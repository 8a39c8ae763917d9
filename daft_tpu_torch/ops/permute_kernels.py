"""The mesh exchange kernel K6 (counterpart of daft_tpu/ops/pallas_kernels.py
``ring_permute_bits``).

``ring_permute_words`` takes every shard's send words as one
(n_src, n_dst, W) int32 tensor, where block [s, d] is shard s's words for
shard d, and returns the (n_dst, n_src, W) receive words:
``recv[d, s] = send[s, d]``. On the TPU each shard's kernel sends its
blocks to its peers over the interconnect; the port's mesh is n shard slots
on one card, so the exchange is a block transpose in device memory, done by
ONE launch of a hand-written CUDA kernel (ops/csrc/ring_permute.cu, whose
source note gives the bound and the design): bulk asynchronous copies
through shared memory when W is a multiple of four words and both buffers
are 16-byte aligned, as the repartition step makes them, a word copy
otherwise. A mesh over several cards
(peer copies over NVLink) is not ported yet: the send words are one tensor,
so every shard lies on one device.

The wrapper follows ops/segment_kernels.py: it checks dtype, shape and
contiguity, allocates the output, and runs the plain version for a CPU
tensor (counted as ``plain_ring_permute_words``) or launches the kernel on
the current CUDA stream (``launches_ring_permute_words``). For a CUDA
tensor it launches or raises: nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes

import torch

from . import counters
from .segment_kernels import _check, _launched, _route, _stream

_SOURCE = "ring_permute.cu"
# the word path's grid (unaligned shapes) puts the n^2 (source, destination)
# pairs on its second dimension, which CUDA caps at 65535
MAX_SHARDS = 255

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ._build import library

        lib = library(_SOURCE)
        lib.daft_ring_permute_words.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                                ctypes.c_int, ctypes.c_longlong,
                                                ctypes.c_void_p]
        lib.daft_ring_permute_words.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Build (or load) the kernel library now; raises when the build fails."""
    _library()


def ring_permute_words(send: torch.Tensor) -> torch.Tensor:
    """(n, n, W) int32 send words -> (n, n, W) receive words, with
    ``recv[d, s] = send[s, d]`` bit for bit."""
    _check(send, "send", torch.int32, 3)
    n, n_dst, w = send.shape
    if n != n_dst:
        raise ValueError(f"send words need one block per (source, destination) "
                         f"pair, got shape {tuple(send.shape)}")
    if n > MAX_SHARDS:
        raise ValueError(f"{n} shards: the exchange kernel takes at most {MAX_SHARDS}")
    if not _route(send):
        counters.bump("plain_ring_permute_words")
        return ring_permute_words_plain(send)
    recv = torch.empty_like(send)
    if send.numel() == 0:
        return recv  # nothing to move: no launch
    with torch.cuda.device(send.device):
        rc = _library().daft_ring_permute_words(send.data_ptr(), recv.data_ptr(), n, w,
                                                _stream(send))
    _launched(rc, "ring_permute_words")
    return recv


def ring_permute_words_plain(send: torch.Tensor) -> torch.Tensor:
    """Plain K6: one ``copy_`` per (source, destination) block."""
    n = send.shape[0]
    recv = torch.empty_like(send)
    for s in range(n):
        for d in range(n):
            recv[d, s].copy_(send[s, d])
    return recv
