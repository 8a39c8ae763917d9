"""The mesh tier's repartition exchange (counterpart of the repartition part of
daft_tpu/parallel/distributed.py).

The reference's mesh is single-controller: one process drives every local
device through ``shard_map``, rows sharded contiguously along the mesh axis.
The port's ``Mesh`` is n shard slots on ONE ``torch.device`` (the card, or
the CPU in the tests): a flat array of ``n * S`` rows is shard j's rows
``[j * S, (j + 1) * S)``, and every shard's work runs batched over a leading
shard dimension. A mesh over several cards (peer copies over NVLink) and
the cross-process tier (torch.distributed) are not ported yet.

The exchange of a hash repartition, in two tiers with one contract:

- ``sharded_ring_repartition_step`` (kernel_mode="on"): every shard
  stable-sorts its rows by destination and bins them (``_repart_sort_pack``),
  every plane and the per-destination counts are packed bit for bit into one
  (n_src, n_dst, W) int32 word buffer, and ONE launch of the exchange kernel
  K6 (ops/permute_kernels.py ``ring_permute_words``) moves every
  (source, destination) block;
- ``sharded_alltoall_repartition_step`` (kernel_mode="off"): the same bins,
  one plain block copy per (source, destination) pair and plane, standing in
  for ``jax.lax.all_to_all``.

Both return ``(counts[n * n] int64, planes [n * n, S])`` where row block
``d * n + j`` holds source shard j's rows destined to partition d: the first
``counts[d * n + j]`` rows are real, in input order (stable sort +
contiguous shards). Bins are padded to the full shard size S, as in the
reference, since one destination may receive every row.

Planes are torch tensors of any device dtype; unsigned 16/32/64-bit columns
ride as same-width signed views (torch's unsigned types lack most ops).
Packing uses views and integer casts only, never float arithmetic, so NaN
payloads and -0.0 survive.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..ops import counters


class Mesh:
    """``size`` shard slots on one ``torch.device``."""

    __slots__ = ("size", "device")

    def __init__(self, size: int, device: torch.device):
        if size < 1:
            raise ValueError(f"a mesh needs at least one shard, got {size}")
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            # tensors report their card's index: "cuda" names the current one
            device = torch.device("cuda", torch.cuda.current_device())
        self.size = int(size)
        self.device = device

    def __repr__(self) -> str:
        return f"Mesh(size={self.size}, device={self.device})"


def default_mesh(n: int, device) -> Mesh:
    """A mesh of ``n`` shard slots on ``device``."""
    return Mesh(n, device)


def _check_inputs(mesh: Mesh, dest: torch.Tensor, row_mask: torch.Tensor,
                  planes: Sequence[torch.Tensor]) -> int:
    """Shard size S; every input is a flat (n * S,) tensor on the mesh's
    device."""
    n = mesh.size
    total = dest.shape[0]
    if dest.dim() != 1 or total % n:
        raise ValueError(f"dest must be flat with a multiple of {n} rows, "
                         f"got shape {tuple(dest.shape)}")
    if dest.dtype != torch.int64 or row_mask.dtype != torch.bool:
        raise TypeError(f"dest must be int64 and row_mask bool, got {dest.dtype}, "
                        f"{row_mask.dtype}")
    for t in (dest, row_mask, *planes):
        if t.shape != (total,):
            raise ValueError(f"every plane must have shape ({total},), got {tuple(t.shape)}")
        if t.device != mesh.device:
            raise ValueError(f"input on {t.device}, the mesh is on {mesh.device}")
    return total // n


def _repart_sort_pack(dest: torch.Tensor, row_mask: torch.Tensor,
                      planes: Sequence[torch.Tensor], n_dev: int,
                      S: int) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The local half of both exchanges, for every shard at once: stable-sort
    each shard's rows by destination and scatter them into per-destination
    bins. Returns (counts (n_src, n_dst) int64, one (n_src, n_dst, S) bin
    tensor per plane); bin slots past a block's count hold zeros."""
    d = torch.where(row_mask, dest, n_dev).view(n_dev, S)
    d_sorted, order = torch.sort(d, dim=1, stable=True)
    counts = torch.zeros((n_dev, n_dev + 1), dtype=torch.int64, device=d.device)
    counts.scatter_add_(1, d, torch.ones_like(d))
    counts = counts[:, :n_dev].contiguous()
    offsets = torch.cumsum(counts, dim=1) - counts
    safe_bin = d_sorted.clamp(max=n_dev - 1)
    pos = torch.arange(S, dtype=torch.int64, device=d.device) - offsets.gather(1, safe_bin)
    # padding rows go to one trash slot past the bins (the reference's
    # mode="drop" scatter)
    flat_idx = torch.where(d_sorted < n_dev, safe_bin * S + pos, n_dev * S)
    del d, d_sorted, safe_bin, pos
    mats = []
    for p in planes:
        mat = torch.zeros((n_dev, n_dev * S + 1), dtype=p.dtype, device=p.device)
        mat.scatter_(1, flat_idx, p.view(n_dev, S).gather(1, order))
        mats.append(mat[:, :n_dev * S].view(n_dev, n_dev, S))
    return counts, mats


def _word_width(dtype: torch.dtype, S: int) -> int:
    """Words a plane of S values of ``dtype`` packs into."""
    return 2 * S if dtype.itemsize == 8 else S


def _pack_words(mat: torch.Tensor) -> torch.Tensor:
    """(..., S) plane of any device dtype -> (..., W) int32 words, bit-exact
    and invertible by ``_unpack_words``: 64-bit types split into two words,
    32-bit types are reinterpreted, narrower types and bool widen by an
    integer cast."""
    if mat.dtype.itemsize in (4, 8) and mat.dtype != torch.bool:
        return mat.view(torch.int32)
    return mat.to(torch.int32)


def _unpack_words(words: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``_pack_words``: (..., W) int32 words back to the dtype."""
    if dtype == torch.bool:
        return words != 0
    if dtype.itemsize in (4, 8):
        return words.view(dtype)
    return words.to(dtype)


def sharded_alltoall_repartition_step(mesh: Mesh, dest: torch.Tensor,
                                      row_mask: torch.Tensor,
                                      *planes: torch.Tensor):
    """The all_to_all tier: bins per shard, then one block copy per
    (source, destination) pair of every plane and of the counts."""
    n = mesh.size
    S = _check_inputs(mesh, dest, row_mask, planes)
    counts, mats = _repart_sort_pack(dest, row_mask, planes, n, S)
    outs = []
    moved = 0
    for mat in mats:
        out = torch.empty((n, n, S), dtype=mat.dtype, device=mat.device)
        for s in range(n):
            for d in range(n):
                out[d, s].copy_(mat[s, d])
        moved += mat.numel() * mat.element_size()
        outs.append(out.view(n * n, S))
    cnt = torch.empty_like(counts)
    for s in range(n):
        for d in range(n):
            cnt[d, s].copy_(counts[s, d])
    counters.bump("mesh_exchange_bytes", moved + counts.numel() * 8)
    return cnt.view(n * n), tuple(outs)


def sharded_ring_repartition_step(mesh: Mesh, dest: torch.Tensor,
                                  row_mask: torch.Tensor, *planes: torch.Tensor):
    """The kernel tier: every plane and the counts packed into one
    (n_src, n_dst, W) int32 word buffer, exchanged by ONE launch of K6."""
    from ..ops.permute_kernels import ring_permute_words

    n = mesh.size
    S = _check_inputs(mesh, dest, row_mask, planes)
    counts, mats = _repart_sort_pack(dest, row_mask, planes, n, S)
    widths = [_word_width(p.dtype, S) for p in planes]
    used = sum(widths) + 2
    # W rounded up to whole 16-byte vectors, so every block is aligned for
    # the kernel's vector copy
    W = (used + 3) // 4 * 4
    send = torch.empty((n, n, W), dtype=torch.int32, device=mesh.device)
    send[:, :, used:] = 0
    off = 0
    for i, w in enumerate(widths):
        send[:, :, off:off + w] = _pack_words(mats[i])
        mats[i] = None  # free each bin tensor once it is packed
        off += w
    send[:, :, off:off + 2] = counts.view(torch.int32).view(n, n, 2)
    recv = ring_permute_words(send)
    counters.bump("mesh_exchange_bytes", send.numel() * 4)
    del send
    outs = []
    off = 0
    for p, w in zip(planes, widths):
        outs.append(_unpack_words(recv[:, :, off:off + w], p.dtype).reshape(n * n, S))
        off += w
    cnt = recv[:, :, off:off + 2].contiguous().view(torch.int64).reshape(n * n)
    return cnt, tuple(outs)
