"""Hash-probe join kernels K4 and K5 (counterparts of
daft_tpu/ops/pallas_kernels.py ``hash_probe_index``, with its host
``build_probe_table`` and ``probe_key_digits``, and
``hash_probe_segment_sum``).

A dim's unique join keys go into an open-addressed hash table on the device
(``build_probe_table``), and every fact key is probed against it
(``hash_probe_index``): the int32 row of the equal dim key, or -1 when the
fact key is null or unmatched. Null dim keys never enter the table.

The table is one contiguous int64 tensor of shape (S, 2), S a power of two:
row h is slot h, 16 bytes, ``[key ^ EMPTY_KEY, dim row]``. A stored word of
0 marks an empty slot, so a zero-filled tensor is an empty table; the row
word holds the non-negative int32 row zero-extended. The CUDA source
(ops/csrc/hash_probe.cu) gives the hash, the bound and the design: the
build places each 4096-slot region of the table in shared memory, the probe
reads one 16-byte slot a step.

``hash_probe_segment_sum`` (K5) fuses K4's probe with a segment sum of the
matched dim row's planes, writing no index plane. No engine code calls it,
in the port or in the reference: it is a standalone kernel on K4's table.

The entry points are wrappers in the style of ops/segment_kernels.py: they
check device, dtype, shape and contiguity, allocate the outputs, and then
run the plain PyTorch version beside them (a tensor on the CPU, counted as
``plain_<name>``) or launch the kernel on the current CUDA stream (counted as
``launches_<name>``). For a CUDA tensor they launch or raise: nothing falls
back to the plain version.

The table's preconditions are checked on the host before any launch
(``probe_key_refusal``): valid keys must be unique and none may equal
``EMPTY_KEY`` (int64 min), the one key whose stored word is 0. The join
runtime turns a refusal into ``DeviceFallback``.

Where a key lands depends on the order the build's threads claim their
slots, so two builds may lay out the same keys differently; the set of
(key, row) entries and every probe's answer do not change. The plain build
packs the same entries, in the same slot layout, into the first slots with
no hashing: the plain probe searches the sorted occupied slots and needs no
hash layout.

Left for later: a bucketed or cuckoo layout that bounds a miss's walk, and
warp-aggregated atomics in K5.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np
import torch

from . import counters
from .segment_kernels import _check, _launched, _route, _stream

_SOURCE = "hash_probe.cu"
EMPTY_KEY = -(1 << 63)
_MIN_SLOTS = 16

_lib = None


def _library():
    global _lib
    if _lib is None:
        from ._build import library

        lib = library(_SOURCE)
        vp, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.daft_hash_probe_build_scratch.argtypes = [ll, ll]
        lib.daft_hash_probe_build_scratch.restype = ll
        lib.daft_hash_probe_build.argtypes = [vp, vp, vp, vp, ll, ll, vp]
        lib.daft_hash_probe_index.argtypes = [vp, vp, vp, vp, ll, ll, vp]
        lib.daft_hash_probe_segment_sum.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, i, i,
                                                    ll, vp]
        for fn in (lib.daft_hash_probe_build, lib.daft_hash_probe_index,
                   lib.daft_hash_probe_segment_sum):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Build (or load) the kernel library now; raises when the build fails."""
    _library()


def probe_table_slots(n_rows: int) -> int:
    """Slot count for a dim of ``n_rows`` keys (nulls included): a power of
    two >= 2 * n_rows, so the table's load stays <= 0.5."""
    s = _MIN_SLOTS
    while s < 2 * n_rows:
        s <<= 1
    return s


def probe_key_refusal(keys: np.ndarray, valid: np.ndarray) -> Optional[str]:
    """Why these dim keys cannot go into a probe table, or None."""
    vk = np.asarray(keys, dtype=np.int64)[np.asarray(valid, dtype=bool)]
    if np.any(vk == EMPTY_KEY):
        return "a dim key equals the probe table's empty marker (int64 min)"
    if len(np.unique(vk)) != len(vk):
        return "dim keys are not unique"
    return None


def _check_keys(keys: torch.Tensor, valid: torch.Tensor) -> None:
    _check(keys, "keys", torch.int64, 1)
    _check(valid, "valid", torch.bool, 1)
    if valid.shape[0] != keys.shape[0]:
        raise ValueError(f"keys has {keys.shape[0]} rows, valid {valid.shape[0]}")


def _check_table(table: torch.Tensor) -> int:
    _check(table, "table", torch.int64, 2)
    s = table.shape[0]
    if table.shape[1] != 2 or s < 1 or s & (s - 1):
        raise ValueError(f"probe table must be (S, 2) with S a power of two, got "
                         f"{tuple(table.shape)}")
    if table.data_ptr() % 16:
        raise ValueError("probe table must be 16-byte aligned")
    return s


def table_entries(table: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(keys int64, rows int32) of the table's occupied slots, sorted by key:
    the set of entries, whatever the layout."""
    occupied = table[:, 0] != 0
    keys, order = torch.sort(table[occupied, 0] ^ EMPTY_KEY)
    return keys, table[occupied, 1][order].to(torch.int32)


# ---- build ---------------------------------------------------------------------------


def build_probe_table(keys: torch.Tensor, valid: torch.Tensor, slots: int) -> torch.Tensor:
    """The (slots, 2) int64 table holding every valid (key, row); empty
    slots are zero. ``slots`` comes from ``probe_table_slots`` and the keys
    must pass ``probe_key_refusal``. A table over the load limit is refused:
    a full table would never let the kernels' probe loops end."""
    _check_keys(keys, valid)
    if slots < 1 or slots & (slots - 1):
        raise ValueError(f"slots must be a power of two, got {slots}")
    if slots < 2 * keys.shape[0]:
        raise ValueError(f"{slots} slots for {keys.shape[0]} keys: the table needs at "
                         f"least twice the keys (probe_table_slots)")
    if not _route(keys, valid):
        counters.bump("plain_hash_probe_build")
        return build_probe_table_plain(keys, valid, slots)
    if keys.shape[0] == 0:  # nothing to place: no launch
        return torch.zeros((slots, 2), dtype=torch.int64, device=keys.device)
    lib = _library()
    table = torch.empty((slots, 2), dtype=torch.int64, device=keys.device)
    # the build's region counts and overflow list, apart from the table so
    # that a resident table holds no scratch
    scratch = torch.empty(lib.daft_hash_probe_build_scratch(keys.shape[0], slots),
                          dtype=torch.int32, device=keys.device)
    with torch.cuda.device(keys.device):
        rc = lib.daft_hash_probe_build(
            keys.data_ptr(), valid.data_ptr(), table.data_ptr(), scratch.data_ptr(),
            keys.shape[0], slots, _stream(keys))
    _launched(rc, "hash_probe_build")
    return table


def build_probe_table_plain(keys: torch.Tensor, valid: torch.Tensor,
                            slots: int) -> torch.Tensor:
    """Plain build: the valid (key, row) pairs in row order in the first
    slots, in the kernel's slot layout, the rest empty. No hash layout: only
    the plain probe reads it."""
    table = torch.zeros((slots, 2), dtype=torch.int64, device=keys.device)
    rows = torch.nonzero(valid).flatten()
    table[:rows.numel(), 0] = keys[rows] ^ EMPTY_KEY
    table[:rows.numel(), 1] = rows
    return table


# ---- probe ---------------------------------------------------------------------------


def hash_probe_index(keys: torch.Tensor, valid: torch.Tensor,
                     table: torch.Tensor) -> torch.Tensor:
    """int32[N]: the dim row whose key equals ``keys[i]``, or -1 when
    ``valid[i]`` is false or no dim key equals it."""
    _check_keys(keys, valid)
    slots = _check_table(table)
    if not _route(keys, valid, table):
        counters.bump("plain_hash_probe_index")
        return hash_probe_index_plain(keys, valid, table)
    out = torch.empty(keys.shape[0], dtype=torch.int32, device=keys.device)
    if keys.shape[0] == 0:
        return out  # nothing to probe: no launch
    with torch.cuda.device(keys.device):
        rc = _library().daft_hash_probe_index(
            keys.data_ptr(), valid.data_ptr(), table.data_ptr(), out.data_ptr(),
            keys.shape[0], slots, _stream(keys))
    _launched(rc, "hash_probe_index")
    return out


def hash_probe_index_plain(keys: torch.Tensor, valid: torch.Tensor,
                           table: torch.Tensor) -> torch.Tensor:
    """Plain probe: sort the occupied slots by key, ``searchsorted`` each
    fact key and keep the row where the key found is equal."""
    table_keys, table_rows = table_entries(table)
    if table_keys.numel() == 0:
        return torch.full(keys.shape, -1, dtype=torch.int32, device=keys.device)
    pos = torch.searchsorted(table_keys, keys).clamp_(max=table_keys.numel() - 1)
    hit = valid & (table_keys[pos] == keys) & (keys != EMPTY_KEY)
    return torch.where(hit, table_rows[pos], -1).to(torch.int32)


# ---- K5: probe + segment sum ----------------------------------------------------------


def hash_probe_segment_sum(keys: torch.Tensor, valid: torch.Tensor, codes: torch.Tensor,
                           table: torch.Tensor, planes: torch.Tensor,
                           cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums (cap, P) f64, counts (cap,) int64): for every fact row whose
    key finds a dim row in the table and whose code lies in [0, cap), that
    dim row's planes (``planes[row]``, (D, P) f32, one row per key the table
    was built from) are added into the code's segment and 1 into its count.
    A null fact key never matches.

    The reference returns f32 sums and counts; these are widened as K1's
    are, and equal the reference's wherever its f32 sums are exact
    (integer-valued planes under 2^24 a segment). The kernel adds in f64
    atomics in no fixed order, so a float plane with fractions may differ
    from the plain version in the last bits."""
    _check_keys(keys, valid)
    _check(codes, "codes", torch.int32, 1)
    _check(planes, "planes", torch.float32, 2)
    slots = _check_table(table)
    n, p = keys.shape[0], planes.shape[1]
    if codes.shape[0] != n:
        raise ValueError(f"codes has {codes.shape[0]} rows, keys {n}")
    if slots < 2 * planes.shape[0]:
        raise ValueError(f"{slots} slots cannot hold a table of {planes.shape[0]} dim rows")
    if not _route(keys, valid, codes, table, planes):
        counters.bump("plain_hash_probe_segment_sum")
        return hash_probe_segment_sum_plain(keys, valid, codes, table, planes, cap)
    sums = torch.zeros((cap, p), dtype=torch.float64, device=keys.device)
    counts = torch.zeros(cap, dtype=torch.int64, device=keys.device)
    if n == 0:
        return sums, counts  # nothing to probe: no launch
    with torch.cuda.device(keys.device):
        rc = _library().daft_hash_probe_segment_sum(
            keys.data_ptr(), valid.data_ptr(), codes.data_ptr(), table.data_ptr(),
            planes.data_ptr(), sums.data_ptr(), counts.data_ptr(), n, p, cap, slots,
            _stream(keys))
    _launched(rc, "hash_probe_segment_sum")
    return sums, counts


def hash_probe_segment_sum_plain(keys: torch.Tensor, valid: torch.Tensor,
                                 codes: torch.Tensor, table: torch.Tensor,
                                 planes: torch.Tensor,
                                 cap: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain K5: the plain probe, then ``index_add_`` of the gathered dim
    planes (f64) and of ones (int64) into tables with a trash row."""
    idx = hash_probe_index_plain(keys, valid, table)
    hit = (idx >= 0) & (codes >= 0) & (codes < cap)
    seg = torch.where(hit, codes, cap).long()
    p = planes.shape[1]
    sums = torch.zeros((cap + 1, p), dtype=torch.float64, device=keys.device)
    counts = torch.zeros(cap + 1, dtype=torch.int64, device=keys.device)
    if planes.shape[0]:
        sums.index_add_(0, seg, planes[idx.clamp(min=0).long()].double())
    counts.index_add_(0, seg, torch.ones_like(seg))
    return sums[:cap].contiguous(), counts[:cap].contiguous()
