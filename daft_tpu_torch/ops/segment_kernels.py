"""Segment-reduce kernels K1-K3 (counterpart of daft_tpu/ops/pallas_kernels.py).

The grouped-aggregation inner loop: accumulate value planes into a
(segments x planes) table keyed by per-row int32 segment codes, with codes
outside [0, cap) dropped (the trash segment of filtered and padding rows).

Each entry point is a wrapper around a CUDA kernel written for Hopper
(ops/csrc/segment_reduce.cu, whose source note gives each kernel's contract,
bound and design) and has a plain PyTorch version beside it:

- ``segment_sum_planes`` (K1, replaces ``segment_sum_planes_windowed``);
- ``segment_sum_planes_f32`` (K1a, replaces ``segment_sum_planes``, the
  one-window f32 case; no engine code calls it, in the port or in the
  reference);
- ``segment_extreme_planes`` (K2, replaces ``segment_extreme_planes``);
- ``segment_extreme_int64`` (K3, replaces ``segment_extreme_int64``).

A wrapper checks device, dtype, shape and contiguity, allocates the outputs,
and then either calls the plain version (a tensor on the CPU) or launches the
kernel on the current CUDA stream and counts the launch
(ops/counters.py ``launches_<name>``; a call routed to the plain version
counts ``plain_<name>`` instead). For a CUDA tensor it launches or raises:
nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Tuple

import torch

from . import counters

_SOURCE = "segment_reduce.cu"
# the reference's f32 accumulation window (32 blocks of 1024 rows): the plain
# K1 sums each window in f32 and combines windows in f64, as the TPU kernel did
WINDOW_ROWS = 32 * 1024
# ceiling of the kernel tier's segment count (the reference's
# PALLAS_MAX_SEGMENTS)
KERNEL_MAX_SEGMENTS = 1 << 17
# first-row indices ride an f32 plane: exact only below 2^24 rows per bucket
MAX_KERNEL_BUCKET = 1 << 24

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1
# order-preserving uint32 keys of +inf / -inf, stored in an int32 table
_F32_MIN_IDENT_KEY = 0xFF800000 - (1 << 32)
_F32_MAX_IDENT_KEY = 0x007FFFFF

_lib = None


def _library():
    """The kernel library with its launchers' ctypes signatures set."""
    global _lib
    if _lib is None:
        from ._build import library

        lib = library(_SOURCE)
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.daft_segment_sum_planes.argtypes = [vp, vp, vp, ll, i32, i32, vp]
        lib.daft_segment_sum_planes_f32.argtypes = [vp, vp, vp, ll, i32, i32, vp]
        lib.daft_segment_extreme_planes.argtypes = [vp, vp, vp, vp, ll, i32, i32,
                                                    i32, vp]
        lib.daft_segment_extreme_int64_parts.argtypes = [i32, i32, i32,
                                                         ctypes.POINTER(i32)]
        lib.daft_segment_extreme_int64.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, i32,
                                                   i32, i32, i32, i32, i32, vp]
        for fn in (lib.daft_segment_sum_planes, lib.daft_segment_sum_planes_f32,
                   lib.daft_segment_extreme_planes,
                   lib.daft_segment_extreme_int64_parts,
                   lib.daft_segment_extreme_int64):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def build() -> None:
    """Build (or load) the kernel library now; raises when the build fails."""
    _library()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def _route(*tensors: torch.Tensor) -> bool:
    """True = launch the CUDA kernel, False = plain version on the CPU."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"inputs on different devices: {[str(t.device) for t in tensors]}")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"no segment kernel for device {dev}")
    return True


def _launched(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
    counters.bump(f"launches_{name}")


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


# ---- K1 ----------------------------------------------------------------------------


def segment_sum_planes(planes: torch.Tensor, codes: torch.Tensor,
                       cap: int) -> torch.Tensor:
    """Sum planes (N x P, f32) into segments (cap x P, f64) by codes (N, i32).

    Exact only for integer-valued planes whose segment totals stay below
    2^53 (rows, counts, 8-bit digits): the kernel adds in f64 atomics in no
    fixed order."""
    _check(planes, "planes", torch.float32, 2)
    _check(codes, "codes", torch.int32, 1)
    n, p = planes.shape
    if codes.shape[0] != n:
        raise ValueError(f"codes has {codes.shape[0]} rows, planes {n}")
    if not _route(planes, codes):
        counters.bump("plain_segment_sum_planes")
        return segment_sum_planes_plain(planes, codes, cap)
    out = torch.zeros((cap, p), dtype=torch.float64, device=planes.device)
    with torch.cuda.device(planes.device):
        rc = _library().daft_segment_sum_planes(
            planes.data_ptr(), codes.data_ptr(), out.data_ptr(), n, p, cap,
            _stream(planes))
    _launched(rc, "segment_sum_planes")
    return out


def segment_sum_planes_plain(planes: torch.Tensor, codes: torch.Tensor,
                             cap: int) -> torch.Tensor:
    """Plain K1: per-window ``index_add_`` in f32, windows summed in f64."""
    n, p = planes.shape
    inside = (codes >= 0) & (codes < cap)
    safe = torch.where(inside, codes, cap).long()
    out = torch.zeros((cap, p), dtype=torch.float64, device=planes.device)
    win = min(WINDOW_ROWS, n)
    for s in range(0, n, win):
        part = torch.zeros((cap + 1, p), dtype=torch.float32, device=planes.device)
        part.index_add_(0, safe[s:s + win], planes[s:s + win])
        out += part[:cap].double()
    return out


# ---- K1a ---------------------------------------------------------------------------


def segment_sum_planes_f32(planes: torch.Tensor, codes: torch.Tensor,
                           cap: int) -> torch.Tensor:
    """Sum planes (N x P, f32) into segments (cap x P, f32) by codes (N, i32)
    in one f32 accumulation, codes outside [0, cap) dropped.

    Exact for integer-valued planes whose segment totals stay below 2^24;
    otherwise the kernel's atomic order decides the last bits, as the
    reference's single-window kernel is exact only there."""
    _check(planes, "planes", torch.float32, 2)
    _check(codes, "codes", torch.int32, 1)
    n, p = planes.shape
    if codes.shape[0] != n:
        raise ValueError(f"codes has {codes.shape[0]} rows, planes {n}")
    if not _route(planes, codes):
        counters.bump("plain_segment_sum_planes_f32")
        return segment_sum_planes_f32_plain(planes, codes, cap)
    out = torch.zeros((cap, p), dtype=torch.float32, device=planes.device)
    if n * p == 0:
        return out  # nothing to sum: no launch
    with torch.cuda.device(planes.device):
        rc = _library().daft_segment_sum_planes_f32(
            planes.data_ptr(), codes.data_ptr(), out.data_ptr(), n, p, cap,
            _stream(planes))
    _launched(rc, "segment_sum_planes_f32")
    return out


def segment_sum_planes_f32_plain(planes: torch.Tensor, codes: torch.Tensor,
                                 cap: int) -> torch.Tensor:
    """Plain K1a: one f32 ``index_add_`` into a table with a trash row."""
    inside = (codes >= 0) & (codes < cap)
    safe = torch.where(inside, codes, cap).long()
    out = torch.zeros((cap + 1, planes.shape[1]), dtype=torch.float32,
                      device=planes.device)
    out.index_add_(0, safe, planes)
    return out[:cap].contiguous()


# ---- K2 ----------------------------------------------------------------------------


def segment_extreme_planes(planes: torch.Tensor, codes: torch.Tensor, cap: int,
                           op: str) -> torch.Tensor:
    """min/max planes (N x Q, f32, identity-filled) into (cap x Q, f32).

    Masked-out rows must already carry the identity (+inf for min, -inf for
    max); an empty segment keeps the identity. NaN is outside the contract."""
    if op not in ("min", "max"):
        raise ValueError(op)
    _check(planes, "planes", torch.float32, 2)
    _check(codes, "codes", torch.int32, 1)
    n, q = planes.shape
    if codes.shape[0] != n:
        raise ValueError(f"codes has {codes.shape[0]} rows, planes {n}")
    if not _route(planes, codes):
        counters.bump("plain_segment_extreme_planes")
        return segment_extreme_planes_plain(planes, codes, cap, op)
    ident_key = _F32_MIN_IDENT_KEY if op == "min" else _F32_MAX_IDENT_KEY
    table = torch.full((cap, q), ident_key, dtype=torch.int32, device=planes.device)
    out = torch.empty((cap, q), dtype=torch.float32, device=planes.device)
    with torch.cuda.device(planes.device):
        rc = _library().daft_segment_extreme_planes(
            planes.data_ptr(), codes.data_ptr(), table.data_ptr(), out.data_ptr(),
            n, q, cap, int(op == "min"), _stream(planes))
    _launched(rc, "segment_extreme_planes")
    return out


def segment_extreme_planes_plain(planes: torch.Tensor, codes: torch.Tensor,
                                 cap: int, op: str) -> torch.Tensor:
    """Plain K2: ``scatter_reduce_`` (amin/amax) into an identity-filled table."""
    n, q = planes.shape
    ident = float("inf") if op == "min" else float("-inf")
    inside = (codes >= 0) & (codes < cap)
    safe = torch.where(inside, codes, cap).long()
    out = torch.full((cap + 1, q), ident, dtype=torch.float32, device=planes.device)
    out.scatter_reduce_(0, safe[:, None].expand(n, q), planes,
                        reduce="amin" if op == "min" else "amax")
    return out[:cap].contiguous()


# ---- K3 ----------------------------------------------------------------------------


class K3Tier(NamedTuple):
    """How K3 lays out its shared-memory table (ops/csrc/segment_reduce.cu)."""

    cluster: int     # blocks that share one table (a thread block cluster)
    slice: int       # table entries each block holds
    warp_agg: bool   # lanes with equal codes reduce in the warp first


# entries one block's shared memory holds: 8-byte keys plus a bitmap, 195 KB
# of a block's 227 KB
K3_BLOCK_SLICE_MAX = 24576
# entries per block when a cluster of 2, 4 or 8 blocks splits the table
K3_CLUSTER_SLICE = 16384
# caps this small put every warp's rows on a few addresses: pre-aggregate
K3_WARP_AGG_MAX_CAP = 16

_k3_parts: Dict[Tuple[int, K3Tier], int] = {}


def segment_extreme_int64_tier(cap: int) -> K3Tier:
    """K3's tier at ``cap``: one table per block while a block's shared
    memory holds cap entries, else one table split across a cluster of the
    fewest blocks (2, 4 or 8) that hold it; warp pre-aggregation for caps up
    to K3_WARP_AGG_MAX_CAP."""
    if not 0 < cap <= KERNEL_MAX_SEGMENTS:
        raise ValueError(f"K3 takes 1 to {KERNEL_MAX_SEGMENTS} segments, got {cap}")
    if cap <= K3_BLOCK_SLICE_MAX:
        return K3Tier(1, -(-cap // 32) * 32, cap <= K3_WARP_AGG_MAX_CAP)
    cluster = 2
    while cluster * K3_CLUSTER_SLICE < cap:
        cluster *= 2
    return K3Tier(cluster, K3_CLUSTER_SLICE, False)


def _k3_partial_tables(device: torch.device, tier: K3Tier) -> int:
    """How many partial tables K3's first launch writes at ``tier`` (as many
    blocks or clusters as fit on the card at once), cached per device."""
    key = (device.index, tier)
    if key not in _k3_parts:
        parts = ctypes.c_int(0)
        rc = _library().daft_segment_extreme_int64_parts(
            tier.cluster, tier.slice, int(tier.warp_agg), ctypes.byref(parts))
        if rc != 0:
            raise RuntimeError(f"segment_extreme_int64: no launch fits tier {tier} "
                               f"(CUDA error {rc})")
        _k3_parts[key] = parts.value
    return _k3_parts[key]


def segment_extreme_int64(vals: torch.Tensor, mask: torch.Tensor,
                          codes: torch.Tensor, cap: int,
                          op: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact int64 min/max by segment over rows where ``mask`` holds.

    Returns (int64[cap] extremes, bool[cap] nonempty); an empty segment
    carries the reduction identity (int64 max for min, int64 min for max)."""
    if op not in ("min", "max"):
        raise ValueError(op)
    _check(vals, "vals", torch.int64, 1)
    _check(mask, "mask", torch.bool, 1)
    _check(codes, "codes", torch.int32, 1)
    n = vals.shape[0]
    if mask.shape[0] != n or codes.shape[0] != n:
        raise ValueError(f"vals/mask/codes rows differ: {n}, {mask.shape[0]}, "
                         f"{codes.shape[0]}")
    if not _route(vals, mask, codes):
        counters.bump("plain_segment_extreme_int64")
        return segment_extreme_int64_plain(vals, mask, codes, cap, op)
    dev = vals.device
    out = torch.empty((cap,), dtype=torch.int64, device=dev)
    nonempty = torch.empty((cap,), dtype=torch.bool, device=dev)
    if cap == 0:
        return out, nonempty  # no segment: no launch
    tier = segment_extreme_int64_tier(cap)
    with torch.cuda.device(dev):
        parts = _k3_partial_tables(dev, tier)
        entries = parts * tier.cluster * tier.slice
        part_keys = torch.empty((entries,), dtype=torch.int64, device=dev)
        part_bits = torch.empty((entries // 32,), dtype=torch.int32, device=dev)
        rc = _library().daft_segment_extreme_int64(
            vals.data_ptr(), mask.data_ptr(), codes.data_ptr(), part_keys.data_ptr(),
            part_bits.data_ptr(), out.data_ptr(), nonempty.data_ptr(), n, cap,
            tier.cluster, tier.slice, int(tier.warp_agg), parts, int(op == "min"),
            _stream(vals))
    _launched(rc, "segment_extreme_int64")
    return out, nonempty


def segment_extreme_int64_plain(vals: torch.Tensor, mask: torch.Tensor,
                                codes: torch.Tensor, cap: int, op: str):
    """Plain K3: ``scatter_reduce_`` on an identity-filled int64 table."""
    ident = _I64_MAX if op == "min" else _I64_MIN
    use = mask & (codes >= 0) & (codes < cap)
    safe = torch.where(use, codes, cap).long()
    out = torch.full((cap + 1,), ident, dtype=torch.int64, device=vals.device)
    out.scatter_reduce_(0, safe, torch.where(use, vals, ident),
                        reduce="amin" if op == "min" else "amax")
    nonempty = torch.zeros((cap + 1,), dtype=torch.bool, device=vals.device)
    nonempty[safe[use]] = True
    return out[:cap].contiguous(), nonempty[:cap].contiguous()
