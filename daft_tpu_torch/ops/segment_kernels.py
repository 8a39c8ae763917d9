"""Segment-reduce kernels K1-K3 and K7 (counterpart of
daft_tpu/ops/pallas_kernels.py, and of the reference's XLA float sums).

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
- ``segment_extreme_int64`` (K3, replaces ``segment_extreme_int64``);
- ``segment_sum_float_planes`` (K7, replaces the reference's XLA reduction
  of float "sum" planes in daft_tpu/ops/grouped_stage.py: f32 or f64 planes
  summed in f64).

K1, K2 and K7 take their planes as a list of 1-D tensors (the rows of a (P, N)
tensor qualify), so the caller never stacks them; K1a keeps the reference's
(N, P) layout. Their plain versions stack the list and compute as the
reference does.

A wrapper checks device, dtype, shape and contiguity, allocates the outputs,
and then either calls the plain version (a tensor on the CPU) or launches the
kernel on the current CUDA stream and counts the launch
(ops/counters.py ``launches_<name>``: one per launch of the kernel, its
first pass and the merge of its partial tables; K1 and K2 launch once per
chunk of 64 planes; a call routed to the plain version counts
``plain_<name>`` instead). For a CUDA tensor it launches or raises:
nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from . import counters

_SOURCE = "segment_reduce.cu"
# the reference's f32 accumulation window (32 blocks of 1024 rows): the plain
# K1 sums each window in f32 and combines windows in f64, as the TPU kernel did
WINDOW_ROWS = 32 * 1024
# ceiling of the kernels' segment count: the reference's TOPN_MAX_SEGMENTS
# (daft_tpu/ops/device_join.py), which a star-join TopN run reaches; K1's,
# K2's, K3's and K7's global tiers hold such tables in device memory. The
# grouped stage keeps the reference's lower MAX_SORT_SEGMENTS of 2^20
KERNEL_MAX_SEGMENTS = 1 << 22
# first-row indices ride an f32 plane: exact only below 2^24 rows per bucket
MAX_KERNEL_BUCKET = 1 << 24

_I64_MIN = -(1 << 63)
_I64_MAX = (1 << 63) - 1

_lib = None


def _library():
    """The kernel library with its launchers' ctypes signatures set."""
    global _lib
    if _lib is None:
        from ._build import library

        lib = library(_SOURCE)
        vp, ll, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.daft_segment_planes_blocks.argtypes = [i32, i32, i32, i32, i32,
                                                   ctypes.POINTER(i32)]
        lib.daft_segment_planes.argtypes = [i32, ctypes.POINTER(vp), i32, vp, vp, vp, ll,
                                            i32, i32, i32, i32, i32, i32, vp]
        lib.daft_segment_sum_planes_f32_parts.argtypes = [i32, i32, i32, i32,
                                                          ctypes.POINTER(i32)]
        lib.daft_segment_sum_planes_f32.argtypes = [vp, vp, vp, vp, ll, i32, i32, i32, i32,
                                                    i32, vp]
        lib.daft_segment_extreme_int64_parts.argtypes = [i32, i32, i32,
                                                         ctypes.POINTER(i32)]
        lib.daft_segment_extreme_int64.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, i32,
                                                   i32, i32, i32, i32, i32, vp]
        lib.daft_segment_extreme_int64_global_blocks.argtypes = [ctypes.POINTER(i32)]
        lib.daft_segment_extreme_int64_global.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, i32,
                                                          i32, i32, i32, vp]
        lib.daft_segment_sum_float_planes_blocks.argtypes = [i32, i32, i32, i32, i32,
                                                             ctypes.POINTER(i32)]
        lib.daft_segment_sum_float_planes.argtypes = [i32, ctypes.POINTER(vp), i32, vp, vp,
                                                      vp, ll, i32, i32, i32, i32, i32, i32,
                                                      vp]
        for fn in (lib.daft_segment_planes_blocks, lib.daft_segment_planes,
                   lib.daft_segment_sum_planes_f32_parts, lib.daft_segment_sum_planes_f32,
                   lib.daft_segment_extreme_int64_parts,
                   lib.daft_segment_extreme_int64,
                   lib.daft_segment_extreme_int64_global_blocks,
                   lib.daft_segment_extreme_int64_global,
                   lib.daft_segment_sum_float_planes_blocks,
                   lib.daft_segment_sum_float_planes):
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


# ---- K1 and K2: planes by pointer ---------------------------------------------------


class PlaneTier(NamedTuple):
    """How K1 and K2 lay out their tables for one chunk of planes
    (ops/csrc/segment_reduce.cu)."""

    kind: str    # "block" (shared-memory tables) or "global"
    group: int   # planes per table; the global tier's one table holds all


# planes per launch pair: their pointers ride in the kernel's parameters
PLANE_CHUNK = 64
# shared memory one block may take (H100: 227 KB)
PLANE_SMEM_MAX = 232448
_PLANE_TIER_IDS = {"block": 0, "global": 1}
_PLANE_OP_IDS = {"sum": 0, "min": 1, "max": 2}


class _PlaneChunk(NamedTuple):
    """One launch pair of K1 or K2: planes [col, col + planes) of the call."""

    col: int
    planes: int
    tier: int     # _PLANE_TIER_IDS
    group: int
    blocks: int   # the first pass's grid
    words: int    # uint32 scratch: the partial tables, or the global table


# (device, op, cap, planes) -> (the call's chunks, scratch words)
_plane_plans: Dict[Tuple[int, int, int, int], Tuple[Tuple[_PlaneChunk, ...], int]] = {}


def segment_planes_tier(cap: int, nplanes: int) -> PlaneTier:
    """K1's and K2's tier for a chunk of ``nplanes`` planes at ``cap``: uint32
    tables of ``group`` planes in a block's shared memory (the most planes
    whose cap x group x 4 bytes fit); one table in device memory when a
    single plane's does not fit."""
    if not 0 < cap <= KERNEL_MAX_SEGMENTS:
        raise ValueError(f"K1/K2 take 1 to {KERNEL_MAX_SEGMENTS} segments, got {cap}")
    if not 0 < nplanes <= PLANE_CHUNK:
        raise ValueError(f"a chunk holds 1 to {PLANE_CHUNK} planes, got {nplanes}")
    fit = PLANE_SMEM_MAX // (cap * 4)
    if fit == 0:
        return PlaneTier("global", nplanes)
    return PlaneTier("block", min(nplanes, fit))


def _plane_plan(device: int, op: int, cap: int,
                p: int) -> Tuple[Tuple[_PlaneChunk, ...], int]:
    """The launch pairs of a call on ``p`` planes, one per chunk of
    PLANE_CHUNK: each chunk's tier and first-pass grid (as many blocks as fit
    on the current device at once, in equal shares per plane group, at least
    one each), and the scratch the largest needs; cached per shape."""
    key = (device, op, cap, p)
    plan = _plane_plans.get(key)
    if plan is None:
        chunks = []
        for col in range(0, p, PLANE_CHUNK):
            k = min(PLANE_CHUNK, p - col)
            tier = segment_planes_tier(cap, k)
            tier_id = _PLANE_TIER_IDS[tier.kind]
            fit = ctypes.c_int(0)
            rc = _library().daft_segment_planes_blocks(op, tier_id, cap, k, tier.group,
                                                       ctypes.byref(fit))
            if rc != 0:
                raise RuntimeError(f"segment planes: no launch fits tier {tier} at cap "
                                   f"{cap} (CUDA error {rc})")
            if tier.kind == "global":
                blocks, words = fit.value, k * cap
            else:
                groups = -(-k // tier.group)
                blocks = groups * max(1, fit.value // groups)
                words = blocks * tier.group * cap
            chunks.append(_PlaneChunk(col, k, tier_id, tier.group, blocks, words))
        plan = _plane_plans[key] = (tuple(chunks), max(c.words for c in chunks))
    return plan


def _check_planes(planes, codes: torch.Tensor, name: str,
                  dtype: torch.dtype = torch.float32) -> int:
    """Check a plane list against the codes (each plane 1-D, of ``dtype``,
    contiguous, as long as the codes and on their device); returns the row
    count. The loop reads only cheap attributes: at q12's shapes the
    wrapper's host time is about the kernels' own."""
    if not isinstance(planes, (list, tuple)):
        raise TypeError(f"{name}: planes must be a list or tuple of 1-D tensors, "
                        f"got {type(planes).__name__}")
    if not planes:
        raise ValueError(f"{name}: no planes")
    _check(codes, "codes", torch.int32, 1)
    n, dev = codes.shape[0], codes.device
    for j, t in enumerate(planes):
        if (t.dtype is not dtype or t.ndim != 1 or t.numel() != n or t.device != dev
                or not t.is_contiguous()):
            _check(t, f"plane {j}", dtype, 1)
            if t.device != dev:
                raise ValueError(f"{name}: plane {j} on {t.device}, codes on {dev}")
            raise ValueError(f"{name}: plane {j} has {t.shape[0]} rows, codes {n}")
    return n


def _launch_planes(op: str, planes, codes: torch.Tensor, cap: int, out: torch.Tensor,
                   name: str) -> None:
    """K1 or K2 on the card: one launch pair per chunk of PLANE_CHUNK planes,
    each writing its columns of ``out`` and counted once in
    ``launches_<name>``; the chunks share one scratch buffer in stream
    order."""
    lib = _library()
    dev = codes.device
    op_id = _PLANE_OP_IDS[op]
    n, p = codes.shape[0], len(planes)
    ptrs = [t.data_ptr() for t in planes]
    with torch.cuda.device(dev):
        chunks, words = _plane_plan(dev.index, op_id, cap, p)
        part = torch.empty((words,), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c in chunks:
            rc = lib.daft_segment_planes(
                op_id, (ctypes.c_void_p * c.planes)(*ptrs[c.col:c.col + c.planes]), c.planes,
                codes.data_ptr(), part.data_ptr(), out.data_ptr(), n, cap, c.tier, c.group,
                c.blocks, p, c.col, stream)
            _launched(rc, name)


# ---- K1 ----------------------------------------------------------------------------


def segment_sum_planes(planes: Sequence[torch.Tensor], codes: torch.Tensor,
                       cap: int) -> torch.Tensor:
    """Sum P planes (each N f32, contiguous) into segments (cap x P, f64) by
    codes (N, i32); codes outside [0, cap) are dropped.

    The contract (ops/csrc/segment_reduce.cu): every plane value is an
    integer in [0, 255] (rows, counts, 8-bit digits), and N < 2^24, which is
    checked here. The kernel adds in uint32 then, exactly in any order."""
    n = _check_planes(planes, codes, "segment_sum_planes")
    if n >= MAX_KERNEL_BUCKET:
        raise ValueError(f"segment_sum_planes: {n} rows, the contract takes fewer than "
                         f"{MAX_KERNEL_BUCKET}")
    if not _route(codes):
        counters.bump("plain_segment_sum_planes")
        return segment_sum_planes_plain(planes, codes, cap)
    out = torch.empty((cap, len(planes)), dtype=torch.float64, device=codes.device)
    if cap:
        _launch_planes("sum", planes, codes, cap, out, "segment_sum_planes")
    return out


def segment_sum_planes_plain(planes: Sequence[torch.Tensor], codes: torch.Tensor,
                             cap: int) -> torch.Tensor:
    """Plain K1: the planes stacked to (N x P), per-window ``index_add_`` in
    f32, windows summed in f64."""
    planes = torch.stack(list(planes), dim=1)
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


class F32Tier(NamedTuple):
    """How K1a lays out its f32 table (ops/csrc/segment_reduce.cu)."""

    kind: str     # "block" (a table per block in shared memory) or "global"
    copies: int   # copies of the table in a block, one per warp in turn (block tier)


# shared memory beside K1a's table: the codes of two 4096-row tiles and
# each warp's 32 vectors
_F32_STAGE_BYTES = 2 * (4096 + 4) * 4 + 1024 * 16
# shared memory one block's table may take: a block's 227 KB less the stage
F32_TABLE_BYTES = 232448 - _F32_STAGE_BYTES
# table copies per block: at most one per warp, and only while two blocks
# of 1024 threads would still fit on an SM
F32_MAX_COPIES = 32
F32_COPIES_BYTES = 232448 // 2 - _F32_STAGE_BYTES
_F32_TIER_IDS = {"block": 0, "global": 1}

_f32_parts: Dict[Tuple[int, int, int, F32Tier], int] = {}


def segment_sum_f32_tier(cap: int, p: int) -> F32Tier:
    """K1a's tier at ``cap`` segments of ``p`` planes: the whole cap x P f32
    table in each block's shared memory while it fits (in as many copies as
    would keep two blocks an SM, up to one per warp); else one table in
    device memory, which the warps' adds reach as global atomics on a
    row's adjacent entries."""
    if cap <= 0 or p <= 0:
        raise ValueError(f"K1a takes at least one segment and one plane, got {cap} x {p}")
    table = cap * p * 4
    if table <= F32_TABLE_BYTES:
        return F32Tier("block", max(1, min(F32_MAX_COPIES, F32_COPIES_BYTES // table)))
    return F32Tier("global", 1)


def _f32_partial_tables(device: torch.device, cap: int, p: int, tier: F32Tier) -> int:
    """K1a's first-pass blocks that fit on the card at once, one partial
    table each in the block tier; cached per device and shape (the first
    query on a device also allows the kernel its shared memory there)."""
    key = (device.index, cap, p, tier)
    if key not in _f32_parts:
        parts = ctypes.c_int(0)
        rc = _library().daft_segment_sum_planes_f32_parts(_F32_TIER_IDS[tier.kind], cap, p,
                                                          tier.copies, ctypes.byref(parts))
        if rc != 0:
            raise RuntimeError(f"segment_sum_planes_f32: no launch fits tier {tier} "
                               f"(CUDA error {rc})")
        _f32_parts[key] = parts.value
    return _f32_parts[key]


def segment_sum_planes_f32(planes: torch.Tensor, codes: torch.Tensor,
                           cap: int) -> torch.Tensor:
    """Sum planes (N x P, f32) into segments (cap x P, f32) by codes (N, i32)
    in one f32 accumulation, codes outside [0, cap) dropped.

    Exact for integer-valued planes whose segment totals stay below 2^24;
    otherwise the order of the kernel's atomic adds decides the last bits,
    as the reference's single-window kernel is exact only there."""
    _check(planes, "planes", torch.float32, 2)
    _check(codes, "codes", torch.int32, 1)
    n, p = planes.shape
    if codes.shape[0] != n:
        raise ValueError(f"codes has {codes.shape[0]} rows, planes {n}")
    if not _route(planes, codes):
        counters.bump("plain_segment_sum_planes_f32")
        return segment_sum_planes_f32_plain(planes, codes, cap)
    dev = planes.device
    if n * p == 0 or cap == 0:
        return torch.zeros((cap, p), dtype=torch.float32, device=dev)  # no launch
    tier = segment_sum_f32_tier(cap, p)
    with torch.cuda.device(dev):
        parts = _f32_partial_tables(dev, cap, p, tier)
        if tier.kind == "global":
            out = torch.zeros((cap, p), dtype=torch.float32, device=dev)
            part = out
        else:
            out = torch.empty((cap, p), dtype=torch.float32, device=dev)
            part = torch.empty((parts, cap, p), dtype=torch.float32, device=dev)
        rc = _library().daft_segment_sum_planes_f32(
            planes.data_ptr(), codes.data_ptr(), part.data_ptr(), out.data_ptr(), n, p, cap,
            _F32_TIER_IDS[tier.kind], tier.copies, parts, _stream(planes))
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


def segment_extreme_planes(planes: Sequence[torch.Tensor], codes: torch.Tensor, cap: int,
                           op: str) -> torch.Tensor:
    """min/max of Q planes (each N f32, contiguous, identity-filled) by codes
    (N, i32) into (cap x Q, f32); codes outside [0, cap) are dropped.

    Masked-out rows must already carry the identity (+inf for min, -inf for
    max); an empty segment keeps the identity. NaN is outside the contract."""
    if op not in ("min", "max"):
        raise ValueError(op)
    _check_planes(planes, codes, "segment_extreme_planes")
    if not _route(codes):
        counters.bump("plain_segment_extreme_planes")
        return segment_extreme_planes_plain(planes, codes, cap, op)
    out = torch.empty((cap, len(planes)), dtype=torch.float32, device=codes.device)
    if cap:
        _launch_planes(op, planes, codes, cap, out, "segment_extreme_planes")
    return out


def segment_extreme_planes_plain(planes: Sequence[torch.Tensor], codes: torch.Tensor,
                                 cap: int, op: str) -> torch.Tensor:
    """Plain K2: the planes stacked to (N x Q), ``scatter_reduce_``
    (amin/amax) into an identity-filled table."""
    planes = torch.stack(list(planes), dim=1)
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
    """How K3 lays out its table (ops/csrc/segment_reduce.cu)."""

    cluster: int     # blocks that share one shared-memory table (a thread
                     # block cluster); 0: the global tier, one table in
                     # device memory
    slice: int       # table entries each block holds (global tier: all)
    warp_agg: bool   # lanes with equal codes reduce in the warp first


# entries one block's shared memory holds: 8-byte keys plus a bitmap, 195 KB
# of a block's 227 KB
K3_BLOCK_SLICE_MAX = 24576
# entries per block when a cluster of 2, 4 or 8 blocks splits the table
K3_CLUSTER_SLICE = 16384
# caps this small put every warp's rows on a few addresses: pre-aggregate
K3_WARP_AGG_MAX_CAP = 16
# the largest cluster; past its tables the global tier takes over
K3_MAX_CLUSTER = 8

_k3_parts: Dict[Tuple[int, K3Tier], int] = {}


def segment_extreme_int64_tier(cap: int) -> K3Tier:
    """K3's tier at ``cap``: one table per block while a block's shared
    memory holds cap entries, else one table split across a cluster of the
    fewest blocks (2, 4 or 8) that hold it, else (cap > 2^17) one table in
    device memory (cluster 0); warp pre-aggregation for caps up to
    K3_WARP_AGG_MAX_CAP."""
    if not 0 < cap <= KERNEL_MAX_SEGMENTS:
        raise ValueError(f"K3 takes 1 to {KERNEL_MAX_SEGMENTS} segments, got {cap}")
    if cap <= K3_BLOCK_SLICE_MAX:
        return K3Tier(1, -(-cap // 32) * 32, cap <= K3_WARP_AGG_MAX_CAP)
    if cap > K3_MAX_CLUSTER * K3_CLUSTER_SLICE:
        return K3Tier(0, -(-cap // 32) * 32, False)
    cluster = 2
    while cluster * K3_CLUSTER_SLICE < cap:
        cluster *= 2
    return K3Tier(cluster, K3_CLUSTER_SLICE, False)


def _k3_partial_tables(device: torch.device, tier: K3Tier) -> int:
    """How many partial tables K3's first launch writes at ``tier`` (as many
    blocks or clusters as fit on the card at once; the global tier's grid,
    which writes one table), cached per device."""
    key = (device.index, tier if tier.cluster else None)
    if key not in _k3_parts:
        parts = ctypes.c_int(0)
        if tier.cluster == 0:
            rc = _library().daft_segment_extreme_int64_global_blocks(ctypes.byref(parts))
        else:
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
        if tier.cluster == 0:
            keys = torch.empty((tier.slice,), dtype=torch.int64, device=dev)
            bits = torch.empty((tier.slice // 32,), dtype=torch.int32, device=dev)
            rc = _library().daft_segment_extreme_int64_global(
                vals.data_ptr(), mask.data_ptr(), codes.data_ptr(), keys.data_ptr(),
                bits.data_ptr(), out.data_ptr(), nonempty.data_ptr(), n, cap, tier.slice,
                parts, int(op == "min"), _stream(vals))
            _launched(rc, "segment_extreme_int64")
            return out, nonempty
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


# ---- K7 ----------------------------------------------------------------------------


class FloatTier(NamedTuple):
    """How K7 lays out its f64 tables for one chunk of planes
    (ops/csrc/segment_reduce.cu)."""

    kind: str    # "thread" (a table per thread), "warp" (a table per
                 # consumer warp), "block" (a table per block) or "global"
                 # (one table in device memory: the output)
    group: int   # planes per table; the global tier's one table holds all


# the thread tier's block: each of its threads keeps its own table
K7_THREAD_TIER_THREADS = 256
# caps up to this take the thread tier: few entries, every lane on them
K7_THREAD_MAX_CAP = 32
# the warp tier's consumer warps, each with its own table
K7_WARP_COPIES = 16
# rows of a stage of the warp tier's rings
K7_TILE = 2048
# shared memory the warp tier keeps beside its tables for the barriers
K7_RESERVE = 1024
_FLOAT_TIER_IDS = {"thread": 0, "block": 1, "global": 2, "warp": 3}


def k7_warp_bytes(cap: int, group: int) -> int:
    """The warp tier's shared memory at its smallest ring, for f64 planes
    (f32 planes take less): a table per consumer warp, rounded up to 128
    bytes; two plane stages and four code stages of K7_TILE rows, each
    array with 16 bytes of room for a start off 16-byte alignment; the
    barriers."""
    tables = -(-K7_WARP_COPIES * group * cap * 8 // 128) * 128
    return (tables + 2 * group * (K7_TILE * 8 + 16) + 4 * (K7_TILE * 4 + 16) + K7_RESERVE)


# (device, f64, cap, planes) -> (the call's chunks, scratch doubles)
_float_plans: Dict[Tuple[int, bool, int, int], Tuple[Tuple[_PlaneChunk, ...], int]] = {}


def segment_sum_float_tier(cap: int, nplanes: int) -> FloatTier:
    """K7's tier for a chunk of ``nplanes`` planes at ``cap``: for caps up to
    K7_THREAD_MAX_CAP, a table per thread of ``group`` planes (the most whose
    256 copies fit a block's shared memory); past that, a table per consumer
    warp (K7_WARP_COPIES of them, tiles staged in shared memory by bulk
    copies) while all the chunk's planes fit; else f64 tables of ``group``
    planes in a block's shared memory (the most whose cap x group x 8 bytes
    fit); one table in device memory when a single plane's does not fit."""
    if not 0 < cap <= KERNEL_MAX_SEGMENTS:
        raise ValueError(f"K7 takes 1 to {KERNEL_MAX_SEGMENTS} segments, got {cap}")
    if not 0 < nplanes <= PLANE_CHUNK:
        raise ValueError(f"a chunk holds 1 to {PLANE_CHUNK} planes, got {nplanes}")
    if cap <= K7_THREAD_MAX_CAP:
        per_plane = cap * K7_THREAD_TIER_THREADS * 8
        return FloatTier("thread", min(nplanes, PLANE_SMEM_MAX // per_plane))
    if k7_warp_bytes(cap, nplanes) <= PLANE_SMEM_MAX:
        return FloatTier("warp", nplanes)
    fit = PLANE_SMEM_MAX // (cap * 8)
    if fit == 0:
        return FloatTier("global", nplanes)
    return FloatTier("block", min(nplanes, fit))


def _float_plan(device: int, f64: bool, cap: int,
                p: int) -> Tuple[Tuple[_PlaneChunk, ...], int]:
    """K7's launch pairs for a call on ``p`` planes, one per chunk of
    PLANE_CHUNK, as ``_plane_plan`` lays out K1's: each chunk's tier and
    first-pass grid, and the scratch (f64 partial tables) the largest needs;
    cached per shape."""
    key = (device, f64, cap, p)
    plan = _float_plans.get(key)
    if plan is None:
        chunks = []
        for col in range(0, p, PLANE_CHUNK):
            k = min(PLANE_CHUNK, p - col)
            tier = segment_sum_float_tier(cap, k)
            tier_id = _FLOAT_TIER_IDS[tier.kind]
            fit = ctypes.c_int(0)
            rc = _library().daft_segment_sum_float_planes_blocks(
                int(f64), tier_id, cap, k, tier.group, ctypes.byref(fit))
            if rc != 0:
                raise RuntimeError(f"segment_sum_float_planes: no launch fits tier {tier} at "
                                   f"cap {cap} (CUDA error {rc})")
            groups = -(-k // tier.group)
            blocks = groups * max(1, fit.value // groups)
            words = 0 if tier.kind == "global" else blocks * tier.group * cap
            chunks.append(_PlaneChunk(col, k, tier_id, tier.group, blocks, words))
        plan = _float_plans[key] = (tuple(chunks), max(c.words for c in chunks))
    return plan


def segment_sum_float_planes(planes: Sequence[torch.Tensor], codes: torch.Tensor,
                             cap: int) -> torch.Tensor:
    """Sum P float planes (each N f32, or each N f64; contiguous, one dtype)
    into segments (cap x P, f64) by codes (N, i32); codes outside [0, cap)
    are dropped.

    Every value is widened to f64 and added in f64 (ops/csrc/
    segment_reduce.cu K7). The order of the adds decides the last bits, so
    a result is held to the worst case of f64 summation, not bit for bit."""
    dtype = (planes[0].dtype if isinstance(planes, (list, tuple)) and planes
             else torch.float32)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"segment_sum_float_planes: planes must be float32 or float64, "
                        f"got {dtype}")
    n = _check_planes(planes, codes, "segment_sum_float_planes", dtype)
    if not _route(codes):
        counters.bump("plain_segment_sum_float_planes")
        return segment_sum_float_planes_plain(planes, codes, cap)
    p, dev = len(planes), codes.device
    if cap == 0:
        return torch.empty((0, p), dtype=torch.float64, device=dev)  # no launch
    f64 = dtype is torch.float64
    lib = _library()
    ptrs = [t.data_ptr() for t in planes]
    with torch.cuda.device(dev):
        chunks, words = _float_plan(dev.index, f64, cap, p)
        if chunks[0].tier == _FLOAT_TIER_IDS["global"]:
            out = torch.zeros((cap, p), dtype=torch.float64, device=dev)
        else:
            out = torch.empty((cap, p), dtype=torch.float64, device=dev)
        part = torch.empty((max(words, 1),), dtype=torch.float64, device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream
        for c in chunks:
            rc = lib.daft_segment_sum_float_planes(
                int(f64), (ctypes.c_void_p * c.planes)(*ptrs[c.col:c.col + c.planes]),
                c.planes, codes.data_ptr(), part.data_ptr(), out.data_ptr(), n, cap, c.tier,
                c.group, c.blocks, p, c.col, stream)
            _launched(rc, "segment_sum_float_planes")
    return out


def segment_sum_float_planes_plain(planes: Sequence[torch.Tensor], codes: torch.Tensor,
                                   cap: int) -> torch.Tensor:
    """Plain K7: the planes stacked to (N x P) in f64, one ``index_add_``
    into a table with a trash row."""
    stack = torch.stack([t.double() for t in planes], dim=1)
    inside = (codes >= 0) & (codes < cap)
    safe = torch.where(inside, codes, cap).long()
    out = torch.zeros((cap + 1, stack.shape[1]), dtype=torch.float64, device=stack.device)
    out.index_add_(0, safe, stack)
    return out[:cap].contiguous()
