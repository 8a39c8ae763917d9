"""Device grouped-aggregation stage on the hand-written segment kernels
(counterpart of daft_tpu/ops/grouped_stage.py, its kernel tier).

A stage compiles filter -> grouped aggregation over one input schema into a
function on torch tensors: the predicate and every aggregation child are
evaluated on the device (ops/device_eval.py), and the per-group partials are
reduced by the segment kernels of ops/segment_kernels.py:

- K1 ``segment_sum_planes`` sums the integer-valued planes: the kept-row
  count, one valid-count plane per aggregation, and 8-bit digit planes of
  integer sums (``_isum_digit``; the host recombines them in uint64);
- K7 ``segment_sum_float_planes`` sums the float and bool "sum" planes
  (and, in a stage computed in f64, every sum) in f64;
- K2 ``segment_extreme_planes`` takes the per-group minimum of the local
  first-row index (group order = first occurrence, as on the host);
  all three take their planes as a list, so no (N, P) stack is built;
- K3 ``segment_extreme_int64`` takes exact integer and date minima/maxima,
  and float ones on an order-preserving int64 key of the f64 bits
  (``_float_extreme``).

The output contract is the reference's ``{"mm", "ext", "sct"}`` dict, so
``finalize`` and ``results_from_tables`` merge exactly as the reference does.

A stage with a float min/max computes in f64, as the reference's does, so
its extremes are exact; the others compute in f32 and sum in f64. The
kernels take group codes in place up to ``MAX_SORT_SEGMENTS`` (2^20)
groups, where the reference switches from one-hot matmuls to a sort: the
port has no matmul, sort or local-dense tier. Under ``kernel_mode="off"``
no stage is built (``try_build_grouped_agg_stage`` returns None and records
why), so the aggregation plans to the host. A kernel that fails to build or
launch raises; nothing falls back behind the caller's back. A run whose
group count outgrows the ceiling raises ``DeviceFallback`` before any
launch, and the executor reruns the stage on the host.

Like the reference, the stage (immutable, cached by structure) is separate
from per-run state (``GroupedAggRun``), so a failed run cannot leak into the
next.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.kernels.groupby import extreme_replaces
from ..expressions.expressions import AggExpr, Alias, ColumnRef, Expression
from ..schema import Schema
from . import counters
from . import device_eval as dev
from . import segment_kernels as sk
from .stage import device_row_mask, pad_bucket

_MIN_GROUP_CAP = 8
# the grouped stage's group ceiling: the reference's sort tier's
# (daft_tpu/ops/grouped_stage.py MAX_SORT_SEGMENTS), which the port's kernels
# reach with their tables in device memory; the kernels themselves take up to
# sk.KERNEL_MAX_SEGMENTS, for the join TopN run (ops/device_join.py)
MAX_SORT_SEGMENTS = 1 << 20
# the low 63 bits of an int64: flipped on negative f64 bits for an
# order-preserving key
_F64_LOW63 = 0x7FFF_FFFF_FFFF_FFFF


class DeviceFallback(Exception):
    """Raised (before any device launch) when a stage's runtime shape is
    outside the kernels' envelope; the executor reruns on the host."""


def _pad_groups(g: int) -> int:
    c = _MIN_GROUP_CAP
    while c < g:
        c <<= 1
    return c


_F64_EXACT_KINDS = frozenset({"int8", "int16", "int32", "uint8", "uint16",
                              "uint32", "date", "bool"})


def _f64_exact_dtype(dt) -> bool:
    """True when every value of this dtype is exactly representable in f64:
    <= 32-bit ints, dates, bools."""
    return dt.kind in _F64_EXACT_KINDS


def _static_int_bounds(e) -> Optional[Tuple[int, int]]:
    """Static (lo, hi) value bounds of an integer expression, or None:
    interval arithmetic over literals, if_else, + - * and casts, so a
    CASE-WHEN-1-ELSE-0 sum needs one digit plane instead of eight."""
    from ..expressions.expressions import BinaryOp, Cast, IfElse, Literal

    if isinstance(e, Alias):
        return _static_int_bounds(e.child)
    if isinstance(e, Cast):
        b = _static_int_bounds(e.child)
        if b is None:
            return None
        # a narrowing cast can wrap: pass bounds through only when they fit
        rng = {"int8": (-128, 127), "int16": (-32768, 32767),
               "int32": (-2**31, 2**31 - 1), "int64": (-2**63, 2**63 - 1),
               "uint8": (0, 255), "uint16": (0, 65535),
               "uint32": (0, 2**32 - 1), "uint64": (0, 2**64 - 1)}.get(e.dtype.kind)
        if rng is None or b[0] < rng[0] or b[1] > rng[1]:
            return None
        return b
    if isinstance(e, Literal):
        if isinstance(e.value, bool):
            return (int(e.value), int(e.value))
        if isinstance(e.value, int):
            return (e.value, e.value)
        return None
    if isinstance(e, IfElse):
        a = _static_int_bounds(e.if_true)
        b = _static_int_bounds(e.if_false)
        if a is None or b is None:
            return None
        return (min(a[0], b[0]), max(a[1], b[1]))
    if isinstance(e, BinaryOp) and e.op in ("add", "sub", "mul"):
        a = _static_int_bounds(e.left)
        b = _static_int_bounds(e.right)
        if a is None or b is None:
            return None
        if e.op == "add":
            return (a[0] + b[0], a[1] + b[1])
        if e.op == "sub":
            return (a[0] - b[1], a[1] - b[0])
        corners = [x * y for x in a for y in b]
        return (min(corners), max(corners))
    return None


def _isum_digit(v: torch.Tensor, kind: str) -> torch.Tensor:
    """One 8-bit digit plane of an int sum (kind = "isum<k>:<lo>"): shift the
    offset int64 value and mask a byte. Arithmetic >> keeps two's complement,
    so with lo=0 the 8-digit sum reconstructs sum mod 2^64 exactly. Digits
    are < 256, so every K1 partial stays an exact integer."""
    head, lo = kind.split(":")
    k = int(head[len("isum"):])
    vi = torch.round(v).long() if v.dtype.is_floating_point else v.long()
    u = vi - int(lo)
    return ((u >> (8 * k)) & 255).to(torch.float32)


def _f64_order_key(bits: torch.Tensor) -> torch.Tensor:
    """The int64 key of f64 bits (viewed as int64) whose signed order is the
    floats' order: a negative float's low 63 bits flipped. Its own inverse."""
    return bits ^ ((bits >> 63) & _F64_LOW63)


def _float_extreme(v: torch.Tensor, mask: torch.Tensor, seg: torch.Tensor, cap: int,
                   op: str) -> torch.Tensor:
    """Exact f64 min/max of a float plane per segment through K3, on the
    host path's terms (core/kernels/groupby.py ``_float_extreme``): NaN rows
    are left out of K3's mask, -0.0 folds into +0.0 for the key, and a
    second K3 launch finds each segment's first zero row, whose sign a zero
    result takes."""
    v = v.to(torch.float64)
    folded = v + 0.0
    ok = mask & ~torch.isnan(v)
    key = _f64_order_key(folded.view(torch.int64))
    kv, nonempty = sk.segment_extreme_int64(key.contiguous(), ok.contiguous(), seg, cap, op)
    val = _f64_order_key(kv).view(torch.float64)
    val = torch.where(nonempty, val, float("inf") if op == "min" else float("-inf"))
    rows = torch.arange(v.shape[0], dtype=torch.int64, device=v.device)
    first, has_zero = sk.segment_extreme_int64(rows, ok & (folded == 0), seg, cap, "min")
    zero_sign = torch.copysign(torch.zeros_like(val), v[first.clamp(0, v.shape[0] - 1)])
    return torch.where((val == 0) & has_zero, zero_sign, val)


def cached_dict_code_plane(src, codes: np.ndarray, rows: int, bucket: int,
                           device: torch.device) -> torch.Tensor:
    """Device plane of dictionary codes padded to ``bucket`` (padding rows
    carry code 0 and are masked by the row mask), registered in the
    residency manager anchored on the Series."""
    from ..device.residency import manager

    def build():
        padded = np.zeros(bucket, dtype=np.int32)
        padded[:rows] = codes
        return torch.from_numpy(padded).to(device)

    return manager().get_or_build(src, ("dictcodes", bucket, str(device)), build)


def resolve_key_series(batch, groupby, n: int):
    """Evaluate group-key expressions, resolving Alias(ColumnRef) to the
    stored column so dictionary caches land on the long-lived Series."""
    from ..expressions.eval import eval_expression

    out = []
    for e in groupby:
        node = e.child if isinstance(e, Alias) else e
        if isinstance(node, ColumnRef):
            s = batch.get_column(node._name)
        else:
            s = eval_expression(batch, e)
        if len(s) == 1 and n != 1:
            s = s.broadcast(n)
        out.append(s)
    return out


class GroupedAggStage:
    """Compiled filter -> grouped-agg program (immutable; see start_run())."""

    def __init__(self, schema: Schema, predicate: Optional[Expression],
                 groupby: Sequence[Expression], aggs: Sequence[Tuple[str, AggExpr]]):
        self.schema = schema
        self.predicate = predicate
        self.groupby = list(groupby)
        self.aggs = list(aggs)
        self._programs: Dict[int, Callable] = {}
        self._lock = threading.Lock()
        self._input_cols = self._referenced_columns()
        # group keys take the device dictionary path iff they are bare columns
        self.dict_keys = all(isinstance(g, ColumnRef) or
                             (isinstance(g, Alias) and isinstance(g.child, ColumnRef))
                             for g in groupby)
        # float min/max must be exact: the stage runs wholly in f64, as the
        # reference's does
        self._use_f64 = any(
            agg.op in ("min", "max")
            and agg.child.to_field(schema).dtype.is_floating()
            for _n, agg in self.aggs)
        self._classify_planes()

    def _classify_planes(self) -> None:
        """Assign each aggregation's partials to sum / extreme / scatter slots.

        mm plane 0 is always the kept-row count ("rows"): it decides group
        existence and serves count(mode=all). Every agg also gets a
        valid-count plane (validity of the result = count > 0). Integer sums
        become 8-bit digit planes ("isum") for K1; float and bool sums
        (every sum in an f64 stage) a raw "sum" plane for K7. Extremes of
        <= 32-bit ints, dates and floats are "ext" slots (the float ones
        listed in ``_float_ext``), 64-bit integer extremes "sct" slots; ext
        slot 0 is the first-row index.
        """
        self._mm_specs: List[Tuple[int, str]] = [(-1, "rows")]
        self._ext_specs: List[Tuple[int, str, bool]] = [(-1, "min", True)]  # first-row idx
        self._sct_specs: List[Tuple[int, str]] = []
        self._agg_slots: List[Dict[str, tuple]] = []
        self._float_ext: List[int] = []
        for i, (_name, agg) in enumerate(self.aggs):
            child_dt = agg.child.to_field(self.schema).dtype
            is_float = child_dt.is_floating()
            slots: Dict[str, tuple] = {}
            slots["count"] = ("mm", len(self._mm_specs))
            self._mm_specs.append((i, "count"))
            if agg.op in ("sum", "mean"):
                if is_float or child_dt.is_boolean() or self._use_f64:
                    slots["sum"] = ("mm", len(self._mm_specs))
                    self._mm_specs.append((i, "sum"))
                else:
                    # exact int sum via digit planes; static bounds shrink the
                    # digit count, unknown bounds use all 8 (sum mod 2^64 is
                    # the true sum when it fits int64)
                    bounds = _static_int_bounds(agg.child)
                    if bounds is not None:
                        lo, hi = bounds
                        nd = max(1, (max(hi - lo, 1).bit_length() + 7) // 8)
                    else:
                        lo, nd = 0, 8
                    slots["sum"] = ("imm", len(self._mm_specs), nd, lo)
                    self._mm_specs.extend(
                        [(i, f"isum{k}:{lo}") for k in range(nd)])
            elif agg.op in ("min", "max"):
                if is_float or _f64_exact_dtype(child_dt):
                    if is_float:
                        self._float_ext.append(len(self._ext_specs))
                    slots[agg.op] = ("ext", len(self._ext_specs))
                    self._ext_specs.append((i, agg.op,
                                            self._use_f64 or not is_float))
                else:
                    slots[agg.op] = ("sct", len(self._sct_specs))
                    self._sct_specs.append((i, agg.op))
            self._agg_slots.append(slots)

    def _referenced_columns(self) -> List[str]:
        cols: List[str] = []
        exprs: List[Expression] = [a.child for _, a in self.aggs]
        if self.predicate is not None:
            exprs.append(self.predicate)
        for e in exprs:
            for c in e.referenced_columns():
                if c not in cols:
                    cols.append(c)
        return cols

    def start_run(self, device: torch.device) -> "GroupedAggRun":
        return GroupedAggRun(self, device)

    def sum_routes(self) -> Tuple[List[int], List[int]]:
        """The mm planes by kernel: (K1's, K7's) indices into ``_mm_specs``.
        K1 takes the integer-valued planes (rows, counts, digits), which it
        sums exactly in uint32; K7 the raw "sum" planes in f64."""
        k1 = [j for j, (_i, kind) in enumerate(self._mm_specs) if kind != "sum"]
        k7 = [j for j, (_i, kind) in enumerate(self._mm_specs) if kind == "sum"]
        return k1, k7

    def _program_for(self, cap: int) -> Callable:
        with self._lock:
            prog = self._programs.get(cap)
            if prog is None:
                prog = self._programs[cap] = self._build_kernel(cap)
        return prog

    def _build_kernel(self, cap: int) -> Callable:
        """The stage's program at ``cap``: the output contract of the
        reference's tiers ({"mm","ext","sct"}), compute routed through
        ops/segment_kernels.py. Every K1 plane is integer-valued
        (``sum_routes``), and the first-row index rides an f32 plane (exact
        while bucket < 2^24, checked per call)."""
        schema = self.schema
        fdt = torch.float64 if self._use_f64 else torch.float32
        pred_fn = (dev.build_device_expr(self.predicate, schema, float_dtype=fdt)
                   if self.predicate is not None else None)
        child_fns = []
        for _name, agg in self.aggs:
            count_all = agg.op == "count" and agg.params.get("mode", "valid") == "all"
            child_fns.append((dev.build_device_expr(agg.child, schema, float_dtype=fdt),
                              count_all))
        mm_specs, ext_specs = self._mm_specs, self._ext_specs
        sct_specs = self._sct_specs
        k1_cols, k7_cols = self.sum_routes()
        float_ext = set(self._float_ext)

        def stage(cols: Dict[str, dev.DCol], codes: torch.Tensor,
                  row_mask: torch.Tensor, row_offset: int) -> dict:
            bucket = codes.shape[0]
            device = codes.device
            if bucket >= sk.MAX_KERNEL_BUCKET:
                raise ValueError(
                    f"kernel tier: bucket {bucket} exceeds the f32-exact "
                    f"first-row-index range {sk.MAX_KERNEL_BUCKET}")
            if pred_fn is not None:
                pv, pm = pred_fn(cols, device)
                keep = pv.bool() & pm & row_mask
            else:
                keep = row_mask
            seg = torch.where(keep, codes, cap).to(torch.int32)

            evaluated = []
            for fn, count_all in child_fns:
                v, m = fn(cols, device)
                # a scalar child (a literal) broadcasts to the bucket's shape
                if v.shape != seg.shape:
                    v = v.expand(seg.shape)
                mask = keep if count_all else dev._broadcast_valid(v, m) & keep
                evaluated.append((v, mask))

            planes, float_planes = [], []
            for agg_idx, kind in mm_specs:
                if kind == "rows":
                    planes.append(keep.to(torch.float32))
                elif kind == "count":
                    planes.append(evaluated[agg_idx][1].to(torch.float32))
                elif kind == "sum":  # float or bool, or any sum of an f64 stage
                    v, mask = evaluated[agg_idx]
                    float_planes.append(torch.where(mask, v.to(fdt), 0.0))
                else:  # isum digit
                    v, mask = evaluated[agg_idx]
                    planes.append(torch.where(mask, _isum_digit(v, kind), 0.0))

            # every plane above is a fresh full-length tensor (an elementwise
            # result, never a broadcast view): the kernels read them in place
            acc_mm = sk.segment_sum_planes(planes, seg, cap)
            if float_planes:
                sums = sk.segment_sum_float_planes(float_planes, seg, cap)
                table = torch.empty((cap, len(mm_specs)), dtype=torch.float64, device=device)
                table[:, k1_cols] = acc_mm
                table[:, k7_cols] = sums
                acc_mm = table

            # ext slot 0, the first-row index, is K2's min over a LOCAL f32
            # arange; row_offset folds back in f64 after the kernel (+inf =
            # empty group)
            first = torch.where(keep, torch.arange(bucket, dtype=torch.float32, device=device),
                                float("inf"))
            r0 = sk.segment_extreme_planes([first], seg, cap, "min")[:, 0]
            ext_out: List = [torch.where(torch.isfinite(r0),
                                         r0.to(torch.float64) + float(row_offset),
                                         float("inf"))]
            # the other ext slots are exact through K3 and decode to the f64
            # plane contract (+-inf = empty group): integers and dates as they
            # are, floats (in the f64 stage) on an order-preserving key
            for slot, (agg_idx, op, _exact) in enumerate(ext_specs[1:], start=1):
                v, mask = evaluated[agg_idx]
                if slot in float_ext:
                    ext_out.append(_float_extreme(v, mask, seg, cap, op))
                    continue
                vals, nonempty = sk.segment_extreme_int64(
                    v.to(torch.int64).contiguous(), mask.contiguous(), seg, cap, op)
                big = float("inf") if op == "min" else float("-inf")
                ext_out.append(torch.where(nonempty, vals.to(torch.float64), big))
            # int64 scatter slots keep their native int64 identity fill
            scts = []
            for agg_idx, kind in sct_specs:
                v, mask = evaluated[agg_idx]
                vals, _nonempty = sk.segment_extreme_int64(
                    v.to(torch.int64).contiguous(), mask.contiguous(), seg, cap, kind)
                scts.append(vals)
            return {"mm": acc_mm, "ext": tuple(ext_out), "sct": tuple(scts)}

        return stage


class GroupedAggRun:
    """Per-run accumulator. Launches stay queued on the device; every batch's
    tables are copied to the host once, at finalize, and merged there."""

    def __init__(self, stage: GroupedAggStage, device: torch.device):
        self.stage = stage
        self.device = device
        self._pending: List[Tuple[dict, "_Decode"]] = []
        self._row_offset = 0

    def feed_batch(self, batch) -> None:
        stage = self.stage
        n = batch.num_rows
        if n == 0:
            return
        bucket = pad_bucket(n)
        decode = self._codes_for(batch, n, bucket)
        prog = stage._program_for(decode.cap)
        dcols = {name: batch.get_column(name).to_device_cached(
                     bucket, f32=not stage._use_f64, device=self.device)
                 for name in stage._input_cols}
        out = prog(dcols, decode.dcodes, device_row_mask(n, bucket, self.device),
                   self._row_offset)
        self._row_offset += n
        self._pending.append((out, decode))
        counters.bump("device_grouped_batches")

    def _codes_for(self, batch, n: int, bucket: int) -> "_Decode":
        """Segment codes for one batch: the device combine of per-column
        dictionary codes when the keys are plain columns whose code product
        fits the kernels' segment ceiling, else a host factorize.

        Raises DeviceFallback (before any launch) when the group count
        exceeds the ceiling: the executor reruns the whole stage on the host.
        """
        stage = self.stage
        key_series = resolve_key_series(batch, stage.groupby, n)

        if stage.dict_keys:
            encoded = [s.dict_codes() for s in key_series]
            total = 1
            for _, _, k in encoded:
                total *= max(k, 1)
            if 0 < total <= MAX_SORT_SEGMENTS:
                cap = _pad_groups(total)
                dcode_cols = [cached_dict_code_plane(s, codes, n, bucket, self.device)
                              for s, (codes, _, _) in zip(key_series, encoded)]
                radices = []
                mult = 1
                for _, _, k in reversed(encoded):
                    radices.append(mult)
                    mult *= max(k, 1)
                radices.reverse()
                combined = dcode_cols[0] * radices[0]
                for dc, r in zip(dcode_cols[1:], radices[1:]):
                    combined = combined + dc * r
                return _Decode(cap=cap, dcodes=combined,
                               dicts=[(vals, k) for _, vals, k in encoded],
                               radices=radices, key_rows=None)

        # host factorize of the full key rows for this batch, cached on the
        # batch so repeated queries over a resident table skip it
        gb_key = ("__group_codes__",) + tuple(repr(e) for e in stage.groupby)
        cache = batch.stage_cache()
        if gb_key in cache:
            group_ids, num_groups, key_rows = cache[gb_key]
        else:
            from ..core.kernels.groupby import make_groups

            first_idx, group_ids, _ = make_groups(key_series)
            num_groups = len(first_idx)
            key_rows = list(zip(*[s.take(first_idx).to_pylist() for s in key_series])) \
                if num_groups else []
            cache[gb_key] = (group_ids, num_groups, key_rows)
        cap = _pad_groups(max(num_groups, 1))
        if cap > MAX_SORT_SEGMENTS:
            raise DeviceFallback(
                f"grouped stage has {num_groups} groups > {MAX_SORT_SEGMENTS} "
                "segment ceiling")
        codes = np.full(bucket, cap, dtype=np.int32)
        codes[:n] = group_ids
        return _Decode(cap=cap, dcodes=torch.from_numpy(codes).to(self.device),
                       dicts=None, radices=None, key_rows=key_rows)

    def finalize(self):
        """Returns (key_rows, agg_results); agg_results[i] = (values, valid).

        One device-to-host copy of every pending batch's tables, then a
        vectorized host merge. Group order matches the host engine: first
        occurrence in the stream, from the first-row-index plane.
        """
        stage = self.stage
        pending, self._pending = self._pending, []
        self._row_offset = 0
        counters.bump("device_stage_runs")
        if not pending:
            return [], [(np.empty(0), np.empty(0, dtype=bool)) for _ in stage.aggs]

        fetched = [_to_host(out) for out, _ in pending]

        key_slot: Dict[tuple, int] = {}
        key_order: List[tuple] = []
        first_seen: List[float] = []
        n_mm = len(stage._mm_specs)
        mm_parts: List[np.ndarray] = []
        ext_parts: List[List[np.ndarray]] = []
        sct_parts: List[List[np.ndarray]] = []
        slot_maps: List[np.ndarray] = []

        for out, decode in zip(fetched, (d for _, d in pending)):
            mm = out["mm"]
            present = np.flatnonzero(mm[:, 0] > 0)
            keys = decode.keys_for(present)
            firsts = out["ext"][0][present]
            slots = np.empty(len(present), dtype=np.int64)
            for j, key in enumerate(keys):
                slot = key_slot.get(key)
                if slot is None:
                    slot = len(key_order)
                    key_slot[key] = slot
                    key_order.append(key)
                    first_seen.append(float(firsts[j]))
                elif firsts[j] < first_seen[slot]:
                    first_seen[slot] = float(firsts[j])
                slots[j] = slot
            slot_maps.append(slots)
            mm_parts.append(mm[present])
            ext_parts.append([e[present] for e in out["ext"]])
            sct_parts.append([s[present] for s in out["sct"]])

        g = len(key_order)
        mm_acc = np.zeros((g, n_mm), dtype=np.float64)
        ext_acc = [np.full(g, np.inf if op == "min" else -np.inf)
                   for _, op, _ in stage._ext_specs]
        info = np.iinfo(np.int64)
        sct_acc = [np.full(g, info.max if kind == "min" else info.min, dtype=np.int64)
                   for _, kind in stage._sct_specs]
        for slots, mm, exts, scts in zip(slot_maps, mm_parts, ext_parts, sct_parts):
            np.add.at(mm_acc, slots, mm)
            for k, (spec, e) in enumerate(zip(stage._ext_specs, exts)):
                if k in stage._float_ext:
                    # a batch's slots are distinct, and batches come in row order
                    win = extreme_replaces(spec[1], e, ext_acc[k][slots])
                    ext_acc[k][slots[win]] = e[win]
                    continue
                uf = np.minimum if spec[1] == "min" else np.maximum
                uf.at(ext_acc[k], slots, e.astype(np.float64))
            for k, ((_idx, kind), s) in enumerate(zip(stage._sct_specs, scts)):
                uf = np.minimum if kind == "min" else np.maximum
                uf.at(sct_acc[k], slots, s)

        # order groups by first occurrence (matches host groupby semantics)
        order = np.argsort(np.asarray(first_seen), kind="stable")
        key_rows = [key_order[i] for i in order]
        mm_acc = mm_acc[order]
        ext_acc = [e[order] for e in ext_acc]
        sct_acc = [s[order] for s in sct_acc]
        return key_rows, results_from_tables(stage, mm_acc, ext_acc, sct_acc)


def _to_host(out: dict) -> dict:
    return {"mm": out["mm"].cpu().numpy(),
            "ext": [e.cpu().numpy() for e in out["ext"]],
            "sct": [s.cpu().numpy() for s in out["sct"]]}


def results_from_tables(stage: GroupedAggStage, mm_acc, ext_acc, sct_acc):
    """Per-agg (values, valid) arrays from accumulated plane tables."""
    g = len(mm_acc)
    results = []
    for (_name, agg), slots in zip(stage.aggs, stage._agg_slots):
        op = agg.op
        count_all = op == "count" and agg.params.get("mode", "valid") == "all"
        cnt = mm_acc[:, 0] if count_all else mm_acc[:, slots["count"][1]]
        if op == "count":
            results.append((cnt.astype(np.int64), np.ones(g, dtype=bool)))
            continue
        valid = cnt > 0
        if op in ("sum", "mean"):
            if slots["sum"][0] == "imm":
                # recombine digits in uint64 modular arithmetic: digit totals
                # are exact integers in the f64 table, and for the 8-digit
                # case the wrap mod 2^64 is the two's-complement sum
                _k, base, nd, lo = slots["sum"]
                acc = np.zeros(g, dtype=np.uint64)
                for k in range(nd):
                    acc = acc + (mm_acc[:, base + k].astype(np.uint64)
                                 << np.uint64(8 * k))
                s_int = acc.view(np.int64) + np.int64(lo) * cnt.astype(np.int64)
                if op == "mean":
                    results.append((s_int.astype(np.float64) / np.maximum(cnt, 1), valid))
                else:
                    results.append((s_int, valid))
                continue
            s = mm_acc[:, slots["sum"][1]]
            results.append((s / np.maximum(cnt, 1) if op == "mean" else s, valid))
        else:  # min / max
            kind, idx = slots[op]
            results.append((sct_acc[idx] if kind == "sct" else ext_acc[idx], valid))
    return results


class _Decode:
    """How to map a segment id back to its key tuple for one batch."""

    def __init__(self, cap: int, dcodes, dicts, radices, key_rows, fact_codes=None):
        self.cap = cap
        self.dcodes = dcodes
        self.dicts = dicts          # [(values, K)] per key column (dict mode)
        self.radices = radices
        self.key_rows = key_rows    # first-occurrence key tuples (host mode)
        # a join run's host factorize (ops/device_join.py _FactorizedCodes),
        # which builds the key tuples of the groups asked for
        self.fact_codes = fact_codes

    def keys_for(self, segs: np.ndarray) -> List[tuple]:
        """Key tuples of the segments ``segs``, in any mode."""
        if self.fact_codes is not None:
            return self.fact_codes.rows_for(segs)
        if self.key_rows is not None:
            return [self.key_rows[g] for g in segs]
        return self.decode_keys(segs)

    def decode_keys(self, segs: np.ndarray) -> List[tuple]:
        """Key tuples of the segments ``segs`` (dict mode)."""
        cols = []
        rest = np.asarray(segs, dtype=np.int64)
        for (values, _k), r in zip(self.dicts, self.radices):
            digit, rest = np.divmod(rest, r)
            cols.append([values[d] for d in digit.tolist()])
        return list(zip(*cols))


_STAGE_CACHE: Dict[tuple, GroupedAggStage] = {}
_CACHE_LOCK = threading.Lock()


def try_build_grouped_agg_stage(schema: Schema, predicate: Optional[Expression],
                                groupby: Sequence[Expression],
                                agg_exprs: Sequence[Expression]) -> Optional[GroupedAggStage]:
    """A device grouped-agg stage when the predicate and every aggregation
    are device-evaluable, else None (with the reason recorded in
    ``counters.rejections``), so the aggregation plans to the host.

    Group keys are unconstrained beyond being non-aggregate expressions: they
    factorize on the host or through cached per-column dictionaries. Stages
    are cached by structure; run state lives in GroupedAggRun.
    """
    from ..config import execution_config
    from .stage import stage_cache_key

    site = "grouped agg"
    if execution_config().kernel_mode == "off":
        counters.reject(site, "kernel_mode is off and the port has no other device tier")
        return None
    key = stage_cache_key(schema, predicate, list(groupby) + list(agg_exprs))
    with _CACHE_LOCK:
        cached = _STAGE_CACHE.get(key)
    if cached is not None:
        return cached
    if not groupby:
        counters.reject(site, "no group keys")
        return None
    if predicate is not None and not dev.is_device_evaluable(predicate, schema):
        counters.reject(site, "predicate is not device-evaluable")
        return None
    aggs: List[Tuple[str, AggExpr]] = []
    for e in agg_exprs:
        name = e.name()
        inner = e
        while isinstance(inner, Alias):
            inner = inner.child
        if not isinstance(inner, AggExpr):
            counters.reject(site, "aggregation is not a bare AggExpr")
            return None
        if inner.op == "count" and inner.params.get("mode", "valid") == "null":
            counters.reject(site, "count(mode=null)")
            return None
        if not dev.is_device_evaluable(inner.child, schema):
            counters.reject(site, "aggregation child is not device-evaluable")
            return None
        aggs.append((name, inner))
    for g in groupby:
        if g.has_agg():
            counters.reject(site, "group key holds an aggregation")
            return None
    stage = GroupedAggStage(schema, predicate, groupby, aggs)
    with _CACHE_LOCK:
        _STAGE_CACHE[key] = stage
    return stage
