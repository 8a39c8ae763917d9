"""Device grouped-aggregation stage on the hand-written segment kernels
(counterpart of daft_tpu/ops/grouped_stage.py, its kernel tier).

A stage compiles filter -> grouped aggregation over one input schema into a
function on torch tensors: the predicate and every aggregation child are
evaluated on the device (ops/device_eval.py), and the per-group partials are
reduced by the segment kernels of ops/segment_kernels.py:

- K1 ``segment_sum_planes`` sums the integer-valued planes: the kept-row
  count, one valid-count plane per aggregation, and 8-bit digit planes of
  integer sums (``_isum_digit``; the host recombines them in uint64);
- K2 ``segment_extreme_planes`` takes the per-group minimum of the local
  first-row index (group order = first occurrence, as on the host);
  both take their planes as a list, so no (N, P) stack is built;
- K3 ``segment_extreme_int64`` takes exact integer and date minima/maxima.

The output contract is the reference's ``{"mm", "ext", "sct"}`` dict, so
``finalize`` and ``results_from_tables`` merge exactly as the reference does.

The port has only this tier so far (the matmul, sort and local-dense tiers
are later work): a stage that ``_kernel_eligible`` refuses, or any stage under
``kernel_mode="off"``, is not built (``try_build_grouped_agg_stage`` returns
None and records why), so it plans to the host. A kernel that fails to build
or launch raises; nothing falls back behind the caller's back. A run whose
group count outgrows the kernels' segment ceiling raises ``DeviceFallback``
before any launch, and the executor reruns the stage on the host.

Like the reference, the stage (immutable, cached by structure) is separate
from per-run state (``GroupedAggRun``), so a failed run cannot leak into the
next.
"""

from __future__ import annotations

import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..expressions.expressions import AggExpr, Alias, ColumnRef, Expression
from ..schema import Schema
from . import counters
from . import device_eval as dev
from . import segment_kernels as sk
from .stage import device_row_mask, pad_bucket

_MIN_GROUP_CAP = 8


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
        # float min/max must be exact: the reference runs such stages wholly
        # in f64 on its XLA tiers, which the kernel tier does not serve
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
        become 8-bit digit planes ("isum"); float and bool sums a raw "sum"
        plane (which the kernel tier refuses). Extremes of <= 32-bit ints,
        dates and floats are "ext" slots, 64-bit integer extremes "sct"
        slots; ext slot 0 is the first-row index.
        """
        self._mm_specs: List[Tuple[int, str]] = [(-1, "rows")]
        self._ext_specs: List[Tuple[int, str, bool]] = [(-1, "min", True)]  # first-row idx
        self._sct_specs: List[Tuple[int, str]] = []
        self._agg_slots: List[Dict[str, tuple]] = []
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

    def _kernel_eligible(self) -> bool:
        """Exactness contract of the kernel tier: K1 is exact only for
        integer-valued planes (rows, counts, digits), so raw float or bool
        sums and f64 stages (float min/max) are refused. Integer extremes, ext
        planes and int64 scatter slots alike, are exact through K3."""
        if self._use_f64:
            return False
        for _idx, kind in self._mm_specs:
            if not (kind in ("rows", "count") or kind.startswith("isum")):
                return False
        for _idx, kind in self._sct_specs:
            if kind not in ("min", "max"):
                return False
        return True

    def _program_for(self, cap: int) -> Callable:
        with self._lock:
            prog = self._programs.get(cap)
            if prog is None:
                prog = self._programs[cap] = self._build_kernel(cap)
        return prog

    def _build_kernel(self, cap: int) -> Callable:
        """The kernel tier: same output contract as the reference's
        ``_build_pallas`` ({"mm","ext","sct"}), compute routed through
        ops/segment_kernels.py. Only built for stages that pass
        ``_kernel_eligible``, so every K1 plane is integer-valued, and the
        first-row index rides an f32 plane (exact while bucket < 2^24,
        checked per call)."""
        schema = self.schema
        fdt = torch.float32
        pred_fn = (dev.build_device_expr(self.predicate, schema, float_dtype=fdt)
                   if self.predicate is not None else None)
        child_fns = []
        for _name, agg in self.aggs:
            count_all = agg.op == "count" and agg.params.get("mode", "valid") == "all"
            child_fns.append((dev.build_device_expr(agg.child, schema, float_dtype=fdt),
                              count_all))
        mm_specs, ext_specs = self._mm_specs, self._ext_specs
        sct_specs = self._sct_specs

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

            planes = []
            for agg_idx, kind in mm_specs:
                if kind == "rows":
                    planes.append(keep.to(torch.float32))
                elif kind == "count":
                    planes.append(evaluated[agg_idx][1].to(torch.float32))
                else:  # isum digit: _kernel_eligible admits nothing else
                    v, mask = evaluated[agg_idx]
                    planes.append(torch.where(mask, _isum_digit(v, kind), 0.0))

            # extreme planes grouped by op for one K2 launch each; the
            # first-row index (slot 0) rides the min family as a LOCAL f32
            # arange, and row_offset folds back in f64 after the kernel
            min_slots, max_slots = [], []
            min_planes, max_planes = [], []
            int_ext = []    # (slot, agg_idx, op): exact-int64 extreme family
            for slot, (agg_idx, op, use_f64) in enumerate(ext_specs):
                if agg_idx < 0:
                    v = torch.arange(bucket, dtype=torch.float32, device=device)
                    mask = keep
                elif use_f64:
                    # integer/date extreme: exact through K3
                    int_ext.append((slot, agg_idx, op))
                    continue
                else:
                    v, mask = evaluated[agg_idx]
                    v = v.to(torch.float32)
                big = float("inf") if op == "min" else float("-inf")
                plane = torch.where(mask, v, big)
                if op == "min":
                    min_slots.append(slot)
                    min_planes.append(plane)
                else:
                    max_slots.append(slot)
                    max_planes.append(plane)

            # every plane above is a fresh full-length tensor (an elementwise
            # result, never a broadcast view): the kernels read them in place
            acc_mm = sk.segment_sum_planes(planes, seg, cap)
            ext_out: List = [None] * len(ext_specs)
            for op, slots_, planes_ in (("min", min_slots, min_planes),
                                        ("max", max_slots, max_planes)):
                if planes_:
                    red = sk.segment_extreme_planes(planes_, seg, cap, op)
                    for j, slot in enumerate(slots_):
                        ext_out[slot] = red[:, j]
            # slot 0 back to the global f64 index contract (+inf = empty group)
            r0 = ext_out[0]
            ext_out[0] = torch.where(torch.isfinite(r0),
                                     r0.to(torch.float64) + float(row_offset),
                                     float("inf"))
            # integer ext planes decode back to the f64 plane contract
            # (+-inf = empty group); int64 scatter slots keep their native
            # int64 identity fill
            for slot, agg_idx, op in int_ext:
                v, mask = evaluated[agg_idx]
                vals, nonempty = sk.segment_extreme_int64(
                    v.to(torch.int64).contiguous(), mask.contiguous(), seg, cap, op)
                big = float("inf") if op == "min" else float("-inf")
                ext_out[slot] = torch.where(nonempty, vals.to(torch.float64), big)
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
                     bucket, f32=True, device=self.device)
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
            if 0 < total <= sk.KERNEL_MAX_SEGMENTS:
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
        if cap > sk.KERNEL_MAX_SEGMENTS:
            raise DeviceFallback(
                f"grouped stage has {num_groups} groups > {sk.KERNEL_MAX_SEGMENTS} "
                "kernel segment ceiling")
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
            if decode.key_rows is None:
                keys = decode.decode_keys(present)
            else:
                keys = [decode.key_rows[g] for g in present]
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

    def __init__(self, cap: int, dcodes, dicts, radices, key_rows):
        self.cap = cap
        self.dcodes = dcodes
        self.dicts = dicts          # [(values, K)] per key column (dict mode)
        self.radices = radices
        self.key_rows = key_rows    # first-occurrence key tuples (host mode)

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
    qualify for the kernel tier, else None (with the reason recorded in
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
    if not stage._kernel_eligible():
        counters.reject(site, "float/bool sum or float min/max: outside the "
                              "kernel tier's exactness contract")
        return None
    with _CACHE_LOCK:
        _STAGE_CACHE[key] = stage
    return stage
