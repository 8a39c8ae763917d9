"""The ungrouped device stage and the helpers the device stages share
(counterpart of daft_tpu/ops/stage.py).

``FilterAggStage`` compiles filter -> ungrouped aggregation (the TPC-H q6
shape) into a function on torch tensors: the predicate and every
aggregation child are evaluated on the device (ops/device_eval.py) and each
aggregation's partials reduced with torch's masked reductions
(``device_agg``), the counterpart of the reference's XLA reductions: no
Pallas kernel served this stage there. Per-run state lives in
``FilterAggRun``, so a failed run cannot leak into the next.
``DispatchCoalescer`` folds a stream of small morsels into fewer, fuller
batches before a device stage run takes them.

Batches pad to power-of-two row buckets (padding rows ride along invalid),
so a stage sees O(log rows) distinct shapes; the reference needs this for
XLA's static shapes, the port keeps it so the first-row-index and code
planes keep the reference's layout and bounds.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.kernels.groupby import extreme_replaces
from ..expressions.expressions import AggExpr, Alias, Expression
from ..observability.metrics import registry
from ..observability.runtime_stats import profile_span
from ..schema import Schema
from . import counters
from . import device_eval as dev

_MIN_BUCKET = 512


def pad_bucket(n: int) -> int:
    """Smallest power of two >= n (and >= _MIN_BUCKET)."""
    b = _MIN_BUCKET
    while b < n:
        b <<= 1
    return b


_ROW_MASK_CACHE: Dict[Tuple[int, int, str], object] = {}
_CACHE_LOCK = threading.Lock()


def device_row_mask(n: int, bucket: int, device):
    """bool[bucket] on ``device`` with the first n rows set, cached per
    (n, bucket, device) so repeated dispatches do not rebuild it."""
    import torch

    key = (n, bucket, str(device))
    with _CACHE_LOCK:
        cached = _ROW_MASK_CACHE.get(key)
    if cached is not None:
        return cached
    mask = torch.zeros(bucket, dtype=torch.bool, device=device)
    mask[:n] = True
    with _CACHE_LOCK:
        _ROW_MASK_CACHE[key] = mask
        while len(_ROW_MASK_CACHE) > 64:
            _ROW_MASK_CACHE.pop(next(iter(_ROW_MASK_CACHE)))
    return mask


def stage_cache_key(schema, predicate, exprs) -> tuple:
    return (
        tuple((f.name, repr(f.dtype)) for f in schema),
        repr(predicate),
        tuple(repr(e) for e in exprs),
    )


def _decompose_agg(op: str) -> List[str]:
    """The partial aggregations that compute ``op`` across batches."""
    if op == "mean":
        return ["sum", "count"]
    if op in ("sum", "count", "min", "max"):
        return [op]
    raise ValueError(f"agg {op!r} has no device decomposition")


def _combine_partials(op: str, parts: List[Dict[tuple, tuple]], name: str):
    """The final value of one aggregation from its per-batch partials, on
    the host (None where no row was valid). Extremes merge in batch order by
    ``extreme_replaces``; a NaN partial (all of its batch's values NaN) is
    the result only when every batch's is (core/kernels/groupby.py
    ``_agg_columns``)."""
    if op == "count":
        return int(sum(p[(name, "count")][0] for p in parts))
    vals = [p[(name, op if op != "mean" else "sum")] for p in parts]
    if op == "mean":
        total = sum(v for v, ok in vals if ok)
        cnt = sum(p[(name, "count")][0] for p in parts)
        return (total / cnt) if cnt else None
    good = [v for v, ok in vals if ok]
    if not good:
        return None
    if op == "sum":
        return sum(good)
    numbers = [v for v in good if v == v]  # NaN only where every batch's is
    if not numbers:
        return good[0]
    best = numbers[0]
    for v in numbers[1:]:
        if extreme_replaces(op, v, best):
            best = v
    return best


class FilterAggStage:
    """Compiled filter -> ungrouped-aggregation program (immutable; see
    start_run())."""

    def __init__(self, schema: Schema, predicate: Optional[Expression],
                 aggs: Sequence[Tuple[str, AggExpr]]):
        self.schema = schema
        self.predicate = predicate
        self.aggs = list(aggs)
        self._program = None
        self._lock = threading.Lock()
        self._input_cols = self._referenced_columns()
        # float min/max must be exact: such stages run wholly in f64, as the
        # reference's do, and so do those that round a float to decimals
        # (device_eval.needs_f64); the others compute in f32 and sum in f64
        self._use_f64 = any(
            agg.op in ("min", "max") and agg.child.to_field(schema).dtype.is_floating()
            for _n, agg in self.aggs) or dev.needs_f64(
                [a.child for _n, a in self.aggs] + [predicate], schema)

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

    def start_run(self, device) -> "FilterAggRun":
        return FilterAggRun(self, device)

    def program(self):
        """``fn(cols, row_mask) -> {(name, partial op): (value, valid)}`` of
        0-d tensors, built once."""
        with self._lock:
            if self._program is None:
                self._program = self._build()
        return self._program

    def _build(self):
        import torch

        schema = self.schema
        fdt = torch.float64 if self._use_f64 else torch.float32
        pred_fn = (dev.build_device_expr(self.predicate, schema, float_dtype=fdt)
                   if self.predicate is not None else None)
        agg_specs = []
        for name, agg in self.aggs:
            child_fn = dev.build_device_expr(agg.child, schema, float_dtype=fdt)
            count_all = agg.op == "count" and agg.params.get("mode", "valid") == "all"
            agg_specs.append((name, agg.op, count_all, child_fn))

        def stage(cols: Dict[str, dev.DCol], row_mask):
            device = row_mask.device
            if pred_fn is not None:
                pv, pm = pred_fn(cols, device)
                keep = pv.bool() & pm & row_mask
            else:
                keep = row_mask
            out = {}
            for name, op, count_all, child_fn in agg_specs:
                v, m = child_fn(cols, device)
                if v.shape != keep.shape:  # a literal child broadcasts
                    v = v.expand(keep.shape)
                m = keep if count_all else dev._broadcast_valid(v, m) & keep
                for partial_op in _decompose_agg(op):
                    out[(name, partial_op)] = dev.device_agg(partial_op, v, m)
            return out

        return stage


class FilterAggRun:
    """Per-run accumulator for a FilterAggStage. Each batch's partials stay
    on the device until finalize, which copies them all to the host at once
    (one copy per value type)."""

    def __init__(self, stage: FilterAggStage, device):
        self.stage = stage
        self.device = device
        self._partials: List[Dict[tuple, tuple]] = []

    def _run(self, dcols: Dict[str, dev.DCol], n: int, bucket: int) -> None:
        """The stage over one batch's device columns; its partials stay on
        the device until finalize."""
        with profile_span("device.dispatch", "device", op="filter_agg", rows=n,
                          bucket=bucket):
            self._partials.append(self.stage.program()(
                dcols, device_row_mask(n, bucket, self.device)))
        counters.bump("device_stage_batches")

    def feed_batch(self, batch) -> None:
        """One host RecordBatch through the stage (its referenced columns
        uploaded, cached in the residency manager)."""
        n = batch.num_rows
        if n == 0:
            return
        bucket = pad_bucket(n)
        f32 = not self.stage._use_f64
        with profile_span("device.h2d", "device", rows=n, bucket=bucket):
            dcols = {name: batch.get_column(name).to_device_cached(bucket, f32=f32,
                                                                   device=self.device)
                     for name in self.stage._input_cols}
        self._run(dcols, n, bucket)

    def finalize(self) -> Dict[str, object]:
        """{aggregation name: its value} (None where no row was valid)."""
        import torch

        partials, self._partials = self._partials, []
        counters.bump("device_stage_runs")
        values = [v for p in partials for v, _ok in p.values()]
        fetched = {}
        # the copies wait for the run's kernels: the device time lands here
        with profile_span("device.d2h", "device", op="filter_agg", batches=len(partials)):
            for is_float in (True, False):
                pick = [j for j, v in enumerate(values) if v.is_floating_point() == is_float]
                if pick:
                    host = torch.stack([values[j] for j in pick]).cpu().tolist()
                    fetched.update(zip(pick, host))
            oks = (torch.stack([ok for p in partials for _v, ok in p.values()]).cpu().tolist()
                   if partials else [])
        per_batch, j = [], 0
        for p in partials:
            per_batch.append({k: (fetched[j + i], bool(oks[j + i])) for i, k in enumerate(p)})
            j += len(p)
        out = {}
        for name, agg in self.stage.aggs:
            if not per_batch:
                out[name] = 0 if agg.op == "count" else None
            else:
                out[name] = _combine_partials(agg.op, per_batch, name)
        return out


class DispatchCoalescer:
    """Morsel -> super-batch accumulator for one device stage run.

    Every stage call pads its rows to a power-of-two bucket and pays a fixed
    host cost, so a stream of small morsels pays that cost per morsel and
    uploads mostly padding. The coalescer keeps the incoming host
    RecordBatches and feeds ONE concatenated batch when either

    - the pending rows reach ``target_rows`` (``batch_fill_target`` of the
      bucket at the configured morsel size), so the bucket the batch pads to
      is at least that full, or
    - a morsel ARRIVES after the oldest pending one has waited past the
      latency bound. The coalescer is pull-driven: the deadline is checked
      at each ``add()``, never by a timer thread, so a stalled upstream
      flushes on the next arrival or at ``close()``.

    A flush of one pending batch hands the ORIGINAL batch on: the residency
    caches are keyed on the identity of each column Series
    (device/residency.py), so a concat there would rebuild every resident
    plane on every warm run.

    Counters, once per flush: ``coalesce_morsels_in`` / ``dispatch_coalesced``
    give the amortization factor, ``bucket_fill_rows`` /
    ``bucket_capacity_rows`` the padding efficiency, and the
    ``bucket_fill_ratio`` gauge this run's fill so far. Each flush is a
    "device.coalesce_flush" span while a span recorder is active.
    """

    def __init__(self, feed: Callable, target_rows: int, latency_s: float):
        self._feed = feed
        self._target = max(int(target_rows), 1)
        self._latency = max(float(latency_s), 0.0)
        self._pending: List = []
        self._rows = 0
        self._oldest: Optional[float] = None
        self._filled = 0
        self._capacity = 0

    def add(self, batch) -> None:
        if batch.num_rows == 0:
            return
        counters.bump("coalesce_morsels_in")
        self._pending.append(batch)
        self._rows += batch.num_rows
        now = time.perf_counter()
        if self._oldest is None:
            self._oldest = now
        if self._rows >= self._target or now - self._oldest >= self._latency:
            self.flush()

    def flush(self) -> None:
        if not self._pending:
            return
        morsels_in = len(self._pending)
        if morsels_in == 1:
            batch = self._pending[0]  # identity kept: the resident planes hit
        else:
            from ..core.recordbatch import RecordBatch

            batch = RecordBatch.concat(self._pending)
        self._pending = []
        self._rows = 0
        self._oldest = None
        bucket = pad_bucket(batch.num_rows)
        with profile_span("device.coalesce_flush", "device", morsels_in=morsels_in,
                          rows=batch.num_rows,
                          fill_ratio=round(batch.num_rows / bucket, 4)):
            self._feed(batch)
        counters.bump("dispatch_coalesced")
        counters.bump("bucket_fill_rows", batch.num_rows)
        counters.bump("bucket_capacity_rows", bucket)
        self._filled += batch.num_rows
        self._capacity += bucket
        registry().set_gauge("bucket_fill_ratio", round(self._filled / self._capacity, 4))

    # the stream is exhausted: feed whatever is still pending
    close = flush


_FILTER_AGG_CACHE: Dict[tuple, FilterAggStage] = {}


def try_build_filter_agg_stage(schema: Schema, predicate: Optional[Expression],
                               agg_exprs: Sequence[Expression]) -> Optional[FilterAggStage]:
    """A device stage for filter + ungrouped aggregation when the predicate
    and every aggregation are device-evaluable, else None (the reason in
    ``counters.rejections``). Stages are cached by structure."""
    site = "agg"
    key = stage_cache_key(schema, predicate, agg_exprs)
    with _CACHE_LOCK:
        cached = _FILTER_AGG_CACHE.get(key)
    if cached is not None:
        return cached
    if predicate is not None and not dev.is_device_evaluable(predicate, schema):
        counters.reject(site, "predicate is not device-evaluable")
        return None
    aggs: List[Tuple[str, AggExpr]] = []
    for e in agg_exprs:
        name = e.name()
        inner = e
        while isinstance(inner, Alias):
            inner = inner.child
        if not isinstance(inner, AggExpr) or inner.op not in ("sum", "mean", "min", "max",
                                                              "count"):
            counters.reject(site, "aggregation is not a bare sum/mean/min/max/count")
            return None
        if inner.op == "count" and inner.params.get("mode", "valid") == "null":
            counters.reject(site, "count(mode=null)")
            return None
        if not dev.is_device_evaluable(inner.child, schema):
            counters.reject(site, "aggregation child is not device-evaluable")
            return None
        aggs.append((name, inner))
    stage = FilterAggStage(schema, predicate, aggs)
    with _CACHE_LOCK:
        _FILTER_AGG_CACHE[key] = stage
    return stage
