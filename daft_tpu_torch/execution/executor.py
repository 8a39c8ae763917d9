"""Streaming interpreter of the physical plan (counterpart of
daft_tpu/execution/executor.py, the subset the port's slices need).

``execute_plan`` streams MicroPartitions. With ``pipeline_mode`` "on" (the
default, on a compute pool of more than one thread) or "force", every stage
node (``_STAGE_NODES``) runs on a stage thread of its own behind a bounded
channel (execution/pipeline.py); Projects, Filters and host join probes
fan their morsels out over the compute pool in order (``_map_op``), a
multi-task scan reads its tasks in an IO-parallel window
(``_streaming_scan``), and host aggregations compute their partials on the
pool. Under "off" the plan runs on the caller's thread, one morsel at a
time. Either way the rows and their order are the same.

Host operators run in numpy (``PhysLimit`` and ``PhysTopN`` included: a
stable sort, then a slice). A ``DeviceFilterAgg`` runs its ungrouped stage
on the configured device (``_exec_device_filter_agg``), fused with a device
UDF that feeds it (``_try_fused_udf_agg``). A ``UDFProject`` runs its UDF
on the host, a ``DeviceUdfProject`` on the device-UDF tier
(``_run_device_udf_stage``). A ``DeviceGroupedAgg`` runs its stage on the
configured device (the reference's device agg branch, executor.py:580-733,
without the mesh and cost-model arms): each batch is buffered, and when the
stage raises ``DeviceFallback`` (its group count outgrew the kernels'
envelope, detected before any launch) the whole buffered stream reruns on
the host. Both stages, and the join runs but the TopN, take their morsels
through a ``DispatchCoalescer`` (``_make_coalescer``), which is closed
before the run finalizes. A ``DeviceJoinAgg`` runs the star-join stage,
grouped or ungrouped, the same way (``_exec_device_join_agg``), a
``DeviceJoinTopN`` its TopN run over one fact batch
(``_exec_device_join_topn``), and a ``HashJoin`` (inner, left, semi,
anti: a ``JoinProbe`` built once from the right side), a ``CrossJoin`` and
a ``Dedup`` (distinct) run on the host. A ``PhysRepartition`` splits on the
host by the rows' hash (or at random), or, for a hash repartition into
``mesh_devices`` partitions, runs the mesh exchange on the device
(``_mesh_repartition``). A ``PhysWrite`` hands its input stream to the
writer (io/writers.py). Any other error, a kernel that fails to build or
launch included, propagates, from a stage thread through its channel: no
device failure turns into a host result.
"""

from __future__ import annotations

import itertools
from typing import Iterator, List, Optional

import numpy as np

from ..core.micropartition import MicroPartition
from ..core.recordbatch import RecordBatch
from ..core.series import Series
from ..expressions.eval import eval_expression, eval_projection
from ..expressions.expressions import AggExpr, Alias, Expression, col
from ..plan import physical as pp
from ..schema import Schema


def execute_plan(plan: pp.PhysicalPlan) -> Iterator[MicroPartition]:
    """Stream result MicroPartitions for a physical plan."""
    return _exec(plan)


# The operators that run as a stage of their own when the pipeline is on
# (the reference's _STAGE_NODES). The rest run on their consumer's thread:
# InMemoryScan yields references, PhysLimit and PhysTopN are cheap state
# machines, PhysWrite is a sink its consumer drives, a UDF's concurrency is
# the UDF tier's, and the device join runs (not stage nodes in the
# reference either) pull their fact and dims themselves.
_STAGE_NODES = (pp.StreamingScan, pp.Project, pp.PhysFilter, pp.PhysSort,
                pp.HashAggregate, pp.DeviceFilterAgg, pp.DeviceGroupedAgg, pp.Dedup,
                pp.HashJoin, pp.CrossJoin, pp.PhysRepartition)


def _exec(node: pp.PhysicalPlan) -> Iterator[MicroPartition]:
    """One node's stream: on a stage thread behind a bounded channel when it
    is a stage node and the pipeline is on (execution/pipeline.py
    ``spawn_stage``), else the node's generator itself."""
    gen = _exec_impl(node)
    if isinstance(node, _STAGE_NODES) and _pipeline_on():
        from .pipeline import spawn_stage

        gen = spawn_stage(gen)
    return gen


def _pipeline_on() -> bool:
    """pipeline_mode "force", or "on" with a compute pool of more than one
    thread (on one core, stage threads and fan-out are overhead alone)."""
    from ..config import execution_config
    from ..utils.pool import pool_width

    mode = execution_config().pipeline_mode
    if mode == "force":
        return True
    return mode == "on" and pool_width() > 1


def _map_op(stream: Iterator[MicroPartition], fn) -> Iterator[MicroPartition]:
    """``fn(part, index)`` over a stream, in order. With the pipeline on, the
    stream is cut into morsels (zero-copy slices) that fan out over the
    compute pool: at ``morsel_size_rows`` under batching_mode "static", else
    at the sizes this operator's own strategy picks from the morsels'
    timings (execution/batching.py). With it off, one part at a time."""
    if not _pipeline_on():
        for i, part in enumerate(stream):
            yield fn(part, i)
        return
    from ..config import execution_config
    from .pipeline import morsel_stream, pmap_stream

    cfg = execution_config()
    if cfg.batching_mode == "static":
        yield from pmap_stream(morsel_stream(stream, cfg.morsel_size_rows), fn)
        return
    from .batching import adaptive_morsel_stream, make_strategy

    strategy = make_strategy(cfg)
    yield from pmap_stream(adaptive_morsel_stream(stream, strategy), fn, strategy=strategy)


def _columns_only(projection: List[Expression]) -> bool:
    """Every expression a column reference, renamed or not."""
    from ..expressions.expressions import ColumnRef

    for e in projection:
        while isinstance(e, Alias):
            e = e.child
        if not isinstance(e, ColumnRef):
            return False
    return True


def _exec_impl(node: pp.PhysicalPlan) -> Iterator[MicroPartition]:
    if isinstance(node, pp.InMemoryScan):
        yield from node.partitions
        return

    if isinstance(node, pp.StreamingScan):
        yield from _streaming_scan(node)
        return

    if isinstance(node, pp.PhysWrite):
        yield from node.info.execute_write(_exec(node.input), node.input.schema)
        return

    if isinstance(node, pp.Project):
        def project(part, _i):
            batches = [eval_projection(b, node.projection) for b in part.batches]
            return MicroPartition(node.schema, batches or [RecordBatch.empty(node.schema)])

        if _columns_only(node.projection):
            # a selection of columns (the optimizer's pruning) has no work to
            # spread: each batch passes whole, so a held table's columns stay
            # the Series their resident planes are keyed on, and a one-batch
            # fact stays one batch (the device join TopN)
            for i, part in enumerate(_exec(node.input)):
                yield project(part, i)
            return
        yield from _map_op(_exec(node.input), project)
        return

    if isinstance(node, pp.DeviceUdfProject):
        yield from _exec_device_udf(node)
        return

    if isinstance(node, pp.UDFProject):
        # one part at a time: a UDF may hold state that is not thread-safe
        yield from _udf_host_parts(node, _exec(node.input))
        return

    if isinstance(node, pp.PhysFilter):
        yield from _map_op(_exec(node.input),
                           lambda part, _i: _filter_part(part, node.predicate, node.keep))
        return

    if isinstance(node, pp.PhysSort):
        batch = _concat_parts(list(_exec(node.input)), node.schema)
        keys = [_full_length(eval_expression(batch, e), batch.num_rows)
                for e in node.sort_by]
        yield MicroPartition(node.schema,
                             [batch.sort(keys, node.descending, node.nulls_first)])
        return

    if isinstance(node, pp.PhysLimit):
        yield from _limit(node)
        return

    if isinstance(node, pp.PhysTopN):
        batch = _concat_parts(list(_exec(node.input)), node.schema)
        keys = [_full_length(eval_expression(batch, e), batch.num_rows)
                for e in node.sort_by]
        top = batch.sort(keys, node.descending, node.nulls_first)
        yield MicroPartition(node.schema, [top.slice(node.offset, node.offset + node.limit)])
        return

    if isinstance(node, pp.DeviceJoinTopN):
        yield _exec_device_join_topn(node)
        return

    if isinstance(node, pp.HashAggregate):
        if node.groupby:
            out = _two_phase_agg(_exec(node.input), node.groupby, node.aggregations,
                                 node.input.schema)
        else:
            out = _ungrouped_agg(_exec(node.input), node.aggregations, node.input.schema)
        yield MicroPartition(node.schema, [out.cast_to_schema(node.schema)])
        return

    if isinstance(node, pp.DeviceFilterAgg):
        yield _exec_device_filter_agg(node)
        return

    if isinstance(node, pp.DeviceGroupedAgg):
        yield _exec_device_agg(node)
        return

    if isinstance(node, pp.HashJoin):
        yield from _hash_join(node)
        return

    if isinstance(node, pp.CrossJoin):
        right = _concat_parts(list(_exec(node.right)), node.right.schema)
        for part in _exec(node.left):
            yield MicroPartition(node.schema,
                                 [_cross_join_batch(node, b, right) for b in part.batches])
        return

    if isinstance(node, pp.Dedup):
        batch = _concat_parts(list(_exec(node.input)), node.schema)
        if batch.num_rows:
            from ..core.kernels.groupby import make_groups

            keys = batch.columns() if node.on is None else \
                [_full_length(eval_expression(batch, e), batch.num_rows) for e in node.on]
            batch = batch.take(np.sort(make_groups(keys)[0]))
        yield MicroPartition(node.schema, [batch])
        return

    if isinstance(node, pp.DeviceJoinAgg):
        yield _exec_device_join_agg(node)
        return

    if isinstance(node, pp.PhysRepartition):
        yield from _repartition(node)
        return

    raise NotImplementedError(f"no executor for {node.name()}")


def _streaming_scan(node: pp.StreamingScan) -> Iterator[MicroPartition]:
    """A StreamingScan's morsels in task order (the reference's
    executor.py:438-549), each task's filtered by ``post_filter`` when the
    task did not apply it. With a ``post_limit``, one task, or the pipeline
    off, the tasks run one after another on this thread, one morsel at a
    time, the stream cut at ``post_limit`` rows. Otherwise they run in an
    IO-parallel window: up to the compute pool's width of tasks read at
    once on the pool, each whole into a list, yielded in task order; a
    closed stream drops the tasks not started and waits for the running
    ones. Counts ``scan_tasks`` (tasks started), ``scan_batches`` and
    ``scan_rows`` (what was yielded, an early close included), and for the
    window ``scan_window_tasks`` and its peak of tasks read at once,
    ``scan_window_peak``. The host memory budget's backpressure
    (``wait_for_headroom``) comes with the out-of-core slice (ROADMAP
    Queue 1 item 4)."""
    from ..ops import counters

    def task_parts(task):
        for part in task.read():
            if node.post_filter is not None and not task.filters_applied:
                part = _timed_filter(part, node.post_filter)
            yield part

    remaining = node.post_limit
    batches = rows = 0
    try:
        if remaining is not None or len(node.tasks) <= 1 or not _pipeline_on():
            for task in node.tasks:
                counters.bump("scan_tasks")
                for part in task_parts(task):
                    if remaining is not None:
                        if remaining <= 0:
                            return
                        if part.num_rows > remaining:
                            part = MicroPartition(part.schema,
                                                  [part.concat_or_empty().head(remaining)])
                        remaining -= part.num_rows
                    batches += 1
                    rows += part.num_rows
                    yield part
            return
        for part in _scan_window(node.tasks, task_parts):
            batches += 1
            rows += part.num_rows
            yield part
    finally:
        counters.bump("scan_batches", batches)
        counters.bump("scan_rows", rows)


def _scan_window(tasks, task_parts) -> Iterator[MicroPartition]:
    """The scan tasks read on the compute pool, up to its width at once,
    their morsels yielded in task order."""
    import threading
    from collections import deque
    from concurrent.futures import wait

    from ..ops import counters
    from ..utils.pool import compute_pool

    pool = compute_pool()
    window = min(pool._max_workers, len(tasks))
    lock = threading.Lock()
    reading = [0, 0]  # tasks reading now, the most at once

    def read_task(task):
        counters.bump("scan_tasks")
        counters.bump("scan_window_tasks")
        with lock:
            reading[0] += 1
            reading[1] = max(reading[1], reading[0])
        try:
            return list(task_parts(task))
        finally:
            with lock:
                reading[0] -= 1

    futures: deque = deque()
    ti = 0
    try:
        while ti < len(tasks) or futures:
            while ti < len(tasks) and len(futures) < window:
                futures.append(pool.submit(read_task, tasks[ti]))
                ti += 1
            yield from futures.popleft().result()
    finally:
        wait([f for f in futures if not f.cancel()])
        counters.bump_max("scan_window_peak", reading[1])


def _timed_filter(part: MicroPartition, predicate: Expression) -> MicroPartition:
    """``_filter_part`` of a scan's pushed predicate, its host time counted
    in ``scan_filter_ms``."""
    import time

    from ..ops import counters

    t0 = time.perf_counter()
    out = _filter_part(part, predicate, None)
    counters.bump("scan_filter_ms", (time.perf_counter() - t0) * 1e3)
    return out


def filter_batch(batch: RecordBatch, predicate: Expression) -> RecordBatch:
    """The rows of ``batch`` where ``predicate`` is true (null drops), as a
    reader applies a pushed predicate (timed in ``scan_filter_ms``)."""
    part = _timed_filter(MicroPartition(batch.schema, [batch]), predicate)
    return part.batches[0] if part.batches else RecordBatch.empty(batch.schema)


def _limit(node: pp.PhysLimit) -> Iterator[MicroPartition]:
    """Skip ``offset`` rows of the stream, then pass ``limit`` rows on (every
    row when limit is -1); stops reading the input once the limit is met."""
    to_skip = node.offset
    remaining = node.limit if node.limit >= 0 else None
    if remaining == 0:
        return
    stream = _exec(node.input)
    try:
        for part in stream:
            batches = []
            for b in part.batches:
                if to_skip >= b.num_rows:
                    to_skip -= b.num_rows
                    continue
                b = b.slice(to_skip, b.num_rows)
                to_skip = 0
                if remaining is not None:
                    b = b.head(remaining)
                    remaining -= b.num_rows
                batches.append(b)
                if remaining == 0:
                    break
            if batches:
                yield MicroPartition(node.schema, batches)
            if remaining == 0:
                return
    finally:
        stream.close()  # stop the input's stages once the limit is met


def _make_coalescer(feed, cfg):
    """A DispatchCoalescer (ops/stage.py) feeding ``feed``, or None when
    coalescing is off (batch_fill_target == 0): each morsel is then fed
    alone. The flush threshold is batching.coalesce_target_rows."""
    from ..ops.stage import DispatchCoalescer
    from .batching import coalesce_target_rows

    target = coalesce_target_rows(cfg)
    if target <= 0:
        return None
    return DispatchCoalescer(feed, target_rows=target, latency_s=cfg.batch_latency_ms / 1e3)


def _feed_stream(stream, feed, cfg) -> None:
    """Every batch of ``stream`` through ``feed``, by way of a coalescer when
    coalescing is on; the coalescer is closed (its pending batches fed)
    before the caller finalizes."""
    coalescer = _make_coalescer(feed, cfg)
    add = coalescer.add if coalescer is not None else feed
    for part in stream:
        for b in part.batches:
            add(b)
    if coalescer is not None:
        coalescer.close()


def _region_keep_columns(node) -> Optional[List[str]]:
    """The input columns a device aggregate node reads, in input order, or
    None when it reads (nearly) its whole input. A fused region that
    absorbed a Project sits on the chain's full base width: the host path
    and the fallback's rerun buffer narrow to these before they filter,
    buffer or concatenate anything (the device stage uploads only what it
    reads)."""
    from ..ops.region import referenced_columns

    need = referenced_columns(node.predicate, getattr(node, "groupby", []),
                              node.aggregations)
    have = node.input.schema.column_names()
    if not need or need >= set(have):
        return None
    return [c for c in have if c in need]


def _narrowed(stream, keep: Optional[List[str]]):
    return stream if keep is None else (p.select_columns(keep) for p in stream)


def _note_region(node, region_ops, dispatches: int) -> None:
    """Count one finished fused-region run: each of its device dispatches
    covered len(region_ops) operators. Only regions of at least 2 ops
    count, so the ratio measures fusion, not bare aggregates."""
    if dispatches <= 0 or len(region_ops) < 2:
        return
    from ..ops import counters

    counters.bump("device_region_dispatches", dispatches)
    counters.bump("device_region_ops_fused", dispatches * len(region_ops))


def _exec_device_agg(node: pp.DeviceGroupedAgg) -> MicroPartition:
    """Run a DeviceGroupedAgg: the device stage, or the host under
    device_mode="off" and after a DeviceFallback. The host path and the
    rerun buffer read the node's input narrowed to its referenced columns;
    the device stage reads the input batches themselves, so their cached
    planes and group codes still hit."""
    from ..config import execution_config
    from ..device.residency import manager as _residency
    from ..ops import counters
    from ..ops.grouped_stage import DeviceFallback, try_build_grouped_agg_stage
    from ..ops.region import node_region_ops
    from ..utils.torch_setup import resolve_device

    cfg = execution_config()
    stream = _exec(node.input)
    keep = _region_keep_columns(node)

    def _host_agg(s):
        if node.predicate is not None:
            s = (_filter_part(p, node.predicate) for p in s)
        out = _two_phase_agg(s, node.groupby, node.aggregations, node.input.schema)
        return MicroPartition(node.schema, [out.cast_to_schema(node.schema)])

    if cfg.device_mode == "off":
        return _host_agg(_narrowed(stream, keep))

    device = resolve_device(cfg.device)
    stage = try_build_grouped_agg_stage(node.input.schema, node.predicate,
                                        node.groupby, node.aggregations)
    if stage is None:
        raise RuntimeError("planner emitted DeviceGroupedAgg for a stage the "
                           "kernel tier does not accept under the current config")
    run = stage.start_run(device)
    buffered: List[MicroPartition] = []

    def buffering():
        for part in stream:
            buffered.append(part if keep is None else part.select_columns(keep))
            yield part

    d0 = counters.device_grouped_batches
    try:
        # pin the query's resident planes so a tight budget cannot evict
        # buffers this run still reads; released at scope exit
        with _residency().pin_scope():
            _feed_stream(buffering(), run.feed_batch, cfg)
            key_rows, results = run.finalize()
    except DeviceFallback as exc:
        # raised before any launch for the offending batch: rerun the whole
        # buffered region on the host (the composed expressions evaluate
        # compositionally, so the result is the fused program's)
        counters.bump("device_fallbacks")
        counters.reject("grouped agg", f"device fallback: {type(exc).__name__}")
        return _host_agg(itertools.chain(buffered, _narrowed(stream, keep)))
    _note_region(node, node_region_ops(node), counters.device_grouped_batches - d0)
    return _grouped_output(node.schema, node.groupby, node.aggregations,
                           key_rows, results)


def _exec_device_filter_agg(node: pp.DeviceFilterAgg) -> MicroPartition:
    """Run a DeviceFilterAgg: the ungrouped device stage over every batch
    of the input, or the host (over the input narrowed to its referenced
    columns) under device_mode="off". A failure on the device raises:
    nothing reruns on the host."""
    from ..config import execution_config
    from ..device.residency import manager as _residency
    from ..ops import counters
    from ..ops.region import node_region_ops
    from ..ops.stage import try_build_filter_agg_stage
    from ..utils.torch_setup import resolve_device

    cfg = execution_config()
    if cfg.device_mode == "on" and cfg.region_mode == "on":
        # a device UDF feeding the aggregate: its output plane goes into the
        # aggregate's program with no copy back in between
        fused = _try_fused_udf_agg(node, cfg)
        if fused is not None:
            return fused
    stream = _exec(node.input)
    if cfg.device_mode == "off":
        return _host_filter_agg(node, stream)
    device = resolve_device(cfg.device)
    stage = try_build_filter_agg_stage(node.input.schema, node.predicate, node.aggregations)
    if stage is None:
        raise RuntimeError("planner emitted DeviceFilterAgg for a stage the device does "
                           "not accept")
    run = stage.start_run(device)
    d0 = counters.device_stage_batches
    with _residency().pin_scope():
        _feed_stream(stream, run.feed_batch, cfg)
        final = run.finalize()
    _note_region(node, node_region_ops(node), counters.device_stage_batches - d0)
    return _ungrouped_output(node.schema, stage, final)


def _host_filter_agg(node: pp.DeviceFilterAgg, stream) -> MicroPartition:
    """A DeviceFilterAgg on the host, over its input narrowed to the columns
    it reads."""
    stream = _narrowed(stream, _region_keep_columns(node))
    if node.predicate is not None:
        stream = (_filter_part(p, node.predicate) for p in stream)
    out = _ungrouped_agg(stream, node.aggregations, node.input.schema)
    return MicroPartition(node.schema, [out.cast_to_schema(node.schema)])


def _udf_host_parts(node: pp.UDFProject, stream) -> Iterator[MicroPartition]:
    """A UDFProject on the host, one part at a time (a device Func through
    ops/udf_stage.py ``host_eval_device_func``, on the configured device, or
    on the CPU under device_mode="off")."""
    exprs = list(node.passthrough) + [node.udf_expr]
    for part in stream:
        batches = [eval_projection(b, exprs) for b in part.batches]
        yield MicroPartition(node.schema, batches or [RecordBatch.empty(node.schema)])


def _exec_device_udf(node: pp.DeviceUdfProject) -> Iterator[MicroPartition]:
    """Run a DeviceUdfProject: the device-UDF stage on the configured device
    (which must be there), or the host path under device_mode="off" (on the
    CPU, never touching the card). The reference's cost-model choice
    ("auto") comes with the cost model."""
    from ..config import execution_config

    cfg = execution_config()
    stream = _exec(node.input)
    if cfg.device_mode == "off":
        yield from _udf_host_parts(node, stream)
        return
    yield _run_device_udf_stage(node, stream, cfg)


def _run_device_udf_stage(node: pp.DeviceUdfProject, stream, cfg) -> MicroPartition:
    """One DeviceUdfProject on the device tier: the input's batches through
    the dispatch coalescer into the stage, under a pin scope that holds the
    weights, one copy back at finalize; the output is the passthrough
    columns and the decoded UDF column. A failure raises: nothing reruns on
    the host."""
    from ..device.residency import manager as _residency
    from ..ops.udf_stage import DeviceUdfStage, finish_series
    from ..utils.torch_setup import resolve_device

    device = resolve_device(cfg.device)
    call = pp.device_udf_call(node.udf_expr)
    out_name = node.udf_expr.name()
    stage = DeviceUdfStage(call.func, call.args, out_name)
    parts: List[MicroPartition] = []  # the passthrough columns' source

    def keeping():
        for part in stream:
            parts.append(part)
            yield part

    with _residency().pin_scope():
        run = stage.start_run(device)
        _feed_stream(keeping(), run.feed_batch, cfg)
        out, valid = run.finalize()
    big = _concat_parts(parts, node.input.schema)
    udf_col = finish_series(call.func, out, valid, out_name)
    cols = [_full_length(eval_expression(big, e), big.num_rows) for e in node.passthrough]
    return MicroPartition(node.schema,
                          [RecordBatch(node.schema, cols + [udf_col], big.num_rows)])


def _try_fused_udf_agg(node: pp.DeviceFilterAgg, cfg) -> Optional[MicroPartition]:
    """A DeviceUdfProject feeding this DeviceFilterAgg, fused: each
    (coalesced) batch dispatches the UDF and hands its output plane to the
    aggregate's program in the same dispatch (ops/udf_stage.py
    ``FusedUdfAggFeeder``), so the UDF's column never comes back to the
    host. Only for a UDF of a numeric return dtype that the aggregate reads;
    every check that fails returns None before any input runs. A failure
    raises: nothing reruns on the host."""
    from ..device.residency import manager as _residency
    from ..ops import counters
    from ..ops.region import node_region_ops, unwrap_udf_agg_input
    from ..ops.stage import try_build_filter_agg_stage
    from ..ops.udf_stage import DeviceUdfStage, FusedUdfAggFeeder
    from ..utils.torch_setup import resolve_device

    udf_node, rename = unwrap_udf_agg_input(node.input)
    if udf_node is None:
        return None
    call = pp.device_udf_call(udf_node.udf_expr)
    agg_stage = try_build_filter_agg_stage(node.input.schema, node.predicate,
                                           node.aggregations)
    if call is None or agg_stage is None:
        return None
    internal = udf_node.udf_expr.name()
    # the aggregate's columns: the UDF's output plane, and the UDF node's
    # other inputs under their source names
    udf_cols = [c for c in agg_stage._input_cols if rename.get(c) == internal]
    other = {c: rename.get(c, c) for c in agg_stage._input_cols
             if rename.get(c) != internal}
    if not udf_cols or not all(node.input.schema[c].dtype.is_numeric() for c in udf_cols):
        return None
    if not set(other.values()) <= set(udf_node.input.schema.column_names()):
        return None
    device = resolve_device(cfg.device)
    udf_stage = DeviceUdfStage(call.func, call.args, internal)
    d0 = counters.device_stage_batches
    agg_run = agg_stage.start_run(device)
    with _residency().pin_scope():
        feeder = FusedUdfAggFeeder(udf_stage.start_run(device), agg_run, udf_cols, other,
                                   f32=not agg_stage._use_f64)
        _feed_stream(_exec(udf_node.input), feeder.feed_batch, cfg)
        final = agg_run.finalize()
    # the UDF fed the aggregate in the same dispatch: one more fused op
    _note_region(node, ("udf",) + node_region_ops(node), counters.device_stage_batches - d0)
    return _ungrouped_output(node.schema, agg_stage, final)


def _ungrouped_output(schema, stage, final) -> MicroPartition:
    """The one-row result of an ungrouped device stage from its finalized
    {aggregation name: value}; a boolean result (a min or max of a bool
    column comes back as a number) is cast back to bool."""
    cols = []
    for name, _agg in stage.aggs:
        f = schema[name]
        value = final[name]
        if value is not None and f.dtype.is_boolean():
            value = bool(value)
        cols.append(Series.from_pylist([value], f.name, dtype=f.dtype))
    return MicroPartition(schema, [RecordBatch(schema, cols, 1)])


class JoinProbe:
    """The build-once, probe-many host join of inner, left, semi and anti
    joins (counterpart of daft_tpu/core/relational.py ``JoinProbe``): the
    right side's keys are indexed once (core/kernels/join.py ``ProbeTable``),
    and each left batch is a lookup into that index. A probe gives the rows
    ``join_indices`` gives over the same batch and the whole right side, in
    the same order. The table is read-only once built, so probes may run on
    several pool threads at once."""

    def __init__(self, node: pp.HashJoin, right: RecordBatch):
        from ..core.kernels.join import ProbeTable

        if node.how not in ("inner", "left", "semi", "anti"):
            raise ValueError(f"JoinProbe does not support how={node.how!r}")
        self.node = node
        self.right = right
        left_schema = node.left.schema
        self.table = ProbeTable(_keys(right, node.right_on),
                                [e.to_field(left_schema).dtype for e in node.left_on])

    def probe(self, left: RecordBatch) -> RecordBatch:
        """``left`` joined to the right side."""
        li, ri = self.table.probe(_keys(left, self.node.left_on), self.node.how)
        return self._assemble(left, li, ri)

    def probe_filtered(self, raw: RecordBatch, sel: np.ndarray) -> RecordBatch:
        """``probe(raw.take(sel))`` with the filter fused: only the key
        columns (column references) are gathered through ``sel``; every
        other column is gathered once, through the composed row indices."""
        keys = [raw.get_column(e.name()).take(sel) for e in self.node.left_on]
        li, ri = self.table.probe(keys, self.node.how)
        # inner, left, semi and anti give every left row a real index
        return self._assemble(raw, sel[li], ri)

    def _assemble(self, left: RecordBatch, li: np.ndarray, ri: np.ndarray) -> RecordBatch:
        """The join's output rows: the left's columns at ``li``, then (not for
        a semi or anti join) the right's at ``ri``, renamed, -1 giving null."""
        node = self.node
        cols = [s.take(li) for s in left.columns()]
        if node.how not in ("semi", "anti"):
            cols += [s.take_or_null(ri).rename(node.right_rename.get(s.name, s.name))
                     for s in self.right.columns() if s.name not in node.merged_keys]
        return RecordBatch(node.schema, cols, len(li))


def _keys(batch: RecordBatch, exprs) -> List[Series]:
    return [_full_length(eval_expression(batch, e), batch.num_rows) for e in exprs]


def _selection_vector(batch: RecordBatch, mask: Series) -> np.ndarray:
    """The rows where ``mask`` is true (a null drops), as ``filter_by_mask``
    keeps them; a one-row mask broadcasts."""
    if len(mask) == 1 and batch.num_rows != 1:
        hit = bool(mask.validity_numpy()[0] and mask.to_numpy()[0])
        return np.arange(batch.num_rows, dtype=np.int64) if hit \
            else np.empty(0, dtype=np.int64)
    return np.flatnonzero(mask.to_numpy().astype(bool) & mask.validity_numpy())


def _hash_join(node: pp.HashJoin) -> Iterator[MicroPartition]:
    """A host join (the reference's executor.py:2870-2928 without its memory
    budget): the right side materialized and indexed once, the left side
    streamed through ``_map_op``, each morsel a probe. Where the left side
    is a Filter and the left keys are column references, the filter fuses
    into the probe: the raw batches stream, the predicate becomes a
    selection vector, and the probe gathers the other columns once."""
    from ..expressions.expressions import ColumnRef

    right = _concat_parts(list(_exec(node.right)), node.right.schema)
    probe = JoinProbe(node, right)
    source, predicate, keep = node.left, None, None
    if isinstance(source, pp.PhysFilter) and \
            all(isinstance(e, ColumnRef) for e in node.left_on) and \
            (source.keep is None or all(e.name() in source.keep for e in node.left_on)):
        source, predicate, keep = source.input, source.predicate, source.keep

    def run(part, _i):
        outs = []
        for b in part.batches:
            if predicate is None:
                outs.append(probe.probe(b))
                continue
            sel = _selection_vector(b, eval_expression(b, predicate))
            if len(sel):
                outs.append(probe.probe_filtered(b if keep is None else b.select_columns(keep),
                                                 sel))
        return MicroPartition(node.schema, outs or [RecordBatch.empty(node.schema)])

    yield from _map_op(_exec(source), run)


def _cross_join_batch(node: pp.CrossJoin, left: RecordBatch,
                      right: RecordBatch) -> RecordBatch:
    """One left batch with every right row, left-major."""
    from ..core.kernels.join import cross_join_indices

    li, ri = cross_join_indices(left.num_rows, right.num_rows)
    cols = [s.take(li) for s in left.columns()]
    cols += [s.take(ri).rename(node.right_rename.get(s.name, s.name))
             for s in right.columns()]
    return RecordBatch(node.schema, cols, len(li))


def _exec_device_join_agg(node: pp.DeviceJoinAgg) -> MicroPartition:
    """Run a DeviceJoinAgg: the grouped join run (group keys) or the
    ungrouped one (none), the fact's morsels fed through the dispatch
    coalescer."""
    from ..ops.device_join import DeviceJoinGroupedRun, DeviceJoinUngroupedRun

    def make_run(stage, grouped, ctx):
        return DeviceJoinGroupedRun(stage, ctx) if grouped \
            else DeviceJoinUngroupedRun(stage, ctx)

    def feed(run, stream, cfg):
        _feed_stream(stream, run.feed_batch, cfg)

    def assemble(run, stage, grouped):
        if grouped:
            key_rows, results = run.finalize()
            return _grouped_output(node.schema, node.spec.groupby, node.spec.aggregations,
                                   key_rows, results)
        return _ungrouped_output(node.schema, stage, run.finalize())

    return _run_device_join(node, "join agg", make_run, feed, assemble)


def _exec_device_join_topn(node: pp.DeviceJoinTopN) -> MicroPartition:
    """Run a DeviceJoinTopN: the TopN join run over one fact batch (a
    second batch is a DeviceFallback, raised before anything is fed), the
    K winners assembled in the TopN's column order."""
    from ..ops.device_join import DeviceJoinTopNRun
    from ..ops.grouped_stage import DeviceFallback

    def make_run(stage, _grouped, ctx):
        return DeviceJoinTopNRun(stage, ctx, node.topn)

    def feed(run, stream, _cfg):
        # bail on sighting a second batch, before any device work and
        # without draining the stream (a scan stops reading), as the
        # reference does
        first = None
        for part in stream:
            for b in part.batches:
                if b.num_rows == 0:
                    continue
                if first is not None:
                    stream.close()
                    raise DeviceFallback("device TopN path requires a single fact batch")
                first = b
        if first is not None:
            run.feed_batch(first)

    def assemble(run, _stage, _grouped):
        key_rows, results = run.finalize_topn()
        cols = []
        for f, (kind, idx) in zip(node.schema, node.out_map):
            if kind == "group":
                cols.append(Series.from_pylist([k[idx] for k in key_rows], f.name,
                                               dtype=f.dtype))
            else:
                cols.append(_agg_series(f, *results[idx]))
        return MicroPartition(node.schema, [RecordBatch(node.schema, cols, len(key_rows))])

    return _run_device_join(node, "join topn", make_run, feed, assemble)


def _run_device_join(node, label: str, make_run, feed, assemble) -> MicroPartition:
    """What the device join nodes share (the reference's _run_device_join
    without its cost model and mesh): the host plan under device_mode="off";
    otherwise materialize the dims, build the join context, and feed the
    fact stream through the run under one pin scope, then assemble. A
    DeviceFallback (non-unique or non-integer dim keys, a dim key equal to
    the probe table's empty marker, too many groups, a TopN's second fact
    batch: all decided before any launch) records its reason and runs the
    host plan. Any other error, a kernel failure included, propagates. A
    finished run counts as a fused region of ("join", "agg"), or ("join",
    "agg", "topn"), over its join batches."""
    from ..config import execution_config
    from ..device.residency import manager as _residency
    from ..ops import counters
    from ..ops.device_join import _JoinContext, build_join_stage
    from ..ops.grouped_stage import DeviceFallback
    from ..utils.torch_setup import resolve_device

    def host() -> MicroPartition:
        return MicroPartition(node.schema, [_concat_parts(list(_exec(node.host_plan)),
                                                          node.schema)])

    cfg = execution_config()
    if cfg.device_mode == "off":
        return host()
    device = resolve_device(cfg.device)
    stage, grouped = build_join_stage(node.spec)
    if stage is None:
        return host()  # the config changed since planning (kernel_mode="off")
    dims = {name: _concat_parts(list(_exec(plan)), plan.schema)
            for name, plan in node.dim_plans}
    region_ops = ("join", "agg", "topn") if isinstance(node, pp.DeviceJoinTopN) \
        else ("join", "agg")
    d0 = counters.device_join_batches
    try:
        with _residency().pin_scope():
            run = make_run(stage, grouped, _JoinContext(node.spec, dims, device,
                                                        f32=not stage._use_f64))
            feed(run, _exec(node.fact), cfg)
            out = assemble(run, stage, grouped)
        _note_region(node, region_ops, counters.device_join_batches - d0)
        return out
    except DeviceFallback as exc:
        counters.bump("device_fallbacks")
        counters.reject(label, f"device fallback: {exc}")
        return host()


def _repartition(node: pp.PhysRepartition) -> Iterator[MicroPartition]:
    """n output partitions, in partition order; the rows of each keep their
    input order. ``random`` draws each input partition's ids from numpy's
    ``default_rng(partition index)``, as the reference."""
    n = node.num_partitions or 1
    if node.scheme == "hash" and _mesh_repart_eligible(node, n):
        yield from _mesh_repartition(node, n)
        return
    yield from _host_repartition(node, _exec(node.input), n)


def _host_repartition(node: pp.PhysRepartition, stream, n: int) -> List[MicroPartition]:
    """The host split of ``stream`` into n partitions by ``node.scheme``."""
    buckets: List[List[RecordBatch]] = [[] for _ in range(n)]
    for i, part in enumerate(stream):
        for b in part.batches:
            if b.num_rows == 0:
                continue
            if node.scheme == "hash":
                keys = [_full_length(eval_expression(b, e), b.num_rows) for e in node.by]
                pieces = b.partition_by_hash(keys, n)
            else:
                pieces = b.partition_by_random(n, seed=i)
            for j, piece in enumerate(pieces):
                if piece.num_rows:
                    buckets[j].append(piece)
    return [MicroPartition(node.schema, bs) for bs in buckets]


def _mesh_repart_eligible(node: pp.PhysRepartition, n: int) -> bool:
    """The static gate of the mesh repartition: a forced mesh of n shards,
    keys, and only numeric or boolean columns (strings and dates stay on the
    host, as in the reference). Decided before the input is read or anything
    is uploaded; every refusal but device_mode="off" is recorded."""
    from ..config import execution_config
    from ..ops import counters

    cfg = execution_config()
    if cfg.device_mode == "off":
        return False
    site = "repartition"
    if cfg.mesh_devices < 2:
        counters.reject(site, "mesh_devices < 2: no mesh")
        return False
    if n != cfg.mesh_devices:
        counters.reject(site, "partition count differs from mesh_devices")
        return False
    if not node.by:
        counters.reject(site, "no partition keys")
        return False
    if not all(f.dtype.is_numeric() or f.dtype.is_boolean() for f in node.schema):
        counters.reject(site, "a column is neither numeric nor boolean")
        return False
    return True


def _mesh_repartition(node: pp.PhysRepartition, n: int) -> List[MicroPartition]:
    """The hash repartition as one mesh exchange on the configured device;
    input under ``device_min_rows`` rows is split on the host. The partitions
    equal the host path's, rows in order. There is no host rerun: a failure
    of the exchange (a kernel that fails to build or launch) raises."""
    from ..config import execution_config
    from ..ops import counters

    batches = [b for p in _exec(node.input) for b in p.batches if b.num_rows > 0]
    rows = sum(b.num_rows for b in batches)
    if rows < max(execution_config().device_min_rows, 1):
        counters.reject("repartition", "fewer rows than device_min_rows")
        return _host_repartition(node, [MicroPartition(node.schema, batches)], n)
    return _mesh_repartition_exchange(node, batches, rows, n)


def _mesh_repartition_exchange(node: pp.PhysRepartition, batches: List[RecordBatch],
                               rows: int, n: int) -> List[MicroPartition]:
    """Destinations hashed on the host with the host path's function; every
    column's values and validity sharded over the mesh; one exchange (the
    K6 tier, or the all_to_all tier under kernel_mode="off"); then each
    block's live rows, and only those, back to the host, in (destination,
    source shard, row) order."""
    import torch

    from ..config import execution_config
    from ..core.kernels.hashing import combine_hashes
    from ..ops import counters
    from ..ops.mesh_stage import _shard_np, mesh_row_mask, mesh_total
    from ..parallel.distributed import (default_mesh, sharded_alltoall_repartition_step,
                                        sharded_ring_repartition_step)
    from ..utils.torch_setup import resolve_device

    cfg = execution_config()
    big = batches[0] if len(batches) == 1 else RecordBatch.concat(batches)
    keys = [_full_length(eval_expression(big, e), rows) for e in node.by]
    dest = (combine_hashes([s.hash().to_numpy() for s in keys])
            % np.uint64(n)).astype(np.int64)
    mesh = default_mesh(n, resolve_device(cfg.device))
    total = mesh_total(rows, n)
    S = total // n
    planes, np_dtypes = [], []
    for c in big.columns():
        planes += [_shard_np(mesh, c.to_numpy(), total),
                   _shard_np(mesh, c.validity_numpy(), total)]
        np_dtypes.append(c.to_numpy().dtype)
    args = (_shard_np(mesh, dest, total), mesh_row_mask(mesh, rows, total), *planes)
    if cfg.kernel_mode == "on":
        counts, out = sharded_ring_repartition_step(mesh, *args)
        counters.bump("mesh_fused_permute_dispatches")
    else:
        counts, out = sharded_alltoall_repartition_step(mesh, *args)
        counters.bump("mesh_alltoall_dispatches")
    counters.bump("mesh_alltoall_rows", rows)
    del args, planes
    live = torch.arange(S, device=mesh.device) < counts.view(n * n, 1)
    host = [p[live].cpu().numpy() for p in out]
    del out
    bounds = np.concatenate([[0], np.cumsum(counts.cpu().numpy().reshape(n, n).sum(axis=1))])
    parts = []
    for d in range(n):
        lo, hi = int(bounds[d]), int(bounds[d + 1])
        cols = [Series.from_numpy(host[2 * i][lo:hi].view(np_dtypes[i]), f.name,
                                  dtype=f.dtype, validity=host[2 * i + 1][lo:hi])
                for i, f in enumerate(node.schema)]
        parts.append(MicroPartition(node.schema, [RecordBatch(node.schema, cols, hi - lo)]))
    return parts


def _grouped_output(schema, groupby, aggregations, key_rows, results) -> MicroPartition:
    """A grouped-agg result batch from key tuples and per-agg (values, valid)
    arrays."""
    cols = []
    for i, g in enumerate(groupby):
        f = schema[g.name()]
        cols.append(Series.from_pylist([k[i] for k in key_rows], f.name, dtype=f.dtype))
    for e, (vals, valid) in zip(aggregations, results):
        cols.append(_agg_series(schema[e.name()], vals, valid))
    out = RecordBatch(schema, cols, len(key_rows))
    return MicroPartition(schema, [out])


def _agg_series(f, vals: np.ndarray, valid: np.ndarray) -> Series:
    """One aggregation's result column of field ``f``. Invalid slots are
    zeroed before the cast to the output type, so an empty group's +-inf
    extreme never reaches an integer cast."""
    vals = np.where(valid, vals, vals.dtype.type(0))
    return Series.from_numpy(vals.astype(f.dtype.to_numpy()), f.name, dtype=f.dtype,
                             validity=valid)


def _agg_op(e: Expression) -> str:
    while isinstance(e, Alias):
        e = e.child
    return e.op if isinstance(e, AggExpr) else ""


def _split_aggs(aggs: List[Expression]):
    """(partial, final, projection) expressions of a two-phase aggregation:
    partials per morsel, finals over the concatenated partials, and the
    projection that names the outputs (mean = sum / count)."""
    partial, final, projection = [], [], []
    for i, e in enumerate(aggs):
        name = e.name()
        inner = e
        while isinstance(inner, Alias):
            inner = inner.child
        if not isinstance(inner, AggExpr):
            raise ValueError(f"expected an aggregation, got {e!r}")
        p = f"__p{i}"
        if inner.op == "mean":
            partial += [AggExpr("sum", inner.child).alias(p + "s"),
                        AggExpr("count", inner.child).alias(p + "c")]
            final += [col(p + "s").sum().alias(p + "s"),
                      col(p + "c").sum().alias(p + "c")]
            projection.append((col(p + "s") / col(p + "c")).alias(name))
            continue
        partial.append(AggExpr(inner.op, inner.child, dict(inner.params)).alias(p))
        merge = "sum" if inner.op in ("sum", "count") else inner.op
        final.append(AggExpr(merge, col(p)).alias(name))
        projection.append(col(name))
    return partial, final, projection


def _agg_morsels(stream, aggs):
    """(the stream's non-empty batches, their morsels of ``morsel_size_rows``
    rows, or None when the input aggregates in one phase: at most a morsel
    of rows, or a count_distinct, which needs each group's whole value
    set)."""
    from ..config import execution_config

    batches = [b for part in stream for b in part.batches if b.num_rows > 0]
    morsel = execution_config().morsel_size_rows
    if sum(b.num_rows for b in batches) <= morsel or \
            any(_agg_op(e) == "count_distinct" for e in aggs):
        return batches, None
    return batches, [b.slice(s, s + morsel) for b in batches
                     for s in range(0, b.num_rows, morsel)]


def _two_phase_agg(stream, groupby, aggs, in_schema) -> RecordBatch:
    """Host grouped aggregation. Input up to ``morsel_size_rows`` rows
    aggregates in one phase; larger input aggregates each morsel into
    partials on the compute pool, then combines the partials (the
    reference's two-phase plan, executor.py:2240-2283)."""
    from ..core.kernels.groupby import grouped_agg
    from ..utils.pool import pool_map

    batches, morsels = _agg_morsels(stream, aggs)
    if morsels is None:
        big = RecordBatch.concat(batches) if batches else RecordBatch.empty(in_schema)
        return grouped_agg(big, groupby, aggs)
    partial, final, projection = _split_aggs(aggs)
    partials = pool_map(lambda m: grouped_agg(m, groupby, partial), morsels)
    keys = [col(e.name()) for e in groupby]
    combined = grouped_agg(RecordBatch.concat(partials), keys, final)
    return eval_projection(combined, keys + projection)


def _ungrouped_agg(stream, aggs, in_schema) -> RecordBatch:
    """Host ungrouped aggregation into one row, in two phases as
    ``_two_phase_agg`` past a morsel of input."""
    from ..core.kernels.groupby import ungrouped_agg
    from ..utils.pool import pool_map

    batches, morsels = _agg_morsels(stream, aggs)
    if morsels is None:
        if not batches:
            return ungrouped_agg(RecordBatch.empty(in_schema), aggs)
        return ungrouped_agg(batches[0] if len(batches) == 1 else RecordBatch.concat(batches),
                             aggs)
    partial, final, projection = _split_aggs(aggs)
    partials = pool_map(lambda m: ungrouped_agg(m, partial), morsels)
    return eval_projection(ungrouped_agg(RecordBatch.concat(partials), final), projection)


def _full_length(s: Series, n: int) -> Series:
    return s.broadcast(n) if len(s) == 1 and n != 1 else s


def _filter_part(part: MicroPartition, predicate: Expression,
                 keep: Optional[List[str]] = None) -> MicroPartition:
    """The rows of ``part`` where ``predicate`` is true; with ``keep``, only
    those columns are gathered."""
    batches = []
    schema = part.schema
    for b in part.batches:
        mask = eval_expression(b, predicate)
        if keep is not None:
            b = b.select_columns(keep)
            schema = b.schema
        if len(mask) == 1 and b.num_rows != 1:
            hit = bool(mask.validity_numpy()[0] and mask.to_numpy()[0])
            batches.append(b if hit else b.head(0))
        else:
            batches.append(b.filter_by_mask(mask))
    if keep is not None and not part.batches:
        schema = Schema([part.schema[c] for c in keep])
    return MicroPartition(schema, batches or [RecordBatch.empty(schema)])


def _concat_parts(parts: List[MicroPartition], schema) -> RecordBatch:
    batches = [b for p in parts for b in p.batches if b.num_rows > 0]
    if not batches:
        return RecordBatch.empty(schema)
    return RecordBatch.concat(batches)
