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
without the mesh arm): each batch is buffered, and when the
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
host by the rows' hash (or at random, or into equal slices in order for
``IntoPartitions``), or, for a hash repartition into ``mesh_devices``
partitions, runs the mesh exchange on the device (``_mesh_repartition``).
A ``PhysWindow`` evaluates its window functions on the host
(execution/window.py). ``PhysUnpivot``, ``PhysSample``, ``PhysMonotonicId``,
``PhysMapGroups``, ``PhysPivot`` and ``PhysIntoBatches`` run on the host
(core/relational.py), as the reference's executor.py:212-404. A
``PhysWrite`` hands its input stream to the writer (io/writers.py). Any
other error, a kernel that fails to build or launch included, propagates,
from a stage thread through its channel: no device failure turns into a
host result.

Placement: under ``device_mode="on"`` every device node runs on the device
(each run recorded as forced in the placement ledger,
observability/placement.py); under "off" on the host; under "auto" each
device aggregate, join, join TopN and device UDF prices its first morsel
on the host and on the card (``_device_wins``, ``_join_device_wins``,
``_udf_device_wins``, over ops/costmodel.py) and runs where it is cheaper.
A CPU device is gated to the host without pricing (``_auto_gate``).

Out of core (``memory_limit_bytes`` > 0; memory/): the host sort, the host
aggregations, the host join's build side and the window admit each batch
against the process's byte ledger and, once it is over the budget, switch
to their spilling strategies: the external sort (sorted runs and a k-way
merge), Grace aggregation (K = 32), the Grace join and the Grace window
(K = 16 each); streaming scans pace themselves by the ledger's pressure.
Device stages take no host budget. With the budget 0 (the default) none
of this runs: every operator takes its in-memory path and no ledger or
spill counter moves.
"""

from __future__ import annotations

import itertools
import threading
from typing import Iterator, List, Optional

import numpy as np

from ..core import relational as rel
from ..core.micropartition import MicroPartition
from ..core.recordbatch import RecordBatch
from ..core.series import Series
from ..datatype import DataType
from ..expressions.eval import eval_expression, eval_projection
from ..expressions.expressions import AggExpr, Alias, Expression, col
from ..observability import placement as _placement
from ..ops import costmodel as _costmodel
from ..plan import physical as pp
from ..plan.agg_split import UNSPLIT_AGGS as _UNSPLIT_AGGS
from ..plan.agg_split import agg_op as _agg_op
from ..plan.agg_split import split_aggs_exprs as _split_aggs
from ..schema import Schema
from ..utils.env import env_bool


def execute_plan(plan: pp.PhysicalPlan) -> Iterator[MicroPartition]:
    """Stream result MicroPartitions for a physical plan."""
    return _exec(plan)


# The operators that run as a stage of their own when the pipeline is on
# (the reference's _STAGE_NODES). The rest run on their consumer's thread:
# InMemoryScan yields references, PhysLimit and PhysTopN are cheap state
# machines, PhysWrite is a sink its consumer drives, a UDF's concurrency is
# the UDF tier's, and the device join runs (not stage nodes in the
# reference either) pull their fact and dims themselves.
_STAGE_NODES = (pp.StreamingScan, pp.Project, pp.PhysFilter, pp.PhysExplode, pp.PhysUnpivot,
                pp.PhysSample, pp.PhysSort, pp.HashAggregate, pp.DeviceFilterAgg,
                pp.DeviceGroupedAgg, pp.Dedup, pp.PhysPivot, pp.HashJoin, pp.CrossJoin,
                pp.PhysRepartition, pp.PhysWindow)


def _exec(node: pp.PhysicalPlan) -> Iterator[MicroPartition]:
    """One node's stream: on a stage thread behind a bounded channel when it
    is a stage node and the pipeline is on (execution/pipeline.py
    ``spawn_stage``), else the node's generator itself. While a stats
    collector is active (a subscriber, explain_analyze) the stream is
    wrapped to count its rows and time (observability/runtime_stats.py),
    and the stage's channel attributes its stalls to the node; with none,
    the generator runs as it is."""
    from ..observability.runtime_stats import current_collector

    c = current_collector()
    gen = _exec_impl(node)
    if c is not None:
        gen = c.wrap(node, gen)
    if isinstance(node, _STAGE_NODES) and _pipeline_on():
        from .pipeline import spawn_stage

        gen = spawn_stage(gen, node=node)
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
        yield from _sort_exec(node)
        return

    if isinstance(node, pp.PhysWindow):
        yield from _window_exec(node)
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
                                 node.input.schema, node)
        else:
            out = _ungrouped_agg(_exec(node.input), node.aggregations, node.input.schema,
                                 node)
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

    if isinstance(node, pp.PhysConcat):
        for child in node.inputs:
            yield from _exec(child)
        return

    if isinstance(node, pp.PhysRepartition):
        yield from _repartition(node)
        return

    if isinstance(node, pp.ShuffleWrite):
        from ..distributed.shuffle import MapOutputWriter

        out = MapOutputWriter(node.shuffle_dir, node.shuffle_id, node.map_id,
                              node.num_partitions)
        try:
            for part in _exec(node.input):
                for b in part.batches:
                    if b.num_rows == 0:
                        continue
                    keys = [_full_length(eval_expression(b, e), b.num_rows) for e in node.by]
                    for j, piece in enumerate(b.partition_by_hash(keys, node.num_partitions)):
                        out.append(j, piece)
        finally:
            out.close()
        return

    if isinstance(node, pp.ShuffleRead):
        if node.fetch_endpoints:
            from ..distributed.fetch_server import fetch_partition

            yield from fetch_partition(node.fetch_endpoints, node.shuffle_id,
                                       node.partition_idx, node.schema,
                                       expected_maps=node.expected_maps)
            return
        from ..distributed import shuffle as shf

        yield from shf.read_partition(node.shuffle_dir, node.shuffle_id,
                                      node.partition_idx, node.schema,
                                      expected_maps=node.expected_maps)
        return

    if isinstance(node, pp.PhysExplode):
        def explode(part, _i):
            batches = [rel.explode(b, node.to_explode, node.schema) for b in part.batches]
            return MicroPartition(node.schema, batches or [RecordBatch.empty(node.schema)])

        yield from _map_op(_exec(node.input), explode)
        return

    if isinstance(node, pp.PhysUnpivot):
        def unpivot(part, _i):
            batches = [rel.unpivot(b, [_full_length(eval_expression(b, e), b.num_rows)
                                       for e in node.ids],
                                   [_full_length(eval_expression(b, e), b.num_rows)
                                    for e in node.values],
                                   node.variable_name, node.value_name, node.schema)
                       for b in part.batches]
            return MicroPartition(node.schema, batches or [RecordBatch.empty(node.schema)])

        yield from _map_op(_exec(node.input), unpivot)
        return

    if isinstance(node, pp.PhysSample):
        # a seeded sample without replacement hashes each row's position in
        # the stream (rel.sample_at): the same seed keeps the same rows
        # however the stream is batched, as in the reference
        offset = 0
        for i, part in enumerate(_exec(node.input)):
            batches = []
            for b in part.batches:
                if node.seed is not None and not node.with_replacement:
                    batches.append(rel.sample_at(b, node.fraction, node.seed, offset))
                else:
                    seed = None if node.seed is None else node.seed + i
                    batches.append(rel.sample(b, node.fraction, node.with_replacement, seed))
                offset += b.num_rows
            yield MicroPartition(node.schema, batches or [RecordBatch.empty(node.schema)])
        return

    if isinstance(node, pp.PhysMonotonicId):
        # the partition index in the top 28 bits, the row's position in its
        # partition in the low 36, as the reference
        for part_id, part in enumerate(_exec(node.input)):
            offset = 0
            batches = []
            for b in part.batches:
                ids = (np.uint64(part_id) << np.uint64(36)) + np.arange(
                    offset, offset + b.num_rows, dtype=np.uint64)
                offset += b.num_rows
                id_col = Series.from_numpy(ids, node.column_name, DataType.uint64())
                batches.append(RecordBatch(node.schema, [id_col] + b.columns(), b.num_rows))
            yield MicroPartition(node.schema, batches or [RecordBatch.empty(node.schema)])
        return

    if isinstance(node, pp.PhysMapGroups):
        yield _exec_map_groups(node)
        return

    if isinstance(node, pp.PhysPivot):
        keys = list(node.groupby) + [node.pivot_col]
        sub = _two_phase_agg(_exec(node.input), keys, [AggExpr(node.agg_op, node.value_col)],
                             node.input.schema)
        yield MicroPartition(node.schema, [rel.pivot(sub, len(node.groupby), node.names,
                                                     node.schema)])
        return

    if isinstance(node, pp.PhysIntoBatches):
        buffer: List[RecordBatch] = []
        buffered = 0
        for part in _exec(node.input):
            for b in part.batches:
                buffer.append(b)
                buffered += b.num_rows
                while buffered >= node.batch_size:
                    big = RecordBatch.concat(buffer)
                    rest = big.slice(node.batch_size, big.num_rows)
                    yield MicroPartition(node.schema, [big.head(node.batch_size)])
                    buffer = [rest] if rest.num_rows else []
                    buffered = rest.num_rows
        if buffered:
            yield MicroPartition(node.schema, [RecordBatch.concat(buffer)])
        return

    raise NotImplementedError(f"no executor for {node.name()}")


def _exec_map_groups(node) -> MicroPartition:
    """The UDF expression over each group's rows (groups in first
    occurrence order), each group's keys repeated for every row it emits,
    as the reference."""
    from ..core.kernels.groupby import make_groups

    batch = _concat_parts(list(_exec(node.input)), node.input.schema)
    if batch.num_rows == 0:
        return MicroPartition(node.schema, [RecordBatch.empty(node.schema)])
    key_series = [_full_length(eval_expression(batch, e), batch.num_rows)
                  for e in node.groupby]
    first_idx, group_ids, _counts = make_groups(key_series)
    order = np.argsort(group_ids, kind="stable")
    bounds = np.concatenate([[0], np.flatnonzero(np.diff(group_ids[order])) + 1,
                             [len(order)]]).astype(np.int64)
    outs: List[Series] = []
    for g in range(len(first_idx)):
        sub = batch.take(order[bounds[g]:bounds[g + 1]])
        outs.append(eval_expression(sub, node.udf_expr))  # any number of rows
    reps = np.repeat(np.arange(len(first_idx), dtype=np.int64),
                     np.asarray([len(o) for o in outs], dtype=np.int64))
    cols = [ks.take(first_idx).take(reps) for ks in key_series] + [Series.concat(outs)]
    out = RecordBatch(node.schema, [c.cast(f.dtype) if c.dtype != f.dtype else c
                                    for c, f in zip(cols, node.schema)], int(len(reps)))
    return MicroPartition(node.schema, [out])


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
    ``scan_window_peak``.

    Under a host memory budget (``memory_limit_bytes`` > 0; the
    reference's :486-533), the scan paces itself by the ledger: before each
    task, after each morsel it yields while the ledger is under pressure,
    and before each task the window starts, it waits for headroom
    (``wait_for_headroom``: bounded, counted in ``scan_backpressure_stalls``
    and ``scan_stall_ms``), and it counts the ``size_bytes`` it yielded in
    ``scan_bytes``. Unbudgeted, none of this runs.

    While a span recorder is active each task's read is one "scan.stream"
    span, and a stats collector notes the task count beside the node."""
    from ..observability.runtime_stats import current_collector, span_iter
    from ..ops import counters
    from .memory import manager

    c = current_collector()
    if c is not None:
        c.annotate(node, f"streaming: {len(node.tasks)} tasks")

    def task_parts(task):
        for part in span_iter("scan.stream", "scan", task.read(),
                              source=task.source_label):
            if node.post_filter is not None and not task.filters_applied:
                part = _timed_filter(part, node.post_filter)
            yield part

    mgr = manager()
    budgeted = mgr.limit_bytes() > 0
    remaining = node.post_limit
    batches = rows = nbytes = 0
    try:
        if remaining is not None or len(node.tasks) <= 1 or not _pipeline_on():
            for task in node.tasks:
                counters.bump("scan_tasks")
                if budgeted:
                    mgr.wait_for_headroom()
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
                    if budgeted:
                        nbytes += part.size_bytes()
                    yield part
                    if budgeted and mgr.under_pressure():
                        mgr.wait_for_headroom()
            return
        for part in _scan_window(node.tasks, task_parts, mgr if budgeted else None):
            batches += 1
            rows += part.num_rows
            if budgeted:
                nbytes += part.size_bytes()
            yield part
    finally:
        counters.bump("scan_batches", batches)
        counters.bump("scan_rows", rows)
        if nbytes:
            counters.bump("scan_bytes", nbytes)


def _scan_window(tasks, task_parts, mgr=None) -> Iterator[MicroPartition]:
    """The scan tasks read on the compute pool, up to its width at once,
    their morsels yielded in task order; with a budget's ``mgr``, a task
    starts only after a bounded wait for headroom while under pressure."""
    import threading
    from collections import deque
    from concurrent.futures import wait

    from ..observability.metrics import registry
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
                if mgr is not None and mgr.under_pressure():
                    mgr.wait_for_headroom()
                futures.append(pool.submit(read_task, tasks[ti]))
                ti += 1
            yield from futures.popleft().result()
    finally:
        wait([f for f in futures if not f.cancel()])
        registry().set_gauge_max("scan_window_peak", reading[1])


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
    count, so the ratio measures fusion, not bare aggregates; EXPLAIN
    ANALYZE shows the region beside the node."""
    if dispatches <= 0 or len(region_ops) < 2:
        return
    from ..observability.runtime_stats import current_collector
    from ..ops import counters
    from ..ops.region import region_label

    counters.bump("device_region_dispatches", dispatches)
    counters.bump("device_region_ops_fused", dispatches * len(region_ops))
    c = current_collector()
    if c is not None:
        d = "1 dispatch" if dispatches == 1 else f"{dispatches} dispatches"
        c.annotate(node, f"fused region: {len(region_ops)} ops "
                         f"({region_label(region_ops)}), {d}")


# ---- placement: device_mode="auto" and the placement ledger --------------------------
#
# The reference's cost-model decision points (daft_tpu/execution/executor.py:
# the "auto" branch of _exec_device_agg, _device_wins, the join's auto path
# and _join_device_wins, the device UDF's and _udf_device_wins, the bounded
# decision cache), priced by ops/costmodel.py over the port's kernel tier.
# Under "on" each device run is recorded as forced (priced too with
# DAFT_TPU_PLACEMENT_PRICE_FORCED) and wrapped in placement.feedback, as in
# the reference; under "off" nothing here runs.


def _auto_gate(cfg) -> Optional[str]:
    """Why "auto" keeps a stage on the host without pricing it, or None: the
    configured device is the CPU (the counterpart of the reference's
    ``jax.default_backend() == "cpu"`` bail). A "cuda" device without a card
    raises here, through resolve_device, as under "on". The one function
    the tests monkeypatch to price stages on CPU tensors."""
    from ..utils.torch_setup import resolve_device

    return "cpu device" if resolve_device(cfg.device).type == "cpu" else None


def _price_forced(cfg) -> bool:
    """Price a forced "on" run too (DAFT_TPU_PLACEMENT_PRICE_FORCED), so the
    ledger gets predicted-against-observed samples; never on a CPU device,
    which has no calibration to price with."""
    return env_bool("DAFT_TPU_PLACEMENT_PRICE_FORCED", False) and _auto_gate(cfg) is None


class _BoundedDecisionCache:
    """Thread-safe bounded FIFO verdict cache. Concurrent queries hit it from
    many threads at once; a plain dict's ``pop(next(iter(d)))`` eviction
    under concurrent insertion can raise mid-query, so reads and the
    insert+evict pair are locked (one probe per cost decision, never per
    row)."""

    def __init__(self, cap: int = 512):
        self._lock = threading.Lock()
        self._d: dict = {}
        self.cap = cap

    def get(self, key, default=None):
        with self._lock:
            return self._d.get(key, default)

    def put(self, key, value) -> None:
        with self._lock:
            self._d[key] = value
            while len(self._d) > self.cap:
                self._d.pop(next(iter(self._d)))

    def clear(self) -> None:
        with self._lock:
            self._d.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


_DECISION_CACHE = _BoundedDecisionCache()


def _invalidate_costed_verdicts() -> None:
    """costmodel.reset_calibration() hook: every cached verdict was priced
    under the Calibration being discarded, so a recalibrated process
    re-decides instead of replaying stale verdicts."""
    _DECISION_CACHE.clear()


_costmodel.on_calibration_reset(_invalidate_costed_verdicts)


def _batch_layout(part: MicroPartition) -> tuple:
    """Batch-granularity signature of one partition: (nonempty batch count,
    mean batch rows padded to its bucket). The coalesce horizon derives from
    it, so it identifies a cached verdict without a second-partition peek."""
    from ..ops.stage import pad_bucket

    sizes = [b.num_rows for b in part.batches if b.num_rows > 0]
    if not sizes:
        return (0, 0)
    return (len(sizes), pad_bucket(int(sum(sizes) / len(sizes))))


def _decision_key(node, rows: int, cfg, topn: bool, layout: tuple) -> tuple:
    """Structural identity of one join decision: the captured spec's shape,
    the input size, the config knobs the decision reads, the fact's batch
    layout and the dim tables' identity. A repeat whose tail or residency
    differs reuses the verdict (a repeat-query heuristic, as in the
    reference); a config change to a keyed knob re-decides."""
    from ..device.residency import identity_token

    spec = node.spec
    return (
        topn, rows, cfg.device_mode, cfg.device_amortize_runs,
        cfg.batch_fill_target, cfg.morsel_size_rows, layout, cfg.device,
        repr(spec.predicate),
        tuple(repr(g) for g in spec.groupby),
        tuple(repr(a) for a in spec.aggregations),
        tuple((d.key_col, d.parent) for d in spec.dims),
        tuple(identity_token(part)
              for _n, plan in node.dim_plans
              for part in getattr(plan, "partitions", ())),
    )


def _coalesce_horizon(parts) -> float:
    """Expected dispatch-coalescing factor from the observed leading
    partitions' batch granularity (the first, and a peeked second): the
    mean nonempty batch size against the coalescer's flush threshold,
    capped by the number of batches seen, so the model never prices an
    amortization the coalescer cannot deliver. 1.0 with coalescing off."""
    from ..config import execution_config
    from .batching import coalesce_target_rows

    target = coalesce_target_rows(execution_config())
    if target <= 0:
        return 1.0
    sizes = [b.num_rows for p in parts for b in p.batches if b.num_rows > 0]
    if len(sizes) <= 1:
        return 1.0
    mean_rows = int(sum(sizes) / len(sizes))
    return min(_costmodel.expected_coalesce_factor(mean_rows, target), float(len(sizes)))


def _resident_source(n) -> bool:
    """True when the chain under ``n`` ends in an in-memory table (its
    planes stay resident across queries)."""
    while n is not None:
        if isinstance(n, pp.InMemoryScan):
            return True
        n = getattr(n, "input", None)
    return False


def _resident_source_rec(n) -> bool:
    """True if every leaf under ``n`` is an in-memory scan."""
    kids = n.children()
    if not kids:
        return isinstance(n, pp.InMemoryScan)
    return all(_resident_source_rec(k) for k in kids)


def _plane_bytes(batch, cols, bucket: int, f32: bool, device) -> tuple:
    """(non-resident, resident) upload bytes of ``cols`` of one batch in the
    stage's layout: 4 or 8 value bytes and a validity byte a row."""
    per = 5 if f32 else 9
    nonres = res = 0
    for c in cols:
        if batch.get_column(c).is_device_resident(bucket, f32=f32, device=device):
            res += batch.num_rows * per
        else:
            nonres += batch.num_rows * per
    return nonres, res


def _auto_agg(node, stream, grouped: bool, cfg):
    """The reference's "auto" branch of a device aggregate: peek the first
    morsel (and a second when the coalescer is on), apply the
    device_min_rows gate and the CPU gate, then price it. Returns
    (run on the device, placement record, the stream with the peeked
    morsels chained back)."""
    from .batching import coalesce_target_rows

    site = "grouped agg" if grouped else "agg"
    first = next(stream, None)
    if first is None:
        return False, None, stream
    second = None
    wins, prec = False, None
    if first.num_rows < cfg.device_min_rows:
        # the common tiny-query bail: recorded only when a scope listens
        _placement.ledger().gate(site, "below device_min_rows", first.num_rows,
                                 only_scoped=True)
    else:
        why = _auto_gate(cfg)
        if why is not None:
            _placement.ledger().gate(site, why, first.num_rows, only_scoped=True)
        else:
            if coalesce_target_rows(cfg) > 0:
                # a second morsel widens the coalesce horizon the model prices
                second = next(stream, None)
            wins, prec = _device_wins(node, first, grouped, second=second)
            if not wins:
                from ..ops import counters

                counters.reject(site, "host wins cost model")
    peeked = [first] if second is None else [first, second]
    return wins, prec, itertools.chain(peeked, stream)


def _forced_record(node, stream, grouped: bool, cfg):
    """The ledger record of a forced ("on") device aggregate: priced under
    DAFT_TPU_PLACEMENT_PRICE_FORCED, else uncosted. Returns (record, stream
    with any peeked morsel chained back)."""
    prec = None
    if _price_forced(cfg):
        first = next(stream, None)
        if first is not None:
            stream = itertools.chain([first], stream)
            _w, prec = _device_wins(node, first, grouped, forced=True)
    if prec is None:
        prec = _placement.ledger().record("grouped agg" if grouped else "agg", "device",
                                          forced=True)
    return prec, stream


def _device_wins(node, first: MicroPartition, grouped: bool,
                 second: Optional[MicroPartition] = None, forced: bool = False):
    """Cost-model decision for one device aggregate from its first morsel:
    (wins, placement record), the record carrying both sides'
    CostBreakdowns. One-time costs (uploads, dictionary builds, the host
    factorize the port caches on a batch) amortize over
    ``device_amortize_runs`` when the input is a resident in-memory table;
    a file scan pays them in full. ``forced`` prices a forced run for the
    ledger only: the caller ignores the verdict."""
    from ..config import execution_config
    from ..ops.region import node_region_ops
    from ..ops.stage import pad_bucket
    from ..utils.torch_setup import resolve_device

    site = "grouped agg" if grouped else "agg"
    batch = next((b for b in first.batches if b.num_rows > 0), None)
    if batch is None:
        return False, None
    cfg = execution_config()
    device = resolve_device(cfg.device)
    rows = first.num_rows
    cal = _costmodel.calibrate()
    coal = _coalesce_horizon([first] if second is None else [first, second])
    amort = max(cfg.device_amortize_runs, 1) if _resident_source(node.input) else 1
    # region ops the host path evaluates BEYOND the filter + agg that
    # host_agg_cost's base terms already price (absorbed projects/filters)
    extra_ops = max(len(node_region_ops(node)) - (2 if node.predicate is not None else 1), 0)
    bucket = pad_bucket(batch.num_rows)
    if grouped:
        from ..ops.grouped_stage import (MAX_SORT_SEGMENTS, _pad_groups, estimate_groups,
                                         resolve_key_series, try_build_grouped_agg_stage)

        stage = try_build_grouped_agg_stage(node.input.schema, node.predicate,
                                            node.groupby, node.aggregations)
        if stage is None:
            return False, None
        f32 = not stage._use_f64
        nonres, res = _plane_bytes(batch, stage._input_cols, bucket, f32, device)
        key_series = resolve_key_series(batch, stage.groupby, batch.num_rows)
        card = estimate_groups(key_series, batch.num_rows)
        if card > MAX_SORT_SEGMENTS and not forced:
            # the run would raise DeviceFallback before its first launch
            from ..ops import counters

            counters.reject(site, "est group count over ceiling")
            _placement.ledger().gate(site, "est group count over ceiling", rows)
            return False, None
        cap = _pad_groups(min(card, MAX_SORT_SEGMENTS))
        if stage.dict_keys:
            # dictionary builds and code planes are cached per Series:
            # amortized like uploads; a new morsel's Series builds its own
            fact_rows = sum(batch.num_rows for s in key_series
                            if getattr(s, "_dict_codes", None) is None)
            for s in key_series:
                from ..device.residency import manager as _residency

                if not _residency().is_resident(s, ("dictcodes", bucket, str(device))):
                    nonres += batch.num_rows * 4
        else:
            # host-factorized codes are cached on the batch (stage_cache)
            fact_rows = batch.num_rows
            nonres += batch.num_rows * 4
        k1, k7 = (len(r) for r in stage.sum_routes())
        # a float extreme takes two K3 launches (the value, its zero's sign)
        k3 = len(stage._ext_specs) - 1 + len(stage._float_ext) + len(stage._sct_specs)
        dev = _costmodel.device_grouped_kernel_cost(
            cal, rows, nonres // amort, k1=k1, k7=k7, k2=1, k3=k3, cap=cap,
            factorize_rows=fact_rows // amort, coalesce=coal, resident_bytes=res)
        host = _costmodel.host_agg_cost(cal, rows, len(node.aggregations), grouped=True,
                                        has_predicate=node.predicate is not None,
                                        n_region_ops=extra_ops)
        detail = (f"{len(node.groupby)} keys, {len(node.aggregations)} aggs, "
                  f"~{card} groups (cap {cap}), K1 {k1} / K7 {k7} / K2 1 / K3 {k3} planes")
    else:
        from ..ops.stage import try_build_filter_agg_stage

        stage = try_build_filter_agg_stage(node.input.schema, node.predicate,
                                           node.aggregations)
        if stage is None:
            return False, None
        nonres, res = _plane_bytes(batch, stage._input_cols, bucket, not stage._use_f64,
                                   device)
        dev = _costmodel.device_ungrouped_cost(cal, rows, nonres // amort,
                                               n_partials=max(len(stage.aggs), 1),
                                               coalesce=coal, resident_bytes=res)
        host = _costmodel.host_agg_cost(cal, rows, len(node.aggregations), grouped=False,
                                        has_predicate=node.predicate is not None,
                                        n_region_ops=extra_ops)
        detail = (f"{len(node.aggregations)} aggs"
                  + (", filtered" if node.predicate is not None else ""))
    wins = dev < host
    rec = _placement.ledger().record(site, "device" if (wins or forced) else "host", rows,
                                     forced=forced, device=dev, host=host, detail=detail)
    return wins, rec


def _exec_device_agg(node: pp.DeviceGroupedAgg) -> MicroPartition:
    """Run a DeviceGroupedAgg: the device stage, or the host under
    device_mode="off", where "auto" prices the host lower, and after a
    DeviceFallback. The host path and the rerun buffer read the node's
    input narrowed to its referenced columns; the device stage reads the
    input batches themselves, so their cached planes and group codes still
    hit."""
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
        out = _two_phase_agg(s, node.groupby, node.aggregations, node.input.schema, node)
        return MicroPartition(node.schema, [out.cast_to_schema(node.schema)])

    if cfg.device_mode == "off":
        return _host_agg(_narrowed(stream, keep))
    if cfg.device_mode == "auto":
        wins, prec, stream = _auto_agg(node, stream, True, cfg)
        if not wins:
            return _host_agg(_narrowed(stream, keep))
    else:
        prec, stream = _forced_record(node, stream, True, cfg)

    device = resolve_device(cfg.device)
    stage = try_build_grouped_agg_stage(node.input.schema, node.predicate,
                                        node.groupby, node.aggregations)
    if stage is None:
        raise RuntimeError("planner emitted DeviceGroupedAgg for a stage the "
                           "kernel tier does not accept under the current config")
    run = stage.start_run(device)
    buffered: List[MicroPartition] = []
    fed_rows = 0

    def buffering():
        nonlocal fed_rows
        for part in stream:
            buffered.append(part if keep is None else part.select_columns(keep))
            fed_rows += part.num_rows
            yield part

    d0 = counters.device_grouped_batches
    try:
        # pin the query's resident planes so a tight budget cannot evict
        # buffers this run still reads; released at scope exit
        with _placement.feedback(prec) as fb, _residency().pin_scope():
            _feed_stream(buffering(), run.feed_batch, cfg)
            fb.set_rows(fed_rows)
            key_rows, results = run.finalize()
    except DeviceFallback as exc:
        # raised before any launch for the offending batch: rerun the whole
        # buffered region on the host (the composed expressions evaluate
        # compositionally, so the result is the fused program's)
        counters.bump("device_fallbacks")
        counters.reject("grouped agg", f"device fallback: {type(exc).__name__}")
        _note_fallback(exc)
        return _host_agg(itertools.chain(buffered, _narrowed(stream, keep)))
    _note_region(node, node_region_ops(node), counters.device_grouped_batches - d0)
    return _grouped_output(node.schema, node.groupby, node.aggregations,
                           key_rows, results)


def _exec_device_filter_agg(node: pp.DeviceFilterAgg) -> MicroPartition:
    """Run a DeviceFilterAgg: the ungrouped device stage over every batch
    of the input, or the host (over the input narrowed to its referenced
    columns) under device_mode="off" and where "auto" prices the host
    lower. A failure on the device raises: nothing reruns on the host."""
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
    if cfg.device_mode == "auto":
        wins, prec, stream = _auto_agg(node, stream, False, cfg)
        if not wins:
            return _host_filter_agg(node, stream)
    else:
        prec, stream = _forced_record(node, stream, False, cfg)
    device = resolve_device(cfg.device)
    stage = try_build_filter_agg_stage(node.input.schema, node.predicate, node.aggregations)
    if stage is None:
        raise RuntimeError("planner emitted DeviceFilterAgg for a stage the device does "
                           "not accept")
    run = stage.start_run(device)
    d0 = counters.device_stage_batches
    fed_rows = 0

    def counting():
        nonlocal fed_rows
        for part in stream:
            fed_rows += part.num_rows
            yield part

    with _placement.feedback(prec) as fb, _residency().pin_scope():
        _feed_stream(counting(), run.feed_batch, cfg)
        fb.set_rows(fed_rows)
        final = run.finalize()
    _note_region(node, node_region_ops(node), counters.device_stage_batches - d0)
    return _ungrouped_output(node.schema, stage, final)


def _host_filter_agg(node: pp.DeviceFilterAgg, stream) -> MicroPartition:
    """A DeviceFilterAgg on the host, over its input narrowed to the columns
    it reads."""
    stream = _narrowed(stream, _region_keep_columns(node))
    if node.predicate is not None:
        stream = (_filter_part(p, node.predicate) for p in stream)
    out = _ungrouped_agg(stream, node.aggregations, node.input.schema, node)
    return MicroPartition(node.schema, [out.cast_to_schema(node.schema)])


def _udf_host_parts(node: pp.UDFProject, stream, on_cpu: bool = False
                    ) -> Iterator[MicroPartition]:
    """A UDFProject on the host, one part at a time (a device Func through
    ops/udf_stage.py ``host_eval_device_func``, on the configured device, or
    on the CPU under device_mode="off" and with ``on_cpu``, the host arm of
    an "auto" verdict)."""
    exprs = list(node.passthrough) + [node.udf_expr]
    for part in stream:
        if on_cpu:
            from ..ops.udf_stage import host_arm

            with host_arm():
                batches = [eval_projection(b, exprs) for b in part.batches]
        else:
            batches = [eval_projection(b, exprs) for b in part.batches]
        yield MicroPartition(node.schema, batches or [RecordBatch.empty(node.schema)])


def _exec_device_udf(node: pp.DeviceUdfProject) -> Iterator[MicroPartition]:
    """Run a DeviceUdfProject: the device-UDF stage on the configured device
    (which must be there), or the host path under device_mode="off" (on the
    CPU, never touching the card) and where "auto" prices the host lower
    (``device_udf_cost`` against ``host_udf_cost``, cached per function
    fingerprint and batch layout)."""
    from ..config import execution_config
    from ..ops import counters
    from ..ops.udf_stage import func_fingerprint

    cfg = execution_config()
    call = pp.device_udf_call(node.udf_expr)
    stream = _exec(node.input)
    if cfg.device_mode == "off":
        yield from _udf_host_parts(node, stream)
        return
    prec = None
    if cfg.device_mode == "auto":
        why = _auto_gate(cfg)
        if why is not None:
            counters.reject("device udf", why)
            counters.bump("device_udf_fallbacks")
            _placement.ledger().gate("udf", why, only_scoped=True)
            yield from _udf_host_parts(node, stream, on_cpu=True)
            return
        first = next(stream, None)
        if first is None:
            yield MicroPartition(node.schema, [RecordBatch.empty(node.schema)])
            return
        stream = itertools.chain([first], stream)
        dk = ("udf", func_fingerprint(call.func), cfg.device_mode, cfg.batch_fill_target,
              cfg.morsel_size_rows, cfg.device, _batch_layout(first))
        wins = _DECISION_CACHE.get(dk)
        if wins is None:
            wins, prec = _udf_device_wins(call.func, first, _coalesce_horizon([first]))
            _DECISION_CACHE.put(dk, wins)
        else:
            prec = _placement.ledger().record("udf", "device" if wins else "host",
                                              first.num_rows, cached=True,
                                              detail=call.func.name)
        if not wins:
            counters.reject("device udf", "host wins cost model")
            counters.bump("device_udf_fallbacks")
            yield from _udf_host_parts(node, stream, on_cpu=True)
            return
    else:
        if _price_forced(cfg):
            first = next(stream, None)
            if first is None:
                yield MicroPartition(node.schema, [RecordBatch.empty(node.schema)])
                return
            stream = itertools.chain([first], stream)
            _w, prec = _udf_device_wins(call.func, first, _coalesce_horizon([first]),
                                        forced=True)
        if prec is None:
            prec = _placement.ledger().record("udf", "device", forced=True,
                                              detail=call.func.name)
    yield _run_device_udf_stage(node, stream, cfg, prec)


def _udf_device_wins(func, first: MicroPartition, coal: float, forced: bool = False):
    """Cost decision for one device-UDF stage: (wins, placement record). The
    flops estimate is the reference's, coarse (2 x weight scalars a row);
    both sides use it, so the verdict hangs on the measured rates, the
    per-morsel input upload and the coalesce-amortized round trip. Weight
    uploads are priced at zero: a residency-managed one-time investment."""
    from ..ops.udf_stage import func_weight_nbytes

    cal = _costmodel.calibrate()
    rows = first.num_rows
    w_nbytes = func_weight_nbytes(func)
    w_scalars = (w_nbytes // 4) if w_nbytes else 1 << 20
    flops = 2.0 * w_scalars * rows
    in_bytes = rows * 1024        # tokenized ids + mask, order of magnitude
    fetch_bytes = rows * 512      # output rows (embedding width order)
    dev = _costmodel.device_udf_cost(cal, rows, in_bytes, flops, fetch_bytes, coalesce=coal)
    host = _costmodel.host_udf_cost(cal, flops)
    wins = dev < host
    rec = _placement.ledger().record("udf", "device" if (wins or forced) else "host", rows,
                                     forced=forced, device=dev, host=host, detail=func.name)
    return wins, rec


def _run_device_udf_stage(node: pp.DeviceUdfProject, stream, cfg,
                          prec=None) -> MicroPartition:
    """One DeviceUdfProject on the device tier: the input's batches through
    the dispatch coalescer into the stage, under a pin scope that holds the
    weights, one copy back at finalize; the output is the passthrough
    columns and the decoded UDF column. A failure raises: nothing reruns on
    the host."""
    from ..device.residency import manager as _residency
    from ..observability.runtime_stats import current_collector
    from ..ops.udf_stage import DeviceUdfStage, finish_series, func_anchors
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

    with _placement.feedback(prec) as fb, _residency().pin_scope():
        run = stage.start_run(device)
        _feed_stream(keeping(), run.feed_batch, cfg)
        fb.set_rows(sum(p.num_rows for p in parts))
        out, valid = run.finalize()
    c = current_collector()
    if c is not None:
        anchors = func_anchors(call.func) or {}
        mb = sum(a.nbytes for a in anchors.values()) / 1e6
        c.annotate(node, f"device udf: {call.func.name}, weights {mb:.1f}MB resident")
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
    from ..observability.runtime_stats import current_collector
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
    # fusion runs only under "on": a forced record, so the fused dispatches
    # still land in the placement ledger
    prec = _placement.ledger().record("udf+agg fused", "device", forced=True,
                                      detail=call.func.name)
    with _placement.feedback(prec), _residency().pin_scope():
        feeder = FusedUdfAggFeeder(udf_stage.start_run(device), agg_run, udf_cols, other,
                                   f32=not agg_stage._use_f64)
        _feed_stream(_exec(udf_node.input), feeder.feed_batch, cfg)
        final = agg_run.finalize()
    # the UDF fed the aggregate in the same dispatch: one more fused op
    _note_region(node, ("udf",) + node_region_ops(node), counters.device_stage_batches - d0)
    c = current_collector()
    if c is not None:
        c.annotate(node, f"fused device udf: {call.func.name}")
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
                                [e.to_field(left_schema).dtype for e in node.left_on],
                                node.null_equals_null)

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


def _whole_join(node: pp.HashJoin, left: RecordBatch, right: RecordBatch) -> RecordBatch:
    """A right or outer join over both sides whole (``join_indices``),
    assembled as the reference's
    ``_assemble_join``: an outer join's merged key takes the right's value
    where the left has no row, a right join's is the right's."""
    from ..core.kernels.join import join_indices

    rkeys = _keys(right, node.right_on)
    li, ri = join_indices(_keys(left, node.left_on), rkeys, node.how,
                          node.null_equals_null)
    cols = [s.take_or_null(li) for s in left.columns()]
    names = [s.name for s in cols]
    for le, re_, rk in zip(node.left_on, node.right_on, rkeys):
        if re_.name() in node.merged_keys and le.name() in names:
            i = names.index(le.name())
            rv = rk.cast(cols[i].dtype) if rk.dtype != cols[i].dtype else rk
            rv = rv.take_or_null(ri).rename(le.name())
            if node.how == "right":
                cols[i] = rv
            else:
                miss = li < 0
                lv = cols[i]
                vals = np.where(miss, rv.to_numpy(), lv.to_numpy())
                valid = np.where(miss, rv.validity_numpy(), lv.validity_numpy())
                cols[i] = Series(lv.name, lv.dtype, vals, valid)
    cols += [s.take_or_null(ri).rename(node.right_rename.get(s.name, s.name))
             for s in right.columns() if s.name not in node.merged_keys]
    return RecordBatch(node.schema, cols, len(li))


def _hash_join(node: pp.HashJoin) -> Iterator[MicroPartition]:
    """A host join (the reference's ``_join_exec``, executor.py:2841-2978):
    the right side materialized and indexed once, the left side streamed
    through ``_map_op``, each morsel a probe (``_probe_stream``).

    Under a host memory budget the right side is admitted batch by batch
    against the ledger. Over it, both sides Grace-partition into K = 16
    co-partitioned spill files by the join keys' row hash, and each pair of
    partitions joins through a ``JoinProbe`` of its own: equal keys share a
    partition, so every join type the port has (inner, left, semi, anti)
    gives the same rows, grouped by partition. The ledger's bytes go back
    as the prefix reaches disk and, in a ``finally``, when the join ends."""
    from .memory import operator_budget

    budget = operator_budget()
    try:
        right_it = _batch_iter(_exec(node.right))
        right_parts, over = _admit_prefix(budget, right_it)
        if not over:
            right = RecordBatch.concat(right_parts) if right_parts \
                else RecordBatch.empty(node.right.schema)
            if _whole(node):
                left = _concat_parts(list(_exec(node.left)), node.left.schema)
                yield MicroPartition(node.schema, [_whole_join(node, left, right)])
                return
            yield from _probe_stream(node, right)
            return
        yield from _grace_join(node, budget, right_parts, right_it)
    finally:
        budget.close()


def _grace_join(node: pp.HashJoin, budget, right_parts, right_it) -> Iterator[MicroPartition]:
    from ..observability.runtime_stats import profile_span
    from .memory import SpillPartitions

    K = 16
    spr = SpillPartitions(node.right.schema, K)
    spl = SpillPartitions(node.left.schema, K)
    try:
        with profile_span("spill.grace_join", "spill", partitions=K):
            for b in _drain_prefix(budget, right_parts, right_it):
                spr.append_partitioned(b, node.right_on)
            for b in _batch_iter(_exec(node.left)):
                spl.append_partitioned(b, node.left_on)
        _annotate_spill(node, spr.bytes_written + spl.bytes_written, f"{K}x2 partitions")
        for fl, fr in zip(spl.files, spr.files):
            lbs = list(fl.read())
            if not lbs and node.how not in ("right", "outer"):
                continue  # inner, left, semi and anti give no row without a left row
            rbs = list(fr.read())
            right = RecordBatch.concat(rbs) if rbs else RecordBatch.empty(node.right.schema)
            left = RecordBatch.concat(lbs) if lbs else RecordBatch.empty(node.left.schema)
            out = _whole_join(node, left, right) if _whole(node) \
                else JoinProbe(node, right).probe(left)
            if out.num_rows:
                yield MicroPartition(node.schema, [out])
    finally:
        spr.delete()
        spl.delete()


def _whole(node: pp.HashJoin) -> bool:
    """A join that reads both sides whole: right or outer."""
    return node.how in ("right", "outer")


def _probe_stream(node: pp.HashJoin, right: RecordBatch) -> Iterator[MicroPartition]:
    """The left side's stream, each morsel probed into ``right``'s index.
    Where the left side is a Filter and the left keys are column
    references, the filter fuses into the probe: the raw batches stream,
    the predicate becomes a selection vector, and the probe gathers the
    other columns once."""
    from ..expressions.expressions import ColumnRef

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
                    exc = DeviceFallback("device TopN path requires a single fact batch")
                    exc.second_fact_batch = True  # no device work: nothing to observe
                    raise exc
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
    without its mesh arm): the host plan under device_mode="off"; under
    "auto" the CPU gate, the first fact morsel's device_min_rows gate, the
    decision cache's cached rejects and the cost decision
    (``_join_device_wins``, the dims materialized first); otherwise
    materialize the dims, build the join context, and feed the fact stream
    through the run under one pin scope and the placement feedback, then
    assemble. A DeviceFallback (non-unique or non-integer dim keys, a dim
    key equal to the probe table's empty marker, too many groups, a TopN's
    second fact batch: all decided before any launch) records its reason
    and runs the host plan. Any other error, a kernel failure included,
    propagates. A finished run counts as a fused region of ("join", "agg"),
    or ("join", "agg", "topn"), over its join batches."""
    from ..config import execution_config
    from ..device.residency import manager as _residency
    from ..ops import counters
    from ..ops.device_join import _JoinContext, build_join_stage
    from ..ops.grouped_stage import DeviceFallback
    from ..ops.region import single_batch_horizon
    from ..utils.torch_setup import resolve_device
    from .batching import coalesce_target_rows

    def host() -> MicroPartition:
        return MicroPartition(node.schema, [_concat_parts(list(_exec(node.host_plan)),
                                                          node.schema)])

    cfg = execution_config()
    if cfg.device_mode == "off":
        return host()
    topn = isinstance(node, pp.DeviceJoinTopN)
    auto = cfg.device_mode == "auto"
    if auto:
        why = _auto_gate(cfg)
        if why is not None:
            counters.reject(label, why)
            _placement.ledger().gate(label, why, only_scoped=True)
            return host()
    device = resolve_device(cfg.device)
    stage, grouped = build_join_stage(node.spec)
    if stage is None:
        return host()  # the config changed since planning (kernel_mode="off")
    region_ops = ("join", "agg", "topn") if topn else ("join", "agg")
    fact = _exec(node.fact)
    try:
        first = next(fact, None)
        if first is None:
            fact.close()
            return host()
        if auto and first.num_rows < cfg.device_min_rows:
            counters.reject(label, "below device_min_rows")
            _placement.ledger().gate(label, "below device_min_rows", first.num_rows,
                                     only_scoped=True)
            fact.close()
            return host()
        # a shape the model rejected before skips the dims and the pricing
        dk = _decision_key(node, first.num_rows, cfg, topn, _batch_layout(first))
        if auto and _DECISION_CACHE.get(dk) is False:
            counters.reject(label, "host wins (cached decision)")
            _placement.ledger().record(label, "host", first.num_rows, cached=True,
                                       reason="host wins (cached decision)")
            fact.close()
            return host()
        second = None
        if auto and not topn and coalesce_target_rows(cfg) > 0:
            # a second morsel widens the coalesce horizon the model prices
            second = next(fact, None)
        peeked = [first] if second is None else [first, second]
        fact_stream = itertools.chain(peeked, fact)
        # the TopN is a one-batch region: its round trip is priced in full
        coal = single_batch_horizon() if topn else _coalesce_horizon(peeked)
        dims = {name: _concat_parts(list(_exec(plan)), plan.schema)
                for name, plan in node.dim_plans}
        ctx = _JoinContext(node.spec, dims, device, f32=not stage._use_f64)
        prec = None
        batch0 = next((b for b in first.batches if b.num_rows > 0), None)
        if auto:
            wins = False
            if batch0 is not None:
                wins, prec = _join_device_wins(node, ctx, first, batch0, grouped, stage,
                                               topn, label, coal)
            _DECISION_CACHE.put(dk, wins)
            if not wins:
                fact.close()
                return host()
        else:
            if batch0 is not None and _price_forced(cfg):
                _w, prec = _join_device_wins(node, ctx, first, batch0, grouped, stage,
                                             topn, label, coal, forced=True)
            if prec is None:
                prec = _placement.ledger().record(label, "device", first.num_rows,
                                                  forced=True)
        d0 = counters.device_join_batches
        fed_rows = 0

        def counting():
            nonlocal fed_rows
            for part in fact_stream:
                fed_rows += part.num_rows
                yield part

        with _placement.feedback(prec) as fb, _residency().pin_scope():
            run = make_run(stage, grouped, ctx)
            try:
                feed(run, counting(), cfg)
            except DeviceFallback as exc:
                if getattr(exc, "second_fact_batch", False):
                    fb.cancel()  # no device work happened: nothing to observe
                raise
            fb.set_rows(fed_rows)
            out = assemble(run, stage, grouped)
        _note_region(node, region_ops, counters.device_join_batches - d0)
        return out
    except DeviceFallback as exc:
        fact.close()
        counters.bump("device_fallbacks")
        counters.reject(label, f"device fallback: {exc}")
        _note_fallback(exc)
        return host()


def _join_device_wins(node, ctx, first: MicroPartition, batch, grouped: bool, stage,
                      topn: bool, label: str, coalesce: float, forced: bool = False):
    """Cost-model decision for a device join node from its first fact
    morsel: (wins, placement record), both sides' CostBreakdowns in the
    record. The device side is the port's (``device_join_kernel_cost``):
    K4's probe of the fact rows whose index plane is not resident, one
    gather per dim plane, the grouped kernels or the ungrouped reduce, and
    the host work the port does per fact batch (its dim index and the host
    factorize of joined keys that are not dictionary-coded). One-time costs
    amortize over ``device_amortize_runs`` when every fact source is an
    in-memory table. ``forced`` prices a forced run for the ledger only."""
    import math

    from ..config import execution_config
    from ..device.residency import manager as _residency
    from ..ops import counters
    from ..ops.device_join import TOPN_MAX_SEGMENTS, DeviceJoinGroupedRun
    from ..ops.grouped_stage import _pad_groups, estimate_distinct
    from ..ops.stage import pad_bucket
    from ..plan.stats import selectivity

    cfg = execution_config()
    spec = node.spec
    cal = _costmodel.calibrate()
    device = ctx.device
    rows = first.num_rows
    bucket = pad_bucket(batch.num_rows)
    amort = max(cfg.device_amortize_runs, 1) if _resident_source_rec(node.fact) else 1
    # the host plan pushes the lifted conjuncts below the join, so its probe
    # and agg passes see only the filtered stream; the device sees every row
    host_rows = rows
    if spec.predicate is not None:
        host_rows = max(int(rows * min(selectivity(spec.predicate), 1.0)), 1)
    fact_cols = [c for c in stage._input_cols
                 if spec.col_side.get(c) == "fact" and c not in spec.fact_synthetic]
    dim_cols = [c for c in stage._input_cols if spec.col_side.get(c) not in ("fact", None)]
    nonres, res = _plane_bytes(batch, fact_cols, bucket, ctx.f32, device)
    probe_rows = 0
    adjacent = [d for d in spec.dims if d.parent[0] == "fact"]
    for d in adjacent:
        key = ("pdidx", d.key_col, d.parent, bucket, str(device))
        if not _residency().is_resident(batch.get_column(d.parent[1]), key):
            probe_rows += batch.num_rows
            nonres += batch.num_rows * 9  # the probe values and validity
    n_gathers = len(dim_cols) + len(spec.dims)  # value planes + visibility
    n_batches = sum(1 for b in first.batches if b.num_rows > 0)
    dim_rows = sum(ctx.batches[d.name].num_rows for d in spec.dims)
    if grouped:
        ceiling = TOPN_MAX_SEGMENTS if topn else DeviceJoinGroupedRun.max_segments
        sources = []
        for g in stage.groupby:
            name = (g.child if isinstance(g, Alias) else g)._name
            side = spec.col_side.get(name)
            sources.append(batch.get_column(name) if side == "fact"
                           else ctx._dim_source(side, name))
        # the run codes the keys on the device while the product of their
        # dictionary sizes fits its ceiling, else by a host factorize
        product = math.prod(estimate_distinct(s) for s in sources)
        card = max(min(product, batch.num_rows), 1)
        if card > ceiling and not forced:
            counters.reject(label, "est group count over ceiling")
            _placement.ledger().gate(label, "est group count over ceiling", rows)
            return False, None
        cap = _pad_groups(min(card, ceiling))
        k1, k7 = (len(r) for r in stage.sum_routes())
        # a float extreme takes two K3 launches (the value, its zero's sign)
        k3 = len(stage._ext_specs) - 1 + len(stage._float_ext) + len(stage._sct_specs)
        fact_keys = [s for s, g in zip(sources, stage.groupby)
                     if spec.col_side.get((g.child if isinstance(g, Alias) else g)._name)
                     == "fact"]
        if topn or product > DeviceJoinGroupedRun.max_segments:
            # the host factorize path: each batch's host dim index (a
            # uniqueness check over every dim's keys) and the factorize of
            # the joined key rows, cached on the fact Series
            fact_rows = n_batches * dim_rows + batch.num_rows
            nonres += bucket * 4  # the codes plane
        else:
            # dictionary codes: built once per new fact Series
            fact_rows = sum(batch.num_rows for s in fact_keys
                            if getattr(s, "_dict_codes", None) is None)
        if topn:
            k_total = node.topn.offset + node.topn.limit
            fetch = k_total * (k1 + k7 + 2 + k3) * 8
        else:
            fetch = cap * (k1 + k7 + 1 + k3) * 8
        dev = _costmodel.device_join_kernel_cost(
            cal, rows, nonres // amort, probe_rows // amort, n_gathers, k1=k1, k7=k7, k2=1,
            k3=k3, n_partials=0, cap_est=cap, fetch_bytes=fetch,
            factorize_rows=fact_rows // amort, coalesce=coalesce, resident_bytes=res)
        host = _costmodel.host_join_agg_cost(cal, host_rows, len(spec.dims), len(stage.aggs),
                                             True, False)
        if topn:
            # the device sorts the cap-length tables: a value and a validity
            # pass a key and the first-occurrence tie-break; the host sorts
            # the aggregate's rows
            dev.add("compute", cap * (2 * len(node.topn.keys) + 1) / cal.sort_rows_per_s)
            host.add("compute", card * max(math.log2(max(card, 2)), 1.0) / cal.host_agg_rate)
        detail = (f"{len(spec.dims)} dims, {len(stage.aggs)} aggs, ~{card} joined groups "
                  f"(cap {cap})")
    else:
        fetch = 256 * max(len(stage.aggs), 1)
        dev = _costmodel.device_join_kernel_cost(
            cal, rows, nonres // amort, probe_rows // amort, n_gathers, k1=0, k7=0, k2=0,
            k3=0, n_partials=max(len(stage.aggs), 1), cap_est=1, fetch_bytes=fetch,
            factorize_rows=0, coalesce=coalesce, resident_bytes=res)
        host = _costmodel.host_join_agg_cost(cal, host_rows, len(spec.dims), len(stage.aggs),
                                             False, False)
        detail = f"{len(spec.dims)} dims, {len(stage.aggs)} aggs"
    if spec.predicate is not None:
        host.add("compute", rows / cal.host_agg_rate)  # the filter pass
    wins = dev < host
    if not wins and not forced:
        counters.reject(label, "host wins cost model")
    rec = _placement.ledger().record(label, "device" if (wins or forced) else "host", rows,
                                     forced=forced, device=dev, host=host, detail=detail)
    return wins, rec


def _note_fallback(exc: BaseException) -> None:
    """A DeviceFallback, noted by the flight recorder (an anomaly: its ring
    is dumped, cooldown permitting) when the recorder is on."""
    from ..observability import flight

    frec = flight.recorder()
    if frec is not None:
        frec.note_fallback(f"{type(exc).__name__}: {exc}")


def _repartition(node: pp.PhysRepartition) -> Iterator[MicroPartition]:
    """n output partitions, in partition order; the rows of each keep their
    input order. ``random`` draws each input partition's ids from numpy's
    ``default_rng(partition index)``, as the reference."""
    n = node.num_partitions or 1
    if node.scheme == "into":
        batch = _concat_parts(list(_exec(node.input)), node.schema)
        rows = batch.num_rows
        start = 0
        for i in range(n):
            size = rows // n + (1 if i < rows % n else 0)
            yield MicroPartition(node.schema, [batch.slice(start, start + size)])
            start += size
        return
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
    from ..observability.runtime_stats import current_collector
    from ..ops import counters

    batches = [b for p in _exec(node.input) for b in p.batches if b.num_rows > 0]
    rows = sum(b.num_rows for b in batches)
    if rows < max(execution_config().device_min_rows, 1):
        counters.reject("repartition", "fewer rows than device_min_rows")
        return _host_repartition(node, [MicroPartition(node.schema, batches)], n)
    c = current_collector()
    if c is not None:
        c.annotate(node, f"mesh: {n} shard slots")
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


def _agg_morsels(batches, aggs):
    """The morsels of ``morsel_size_rows`` rows of ``batches`` (non-empty),
    or None when the input aggregates in one phase: at most a morsel of
    rows, or a count_distinct, which needs each group's whole value set."""
    from ..config import execution_config

    morsel = execution_config().morsel_size_rows
    if sum(b.num_rows for b in batches) <= morsel or \
            any(_agg_op(e) in _UNSPLIT_AGGS for e in aggs):
        return None
    return [m for b in batches for m in _morsels_of(b, morsel)]


def _morsels_of(b: RecordBatch, morsel: int) -> List[RecordBatch]:
    return [b.slice(s, s + morsel) for s in range(0, b.num_rows, morsel)]


def _batch_iter(stream) -> Iterator[RecordBatch]:
    """The non-empty batches of a stream of parts."""
    for part in stream:
        for b in part.batches:
            if b.num_rows > 0:
                yield b


def _admit_prefix(budget, it):
    """Buffer ``it``'s batches, each admitted against ``budget``, until the
    ledger goes over it: (the buffered batches, whether it went over). With
    no budget every batch is buffered and none is measured."""
    if budget.limit <= 0:
        return list(it), False
    batches: List[RecordBatch] = []
    for b in it:
        batches.append(b)
        if not budget.admit(b.size_bytes()):
            return batches, True
    return batches, False


def _drain_prefix(budget, batches: List[RecordBatch], it) -> Iterator[RecordBatch]:
    """The buffered over-budget prefix, then the rest of the stream. Each
    prefix batch's ledger bytes go back only after the consumer has
    processed it (spilled it, or folded it into a partial), and the list is
    consumed as it goes, so a released batch can really be dropped: an
    early release would let another operator admit while the prefix is
    still in memory."""
    while batches:
        b = batches.pop(0)
        yield b
        budget.release(b.size_bytes())
        del b
    yield from it


def _annotate_spill(node, nbytes: int, what: str) -> None:
    """EXPLAIN ANALYZE's note of one operator's spill ("memory: spilled
    12.5 MB, 8 runs"), while a stats collector is active."""
    from ..observability.runtime_stats import current_collector

    c = current_collector()
    if c is not None and node is not None:
        c.annotate(node, f"memory: spilled {nbytes / 1e6:.1f} MB, {what}")


def _two_phase_agg(stream, groupby, aggs, in_schema, node=None) -> RecordBatch:
    """Host grouped aggregation. Input up to ``morsel_size_rows`` rows
    aggregates in one phase; larger input aggregates each morsel into
    partials on the compute pool, then combines the partials (the
    reference's two-phase plan, executor.py:2240-2283).

    Under a host memory budget each batch is admitted against the ledger;
    over it, the aggregation Grace-partitions into K = 32 spill files by the
    group keys' row hash: the partials of each morsel when the aggregations
    split, the raw rows otherwise (a count_distinct), and each partition
    aggregates alone (its keys are in no other). The reference's
    ``_two_phase_agg`` (executor.py:2215-2357). Groups then come out by
    partition; each group's partials combine in the same order as in
    memory."""
    from .memory import operator_budget

    budget = operator_budget()
    try:
        it = _batch_iter(stream)
        batches, over = _admit_prefix(budget, it)
        if not over:
            return _grouped_in_memory(batches, groupby, aggs, in_schema)
        return _grace_agg(_drain_prefix(budget, batches, it), groupby, aggs, in_schema,
                          node)
    finally:
        budget.close()


def _grouped_in_memory(batches, groupby, aggs, in_schema) -> RecordBatch:
    from ..core.kernels.groupby import grouped_agg
    from ..utils.pool import pool_map

    morsels = _agg_morsels(batches, aggs)
    if morsels is None:
        big = RecordBatch.concat(batches) if batches else RecordBatch.empty(in_schema)
        return grouped_agg(big, groupby, aggs)
    partial, final, projection = _split_aggs(aggs)
    partials = pool_map(lambda m: grouped_agg(m, groupby, partial), morsels)
    keys = [col(e.name()) for e in groupby]
    combined = grouped_agg(RecordBatch.concat(partials), keys, final)
    return eval_projection(combined, keys + projection)


def _grace_agg(rest, groupby, aggs, in_schema, node=None) -> RecordBatch:
    from ..config import execution_config
    from ..core.kernels.groupby import grouped_agg
    from ..observability.runtime_stats import profile_span
    from .memory import SpillPartitions

    K = 32
    keys = [col(e.name()) for e in groupby]
    if any(_agg_op(e) in _UNSPLIT_AGGS for e in aggs):
        # unsplittable: Grace over the raw rows
        sp = SpillPartitions(in_schema, K)
        try:
            with profile_span("spill.grace_agg", "spill", partitions=K):
                for b in rest:
                    sp.append_partitioned(b, groupby)
            _annotate_spill(node, sp.bytes_written, f"{K} partitions")
            outs = [grouped_agg(RecordBatch.concat(bs), groupby, aggs)
                    for bs in (list(f.read()) for f in sp.files) if bs]
        finally:
            sp.delete()
    else:
        partial, final, projection = _split_aggs(aggs)
        partial_schema = Schema([e.to_field(in_schema) for e in list(groupby) + partial])
        morsel = execution_config().morsel_size_rows
        sp = SpillPartitions(partial_schema, K)
        try:
            with profile_span("spill.grace_agg", "spill", partitions=K):
                for b in rest:
                    for m in _morsels_of(b, morsel):
                        sp.append_partitioned(grouped_agg(m, groupby, partial), keys)
            _annotate_spill(node, sp.bytes_written, f"{K} partitions")
            outs = [eval_projection(grouped_agg(RecordBatch.concat(bs), keys, final),
                                    keys + projection)
                    for bs in (list(f.read()) for f in sp.files) if bs]
        finally:
            sp.delete()
    if not outs:
        return grouped_agg(RecordBatch.empty(in_schema), groupby, aggs)
    return RecordBatch.concat(outs)


def _ungrouped_agg(stream, aggs, in_schema, node=None) -> RecordBatch:
    """Host ungrouped aggregation into one row, in two phases as
    ``_two_phase_agg`` past a morsel of input. Over a host memory budget,
    the partials stream (one row a morsel) when the aggregations split;
    otherwise the raw rows spill once and each aggregation reads them back
    (``_ungrouped_agg_spilled``)."""
    from .memory import operator_budget

    budget = operator_budget()
    try:
        it = _batch_iter(stream)
        batches, over = _admit_prefix(budget, it)
        if not over:
            return _ungrouped_in_memory(batches, aggs, in_schema)
        rest = _drain_prefix(budget, batches, it)
        if any(_agg_op(e) in _UNSPLIT_AGGS for e in aggs):
            return _ungrouped_agg_spilled(rest, aggs, in_schema, node)
        from ..config import execution_config
        from ..core.kernels.groupby import ungrouped_agg

        partial, final, projection = _split_aggs(aggs)
        morsel = execution_config().morsel_size_rows
        partials = [ungrouped_agg(m, partial) for b in rest for m in _morsels_of(b, morsel)]
        return eval_projection(ungrouped_agg(RecordBatch.concat(partials), final), projection)
    finally:
        budget.close()


def _ungrouped_in_memory(batches, aggs, in_schema) -> RecordBatch:
    from ..core.kernels.groupby import ungrouped_agg
    from ..utils.pool import pool_map

    morsels = _agg_morsels(batches, aggs)
    if morsels is None:
        if not batches:
            return ungrouped_agg(RecordBatch.empty(in_schema), aggs)
        return ungrouped_agg(batches[0] if len(batches) == 1 else RecordBatch.concat(batches),
                             aggs)
    partial, final, projection = _split_aggs(aggs)
    partials = pool_map(lambda m: ungrouped_agg(m, partial), morsels)
    return eval_projection(ungrouped_agg(RecordBatch.concat(partials), final), projection)


def _ungrouped_agg_spilled(stream, aggs, in_schema, node=None) -> RecordBatch:
    """Over budget with a count_distinct: the raw rows spill once; a
    count_distinct Grace-partitions its own value column (a distinct value
    lands in one partition, so the partitions' counts add up), and every
    other aggregation streams its partials from the spill (the reference's
    ``_ungrouped_agg_spilled``, executor.py:2360-2431)."""
    from ..core.kernels.groupby import make_groups, ungrouped_agg
    from ..observability.runtime_stats import profile_span
    from .memory import SpillFile, SpillPartitions

    spill = SpillFile(in_schema)
    try:
        with profile_span("spill.raw", "spill"):
            for b in stream:
                spill.append(b)
        _annotate_spill(node, spill.bytes_written, "1 raw run")
        cols: List[Series] = []
        for e in aggs:
            inner = e
            while isinstance(inner, Alias):
                inner = inner.child
            name = e.name()
            out_field = e.to_field(in_schema)
            if inner.op == "count_distinct":
                val_field = inner.child.to_field(in_schema)
                vschema = Schema([val_field])
                sp = SpillPartitions(vschema, 32)
                try:
                    for b in spill.read():
                        v = _full_length(eval_expression(b, inner.child), b.num_rows)
                        sp.append_partitioned(RecordBatch(vschema, [v.rename(val_field.name)],
                                                          b.num_rows), [col(val_field.name)])
                    total = 0
                    for f in sp.files:
                        bs = list(f.read())
                        if bs:
                            v = RecordBatch.concat(bs).get_column(val_field.name)
                            first, _ids, _n = make_groups([v])
                            total += int(v.validity_numpy()[first].sum())
                finally:
                    sp.delete()
                cols.append(Series.from_pylist([total], name, dtype=out_field.dtype))
                continue
            if inner.op in _UNSPLIT_AGGS:  # set, string_agg: every value at once
                rows = list(spill.read())
                whole = RecordBatch.concat(rows) if rows else RecordBatch.empty(in_schema)
                cols.append(ungrouped_agg(whole, [e]).get_column(name))
                continue
            partial, final, projection = _split_aggs([e])
            partials = [ungrouped_agg(b, partial) for b in spill.read()]
            big = RecordBatch.concat(partials) if partials else \
                ungrouped_agg(RecordBatch.empty(in_schema), partial)
            cols.append(eval_projection(ungrouped_agg(big, final), projection).get_column(name))
        return RecordBatch(Schema([e.to_field(in_schema) for e in aggs]), cols, 1)
    finally:
        spill.delete()


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


# ---- the external sort ---------------------------------------------------------------

# the merge's fan-in: one k-way merge holds about one batch a run (and the
# rows it cannot emit yet), so the cap bounds its memory; wider run sets
# cascade through intermediate runs
_MERGE_FANIN = 16


def _sort_keys(batch: RecordBatch, node) -> List[Series]:
    return [_full_length(eval_expression(batch, e), batch.num_rows) for e in node.sort_by]


def _sort_exec(node: pp.PhysSort) -> Iterator[MicroPartition]:
    """A host sort (the reference's ``_sort_exec``, executor.py:2433-2508):
    the whole input sorted at once. Under a host memory budget each batch
    is admitted against the ledger; over it, the sort turns external: each
    buffer of about the budget's size sorts (stably) and spills as a sorted
    run of morsel-sized batches, and the runs stream out through a k-way
    merge (``_merge_sorted_runs``). The result is the in-memory sort's, tie
    order included: the runs cut the input in order, each sorts stably, and
    the merge breaks ties between runs by run index."""
    from .memory import operator_budget

    budget = operator_budget()
    try:
        it = _batch_iter(_exec(node.input))
        buffered, over = _admit_prefix(budget, it)
        if not over:
            batch = RecordBatch.concat(buffered) if buffered \
                else RecordBatch.empty(node.schema)
            yield MicroPartition(node.schema,
                                 [batch.sort(_sort_keys(batch, node), node.descending,
                                             node.nulls_first)])
            return
        yield from _external_sort(node, budget, buffered, it)
    finally:
        budget.close()


def _external_sort(node: pp.PhysSort, budget, buffered, it) -> Iterator[MicroPartition]:
    from ..config import execution_config
    from ..observability.runtime_stats import profile_span
    from .memory import SpillFile
    from ..ops import counters

    runs: List = []
    step = execution_config().morsel_size_rows

    def flush_run(bufs: List[RecordBatch]) -> None:
        big = RecordBatch.concat(bufs) if len(bufs) > 1 else bufs[0]
        srt = big.sort(_sort_keys(big, node), node.descending, node.nulls_first)
        f = SpillFile(node.schema)
        with profile_span("spill.sort_run", "spill", rows=srt.num_rows):
            for s in range(0, srt.num_rows, step):
                f.append(srt.slice(s, min(s + step, srt.num_rows)))
            # publish behind the queued writes: the next run buffers meanwhile
            f.finish_async()
        counters.bump("spill_runs")
        runs.append(f)
        budget.release_all()  # the buffer is on disk now

    try:
        flush_run(buffered)
        buffered = []
        for b in it:
            buffered.append(b)
            if not budget.admit(b.size_bytes()):
                flush_run(buffered)
                buffered = []
        if buffered:
            flush_run(buffered)
            buffered = []
        _annotate_spill(node, sum(f.bytes_written for f in runs), f"{len(runs)} runs")
        yield from _merge_sorted_runs(node, runs)
    finally:
        for f in runs:
            f.delete()


def _merge_sorted_runs(node: pp.PhysSort, runs) -> Iterator[MicroPartition]:
    """The sorted runs merged into one sorted stream, through intermediate
    runs (``spill_merge_passes``) while there are more than
    ``_MERGE_FANIN``."""
    from .memory import SpillFile
    from ..ops import counters

    live = [f for f in runs if f.rows > 0]
    intermediates: List = []
    try:
        while len(live) > _MERGE_FANIN:
            merged = []
            for i in range(0, len(live), _MERGE_FANIN):
                chunk = live[i:i + _MERGE_FANIN]
                if len(chunk) == 1:
                    merged.append(chunk[0])
                    continue
                f = SpillFile(node.schema)
                for part in _kway_merge(node, chunk):
                    for b in part.batches:
                        f.append(b)  # the merge emits morsel-sized batches already
                f.finish_async()
                counters.bump("spill_merge_passes")
                intermediates.append(f)
                merged.append(f)
                for g in chunk:
                    g.delete()
            live = merged
        yield from _kway_merge(node, live)
    finally:
        for f in intermediates:
            f.delete()


def _merge_ord_col(series: Series, descending: bool, nulls_first: bool):
    """(null_key, vals, flip): one sort column's ordering arrays, comparable
    across batches. null_key decides first (``core/kernels/sort.py``'s
    encoding); vals carries the value order: numbers, booleans and dates as
    ``_column_keys`` transforms them (NaN as +inf, descending by negation
    or bitwise-not), so row comparisons agree with the sort exactly;
    strings keep their values (the sort's codes are batch-local), and
    ``flip`` reverses their comparison when descending."""
    valid = series.validity_numpy()
    null_key = np.where(valid, np.int8(0), np.int8(-1 if nulls_first else 1))
    dt = series.dtype
    if dt.is_string() or dt.is_null():
        vals = np.where(valid, series.to_numpy(), "")
        return null_key, vals, descending
    vals = np.asarray(series.to_numpy())
    if vals.dtype.kind == "f":
        nan = np.isnan(vals)
        if nan.any():
            vals = np.where(nan, np.inf, vals)
    if vals.dtype.kind == "b":
        vals = vals.astype(np.int8)
    if descending:
        vals = np.bitwise_not(vals) if vals.dtype.kind in "iu" else -vals
    vals = np.where(valid, vals, vals.dtype.type(0))
    return null_key, vals, False


def _cmp_rows(a_cols, ai: int, b_cols, bi: int) -> int:
    """Row ai of one segment against row bi of another in the sort order
    (-1, 0, 1): null placement first, two nulls tie, values by
    ``_merge_ord_col``'s arrays, reversed where ``flip``."""
    for (a_nk, a_v, flip), (b_nk, b_v, _f) in zip(a_cols, b_cols):
        an, bn = a_nk[ai], b_nk[bi]
        if an != bn:
            return -1 if an < bn else 1
        if an:
            continue
        x, y = a_v[ai], b_v[bi]
        if x < y:
            return 1 if flip else -1
        if y < x:
            return -1 if flip else 1
    return 0


class _MergeSeg:
    """One sorted batch of a run inside ``_kway_merge``: its sort keys
    (evaluated once), their ordering arrays, and how far it is consumed."""

    __slots__ = ("run", "batch", "keys", "ords", "pos", "n")

    def __init__(self, run: int, batch: RecordBatch, keys, ords):
        self.run = run
        self.batch = batch
        self.keys = keys
        self.ords = ords
        self.pos = 0
        self.n = batch.num_rows


def _kway_merge(node: pp.PhysSort, files) -> Iterator[MicroPartition]:
    """The reference's streaming k-way merge (executor.py:2611-2770), one
    batch a run in flight plus the rows not yet emittable. Each round, every
    live run's newest batch offers its last row as the run's boundary; the
    horizon is the smallest boundary (the lower run index on a tie). A row
    is emittable when it sorts before the horizon, or ties with it from a
    run no later than the horizon's; each batch's emittable prefix is found
    by binary search, and only the emitted rows are sorted, by the sort
    keys and then the run index (``spill_merge_sort_rows``), so ties
    between runs keep stream order. Output goes in batches of
    ``morsel_size_rows``."""
    from ..config import execution_config
    from ..core.kernels.sort import multi_argsort
    from ..datatype import DataType
    from ..ops import counters

    if not files:
        return
    nkeys = len(node.sort_by)
    desc = list(node.descending) if node.descending else [False] * nkeys
    nf = list(node.nulls_first) if node.nulls_first else list(desc)
    if len(files) == 1:
        for b in files[0].read():
            yield MicroPartition(node.schema, [b])
        return

    step = execution_config().morsel_size_rows
    its = [f.read() for f in files]
    need = set(range(len(its)))
    segs: List[_MergeSeg] = []   # within a run, in stream order
    bounds: dict = {}            # run -> (its newest batch's ordering arrays, last row)
    outbuf: List[RecordBatch] = []
    out_rows = 0

    def sorted_pieces(pieces) -> Optional[RecordBatch]:
        if not pieces:
            return None
        bats = [s.batch.slice(a, b) for s, a, b in pieces]
        if len(bats) == 1:
            return bats[0]  # one source: already in order
        big = RecordBatch.concat(bats)
        key_cols = [Series.concat([s.keys[k].slice(a, b).rename("k") for s, a, b in pieces])
                    for k in range(nkeys)]
        run_ids = np.concatenate([np.full(b - a, s.run, dtype=np.int64)
                                  for s, a, b in pieces])
        key_cols.append(Series.from_numpy(run_ids, "__run__", DataType.int64()))
        idx = multi_argsort(key_cols, desc + [False], nf + [False])
        counters.bump("spill_merge_sort_rows", len(idx))
        return big.take(idx)

    def push(batch: RecordBatch) -> Iterator[MicroPartition]:
        nonlocal out_rows, outbuf
        outbuf.append(batch)
        out_rows += batch.num_rows
        if out_rows < step:
            return
        big = RecordBatch.concat(outbuf) if len(outbuf) > 1 else outbuf[0]
        full = (out_rows // step) * step
        for s in range(0, full, step):
            yield MicroPartition(node.schema, [big.slice(s, s + step)])
        rest = big.slice(full, out_rows)
        outbuf = [rest] if rest.num_rows else []
        out_rows = rest.num_rows

    try:
        while True:
            for i in sorted(need):
                b = next(its[i], None)
                while b is not None and b.num_rows == 0:
                    b = next(its[i], None)
                if b is None:
                    bounds.pop(i, None)  # the run is done: no boundary
                else:
                    keys = _sort_keys(b, node)
                    ords = [_merge_ord_col(k, d, n) for k, d, n in zip(keys, desc, nf)]
                    segs.append(_MergeSeg(i, b, keys, ords))
                    bounds[i] = (ords, b.num_rows - 1)
            need.clear()
            if not bounds:
                big = sorted_pieces([(s, s.pos, s.n) for s in segs if s.pos < s.n])
                if big is not None:
                    yield from push(big)
                if outbuf:
                    yield MicroPartition(node.schema, [RecordBatch.concat(outbuf)])
                return
            r = -1
            for i in sorted(bounds):
                if r < 0 or _cmp_rows(bounds[i][0], bounds[i][1],
                                      bounds[r][0], bounds[r][1]) < 0:
                    r = i
            b_ord, b_idx = bounds[r]
            pieces = []
            for s in segs:
                lo, hi = s.pos, s.n
                while lo < hi:
                    mid = (lo + hi) // 2
                    c = _cmp_rows(s.ords, mid, b_ord, b_idx)
                    if c < 0 or (c == 0 and s.run <= r):
                        lo = mid + 1
                    else:
                        hi = mid
                if lo > s.pos:
                    pieces.append((s, s.pos, lo))
                    s.pos = lo
            segs = [s for s in segs if s.pos < s.n]
            big = sorted_pieces(pieces)
            if big is not None:
                yield from push(big)
            # the horizon run's rows are all out: pull its next batch
            need.add(r)
            del bounds[r]
    finally:
        for it in its:
            it.close()


# ---- windows ---------------------------------------------------------------------------


def _window_exec(node) -> Iterator[MicroPartition]:
    """A window node (the reference's ``_window_exec``, executor.py:
    2773-2839): the input gathered and evaluated at once
    (execution/window.py ``eval_window``), rows in input order. Under a
    host memory budget each batch is admitted against the ledger; over it,
    a window with PARTITION BY Grace-partitions into K = 16 spill files by
    the partition keys' row hash (a window partition lies in one file), and
    each file evaluates alone, on the compute pool when the pipeline is on:
    rows then come out grouped by spill partition. A window with no
    PARTITION BY needs every row in one frame and gathers."""
    from .memory import operator_budget
    from .window import eval_window

    budget = operator_budget()
    try:
        it = _batch_iter(_exec(node.input))
        buffered, over = _admit_prefix(budget, it)
        if not over or not node.spec.partition_by_exprs:
            batches = buffered + (list(it) if over else [])
            batch = RecordBatch.concat(batches) if batches \
                else RecordBatch.empty(node.input.schema)
            yield MicroPartition(node.schema,
                                 [eval_window(batch, node.window_exprs, node.spec,
                                              node.schema)])
            return
        yield from _grace_window(node, budget, buffered, it)
    finally:
        budget.close()


def _grace_window(node, budget, buffered, it) -> Iterator[MicroPartition]:
    from ..observability.runtime_stats import profile_span
    from .memory import SpillPartitions
    from .window import eval_window

    K = 16
    sp = SpillPartitions(node.input.schema, K)
    try:
        with profile_span("spill.grace_window", "spill", partitions=K):
            for b in _drain_prefix(budget, buffered, it):
                sp.append_partitioned(b, node.spec.partition_by_exprs)
        _annotate_spill(node, sp.bytes_written, f"{K} partitions")

        def eval_file(f, _i):
            bs = list(f.read())
            if not bs:
                return MicroPartition(node.schema, [])
            return MicroPartition(node.schema, [eval_window(
                RecordBatch.concat(bs), node.window_exprs, node.spec, node.schema)])

        if _pipeline_on():
            from .pipeline import pmap_stream

            yield from pmap_stream(iter(sp.files), eval_file)
        else:
            for i, f in enumerate(sp.files):
                yield eval_file(f, i)
    finally:
        sp.delete()
