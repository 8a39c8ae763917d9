"""Physical plan and logical -> physical translation (counterpart of
daft_tpu/plan/physical.py, the subset the grouped-aggregation and join
slices need).

``translate`` lowers each logical node to the node the executor interprets
(a ScanSource to a ``StreamingScan`` over its operator's tasks, a Sink to a
``PhysWrite``). A UDFProject whose UDF is a device Func becomes a
``DeviceUdfProject`` unless device_mode is "off". The device decisions made
for an Aggregate are the reference's captures (physical.py:557-632), in its
order:

1. the star join: an Aggregate (grouped or not) over [Project]* <-
   [Filter]* <- an inner-join tree that ``try_capture_join_agg`` accepts
   becomes a ``DeviceJoinAgg``, which carries the untouched host
   translation of the same subtree;
2. the fused region (ops/region.py, under region_mode="on"): the chain of
   up to 8 Filters and Projects under the Aggregate is composed into one
   (predicate, keys, aggregations) over the chain's base; the candidates,
   most absorbed first down to the single Filter directly under the
   aggregate (the only candidate under region_mode="off"), are tried in
   turn, and the first that ``try_build_grouped_agg_stage`` (with group
   keys) or ``try_build_filter_agg_stage`` (without) accepts becomes a
   ``DeviceGroupedAgg`` or ``DeviceFilterAgg`` over the base.

Otherwise it stays a host ``HashAggregate`` over the translated input (with
no group keys, the ungrouped aggregation: one row).

``translate`` takes the optimized plan (plan/optimizer.py), whose
``rule_detect_topn`` has made each Limit over a Sort a TopN. A TopN over
[column Project]* <- a grouped star-join Aggregate that
``try_capture_join_topn`` accepts becomes a ``DeviceJoinTopN`` (the
reference's capture, physical.py:530-555, whose capture errors raise here
instead of being caught); any other TopN is a host ``PhysTopN``. A Filter
with the pruning pass's ``keep`` narrows its output to those columns. An
inner join whose left side is estimated under half the right's bytes
builds on the left (the reference's swap, physical.py:664-690) under a
Project that restores the column order. A Window becomes a host
``PhysWindow``.
"""

from __future__ import annotations

from typing import Any, List, Optional, Tuple

from ..expressions.expressions import Expression
from ..schema import Schema
from . import logical as lp


class PhysicalPlan:
    schema: Schema

    def children(self) -> List["PhysicalPlan"]:
        return []

    def name(self) -> str:
        """The operator's name in ``display()`` and EXPLAIN ANALYZE (the
        reference's, node for node)."""
        return type(self).__name__

    def display(self) -> str:
        lines: List[str] = []

        def rec(node, depth):
            lines.append("  " * depth + "* " + node.name())
            for c in node.children():
                rec(c, depth + 1)

        rec(self, 0)
        return "\n".join(lines)

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()


class _Unary(PhysicalPlan):
    def __init__(self, input: PhysicalPlan, schema: Schema):
        self.input = input
        self.schema = schema

    def children(self):
        return [self.input]


class InMemoryScan(PhysicalPlan):
    def __init__(self, partitions: List[Any], schema: Schema):
        self.partitions = partitions
        self.schema = schema


class StreamingScan(PhysicalPlan):
    """A scan's tasks read one after another (execution/executor.py
    ``_streaming_scan``); ``post_filter`` is applied to the morsels of tasks
    that did not apply the pushed predicate themselves, and ``post_limit``
    caps the rows."""

    def __init__(self, tasks: List[Any], schema: Schema, post_filter=None, post_limit=None):
        self.tasks = tasks
        self.schema = schema
        self.post_filter = post_filter
        self.post_limit = post_limit

    def name(self) -> str:
        return f"StreamingScan({len(self.tasks)} tasks)"


class PhysWrite(_Unary):
    """Write the input's stream through ``info`` (io/writers.py)."""

    def __init__(self, input: PhysicalPlan, info: Any, schema: Schema):
        super().__init__(input, schema)
        self.info = info


class Project(_Unary):
    def __init__(self, input: PhysicalPlan, projection: List[Expression], schema: Schema):
        super().__init__(input, schema)
        self.projection = projection


class UDFProject(_Unary):
    """The passthrough columns and one UDF column, evaluated on the host."""

    def __init__(self, input: PhysicalPlan, udf_expr: Expression,
                 passthrough: List[Expression], schema: Schema):
        super().__init__(input, schema)
        self.udf_expr = udf_expr
        self.passthrough = passthrough


class DeviceUdfProject(UDFProject):
    """A UDFProject whose UDF is a device Func (``on_device=True``): the
    device-UDF tier (ops/udf_stage.py) runs it with its weights resident,
    morsels coalesced and one copy back per run, or, feeding an ungrouped
    device aggregate, fused into that stage's dispatches
    (execution/executor.py ``_try_fused_udf_agg``)."""

    def name(self) -> str:
        return f"DeviceUdfProject({self.udf_expr.name()})"


def device_udf_call(expr: Expression):
    """The UdfCall at the root of ``expr`` (aliases unwrapped) when it is a
    device Func call with arguments and no keyword arguments, the shape the
    device tier runs; else None. Structural only: a plan of host UDFs
    imports nothing of the tier."""
    from ..expressions.expressions import Alias
    from ..udf.expr import UdfCall

    e = expr
    while isinstance(e, Alias):
        e = e.child
    if not isinstance(e, UdfCall) or not e.func.on_device or e.kwargs or not e.args:
        return None
    return e


class PhysFilter(_Unary):
    """Rows where ``predicate`` is true; ``keep`` (the pruning pass's)
    narrows the output to those columns."""

    def __init__(self, input: PhysicalPlan, predicate: Expression, schema: Schema,
                 keep: Optional[List[str]] = None):
        super().__init__(input, schema)
        self.predicate = predicate
        self.keep = keep


class PhysSort(_Unary):
    def __init__(self, input: PhysicalPlan, sort_by: List[Expression],
                 descending: List[bool], nulls_first: List[bool], schema: Schema):
        super().__init__(input, schema)
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first


class PhysLimit(_Unary):
    """Rows [offset, offset + limit) of the input's stream; limit -1: every
    row after the offset."""

    def __init__(self, input: PhysicalPlan, limit: int, offset: int, schema: Schema):
        super().__init__(input, schema)
        self.limit = limit
        self.offset = offset


class PhysTopN(_Unary):
    """A stable sort of the whole input, then rows [offset, offset + limit)."""

    def __init__(self, input: PhysicalPlan, sort_by: List[Expression],
                 descending: List[bool], nulls_first: List[bool], limit: int, offset: int,
                 schema: Schema):
        super().__init__(input, schema)
        self.sort_by = sort_by
        self.descending = descending
        self.nulls_first = nulls_first
        self.limit = limit
        self.offset = offset


class HashAggregate(_Unary):
    """Host aggregation: grouped by ``groupby``, or, with no keys, ungrouped
    into one row."""

    def __init__(self, input: PhysicalPlan, groupby: List[Expression],
                 aggregations: List[Expression], schema: Schema):
        super().__init__(input, schema)
        self.groupby = groupby
        self.aggregations = aggregations


class DeviceGroupedAgg(_Unary):
    """Filter (optional) + grouped aggregation as one device stage
    (ops/grouped_stage.py); the executor runs it on the device, or on the
    host under device_mode="off" or after a DeviceFallback. ``region_ops``
    names the fused operators, source first (ops/region.py)."""

    def __init__(self, input: PhysicalPlan, predicate: Optional[Expression],
                 groupby: List[Expression], aggregations: List[Expression],
                 schema: Schema, region_ops: Tuple[str, ...] = ()):
        super().__init__(input, schema)
        self.predicate = predicate
        self.groupby = groupby
        self.aggregations = aggregations
        self.region_ops = region_ops

    def name(self) -> str:
        if self.region_ops and len(self.region_ops) > 2:
            return f"DeviceGroupedAgg[{'+'.join(self.region_ops)}]"
        return "DeviceGroupedAgg"


class DeviceFilterAgg(_Unary):
    """Filter (optional) + ungrouped aggregation as one device stage
    (ops/stage.py ``FilterAggStage``); the executor runs it on the device,
    or on the host under device_mode="off". ``region_ops`` as above."""

    def __init__(self, input: PhysicalPlan, predicate: Optional[Expression],
                 aggregations: List[Expression], schema: Schema,
                 region_ops: Tuple[str, ...] = ()):
        super().__init__(input, schema)
        self.predicate = predicate
        self.aggregations = aggregations
        self.region_ops = region_ops

    def name(self) -> str:
        if self.region_ops and len(self.region_ops) > 2:
            return f"DeviceFilterAgg[{'+'.join(self.region_ops)}]"
        return "DeviceFilterAgg"


class PhysConcat(PhysicalPlan):
    """The rows of each input in turn, passed through as its stream gives
    them (each input keeps its own plan, placement and residency)."""

    def __init__(self, inputs: List[PhysicalPlan], schema: Schema):
        self.inputs = inputs
        self.schema = schema

    def children(self):
        return list(self.inputs)


class HashJoin(PhysicalPlan):
    """Host equi-join, inner, left, right, outer, semi or anti
    (core/kernels/join.py); the right side is materialized, the left streams
    (a right or outer join, or one matching null keys, materializes both)."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan, left_on, right_on,
                 merged_keys, right_rename, schema: Schema, how: str = "inner",
                 null_equals_null: bool = False):
        self.left = left
        self.right = right
        self.left_on = left_on
        self.right_on = right_on
        self.merged_keys = merged_keys
        self.right_rename = right_rename
        self.schema = schema
        self.how = how
        self.null_equals_null = null_equals_null

    def children(self):
        return [self.left, self.right]


class CrossJoin(PhysicalPlan):
    """Host cross join: every left row with every row of the materialized
    right side, left-major."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan, right_rename,
                 schema: Schema):
        self.left = left
        self.right = right
        self.right_rename = right_rename
        self.schema = schema

    def children(self):
        return [self.left, self.right]


class Dedup(_Unary):
    """Host distinct: the first row of each distinct ``on`` value (every
    column when None), in input order."""

    def __init__(self, input: PhysicalPlan, on, schema: Schema):
        super().__init__(input, schema)
        self.on = on


class PhysRepartition(_Unary):
    """Hash, random or "into" (equal slices, in order: ``IntoPartitions``)
    repartition (execution/executor.py ``_repartition``); a hash
    repartition into ``mesh_devices`` partitions may run as the mesh
    exchange on the device."""

    def __init__(self, input: PhysicalPlan, num_partitions, scheme, by, schema: Schema):
        super().__init__(input, schema)
        self.num_partitions = num_partitions
        self.scheme = scheme
        self.by = by


class PhysExplode(_Unary):
    """The explode operator (the reference's physical.py:155): one output
    batch per input batch (core/relational.py ``explode``)."""

    def __init__(self, input: PhysicalPlan, to_explode, schema: Schema):
        super().__init__(input, schema)
        self.to_explode = to_explode


class PhysUnpivot(_Unary):
    def __init__(self, input: PhysicalPlan, ids, values, variable_name, value_name,
                 schema: Schema):
        super().__init__(input, schema)
        self.ids = ids
        self.values = values
        self.variable_name = variable_name
        self.value_name = value_name


class PhysSample(_Unary):
    def __init__(self, input: PhysicalPlan, fraction, with_replacement, seed, schema: Schema):
        super().__init__(input, schema)
        self.fraction = fraction
        self.with_replacement = with_replacement
        self.seed = seed


class PhysMonotonicId(_Unary):
    def __init__(self, input: PhysicalPlan, column_name: str, schema: Schema):
        super().__init__(input, schema)
        self.column_name = column_name


class PhysMapGroups(_Unary):
    def __init__(self, input: PhysicalPlan, groupby, udf_expr, schema: Schema):
        super().__init__(input, schema)
        self.groupby = groupby
        self.udf_expr = udf_expr


class PhysPivot(_Unary):
    def __init__(self, input: PhysicalPlan, groupby, pivot_col, value_col, agg_op, names,
                 schema: Schema):
        super().__init__(input, schema)
        self.groupby = groupby
        self.pivot_col = pivot_col
        self.value_col = value_col
        self.agg_op = agg_op
        self.names = names


class PhysIntoBatches(_Unary):
    def __init__(self, input: PhysicalPlan, batch_size: int, schema: Schema):
        super().__init__(input, schema)
        self.batch_size = batch_size


class PhysWindow(_Unary):
    """Window functions over one spec on the host (execution/executor.py
    ``_window_exec``, execution/window.py ``eval_window``)."""

    def __init__(self, input: PhysicalPlan, window_exprs, spec, schema: Schema):
        super().__init__(input, schema)
        self.window_exprs = window_exprs
        self.spec = spec


class ShuffleWrite(_Unary):
    """The root of a distributed map task: hash-partition the input stream
    on ``by`` and write each partition's rows to the shuffle directory
    (distributed/shuffle.py); yields nothing."""

    def __init__(self, input: PhysicalPlan, shuffle_id: str, map_id: int,
                 num_partitions: int, by: List[Expression], shuffle_dir: str,
                 schema: Schema):
        super().__init__(input, schema)
        self.shuffle_id = shuffle_id
        self.map_id = map_id
        self.num_partitions = num_partitions
        self.by = by
        self.shuffle_dir = shuffle_dir


class ShuffleRead(PhysicalPlan):
    """The leaf of a distributed reduce task: every map's file of one
    shuffle partition, from the shuffle directory or, with
    ``fetch_endpoints``, over the fetch servers' sockets. ``expected_maps``
    names the map ids that wrote rows for this partition: a missing one
    raises ShuffleDataLost."""

    def __init__(self, shuffle_id: str, partition_idx: int, shuffle_dir: str,
                 schema: Schema, fetch_endpoints=None, expected_maps=None):
        self.shuffle_id = shuffle_id
        self.partition_idx = partition_idx
        self.shuffle_dir = shuffle_dir
        self.schema = schema
        self.fetch_endpoints = fetch_endpoints  # [(host, port, authkey_hex)]
        self.expected_maps = tuple(expected_maps) if expected_maps else None


class DeviceJoinAgg(PhysicalPlan):
    """Star join + aggregate fused for the device (ops/device_join.py): the
    fact streams, each dim materializes once per run and joins as a device
    gather through its index plane, and the aggregation runs on the grouped
    stage's kernels (with group keys) or the ungrouped stage (without). ``host_plan`` is the
    host translation of the same subtree: the executor runs it under
    device_mode="off" and after a DeviceFallback."""

    def __init__(self, fact: PhysicalPlan, dim_plans, spec, host_plan: PhysicalPlan,
                 schema: Schema):
        self.fact = fact
        self.dim_plans = dim_plans  # [(dim name, PhysicalPlan)], parents first
        self.spec = spec            # ops.device_join.JoinAggSpec
        self.host_plan = host_plan
        self.schema = schema

    def children(self):
        return [self.fact] + [p for _n, p in self.dim_plans]

    def name(self) -> str:
        return f"DeviceJoinAgg({len(self.dim_plans)} dims)"


class DeviceJoinTopN(PhysicalPlan):
    """Star join + grouped aggregate + ORDER BY + LIMIT fused for the device
    (ops/device_join.py ``DeviceJoinTopNRun``): the group tables stay on the
    device, a device sort picks the K winners and only their rows come
    back. ``host_plan`` is the host translation of the same TopN subtree."""

    def __init__(self, fact: PhysicalPlan, dim_plans, spec, topn, out_map,
                 host_plan: PhysicalPlan, schema: Schema):
        self.fact = fact
        self.dim_plans = dim_plans
        self.spec = spec            # ops.device_join.JoinAggSpec
        self.topn = topn            # ops.device_join.TopNSpec
        self.out_map = out_map      # [("agg" | "group", index)] per output column
        self.host_plan = host_plan
        self.schema = schema

    def children(self):
        return [self.fact] + [p for _n, p in self.dim_plans]

    def name(self) -> str:
        return f"DeviceJoinTopN({len(self.dim_plans)} dims, k={self.topn.limit})"


def translate(plan: lp.LogicalPlan) -> PhysicalPlan:
    """The physical plan of an optimized ``plan`` under the current
    execution config."""
    from ..config import execution_config

    cfg = execution_config()
    if isinstance(plan, lp.InMemorySource):
        return InMemoryScan(plan.partitions, plan.schema)
    if isinstance(plan, lp.ScanSource):
        return _translate_scan(plan, cfg)
    if isinstance(plan, lp.Sink):
        return PhysWrite(translate(plan.input), plan.info, plan.schema)
    if isinstance(plan, lp.Project):
        return Project(translate(plan.input), plan.projection, plan.schema)
    if isinstance(plan, lp.UDFProject):
        node = DeviceUdfProject if cfg.device_mode != "off" \
            and device_udf_call(plan.udf_expr) is not None else UDFProject
        return node(translate(plan.input), plan.udf_expr, plan.passthrough, plan.schema)
    if isinstance(plan, lp.Filter):
        return PhysFilter(translate(plan.input), plan.predicate, plan.schema, plan.keep)
    if isinstance(plan, lp.Sort):
        return PhysSort(translate(plan.input), plan.sort_by, plan.descending,
                        plan.nulls_first, plan.schema)
    if isinstance(plan, lp.Limit):
        return PhysLimit(translate(plan.input), plan.limit, 0, plan.schema)
    if isinstance(plan, lp.Offset):
        return PhysLimit(translate(plan.input), -1, plan.offset, plan.schema)
    if isinstance(plan, lp.TopN):
        host_input = translate(plan.input)
        host = PhysTopN(host_input, plan.sort_by, plan.descending, plan.nulls_first,
                        plan.limit, plan.offset, plan.schema)
        if cfg.device_mode != "off":
            from ..ops.device_join import try_capture_join_topn

            captured = try_capture_join_topn(plan)
            if captured is not None:
                jspec, topn, out_map = captured
                return DeviceJoinTopN(translate(jspec.fact),
                                      [(d.name, translate(d.base)) for d in jspec.dims],
                                      jspec, topn, out_map, host, plan.schema)
        return host
    if isinstance(plan, lp.Repartition):
        return PhysRepartition(translate(plan.input), plan.num_partitions, plan.scheme,
                               plan.by, plan.schema)
    if isinstance(plan, lp.IntoPartitions):
        return PhysRepartition(translate(plan.input), plan.num_partitions, "into", None,
                               plan.schema)
    if isinstance(plan, lp.IntoBatches):
        return PhysIntoBatches(translate(plan.input), plan.batch_size, plan.schema)
    if isinstance(plan, lp.Explode):
        return PhysExplode(translate(plan.input), plan.to_explode, plan.schema)
    if isinstance(plan, lp.Unpivot):
        return PhysUnpivot(translate(plan.input), plan.ids, plan.values, plan.variable_name,
                           plan.value_name, plan.schema)
    if isinstance(plan, lp.Sample):
        return PhysSample(translate(plan.input), plan.fraction, plan.with_replacement,
                          plan.seed, plan.schema)
    if isinstance(plan, lp.MonotonicallyIncreasingId):
        return PhysMonotonicId(translate(plan.input), plan.column_name, plan.schema)
    if isinstance(plan, lp.MapGroups):
        return PhysMapGroups(translate(plan.input), plan.groupby, plan.udf_expr, plan.schema)
    if isinstance(plan, lp.Pivot):
        return PhysPivot(translate(plan.input), plan.groupby, plan.pivot_col, plan.value_col,
                         plan.agg_op, plan.names, plan.schema)
    if isinstance(plan, lp.Join):
        merged, rename = plan.output_naming()
        if plan.how == "cross":
            return CrossJoin(translate(plan.left), translate(plan.right), rename,
                             plan.schema)
        swapped = _build_on_left(plan)
        if swapped is not None:
            return swapped
        return HashJoin(translate(plan.left), translate(plan.right), plan.left_on,
                        plan.right_on, merged, rename, plan.schema, plan.how,
                        plan.null_equals_null)
    if isinstance(plan, lp.Concat):
        return PhysConcat([translate(c) for c in plan.inputs], plan.schema)
    if isinstance(plan, lp.Distinct):
        return Dedup(translate(plan.input), plan.on, plan.schema)
    if isinstance(plan, lp.Window):
        return PhysWindow(translate(plan.input), plan.window_exprs, plan.spec, plan.schema)
    if isinstance(plan, lp.Aggregate):
        if cfg.device_mode != "off":
            from ..ops.device_join import try_capture_join_agg
            from ..ops.grouped_stage import try_build_grouped_agg_stage
            from ..ops.stage import try_build_filter_agg_stage

            spec = try_capture_join_agg(plan)
            if spec is not None:
                host = HashAggregate(translate(plan.input), plan.groupby,
                                     plan.aggregations, plan.schema)
                return DeviceJoinAgg(translate(spec.fact),
                                     [(d.name, translate(d.base)) for d in spec.dims],
                                     spec, host, plan.schema)

            # the fused-region capture: the Filter/Project chain under the
            # aggregate composed over the chain's base, candidates most
            # absorbed first; the last is the single-Filter peel, so nothing
            # that planned on the card without regions stops doing so
            from ..ops.region import agg_region_candidates, single_filter_peel

            cands = agg_region_candidates(plan) if cfg.region_mode == "on" \
                else [single_filter_peel(plan)]
            for cand in cands:
                if not plan.groupby:
                    if try_build_filter_agg_stage(cand.source.schema, cand.predicate,
                                                  cand.aggregations) is not None:
                        return DeviceFilterAgg(translate(cand.source), cand.predicate,
                                               cand.aggregations, plan.schema, cand.ops)
                elif try_build_grouped_agg_stage(cand.source.schema, cand.predicate,
                                                 cand.groupby,
                                                 cand.aggregations) is not None:
                    return DeviceGroupedAgg(translate(cand.source), cand.predicate,
                                            cand.groupby, cand.aggregations, plan.schema,
                                            cand.ops)
        return HashAggregate(translate(plan.input), plan.groupby,
                             plan.aggregations, plan.schema)
    raise NotImplementedError(f"no physical translation for {type(plan).__name__}")


def _translate_scan(plan: lp.ScanSource, cfg) -> "StreamingScan":
    """The reference's scan translation (physical.py:466-484): the
    operator's tasks, small ones merged toward ``scan_split_bytes``; the
    pushed predicate is applied after the scan unless every task applied it,
    and the pushed limit always caps the rows."""
    from ..io.scan import merge_small_tasks

    tasks = plan.scan_op.to_scan_tasks(plan.pushdowns)
    if cfg.scan_split_bytes and len(tasks) > 1:
        tasks = merge_small_tasks(tasks, cfg.scan_split_bytes)
    post_filter = None
    if plan.pushdowns.filters is not None and not all(t.filters_applied for t in tasks):
        post_filter = plan.pushdowns.filters
    return StreamingScan(tasks, plan.schema, post_filter, plan.pushdowns.limit)


def _build_on_left(plan: lp.Join) -> Optional[PhysicalPlan]:
    """The reference's build-side swap: the host join materializes its right
    side, so an inner join whose left is estimated under half the right's
    bytes joins the other way round, under a Project that restores the
    column order; None when the estimates do not say so or the swap would
    rename a column."""
    from ..expressions.expressions import col
    from .stats import estimate_bytes

    if plan.how != "inner" or plan.strategy is not None or plan.null_equals_null \
            or plan.output_naming()[1]:
        return None
    lb, rb = estimate_bytes(plan.left), estimate_bytes(plan.right)
    if lb is None or rb is None or not lb < rb / 2:
        return None
    swapped = lp.Join(plan.right, plan.left, plan.right_on, plan.left_on, "inner")
    s_merged, s_rename = swapped.output_naming()
    if s_rename or set(swapped.schema.column_names()) != set(plan.schema.column_names()):
        return None
    hj = HashJoin(translate(plan.right), translate(plan.left), plan.right_on, plan.left_on,
                  s_merged, s_rename, swapped.schema)
    return Project(hj, [col(f.name) for f in plan.schema], plan.schema)
