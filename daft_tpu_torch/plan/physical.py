"""Physical plan and logical -> physical translation (counterpart of
daft_tpu/plan/physical.py, the subset the grouped-aggregation and join
slices need).

``translate`` lowers each logical node to the node the executor interprets.
The device decisions made here are the reference's Aggregate captures
(physical.py:557-632), in its order:

1. the star join: an Aggregate (grouped or not) over [Project]* <-
   [Filter]* <- an inner-join tree that ``try_capture_join_agg`` accepts
   becomes a ``DeviceJoinAgg``, which carries the untouched host
   translation of the same subtree;
2. the single-Filter peel: an Aggregate optionally over one Filter becomes
   a ``DeviceGroupedAgg`` (with group keys) when ``try_build_grouped_agg_stage``
   accepts the (predicate, keys, aggregations), or a ``DeviceFilterAgg``
   (without) when ``try_build_filter_agg_stage`` accepts the (predicate,
   aggregations).

Otherwise it stays a host ``HashAggregate`` over the translated input (with
no group keys, the ungrouped aggregation: one row).

A Limit over a Sort (or over an Offset over a Sort) becomes a TopN
(plan/optimizer.py ``rule_detect_topn``). A TopN over [column Project]* <-
a grouped star-join Aggregate that ``try_capture_join_topn`` accepts becomes
a ``DeviceJoinTopN`` (the reference's capture, physical.py:530-555, whose
capture errors raise here instead of being caught); any other TopN is a
host ``PhysTopN``. The fused-region capture is not ported yet.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..expressions.expressions import Expression
from ..schema import Schema
from . import logical as lp


class PhysicalPlan:
    schema: Schema

    def children(self) -> List["PhysicalPlan"]:
        return []

    def name(self) -> str:
        return type(self).__name__

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


class Project(_Unary):
    def __init__(self, input: PhysicalPlan, projection: List[Expression], schema: Schema):
        super().__init__(input, schema)
        self.projection = projection


class PhysFilter(_Unary):
    def __init__(self, input: PhysicalPlan, predicate: Expression, schema: Schema):
        super().__init__(input, schema)
        self.predicate = predicate


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
    host under device_mode="off" or after a DeviceFallback."""

    def __init__(self, input: PhysicalPlan, predicate: Optional[Expression],
                 groupby: List[Expression], aggregations: List[Expression],
                 schema: Schema):
        super().__init__(input, schema)
        self.predicate = predicate
        self.groupby = groupby
        self.aggregations = aggregations


class DeviceFilterAgg(_Unary):
    """Filter (optional) + ungrouped aggregation as one device stage
    (ops/stage.py ``FilterAggStage``); the executor runs it on the device,
    or on the host under device_mode="off"."""

    def __init__(self, input: PhysicalPlan, predicate: Optional[Expression],
                 aggregations: List[Expression], schema: Schema):
        super().__init__(input, schema)
        self.predicate = predicate
        self.aggregations = aggregations


class HashJoin(PhysicalPlan):
    """Host inner equi-join (core/kernels/join.py); the right side is
    materialized, the left streams."""

    def __init__(self, left: PhysicalPlan, right: PhysicalPlan, left_on, right_on,
                 merged_keys, right_rename, schema: Schema):
        self.left = left
        self.right = right
        self.left_on = left_on
        self.right_on = right_on
        self.merged_keys = merged_keys
        self.right_rename = right_rename
        self.schema = schema

    def children(self):
        return [self.left, self.right]


class PhysRepartition(_Unary):
    """Hash or random repartition (execution/executor.py ``_repartition``);
    a hash repartition into ``mesh_devices`` partitions may run as the mesh
    exchange on the device."""

    def __init__(self, input: PhysicalPlan, num_partitions, scheme, by, schema: Schema):
        super().__init__(input, schema)
        self.num_partitions = num_partitions
        self.scheme = scheme
        self.by = by


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


def translate(plan: lp.LogicalPlan) -> PhysicalPlan:
    """The physical plan of ``plan`` under the current execution config."""
    from ..config import execution_config

    cfg = execution_config()
    if isinstance(plan, lp.InMemorySource):
        return InMemoryScan(plan.partitions, plan.schema)
    if isinstance(plan, lp.Project):
        return Project(translate(plan.input), plan.projection, plan.schema)
    if isinstance(plan, lp.Filter):
        return PhysFilter(translate(plan.input), plan.predicate, plan.schema)
    if isinstance(plan, lp.Sort):
        return PhysSort(translate(plan.input), plan.sort_by, plan.descending,
                        plan.nulls_first, plan.schema)
    if isinstance(plan, lp.Limit):
        from .optimizer import rule_detect_topn

        topn = rule_detect_topn(plan)
        if topn is not None:
            return translate(topn)
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
    if isinstance(plan, lp.Join):
        merged, rename = plan.output_naming()
        return HashJoin(translate(plan.left), translate(plan.right), plan.left_on,
                        plan.right_on, merged, rename, plan.schema)
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

            # the reference's single-Filter peel
            src, predicate = plan.input, None
            if isinstance(src, lp.Filter):
                src, predicate = src.input, src.predicate
            if not plan.groupby:
                if try_build_filter_agg_stage(src.schema, predicate,
                                              plan.aggregations) is not None:
                    return DeviceFilterAgg(translate(src), predicate, plan.aggregations,
                                           plan.schema)
            elif try_build_grouped_agg_stage(src.schema, predicate, plan.groupby,
                                             plan.aggregations) is not None:
                return DeviceGroupedAgg(translate(src), predicate, plan.groupby,
                                        plan.aggregations, plan.schema)
        return HashAggregate(translate(plan.input), plan.groupby,
                             plan.aggregations, plan.schema)
    raise NotImplementedError(f"no physical translation for {type(plan).__name__}")
