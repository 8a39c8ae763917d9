"""Logical plan nodes (counterpart of daft_tpu/plan/logical.py, the subset the
grouped-aggregation, join and repartition slices need): an in-memory source,
Filter, Project, Aggregate, Sort, Limit, Offset, TopN (a Sort with a Limit,
made by plan/optimizer.py ``rule_detect_topn``), the inner equi-Join and
Repartition. Each node computes its
output schema on construction, so a type error surfaces where the DataFrame
method is called.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..expressions.expressions import Expression
from ..datatype import Field
from ..schema import Schema


class LogicalPlan:
    def __init__(self, schema: Schema):
        self.schema = schema

    def children(self) -> List["LogicalPlan"]:
        return []


class InMemorySource(LogicalPlan):
    def __init__(self, schema: Schema, partitions: List[Any]):
        super().__init__(schema)
        self.partitions = list(partitions)


class Filter(LogicalPlan):
    def __init__(self, input: LogicalPlan, predicate: Expression):
        dt = predicate.to_field(input.schema).dtype
        if not (dt.is_boolean() or dt.is_null()):
            raise ValueError(f"filter predicate must be boolean, got {dt}")
        super().__init__(input.schema)
        self.input = input
        self.predicate = predicate

    def children(self):
        return [self.input]


class Project(LogicalPlan):
    def __init__(self, input: LogicalPlan, projection: List[Expression]):
        super().__init__(Schema([e.to_field(input.schema) for e in projection]))
        self.input = input
        self.projection = list(projection)

    def children(self):
        return [self.input]


class Aggregate(LogicalPlan):
    def __init__(self, input: LogicalPlan, groupby: List[Expression],
                 aggregations: List[Expression]):
        fields = [e.to_field(input.schema) for e in groupby]
        fields += [e.to_field(input.schema) for e in aggregations]
        super().__init__(Schema(fields))
        self.input = input
        self.groupby = list(groupby)
        self.aggregations = list(aggregations)

    def children(self):
        return [self.input]


class Sort(LogicalPlan):
    def __init__(self, input: LogicalPlan, sort_by: List[Expression],
                 descending: List[bool], nulls_first: Optional[List[bool]] = None):
        super().__init__(input.schema)
        self.input = input
        self.sort_by = list(sort_by)
        self.descending = list(descending)
        self.nulls_first = (list(nulls_first) if nulls_first is not None
                            else list(self.descending))

    def children(self):
        return [self.input]


class Limit(LogicalPlan):
    """The first ``limit`` rows."""

    def __init__(self, input: LogicalPlan, limit: int):
        if limit < 0:
            raise ValueError(f"limit must be >= 0, got {limit}")
        super().__init__(input.schema)
        self.input = input
        self.limit = limit

    def children(self):
        return [self.input]


class Offset(LogicalPlan):
    """Every row after the first ``offset``."""

    def __init__(self, input: LogicalPlan, offset: int):
        if offset < 0:
            raise ValueError(f"offset must be >= 0, got {offset}")
        super().__init__(input.schema)
        self.input = input
        self.offset = offset

    def children(self):
        return [self.input]


class TopN(LogicalPlan):
    """Sort, then rows [offset, offset + limit)."""

    def __init__(self, input: LogicalPlan, sort_by: List[Expression], descending: List[bool],
                 nulls_first: List[bool], limit: int, offset: int = 0):
        super().__init__(input.schema)
        self.input = input
        self.sort_by = list(sort_by)
        self.descending = list(descending)
        self.nulls_first = list(nulls_first)
        self.limit = limit
        self.offset = offset

    def children(self):
        return [self.input]


class Join(LogicalPlan):
    """Inner equi-join (counterpart of daft_tpu/plan/logical.py Join, inner
    joins only). Join keys of the same name merge into the left's column;
    other right columns whose names clash with the left are renamed
    ``right.<name>``."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_on: List[Expression], right_on: List[Expression]):
        if len(left_on) != len(right_on) or not left_on:
            raise ValueError("join needs the same number (>= 1) of left and right keys")
        self.left = left
        self.right = right
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        merged, rename = self.output_naming()
        fields = list(left.schema) + [
            Field(rename.get(f.name, f.name), f.dtype)
            for f in right.schema if f.name not in merged]
        super().__init__(Schema(fields))

    def output_naming(self):
        """(merged_keys, right_rename) as the reference names join outputs."""
        left_names = set(self.left.schema.column_names())
        merged = {ro.name() for lo, ro in zip(self.left_on, self.right_on)
                  if lo.name() == ro.name()}
        rename = {f.name: f"right.{f.name}" for f in self.right.schema
                  if f.name not in merged and f.name in left_names}
        return merged, rename

    def children(self):
        return [self.left, self.right]


class Repartition(LogicalPlan):
    """Hash or random repartition into ``num_partitions`` (counterpart of
    daft_tpu/plan/logical.py Repartition; the ``range`` and ``into`` schemes
    are not ported yet)."""

    def __init__(self, input: LogicalPlan, num_partitions: Optional[int], scheme: str,
                 by: Optional[List[Expression]] = None):
        if scheme not in ("hash", "random"):
            raise NotImplementedError(f"repartition scheme {scheme!r} is not ported yet")
        if scheme == "hash" and not by:
            raise ValueError("a hash repartition needs at least one key")
        super().__init__(input.schema)
        self.input = input
        self.num_partitions = num_partitions
        self.scheme = scheme
        self.by = list(by) if by else []

    def children(self):
        return [self.input]
