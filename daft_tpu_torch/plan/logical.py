"""Logical plan nodes (counterpart of daft_tpu/plan/logical.py, the subset the
port's slices need): an in-memory source, a scan over files (``ScanSource``,
whose pushdowns the optimizer's scan rules attach), a write (``Sink``),
Filter (with the pruning pass's ``keep``), Project, UDFProject (a
projection the optimizer's ``rule_split_udfs`` isolated around one UDF),
Aggregate, Sort, Limit, Offset, TopN (a Sort with a Limit, made by
plan/optimizer.py ``rule_detect_topn``), Join (inner, left,
semi, anti and cross), Distinct and Repartition. Each node computes its
output schema on construction, so a type error surfaces where the DataFrame
method is called.

The optimizer's rules rewrite the tree through ``with_children`` and
``transform_up``; ``describe`` and ``display`` print a node and a tree as
the reference prints them.
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

    def with_children(self, children: List["LogicalPlan"]) -> "LogicalPlan":
        """The same node over ``children``."""
        if children:
            raise ValueError(f"{type(self).__name__} takes no children")
        return self

    def name(self) -> str:
        return type(self).__name__

    def transform_up(self, fn) -> "LogicalPlan":
        """Bottom-up rewrite: ``fn(node)`` returns a replacement or None to
        keep the node."""
        old = self.children()
        new = [c.transform_up(fn) for c in old]
        node = self.with_children(new) if any(a is not b for a, b in zip(new, old)) \
            else self
        out = fn(node)
        return out if out is not None else node

    def describe(self) -> str:
        return self.name()

    def display(self) -> str:
        lines: List[str] = []

        def rec(node: "LogicalPlan", depth: int) -> None:
            lines.append("  " * depth + "* " + node.describe())
            for c in node.children():
                rec(c, depth + 1)

        rec(self, 0)
        return "\n".join(lines)

    def __repr__(self) -> str:
        return self.display()


class _Unary(LogicalPlan):
    def children(self):
        return [self.input]


class InMemorySource(LogicalPlan):
    def __init__(self, schema: Schema, partitions: List[Any]):
        super().__init__(schema)
        self.partitions = list(partitions)

    def describe(self) -> str:
        cols = ", ".join(f"{f.name}: {f.dtype}" for f in self.schema)
        return f"InMemorySource[{len(self.partitions)} partitions, {cols}]"


class ScanSource(LogicalPlan):
    """A scan over external storage through a ScanOperator (io/scan.py).
    The optimizer attaches pushdowns (columns, filters, limit); translation
    asks the operator for its ScanTasks."""

    def __init__(self, scan_op: Any, pushdowns: Optional[Any] = None):
        from ..io.scan import Pushdowns

        self.scan_op = scan_op
        self.pushdowns = pushdowns if pushdowns is not None else Pushdowns()
        base = scan_op.schema()
        super().__init__(base if self.pushdowns.columns is None
                         else Schema([base[c] for c in self.pushdowns.columns]))

    def describe(self) -> str:
        return f"ScanSource[{self.scan_op.name()}, pushdowns={self.pushdowns}]"


class Sink(_Unary):
    """A write of the input (io/writers.py ``WriteInfo``); the output is the
    written files' manifest (a ``path`` column)."""

    def __init__(self, input: LogicalPlan, info: Any):
        super().__init__(info.result_schema())
        self.input = input
        self.info = info

    def with_children(self, children):
        return Sink(children[0], self.info)

    def describe(self) -> str:
        return f"Sink[{self.info}]"


class Filter(_Unary):
    """Rows where ``predicate`` is true. ``keep`` (set by the optimizer's
    column pruning when the consumers need fewer columns than the predicate
    reads) narrows the output to those columns."""

    def __init__(self, input: LogicalPlan, predicate: Expression,
                 keep: Optional[List[str]] = None):
        dt = predicate.to_field(input.schema).dtype
        if not (dt.is_boolean() or dt.is_null()):
            raise ValueError(f"filter predicate must be boolean, got {dt}")
        super().__init__(input.schema if keep is None
                         else Schema([input.schema[c] for c in keep]))
        self.input = input
        self.predicate = predicate
        self.keep = list(keep) if keep is not None else None

    def with_children(self, children):
        return Filter(children[0], self.predicate, self.keep)

    def describe(self) -> str:
        return f"Filter[{self.predicate!r}]"


class Project(_Unary):
    def __init__(self, input: LogicalPlan, projection: List[Expression]):
        super().__init__(Schema([e.to_field(input.schema) for e in projection]))
        self.input = input
        self.projection = list(projection)

    def with_children(self, children):
        return Project(children[0], self.projection)

    def describe(self) -> str:
        return f"Project[{', '.join(e.name() for e in self.projection)}]"


class UDFProject(_Unary):
    """A projection isolated because it holds a UDF (the optimizer's
    ``rule_split_udfs``): the passthrough columns, then the one UDF
    expression."""

    def __init__(self, input: LogicalPlan, udf_expr: Expression,
                 passthrough: List[Expression]):
        fields = [e.to_field(input.schema) for e in passthrough]
        fields.append(udf_expr.to_field(input.schema))
        super().__init__(Schema(fields))
        self.input = input
        self.udf_expr = udf_expr
        self.passthrough = list(passthrough)

    def with_children(self, children):
        return UDFProject(children[0], self.udf_expr, self.passthrough)

    def describe(self) -> str:
        return f"UDFProject[{self.udf_expr.name()}]"


class Aggregate(_Unary):
    def __init__(self, input: LogicalPlan, groupby: List[Expression],
                 aggregations: List[Expression]):
        fields = [e.to_field(input.schema) for e in groupby]
        fields += [e.to_field(input.schema) for e in aggregations]
        super().__init__(Schema(fields))
        self.input = input
        self.groupby = list(groupby)
        self.aggregations = list(aggregations)

    def with_children(self, children):
        return Aggregate(children[0], self.groupby, self.aggregations)

    def describe(self) -> str:
        g = ", ".join(e.name() for e in self.groupby)
        a = ", ".join(e.name() for e in self.aggregations)
        return f"Aggregate[groupby=({g}) aggs=({a})]"


class Sort(_Unary):
    def __init__(self, input: LogicalPlan, sort_by: List[Expression],
                 descending: List[bool], nulls_first: Optional[List[bool]] = None):
        super().__init__(input.schema)
        self.input = input
        self.sort_by = list(sort_by)
        self.descending = list(descending)
        self.nulls_first = (list(nulls_first) if nulls_first is not None
                            else list(self.descending))

    def with_children(self, children):
        return Sort(children[0], self.sort_by, self.descending, self.nulls_first)

    def describe(self) -> str:
        keys = ", ".join(f"{e.name()} {'desc' if d else 'asc'}"
                         for e, d in zip(self.sort_by, self.descending))
        return f"Sort[{keys}]"


class Limit(_Unary):
    """The first ``limit`` rows."""

    def __init__(self, input: LogicalPlan, limit: int):
        if limit < 0:
            raise ValueError(f"limit must be >= 0, got {limit}")
        super().__init__(input.schema)
        self.input = input
        self.limit = limit

    def with_children(self, children):
        return Limit(children[0], self.limit)

    def describe(self) -> str:
        return f"Limit[{self.limit}]"


class Offset(_Unary):
    """Every row after the first ``offset``."""

    def __init__(self, input: LogicalPlan, offset: int):
        if offset < 0:
            raise ValueError(f"offset must be >= 0, got {offset}")
        super().__init__(input.schema)
        self.input = input
        self.offset = offset

    def with_children(self, children):
        return Offset(children[0], self.offset)


class TopN(_Unary):
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

    def with_children(self, children):
        return TopN(children[0], self.sort_by, self.descending, self.nulls_first,
                    self.limit, self.offset)

    def describe(self) -> str:
        return f"TopN[{self.limit}]"


class Join(LogicalPlan):
    """Equi-join or cross join (counterpart of daft_tpu/plan/logical.py
    Join, its ``inner``, ``left``, ``semi``, ``anti`` and ``cross`` types).
    Join keys of the same name merge into the left's column; other right
    columns whose names clash with the left are renamed
    ``<prefix><name><suffix>`` when either is given, else ``right.<name>``.
    A semi or anti join keeps the left's columns only; a cross join has no
    keys. ``strategy`` and ``null_equals_null`` are the reference's fields
    (the optimizer's join reorder leaves a join that sets them alone); the
    port's host join is a hash join and never matches null keys."""

    JOIN_TYPES = ("inner", "left", "semi", "anti", "cross")

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_on: List[Expression], right_on: List[Expression], how: str = "inner",
                 prefix: Optional[str] = None, suffix: Optional[str] = None,
                 strategy: Optional[str] = None, null_equals_null: bool = False):
        if how not in self.JOIN_TYPES:
            raise ValueError(f"unknown or unported join type {how!r}")
        if how == "cross":
            if left_on or right_on:
                raise ValueError("a cross join takes no keys")
        elif len(left_on) != len(right_on) or not left_on:
            raise ValueError("join needs the same number (>= 1) of left and right keys")
        if null_equals_null:
            raise NotImplementedError("a join matching null keys (the SQL set operations) "
                                      "is not ported yet")
        self.left = left
        self.right = right
        self.left_on = list(left_on)
        self.right_on = list(right_on)
        self.how = how
        self.prefix = prefix
        self.suffix = suffix
        self.strategy = strategy
        self.null_equals_null = null_equals_null
        if how in ("semi", "anti"):
            super().__init__(left.schema)
            return
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
        rename = {}
        for f in self.right.schema:
            if f.name in merged or f.name not in left_names:
                continue
            if self.prefix is not None or self.suffix is not None:
                rename[f.name] = f"{self.prefix or ''}{f.name}{self.suffix or ''}"
            else:
                rename[f.name] = f"right.{f.name}"
        return merged, rename

    def children(self):
        return [self.left, self.right]

    def with_children(self, children):
        return Join(children[0], children[1], self.left_on, self.right_on, self.how,
                    self.prefix, self.suffix, self.strategy, self.null_equals_null)

    def describe(self) -> str:
        keys = ", ".join(f"{l.name()}={r.name()}" for l, r in zip(self.left_on, self.right_on))
        return f"Join[{self.how} on ({keys}) strategy={self.strategy or 'auto'}]"


class Distinct(_Unary):
    """The first row of each distinct value of ``on`` (every column when
    None), in input order."""

    def __init__(self, input: LogicalPlan, on: Optional[List[Expression]] = None):
        super().__init__(input.schema)
        self.input = input
        self.on = list(on) if on else None

    def with_children(self, children):
        return Distinct(children[0], self.on)


class Repartition(_Unary):
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

    def with_children(self, children):
        return Repartition(children[0], self.num_partitions, self.scheme, self.by)

    def describe(self) -> str:
        return f"Repartition[{self.scheme} n={self.num_partitions}]"
