"""Logical plan nodes (counterpart of daft_tpu/plan/logical.py, the subset the
port's slices need): an in-memory source, a scan over files (``ScanSource``,
whose pushdowns the optimizer's scan rules attach), a write (``Sink``),
Filter (with the pruning pass's ``keep``), Project, UDFProject (a
projection the optimizer's ``rule_split_udfs`` isolated around one UDF),
Aggregate, Sort, Limit, Offset, TopN (a Sort with a Limit, made by
plan/optimizer.py ``rule_detect_topn``), Join (inner, left, right,
outer, semi, anti and cross), Concat, Distinct, Repartition, Window (window
functions over one window spec, the optimizer's ``rule_extract_windows``
moving them out of a projection), Explode, Unpivot, Sample, MonotonicallyIncreasingId,
MapGroups, Pivot, IntoPartitions and IntoBatches. Each node computes its
output schema on construction, so a type error surfaces where the DataFrame
method is called.

The optimizer's rules rewrite the tree through ``with_children`` and
``transform_up``; ``describe`` and ``display`` print a node and a tree as
the reference prints them.
"""

from __future__ import annotations

from typing import Any, List, Optional

from ..expressions.expressions import AggExpr, Expression, common_supertype
from ..datatype import DataType, Field
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


class Concat(LogicalPlan):
    """The rows of each input in turn (counterpart of
    daft_tpu/plan/logical.py Concat); every input has the first's column
    names, and the output its schema."""

    def __init__(self, inputs: List[LogicalPlan]):
        if not inputs:
            raise ValueError("concat of zero plans")
        s0 = inputs[0].schema
        for p in inputs[1:]:
            if p.schema.column_names() != s0.column_names():
                raise ValueError(f"concat requires matching schemas: {s0.column_names()} "
                                 f"vs {p.schema.column_names()}")
        super().__init__(s0)
        self.inputs = list(inputs)

    def children(self):
        return list(self.inputs)

    def with_children(self, children):
        return Concat(children)


class Join(LogicalPlan):
    """Equi-join or cross join (counterpart of daft_tpu/plan/logical.py
    Join, its ``inner``, ``left``, ``right``, ``outer``, ``semi``, ``anti``
    and ``cross`` types). Join keys of the same name merge into the left's
    column (an outer join's merged key takes the right's value where the
    left has no row, a right join's is the right's); other right columns
    whose names clash with the left are renamed ``<prefix><name><suffix>``
    when either is given, else ``right.<name>``. A semi or anti join keeps
    the left's columns only; a cross join has no keys.
    ``null_equals_null`` makes null keys match each other (the SQL set
    operations); ``strategy`` is the reference's field (the optimizer's
    join reorder leaves a join that sets either alone)."""

    JOIN_TYPES = ("inner", "left", "right", "outer", "semi", "anti", "cross")

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


class Window(_Unary):
    """Window functions over one window spec (counterpart of
    daft_tpu/plan/logical.py Window): the input's columns, then one column
    per window expression (``WindowExpr``, each named)."""

    def __init__(self, input: LogicalPlan, window_exprs: List[Expression], spec: Any):
        fields = list(input.schema) + [e.to_field(input.schema) for e in window_exprs]
        super().__init__(Schema(fields))
        self.input = input
        self.window_exprs = list(window_exprs)
        self.spec = spec

    def with_children(self, children):
        return Window(children[0], self.window_exprs, self.spec)

    def describe(self) -> str:
        return f"Window[{', '.join(e.name() for e in self.window_exprs)}]"


class Explode(_Unary):
    """One row per element of the exploded list columns, the other columns
    repeated (the reference's logical.py:229-252); an exploded column takes
    its element type."""

    def __init__(self, input: LogicalPlan, to_explode: List[Expression]):
        in_schema = input.schema
        exploded = {}
        for e in to_explode:
            f = e.to_field(in_schema)
            exploded[f.name] = Field(f.name, f.dtype.inner if f.dtype.is_list() else f.dtype)
        super().__init__(Schema([exploded.get(f.name, f) for f in in_schema]))
        self.input = input
        self.to_explode = list(to_explode)

    def with_children(self, children):
        return Explode(children[0], self.to_explode)

    def describe(self) -> str:
        return f"Explode[{', '.join(e.name() for e in self.to_explode)}]"


class Unpivot(_Unary):
    """Wide to long: the ``ids`` columns, then ``variable_name`` (the value
    column's name) and ``value_name`` (its value, in the values' common
    supertype), one row per input row and value column."""

    def __init__(self, input: LogicalPlan, ids: List[Expression], values: List[Expression],
                 variable_name: str, value_name: str):
        in_schema = input.schema
        fields = [e.to_field(in_schema) for e in ids]
        value_fields = [e.to_field(in_schema) for e in values]
        if not value_fields:
            raise ValueError("unpivot requires at least one value column")
        vt = value_fields[0].dtype
        for f in value_fields[1:]:
            if f.dtype != vt:
                # the reference's DataType.common_supertype: a string with
                # anything else is a string
                vt = DataType.string() if vt.is_string() or f.dtype.is_string() \
                    else common_supertype(vt, f.dtype)
        fields += [Field(variable_name, DataType.string()), Field(value_name, vt)]
        super().__init__(Schema(fields))
        self.input = input
        self.ids = list(ids)
        self.values = list(values)
        self.variable_name = variable_name
        self.value_name = value_name

    def with_children(self, children):
        return Unpivot(children[0], self.ids, self.values, self.variable_name,
                       self.value_name)


class Sample(_Unary):
    def __init__(self, input: LogicalPlan, fraction: float, with_replacement: bool,
                 seed: Optional[int]):
        super().__init__(input.schema)
        self.input = input
        self.fraction = fraction
        self.with_replacement = with_replacement
        self.seed = seed

    def with_children(self, children):
        return Sample(children[0], self.fraction, self.with_replacement, self.seed)


class MonotonicallyIncreasingId(_Unary):
    """A uint64 id column before the input's columns: the partition index
    in the top 28 bits, the row's position in its partition below."""

    def __init__(self, input: LogicalPlan, column_name: str = "id"):
        super().__init__(Schema([Field(column_name, DataType.uint64())]
                                + list(input.schema)))
        self.input = input
        self.column_name = column_name

    def with_children(self, children):
        return MonotonicallyIncreasingId(children[0], self.column_name)


class MapGroups(_Unary):
    """A UDF expression over each group's rows; the output is the group
    keys (one copy per row the UDF emits) and the UDF's column."""

    def __init__(self, input: LogicalPlan, groupby: List[Expression], udf_expr: Expression):
        in_schema = input.schema
        super().__init__(Schema([e.to_field(in_schema) for e in groupby]
                                + [udf_expr.to_field(in_schema)]))
        self.input = input
        self.groupby = list(groupby)
        self.udf_expr = udf_expr

    def with_children(self, children):
        return MapGroups(children[0], self.groupby, self.udf_expr)

    def describe(self) -> str:
        g = ", ".join(e.name() for e in self.groupby)
        return f"MapGroups[groupby=({g}) udf={self.udf_expr.name()}]"


class Pivot(_Unary):
    """Long to wide: the group keys, then one column per name in ``names``
    holding ``agg_op`` of the values whose pivot value reads as that name."""

    def __init__(self, input: LogicalPlan, groupby: List[Expression], pivot_col: Expression,
                 value_col: Expression, agg_op: str, names: List[str]):
        in_schema = input.schema
        value_dt = AggExpr(agg_op, value_col).to_field(in_schema).dtype
        super().__init__(Schema([e.to_field(in_schema) for e in groupby]
                                + [Field(n, value_dt) for n in names]))
        self.input = input
        self.groupby = list(groupby)
        self.pivot_col = pivot_col
        self.value_col = value_col
        self.agg_op = agg_op
        self.names = list(names)

    def with_children(self, children):
        return Pivot(children[0], self.groupby, self.pivot_col, self.value_col, self.agg_op,
                     self.names)


class IntoPartitions(_Unary):
    """The rows, in order, cut into ``num_partitions`` partitions of equal
    size (the first ones one row larger)."""

    def __init__(self, input: LogicalPlan, num_partitions: int):
        super().__init__(input.schema)
        self.input = input
        self.num_partitions = num_partitions

    def with_children(self, children):
        return IntoPartitions(children[0], self.num_partitions)


class IntoBatches(_Unary):
    """The stream re-cut into batches of ``batch_size`` rows (the last one
    shorter)."""

    def __init__(self, input: LogicalPlan, batch_size: int):
        super().__init__(input.schema)
        self.input = input
        self.batch_size = batch_size

    def with_children(self, children):
        return IntoBatches(children[0], self.batch_size)
