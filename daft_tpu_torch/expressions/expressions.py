"""Expression IR (counterpart of daft_tpu/expressions/expressions.py, the
subset the grouped-aggregation and join slices need): ``col``, ``lit``
(with ``datetime.date``), ``Alias``, ``Cast``, arithmetic, comparisons,
``&``, ``|``, ``~``, null tests, ``IfElse``, ``IsIn``, ``AggExpr`` with
sum, count, mean, min, max and count_distinct, ``Between``, and the
``Function`` calls ``.str.startswith``, ``.str.endswith``, ``.str.contains``,
``.str.left``, ``.str.like``, ``.str.substr`` and ``.dt.year``, and UDF
calls (udf/expr.py ``UdfCall``, ``Expression.apply``). ``transform``
rewrites a tree bottom-up (the
join capture substitutes projections and hoists dim-only subexpressions
with it).

One class hierarchy is both the user-facing Expression and the plan IR. Host
evaluation lives in expressions/eval.py, device (torch) evaluation in
ops/device_eval.py; both dispatch over these node types.
"""

from __future__ import annotations

import datetime
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..datatype import DataType, Field
from ..schema import Schema


class Expression:
    """Base class; subclasses are the IR nodes."""

    def name(self) -> str:
        raise NotImplementedError(type(self).__name__)

    def alias(self, name: str) -> "Expression":
        return Alias(self, name)

    def cast(self, dtype: DataType) -> "Expression":
        return Cast(self, dtype)

    # ---- structure ----------------------------------------------------------------
    def children(self) -> List["Expression"]:
        return []

    def with_children(self, children: List["Expression"]) -> "Expression":
        if children:
            raise ValueError(f"{type(self).__name__} takes no children")
        return self

    def transform(self, fn: Callable[["Expression"], Optional["Expression"]]) -> "Expression":
        """Bottom-up rewrite: ``fn`` returns a replacement or None to keep."""
        old = self.children()
        new = [c.transform(fn) for c in old]
        node = self.with_children(new) if any(a is not b for a, b in zip(new, old)) \
            else self
        out = fn(node)
        return out if out is not None else node

    def walk(self):
        yield self
        for c in self.children():
            yield from c.walk()

    def referenced_columns(self) -> List[str]:
        out: List[str] = []
        for node in self.walk():
            if isinstance(node, ColumnRef) and node._name not in out:
                out.append(node._name)
        return out

    def has_agg(self) -> bool:
        return any(isinstance(n, AggExpr) for n in self.walk())

    def has_udf(self) -> bool:
        from ..udf.expr import UdfCall

        return any(isinstance(n, UdfCall) for n in self.walk())

    def is_literal_true(self) -> bool:
        return isinstance(self, Literal) and self.value is True

    # ---- typing -------------------------------------------------------------------
    def to_field(self, schema: Schema) -> Field:
        raise NotImplementedError(type(self).__name__)

    # ---- operators ----------------------------------------------------------------
    def _other(self, other) -> "Expression":
        return other if isinstance(other, Expression) else lit(other)

    def __add__(self, other):
        return BinaryOp("add", self, self._other(other))

    def __radd__(self, other):
        return BinaryOp("add", self._other(other), self)

    def __sub__(self, other):
        return BinaryOp("sub", self, self._other(other))

    def __rsub__(self, other):
        return BinaryOp("sub", self._other(other), self)

    def __mul__(self, other):
        return BinaryOp("mul", self, self._other(other))

    def __rmul__(self, other):
        return BinaryOp("mul", self._other(other), self)

    def __truediv__(self, other):
        return BinaryOp("div", self, self._other(other))

    def __rtruediv__(self, other):
        return BinaryOp("div", self._other(other), self)

    def __eq__(self, other):  # type: ignore[override]
        return BinaryOp("eq", self, self._other(other))

    def __ne__(self, other):  # type: ignore[override]
        return BinaryOp("neq", self, self._other(other))

    def __lt__(self, other):
        return BinaryOp("lt", self, self._other(other))

    def __le__(self, other):
        return BinaryOp("le", self, self._other(other))

    def __gt__(self, other):
        return BinaryOp("gt", self, self._other(other))

    def __ge__(self, other):
        return BinaryOp("ge", self, self._other(other))

    def __and__(self, other):
        return BinaryOp("and", self, self._other(other))

    def __rand__(self, other):
        return BinaryOp("and", self._other(other), self)

    def __or__(self, other):
        return BinaryOp("or", self, self._other(other))

    def __ror__(self, other):
        return BinaryOp("or", self._other(other), self)

    def __invert__(self):
        return UnaryOp("not", self)

    def __neg__(self):
        return UnaryOp("neg", self)

    def __hash__(self):
        return hash(repr(self))

    def __bool__(self):
        raise ValueError(
            "Expressions are lazy; cannot convert to bool. Use & | ~ instead of and/or/not.")

    # ---- null / conditional -------------------------------------------------------
    def is_null(self) -> "Expression":
        return UnaryOp("is_null", self)

    def not_null(self) -> "Expression":
        return UnaryOp("not_null", self)

    def if_else(self, if_true, if_false) -> "Expression":
        return IfElse(self, self._other(if_true), self._other(if_false))

    def between(self, lower, upper) -> "Expression":
        """lower <= self <= upper (both bounds inclusive)."""
        return Between(self, self._other(lower), self._other(upper))

    def is_in(self, values) -> "Expression":
        if isinstance(values, Expression):
            items = [values]
        else:
            items = [v if isinstance(v, Expression) else lit(v) for v in values]
        return IsIn(self, items)

    def apply(self, fn: Callable, return_dtype: DataType) -> "Expression":
        """A row UDF of ``fn`` over this expression."""
        from ..udf.expr import UdfCall
        from ..udf.udf import Func

        f = Func(fn=fn, return_dtype=return_dtype, name=getattr(fn, "__name__", "apply"))
        return UdfCall(f, [self], {})

    @property
    def str(self) -> "StringNamespace":
        return StringNamespace(self)

    @property
    def dt(self) -> "DateNamespace":
        return DateNamespace(self)

    # ---- aggregation sugar ----------------------------------------------------------
    def sum(self):
        return AggExpr("sum", self)

    def mean(self):
        return AggExpr("mean", self)

    def min(self):
        return AggExpr("min", self)

    def max(self):
        return AggExpr("max", self)

    def count(self, mode: str = "valid"):
        return AggExpr("count", self, {"mode": mode})

    def count_distinct(self):
        """The number of distinct valid values (nulls are not counted)."""
        return AggExpr("count_distinct", self)

    # ---- windows --------------------------------------------------------------------
    def over(self, spec) -> "WindowExpr":
        """This aggregation over a window (window.py ``Window``)."""
        if isinstance(self, AggExpr):
            return WindowExpr(self.op, self.child, spec, self.params)
        raise ValueError(
            f"only aggregation expressions support .over(); got {type(self).__name__} "
            "(use daft_tpu_torch.functions.row_number()/rank()/... for ranking window fns)")

    def lag(self, offset: int = 1, default=None) -> "Expression":
        return _UnboundWindowFn("lag", self, {"offset": offset, "default": default})

    def lead(self, offset: int = 1, default=None) -> "Expression":
        return _UnboundWindowFn("lead", self, {"offset": offset, "default": default})

    def first_value(self) -> "Expression":
        return _UnboundWindowFn("first_value", self, {})

    def last_value(self) -> "Expression":
        return _UnboundWindowFn("last_value", self, {})


class ColumnRef(Expression):
    def __init__(self, name: str):
        self._name = name

    def name(self) -> str:
        return self._name

    def to_field(self, schema: Schema) -> Field:
        return schema[self._name]

    def __repr__(self):
        return f"col({self._name})"


class Literal(Expression):
    def __init__(self, value: Any, dtype: Optional[DataType] = None):
        self.value = value
        self.dtype = dtype or _infer_literal_dtype(value)

    def name(self) -> str:
        return "literal"

    def to_field(self, schema: Schema) -> Field:
        return Field("literal", self.dtype)

    def storage_value(self):
        """The value as stored in a column: a date literal is int32 days
        since 1970-01-01, on the host path and the device path alike."""
        if self.dtype.is_temporal() and isinstance(self.value, datetime.date):
            return self.value.toordinal() - datetime.date(1970, 1, 1).toordinal()
        return self.value

    def __repr__(self):
        return f"lit({self.value!r})"


class Alias(Expression):
    def __init__(self, child: Expression, alias: str):
        self.child = child
        self._alias = alias

    def name(self) -> str:
        return self._alias

    def children(self):
        return [self.child]

    def with_children(self, children):
        return Alias(children[0], self._alias)

    def to_field(self, schema: Schema) -> Field:
        return Field(self._alias, self.child.to_field(schema).dtype)

    def __repr__(self):
        return f"{self.child!r}.alias({self._alias!r})"


class Cast(Expression):
    def __init__(self, child: Expression, dtype: DataType):
        self.child = child
        self.dtype = dtype

    def name(self) -> str:
        return self.child.name()

    def children(self):
        return [self.child]

    def with_children(self, children):
        return Cast(children[0], self.dtype)

    def to_field(self, schema: Schema) -> Field:
        return Field(self.child.to_field(schema).name, self.dtype)

    def __repr__(self):
        return f"{self.child!r}.cast({self.dtype})"


COMPARISON_OPS = {"eq", "neq", "lt", "le", "gt", "ge"}
LOGICAL_OPS = {"and", "or"}
ARITH_OPS = {"add", "sub", "mul", "div"}


class BinaryOp(Expression):
    def __init__(self, op: str, left: Expression, right: Expression):
        self.op = op
        self.left = left
        self.right = right

    def name(self) -> str:
        return self.left.name()

    def children(self):
        return [self.left, self.right]

    def with_children(self, children):
        return BinaryOp(self.op, children[0], children[1])

    def to_field(self, schema: Schema) -> Field:
        lf = self.left.to_field(schema)
        rf = self.right.to_field(schema)
        name = lf.name if not isinstance(self.left, Literal) else rf.name
        op = self.op
        if op in COMPARISON_OPS:
            return Field(name, DataType.bool())
        if op in LOGICAL_OPS:
            for dt in (lf.dtype, rf.dtype):
                if not (dt.is_boolean() or dt.is_null()):
                    raise ValueError(f"logical op {op!r} requires boolean operands, "
                                     f"got {lf.dtype} and {rf.dtype}")
            return Field(name, DataType.bool())
        if op in ARITH_OPS:
            return Field(name, _arith_result_type(op, lf.dtype, rf.dtype))
        raise ValueError(f"unknown binary op {op!r}")

    def __repr__(self):
        sym = {"add": "+", "sub": "-", "mul": "*", "div": "/", "eq": "==", "neq": "!=",
               "lt": "<", "le": "<=", "gt": ">", "ge": ">=", "and": "&", "or": "|"}.get(self.op)
        if sym:
            return f"({self.left!r} {sym} {self.right!r})"
        return f"{self.op}({self.left!r}, {self.right!r})"


class UnaryOp(Expression):
    def __init__(self, op: str, child: Expression):
        self.op = op
        self.child = child

    def name(self) -> str:
        return self.child.name()

    def children(self):
        return [self.child]

    def with_children(self, children):
        return UnaryOp(self.op, children[0])

    def to_field(self, schema: Schema) -> Field:
        f = self.child.to_field(schema)
        if self.op in ("is_null", "not_null", "not"):
            return Field(f.name, DataType.bool())
        if self.op == "neg":
            if not f.dtype.is_numeric():
                raise ValueError(f"{self.op} requires numeric input, got {f.dtype}")
            return f
        raise ValueError(f"unknown unary op {self.op!r}")

    def __repr__(self):
        return f"{self.op}({self.child!r})"


class IfElse(Expression):
    def __init__(self, predicate: Expression, if_true: Expression, if_false: Expression):
        self.predicate = predicate
        self.if_true = if_true
        self.if_false = if_false

    def name(self) -> str:
        return self.if_true.name()

    def children(self):
        return [self.predicate, self.if_true, self.if_false]

    def with_children(self, children):
        return IfElse(children[0], children[1], children[2])

    def to_field(self, schema: Schema) -> Field:
        t = self.if_true.to_field(schema)
        f = self.if_false.to_field(schema)
        return Field(self.name(), common_supertype(t.dtype, f.dtype))

    def __repr__(self):
        return f"{self.predicate!r}.if_else({self.if_true!r}, {self.if_false!r})"


class IsIn(Expression):
    """Membership of ``child`` in the values of ``items``. A null row is
    true only when the items hold a null, else false (never null), as the
    reference's Arrow ``is_in`` + ``fill_null(False)`` gives it."""

    def __init__(self, child: Expression, items: List[Expression]):
        self.child = child
        self.items = items

    def name(self) -> str:
        return self.child.name()

    def children(self):
        return [self.child] + self.items

    def with_children(self, children):
        return IsIn(children[0], children[1:])

    def to_field(self, schema: Schema) -> Field:
        return Field(self.child.to_field(schema).name, DataType.bool())

    def __repr__(self):
        return f"{self.child!r}.is_in({self.items!r})"


class Between(Expression):
    """lower <= child <= upper: ``(child >= lower) & (child <= upper)``
    under Kleene logic, as the reference's ``Series.between`` computes it."""

    def __init__(self, child: Expression, lower: Expression, upper: Expression):
        self.child = child
        self.lower = lower
        self.upper = upper

    def name(self) -> str:
        return self.child.name()

    def children(self):
        return [self.child, self.lower, self.upper]

    def with_children(self, children):
        return Between(children[0], children[1], children[2])

    def as_comparisons(self) -> Expression:
        return BinaryOp("and", BinaryOp("ge", self.child, self.lower),
                        BinaryOp("le", self.child, self.upper))

    def to_field(self, schema: Schema) -> Field:
        self.as_comparisons().to_field(schema)
        return Field(self.child.to_field(schema).name, DataType.bool())

    def __repr__(self):
        return f"{self.child!r}.between({self.lower!r}, {self.upper!r})"


# the scalar functions the port evaluates (on the host only): name ->
# (the first argument's kind, the types of the literal arguments after it,
# how many of them may be left out from the end, the result type)
FUNCTIONS = {
    "utf8_startswith": ("string", (str,), 0, "bool"),
    "utf8_endswith": ("string", (str,), 0, "bool"),
    "utf8_contains": ("string", (str,), 0, "bool"),
    "utf8_like": ("string", (str,), 0, "bool"),
    "utf8_left": ("string", (int,), 0, "string"),
    "utf8_substr": ("string", (int, int), 1, "string"),
    "dt_year": ("date", (), 0, "int32"),
}


class Function(Expression):
    """A scalar function call (counterpart of the reference's ``Function``
    over its registry, holding only what the TPC-H queries call: the string
    tests ``utf8_startswith``, ``utf8_endswith`` and ``utf8_contains`` (a
    substring, not a pattern), ``utf8_like`` (SQL LIKE: ``%`` any run, ``_``
    one character), ``utf8_left`` (the first n characters), ``utf8_substr``
    (from a 0-based start, optionally n characters) and ``dt_year``).
    Evaluated on the host (expressions/eval.py); the device never takes it
    (ops/device_eval.py), so a join capture hoists it into a host-evaluated
    dim column."""

    def __init__(self, fname: str, args: List[Expression]):
        if fname not in FUNCTIONS:
            raise ValueError(f"function {fname!r} is not ported")
        self.fname = fname
        self.args = args

    def name(self) -> str:
        return self.args[0].name()

    def children(self):
        return list(self.args)

    def with_children(self, children):
        return Function(self.fname, children)

    def to_field(self, schema: Schema) -> Field:
        kind, lit_types, optional, out = FUNCTIONS[self.fname]
        arg = self.args[0].to_field(schema)
        if not (arg.dtype.is_string() if kind == "string" else arg.dtype.kind == "date"):
            raise ValueError(f"{self.fname} takes a {kind} column, got {arg.dtype}")
        lits = self.args[1:]
        if not len(lit_types) - optional <= len(lits) <= len(lit_types):
            raise ValueError(f"{self.fname} takes {len(lit_types)} literal arguments, "
                             f"got {len(lits)}")
        for a, t in zip(lits, lit_types):
            if not (isinstance(a, Literal) and isinstance(a.value, t)
                    and not isinstance(a.value, bool)):
                raise ValueError(f"{self.fname} takes a {t.__name__} literal, got {a!r}")
        return Field(arg.name, getattr(DataType, out)())

    def __repr__(self):
        return f"{self.fname}({', '.join(repr(a) for a in self.args)})"


class StringNamespace:
    """``expr.str``: the string functions the port has."""

    def __init__(self, expr: Expression):
        self._e = expr

    def startswith(self, pat) -> Expression:
        return Function("utf8_startswith", [self._e, lit(pat)])

    def endswith(self, pat) -> Expression:
        return Function("utf8_endswith", [self._e, lit(pat)])

    def contains(self, pat) -> Expression:
        return Function("utf8_contains", [self._e, lit(pat)])

    def left(self, n) -> Expression:
        return Function("utf8_left", [self._e, lit(n)])

    def like(self, pattern) -> Expression:
        return Function("utf8_like", [self._e, lit(pattern)])

    def substr(self, start, length=None) -> Expression:
        args = [self._e, lit(start)] + ([] if length is None else [lit(length)])
        return Function("utf8_substr", args)


class DateNamespace:
    """``expr.dt``: the date functions the port has."""

    def __init__(self, expr: Expression):
        self._e = expr

    def year(self) -> Expression:
        return Function("dt_year", [self._e])


AGG_OPS = ("sum", "mean", "min", "max", "count", "count_distinct")


class AggExpr(Expression):
    def __init__(self, op: str, child: Expression, params: Optional[Dict[str, Any]] = None):
        if op not in AGG_OPS:
            raise ValueError(f"unknown aggregation {op!r}")
        self.op = op
        self.child = child
        self.params = params or {}

    def name(self) -> str:
        return self.child.name()

    def children(self):
        return [self.child]

    def with_children(self, children):
        return AggExpr(self.op, children[0], dict(self.params))

    def to_field(self, schema: Schema) -> Field:
        from ..core.kernels.groupby import agg_output_dtype

        f = self.child.to_field(schema)
        return Field(f.name, agg_output_dtype(self.op, f.dtype))

    def __repr__(self):
        return f"{self.child!r}.{self.op}()"


class _UnboundWindowFn(Expression):
    """A window function (lag, lead, first_value, last_value, row_number,
    rank, ...) before ``.over()`` binds it to a window."""

    def __init__(self, func: str, child: Optional[Expression], params: Dict[str, Any]):
        self.func = func
        self.child = child
        self.params = params

    def name(self) -> str:
        return self.child.name() if self.child is not None else self.func

    def children(self):
        return [self.child] if self.child is not None else []

    def with_children(self, children):
        return _UnboundWindowFn(self.func, children[0] if children else None, self.params)

    def over(self, spec) -> "WindowExpr":
        return WindowExpr(self.func, self.child, spec, self.params)

    def to_field(self, schema: Schema) -> Field:
        raise ValueError(f"{self.func}() must be bound with .over(window)")

    def __repr__(self):
        return f"{self.child!r}.{self.func}({self.params})"


# the ranking functions take no child; the value functions take one
WINDOW_FNS = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist", "ntile",
              "lag", "lead", "first_value", "last_value")


class WindowExpr(Expression):
    """A window function or a windowed aggregation bound to a window spec
    (the reference's expressions.py:756). ``func`` is one of
    ``WINDOW_FNS`` or an aggregation op; ``child`` the value expression
    (None for the ranking functions). Only a window node evaluates it
    (execution/window.py): the optimizer's ``rule_extract_windows`` moves
    it out of a projection, and the host evaluator refuses it elsewhere."""

    def __init__(self, func: str, child: Optional[Expression], spec: Any,
                 params: Optional[Dict[str, Any]] = None, out_name: Optional[str] = None):
        if func not in WINDOW_FNS and func not in AGG_OPS:
            raise ValueError(f"unknown window function {func!r}")
        self.func = func
        self.child = child
        self.spec = spec
        self.params = params or {}
        self._out_name = out_name

    def name(self) -> str:
        if self._out_name:
            return self._out_name
        return self.child.name() if self.child is not None else self.func

    def alias(self, name: str) -> "WindowExpr":
        return WindowExpr(self.func, self.child, self.spec, self.params, name)

    def children(self):
        """The child, then the spec's partition and order expressions, so
        column analysis (pruning, SQL name resolution) sees them."""
        out = [self.child] if self.child is not None else []
        out.extend(self.spec.partition_by_exprs)
        out.extend(self.spec.order_by_exprs)
        return out

    def with_children(self, children):
        i = 0
        child = None
        if self.child is not None:
            child = children[0]
            i = 1
        n_part = len(self.spec.partition_by_exprs)
        n_order = len(self.spec.order_by_exprs)
        spec = self.spec._copy()
        spec.partition_by_exprs = list(children[i:i + n_part])
        spec.order_by_exprs = list(children[i + n_part:i + n_part + n_order])
        return WindowExpr(self.func, child, spec, self.params, self._out_name)

    def to_field(self, schema: Schema) -> Field:
        name = self.name()
        if self.func in ("row_number", "rank", "dense_rank", "ntile"):
            return Field(name, DataType.uint64())
        if self.func in ("percent_rank", "cume_dist"):
            return Field(name, DataType.float64())
        if self.func in ("lag", "lead", "first_value", "last_value"):
            return Field(name, self.child.to_field(schema).dtype)
        return Field(name, AggExpr(self.func, self.child, self.params).to_field(schema).dtype)

    def __repr__(self):
        base = f"{self.child!r}.{self.func}" if self.child is not None else self.func
        return f"{base}.over({self.spec!r})"


def col(name: str) -> Expression:
    return ColumnRef(name)


def lit(value: Any, dtype: Optional[DataType] = None) -> Expression:
    return Literal(value, dtype)


def _infer_literal_dtype(v: Any) -> DataType:
    if v is None:
        return DataType.null()
    if isinstance(v, (bool, np.bool_)):
        return DataType.bool()
    if isinstance(v, (int, np.integer)):
        return DataType.uint64() if isinstance(v, np.unsignedinteger) else DataType.int64()
    if isinstance(v, (float, np.floating)):
        return DataType.float64()
    if isinstance(v, str):
        return DataType.string()
    if isinstance(v, datetime.datetime):
        raise TypeError("timestamp literals are not supported by the port yet")
    if isinstance(v, datetime.date):
        return DataType.date()
    raise TypeError(f"unsupported literal {v!r}")


def _numeric_promote(a: DataType, b: DataType) -> DataType:
    return DataType.from_numpy(np.promote_types(a.to_numpy(), b.to_numpy()))


def _arith_result_type(op: str, l: DataType, r: DataType) -> DataType:
    if op == "div":
        if l.is_numeric() and r.is_numeric():
            return DataType.float64()
        raise ValueError(f"cannot divide {l} by {r}")
    if l.is_null():
        return r
    if r.is_null():
        return l
    if not (l.is_numeric() and r.is_numeric()):
        raise ValueError(f"arith op {op!r} unsupported between {l} and {r}")
    return _numeric_promote(l, r)


def common_supertype(a: DataType, b: DataType) -> DataType:
    if a == b:
        return a
    if a.is_null():
        return b
    if b.is_null():
        return a
    if a.is_numeric() and b.is_numeric():
        return _numeric_promote(a, b)
    raise ValueError(f"no common supertype for {a} and {b}")
