"""Expression IR (counterpart of daft_tpu/expressions/expressions.py): ``col``,
``lit`` (with ``datetime.date``), ``Alias``, ``Cast``, arithmetic (``+ - * /
// % **``), comparisons and ``eq_null_safe``, ``&``, ``|``, ``^``, ``~``,
null tests and ``fill_null``, ``abs``, ``IfElse``, ``IsIn``, ``Between``,
``AggExpr`` (sum, count, mean, min, max, count_distinct, any_value,
stddev, var, skew, bool_and, bool_or, the list aggregates list, set,
concat, product and string_agg, and the sketches approx_count_distinct and
approx_percentile), ``Function`` calls into the scalar function registry
(functions/registry.py) with the ``.str``, ``.dt``, ``.float``, ``.list``,
``.struct``, ``.map``, ``.binary``, ``.json``, ``.embedding``, ``.image``
and ``.url`` namespaces, the math methods, ``minhash``, ``tokenize_*``, the
file methods and the flat API (with ``_TypeDispatch``, whose namespace
follows the input type, and ``Unnest``), and UDF calls (udf/expr.py
``UdfCall``, ``Expression.apply``). ``transform`` rewrites a tree bottom-up (the join capture substitutes
projections and hoists dim-only subexpressions with it).

One class hierarchy is both the user-facing Expression and the plan IR. Host
evaluation lives in expressions/eval.py, device (torch) evaluation in
ops/device_eval.py; both dispatch over these node types.
"""

from __future__ import annotations

import datetime
import decimal
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.temporal import finer_unit
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

    def get_type(self, schema: Schema) -> DataType:
        """The expression's type over ``schema``."""
        return self.to_field(schema).dtype

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

    def __floordiv__(self, other):
        return BinaryOp("floordiv", self, self._other(other))

    def __rfloordiv__(self, other):
        return BinaryOp("floordiv", self._other(other), self)

    def __mod__(self, other):
        return BinaryOp("mod", self, self._other(other))

    def __rmod__(self, other):
        return BinaryOp("mod", self._other(other), self)

    def __pow__(self, other):
        return BinaryOp("pow", self, self._other(other))

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

    def __xor__(self, other):
        return BinaryOp("xor", self, self._other(other))

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

    def fill_null(self, value) -> "Expression":
        return BinaryOp("fill_null", self, self._other(value))

    def eq_null_safe(self, other) -> "Expression":
        return BinaryOp("eq_null_safe", self, self._other(other))

    def abs(self) -> "Expression":
        return UnaryOp("abs", self)

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

    # ---- scalar function sugar ------------------------------------------------------
    def _fn(__self, __fname: str, *args, **kwargs) -> "Expression":
        exprs = [__self] + [a if isinstance(a, Expression) else lit(a) for a in args]
        return Function(__fname, exprs, kwargs)

    def exp(self):
        return self._fn("exp")

    def log(self, base: Optional[float] = None):
        return self._fn("log", **({"base": base} if base else {}))

    def log2(self):
        return self._fn("log2")

    def log10(self):
        return self._fn("log10")

    def sqrt(self):
        return self._fn("sqrt")

    def sin(self):
        return self._fn("sin")

    def cos(self):
        return self._fn("cos")

    def tan(self):
        return self._fn("tan")

    def arctan(self):
        return self._fn("arctan")

    def arcsin(self):
        return self._fn("arcsin")

    def arccos(self):
        return self._fn("arccos")

    def floor(self):
        return self._fn("floor")

    def ceil(self):
        return self._fn("ceil")

    def round(self, decimals: int = 0):
        return self._fn("round", decimals=decimals)

    def sign(self):
        return self._fn("sign")

    def clip(self, min=None, max=None):
        return self._fn("clip", clip_min=min, clip_max=max)

    def hash(self, seed=None):
        return self._fn("hash", **({"seed": seed} if seed is not None else {}))

    def minhash(self, num_hashes: int = 16, ngram_size: int = 1, seed: int = 1):
        """Word-shingle MinHash signatures (expressions.py:264-265)."""
        return self._fn("minhash", num_hashes=num_hashes, ngram_size=ngram_size, seed=seed)

    def tokenize_encode(self, tokenizer: str = "bytes"):
        """Text to token ids (expressions.py:267-270): the "bytes" tokenizer."""
        return self._fn("tokenize_encode", tokenizer=tokenizer)

    def tokenize_decode(self, tokenizer: str = "bytes"):
        """Token ids to text, the inverse of ``tokenize_encode``."""
        return self._fn("tokenize_decode", tokenizer=tokenizer)

    def file_path(self):
        """The path of a file column's reference (expressions.py:1748)."""
        return self._fn("file_path")

    def file_size(self, io_config=None):
        return self._fn("file_size", io_config=io_config)

    def file_read(self, offset: int = 0, length=None, io_config=None):
        """A file column's bytes from ``offset``, ``length`` of them."""
        return self._fn("file_read", offset=offset, length=length, io_config=io_config)

    @property
    def str(self) -> "StringNamespace":
        return StringNamespace(self)

    @property
    def dt(self) -> "TemporalNamespace":
        return TemporalNamespace(self)

    @property
    def float(self) -> "FloatNamespace":
        return FloatNamespace(self)

    @property
    def list(self) -> "ListNamespace":
        return ListNamespace(self)

    @property
    def struct(self) -> "StructNamespace":
        return StructNamespace(self)

    @property
    def map(self) -> "MapNamespace":
        return MapNamespace(self)

    @property
    def binary(self) -> "BinaryNamespace":
        return BinaryNamespace(self)

    @property
    def json(self) -> "JsonNamespace":
        return JsonNamespace(self)

    @property
    def image(self) -> "ImageNamespace":
        return ImageNamespace(self)

    @property
    def url(self) -> "UrlNamespace":
        return UrlNamespace(self)

    @property
    def embedding(self) -> "EmbeddingNamespace":
        return EmbeddingNamespace(self)

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

    def avg(self):
        return AggExpr("mean", self)

    def any_value(self, ignore_nulls: bool = False):
        return AggExpr("any_value", self, {"ignore_nulls": ignore_nulls})

    def stddev(self, ddof: int = 0):
        return AggExpr("stddev", self, {"ddof": ddof} if ddof else {})

    def var(self, ddof: int = 0):
        return AggExpr("var", self, {"ddof": ddof} if ddof else {})

    def skew(self):
        return AggExpr("skew", self)

    def bool_and(self):
        return AggExpr("bool_and", self)

    def bool_or(self):
        return AggExpr("bool_or", self)

    def agg_list(self):
        return AggExpr("list", self)

    def agg_set(self):
        return AggExpr("set", self)

    def agg_concat(self):
        return AggExpr("concat", self)

    def product(self):
        """The product of the valid values (the reference's
        expressions.py:1579)."""
        return AggExpr("product", self)

    def string_agg(self, delimiter: str = ""):
        """The valid strings joined by ``delimiter`` (expressions.py:1584)."""
        return AggExpr("string_agg", self, {"delimiter": delimiter})

    def list_agg(self):
        return AggExpr("list", self)

    def list_agg_distinct(self):
        return AggExpr("set", self)

    def approx_count_distinct(self):
        return AggExpr("approx_count_distinct", self)

    def approx_percentile(self, *percentiles, alpha: float = 0.01):
        """DDSketch percentile(s) in [0, 1] (expressions.py:335-344): one
        gives a float64, several a list of float64."""
        if not percentiles:
            raise ValueError("approx_percentile needs at least one percentile")
        single = len(percentiles) == 1
        return AggExpr("approx_percentile", self, {
            "percentiles": float(percentiles[0]) if single else [float(p) for p in percentiles],
            "alpha": alpha})

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
        """The value as stored in a column of the literal's type, on the host
        path and the device path alike: a date is int32 days since
        1970-01-01, a timestamp int64 ticks of its unit (an aware datetime
        its UTC instant, a naive one read as UTC), a duration or a time of
        day int64 ticks."""
        if self.dtype.is_temporal() and self.value is not None:
            from ..core.series import _temporal_ticks

            return _temporal_ticks(self.value, self.dtype)
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


COMPARISON_OPS = {"eq", "neq", "lt", "le", "gt", "ge", "eq_null_safe"}
LOGICAL_OPS = {"and", "or", "xor"}
ARITH_OPS = {"add", "sub", "mul", "div", "floordiv", "mod", "pow"}


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
        if op == "fill_null":
            return Field(lf.name, lf.dtype if not lf.dtype.is_null() else rf.dtype)
        if op in ARITH_OPS:
            return Field(name, _arith_result_type(op, lf.dtype, rf.dtype))
        raise ValueError(f"unknown binary op {op!r}")

    def __repr__(self):
        sym = {"add": "+", "sub": "-", "mul": "*", "div": "/", "floordiv": "//", "mod": "%",
               "pow": "**", "eq": "==", "neq": "!=", "lt": "<", "le": "<=", "gt": ">",
               "ge": ">=", "and": "&", "or": "|", "xor": "^"}.get(self.op)
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
        if self.op in ("neg", "abs"):
            if not (f.dtype.is_numeric() or f.dtype.is_decimal()):
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


class Function(Expression):
    """A call into the scalar function registry (counterpart of the
    reference's ``Function``, functions/registry.py): ``args`` are
    expressions (a literal argument is a ``Literal``), ``kwargs`` the
    function's options. The registry's return-type rule types it, its host
    kernel evaluates it (expressions/eval.py), and a function with a device
    form runs in the stage program (ops/device_eval.py). A name of a later
    wave raises ``NotImplementedError`` naming the wave; an unknown name
    raises ``ValueError``."""

    def __init__(self, fname: str, args: List[Expression],
                 kwargs: Optional[Dict[str, Any]] = None):
        from ..functions.registry import get_function

        get_function(fname)
        self.fname = fname
        self.args = args
        self.kwargs = kwargs or {}

    def name(self) -> str:
        return self.args[0].name() if self.args else self.fname

    def children(self):
        return list(self.args)

    def with_children(self, children):
        return Function(self.fname, children, self.kwargs)

    def to_field(self, schema: Schema) -> Field:
        from ..functions.registry import get_function

        spec = get_function(self.fname)
        fields = [a.to_field(schema) for a in self.args]
        if spec.check is not None:
            spec.check(self.fname, self.args, fields)
        return Field(self.name(), spec.return_type(fields, self.kwargs))

    def __repr__(self):
        # the options are part of the call: the stage cache and the
        # optimizer's conjunct sets key expressions by their repr
        opts = [f"{k}={v!r}" for k, v in sorted(self.kwargs.items())]
        return f"{self.fname}({', '.join([repr(a) for a in self.args] + opts)})"


class _Namespace:
    def __init__(self, expr: Expression):
        self._e = expr


class StringNamespace(_Namespace):
    """``expr.str``: the string functions (the reference's StringNamespace)."""

    def upper(self):
        return self._e._fn("utf8_upper")

    def lower(self):
        return self._e._fn("utf8_lower")

    def title(self):
        return self._e._fn("utf8_title")

    def capitalize(self):
        return self._e._fn("utf8_capitalize")

    def length(self):
        return self._e._fn("utf8_length")

    def length_bytes(self):
        return self._e._fn("utf8_length_bytes")

    def contains(self, pat):
        return self._e._fn("utf8_contains", pat)

    def startswith(self, pat):
        return self._e._fn("utf8_startswith", pat)

    def endswith(self, pat):
        return self._e._fn("utf8_endswith", pat)

    def match(self, pattern):
        return self._e._fn("utf8_match", pattern)

    def split(self, pat, regex: bool = False):
        return self._e._fn("utf8_split", pat, regex=regex)

    def concat(self, other):
        return BinaryOp("add", self._e, self._e._other(other))

    def substr(self, start, length=None):
        return self._e._fn("utf8_substr", start, *([] if length is None else [length]))

    def replace(self, pat, replacement, regex: bool = False):
        return self._e._fn("utf8_replace", pat, replacement, regex=regex)

    def extract(self, pattern, index: int = 0):
        return self._e._fn("utf8_extract", pattern, index=index)

    def extract_all(self, pattern, index: int = 0):
        return self._e._fn("utf8_extract_all", pattern, index=index)

    def find(self, substr):
        return self._e._fn("utf8_find", substr)

    def lstrip(self):
        return self._e._fn("utf8_lstrip")

    def rstrip(self):
        return self._e._fn("utf8_rstrip")

    def strip(self):
        return self._e._fn("utf8_strip")

    def reverse(self):
        return self._e._fn("utf8_reverse")

    def left(self, n):
        return self._e._fn("utf8_left", n)

    def right(self, n):
        return self._e._fn("utf8_right", n)

    def repeat(self, n):
        return self._e._fn("utf8_repeat", n)

    def like(self, pattern):
        return self._e._fn("utf8_like", pattern)

    def ilike(self, pattern):
        return self._e._fn("utf8_ilike", pattern)

    def rpad(self, length, pad=" "):
        return self._e._fn("utf8_rpad", length, pad)

    def lpad(self, length, pad=" "):
        return self._e._fn("utf8_lpad", length, pad)

    def to_date(self, format: str):
        return self._e._fn("utf8_to_date", format=format)

    def to_datetime(self, format: str, timezone: Optional[str] = None):
        return self._e._fn("utf8_to_datetime", format=format, timezone=timezone)

    def normalize(self, remove_punct=False, lowercase=False, nfd_unicode=False,
                  white_space=False):
        return self._e._fn("utf8_normalize", remove_punct=remove_punct, lowercase=lowercase,
                           nfd_unicode=nfd_unicode, white_space=white_space)

    def count_matches(self, patterns, whole_words: bool = False, case_sensitive: bool = True):
        return self._e._fn("utf8_count_matches", patterns, whole_words=whole_words,
                           case_sensitive=case_sensitive)

    def levenshtein(self, other):
        return self._e._fn("levenshtein", other)

    def jaccard_similarity(self, other, ngram: int = 2):
        return self._e._fn("jaccard_similarity", other, ngram=ngram)

    def md5(self):
        return self._e._fn("md5")

    def sha256(self):
        return self._e._fn("sha256")

    def tokenize_encode(self, tokenizer: str = "r50k_base"):
        """As ``Expression.tokenize_encode``, with the reference's default
        tokenizer (expressions.py:943): a tokenizer file, which raises
        ``NotImplementedError`` until its reader is ported."""
        return self._e._fn("tokenize_encode", tokenizer=tokenizer)

    def tokenize_decode(self, tokenizer: str = "r50k_base"):
        return self._e._fn("tokenize_decode", tokenizer=tokenizer)


class TemporalNamespace(_Namespace):
    """``expr.dt``: the temporal functions over dates, timestamps and
    times (the reference's TemporalNamespace)."""

    def year(self):
        return self._e._fn("dt_year")

    def month(self):
        return self._e._fn("dt_month")

    def day(self):
        return self._e._fn("dt_day")

    def day_of_month(self):
        return self._e._fn("dt_day")

    def day_of_week(self):
        return self._e._fn("dt_day_of_week")

    def day_of_year(self):
        return self._e._fn("dt_day_of_year")

    def week_of_year(self):
        return self._e._fn("dt_week_of_year")

    def quarter(self):
        return self._e._fn("dt_quarter")

    def is_leap_year(self):
        return self._e._fn("dt_is_leap_year")

    def days_in_month(self):
        return self._e._fn("dt_days_in_month")

    def truncate(self, interval: str):
        return self._e._fn("dt_truncate", interval=interval)

    def to_unix_epoch(self, unit: str = "s"):
        return self._e._fn("dt_to_unix_epoch", unit=unit)

    def strftime(self, format: Optional[str] = None):
        return self._e._fn("dt_strftime", format=format)

    def hour(self):
        return self._e._fn("dt_hour")

    def minute(self):
        return self._e._fn("dt_minute")

    def second(self):
        return self._e._fn("dt_second")

    def millisecond(self):
        return self._e._fn("dt_millisecond")

    def microsecond(self):
        return self._e._fn("dt_microsecond")

    def date(self):
        return self._e._fn("dt_date")

    def time(self):
        return self._e._fn("dt_time")


class FloatNamespace(_Namespace):
    """``expr.float``: NaN and infinity tests and fill_nan."""

    def is_nan(self):
        return self._e._fn("is_nan")

    def is_inf(self):
        return self._e._fn("is_inf")

    def not_nan(self):
        return self._e._fn("not_nan")

    def fill_nan(self, value):
        return self._e._fn("fill_nan", value)


class ListNamespace(_Namespace):
    """``expr.list`` (the reference's expressions.py:1011-1054)."""

    def length(self):
        return self._e._fn("list_length")

    def get(self, idx, default=None):
        return self._e._fn("list_get", idx, default)

    def sum(self):
        return self._e._fn("list_sum")

    def mean(self):
        return self._e._fn("list_mean")

    def min(self):
        return self._e._fn("list_min")

    def max(self):
        return self._e._fn("list_max")

    def count(self, mode: str = "valid"):
        return self._e._fn("list_count", mode=mode)

    def join(self, delimiter: str):
        return self._e._fn("list_join", delimiter)

    def contains(self, value):
        return self._e._fn("list_contains", value)

    def slice(self, start, end=None):
        return self._e._fn("list_slice", start, end)

    def sort(self, desc: bool = False):
        return self._e._fn("list_sort", desc=desc)

    def distinct(self):
        return self._e._fn("list_distinct")

    def value_counts(self):
        return self._e._fn("list_value_counts")

    def chunk(self, size: int):
        return self._e._fn("list_chunk", size=size)


class StructNamespace(_Namespace):
    """``expr.struct`` (expressions.py:1116-1125)."""

    def get(self, name: str):
        return self._e._fn("struct_get", name=name)


class BinaryNamespace(_Namespace):
    """``expr.binary`` (expressions.py:1228-1255)."""

    def length(self):
        return self._e._fn("binary_length")

    def concat(self, other):
        return self._e._fn("binary_concat", other)

    def slice(self, start: int, length=None):
        kw = {"start": start}
        if length is not None:
            kw["length"] = length
        return self._e._fn("binary_slice", **kw)

    def encode_hex(self):
        return self._e._fn("encode_hex")

    def decode_hex(self):
        return self._e._fn("decode_hex")

    def encode_base64(self):
        return self._e._fn("encode_base64")

    def decode_base64(self):
        return self._e._fn("decode_base64")


class MapNamespace(_Namespace):
    """``expr.map`` (expressions.py:1256-1262)."""

    def get(self, key):
        return self._e._fn("map_get", key=key)


class JsonNamespace(_Namespace):
    """``expr.json`` (expressions.py:1263-1275)."""

    def query(self, path: str):
        return self._e._fn("json_query", path=path)


class EmbeddingNamespace(_Namespace):
    """``expr.embedding`` (expressions.py:1069-1080)."""

    def cosine_distance(self, other):
        return self._e._fn("cosine_distance", other)

    def dot(self, other):
        return self._e._fn("dot", other)

    def euclidean_distance(self, other):
        return self._e._fn("euclidean_distance", other)

    def norm(self):
        return self._e._fn("embedding_norm")


class ImageNamespace(_Namespace):
    """``expr.image`` (expressions.py:1083-1105)."""

    def decode(self, mode: Optional[str] = None, on_error: str = "raise"):
        return self._e._fn("image_decode", mode=mode, on_error=on_error)

    def encode(self, image_format: str = "PNG"):
        return self._e._fn("image_encode", image_format=image_format)

    def resize(self, w: int, h: int):
        return self._e._fn("image_resize", w=w, h=h)

    def crop(self, bbox):
        return self._e._fn("image_crop", bbox=tuple(bbox))

    def to_mode(self, mode: str):
        return self._e._fn("image_to_mode", mode=mode)

    def to_fixed_shape(self, mode: str, h: int, w: int):
        """A dense (h, w, c) fixed-shape image: the device UDF tier's input."""
        return self._e._fn("image_to_fixed_shape", mode=mode, h=h, w=w)


class UrlNamespace(_Namespace):
    """``expr.url`` (expressions.py:1108-1115)."""

    def download(self, on_error: str = "raise", timeout: int = 30):
        return self._e._fn("url_download", on_error=on_error, timeout=timeout)

    def upload(self, location: str):
        return self._e._fn("url_upload", location=location)


AGG_OPS = ("sum", "mean", "min", "max", "count", "count_distinct", "any_value", "stddev",
           "var", "skew", "bool_and", "bool_or", "list", "set", "concat", "product",
           "string_agg", "approx_count_distinct", "approx_percentile")


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
        if self.op == "approx_percentile":
            single = not isinstance(self.params.get("percentiles"), list)
            return Field(f.name, DataType.float64() if single
                         else DataType.list(DataType.float64()))
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


# the reference's flat API (expressions.py:1276-1360): each name a method of
# Expression, an alias of a namespace method or a registry call
_FLAT_NAMESPACE_ALIASES = {
    "capitalize": ("str", "capitalize"), "count_matches": ("str", "count_matches"),
    "endswith": ("str", "endswith"), "find": ("str", "find"), "ilike": ("str", "ilike"),
    "left": ("str", "left"), "like": ("str", "like"), "lower": ("str", "lower"),
    "lpad": ("str", "lpad"), "lstrip": ("str", "lstrip"),
    "lengths_bytes": ("str", "length_bytes"), "length_bytes": ("str", "length_bytes"),
    "normalize": ("str", "normalize"), "repeat": ("str", "repeat"),
    "replace": ("str", "replace"), "reverse": ("str", "reverse"), "right": ("str", "right"),
    "rpad": ("str", "rpad"), "rstrip": ("str", "rstrip"), "split": ("str", "split"),
    "startswith": ("str", "startswith"), "strip": ("str", "strip"),
    "substr": ("str", "substr"), "upper": ("str", "upper"), "to_date": ("str", "to_date"),
    "to_datetime": ("str", "to_datetime"),
    "jaccard_similarity": ("str", "jaccard_similarity"), "regexp": ("str", "match"),
    "regexp_extract": ("str", "extract"), "regexp_extract_all": ("str", "extract_all"),
    "date": ("dt", "date"), "day": ("dt", "day"), "day_of_month": ("dt", "day_of_month"),
    "day_of_week": ("dt", "day_of_week"), "day_of_year": ("dt", "day_of_year"),
    "hour": ("dt", "hour"), "microsecond": ("dt", "microsecond"),
    "millisecond": ("dt", "millisecond"), "minute": ("dt", "minute"),
    "month": ("dt", "month"), "quarter": ("dt", "quarter"), "second": ("dt", "second"),
    "time": ("dt", "time"), "week_of_year": ("dt", "week_of_year"), "year": ("dt", "year"),
    "strftime": ("dt", "strftime"), "to_unix_epoch": ("dt", "to_unix_epoch"),
    "date_trunc": ("dt", "truncate"), "fill_nan": ("float", "fill_nan"),
    "is_inf": ("float", "is_inf"), "is_nan": ("float", "is_nan"),
    "not_nan": ("float", "not_nan"), "list_contains": ("list", "contains"),
    "list_count": ("list", "count"), "list_distinct": ("list", "distinct"),
    "list_join": ("list", "join"), "list_max": ("list", "max"), "list_mean": ("list", "mean"),
    "list_min": ("list", "min"), "list_sort": ("list", "sort"), "list_sum": ("list", "sum"),
    "value_counts": ("list", "value_counts"), "chunk": ("list", "chunk"),
    "cosine_distance": ("embedding", "cosine_distance"),
    "euclidean_distance": ("embedding", "euclidean_distance"),
    "dot_product": ("embedding", "dot"), "crop": ("image", "crop"),
    "resize": ("image", "resize"), "convert_image": ("image", "to_mode"),
    "encode_image": ("image", "encode"), "decode_image": ("image", "decode"),
    "image_to_tensor": ("image", "to_fixed_shape"), "download": ("url", "download"),
    "upload": ("url", "upload"), "map_get": ("map", "get"), "jq": ("json", "query"),
}
_FLAT_REGISTRY_FNS = (
    "arccosh", "arcsinh", "arctanh", "arctan2", "cbrt", "cosh", "sinh", "tanh", "cot", "sec",
    "csc", "degrees", "radians", "expm1", "log1p", "to_camel_case", "to_snake_case",
    "to_kebab_case", "to_title_case", "to_upper_camel_case", "to_upper_snake_case",
    "to_upper_kebab_case", "parse_url", "shift_left", "shift_right", "bitwise_and",
    "bitwise_or", "bitwise_xor", "bitwise_not", "coalesce", "total_days", "total_hours",
    "total_minutes", "total_seconds", "total_milliseconds", "total_microseconds",
    "total_nanoseconds", "unix_date", "image_height", "image_width", "image_channel",
    "image_hash",
)


def _install_flat_api():
    def alias(ns_attr, meth):
        def flat(self, *args, **kwargs):
            return getattr(getattr(self, ns_attr), meth)(*args, **kwargs)
        flat.__name__ = meth
        flat.__doc__ = f"Alias of Expression.{ns_attr}.{meth}()."
        return flat

    def registry_call(fname):
        def flat(self, *args, **kwargs):
            return self._fn(fname, *args, **kwargs)
        flat.__name__ = fname
        flat.__doc__ = f"The registry's scalar function {fname!r}."
        return flat

    for name, (ns_attr, meth) in _FLAT_NAMESPACE_ALIASES.items():
        if not hasattr(Expression, name):
            setattr(Expression, name, alias(ns_attr, meth))
    for fname in _FLAT_REGISTRY_FNS:
        if not hasattr(Expression, fname):
            setattr(Expression, fname, registry_call(fname))
    Expression.pow = Expression.power = lambda self, exponent: self ** exponent
    Expression.negate = lambda self: -self
    Expression.ln = lambda self: self.log()


_install_flat_api()


def _partition_transform(fname):
    def flat(self):
        return self._fn(fname)
    flat.__name__ = fname
    flat.__doc__ = f"The {fname.split('_')[1]} partition transform (Iceberg's)."
    return flat


for _unit in ("days", "hours", "months", "years"):
    setattr(Expression, f"partition_{_unit}", _partition_transform(f"partition_{_unit}"))


def _options_call(fname, **defaults):
    """A flat method calling ``fname`` with keyword options (the reference's
    expressions.py:1505-1720 flat methods of the nested-types wave)."""
    names = list(defaults)

    def flat(self, *args, **kwargs):
        opts = dict(defaults)
        opts.update(zip(names, args))
        opts.update(kwargs)
        return self._fn(fname, **opts)
    flat.__name__ = fname
    flat.__doc__ = f"The registry's scalar function {fname!r}."
    return flat


for _name, _fname, _defaults in (
        ("serialize", "serialize", {"format": "json"}),
        ("deserialize", "deserialize", {"format": "json", "dtype": None}),
        ("try_deserialize", "try_deserialize", {"format": "json", "dtype": None}),
        ("compress", "compress", {"codec": "gzip"}),
        ("decompress", "decompress", {"codec": "gzip"}),
        ("try_compress", "try_compress", {"codec": "gzip"}),
        ("try_decompress", "try_decompress", {"codec": "gzip"}),
        ("encode", "codec_encode", {"codec": "utf-8"}),
        ("decode", "codec_decode", {"codec": "utf-8"}),
        ("try_encode", "try_codec_encode", {"codec": "utf-8"}),
        ("try_decode", "try_codec_decode", {"codec": "utf-8"}),
        ("partition_iceberg_bucket", "partition_iceberg_bucket", {"n": None}),
        ("partition_iceberg_truncate", "partition_iceberg_truncate", {"w": None})):
    setattr(Expression, _name, _options_call(_fname, **_defaults))

Expression.list_append = lambda self, other: self._fn("list_append", other)
Expression.list_bool_and = lambda self: self._fn("list_bool_and")
Expression.list_bool_or = lambda self: self._fn("list_bool_or")
Expression.regexp_count = lambda self, pattern: self.str.extract_all(pattern).list.length()


class _TypeDispatch(Expression):
    """A flat method whose namespace depends on the input type, chosen when
    the schema is known (the reference's expressions.py:1400-1445)."""

    def __init__(self, child: Expression, table, opname, *args):
        self.child = child
        self.table = table
        self.opname = opname
        self.args = args

    def name(self) -> str:
        return self.child.name()

    def children(self):
        return [self.child]

    def with_children(self, children):
        return _TypeDispatch(children[0], self.table, self.opname, *self.args)

    def resolve(self, schema: Schema) -> Expression:
        dt = self.child.to_field(schema).dtype
        kind = ("list" if dt.is_list() else "string" if dt.is_string() else
                "binary" if dt.is_binary() else "map" if dt.is_map() else
                "struct" if dt.is_struct() else dt.kind)
        hit = self.table.get(kind)
        if hit is None:
            raise ValueError(f"{self.opname}() does not support dtype {dt}; "
                             f"supported kinds: {sorted(self.table)}")
        ns_attr, meth = hit
        args = [a for a in self.args if a is not None] if self.opname == "slice" \
            else list(self.args)
        return getattr(getattr(self.child, ns_attr), meth)(*args)

    def to_field(self, schema: Schema) -> Field:
        return self.resolve(schema).to_field(schema)

    def __repr__(self):
        return f"{self.child!r}.{self.opname}({', '.join(map(repr, self.args))})"


Expression.length = lambda self: _TypeDispatch(
    self, {"list": ("list", "length"), "string": ("str", "length"),
           "binary": ("binary", "length")}, "length")
Expression.get = lambda self, key_or_index, default=None: _TypeDispatch(
    self, {"list": ("list", "get"), "map": ("map", "get"), "struct": ("struct", "get")},
    "get", key_or_index)
Expression.contains = lambda self, item: _TypeDispatch(
    self, {"list": ("list", "contains"), "string": ("str", "contains")}, "contains", item)
Expression.slice = lambda self, start, end=None: _TypeDispatch(
    self, {"list": ("list", "slice"), "binary": ("binary", "slice")}, "slice", start, end)
Expression.concat = lambda self, other: _TypeDispatch(
    self, {"string": ("str", "concat"), "binary": ("binary", "concat")}, "concat", other)


class Unnest(Expression):
    """A struct column's fields as columns, expanded by ``select`` (the
    reference's expressions.py:1680-1700)."""

    def __init__(self, child: Expression):
        self.child = child

    def name(self) -> str:
        return self.child.name()

    def children(self):
        return [self.child]

    def with_children(self, children):
        return Unnest(children[0])

    def to_field(self, schema: Schema) -> Field:
        raise ValueError("unnest() can only be used directly inside select()")


Expression.unnest = lambda self: Unnest(self)


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
    if isinstance(v, (bytes, bytearray)):
        return DataType.binary()
    if isinstance(v, decimal.Decimal):
        from ..core.decimal import literal_type

        return literal_type(v)
    if isinstance(v, datetime.datetime):
        # the reference's naming: tzname(None), which is None for a ZoneInfo
        # zone and "UTC+hh:mm" for a fixed offset
        return DataType.timestamp("us", v.tzinfo.tzname(None) if v.tzinfo else None)
    if isinstance(v, datetime.date):
        return DataType.date()
    if isinstance(v, datetime.timedelta):
        return DataType.duration("us")
    if isinstance(v, datetime.time):
        return DataType.python()
    if isinstance(v, (list, tuple)):
        # a host-only value (utf8_count_matches' patterns)
        return DataType.list(_infer_literal_dtype(v[0]) if v else DataType.null())
    if isinstance(v, np.ndarray):
        # an array is a fixed-shape tensor (expressions.py:1158-1160)
        return DataType.fixed_shape_tensor(DataType.from_numpy(v.dtype), v.shape)
    raise TypeError(f"unsupported literal {v!r}")


def _numeric_promote(a: DataType, b: DataType) -> DataType:
    return DataType.from_numpy(np.promote_types(a.to_numpy(), b.to_numpy()))


def _arith_result_type(op: str, l: DataType, r: DataType) -> DataType:
    if op == "add" and l.is_string() and r.is_string():
        return DataType.string()
    if op == "div":
        if all(t.is_numeric() or t.is_decimal() for t in (l, r)):
            return DataType.float64()
        raise ValueError(f"cannot divide {l} by {r}")
    if op == "pow":
        return DataType.float64()
    if l.is_temporal() or r.is_temporal():
        return _temporal_arith_type(op, l, r)
    if l.is_null():
        return r
    if r.is_null():
        return l
    if l.is_decimal() or r.is_decimal():
        # the reference's rule (expressions.py:1185-1186): the decimal operand's type
        if not all(t.is_decimal() or t.is_numeric() for t in (l, r)):
            raise ValueError(f"arith op {op!r} unsupported between {l} and {r}")
        return l if l.is_decimal() else r
    if not (l.is_numeric() and r.is_numeric()):
        raise ValueError(f"arith op {op!r} unsupported between {l} and {r}")
    return _numeric_promote(l, r)


def _temporal_arith_type(op: str, l: DataType, r: DataType) -> DataType:
    """The reference's temporal arithmetic (expressions.py:1191-1210), with
    the unit Arrow gives the values: the finer of the operands' units, and a
    date plus or minus a duration a timestamp."""
    lk, rk = l.kind, r.kind
    if op == "sub":
        if lk == "timestamp" and rk == "timestamp":
            return DataType.duration(finer_unit(l.time_unit, r.time_unit))
        if lk == "date" and rk == "date":
            return DataType.duration("s")
        if lk == "timestamp" and rk == "duration":
            return DataType.timestamp(finer_unit(l.time_unit, r.time_unit), l.timezone)
        if lk == "date" and rk == "duration":
            return DataType.timestamp(finer_unit("s", r.time_unit))
    if op == "add":
        if lk == "timestamp" and rk == "duration":
            return DataType.timestamp(finer_unit(l.time_unit, r.time_unit), l.timezone)
        if lk == "duration" and rk == "timestamp":
            return DataType.timestamp(finer_unit(l.time_unit, r.time_unit), r.timezone)
        if lk == "date" and rk == "duration":
            return DataType.timestamp(finer_unit("s", r.time_unit))
        if lk == "duration" and rk == "duration":
            return DataType.duration(finer_unit(l.time_unit, r.time_unit))
    raise ValueError(f"temporal arithmetic {op!r} unsupported between {l} and {r}")


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
