"""Host expression evaluation over RecordBatch, in numpy (counterpart of
daft_tpu/expressions/eval.py).

Returns Series; literals evaluate to length-1 Series that broadcast through
the kernels and expand at projection boundaries. Null semantics follow the
reference's Arrow kernels: validity propagates through arithmetic and
comparisons, division by zero is null, and/or are Kleene, and a null
IfElse predicate gives null. ``is_in`` is never null: a null row is true
only when the item values hold a null (Arrow's ``is_in`` followed by
``fill_null(False)``, as the reference evaluates it). The string and date
functions are null on a null row, as Arrow's kernels. A UDF call runs its
function on the host (udf/expr.py ``UdfCall.eval_host``).
"""

from __future__ import annotations

import re
from typing import List

import numpy as np

from ..core.series import Series, _null_fill
from ..datatype import DataType
from ..schema import Schema
from .expressions import (
    ARITH_OPS,
    COMPARISON_OPS,
    AggExpr,
    Alias,
    Between,
    BinaryOp,
    Cast,
    ColumnRef,
    Expression,
    Function,
    IfElse,
    IsIn,
    Literal,
    UnaryOp,
)

_CMP = {"eq": np.equal, "neq": np.not_equal, "lt": np.less, "le": np.less_equal,
        "gt": np.greater, "ge": np.greater_equal}
_ARITH = {"add": np.add, "sub": np.subtract, "mul": np.multiply}


def eval_expression(batch, expr: Expression) -> Series:
    """Evaluate to a Series of batch.num_rows rows (or 1 row for pure literals)."""
    if isinstance(expr, ColumnRef):
        return batch.get_column(expr._name)
    if isinstance(expr, Literal):
        return Series.from_pylist([expr.value], "literal", expr.dtype)
    if isinstance(expr, Alias):
        return eval_expression(batch, expr.child).rename(expr._alias)
    if isinstance(expr, Cast):
        return eval_expression(batch, expr.child).cast(expr.dtype)
    if isinstance(expr, UnaryOp):
        s = eval_expression(batch, expr.child)
        v, m = s.to_numpy(), s.validity_numpy()
        if expr.op == "not":
            return _make(s.name, DataType.bool(), ~v.astype(bool), m)
        if expr.op == "neg":
            return _make(s.name, s.dtype, -v, m)
        if expr.op == "is_null":
            return _make(s.name, DataType.bool(), ~m, np.ones(len(m), dtype=bool))
        if expr.op == "not_null":
            return _make(s.name, DataType.bool(), m.copy(), np.ones(len(m), dtype=bool))
        raise ValueError(f"unknown unary op {expr.op!r}")
    if isinstance(expr, BinaryOp):
        l = eval_expression(batch, expr.left)
        r = eval_expression(batch, expr.right)
        out_dt = expr.to_field(batch.schema).dtype
        return _binop(expr.op, l, r, out_dt).rename(expr.name())
    if isinstance(expr, IfElse):
        p = eval_expression(batch, expr.predicate)
        t = eval_expression(batch, expr.if_true)
        f = eval_expression(batch, expr.if_false)
        out_dt = expr.to_field(batch.schema).dtype
        cond = p.to_numpy().astype(bool)
        val = np.where(cond, _values_as(t, out_dt), _values_as(f, out_dt))
        valid = p.validity_numpy() & np.where(cond, t.validity_numpy(), f.validity_numpy())
        return _make(expr.name(), out_dt, val, valid)
    if isinstance(expr, Between):
        return eval_expression(batch, expr.as_comparisons()).rename(expr.name())
    if isinstance(expr, IsIn):
        return _is_in(eval_expression(batch, expr.child),
                      [eval_expression(batch, i) for i in expr.items])
    if isinstance(expr, Function):
        return _function(expr, eval_expression(batch, expr.args[0]))
    if isinstance(expr, AggExpr):
        raise ValueError(f"aggregation expression {expr!r} cannot be evaluated in a "
                         "projection context; use .agg()/groupby")
    from ..udf.expr import UdfCall

    if isinstance(expr, UdfCall):
        return expr.eval_host([eval_expression(batch, a) for a in expr.args], batch.num_rows)
    raise ValueError(f"cannot evaluate expression node {type(expr).__name__}")


def _is_in(s: Series, items: List[Series]) -> Series:
    """Membership of each row of ``s`` in the values of ``items``. A string
    column goes through its cached dictionary codes (one lookup table over
    the distinct values), so a repeated predicate over a resident column
    costs one gather."""
    targets = set()
    has_null = False
    for it in items:
        for v, ok in zip(it.to_numpy().tolist(), it.validity_numpy().tolist()):
            if ok:
                targets.add(v)
            else:
                has_null = True
    valid = s.validity_numpy()
    if s.dtype.is_string():
        codes, vocab, _k = s.dict_codes()
        lut = np.array([(v in targets) if v is not None else has_null for v in vocab],
                       dtype=bool)
        hit = lut[codes] if len(codes) else np.zeros(0, dtype=bool)
    else:
        vals = s.to_numpy()
        hit = np.isin(vals, np.asarray(list(targets))) \
            if targets and not s.dtype.is_null() else np.zeros(len(s), dtype=bool)
        hit = np.where(valid, hit, has_null)
    return _make(s.name, DataType.bool(), hit, np.ones(len(s), dtype=bool))


def _function(expr: Function, s: Series) -> Series:
    """A scalar function; a null row gives null. The string functions map
    the column's cached dictionary (one call per distinct value) and gather
    through its codes; ``dt_year`` reads the days as numpy dates."""
    if expr.fname == "dt_year":
        years = s.to_numpy().astype("datetime64[D]").astype("datetime64[Y]")
        return _make(s.name, DataType.int32(), years.astype(np.int32) + 1970,
                     s.validity_numpy())
    arg = expr.args[1].value
    codes, vocab, _k = s.dict_codes()
    if expr.fname in ("utf8_left", "utf8_substr"):
        if expr.fname == "utf8_left":
            cut = slice(0, max(arg, 0))
        else:  # Arrow's utf8_slice_codeunits(start, start + length)
            length = expr.args[2].value if len(expr.args) > 2 else None
            cut = slice(arg, None if length is None else arg + length)
        mapped = np.empty(len(vocab), dtype=object)
        mapped[:] = [v[cut] if v is not None else None for v in vocab]
        out = mapped[codes] if len(codes) else np.empty(0, dtype=object)
        return _make(s.name, DataType.string(), out, s.validity_numpy())
    if expr.fname == "utf8_like":
        rx = _like_regex(arg)
        test = lambda v, _pat: rx.match(v) is not None  # noqa: E731
    else:
        test = {"utf8_startswith": str.startswith, "utf8_endswith": str.endswith,
                "utf8_contains": str.__contains__}[expr.fname]
    lut = np.array([v is not None and test(v, arg) for v in vocab], dtype=bool)
    hit = lut[codes] if len(codes) else np.zeros(0, dtype=bool)
    return _make(s.name, DataType.bool(), hit, s.validity_numpy())


def _like_regex(pattern: str):
    """SQL LIKE as an anchored regex: ``%`` any run, ``_`` one character,
    everything else literal."""
    parts = [".*" if ch == "%" else "." if ch == "_" else re.escape(ch) for ch in pattern]
    return re.compile("^" + "".join(parts) + "$")


def _values_as(s: Series, dtype: DataType) -> np.ndarray:
    v = s.to_numpy()
    if s.dtype.is_null():
        return np.full(len(v), _null_fill(dtype), dtype=dtype.to_numpy())
    target = dtype.to_numpy()
    return v if v.dtype == target else v.astype(target)


def _make(name: str, dtype: DataType, values, valid) -> Series:
    values = np.asarray(values)
    valid = np.broadcast_to(np.asarray(valid, dtype=bool), values.shape).copy()
    if not valid.all() and values.dtype != object:
        values = np.where(valid, values, values.dtype.type(_null_fill(dtype)))
    return Series(name, dtype, values, valid)


def _binop(op: str, l: Series, r: Series, out_dt: DataType) -> Series:
    lm, rm = l.validity_numpy(), r.validity_numpy()
    if op in ARITH_OPS:
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            if op == "div":
                lv = _values_as(l, DataType.float64())
                rv = _values_as(r, DataType.float64())
                zero = rv == 0
                val = lv / np.where(zero, 1.0, rv)
                return _make(l.name, out_dt, val, lm & rm & ~zero)
            val = _ARITH[op](_values_as(l, out_dt), _values_as(r, out_dt))
        return _make(l.name, out_dt, val, lm & rm)
    if op in COMPARISON_OPS:
        if l.dtype.is_null() or r.dtype.is_null():
            n = max(len(l), len(r))
            return _make(l.name, DataType.bool(), np.zeros(n, bool), np.zeros(n, bool))
        lv, rv = l.to_numpy(), r.to_numpy()
        if lv.dtype == object or rv.dtype == object:
            # strings: null slots hold None, which does not order against str
            lv = np.where(lm, lv, "")
            rv = np.where(rm, rv, "")
        return _make(l.name, DataType.bool(), _CMP[op](lv, rv), lm & rm)
    if op in ("and", "or"):
        lb = l.to_numpy().astype(bool) if not l.dtype.is_null() else np.zeros(len(l), bool)
        rb = r.to_numpy().astype(bool) if not r.dtype.is_null() else np.zeros(len(r), bool)
        if op == "and":
            valid = (lm & rm) | (lm & ~lb) | (rm & ~rb)
            return _make(l.name, DataType.bool(), lb & rb & valid, valid)
        valid = (lm & rm) | (lm & lb) | (rm & rb)
        return _make(l.name, DataType.bool(), (lb & lm) | (rb & rm), valid)
    raise ValueError(f"unknown binary op {op!r}")


def eval_projection(batch, exprs: List[Expression]):
    """Project: evaluate expressions and assemble an output RecordBatch,
    broadcasting length-1 results to the batch length."""
    from ..core.recordbatch import RecordBatch

    n = batch.num_rows
    out: List[Series] = []
    for e in exprs:
        s = eval_expression(batch, e)
        if len(s) == 1 and n != 1:
            s = s.broadcast(n)
        elif len(s) != n:
            raise ValueError(f"projection result {e!r} has {len(s)} rows, expected {n}")
        out.append(s)
    names = [s.name for s in out]
    if len(set(names)) != len(names):
        dupes = sorted({x for x in names if names.count(x) > 1})
        raise ValueError(f"duplicate output column names in projection: {dupes}; use .alias()")
    return RecordBatch(Schema([s.field() for s in out]), out, n)
