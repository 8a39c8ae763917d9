"""Host expression evaluation over RecordBatch, in numpy (counterpart of
daft_tpu/expressions/eval.py).

Returns Series; literals evaluate to length-1 Series that broadcast through
the kernels and expand at projection boundaries. Null semantics follow the
reference's Arrow kernels: validity propagates through arithmetic and
comparisons, division by zero is null, and/or are Kleene, and a null
IfElse predicate gives null. ``is_in`` is never null: a null row is true
only when the item values hold a null (Arrow's ``is_in`` followed by
``fill_null(False)``, as the reference evaluates it). The reference's
``Series`` operators (daft_tpu/core/series.py:556-600) hold for the rest:
floordiv goes through f64 and is cast back to the common integer type,
mod is numpy's (the sign of the divisor) and null where the divisor is
0, pow is in f64, xor is null where either side is, ``eq_null_safe`` is
never null, ``fill_null`` keeps the left's type. A ``Function`` runs its
registry host kernel (functions/registry.py); a UDF call runs its
function on the host (udf/expr.py ``UdfCall.eval_host``).
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.series import Series, _null_fill
from ..core.temporal import common_temporal_type, unit_type
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
        if expr.op == "abs":
            return _make(s.name, s.dtype, np.abs(v), m)
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
        from ..functions.registry import get_function

        spec = get_function(expr.fname)
        args = [eval_expression(batch, a) for a in expr.args]
        kwargs = dict(expr.kwargs)
        if not args:
            kwargs["__num_rows"] = batch.num_rows
        return spec.host(args, kwargs).rename(expr.name())
    from .expressions import _TypeDispatch

    if isinstance(expr, _TypeDispatch):
        return eval_expression(batch, expr.resolve(batch.schema)).rename(expr.name())
    if isinstance(expr, AggExpr):
        raise ValueError(f"aggregation expression {expr!r} cannot be evaluated in a "
                         "projection context; use .agg()/groupby")
    from ..udf.expr import UdfCall

    if isinstance(expr, UdfCall):
        return expr.eval_host([eval_expression(batch, a) for a in expr.args], batch.num_rows)
    from .expressions import WindowExpr, _UnboundWindowFn

    if isinstance(expr, (WindowExpr, _UnboundWindowFn)):
        raise ValueError(f"window expression {expr!r} cannot be evaluated outside a window; "
                         "bind it with .over(Window(...)) in a select or with_column")
    raise ValueError(f"cannot evaluate expression node {type(expr).__name__}")


def _is_in(s: Series, items: List[Series]) -> Series:
    """Membership of each row of ``s`` in the values of ``items``, on
    Arrow's hashing terms: -0.0 is not 0.0, a NaN is every NaN. A string
    column goes through its cached dictionary codes (one lookup table over
    the distinct values), so a repeated predicate over a resident column
    costs one gather."""
    targets = set()
    has_null = False
    if s.dtype.is_temporal():
        # a datetime item is held in its literal's unit: compare in the column's
        items = [it.cast(s.dtype) if it.dtype.is_temporal() and it.dtype != s.dtype else it
                 for it in items]
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
        if not targets or s.dtype.is_null():
            hit = np.zeros(len(s), dtype=bool)
        elif vals.dtype.kind == "f":
            want = np.asarray([float(t) for t in targets], dtype=np.float64)
            hit = np.isin(vals.astype(np.float64).view(np.int64),
                          want[~np.isnan(want)].view(np.int64))
            if np.isnan(want).any():
                hit |= np.isnan(vals)
        else:
            hit = np.isin(vals, np.asarray(list(targets)))
        hit = np.where(valid, hit, has_null)
    return _make(s.name, DataType.bool(), hit, np.ones(len(s), dtype=bool))


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


_TICKS = ("timestamp", "duration")
# the binary ops core/decimal.py evaluates where an operand is a decimal
_DECIMAL_OPS = ("add", "sub", "mul", "div", "eq", "neq", "lt", "le", "gt", "ge")


def _incomparable(l: DataType, r: DataType) -> ValueError:
    if l.kind == r.kind == "timestamp":
        return ValueError("Cannot compare timestamp with timezone to timestamp without "
                          f"timezone, got: {l} and {r}")
    return ValueError(f"cannot compare {l} with {r}")


def _temporal_arith(op: str, l: Series, r: Series, out_dt: DataType) -> Series:
    """Temporal + and - (the types of expressions.py ``_temporal_arith_type``):
    the operands in the result's unit, a date as its midnight."""
    lm, rm = l.validity_numpy(), r.validity_numpy()
    unit = out_dt.time_unit
    if l.dtype.kind == "date" and r.dtype.kind == "date":
        lv, rv = l.to_numpy().astype(np.int64), r.to_numpy().astype(np.int64)
        return _make(l.name, out_dt, (lv - rv) * np.int64(86_400), lm & rm)
    lv = l.cast(unit_type(l.dtype, unit)).to_numpy()
    rv = r.cast(unit_type(r.dtype, unit)).to_numpy()
    with np.errstate(over="ignore"):
        val = lv + rv if op == "add" else lv - rv
    return _make(l.name, out_dt, val, lm & rm)


def _binop(op: str, l: Series, r: Series, out_dt: DataType) -> Series:
    if (l.dtype.is_decimal() or r.dtype.is_decimal()) and op in _DECIMAL_OPS \
            and not (l.dtype.is_null() or r.dtype.is_null()):
        from ..core.decimal import binop as decimal_binop

        return decimal_binop(op, l, r, out_dt)
    lm, rm = l.validity_numpy(), r.validity_numpy()
    if op in ("add", "sub") and out_dt.kind in _TICKS and not (
            l.dtype.is_null() or r.dtype.is_null()):
        return _temporal_arith(op, l, r, out_dt)
    if op == "add" and out_dt.is_string():
        n = max(len(l), len(r))
        lv = np.broadcast_to(l.to_numpy(), n)
        rv = np.broadcast_to(r.to_numpy(), n)
        valid = np.broadcast_to(lm, n) & np.broadcast_to(rm, n)
        out = np.empty(n, dtype=object)
        out[:] = [a + b if ok else None for a, b, ok in zip(lv, rv, valid.tolist())]
        return _make(l.name, out_dt, out, valid)
    if op in ARITH_OPS:
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            if op in ("div", "floordiv", "pow"):
                lv = _values_as(l, DataType.float64())
                rv = _values_as(r, DataType.float64())
                if op == "pow":
                    return _make(l.name, out_dt, np.power(lv, rv), lm & rm)
                zero = rv == 0
                val = lv / np.where(zero, 1.0, rv)
                if op == "floordiv":
                    val = np.floor(val)
                    if out_dt.is_integer():
                        # a quotient past the integer range stays in range
                        info = np.iinfo(out_dt.to_numpy())
                        val = np.where(np.isfinite(val), np.clip(val, info.min, info.max), 0)
                return _make(l.name, out_dt, val.astype(out_dt.to_numpy()), lm & rm & ~zero)
            if op == "mod":
                lv, rv = _values_as(l, out_dt), _values_as(r, out_dt)
                lv, rv = np.broadcast_arrays(lv, rv)
                zero = rv == 0
                val = np.mod(lv, rv, where=~zero, out=np.zeros(lv.shape, dtype=lv.dtype))
                return _make(l.name, out_dt, val, lm & rm & ~zero)
            val = _ARITH[op](_values_as(l, out_dt), _values_as(r, out_dt))
        return _make(l.name, out_dt, val, lm & rm)
    if op == "eq_null_safe":
        n = max(len(l), len(r))
        if l.dtype.is_null() or r.dtype.is_null():
            eq = np.zeros(n, dtype=bool)
        else:
            eq = _binop("eq", l, r, DataType.bool()).to_numpy()
        both = np.broadcast_to(lm, n) & np.broadcast_to(rm, n)
        neither = ~np.broadcast_to(lm, n) & ~np.broadcast_to(rm, n)
        return _make(l.name, DataType.bool(), np.where(both, eq, neither), np.ones(n, bool))
    if op == "fill_null":
        n = max(len(l), len(r))
        lv = np.broadcast_to(_values_as(l, out_dt), n)
        rv = np.broadcast_to(_values_as(r, out_dt), n)
        lmb = np.broadcast_to(lm, n)
        return _make(l.name, out_dt, np.where(lmb, lv, rv), lmb | np.broadcast_to(rm, n))
    if op in COMPARISON_OPS:
        if l.dtype.is_null() or r.dtype.is_null():
            n = max(len(l), len(r))
            return _make(l.name, DataType.bool(), np.zeros(n, bool), np.zeros(n, bool))
        lv, rv = l.to_numpy(), r.to_numpy()
        if l.dtype != r.dtype and l.dtype.is_temporal() and r.dtype.is_temporal():
            t = common_temporal_type(l.dtype, r.dtype)
            if t is None:
                raise _incomparable(l.dtype, r.dtype)
            lv, rv = l.cast(t).to_numpy(), r.cast(t).to_numpy()
        if lv.dtype == object or rv.dtype == object:
            # strings: null slots hold None, which does not order against str
            lv = np.where(lm, lv, "")
            rv = np.where(rm, rv, "")
        return _make(l.name, DataType.bool(), _CMP[op](lv, rv), lm & rm)
    if op == "xor":
        lb = l.to_numpy().astype(bool) if not l.dtype.is_null() else np.zeros(len(l), bool)
        rb = r.to_numpy().astype(bool) if not r.dtype.is_null() else np.zeros(len(r), bool)
        return _make(l.name, DataType.bool(), lb ^ rb, lm & rm)
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
