"""Compile Expression trees into torch functions over (values, validity) pairs
(counterpart of daft_tpu/ops/device_eval.py).

The device half of expression evaluation (host half: expressions/eval.py).
``build_device_expr`` returns ``fn(cols, device) -> (values, validity)`` over
a dict of column tensors; the grouped stage (ops/grouped_stage.py) calls it
for the predicate and every aggregation child of a stage.

Null semantics mirror the host kernels: validity propagates through
arithmetic and comparisons, and/or are Kleene, xor is null where either
side is, division and mod by zero are null, a null IfElse predicate gives
null, ``IsIn`` and ``eq_null_safe`` are never null, ``fill_nan`` replaces
only valid NaNs. The device functions are the registry's
(functions/registry.py ``device=``), the float ones computed in the
stage's float type. An integer floordiv goes through f64 whatever the
stage's float type, as the host's does, so it is exact where the host is. Padding rows ride along as invalid and are
masked out at aggregation. Literals are 0-d tensors that broadcast against
the columns; where a result must have the bucket's shape the caller expands
it (torch does not grow a 0-d mask the way jnp's ``&`` with a shaped array
does for the value side).

Binary operands are promoted explicitly with ``torch.promote_types``: torch's
own rule lets a 1-d int32 column win over a 0-d int64 literal, which would
compare a wide literal in int32.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..datatype import DataType
from ..expressions.expressions import (
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
from ..schema import Schema

# (values, validity) pair; validity is bool[n] (or 0-d for a literal)
DCol = Tuple[torch.Tensor, torch.Tensor]

_FLOATS = (torch.float32, torch.float64)
_BINARY_OPS = ("add", "sub", "mul", "div", "floordiv", "mod", "pow", "eq", "neq", "lt",
               "le", "gt", "ge", "and", "or", "xor", "fill_null", "eq_null_safe")
_UNARY_OPS = ("not", "neg", "abs", "is_null", "not_null")


def is_device_evaluable(expr: Expression, schema: Schema) -> bool:
    """True if the whole expression tree can run on the device for this
    input schema (the reference's qualification rule over the port's IR)."""
    try:
        out_dt = expr.to_field(schema).dtype
    except (KeyError, ValueError, TypeError):  # untypeable = not device-evaluable
        return False
    if not _dtype_on_device(out_dt):
        return False
    for node in expr.walk():
        if isinstance(node, ColumnRef):
            if not _dtype_on_device(schema[node._name].dtype):
                return False
        elif isinstance(node, Literal):
            dt = node.dtype
            if not (dt.is_numeric() or dt.is_boolean() or dt.is_null()
                    or dt.is_temporal()):
                return False
        elif isinstance(node, (Alias, IfElse)):
            pass
        elif isinstance(node, IsIn):
            # the items are a value set (the host's semantics): literals only
            if not all(isinstance(i, Literal) for i in node.items):
                return False
        elif isinstance(node, Function):
            from ..functions.registry import has_function, get_function

            if not has_function(node.fname) or get_function(node.fname).device is None:
                return False
        elif isinstance(node, Between):
            if not _temporal_operands_aligned([node.child, node.lower, node.upper], schema):
                return False
        elif isinstance(node, Cast):
            if not _dtype_on_device(node.dtype):
                return False
        elif isinstance(node, BinaryOp):
            if node.op not in _BINARY_OPS:
                return False
            if not _temporal_operands_aligned([node.left, node.right], schema):
                return False
        elif isinstance(node, UnaryOp):
            if node.op not in _UNARY_OPS:
                return False
        elif isinstance(node, AggExpr):
            if node.op not in ("sum", "mean", "min", "max", "count"):
                return False
        else:
            return False
    return True


def _dtype_on_device(dt: DataType) -> bool:
    # uint64 has no torch device type (the reference keeps it on the device)
    return ((dt.is_numeric() and dt.kind != "uint64") or dt.is_boolean()
            or dt.is_temporal())


def _temporal_operands_aligned(exprs, schema: Schema) -> bool:
    """Temporal values live on the device as raw storage ints (days), so every
    temporal operand of one operation must have the identical dtype."""
    dts = []
    for e in exprs:
        try:
            dts.append(e.to_field(schema).dtype)
        except (KeyError, ValueError, TypeError):
            return False
    temporal = [dt for dt in dts if dt.is_temporal()]
    return all(dt == temporal[0] for dt in temporal)


def needs_f64(exprs, schema: Schema) -> bool:
    """Whether a stage program over ``exprs`` (None entries skipped) keeps
    its floats in f64 whatever its aggregates: a float rounded to decimals
    scales by 10^d, and a decimal tie (x.x5) falls on either side of it once
    the column is rounded to f32, so the round would differ from the host's
    on a tenth of such rows (the reference's f32 stage rounds in f32)."""
    from ..expressions.expressions import Function

    for e in exprs:
        if e is None:
            continue
        for node in e.walk():
            if isinstance(node, Function) and node.fname == "round" \
                    and int(node.kwargs.get("decimals", 0)) != 0 \
                    and node.args[0].to_field(schema).dtype.is_floating():
                return True
    return False


def build_device_expr(expr: Expression, schema: Schema,
                      float_dtype: torch.dtype = torch.float64
                      ) -> Callable[[Dict[str, DCol], torch.device], DCol]:
    """Return fn(cols, device) -> (values, validity).

    ``float_dtype`` is the device float compute dtype; the grouped stage
    passes float32, as the reference's stage compilers do."""
    fdt = float_dtype

    def fcast(v):
        return v.to(fdt) if v.dtype in _FLOATS and v.dtype != fdt else v

    def ev(node: Expression, cols: Dict[str, DCol], device) -> DCol:
        if isinstance(node, ColumnRef):
            v, m = cols[node._name]
            return fcast(v), m
        if isinstance(node, Literal):
            if node.value is None:
                return (torch.zeros((), dtype=fdt, device=device),
                        torch.zeros((), dtype=torch.bool, device=device))
            dt = node.dtype.to_torch()
            if dt in _FLOATS:
                dt = fdt
            # a date literal becomes int32 days, as the column stores it
            return (torch.tensor(node.storage_value(), dtype=dt, device=device),
                    torch.ones((), dtype=torch.bool, device=device))
        if isinstance(node, Alias):
            return ev(node.child, cols, device)
        if isinstance(node, Cast):
            v, m = ev(node.child, cols, device)
            target = node.dtype.to_torch()
            if target in _FLOATS:
                target = fdt
            return v.to(target), m
        if isinstance(node, UnaryOp):
            v, m = ev(node.child, cols, device)
            if node.op == "not":
                return ~v.bool(), m
            if node.op == "neg":
                return -v, m
            if node.op == "abs":
                return v.abs(), m
            if node.op in ("is_null", "not_null"):
                val = _broadcast_valid(v, ~m if node.op == "is_null" else m)
                return val, torch.ones_like(val)
            raise ValueError(node.op)
        if isinstance(node, BinaryOp):
            lv, lm = ev(node.left, cols, device)
            rv, rm = ev(node.right, cols, device)
            return _binop(node.op, lv, lm, rv, rm, fdt)
        if isinstance(node, Between):
            # the host's Kleene (child >= lower) & (child <= upper)
            return ev(node.as_comparisons(), cols, device)
        if isinstance(node, IsIn):
            # never null: a null row is true only where the items hold a null
            v, m = ev(node.child, cols, device)
            acc = torch.zeros(v.shape, dtype=torch.bool, device=v.device)
            has_null = torch.zeros((), dtype=torch.bool, device=v.device)
            for item in node.items:
                iv, im = ev(item, cols, device)
                a, b = _promote_pair(v, iv)
                eq = a == b
                if a.dtype.is_floating_point:
                    # Arrow's hashing terms: -0.0 is not 0.0, NaN is NaN
                    eq = (eq & (torch.signbit(a) == torch.signbit(b))) | (a.isnan() & b.isnan())
                acc = acc | (eq & im)
                has_null = has_null | ~im
            val = torch.where(m, acc, has_null)
            return val, torch.ones_like(val)
        if isinstance(node, Function):
            from ..functions.registry import get_function

            pairs = [ev(a, cols, device) for a in node.args]
            return get_function(node.fname).device(pairs, node.kwargs, fdt)
        if isinstance(node, IfElse):
            pv, pm = ev(node.predicate, cols, device)
            tv, tm = ev(node.if_true, cols, device)
            fv, fm = ev(node.if_false, cols, device)
            cond = pv.bool()
            tv, fv = _promote_pair(tv, fv)
            val = torch.where(cond, tv, fv)
            ones = torch.ones_like(cond)
            # null predicate -> null (the host's if_else semantics)
            valid = pm & torch.where(cond, tm & ones, fm & ones)
            return val, valid
        raise ValueError(f"not device-evaluable: {type(node).__name__}")

    def run(cols: Dict[str, DCol], device) -> DCol:
        return ev(expr, cols, device)

    return run


def _promote_pair(a: torch.Tensor, b: torch.Tensor):
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)


def _broadcast_valid(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The validity mask at the shape of the values."""
    if m.shape != v.shape:
        return m & torch.ones(v.shape, dtype=torch.bool, device=v.device)
    return m


def _binop(op: str, lv, lm, rv, rm, fdt=torch.float64) -> DCol:
    if op in ("add", "sub", "mul"):
        a, b = _promote_pair(lv, rv)
        val = {"add": torch.add, "sub": torch.sub, "mul": torch.mul}[op](a, b)
        return val, _broadcast_valid(val, lm & rm)
    if op == "div":
        lvf, rvf = lv.to(fdt), rv.to(fdt)
        val = lvf / torch.where(rv == 0, torch.ones_like(rvf), rvf)
        return val, _broadcast_valid(val, lm & rm & (rv != 0))
    if op == "floordiv":
        ints = not lv.dtype.is_floating_point and not rv.dtype.is_floating_point
        wdt = torch.float64 if ints else fdt
        lvf, rvf = lv.to(wdt), rv.to(wdt)
        q = torch.floor(lvf / torch.where(rv == 0, torch.ones_like(rvf), rvf))
        if ints:
            out = torch.promote_types(lv.dtype, rv.dtype)
            info = torch.iinfo(out)
            q = torch.where(torch.isfinite(q), q.clamp(info.min, info.max), 0.0).to(out)
        return q, _broadcast_valid(q, lm & rm & (rv != 0))
    if op == "mod":
        a, b = _promote_pair(lv, rv)
        zero = b == 0
        val = torch.remainder(a, torch.where(zero, torch.ones_like(b), b))
        return val, _broadcast_valid(val, lm & rm & ~zero)
    if op == "pow":
        val = torch.pow(lv.to(fdt), rv.to(fdt))
        return val, _broadcast_valid(val, lm & rm)
    if op == "xor":
        val = lv.bool() ^ rv.bool()
        return val, _broadcast_valid(val, lm & rm)
    if op == "fill_null":
        a, b = _promote_pair(lv, rv)
        val = torch.where(lm, a, b)
        return val.to(lv.dtype), _broadcast_valid(val, lm | rm)
    if op == "eq_null_safe":
        a, b = _promote_pair(lv, rv)
        both = lm & rm
        val = torch.where(both, a == b, ~(lm ^ rm))
        val = _broadcast_valid(val, val)
        return val, torch.ones_like(val)
    if op in ("eq", "neq", "lt", "le", "gt", "ge"):
        a, b = _promote_pair(lv, rv)
        val = {"eq": torch.eq, "neq": torch.ne, "lt": torch.lt, "le": torch.le,
               "gt": torch.gt, "ge": torch.ge}[op](a, b)
        return val, _broadcast_valid(val, lm & rm)
    if op == "and":
        lb, rb = lv.bool(), rv.bool()
        val = lb & rb
        # Kleene: false AND anything = false (valid); null only if both maybe-true
        valid = (lm & rm) | (lm & ~lb) | (rm & ~rb)
        return val & valid, _broadcast_valid(val, valid)
    if op == "or":
        lb, rb = lv.bool(), rv.bool()
        val = (lb & lm) | (rb & rm)
        valid = (lm & rm) | (lm & lb) | (rm & rb)
        return val, _broadcast_valid(val, valid)
    raise ValueError(f"unsupported device binop {op!r}")


# ---- whole-column (ungrouped) aggregation on the device -----------------------------


def device_agg(op: str, v: torch.Tensor, m: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Aggregate a masked column to one value: (value, valid) 0-d tensors
    (counterpart of the reference's ``device_agg``, whose XLA reductions
    become torch's). ``m`` has the values' shape.

    count is int64; a sum accumulates floats in f64 (an f32 stage's values
    widened) and bools and integers in int64, which wraps mod 2^64 as the
    reference's does; a mean is the f64 sum over the count. A float min/max
    takes the host path's terms (``_float_extreme_all``)."""
    count = m.sum()
    if op == "count":
        return count, torch.ones((), dtype=torch.bool, device=v.device)
    valid = count > 0
    if op == "sum":
        if v.dtype.is_floating_point:
            return torch.where(m, v.to(torch.float64), 0.0).sum(), valid
        return torch.where(m, v.to(torch.int64), 0).sum(), valid
    if op == "mean":
        s = torch.where(m, v.to(torch.float64), 0.0).sum()
        return s / count.clamp(min=1), valid
    if op in ("min", "max"):
        if v.dtype.is_floating_point:
            return _float_extreme_all(op, v.to(torch.float64), m), valid
        info = torch.iinfo(torch.int64)
        w = torch.where(m, v.to(torch.int64), info.max if op == "min" else info.min)
        return (w.amin() if op == "min" else w.amax()), valid
    raise ValueError(f"no device agg {op!r}")


def _float_extreme_all(op: str, v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The f64 min/max of the valid values on the host path's terms
    (native.py ``native_grouped_minmax``, and ``_agg_columns`` for
    the ungrouped all-NaN case): NaN left out of the reduction, then the
    sign of the first zero row put on a zero result."""
    ok = m & ~torch.isnan(v)
    big = float("inf") if op == "min" else float("-inf")
    w = torch.where(ok, v, big)
    val = w.amin() if op == "min" else w.amax()
    zero = ok & (v == 0)
    rows = torch.arange(v.shape[0], device=v.device)
    first = torch.where(zero, rows, v.shape[0]).amin().clamp(max=v.shape[0] - 1)
    val = torch.where((val == 0) & zero.any(), torch.copysign(torch.zeros_like(val), v[first]),
                      val)
    return torch.where(m.any() & ~ok.any(), float("nan"), val)
