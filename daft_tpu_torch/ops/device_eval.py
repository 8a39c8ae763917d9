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

Temporal values live on the device as their storage ints (int32 days,
int64 ticks of a unit). Where two temporal operands of different types meet,
or a cast changes the type, the device rescales the ints as the host's
``Series.cast`` does (``core/temporal.common_temporal_type`` and
``widen_factor``); a cast that reads a zone, could lose ticks or would raise
stays on the host.

Binary operands are promoted explicitly with ``torch.promote_types``: torch's
own rule lets a 1-d int32 column win over a 0-d int64 literal, which would
compare a wide literal in int32.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..core.temporal import common_temporal_type, unit_type, widen_factor
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
_COMPARISONS = ("eq", "neq", "lt", "le", "gt", "ge", "eq_null_safe")


def is_device_evaluable(expr: Expression, schema: Schema) -> bool:
    """True if the whole expression tree can run on the device for this
    input schema (the reference's qualification rule over the port's IR,
    with the temporal casts and meetings the device cannot rescale left
    on the host)."""
    try:
        return _dtype_on_device(expr.to_field(schema).dtype) \
            and all(_node_on_device(node, schema) for node in expr.walk())
    except (KeyError, ValueError, TypeError):  # untypeable = not device-evaluable
        return False


def has_nested_operand(expr: Expression, schema: Schema) -> bool:
    """Whether any node of ``expr`` reads or makes a nested, binary or
    ``python`` value: the device holds none (a stage never sees such a
    column)."""
    try:
        for node in expr.walk():
            dt = node.to_field(schema).dtype
            if dt.is_nested() or dt.is_binary() or dt.kind == "python":
                return True
    except (KeyError, ValueError, TypeError):
        return False
    return False


def _node_on_device(node: Expression, schema: Schema) -> bool:
    if isinstance(node, ColumnRef):
        return _dtype_on_device(schema[node._name].dtype)
    if isinstance(node, Literal):
        dt = node.dtype
        return dt.is_numeric() or dt.is_boolean() or dt.is_null() or dt.is_temporal()
    if isinstance(node, Alias):
        return True
    if isinstance(node, IfElse):
        return _temporal_operands_aligned([node.if_true, node.if_false], schema)
    if isinstance(node, IsIn):
        # the items are a value set (the host's semantics): literals only
        if not all(isinstance(i, Literal) for i in node.items):
            return False
        child_dt = node.child.to_field(schema).dtype
        for item in node.items:
            _isin_item_value(item, child_dt)  # raises where the host's cast would
        return True
    if isinstance(node, Function):
        from ..functions.registry import has_function, get_function

        return has_function(node.fname) and get_function(node.fname).device is not None
    if isinstance(node, Between):
        return is_device_evaluable(node.as_comparisons(), schema)
    if isinstance(node, Cast):
        return _dtype_on_device(node.dtype) \
            and _cast_how(node.child.to_field(schema).dtype, node.dtype) is not None
    if isinstance(node, BinaryOp):
        return node.op in _BINARY_OPS and _meet(
            node.op, node.left.to_field(schema).dtype, node.right.to_field(schema).dtype,
            node.to_field(schema).dtype) is not None
    if isinstance(node, UnaryOp):
        return node.op in _UNARY_OPS
    if isinstance(node, AggExpr):
        return node.op in ("sum", "mean", "min", "max", "count")
    return False


def _dtype_on_device(dt: DataType) -> bool:
    # uint64 has no torch device type (the reference keeps it on the device)
    return ((dt.is_numeric() and dt.kind != "uint64") or dt.is_boolean()
            or dt.is_temporal())


def _temporal_operands_aligned(exprs, schema: Schema) -> bool:
    """Whether every temporal operand of one operation has the identical
    dtype (the branches of an if_else, which the device does not rescale)."""
    dts = []
    for e in exprs:
        try:
            dts.append(e.to_field(schema).dtype)
        except (KeyError, ValueError, TypeError):
            return False
    temporal = [dt for dt in dts if dt.is_temporal()]
    return all(dt == temporal[0] for dt in temporal)


def _meet(op: str, ldt: DataType, rdt: DataType, out_dt: DataType):
    """The types the device brings the two operands of a binary op to before
    it applies it, as the host's do; None where it cannot. Temporal operands
    of different types meet in ``common_temporal_type`` for a comparison and
    in the result's unit for + and -; any other op needs equal types. A
    temporal operand against a number or a null is taken as it is stored,
    as on the host."""
    if ldt == rdt or not (ldt.is_temporal() and rdt.is_temporal()):
        return ldt, rdt
    if op in _COMPARISONS:
        t = common_temporal_type(ldt, rdt)
        return None if t is None else (t, t)
    if op in ("add", "sub") and out_dt.kind in ("timestamp", "duration"):
        return unit_type(ldt, out_dt.time_unit), unit_type(rdt, out_dt.time_unit)
    return None


def _cast_how(src: DataType, dst: DataType):
    """How the device casts ``src`` to ``dst`` where either is temporal:
    "scale" (times ``widen_factor``), "day" (a naive timestamp to its date,
    a floor division) or "plain" (the stored int as it is: an int64-stored
    temporal to int64, an integer or a null to a temporal, a date to a
    number); None where the host's cast reads a zone, could lose ticks,
    raises or writes text. Casts between other types are "plain"."""
    if src == dst or src.is_null() or not (src.is_temporal() or dst.is_temporal()):
        return "plain"
    if widen_factor(src, dst) is not None:
        return "scale"
    if src.kind == "timestamp" and dst.kind == "date" and src.timezone is None:
        return "day"
    if src.kind in ("timestamp", "duration", "time") and dst.kind == "int64":
        return "plain"
    if src.is_integer() and dst.is_temporal():
        return "plain"
    if src.kind == "date" and dst.is_numeric():
        return "plain"
    return None


def _widen(v: torch.Tensor, src: DataType, dst: DataType) -> torch.Tensor:
    if src == dst:
        return v
    return v.to(torch.int64) * widen_factor(src, dst)


def _isin_item_value(item: Literal, child_dt: DataType):
    """The stored value a temporal literal item of another type than the
    column compares as: the item cast to the column's type, as the host's
    is_in casts it (raising where the host's cast raises). None where the
    item is taken as it is."""
    dt = item.dtype
    if item.value is None or dt == child_dt or not (dt.is_temporal() and child_dt.is_temporal()):
        return None
    from ..core.series import Series

    s = Series("", dt, np.asarray([item.storage_value()], dtype=dt.to_numpy()),
               np.ones(1, dtype=bool))
    return s.cast(child_dt).to_numpy()[0].item()


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
    # per node of the tree, held with the node so that its id stays its own:
    # its dtype, and a Between's comparisons (made once, so that their ids last)
    dtypes: Dict[int, Tuple[Expression, DataType]] = {}
    lowered: Dict[int, Tuple[Between, Expression]] = {}

    def dtype_of(node: Expression) -> DataType:
        if id(node) not in dtypes:
            dtypes[id(node)] = (node, node.to_field(schema).dtype)
        return dtypes[id(node)][1]

    def comparisons(node: Between) -> Expression:
        if id(node) not in lowered:
            lowered[id(node)] = (node, node.as_comparisons())
        return lowered[id(node)][1]

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
            # a temporal literal becomes its storage int, as the column stores
            # it (int32 days, int64 ticks of the unit)
            return (torch.tensor(node.storage_value(), dtype=dt, device=device),
                    torch.ones((), dtype=torch.bool, device=device))
        if isinstance(node, Alias):
            return ev(node.child, cols, device)
        if isinstance(node, Cast):
            v, m = ev(node.child, cols, device)
            src = dtype_of(node.child)
            how = _cast_how(src, node.dtype)
            if how == "scale":
                return _widen(v, src, node.dtype), m
            if how == "day":
                per_day = widen_factor(DataType.date(), DataType.timestamp(src.time_unit))
                return torch.div(v, per_day, rounding_mode="floor").to(torch.int32), m
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
            ldt, rdt = dtype_of(node.left), dtype_of(node.right)
            if node.op == "sub" and ldt.kind == "date" and rdt.kind == "date":
                # date - date is a duration in seconds, as on the host
                return (lv.to(torch.int64) - rv.to(torch.int64)) * 86_400, \
                    _broadcast_valid(lv, lm & rm)
            tl, tr = _meet(node.op, ldt, rdt, dtype_of(node))
            return _binop(node.op, _widen(lv, ldt, tl), lm, _widen(rv, rdt, tr), rm, fdt)
        if isinstance(node, Between):
            # the host's Kleene (child >= lower) & (child <= upper)
            return ev(comparisons(node), cols, device)
        if isinstance(node, IsIn):
            # never null: a null row is true only where the items hold a null
            v, m = ev(node.child, cols, device)
            child_dt = dtype_of(node.child)
            acc = torch.zeros(v.shape, dtype=torch.bool, device=v.device)
            has_null = torch.zeros((), dtype=torch.bool, device=v.device)
            for item in node.items:
                cast = _isin_item_value(item, child_dt)
                if cast is None:
                    iv, im = ev(item, cols, device)
                else:
                    iv = torch.tensor(cast, dtype=v.dtype, device=device)
                    im = torch.ones((), dtype=torch.bool, device=device)
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
