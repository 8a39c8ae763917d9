"""DECIMAL columns (the reference's ``decimal128(p, s)``, which it keeps in
pyarrow's decimal128 arrays).

Storage: an object array of Python ints, each value unscaled (value x
10^s), 0 in null slots; ``to_pylist`` gives ``decimal.Decimal`` at scale s.
Decimals stay on the host (the reference's device program refuses them).

Casts follow pyarrow's, which the reference calls: an integer column casts
only to a precision that holds its whole type (p - s at least 3, 5, 10, 19
or 20 digits for 8- to 64-bit integers), a float rounds half to even, a
string parses exactly; a value that would lose digits, or that does not
fit in p, raises ValueError (pyarrow's ArrowInvalid is a ValueError). A
decimal casts to a float, to an integer (when it has no fraction) and to a
string at its scale.

Arithmetic (``+``, ``-``, ``*``) with a decimal operand takes the type of
that operand (the reference's rule, expressions.py:1185-1186) and is
computed exactly, then cast to it; ``/`` gives a float64; comparisons
compare exact values.
"""

from __future__ import annotations

import decimal
from typing import List, Optional

import numpy as np

from ..datatype import DataType

MAX_PRECISION = 38
# the digits of each integer type (pyarrow's precision floor for its cast)
_INT_DIGITS = {"int8": 3, "uint8": 3, "int16": 5, "uint16": 5, "int32": 10, "uint32": 10,
               "int64": 19, "uint64": 20, "bool": None}
_CTX = decimal.Context(prec=200, rounding=decimal.ROUND_HALF_EVEN)


def check_type(precision: int, scale: int) -> None:
    """pyarrow's bounds: the precision in [1, 38]; any scale (one past the
    precision holds only values under 10^(p - s), as pyarrow's does)."""
    if not 1 <= precision <= MAX_PRECISION:
        raise ValueError(f"Decimal precision out of range [1, {MAX_PRECISION}]: {precision}")


def literal_type(v: decimal.Decimal) -> DataType:
    """The type of a Decimal literal (the reference's expressions.py:1145-1147)."""
    d = v.as_tuple()
    return DataType.decimal128(max(len(d.digits), 1), max(-d.exponent, 0))


def infer_type(values) -> DataType:
    """The type pyarrow infers for a list of Decimals: the largest scale,
    and the precision that holds every value at it."""
    scale = max((max(-v.as_tuple().exponent, 0) for v in values), default=0)
    whole = max((max(len(v.as_tuple().digits) + v.as_tuple().exponent, 0) for v in values),
                default=1)
    return DataType.decimal128(max(whole + scale, 1), scale)


def _fits(unscaled: int, precision: int) -> bool:
    return abs(unscaled) < 10 ** precision


def _unscale(v: decimal.Decimal, scale: int, precision: int) -> int:
    """``v`` as an unscaled int at ``scale``; raises where a digit would be
    lost or the value does not fit in ``precision``."""
    q = v.scaleb(scale, context=_CTX)
    i = int(q)
    if q != i:
        raise ValueError("Rescaling Decimal value would cause data loss")
    if not _fits(i, precision):
        raise ValueError(f"Decimal value does not fit in precision {precision}")
    return i


def to_double(unscaled: int, scale: int) -> float:
    """A decimal as pyarrow converts it to a float: the unscaled integer as
    a double times the double 10^-scale (so 847.06 at scale 2 becomes
    847.0600000000001, as the reference gives it)."""
    return float(unscaled) * (10.0 ** -scale) if scale else float(unscaled)


def exact(s) -> List[Optional[decimal.Decimal]]:
    """The exact value of each row of a decimal, integer, boolean or float
    Series (None for a null)."""
    valid = s.validity_numpy().tolist()
    kind = s.dtype.kind
    vals = s._values.tolist()
    if kind == "decimal128":
        scale = s.dtype.params[1]
        return [decimal.Decimal(v).scaleb(-scale) if ok else None
                for v, ok in zip(vals, valid)]
    if kind in ("float32", "float64"):
        return [decimal.Decimal(float(v)) if ok else None for v, ok in zip(vals, valid)]
    return [decimal.Decimal(int(v)) if ok else None for v, ok in zip(vals, valid)]


def to_pylist(values: np.ndarray, valid: np.ndarray, scale: int) -> list:
    return [decimal.Decimal(v).scaleb(-scale) if ok else None
            for v, ok in zip(values.tolist(), valid.tolist())]


def _object(ints: list) -> np.ndarray:
    out = np.empty(len(ints), dtype=object)
    out[:] = ints
    return out


def from_exact(name: str, values: List[Optional[decimal.Decimal]], dtype: DataType):
    """A decimal Series of exact values, cast to ``dtype`` with pyarrow's
    checks (a lost digit or an overflow raises)."""
    from .series import Series

    p, sc = dtype.params
    valid = np.array([v is not None for v in values], dtype=bool)
    ints = [_unscale(v, sc, p) if v is not None else 0 for v in values]
    return Series(name, dtype, _object(ints), valid)


def cast_to_decimal(s, dtype: DataType):
    """A Series of any numeric, boolean-free or string type cast to
    ``dtype`` (decimal128), as pyarrow casts."""
    from .series import Series

    p, sc = dtype.params
    src = s.dtype
    valid = s.validity_numpy()
    if src.kind == "decimal128":
        return from_exact(s.name, exact(s), dtype)
    if src.is_integer():
        need = _INT_DIGITS[src.kind] + sc
        if p < need:
            raise ValueError(f"Precision is not great enough for the result. It should be "
                             f"at least {need}")
        ints = [int(v) * 10 ** sc if ok else 0
                for v, ok in zip(s._values.tolist(), valid.tolist())]
        return Series(s.name, dtype, _object(ints), valid.copy())
    if src.is_floating():
        ints = []
        for v, ok in zip(s._values.tolist(), valid.tolist()):
            if not ok:
                ints.append(0)
                continue
            if not np.isfinite(v):
                raise ValueError(f"Cannot convert {v} to {dtype}")
            q = decimal.Decimal(float(v)).scaleb(sc, context=_CTX).to_integral_value(
                rounding=decimal.ROUND_HALF_EVEN)
            i = int(q)
            if not _fits(i, p):
                raise ValueError(f"Cannot convert {v:f} to Decimal128(precision = {p}, "
                                 f"scale = {sc}): overflow")
            ints.append(i)
        return Series(s.name, dtype, _object(ints), valid.copy())
    if src.is_string():
        parsed = []
        for v, ok in zip(s._values.tolist(), valid.tolist()):
            if not ok:
                parsed.append(None)
                continue
            try:
                if v != v.strip() or not v:
                    raise decimal.InvalidOperation
                d = decimal.Decimal(v)
                if not d.is_finite():
                    raise decimal.InvalidOperation
            except decimal.InvalidOperation:
                raise ValueError(f"The string '{v}' is not a valid decimal128 number") \
                    from None
            parsed.append(d)
        return from_exact(s.name, parsed, dtype)
    raise ValueError(f"Unsupported cast from {src} to {dtype}")


def cast_from_decimal(s, dtype: DataType):
    """A decimal Series cast to a float, an integer or a string type."""
    from .series import Series

    vals = exact(s)
    valid = s.validity_numpy().copy()
    if dtype.is_floating():
        scale = s.dtype.params[1]
        out = np.array([to_double(v, scale) if ok else 0.0
                        for v, ok in zip(s._values.tolist(), valid.tolist())],
                       dtype=dtype.to_numpy())
        return Series(s.name, dtype, out, valid)
    if dtype.is_integer():
        ints = []
        info = np.iinfo(dtype.to_numpy())
        for v in vals:
            if v is None:
                ints.append(0)
                continue
            i = int(v)
            if v != i:
                raise ValueError("Rescaling Decimal value would cause data loss")
            if not info.min <= i <= info.max:
                raise ValueError(f"Integer value {i} not in range: {info.min} to {info.max}")
            ints.append(i)
        return Series(s.name, dtype, np.array(ints, dtype=dtype.to_numpy()), valid)
    if dtype.is_string():
        return Series(s.name, dtype, _object([format(v, "f") if v is not None else None
                                              for v in vals]), valid)
    raise ValueError(f"Unsupported cast from {s.dtype} to {dtype}")


def _doubles(s, n: int) -> np.ndarray:
    """A Series as floats, a decimal as pyarrow converts it (to_double),
    broadcast to ``n`` rows."""
    if s.dtype.is_decimal():
        scale = s.dtype.params[1]
        out = np.array([to_double(v, scale) for v in s._values.tolist()], dtype=np.float64)
    else:
        out = s._values.astype(np.float64)
    return np.broadcast_to(out, (n,)) if len(out) == 1 and n != 1 else out


def binop(op: str, l, r, out_dt: DataType):
    """``l op r`` where an operand is a decimal: exact arithmetic cast to
    ``out_dt``, a float quotient, or a comparison of exact values."""
    from .series import Series

    n = max(len(l), len(r))
    lv, rv = exact(l), exact(r)
    if len(lv) == 1 and n != 1:
        lv = lv * n
    if len(rv) == 1 and n != 1:
        rv = rv * n
    if op in ("add", "sub", "mul"):
        fn = {"add": _CTX.add, "sub": _CTX.subtract, "mul": _CTX.multiply}[op]
        vals = [fn(a, b) if a is not None and b is not None else None
                for a, b in zip(lv, rv)]
        return from_exact(l.name, vals, out_dt)
    if op == "div":
        lf, rf = _doubles(l, n), _doubles(r, n)
        valid = np.array([a is not None and b is not None and b != 0
                          for a, b in zip(lv, rv)], dtype=bool)
        with np.errstate(divide="ignore", invalid="ignore"):
            vals = np.where(valid, lf / np.where(valid, rf, 1.0), 0.0)
        return Series(l.name, DataType.float64(), vals, valid)
    cmp = {"eq": lambda a, b: a == b, "neq": lambda a, b: a != b,
           "lt": lambda a, b: a < b, "le": lambda a, b: a <= b,
           "gt": lambda a, b: a > b, "ge": lambda a, b: a >= b}.get(op)
    if cmp is None:
        raise ValueError(f"the binary op {op!r} does not take a decimal operand")
    valid = np.array([a is not None and b is not None for a, b in zip(lv, rv)], dtype=bool)
    vals = np.array([bool(cmp(a, b)) if ok else False
                     for a, b, ok in zip(lv, rv, valid.tolist())], dtype=bool)
    return Series(l.name, DataType.bool(), vals, valid)


def reduce(op: str, s, group_ids: np.ndarray, g: int):
    """A grouped sum, min or max of a decimal column: (unscaled values,
    valid) per group, exactly, in Python ints."""
    vals = s._values.tolist()
    valid = s.validity_numpy().tolist()
    acc: list = [None] * g
    for v, ok, gi in zip(vals, valid, group_ids.tolist()):
        if not ok:
            continue
        cur = acc[gi]
        if cur is None:
            acc[gi] = v
        elif op == "sum":
            acc[gi] = cur + v
        elif op == "min":
            acc[gi] = v if v < cur else cur
        else:
            acc[gi] = v if v > cur else cur
    has = np.array([a is not None for a in acc], dtype=bool)
    return _object([a if a is not None else 0 for a in acc]), has
