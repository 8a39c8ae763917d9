"""The scalar function registry (counterpart of daft_tpu/functions/registry.py,
its ``extra.py`` and ``breadth.py``): the numeric and float functions, the
bitwise functions, the string functions, the temporal
functions over dates, timestamps, durations and times (functions/temporal.py),
and ``coalesce``, ``monotonically_increasing_id`` and ``uuid``.

Each ``FunctionSpec`` carries a return-type rule over the argument fields
and the options, a host kernel over Series (numpy and Python's ``re``,
``unicodedata`` and ``datetime``, giving the reference's pyarrow answers),
an optional check of the argument expressions, and, for the functions the
device program takes, a torch function: ``device(args, kwargs, fdt)`` over
the arguments' (values, validity) pairs, ``fdt`` the stage's float type
(ops/device_eval.py).

The nested-types wave (lists, structs, maps, binary, JSON, hashes, URLs,
compression, serialization, codecs and the Iceberg partitions) is in
functions/nested.py, the multimodal wave (embeddings, minhash, tokenize,
images, urls, files) in functions/multimodal.py, audio and video in
functions/media.py. ``_WAVES`` holds the names of a later wave, each of
which raises ``NotImplementedError`` naming its wave (``later_wave``); none
is left. An unknown name raises ``ValueError``.
"""

from __future__ import annotations

import dataclasses
import re
import threading
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ..core.series import Series, _null_fill
from ..datatype import DataType, Field

_REGISTRY: Dict[str, "FunctionSpec"] = {}
_REGISTRY_LOCK = threading.Lock()


@dataclasses.dataclass
class FunctionSpec:
    name: str
    return_type: Callable[[List[Field], Dict[str, Any]], DataType]
    host: Callable[[List[Series], Dict[str, Any]], Series]
    # torch kernel: (list of (values, validity) pairs, kwargs, float dtype) -> pair
    device: Optional[Callable] = None
    # raises ValueError on argument expressions the function does not take
    check: Optional[Callable] = None


def register(name: str, return_type, host, device=None, aliases=(), check=None):
    spec = FunctionSpec(name, return_type, host, device, check)
    with _REGISTRY_LOCK:
        _REGISTRY[name] = spec
        for a in aliases:
            _REGISTRY[a] = spec
    return spec


def get_function(name: str) -> FunctionSpec:
    spec = _REGISTRY.get(name)
    if spec is None:
        wave = later_wave(name)
        if wave is not None:
            raise NotImplementedError(f"the function {name!r} is not ported yet: it comes "
                                      f"with {wave}")
        raise ValueError(f"unknown function {name!r}; known: {sorted(_REGISTRY)[:40]}...")
    return spec


def has_function(name: str) -> bool:
    return name in _REGISTRY


# ---- the later waves (ROADMAP.md Queue 1 item 7) -------------------------------------

_WAVES: Dict[str, tuple] = {}
_LATER = {n: wave for wave, names in _WAVES.items() for n in names}


def later_wave(name: str) -> Optional[str]:
    """The wave of ROADMAP.md Queue 1 item 7 that brings ``name``, or None."""
    return _LATER.get(name)


# ---- return types and checks ----------------------------------------------------------


def _rt_same(fields, kwargs):
    return fields[0].dtype


def _rt_const(dt: DataType):
    return lambda fields, kwargs: dt


def _rt_float(fields, kwargs):
    return DataType.float32() if fields[0].dtype.kind == "float32" else DataType.float64()


_NEED = {"string": DataType.is_string, "numeric": DataType.is_numeric,
         "integer": DataType.is_integer, "date": lambda d: d.kind in ("date", "timestamp"),
         "clock": lambda d: d.kind in ("timestamp", "time"),
         "timestamp": lambda d: d.kind == "timestamp",
         "temporal": lambda d: d.kind in ("date", "timestamp", "time"),
         "duration": lambda d: d.kind == "duration"}
_NEED_WHAT = {"date": "a date column or a timestamp", "clock": "a timestamp or time column",
              "temporal": "a date, timestamp or time column"}


def _need(kind: str):
    """A check that the first argument is of ``kind`` ("string", "numeric",
    "integer"; "date": a date or timestamp, "clock": a timestamp or time,
    "timestamp", "temporal", "duration")."""
    test = _NEED[kind]

    def check(fname, args, fields):
        dt = fields[0].dtype
        if not (test(dt) or dt.is_null()):
            what = _NEED_WHAT.get(kind, f"a {kind} column")
            raise ValueError(f"{fname} takes {what}, got {dt}")
    return check


def _literals(*types, optional: int = 0, first: str = "string"):
    """A check of the first argument's kind and of the literal arguments
    after it: their Python types, of which the last ``optional`` may be
    left out."""
    base = _need(first)

    def check(fname, args, fields):
        from ..expressions.expressions import Literal

        base(fname, args, fields)
        lits = args[1:]
        if not len(types) - optional <= len(lits) <= len(types):
            raise ValueError(f"{fname} takes {len(types)} literal arguments, got {len(lits)}")
        for a, t in zip(lits, types):
            if not (isinstance(a, Literal) and isinstance(a.value, t)
                    and not isinstance(a.value, bool)):
                name = t.__name__ if isinstance(t, type) else t[0].__name__
                raise ValueError(f"{fname} takes a {name} literal, got {a!r}")
    return check


def _string_or_literal(fname, args, fields):
    """The first argument a string column; the others strings (a column of
    the same length, or a literal)."""
    _need("string")(fname, args, fields)
    for f in fields[1:]:
        if not (f.dtype.is_string() or f.dtype.is_null()):
            raise ValueError(f"{fname} takes string arguments, got {f.dtype}")


# ---- host helpers ---------------------------------------------------------------------


def _scalar_arg(s: Series):
    """The Python value of a length-1 Series argument (None when null)."""
    if len(s) != 1:
        raise ValueError("expected a scalar argument")
    return s.to_pylist()[0]


def _out(s: Series, dtype: DataType, values, valid) -> Series:
    valid = np.asarray(valid, dtype=bool)
    if dtype.is_nested():
        return Series.from_pylist([v if ok else None for v, ok in zip(values, valid.tolist())],
                                  s.name, dtype)
    values = np.asarray(values)
    if values.dtype != object:
        values = values.astype(dtype.to_numpy(), copy=False)
        if not valid.all():
            values = np.where(valid, values, values.dtype.type(_null_fill(dtype)))
    return Series(s.name, dtype, values, valid)


def _float_vals(s: Series) -> np.ndarray:
    v = s.to_numpy()
    return v.astype(np.float32 if s.dtype.kind == "float32" else np.float64, copy=False)


def _np1(fn):
    """A unary numpy kernel over the values in f64 (f32 stays f32); null
    rows stay null."""

    def host(args, kwargs):
        s = args[0]
        with np.errstate(all="ignore"):
            out = fn(_float_vals(s))
        return _out(s, _rt_float([s.field()], kwargs), out, s.validity_numpy())
    return host


def _dev1(fn):
    """A unary torch kernel in the stage's float type."""

    def device(pairs, kwargs, fdt):
        v, m = pairs[0]
        return fn(v.to(fdt) if not v.dtype.is_floating_point else v), m
    return device


def _str_map(fn, out_dtype: DataType):
    """A per-value Python function over a string column, once per distinct
    value through the column's dictionary codes; a null row, or a value
    the function maps to None, gives null."""

    def host(args, kwargs):
        s = args[0]
        extra = [_scalar_arg(a) for a in args[1:]]
        valid = s.validity_numpy()
        if len(s) == 0:
            return Series.empty(s.name, out_dtype)
        if any(e is None for e in extra):
            return Series.full_null(s.name, out_dtype, len(s))
        codes, vocab, _k = s.dict_codes()
        mapped = [None if v is None else fn(v, *extra, **kwargs) for v in vocab]
        ok = np.array([m is not None for m in mapped], dtype=bool)
        if out_dtype.to_numpy() == object:
            table = np.empty(len(mapped), dtype=object)
            table[:] = mapped
        else:
            fill = _null_fill(out_dtype)
            table = np.array([fill if m is None else m for m in mapped],
                             dtype=out_dtype.to_numpy())
        return _out(s, out_dtype, table[codes], ok[codes] & valid)
    return host


def _str_pair(fn, out_dtype: DataType):
    """A per-row Python function of two strings (a column or a literal
    each); null if either is null."""

    def host(args, kwargs):
        a, b = args[0], args[1]
        n = max(len(a), len(b))
        av = a.broadcast(n) if len(a) == 1 and n != 1 else a
        bv = b.broadcast(n) if len(b) == 1 and n != 1 else b
        out = [None if x is None or y is None else fn(x, y, **kwargs)
               for x, y in zip(av.to_pylist(), bv.to_pylist())]
        return Series.from_pylist(out, a.name, out_dtype)
    return host


# ===================================================================================
# numeric
# ===================================================================================

_MATH = [
    ("exp", np.exp, lambda t: t.exp()), ("sqrt", np.sqrt, lambda t: t.sqrt()),
    ("sin", np.sin, lambda t: t.sin()), ("cos", np.cos, lambda t: t.cos()),
    ("tan", np.tan, lambda t: t.tan()), ("arctan", np.arctan, lambda t: t.arctan()),
    ("arcsin", np.arcsin, lambda t: t.arcsin()), ("arccos", np.arccos, lambda t: t.arccos()),
    ("log2", np.log2, lambda t: t.log2()), ("log10", np.log10, lambda t: t.log10()),
    # torch has no cbrt: the sign times |x|^(1/3)
    ("cbrt", np.cbrt, lambda t: t.sign() * t.abs().pow(1.0 / 3.0)),
    ("expm1", np.expm1, lambda t: t.expm1()), ("log1p", np.log1p, lambda t: t.log1p()),
    # torch's vectorized f32 sinh and cosh overflow where exp(|x|) does (|x|
    # past 88.7), short of f32's range: an f32 column's are taken in f64 and
    # rounded back
    ("sinh", np.sinh, lambda t: t.double().sinh().to(t.dtype)),
    ("cosh", np.cosh, lambda t: t.double().cosh().to(t.dtype)),
    ("tanh", np.tanh, lambda t: t.tanh()), ("degrees", np.degrees, lambda t: t.rad2deg()),
    ("radians", np.radians, lambda t: t.deg2rad()),
]
for _name, _np_fn, _t_fn in _MATH:
    register(_name, _rt_float, _np1(_np_fn), device=_dev1(_t_fn), check=_need("numeric"))

# the math long tail (breadth.py): host only, as in the reference
for _name, _np_fn in [("arccosh", np.arccosh), ("arcsinh", np.arcsinh),
                      ("arctanh", np.arctanh), ("cot", lambda v: 1.0 / np.tan(v)),
                      ("sec", lambda v: 1.0 / np.cos(v)), ("csc", lambda v: 1.0 / np.sin(v))]:
    register(_name, _rt_float, _np1(_np_fn), check=_need("numeric"))


def _atan2_host(args, kwargs):
    y, x = args[0], args[1]
    n = max(len(y), len(x))
    yv = np.broadcast_to(y.to_numpy().astype(np.float64), n)
    xv = np.broadcast_to(x.to_numpy().astype(np.float64), n)
    with np.errstate(all="ignore"):
        out = np.arctan2(yv, xv)
    valid = np.broadcast_to(y.validity_numpy(), n) & np.broadcast_to(x.validity_numpy(), n)
    return _out(y, DataType.float64(), out, valid)


register("arctan2", _rt_const(DataType.float64()), _atan2_host)


def _log_host(args, kwargs):
    s = args[0]
    base = kwargs.get("base")
    with np.errstate(all="ignore"):
        v = s.to_numpy().astype(np.float64)
        out = np.log(v) if not base else np.log(v) / np.log(base)
    return _out(s, _rt_float([s.field()], kwargs), out, s.validity_numpy())


def _log_device(pairs, kwargs, fdt):
    v, m = pairs[0]
    base = kwargs.get("base")
    v = v.to(fdt)
    return (v.log() if not base else v.log() / float(np.log(base))), m


register("log", _rt_float, _log_host, device=_log_device, check=_need("numeric"))


def _keep_dtype(fn):
    """floor / ceil: computed in floats, cast back to the input's type."""

    def host(args, kwargs):
        s = args[0]
        if s.dtype.is_integer():
            return s
        with np.errstate(all="ignore"):
            out = fn(_float_vals(s))
        return _out(s, s.dtype, out, s.validity_numpy())
    return host


def _keep_dtype_device(fn):
    def device(pairs, kwargs, fdt):
        v, m = pairs[0]
        return (fn(v) if v.dtype.is_floating_point else v), m
    return device


register("floor", _rt_same, _keep_dtype(np.floor),
         device=_keep_dtype_device(lambda t: t.floor()), check=_need("numeric"))
register("ceil", _rt_same, _keep_dtype(np.ceil),
         device=_keep_dtype_device(lambda t: t.ceil()), check=_need("numeric"))


def _sign_host(args, kwargs):
    # Arrow's sign: -1 / 0 / 1 in the input's type, NaN stays NaN, -0.0 gives 0
    s = args[0]
    v = s.to_numpy()
    with np.errstate(all="ignore"):
        out = np.sign(v) + (0.0 if v.dtype.kind == "f" else 0)
    return _out(s, s.dtype, out, s.validity_numpy())


def _sign_device(pairs, kwargs, fdt):
    import torch

    v, m = pairs[0]
    if not v.dtype.is_floating_point:
        return v.sign(), m
    # torch's sign of NaN is 0; Arrow's is NaN
    return torch.where(v.isnan(), v, v.sign() + 0.0), m


register("sign", _rt_same, _sign_host, device=_sign_device, check=_need("numeric"))


def _round_int(v: np.ndarray, d: int) -> np.ndarray:
    """Integers rounded to 10^-d, half to even (Arrow's round on integers)."""
    if d >= 0:
        return v
    p = 10 ** (-d)
    w = v.astype(np.int64)
    r = np.mod(w, p)
    base = w - r
    up = (2 * r > p) | ((2 * r == p) & ((base // p) % 2 == 1))
    return np.where(up, base + p, base).astype(v.dtype)


def _round_host(args, kwargs):
    s = args[0]
    d = int(kwargs.get("decimals", 0))
    v = s.to_numpy()
    if s.dtype.is_integer():
        out = _round_int(v, d)
    else:
        with np.errstate(all="ignore"):
            out = np.round(v, d)
    return _out(s, s.dtype, out, s.validity_numpy())


def _round_device(pairs, kwargs, fdt):
    import torch

    v, m = pairs[0]
    d = int(kwargs.get("decimals", 0))
    if v.dtype.is_floating_point:
        if d == 0 or v.dtype == torch.float64:
            return torch.round(v, decimals=d), m
        # scaling by 10^d in f32 rounds once more, which can make or break
        # a tie: scale in f64, as the host does, and round the result to f32
        return torch.round(v.to(torch.float64), decimals=d).to(v.dtype), m
    if d >= 0 or v.dtype == torch.bool:
        return v, m
    p = 10 ** (-d)
    w = v.to(torch.int64)
    r = torch.remainder(w, p)
    base = w - r
    up = (2 * r > p) | ((2 * r == p) & (torch.remainder(torch.div(base, p, rounding_mode="floor"),
                                                         2) == 1))
    return torch.where(up, base + p, base).to(v.dtype), m


register("round", _rt_same, _round_host, device=_round_device, check=_need("numeric"))


def _clip_host(args, kwargs):
    s = args[0]
    lo, hi = kwargs.get("clip_min"), kwargs.get("clip_max")
    v = s.to_numpy()
    out = np.clip(v, lo, hi) if (lo is not None or hi is not None) else v
    return _out(s, s.dtype, out, s.validity_numpy())


def _clip_device(pairs, kwargs, fdt):
    v, m = pairs[0]
    lo, hi = kwargs.get("clip_min"), kwargs.get("clip_max")
    if lo is None and hi is None:
        return v, m
    out = v.clamp(min=lo, max=hi)
    return out.to(v.dtype) if not v.dtype.is_floating_point else out, m


register("clip", _rt_same, _clip_host, device=_clip_device, check=_need("numeric"))


def _hash_host(args, kwargs):
    seed = kwargs.get("seed")
    s = args[0]
    seed_series = None if seed is None else \
        Series.from_numpy(np.full(len(s), seed, dtype=np.uint64), "seed")
    return s.hash(seed_series).rename(s.name)


register("hash", _rt_const(DataType.uint64()), _hash_host)


# ---- bitwise (extra.py) ---------------------------------------------------------------


def _int_binary(fn):
    def host(args, kwargs):
        a, b = args[0], args[1]
        n = max(len(a), len(b))
        av = np.broadcast_to(a.to_numpy(), n)
        bv = np.broadcast_to(b.to_numpy(), n)
        dt = np.promote_types(av.dtype, bv.dtype)
        with np.errstate(all="ignore"):
            out = fn(av.astype(dt), bv.astype(dt))
        valid = np.broadcast_to(a.validity_numpy(), n) & np.broadcast_to(b.validity_numpy(), n)
        return _out(a, a.dtype, out.astype(a.dtype.to_numpy()), valid)
    return host


def _shift(left: bool):
    def fn(a, b):
        bits = a.dtype.itemsize * 8
        ok = (b >= 0) & (b < bits)
        sb = np.where(ok, b, 0).astype(a.dtype)
        out = np.left_shift(a, sb) if left else np.right_shift(a, sb)
        return np.where(ok, out, 0)
    return fn


for _name, _fn in [("bitwise_and", np.bitwise_and), ("bitwise_or", np.bitwise_or),
                   ("bitwise_xor", np.bitwise_xor), ("shift_left", _shift(True)),
                   ("shift_right", _shift(False))]:
    register(_name, _rt_same, _int_binary(_fn), check=_need("integer"))


def _bitwise_not(args, kwargs):
    s = args[0]
    return _out(s, s.dtype, np.invert(s.to_numpy()), s.validity_numpy())


register("bitwise_not", _rt_same, _bitwise_not, check=_need("integer"))


# ===================================================================================
# float namespace
# ===================================================================================


def _float_test(fn, negate=False):
    def host(args, kwargs):
        s = args[0]
        v = s.to_numpy()
        hit = fn(v) if v.dtype.kind == "f" else np.zeros(len(v), dtype=bool)
        return _out(s, DataType.bool(), ~hit if negate else hit, s.validity_numpy())
    return host


def _float_test_device(fn, negate=False):
    def device(pairs, kwargs, fdt):
        import torch

        v, m = pairs[0]
        hit = fn(v) if v.dtype.is_floating_point else torch.zeros_like(v, dtype=torch.bool)
        return (~hit if negate else hit), m
    return device


register("is_nan", _rt_const(DataType.bool()), _float_test(np.isnan),
         device=_float_test_device(lambda t: t.isnan()))
register("is_inf", _rt_const(DataType.bool()), _float_test(np.isinf),
         device=_float_test_device(lambda t: t.isinf()))
register("not_nan", _rt_const(DataType.bool()), _float_test(np.isnan, negate=True),
         device=_float_test_device(lambda t: t.isnan(), negate=True))


def _fill_nan_host(args, kwargs):
    s, fill = args[0], args[1]
    v = s.to_numpy()
    n = len(s)
    valid = s.validity_numpy()
    nan = (np.isnan(v) if v.dtype.kind == "f" else np.zeros(n, dtype=bool)) & valid
    fv = np.broadcast_to(fill.to_numpy(), n)
    fm = np.broadcast_to(fill.validity_numpy(), n)
    with np.errstate(all="ignore"):
        out = np.where(nan, fv.astype(v.dtype), v)
    return _out(s, s.dtype, out, np.where(nan, fm, valid))


def _fill_nan_device(pairs, kwargs, fdt):
    import torch

    (v, m), (fv, fm) = pairs[0], pairs[1]
    # a null row carries NaN in its values: only a valid NaN is replaced
    nan = (v.isnan() & m) if v.dtype.is_floating_point else torch.zeros_like(m)
    val = torch.where(nan, fv.to(v.dtype), v)
    ones = torch.ones_like(nan)
    return val, torch.where(nan, fm & ones, m & ones)


register("fill_nan", _rt_same, _fill_nan_host, device=_fill_nan_device)


# ===================================================================================
# utf8
# ===================================================================================


def _upper_cp(v: str) -> str:
    # per code point, as utf8proc maps it: a character whose Python upper case
    # is longer than one (sharp s) keeps one code point
    if v.isascii():
        return v.upper()
    return "".join(u if len(u := c.upper()) == 1 else ("ẞ" if c == "\xdf" else c)
                   for c in v)


def _lower_cp(v: str) -> str:
    if v.isascii():
        return v.lower()
    # dotted capital I's simple lower case is "i" (Python's full mapping adds
    # a combining dot)
    return "".join(u if len(u := c.lower()) == 1 else ("i" if c == "\u0130" else c)
                   for c in v)


def _capitalize(v: str) -> str:
    return _upper_cp(v[:1]) + _lower_cp(v[1:])


_S = DataType.string()
_B = DataType.bool()

register("utf8_upper", _rt_same, _str_map(_upper_cp, _S), check=_need("string"))
register("utf8_lower", _rt_same, _str_map(_lower_cp, _S), check=_need("string"))
register("utf8_capitalize", _rt_same, _str_map(_capitalize, _S), check=_need("string"))
# the reference's utf8_title is Python's str.title (extra.py:233)
register("utf8_title", _rt_const(_S), _str_map(str.title, _S), check=_need("string"))
register("utf8_length", _rt_const(DataType.uint64()), _str_map(len, DataType.uint64()),
         check=_need("string"))
register("utf8_length_bytes", _rt_const(DataType.uint64()),
         _str_map(lambda v: len(v.encode("utf-8")), DataType.uint64()), check=_need("string"))
register("utf8_reverse", _rt_same, _str_map(lambda v: v[::-1], _S), check=_need("string"))
register("utf8_lstrip", _rt_same, _str_map(str.lstrip, _S), check=_need("string"))
register("utf8_rstrip", _rt_same, _str_map(str.rstrip, _S), check=_need("string"))
register("utf8_strip", _rt_same, _str_map(str.strip, _S), check=_need("string"))


def _contains_host(args, kwargs):
    s, pat = args[0], args[1]
    if len(pat) == 1:
        return _str_map(lambda v, p: p in v, _B)(args, kwargs)
    return _str_pair(lambda a, b: b in a, _B)(args, kwargs)


register("utf8_contains", _rt_const(_B), _contains_host, check=_string_or_literal)
register("utf8_startswith", _rt_const(_B), _str_map(lambda v, p: v.startswith(p), _B),
         check=_literals(str))
register("utf8_endswith", _rt_const(_B), _str_map(lambda v, p: v.endswith(p), _B),
         check=_literals(str))
# the reference's match, split and replace run RE2 (pyarrow), whose \w, \d,
# \s and \b are ASCII: Python's re takes re.ASCII for them; its extract,
# extract_all, like and count_matches run Python's re, as here
register("utf8_match", _rt_const(_B),
         _str_map(lambda v, p: re.search(p, v, re.ASCII) is not None, _B),
         check=_literals(str))


def _split(v: str, p: str, regex=False):
    return re.split(p, v, flags=re.ASCII) if regex else v.split(p)


register("utf8_split", _rt_const(DataType.list(_S)),
         _str_map(_split, DataType.list(_S)), check=_literals(str))


def _substr(v: str, start, length=None):
    return v[start:None if length is None else start + length]


register("utf8_substr", _rt_const(_S), _str_map(_substr, _S),
         check=_literals(int, int, optional=1))


def _replace(v: str, pat: str, rep: str, regex=False):
    return re.sub(pat, rep, v, flags=re.ASCII) if regex else v.replace(pat, rep)


register("utf8_replace", _rt_const(_S), _str_map(_replace, _S), check=_literals(str, str))


def _extract(v: str, pat: str, index=0):
    m = re.search(pat, v)
    return None if m is None else m.group(index)


def _extract_all(v: str, pat: str, index=0):
    return [m.group(index) for m in re.finditer(pat, v)]


register("utf8_extract", _rt_const(_S), _str_map(_extract, _S), check=_literals(str))
register("utf8_extract_all", _rt_const(DataType.list(_S)),
         _str_map(_extract_all, DataType.list(_S)), check=_literals(str))


def _find(v: str, sub: str):
    # Arrow's find_substring: the first match's offset in UTF-8 bytes, else -1
    i = v.find(sub)
    return i if i <= 0 or v.isascii() else len(v[:i].encode("utf-8"))


register("utf8_find", _rt_const(DataType.int64()), _str_map(_find, DataType.int64()),
         check=_literals(str))
register("utf8_left", _rt_const(_S), _str_map(lambda v, n: v[:max(n, 0)], _S),
         check=_literals(int))
register("utf8_right", _rt_const(_S),
         _str_map(lambda v, n: v[max(len(v) - n, 0):] if n > 0 else "", _S),
         check=_literals(int))
register("utf8_repeat", _rt_const(_S), _str_map(lambda v, n: v * max(n, 0), _S),
         check=_literals(int))


def _concat_host(args, kwargs):
    return _str_pair(lambda a, b: a + b, _S)(args, kwargs)


register("utf8_concat", _rt_const(_S), _concat_host, check=_string_or_literal)


def like_regex(pattern: str, case_insensitive: bool = False):
    """SQL LIKE as an anchored regex: ``%`` any run, ``_`` one character,
    everything else literal."""
    parts = [".*" if ch == "%" else "." if ch == "_" else re.escape(ch) for ch in pattern]
    return re.compile("^" + "".join(parts) + "$",
                      (re.IGNORECASE if case_insensitive else 0) | re.DOTALL)


def _like(ci: bool):
    def host(args, kwargs):
        rx = like_regex(_scalar_arg(args[1]) or "", ci)
        return _str_map(lambda v, _p: rx.match(v) is not None, _B)(args, kwargs)
    return host


register("utf8_like", _rt_const(_B), _like(False), check=_literals(str))
register("utf8_ilike", _rt_const(_B), _like(True), check=_literals(str))


def _pad(left: bool):
    # Arrow's utf8_lpad / utf8_rpad: pad to ``n`` code points, never truncate
    def fn(v: str, n: int, pad: str):
        short = n - len(v)
        if short <= 0:
            return v
        return pad * short + v if left else v + pad * short
    return fn


register("utf8_lpad", _rt_const(_S), _str_map(_pad(True), _S), check=_literals(int, str))
register("utf8_rpad", _rt_const(_S), _str_map(_pad(False), _S), check=_literals(int, str))


def _normalize(v: str, remove_punct=False, lowercase=False, nfd_unicode=False,
               white_space=False):
    import unicodedata

    if nfd_unicode:
        v = unicodedata.normalize("NFD", v)
    if lowercase:
        v = v.lower()
    if remove_punct:
        v = re.sub(r"[^\w\s]", "", v)
    if white_space:
        v = " ".join(v.split())
    return v


register("utf8_normalize", _rt_const(_S), _str_map(_normalize, _S), check=_need("string"))


def _count_matches(args, kwargs):
    s, patterns = args[0], args[1]
    pats = patterns.to_pylist()
    if pats and isinstance(pats[0], list):
        pats = pats[0]
    flags = 0 if kwargs.get("case_sensitive", True) else re.IGNORECASE
    ww = kwargs.get("whole_words", False)
    rx = re.compile("|".join((r"\b" + re.escape(p) + r"\b") if ww else re.escape(p)
                             for p in pats), flags)
    return _str_map(lambda v: len(rx.findall(v)), DataType.uint64())([s], {})


register("utf8_count_matches", _rt_const(DataType.uint64()), _count_matches,
         check=_need("string"))


def _levenshtein(x: str, y: str) -> int:
    if len(x) < len(y):
        x, y = y, x
    prev = list(range(len(y) + 1))
    for i, cx in enumerate(x):
        cur = [i + 1]
        for j, cy in enumerate(y):
            cur.append(min(prev[j + 1] + 1, cur[j] + 1, prev[j] + (cx != cy)))
        prev = cur
    return prev[-1]


def _jaccard(x: str, y: str, ngram: int = 2) -> float:
    n = int(ngram)

    def grams(s):
        return {s[i:i + n] for i in range(max(len(s) - n + 1, 1))}

    gx, gy = grams(x), grams(y)
    union = len(gx | gy)
    return len(gx & gy) / union if union else 1.0


register("levenshtein", _rt_const(DataType.uint32()),
         _str_pair(lambda a, b: _levenshtein(a, b), DataType.uint32()),
         check=_string_or_literal)
register("jaccard_similarity", _rt_const(DataType.float64()),
         _str_pair(_jaccard, DataType.float64()), check=_string_or_literal)

# the case conversions (breadth.py): words split at camelCase / PascalCase
# boundaries and at every run of characters outside [A-Za-z0-9]
_WORD_RE = re.compile(r"[A-Za-z0-9]+")


def _words(v: str) -> List[str]:
    spaced = re.sub(r"([a-z0-9])([A-Z])", r"\1 \2", v)
    spaced = re.sub(r"([A-Z]+)([A-Z][a-z])", r"\1 \2", spaced)
    return [w.lower() for w in _WORD_RE.findall(spaced)]


for _name, _join in [
    ("to_snake_case", lambda ws: "_".join(ws)),
    ("to_kebab_case", lambda ws: "-".join(ws)),
    ("to_camel_case", lambda ws: (ws[0] + "".join(w.title() for w in ws[1:])) if ws else ""),
    ("to_upper_camel_case", lambda ws: "".join(w.title() for w in ws)),
    ("to_upper_snake_case", lambda ws: "_".join(w.upper() for w in ws)),
    ("to_upper_kebab_case", lambda ws: "-".join(w.upper() for w in ws)),
    ("to_title_case", lambda ws: " ".join(w.title() for w in ws)),
]:
    register(_name, _rt_const(_S), _str_map(lambda v, _j=_join: _j(_words(v)), _S),
             check=_need("string"))


# ===================================================================================
# misc
# ===================================================================================


def _coalesce_host(args, kwargs):
    n = max(len(a) for a in args)
    out_dt = _rt_coalesce([a.field() for a in args], kwargs)
    vals = None
    valid = np.zeros(n, dtype=bool)
    for a in args:
        if a.dtype.is_null():
            continue
        a = a.cast(out_dt) if a.dtype != out_dt else a
        av = np.broadcast_to(a.to_numpy(), n)
        am = np.broadcast_to(a.validity_numpy(), n)
        take = am & ~valid
        if vals is None:
            vals = np.array(av, copy=True)
        else:
            vals = np.where(take, av, vals)
        valid = valid | am
    if vals is None:
        return Series.full_null(args[0].name, out_dt, n)
    return _out(args[0], out_dt, vals, valid)


def _rt_coalesce(fields, kwargs):
    for f in fields:
        if not f.dtype.is_null():
            return f.dtype
    return fields[0].dtype


register("coalesce", _rt_coalesce, _coalesce_host)


def _monotonically_increasing_id(args, kwargs):
    raise ValueError("monotonically_increasing_id is evaluated by the executor, not as a "
                     "scalar fn")


register("monotonically_increasing_id", _rt_const(DataType.uint64()),
         _monotonically_increasing_id)


def _uuid_host(args, kwargs):
    import uuid as _uuid

    n = kwargs.get("__num_rows", 1)
    return Series.from_pylist([str(_uuid.uuid4()) for _ in range(n)], "uuid", _S)


register("uuid", _rt_const(_S), _uuid_host)


from . import temporal as _temporal  # noqa: E402,F401  (registers the temporal functions)
from . import nested as _nested  # noqa: E402,F401  (registers the nested-types wave)
from . import multimodal as _multimodal  # noqa: E402,F401  (registers the multimodal wave)
from . import media as _media  # noqa: E402,F401  (registers audio, video)
