"""The nested-types wave of the registry (counterpart of the list and struct
functions of daft_tpu/functions/registry.py:646-880, the binary, hash, JSON
and map functions of ``extra.py:44-226``, and ``parse_url``, compression,
serialization, the codecs, the list long tail and the Iceberg partitions of
``breadth.py:132-602``).

List functions work on the offsets and the child column (core/series.py
``NestedLayout``): lengths, the numeric reductions, ``list_get``,
``list_slice``, ``list_contains``, ``list_count``, ``list_sort``,
``list_distinct``, ``list_chunk``, ``list_append``, the bool reductions and
``map_get`` run in numpy over the child planes, with no Python loop over
rows. The reductions follow the reference's: in f64 and cast back to the
element type, null for a null, empty or all-null list. Value functions
(hashes, base64, JSON, compression, codecs) call Python's standard library
once a value, as the reference does; ``partition_iceberg_bucket`` hashes an
integer column with murmur3 in numpy, bit for bit the reference's.
"""

from __future__ import annotations

import base64 as _b64
import binascii
import bz2 as _bz2
import gzip as _gzip
import hashlib
import json as _json
import zlib as _zlib
from typing import List

import numpy as np

from ..core.kernels.groupby import equality_codes
from ..core.series import Series, _lengths_to_offsets, _ranges
from ..datatype import DataType
from .registry import _rt_const, _rt_same, _scalar_arg, register

_U64 = DataType.uint64()
_S = DataType.string()
_B = DataType.binary()


def _rt_inner(fields, kwargs):
    return fields[0].dtype.inner


def _need_list(fname: str, s: Series) -> Series:
    """``s`` if it is a list column; a fixed-size list as a list (its null
    rows' element slots dropped), so every list function reads one
    layout."""
    if not s.dtype.is_list() and not s.dtype.is_null():
        raise ValueError(f"{fname} expects a list column, got {s.dtype}")
    return s.cast(DataType.list(s.dtype.inner)) if s.dtype.kind == "fixed_size_list" else s


def _row_ids(s: Series) -> np.ndarray:
    """The row of each child element of a list (or map) column."""
    return np.repeat(np.arange(len(s), dtype=np.int64), s.list_lengths())


def _segment_reduce(ufunc, values: np.ndarray, rows: np.ndarray, n: int, identity):
    """``ufunc`` over each row's values (rows sorted), ``identity`` where a
    row has none: (result, count)."""
    counts = np.bincount(rows, minlength=n).astype(np.int64)
    out = np.full(n, identity, dtype=values.dtype)
    if len(values):
        starts = _lengths_to_offsets(counts)[:-1]
        has = counts > 0
        out[has] = ufunc.reduceat(values, starts[has])
    return out, counts


def _valid_elements(s: Series):
    """(values, rows) of the valid elements of a list column."""
    child = s.list_child()
    keep = child.validity_numpy()
    rows = _row_ids(s)
    vals = child.to_numpy()
    if not keep.all():
        vals, rows = vals[keep], rows[keep]
    return vals, rows


# ---- lists (registry.py:646-880) ---------------------------------------------------------


def _list_length(args, kwargs):
    s = args[0]
    s = _need_list("list_length", s)
    if s.dtype.is_null():
        return Series.full_null(s.name, _U64, len(s))
    valid = s.validity_numpy()
    return Series.from_numpy(np.where(valid, s.list_lengths(), 0).astype(np.uint64), s.name,
                             _U64, validity=valid)


register("list_length", _rt_const(_U64), _list_length)


def _list_agg(op: str):
    """list_sum / mean / min / max (registry.py:665-701): the valid
    elements of each row reduced in f64, then cast back to the element
    type (f64 for the mean); null where a row has none."""

    def host(args, kwargs):
        s = args[0]
        s = _need_list(f"list_{op}", s)
        out_dt = DataType.float64() if op == "mean" else s.dtype.inner
        n = len(s)
        vals, rows = _valid_elements(s)
        vals = vals.astype(np.float64)
        if op in ("sum", "mean"):
            red, cnt = _segment_reduce(np.add, vals, rows, n, 0.0)
            if op == "mean":
                with np.errstate(invalid="ignore", divide="ignore"):
                    red = red / np.maximum(cnt, 1)
        else:
            red, cnt = _segment_reduce(np.minimum if op == "min" else np.maximum, vals, rows,
                                       n, 0.0)
        valid = s.validity_numpy() & (cnt > 0)
        red = np.where(valid, red, 0.0)
        return Series.from_numpy(red.astype(out_dt.to_numpy()), s.name, out_dt,
                                 validity=valid)
    return host


register("list_sum", _rt_inner, _list_agg("sum"))
register("list_mean", _rt_const(DataType.float64()), _list_agg("mean"))
register("list_min", _rt_inner, _list_agg("min"))
register("list_max", _rt_inner, _list_agg("max"))


def _pick(s: Series, pos: np.ndarray, ok: np.ndarray, default=None) -> Series:
    """The element at ``pos`` of each row where ``ok``; elsewhere null, or
    ``default`` on a valid row."""
    child = s.list_child()
    idx = np.where(ok, s.list_offsets()[:-1] + pos, -1)
    if default is not None:
        use = s.validity_numpy() & ~ok
        if use.any():
            child = Series.concat([child, Series.from_pylist([default], child.name,
                                                             child.dtype)])
            idx = np.where(use, len(child) - 1, idx)
    out = child.take_or_null(idx) if len(child) else \
        Series.full_null(child.name, child.dtype, len(idx))
    return out.rename(s.name)


def _list_get(args, kwargs):
    """``v[idx]`` of each row, Python's negative indices; ``default`` where
    the index is out of range, null for a null row (registry.py:704-719)."""
    s = args[0]
    s = _need_list("list_get", s)
    idx = _scalar_arg(args[1])
    default = args[2].to_pylist()[0] if len(args) > 2 and args[2] is not None else None
    lens = s.list_lengths()
    pos = np.full(len(s), idx, dtype=np.int64) if idx >= 0 else lens + idx
    ok = s.validity_numpy() & (pos >= 0) & (pos < lens)
    return _pick(s, pos, ok, default)


register("list_get", _rt_inner, _list_get)


def _list_join(args, kwargs):
    """The string elements joined by the delimiter; null for a null row or a
    row holding a null (Arrow's binary_join)."""
    s = args[0]
    s = _need_list("list_join", s)
    delim = _scalar_arg(args[1])
    child = s.list_child()
    flat = child.to_numpy().tolist()
    rows = _row_ids(s)
    has_null = np.bincount(rows[~child.validity_numpy()], minlength=len(s)) > 0
    valid = s.validity_numpy() & ~has_null
    o = s.list_offsets().tolist()
    out = [delim.join(flat[o[i]:o[i + 1]]) if ok else None
           for i, ok in enumerate(valid.tolist())]
    return Series.from_pylist(out, s.name, _S)


register("list_join", _rt_const(_S), _list_join)


def _list_contains(args, kwargs):
    """Whether each row holds the value (Python's ``in``: a None value finds
    a null element); null for a null row."""
    s = args[0]
    s = _need_list("list_contains", s)
    target = args[1].to_pylist()[0]
    child = s.list_child()
    cvalid = child.validity_numpy()
    if target is None:
        hit = ~cvalid
    else:
        vals = child.to_numpy()
        if child.dtype.is_nested():
            hit = np.array([v == target for v in vals.tolist()], dtype=bool)
        else:
            with np.errstate(invalid="ignore"):
                hit = np.asarray(vals == target, dtype=bool)
        hit = hit & cvalid
    found = np.bincount(_row_ids(s)[hit], minlength=len(s)) > 0
    valid = s.validity_numpy()
    return Series.from_numpy(found & valid, s.name, DataType.bool(), validity=valid)


register("list_contains", _rt_const(DataType.bool()), _list_contains)


def _py_bound(v, lens: np.ndarray, default: np.ndarray) -> np.ndarray:
    """A Python slice bound per row, clipped to [0, len]."""
    if v is None:
        return default
    b = np.full(len(lens), v, dtype=np.int64) if v >= 0 else lens + v
    return np.clip(b, 0, lens)


def _sub_lists(s: Series, start: np.ndarray, lens: np.ndarray) -> Series:
    """Each row's elements [start, start + lens) as a list column of s's
    type (lens 0 on null rows)."""
    child = s.list_child()
    idx = _ranges(s.list_offsets()[:-1] + start, lens)
    dt = s.dtype if s.dtype.kind == "list" else DataType.list(s.dtype.inner)
    return Series.nested(s.name, dt, _lengths_to_offsets(lens), [child.take(idx)],
                         s.validity_numpy())


def _list_slice(args, kwargs):
    """``v[start:end]`` of each row (registry.py:744-753)."""
    s = args[0]
    s = _need_list("list_slice", s)
    start = _scalar_arg(args[1])
    end = _scalar_arg(args[2]) if len(args) > 2 and args[2] is not None else None
    lens = s.list_lengths()
    a = _py_bound(start, lens, np.zeros(len(s), dtype=np.int64))
    b = _py_bound(end, lens, lens)
    return _sub_lists(s, a, np.maximum(b - a, 0) * s.validity_numpy())


register("list_slice", _rt_same, _list_slice)


def _elements_in_order(s: Series, keep_rows: np.ndarray) -> Series:
    """A list column of the child elements ``keep_rows`` (sorted by row)."""
    counts = np.bincount(_row_ids(s)[keep_rows], minlength=len(s)).astype(np.int64)
    dt = s.dtype if s.dtype.kind == "list" else DataType.list(s.dtype.inner)
    return Series.nested(s.name, dt, _lengths_to_offsets(counts),
                         [s.list_child().take(keep_rows)], s.validity_numpy())


def _list_sort(args, kwargs):
    """Each row's valid elements sorted (descending with ``desc``), its
    nulls after them (registry.py:756-766)."""
    from ..core.kernels.sort import multi_argsort

    s = args[0]
    s = _need_list("list_sort", s)
    desc = bool(kwargs.get("desc", False))
    rows = Series.from_numpy(_row_ids(s))
    order = multi_argsort([rows, s.list_child()], [False, desc], [False, False])
    return _elements_in_order(s, order)


register("list_sort", _rt_same, _list_sort)


def _distinct_codes(child: Series) -> np.ndarray:
    """Equality codes where each NaN is distinct (a Python set's terms)."""
    codes = equality_codes(child)
    if child.dtype.is_floating():
        nan = child.validity_numpy() & np.isnan(child.to_numpy())
        codes = np.where(nan, int(codes.max(initial=-1)) + 1 + np.cumsum(nan), codes)
    return codes


def _first_distinct(s: Series):
    """(the first element of each distinct valid value per row, in order,
    the number of its occurrences)."""
    child = s.list_child()
    rows = _row_ids(s)
    codes = _distinct_codes(child)
    valid = np.flatnonzero(child.validity_numpy())
    width = int(codes.max(initial=0)) + 1
    pairs = rows[valid] * width + codes[valid]
    _u, first, inverse, counts = np.unique(pairs, return_index=True, return_inverse=True,
                                           return_counts=True)
    keep = valid[first]
    order = np.argsort(keep, kind="stable")
    return keep[order], counts[order].astype(np.uint64)


def _list_distinct(args, kwargs):
    """Each row's distinct valid elements in order of first occurrence
    (registry.py:769-786)."""
    s = args[0]
    s = _need_list("list_distinct", s)
    keep, _counts = _first_distinct(s)
    return _elements_in_order(s, keep)


register("list_distinct", _rt_same, _list_distinct)


def _list_chunk(args, kwargs):
    """Each row split into lists of ``size`` elements; a shorter tail is
    dropped (registry.py:789-800)."""
    s = args[0]
    s = _need_list("list_chunk", s)
    size = int(kwargs["size"])
    lens = s.list_lengths()
    n_chunks = lens // size
    inner = _sub_lists(s, np.zeros(len(s), dtype=np.int64), n_chunks * size)
    chunks = Series.nested("item", inner.dtype, np.arange(int(n_chunks.sum()) + 1,
                                                          dtype=np.int64) * size,
                           [inner.list_child()], np.ones(int(n_chunks.sum()), dtype=bool))
    return Series.nested(s.name, DataType.list(s.dtype), _lengths_to_offsets(n_chunks),
                         [chunks], s.validity_numpy())


register("list_chunk", lambda f, k: DataType.list(f[0].dtype), _list_chunk)


def _list_count(args, kwargs):
    """Each row's valid, null or all elements; 0 for a null row."""
    s = args[0]
    s = _need_list("list_count", s)
    mode = kwargs.get("mode", "valid")
    lens = s.list_lengths()
    nulls = np.bincount(_row_ids(s)[~s.list_child().validity_numpy()],
                        minlength=len(s)).astype(np.int64)
    out = {"valid": lens - nulls, "null": nulls}.get(mode, lens)
    return Series.from_numpy(out.astype(np.uint64), s.name, _U64)


register("list_count", _rt_const(_U64), _list_count)


def _value_counts_type(inner: DataType) -> DataType:
    return DataType.list(DataType.struct({"key": inner, "value": _U64}))


def _list_value_counts(args, kwargs):
    """Each row's distinct valid elements with their counts, as a list of
    structs of ``key`` and ``value`` in order of first occurrence."""
    s = args[0]
    s = _need_list("list_value_counts", s)
    keep, counts = _first_distinct(s)
    keys = s.list_child().take(keep).rename("key")
    entry = Series.nested("item", DataType.struct({"key": s.dtype.inner, "value": _U64}),
                          None, [keys, Series.from_numpy(counts, "value", _U64)],
                          np.ones(len(keep), dtype=bool))
    n = np.bincount(_row_ids(s)[keep], minlength=len(s)).astype(np.int64)
    return Series.nested(s.name, _value_counts_type(s.dtype.inner), _lengths_to_offsets(n),
                         [entry], s.validity_numpy())


register("list_value_counts", lambda f, k: _value_counts_type(f[0].dtype.inner),
         _list_value_counts)


def _list_append(args, kwargs):
    """Each row with the value appended (breadth.py:412-420); a null row
    stays null."""
    s, v = args[0], args[1]
    s = _need_list("list_append", s)
    n = len(s)
    v = v.broadcast(n) if len(v) == 1 and n != 1 else v
    valid = s.validity_numpy()
    lens = s.list_lengths()
    new_lens = lens + valid
    child = s.list_child()
    item = v.cast(child.dtype) if v.dtype != child.dtype and not v.dtype.is_null() \
        else v
    if item.dtype.is_null():
        item = Series.full_null(child.name, child.dtype, n)
    both = Series.concat([child, item.rename(child.name)])
    off = _lengths_to_offsets(new_lens)
    idx = np.empty(int(off[-1]), dtype=np.int64)
    elem = _ranges(s.list_offsets()[:-1], lens)
    pos = _ranges(off[:-1], lens)
    idx[pos] = elem
    last = off[1:][valid] - 1
    idx[last] = len(child) + np.flatnonzero(valid)
    dt = s.dtype if s.dtype.kind == "list" else DataType.list(s.dtype.inner)
    return Series.nested(s.name, dt, off, [both.take(idx)], valid)


register("list_append", lambda f, k: f[0].dtype if f[0].dtype.kind == "list"
         else DataType.list(f[0].dtype.inner), _list_append)


def _list_bool(op_all: bool):
    """Whether all (any) valid elements of a row are true; null for a null
    row or one with no valid element (breadth.py:423-440)."""

    def host(args, kwargs):
        s = args[0]
        s = _need_list("list_bool_and" if op_all else "list_bool_or", s)
        vals, rows = _valid_elements(s)
        truth = np.array([bool(v) for v in vals.tolist()], dtype=bool) \
            if vals.dtype == object else vals.astype(bool)
        n = len(s)
        cnt = np.bincount(rows, minlength=n)
        trues = np.bincount(rows[truth], minlength=n)
        out = (trues == cnt) if op_all else (trues > 0)
        valid = s.validity_numpy() & (cnt > 0)
        return Series.from_numpy(out & valid, s.name, DataType.bool(), validity=valid)
    return host


register("list_bool_and", _rt_const(DataType.bool()), _list_bool(True))
register("list_bool_or", _rt_const(DataType.bool()), _list_bool(False))


# ---- structs and maps --------------------------------------------------------------------


def _rt_struct_get(fields, kwargs):
    for n, t in fields[0].dtype.struct_fields:
        if n == kwargs["name"]:
            return t
    raise ValueError(f"struct has no field {kwargs['name']!r}")


def _struct_get(args, kwargs):
    s = args[0]
    if not s.dtype.is_struct():
        raise ValueError(f"struct_get expects a struct column, got {s.dtype}")
    return s.struct_field(kwargs["name"])


register("struct_get", _rt_struct_get, _struct_get)


def _map_value_dtype(dt: DataType, key) -> DataType:
    if dt.kind == "map":
        return dt.params[1]
    if dt.kind == "struct":
        for name, fdt in dt.struct_fields:
            if name == key:
                return fdt
    return _S


def _map_get(args, kwargs):
    """The value of each row's first entry with the key (extra.py:192-212);
    null where there is none. A struct column gives its field."""
    s = args[0]
    key = kwargs["key"]
    out_dt = _map_value_dtype(s.dtype, key)
    if s.dtype.is_struct():
        return s.struct_field(key).rename(s.name) if any(
            n == key for n, _t in s.dtype.struct_fields) else \
            Series.full_null(s.name, out_dt, len(s))
    if s.dtype.kind != "map":
        raise ValueError(f"map_get expects a map column, got {s.dtype}")
    entries = s.list_child()
    keys, values = entries.layout.children
    kv = keys.to_numpy()
    hit = np.array([k == key for k in kv.tolist()], dtype=bool) if kv.dtype == object \
        else np.asarray(kv == key, dtype=bool)
    hit &= keys.validity_numpy()
    rows = _row_ids(s)
    big = np.iinfo(np.int64).max
    pos = np.where(hit, np.arange(len(hit)), big)
    first, _cnt = _segment_reduce(np.minimum, pos, rows, len(s), big)
    found = first < big
    return values.take_or_null(np.where(found, first, -1)).rename(s.name)


register("map_get", lambda f, k: _map_value_dtype(f[0].dtype, k.get("key")), _map_get)


# ---- value maps --------------------------------------------------------------------------


def _value_map(fn, out_dtype: DataType):
    """A per-value Python function (extra.py:29-38): a null row gives null."""

    def host(args: List[Series], kwargs) -> Series:
        s = args[0]
        out = [None if v is None else fn(v, kwargs) for v in s.to_pylist()]
        return Series.from_pylist(out, s.name, dtype=out_dtype)
    return host


def _as_bytes(v) -> bytes:
    return v.encode() if isinstance(v, str) else bytes(v)


# ---- binary (extra.py:44-77) -------------------------------------------------------------


def _binary_length(args, kwargs):
    s = args[0]
    valid = s.validity_numpy()
    lens = np.fromiter((len(v) if ok else 0 for v, ok in zip(s.to_numpy().tolist(),
                                                              valid.tolist())),
                       dtype=np.uint64, count=len(s))
    return Series.from_numpy(lens, s.name, _U64, validity=valid)


def _binary_concat(args, kwargs):
    a, b = args[0], args[1]
    n = max(len(a), len(b))
    a = a.broadcast(n) if len(a) == 1 and n != 1 else a
    b = b.broadcast(n) if len(b) == 1 and n != 1 else b
    valid = a.validity_numpy() & b.validity_numpy()
    out = [x + y if ok else None for x, y, ok in zip(a.to_numpy().tolist(),
                                                     b.to_numpy().tolist(), valid.tolist())]
    return Series.from_pylist(out, a.name, a.dtype if a.dtype.kind == "binary" else _B)


def _binary_slice(args, kwargs):
    s = args[0]
    start = int(kwargs.get("start", 0))
    length = kwargs.get("length")
    out = [None if v is None
           else (v[start:start + int(length)] if length is not None else v[start:])
           for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, dtype=_B)


register("binary_length", _rt_const(_U64), _binary_length)
register("binary_concat", _rt_same, _binary_concat)
register("binary_slice", _rt_const(_B), _binary_slice)
register("encode_hex", _rt_const(_S), _value_map(lambda v, k: _as_bytes(v).hex(), _S))
register("decode_hex", _rt_const(_B), _value_map(lambda v, k: binascii.unhexlify(v), _B))
register("encode_base64", _rt_const(_S),
         _value_map(lambda v, k: _b64.b64encode(_as_bytes(v)).decode(), _S))
register("decode_base64", _rt_const(_B), _value_map(lambda v, k: _b64.b64decode(v), _B))


def _hasher(name):
    def one(v, _k):
        return hashlib.new(name, _as_bytes(v)).hexdigest()
    return one


for _algo in ("md5", "sha1", "sha256", "sha512"):
    register(_algo, _rt_const(_S), _value_map(_hasher(_algo), _S))


# ---- JSON (extra.py:150-186) -------------------------------------------------------------


def _json_get(doc, path: str):
    """The reference's jsonpath subset: $.a.b[2].c, object keys and array
    indices."""
    cur = doc
    if path.startswith("$"):
        path = path[1:]
    for part in path.replace("]", "").split("."):
        if not part:
            continue
        for piece in part.split("["):
            if piece == "":
                continue
            if cur is None:
                return None
            if isinstance(cur, list):
                try:
                    cur = cur[int(piece)]
                except (ValueError, IndexError):
                    return None
            elif isinstance(cur, dict):
                cur = cur.get(piece)
            else:
                return None
    return cur


def _json_query(args, kwargs):
    s = args[0]
    path = kwargs.get("path", "$")
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
            continue
        try:
            res = _json_get(_json.loads(v), path)
        except (ValueError, TypeError):
            res = None
        if res is None:
            out.append(None)
        elif isinstance(res, str):
            out.append(res)
        else:
            out.append(_json.dumps(res))
    return Series.from_pylist(out, s.name, dtype=_S)


register("json_query", _rt_const(_S), _json_query)
register("to_json", _rt_const(_S), _value_map(lambda v, k: _json.dumps(v, default=str), _S))


# ---- URLs, compression and serialization (breadth.py:110-230) ----------------------------

_URL_STRUCT = DataType.struct({
    "scheme": _S, "username": _S, "password": _S, "host": _S, "port": DataType.int32(),
    "path": _S, "query": _S, "fragment": _S})


def _parse_url(v: str, kwargs):
    from urllib.parse import urlsplit

    try:
        u = urlsplit(v)
    except ValueError:
        return None
    # an out-of-range port raises, as the reference's (breadth.py:120-129)
    return {"scheme": u.scheme or None, "username": u.username, "password": u.password,
            "host": u.hostname, "port": u.port, "path": u.path or None,
            "query": u.query or None, "fragment": u.fragment or None}


register("parse_url", _rt_const(_URL_STRUCT), _value_map(_parse_url, _URL_STRUCT))

_CODECS = {
    "gzip": (_gzip.compress, _gzip.decompress),
    "zlib": (_zlib.compress, _zlib.decompress),
    "deflate": (_zlib.compress, _zlib.decompress),
    "bz2": (_bz2.compress, _bz2.decompress),
}


def _codec(kwargs):
    codec = kwargs.get("codec", "gzip")
    if codec not in _CODECS:
        raise ValueError(f"unknown codec {codec!r}; supported: {sorted(_CODECS)}")
    return _CODECS[codec]


def _compress(v, kwargs):
    return _codec(kwargs)[0](_as_bytes(v))


def _decompress(v, kwargs):
    return _codec(kwargs)[1](v)


def _try(fn):
    """Row errors as nulls; an unknown codec still raises."""
    def wrapped(v, kwargs):
        try:
            return fn(v, kwargs)
        except ValueError:
            raise
        except Exception:  # lint: ignore[broad-except] -- a row's failure is its null
            return None
    return wrapped


register("compress", _rt_const(_B), _value_map(_compress, _B))
register("decompress", _rt_const(_B), _value_map(_decompress, _B))
register("try_compress", _rt_const(_B), _value_map(_try(_compress), _B))
register("try_decompress", _rt_const(_B), _value_map(_try(_decompress), _B))


def _serialize(v, kwargs):
    fmt = kwargs.get("format", "json")
    if fmt != "json":
        raise ValueError(f"unsupported serialize format {fmt!r} (supported: json)")
    return _json.dumps(v, default=str)


register("serialize", _rt_const(_S), _value_map(_serialize, _S))


def _rt_deserialize(fields, kwargs):
    dt = kwargs.get("dtype")
    return dt if dt is not None else _S


def _deserialize(args: List[Series], kwargs) -> Series:
    s = args[0]
    fmt = kwargs.get("format", "json")
    if fmt != "json":
        raise ValueError(f"unsupported deserialize format {fmt!r} (supported: json)")
    dt = kwargs.get("dtype") or _S
    strict = kwargs.get("strict", True)
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
            continue
        try:
            out.append(_json.loads(v))
        except Exception:  # lint: ignore[broad-except] -- try_deserialize: a bad row is null
            if strict:
                raise
            out.append(None)
    if dt.is_string() and any(v is not None and not isinstance(v, str) for v in out):
        # Arrow refuses a parsed object as a string (the reference's TypeError)
        raise TypeError("deserialize: a parsed value is not a string; pass dtype=")
    return Series.from_pylist(out, s.name, dtype=dt)


register("deserialize", _rt_deserialize, _deserialize)
register("try_deserialize", _rt_deserialize,
         lambda a, k: _deserialize(a, {**k, "strict": False}))

# ---- codecs (breadth.py:445-520) ---------------------------------------------------------

_TEXT_CODECS = {"utf-8", "utf8", "ascii", "latin-1"}


def _encode(v, kwargs):
    codec = kwargs.get("codec", "utf-8")
    if codec in _TEXT_CODECS:
        return v.encode(codec) if isinstance(v, str) else v
    if codec == "base64":
        return _b64.b64encode(_as_bytes(v))
    if codec == "hex":
        return _as_bytes(v).hex().encode()
    if codec in _CODECS:
        return _compress(v, {"codec": codec})
    raise ValueError(f"unknown codec {codec!r}")


def _decode(v, kwargs):
    codec = kwargs.get("codec", "utf-8")
    if codec in _TEXT_CODECS:
        return v.decode(codec) if isinstance(v, (bytes, bytearray)) else v
    if codec == "base64":
        return _b64.b64decode(v)
    if codec == "hex":
        return bytes.fromhex(v.decode() if isinstance(v, (bytes, bytearray)) else v)
    if codec in _CODECS:
        return _decompress(v, {"codec": codec})
    raise ValueError(f"unknown codec {codec!r}")


def _rt_codec_decode(fields, kwargs):
    return _S if kwargs.get("codec", "utf-8") in _TEXT_CODECS else _B


def _decode_host(args: List[Series], kwargs) -> Series:
    s = args[0]
    dt = _rt_codec_decode(None, kwargs)
    strict = kwargs.get("strict", True)
    out = []
    for v in s.to_pylist():
        if v is None:
            out.append(None)
            continue
        try:
            out.append(_decode(v, kwargs))
        except ValueError:
            raise
        except Exception:  # lint: ignore[broad-except] -- try_codec_decode: a bad row is null
            if strict:
                raise
            out.append(None)
    return Series.from_pylist(out, s.name, dtype=dt)


register("codec_encode", _rt_const(_B), _value_map(_encode, _B))
register("try_codec_encode", _rt_const(_B), _value_map(_try(_encode), _B))
register("codec_decode", _rt_codec_decode, _decode_host)
register("try_codec_decode", _rt_codec_decode,
         lambda a, k: _decode_host(a, {**k, "strict": False}))

# ---- Iceberg partitions (breadth.py:540-602) ---------------------------------------------

_M32 = np.uint64(0xFFFFFFFF)


def _rotl32(x: np.ndarray, r: int) -> np.ndarray:
    return ((x << np.uint64(r)) | (x >> np.uint64(32 - r))) & _M32


def _mix_k(k: np.ndarray) -> np.ndarray:
    k = (k * np.uint64(0xCC9E2D51)) & _M32
    k = _rotl32(k, 15)
    return (k * np.uint64(0x1B873593)) & _M32


def murmur3_32_int64(vals: np.ndarray) -> np.ndarray:
    """murmur3 x86 32-bit (seed 0) of each int64 as its 8 little-endian
    bytes, in numpy: Iceberg's bucket hash of a long."""
    u = np.ascontiguousarray(vals, dtype=np.int64).view(np.uint64)
    h = np.zeros(len(u), dtype=np.uint64)
    with np.errstate(over="ignore"):
        for block in (u & _M32, u >> np.uint64(32)):
            h ^= _mix_k(block)
            h = _rotl32(h, 13)
            h = (h * np.uint64(5) + np.uint64(0xE6546B64)) & _M32
        h ^= np.uint64(8)
        h ^= h >> np.uint64(16)
        h = (h * np.uint64(0x85EBCA6B)) & _M32
        h ^= h >> np.uint64(13)
        h = (h * np.uint64(0xC2B2AE35)) & _M32
        h ^= h >> np.uint64(16)
    return h


def murmur3_32(data: bytes, seed: int = 0) -> int:
    """murmur3 x86 32-bit of one byte string."""
    c1, c2 = 0xCC9E2D51, 0x1B873593
    h = seed & 0xFFFFFFFF
    n = len(data)
    for i in range(0, n - n % 4, 4):
        k = int.from_bytes(data[i:i + 4], "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
        h = ((h << 13) | (h >> 19)) & 0xFFFFFFFF
        h = (h * 5 + 0xE6546B64) & 0xFFFFFFFF
    tail = data[n - n % 4:]
    if tail:
        k = int.from_bytes(tail.ljust(4, b"\0"), "little")
        k = (k * c1) & 0xFFFFFFFF
        k = ((k << 15) | (k >> 17)) & 0xFFFFFFFF
        k = (k * c2) & 0xFFFFFFFF
        h ^= k
    h ^= n
    h ^= h >> 16
    h = (h * 0x85EBCA6B) & 0xFFFFFFFF
    h ^= h >> 13
    h = (h * 0xC2B2AE35) & 0xFFFFFFFF
    h ^= h >> 16
    return h


def _iceberg_bucket(args: List[Series], kwargs) -> Series:
    """(murmur3 of the value's Iceberg bytes & 0x7FFFFFFF) % n: an integer
    as 8 little-endian bytes, a string as UTF-8, binary as it is; any other
    type raises ValueError, as the reference's."""
    s = args[0]
    n = int(kwargs["n"])
    dt = s.dtype
    valid = s.validity_numpy()
    if dt.is_integer():
        h = murmur3_32_int64(s.to_numpy().astype(np.int64))
        out = ((h & np.uint64(0x7FFFFFFF)) % np.uint64(n)).astype(np.int32)
        return Series.from_numpy(np.where(valid, out, 0).astype(np.int32), s.name,
                                 DataType.int32(), validity=valid)
    if not (dt.is_string() or dt.is_binary()):
        raise ValueError(f"iceberg_bucket unsupported for {dt}")
    out = [None if v is None else (murmur3_32(_as_bytes(v)) & 0x7FFFFFFF) % n
           for v in s.to_pylist()]
    return Series.from_pylist(out, s.name, dtype=DataType.int32())


register("partition_iceberg_bucket", _rt_const(DataType.int32()), _iceberg_bucket)


def _iceberg_truncate(args: List[Series], kwargs) -> Series:
    """An integer floored to a multiple of ``w``, a string's first ``w``
    characters (breadth.py:583-602)."""
    s = args[0]
    w = int(kwargs["w"])
    dt = s.dtype
    if dt.is_integer():
        vals = s.to_numpy().astype(np.int64)
        out = vals - (((vals % w) + w) % w)
        valid = s.validity_numpy()
        return Series.from_numpy(np.where(valid, out, 0), s.name, DataType.int64(),
                                 validity=valid).cast(dt)
    if dt.is_string():
        return Series.from_pylist([None if v is None else v[:w] for v in s.to_pylist()],
                                  s.name, dtype=_S)
    raise ValueError(f"iceberg_truncate unsupported for {dt}")


register("partition_iceberg_truncate", _rt_same, _iceberg_truncate)
