"""The port's host kernel library (counterpart of daft_tpu/native.py): the
C++ of csrc/kernels.cpp, loaded with ctypes, and a plain numpy version of
every wrapper.

The library builds at first use with the host compiler (ops/_build.py
``host_library``: ``$CXX``, else ``c++``) into ops/_kbuild/, named by a hash
of its source. A failed build or load raises: no caller drops to numpy
behind the library's back. ``DAFT_TPU_DISABLE_NATIVE`` set (any value but
a falsy one, read on every call, so a process may toggle it) is the one way
to run the plain versions instead; the tests hold each wrapper to them.

The library is loaded with ``ctypes.CDLL``, so every call drops the GIL for
its whole length: the pipeline's pool threads overlap them. ``CALLS`` counts
the library's calls per export (the plain versions count nothing); it is
not a metric of the registry, so a host query's registry diff stays empty.

The wrappers keep the reference's names, arguments and results. Where a
reference wrapper returns None to route a dtype back to its caller, this
one does too, with the reason beside it. Each plain version returns what
its wrapper returns, bit for bit: f64 sums add in row order
(``np.add.at`` is sequential, as the C loop is), integer sums wrap mod 2^64.
The one exception is a map's layout: ``plain_i64_map_build`` gives a
``PlainMap`` (sorted keys), whose lookups equal the library table's; a
plain lookup also reads a table the library built, by the kernel's own
linear probing.
"""

from __future__ import annotations

import collections
import ctypes
import os
import threading
from typing import NamedTuple, Optional

import numpy as np

from .utils.env import env_bool

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "kernels.cpp")
DISABLE_ENV = "DAFT_TPU_DISABLE_NATIVE"

_I64P = ctypes.POINTER(ctypes.c_int64)
_U64P = ctypes.POINTER(ctypes.c_uint64)
_F64P = ctypes.POINTER(ctypes.c_double)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64 = ctypes.c_int64
_U64 = ctypes.c_uint64

# export -> (restype, argtypes): the 25 functions of csrc/kernels.cpp
EXPORTS = {
    "xxhash64": (_U64, [_U8P, _U64, _U64]),
    "hash_binary_column": (None, [_U8P, _I64P, _I64, _U64, _U64P]),
    "hash_u64_column": (None, [_U64P, _I64, _U64, _U64P]),
    "factorize_i64": (_I64, [_I64P, _I64, _I64P]),
    "combine_factorize_i64": (_I64, [_I64P, _I64P, _I64, _I64, _I64P]),
    "grouped_sum_f64": (None, [_I64P, _F64P, _U8P, _I64, _I64, _F64P, _I64P]),
    "grouped_sum_i64": (None, [_I64P, _I64P, _U8P, _I64, _I64, _I64P, _I64P]),
    "grouped_minmax_f64": (None, [_I64P, _F64P, _U8P, _I64, _I64, _F64P, _F64P]),
    "grouped_minmax_i64": (None, [_I64P, _I64P, _U8P, _I64, _I64, _I64P, _I64P]),
    "join_count": (_I64, [_I64P, _I64, _I64P, _I64, _I64, _I64P, _I64P]),
    "join_fill": (None, [_I64P, _I64, _I64P, _I64, _I64, _I64P, _I64P, _I64P, _I64P]),
    "probe_count": (_I64, [_I64P, _I64, _I64, _I64P, _I64P]),
    "i64_map_build": (None, [_I64P, _I64, _I64, _I64P, _I64P]),
    "i64_map_lookup": (None, [_I64P, _I64P, _I64, _I64P, _I64, _I64P]),
    "bool_mask_indices": (_I64, [_U8P, _U8P, _I64, _I64, _I64P]),
    "i64_pairmap_build": (None, [_I64P, _I64, _I64, _I64P]),
    "i64_pairmap_lookup": (None, [_I64P, _I64, _I64P, _I64, _I64P]),
    "probe_lookup_count_pair": (_I64, [_I64P, _U8P, _I64, _I64P, _I64, _I64P, _I64,
                                       _I64P, _I64P]),
    "probe_fill": (None, [_I64P, _I64, _I64, _I64P, _I64P, _I64P, _I64P, _I64P]),
    "probe_lookup_count_hash": (_I64, [_I64P, _U8P, _I64, _I64P, _I64P, _I64, _I64P,
                                       _I64, _I64P, _I64P]),
    "probe_lookup_count_dense": (_I64, [_I64P, _U8P, _I64, _I64, _I64, _I64P, _I64,
                                        _I64P, _I64P]),
    "bucket_build": (_I64, [_I64P, _I64, _I64, _I64P, _I64P]),
    "probe_unique_pair": (_I64, [_I64P, _U8P, _I64, _I64P, _I64, _I64P, _I64P, _I64P]),
    "probe_unique_dense": (_I64, [_I64P, _U8P, _I64, _I64, _I64, _I64P, _I64P, _I64P,
                                  _I64P]),
    "bucket_scatter": (None, [_I64P, _I64, _I64, _I64P, _I64P]),
}

# the port's own exports, beyond the reference's library: export -> (restype, argtypes)
PORT_EXPORTS = {
    "png_unfilter": (_I64, [_U8P, _I64, _I64, _I64, _U8P]),
}

_LIB: Optional[ctypes.CDLL] = None
_COUNT_LOCK = threading.Lock()
CALLS: collections.Counter = collections.Counter()


def disabled() -> bool:
    """Whether ``DAFT_TPU_DISABLE_NATIVE`` selects the plain versions."""
    return env_bool(DISABLE_ENV, False)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set ``restype`` / ``argtypes`` of every export on ``lib`` (the port's
    library, or another build of the same source)."""
    for name, (restype, argtypes) in EXPORTS.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use; raises when the build or the
    load fails."""
    global _LIB
    if _LIB is None:
        from .ops._build import host_library

        lib = declare(host_library(SOURCE))
        for name, (restype, argtypes) in PORT_EXPORTS.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _LIB = lib
    return _LIB


def calls() -> dict:
    """The library's calls per export so far."""
    with _COUNT_LOCK:
        return dict(CALLS)


def _call(name: str, *args):
    lib = get_lib()
    with _COUNT_LOCK:
        CALLS[name] += 1
    return getattr(lib, name)(*args)


def _need(cond: bool, what: str) -> None:
    """Refuse arguments a kernel would read or write past: the C side takes
    pointers and checks no length."""
    if not cond:
        raise ValueError(what)


def _i64(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.int64)


def _u8(mask: np.ndarray) -> np.ndarray:
    """A boolean (or 0/1) mask as contiguous uint8, without a copy where it
    is already a contiguous bool array."""
    mask = np.ascontiguousarray(mask)
    return mask.view(np.uint8) if mask.dtype == np.bool_ else mask.astype(np.uint8)


def _p(arr: np.ndarray, ctype=ctypes.c_int64):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _p8(arr: Optional[np.ndarray]):
    return None if arr is None else _p(arr, ctypes.c_uint8)


def _empty(n: int, dtype=np.int64) -> np.ndarray:
    # a kernel takes its output pointer even when it writes nothing
    return np.empty(max(int(n), 1), dtype=dtype)


# ---- hashing -------------------------------------------------------------------------

_M64 = (1 << 64) - 1
_XP1, _XP2, _XP3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_XP4, _XP5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5


def native_xxhash64(data: bytes, seed: int = 0) -> int:
    """xxHash64 of ``data``."""
    if disabled():
        return plain_xxhash64(data, seed)
    buf = np.frombuffer(bytes(data) or b"\0", dtype=np.uint8)
    return int(_call("xxhash64", _p8(buf), len(data), seed & _M64))


def native_hash_binary_column(data: np.ndarray, offsets: np.ndarray, seed: int = 0) -> np.ndarray:
    """xxHash64 of each value of a binary column given as one uint8 buffer
    and n + 1 int64 offsets (Arrow's layout)."""
    offsets = _i64(offsets)
    n = max(len(offsets) - 1, 0)
    if disabled():
        return plain_hash_binary_column(data, offsets, seed)
    data = np.ascontiguousarray(data, dtype=np.uint8)
    _need(n == 0 or (offsets[0] >= 0 and offsets[-1] <= len(data)),
          "offsets run past the data buffer")
    data = data if len(data) else np.zeros(1, dtype=np.uint8)
    out = _empty(n, np.uint64)
    _call("hash_binary_column", _p8(data), _p(offsets), n, seed & _M64, _p(out, ctypes.c_uint64))
    return out[:n]


def _u64(vals) -> np.ndarray:
    """8-byte values as their uint64 bits; narrower integers widened."""
    vals = np.ascontiguousarray(vals)
    return vals.view(np.uint64) if vals.dtype.itemsize == 8 else vals.astype(np.uint64)


def native_hash_u64_column(vals: np.ndarray, seed: int = 0) -> np.ndarray:
    """xxHash64 of each value's 8 little-endian bytes."""
    vals = _u64(vals)
    if disabled():
        return plain_hash_u64_column(vals, seed)
    out = _empty(len(vals), np.uint64)
    _call("hash_u64_column", _p(vals, ctypes.c_uint64), len(vals), seed & _M64,
          _p(out, ctypes.c_uint64))
    return out[:len(vals)]


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round1(acc: int, lane: int) -> int:
    acc = (acc + lane * _XP2) & _M64
    return (_rotl(acc, 31) * _XP1) & _M64


def plain_xxhash64(data: bytes, seed: int = 0) -> int:
    data = bytes(data)
    seed &= _M64
    n, p = len(data), 0

    def word(at: int, size: int) -> int:
        return int.from_bytes(data[at:at + size], "little")

    if n >= 32:
        v = [(seed + _XP1 + _XP2) & _M64, (seed + _XP2) & _M64, seed, (seed - _XP1) & _M64]
        while p + 32 <= n:
            for k in range(4):
                v[k] = _round1(v[k], word(p, 8))
                p += 8
        h = (_rotl(v[0], 1) + _rotl(v[1], 7) + _rotl(v[2], 12) + _rotl(v[3], 18)) & _M64
        for k in range(4):
            h = ((h ^ _round1(0, v[k])) * _XP1 + _XP4) & _M64
    else:
        h = (seed + _XP5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round1(0, word(p, 8))
        h = (_rotl(h, 27) * _XP1 + _XP4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (word(p, 4) * _XP1) & _M64
        h = (_rotl(h, 23) * _XP2 + _XP3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _XP5) & _M64
        h = (_rotl(h, 11) * _XP1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _XP2) & _M64
    h ^= h >> 29
    h = (h * _XP3) & _M64
    return h ^ (h >> 32)


def plain_hash_binary_column(data: np.ndarray, offsets: np.ndarray, seed: int = 0) -> np.ndarray:
    buf = np.asarray(data, dtype=np.uint8).tobytes()
    offsets = _i64(offsets)
    return np.array([plain_xxhash64(buf[offsets[i]:offsets[i + 1]], seed)
                     for i in range(max(len(offsets) - 1, 0))], dtype=np.uint64)


def plain_hash_u64_column(vals: np.ndarray, seed: int = 0) -> np.ndarray:
    """xxHash64 of 8-byte values, vectorized (uint64 arithmetic wraps)."""
    v = _u64(vals)
    u = np.uint64
    with np.errstate(over="ignore"):
        k = v * u(_XP2)
        k = ((k << u(31)) | (k >> u(33))) * u(_XP1)
        h = u((seed + _XP5 + 8) & _M64) ^ k
        h = ((h << u(27)) | (h >> u(37))) * u(_XP1) + u(_XP4)
        h ^= h >> u(33)
        h *= u(_XP2)
        h ^= h >> u(29)
        h *= u(_XP3)
        h ^= h >> u(32)
    return h.astype(np.uint64)


# ---- factorize -----------------------------------------------------------------------


def native_factorize(keys: np.ndarray) -> tuple:
    """(codes, number of distinct keys): each key's code in first-occurrence
    order (any int64 is a key, -1 too)."""
    keys = _i64(keys)
    if disabled():
        return plain_factorize(keys)
    out = _empty(len(keys))
    g = _call("factorize_i64", _p(keys), len(keys), _p(out))
    return out[:len(keys)], int(g)


def native_combine_factorize(a: np.ndarray, b: np.ndarray, b_domain: int) -> tuple:
    """factorize((a + 1) * (b_domain + 2) + (b + 1)): the codes of the pairs
    (a, b) in first-occurrence order. ``a`` and ``b`` are codes >= -1 with
    b < b_domain, so the pair stays below (n + 1) * (b_domain + 2)."""
    a, b = _i64(a), _i64(b)
    _need(len(a) == len(b), "a and b differ in length")
    if disabled():
        return plain_combine_factorize(a, b, b_domain)
    out = _empty(len(a))
    g = _call("combine_factorize_i64", _p(a), _p(b), len(a), int(b_domain), _p(out))
    return out[:len(a)], int(g)


def plain_factorize(keys: np.ndarray) -> tuple:
    keys = _i64(keys)
    if len(keys) == 0:
        return np.empty(0, dtype=np.int64), 0
    uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    rank = np.empty(len(uniq), dtype=np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(len(uniq), dtype=np.int64)
    return rank[inv.reshape(-1)], len(uniq)


def plain_combine_factorize(a: np.ndarray, b: np.ndarray, b_domain: int) -> tuple:
    return plain_factorize((_i64(a) + 1) * (int(b_domain) + 2) + (_i64(b) + 1))


# ---- grouped aggregation -------------------------------------------------------------


def native_grouped_sum(gids: np.ndarray, vals: np.ndarray, valid: np.ndarray,
                       num_groups: int) -> Optional[tuple]:
    """(sums, counts) of the valid rows per group, in row order; None unless
    ``vals`` is float64 or int64 (the caller picks the type to sum in)."""
    if vals.dtype not in (np.float64, np.int64):
        return None
    gids, valid8 = _i64(gids), _u8(valid)
    vals = np.ascontiguousarray(vals)
    _need(len(gids) == len(vals) == len(valid8), "gids, vals and valid differ in length")
    if disabled():
        return plain_grouped_sum(gids, vals, valid8, num_groups)
    f = vals.dtype == np.float64
    out = _empty(num_groups, vals.dtype)
    cnt = _empty(num_groups)
    _call("grouped_sum_f64" if f else "grouped_sum_i64", _p(gids),
          _p(vals, ctypes.c_double if f else ctypes.c_int64), _p8(valid8), len(gids),
          int(num_groups), _p(out, ctypes.c_double if f else ctypes.c_int64), _p(cnt))
    return out[:num_groups], cnt[:num_groups]


def native_grouped_minmax(gids: np.ndarray, vals: np.ndarray, valid: np.ndarray,
                          num_groups: int) -> Optional[tuple]:
    """(min, max) of the valid rows per group by a strict compare in row
    order: NaN never wins, an empty or all-NaN group keeps the identity
    (+inf / -inf, INT64_MAX / INT64_MIN), and of equal values (0.0 and
    -0.0) the first stays. None unless ``vals`` is float64 or int64."""
    if vals.dtype not in (np.float64, np.int64):
        return None
    gids, valid8 = _i64(gids), _u8(valid)
    vals = np.ascontiguousarray(vals)
    _need(len(gids) == len(vals) == len(valid8), "gids, vals and valid differ in length")
    if disabled():
        return plain_grouped_minmax(gids, vals, valid8, num_groups)
    f = vals.dtype == np.float64
    ct = ctypes.c_double if f else ctypes.c_int64
    mn = _empty(num_groups, vals.dtype)
    mx = _empty(num_groups, vals.dtype)
    _call("grouped_minmax_f64" if f else "grouped_minmax_i64", _p(gids), _p(vals, ct),
          _p8(valid8), len(gids), int(num_groups), _p(mn, ct), _p(mx, ct))
    return mn[:num_groups], mx[:num_groups]


def plain_grouped_sum(gids, vals, valid, num_groups: int) -> Optional[tuple]:
    if vals.dtype not in (np.float64, np.int64):
        return None
    keep = np.asarray(valid).astype(bool)
    g = _i64(gids)[keep]
    out = np.zeros(num_groups, dtype=vals.dtype)
    with np.errstate(invalid="ignore", over="ignore"):
        np.add.at(out, g, vals[keep])
    return out, np.bincount(g, minlength=num_groups).astype(np.int64)[:num_groups]


def plain_grouped_minmax(gids, vals, valid, num_groups: int) -> Optional[tuple]:
    if vals.dtype not in (np.float64, np.int64):
        return None
    keep = np.asarray(valid).astype(bool)
    g, v = _i64(gids)[keep], vals[keep]
    if vals.dtype == np.int64:
        mn = np.full(num_groups, np.iinfo(np.int64).max, dtype=np.int64)
        mx = np.full(num_groups, np.iinfo(np.int64).min, dtype=np.int64)
        np.minimum.at(mn, g, v)
        np.maximum.at(mx, g, v)
        return mn, mx
    return _float_extreme(np.minimum, g, v, num_groups), \
        _float_extreme(np.maximum, g, v, num_groups)


def _float_extreme(uf, g: np.ndarray, v: np.ndarray, num_groups: int) -> np.ndarray:
    """The C loop's strict compare, vectorized: the extreme over the non-NaN
    values, then the value itself from the group's first row equal to it
    (0.0 and -0.0 compare equal, and the first stays)."""
    ok = ~np.isnan(v)
    acc = np.full(num_groups, np.inf if uf is np.minimum else -np.inf)
    uf.at(acc, g[ok], v[ok])
    hit = np.flatnonzero(ok & (v == acc[g]))
    first = np.full(num_groups, len(v), dtype=np.int64)
    np.minimum.at(first, g[hit], hit)
    found = first < len(v)
    acc[found] = v[first[found]]
    return acc


# ---- the bucket join -----------------------------------------------------------------


def native_join_counts(lcodes: np.ndarray, rcodes: np.ndarray, num_codes: int) -> np.ndarray:
    """Each left row's number of right rows with its code (semi and anti
    joins need no pairs). Codes lie in [0, num_codes); a negative one never
    matches."""
    lcodes, rcodes = _i64(lcodes), _i64(rcodes)
    if disabled():
        return plain_join_counts(lcodes, rcodes, num_codes)
    nl, nr = len(lcodes), len(rcodes)
    bucket_counts = _empty(num_codes)
    l_match = _empty(nl)
    _call("join_count", _p(lcodes), nl, _p(rcodes), nr, int(num_codes), _p(bucket_counts),
          _p(l_match))
    return l_match[:nl]


def native_join_indices(lcodes: np.ndarray, rcodes: np.ndarray, num_codes: int) -> tuple:
    """(left rows, right rows, each left row's match count) of the inner
    join on codes: left-major, a left row's right rows in row order."""
    lcodes, rcodes = _i64(lcodes), _i64(rcodes)
    if disabled():
        return plain_join_indices(lcodes, rcodes, num_codes)
    nl, nr = len(lcodes), len(rcodes)
    bucket_counts = _empty(num_codes)
    l_match = _empty(nl)
    total = _call("join_count", _p(lcodes), nl, _p(rcodes), nr, int(num_codes),
                  _p(bucket_counts), _p(l_match))
    offsets = _i64(np.cumsum(bucket_counts[:num_codes]) - bucket_counts[:num_codes]) \
        if num_codes else np.zeros(1, dtype=np.int64)
    bucket_rows = _empty(nr)
    out_l, out_r = _empty(total), _empty(total)
    _call("join_fill", _p(lcodes), nl, _p(rcodes), nr, int(num_codes), _p(offsets),
          _p(bucket_rows), _p(out_l), _p(out_r))
    return out_l[:total], out_r[:total], l_match[:nl]


def _code_counts(codes: np.ndarray, num_codes: int) -> np.ndarray:
    return np.bincount(codes[codes >= 0], minlength=num_codes).astype(np.int64)[:max(num_codes, 0)]


def _match_counts(lcodes: np.ndarray, counts: np.ndarray, num_codes: int) -> np.ndarray:
    hit = (lcodes >= 0) & (lcodes < num_codes)
    return np.where(hit, counts[np.where(hit, lcodes, 0)] if num_codes else 0, 0).astype(np.int64)


def _expand(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The ranges [starts[i], starts[i] + counts[i]) concatenated."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    return np.repeat(starts - (np.cumsum(counts) - counts), counts) \
        + np.arange(total, dtype=np.int64)


def plain_join_counts(lcodes, rcodes, num_codes: int) -> np.ndarray:
    return _match_counts(_i64(lcodes), _code_counts(_i64(rcodes), num_codes), num_codes)


def plain_join_indices(lcodes, rcodes, num_codes: int) -> tuple:
    lcodes, rcodes = _i64(lcodes), _i64(rcodes)
    counts = _code_counts(rcodes, num_codes)
    pos = rcodes >= 0
    rows = np.flatnonzero(pos)[np.argsort(rcodes[pos], kind="stable")]
    return plain_probe(lcodes, num_codes, np.cumsum(counts) - counts, counts, rows)


# ---- the probe table -----------------------------------------------------------------


def native_probe(lcodes: np.ndarray, num_codes: int, bucket_offsets: np.ndarray,
                 bucket_counts: np.ndarray, bucket_rows: np.ndarray) -> tuple:
    """(left rows, right rows, match counts) of left codes probed into
    buckets built once (``native_bucket_build`` / ``native_bucket_scatter``);
    the buckets are read only, so pool threads probe them at once."""
    lcodes = _i64(lcodes)
    _buckets_hold(num_codes, bucket_offsets, bucket_counts)
    if disabled():
        return plain_probe(lcodes, num_codes, bucket_offsets, bucket_counts, bucket_rows)
    nl = len(lcodes)
    l_match = _empty(nl)
    total = _call("probe_count", _p(lcodes), nl, int(num_codes), _p(bucket_counts),
                  _p(l_match))
    out_l, out_r = _empty(total), _empty(total)
    _call("probe_fill", _p(lcodes), nl, int(num_codes), _p(bucket_offsets),
          _p(bucket_counts), _p(bucket_rows), _p(out_l), _p(out_r))
    return out_l[:total], out_r[:total], l_match[:nl]


def _buckets_hold(num_codes: int, *tables) -> None:
    _need(all(len(t) >= num_codes for t in tables), f"a bucket table is shorter than its "
                                                    f"{num_codes} codes")


def plain_probe(lcodes, num_codes: int, bucket_offsets, bucket_counts, bucket_rows) -> tuple:
    lcodes = _i64(lcodes)
    l_match = _match_counts(lcodes, bucket_counts, num_codes)
    hit = l_match > 0
    starts = np.where(hit, bucket_offsets[np.where(hit, lcodes, 0)] if num_codes else 0, 0)
    matched_l = np.repeat(np.arange(len(lcodes), dtype=np.int64), l_match)
    return matched_l, _i64(bucket_rows)[_expand(_i64(starts), l_match)], l_match


def native_bucket_build(codes: np.ndarray, num_codes: int) -> tuple:
    """(counts, exclusive offsets, largest count) per code; a negative code
    is left out. A largest count of 1 means unique build keys."""
    codes = _i64(codes)
    if disabled():
        return plain_bucket_build(codes, num_codes)
    g = max(int(num_codes), 1)
    counts, offsets = np.empty(g, dtype=np.int64), np.empty(g, dtype=np.int64)
    mx = _call("bucket_build", _p(codes), len(codes), g, _p(counts), _p(offsets))
    return counts[:num_codes], offsets[:num_codes], int(mx)


def native_bucket_scatter(codes: np.ndarray, num_codes: int, offsets: np.ndarray,
                          total: int) -> np.ndarray:
    """The rows of each code from its offset on, in row order (a stable
    counting sort, O(n + num_codes))."""
    codes, offsets = _i64(codes), _i64(offsets)
    _buckets_hold(num_codes, offsets)
    if disabled():
        return plain_bucket_scatter(codes, num_codes, offsets, total)
    rows = _empty(total)
    offs = offsets if len(offsets) else np.zeros(1, dtype=np.int64)
    _call("bucket_scatter", _p(codes), len(codes), max(int(num_codes), 1), _p(offs), _p(rows))
    return rows[:total]


def plain_bucket_build(codes, num_codes: int) -> tuple:
    counts = _code_counts(_i64(codes), num_codes)
    return counts, np.cumsum(counts) - counts, int(counts.max(initial=0))


def plain_bucket_scatter(codes, num_codes: int, offsets, total: int) -> np.ndarray:
    codes = _i64(codes)
    pos = codes >= 0
    return np.flatnonzero(pos)[np.argsort(codes[pos], kind="stable")].astype(np.int64)


class PlainMap(NamedTuple):
    """The plain versions' int64 map: the keys sorted, and each one's
    position among the keys it was built from."""
    keys: np.ndarray
    rows: np.ndarray


def _map_cap(n: int) -> int:
    cap = 1
    while cap < max(2 * n, 16):
        cap <<= 1
    return cap


def native_i64_map_build(keys: np.ndarray) -> tuple:
    """(slots, cap): an open-addressed map of unique int64 keys to their
    positions, (key, position) pairs interleaved so one probe reads one
    cache line. Read only once built. The plain version gives
    (``PlainMap``, its size)."""
    keys = _i64(keys)
    if disabled():
        return plain_i64_map_build(keys)
    cap = _map_cap(len(keys))
    slots = np.full(2 * cap, -1, dtype=np.int64)  # an empty slot: key and value -1
    _call("i64_pairmap_build", _p(keys), len(keys), cap, _p(slots))
    return slots, cap


def native_i64_map_lookup(slots, cap: int, vals: np.ndarray) -> np.ndarray:
    """Each value's position among the map's keys, -1 where absent."""
    vals = _i64(vals)
    if disabled() or isinstance(slots, PlainMap):
        return plain_i64_map_lookup(slots, cap, vals)
    _need(len(slots) == 2 * cap, "slots do not hold 2 x cap entries")
    out = _empty(len(vals))
    _call("i64_pairmap_lookup", _p(slots), int(cap), _p(vals), len(vals), _p(out))
    return out[:len(vals)]


def native_i64_split_map_build(keys: np.ndarray) -> tuple:
    """(slot_keys, slot_vals, cap): the same map with keys and positions in
    two arrays (the library's other layout; no engine caller)."""
    keys = _i64(keys)
    if disabled():
        pm, n = plain_i64_map_build(keys)
        return pm, None, n
    cap = _map_cap(len(keys))
    slot_keys = np.full(cap, -1, dtype=np.int64)
    slot_vals = np.full(cap, -1, dtype=np.int64)
    _call("i64_map_build", _p(keys), len(keys), cap, _p(slot_keys), _p(slot_vals))
    return slot_keys, slot_vals, cap


def native_i64_split_map_lookup(slot_keys, slot_vals, cap: int, vals: np.ndarray) -> np.ndarray:
    vals = _i64(vals)
    if disabled() or isinstance(slot_keys, PlainMap):
        return plain_i64_split_map_lookup(slot_keys, slot_vals, cap, vals)
    _need(len(slot_keys) == len(slot_vals) == cap, "the slot arrays do not hold cap entries")
    out = _empty(len(vals))
    _call("i64_map_lookup", _p(slot_keys), _p(slot_vals), int(cap), _p(vals), len(vals),
          _p(out))
    return out[:len(vals)]


def plain_i64_map_build(keys) -> tuple:
    keys = _i64(keys)
    order = np.argsort(keys, kind="stable")
    return PlainMap(keys[order], order.astype(np.int64)), len(keys)


def plain_i64_map_lookup(slots, cap: int, vals) -> np.ndarray:
    """Lookups in a ``PlainMap``, or in the library's interleaved table by
    the kernel's own linear probing, vectorized."""
    if isinstance(slots, PlainMap):
        return _sorted_lookup(slots, _i64(vals))
    return _probe_slots(lambda h: slots[2 * h], lambda h: slots[2 * h + 1], cap, _i64(vals))


def plain_i64_split_map_lookup(slot_keys, slot_vals, cap: int, vals) -> np.ndarray:
    if isinstance(slot_keys, PlainMap):
        return _sorted_lookup(slot_keys, _i64(vals))
    return _probe_slots(lambda h: slot_keys[h], lambda h: slot_vals[h], cap, _i64(vals))


def _sorted_lookup(pm: PlainMap, vals: np.ndarray) -> np.ndarray:
    if len(pm.keys) == 0:
        return np.full(len(vals), -1, dtype=np.int64)
    at = np.minimum(np.searchsorted(pm.keys, vals), len(pm.keys) - 1)
    return np.where(pm.keys[at] == vals, pm.rows[at], -1).astype(np.int64)


def _mix64(x: np.ndarray) -> np.ndarray:
    """kernels.cpp ``mix64`` (murmur3's finalizer) on uint64."""
    u = np.uint64
    with np.errstate(over="ignore"):
        x = x ^ (x >> u(33))
        x = x * u(0xFF51AFD7ED558CCD)
        x = x ^ (x >> u(33))
        x = x * u(0xC4CEB9FE1A85EC53)
        return x ^ (x >> u(33))


def _probe_slots(key_at, val_at, cap: int, vals: np.ndarray) -> np.ndarray:
    """Linear probing from each value's home slot, every value one step a
    round, until it meets its key or an empty slot (value -1)."""
    out = np.full(len(vals), -1, dtype=np.int64)
    h = (_mix64(vals.view(np.uint64)) & np.uint64(cap - 1)).astype(np.int64)
    todo = np.arange(len(vals))
    while len(todo):
        at = h[todo]
        got = val_at(at)
        hit = (got != -1) & (key_at(at) == vals[todo])
        out[todo[hit]] = got[hit]
        todo = todo[(got != -1) & ~hit]
        h[todo] = (h[todo] + 1) & (cap - 1)
    return out


def _lookup_codes(vals: np.ndarray, valid: Optional[np.ndarray], lookup) -> np.ndarray:
    """Plain: each value's build code through a probe table's lookup
    descriptor, -1 for an invalid or absent value."""
    if lookup[0] == "dense":
        lo, hi = int(lookup[1]), int(lookup[2])
        with np.errstate(over="ignore"):
            codes = np.where((vals >= lo) & (vals <= hi), vals - lo, -1)
    elif lookup[0] == "hashmap":
        codes = plain_i64_map_lookup(*lookup[1], vals)
    else:
        codes = plain_i64_split_map_lookup(*lookup[1], vals)
    if valid is not None:
        codes = np.where(np.asarray(valid).astype(bool), codes, -1)
    return codes.astype(np.int64, copy=False)


def native_probe_lookup_count(vals: np.ndarray, valid: Optional[np.ndarray], lookup,
                              bucket_counts: np.ndarray, num_codes: int) -> tuple:
    """One pass from a single int64 key to its build code and match count:
    (codes, match counts, total). ``lookup`` is ("dense", lo, hi),
    ("hashmap", (slots, cap)) or ("splitmap", (slot_keys, slot_vals, cap));
    ``valid`` None means every row is valid."""
    vals = _i64(vals)
    valid8 = None if valid is None else _u8(valid)
    _need(valid8 is None or len(valid8) == len(vals), "valid and vals differ in length")
    _buckets_hold(num_codes, bucket_counts)
    plain_map = lookup[0] != "dense" and isinstance(lookup[1][0], PlainMap)
    if disabled() or plain_map:
        return plain_probe_lookup_count(vals, valid8, lookup, bucket_counts, num_codes)
    n = len(vals)
    codes, l_match = _empty(n), _empty(n)
    if lookup[0] == "dense":
        total = _call("probe_lookup_count_dense", _p(vals), _p8(valid8), n, int(lookup[1]),
                      int(lookup[2]), _p(bucket_counts), int(num_codes), _p(codes),
                      _p(l_match))
    elif lookup[0] == "hashmap":
        slots, cap = lookup[1]
        _need(len(slots) == 2 * cap, "slots do not hold 2 x cap entries")
        total = _call("probe_lookup_count_pair", _p(vals), _p8(valid8), n, _p(slots),
                      int(cap), _p(bucket_counts), int(num_codes), _p(codes), _p(l_match))
    else:
        slot_keys, slot_vals, cap = lookup[1]
        _need(len(slot_keys) == len(slot_vals) == cap, "the slot arrays do not hold cap entries")
        total = _call("probe_lookup_count_hash", _p(vals), _p8(valid8), n, _p(slot_keys),
                      _p(slot_vals), int(cap), _p(bucket_counts), int(num_codes), _p(codes),
                      _p(l_match))
    return codes[:n], l_match[:n], int(total)


def plain_probe_lookup_count(vals, valid, lookup, bucket_counts, num_codes: int) -> tuple:
    codes = _lookup_codes(_i64(vals), valid, lookup)
    l_match = _match_counts(codes, bucket_counts, num_codes)
    return codes, l_match, int(l_match.sum())


def native_probe_fill(codes: np.ndarray, num_codes: int, bucket_offsets: np.ndarray,
                      bucket_counts: np.ndarray, bucket_rows: np.ndarray, total: int) -> tuple:
    """The pairs of ``native_probe`` once the match total is known."""
    codes = _i64(codes)
    _buckets_hold(num_codes, bucket_offsets, bucket_counts)
    if disabled():
        return plain_probe(codes, num_codes, bucket_offsets, bucket_counts, bucket_rows)[:2]
    out_l, out_r = _empty(total), _empty(total)
    _call("probe_fill", _p(codes), len(codes), int(num_codes), _p(bucket_offsets),
          _p(bucket_counts), _p(bucket_rows), _p(out_l), _p(out_r))
    return out_l[:total], out_r[:total]


def native_probe_unique(vals: np.ndarray, valid: Optional[np.ndarray], direct) -> tuple:
    """A probe of unique build keys, one read a row: (each row's build row
    or -1, matched left rows, their build rows). ``direct`` is ("pairmap",
    slots, cap) from value to build row, or ("dense", lo, hi, row_of_code)."""
    vals = _i64(vals)
    valid8 = None if valid is None else _u8(valid)
    _need(valid8 is None or len(valid8) == len(vals), "valid and vals differ in length")
    plain_map = direct[0] == "pairmap" and isinstance(direct[1], PlainMap)
    if disabled() or plain_map:
        return plain_probe_unique(vals, valid8, direct)
    _need(len(direct[1]) == 2 * direct[2] if direct[0] == "pairmap"
          else len(direct[3]) == direct[2] - direct[1] + 1,
          "the direct table does not match its bounds")
    n = len(vals)
    ridx, out_l, out_r = _empty(n), _empty(n), _empty(n)
    if direct[0] == "pairmap":
        m = _call("probe_unique_pair", _p(vals), _p8(valid8), n, _p(direct[1]), int(direct[2]),
                  _p(ridx), _p(out_l), _p(out_r))
    else:
        m = _call("probe_unique_dense", _p(vals), _p8(valid8), n, int(direct[1]),
                  int(direct[2]), _p(direct[3]), _p(ridx), _p(out_l), _p(out_r))
    return ridx[:n], out_l[:m], out_r[:m]


def plain_probe_unique(vals, valid, direct) -> tuple:
    vals = _i64(vals)
    if direct[0] == "pairmap":
        ridx = plain_i64_map_lookup(direct[1], direct[2], vals)
    else:
        lo, hi, table = int(direct[1]), int(direct[2]), direct[3]
        inside = (vals >= lo) & (vals <= hi)
        with np.errstate(over="ignore"):
            ridx = np.where(inside, table[np.where(inside, vals - lo, 0)] if len(table) else -1,
                            -1)
    if valid is not None:
        ridx = np.where(np.asarray(valid).astype(bool), ridx, -1)
    ridx = ridx.astype(np.int64, copy=False)
    ml = np.flatnonzero(ridx >= 0).astype(np.int64)
    return ridx, ml, ridx[ml]


# ---- selection vectors ---------------------------------------------------------------


def native_mask_indices(bits: np.ndarray, validity: Optional[np.ndarray], offset: int,
                        n: int) -> np.ndarray:
    """The rows i < n whose bit ``offset + i`` is set in ``bits`` and, when
    given, in ``validity``: Arrow-style bitmaps (LSB first, as
    ``np.packbits(..., bitorder="little")`` packs them). The kernel reads
    whole 64-bit words, so each bitmap must hold the words that cover
    ``offset + n`` bits."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    validity = None if validity is None else np.ascontiguousarray(validity, dtype=np.uint8)
    if disabled():
        return plain_mask_indices(bits, validity, offset, n)
    words = -(-(offset + n) // 64) * 8
    for name, bm in (("bits", bits), ("validity", validity)):
        _need(bm is None or len(bm) >= words,
              f"{name} holds too few bytes: {offset + n} bits read by words need {words}")
    out = _empty(n)
    m = _call("bool_mask_indices", _p8(bits), _p8(validity), int(offset), int(n), _p(out))
    return out[:m]


def plain_mask_indices(bits, validity, offset: int, n: int) -> np.ndarray:
    keep = np.unpackbits(np.asarray(bits, dtype=np.uint8), bitorder="little")[offset:offset + n]
    if validity is not None:
        keep = keep & np.unpackbits(np.asarray(validity, dtype=np.uint8),
                                    bitorder="little")[offset:offset + n]
    return np.flatnonzero(keep).astype(np.int64)


def pack_mask(mask: np.ndarray) -> np.ndarray:
    """A bool mask as an LSB-first bitmap padded to whole 64-bit words."""
    packed = np.packbits(np.asarray(mask, dtype=bool), bitorder="little")
    pad = -len(packed) % 8
    return np.concatenate([packed, np.zeros(pad, dtype=np.uint8)]) if pad else packed


# ---- PNG unfiltering (the port's own export) ------------------------------------------


def png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """PNG's five row filters undone: ``raw`` holds ``h`` rows of a filter
    byte and ``stride`` bytes; returns the (h, stride) uint8 scanlines.
    Raises ValueError on a filter byte outside 0-4 or short data. The
    library's export, or ``plain_png_unfilter`` under
    ``DAFT_TPU_DISABLE_NATIVE``."""
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    _need(len(raw) >= h * (stride + 1), "PNG image data is truncated")
    if disabled():
        return plain_png_unfilter(raw, h, stride, bpp)
    out = np.empty((max(h, 1), max(stride, 1)), dtype=np.uint8)
    rc = _call("png_unfilter", raw.ctypes.data_as(_U8P), h, stride, bpp,
               out.ctypes.data_as(_U8P))
    if rc < 0:
        raise ValueError(f"PNG row {-rc - 1} has an unknown filter type")
    return out[:h, :stride]


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def plain_png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version: None, Sub and Up row at a time in numpy; Average
    and Paeth, which read the byte to their left, byte by byte."""
    rows = np.asarray(raw[:h * (stride + 1)], dtype=np.uint8).reshape(h, stride + 1)
    out = np.zeros((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        ft, line = int(rows[y, 0]), rows[y, 1:]
        if ft == 0:
            cur = line.copy()
        elif ft == 1:
            pad = (-stride) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = (np.cumsum(lanes.astype(np.int64), axis=0) % 256).astype(np.uint8)
            cur = cur.reshape(-1)[:stride]
        elif ft == 2:
            cur = (line.astype(np.int64) + prev) % 256
            cur = cur.astype(np.uint8)
        elif ft in (3, 4):
            cur = np.zeros(stride, dtype=np.uint8)
            ln, pv = line.tolist(), prev.tolist()
            c = [0] * stride
            for i in range(stride):
                a = c[i - bpp] if i >= bpp else 0
                b = pv[i]
                if ft == 3:
                    pred = (a + b) >> 1
                else:
                    pred = _paeth(a, b, pv[i - bpp] if i >= bpp else 0)
                c[i] = (ln[i] + pred) & 0xFF
            cur[:] = c
        else:
            raise ValueError(f"PNG row {y} has an unknown filter type")
        out[y] = cur
        prev = cur
    return out
