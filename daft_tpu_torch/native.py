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
import itertools
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
_I16P = ctypes.POINTER(ctypes.c_int16)
_U16P = ctypes.POINTER(ctypes.c_uint16)
_I32P = ctypes.POINTER(ctypes.c_int32)
_U32P = ctypes.POINTER(ctypes.c_uint32)
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
    "jpeg_decode_scan": (_I64, [_U8P, _I64, _I64, _I32P, _I32P, _I16P]),
    "jpeg_idct": (None, [_I16P, _I64, _I64, _I64, _U16P, _U8P]),
    "jpeg_upsample": (None, [_U8P, _I64, _I64, _I64, _I64, _I64, _U8P, _I64, _I64]),
    "jpeg_color": (None, [_U8P, _U8P, _U8P, _U8P, _I64, _I64, _U8P]),
    "jpeg_encode_scan": (_I64, [_I16P, _I32P, _I32P, _U8P, _I64]),
    "jpeg_fdct_quant": (None, [_U8P, _I64, _I64, _I32P, _I16P]),
    "jpeg_component_plane": (None, [_U8P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64, _I64,
                                    _U8P]),
    "bpe_cache_new": (_I64, [_I64]),
    "bpe_cache_free": (None, [_I64]),
    "bpe_cache_put": (None, [_I64, _U32P, _I64, _I32P, _I64]),
    "bpe_encode": (_I64, [_I64, _U32P, _I64, _U8P, _I32P, _I64, _I64P, _I64P]),
    "image_resize_u8": (None, [_U8P, _I64, _I64, _I64P, _I64P, _I32P, _I64P, _I64P, _I32P,
                               _I64, _I64, _U8P]),
    "lz4_xxh32": (ctypes.c_uint32, [_U8P, _I64, ctypes.c_uint32]),
    "lz4_block_compress": (_I64, [_U8P, _I64, _U8P, _I64]),
    "lz4_block_decompress": (_I64, [_U8P, _I64, _U8P, _I64]),
    "lz4_frame_compress": (_I64, [_U8P, _I64, _U8P, _I64]),
    "lz4_frame_decompress": (_I64, [_U8P, _I64, _U8P, _I64]),
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


# ---- JPEG (the port's own exports: core/kernels/jpeg.py) -----------------------------

# zigzag index -> natural index, with 16 entries of 63 past the end (csrc kJpegNatural)
JPEG_NATURAL = np.array(
    [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34,
     27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44,
     51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63] + [63] * 16,
    dtype=np.int64)
JPEG_HUFF_INTS = 548  # one decoding table: lookahead, maxcode, value offsets, symbols


def _scan_blocks_needed(params: np.ndarray) -> int:
    """The blocks a scan's params reach, so the wrapper can refuse a short
    coefficient buffer."""
    nc, mx, my = int(params[6]), int(params[7]), int(params[8])
    need = 0
    for c in range(nc):
        off, stride, h, v, _dc, _ac, bw, bh = (int(x) for x in params[9 + 8 * c:17 + 8 * c])
        cols, rows = (bw, bh) if nc == 1 else (mx * h, my * v)
        _need(cols <= stride, "JPEG scan wider than its component's blocks")
        need = max(need, off + (rows - 1) * stride + cols if rows and cols else 0)
    return need


def jpeg_decode_scan(data, pos: int, params: np.ndarray, huff: np.ndarray,
                     coefs: np.ndarray) -> int:
    """One scan's entropy-coded data, from ``data[pos]``, decoded into
    ``coefs`` ((blocks, 64) int16, natural order) in place, baseline or
    progressive (csrc/kernels.cpp ``jpeg_decode_scan`` lays out ``params``
    and ``huff``). Returns the index of the marker that ends the data, or
    ``len(data)``. The library's export, or ``plain_jpeg_decode_scan``
    under ``DAFT_TPU_DISABLE_NATIVE``."""
    buf = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) \
        else np.ascontiguousarray(data, dtype=np.uint8)
    params = np.ascontiguousarray(params, dtype=np.int32)
    huff = np.ascontiguousarray(huff, dtype=np.int32)
    _need(huff.size >= 8 * JPEG_HUFF_INTS, "JPEG scan needs 8 Huffman tables")
    _need(coefs.dtype == np.int16 and coefs.flags.c_contiguous
          and coefs.size >= 64 * _scan_blocks_needed(params), "JPEG coefficients too short")
    if disabled():
        return plain_jpeg_decode_scan(bytes(buf), pos, params, huff, coefs)
    return int(_call("jpeg_decode_scan", _p8(buf), len(buf), int(pos), _p(params, ctypes.c_int32),
                     _p(huff, ctypes.c_int32), _p(coefs, ctypes.c_int16)))


def _entropy_segments(data: bytes, pos: int, restarts: bool):
    """The scan's unstuffed bytes from ``pos``, cut at each RSTn marker
    where the scan has a restart interval; and the index of the marker
    that ends it (or ``len(data)``)."""
    n = len(data)
    segs, cur = [], bytearray()
    while True:
        j = data.find(b"\xff", pos)
        if j < 0:
            cur += data[pos:]
            segs.append(cur)
            return segs, n
        cur += data[pos:j]
        k = j + 1
        while k < n and data[k] == 0xFF:
            k += 1
        if k >= n:
            segs.append(cur)
            return segs, n
        if data[k] == 0:
            cur.append(0xFF)
            pos = k + 1
        elif restarts and 0xD0 <= data[k] <= 0xD7:
            segs.append(cur)
            cur = bytearray()
            pos = k + 1
        else:
            segs.append(cur)
            return segs, k - 1


def plain_jpeg_decode_scan(data: bytes, pos: int, params, huff, coefs: np.ndarray) -> int:
    """The plain version: the same decoder, bit by bit in Python, over the
    scan's bytes unstuffed first and cut at its restart markers."""
    p = [int(x) for x in params]
    prog, ss, se, ah, al, ri, nc, mcus_x, mcus_y = p[:9]
    comp = [p[9 + 8 * c:17 + 8 * c] for c in range(nc)]
    tables = [huff[t * JPEG_HUFF_INTS:(t + 1) * JPEG_HUFF_INTS].tolist() for t in range(8)]
    nat = JPEG_NATURAL.tolist()
    segs, end = _entropy_segments(data, pos, ri > 0)
    flat = coefs.reshape(-1)
    st = {"seg": 0, "bp": 0, "buf": bytes(segs[0]) + bytes(8)}

    def get(s):
        bp = st["bp"]
        i = bp >> 3
        v = int.from_bytes(st["buf"][i:i + 4].ljust(4, b"\0"), "big")
        st["bp"] = bp + s
        return (v >> (32 - (bp & 7) - s)) & ((1 << s) - 1)

    def decode(t):
        bp = st["bp"]
        i = bp >> 3
        v = int.from_bytes(st["buf"][i:i + 4].ljust(4, b"\0"), "big")
        code16 = (v >> (16 - (bp & 7))) & 0xFFFF
        e = t[code16 >> 8]
        if e:
            st["bp"] = bp + (e >> 8)
            return e & 0xFF
        for ln in range(9, 17):
            code = code16 >> (16 - ln)
            if code <= t[256 + ln]:
                st["bp"] = bp + ln
                return t[292 + ((t[274 + ln] + code) & 0xFF)]
        st["bp"] = bp + 16
        return 0

    def extend(v, s):
        return 0 if s == 0 else (v - (1 << s) + 1 if v < (1 << (s - 1)) else v)

    def i16(v):  # the C side's int16_t store
        return ((v + 32768) & 0xFFFF) - 32768

    pred = [0, 0, 0, 0]
    eob = [0]
    p1, m1 = 1 << al, -(1 << al)

    def refine(base, k):
        c = flat[base + nat[k]]
        if c != 0 and get(1) and (int(c) & p1) == 0:
            flat[base + nat[k]] = i16(int(c) + (p1 if c >= 0 else m1))
        return c != 0

    def block(ci, bx, by):
        off, stride, _h, _v, dct, act = comp[ci][:6]
        base = (off + by * stride + bx) * 64
        dt, at = tables[dct], tables[4 + act]
        if not prog:
            s = decode(dt)
            pred[ci] += extend(get(s), s) if s else 0
            flat[base] = i16(pred[ci])
            k = 1
            while k < 64:
                rs = decode(at)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    flat[base + nat[k]] = i16(extend(get(s), s))
                elif r != 15:
                    break
                else:
                    k += 15
                k += 1
            return
        if ss == 0:
            if ah == 0:
                s = decode(dt)
                pred[ci] += extend(get(s), s) if s else 0
                flat[base] = i16(pred[ci] * (1 << al))
            elif get(1):
                flat[base] = i16(int(flat[base]) | p1)
            return
        if ah == 0:
            if eob[0] > 0:
                eob[0] -= 1
                return
            k = ss
            while k <= se:
                rs = decode(at)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    flat[base + nat[k]] = i16(extend(get(s), s) * (1 << al))
                elif r == 15:
                    k += 15
                else:
                    eob[0] = (1 << r) + (get(r) if r else 0) - 1
                    break
                k += 1
            return
        k = ss
        if eob[0] == 0:
            while k <= se:
                rs = decode(at)
                r, s = rs >> 4, rs & 15
                if s:
                    s = p1 if get(1) else m1
                elif r != 15:
                    eob[0] = (1 << r) + (get(r) if r else 0)
                    break
                while k <= se:
                    if not refine(base, k):
                        r -= 1
                        if r < 0:
                            break
                    k += 1
                if s:
                    flat[base + nat[k]] = i16(s)
                k += 1
        if eob[0] > 0:
            while k <= se:
                refine(base, k)
                k += 1
            eob[0] -= 1

    total = comp[0][6] * comp[0][7] if nc == 1 else mcus_x * mcus_y
    for m in range(total):
        if ri > 0 and m > 0 and m % ri == 0:
            st["seg"] += 1
            nxt = segs[st["seg"]] if st["seg"] < len(segs) else b""
            st["buf"], st["bp"] = bytes(nxt) + bytes(8), 0
            pred[:] = [0, 0, 0, 0]
            eob[0] = 0
        if nc == 1:
            block(0, m % comp[0][6], m // comp[0][6])
            continue
        mx, my = m % mcus_x, m // mcus_x
        for ci in range(nc):
            h, v = comp[ci][2], comp[ci][3]
            for y in range(v):
                for x in range(h):
                    block(ci, mx * h + x, my * v + y)
    return end


def jpeg_idct(coefs: np.ndarray, stride: int, bw: int, bh: int, qt: np.ndarray) -> np.ndarray:
    """libjpeg's islow IDCT of a component's ``bw`` x ``bh`` blocks (rows of
    ``stride`` blocks in ``coefs``), dequantized by the natural-order table
    ``qt``: the (8 bh, 8 bw) uint8 plane. The library's export, or
    ``plain_jpeg_idct`` under ``DAFT_TPU_DISABLE_NATIVE``."""
    coefs = np.ascontiguousarray(coefs, dtype=np.int16)
    qt = np.ascontiguousarray(qt, dtype=np.uint16)
    _need(qt.size == 64 and bw <= stride and coefs.size >= 64 * stride * bh,
          "JPEG IDCT arguments out of range")
    if disabled():
        return plain_jpeg_idct(coefs, stride, bw, bh, qt)
    out = np.empty((max(bh, 1) * 8, max(bw, 1) * 8), dtype=np.uint8)
    _call("jpeg_idct", _p(coefs, ctypes.c_int16), stride, bw, bh, _p(qt, ctypes.c_uint16),
          _p8(out))
    return out[:bh * 8, :bw * 8]


def _butterfly(x, rnd_shift):
    """The islow IDCT's 1-D pass (jidctint.c) over axis 0 of ``x`` (8, ...)
    int64, descaled by ``rnd_shift``."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * 4433
    t2 = z1 + z3 * -15137
    t3 = z1 + z2 * 6270
    t0 = (x[0] + x[4]) * 8192
    t1 = (x[0] - x[4]) * 8192
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    o0, o1, o2, o3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * 9633
    o0, o1, o2, o3 = o0 * 2446, o1 * 16819, o2 * 25172, o3 * 12299
    z1, z2 = z1 * -7373, z2 * -20995
    z3 = z3 * -16069 + z5
    z4 = z4 * -3196 + z5
    o0 = o0 + z1 + z3
    o1 = o1 + z2 + z4
    o2 = o2 + z2 + z3
    o3 = o3 + z1 + z4
    rnd = 1 << (rnd_shift - 1)
    return np.stack([t10 + o3, t11 + o2, t12 + o1, t13 + o0,
                     t13 - o0, t12 - o1, t11 - o2, t10 - o3]) + rnd >> rnd_shift


def plain_jpeg_idct(coefs, stride: int, bw: int, bh: int, qt) -> np.ndarray:
    """The plain version: both passes over every block at once in numpy."""
    blocks = coefs.reshape(-1, 64)[:stride * bh].reshape(bh, stride, 8, 8)[:, :bw]
    x = blocks.astype(np.int64) * qt.reshape(8, 8).astype(np.int64)
    # pass 1 down the columns (axis 2 is the row u), pass 2 along the rows
    ws = _butterfly(np.moveaxis(x, 2, 0), 11)                # (u', bh, bw, v)
    out = _butterfly(np.moveaxis(ws, 3, 0), 18)              # (v', u', bh, bw)
    px = np.clip(out + 128, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(px.transpose(2, 1, 3, 0).reshape(bh * 8, bw * 8))


def jpeg_upsample(plane: np.ndarray, dw: int, dh: int, hf: int, vf: int, out_w: int,
                  out_h: int) -> np.ndarray:
    """A component's ``dw`` x ``dh`` samples (the top left of ``plane``)
    brought up ``hf`` x ``vf`` times into an (out_h, out_w) plane as
    jdsample.c does (fancy h2v1, h1v2, h2v2; replication otherwise). The
    library's export, or ``plain_jpeg_upsample`` under
    ``DAFT_TPU_DISABLE_NATIVE``."""
    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    _need(plane.ndim == 2 and 0 < dw <= plane.shape[1] and 0 < dh <= plane.shape[0]
          and out_w <= dw * hf and out_h <= dh * vf and hf >= 1 and vf >= 1,
          "JPEG upsampling arguments out of range")
    if disabled():
        return plain_jpeg_upsample(plane, dw, dh, hf, vf, out_w, out_h)
    out = np.empty((max(out_h, 1), max(out_w, 1)), dtype=np.uint8)
    _call("jpeg_upsample", _p8(plane), plane.shape[1], dw, dh, hf, vf, _p8(out), out_w, out_h)
    return out[:out_h, :out_w]


def plain_jpeg_upsample(plane, dw: int, dh: int, hf: int, vf: int, out_w: int,
                        out_h: int) -> np.ndarray:
    src = plane[:dh, :dw].astype(np.int32)
    fancy_h = hf == 2 and dw > 2
    r = np.arange(out_h) // vf
    if vf == 2 and (hf == 1 or fancy_h):
        odd = (np.arange(out_h) & 1).astype(bool)
        far = np.clip(np.where(odd, r + 1, r - 1), 0, dh - 1)
        col = src[r] * 3 + src[far]
        if hf == 1:
            out = (col + np.where(odd, 2, 1)[:, None]) >> 2
        else:
            left = np.concatenate([col[:, :1], col[:, :-1]], axis=1)
            right = np.concatenate([col[:, 1:], col[:, -1:]], axis=1)
            even = (col * 3 + left + 8) >> 4
            even[:, 0] = (col[:, 0] * 4 + 8) >> 4
            oddc = (col * 3 + right + 7) >> 4
            oddc[:, -1] = (col[:, -1] * 4 + 7) >> 4
            out = np.stack([even, oddc], axis=2).reshape(out_h, 2 * dw)
    elif fancy_h and vf == 1:
        rows = src[r]
        v3 = rows * 3
        left = np.concatenate([rows[:, :1], rows[:, :-1]], axis=1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], axis=1)
        even = (v3 + left + 1) >> 2
        even[:, 0] = rows[:, 0]
        oddc = (v3 + right + 2) >> 2
        oddc[:, -1] = rows[:, -1]
        out = np.stack([even, oddc], axis=2).reshape(out_h, 2 * dw)
    else:
        out = np.repeat(src[r], hf, axis=1)
    return np.ascontiguousarray(out[:, :out_w].astype(np.uint8))


# space: 0 YCbCr -> RGB, 1 RGB, 2 CMYK, 3 YCCK (the last two as PIL's inverted CMYK)
JPEG_SPACE_CHANNELS = {0: 3, 1: 3, 2: 4, 3: 4}


def jpeg_color(planes, space: int) -> np.ndarray:
    """Equal-size planes (3 or 4) to interleaved pixels (h, w, 3 or 4) in
    PIL's representation: YCbCr -> RGB by jdcolor.c's tables, RGB kept,
    CMYK and YCCK as PIL's inverted CMYK. The library's export, or
    ``plain_jpeg_color`` under ``DAFT_TPU_DISABLE_NATIVE``."""
    planes = [np.ascontiguousarray(p, dtype=np.uint8) for p in planes]
    ch = JPEG_SPACE_CHANNELS[space]
    _need(len(planes) == (4 if ch == 4 else 3), "JPEG colour planes do not match the space")
    _need(all(p.shape == planes[0].shape for p in planes), "JPEG colour planes differ in size")
    if disabled():
        return plain_jpeg_color(planes, space)
    h, w = planes[0].shape
    out = np.empty((h, w, ch), dtype=np.uint8)
    p3 = planes[3] if len(planes) > 3 else planes[0]
    _call("jpeg_color", _p8(planes[0]), _p8(planes[1]), _p8(planes[2]), _p8(p3), h * w, space,
          _p8(out))
    return out


def _ycc_tables():
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((91881 * x + half) >> 16, (116130 * x + half) >> 16, -46802 * x, -22554 * x + half)


def plain_jpeg_color(planes, space: int) -> np.ndarray:
    p = [q.astype(np.int64) for q in planes]
    if space == 1:
        return np.stack(planes[:3], axis=2)
    if space == 2:
        return (255 - np.stack(planes[:4], axis=2)).astype(np.uint8)
    cr_r, cb_b, cr_g, cb_g = _ycc_tables()
    y, cb, cr = p[0], p[1], p[2]
    rgb = [np.clip(y + cr_r[cr], 0, 255), np.clip(y + ((cb_g[cb] + cr_g[cr]) >> 16), 0, 255),
           np.clip(y + cb_b[cb], 0, 255)]
    if space == 3:
        rgb.append(255 - p[3])
    return np.stack(rgb, axis=2).astype(np.uint8)


def jpeg_component_plane(px: np.ndarray, comp: int, hf: int, vf: int, max_v: int, bw: int,
                         bh: int) -> np.ndarray:
    """The writer's (8 bh, 8 bw) uint8 samples of component ``comp`` (0 Y,
    1 Cb, 2 Cr; 0 of a gray image) of (h, w) or (h, w, 3) uint8 pixels:
    jccolor.c's RGB -> YCbCr, jcprep.c's edge padding (down to a row group
    of ``max_v`` rows, right to whole blocks), jcsample.c's ``hf`` x ``vf``
    downsampling, the last row repeated down to whole blocks. The
    library's export, or ``plain_jpeg_component_plane`` under
    ``DAFT_TPU_DISABLE_NATIVE``."""
    px = np.ascontiguousarray(px, dtype=np.uint8)
    h, w = px.shape[:2]
    c = 1 if px.ndim == 2 else px.shape[2]
    _need(c in (1, 3) and h > 0 and w > 0 and hf >= 1 and vf >= 1 and max_v % vf == 0
          and bw * 8 * hf >= w and comp in ((0,) if c == 1 else (0, 1, 2)),
          "JPEG component arguments out of range")
    if disabled():
        return plain_jpeg_component_plane(px, comp, hf, vf, max_v, bw, bh)
    out = np.empty((bh * 8, bw * 8), dtype=np.uint8)
    _call("jpeg_component_plane", _p8(px), h, w, c, comp, hf, vf, max_v, bw, bh, _p8(out))
    return out


def plain_jpeg_component_plane(px, comp: int, hf: int, vf: int, max_v: int, bw: int,
                               bh: int) -> np.ndarray:
    """The plain version, in numpy (int32: every colour sum stays under 2^25)."""
    if px.ndim == 2:
        full = px.astype(np.int32)
    else:
        r, g, b = (px[:, :, i].astype(np.int32) for i in range(3))
        full = ((19595 * r + 38470 * g + 7471 * b + 32768) >> 16,
                (-11059 * r - 21709 * g + 32768 * b + 8421375) >> 16,
                (32768 * r - 27439 * g - 5329 * b + 8421375) >> 16)[comp]
    height, width = full.shape
    need_w = bw * 8 * hf
    rows = -(-height // max_v) * max_v
    p = np.pad(full, ((0, rows - height), (0, need_w - width)), mode="edge")
    if hf == 2 and vf == 2:
        s = p[0::2, 0::2] + p[0::2, 1::2] + p[1::2, 0::2] + p[1::2, 1::2]
        p = (s + np.tile(np.array([1, 2], np.int32), bw * 4)) >> 2
    elif hf == 2 and vf == 1:
        p = (p[:, 0::2] + p[:, 1::2] + np.tile(np.array([0, 1], np.int32), bw * 4)) >> 1
    elif (hf, vf) != (1, 1):  # int_downsample
        s = p.reshape(rows // vf, vf, need_w // hf, hf).sum(axis=(1, 3))
        p = (s + hf * vf // 2) // (hf * vf)
    rows_out = np.minimum(np.arange(bh * 8), p.shape[0] - 1)
    return np.ascontiguousarray(p[rows_out].astype(np.uint8))


def jpeg_fdct_quant(plane: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """The islow FDCT (jfdctint.c) and libjpeg-turbo's reciprocal
    quantization of every block of an (8 bh, 8 bw) uint8 plane: (bh, bw,
    64) int16 coefficients in natural order. ``quant``: 64 reciprocals, 64
    corrections, 64 shifts. The library's export, or
    ``plain_jpeg_fdct_quant`` under ``DAFT_TPU_DISABLE_NATIVE``."""
    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    quant = np.ascontiguousarray(quant, dtype=np.int32)
    _need(plane.ndim == 2 and plane.shape[0] % 8 == 0 and plane.shape[1] % 8 == 0
          and quant.size == 192, "JPEG FDCT arguments out of range")
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    if disabled():
        return plain_jpeg_fdct_quant(plane, quant)
    out = np.empty((max(bh, 1), max(bw, 1), 64), dtype=np.int16)
    _call("jpeg_fdct_quant", _p8(plane), bw, bh, _p(quant, ctypes.c_int32),
          _p(out, ctypes.c_int16))
    return out[:bh, :bw]


def _fdct_pass(x, last: bool):
    """jfdctint.c's 1-D pass over axis 0 of ``x`` (8, ...) int64: the row
    pass (``last`` False) keeps PASS1_BITS, the column pass removes it."""
    t0, t7 = x[0] + x[7], x[0] - x[7]
    t1, t6 = x[1] + x[6], x[1] - x[6]
    t2, t5 = x[2] + x[5], x[2] - x[5]
    t3, t4 = x[3] + x[4], x[3] - x[4]
    t10, t13, t11, t12 = t0 + t3, t0 - t3, t1 + t2, t1 - t2
    sh = 15 if last else 11
    rnd = 1 << (sh - 1)
    out = [None] * 8
    if last:
        out[0], out[4] = (t10 + t11 + 2) >> 2, (t10 - t11 + 2) >> 2
    else:
        out[0], out[4] = (t10 + t11) * 4, (t10 - t11) * 4
    z1 = (t12 + t13) * 4433
    out[2] = (z1 + t13 * 6270 + rnd) >> sh
    out[6] = (z1 + t12 * -15137 + rnd) >> sh
    z1, z2, z3, z4 = t4 + t7, t5 + t6, t4 + t6, t5 + t7
    z5 = (z3 + z4) * 9633
    z1, z2 = z1 * -7373, z2 * -20995
    z3 = z3 * -16069 + z5
    z4 = z4 * -3196 + z5
    out[7] = (t4 * 2446 + z1 + z3 + rnd) >> sh
    out[5] = (t5 * 16819 + z2 + z4 + rnd) >> sh
    out[3] = (t6 * 25172 + z2 + z3 + rnd) >> sh
    out[1] = (t7 * 12299 + z1 + z4 + rnd) >> sh
    return np.stack(out)


def plain_jpeg_fdct_quant(plane, quant) -> np.ndarray:
    """The plain version: both passes over every block at once in numpy."""
    bh, bw = plane.shape[0] // 8, plane.shape[1] // 8
    x = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3).astype(np.int64) - 128
    rows = _fdct_pass(np.moveaxis(x, 3, 0), last=False)       # (v', bh, bw, u)
    cols = _fdct_pass(np.moveaxis(rows, 3, 0), last=True)     # (u', v', bh, bw)
    coef = cols.transpose(2, 3, 0, 1).reshape(bh, bw, 64)
    recip, corr, shift = (quant[k * 64:(k + 1) * 64].astype(np.int64) for k in range(3))
    mag = ((np.abs(coef) + corr) * recip) >> shift
    return np.where(coef < 0, -mag, mag).astype(np.int16)


def jpeg_encode_scan(coefs: np.ndarray, params: np.ndarray, ehuf: np.ndarray) -> bytes:
    """Quantized blocks ((blocks, 64) int16, natural order) entropy-coded
    as one baseline interleaved scan: MCU by MCU, 0xFF stuffed, padded
    with 1 bits (csrc/kernels.cpp ``jpeg_encode_scan`` lays out ``params``
    and ``ehuf``). The library's export, or ``plain_jpeg_encode_scan``
    under ``DAFT_TPU_DISABLE_NATIVE``."""
    coefs = np.ascontiguousarray(coefs, dtype=np.int16)
    params = np.ascontiguousarray(params, dtype=np.int32)
    ehuf = np.ascontiguousarray(ehuf, dtype=np.int32)
    nc, mx, my = int(params[0]), int(params[1]), int(params[2])
    need = 0
    for c in range(nc):
        off, stride, h, v = (int(x) for x in params[3 + 6 * c:7 + 6 * c])
        _need(mx * h <= stride, "JPEG scan wider than its component's blocks")
        need = max(need, off + (my * v - 1) * stride + mx * h)
    _need(coefs.size >= 64 * need and ehuf.size >= 4 * 512, "JPEG encoder arguments too short")
    if disabled():
        return plain_jpeg_encode_scan(coefs, params, ehuf)
    cap = coefs.size * 8 + 1024
    out = np.empty(cap, dtype=np.uint8)
    n = _call("jpeg_encode_scan", _p(coefs, ctypes.c_int16), _p(params, ctypes.c_int32),
              _p(ehuf, ctypes.c_int32), _p8(out), cap)
    _need(n >= 0, "JPEG entropy-coded data outgrew its buffer")
    return out[:n].tobytes()


def plain_jpeg_encode_scan(coefs, params, ehuf) -> bytes:
    """The plain version: the same coder in Python."""
    p = [int(x) for x in params]
    nc, mcus_x, mcus_y = p[:3]
    comp = [p[3 + 6 * c:9 + 6 * c] for c in range(nc)]
    tabs = [ehuf[t * 512:(t + 1) * 512].tolist() for t in range(4)]
    nat = JPEG_NATURAL[:64].tolist()
    blocks = coefs.reshape(-1, 64)
    out = bytearray()
    st = [0, 0]  # accumulator, bits in it

    def put(code, size):
        acc = (st[0] << size) | (code & ((1 << size) - 1))
        nb = st[1] + size
        while nb >= 8:
            b = (acc >> (nb - 8)) & 0xFF
            nb -= 8
            out.append(b)
            if b == 0xFF:
                out.append(0)
        st[0], st[1] = acc & ((1 << nb) - 1), nb

    pred = [0] * nc
    for m in range(mcus_x * mcus_y):
        mx, my = m % mcus_x, m // mcus_x
        for c in range(nc):
            off, stride, h, v, dct, act = comp[c]
            dc, ac = tabs[dct], tabs[2 + act]
            for y in range(v):
                for x in range(h):
                    blk = blocks[off + (my * v + y) * stride + mx * h + x].tolist()
                    t = blk[0] - pred[c]
                    pred[c] = blk[0]
                    s = abs(t).bit_length()
                    put(dc[s], dc[256 + s])
                    if s:
                        put(t - 1 if t < 0 else t, s)
                    r = 0
                    for k in range(1, 64):
                        val = blk[nat[k]]
                        if val == 0:
                            r += 1
                            continue
                        while r > 15:
                            put(ac[0xF0], ac[256 + 0xF0])
                            r -= 16
                        sz = abs(val).bit_length()
                        sym = (r << 4) + sz
                        put(ac[sym], ac[256 + sym])
                        put(val - 1 if val < 0 else val, sz)
                        r = 0
                    if r > 0:
                        put(ac[0], ac[256])
    put(0x7F, 7)
    return bytes(out)


# ---- the tokenizer-file reader's split and word cache (functions/tokenizer_file.py) ---


class BpeCache:
    """One tokenizer's words and their ids, emptied when it holds
    ``max_words`` words: the library's table (made at first use, freed with
    this object), or ``words``, the plain version's dict, under
    ``DAFT_TPU_DISABLE_NATIVE``."""

    def __init__(self, max_words: int = 1 << 20):
        self.max_words = max_words
        self.words: dict = {}
        self.lock = threading.Lock()
        self._handle = None

    def handle(self) -> int:
        with self.lock:
            if self._handle is None:
                self._handle = int(_call("bpe_cache_new", self.max_words))
            return self._handle

    def __del__(self):
        if self._handle is not None and _LIB is not None:
            _LIB.bpe_cache_free(self._handle)


def bpe_encode(cache: BpeCache, text: str, classes: np.ndarray, pattern, merge) -> np.ndarray:
    """``text`` cut into GPT-2's pre-tokenizer words and each word's ids
    (int32, in order), a word's ids from ``cache`` or, when it is not
    there, from ``merge(word)`` (once a call, then put in ``cache``).
    ``classes``: a uint8 class per code point (0 other, 1 letter, 2 number,
    3 whitespace); ``pattern``: the same split as a compiled ``re`` pattern,
    which ``plain_bpe_encode`` runs under ``DAFT_TPU_DISABLE_NATIVE``."""
    _need(classes.dtype == np.uint8 and classes.size == 0x110000,
          "bpe_encode needs a class for every code point")
    if disabled():
        return plain_bpe_encode(cache, text, pattern, merge)
    cps = np.frombuffer(text.encode("utf-32-le"), dtype=np.uint32)
    h = cache.handle()
    out = np.empty(4 * len(cps) + 16, dtype=np.int32)  # a code point is at most 4 byte ids
    miss = np.empty(3 * len(cps) + 3, dtype=np.int64)
    n_miss = np.zeros(1, dtype=np.int64)
    o = _call("bpe_encode", h, _p(cps, ctypes.c_uint32), len(cps), _p8(classes),
              _p(out, ctypes.c_int32), len(out), _p(miss), _p(n_miss))
    _need(o >= 0, "bpe_encode: a word's ids outgrew their buffer")
    if not n_miss[0]:
        return out[:o].copy()
    # the missing words' ids go between the found ones; the cache may drop
    # them again (another call's reset), this call does not read them back
    merged: dict = {}
    parts, prev = [], 0
    for s, e, at in miss[:3 * int(n_miss[0])].reshape(-1, 3).tolist():
        word = text[s:e]
        ids = merged.get(word)
        if ids is None:
            ids = merged[word] = np.ascontiguousarray(merge(word), dtype=np.int32)
            key = np.ascontiguousarray(cps[s:e])
            _call("bpe_cache_put", h, _p(key, ctypes.c_uint32), e - s, _p(ids, ctypes.c_int32),
                  len(ids))
        parts += (out[prev:at], ids)
        prev = at
    parts.append(out[prev:o])
    return np.concatenate(parts)


def plain_bpe_encode(cache: BpeCache, text: str, pattern, merge) -> np.ndarray:
    """The plain version: ``re`` splits, a dict keeps the words."""
    words = pattern.findall(text)
    got = list(map(cache.words.get, words))
    for i, w in enumerate(words):
        if got[i] is None:
            ids = cache.words.get(w)
            if ids is None:
                ids = tuple(merge(w))
                with cache.lock:
                    if len(cache.words) >= cache.max_words:
                        cache.words.clear()
                    cache.words[w] = ids
            got[i] = ids
    n = sum(map(len, got))
    return np.fromiter(itertools.chain.from_iterable(got), dtype=np.int32, count=n)


# ---- cv2's INTER_LINEAR for uint8 images (core/kernels/image.py) ---------------------


def image_resize_u8(img: np.ndarray, xs0, xs1, a0, ys0, ys1, b0) -> np.ndarray:
    """An (sh, sw, c) uint8 image resized in cv2's fixed point to (len(ys0),
    len(xs0), c): the output column's source columns ``xs0`` / ``xs1`` and
    the first's 11-bit weight ``a0``, the output row's ``ys0`` / ``ys1`` /
    ``b0``. The library's export, or ``plain_image_resize_u8`` under
    ``DAFT_TPU_DISABLE_NATIVE``."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    xs0, xs1, ys0, ys1 = (np.ascontiguousarray(a, dtype=np.int64) for a in (xs0, xs1, ys0, ys1))
    a0, b0 = (np.ascontiguousarray(a, dtype=np.int32) for a in (a0, b0))
    sh, sw, c = img.shape
    _need(len(xs1) == len(xs0) == len(a0) and len(ys1) == len(ys0) == len(b0)
          and all(len(a) == 0 or (a.min() >= 0 and a.max() < lim)
                  for a, lim in ((xs0, sw), (xs1, sw), (ys0, sh), (ys1, sh))),
          "resize taps out of the image")
    if disabled():
        return plain_image_resize_u8(img, xs0, xs1, a0, ys0, ys1, b0)
    out = np.empty((max(len(ys0), 1), max(len(xs0), 1), max(c, 1)), dtype=np.uint8)
    _call("image_resize_u8", _p8(img), sw, c, _p(xs0), _p(xs1), _p(a0, ctypes.c_int32),
          _p(ys0), _p(ys1), _p(b0, ctypes.c_int32), len(xs0), len(ys0), _p8(out))
    return out[:len(ys0), :len(xs0), :c]


def plain_image_resize_u8(img, xs0, xs1, a0, ys0, ys1, b0) -> np.ndarray:
    """The plain version: the horizontal pass over the rows the output
    reads, at once in numpy, int32 throughout (a row sum is at most 255 x
    2048, and b x (row >> 4) at most 2048 x 32640)."""
    a1, b1 = 2048 - a0, 2048 - b0
    rows = np.unique(np.concatenate([ys0, ys1]))
    src = img[rows].astype(np.int32)
    horiz = src[:, xs0, :] * a0[None, :, None]
    horiz += src[:, xs1, :] * a1[None, :, None]
    horiz >>= 4
    pos0, pos1 = np.searchsorted(rows, ys0), np.searchsorted(rows, ys1)
    out = (horiz[pos0] * b0[:, None, None]) >> 16
    out += (horiz[pos1] * b1[:, None, None]) >> 16
    out += 2
    out >>= 2
    return np.clip(out, 0, 255).astype(np.uint8)


# ---- LZ4 (io/arrow_ipc.py's LZ4_FRAME bodies) -----------------------------------------

LZ4_HASH_LOG = 16
LZ4_FRAME_BLOCK = 4 << 20   # the frames written hold blocks of 4 MiB (BD 7)
_LZ4_ERRORS = {-1: "not an LZ4 frame", -2: "malformed LZ4 data",
               -3: "LZ4 data decodes past its stated size", -4: "an LZ4 checksum differs",
               -5: "an LZ4 frame names a dictionary"}


def _u8_view(data) -> np.ndarray:
    buf = np.frombuffer(memoryview(data).cast("B"), dtype=np.uint8)
    return buf if len(buf) else np.zeros(1, np.uint8)


def lz4_block_bound(n: int) -> int:
    """The most bytes an LZ4 block of ``n`` input bytes takes."""
    return n + n // 255 + 16


def lz4_frame_bound(n: int) -> int:
    """The most bytes ``lz4_frame_compress`` writes for ``n`` input bytes."""
    blocks = max(1, -(-n // LZ4_FRAME_BLOCK))
    return 7 + 4 * (blocks + 1) + n


def lz4_xxh32(data, seed: int = 0) -> int:
    """xxh32 of ``data`` (the LZ4 frame's checksums). The library's export,
    or ``plain_lz4_xxh32`` under ``DAFT_TPU_DISABLE_NATIVE``."""
    if disabled():
        return plain_lz4_xxh32(data, seed)
    return int(_call("lz4_xxh32", _u8_view(data).ctypes.data_as(_U8P), len(data), seed))


def lz4_block_compress(data) -> bytes:
    """One LZ4 block of ``data``. The library's export, or
    ``plain_lz4_block_compress`` (the same bytes) under
    ``DAFT_TPU_DISABLE_NATIVE``."""
    if disabled():
        return plain_lz4_block_compress(data)
    src = _u8_view(data)
    out = np.empty(lz4_block_bound(len(data)), dtype=np.uint8)
    n = _call("lz4_block_compress", src.ctypes.data_as(_U8P), len(data),
              out.ctypes.data_as(_U8P), len(out))
    _need(n >= 0, "LZ4 block bound too small")
    return out[:n].tobytes()


def lz4_block_decompress(data, size: int) -> bytes:
    """The ``size`` bytes one LZ4 block decodes to (ValueError on malformed
    data or another size). The library's export, or
    ``plain_lz4_block_decompress`` under ``DAFT_TPU_DISABLE_NATIVE``."""
    if disabled():
        return plain_lz4_block_decompress(data, size)
    src = _u8_view(data)
    out = np.empty(max(size, 1), dtype=np.uint8)
    n = _call("lz4_block_decompress", src.ctypes.data_as(_U8P), len(data),
              out.ctypes.data_as(_U8P), size)
    if n < 0:
        raise ValueError(_LZ4_ERRORS.get(int(n), "malformed LZ4 data"))
    _need(n == size, f"LZ4 block decodes to {n} bytes, expected {size}")
    return out[:size].tobytes()


def lz4_frame_compress(data) -> bytes:
    """One LZ4 frame of ``data``: independent 4 MiB blocks, a block that
    does not shrink stored, no checksums. The library's export, or
    ``plain_lz4_frame_compress`` (the same bytes) under
    ``DAFT_TPU_DISABLE_NATIVE``."""
    if disabled():
        return plain_lz4_frame_compress(data)
    src = _u8_view(data)
    out = np.empty(lz4_frame_bound(len(data)), dtype=np.uint8)
    n = _call("lz4_frame_compress", src.ctypes.data_as(_U8P), len(data),
              out.ctypes.data_as(_U8P), len(out))
    _need(n >= 0, "LZ4 frame bound too small")
    return out[:n].tobytes()


def lz4_frame_decompress(data, size: int) -> bytes:
    """The ``size`` bytes the LZ4 frames of ``data`` decode to (any valid
    frame: linked or independent blocks, checksums, content size, stored
    blocks, skippable frames); ValueError on malformed data or another
    size. The library's export, or ``plain_lz4_frame_decompress`` under
    ``DAFT_TPU_DISABLE_NATIVE``."""
    if disabled():
        return plain_lz4_frame_decompress(data, size)
    src = _u8_view(data)
    out = np.empty(max(size, 1), dtype=np.uint8)
    n = _call("lz4_frame_decompress", src.ctypes.data_as(_U8P), len(data),
              out.ctypes.data_as(_U8P), size)
    if n < 0:
        raise ValueError(_LZ4_ERRORS.get(int(n), "malformed LZ4 data"))
    _need(n == size, f"LZ4 frame decodes to {n} bytes, expected {size}")
    return out[:size].tobytes()


_M32 = 0xFFFFFFFF
_X32 = (2654435761, 2246822519, 3266489917, 668265263, 374761393)


def _rotl32(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def plain_lz4_xxh32(data, seed: int = 0) -> int:
    p1, p2, p3, p4, p5 = _X32
    b = bytes(data)
    n = len(b)
    i = 0
    if n >= 16:
        v = [(seed + p1 + p2) & _M32, (seed + p2) & _M32, seed & _M32, (seed - p1) & _M32]
        while i <= n - 16:
            for k in range(4):
                w = int.from_bytes(b[i:i + 4], "little")
                v[k] = (_rotl32((v[k] + w * p2) & _M32, 13) * p1) & _M32
                i += 4
        h = (_rotl32(v[0], 1) + _rotl32(v[1], 7) + _rotl32(v[2], 12) + _rotl32(v[3], 18)) & _M32
    else:
        h = (seed + p5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        h = (_rotl32((h + int.from_bytes(b[i:i + 4], "little") * p3) & _M32, 17) * p4) & _M32
        i += 4
    while i < n:
        h = (_rotl32((h + b[i] * p5) & _M32, 11) * p1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * p2) & _M32
    h ^= h >> 13
    h = (h * p3) & _M32
    h ^= h >> 16
    return h


def _lz4_length(out: bytearray, rest: int) -> None:
    while rest >= 255:
        out.append(255)
        rest -= 255
    out.append(rest)


def _lz4_sequence(out: bytearray, src: bytes, anchor: int, lit: int, offset: int,
                  mlen: int) -> None:
    ml = mlen - 4 if mlen else 0
    out.append((min(lit, 15) << 4) | min(ml, 15))
    if lit >= 15:
        _lz4_length(out, lit - 15)
    out += src[anchor:anchor + lit]
    if mlen:
        out += bytes((offset & 0xFF, offset >> 8))
        if ml >= 15:
            _lz4_length(out, ml - 15)


def plain_lz4_block_compress(data) -> bytes:
    src = bytes(data)
    n = len(src)
    table = {}
    out = bytearray()
    ip = anchor = 0
    mflimit, matchlimit = n - 12, n - 5
    while ip < mflimit:
        seq = int.from_bytes(src[ip:ip + 4], "little")
        h = ((seq * 2654435761) & _M32) >> (32 - LZ4_HASH_LOG)
        ref = table.get(h, -1)
        table[h] = ip
        if ref < 0 or ip - ref > 65535 or src[ref:ref + 4] != src[ip:ip + 4]:
            ip += 1
            continue
        mlen = 4
        while ip + mlen < matchlimit and src[ref + mlen] == src[ip + mlen]:
            mlen += 1
        _lz4_sequence(out, src, anchor, ip - anchor, ip - ref, mlen)
        ip += mlen
        anchor = ip
    _lz4_sequence(out, src, anchor, n - anchor, 0, 0)
    return bytes(out)


def _plain_lz4_block_into(src: bytes, out: bytearray, start: int, cap: int) -> None:
    """Decode one block, appending to ``out``; a match reaches back no
    further than ``start``; ``cap`` bounds len(out)."""
    ip, n = 0, len(src)

    def length(ip: int, v: int):
        while True:
            if ip >= n:
                raise ValueError("malformed LZ4 data")
            b = src[ip]
            ip += 1
            v += b
            if b != 255:
                return ip, v

    while ip < n:
        tok = src[ip]
        ip += 1
        lit = tok >> 4
        if lit == 15:
            ip, lit = length(ip, lit)
        if ip + lit > n:
            raise ValueError("malformed LZ4 data")
        if len(out) + lit > cap:
            raise ValueError("LZ4 data decodes past its stated size")
        out += src[ip:ip + lit]
        ip += lit
        if ip == n:
            break
        if ip + 2 > n:
            raise ValueError("malformed LZ4 data")
        offset = src[ip] | (src[ip + 1] << 8)
        ip += 2
        if offset == 0 or offset > len(out) - start:
            raise ValueError("malformed LZ4 data")
        mlen = tok & 15
        if mlen == 15:
            ip, mlen = length(ip, mlen)
        mlen += 4
        if len(out) + mlen > cap:
            raise ValueError("LZ4 data decodes past its stated size")
        for _ in range(mlen):
            out.append(out[-offset])


def plain_lz4_block_decompress(data, size: int) -> bytes:
    out = bytearray()
    _plain_lz4_block_into(bytes(data), out, 0, size)
    _need(len(out) == size, f"LZ4 block decodes to {len(out)} bytes, expected {size}")
    return bytes(out)


def plain_lz4_frame_compress(data) -> bytes:
    src = bytes(data)
    desc = bytes((0x60, 0x70))
    out = bytearray((0x184D2204).to_bytes(4, "little") + desc
                    + bytes(((plain_lz4_xxh32(desc) >> 8) & 0xFF,)))
    for at in range(0, len(src), LZ4_FRAME_BLOCK):
        block = src[at:at + LZ4_FRAME_BLOCK]
        c = plain_lz4_block_compress(block)
        if len(c) >= len(block):
            out += (len(block) | 0x80000000).to_bytes(4, "little") + block
        else:
            out += len(c).to_bytes(4, "little") + c
    return bytes(out + bytes(4))


def plain_lz4_frame_decompress(data, size: int) -> bytes:
    src = bytes(data)
    n = len(src)
    out = bytearray()
    ip = 0

    def word(at: int) -> int:
        if at + 4 > n:
            raise ValueError("malformed LZ4 data")
        return int.from_bytes(src[at:at + 4], "little")

    while ip < n:
        magic = word(ip)
        if magic & 0xFFFFFFF0 == 0x184D2A50:
            ip += 8 + word(ip + 4)
            continue
        if magic != 0x184D2204:
            raise ValueError("not an LZ4 frame" if ip == 0 else "malformed LZ4 data")
        if ip + 7 > n or src[ip + 4] >> 6 != 1:
            raise ValueError("malformed LZ4 data")
        flg = src[ip + 4]
        indep, bsum, csize, csum, dict_ = (bool(flg & m) for m in (0x20, 0x10, 0x08, 0x04, 0x01))
        desc = 2 + (8 if csize else 0) + (4 if dict_ else 0)
        if ip + 5 + desc > n:
            raise ValueError("malformed LZ4 data")
        if (plain_lz4_xxh32(src[ip + 4:ip + 4 + desc]) >> 8) & 0xFF != src[ip + 4 + desc]:
            raise ValueError("an LZ4 checksum differs")
        if dict_:
            raise ValueError("an LZ4 frame names a dictionary")
        content = int.from_bytes(src[ip + 6:ip + 14], "little") if csize else -1
        bmax = 1 << (8 + 2 * ((src[ip + 5] >> 4) & 7))
        ip += 5 + desc
        start = len(out)
        while True:
            w = word(ip)
            ip += 4
            if w == 0:
                break
            length = w & 0x7FFFFFFF
            if length > bmax or ip + length + (4 if bsum else 0) > n:
                raise ValueError("malformed LZ4 data")
            block = src[ip:ip + length]
            if bsum and plain_lz4_xxh32(block) != word(ip + length):
                raise ValueError("an LZ4 checksum differs")
            if w & 0x80000000:
                if len(out) + length > size:
                    raise ValueError("LZ4 data decodes past its stated size")
                out += block
            else:
                _plain_lz4_block_into(block, out, len(out) if indep else start, size)
            ip += length + (4 if bsum else 0)
        if csum:
            if plain_lz4_xxh32(out[start:]) != word(ip):
                raise ValueError("an LZ4 checksum differs")
            ip += 4
        if content >= 0 and content != len(out) - start:
            raise ValueError("malformed LZ4 data")
    _need(len(out) == size, f"LZ4 frame decodes to {len(out)} bytes, expected {size}")
    return bytes(out)
