"""Deterministic 64-bit row hashing (counterpart of
daft_tpu/core/kernels/hashing.py), bit-identical to the reference.

Fixed-width values go through a splitmix64 finalizer over a canonical 64-bit
encoding: integers (and dates, int32 days) as their int64 bits, floats
widened to f64 with -0.0 and every NaN canonicalized, bools as 0/1. Strings
take the reference's Arrow-buffer hash, recomputed here from Python ``str``
(the port has no Arrow): a row of at most 256 UTF-8 bytes takes FNV-1a over
its bytes and then ``splitmix64(h ^ len)``; a longer row takes its 8-byte
blake2b digest. Null rows hash to ``NULL_HASH``, so partitioning, grouping
and joining agree across the two engines and across processes.
"""

from __future__ import annotations

from hashlib import blake2b
from typing import List, Optional

import numpy as np

NULL_HASH = np.uint64(0x9E3779B97F4A7C15)

_C1 = np.uint64(0xBF58476D1CE4E5B9)
_C2 = np.uint64(0x94D049BB133111EB)
_C3 = np.uint64(0x9E3779B97F4A7C15)

_FNV_OFFSET = np.uint64(14695981039346656037)
_FNV_PRIME = np.uint64(1099511628211)
# rows longer than this many bytes take blake2b, chosen per row by its own
# length, so a value's hash never depends on its batchmates
_LONG_CUTOFF = 256


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64."""
    with np.errstate(over="ignore"):
        x = (x + _C3).astype(np.uint64)
        x = (x ^ (x >> np.uint64(30))) * _C1
        x = (x ^ (x >> np.uint64(27))) * _C2
        x = x ^ (x >> np.uint64(31))
    return x


def _hash_strings(values: np.ndarray, valid: np.ndarray) -> np.ndarray:
    """The reference's ``_hash_string_arrow`` over an object array of str."""
    encoded = [v.encode("utf-8") if ok else b"" for v, ok in zip(values, valid)]
    n = len(encoded)
    lengths = np.fromiter((len(b) for b in encoded), dtype=np.int64, count=n)
    data = np.frombuffer(b"".join(encoded), dtype=np.uint8)
    starts = np.cumsum(lengths) - lengths
    short = lengths <= _LONG_CUTOFF
    h = np.full(n, _FNV_OFFSET, dtype=np.uint64)
    max_len = int(np.minimum(lengths, _LONG_CUTOFF).max()) if n else 0
    with np.errstate(over="ignore"):
        for k in range(max_len):
            live = short & (lengths > k)
            h[live] = (h[live] ^ data[starts[live] + k].astype(np.uint64)) * _FNV_PRIME
        h = splitmix64(h ^ lengths.astype(np.uint64))
    for i in np.flatnonzero(~short):
        h[i] = np.frombuffer(blake2b(encoded[i], digest_size=8).digest(), dtype="<u8")[0]
    h[~valid] = NULL_HASH
    return h


def hash_series(series, seed: Optional[object] = None):
    """64-bit hash of each row of a Series; returns a uint64 Series."""
    from ..series import Series

    dt = series.dtype
    valid = series.validity_numpy()
    if dt.is_null():
        h = np.full(len(series), NULL_HASH, dtype=np.uint64)
    elif dt.is_string():
        h = _hash_strings(series.to_numpy(), valid)
    elif dt.is_numeric() or dt.is_boolean() or dt.is_temporal():
        values = series.to_numpy()
        if values.dtype.kind == "f":
            # canonicalize -0.0 == 0.0 and all NaNs equal
            values = values.astype(np.float64) + 0.0
            bits = values.view(np.uint64).copy()
            bits[np.isnan(values)] = np.uint64(0x7FF8000000000000)
        elif values.dtype.kind in "iu":
            # dates are int32 days here, as the reference's to_numpy() gives them
            bits = values.astype(np.int64, copy=False).view(np.uint64).copy()
        else:  # bool
            bits = values.astype(np.uint64)
        h = splitmix64(bits)
        h[~valid] = NULL_HASH
    else:
        raise TypeError(f"no hash for {dt}")

    if seed is not None:
        seed_np = (seed.to_numpy().astype(np.uint64) if hasattr(seed, "to_numpy")
                   else np.asarray(seed, dtype=np.uint64))
        h = splitmix64(h ^ seed_np)
    return Series.from_numpy(h, series.name)


def combine_hashes(hashes: List[np.ndarray]) -> np.ndarray:
    """Combine per-column uint64 hash arrays into one row hash."""
    out = hashes[0].copy()
    with np.errstate(over="ignore"):
        for h in hashes[1:]:
            out = splitmix64(out ^ (h + _C3 + (out << np.uint64(6)) + (out >> np.uint64(2))))
    return out
