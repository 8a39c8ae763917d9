"""MinHash signatures for LSH dedup (counterpart of
daft_tpu/core/kernels/minhash.py): word-shingle MinHash with k universal-hash
permutations h_i(x) = (a_i x + b_i) mod (2^61 - 1), masked to 32 bits, over
each shingle's 8-byte BLAKE2b hash. The permutations are numpy's
``default_rng(seed)`` draws, as the reference draws them, so signatures
equal the reference's bit for bit.
"""

from __future__ import annotations

import hashlib

import numpy as np

_MERSENNE_P = np.uint64((1 << 61) - 1)
_MAX_HASH = np.uint64(0xFFFFFFFF)
_CHUNK_ROWS = 2048


def permutations(num_hashes: int, seed: int):
    """(a, b): the k permutations' uint64 coefficients (minhash.py:17-21)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(1, 1 << 32, size=num_hashes, dtype=np.uint64)
    b = rng.integers(0, 1 << 32, size=num_hashes, dtype=np.uint64)
    return a, b


def shingles(text: str, ngram_size: int) -> list:
    """The space-joined word n-grams of ``text`` (a text shorter than one
    n-gram is one shingle of all its words; no words, none)."""
    words = text.split()
    if len(words) < ngram_size:
        return [" ".join(words)] if words else []
    return [" ".join(words[j:j + ngram_size]) for j in range(len(words) - ngram_size + 1)]


def minhash_series(series, num_hashes: int = 16, ngram_size: int = 1, seed: int = 1):
    """Each string row's signature as a ``fixed_size_list(uint64,
    num_hashes)``; a null row is null, a row of no words all 0xFFFFFFFF
    (minhash.py:24-62)."""
    from ...datatype import DataType
    from ..series import Series

    a, b = permutations(num_hashes, seed)
    n = len(series)
    out = np.full((n, num_hashes), _MAX_HASH, dtype=np.uint64)
    valid = series.validity_numpy()
    texts = series.to_pylist()
    # rows in chunks: every shingle of a chunk hashed at once, each row's
    # minimum by a segmented reduction (the reference's row loop, the same
    # values)
    for start in range(0, n, _CHUNK_ROWS):
        rows, digests = [], []
        for i in range(start, min(start + _CHUNK_ROWS, n)):
            if texts[i] is None:
                continue
            sh = shingles(texts[i], ngram_size)
            if sh:
                rows.append((i, len(sh)))
                digests.extend(hashlib.blake2b(x.encode(), digest_size=8).digest()
                               for x in sh)
        if not rows:
            continue
        base = np.frombuffer(b"".join(digests), dtype=np.uint64)
        with np.errstate(over="ignore"):
            hashed = (base[:, None] * a[None, :] + b[None, :]) % _MERSENNE_P
            hashed &= _MAX_HASH
        idx = np.array([r for r, _k in rows], dtype=np.int64)
        counts = np.array([k for _r, k in rows], dtype=np.int64)
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        out[idx] = np.minimum.reduceat(hashed, starts, axis=0)
    return Series.from_numpy(out, series.name,
                             DataType.fixed_size_list(DataType.uint64(), num_hashes),
                             validity=valid)
