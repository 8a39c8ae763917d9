"""Multi-column stable sort (counterpart of daft_tpu/core/kernels/sort.py).

np.lexsort over order-preserving keys: each column contributes a null-placement
key and a value key (strings by their rank codes), so int64 keys keep full
precision and ties keep input order.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def _column_keys(series, descending: bool, nulls_first: bool) -> List[np.ndarray]:
    """[null_key, value_key] for one sort column (null_key more significant)."""
    valid = series.validity_numpy()
    if series.dtype.is_nested() or series.dtype.kind == "fixed_size_binary":
        # the reference's fallback: by row hash (an order, not a meaningful one)
        vals = series.hash().to_numpy()
    else:
        vals = series.to_numpy()
    raw = series._raw_codes() if series.dtype.is_string() else None
    if raw is not None:
        # known dictionary codes: each entry's rank among the distinct words
        codes, words = raw
        rank = np.zeros(len(words) + 1, dtype=np.int64)
        r, prev = -1, None
        for w, i in sorted((w, i) for i, w in enumerate(words) if w is not None):
            r += w != prev or r < 0
            rank[i], prev = r, w
        vals = rank[np.asarray(codes, dtype=np.int64)]
    elif series.dtype.is_string() or series.dtype.is_null() or series.dtype.is_binary() \
            or series.dtype.is_nested():
        codes = np.zeros(len(series), dtype=np.int64)
        if valid.any():
            codes[valid] = np.unique(vals[valid], return_inverse=True)[1].reshape(-1)
        vals = codes
    elif vals.dtype.kind == "f":
        vals = np.where(np.isnan(vals), np.inf, vals)  # NaN after every number
    elif vals.dtype.kind == "b":
        vals = vals.astype(np.int8)
    if descending:
        # bitwise-not reverses integer order without overflow at the minimum
        vals = np.bitwise_not(vals) if vals.dtype.kind in "iu" else -vals
    vals = np.where(valid, vals, vals.dtype.type(0))
    null_key = np.where(valid, np.int8(0), np.int8(-1 if nulls_first else 1))
    return [null_key, vals]


def multi_argsort(key_series: Sequence, descending: Sequence[bool],
                  nulls_first: Optional[Sequence[bool]] = None) -> np.ndarray:
    """Stable multi-column argsort; nulls sort last ascending, first descending
    unless ``nulls_first`` says otherwise."""
    if nulls_first is None:
        nulls_first = list(descending)
    keys: List[np.ndarray] = []
    for s, d, nf in zip(key_series, descending, nulls_first):
        keys.extend(_column_keys(s, d, nf))
    return np.lexsort(tuple(reversed(keys))).astype(np.int64)
