"""Host equi-join indices in numpy (the contract of
daft_tpu/core/kernels/join.py ``join_indices`` and ``cross_join_indices``;
the reference builds them on its native hash map and pandas, the port on
sort + searchsorted).

``join_indices(how=...)`` returns (left rows, right rows), -1 marking a
missing partner:

- ``inner``: every matching pair in left-row order, and for one left row
  its right matches in right-row order;
- ``left``: the inner pairs, then every left row without a match (in
  left-row order) paired with -1, as the reference emits them;
- ``semi`` / ``anti``: the left rows with / without a match, in order, and
  -1 for the right.

Null keys never match. Multi-column keys compare column by column after
each pair is cast to its common key type (encoding.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .encoding import _common_key_dtype, canonical_key_values

JOIN_TYPES = ("inner", "left", "semi", "anti")


def _joint_codes(left, right) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Dense codes of one key column pair over both sides at once (equal
    keys share a code) and each side's validity."""
    target = _common_key_dtype(left.dtype, right.dtype)
    sides = []
    for s in (left, right):
        s = s if s.dtype == target else s.cast(target)
        kind, vals, valid = canonical_key_values(s)
        if kind == "null":
            valid = np.zeros(len(s), dtype=bool)
        sides.append((vals, valid))
    (lv, lm), (rv, rm) = sides
    both = np.concatenate([lv[lm], rv[rm]])
    codes = np.unique(both, return_inverse=True)[1].reshape(-1) if len(both) \
        else np.zeros(0, dtype=np.int64)
    lc = np.zeros(len(lv), dtype=np.int64)
    rc = np.zeros(len(rv), dtype=np.int64)
    lc[lm] = codes[:int(lm.sum())]
    rc[rm] = codes[int(lm.sum()):]
    return lc, rc, lm, rm


def _matches(left_keys: List, right_keys: List):
    """(right rows with a valid key, sorted by key code; each left row's
    first match among them; its match count, 0 for a null key)."""
    n_left, n_right = len(left_keys[0]), len(right_keys[0])
    lcode = np.zeros(n_left, dtype=np.int64)
    rcode = np.zeros(n_right, dtype=np.int64)
    lvalid = np.ones(n_left, dtype=bool)
    rvalid = np.ones(n_right, dtype=bool)
    for ls, rs in zip(left_keys, right_keys):
        lc, rc, lm, rm = _joint_codes(ls, rs)
        # fold this column into the running code, then re-densify so the
        # product never overflows
        width = int(max(lc.max(initial=0), rc.max(initial=0))) + 1
        joint = np.unique(np.concatenate([lcode * width + lc, rcode * width + rc]),
                          return_inverse=True)[1].reshape(-1)
        lcode, rcode = joint[:n_left], joint[n_left:]
        lvalid &= lm
        rvalid &= rm
    right_rows = np.flatnonzero(rvalid)
    right_rows = right_rows[np.argsort(rcode[right_rows], kind="stable")]
    sorted_codes = rcode[right_rows]
    lo = np.searchsorted(sorted_codes, lcode, side="left")
    hi = np.searchsorted(sorted_codes, lcode, side="right")
    return right_rows, lo, np.where(lvalid, hi - lo, 0)


def join_indices(left_keys: List, right_keys: List,
                 how: str = "inner") -> Tuple[np.ndarray, np.ndarray]:
    """(left_idx, right_idx) int64 arrays of a ``how`` join; -1 = no
    partner."""
    if how not in JOIN_TYPES:
        raise ValueError(f"unsupported join type {how!r}")
    n_left = len(left_keys[0])
    right_rows, lo, counts = _matches(left_keys, right_keys)
    if how in ("semi", "anti"):
        lidx = np.flatnonzero(counts > 0 if how == "semi" else counts == 0)
        return lidx.astype(np.int64), np.full(len(lidx), -1, dtype=np.int64)
    left_idx = np.repeat(np.arange(n_left, dtype=np.int64), counts)
    starts = np.repeat(lo - (np.cumsum(counts) - counts), counts)
    right_idx = right_rows[starts + np.arange(len(left_idx), dtype=np.int64)]
    if how == "left":
        unmatched = np.flatnonzero(counts == 0).astype(np.int64)
        left_idx = np.concatenate([left_idx, unmatched])
        right_idx = np.concatenate([right_idx, np.full(len(unmatched), -1, dtype=np.int64)])
    return left_idx, right_idx.astype(np.int64)


def cross_join_indices(n_left: int, n_right: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every (left, right) pair, left-major."""
    lidx = np.repeat(np.arange(n_left, dtype=np.int64), n_right)
    ridx = np.tile(np.arange(n_right, dtype=np.int64), n_left)
    return lidx, ridx
