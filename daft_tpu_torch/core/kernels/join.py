"""Host inner equi-join in numpy (the contract of daft_tpu/core/kernels/join.py
``join_indices`` / ``ProbeTable`` for inner joins; the reference builds them
on its native hash map and pandas, the port on sort + searchsorted).

``inner_join_indices`` returns the matching (left row, right row) pairs in
left-row order, and for one left row its right matches in right-row order.
Null keys never match. Multi-column keys compare column by column after each
pair is cast to its common key type (encoding.py).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .encoding import _common_key_dtype, canonical_key_values


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


def inner_join_indices(left_keys: List, right_keys: List) -> Tuple[np.ndarray, np.ndarray]:
    """(left_idx, right_idx) int64 arrays of every matching row pair."""
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
    order = np.argsort(rcode[right_rows], kind="stable")
    right_rows = right_rows[order]
    sorted_codes = rcode[right_rows]
    lo = np.searchsorted(sorted_codes, lcode, side="left")
    hi = np.searchsorted(sorted_codes, lcode, side="right")
    counts = np.where(lvalid, hi - lo, 0)
    left_idx = np.repeat(np.arange(n_left, dtype=np.int64), counts)
    starts = np.repeat(lo - (np.cumsum(counts) - counts), counts)
    right_idx = right_rows[starts + np.arange(len(left_idx), dtype=np.int64)]
    return left_idx, right_idx
