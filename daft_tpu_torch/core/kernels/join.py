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

``ProbeTable`` gives the same pairs in the same order with the right side
indexed once, for a join that probes it with many left batches (the host
join's ``JoinProbe``, execution/executor.py).
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


# ---- the build-once probe table ------------------------------------------------------


def _expand_ranges(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """The ranges [starts[i], starts[i] + counts[i]) concatenated."""
    total = int(counts.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    reps = np.repeat(starts - (np.cumsum(counts) - counts), counts)
    return reps + np.arange(total, dtype=np.int64)


def _no_match(n: int) -> np.ndarray:
    return np.full(n, -1, dtype=np.int64)


class ProbeTable:
    """The right side's keys indexed once, probed by many left batches
    (counterpart of daft_tpu/core/kernels/join.py ``ProbeTable``, in numpy:
    the reference's native hash maps and pandas indexes become a dense
    value range, sorted unique values or a Python dict).

    Build: each key column, cast to the common type of its pair, gets
    codes: an integer-like column of a dense value range (at most
    max(4096, 4 x its valid rows) wide) its values less the smallest,
    another its rank among its sorted unique values, a string column its
    index in a dict of its distinct values. Several columns fold into one
    joint code through pairing levels (a pair's sorted unique values),
    and the rows of each joint code are listed in row order (CSR). A row
    with a null key never matches. Probe: each left column looked up the
    same way (a value the right side lacks cannot match), the levels
    replayed, the CSR ranges expanded. The pairs and their order are
    ``join_indices``': left-major, right rows in row order within a key;
    ``left`` adds the unmatched left rows after the pairs."""

    def __init__(self, right_keys: List, left_dtypes: List):
        self.n_right = len(right_keys[0]) if right_keys else 0
        self._dtypes = []
        # per column: ("dense", lo, hi) | ("sorted", uniq) | ("dict", d) | ("null",)
        self._lookups = []
        rcols = []
        rnull = np.zeros(self.n_right, dtype=bool)
        for rs, ldt in zip(right_keys, left_dtypes):
            target = _common_key_dtype(ldt, rs.dtype)
            if rs.dtype != target:
                rs = rs.cast(target)
            self._dtypes.append(target)
            kind, vals, valid = canonical_key_values(rs)
            if kind == "null":
                valid = np.zeros(self.n_right, dtype=bool)
                codes = np.full(self.n_right, -1, dtype=np.int64)
                self._lookups.append(("null",))
            elif kind == "num":
                vv = vals[valid]
                lo = int(vv.min()) if len(vv) else 0
                hi = int(vv.max()) if len(vv) else -1
                if 0 < hi - lo + 1 <= max(4096, 4 * len(vv)):
                    codes = vals - lo
                    self._lookups.append(("dense", lo, hi))
                else:
                    uniq = np.unique(vv)
                    codes = np.searchsorted(uniq, vals).astype(np.int64) if len(uniq) \
                        else np.zeros(self.n_right, dtype=np.int64)
                    self._lookups.append(("sorted", uniq))
            else:
                index: dict = {}
                codes = np.full(self.n_right, -1, dtype=np.int64)
                rows = np.flatnonzero(valid)
                codes[rows] = [index.setdefault(v, len(index)) for v in vals[rows].tolist()]
                self._lookups.append(("dict", index))
            codes = np.where(valid, codes, -1).astype(np.int64, copy=False)
            rcols.append(codes)
            rnull |= ~valid

        self._levels = []
        codes = rcols[0] if rcols else np.zeros(0, dtype=np.int64)
        for c in rcols[1:]:
            g = int(c.max()) + 1 if len(c) else 1
            pair = (codes + 1) * (g + 2) + (c + 1)
            uniq, codes = np.unique(pair, return_inverse=True)
            codes = codes.reshape(-1).astype(np.int64, copy=False)
            self._levels.append((uniq, g))
        codes = np.where(rnull, -1, codes)

        G = int(codes.max(initial=-1)) + 1
        pos = codes >= 0
        self._counts = np.bincount(codes[pos], minlength=max(G, 1)).astype(np.int64)
        self._starts = np.cumsum(self._counts) - self._counts
        self.max_count = int(self._counts.max(initial=0))
        self._num_codes = G
        rows = np.flatnonzero(pos)
        self._bucket_rows = rows[np.argsort(codes[pos], kind="stable")].astype(np.int64)

    @staticmethod
    def _lookup_strings(s, index: dict) -> np.ndarray:
        """Codes of a string column in ``index`` (-2 where absent): through
        its known dictionary codes when it has them, a lookup per distinct
        value, else a lookup per row."""
        raw = s._raw_codes()
        if raw is not None:
            rcodes, values = raw
            lut = np.array([index.get(v, -2) for v in values], dtype=np.int64)
            return lut[rcodes] if len(lut) else np.full(len(s), -2, dtype=np.int64)
        return np.array([index.get(v, -2) for v in s.to_numpy().tolist()], dtype=np.int64)

    def probe_codes(self, left_keys: List) -> np.ndarray:
        """Each left row's joint code on the right side; negative codes never
        match (-1 a null key)."""
        n = len(left_keys[0]) if left_keys else 0
        lcols = []
        lnull = np.zeros(n, dtype=bool)
        for ls, target, lookup in zip(left_keys, self._dtypes, self._lookups):
            if ls.dtype != target:
                ls = ls.cast(target)
            kind, vals, valid = canonical_key_values(ls)
            if lookup[0] == "null" or kind == "null":
                codes = np.full(n, -2, dtype=np.int64)
            elif lookup[0] == "dense":
                lo, hi = lookup[1], lookup[2]
                codes = np.where((vals < lo) | (vals > hi), -2, vals - lo)
            elif lookup[0] == "sorted":
                uniq = lookup[1]
                if len(uniq):
                    at = np.minimum(np.searchsorted(uniq, vals), len(uniq) - 1)
                    codes = np.where(uniq[at] == vals, at, -2)
                else:
                    codes = np.full(n, -2, dtype=np.int64)
            else:
                codes = self._lookup_strings(ls, lookup[1])
            codes = np.where(valid, codes, -1).astype(np.int64, copy=False)
            lcols.append(codes)
            lnull |= ~valid
        codes = lcols[0] if lcols else np.zeros(0, dtype=np.int64)
        for (uniq, g), c in zip(self._levels, lcols[1:]):
            pair = (codes + 1) * (g + 2) + (c + 1)
            if len(uniq):
                at = np.minimum(np.searchsorted(uniq, pair), len(uniq) - 1)
                codes = np.where((uniq[at] == pair) & (codes >= 0) & (c >= 0), at, -2)
            else:
                codes = np.full(n, -2, dtype=np.int64)
        return np.where(lnull, -1, codes)

    def probe(self, left_keys: List, how: str) -> Tuple[np.ndarray, np.ndarray]:
        """(left rows, right rows) of a ``how`` join of the left batch whose
        keys are ``left_keys`` against the right side; -1 = no partner."""
        if how not in JOIN_TYPES:
            raise ValueError(f"ProbeTable.probe does not support how={how!r}")
        lcodes = self.probe_codes(left_keys)
        nl = len(lcodes)
        hit = (lcodes >= 0) & (lcodes < self._num_codes)
        safe = np.where(hit, lcodes, 0)
        counts = np.where(hit, self._counts[safe], 0)
        if how in ("semi", "anti"):
            lidx = np.flatnonzero(counts > 0 if how == "semi" else counts == 0)
            return lidx.astype(np.int64), _no_match(len(lidx))
        if self.max_count == 1:
            # unique right keys: one gather per matched left row
            matched_l = np.flatnonzero(counts).astype(np.int64)
            matched_r = self._bucket_rows[self._starts[lcodes[matched_l]]]
        else:
            matched_l = np.repeat(np.arange(nl, dtype=np.int64), counts)
            starts = np.where(hit, self._starts[safe], 0)
            matched_r = self._bucket_rows[_expand_ranges(starts, counts)]
        if how == "inner":
            return matched_l, matched_r
        unmatched = np.flatnonzero(counts == 0).astype(np.int64)
        return (np.concatenate([matched_l, unmatched]),
                np.concatenate([matched_r, _no_match(len(unmatched))]))
