"""Host equi-join indices (the contract of daft_tpu/core/kernels/join.py
``join_indices`` and ``cross_join_indices``), on the host kernel library's
bucket join (native.py ``native_join_indices``: ``join_count`` then
``join_fill``).

``join_indices(how=...)`` returns (left rows, right rows), -1 marking a
missing partner:

- ``inner``: every matching pair in left-row order, and for one left row
  its right matches in right-row order;
- ``left``: the inner pairs, then every left row without a match (in
  left-row order) paired with -1, as the reference emits them;
- ``outer``: the ``left`` rows, then every right row without a match (in
  right-row order) paired with -1 on the left;
- ``right``: the ``left`` join with the sides swapped;
- ``semi`` / ``anti``: the left rows with / without a match, in order, and
  -1 for the right.

Null keys never match, unless ``null_equals_null`` (the SQL set
operations), when a null matches a null. Multi-column keys compare column
by column after each pair is cast to its common key type (encoding.py).
Each column's codes over both sides are its values less the smallest
where the integer domain is dense (the reference's
``_dense_int_pair_codes``), else the library's factorize (strings: their
rank among the sorted distinct values); further columns pair in through
``native_combine_factorize``.

``ProbeTable`` gives the same pairs in the same order with the right side
indexed once, for a join that probes it with many left batches (the host
join's ``JoinProbe``, execution/executor.py).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ... import native
from .encoding import _common_key_dtype, canonical_key_values

JOIN_TYPES = ("inner", "left", "semi", "anti")
ALL_JOIN_TYPES = JOIN_TYPES + ("right", "outer")


def _column_codes(left, right, null_equals_null: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Codes of one key column pair over both sides at once (equal keys
    share a code; a null is -1, or one more code with
    ``null_equals_null``)."""
    target = _common_key_dtype(left.dtype, right.dtype)
    sides = []
    for s in (left, right):
        s = s if s.dtype == target else s.cast(target)
        kind, vals, valid = canonical_key_values(s)
        if kind == "null":
            valid = np.zeros(len(s), dtype=bool)
        sides.append((kind, vals, valid))
    (lk, lv, lm), (rk, rv, rm) = sides
    n_left = len(lv)
    numeric = "obj" not in (lk, rk)
    both = np.concatenate([lv[lm], rv[rm]])
    if not len(both):
        codes = np.zeros(0, dtype=np.int64)
    elif numeric and (dense := _dense_bounds(both)) is not None:
        codes = both - dense
    elif numeric:
        codes = native.native_factorize(both)[0]
    else:
        codes = np.unique(both, return_inverse=True)[1].reshape(-1).astype(np.int64)
    null = int(codes.max(initial=-1)) + 1 if null_equals_null else -1
    lc = np.full(n_left, null, dtype=np.int64)
    rc = np.full(len(rv), null, dtype=np.int64)
    kept = int(lm.sum())
    lc[lm] = codes[:kept]
    rc[rm] = codes[kept:]
    return lc, rc


def _dense_bounds(vals: np.ndarray) -> Optional[int]:
    """The smallest value when the int64 values span a dense domain (at
    most max(1024, 4 n) wide), else None."""
    lo, hi = int(vals.min()), int(vals.max())
    return lo if hi - lo + 1 <= max(1024, 4 * len(vals)) else None


def _joint_codes(left_keys: List, right_keys: List, null_equals_null: bool = False):
    """(left codes, right codes, number of codes): one code per row for
    every key column together; a row with a null key gets -1 (never
    matches) unless ``null_equals_null``."""
    n_left = len(left_keys[0])
    codes = None
    for ls, rs in zip(left_keys, right_keys):
        lc, rc = _column_codes(ls, rs, null_equals_null)
        c = np.concatenate([lc, rc])
        if codes is None:
            codes = c
            null = c < 0
        else:
            codes = native.native_combine_factorize(codes, c, int(c.max(initial=-1)) + 1)[0]
            null |= c < 0
    codes = np.where(null, -1, codes)
    return codes[:n_left], codes[n_left:], int(codes.max(initial=-1)) + 1


def _assemble(how: str, hit: np.ndarray, pairs=None) -> Tuple[np.ndarray, np.ndarray]:
    """The ``how`` join's (left rows, right rows) from each left row's
    ``hit`` (has a match) and, but for semi and anti, the inner pairs."""
    if how in ("semi", "anti"):
        lidx = np.flatnonzero(hit if how == "semi" else ~hit).astype(np.int64)
        return lidx, _no_match(len(lidx))
    matched_l, matched_r = pairs
    if how == "inner":
        return matched_l, matched_r
    unmatched = np.flatnonzero(~hit).astype(np.int64)
    return (np.concatenate([matched_l, unmatched]),
            np.concatenate([matched_r, _no_match(len(unmatched))]))


def join_indices(left_keys: List, right_keys: List, how: str = "inner",
                 null_equals_null: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """(left_idx, right_idx) int64 arrays of a ``how`` join; -1 = no
    partner."""
    if how == "right":
        ri, li = join_indices(right_keys, left_keys, "left", null_equals_null)
        return li, ri
    if how not in ALL_JOIN_TYPES:
        raise ValueError(f"unsupported join type {how!r}")
    lcode, rcode, num_codes = _joint_codes(left_keys, right_keys, null_equals_null)
    if how in ("semi", "anti"):
        return _assemble(how, native.native_join_counts(lcode, rcode, num_codes) > 0)
    matched_l, matched_r, counts = native.native_join_indices(lcode, rcode, num_codes)
    left_idx, right_idx = _assemble("inner" if how == "inner" else "left", counts > 0,
                                    (matched_l, matched_r))
    if how == "outer":
        hit = np.zeros(len(rcode), dtype=bool)
        hit[matched_r] = True
        lonely = np.flatnonzero(~hit).astype(np.int64)
        left_idx = np.concatenate([left_idx, _no_match(len(lonely))])
        right_idx = np.concatenate([right_idx, lonely])
    return left_idx, right_idx


def cross_join_indices(n_left: int, n_right: int) -> Tuple[np.ndarray, np.ndarray]:
    """Every (left, right) pair, left-major."""
    lidx = np.repeat(np.arange(n_left, dtype=np.int64), n_right)
    ridx = np.tile(np.arange(n_right, dtype=np.int64), n_left)
    return lidx, ridx


# ---- the build-once probe table ------------------------------------------------------


def _no_match(n: int) -> np.ndarray:
    return np.full(n, -1, dtype=np.int64)


class ProbeTable:
    """The right side's keys indexed once, probed by many left batches
    (counterpart of daft_tpu/core/kernels/join.py ``ProbeTable``, on the
    host kernel library).

    Build: each key column, cast to the common type of its pair, gets
    codes: an integer-like column of a dense value range (at most
    max(4096, 4 x its valid rows) wide) its values less the smallest,
    another its code in the library's factorize, looked up through an
    int64 map (``native_i64_map_build``), a string column its index in a
    dict of its distinct values. Several columns fold into one joint code
    through pairing levels (each a factorize of the pairs and a map over
    them), and the rows of each joint code are listed in row order
    (``native_bucket_build``, ``native_bucket_scatter``). A row with a null
    key never matches. Probe: a single integer-like key goes value -> code
    -> matches in one library pass (``native_probe_lookup_count``, then
    ``native_probe_fill``), or, when the right keys are unique, value ->
    right row in one read (``native_probe_unique``); other keys are looked
    up column by column (a value the right side lacks cannot match), the
    levels replayed and the buckets read (``native_probe``). The pairs and
    their order are ``join_indices``': left-major, right rows in row order
    within a key; ``left`` adds the unmatched left rows after the pairs.
    With ``null_equals_null`` (the set operations) a null key is one more
    code of its column, reserved past the column's value codes, on both
    sides. Everything is built in the constructor and only read by a
    probe, so pool threads probe one table at once."""

    def __init__(self, right_keys: List, left_dtypes: List, null_equals_null: bool = False):
        self.n_right = len(right_keys[0]) if right_keys else 0
        self.null_equals_null = null_equals_null
        self._dtypes = []
        # per column: ("dense", lo, hi) | ("hashmap", (slots, cap)) | ("dict", d) | ("null",)
        self._lookups = []
        # per column: the code a null key takes under null_equals_null
        self._null_codes = []
        single_vals = None  # the one key column's values, when none is null
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
                null_code = 0
            elif kind == "num":
                vv = vals[valid]
                lo = int(vv.min()) if len(vv) else 0
                hi = int(vv.max()) if len(vv) else -1
                if 0 < hi - lo + 1 <= max(4096, 4 * len(vv)):
                    codes = vals - lo
                    self._lookups.append(("dense", lo, hi))
                    null_code = hi - lo + 1
                else:
                    kept, null_code = native.native_factorize(vv)
                    keys = np.empty(null_code, dtype=np.int64)
                    keys[kept] = vv
                    codes = np.full(self.n_right, -1, dtype=np.int64)
                    codes[valid] = kept
                    self._lookups.append(("hashmap", native.native_i64_map_build(keys)))
                if len(right_keys) == 1 and valid.all():
                    single_vals = vals
            else:
                index: dict = {}
                codes = np.full(self.n_right, -1, dtype=np.int64)
                rows = np.flatnonzero(valid)
                codes[rows] = [index.setdefault(v, len(index)) for v in vals[rows].tolist()]
                self._lookups.append(("dict", index))
                null_code = len(index)
            self._null_codes.append(null_code)
            if null_equals_null:
                codes = np.where(valid, codes, null_code).astype(np.int64, copy=False)
            else:
                codes = np.where(valid, codes, -1).astype(np.int64, copy=False)
                rnull |= ~valid
            rcols.append(codes)

        self._levels = []
        codes = rcols[0] if rcols else np.zeros(0, dtype=np.int64)
        for c in rcols[1:]:
            g = int(c.max(initial=-1)) + 1
            pair = (codes + 1) * (g + 2) + (c + 1)
            codes, n_pairs = native.native_factorize(pair)
            keys = np.empty(n_pairs, dtype=np.int64)
            keys[codes] = pair
            self._levels.append((native.native_i64_map_build(keys), g))
        codes = np.where(rnull, -1, codes)

        G = int(codes.max(initial=-1)) + 1
        counts, starts, self.max_count = native.native_bucket_build(codes, G)
        # kernels take a pointer even to an empty table
        self._counts = counts if G else np.zeros(1, dtype=np.int64)
        self._starts = starts if G else np.zeros(1, dtype=np.int64)
        self._num_codes = G
        self._bucket_rows = native.native_bucket_scatter(codes, G, self._starts,
                                                         int(counts.sum()))
        # unique right keys over one integer-like column: value -> right row
        self._direct = None
        lookup = self._lookups[0] if len(self._lookups) == 1 else ("none",)
        if self.max_count == 1 and not null_equals_null:
            if lookup[0] == "dense":
                table = np.full(lookup[2] - lookup[1] + 1, -1, dtype=np.int64)
                pos = codes >= 0
                table[codes[pos]] = np.flatnonzero(pos)
                self._direct = ("dense", lookup[1], lookup[2], table)
            elif lookup[0] == "hashmap" and single_vals is not None:
                # unique keys, none null: each row's code is the row itself
                # (first-occurrence codes), so the column's map is value -> row
                self._direct = ("pairmap",) + lookup[1]

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

    def _single_key(self, left_keys: List):
        """(values, validity or None) of the left batch's one integer-like
        key when the library's fused probes apply, else None."""
        if (len(self._lookups) != 1 or self.null_equals_null
                or self._lookups[0][0] not in ("dense", "hashmap")):
            return None
        ls = left_keys[0]
        if ls.dtype != self._dtypes[0]:
            ls = ls.cast(self._dtypes[0])
        kind, vals, valid = canonical_key_values(ls)
        if kind != "num":
            return None
        return vals, (None if valid.all() else valid)

    def probe_codes(self, left_keys: List) -> np.ndarray:
        """Each left row's joint code on the right side; negative codes never
        match (-1 a null key)."""
        n = len(left_keys[0]) if left_keys else 0
        lcols = []
        lnull = np.zeros(n, dtype=bool)
        for ls, target, lookup, null_code in zip(left_keys, self._dtypes, self._lookups,
                                                 self._null_codes):
            if ls.dtype != target:
                ls = ls.cast(target)
            kind, vals, valid = canonical_key_values(ls)
            if lookup[0] == "null" or kind == "null":
                codes = np.full(n, -2, dtype=np.int64)
            elif lookup[0] == "dense":
                lo, hi = lookup[1], lookup[2]
                codes = np.where((vals < lo) | (vals > hi), -2, vals - lo)
            elif lookup[0] == "hashmap":
                codes = native.native_i64_map_lookup(*lookup[1], vals)
                codes = np.where(codes >= 0, codes, -2)
            else:
                codes = self._lookup_strings(ls, lookup[1])
            if kind == "null":
                valid = np.zeros(n, dtype=bool)
            if self.null_equals_null:
                codes = np.where(valid, codes, null_code).astype(np.int64, copy=False)
            else:
                codes = np.where(valid, codes, -1).astype(np.int64, copy=False)
                lnull |= ~valid
            lcols.append(codes)
        codes = lcols[0] if lcols else np.zeros(0, dtype=np.int64)
        for (hm, g), c in zip(self._levels, lcols[1:]):
            found = native.native_i64_map_lookup(*hm, (codes + 1) * (g + 2) + (c + 1))
            codes = np.where((found >= 0) & (codes >= 0) & (c >= 0), found, -2)
        return np.where(lnull, -1, codes)

    def probe(self, left_keys: List, how: str) -> Tuple[np.ndarray, np.ndarray]:
        """(left rows, right rows) of a ``how`` join of the left batch whose
        keys are ``left_keys`` against the right side; -1 = no partner."""
        if how not in JOIN_TYPES:
            raise ValueError(f"ProbeTable.probe does not support how={how!r}")
        single = self._single_key(left_keys)
        G = self._num_codes
        if single is not None and self._direct is not None:
            ridx, matched_l, matched_r = native.native_probe_unique(*single, self._direct)
            return _assemble(how, ridx >= 0, (matched_l, matched_r))
        if single is not None:
            codes, l_match, total = native.native_probe_lookup_count(
                *single, self._lookups[0], self._counts, G)
            if how in ("semi", "anti"):
                return _assemble(how, l_match > 0)
            pairs = native.native_probe_fill(codes, G, self._starts, self._counts,
                                             self._bucket_rows, total)
            return _assemble(how, l_match > 0, pairs)
        lcodes = self.probe_codes(left_keys)
        if how in ("semi", "anti"):
            hit = (lcodes >= 0) & (lcodes < G)
            return _assemble(how, hit & (self._counts[np.where(hit, lcodes, 0)] > 0))
        matched_l, matched_r, l_match = native.native_probe(lcodes, G, self._starts,
                                                            self._counts, self._bucket_rows)
        return _assemble(how, l_match > 0, (matched_l, matched_r))
