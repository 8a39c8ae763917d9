"""Window function evaluation in numpy (counterpart of
daft_tpu/execution/window.py, without pyarrow).

One pass for every window expression of a spec: the rows sort once by
(partition, order keys) (``multi_argsort``, stable), each expression is
computed in that order with segment arithmetic, and the results scatter
back to the input's row order. Partitions are the partition keys' groups
(nulls form their own); peers are rows of one partition equal on every
order key.

- ranking: ``row_number``, ``rank``, ``dense_rank``, ``percent_rank``,
  ``cume_dist``, ``ntile`` (the first ``len % n`` buckets one row larger);
- ``lag`` / ``lead`` by an offset within the partition, a default (or null)
  past its edge; ``first_value`` / ``last_value`` of the frame;
- aggregations over the frame (``sum``, ``count``, ``mean``, ``stddev``,
  ``var``, ``min``, ``max``): prefix sums for the sums and counts (integers
  in int64, exact past 2^53; floats in float64), f64 prefix sums of x and
  x^2 for the population stddev and var, a sparse table for min and max
  (``_sliding_minmax``). The frame is ``rows_between`` (row offsets) or
  ``range_between`` (the one numeric order key's offsets; a null key frames
  over its peers), clipped to the partition; with none, an ordered window
  runs from the partition's start through the current row's peers, an
  unordered one covers the partition. A frame that is empty, or holds fewer
  than ``min_periods`` rows, or no valid value, gives null (a count, 0).
  ``any_value``, ``skew``, ``bool_and``, ``bool_or`` and ``count_distinct``
  raise over a window, as in the reference.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..core.kernels.groupby import equality_codes, make_groups
from ..core.kernels.sort import multi_argsort
from ..core.recordbatch import RecordBatch
from ..core.series import Series, _null_fill
from ..datatype import DataType
from ..expressions.eval import eval_expression
from ..schema import Schema
from ..window import Window


def _full(batch: RecordBatch, e) -> Series:
    s = eval_expression(batch, e)
    return s.broadcast(batch.num_rows) if len(s) == 1 and batch.num_rows != 1 else s


def eval_window(batch: RecordBatch, window_exprs, spec, schema: Schema) -> RecordBatch:
    """``batch``'s columns, then one column per window expression of
    ``spec``, rows in ``batch``'s order."""
    n = batch.num_rows
    if n == 0:
        return RecordBatch.empty(schema)

    if spec.partition_by_exprs:
        _, group_ids, _ = make_groups([_full(batch, e) for e in spec.partition_by_exprs])
    else:
        group_ids = np.zeros(n, dtype=np.int64)

    order_series = [_full(batch, e) for e in spec.order_by_exprs]
    if order_series:
        sorted_idx = multi_argsort([Series.from_numpy(group_ids, "__gid__")] + order_series,
                                   [False] + list(spec.descending),
                                   [False] + list(spec.nulls_first))
    else:
        sorted_idx = np.argsort(group_ids, kind="stable")

    sg = group_ids[sorted_idx]
    seg_start_flag = np.empty(n, dtype=bool)
    seg_start_flag[0] = True
    seg_start_flag[1:] = sg[1:] != sg[:-1]
    seg_id_sorted = np.cumsum(seg_start_flag) - 1
    seg_starts = np.flatnonzero(seg_start_flag)
    seg_len = np.append(seg_starts[1:], n) - seg_starts
    row_start = seg_starts[seg_id_sorted]
    row_len = seg_len[seg_id_sorted]
    pos_in_seg = np.arange(n) - row_start

    peer_new = seg_start_flag.copy()
    for s in order_series:
        codes = equality_codes(s.take(sorted_idx))  # a null is its own code
        peer_new[1:] |= codes[1:] != codes[:-1]
    peer_gid = np.cumsum(peer_new) - 1
    peer_first = np.flatnonzero(peer_new)
    peer_last = np.append(peer_first[1:], n) - 1
    rows = _Rows(sorted_idx, n, row_start, row_len, pos_in_seg, peer_new,
                 peer_first[peer_gid], peer_last[peer_gid], seg_id_sorted)

    out_cols: List[Series] = batch.columns()
    for we in window_exprs:
        out_cols.append(_eval_one(we, batch, spec, rows).rename(we.name()))
    cols = [c.cast(f.dtype) if c.dtype != f.dtype else c
            for c, f in zip(out_cols, schema)]
    return RecordBatch(schema, cols, n)


class _Rows:
    """Per sorted row: its partition's start and length, its position in
    it, and its peer group's first and last row."""

    __slots__ = ("sorted_idx", "n", "row_start", "row_len", "pos_in_seg", "peer_new",
                 "peer_first", "peer_last", "seg_id_sorted")

    def __init__(self, sorted_idx, n, row_start, row_len, pos_in_seg, peer_new,
                 peer_first, peer_last, seg_id_sorted):
        self.sorted_idx = sorted_idx
        self.n = n
        self.row_start = row_start
        self.row_len = row_len
        self.pos_in_seg = pos_in_seg
        self.peer_new = peer_new
        self.peer_first = peer_first
        self.peer_last = peer_last
        self.seg_id_sorted = seg_id_sorted


def _scatter(sorted_vals: np.ndarray, sorted_idx: np.ndarray, n: int) -> np.ndarray:
    out = np.empty(n, dtype=sorted_vals.dtype)
    out[sorted_idx] = sorted_vals
    return out


def _scatter_series(sorted_series: Series, sorted_idx: np.ndarray, n: int) -> Series:
    inv = np.empty(n, dtype=np.int64)
    inv[sorted_idx] = np.arange(n)
    return sorted_series.take(inv)


def _uint64(vals, r: _Rows, name: str) -> Series:
    return Series.from_numpy(_scatter(vals.astype(np.uint64), r.sorted_idx, r.n), name,
                             DataType.uint64())


def _pick(mask: np.ndarray, a: Series, b: Series) -> Series:
    """``a`` where ``mask``, else ``b`` (one dtype)."""
    values = np.where(mask, a.to_numpy(), b.to_numpy())
    if values.dtype != a.to_numpy().dtype:
        values = values.astype(a.to_numpy().dtype)
    return Series(a.name, a.dtype, values,
                  np.where(mask, a.validity_numpy(), b.validity_numpy()))


def _eval_one(we, batch: RecordBatch, spec, r: _Rows) -> Series:
    func = we.func
    name = we.name()
    n, sorted_idx = r.n, r.sorted_idx

    # ---- ranking --------------------------------------------------------------------
    if func == "row_number":
        return _uint64(r.pos_in_seg + 1, r, name)
    if func == "rank":
        return _uint64(r.peer_first - r.row_start + 1, r, name)
    if func == "dense_rank":
        peer_idx = np.cumsum(r.peer_new) - 1
        starts = np.flatnonzero(r.peer_new)
        first_peer_of_seg = np.zeros(r.seg_id_sorted.max() + 1, dtype=np.int64)
        # each segment's smallest peer id (written last, from the reversed order)
        first_peer_of_seg[r.seg_id_sorted[starts][::-1]] = peer_idx[starts][::-1]
        return _uint64(peer_idx - first_peer_of_seg[r.seg_id_sorted] + 1, r, name)
    if func == "percent_rank":
        rank = (r.peer_first - r.row_start).astype(np.float64)
        denom = np.maximum(r.row_len - 1, 1).astype(np.float64)
        vals = np.where(r.row_len > 1, rank / denom, 0.0)
        return Series.from_numpy(_scatter(vals, sorted_idx, n), name, DataType.float64())
    if func == "cume_dist":
        vals = (r.peer_last - r.row_start + 1).astype(np.float64) / r.row_len
        return Series.from_numpy(_scatter(vals, sorted_idx, n), name, DataType.float64())
    if func == "ntile":
        k = int(we.params["n"])
        base = r.row_len // k
        rem = r.row_len % k
        big = (base + 1) * rem
        pos = r.pos_in_seg
        vals = np.where(pos < big, pos // np.maximum(base + 1, 1),
                        np.where(base > 0, rem + (pos - big) // np.maximum(base, 1), rem)) + 1
        return _uint64(vals, r, name)

    # ---- value functions ------------------------------------------------------------
    child = _full(batch, we.child)
    sorted_child = child.take(sorted_idx)
    if func in ("lag", "lead"):
        offset = int(we.params.get("offset", 1))
        if func == "lead":
            offset = -offset
        src = np.arange(n) - offset
        inside = (src >= r.row_start) & (src < r.row_start + r.row_len)
        taken = sorted_child.take(np.where(inside, np.clip(src, 0, n - 1), 0))
        default = we.params.get("default")
        fill = Series.full_null(name, child.dtype, n) if default is None \
            else Series.from_pylist([default] * n, name, child.dtype)
        return _scatter_series(_pick(inside, taken, fill), sorted_idx, n)

    rk = _compute_range_keys(batch, spec, sorted_idx) if spec.frame_type == "range" else None
    lo, hi, empty = _frame_bounds(spec, n, r, rk)
    if func in ("first_value", "last_value"):
        picked = sorted_child.take(np.clip(lo if func == "first_value" else hi, 0, n - 1))
        if empty.any():
            picked = _pick(~empty, picked, Series.full_null(name, child.dtype, n))
        return _scatter_series(picked, sorted_idx, n)

    # ---- aggregations over the frame ------------------------------------------------
    frame_rows = np.where(empty, 0, hi + 1 - lo)
    if spec.min_periods > 1:
        empty = empty | (frame_rows < spec.min_periods)
        frame_rows = np.where(empty, 0, frame_rows)
    # an empty frame collapses to a zero-width span, so prefix differences read 0
    lo_e = np.where(empty, r.row_start, lo)
    hi_e = np.where(empty, r.row_start - 1, hi)

    if sorted_child.dtype.is_null():
        if func == "count":
            out = frame_rows.astype(np.uint64) if we.params.get("mode", "valid") == "all" \
                else np.zeros(n, np.uint64)
            return Series.from_numpy(_scatter(out, sorted_idx, n), name, DataType.uint64())
        return Series.full_null(name, we.to_field(batch.schema).dtype, n)

    vals = sorted_child.to_numpy()
    valid = sorted_child.validity_numpy()
    if vals.dtype == object:
        raise ValueError(f"windowed aggregation over non-numeric column {name!r} not supported")
    is_int = np.issubdtype(vals.dtype, np.integer) or vals.dtype == bool
    fvals = np.where(valid, vals.astype(np.int64 if is_int else np.float64),
                     np.int64(0) if is_int else 0.0)
    csum = np.concatenate([np.zeros(1, dtype=fvals.dtype), np.cumsum(fvals)])
    ccnt = np.concatenate([[0], np.cumsum(valid.astype(np.int64))])
    wsum = csum[hi_e + 1] - csum[lo_e]
    wcnt = ccnt[hi_e + 1] - ccnt[lo_e]
    has = (wcnt > 0) & ~empty

    def null_where_empty(out: np.ndarray, cast_to=None) -> Series:
        dtype = DataType.from_numpy(out.dtype)
        out = np.where(has, out, out.dtype.type(_null_fill(dtype)))
        s = Series(name, dtype, out, has.copy())
        if cast_to is not None and s.dtype != cast_to:
            s = s.cast(cast_to)
        return _scatter_series(s, sorted_idx, n)

    if func == "count":
        out = frame_rows.astype(np.uint64) if we.params.get("mode", "valid") == "all" \
            else np.where(empty, 0, wcnt).astype(np.uint64)
        return Series.from_numpy(_scatter(out, sorted_idx, n), name, DataType.uint64())
    if func == "sum":
        return null_where_empty(wsum, we.to_field(batch.schema).dtype)
    if func == "mean":
        with np.errstate(invalid="ignore", divide="ignore"):
            out = wsum.astype(np.float64) / wcnt
        return null_where_empty(out)
    if func in ("stddev", "var"):
        # the reference's f64 prefix sums of x and x^2 (population moments;
        # a ddof is not applied over a window, as in the reference)
        f64 = np.where(valid, vals.astype(np.float64), 0.0)
        csq = np.concatenate([[0.0], np.cumsum(f64 * f64)])
        cs = np.concatenate([[0.0], np.cumsum(f64)])
        wsq = csq[hi_e + 1] - csq[lo_e]
        ws = cs[hi_e + 1] - cs[lo_e]
        with np.errstate(invalid="ignore", divide="ignore"):
            m = ws / wcnt
            var = np.maximum(wsq / wcnt - m * m, 0.0)
            out = np.sqrt(var) if func == "stddev" else var
        return null_where_empty(out)
    if func in ("min", "max"):
        out = _sliding_minmax(fvals, valid, lo_e, np.maximum(hi_e, lo_e), func == "min")
        return null_where_empty(out, we.child.to_field(batch.schema).dtype)
    # any_value, skew, bool_and, bool_or and count_distinct: the reference
    # refuses them over a window with this error
    raise ValueError(f"window aggregation {func!r} not supported")


def _range_bounds(spec, range_keys, row_start, seg_end, row_peer_first, row_peer_last):
    """RANGE BETWEEN: each row's frame is every row whose order key lies in
    [key + start, key + end] (descending keys were negated upstream). The
    valid keys are one contiguous run of each partition (nulls sort to one
    end); a row with a null key frames over its peers."""
    keys, valid, nulls_first = range_keys
    n = len(keys)
    lo = np.empty(n, dtype=np.int64)
    hi = np.empty(n, dtype=np.int64)
    start, end = spec.frame_start, spec.frame_end
    for s in np.unique(row_start):
        s = int(s)
        e = int(seg_end[s])
        sl = slice(s, e + 1)
        seg_keys = keys[sl]
        nv = int(valid[sl].sum())
        off = (e + 1 - s - nv) if nulls_first else 0  # where the valid keys begin
        vk = seg_keys[off:off + nv]
        if start is Window.unbounded_preceding:
            lo[sl] = s + off
        else:
            lo[sl] = s + off + np.searchsorted(vk, seg_keys + start, side="left")
        if end is Window.unbounded_following:
            hi[sl] = s + off + nv - 1
        else:
            hi[sl] = s + off + np.searchsorted(vk, seg_keys + end, side="right") - 1
    lo = np.where(valid, lo, row_peer_first)
    hi = np.where(valid, hi, row_peer_last)
    empty = lo > hi
    return np.clip(lo, row_start, seg_end), np.clip(hi, row_start, seg_end), empty


def _compute_range_keys(batch, spec, sorted_idx):
    """(the sorted order key as float64, ascending; its validity; whether
    nulls sort first), or None when the spec has not exactly one numeric
    order key."""
    if len(spec.order_by_exprs) != 1:
        return None
    s = _full(batch, spec.order_by_exprs[0]).take(sorted_idx)
    vals = s.to_numpy()
    if vals.dtype == object:
        return None
    keys = vals.astype(np.float64)
    desc = bool(spec.descending[0]) if spec.descending else False
    if desc:
        keys = -keys
    nulls_first = bool(spec.nulls_first[0]) if spec.nulls_first else desc
    return keys, s.validity_numpy(), nulls_first


def _frame_bounds(spec, n: int, r: _Rows, range_keys=None):
    """Each sorted row's inclusive frame [lo, hi] and whether it is empty."""
    seg_end = r.row_start + r.row_len - 1
    no_empty = np.zeros(n, dtype=bool)
    if spec.frame_type == "rows":
        lo = _row_bound(spec.frame_start, r.row_start, seg_end, r.pos_in_seg)
        hi = _row_bound(spec.frame_end, r.row_start, seg_end, r.pos_in_seg)
        # a frame outside the partition, or inverted, is empty
        empty = (lo > seg_end) | (hi < r.row_start) | (lo > hi)
        return np.clip(lo, r.row_start, seg_end), np.clip(hi, r.row_start, seg_end), empty
    if spec.frame_type == "range":
        if range_keys is None:
            raise ValueError("range_between requires exactly one numeric ORDER BY key")
        return _range_bounds(spec, range_keys, r.row_start, seg_end, r.peer_first,
                             r.peer_last)
    if spec.order_by_exprs:
        # the SQL default: RANGE UNBOUNDED PRECEDING .. CURRENT ROW, peers included
        return r.row_start, r.peer_last, no_empty
    return r.row_start, seg_end, no_empty


def _row_bound(bound, row_start, seg_end, pos_in_seg):
    if bound is Window.unbounded_preceding:
        return row_start.copy()
    if bound is Window.unbounded_following:
        return seg_end.copy()
    return row_start + pos_in_seg + int(bound)


def _sliding_minmax(fvals, valid, lo, hi, is_min: bool):
    """Each row's min or max over [lo, hi] by a sparse table (O(n log n) to
    build, O(1) a row); invalid values masked to the identity."""
    n = len(fvals)
    if np.issubdtype(fvals.dtype, np.integer):
        info = np.iinfo(fvals.dtype)
        ext = info.max if is_min else info.min
    else:
        ext = np.inf if is_min else -np.inf
    masked = np.where(valid, fvals, ext)
    if n == 0:
        return masked
    reduce = np.minimum if is_min else np.maximum
    levels = max(1, int(np.floor(np.log2(max(hi.max() - lo.min() + 1, 1)))) + 1)
    table = [masked]
    width = 1
    for _ in range(1, levels):
        prev = table[-1]
        m = len(prev) - width
        if m <= 0:
            break
        table.append(reduce(prev[:m], prev[width:width + m]))
        width *= 2
    length = hi - lo + 1
    k = np.where(length > 0, np.floor(np.log2(np.maximum(length, 1))).astype(np.int64), 0)
    k = np.minimum(k, len(table) - 1)
    out = np.empty(n, dtype=masked.dtype)
    for kk in np.unique(k):
        sel = k == kk
        w = 1 << int(kk)
        t = table[int(kk)]
        a = np.clip(lo[sel], 0, len(t) - 1)
        b = np.clip(hi[sel] - w + 1, 0, len(t) - 1)
        out[sel] = reduce(t[a], t[b])
    return out
