"""Group index construction and vectorized host aggregation (counterpart of
daft_tpu/core/kernels/groupby.py and the host grouped aggregation of
daft_tpu/core/relational.py).

``make_groups`` factorizes multi-column keys (nulls form their own group)
into group ids ordered by first occurrence, through the host kernel
library's hash factorize (native.py ``native_factorize``,
``native_combine_factorize``). ``grouped_reduce`` aggregates one column by
group ids in one pass: sums, means, min/max, var and stddev through the
library's grouped kernels where the reference's library takes them, the
rest with numpy scatters (``count_distinct`` counts the distinct (group,
equality code) pairs). ``nested_reduce`` takes the list aggregates
(``list``, ``set``, ``concat``) on the offsets and child columns, and
``product`` and ``string_agg``. ``grouped_agg`` and ``ungrouped_agg``
aggregate a batch by key expressions, or to one row.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np

from ... import native
from ...datatype import DataType


def equality_codes(series) -> np.ndarray:
    """Compact int64 equality codes for one column; null -> -1. Numeric,
    bool and date values take their first-occurrence codes from the
    library's factorize (the reference's pandas factorize), strings and
    binary their rank among the sorted distinct values, nested values
    (lists, structs, maps) the factorize of their row hashes, as the
    reference's. Floats group -0.0 with 0.0 and every NaN together
    (bit-canonicalized)."""
    n = len(series)
    valid = series.validity_numpy()
    codes = np.full(n, -1, dtype=np.int64)
    if series.dtype.is_null() or not valid.any():
        return codes
    if series.dtype.is_nested() or series.dtype.kind == "fixed_size_binary":
        vals = series.hash().to_numpy().view(np.int64)
        codes[valid] = native.native_factorize(vals[valid])[0]
        return codes
    if series.dtype.is_string() and series._raw_codes() is not None:
        # known dictionary codes (a Parquet read, a column built from codes,
        # and their takes): equal strings share a code, nothing to sort
        codes = series.dict_codes()[0].astype(np.int64)
        codes[~valid] = -1
        return codes
    vals = series.to_numpy()
    numeric = vals.dtype != object
    if vals.dtype.kind == "f":
        vals = np.where(np.isnan(vals), np.nan, vals + 0.0)
        vals = vals.view(np.int64 if vals.dtype.itemsize == 8 else np.int32)
    if numeric:
        vals = vals.astype(np.int64, copy=False)
    all_valid = valid.all()
    kept = vals if all_valid else vals[valid]
    if numeric:
        kept_codes = native.native_factorize(kept)[0]
    else:
        kept_codes = _object_ranks(kept)
    if all_valid:
        return kept_codes
    codes[valid] = kept_codes
    return codes


def _object_ranks(values: np.ndarray) -> np.ndarray:
    """Each str or bytes value's rank among the sorted distinct values (what
    ``np.unique(values, return_inverse=True)`` gives), from one dict pass
    in C (``map`` of ``dict.setdefault``: each value's first row) and a
    sort of the distinct values alone, not of every row."""
    first: dict = {}
    rows = np.fromiter(map(first.setdefault, values, itertools.count()), dtype=np.int64,
                       count=len(values))
    distinct = list(first)
    order = sorted(range(len(distinct)), key=distinct.__getitem__)
    rank = np.empty(len(distinct), dtype=np.int64)
    rank[order] = np.arange(len(distinct), dtype=np.int64)
    by_row = np.empty(len(values), dtype=np.int64)
    by_row[np.fromiter(first.values(), dtype=np.int64, count=len(distinct))] = rank
    return by_row[rows]


def make_groups(key_series: list) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Groups over multi-column keys (nulls form their own group).

    Returns (first_occurrence_indices, group_ids, group_counts):
      - first_occurrence_indices[g] = row of the first row of group g
      - group_ids[i] = group of row i (0..G-1, ordered by first occurrence)
      - group_counts[g] = rows in group g

    One numeric column's codes are already first-occurrence ordered: the
    null group takes its place among them. A string column's codes are
    factorized once more with the null code -1 as a value (as the
    reference factorizes every column's). Each further column pairs in
    through ``combine_factorize`` (b_domain its largest code + 1, so a pair
    stays below n^2), whose codes are first-occurrence ordered.
    """
    n = len(key_series[0]) if key_series else 0
    if n == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64))
    codes = equality_codes(key_series[0])
    if len(key_series) == 1 and key_series[0].to_numpy().dtype != object:
        group_ids, g = _null_group(codes)
    elif len(key_series) == 1:
        group_ids, g = native.native_factorize(codes)
    for s in key_series[1:]:
        c = equality_codes(s)
        group_ids, g = native.native_combine_factorize(codes, c, int(c.max()) + 1)
        codes = group_ids
    # ids are first-occurrence ordered: a group starts where the running
    # max of the ids grows
    new = np.empty(n, dtype=bool)
    new[0] = True
    new[1:] = group_ids[1:] > np.maximum.accumulate(group_ids)[:-1]
    first = np.flatnonzero(new).astype(np.int64)
    counts = np.bincount(group_ids, minlength=g).astype(np.int64)
    return first, group_ids, counts


def _null_group(codes: np.ndarray) -> Tuple[np.ndarray, int]:
    """(group ids, groups) of first-occurrence codes whose nulls (-1) form
    one more group: rows before the first null hold codes 0..k-1 alone, so
    the null group is k and every later code moves up one."""
    g = int(codes.max(initial=-1)) + 1
    nulls = np.flatnonzero(codes < 0)
    if not len(nulls):
        return codes, g
    k = int(codes[:nulls[0]].max(initial=-1)) + 1
    return np.where(codes < 0, k, codes + (codes >= k)), g + 1


def grouped_reduce(op: str, values: np.ndarray, valid: np.ndarray,
                   group_ids: np.ndarray, num_groups: int, mode: str = "valid",
                   params=None):
    """Aggregate one column by group: returns (values, valid) arrays of length
    ``num_groups``; a group with no valid value is null (count is never null).

    Integer and bool sums/min/max run in int64 (sum wraps mod 2^64 like the
    reference's int64 kernels), uint64 sums/min/max in uint64, float sums,
    min/max and every mean in float64. Sums add in row order. Float min/max
    take the reference's host terms (native.py ``native_grouped_minmax``:
    NaN never wins, of 0.0 and -0.0 the first stays). any_value is the group's first row (its first
    valid row with ``ignore_nulls``); bool_and / bool_or reduce the valid
    rows; var, stddev and skew are the reference's grouped kernel
    (relational.py:441-470): f64 sums of powers in row order, the variance
    clamped at 0, null where the count is at most ``ddof`` and, for skew,
    where the variance is 0."""
    g = num_groups
    params = params or {}
    if op == "any_value":
        n = len(group_ids)
        rows = np.arange(n, dtype=np.int64)
        first = np.full(g, n, dtype=np.int64)
        np.minimum.at(first, group_ids, rows)
        if params.get("ignore_nulls", False):
            first_valid = np.full(g, n, dtype=np.int64)
            np.minimum.at(first_valid, group_ids[valid], rows[valid])
            first = np.where(first_valid < n, first_valid, first)
        safe = np.minimum(first, max(n - 1, 0))
        if n == 0:
            return values[:0].copy(), np.zeros(g, dtype=bool)
        return values[safe], valid[safe] & (first < n)
    if op == "count":
        rows = group_ids if mode == "all" else group_ids[valid]
        cnt = np.bincount(rows, minlength=g)
        if mode == "null":
            cnt = np.bincount(group_ids, minlength=g) - cnt
        return cnt.astype(np.uint64), np.ones(g, dtype=bool)
    if values.dtype == object and not valid.any():
        values = np.zeros(len(values))  # a null column: no value is read
    if op in ("sum", "mean", "min", "max", "stddev", "var", "skew") \
            and _on_library(op, values):
        return _library_reduce(op, values, valid, group_ids, g, params.get("ddof", 0))
    gids = group_ids[valid]
    vals = values[valid]
    cnt = np.bincount(gids, minlength=g)
    has = cnt > 0
    if op == "count_distinct":
        # ``values`` are equality codes (>= 0 on valid rows): count the
        # distinct (group, code) pairs
        width = int(vals.max(initial=0)) + 1
        pairs = np.unique(gids.astype(np.int64) * width + vals)
        return (np.bincount(pairs // width, minlength=g).astype(np.uint64),
                np.ones(g, dtype=bool))
    if op == "sum":
        # uint64: exact in uint64 (the int64 kernel would wrap at 2^63)
        acc = np.zeros(g, dtype=np.uint64)
        np.add.at(acc, gids, vals.astype(np.uint64))
        return acc, has
    if op in ("bool_and", "bool_or"):
        b = vals.astype(bool)
        if op == "bool_and":
            acc = np.ones(g, dtype=bool)
            np.logical_and.at(acc, gids, b)
        else:
            acc = np.zeros(g, dtype=bool)
            np.logical_or.at(acc, gids, b)
        return acc, has
    if op in ("min", "max"):
        # uint64, as the sum
        info = np.iinfo(np.uint64)
        acc = np.full(g, info.max if op == "min" else info.min, dtype=np.uint64)
        (np.minimum if op == "min" else np.maximum).at(acc, gids, vals.astype(np.uint64))
        return acc, has
    raise ValueError(f"no host grouped aggregation for {op!r} over {values.dtype}")


def _on_library(op: str, values: np.ndarray) -> bool:
    """Whether the library's grouped kernels take ``op`` over ``values``
    (the reference's routing, relational.py:170-205): numbers and bools,
    but no uint64 sum, min or max (the int64 kernels would wrap at 2^63)."""
    if values.dtype.kind not in "iubf":
        return False
    return not (values.dtype == np.uint64 and op in ("sum", "min", "max"))


def _library_reduce(op: str, values: np.ndarray, valid: np.ndarray, group_ids: np.ndarray,
                    g: int, ddof: int):
    """One aggregation through the library, as the reference computes it
    with its library loaded: integer and bool sums and extremes in int64,
    everything else in f64; var, stddev and skew from f64 sums of powers."""
    whole = values.dtype.kind in "iub" and op in ("sum", "min", "max")
    work = values.astype(np.int64 if whole else np.float64, copy=False)
    if op in ("min", "max"):
        mn, mx = native.native_grouped_minmax(group_ids, work, valid, g)
        return (mn if op == "min" else mx), np.bincount(group_ids[valid], minlength=g) > 0
    s1, cnt = native.native_grouped_sum(group_ids, work, valid, g)
    if op == "sum":
        return s1, cnt > 0
    if op == "mean":
        with np.errstate(invalid="ignore", divide="ignore"):
            return s1 / cnt, cnt > 0
    with np.errstate(over="ignore", invalid="ignore"):
        sq = work * work
        s2 = native.native_grouped_sum(group_ids, sq, valid, g)[0]
        s3 = native.native_grouped_sum(group_ids, sq * work, valid, g)[0] \
            if op == "skew" else None
    return _moments(op, s1, s2, s3, cnt, ddof)


def _moments(op: str, s1: np.ndarray, s2: np.ndarray, s3, cnt: np.ndarray, ddof: int):
    """var / stddev / skew per group from f64 sums of powers (the
    reference's grouped kernel, relational.py:441-470)."""
    vc = cnt.astype(np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        m = s1 / vc
        var = np.maximum(s2 / vc - m * m, 0.0)
        if ddof:
            var = var * vc / np.where(vc > ddof, vc - ddof, 1)
            var = np.where(vc > ddof, var, np.nan)
        if op == "var":
            data = var
        elif op == "stddev":
            data = np.sqrt(var)
        else:
            m3 = s3 / vc - 3 * m * s2 / vc + 2 * m ** 3
            sd = np.sqrt(var)
            data = np.where(sd > 0, m3 / sd ** 3, np.nan)
    valid = cnt > 0
    if op == "skew" or ddof:
        valid = valid & ~np.isnan(data)
    return data, valid


def ungrouped_moment(op: str, x: np.ndarray, ddof: int):
    """var / stddev / skew of the valid values ``x`` as the reference's
    one-phase ungrouped kernels give them (pyarrow's variance, and
    ``Series.skew``: 0.0 at zero variance): (value, valid)."""
    n = len(x)
    if n == 0 or (op != "skew" and n <= ddof):
        return np.nan, False
    m = x.mean()
    d = x - m
    if op == "skew":
        s2 = (d * d).mean()
        if s2 == 0:
            return 0.0, True
        return float((d ** 3).mean() / s2 ** 1.5), True
    var = float((d * d).sum() / (n - ddof))
    return (np.sqrt(var) if op == "stddev" else var), True


def extreme_replaces(op: str, new, cur):
    """Whether a later partial extreme ``new`` replaces ``cur`` when partials
    of one group merge in row order, on ``native_grouped_minmax``'s terms: only if
    strictly smaller (min) or larger (max), so NaN never wins and of equal
    values (0.0 and -0.0) the earlier stays. Scalars or arrays (elementwise)."""
    return new < cur if op == "min" else new > cur


NESTED_AGG_OPS = ("list", "set", "concat", "product", "string_agg")


def _group_order(group_ids: np.ndarray, g: int):
    """(rows in group order, each group's row count): rows of group 0 in
    row order, then group 1's, ..."""
    counts = np.bincount(group_ids, minlength=g).astype(np.int64)
    return np.argsort(group_ids, kind="stable").astype(np.int64), counts


def nested_reduce(op: str, s, group_ids: np.ndarray, g: int, params, ungrouped: bool,
                  out_dt: DataType):
    """One of ``NESTED_AGG_OPS`` over the Series ``s`` by group (the
    reference's relational.py:350-398 grouped and series.py:764-890
    ungrouped kernels), as a Series of ``g`` rows:

    - ``list``: each group's values, nulls kept, in row order;
    - ``set``: each group's distinct valid values in order of first
      occurrence (a NaN is distinct from every value, as in a Python set;
      lists and structs compare by value);
    - ``concat``: each group's lists' elements in row order; a group of
      null lists is null grouped and [] ungrouped;
    - ``product``: in int64 (wrapping) or f64, rounded to the output type;
      null where a group has no valid value;
    - ``string_agg``: the valid strings joined by ``delimiter``; null
      where there are none."""
    from ..series import Series, _lengths_to_offsets, _ranges

    name = s.name
    valid = s.validity_numpy()
    if op == "list":
        order, counts = _group_order(group_ids, g)
        return Series.nested(name, out_dt, _lengths_to_offsets(counts), [s.take(order)],
                             np.ones(g, dtype=bool))
    if op == "set":
        codes = equality_codes(s)
        if s.dtype.is_floating():
            nan = valid & np.isnan(s.to_numpy())
            codes = np.where(nan, int(codes.max(initial=-1)) + 1 + np.cumsum(nan), codes)
        rows = np.flatnonzero(valid)
        width = int(codes.max(initial=0)) + 1
        _u, first = np.unique(group_ids[rows].astype(np.int64) * width + codes[rows],
                              return_index=True)
        keep = rows[first]
        keep = keep[np.lexsort((keep, group_ids[keep]))]
        counts = np.bincount(group_ids[keep], minlength=g).astype(np.int64)
        return Series.nested(name, out_dt, _lengths_to_offsets(counts), [s.take(keep)],
                             np.ones(g, dtype=bool))
    if op == "concat":
        if not s.dtype.is_list():
            raise ValueError(f"agg_concat requires a list dtype, got {s.dtype}")
        order, _counts = _group_order(group_ids, g)
        lens = s.list_lengths()[order]
        child = s.list_child()
        if s.dtype.kind == "fixed_size_list":
            starts = order * s.dtype.size
        else:
            starts = s.list_offsets()[:-1][order]
        per_group = np.bincount(group_ids[order], weights=lens, minlength=g).astype(np.int64) \
            if len(order) else np.zeros(g, dtype=np.int64)
        has = np.bincount(group_ids[valid], minlength=g) > 0
        out_valid = np.ones(g, dtype=bool) if ungrouped else has
        return Series.nested(name, out_dt, _lengths_to_offsets(per_group),
                             [child.take(_ranges(starts, lens))], out_valid)
    if op == "product":
        if s.dtype.is_null():
            return Series.full_null(name, out_dt, g)
        vals = s.to_numpy()
        work = np.float64 if out_dt.is_floating() else np.int64
        acc = np.ones(g, dtype=work)
        with np.errstate(over="ignore", invalid="ignore"):
            np.multiply.at(acc, group_ids[valid], vals[valid].astype(work))
        has = np.bincount(group_ids[valid], minlength=g) > 0
        if out_dt.kind == "uint64":
            acc = acc.view(np.uint64)
        acc = np.where(has, acc, acc.dtype.type(0)).astype(out_dt.to_numpy())
        return Series.from_numpy(acc, name, dtype=out_dt, validity=has)
    if op == "string_agg":
        delim = params.get("delimiter", "")
        order, counts = _group_order(group_ids[valid], g)
        items = s.to_numpy()[np.flatnonzero(valid)][order].tolist()
        bounds = _lengths_to_offsets(counts).tolist()
        rows = [delim.join(items[bounds[k]:bounds[k + 1]]) if counts[k] else None
                for k in range(g)]
        return Series.from_pylist(rows, name, DataType.string())
    raise ValueError(f"unknown nested aggregation {op!r}")


def _agg_columns(batch, aggs, group_ids: np.ndarray, g: int, ungrouped: bool = False):
    """One output Series per aggregation over ``g`` groups. Ungrouped, a
    float min/max over valid values that are all NaN is NaN (the
    reference's pyarrow min/max), where a group keeps the identity."""
    from ...expressions.eval import eval_expression
    from ...expressions.expressions import AggExpr, Alias
    from ..series import Series

    n = batch.num_rows
    out = []
    for e in aggs:
        inner = e
        while isinstance(inner, Alias):
            inner = inner.child
        if not isinstance(inner, AggExpr):
            raise ValueError(f"expected an aggregation, got {e!r}")
        s = eval_expression(batch, inner.child)
        s = s.broadcast(n) if len(s) == 1 and n != 1 else s
        out_dt = e.to_field(batch.schema).dtype
        if inner.op in NESTED_AGG_OPS:
            out.append(nested_reduce(inner.op, s, group_ids, g, inner.params, ungrouped,
                                     out_dt).rename(e.name()))
            continue
        if inner.op == "approx_percentile":
            out.append(_approx_percentile(s, group_ids, g, inner.params, out_dt)
                       .rename(e.name()))
            continue
        if inner.op == "approx_count_distinct" and ungrouped:
            # HyperLogLog over the whole column (series.py:893-896); grouped,
            # the reference counts each group's distinct values exactly
            from .sketches import hll_count_distinct

            out.append(Series.from_pylist([hll_count_distinct(s)], e.name(), out_dt))
            continue
        if s.dtype.is_decimal() and inner.op in ("sum", "min", "max"):
            from ..decimal import reduce as decimal_reduce

            vals, valid = decimal_reduce(inner.op, s, group_ids, g)
            out.append(Series(e.name(), out_dt, vals, valid))
            continue
        values, validity = s.to_numpy(), s.validity_numpy()
        op = "count_distinct" if inner.op == "approx_count_distinct" else inner.op
        if op == "count_distinct":
            values = equality_codes(s)
        vals, valid = grouped_reduce(op, values, validity, group_ids, g,
                                     inner.params.get("mode", "valid"), inner.params)
        if ungrouped and inner.op in ("stddev", "var", "skew"):
            v, ok = ungrouped_moment(inner.op, values[validity].astype(np.float64),
                                     inner.params.get("ddof", 0))
            vals, valid = np.array([v], dtype=np.float64), np.array([ok])
        if ungrouped and inner.op in ("min", "max") and values.dtype.kind == "f":
            kept = values[validity]
            if len(kept) and np.isnan(kept).all():
                vals = np.full(1, np.nan)
        vals = np.where(valid, vals, vals.dtype.type(0))
        out.append(Series.from_numpy(vals.astype(out_dt.to_numpy()), e.name(),
                                     dtype=out_dt, validity=valid))
    return out


def _approx_percentile(s, group_ids: np.ndarray, g: int, params, out_dt: DataType):
    """Each group's DDSketch percentile(s) of its valid values
    (relational.py:332-348, series.py:898-907): a float64 (null for no
    values), or for several percentiles a list of them (each None for no
    values)."""
    from ..series import Series
    from .sketches import ddsketch_percentiles

    ps = params["percentiles"]
    alpha = params.get("alpha", 0.01)
    single = not isinstance(ps, list)
    plist = [ps] if single else list(ps)
    valid = s.validity_numpy()
    vals = s.to_numpy()[valid].astype(np.float64)
    order, counts = _group_order(group_ids[valid], g)
    vals = vals[order]
    bounds = np.concatenate([[0], np.cumsum(counts)]).tolist()
    rows = []
    for k in range(g):
        qs = ddsketch_percentiles(vals[bounds[k]:bounds[k + 1]], plist, alpha)
        rows.append(qs[0] if single else qs)
    return Series.from_pylist(rows, s.name, out_dt)


def ungrouped_agg(batch, aggs):
    """Aggregate the whole batch to one row: every row in one group
    (counterpart of daft_tpu/core/relational.py ungrouped_agg). With no
    rows, count is 0 and every other aggregation null."""
    from ...schema import Schema
    from ..recordbatch import RecordBatch

    out = _agg_columns(batch, aggs, np.zeros(batch.num_rows, dtype=np.int64), 1,
                       ungrouped=True)
    return RecordBatch(Schema([s.field() for s in out]), out, 1)


def grouped_agg(batch, groupby, aggs):
    """Group ``batch`` by the ``groupby`` expressions and aggregate: output
    columns are the keys then the aggregations, groups in first-occurrence
    order (counterpart of daft_tpu/core/relational.py grouped_agg)."""
    from ...expressions.eval import eval_expression
    from ...schema import Schema
    from ..recordbatch import RecordBatch

    n = batch.num_rows

    def full(s):
        return s.broadcast(n) if len(s) == 1 and n != 1 else s

    key_series = [full(eval_expression(batch, e)).rename(e.name()) for e in groupby]
    first_idx, group_ids, _ = make_groups(key_series)
    g = len(first_idx)
    out = [s.take(first_idx) for s in key_series] + _agg_columns(batch, aggs, group_ids, g)
    return RecordBatch(Schema([s.field() for s in out]), out, g)


def agg_output_dtype(op: str, child: DataType) -> DataType:
    """Output type of an aggregation (counterpart of AggExpr.to_field)."""
    if op in ("sum", "product"):
        if child.is_signed_integer():
            return DataType.int64()
        if child.is_unsigned_integer() or child.is_boolean():
            return DataType.uint64()
        if child.is_floating():
            return child if child.kind == "float32" else DataType.float64()
        if child.is_null():
            return DataType.null()
        if child.is_decimal() and op == "sum":
            return child
        raise ValueError(f"cannot sum dtype {child}")
    if op in ("mean", "stddev", "var", "skew"):
        return DataType.float64()
    if op in ("count", "count_distinct", "approx_count_distinct"):
        return DataType.uint64()
    if op in ("min", "max", "any_value"):
        return child
    if op in ("bool_and", "bool_or"):
        return DataType.bool()
    if op in ("list", "set"):
        return DataType.list(child)
    if op == "concat":
        if not child.is_list():
            raise ValueError(f"agg_concat requires list dtype, got {child}")
        return child
    if op == "string_agg":
        return DataType.string()
    raise ValueError(f"unknown aggregation {op!r}")
