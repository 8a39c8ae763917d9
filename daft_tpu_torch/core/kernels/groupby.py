"""Group index construction and vectorized host aggregation (counterpart of
daft_tpu/core/kernels/groupby.py and the host grouped aggregation of
daft_tpu/core/relational.py).

``make_groups`` factorizes multi-column keys (nulls form their own group)
into group ids ordered by first occurrence, with numpy alone.
``grouped_reduce`` aggregates one column by group ids with ufunc.at
scatters: O(rows), no per-group Python loop, so it serves a 6M-row table
(``count_distinct`` counts the distinct (group, equality code) pairs).
``grouped_agg`` and ``ungrouped_agg`` aggregate a batch by key expressions,
or to one row.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ...datatype import DataType


def equality_codes(series) -> np.ndarray:
    """Dense int64 equality codes for one column; null -> -1. Floats group
    -0.0 with 0.0 and every NaN together (bit-canonicalized)."""
    n = len(series)
    valid = series.validity_numpy()
    codes = np.full(n, -1, dtype=np.int64)
    if series.dtype.is_null() or not valid.any():
        return codes
    vals = series.to_numpy()
    if vals.dtype.kind == "f":
        vals = np.where(np.isnan(vals), np.nan, vals + 0.0)
        vals = vals.view(np.int64 if vals.dtype.itemsize == 8 else np.int32)
    elif vals.dtype == bool:
        vals = vals.astype(np.int8)
    if valid.all():
        codes = np.unique(vals, return_inverse=True)[1].astype(np.int64).reshape(n)
    else:
        codes[valid] = np.unique(vals[valid], return_inverse=True)[1].reshape(-1)
    return codes


def make_groups(key_series: list) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Groups over multi-column keys (nulls form their own group).

    Returns (first_occurrence_indices, group_ids, group_counts):
      - first_occurrence_indices[g] = row of the first row of group g
      - group_ids[i] = group of row i (0..G-1, ordered by first occurrence)
      - group_counts[g] = rows in group g
    """
    n = len(key_series[0]) if key_series else 0
    if n == 0:
        return (np.empty(0, np.int64), np.empty(0, np.int64), np.empty(0, np.int64))
    combined = None
    for s in key_series:
        c = equality_codes(s) + 1  # null -> 0
        if combined is None:
            combined = c
        else:
            combined = combined * (int(c.max()) + 1) + c
            combined = np.unique(combined, return_inverse=True)[1].reshape(n)
    k = int(combined.max()) + 1
    first = np.full(k, n, dtype=np.int64)
    np.minimum.at(first, combined, np.arange(n, dtype=np.int64))
    present = np.flatnonzero(first < n)
    order = present[np.argsort(first[present], kind="stable")]
    rank = np.full(k, -1, dtype=np.int64)
    rank[order] = np.arange(len(order), dtype=np.int64)
    group_ids = rank[combined]
    counts = np.bincount(group_ids, minlength=len(order)).astype(np.int64)
    return first[order], group_ids, counts


def grouped_reduce(op: str, values: np.ndarray, valid: np.ndarray,
                   group_ids: np.ndarray, num_groups: int, mode: str = "valid",
                   params=None):
    """Aggregate one column by group: returns (values, valid) arrays of length
    ``num_groups``; a group with no valid value is null (count is never null).

    Integer sums/min/max run in int64 (sum wraps mod 2^64 like the reference's
    int64 kernels), unsigned in uint64, floats and means in float64. Sums add
    in row order. Float min/max take the reference's host terms
    (``_float_extreme``). any_value is the group's first row (its first
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
    if op in ("sum", "mean"):
        if vals.dtype.kind == "f" or op == "mean" and vals.dtype.kind not in "iub":
            acc = np.zeros(g, dtype=np.float64)
            np.add.at(acc, gids, vals.astype(np.float64))
        elif vals.dtype.kind == "u" or vals.dtype == bool:
            acc = np.zeros(g, dtype=np.uint64)
            np.add.at(acc, gids, vals.astype(np.uint64))
        else:
            acc = np.zeros(g, dtype=np.int64)
            np.add.at(acc, gids, vals.astype(np.int64))
        if op == "mean":
            with np.errstate(invalid="ignore", divide="ignore"):
                acc = acc.astype(np.float64) / cnt
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
    if op in ("stddev", "var", "skew"):
        return _moments(op, vals.astype(np.float64), gids, g, cnt, params.get("ddof", 0))
    if op in ("min", "max"):
        uf = np.minimum if op == "min" else np.maximum
        if vals.dtype.kind == "f":
            return _float_extreme(op, vals.astype(np.float64), gids, g), has
        if vals.dtype == bool:
            work = vals.astype(np.int8)
            acc = np.full(g, 1 if op == "min" else 0, dtype=np.int8)
        else:
            work = vals.astype(np.uint64 if vals.dtype.kind == "u" else np.int64)
            info = np.iinfo(work.dtype)
            acc = np.full(g, info.max if op == "min" else info.min, dtype=work.dtype)
        uf.at(acc, gids, work)
        return acc, has
    raise ValueError(f"no host grouped aggregation for {op!r}")


def _moments(op: str, z: np.ndarray, gids: np.ndarray, g: int, cnt: np.ndarray, ddof: int):
    """var / stddev / skew per group from f64 sums of powers (the
    reference's grouped kernel, relational.py:441-470)."""
    s1 = np.zeros(g)
    s2 = np.zeros(g)
    np.add.at(s1, gids, z)
    np.add.at(s2, gids, z * z)
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
            s3 = np.zeros(g)
            np.add.at(s3, gids, z * z * z)
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


def _float_extreme(op: str, vals: np.ndarray, gids: np.ndarray, g: int) -> np.ndarray:
    """Per-group f64 min/max as the reference's host kernel computes it, a
    strict compare per row in row order (native/src/kernels.cpp
    grouped_minmax_f64): NaN never wins, so a group of NaN alone keeps the
    identity (+inf for min, -inf for max), and of equal values (0.0 and
    -0.0) the group's first row stays."""
    ok = ~np.isnan(vals)
    acc = np.full(g, np.inf if op == "min" else -np.inf)
    (np.minimum if op == "min" else np.maximum).at(acc, gids[ok], vals[ok])
    # the value itself from the group's first row that equals it
    hit = np.flatnonzero(ok & (vals == acc[gids]))
    first = np.full(g, len(vals), dtype=np.int64)
    np.minimum.at(first, gids[hit], hit)
    found = first < len(vals)
    acc[found] = vals[first[found]]
    return acc


def extreme_replaces(op: str, new, cur):
    """Whether a later partial extreme ``new`` replaces ``cur`` when partials
    of one group merge in row order, on ``_float_extreme``'s terms: only if
    strictly smaller (min) or larger (max), so NaN never wins and of equal
    values (0.0 and -0.0) the earlier stays. Scalars or arrays (elementwise)."""
    return new < cur if op == "min" else new > cur


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
        values, validity = s.to_numpy(), s.validity_numpy()
        if inner.op == "count_distinct":
            values = equality_codes(s)
        vals, valid = grouped_reduce(inner.op, values, validity, group_ids, g,
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
    if op == "sum":
        if child.is_signed_integer():
            return DataType.int64()
        if child.is_unsigned_integer() or child.is_boolean():
            return DataType.uint64()
        if child.is_floating():
            return child if child.kind == "float32" else DataType.float64()
        if child.is_null():
            return DataType.null()
        raise ValueError(f"cannot sum dtype {child}")
    if op in ("mean", "stddev", "var", "skew"):
        return DataType.float64()
    if op in ("count", "count_distinct"):
        return DataType.uint64()
    if op in ("min", "max", "any_value"):
        return child
    if op in ("bool_and", "bool_or"):
        return DataType.bool()
    raise ValueError(f"unknown aggregation {op!r}")
