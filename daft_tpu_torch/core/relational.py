"""Host relational kernels of the plan surface (counterpart of
daft_tpu/core/relational.py ``sample_at``, ``sample``, ``explode``,
``unpivot`` and ``pivot``), in numpy.

``sample_at`` keeps the row at global position p iff a splitmix64 hash of
(p, seed) falls below the fraction, so a seeded sample keeps the same rows
however the stream is batched, and the same rows as the reference's.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..datatype import DataType
from ..schema import Schema
from .recordbatch import RecordBatch
from .series import Series, _ranges

_MASK64 = 0xFFFFFFFFFFFFFFFF


def sample_at(batch: RecordBatch, fraction: float, seed: int, offset: int) -> RecordBatch:
    """The rows of ``batch`` (global positions ``offset``...) that a seeded
    Bernoulli sample of ``fraction`` keeps."""
    n = batch.num_rows
    if n == 0:
        return batch
    x = np.arange(offset, offset + n, dtype=np.uint64)
    salt = (0x9E3779B97F4A7C15 * ((seed & 0x7FFFFFFFFFFFFFFF) + 1)) & _MASK64
    with np.errstate(over="ignore"):
        x = x + np.uint64(salt)
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    keep = (x >> np.uint64(11)).astype(np.float64) * (2.0 ** -53) < fraction
    return batch.take(np.flatnonzero(keep).astype(np.int64))


def sample(batch: RecordBatch, fraction: float, with_replacement: bool,
           seed: Optional[int]) -> RecordBatch:
    """round(n x fraction) rows drawn by numpy's ``default_rng(seed)``, in
    row order."""
    n = batch.num_rows
    k = int(round(n * fraction))
    rng = np.random.default_rng(seed)
    if with_replacement:
        idx = rng.integers(0, n, size=k) if n else np.empty(0, np.int64)
    else:
        k = min(k, n)
        idx = rng.choice(n, size=k, replace=False) if n else np.empty(0, np.int64)
    return batch.take(np.sort(idx))


def explode(batch: RecordBatch, to_explode, output_schema) -> RecordBatch:
    """One row per element of the exploded list columns (the reference's
    relational.py:703-740): a null or empty list gives one null row, the
    other columns repeat, and every exploded column must have the same
    length in each row (a null or empty list counting as one). Works on the
    offsets and the child columns alone."""
    from ..expressions.eval import eval_expression

    exploded = {}
    for e in to_explode:
        s = eval_expression(batch, e)
        if len(s) == 1 and batch.num_rows != 1:
            s = s.broadcast(batch.num_rows)
        if not s.dtype.is_list():
            raise ValueError(f"cannot explode non-list column {s.name} ({s.dtype})")
        exploded[e.name()] = s
    out_counts = None
    for s in exploded.values():
        counts = np.maximum(s.list_lengths(), 1)
        if out_counts is None:
            out_counts = counts
        elif not np.array_equal(counts, out_counts):
            raise ValueError("exploded columns must have matching list lengths per row")
    parent = np.repeat(np.arange(batch.num_rows, dtype=np.int64), out_counts)
    cols = []
    for f in output_schema:
        s = exploded.get(f.name)
        if s is None:
            cols.append(batch.get_column(f.name).take(parent))
            continue
        lens = s.list_lengths()
        child = s.list_child()
        if len(child) == len(parent) and s.dtype.kind == "list" and (lens > 0).all():
            # every row a non-empty list: the output column is the child as
            # it is (its device planes and fingerprint carry over)
            cols.append(child.rename(f.name))
            continue
        # each output row's element, -1 where its row's list is null or empty
        idx = np.full(len(parent), -1, dtype=np.int64)
        starts = np.cumsum(out_counts) - out_counts
        has = lens > 0
        idx[_ranges(starts[has], lens[has])] = _ranges(s.list_offsets()[:-1][has], lens[has])
        out = child.take_or_null(idx) if len(child) else \
            Series.full_null(f.name, child.dtype, len(idx))
        cols.append(out.rename(f.name))
    return RecordBatch(output_schema, [c.cast(f.dtype) if c.dtype != f.dtype else c
                                       for c, f in zip(cols, output_schema)],
                       len(parent))


def unpivot(batch: RecordBatch, id_series: List[Series], val_series: List[Series],
            variable_name: str, value_name: str, output_schema: Schema) -> RecordBatch:
    """Each row as one row per value column: the ids, the value column's
    name, its value (in the output's value type); rows in input order, the
    value columns in their order within a row."""
    n = batch.num_rows
    k = len(val_series)
    vt = output_schema[value_name].dtype
    idx = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = [s.take(idx) for s in id_series]
    names = np.empty(n * k, dtype=object)
    names[:] = [v.name for v in val_series] * n
    cols.append(Series(variable_name, DataType.string(), names, np.ones(n * k, dtype=bool)))
    casted = [v.cast(vt) if v.dtype != vt else v for v in val_series]
    if n:
        cat = Series.concat([c.rename(value_name) for c in casted])  # column-major
        order = (np.tile(np.arange(k, dtype=np.int64) * n, n)
                 + np.repeat(np.arange(n, dtype=np.int64), k))
        cols.append(cat.take(order))
    else:
        cols.append(Series.empty(value_name, vt))
    return RecordBatch(output_schema, [c.cast(f.dtype) if c.dtype != f.dtype else c
                                       for c, f in zip(cols, output_schema)], n * k)


def pivot(sub: RecordBatch, n_keys: int, names: List[str],
          output_schema: Schema) -> RecordBatch:
    """Long to wide from ``sub``, the aggregate grouped by (keys, pivot):
    its key columns, then the pivot column, then the aggregated value. One
    row per distinct key tuple (first occurrence order), one column per
    name holding the value of the row whose pivot value reads as it (null
    where none does)."""
    from .kernels.groupby import make_groups

    gcols = sub.columns()[:n_keys]
    pivot_col = sub.columns()[n_keys]
    value_col = sub.columns()[n_keys + 1]
    if sub.num_rows:
        first_idx, group_ids, _ = make_groups(gcols)
    else:
        first_idx = group_ids = np.empty(0, np.int64)
    num_out = len(first_idx)
    out_cols: List[Series] = [c.take(first_idx) for c in gcols]
    pv = [str(x) if x is not None else None for x in pivot_col.to_pylist()]
    for nm in names:
        take_idx = np.full(num_out, -1, np.int64)
        for row, p in enumerate(pv):
            if p == nm:
                take_idx[group_ids[row]] = row
        out_cols.append(value_col.take_or_null(take_idx).rename(nm))
    return RecordBatch(output_schema, [c.cast(f.dtype) if c.dtype != f.dtype else c
                                       for c, f in zip(out_cols, output_schema)], num_out)
