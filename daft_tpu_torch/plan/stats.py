"""Plan cardinality and size estimates (counterpart of
daft_tpu/plan/stats.py): the optimizer's join reorder, the physical
build-side swap and the join capture's fact pick read them.

Approximations only: correctness never depends on them. A Filter keeps a
fixed fraction of its input per predicate shape, an inner join is as large
as its larger side (the foreign-key assumption), a semi or anti join half
its left, a left join its left, a cross join the product; an Aggregate
keeps n^0.7 groups, a Distinct 30 % of its rows. ``estimate_distinct``
samples a strided slice of an in-memory column (Chao1) once per Series.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional

import numpy as np

from ..expressions.expressions import Alias, Between, BinaryOp, Expression, IsIn, UnaryOp
from . import logical as lp

# the reference's fixed selectivities
_SEL_EQ = 0.1
_SEL_RANGE = 0.3
_SEL_DEFAULT = 0.25


def _dtype_width(dt) -> int:
    if dt.is_boolean():
        return 1
    if dt.is_string():
        return 24
    if dt.is_list():
        return 64
    return 8


def row_width(schema) -> int:
    """Estimated bytes of one row."""
    return max(sum(_dtype_width(f.dtype) for f in schema), 1)


def selectivity(pred: Expression) -> float:
    """Estimated fraction of rows a predicate keeps."""
    if isinstance(pred, Alias):
        return selectivity(pred.child)
    if isinstance(pred, BinaryOp):
        if pred.op == "and":
            return selectivity(pred.left) * selectivity(pred.right)
        if pred.op == "or":
            return min(1.0, selectivity(pred.left) + selectivity(pred.right))
        if pred.op == "eq":
            return _SEL_EQ
        if pred.op in ("lt", "le", "gt", "ge"):
            return _SEL_RANGE
        if pred.op == "neq":
            return 1.0 - _SEL_EQ
    if isinstance(pred, Between):
        return _SEL_RANGE
    if isinstance(pred, IsIn):
        return min(1.0, _SEL_EQ * max(len(pred.items), 1))
    if isinstance(pred, UnaryOp) and pred.op in ("is_null", "not_null"):
        return 0.5
    return _SEL_DEFAULT


def estimate_rows(plan: lp.LogicalPlan) -> Optional[float]:
    """Approximate output row count of a logical plan (None = unknown)."""
    if isinstance(plan, lp.InMemorySource):
        return float(sum(p.num_rows for p in plan.partitions))
    if isinstance(plan, lp.ScanSource):
        # the files' footers (the estimate is advisory: None when unknown)
        return plan.scan_op.approx_num_rows(plan.pushdowns)
    if isinstance(plan, lp.Filter):
        child = estimate_rows(plan.input)
        return None if child is None else child * selectivity(plan.predicate)
    if isinstance(plan, lp.Join):
        left, right = estimate_rows(plan.left), estimate_rows(plan.right)
        if left is None or right is None:
            return None
        if plan.how == "cross":
            return left * right
        if plan.how in ("semi", "anti"):
            return left * 0.5
        if plan.how == "inner":
            return max(left, right)
        return left  # left join: a lower bound (duplicate right keys fan out)
    if isinstance(plan, lp.Aggregate):
        child = estimate_rows(plan.input)
        if child is None:
            return None
        if not plan.groupby:
            return 1.0
        return max(child ** 0.7, 1.0)
    if isinstance(plan, lp.Distinct):
        child = estimate_rows(plan.input)
        return None if child is None else max(child * 0.3, 1.0)
    if isinstance(plan, lp.Limit):
        child = estimate_rows(plan.input)
        lim = float(plan.limit)
        return lim if child is None else min(child, lim)
    if isinstance(plan, lp.Sample):
        child = estimate_rows(plan.input)
        return None if child is None else child * plan.fraction
    if isinstance(plan, lp.Explode):
        # the reference's guess (stats.py:115): four elements a list
        child = estimate_rows(plan.input)
        return None if child is None else child * 4.0
    children = plan.children()
    if len(children) == 1:
        return estimate_rows(children[0])
    return None


def estimate_bytes(plan: lp.LogicalPlan) -> Optional[float]:
    rows = estimate_rows(plan)
    return None if rows is None else rows * row_width(plan.schema)


_DISTINCT_SAMPLE = 8192


def estimate_distinct(plan: lp.LogicalPlan, column: str) -> Optional[float]:
    """Approximate distinct-value count of one column (Selinger V(R, a)).

    An in-memory source samples the column of its first non-empty batch
    holding it, once per Series (the estimate is cached on the Series, so
    repeated optimizes over a resident table sample once); the estimate is
    capped at the plan's estimated rows. None for a column whose source is
    not reached through single-input nodes that keep it."""
    rows = estimate_rows(plan)
    src = plan
    while True:
        if isinstance(src, lp.InMemorySource):
            for p in src.partitions:
                for b in p.batches:
                    if column in b.column_names() and b.num_rows > 0:
                        series = b.get_column(column)
                        k = series._distinct_est
                        if k is None:
                            k = series._distinct_est = _chao1_distinct(series, b.num_rows)
                        return min(k, rows) if rows is not None else k
            return None
        children = src.children()
        if len(children) == 1 and column in children[0].schema.column_names():
            src = children[0]
            continue
        return None


def _chao1_distinct(series, n_rows: int) -> float:
    """Chao1 richness estimate from a strided sample: D ~ k + f1^2 / (2 f2);
    a sample of (nearly) all singletons reads as a key column (D ~ n_rows)."""
    if n_rows <= _DISTINCT_SAMPLE:
        sample = series
    else:
        step = n_rows // _DISTINCT_SAMPLE
        sample = series.take(np.arange(0, n_rows, step, dtype=np.int64)[:_DISTINCT_SAMPLE])
    if sample.validity_numpy().all() and not sample.dtype.is_null():
        _, counts = np.unique(sample.to_numpy(), return_counts=True)
    else:
        counts = np.array(list(Counter(sample.to_pylist()).values()))
    k = float(len(counts))
    if n_rows <= _DISTINCT_SAMPLE:
        return k
    f1 = float((counts == 1).sum())
    f2 = float((counts == 2).sum())
    if f2 > 0:
        est = k + f1 * f1 / (2.0 * f2)
    elif f1 >= k * 0.95:
        est = float(n_rows)
    else:
        est = k
    return min(est, float(n_rows))


def estimate_join_result(left_rows: float, right_rows: float,
                         v_left: Optional[float], v_right: Optional[float]) -> float:
    """Selinger equi-join estimate: |L||R| / max(V(L,a), V(R,b)); an unknown
    V falls back to the unique-key assumption on that side."""
    vl = v_left if v_left is not None else left_rows
    vr = v_right if v_right is not None else right_rows
    return max(left_rows * right_rows / max(vl, vr, 1.0), 1.0)
