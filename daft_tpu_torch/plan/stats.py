"""Plan cardinality estimates (counterpart of daft_tpu/plan/stats.py, the
``estimate_rows`` subset the join capture needs to pick its fact).

Approximations only: correctness never depends on them. A Filter keeps a
fixed fraction of its input per predicate shape, an inner or left join is
as large as its larger side (the foreign-key assumption), a semi or anti
join as its left, a cross join as the product, and a Project keeps its
input's count; any other node is unknown.
"""

from __future__ import annotations

from typing import Optional

from ..expressions.expressions import Alias, BinaryOp, Expression, IsIn, UnaryOp
from . import logical as lp

# the reference's fixed selectivities
_SEL_EQ = 0.1
_SEL_RANGE = 0.3
_SEL_DEFAULT = 0.25


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
    if isinstance(pred, IsIn):
        return min(1.0, _SEL_EQ * max(len(pred.items), 1))
    if isinstance(pred, UnaryOp) and pred.op in ("is_null", "not_null"):
        return 0.5
    return _SEL_DEFAULT


def estimate_rows(plan: lp.LogicalPlan) -> Optional[float]:
    """Approximate output row count of a logical plan (None = unknown)."""
    if isinstance(plan, lp.InMemorySource):
        return float(sum(p.num_rows for p in plan.partitions))
    if isinstance(plan, lp.Filter):
        child = estimate_rows(plan.input)
        return None if child is None else child * selectivity(plan.predicate)
    if isinstance(plan, lp.Join):
        left, right = estimate_rows(plan.left), estimate_rows(plan.right)
        if left is None or right is None:
            return None
        if plan.how in ("semi", "anti"):
            return left
        return left * right if plan.how == "cross" else max(left, right)
    if isinstance(plan, lp.Project):
        return estimate_rows(plan.input)
    return None
