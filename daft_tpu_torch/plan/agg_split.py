"""Aggregation splitting: partial (per morsel, per partition) and final
(combine) phases (counterpart of daft_tpu/plan/agg_split.py).

The host executor's two-phase aggregation (execution/executor.py) and the
distributed planner's partial -> shuffle -> final aggregation
(distributed/planner.py) share this one decomposition.
"""

from __future__ import annotations

from typing import List, Optional

from ..expressions.expressions import AggExpr, Alias, Expression, col, lit

# aggregations that need each group's whole value set: one phase (the
# reference's split_aggs returns None for them)
UNSPLIT_AGGS = ("count_distinct", "set", "string_agg", "approx_count_distinct",
                "approx_percentile")


def agg_op(e: Expression) -> str:
    while isinstance(e, Alias):
        e = e.child
    return e.op if isinstance(e, AggExpr) else ""


class AggSplit:
    """partial: aggregations over each input chunk; final: aggregations over
    the concatenated partials; projection: one output expression per input
    aggregation, named as it was."""

    def __init__(self, partial: List[Expression], final: List[Expression],
                 projection: List[Expression]):
        self.partial = partial
        self.final = final
        self.projection = projection


def split_aggs(aggs: List[Expression]) -> Optional[AggSplit]:
    """The two phases of ``aggs``, or None when one of them needs each
    group's whole value set (``UNSPLIT_AGGS``) or is not an aggregation."""
    for e in aggs:
        op = agg_op(e)
        if not op or op in UNSPLIT_AGGS:
            return None
    return AggSplit(*split_aggs_exprs(aggs))


def split_aggs_exprs(aggs: List[Expression]):
    """(partial, final, projection) expressions of a two-phase aggregation:
    partials per morsel, finals over the concatenated partials, and the
    projection that names the outputs. mean = sum / count; var, stddev and
    skew combine sums of powers and counts, any_value, bool_and, bool_or,
    product and concat merge with themselves, and a list's partial lists
    concatenate, as the reference's agg_split.py:74-121 splits them."""
    from ..datatype import DataType

    partial, final, projection = [], [], []
    for i, e in enumerate(aggs):
        name = e.name()
        inner = e
        while isinstance(inner, Alias):
            inner = inner.child
        if not isinstance(inner, AggExpr):
            raise ValueError(f"expected an aggregation, got {e!r}")
        p = f"__p{i}"
        child = inner.child
        if inner.op == "mean":
            partial += [AggExpr("sum", child).alias(p + "s"),
                        AggExpr("count", child).alias(p + "c")]
            final += [col(p + "s").sum().alias(p + "s"),
                      col(p + "c").sum().alias(p + "c")]
            projection.append((col(p + "s") / col(p + "c")).alias(name))
            continue
        if inner.op in ("stddev", "var", "skew"):
            powers = [("s", child), ("q", child * child)]
            if inner.op == "skew":
                powers.append(("u", child * child * child))
            partial += [AggExpr("sum", x).alias(p + k) for k, x in powers]
            partial.append(AggExpr("count", child).alias(p + "c"))
            final += [col(p + k).sum().alias(p + k) for k, _x in powers]
            final.append(col(p + "c").sum().alias(p + "c"))
            s, q, c = col(p + "s"), col(p + "q"), col(p + "c")
            m = s / c
            var = ((q / c) - m * m).clip(min=0.0)
            if inner.op == "skew":
                sd = var.sqrt()
                m3 = (col(p + "u") / c) - 3 * m * (q / c) + 2 * m * m * m
                out = (sd > 0).if_else(m3 / (sd ** 3), lit(None))
            else:
                ddof = inner.params.get("ddof", 0)
                if ddof:
                    var = (c > ddof).if_else(var * c / (c - ddof), lit(None))
                out = var.sqrt() if inner.op == "stddev" else var
            projection.append(out.cast(DataType.float64()).alias(name))
            continue
        partial.append(AggExpr(inner.op, child, dict(inner.params)).alias(p))
        merge = "sum" if inner.op in ("sum", "count") else \
            "concat" if inner.op == "list" else inner.op
        final.append(AggExpr(merge, col(p), dict(inner.params) if merge == inner.op
                             and merge != "count" else {}).alias(name))
        projection.append(col(name))
    return partial, final, projection
