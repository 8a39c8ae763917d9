"""Logical rewrites (counterpart of daft_tpu/plan/optimizer.py, holding only
the rule the port needs: ``rule_detect_topn``, applied by plan/physical.py
``translate`` at each Limit).
"""

from __future__ import annotations

from typing import Optional

from . import logical as lp


def rule_detect_topn(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """Limit(Sort) -> TopN and Limit(Offset(Sort)) -> TopN; None for any
    other node."""
    if isinstance(node, lp.Limit) and isinstance(node.input, lp.Sort):
        s = node.input
        return lp.TopN(s.input, s.sort_by, s.descending, s.nulls_first, node.limit)
    if (isinstance(node, lp.Limit) and isinstance(node.input, lp.Offset)
            and isinstance(node.input.input, lp.Sort)):
        s = node.input.input
        return lp.TopN(s.input, s.sort_by, s.descending, s.nulls_first,
                       node.limit, node.input.offset)
    return None
