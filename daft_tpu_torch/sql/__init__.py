"""The SQL entry point (counterpart of daft_tpu/sql/): ``sql(query,
**bindings)`` plans a SELECT over DataFrames bound by name (and its CTEs)
into a DataFrame, which ``collect`` optimizes and runs like any other;
``sql_expr(text)`` parses one expression.

The package module is itself callable, so ``daft_tpu_torch.sql("SELECT
...", t=df)`` works although ``daft_tpu_torch.sql`` is the subpackage.
``EXPLAIN PLACEMENT`` raises ``NotImplementedError``: its report is the cost
model's placement ledger (ROADMAP Queue 1 item 1).
"""

from __future__ import annotations

import sys
import types


def sql(query: str, **bindings):
    from .planner import plan_sql

    if query.lstrip()[:30].upper().split()[:2] == ["EXPLAIN", "PLACEMENT"]:
        raise NotImplementedError("EXPLAIN PLACEMENT is not ported yet: it reports the cost "
                                  "model's placement decisions (ROADMAP Queue 1 item 1)")
    return plan_sql(query, bindings)


def sql_expr(text: str):
    from .parser import parse_expression

    return parse_expression(text)


class _CallableModule(types.ModuleType):
    def __call__(self, query: str, **bindings):
        return sql(query, **bindings)


sys.modules[__name__].__class__ = _CallableModule
