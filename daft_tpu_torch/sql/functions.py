"""SQL function names to Expressions (counterpart of
daft_tpu/sql/functions.py).

Every SQL name whose engine function the port has is mapped as the
reference maps it: COALESCE, NULLIF, IFNULL/NVL (as COALESCE of two), IF
and IIF, GREATEST and LEAST (folds of ``if_else``), SUBSTR / SUBSTRING
(1-based, with literal bounds), LEFT, CONTAINS, STARTS_WITH, ENDS_WITH,
YEAR and DATE (a cast). Any other name raises ``NotImplementedError``
naming the function and the ROADMAP item that brings it: the port has no
scalar function registry to fall through to.
"""

from __future__ import annotations

from typing import List

from ..datatype import DataType
from ..expressions.expressions import Cast, Expression, Function, IfElse, Literal, lit
from .parser import EXPRESSIONS


def _lit_val(e: Expression, what: str):
    if isinstance(e, Literal):
        return e.value
    raise NotImplementedError(f"{what} takes a literal here: a column argument comes with "
                              f"{EXPRESSIONS}")


def build_sql_function(fname: str, args: List[Expression]) -> Expression:
    f = _SQL_FUNCS.get(fname)
    if f is not None:
        return f(args)
    raise NotImplementedError(f"SQL function {fname!r} is not ported yet: the scalar "
                              f"function registry comes with {EXPRESSIONS}")


def _coalesce(args):
    out = args[-1]
    for a in reversed(args[:-1]):
        out = IfElse(a.not_null(), a, out)
    return out.alias(args[0].name())


def _substr(args):
    # SQL SUBSTR is 1-based; the engine's utf8_substr is 0-based (the
    # reference folds its start - 1 in the optimizer; the port folds it here,
    # where its Function takes literal bounds)
    start = _lit_val(args[1], "SUBSTR's start")
    out = [args[0], lit(start - 1)]
    if len(args) > 2:
        out.append(lit(_lit_val(args[2], "SUBSTR's length")))
    return Function("utf8_substr", out)


def _fold(args, f):
    out = args[0]
    for a in args[1:]:
        out = f(out, a)
    return out


def _string_test(fname: str, what: str):
    return lambda a: Function(fname, [a[0], lit(_lit_val(a[1], what))])


_SQL_FUNCS = {
    "GREATEST": lambda a: _fold(a, lambda x, y: IfElse(x >= y, x, y)),
    "LEAST": lambda a: _fold(a, lambda x, y: IfElse(x <= y, x, y)),
    "SUBSTR": _substr,
    "SUBSTRING": _substr,
    "LEFT": lambda a: Function("utf8_left", [a[0], lit(_lit_val(a[1], "LEFT's length"))]),
    "CONTAINS": _string_test("utf8_contains", "CONTAINS"),
    "STARTS_WITH": _string_test("utf8_startswith", "STARTS_WITH"),
    "ENDS_WITH": _string_test("utf8_endswith", "ENDS_WITH"),
    "COALESCE": _coalesce,
    "NULLIF": lambda a: IfElse(a[0] == a[1], lit(None), a[0]).alias(a[0].name()),
    "IFNULL": lambda a: _coalesce(a[:2]),
    "NVL": lambda a: _coalesce(a[:2]),
    "IF": lambda a: IfElse(a[0], a[1], a[2]),
    "IIF": lambda a: IfElse(a[0], a[1], a[2]),
    "YEAR": lambda a: a[0].dt.year(),
    "DATE": lambda a: Cast(a[0], DataType.date()),
}
