"""SQL function names to Expressions (counterpart of
daft_tpu/sql/functions.py).

The reference's SQL names map as it maps them (the math functions, the
string functions with SUBSTR / SUBSTRING 1-based over literal bounds, the
conditionals COALESCE, NULLIF, IFNULL / NVL, IF / IIF, GREATEST / LEAST,
the date parts, DATE_TRUNC, TO_DATE, DATE as a cast, HASH); any other name
falls through to the scalar function registry under its lower-case name
(daft_tpu/sql/functions.py:27-33). A name of a later wave raises
``NotImplementedError`` naming its wave; an unknown name ``ValueError``.
"""

from __future__ import annotations

from typing import List

from ..datatype import DataType
from ..expressions.expressions import Cast, Expression, Function, IfElse, Literal, lit
def _lit_val(e: Expression, what: str):
    if isinstance(e, Literal):
        return e.value
    raise ValueError(f"{what} takes a literal argument")


def build_sql_function(fname: str, args: List[Expression]) -> Expression:
    f = _SQL_FUNCS.get(fname)
    if f is not None:
        return f(args)
    from ..functions.registry import has_function, later_wave

    lname = fname.lower()
    if has_function(lname):
        return args[0]._fn(lname, *args[1:]) if args else Function(lname, [])
    wave = later_wave(lname)
    if wave is not None:
        raise NotImplementedError(f"SQL function {fname!r} is not ported yet: it comes "
                                  f"with {wave}")
    raise ValueError(f"unknown SQL function {fname!r}")


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


def _round(args):
    return args[0].round(int(_lit_val(args[1], "ROUND's decimals")) if len(args) > 1 else 0)


def _log(args):
    if len(args) > 1:  # SQL LOG(base, x)
        return args[1].log(float(_lit_val(args[0], "LOG's base")))
    return args[0].log()


def _concat(args):
    out = args[0]
    for a in args[1:]:
        out = out._fn("utf8_concat", a)
    return out


def _pad(fname: str):
    return lambda a: a[0]._fn(fname, _lit_val(a[1], fname),
                              _lit_val(a[2], fname) if len(a) > 2 else " ")


_SQL_FUNCS = {
    "ABS": lambda a: a[0].abs(),
    "CEIL": lambda a: a[0].ceil(),
    "CEILING": lambda a: a[0].ceil(),
    "FLOOR": lambda a: a[0].floor(),
    "ROUND": _round,
    "SQRT": lambda a: a[0].sqrt(),
    "EXP": lambda a: a[0].exp(),
    "LN": lambda a: a[0].log(),
    "LOG": _log,
    "LOG2": lambda a: a[0].log2(),
    "LOG10": lambda a: a[0].log10(),
    "POW": lambda a: a[0] ** a[1],
    "POWER": lambda a: a[0] ** a[1],
    "MOD": lambda a: a[0] % a[1],
    "SIGN": lambda a: a[0].sign(),
    "SIN": lambda a: a[0].sin(),
    "COS": lambda a: a[0].cos(),
    "TAN": lambda a: a[0].tan(),
    "ATAN": lambda a: a[0].arctan(),
    "ASIN": lambda a: a[0].arcsin(),
    "ACOS": lambda a: a[0].arccos(),
    "LOWER": lambda a: a[0].str.lower(),
    "UPPER": lambda a: a[0].str.upper(),
    "LENGTH": lambda a: a[0].str.length(),
    "CHAR_LENGTH": lambda a: a[0].str.length(),
    "TRIM": lambda a: a[0]._fn("utf8_strip"),
    "LTRIM": lambda a: a[0]._fn("utf8_lstrip"),
    "RTRIM": lambda a: a[0]._fn("utf8_rstrip"),
    "REVERSE": lambda a: a[0]._fn("utf8_reverse"),
    "REPLACE": lambda a: a[0]._fn("utf8_replace", _lit_val(a[1], "REPLACE"),
                                  _lit_val(a[2], "REPLACE")),
    "RIGHT": lambda a: a[0]._fn("utf8_right", _lit_val(a[1], "RIGHT's length")),
    "REPEAT": lambda a: a[0]._fn("utf8_repeat", _lit_val(a[1], "REPEAT's count")),
    "LPAD": _pad("utf8_lpad"),
    "RPAD": _pad("utf8_rpad"),
    "REGEXP_MATCH": lambda a: a[0]._fn("utf8_match", _lit_val(a[1], "REGEXP_MATCH")),
    "SPLIT": lambda a: a[0]._fn("utf8_split", _lit_val(a[1], "SPLIT")),
    "CONCAT": _concat,
    "CONCAT_WS": lambda a: _fold(a[1:], lambda x, y: x._fn("utf8_concat", a[0])
                                 ._fn("utf8_concat", y)),
    "MONTH": lambda a: a[0].dt.month(),
    "DAY": lambda a: a[0].dt.day(),
    "HOUR": lambda a: a[0].dt.hour(),
    "MINUTE": lambda a: a[0].dt.minute(),
    "SECOND": lambda a: a[0].dt.second(),
    "DAYOFWEEK": lambda a: a[0].dt.day_of_week(),
    "DAYOFYEAR": lambda a: a[0].dt.day_of_year(),
    "WEEKOFYEAR": lambda a: a[0].dt.week_of_year(),
    "DATE_TRUNC": lambda a: a[1].dt.truncate(f"1 {_lit_val(a[0], 'DATE_TRUNC')}"),
    "TO_DATE": lambda a: a[0].str.to_date(_lit_val(a[1], "TO_DATE") if len(a) > 1
                                          else "%Y-%m-%d"),
    "HASH": lambda a: a[0].hash(),
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
