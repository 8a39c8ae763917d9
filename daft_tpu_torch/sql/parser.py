"""SQL parser (counterpart of daft_tpu/sql/parser.py): tokens to the port's
Expression IR, plus a small SELECT-statement AST for the planner.

A Pratt parser builds expressions directly; SELECT structure lands in the
``Select`` / ``TableFactor`` / ``JoinClause`` dataclasses that
sql/planner.py plans. The grammar is the reference's; what the port's
engine cannot evaluate yet raises ``NotImplementedError`` naming the
ROADMAP item that brings it, where the reference builds an expression:
the types DECIMAL and NUMERIC (the expression surface, item 7). LIST_AGG and ARRAY_AGG are ``agg_list``,
BINARY and BYTES the binary type.

Window functions are the reference's: an aggregate or ROW_NUMBER, RANK,
DENSE_RANK, PERCENT_RANK, CUME_DIST, NTILE(n), LAG / LEAD (expr[, offset[,
default]]), FIRST_VALUE, LAST_VALUE, followed by ``OVER ([PARTITION BY
...] [ORDER BY ... [ASC|DESC] [NULLS FIRST|LAST]] [ROWS|RANGE BETWEEN
<bound> AND <bound>])``, a bound being ``UNBOUNDED PRECEDING|FOLLOWING``,
``CURRENT ROW`` or ``n PRECEDING|FOLLOWING``. A ranking or value function
without ``OVER`` raises.

``DATE 'yyyy-mm-dd'`` is a date literal and ``TIMESTAMP '...'`` a
timestamp literal (microseconds, ISO form). ``INTERVAL 'n' unit`` (week,
day, hour, minute, second, millisecond) is a duration literal, as in the
reference; added to or subtracted from a date literal in whole days it
folds into a date literal here. Month and year are not fixed durations and
raise, as in the reference.
"""

from __future__ import annotations

import dataclasses
import datetime
from typing import Any, Dict, List, Optional, Tuple

from ..datatype import DataType, Field
from ..expressions.expressions import (AggExpr, Alias, Between, Cast, Expression, IfElse,
                                       IsIn, Literal, _UnboundWindowFn, col, lit)
from .tokenizer import Token, tokenize

# what a ROADMAP item brings, named in the NotImplementedError of each
EXPRESSIONS = "a later wave of the expression surface (ROADMAP Queue 1 item 7)"

_KEYWORDS_STOP = {
    "FROM", "WHERE", "GROUP", "HAVING", "ORDER", "LIMIT", "OFFSET", "UNION", "ALL",
    "JOIN", "INNER", "LEFT", "RIGHT", "FULL", "OUTER", "CROSS", "ON", "AS", "BY",
    "ASC", "DESC", "NULLS", "FIRST", "LAST", "AND", "OR", "NOT", "THEN", "ELSE",
    "END", "WHEN", "SELECT", "DISTINCT", "WITH", "USING", "SEMI", "ANTI", "INTERSECT",
    "EXCEPT",
}

# binding powers of the binary operators (Pratt)
_BP = {
    "OR": 10,
    "AND": 20,
    "=": 40, "==": 40, "<>": 40, "!=": 40, "<": 40, "<=": 40, ">": 40, ">=": 40,
    "LIKE": 40, "ILIKE": 40, "IN": 40, "BETWEEN": 40, "IS": 40,
    "||": 50,
    "+": 60, "-": 60,
    "*": 70, "/": 70, "%": 70,
    "^": 80,
    "::": 90,
}

_AGG_FUNCS = {"SUM": "sum", "AVG": "mean", "MEAN": "mean", "MIN": "min", "MAX": "max",
              "COUNT": "count", "STDDEV": "stddev", "STDDEV_SAMP": "stddev", "VAR": "var",
              "VARIANCE": "var", "ANY_VALUE": "any_value", "SKEW": "skew",
              "BOOL_AND": "bool_and", "BOOL_OR": "bool_or",
              "APPROX_COUNT_DISTINCT": "approx_count_distinct", "LIST_AGG": "list",
              "ARRAY_AGG": "list"}
_WINDOW_RANK_FUNCS = {"ROW_NUMBER", "RANK", "DENSE_RANK", "PERCENT_RANK", "CUME_DIST",
                      "NTILE"}

_TYPE_NAMES = {
    "INT": DataType.int32, "INTEGER": DataType.int32, "INT4": DataType.int32,
    "BIGINT": DataType.int64, "INT8": DataType.int64, "SMALLINT": DataType.int16,
    "TINYINT": DataType.int8, "FLOAT": DataType.float32, "REAL": DataType.float32,
    "DOUBLE": DataType.float64, "FLOAT8": DataType.float64, "FLOAT4": DataType.float32,
    "TEXT": DataType.string, "STRING": DataType.string, "VARCHAR": DataType.string,
    "BOOL": DataType.bool, "BOOLEAN": DataType.bool, "DATE": DataType.date,
    "TIMESTAMP": lambda: DataType.timestamp("us"),
    "BINARY": DataType.binary, "BYTES": DataType.binary,
}
# DECIMAL / NUMERIC's defaults when no (precision[, scale]) follows (the
# reference's parser.py:477-484)
DECIMAL_DEFAULT = (38, 10)
# the fixed-length INTERVAL units, in seconds (the reference's parser.py:423)
_INTERVAL_SECONDS = {"day": 86400.0, "week": 7 * 86400.0, "hour": 3600.0, "minute": 60.0,
                     "second": 1.0, "millisecond": 1e-3}


class InSubquery(Expression):
    """``expr IN (SELECT ...)``: never evaluated; the planner rewrites it
    into a semi join (an anti join under NOT)."""

    def __init__(self, child: Expression, select):
        self.child = child
        self.select = select

    def name(self) -> str:
        return self.child.name()

    def children(self):
        return [self.child]

    def with_children(self, children):
        return InSubquery(children[0], self.select)

    def to_field(self, schema):
        return Field(self.name(), DataType.bool())

    def __repr__(self):
        return f"{self.child!r} IN (<subquery>)"


class ExistsSubquery(Expression):
    """``EXISTS (SELECT ...)``: never evaluated; the planner rewrites it
    into a semi join (an anti join under NOT) on the equality correlations
    of the subquery's WHERE."""

    def __init__(self, select):
        self.select = select

    def name(self) -> str:
        return "exists"

    def to_field(self, schema):
        return Field("exists", DataType.bool())

    def __repr__(self):
        return "EXISTS (<subquery>)"


class ScalarSubquery(Expression):
    """``(SELECT <agg> ...)`` used as a value: the planner binds it to a
    column (an uncorrelated one cross-joins a one-row frame; a correlated one
    becomes a grouped aggregate left-joined on the correlation keys)."""

    def __init__(self, select):
        self.select = select

    def name(self) -> str:
        return "__scalar_subquery__"

    def to_field(self, schema):
        raise ValueError("scalar subquery must be bound by the planner before evaluation")

    def __repr__(self):
        return "(<scalar subquery>)"


@dataclasses.dataclass
class SelectItem:
    expr: Optional[Expression]   # None for a wildcard
    alias: Optional[str]
    wildcard: bool = False
    qualifier: Optional[str] = None  # t.*


@dataclasses.dataclass
class TableFactor:
    name: Optional[str] = None
    subquery: Optional["Select"] = None
    alias: Optional[str] = None
    values: Optional[list] = None       # VALUES rows (lists of Expressions)
    col_names: Optional[list] = None    # alias column list: x(a, b)


@dataclasses.dataclass
class JoinClause:
    factor: TableFactor
    kind: str                    # inner/left/right/outer/cross/semi/anti
    on: Optional[Expression]
    using: Optional[List[str]] = None


@dataclasses.dataclass
class OrderItem:
    expr: Any                    # Expression | int position
    desc: bool = False
    nulls_first: Optional[bool] = None


@dataclasses.dataclass
class Select:
    items: List[SelectItem] = dataclasses.field(default_factory=list)
    distinct: bool = False
    from_table: Optional[TableFactor] = None
    joins: List[JoinClause] = dataclasses.field(default_factory=list)
    where: Optional[Expression] = None
    group_by: List[Any] = dataclasses.field(default_factory=list)  # Expression | position
    grouping_sets: Optional[List[List[Any]]] = None  # ROLLUP / CUBE / GROUPING SETS
    having: Optional[Expression] = None
    order_by: List[OrderItem] = dataclasses.field(default_factory=list)
    limit: Optional[int] = None
    offset: Optional[int] = None
    ctes: Dict[str, "Select"] = dataclasses.field(default_factory=dict)
    set_ops: List[Tuple[str, "Select"]] = dataclasses.field(default_factory=list)


def _not_ported(what: str):
    return NotImplementedError(f"{what} is not ported yet: it comes with {EXPRESSIONS}")


class Parser:
    def __init__(self, text: str):
        self.tokens = tokenize(text)
        self.i = 0

    # ---- token helpers -----------------------------------------------------------
    def peek(self, off: int = 0) -> Token:
        return self.tokens[min(self.i + off, len(self.tokens) - 1)]

    def next(self) -> Token:
        t = self.tokens[self.i]
        if t.kind != "eof":
            self.i += 1
        return t

    def at_kw(self, *kws: str) -> bool:
        t = self.peek()
        return t.kind == "ident" and t.upper() in kws

    def eat_kw(self, *kws: str) -> bool:
        if self.at_kw(*kws):
            self.next()
            return True
        return False

    def expect_kw(self, kw: str) -> None:
        if not self.eat_kw(kw):
            raise ValueError(f"expected {kw} at position {self.peek().pos}, "
                             f"got {self.peek().value!r}")

    def at(self, kind: str, value: Optional[str] = None) -> bool:
        t = self.peek()
        return t.kind == kind and (value is None or t.value == value)

    def eat(self, kind: str, value: Optional[str] = None) -> bool:
        if self.at(kind, value):
            self.next()
            return True
        return False

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        if not self.at(kind, value):
            t = self.peek()
            raise ValueError(f"expected {value or kind} at position {t.pos}, got {t.value!r}")
        return self.next()

    # ---- expressions --------------------------------------------------------------
    def parse_expr(self, min_bp: int = 0) -> Expression:
        return self._operand(min_bp)

    def _operand(self, min_bp: int):
        lhs = self._prefix()
        while True:
            t = self.peek()
            opname = None
            if t.kind == "op" and t.value in _BP:
                opname = t.value
            elif t.kind == "ident" and t.upper() in ("AND", "OR", "LIKE", "ILIKE", "IN",
                                                     "BETWEEN", "IS", "NOT"):
                opname = t.upper()
            if opname is None:
                return lhs
            if opname == "NOT":
                # NOT IN / NOT LIKE / NOT BETWEEN
                nxt = self.peek(1)
                if not (nxt.kind == "ident" and nxt.upper() in ("IN", "LIKE", "ILIKE",
                                                                "BETWEEN")):
                    return lhs
                if _BP[nxt.upper()] < min_bp:
                    return lhs
                self.next()
                inner_op = self.next().upper()
                lhs = ~self._postfix_op(lhs, inner_op)
                continue
            bp = _BP[opname]
            if bp < min_bp:
                return lhs
            self.next()
            if opname in ("LIKE", "ILIKE", "IN", "BETWEEN", "IS"):
                lhs = self._postfix_op(lhs, opname)
                continue
            if opname == "::":
                lhs = Cast(lhs, self._parse_type())
                continue
            rhs = self._operand(bp + 1)
            lhs = self._binary(opname, lhs, rhs)

    def _binary(self, op: str, l, r):
        folded = _date_plus_days(op, l, r)
        if folded is not None:
            return folded
        if op == "OR":
            return l | r
        if op == "AND":
            return l & r
        if op in ("=", "=="):
            return l == r
        if op in ("<>", "!="):
            return l != r
        if op == "<":
            return l < r
        if op == "<=":
            return l <= r
        if op == ">":
            return l > r
        if op == ">=":
            return l >= r
        if op == "+":
            return l + r
        if op == "-":
            return l - r
        if op == "*":
            return l * r
        if op == "/":
            return l / r
        if op == "%":
            return l % r
        if op == "^":
            return l ** r
        if op == "||":
            return l._fn("utf8_concat", r)
        raise ValueError(f"unhandled operator {op}")

    def _postfix_op(self, lhs: Expression, op: str) -> Expression:
        if op in ("LIKE", "ILIKE"):
            pattern = self.parse_expr(_BP["LIKE"] + 1)
            if not isinstance(pattern, Literal):
                raise ValueError("LIKE pattern must be a string literal")
            return lhs._fn("utf8_like" if op == "LIKE" else "utf8_ilike", pattern.value)
        if op == "IN":
            self.expect("punct", "(")
            if self.at_kw("SELECT"):
                sub = self._parse_select()
                self.expect("punct", ")")
                return InSubquery(lhs, sub)
            items = [self.parse_expr()]
            while self.eat("punct", ","):
                items.append(self.parse_expr())
            self.expect("punct", ")")
            return IsIn(lhs, items)
        if op == "BETWEEN":
            lo = self.parse_expr(_BP["BETWEEN"] + 1)
            self.expect_kw("AND")
            hi = self.parse_expr(_BP["BETWEEN"] + 1)
            return Between(lhs, lo, hi)
        if op == "IS":
            negate = self.eat_kw("NOT")
            if self.eat_kw("NULL"):
                return lhs.not_null() if negate else lhs.is_null()
            # IS [NOT] TRUE / FALSE: never null (NULL IS TRUE is false)
            for word, value in (("TRUE", True), ("FALSE", False)):
                if self.eat_kw(word):
                    e = lhs.eq_null_safe(lit(value))
                    return ~e if negate else e
            raise ValueError("expected NULL/TRUE/FALSE after IS")
        raise ValueError(op)

    def _prefix(self):
        t = self.peek()
        if t.kind == "op" and t.value == "-":
            self.next()
            return -self.parse_expr(65)
        if t.kind == "op" and t.value == "+":
            self.next()
            return self.parse_expr(65)
        if t.kind == "ident" and t.upper() == "NOT":
            self.next()
            return ~self.parse_expr(25)
        if t.kind == "punct" and t.value == "(":
            self.next()
            if self.at_kw("SELECT"):
                sub = self._parse_select()
                self.expect("punct", ")")
                return ScalarSubquery(sub)
            e = self.parse_expr()
            self.expect("punct", ")")
            return e
        if t.kind == "number":
            self.next()
            txt = t.value
            if "." in txt or "e" in txt or "E" in txt:
                return lit(float(txt))
            return lit(int(txt))
        if t.kind == "string":
            self.next()
            return lit(t.value)
        if t.kind == "ident":
            up = t.upper()
            if up == "EXISTS":
                self.next()
                self.expect("punct", "(")
                sub = self._parse_select()
                self.expect("punct", ")")
                return ExistsSubquery(sub)
            if up == "NULL":
                self.next()
                return lit(None)
            if up == "TRUE":
                self.next()
                return lit(True)
            if up == "FALSE":
                self.next()
                return lit(False)
            if up == "CASE":
                return self._parse_case()
            if up == "CAST":
                self.next()
                self.expect("punct", "(")
                e = self.parse_expr()
                self.expect_kw("AS")
                dt = self._parse_type()
                self.expect("punct", ")")
                return Cast(e, dt)
            if up == "DATE" and self.peek(1).kind == "string":
                self.next()
                return lit(datetime.date.fromisoformat(self.next().value))
            if up == "TIMESTAMP" and self.peek(1).kind == "string":
                self.next()
                return lit(datetime.datetime.fromisoformat(self.next().value))
            if up == "INTERVAL":
                self.next()
                return self._parse_interval()
            if self.peek(1).kind == "punct" and self.peek(1).value == "(":
                return self._parse_function_call()
            # qualified or bare column
            self.next()
            name = t.value
            if self.eat("punct", "."):
                if self.at("op", "*"):
                    raise ValueError("qualified wildcard only allowed in SELECT list")
                return col(f"{name}.{self.expect('ident').value}")
            return col(name)
        raise ValueError(f"unexpected token {t.value!r} at {t.pos}")

    def _parse_interval(self) -> Expression:
        spec = self.expect("string").value.strip()
        parts = spec.split()
        if len(parts) == 2:
            n, unit = parts
        elif self.peek().kind == "ident":
            n, unit = spec, self.next().value
        else:
            raise ValueError(f"malformed INTERVAL {spec!r}")
        n = float(n)
        unit = unit.rstrip("sS").lower()
        if unit in _INTERVAL_SECONDS:
            return lit(datetime.timedelta(seconds=n * _INTERVAL_SECONDS[unit]))
        raise NotImplementedError(
            f"INTERVAL unit {unit!r}: calendar units (month/year) are not fixed durations; "
            "use the dt namespace (e.g. add via datetime arithmetic in the DataFrame API)")

    def _parse_case(self) -> Expression:
        self.expect_kw("CASE")
        operand = None
        if not self.at_kw("WHEN"):
            operand = self.parse_expr()
        branches = []
        while self.eat_kw("WHEN"):
            cond = self.parse_expr()
            self.expect_kw("THEN")
            val = self.parse_expr()
            if operand is not None:
                cond = operand == cond
            branches.append((cond, val))
        default = lit(None)
        if self.eat_kw("ELSE"):
            default = self.parse_expr()
        self.expect_kw("END")
        out = default
        for cond, val in reversed(branches):
            out = IfElse(cond, val, out)
        return out

    def _parse_type(self) -> DataType:
        t = self.expect("ident")
        up = t.upper()
        if up in _TYPE_NAMES:
            # an optional (n) length parameter is read and dropped
            if self.eat("punct", "("):
                while not self.eat("punct", ")"):
                    self.next()
            return _TYPE_NAMES[up]()
        if up in ("DECIMAL", "NUMERIC"):
            prec, scale = DECIMAL_DEFAULT
            if self.eat("punct", "("):
                prec = int(self.expect("number").value)
                if self.eat("punct", ","):
                    scale = int(self.expect("number").value)
                self.expect("punct", ")")
            return DataType.decimal128(prec, scale)
        raise ValueError(f"unknown type {t.value!r}")

    def _parse_function_call(self) -> Expression:
        fname = self.next().upper()
        self.expect("punct", "(")

        if fname == "EXTRACT":
            # EXTRACT(unit FROM expr)
            unit = self.next().upper()
            self.expect_kw("FROM")
            src = self.parse_expr()
            self.expect("punct", ")")
            table = {"YEAR": "year", "MONTH": "month", "DAY": "day", "HOUR": "hour",
                     "MINUTE": "minute", "SECOND": "second", "QUARTER": "quarter",
                     "WEEK": "week_of_year", "DOY": "day_of_year", "DOW": "day_of_week",
                     "MILLISECOND": "millisecond", "MICROSECOND": "microsecond"}
            if unit not in table:
                raise ValueError(f"EXTRACT unit {unit!r} not supported; known: "
                                 f"{sorted(table)}")
            return getattr(src.dt, table[unit])()

        distinct = False
        star = False
        args: List[Expression] = []
        if self.at("op", "*"):
            self.next()
            star = True
        elif not self.at("punct", ")"):
            if self.eat_kw("DISTINCT"):
                distinct = True
            args.append(self.parse_expr())
            while self.eat("punct", ","):
                args.append(self.parse_expr())
        self.expect("punct", ")")

        expr = self._build_function(fname, args, star, distinct)
        if self.at_kw("OVER"):
            self.next()
            spec = self._parse_window_spec()
            inner, out_name = expr, None
            if isinstance(inner, Alias):
                out_name = inner._alias
                inner = inner.child
            if isinstance(inner, (AggExpr, _UnboundWindowFn)):
                w = inner.over(spec)
                return w.alias(out_name) if out_name else w
            raise ValueError(f"{fname} cannot be used as a window function")
        if isinstance(expr, _UnboundWindowFn):
            raise ValueError(f"{fname}() requires an OVER clause")
        return expr

    def _parse_window_spec(self):
        from ..window import Window

        self.expect("punct", "(")
        w = Window()
        if self.eat_kw("PARTITION"):
            self.expect_kw("BY")
            parts = [self.parse_expr()]
            while self.eat("punct", ","):
                parts.append(self.parse_expr())
            w = w.partition_by(*parts)
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            exprs, descs, nfs = [], [], []
            while True:
                e = self.parse_expr()
                d = False
                if self.eat_kw("DESC"):
                    d = True
                else:
                    self.eat_kw("ASC")
                nf = None
                if self.eat_kw("NULLS"):
                    if self.eat_kw("FIRST"):
                        nf = True
                    else:
                        self.expect_kw("LAST")
                        nf = False
                exprs.append(e)
                descs.append(d)
                nfs.append(nf if nf is not None else d)
                if not self.eat("punct", ","):
                    break
            w = w.order_by(*exprs, desc=descs, nulls_first=nfs)
        if self.at_kw("ROWS", "RANGE"):
            kind = self.next().upper()
            lo, hi = self._parse_frame_bounds()
            w = w.rows_between(lo, hi) if kind == "ROWS" else w.range_between(lo, hi)
        self.expect("punct", ")")
        return w

    def _parse_frame_bounds(self):
        from ..window import Window

        def bound():
            if self.eat_kw("UNBOUNDED"):
                if self.eat_kw("PRECEDING"):
                    return Window.unbounded_preceding
                self.expect_kw("FOLLOWING")
                return Window.unbounded_following
            if self.eat_kw("CURRENT"):
                self.expect_kw("ROW")
                return 0
            n = int(self.expect("number").value)
            if self.eat_kw("PRECEDING"):
                return -n
            self.expect_kw("FOLLOWING")
            return n

        self.expect_kw("BETWEEN")
        lo = bound()
        self.expect_kw("AND")
        return lo, bound()

    def _build_function(self, fname: str, args: List[Expression], star: bool,
                        distinct: bool) -> Expression:
        from .functions import build_sql_function

        if fname in _AGG_FUNCS:
            if fname == "COUNT":
                if star:
                    return AggExpr("count", lit(1), {"mode": "all"}).alias("count")
                if distinct:
                    return AggExpr("count_distinct", args[0])
                return AggExpr("count", args[0], {"mode": "valid"})
            if distinct:
                raise ValueError(f"DISTINCT not supported for {fname}")
            return AggExpr(_AGG_FUNCS[fname], args[0])
        if fname in _WINDOW_RANK_FUNCS:
            params = {"n": int(args[0].value)} if fname == "NTILE" and args else {}
            return _UnboundWindowFn(fname.lower(), None, params)
        if fname in ("LAG", "LEAD"):
            offset, default = 1, None
            if len(args) > 1:
                if not isinstance(args[1], Literal):
                    raise ValueError(f"{fname} offset must be a literal integer")
                offset = int(args[1].value)
            if len(args) > 2:
                if not isinstance(args[2], Literal):
                    raise ValueError(f"{fname} default must be a literal")
                default = args[2].value
            return _UnboundWindowFn(fname.lower(), args[0], {"offset": offset,
                                                             "default": default})
        if fname in ("FIRST_VALUE", "LAST_VALUE"):
            return _UnboundWindowFn(fname.lower(), args[0], {})
        return build_sql_function(fname, args)

    # ---- statements ---------------------------------------------------------------
    def parse_statement(self) -> Select:
        sel = self._parse_select()
        if not self.at("eof") and not self.at("punct", ";"):
            t = self.peek()
            raise ValueError(f"unexpected trailing token {t.value!r} at {t.pos}")
        return sel

    def _parse_select(self) -> Select:
        ctes: Dict[str, Select] = {}
        if self.eat_kw("WITH"):
            while True:
                name = self.expect("ident").value
                self.expect_kw("AS")
                self.expect("punct", "(")
                ctes[name.lower()] = self._parse_select()
                self.expect("punct", ")")
                if not self.eat("punct", ","):
                    break
        sel = self._parse_select_core()
        sel.ctes = ctes
        while True:
            if self.eat_kw("UNION"):
                op = "union_all" if self.eat_kw("ALL") else "union"
                sel.set_ops.append((op, self._parse_select_core()))
            elif self.eat_kw("INTERSECT"):
                sel.set_ops.append(("intersect", self._parse_select_core()))
            elif self.eat_kw("EXCEPT"):
                sel.set_ops.append(("except", self._parse_select_core()))
            else:
                break
        # a trailing ORDER BY / LIMIT applies to the whole compound
        self._parse_order_limit(sel)
        return sel

    def _parse_select_core(self) -> Select:
        self.expect_kw("SELECT")
        sel = Select()
        sel.distinct = self.eat_kw("DISTINCT")
        while True:
            sel.items.append(self._parse_select_item())
            if not self.eat("punct", ","):
                break
        if self.eat_kw("FROM"):
            sel.from_table = self._parse_table_factor()
            while True:
                # a SQL-92 comma list is a cross join; the optimizer's
                # rule_cross_join_to_inner recovers the equi-join
                if self.eat("punct", ","):
                    sel.joins.append(JoinClause(self._parse_table_factor(), "cross", None))
                    continue
                j = self._try_parse_join()
                if j is None:
                    break
                sel.joins.append(j)
        if self.eat_kw("WHERE"):
            sel.where = self.parse_expr()
        if self.eat_kw("GROUP"):
            self.expect_kw("BY")
            if self.at_kw("ROLLUP", "CUBE", "GROUPING"):
                sel.grouping_sets = self._parse_grouping_sets()
            else:
                while True:
                    if self.at("number"):
                        sel.group_by.append(int(self.next().value))
                    else:
                        sel.group_by.append(self.parse_expr())
                    if not self.eat("punct", ","):
                        break
        if self.eat_kw("HAVING"):
            sel.having = self.parse_expr()
        return sel

    def _parse_order_limit(self, sel: Select) -> None:
        if self.eat_kw("ORDER"):
            self.expect_kw("BY")
            while True:
                if self.at("number"):
                    item = OrderItem(int(self.next().value))  # the planner resolves it
                else:
                    item = OrderItem(self.parse_expr())
                if self.eat_kw("DESC"):
                    item.desc = True
                else:
                    self.eat_kw("ASC")
                if self.eat_kw("NULLS"):
                    if self.eat_kw("FIRST"):
                        item.nulls_first = True
                    else:
                        self.expect_kw("LAST")
                        item.nulls_first = False
                sel.order_by.append(item)
                if not self.eat("punct", ","):
                    break
        if self.eat_kw("LIMIT"):
            sel.limit = int(self.expect("number").value)
        if self.eat_kw("OFFSET"):
            sel.offset = int(self.expect("number").value)

    def _parse_select_item(self) -> SelectItem:
        if self.at("op", "*"):
            self.next()
            return SelectItem(None, None, wildcard=True)
        if (self.peek().kind == "ident" and self.peek(1).kind == "punct"
                and self.peek(1).value == "." and self.peek(2).kind == "op"
                and self.peek(2).value == "*"):
            q = self.next().value
            self.next()
            self.next()
            return SelectItem(None, None, wildcard=True, qualifier=q)
        e = self.parse_expr()
        alias = None
        if self.eat_kw("AS"):
            alias = self.next().value
        elif self.peek().kind == "ident" and self.peek().upper() not in _KEYWORDS_STOP \
                and not self.at("eof"):
            alias = self.next().value
        return SelectItem(e, alias)

    def _parse_table_factor(self) -> TableFactor:
        if self.eat("punct", "("):
            if self.at_kw("VALUES"):
                self.next()
                rows = []
                while True:
                    self.expect("punct", "(")
                    row = [self.parse_expr()]
                    while self.eat("punct", ","):
                        row.append(self.parse_expr())
                    self.expect("punct", ")")
                    rows.append(row)
                    if not self.eat("punct", ","):
                        break
                self.expect("punct", ")")
                alias, col_names = self._parse_alias_with_columns()
                return TableFactor(values=rows, alias=alias, col_names=col_names)
            sub = self._parse_select()
            self.expect("punct", ")")
            alias, col_names = self._parse_alias_with_columns()
            return TableFactor(subquery=sub, alias=alias, col_names=col_names)
        name = self.expect("ident").value
        while self.eat("punct", "."):  # catalog.schema.table
            name += "." + self.expect("ident").value
        alias = None
        if self.eat_kw("AS"):
            alias = self.next().value
        elif self.peek().kind == "ident" and self.peek().upper() not in _KEYWORDS_STOP:
            alias = self.next().value
        return TableFactor(name=name, alias=alias)

    def _parse_grouping_sets(self):
        """ROLLUP(a, b) / CUBE(a, b) / GROUPING SETS ((a), (a, b), ()) as a
        list of grouping-key lists."""
        kw = self.next().upper()
        if kw == "GROUPING":
            self.expect_kw("SETS")
            self.expect("punct", "(")
            sets = []
            while True:
                self.expect("punct", "(")
                cur = []
                if not self.at("punct", ")"):
                    cur.append(self.parse_expr())
                    while self.eat("punct", ","):
                        cur.append(self.parse_expr())
                self.expect("punct", ")")
                sets.append(cur)
                if not self.eat("punct", ","):
                    break
            self.expect("punct", ")")
            return sets
        self.expect("punct", "(")
        keys = [self.parse_expr()]
        while self.eat("punct", ","):
            keys.append(self.parse_expr())
        self.expect("punct", ")")
        if kw == "ROLLUP":
            return [keys[:i] for i in range(len(keys), -1, -1)]
        if kw == "CUBE":
            import itertools

            return [[keys[i] for i in combo]
                    for r in range(len(keys), -1, -1)
                    for combo in itertools.combinations(range(len(keys)), r)]
        raise ValueError(f"unexpected grouping keyword {kw}")

    def _parse_alias_with_columns(self):
        """[AS] name [(col, col, ...)] after a parenthesized table factor."""
        alias = None
        col_names = None
        if self.eat_kw("AS"):
            alias = self.next().value
        elif self.peek().kind == "ident" and self.peek().upper() not in _KEYWORDS_STOP:
            alias = self.next().value
        if alias is not None and self.eat("punct", "("):
            col_names = [self.expect("ident").value]
            while self.eat("punct", ","):
                col_names.append(self.expect("ident").value)
            self.expect("punct", ")")
        return alias, col_names

    def _try_parse_join(self) -> Optional[JoinClause]:
        kind = None
        if self.eat_kw("CROSS"):
            self.expect_kw("JOIN")
            kind = "cross"
        elif self.eat_kw("INNER"):
            self.expect_kw("JOIN")
            kind = "inner"
        elif self.at_kw("LEFT", "RIGHT", "FULL"):
            k = self.next().upper()
            self.eat_kw("OUTER")
            if self.eat_kw("SEMI"):
                kind = "semi" if k == "LEFT" else "right_semi"
            elif self.eat_kw("ANTI"):
                kind = "anti" if k == "LEFT" else "right_anti"
            else:
                kind = {"LEFT": "left", "RIGHT": "right", "FULL": "outer"}[k]
            self.expect_kw("JOIN")
        elif self.eat_kw("JOIN"):
            kind = "inner"
        else:
            return None
        factor = self._parse_table_factor()
        on = None
        using = None
        if kind != "cross":
            if self.eat_kw("ON"):
                on = self.parse_expr()
            elif self.eat_kw("USING"):
                self.expect("punct", "(")
                using = [self.expect("ident").value]
                while self.eat("punct", ","):
                    using.append(self.expect("ident").value)
                self.expect("punct", ")")
        return JoinClause(factor, kind, on, using)


def _date_plus_days(op: str, l, r) -> Optional[Expression]:
    """DATE literal +/- a whole-day INTERVAL (or INTERVAL + DATE) as a date
    literal; None for anything else, which stays arithmetic."""
    if op not in ("+", "-"):
        return None

    def is_date(e):
        return isinstance(e, Literal) and type(e.value) is datetime.date

    def whole_days(e):
        return isinstance(e, Literal) and isinstance(e.value, datetime.timedelta) \
            and e.value % datetime.timedelta(days=1) == datetime.timedelta(0)

    if is_date(l) and whole_days(r):
        return lit(l.value + r.value if op == "+" else l.value - r.value)
    if op == "+" and whole_days(l) and is_date(r):
        return lit(r.value + l.value)
    return None


def parse_expression(text: str) -> Expression:
    p = Parser(text)
    e = p.parse_expr()
    if not p.at("eof"):
        t = p.peek()
        raise ValueError(f"unexpected trailing token {t.value!r} at {t.pos}")
    return e


def parse_select(text: str) -> Select:
    return Parser(text).parse_statement()
