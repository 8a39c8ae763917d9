"""SQL planner: the Select AST to a DataFrame (counterpart of
daft_tpu/sql/planner.py).

Tables resolve from the query's CTEs, then from the ``**bindings`` (a name
as written, then lower-cased), then from the session (the one given, else
``current_session()``: its temp tables and attached catalogs); any other
name raises ``ValueError("unknown table ...")``. Qualified columns resolve through
a scope of table aliases; ON conjunctions split into equi-join keys and a
residual predicate; aggregates are pulled out of the select list, HAVING
and ORDER BY; subqueries plan to joins: ``[NOT] IN (SELECT ...)`` to a
semi (anti) join, ``[NOT] EXISTS`` to a semi (anti) join on its equality
correlations, a scalar subquery to a cross join with a one-row frame
(uncorrelated) or a left join with a grouped aggregate (correlated).

The set operations (UNION, INTERSECT, EXCEPT) and grouping sets (ROLLUP,
CUBE, GROUPING SETS) raise ``NotImplementedError``: they need the Concat
plan node, which comes with the expression surface (ROADMAP Queue 1
item 7).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..expressions.expressions import (AggExpr, BinaryOp, ColumnRef, Expression, Literal,
                                       UnaryOp, col, lit)
from .parser import (EXPRESSIONS, ExistsSubquery, InSubquery, JoinClause, ScalarSubquery,
                     Select, SelectItem, TableFactor, parse_select)


def plan_sql(query: str, bindings: Dict[str, Any], session: Any = None):
    return SQLPlanner(bindings, session=session).plan(parse_select(query))


class Scope:
    """Table aliases -> {source column -> its current name in the frame}."""

    def __init__(self):
        self.tables: Dict[str, Dict[str, str]] = {}

    def add(self, alias: Optional[str], columns: List[str]):
        if alias:
            self.tables[alias.lower()] = {c: c for c in columns}

    def resolve(self, name: str) -> str:
        if "." in name:
            t, c = name.split(".", 1)
            tbl = self.tables.get(t.lower())
            if tbl is None:
                raise ValueError(f"unknown table alias {t!r}")
            if c not in tbl:
                raise ValueError(f"column {c!r} not found in table {t!r}")
            return tbl[c]
        return name

    def columns_of(self, alias: str) -> List[str]:
        tbl = self.tables.get(alias.lower())
        if tbl is None:
            raise ValueError(f"unknown table alias {alias!r}")
        return list(tbl.values())


def _split_and(e: Expression) -> List[Expression]:
    if isinstance(e, BinaryOp) and e.op == "and":
        return _split_and(e.left) + _split_and(e.right)
    return [e]


def _and_all(exprs: List[Expression]) -> Optional[Expression]:
    out = None
    for e in exprs:
        out = e if out is None else out & e
    return out


def _contains_agg(e: Expression) -> bool:
    return isinstance(e, AggExpr) or any(_contains_agg(c) for c in e.children())


class SQLPlanner:
    def __init__(self, bindings: Dict[str, Any], ctes: Optional[Dict[str, Any]] = None,
                 session: Any = None):
        self.bindings = bindings
        self.cte_frames: Dict[str, Any] = dict(ctes or {})
        self.session = session
        self._scalar_counter = 0

    def _sub(self) -> "SQLPlanner":
        """A planner for a nested select: the same bindings, CTEs and
        session."""
        return SQLPlanner(self.bindings, self.cte_frames, self.session)

    # ---- table resolution ---------------------------------------------------------
    def _resolve_table(self, name: str):
        key = name.lower()
        if key in self.cte_frames:
            return self.cte_frames[key]
        if name in self.bindings:
            return self.bindings[name]
        if key in self.bindings:
            return self.bindings[key]
        from ..session import current_session

        sess = self.session if self.session is not None else current_session()
        t = sess.get_table(name)
        if t is not None:
            return t
        raise ValueError(f"unknown table {name!r}")

    def _plan_factor(self, f: TableFactor, scope: Scope):
        import daft_tpu_torch as dt

        if f.values is not None:
            ncols = len(f.values[0]) if f.values else 0
            names = f.col_names or [f"column{i + 1}" for i in range(ncols)]
            if any(len(r) != ncols for r in f.values):
                raise ValueError("VALUES rows have inconsistent arity")
            data = {}
            for i, n in enumerate(names):
                cells = []
                for r in f.values:
                    if not isinstance(r[i], Literal):
                        raise ValueError("VALUES cells must be literals")
                    cells.append(r[i].value)
                data[n] = cells
            df = dt.from_pydict(data)
            scope.add(f.alias, df.column_names)
            return df
        if f.subquery is not None:
            df = self._sub().plan(f.subquery)
            if f.col_names:
                df = df.select(*[col(c).alias(n) for c, n in zip(df.column_names, f.col_names)])
            scope.add(f.alias, df.column_names)
            return df
        df = self._resolve_table(f.name)
        scope.add(f.alias or f.name, df.column_names)
        return df

    # ---- WHERE and the subqueries in it ---------------------------------------------
    def _apply_where(self, df, where: Expression, scope: Scope):
        """A WHERE clause: its top-level [NOT] IN (SELECT ...) and [NOT]
        EXISTS (SELECT ...) conjuncts become semi or anti joins against the
        planned subquery, and scalar subqueries bind to joined columns."""
        rest = []
        helpers: List[str] = []
        for c in _split_and(where):
            negated = False
            node = c
            if isinstance(node, UnaryOp) and node.op == "not" \
                    and isinstance(node.child, (InSubquery, ExistsSubquery)):
                negated = True
                node = node.child
            if isinstance(node, ExistsSubquery):
                df = self._plan_exists(df, node.select, negated, scope)
                continue
            if not isinstance(node, InSubquery) and \
                    any(isinstance(n, ScalarSubquery) for n in node.walk()):
                df, node, h = self._bind_scalar_subqueries(df, node, scope)
                helpers.extend(h)
                rest.append(node)
                continue
            if isinstance(node, InSubquery):
                sub_df = self._sub().plan(node.select)
                key = sub_df.column_names[0]
                left_key = self._resolve_expr(node.child, scope)
                if negated:
                    # SQL's three-valued NOT IN: a null anywhere in the
                    # subquery makes the predicate null for every row (no row
                    # passes); a null left key passes only against an empty
                    # subquery. A plain anti join keeps both, so a cross-joined
                    # (total, non-null) count guards it. The subquery is
                    # materialized once: the plan reads it twice
                    sub_df = sub_df.collect()
                    stats = sub_df.agg(lit(1).count("all").alias("__in_sub_cnt__"),
                                       col(key).count().alias("__in_sub_nn__"))
                    guard = (col("__in_sub_cnt__") == col("__in_sub_nn__")) & (
                        (col("__in_sub_cnt__") == lit(0)) | left_key.not_null())
                    df = (df.join(stats, how="cross")
                          .where(guard)
                          .exclude("__in_sub_cnt__", "__in_sub_nn__")
                          .join(sub_df, left_on=left_key, right_on=key, how="anti"))
                else:
                    df = df.join(sub_df, left_on=left_key, right_on=key, how="semi")
            else:
                if any(isinstance(n, InSubquery) for n in node.walk()):
                    raise NotImplementedError(
                        "IN (subquery) only supported as a top-level AND conjunct")
                rest.append(node)
        if rest:
            df = df.where(self._resolve_expr(_and_all(rest), scope))
        if helpers:
            df = df.exclude(*[h for h in helpers if h in df.column_names])
        return df

    def _inner_frame(self, sub_sel: Select):
        """The FROM / JOIN part of a subquery alone, to learn which column
        names resolve inside it (plans are lazy: cheap)."""
        import daft_tpu_torch as dt

        planner = self._sub()
        inner_scope = Scope()
        if sub_sel.from_table is None:
            return dt.from_pydict({"__dummy__": [1]}), inner_scope
        inner_df = planner._plan_factor(sub_sel.from_table, inner_scope)
        for j in sub_sel.joins:
            inner_df = planner._plan_join(inner_df, j, inner_scope)
        return inner_df, inner_scope

    def _split_correlation(self, sub_sel: Select, inner_df, inner_scope: Scope,
                           outer_df, outer_scope: Scope):
        """The subquery's WHERE split into equality correlations
        [(inner ref, outer ref)] and the rest (over the inner side only); a
        correlated predicate that is not a plain equality raises."""
        inner_cols = set(inner_df.column_names)
        inner_aliases = set(inner_scope.tables)
        outer_cols = set(outer_df.column_names)

        def is_inner(ref) -> bool:
            n = ref._name
            if "." in n:
                return n.split(".", 1)[0].lower() in inner_aliases
            return n in inner_cols

        def is_outer(ref) -> bool:
            n = ref._name
            if "." in n:
                return n.split(".", 1)[0].lower() in outer_scope.tables
            return n in outer_cols

        pairs, remaining = [], []
        if sub_sel.where is not None:
            for c in _split_and(sub_sel.where):
                if (isinstance(c, BinaryOp) and c.op == "eq"
                        and isinstance(c.left, ColumnRef) and isinstance(c.right, ColumnRef)):
                    li, ri = is_inner(c.left), is_inner(c.right)
                    if li and not ri and is_outer(c.right):
                        pairs.append((c.left, c.right))
                        continue
                    if ri and not li and is_outer(c.left):
                        pairs.append((c.right, c.left))
                        continue
                for n in c.walk():
                    if isinstance(n, ColumnRef) and not is_inner(n) and is_outer(n):
                        raise NotImplementedError(
                            f"unsupported correlated subquery predicate: {c!r}")
                remaining.append(c)
        return pairs, _and_all(remaining)

    def _plan_exists(self, df, sub_sel: Select, negated: bool, scope: Scope):
        """[NOT] EXISTS (SELECT ...): a semi (anti) join on the extracted
        correlation keys; an uncorrelated one guards on the subquery's row
        count."""
        inner_df, inner_scope = self._inner_frame(sub_sel)
        pairs, remaining = self._split_correlation(sub_sel, inner_df, inner_scope, df, scope)
        if not pairs:
            sub_df = self._sub().plan(sub_sel)
            cnt = sub_df.agg(lit(1).count("all").alias("__exists_cnt__"))
            cond = (col("__exists_cnt__") == lit(0)) if negated \
                else (col("__exists_cnt__") > lit(0))
            return df.join(cnt, how="cross").where(cond).exclude("__exists_cnt__")
        if sub_sel.group_by or sub_sel.having is not None:
            raise NotImplementedError("correlated EXISTS with GROUP BY/HAVING")
        if sub_sel.offset:
            raise NotImplementedError("correlated EXISTS with OFFSET")
        if sub_sel.limit == 0:
            return df if negated else df.limit(0)  # EXISTS over no rows is false
        # a LIMIT of n >= 1 cannot change whether a row exists: dropped
        items = [SelectItem(inner_ref, f"__ek_{i}__") for i, (inner_ref, _o) in enumerate(pairs)]
        sub2 = dataclasses.replace(sub_sel, items=items, where=remaining, order_by=[],
                                   limit=None, offset=None, distinct=False)
        sub_df = self._sub().plan(sub2)
        return df.join(sub_df, left_on=[self._resolve_expr(o, scope) for _i, o in pairs],
                       right_on=[col(f"__ek_{i}__") for i in range(len(pairs))],
                       how="anti" if negated else "semi")

    def _bind_scalar_subqueries(self, df, expr: Expression, scope: Scope):
        """Each ScalarSubquery of ``expr`` replaced by a column bound onto
        ``df``: uncorrelated, a one-row cross join; correlated, a grouped
        aggregate over the correlation keys, left-joined (a missing key gives
        null, as a scalar subquery over no rows does). Returns (df, expr,
        helper columns)."""
        import daft_tpu_torch as dt

        helpers: List[str] = []

        def rewrite(node):
            nonlocal df
            if not isinstance(node, ScalarSubquery):
                return None
            sub_sel = node.select
            self._scalar_counter += 1
            n = self._scalar_counter
            alias = f"__scalar_{n}__"
            inner_df, inner_scope = self._inner_frame(sub_sel)
            pairs, remaining = self._split_correlation(sub_sel, inner_df, inner_scope, df,
                                                       scope)
            if not pairs:
                sub_df = self._sub().plan(sub_sel)
                first = sub_df.column_names[0]
                # SQL's scalar semantics: more than one row is an error, none
                # binds null; materialized (a scalar) to enforce both
                probe = sub_df.select(col(first).alias(alias)).limit(2).collect()
                vals = probe.to_pydict()[alias]
                if len(vals) > 1:
                    raise ValueError("scalar subquery returned more than one row")
                one = dt.from_pydict({alias: [vals[0] if vals else None]})
                df = df.join(one.select(col(alias).cast(probe.schema[alias].dtype)),
                             how="cross")
                helpers.append(alias)
                return ColumnRef(alias)
            if len(sub_sel.items) != 1 or sub_sel.items[0].expr is None:
                raise NotImplementedError(
                    "correlated scalar subquery must select exactly one expression")
            if sub_sel.group_by or sub_sel.having is not None:
                raise NotImplementedError("correlated scalar subquery with GROUP BY/HAVING")
            if sub_sel.limit is not None or sub_sel.offset:
                raise NotImplementedError(
                    "correlated scalar subquery with LIMIT/OFFSET (ORDER BY ... LIMIT 1 "
                    "idiom): rewrite as MAX/MIN")
            if not _contains_agg(sub_sel.items[0].expr):
                raise NotImplementedError(
                    "correlated scalar subquery must select a single aggregate")
            key_aliases = [f"__sk_{n}_{i}__" for i in range(len(pairs))]
            items = [SelectItem(inner_ref, None) for inner_ref, _o in pairs]
            items.append(SelectItem(sub_sel.items[0].expr, alias))
            sub2 = dataclasses.replace(sub_sel, items=items, where=remaining,
                                       group_by=list(range(1, len(pairs) + 1)), order_by=[],
                                       limit=None, offset=None, distinct=False)
            sub_df = self._sub().plan(sub2)
            names = sub_df.column_names  # the group keys in order, then the aggregate
            sub_df = sub_df.select(*[col(names[i]).alias(key_aliases[i])
                                     for i in range(len(pairs))],
                                   col(names[-1]).alias(alias))
            df = df.join(sub_df, left_on=[self._resolve_expr(o, scope) for _i, o in pairs],
                         right_on=[col(a) for a in key_aliases], how="left")
            helpers.extend(key_aliases)
            helpers.append(alias)
            return ColumnRef(alias)

        new = expr.transform(rewrite)
        return df, new, helpers

    def _resolve_expr(self, e: Expression, scope: Scope) -> Expression:
        def rewrite(node):
            if isinstance(node, ColumnRef) and "." in node._name:
                return ColumnRef(scope.resolve(node._name))
            return None

        return e.transform(rewrite)

    # ---- the select ---------------------------------------------------------------
    def plan(self, sel: Select):
        planner = self
        if sel.ctes:
            planner = self._sub()
            for name, sub in sel.ctes.items():
                planner.cte_frames[name] = planner._sub().plan(sub)
        if sel.set_ops:
            raise NotImplementedError(
                f"the SQL set operation {sel.set_ops[0][0].upper()} is not ported yet: it "
                f"needs the Concat plan node, which comes with {EXPRESSIONS}")
        df = planner._plan_core(sel)
        return planner._apply_order_limit(df, sel)

    def _plan_core(self, sel: Select):
        import daft_tpu_torch as dt

        scope = Scope()
        if sel.from_table is None:
            if any(it.wildcard for it in sel.items):
                raise ValueError("SELECT * requires a FROM clause")
            df = dt.from_pydict({"__dummy__": [1]})  # SELECT without FROM: one row
        else:
            df = self._plan_factor(sel.from_table, scope)
        for j in sel.joins:
            df = self._plan_join(df, j, scope)
        if sel.where is not None:
            df = self._apply_where(df, sel.where, scope)

        items: List[SelectItem] = []
        for it in sel.items:
            if it.wildcard:
                for c in (scope.columns_of(it.qualifier) if it.qualifier else df.column_names):
                    items.append(SelectItem(col(c), None))
            else:
                items.append(SelectItem(self._resolve_expr(it.expr, scope), it.alias))

        has_agg = any(_contains_agg(it.expr) for it in items)
        if sel.grouping_sets is not None:
            raise NotImplementedError(
                "ROLLUP / CUBE / GROUPING SETS are not ported yet: they union one "
                f"aggregate per key set through the Concat plan node ({EXPRESSIONS})")
        if sel.group_by or has_agg or sel.having is not None:
            df = self._plan_aggregate(df, sel, items, scope)
        else:
            # ORDER BY may read source columns the projection drops (SQL's
            # scoping allows it): sort before projecting then
            if sel.order_by:
                out_names = {it.alias or it.expr.name() for it in items}
                in_names = set(df.column_names)
                needs_presort = any(
                    not isinstance(o.expr, int)
                    and any(c not in out_names
                            for c in self._resolve_expr(o.expr, scope).referenced_columns())
                    for o in sel.order_by)
                if needs_presort:
                    alias_map = {it.alias: it.expr for it in items if it.alias}
                    keys, descs, nfs = [], [], []
                    for o in sel.order_by:
                        if isinstance(o.expr, int):
                            e = items[o.expr - 1].expr
                        else:
                            e = self._substitute_aliases(self._resolve_expr(o.expr, scope),
                                                         alias_map, in_names)
                        keys.append(e)
                        descs.append(o.desc)
                        nfs.append(o.nulls_first if o.nulls_first is not None else o.desc)
                    df = df.sort(keys, descs, nfs)
                    sel.order_by = []
            df = df.select(*[self._item_expr(it) for it in items])
        if sel.distinct:
            df = df.distinct()
        return df

    def _substitute_aliases(self, e: Expression, alias_map: Dict[str, Expression],
                            in_names) -> Expression:
        def rw(node):
            if isinstance(node, ColumnRef) and node._name not in in_names \
                    and node._name in alias_map:
                return alias_map[node._name]
            return None

        return e.transform(rw)

    def _item_expr(self, it: SelectItem) -> Expression:
        return it.expr.alias(it.alias) if it.alias else it.expr

    # ---- joins --------------------------------------------------------------------
    def _plan_join(self, left_df, j: JoinClause, scope: Scope):
        right_scope = Scope()
        right_df = self._plan_factor(j.factor, right_scope)

        if j.kind == "cross":
            out = left_df.join(right_df, how="cross")
            self._merge_scope_after_join(scope, right_scope, left_df, set())
            return out
        if j.kind in ("right", "outer"):
            raise NotImplementedError(
                f"{'RIGHT' if j.kind == 'right' else 'FULL OUTER'} JOIN is not ported yet: "
                f"the host join has inner, left, semi, anti and cross ({EXPRESSIONS})")

        residual: Optional[Expression] = None
        if j.using:
            left_on = [col(c) for c in j.using]
            right_on = [col(c) for c in j.using]
        elif j.on is not None:
            left_on, right_on, residual = self._extract_equi_keys(j.on, scope, right_scope,
                                                                  left_df, right_df)
            if not left_on:
                if j.kind != "inner":
                    raise ValueError("non-equi join conditions only supported for INNER JOIN")
                out = left_df.join(right_df, how="cross")
                self._merge_scope_after_join(scope, right_scope, left_df, set())
                return out.where(self._resolve_expr(j.on, scope))
            if residual is not None and j.kind != "inner":
                raise ValueError("residual join predicates only supported for INNER JOIN")
        else:
            raise ValueError("JOIN requires ON or USING")

        how = {"right_semi": "semi", "right_anti": "anti"}.get(j.kind, j.kind)
        if j.kind in ("right_semi", "right_anti"):
            out = right_df.join(left_df, left_on=right_on, right_on=left_on, how=how)
            scope.tables = right_scope.tables
            return out
        out = left_df.join(right_df, left_on=left_on, right_on=right_on, how=how)
        if how in ("semi", "anti"):
            return out
        merged = {r.name() for l, r in zip(left_on, right_on) if l.name() == r.name()}
        self._merge_scope_after_join(scope, right_scope, left_df, merged)
        if residual is not None:
            out = out.where(self._resolve_expr(residual, scope))
        return out

    def _merge_scope_after_join(self, scope: Scope, right_scope: Scope, left_df, merged_keys):
        left_names = set(left_df.column_names)
        for alias, m in right_scope.tables.items():
            scope.tables[alias] = {
                src: cur if cur in merged_keys or cur not in left_names else f"right.{cur}"
                for src, cur in m.items()}

    def _extract_equi_keys(self, on: Expression, lscope: Scope, rscope: Scope, left_df,
                           right_df):
        """An ON condition split into equi-join keys and a residual."""
        left_cols = set(left_df.column_names)
        right_cols = set(right_df.column_names)
        left_on: List[Expression] = []
        right_on: List[Expression] = []
        residual: Optional[Expression] = None

        def side_of(name: str) -> Optional[str]:
            if "." in name:
                t = name.split(".", 1)[0].lower()
                if t in lscope.tables:
                    return "l"
                if t in rscope.tables:
                    return "r"
                return None
            inl, inr = name in left_cols, name in right_cols
            if inl and not inr:
                return "l"
            if inr and not inl:
                return "r"
            return None

        for c in _split_and(on):
            matched = False
            if isinstance(c, BinaryOp) and c.op == "eq" \
                    and isinstance(c.left, ColumnRef) and isinstance(c.right, ColumnRef):
                l, r = c.left, c.right
                ls, rs = side_of(l._name), side_of(r._name)
                if ls == "l" and rs == "r":
                    left_on.append(ColumnRef(lscope.resolve(l._name)))
                    right_on.append(ColumnRef(rscope.resolve(r._name)))
                    matched = True
                elif ls == "r" and rs == "l":
                    left_on.append(ColumnRef(lscope.resolve(r._name)))
                    right_on.append(ColumnRef(rscope.resolve(l._name)))
                    matched = True
            if not matched:
                residual = c if residual is None else (residual & c)
        return left_on, right_on, residual

    # ---- aggregation --------------------------------------------------------------
    def _plan_aggregate(self, df, sel: Select, items: List[SelectItem], scope: Scope):
        # group-by entries (a position names a select item)
        group_exprs = [items[g - 1].expr if isinstance(g, int) else self._resolve_expr(g, scope)
                       for g in sel.group_by]

        # stable output names for the grouping expressions: a matching
        # select item's alias first, colliding derived names numbered
        item_alias_by_repr = {repr(it.expr): it.alias for it in items if it.alias}
        named_groups: List[Tuple[str, Expression]] = []
        used_names: set = set()
        for g in group_exprs:
            name = item_alias_by_repr.get(repr(g)) or g.name()
            if name in used_names:
                i = 1
                while f"{name}_{i}" in used_names:
                    i += 1
                name = f"{name}_{i}"
            used_names.add(name)
            named_groups.append((name, g))

        # the distinct aggregations of the select items, HAVING and ORDER BY
        agg_map: Dict[str, Tuple[str, AggExpr]] = {}

        def collect(e: Expression):
            for sub in e.walk():
                if isinstance(sub, AggExpr) and repr(sub) not in agg_map:
                    agg_map[repr(sub)] = (f"__agg_{len(agg_map)}", sub)

        for it in items:
            collect(it.expr)
        if sel.having is not None:
            collect(self._resolve_expr(sel.having, scope))
        for o in sel.order_by:
            if not isinstance(o.expr, int):
                collect(self._resolve_expr(o.expr, scope))

        aggs = [a.alias(internal) for internal, a in agg_map.values()]
        gb = [g.alias(n) for n, g in named_groups]
        df = df.groupby(*gb).agg(*aggs) if gb else df.agg(*aggs)

        group_names = {repr(g): n for n, g in named_groups}

        def replace(e: Expression) -> Expression:
            def rw(node):
                if isinstance(node, AggExpr):
                    return ColumnRef(agg_map[repr(node)][0])
                r = group_names.get(repr(node))
                if r is not None and not isinstance(node, ColumnRef):
                    return ColumnRef(r)
                return None

            return e.transform(rw)

        if sel.having is not None:
            df = df.where(replace(self._resolve_expr(sel.having, scope)))

        # ORDER BY rewritten in place, so _apply_order_limit sees plain columns
        for o in sel.order_by:
            if not isinstance(o.expr, int):
                o.expr = replace(self._resolve_expr(o.expr, scope))

        final = [replace(it.expr).alias(it.alias) if it.alias else replace(it.expr)
                 for it in items]
        out = df.select(*final)

        # ORDER BY may read internal aggregate columns the projection drops:
        # sort before dropping them then
        if any(not isinstance(o.expr, int) and any(
                isinstance(s, ColumnRef) and s._name.startswith("__agg_")
                for s in o.expr.walk()) for o in sel.order_by):
            keys, descs, nfs = [], [], []
            for o in sel.order_by:
                keys.append(o.expr if not isinstance(o.expr, int) else final[o.expr - 1])
                descs.append(o.desc)
                nfs.append(o.nulls_first if o.nulls_first is not None else o.desc)
            df = df.sort(keys, descs, nfs)
            out = df.select(*final)
            sel.order_by = []
        return out

    # ---- ORDER BY, LIMIT, OFFSET ------------------------------------------------------
    def _apply_order_limit(self, df, sel: Select):
        if sel.order_by:
            keys: List[Expression] = []
            descs: List[bool] = []
            nfs: List[bool] = []
            out_names = df.column_names
            for o in sel.order_by:
                keys.append(col(out_names[o.expr - 1]) if isinstance(o.expr, int) else o.expr)
                descs.append(o.desc)
                nfs.append(o.nulls_first if o.nulls_first is not None else o.desc)
            df = df.sort(keys, descs, nfs)
        if sel.offset is not None:
            df = df.offset(sel.offset)
        if sel.limit is not None:
            df = df.limit(sel.limit)
        return df
