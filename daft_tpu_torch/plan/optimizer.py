"""The rule-based logical optimizer (counterpart of daft_tpu/plan/optimizer.py).

``Optimizer.optimize`` runs the reference's rule batches in its order, each
rule applied bottom-up (``transform_up``) until a pass changes nothing or
the batch's pass limit is reached:

1. simplify (5 passes): expression simplification with literal folding
   through the host evaluator, trivial-filter removal, filter and limit
   merging, no-op projects dropped;
2. pushdowns (5 passes): a Filter over a cross join with cross-side
   equalities becomes an inner equi-join (SQL-92 comma lists), filters move
   below joins (side-local conjuncts, and a relaxed OR per side for a
   cross-side disjunction) and through column-only Projects, limits move
   below Projects; after the batch, the global column pruning
   (``prune_columns``) and the greedy join reorder
   (``reorder_joins_global``);
3. physical-prep (3 passes): Limit(Sort) and Limit(Offset(Sort)) become a
   TopN, the window expressions of a Project move into Window nodes below
   it, one per distinct spec (``rule_extract_windows``), and each UDF call
   in a Project is isolated into a UDFProject of its own
   (``rule_split_udfs``). A filter conjunct holding a UDF stays above a
   join and above a Project, and a Limit stays above a Project holding one.

``DataFrame.collect`` optimizes every plan before ``translate``, as the
reference's does; nothing is cached between collects.

The scan rules (``rule_push_filter_into_scan``, which keeps the Filter
above the scan; ``rule_push_limit_into_scan``; ``rule_column_pruning``)
and ``_prune``'s ScanSource branch attach a ``ScanSource``'s pushdowns.
Column pruning passes a Window by (its input keeps every column), as the
reference's does.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from ..expressions.expressions import (Alias, BinaryOp, ColumnRef, Expression, IfElse,
                                       Literal, UnaryOp, col)
from . import logical as lp

Rule = Callable[[lp.LogicalPlan], Optional[lp.LogicalPlan]]


class RuleBatch:
    def __init__(self, name: str, rules: List[Rule], max_passes: int = 5):
        self.name = name
        self.rules = rules
        self.max_passes = max_passes


class Optimizer:
    def __init__(self, config=None):
        self.config = config
        self.batches = default_rule_batches(config)

    def optimize(self, plan: lp.LogicalPlan) -> lp.LogicalPlan:
        for batch in self.batches:
            for _ in range(batch.max_passes):
                changed = False
                for rule in batch.rules:
                    new = plan.transform_up(rule)
                    if new is not plan:
                        plan = new
                        changed = True
                if not changed:
                    break
            if batch.name == "pushdowns":
                # the global projection pushdown once the filters have
                # settled, then the join reorder (top-down, so each maximal
                # inner-join chain is reordered once, at its root)
                plan = prune_columns(plan)
                plan = reorder_joins_global(plan)
        return plan


# ======================================================================================
# expression simplification
# ======================================================================================


_MISSING = object()


def simplify_expr(e: Expression, schema=None) -> Expression:
    """Conservative rewrites that keep null semantics, bottom-up: literal
    folding (<lit> op <lit> evaluated at plan time), x+0, 0+x, x-0, x*1,
    1*x -> x, Kleene TRUE AND e -> e, FALSE AND e -> FALSE, FALSE OR e -> e,
    TRUE OR e -> TRUE, NOT NOT e -> e, NOT <bool lit>, and an if_else with a
    literal predicate picks its branch (a null one gives a typed null).
    x*0 is not rewritten: nulls must propagate. With a schema, a rewrite
    that would change the expression's output dtype is refused."""

    def lit_val(x):
        return x.value if isinstance(x, Literal) else _MISSING

    def is_num(x, v):
        lv = lit_val(x)
        return isinstance(lv, (int, float)) and not isinstance(lv, bool) and lv == v

    def rewrite(node):
        out = _rewrite(node)
        if out is None or schema is None:
            return out
        try:
            if out.to_field(schema).dtype != node.to_field(schema).dtype:
                return None
        except (KeyError, ValueError, TypeError):  # untypeable rewrite: keep the original
            return None
        return out

    def _rewrite(node):
        if isinstance(node, BinaryOp):
            l, r = node.left, node.right
            if isinstance(l, Literal) and isinstance(r, Literal) \
                    and node.op not in ("and", "or"):
                folded = _fold_literal_binop(node)
                if folded is not None:
                    return folded
            if node.op == "add":
                if is_num(r, 0):
                    return l
                if is_num(l, 0):
                    return r
            elif node.op == "sub" and is_num(r, 0):
                return l
            elif node.op == "mul":
                if is_num(r, 1):
                    return l
                if is_num(l, 1):
                    return r
            elif node.op == "and":
                if lit_val(l) is True:
                    return r
                if lit_val(r) is True:
                    return l
                if lit_val(l) is False or lit_val(r) is False:
                    return Literal(False)
            elif node.op == "or":
                if lit_val(l) is False:
                    return r
                if lit_val(r) is False:
                    return l
                if lit_val(l) is True or lit_val(r) is True:
                    return Literal(True)
        elif isinstance(node, UnaryOp) and node.op == "not":
            c = node.child
            if isinstance(c, UnaryOp) and c.op == "not":
                return c.child
            if isinstance(lit_val(c), bool):
                return Literal(not c.value)
        elif isinstance(node, IfElse):
            pv = lit_val(node.predicate)
            if pv is True:
                return node.if_true
            if pv is False:
                return node.if_false
            if pv is None and schema is not None:
                try:
                    return Literal(None).cast(node.to_field(schema).dtype)
                except (KeyError, ValueError, TypeError):
                    return None
        return None

    return e.transform(rewrite)


def _fold_literal_binop(node: BinaryOp) -> Optional[Expression]:
    """<lit> op <lit> evaluated by the host evaluator (the engine's own
    semantics); None when the result's dtype would not survive as a
    literal or the evaluation refuses."""
    from ..core.recordbatch import RecordBatch
    from ..expressions.eval import eval_expression

    try:
        s = eval_expression(RecordBatch.from_pydict({"__x__": [0]}), node)
        vals = s.to_pylist()
        if len(vals) != 1:
            return None
        out = Literal(vals[0])
    except (KeyError, ValueError, TypeError, ArithmeticError):
        return None
    if out.dtype != s.dtype and not out.dtype.is_null():
        return None  # e.g. an int literal for a float result
    return out


# ======================================================================================
# rules
# ======================================================================================


def rule_simplify_expressions(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """simplify_expr over Filter predicates and Project expressions."""
    if isinstance(node, lp.Filter):
        new = simplify_expr(node.predicate, node.input.schema)
        if repr(new) != repr(node.predicate):
            return lp.Filter(node.input, new)
        return None
    if isinstance(node, lp.Project):
        new_exprs = []
        changed = False
        for e in node.projection:
            ne = simplify_expr(e, node.input.schema)
            if repr(ne) != repr(e):
                changed = True
                if ne.name() != e.name():
                    ne = ne.alias(e.name())  # output names are part of the schema
            new_exprs.append(ne)
        return lp.Project(node.input, new_exprs) if changed else None
    return None


def rule_drop_trivial_filter(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """Filter(lit(True)) -> its input."""
    if isinstance(node, lp.Filter) and node.predicate.is_literal_true():
        return node.input
    return None


def rule_merge_filters(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """Filter(Filter(x, a), b) -> Filter(x, a & b), dropping repeated
    conjuncts (derived OR filters could otherwise stack copies)."""
    if isinstance(node, lp.Filter) and isinstance(node.input, lp.Filter):
        seen = set()
        uniq = []
        for c in _split_conjuncts(node.input.predicate) + _split_conjuncts(node.predicate):
            r = repr(c)
            if r not in seen:
                seen.add(r)
                uniq.append(c)
        return lp.Filter(node.input.input, _and_all(uniq))
    return None


def rule_merge_limits(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    if isinstance(node, lp.Limit) and isinstance(node.input, lp.Limit):
        return lp.Limit(node.input.input, min(node.limit, node.input.limit))
    return None


def rule_push_filter_into_scan(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """A Filter over a ScanSource that absorbs filters: the predicate joins
    the scan's pushdowns. The Filter stays above the scan (a scan may apply
    its pushed filter only approximately, as zone maps do; translate reads
    each task's ``filters_applied``), so an idempotence check stops the
    rule once the predicate is pushed."""
    if not (isinstance(node, lp.Filter) and isinstance(node.input, lp.ScanSource)):
        return None
    scan = node.input
    if not scan.scan_op.can_absorb_filter():
        return None
    pd = scan.pushdowns
    if pd.filters is not None and repr(pd.filters) == repr(node.predicate):
        return None
    from ..io.scan import Pushdowns

    new_filters = pd.filters & node.predicate if pd.filters is not None else node.predicate
    new_scan = lp.ScanSource(scan.scan_op, Pushdowns(pd.columns, new_filters, pd.limit))
    return lp.Filter(new_scan, new_filters)


def rule_push_limit_into_scan(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """A Limit over a filterless ScanSource: the limit joins its pushdowns
    (the Limit stays above it)."""
    if not (isinstance(node, lp.Limit) and isinstance(node.input, lp.ScanSource)):
        return None
    scan = node.input
    pd = scan.pushdowns
    if pd.filters is not None:
        return None  # a limit after a filter cannot go below it
    if pd.limit is not None and pd.limit <= node.limit:
        return None
    from ..io.scan import Pushdowns

    return lp.Limit(lp.ScanSource(scan.scan_op, Pushdowns(pd.columns, pd.filters,
                                                            node.limit)), node.limit)


def rule_column_pruning(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """A Project over a ScanSource that needs fewer columns than the scan
    yields: the columns it (and the pushed filter) reads become the scan's
    columns pushdown, in the source's order."""
    if not (isinstance(node, lp.Project) and isinstance(node.input, lp.ScanSource)):
        return None
    scan = node.input
    needed: List[str] = []
    exprs = list(node.projection)
    if scan.pushdowns.filters is not None:
        exprs.append(scan.pushdowns.filters)
    for e in exprs:
        for c in e.referenced_columns():
            if c not in needed:
                needed.append(c)
    wanted = set(needed)
    needed = [c for c in scan.scan_op.schema().column_names() if c in wanted]
    if len(needed) >= len(scan.schema.column_names()):
        return None
    from ..io.scan import Pushdowns

    pd = scan.pushdowns
    return lp.Project(lp.ScanSource(scan.scan_op, Pushdowns(needed, pd.filters, pd.limit)),
                      node.projection)


def _split_conjuncts(e: Expression) -> List[Expression]:
    if isinstance(e, BinaryOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _split_disjuncts(e: Expression) -> List[Expression]:
    if isinstance(e, BinaryOp) and e.op == "or":
        return _split_disjuncts(e.left) + _split_disjuncts(e.right)
    return [e]


def _and_all(exprs: List[Expression]) -> Expression:
    out = exprs[0]
    for e in exprs[1:]:
        out = out & e
    return out


def _or_all(exprs: List[Expression]) -> Expression:
    out = exprs[0]
    for e in exprs[1:]:
        out = out | e
    return out


def _rename_refs(e: Expression, mapping) -> Expression:
    def rewrite(x: Expression) -> Optional[Expression]:
        if isinstance(x, ColumnRef) and x._name in mapping:
            return col(mapping[x._name])
        return None

    return e.transform(rewrite)


def _existing_conjunct_reprs(node: lp.LogicalPlan) -> set:
    """The conjuncts already filtering this subtree, looking through Projects
    (rule_push_filter_through_project may have put one between the join and
    a filter derived earlier)."""
    out: set = set()
    while True:
        if isinstance(node, lp.Filter):
            out |= {repr(c) for c in _split_conjuncts(node.predicate)}
            node = node.input
        elif isinstance(node, lp.Project):
            node = node.input
        else:
            return out


def rule_cross_join_to_inner(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """Filter(cross join) with cross-side column equalities -> an inner
    equi-join under a Filter of the other conjuncts (the SQL-92 comma list's
    join recovered). Only when every key pair has distinct names, so the
    inner join merges nothing and the output schema stays the same."""
    if not (isinstance(node, lp.Filter) and isinstance(node.input, lp.Join)
            and node.input.how == "cross"):
        return None
    join = node.input
    left_names = set(join.left.schema.column_names())
    _merged, right_rename = join.output_naming()
    right_out_to_src = {right_rename.get(n, n): n for n in join.right.schema.column_names()}

    keys, rest = [], []
    for c in _split_conjuncts(node.predicate):
        if isinstance(c, BinaryOp) and c.op == "eq" \
                and isinstance(c.left, ColumnRef) and isinstance(c.right, ColumnRef):
            ln, rn = c.left._name, c.right._name
            if ln in left_names and rn in right_out_to_src and rn not in left_names:
                keys.append((ln, right_out_to_src[rn]))
                continue
            if rn in left_names and ln in right_out_to_src and ln not in left_names:
                keys.append((rn, right_out_to_src[ln]))
                continue
        rest.append(c)
    if not keys or any(l == r for l, r in keys):
        return None
    inner = lp.Join(join.left, join.right, [col(l) for l, _ in keys],
                    [col(r) for _, r in keys], "inner", join.prefix, join.suffix)
    if set(inner.schema.column_names()) != set(join.schema.column_names()):
        return None  # the renaming diverged: keep the cross join
    return lp.Filter(inner, _and_all(rest)) if rest else inner


def rule_push_filter_through_join(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """Filter(Join) -> side-local conjuncts below the join, and a derived
    relaxed OR per side for a cross-side disjunction.

    - inner and cross: a conjunct over one side's columns moves to that side;
    - left: only the preserved (left) side takes pushes;
    - semi and anti: the output is the left's, every conjunct moves left;
    - a conjunct (A1 & B1) | (A2 & B2) | ... whose every disjunct has parts
      over one side pushes (A1 | A2 | ...) to that side as a derived filter
      (inner and cross joins only); the conjunct itself stays above the join
      (TPC-H q19's shape).
    """
    if not (isinstance(node, lp.Filter) and isinstance(node.input, lp.Join)):
        return None
    join = node.input
    left_cols = set(join.left.schema.column_names())
    merged_keys, right_rename = join.output_naming()
    # output name -> right-side name, for the columns the right side gives
    out_to_right = {}
    if join.how not in ("semi", "anti"):
        for c in join.right.schema.column_names():
            if c not in merged_keys:
                out_to_right[right_rename.get(c, c)] = c
    right_cols = set(out_to_right)

    push_left = join.how in ("inner", "cross", "left", "semi", "anti")
    push_right = join.how in ("inner", "cross")

    left_push: List[Expression] = []
    right_push: List[Expression] = []
    remaining: List[Expression] = []
    derived_left: List[Expression] = []
    derived_right: List[Expression] = []

    for conj in _split_conjuncts(node.predicate):
        if conj.has_udf():  # a UDF runs above the join, on the rows it gives
            remaining.append(conj)
            continue
        refs = set(conj.referenced_columns())
        if refs <= left_cols and push_left:
            left_push.append(conj)
            continue
        if refs <= right_cols and push_right:
            right_push.append(_rename_refs(conj, out_to_right))
            continue
        remaining.append(conj)
        # a derived filter on one side must not change which preserved rows
        # a left join null-extends: inner and cross joins only
        if join.how not in ("inner", "cross"):
            continue
        disjuncts = _split_disjuncts(conj)
        if len(disjuncts) < 2:
            continue
        for side, target in (("l", derived_left), ("r", derived_right)):
            per_disjunct = []
            for d in disjuncts:
                side_parts = []
                for p in _split_conjuncts(d):
                    prefs = set(p.referenced_columns())
                    if p.has_udf():
                        continue
                    if side == "l" and prefs <= left_cols:
                        side_parts.append(p)
                    elif side == "r" and prefs <= right_cols:
                        side_parts.append(_rename_refs(p, out_to_right))
                if not side_parts:
                    per_disjunct = None
                    break
                per_disjunct.append(_and_all(side_parts))
            if per_disjunct:
                target.append(_or_all(per_disjunct))

    # derived filters stay above too, so do not derive them again each pass
    left_existing = _existing_conjunct_reprs(join.left)
    right_existing = _existing_conjunct_reprs(join.right)
    derived_left = [e for e in derived_left if repr(e) not in left_existing]
    derived_right = [e for e in derived_right if repr(e) not in right_existing]

    if not (left_push or right_push or derived_left or derived_right):
        return None
    new_left = join.left
    if left_push or derived_left:
        new_left = lp.Filter(new_left, _and_all(left_push + derived_left))
    new_right = join.right
    if right_push or derived_right:
        new_right = lp.Filter(new_right, _and_all(right_push + derived_right))
    new_join = lp.Join(new_left, new_right, join.left_on, join.right_on, join.how,
                       join.prefix, join.suffix, join.strategy, join.null_equals_null)
    return lp.Filter(new_join, _and_all(remaining)) if remaining else new_join


def rule_push_filter_through_project(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """Filter(Project) -> Project(Filter) when every projection output the
    predicate reads is a column or an alias of one."""
    if not (isinstance(node, lp.Filter) and isinstance(node.input, lp.Project)):
        return None
    proj = node.input
    mapping = {}
    for e in proj.projection:
        inner = e
        while isinstance(inner, Alias):
            inner = inner.child
        if isinstance(inner, ColumnRef):
            mapping[e.name()] = inner._name
    if node.predicate.has_udf():
        return None
    if not set(node.predicate.referenced_columns()) <= set(mapping):
        return None
    return lp.Project(lp.Filter(proj.input, _rename_refs(node.predicate, mapping)),
                      proj.projection)


def rule_push_limit_through(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """Limit(Project) -> Project(Limit): a Project keeps the row count (one
    holding a UDF stays above, as in the reference)."""
    if isinstance(node, lp.Limit) and isinstance(node.input, lp.Project):
        proj = node.input
        if not any(e.has_udf() for e in proj.projection):
            return lp.Project(lp.Limit(proj.input, node.limit), proj.projection)
    return None


def rule_detect_topn(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """Limit(Sort) -> TopN and Limit(Offset(Sort)) -> TopN."""
    if isinstance(node, lp.Limit) and isinstance(node.input, lp.Sort):
        s = node.input
        return lp.TopN(s.input, s.sort_by, s.descending, s.nulls_first, node.limit)
    if (isinstance(node, lp.Limit) and isinstance(node.input, lp.Offset)
            and isinstance(node.input.input, lp.Sort)):
        s = node.input.input
        return lp.TopN(s.input, s.sort_by, s.descending, s.nulls_first,
                       node.limit, node.input.offset)
    return None


def _projection_is_passthrough(projection: List[Expression], input_schema) -> bool:
    names = input_schema.column_names()
    if len(projection) != len(names):
        return False
    return all(isinstance(e, ColumnRef) and e._name == n for e, n in zip(projection, names))


def _contains_device_udf(expr: Expression) -> bool:
    """True when a UDF call inside ``expr`` is a device Func (a structural
    check: it imports nothing of the device tier)."""
    from ..udf.expr import UdfCall

    return any(isinstance(sub, UdfCall) and sub.func.on_device for sub in expr.walk())


def rule_split_udfs(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """Isolate each UDF-bearing expression of a Project into a UDFProject of
    its own, stacked, so opaque Python never breaks a device stage's fusion.
    Every UDF is extracted in one application; each output gets an internal
    name (``__udf__<name>``, prefixed with "_" while taken) that a Project
    above renames back, so a sibling reading an input of the same name is
    unaffected. A lone host-UDF projection stays as it is (isolation gains
    nothing); a lone device-UDF one is split all the same, so the planner
    can take it to the device tier."""
    if not isinstance(node, lp.Project):
        return None
    udf_exprs = [e for e in node.projection if e.has_udf()]
    if not udf_exprs:
        return None
    if len(node.projection) == len(udf_exprs) == 1 \
            and not _contains_device_udf(udf_exprs[0]):
        return None
    current = node.input
    projection = list(node.projection)
    for target in udf_exprs:
        out_name = target.name()
        input_cols = current.schema.column_names()
        taken = set(input_cols) | {e.name() for e in projection}
        internal = f"__udf__{out_name}"
        while internal in taken:
            internal = "_" + internal
        current = lp.UDFProject(current, target.alias(internal),
                                [col(c) for c in input_cols])
        projection = [col(internal).alias(out_name) if e is target else e
                      for e in projection]
    return lp.Project(current, projection)


def rule_drop_noop_project(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    if isinstance(node, lp.Project) and \
            _projection_is_passthrough(node.projection, node.input.schema):
        return node.input
    return None


# ======================================================================================
# column pruning
# ======================================================================================


def _ordered_union(*col_lists) -> List[str]:
    out: List[str] = []
    for cols in col_lists:
        for c in cols:
            if c not in out:
                out.append(c)
    return out


def _refs(exprs) -> List[str]:
    out: List[str] = []
    for e in exprs:
        for c in e.referenced_columns():
            if c not in out:
                out.append(c)
    return out


def prune_columns(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    """The global projection pushdown: walk top-down with the columns each
    operator's consumers need, narrow every in-memory source with a
    column-only Project, and prune both sides of each join (the right
    side's renames accounted for). A Filter whose consumers need fewer
    columns than its predicate reads gets a ``keep``."""
    return _prune(plan, None)


def _restrict(needed: Optional[List[str]], schema) -> Optional[List[str]]:
    """``needed`` intersected with a schema, in schema order; never empty
    (row counts must survive); None passes through."""
    if needed is None:
        return None
    names = schema.column_names()
    keep = [c for c in names if c in set(needed)]
    return keep or names[:1]


def _prune(node: lp.LogicalPlan, needed: Optional[List[str]]) -> lp.LogicalPlan:
    if isinstance(node, lp.InMemorySource):
        keep = _restrict(needed, node.schema)
        if keep is not None and len(keep) < len(node.schema.column_names()):
            return lp.Project(node, [col(c) for c in keep])
        return node

    if isinstance(node, lp.ScanSource):
        base_cols = node.schema.column_names()
        pd = node.pushdowns
        want = _restrict(_ordered_union(needed if needed is not None else base_cols,
                                        _refs([pd.filters]) if pd.filters is not None
                                        else []),
                         node.schema)
        if needed is not None and want is not None and len(want) < len(base_cols):
            from ..io.scan import Pushdowns

            return lp.ScanSource(node.scan_op, Pushdowns(want, pd.filters, pd.limit))
        return node

    if isinstance(node, lp.Project):
        proj = node.projection
        if needed is not None:
            proj = [e for e in proj if e.name() in set(needed)] or node.projection[:1]
        return lp.Project(_prune(node.input, _refs(proj)), proj)

    if isinstance(node, lp.UDFProject):
        passthrough = node.passthrough
        if needed is not None:
            passthrough = [e for e in passthrough if e.name() in set(needed)]
        child = _prune(node.input, _ordered_union(_refs([node.udf_expr]), _refs(passthrough)))
        return lp.UDFProject(child, node.udf_expr, passthrough)

    if isinstance(node, lp.Filter):
        child = _prune(node.input, None if needed is None
                       else _ordered_union(needed, _refs([node.predicate])))
        # consumers need fewer columns than the predicate reads: the filter
        # materializes only those (predicate-only columns are masked over
        # but never gathered into the output)
        keep = None
        if needed is not None:
            names = child.schema.column_names()
            k = [c for c in names if c in set(needed)] or names[:1]
            if len(k) < len(names):
                keep = k
        return lp.Filter(child, node.predicate, keep)

    if isinstance(node, (lp.Limit, lp.Offset, lp.Sample, lp.IntoBatches, lp.IntoPartitions)):
        return node.with_children([_prune(node.input, needed)])

    if isinstance(node, lp.Explode):
        # the exploded columns are read whatever the parent needs
        child_needed = None if needed is None else _ordered_union(needed,
                                                                  _refs(node.to_explode))
        return node.with_children([_prune(node.input, child_needed)])

    if isinstance(node, lp.MonotonicallyIncreasingId):
        child_needed = None if needed is None else [c for c in needed if c != node.column_name]
        return node.with_children([_prune(node.input, child_needed)])

    if isinstance(node, lp.Repartition):
        child_needed = None if needed is None else _ordered_union(needed, _refs(node.by))
        return node.with_children([_prune(node.input, child_needed)])

    if isinstance(node, lp.Distinct):
        child_needed = None if needed is None or node.on is None \
            else _ordered_union(needed, _refs(node.on))
        return node.with_children([_prune(node.input, child_needed)])

    if isinstance(node, (lp.Sort, lp.TopN)):
        child_needed = None if needed is None else _ordered_union(needed, _refs(node.sort_by))
        return node.with_children([_prune(node.input, child_needed)])

    if isinstance(node, lp.Aggregate):
        child = _prune(node.input, _ordered_union(_refs(node.groupby),
                                                  _refs(node.aggregations)))
        return lp.Aggregate(child, node.groupby, node.aggregations)

    if isinstance(node, lp.Concat):
        return node.with_children([_prune(c, needed) for c in node.inputs])

    if isinstance(node, lp.Join):
        left_names = node.left.schema.column_names()
        right_names = node.right.schema.column_names()
        merged_keys, right_rename = node.output_naming()
        if needed is None:
            left_needed = right_needed = None
        else:
            left_needed = _ordered_union([c for c in needed if c in set(left_names)],
                                         _refs(node.left_on))
            if node.how in ("anti", "semi"):
                right_needed = _refs(node.right_on)
            else:
                out_to_right = {right_rename.get(c, c): c for c in right_names
                                if c not in merged_keys}
                right_needed = _ordered_union(
                    [out_to_right[c] for c in needed if c in out_to_right],
                    _refs(node.right_on))
        return lp.Join(_prune(node.left, left_needed), _prune(node.right, right_needed),
                       node.left_on, node.right_on, node.how, node.prefix, node.suffix,
                       node.strategy, node.null_equals_null)

    return node.with_children([_prune(c, None) for c in node.children()])


# ======================================================================================
# join reorder
# ======================================================================================


def reorder_joins_global(plan: lp.LogicalPlan) -> lp.LogicalPlan:
    """Reorder each maximal inner-join chain at its root, then recurse into
    the chain's relations (nested chains under aggregates, filters and the
    like get their own reorder)."""
    if _plain_inner_join(plan):
        rewritten = _reorder_join_chain(plan)
        target = rewritten if rewritten is not None else plan

        def recurse_spine(n):
            # walk the join spine; recurse into its relations only
            if _plain_inner_join(n):
                kids = [recurse_spine(c) for c in n.children()]
                if all(k is o for k, o in zip(kids, n.children())):
                    return n
                return n.with_children(kids)
            return reorder_joins_global(n)

        if isinstance(target, lp.Project):
            return target.with_children([recurse_spine(target.input)])
        return recurse_spine(target)
    children = plan.children()
    if not children:
        return plan
    new_children = [reorder_joins_global(c) for c in children]
    if all(n is o for n, o in zip(new_children, children)):
        return plan
    return plan.with_children(new_children)


def _reorder_join_chain(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """The greedy cost-based reorder of one chain of plain inner equi-joins
    (no strategy, no prefix or suffix, column keys): start from the smallest
    estimated relation, then add the connected relation whose own size plus
    join result is smallest. Rewrites only on a clear predicted win (the new
    order's cost under half the old's), wrapped in a Project that restores
    the column order; None leaves the chain as it is."""
    from .stats import estimate_distinct, estimate_rows

    if not _plain_inner_join(node):
        return None
    rels: List[lp.LogicalPlan] = []
    conds: List[tuple] = []  # (name_a, name_b)

    def flatten(j) -> bool:
        for lo, ro in zip(j.left_on, j.right_on):
            a, b = _bare_name(lo), _bare_name(ro)
            if a is None or b is None:
                return False
            conds.append((a, b))
        for side in (j.left, j.right):
            if _plain_inner_join(side):
                if not flatten(side):
                    return False
            else:
                rels.append(side)
        return True

    if not flatten(node) or len(rels) < 3:
        return None

    # column name -> owning relations. A same-named join key lives in
    # several relations and merges at each join; any other ambiguity bails
    owners: dict = {}
    for i, r in enumerate(rels):
        for name in r.schema.column_names():
            owners.setdefault(name, []).append(i)
    for a, b in conds:
        if a not in owners or b not in owners:
            return None
        if a != b and (len(owners[a]) != 1 or len(owners[b]) != 1):
            return None
    for name, ow in owners.items():
        if len(ow) > 1 and not any(a == b == name for a, b in conds):
            return None

    est = []
    for r in rels:
        e = estimate_rows(r)
        if e is None:
            return None
        est.append(e)
    # Selinger V(R, a) for every join-key column of each owning relation
    v: dict = {}
    for a, b in conds:
        for name in (a, b):
            for i in owners[name]:
                if (i, name) not in v:
                    v[(i, name)] = estimate_distinct(rels[i], name)

    def join_est(cur_rows, cur_v, i):
        """Estimated rows of joining relation i into the current set, over
        every condition that applies (independence); None when i is not
        connected."""
        out = cur_rows * est[i]
        found = False
        rc = set(rels[i].schema.column_names())
        for a, b in conds:
            sides = None
            if a in cur_v and b in rc:
                sides = (cur_v.get(a), v.get((i, b)))
            elif b in cur_v and a in rc:
                sides = (cur_v.get(b), v.get((i, a)))
            if sides is None:
                continue
            found = True
            vl = sides[0] if sides[0] is not None else cur_rows
            vr = sides[1] if sides[1] is not None else est[i]
            out = out / max(vl, vr, 1.0)
        return max(out, 1.0) if found else None

    def start(first):
        return est[first], {name: v.get((first, name)) for (i, name) in v if i == first}

    def absorb(cur_v, nxt, res):
        for (j, name), val in v.items():
            if j == nxt:
                cur_v[name] = val
        # a join shrinks each column's distinct count to at most its rows
        return {n: (min(x, res) if x is not None else None) for n, x in cur_v.items()}

    def simulate(order):
        """A join order's cost: each step pays its input sizes (build and
        probe are linear in the rows) plus its intermediate result; the final
        result is the same for every order, so only its inputs count."""
        cur_rows, cur_v = start(order[0])
        cost = 0.0
        for step, i in enumerate(order[1:]):
            res = join_est(cur_rows, cur_v, i)
            if res is None:
                return None
            cost += cur_rows + est[i]
            if step < len(order) - 2:
                cost += res
            cur_v = absorb(cur_v, i, res)
            cur_rows = res
        return cost

    order = [min(range(len(rels)), key=lambda i: (est[i], i))]
    placed = {order[0]}
    cur_rows, cur_v = start(order[0])
    while len(placed) < len(rels):
        best = None
        for i in range(len(rels)):
            if i in placed:
                continue
            res = join_est(cur_rows, cur_v, i)
            if res is None:
                continue
            step_cost = est[i] + res
            if best is None or step_cost < best[0] or (step_cost == best[0] and i < best[1]):
                best = (step_cost, i, res)
        if best is None:
            return None  # disconnected relations would need a cross join
        _cost, nxt, res = best
        order.append(nxt)
        placed.add(nxt)
        cur_v = absorb(cur_v, nxt, res)
        cur_rows = res

    current_order = list(range(len(rels)))  # flatten() lists a left-deep order
    if order == current_order:
        return None
    orig_cost, new_cost = simulate(current_order), simulate(order)
    if orig_cost is None or new_cost is None or new_cost >= 0.5 * orig_cost:
        return None

    cur = rels[order[0]]
    have = set(cur.schema.column_names())
    for i in order[1:]:
        r = rels[i]
        rcols = set(r.schema.column_names())
        left_on, right_on = [], []
        for a, b in conds:
            if a in have and b in rcols:
                left_on.append(col(a))
                right_on.append(col(b))
            elif b in have and a in rcols:
                left_on.append(col(b))
                right_on.append(col(a))
        cur = lp.Join(cur, r, left_on, right_on, "inner")
        have |= rcols
    if set(cur.schema.column_names()) != set(node.schema.column_names()):
        return None  # the merged-key set changed: keep the original plan
    return lp.Project(cur, [col(f.name) for f in node.schema])


def rule_extract_windows(node: lp.LogicalPlan) -> Optional[lp.LogicalPlan]:
    """Window expressions out of a Project into Window nodes under it (the
    reference's optimizer.py:762-800): one Window per distinct spec (by its
    ``repr``), each distinct window computation once, named
    ``__window_<i>``, and the Project reading those columns under the
    expressions' names."""
    if not isinstance(node, lp.Project):
        return None
    from ..expressions.expressions import WindowExpr

    found: List = []
    seen = set()
    for e in node.projection:
        for sub in e.walk():
            if isinstance(sub, WindowExpr) and id(sub) not in seen:
                seen.add(id(sub))
                found.append(sub)
    if not found:
        return None
    by_spec: dict = {}
    replacement: dict = {}
    for w in found:
        spec, ws = by_spec.setdefault(repr(w.spec), (w.spec, {}))
        key = (w.func, repr(w.child), repr(sorted(w.params.items(), key=str)))
        if key not in ws:
            ws[key] = (f"__window_{len(replacement)}", w)
        replacement[id(w)] = ws[key][0]
    input_node = node.input
    for spec, ws in by_spec.values():
        input_node = lp.Window(input_node, [w.alias(name) for name, w in ws.values()], spec)

    def rewrite(e: Expression) -> Optional[Expression]:
        if id(e) in replacement:
            return Alias(col(replacement[id(e)]), e.name())
        return None

    return lp.Project(input_node, [e.transform(rewrite) for e in node.projection])


def _plain_inner_join(n) -> bool:
    return (isinstance(n, lp.Join) and n.how == "inner" and n.strategy is None
            and n.prefix is None and n.suffix is None and not n.null_equals_null)


def _bare_name(e: Expression) -> Optional[str]:
    node = e.child if isinstance(e, Alias) else e
    return node._name if isinstance(node, ColumnRef) else None


def default_rule_batches(config=None) -> List[RuleBatch]:
    return [
        RuleBatch("simplify", [
            rule_simplify_expressions,
            rule_drop_trivial_filter,
            rule_merge_filters,
            rule_merge_limits,
            rule_drop_noop_project,
        ]),
        RuleBatch("pushdowns", [
            rule_cross_join_to_inner,
            rule_push_filter_through_join,
            rule_push_filter_through_project,
            rule_merge_filters,
            rule_push_filter_into_scan,
            rule_push_limit_through,
            rule_push_limit_into_scan,
            rule_column_pruning,
        ]),
        RuleBatch("physical-prep", [
            rule_detect_topn,
            rule_extract_windows,
            rule_split_udfs,
        ], max_passes=3),
    ]
