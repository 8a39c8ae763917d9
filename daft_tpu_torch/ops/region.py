"""Whole-stage device fusion: the fused-region capture for the planner
(counterpart of daft_tpu/ops/region.py).

A chain of Filter and Project operators under an Aggregate (any
interleaving, up to ``REGION_MAX_OPS``) collapses into one device stage by
substituting each operator's expressions into its consumers, until the
aggregate's predicate, group keys and aggregation children are expressions
over the chain's BASE input schema. The existing stage builders
(ops/stage.py, ops/grouped_stage.py) then turn those composed expressions
into one program: one upload of the base columns, one dispatch per
coalesced batch, one copy back at finalize, and no host operator between
the scan and the stage.

Substitution instead of a region node: the composed expressions are the
fused program, so everything downstream (the dispatch coalescer, the
residency cache keyed on the base Series, DeviceFallback's rerun of the
buffered region on the host) works unchanged, and the host path is
identical by construction: host evaluation is compositional, so
``sum((a*b)[p])`` over the base stream computes what
Project(a*b) -> Filter(p) -> Agg(sum) would.

What each candidate must hold:
- absorbed expressions hold no aggregation and no UDF call (a UDF ends the
  region at its UDFProject; a device UDF's stage then fuses with an
  ungrouped aggregate at run time, ops/udf_stage.py ``FusedUdfAggFeeder``);
- successive Filters AND-compose (Kleene: null AND true is null, which
  drops the row, as sequential filtering drops it at the first filter that
  is not true);
- every composed aggregation and group key is re-aliased to its output
  name and must type to its original dtype over the base schema, so the
  node's output schema is untouched;
- a candidate that fails a check gives way to a shorter chain, down to the
  shape planned without regions (the one Filter directly under the
  aggregate), never to a planning error.

Substitution copies a projected expression that several consumers read;
the device evaluates each copy (the reference leaves the duplicates to
XLA's CSE, which the port's eager torch program does not have), and so does
the host path.

A Filter with the pruning pass's ``keep`` narrows the mapping to those
columns, so a consumer above it cannot read a column it dropped.

Only the device_mode != "off" branch of the planner and the device nodes'
executor reach this module: a host-only query never imports it.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..expressions.expressions import AggExpr, Alias, BinaryOp, ColumnRef, Expression

# a longer region gains nothing (one dispatch is already amortized over the
# chain) and risks blowing up the expressions by repeated substitution
REGION_MAX_OPS = 8


class RegionCapture:
    """One fused-region candidate: the aggregate re-expressed over
    ``source``. ``ops`` labels the fused chain source-first, e.g.
    ("filter", "project", "agg")."""

    __slots__ = ("source", "predicate", "groupby", "aggregations", "ops")

    def __init__(self, source, predicate: Optional[Expression],
                 groupby: List[Expression], aggregations: List[Expression],
                 ops: Tuple[str, ...]):
        self.source = source
        self.predicate = predicate
        self.groupby = groupby
        self.aggregations = aggregations
        self.ops = ops


def region_label(ops: Sequence[str]) -> str:
    """A region's op chain in human form."""
    return "→".join(ops)


def _strip_alias(e: Expression) -> Expression:
    while isinstance(e, Alias):
        e = e.child
    return e


def _substitute(e: Expression, mapping: Dict[str, Expression]) -> Expression:
    """Inline ``mapping`` (output name -> expression over the base schema)
    into ``e``, bottom-up. A name the mapping lacks raises KeyError: the
    candidate is then invalid."""

    def rewrite(node):
        if isinstance(node, ColumnRef):
            rep = mapping[node._name]
            if isinstance(rep, ColumnRef) and rep._name == node._name:
                return None  # identity: keep the original node
            return rep
        return None

    return e.transform(rewrite)


def _expr_absorbable(e: Expression) -> bool:
    from ..udf.expr import UdfCall

    # the window functions add theirs here (ROADMAP Queue 1 item 4)
    return not any(isinstance(n, (AggExpr, UdfCall)) for n in e.walk())


def _chain_below(agg_input) -> List:
    """The longest absorbable Filter/Project chain under the aggregate,
    nearest the aggregate first."""
    from ..plan import logical as lp

    chain = []
    node = agg_input
    while len(chain) < REGION_MAX_OPS:
        if isinstance(node, lp.Filter):
            if not _expr_absorbable(node.predicate):
                break
        elif isinstance(node, lp.Project):
            if not all(_expr_absorbable(e) for e in node.projection):
                break
        else:
            break
        chain.append(node)
        node = node.input
    return chain


def _compose(plan, chain: List, k: int) -> Optional[RegionCapture]:
    """The candidate absorbing the k operators nearest the aggregate, or
    None when substitution loses a name, an expression does not type over
    the base schema, or an output dtype drifts."""
    from ..plan import logical as lp

    base = chain[k - 1].input if k else plan.input
    mapping: Dict[str, Expression] = {f.name: ColumnRef(f.name) for f in base.schema}
    predicate: Optional[Expression] = None
    labels: List[str] = []
    try:
        for node in reversed(chain[:k]):
            if isinstance(node, lp.Filter):
                p = _substitute(node.predicate, mapping)
                predicate = p if predicate is None else BinaryOp("and", predicate, p)
                if node.keep is not None:
                    mapping = {c: mapping[c] for c in node.keep}
                labels.append("filter")
            else:
                mapping = {e.name(): _substitute(_strip_alias(e), mapping)
                           for e in node.projection}
                labels.append("project")

        in_schema = plan.input.schema
        groupby: List[Expression] = []
        for g in plan.groupby:
            composed = _substitute(_strip_alias(g), mapping)
            if composed.to_field(base.schema).dtype != g.to_field(in_schema).dtype:
                return None
            if not isinstance(composed, ColumnRef) or composed._name != g.name():
                composed = Alias(composed, g.name())
            groupby.append(composed)

        aggregations: List[Expression] = []
        for e in plan.aggregations:
            inner = _strip_alias(e)
            if not isinstance(inner, AggExpr):
                return None
            child = _substitute(inner.child, mapping)
            if child.to_field(base.schema).dtype != inner.child.to_field(in_schema).dtype:
                return None
            aggregations.append(Alias(AggExpr(inner.op, child, inner.params), e.name()))

        if predicate is not None and not predicate.to_field(base.schema).dtype.is_boolean():
            return None
    except (KeyError, ValueError, TypeError):
        # a name lost or an untypeable composition: not capturable at this
        # k; the shorter chain is tried next
        return None
    return RegionCapture(base, predicate, groupby, aggregations, tuple(labels) + ("agg",))


def agg_region_candidates(plan) -> Iterator[RegionCapture]:
    """The fused-region candidates of one ``lp.Aggregate``, most absorbed
    first, composed lazily: the planner stops at the first one a stage
    builder accepts. The last (k = 0) is the bare aggregate; with a Filter
    directly under it, the one before (k = 1) is the single-Filter peel
    planned without regions, so nothing that planned on the card before
    stops doing so."""
    chain = _chain_below(plan.input)
    for k in range(len(chain), -1, -1):
        cand = _compose(plan, chain, k)
        if cand is not None:
            yield cand


def single_filter_peel(plan) -> RegionCapture:
    """The one candidate under region_mode="off": the Filter directly under
    the aggregate, if any, peeled into the stage's predicate."""
    from ..plan import logical as lp

    src, predicate, ops = plan.input, None, ("agg",)
    if isinstance(src, lp.Filter):
        src, predicate, ops = src.input, src.predicate, ("filter", "agg")
    return RegionCapture(src, predicate, plan.groupby, plan.aggregations, ops)


# ---- what the executor reads at run time ------------------------------------------


def referenced_columns(predicate: Optional[Expression], groupby, aggregations) -> set:
    """The base-schema columns a captured region reads. Absorbing a Project
    that dropped columns moves the region's input below it, to the full base
    width: the device stage uploads only what it reads, but the host path
    and the fallback's rerun buffer must narrow to these explicitly."""
    names = set()
    exprs = list(groupby) + list(aggregations)
    if predicate is not None:
        exprs.append(predicate)
    for e in exprs:
        names.update(e.referenced_columns())
    return names


def node_region_ops(node) -> Tuple[str, ...]:
    """The fused-op chain of a planned device node."""
    ops = getattr(node, "region_ops", None)
    if ops:
        return tuple(ops)
    if getattr(node, "predicate", None) is not None:
        return ("filter", "agg")
    return ("agg",)


def unwrap_udf_agg_input(agg_input):
    """(udf_node, rename) when ``agg_input`` is a DeviceUdfProject, or a
    column-only Project over one (the rename ``rule_split_udfs`` leaves; the
    region capture absorbs it at plan time, so the Project arm serves
    region_mode="off"). ``rename`` maps each column the aggregate sees to its
    name in the UDF node's output. (None, None) for any other shape."""
    from ..plan import physical as pp

    if isinstance(agg_input, pp.DeviceUdfProject):
        return agg_input, {c: c for c in agg_input.schema.column_names()}
    if isinstance(agg_input, pp.Project) and isinstance(agg_input.input, pp.DeviceUdfProject):
        rename = {}
        for e in agg_input.projection:
            ref = _strip_alias(e)
            if not isinstance(ref, ColumnRef):
                return None, None
            rename[e.name()] = ref.name()
        return agg_input.input, rename
    return None, None
