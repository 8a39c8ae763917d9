"""Star join + aggregate on the device (counterpart of
daft_tpu/ops/device_join.py, its single-device path: the grouped, the
ungrouped and the TopN runs).

For the analytics shape -- one large fact relation inner-joined to smaller
dims on unique keys, then aggregated -- the join never materializes. Each
dim adjacent to the fact becomes an int32 index plane over the fact rows
(the dim row whose key equals the fact row's key, -1 on a miss), probed on
the card by the hash-probe kernel K4 (ops/probe_kernels.py) against a hash
table of the dim's keys. Every dim column the query touches is then one
device gather through that plane, and the aggregation runs on the grouped
stage's kernels (ops/grouped_stage.py) with ``__join_ok__`` (every adjacent
dim matched and passed its filters) folded into the predicate.

Capture (``try_capture_join_agg``, called by plan/physical.py over the
optimized plan):
    Aggregate <- [Project]* <- [Filter]* <- inner-join tree
flattened to relations and equality conditions; each relation's filters
(pushed down by the optimizer) are stripped, the relation with the largest
unfiltered base is the fact, and the others must connect to it as a tree of
dims over equality edges (leftover edges become device predicates; the
fact's filters join the predicate, each dim's filter its own host-evaluated
visibility). Dim-only subexpressions the device cannot
evaluate (strings, ``is_in``) are hoisted into synthetic dim columns that
the host evaluates once per dim; a fact string ``==`` / ``is_in`` against
literals becomes a membership plane over the column's dictionary codes.

Chained dims (joined to another dim, not to the fact) never probe per fact
row: their planes are composed into their adjacent root's row space through
a host index (``dim_space_idx``), so each fact batch pays one K4 probe and
one gather per plane of each adjacent dim. As in the reference, only
adjacent dims probe in-kernel.

Everything expensive is cached in the residency manager, keyed on the
identity of the column Series it was built from: the probe table (built
once per dim key Series), the index plane (once per fact key Series), the
dim-space planes, the synthetic columns, the visibility and membership
planes, a host factorize of the joined group keys. A warm query launches
K4 zero times and pays the gathers and the stage's kernels.

Runs: ``DeviceJoinGroupedRun`` (the grouped stage; every group's table
comes back at finalize, so at most 2^16 groups), ``DeviceJoinTopNRun``
(an ORDER BY + LIMIT over it: the tables stay on the card, a device sort
picks the K winners, up to ``TOPN_MAX_SEGMENTS`` groups, one fact batch)
and ``DeviceJoinUngroupedRun`` (the ungrouped ``FilterAggStage``).

The port gathers each dim plane in its own dtype (int64 dim values stay
exact without the reference's f32 digit split, which its TPU needed for lane
padding and index-count-bound gathers). Dim filters are evaluated on the
host (dims are small) and uploaded once per query shape. Left out: the
group-sorted (``perm``) and local-dense branches (the reference keeps its
one-hot matmuls narrow with them; the port's kernels take the group codes in
place at every cap up to ``max_segments``) and the cost-model arm. A stage
with a float min/max computes in f64: its fact and dim float columns
upload, and gather, in f64.

Fallback: a shape this module cannot prove safe returns None at capture;
at run time non-unique or non-integer dim keys, a dim key equal to the probe
table's empty marker, a group count over the run's ceiling and a TopN's
second fact batch raise ``DeviceFallback`` before any launch, and the
executor runs the host plan. A kernel failure raises: nothing replays it
on the host.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.kernels.encoding import _common_key_dtype, canonical_key_values
from ..datatype import DataType, Field
from ..device.residency import exprs_structure, expr_structure, manager
from ..expressions.expressions import (AggExpr, Alias, BinaryOp, ColumnRef, Expression,
                                       IsIn, Literal)
from ..schema import Schema
from . import counters
from . import device_eval as dev
from . import probe_kernels as pk
from .grouped_stage import (DeviceFallback, GroupedAggRun, GroupedAggStage, _Decode,
                            _pad_groups, cached_dict_code_plane, results_from_tables,
                            try_build_grouped_agg_stage)
from .stage import FilterAggRun, device_row_mask, pad_bucket, try_build_filter_agg_stage


# ======================================================================================
# capture: logical plan -> JoinAggSpec
# ======================================================================================


@dataclass
class DimSpec:
    base: object                     # logical plan of the dim without trailing filters
    filters: List[Expression]        # dim-local filters (host-evaluated)
    key_col: str                     # dim-side unique join key column
    parent: Tuple[str, str]          # ("fact" | dim name, column) giving probe values
    name: str                        # dim identifier (caches, debug)
    synthetic: List[Tuple[str, Expression]] = field(default_factory=list)


@dataclass
class JoinAggSpec:
    fact: object                     # logical plan of the fact side (filters stripped)
    dims: List[DimSpec]              # parents first
    schema: Schema                   # joined schema: fact + dim (+ synthetic) columns
    col_side: Dict[str, str]         # column -> "fact" | dim name
    predicate: Optional[Expression]
    groupby: List[Expression]
    aggregations: List[Expression]
    # fact string membership lowered to dictionary codes: synthetic name ->
    # (fact column, match values, three_valued). ``==`` is three-valued (a
    # null row is null); ``is_in`` is not (a null row matches a null item).
    fact_synthetic: Dict[str, Tuple[str, tuple, bool]] = field(default_factory=dict)


def _split_conjuncts(e: Expression) -> List[Expression]:
    if isinstance(e, BinaryOp) and e.op == "and":
        return _split_conjuncts(e.left) + _split_conjuncts(e.right)
    return [e]


def _flatten_joins(node) -> Optional[Tuple[list, list]]:
    """A tree of plain inner equi-joins (no strategy, no null-matching keys)
    as (relations, [(left col, right col)]); any other node, a Filter over a
    join or a join of another type included, is a relation of its own, which
    the host runs (the optimizer has pushed every one-sided filter into its
    relation). None on merged or renamed output columns, non-column keys, or
    a column name that two relations share (provenance would be
    ambiguous)."""
    from ..plan import logical as lp

    rels: list = []
    conds: list = []

    def walk(n) -> bool:
        if not (isinstance(n, lp.Join) and n.how == "inner" and n.strategy is None
                and not n.null_equals_null):
            rels.append(n)
            return True
        merged, rename = n.output_naming()
        if merged or rename:
            return False
        pairs = []
        for le, re_ in zip(n.left_on, n.right_on):
            le = le.child if isinstance(le, Alias) else le
            re_ = re_.child if isinstance(re_, Alias) else re_
            if not (isinstance(le, ColumnRef) and isinstance(re_, ColumnRef)):
                return False
            pairs.append((le._name, re_._name))
        if not walk(n.left):
            return False
        conds.extend(pairs)
        return walk(n.right)

    if not walk(node):
        return None
    names: set = set()
    for r in rels:
        cols = set(r.schema.column_names())
        if names & cols:
            return None
        names |= cols
    return rels, conds


def _strip_filters(n) -> Tuple[object, List[Expression]]:
    from ..plan import logical as lp

    fs: List[Expression] = []
    while isinstance(n, lp.Filter):
        fs.extend(_split_conjuncts(n.predicate))
        n = n.input
    return n, fs


def try_capture_join_agg(agg_plan) -> Optional[JoinAggSpec]:
    """Match Aggregate (grouped or not) <- a Filter/Project chain (composed
    by ops/region.py) <- inner-join tree into a JoinAggSpec, or None when the shape is not
    provably safe or the joined stage is outside the device tier."""
    from ..plan.stats import estimate_rows
    from .region import agg_region_candidates

    # the Project/Filter chain under the aggregate composed over its base
    # (the most absorbed region candidate); the joins sit under that base
    cand = next(agg_region_candidates(agg_plan), None)
    if cand is None:
        return None
    groupby, aggs, src = list(cand.groupby), list(cand.aggregations), cand.source
    conjuncts = _split_conjuncts(cand.predicate) if cand.predicate is not None else []

    flat = _flatten_joins(src)
    if flat is None:
        return None
    rels, conds = flat
    if len(rels) < 2:
        return None

    # the fact is the largest relation by unfiltered base size: it streams
    # through the program, and the dims must carry unique keys
    sizes = [estimate_rows(_strip_filters(r)[0]) for r in rels]
    if any(s is None for s in sizes):
        return None
    fact_i = int(np.argmax(sizes))
    fact_base, fact_filters = _strip_filters(rels[fact_i])
    conjuncts.extend(fact_filters)

    col_side: Dict[str, str] = {c: "fact" for c in fact_base.schema.column_names()}
    available = dict(col_side)

    # grow the dim tree from the fact over equality edges
    pending = [r for i, r in enumerate(rels) if i != fact_i]
    remaining = list(conds)
    dims: List[DimSpec] = []
    progress = True
    while pending and progress:
        progress = False
        for pi, rel in enumerate(pending):
            base, filters = _strip_filters(rel)
            rel_cols = set(base.schema.column_names())
            edge = None
            for ci, (a, b) in enumerate(remaining):
                if a in available and b in rel_cols:
                    edge = (ci, a, b)
                    break
                if b in available and a in rel_cols:
                    edge = (ci, b, a)
                    break
            if edge is None:
                continue
            ci, avail_col, dim_key = edge
            remaining.pop(ci)
            name = f"d{len(dims)}"
            dims.append(DimSpec(base=base, filters=filters, key_col=dim_key,
                                parent=(available[avail_col], avail_col), name=name))
            for c in base.schema.column_names():
                col_side[c] = available[c] = name
            pending.pop(pi)
            progress = True
            break
    if pending:
        return None

    fields: List[Field] = list(fact_base.schema)
    for i, r in enumerate(rels):
        if i != fact_i:
            fields.extend(_strip_filters(r)[0].schema)
    schema = Schema(fields)

    # leftover equality edges become device predicates, integer-like columns
    # only (the device compares float planes in f32)
    for a, b in remaining:
        if not all(schema[c].dtype.is_integer() or schema[c].dtype.is_temporal()
                   or schema[c].dtype.is_boolean() for c in (a, b)):
            return None
        conjuncts.append(BinaryOp("eq", ColumnRef(a), ColumnRef(b)))

    # hoist maximal single-dim subexpressions the device cannot evaluate into
    # synthetic host-evaluated dim columns; lower fact string membership
    dim_by_name = {d.name: d for d in dims}
    counter = [0]
    fact_synthetic: Dict[str, Tuple[str, tuple, bool]] = {}

    def fact_string_membership(node) -> Optional[Tuple[str, tuple, bool]]:
        if isinstance(node, IsIn) and isinstance(node.child, ColumnRef):
            cn = node.child._name
            if col_side.get(cn) == "fact" and schema[cn].dtype.is_string() \
                    and all(isinstance(it, Literal) for it in node.items):
                return cn, tuple(it.value for it in node.items), False
        if isinstance(node, BinaryOp) and node.op == "eq":
            for a, b in ((node.left, node.right), (node.right, node.left)):
                if isinstance(a, ColumnRef) and isinstance(b, Literal) \
                        and col_side.get(a._name) == "fact" \
                        and schema[a._name].dtype.is_string() and isinstance(b.value, str):
                    return a._name, (b.value,), True
        return None

    def hoist(e: Expression) -> Expression:
        def rw(node):
            if isinstance(node, (ColumnRef, Alias, AggExpr)):
                return None
            sides = {col_side.get(c) for c in node.referenced_columns()} - {None}
            side = next(iter(sides)) if len(sides) == 1 else None
            if side is None or side == "fact":
                fsm = fact_string_membership(node)
                if fsm is None:
                    return None
                syn = f"__fsyn_{counter[0]}__"
                counter[0] += 1
                fact_synthetic[syn] = fsm
                return ColumnRef(syn)
            if dev.is_device_evaluable(node, schema):
                return None  # numeric dim math gathers its leaves directly
            try:
                node.to_field(dim_by_name[side].base.schema)
            except (KeyError, ValueError, TypeError):
                return None
            syn = f"__syn_{side}_{counter[0]}__"
            counter[0] += 1
            dim_by_name[side].synthetic.append((syn, node))
            return ColumnRef(syn)

        return e.transform(rw)

    def hoist_named(e: Expression) -> Expression:
        out = hoist(e)
        return out if out.name() == e.name() else out.alias(e.name())

    groupby = [hoist_named(g) for g in groupby]
    aggs = [hoist_named(a) for a in aggs]
    conjuncts = [hoist(c) for c in conjuncts]
    for d in dims:
        for syn, expr in d.synthetic:
            fields.append(Field(syn, expr.to_field(d.base.schema).dtype))
            col_side[syn] = d.name
    for syn in fact_synthetic:
        fields.append(Field(syn, DataType.bool()))
        col_side[syn] = "fact"
    schema = Schema(fields)

    # eligibility over the joined schema
    for g in groupby:
        if not isinstance(g.child if isinstance(g, Alias) else g, ColumnRef):
            return None
    predicate = None
    for c in conjuncts:
        if not dev.is_device_evaluable(c, schema):
            return None
        predicate = c if predicate is None else (predicate & c)
    for d in dims:
        kdt = d.base.schema[d.key_col].dtype
        if not (kdt.is_numeric() or kdt.is_temporal()):
            return None
    spec = JoinAggSpec(fact=fact_base, dims=dims, schema=schema, col_side=col_side,
                       predicate=predicate, groupby=groupby, aggregations=aggs,
                       fact_synthetic=fact_synthetic)
    return spec if build_join_stage(spec)[0] is not None else None


def build_join_stage(spec: JoinAggSpec):
    """(stage, grouped): the grouped stage (with group keys) or the ungrouped
    ``FilterAggStage`` (without) over the joined schema, with
    ``__join_ok__`` folded into the predicate; the stage is None when it is
    refused (reason in ``counters.rejections``)."""
    schema = Schema(list(spec.schema) + [Field("__join_ok__", DataType.bool())])
    ok = ColumnRef("__join_ok__")
    predicate = ok if spec.predicate is None else (spec.predicate & ok)
    if spec.groupby:
        return try_build_grouped_agg_stage(schema, predicate, spec.groupby,
                                           spec.aggregations), True
    return try_build_filter_agg_stage(schema, predicate, spec.aggregations), False


# ======================================================================================
# runtime: join indices, probe tables and gathered device columns
# ======================================================================================


def unique_key_index(dim_key_series, probe_vals: np.ndarray, probe_valid: np.ndarray,
                     target_dtype) -> np.ndarray:
    """Host index: idx[i] = dim row whose key equals probe value i, else -1.
    Raises DeviceFallback when the dim keys are not unique (the join would
    multiply rows) or not integer-like."""
    s = dim_key_series
    if s.dtype != target_dtype:
        s = s.cast(target_dtype)
    kind, vals, valid = canonical_key_values(s)
    if kind != "num":
        raise DeviceFallback(f"dim key {s.name!r} is not an integer-like key")
    vv = vals[valid]
    if len(np.unique(vv)) != len(vv):
        raise DeviceFallback(f"dim key {s.name!r} is not unique")
    pv = probe_vals.astype(np.int64, copy=False)
    rows = np.flatnonzero(valid)
    lo = int(vv.min()) if len(vv) else 0
    hi = int(vv.max()) if len(vv) else -1
    domain = hi - lo + 1
    if 0 < domain <= max(4096, 8 * max(len(vv), 1)):
        table = np.full(domain, -1, dtype=np.int64)
        table[vv - lo] = rows
        with np.errstate(over="ignore"):
            safe = np.clip(pv - lo, 0, domain - 1)
        idx = np.where((pv >= lo) & (pv <= hi), table[safe], -1)
    elif len(vv):
        order = np.argsort(vv, kind="stable")
        su = vv[order]
        pos = np.minimum(np.searchsorted(su, pv), len(su) - 1)
        idx = np.where(su[pos] == pv, rows[order][pos], -1)
    else:
        idx = np.full(len(pv), -1, dtype=np.int64)
    return np.where(probe_valid, idx, -1).astype(np.int32)


def _gather(plane: Tuple[torch.Tensor, torch.Tensor], idx: torch.Tensor,
            safe: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, validity) of ``plane`` at index plane ``idx``; a miss (-1)
    reads row 0 and comes back invalid."""
    v, m = plane
    return v[safe], m[safe] & (idx >= 0)


class _JoinContext:
    """Materialized dims and the per-fact-batch index and gather work for
    one run of a DeviceJoinAgg."""

    def __init__(self, spec: JoinAggSpec, dim_batches: Dict[str, object],
                 device: torch.device, f32: bool):
        self.spec = spec
        self.dims = spec.dims
        self.batches = dim_batches              # dim name -> RecordBatch (base rows)
        self.device = device
        # float columns upload as f32, or as f64 for a stage computed in f64
        # (a float min/max); dim planes gather in the dtype they upload in
        self.f32 = f32
        self.syn_series: Dict[str, Dict[str, object]] = {
            d.name: {name: self._cached_syn(dim_batches[d.name], name, expr)
                     for name, expr in d.synthetic}
            for d in self.dims}
        # every dim's keys are checked before anything launches: an adjacent
        # dim's for its probe table, a chained dim's by its host index
        for d in self.dims:
            if d.parent[0] == "fact":
                self._table_keys(d)
            else:
                self.dim_space_idx(d)

    # ---- dim-side host state ---------------------------------------------------------

    def _cached_syn(self, dim_batch, name: str, expr: Expression):
        """A synthetic dim column, evaluated once per (expression shape,
        referenced Series); the literals live in the slot."""
        from ..expressions.eval import eval_expression

        refs = expr.referenced_columns()
        deps = tuple(dim_batch.get_column(c) for c in refs)
        skel, lits = expr_structure(expr)
        return manager().get_or_build(deps[0], ("syn", skel, name),
                                      lambda: eval_expression(dim_batch, expr).rename(name),
                                      deps, lits)

    def vis_plane(self, d: DimSpec, cap_d: int) -> Optional[torch.Tensor]:
        """bool[cap_d] device plane: the dim row passes every filter of the
        dim (None = no filters). The filters run on the host (dims are
        small), once per (filter shapes, referenced Series); the literals
        live in the slot."""
        if not d.filters:
            return None
        from ..expressions.eval import eval_expression

        b = self.batches[d.name]
        deps = tuple(b.get_column(c) for f in d.filters for c in f.referenced_columns())

        def build():
            vis = np.zeros(cap_d, dtype=bool)
            vis[:b.num_rows] = True
            for f in d.filters:
                m = eval_expression(b, f)
                vis[:b.num_rows] &= np.asarray(m.to_numpy(), dtype=bool) & m.validity_numpy()
            return torch.from_numpy(vis).to(self.device)

        skels, lits = exprs_structure(d.filters)
        return manager().get_or_build(b.get_column(d.key_col),
                                      ("visplane", cap_d, str(self.device)) + skels,
                                      build, deps, lits)

    def _dim_source(self, dname: str, colname: str):
        if colname.startswith("__syn_"):
            return self.syn_series[dname][colname]
        return self.batches[dname].get_column(colname)

    def dim_space_idx(self, child: DimSpec) -> np.ndarray:
        """Host index from parent-dim rows to child rows (-1 = miss)."""
        pname, pcol = child.parent
        probe = self.batches[pname].get_column(pcol)
        key_series = self.batches[child.name].get_column(child.key_col)
        kdt = _common_key_dtype(probe.dtype, key_series.dtype)

        def build():
            p = probe if probe.dtype == kdt else probe.cast(kdt)
            kind, vals, valid = canonical_key_values(p)
            if kind != "num":
                raise DeviceFallback(f"chain key {pcol!r} is not integer-like")
            return unique_key_index(key_series, vals, valid, kdt)

        return manager().get_or_build(probe, ("dsidx", child.key_col, repr(kdt)), build,
                                      (key_series,))

    # ---- fact -> dim indices ---------------------------------------------------------

    def _adjacent(self) -> List[DimSpec]:
        return [d for d in self.dims if d.parent[0] == "fact"]

    def _root_of(self, dname: str) -> str:
        d = next(dd for dd in self.dims if dd.name == dname)
        while d.parent[0] != "fact":
            d = next(dd for dd in self.dims if dd.name == d.parent[0])
        return d.name

    def _key_dtype(self, d: DimSpec):
        side, colname = d.parent
        probe_dt = (self.spec.schema[colname].dtype if side == "fact"
                    else self.batches[side].schema[colname].dtype)
        return _common_key_dtype(probe_dt, self.batches[d.name].schema[d.key_col].dtype)

    def _probe_values(self, batch, d: DimSpec, idx_so_far: Dict[str, np.ndarray],
                      kdt) -> Tuple[np.ndarray, np.ndarray]:
        """Canonical int64 probe values of dim ``d`` per fact row: the fact
        column, or (chained) the parent dim's column gathered through the
        parent's host index."""
        side, colname = d.parent
        s = batch.get_column(colname) if side == "fact" \
            else self.batches[side].get_column(colname)
        s = s if s.dtype == kdt else s.cast(kdt)
        kind, vals, valid = canonical_key_values(s)
        if kind != "num":
            raise DeviceFallback(f"join key {colname!r} is not integer-like")
        if side == "fact":
            return vals, valid
        pidx = idx_so_far[side]
        if len(vals) == 0:  # empty parent dim: nothing chains through it
            return np.zeros(len(pidx), dtype=np.int64), np.zeros(len(pidx), dtype=bool)
        safe = np.clip(pidx, 0, len(vals) - 1)
        return vals[safe], (pidx >= 0) & valid[safe]

    def indices_for(self, batch) -> Dict[str, np.ndarray]:
        """Host per-fact-row index of every dim (the host-factorized group
        codes need them), cached on the probe Series; a chained dim also
        depends on its parent's index array."""
        out: Dict[str, np.ndarray] = {}
        for d in self.dims:
            key_series = self.batches[d.name].get_column(d.key_col)
            kdt = self._key_dtype(d)
            side, colname = d.parent
            anchor = batch.get_column(colname) if side == "fact" \
                else self.batches[side].get_column(colname)
            deps: tuple = (key_series,) if side == "fact" else (key_series, out[side])

            def build(d=d, kdt=kdt, key_series=key_series, so_far=dict(out)):
                vals, valid = self._probe_values(batch, d, so_far, kdt)
                return unique_key_index(key_series, vals, valid, kdt)

            key = ("uki", d.key_col, d.parent, repr(kdt), batch.num_rows)
            out[d.name] = manager().get_or_build(anchor, key, build, deps)
        return out

    def _table_keys(self, d: DimSpec) -> Tuple[np.ndarray, np.ndarray]:
        """Canonical int64 keys and validity of an adjacent dim, checked for
        the probe table: raises DeviceFallback (before any launch) on
        non-integer, non-unique or empty-marker keys."""
        key_series = self.batches[d.name].get_column(d.key_col)
        kdt = self._key_dtype(d)

        def build():
            s = key_series if key_series.dtype == kdt else key_series.cast(kdt)
            kind, vals, valid = canonical_key_values(s)
            if kind != "num":
                raise DeviceFallback(f"dim key {d.key_col!r} is not an integer-like key")
            why = pk.probe_key_refusal(vals, valid)
            if why is not None:
                raise DeviceFallback(f"dim key {d.key_col!r}: {why}")
            return vals, valid

        return manager().get_or_build(key_series, ("pkeys", d.key_col, repr(kdt)), build)

    def probe_table(self, d: DimSpec) -> torch.Tensor:
        """The K4 hash table (one (S, 2) int64 tensor of 16-byte slots) of an
        adjacent dim's keys on the device, built once per dim key Series."""
        key_series = self.batches[d.name].get_column(d.key_col)
        vals, valid = self._table_keys(d)

        def build():
            keys = torch.tensor(vals, device=self.device)
            ok = torch.tensor(valid, device=self.device)
            return pk.build_probe_table(keys, ok, pk.probe_table_slots(len(vals)))

        # deps-free, as the reference's: the table is a function of the key
        # Series' content, so a re-read dim's equal keys rebind it
        key = ("ptable", d.key_col, repr(self._key_dtype(d)), str(self.device))
        return manager().get_or_build(key_series, key, build)

    def dev_idx(self, batch, d: DimSpec, bucket: int) -> torch.Tensor:
        """int32[bucket] index plane of an adjacent dim, probed by K4 and
        cached on the fact key Series: a warm query probes nothing."""
        table = self.probe_table(d)
        anchor = batch.get_column(d.parent[1])
        n = batch.num_rows

        def build():
            vals, valid = self._probe_values(batch, d, {}, self._key_dtype(d))
            pv = np.zeros(bucket, dtype=np.int64)
            pm = np.zeros(bucket, dtype=bool)
            pv[:n] = vals
            pm[:n] = valid
            return pk.hash_probe_index(torch.from_numpy(pv).to(self.device),
                                       torch.from_numpy(pm).to(self.device), table)

        key = ("pdidx", d.key_col, d.parent, bucket, str(self.device))
        return manager().get_or_build(anchor, key, build, (table,))

    # ---- dim planes in their adjacent root's row space -----------------------------

    def _build_space(self, d: DimSpec, vals: Dict[str, List[str]],
                     codes: Dict[str, List[str]]):
        """(value planes, code planes, ok plane or None) of d's subtree, in
        d's row space on the device."""
        b = self.batches[d.name]
        cap_d = pad_bucket(b.num_rows)
        planes = {c: self._dim_source(d.name, c).to_device_cached(
                      cap_d, f32=self.f32, device=self.device) for c in vals[d.name]}
        code_planes = {}
        for c in codes[d.name]:
            src = self._dim_source(d.name, c)
            cds, _values, _k = src.dict_codes()
            code_planes[c] = cached_dict_code_plane(src, cds, b.num_rows, cap_d, self.device)
        ok = self.vis_plane(d, cap_d)
        for child in (c for c in self.dims if c.parent[0] == d.name):
            cplanes, ccodes, cok = self._build_space(child, vals, codes)
            padded = np.full(cap_d, -1, dtype=np.int32)
            padded[:b.num_rows] = self.dim_space_idx(child)
            didx = torch.from_numpy(padded).to(self.device)
            safe = didx.clamp(min=0).long()
            for c, plane in cplanes.items():
                planes[c] = _gather(plane, didx, safe)
            for c, cp in ccodes.items():
                code_planes[c] = cp[safe]
            child_ok = didx >= 0
            if cok is not None:
                child_ok = child_ok & cok[safe]
            ok = child_ok if ok is None else ok & child_ok
        return planes, code_planes, ok

    def dim_space(self, adj: DimSpec, needed: Sequence[str], groupby_cols: Sequence[str]):
        """(value planes, code planes, ok plane or None) of the adjacency
        subtree rooted at ``adj``, cached per query shape: the key holds the
        column lists, the chain's shape and the filters' structure, the
        deps every Series read, the literals the filters' values."""
        spec = self.spec
        vals = {d.name: [] for d in self.dims}
        codes = {d.name: [] for d in self.dims}
        for c in needed:
            if spec.col_side.get(c) in vals:
                vals[spec.col_side[c]].append(c)
        for c in groupby_cols:
            if spec.col_side.get(c) in codes:
                codes[spec.col_side[c]].append(c)
        sub = [d for d in self.dims if self._root_of(d.name) == adj.name]
        my_vals = [c for d in sub for c in vals[d.name]]
        my_codes = [c for d in sub for c in codes[d.name]]
        deps = tuple(self._dim_source(spec.col_side[c], c) for c in my_vals + my_codes)
        deps += tuple(self.batches[d.name].get_column(d.key_col) for d in sub)
        deps += tuple(self.batches[d.parent[0]].get_column(d.parent[1])
                      for d in sub if d.parent[0] != "fact")
        skels, lits = exprs_structure([f for d in sub for f in d.filters])
        key = ("space", tuple(my_vals), tuple(my_codes),
               tuple((d.key_col,) + d.parent for d in sub), skels, self.f32,
               str(self.device))
        return manager().get_or_build(self.batches[adj.name].get_column(adj.key_col), key,
                                      lambda: self._build_space(adj, vals, codes),
                                      deps, lits)

    def _fact_membership_plane(self, batch, bucket: int, syn: str):
        """(values, validity) of a fact string membership: the column's
        resident dictionary codes looked up in a table over its distinct
        values. One slot per (column, synthetic name, bucket); the match
        values are the slot's literals."""
        colname, values, three_valued = self.spec.fact_synthetic[syn]
        s = batch.get_column(colname)

        def build():
            cds, vocab, _k = s.dict_codes()
            null_hit = any(v is None for v in values)
            hit = [(v in values) if v is not None else null_hit for v in vocab]
            ok = [v is not None or not three_valued for v in vocab]
            codes = cached_dict_code_plane(s, cds, batch.num_rows, bucket, self.device).long()
            lut = torch.tensor(hit or [False], dtype=torch.bool, device=self.device)
            lut_ok = torch.tensor(ok or [True], dtype=torch.bool, device=self.device)
            return lut[codes], lut_ok[codes]

        return manager().get_or_build(s, ("fmem", syn, bucket, str(self.device)), build,
                                      literals=(values, three_valued))

    def provision(self, batch, bucket: int, needed: Sequence[str],
                  groupby_cols: Sequence[str] = ()):
        """Every device column of one fact batch: fact planes resident, one
        K4 index plane and one gather per plane of each adjacent dim, and
        ``__join_ok__``. Returns (columns, dim group-key code planes)."""
        spec = self.spec
        dcols: Dict[str, dev.DCol] = {}
        code_out: Dict[str, torch.Tensor] = {}
        ok_total = None
        for adj in self._adjacent():
            didx = self.dev_idx(batch, adj, bucket)
            safe = didx.clamp(min=0).long()
            planes, code_planes, ok = self.dim_space(adj, needed, groupby_cols)
            for c, plane in planes.items():
                dcols[c] = _gather(plane, didx, safe)
            for c, cp in code_planes.items():
                code_out[c] = cp[safe]
            aok = didx >= 0
            if ok is not None:
                aok = aok & ok[safe]
            ok_total = aok if ok_total is None else ok_total & aok
        for name in needed:
            if spec.col_side.get(name) != "fact":
                continue
            if name in spec.fact_synthetic:
                dcols[name] = self._fact_membership_plane(batch, bucket, name)
            else:
                dcols[name] = batch.get_column(name).to_device_cached(
                    bucket, f32=self.f32, device=self.device)
        dcols["__join_ok__"] = (ok_total, torch.ones_like(ok_total))
        return dcols, code_out


# ======================================================================================
# the runs: grouped, TopN and ungrouped over joined columns
# ======================================================================================


class _FactorizedCodes:
    """The cached host factorize of the joined group keys of one fact batch:
    dense group ids in first-occurrence order and each group's first fact
    row. Key tuples and sort-rank planes are built lazily, for the groups
    asked for: a TopN run needs the K winners' rows of possibly millions of
    groups.

    Each key column is (source Series, index): a fact column with no index,
    or a dim column with the dim row of every fact row (-1 on a miss). Codes
    are the sources' dictionary codes (cached on each Series; equal values
    share one). The key columns of one dim (one index) are combined over the
    dim's rows first and gathered once, so a dim's string columns are
    factorized over the dim's rows, never over the fact's. Join-miss rows
    form their own groups: they keep no kept row and drop at finalize."""

    def __init__(self, key_cols: List[Tuple[object, Optional[np.ndarray]]], n: int,
                 bucket: int, device: torch.device):
        self.key_cols = key_cols
        self.n = n
        self.bucket = bucket
        self.device = device
        codes = []
        by_index: Dict[int, Tuple[np.ndarray, list]] = {}
        for s, idx in key_cols:
            c = s.dict_codes()[0].astype(np.int64)
            if idx is None:
                codes.append(c)
            else:
                by_index.setdefault(id(idx), (idx, []))[1].append(c)
        for idx, dim_codes in by_index.values():
            rows = len(dim_codes[0])
            if rows:
                dim_ids = _first_occurrence_groups(dim_codes, rows)[1]
                codes.append(dim_ids[np.clip(idx, 0, rows - 1)])
            else:
                codes.append(np.zeros(n, dtype=np.int64))
        if by_index:
            misses = [idx < 0 for idx, _c in by_index.values()]
            codes.append(np.logical_or.reduce(misses).astype(np.int64))
        self.first_idx, self.group_ids = _first_occurrence_groups(codes, n)
        self.cap = _pad_groups(max(len(self.first_idx), 1))

    @property
    def num_groups(self) -> int:
        return len(self.first_idx)

    @property
    def dcodes(self) -> torch.Tensor:
        """int32[bucket] codes plane on the device (padding rows on code
        cap), held by the residency manager beside this object."""
        def build():
            codes = np.full(self.bucket, self.cap, dtype=np.int32)
            codes[:self.n] = self.group_ids
            return torch.from_numpy(codes).to(self.device)

        return manager().get_or_build(self, ("dcodes", str(self.device)), build)

    def _key_rows_of(self, j: int, gids: np.ndarray):
        """Series of key column j at the first rows of groups ``gids``."""
        s, idx = self.key_cols[j]
        rows = self.first_idx[gids]
        if idx is not None:
            rows = idx[rows]
        if len(s) == 0:
            return type(s).full_null(s.name, s.dtype, len(gids))
        return s.take(np.clip(rows, 0, len(s) - 1))

    def rows_for(self, gids) -> List[tuple]:
        """Key tuples of the groups ``gids``."""
        gids = np.asarray(gids, dtype=np.int64)
        if not len(gids):
            return []
        return list(zip(*[self._key_rows_of(j, gids).to_pylist()
                          for j in range(len(self.key_cols))]))

    def rank_plane(self, j: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """(f64[cap] ranks, bool[cap] validity) of key column j on the
        device: each group's dense rank in the column's ascending order
        (equal values share a rank, so ties reach the next sort key),
        computed on the host where every dtype sorts exactly; a null key is
        invalid. Cached beside this object."""
        def build():
            s = self._key_rows_of(j, np.arange(self.num_groups))
            valid = s.validity_numpy()
            rank = np.zeros(self.cap, dtype=np.float64)
            if valid.any():
                rank[:self.num_groups][valid] = np.unique(
                    s.to_numpy()[valid], return_inverse=True)[1].reshape(-1)
            ok = np.zeros(self.cap, dtype=bool)
            ok[:self.num_groups] = valid
            return (torch.from_numpy(rank).to(self.device),
                    torch.from_numpy(ok).to(self.device))

        return manager().get_or_build(self, ("rank", j, str(self.device)), build)


def _first_occurrence_groups(codes: List[np.ndarray], n: int) -> Tuple[np.ndarray,
                                                                        np.ndarray]:
    """(first row of each group, group id of each row) over the combined
    code columns (each in [0, k)), ids in first-occurrence order, as
    core/kernels/groupby.py ``make_groups`` numbers them. The columns are
    radix-combined in int64 and re-densified only when the next radix would
    overflow."""
    combined = np.zeros(n, dtype=np.int64)
    width = 1
    for c in codes:
        k = int(c.max()) + 1 if len(c) else 1
        if width * k >= 1 << 62:
            combined = np.unique(combined, return_inverse=True)[1].reshape(n)
            width = int(combined.max()) + 1
        combined = combined * k + c
        width *= k
    _vals, first, inverse = np.unique(combined, return_index=True, return_inverse=True)
    order = np.argsort(first, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order), dtype=np.int64)
    return first[order].astype(np.int64), rank[inverse.reshape(n)]


class DeviceJoinGroupedRun(GroupedAggRun):
    """GroupedAggRun over gather-joined columns: the same stage programs and
    finalize; only column provisioning and group codes differ."""

    # group-count ceiling: the full cap-sized table is fetched at finalize
    max_segments = 1 << 16
    # a TopN run always takes the host factorize: its dense first-occurrence
    # ids are the sort's last tie-break and feed the rank planes
    force_host_codes = False

    def __init__(self, stage: GroupedAggStage, ctx: _JoinContext):
        super().__init__(stage, ctx.device)
        self.ctx = ctx

    def feed_batch(self, batch) -> None:
        """One fact batch through the stage. Group codes: the per-column
        dictionary codes radix-combined on the device while their product
        stays under the ceiling, else a host factorize of the joined key
        rows (its true group count)."""
        stage = self.stage
        n = batch.num_rows
        if n == 0:
            return
        bucket = pad_bucket(n)
        gb_cols = [(g.child if isinstance(g, Alias) else g)._name for g in stage.groupby]
        if not self.force_host_codes and \
                self._dict_product(batch, gb_cols) <= self.max_segments:
            dcols, code_planes = self.ctx.provision(batch, bucket, stage._input_cols,
                                                    gb_cols)
            decode = self._dict_combined_codes(batch, n, bucket, gb_cols, code_planes)
        else:
            decode = self._host_factorized_codes(batch, n, bucket)
            dcols, _ = self.ctx.provision(batch, bucket, stage._input_cols)
        out = stage._program_for(decode.cap)(
            dcols, decode.dcodes, device_row_mask(n, bucket, self.device), self._row_offset)
        self._row_offset += n
        self._pending.append((out, decode))
        counters.bump("device_grouped_batches")
        counters.bump("device_join_batches")

    def _group_source(self, batch, name: str):
        side = self.ctx.spec.col_side.get(name)
        return batch.get_column(name) if side == "fact" else self.ctx._dim_source(side, name)

    def _dict_product(self, batch, gb_cols) -> int:
        total = 1
        for name in gb_cols:
            total *= max(self._group_source(batch, name).dict_codes()[2], 1)
        return total

    def _dict_combined_codes(self, batch, n: int, bucket: int, gb_cols,
                             code_planes: Dict[str, torch.Tensor]) -> _Decode:
        """Radix-combine per-column dictionary codes on the device (fact
        codes resident per Series, dim codes gathered through the index
        planes). A join-miss row may carry any code; it is masked, and the
        codes are clipped into the table."""
        encoded = []
        for name in gb_cols:
            src = self._group_source(batch, name)
            codes, values, k = src.dict_codes()
            if self.ctx.spec.col_side.get(name) == "fact":
                plane = cached_dict_code_plane(src, codes, n, bucket, self.device)
            else:
                plane = code_planes[name]
            encoded.append((plane, values, k))
        total = 1
        for _, _, k in encoded:
            total *= max(k, 1)
        cap = _pad_groups(total)
        radices, mult = [], 1
        for _, _, k in reversed(encoded):
            radices.append(mult)
            mult *= max(k, 1)
        radices.reverse()
        combined = encoded[0][0] * radices[0]
        for (plane, _, _), r in zip(encoded[1:], radices[1:]):
            combined = combined + plane * r
        combined = combined.clamp(0, cap - 1).to(torch.int32)
        return _Decode(cap=cap, dcodes=combined, dicts=[(v, k) for _, v, k in encoded],
                       radices=radices, key_rows=None)

    def _host_factorized_codes(self, batch, n: int, bucket: int) -> _Decode:
        """Joined-key group codes by a host factorize over the host join
        indices, cached per fact batch (``_FactorizedCodes``). Raises
        DeviceFallback, before any launch, when the group count passes
        ``max_segments``."""
        ctx = self.ctx
        idxs = ctx.indices_for(batch)
        key_cols = []
        for g in self.stage.groupby:
            name = (g.child if isinstance(g, Alias) else g)._name
            side = ctx.spec.col_side.get(name)
            key_cols.append((self._group_source(batch, name),
                             None if side == "fact" else idxs[side]))
        deps = tuple(s for s, _idx in key_cols) + tuple(
            idx for _s, idx in key_cols if idx is not None)
        key = ("jfact", bucket, str(self.device)) + tuple(repr(g) for g in self.stage.groupby)
        fc = manager().get_or_build(key_cols[0][0], key,
                                    lambda: _FactorizedCodes(key_cols, n, bucket, self.device),
                                    deps)
        if fc.cap > self.max_segments:
            raise DeviceFallback(f"joined group count {fc.num_groups} (cap {fc.cap}) exceeds "
                                 f"the ceiling {self.max_segments} of {type(self).__name__}")
        return _Decode(cap=fc.cap, dcodes=fc.dcodes, dicts=None, radices=None, key_rows=None,
                       fact_codes=fc)


# segment ceiling of a TopN run: it copies back K rows whatever the group
# count, so the cap is bounded by the tables and the sort in device memory
TOPN_MAX_SEGMENTS = 1 << 22


@dataclass
class TopNSpec:
    """ORDER BY ... LIMIT lowered onto a grouped join run.

    keys: (kind, index, descending, nulls_first) per sort column: kind "agg"
    indexes spec.aggregations (its plane comes from the group tables on the
    device), kind "group" spec.groupby (a host-computed order rank, exact
    for any dtype, strings included)."""
    keys: List[Tuple[str, int, bool, bool]]
    limit: int
    offset: int


def _agg_sort_plane(stage: GroupedAggStage, out: dict,
                    agg_idx: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values[cap], bool[cap] valid) ordering plane of one aggregation, on
    the device from the group tables, in the dtype that orders it exactly:
    an integer sum (and the int64 extremes) as int64, rebuilt from its digit
    planes with the wrap mod 2^64 of ``results_from_tables``; a count, a
    float sum, a mean and the other extremes as f64."""
    slots = stage._agg_slots[agg_idx]
    _name, agg = stage.aggs[agg_idx]
    mm = out["mm"]
    count_all = agg.op == "count" and agg.params.get("mode", "valid") == "all"
    cnt = mm[:, 0] if count_all else mm[:, slots["count"][1]]
    if agg.op == "count":
        return cnt, torch.ones_like(cnt, dtype=torch.bool)
    valid = cnt > 0
    if agg.op in ("sum", "mean"):
        sl = slots["sum"]
        if sl[0] == "imm":
            # each digit total is an exact integer in the f64 table; the
            # int64 shifts and adds wrap mod 2^64, so the 8-digit
            # two's-complement sum comes back signed
            _k, base, nd, lo = sl
            s = cnt.to(torch.int64) * lo
            for k in range(nd):
                s = s + (mm[:, base + k].to(torch.int64) << (8 * k))
            if agg.op == "mean":
                return s.to(torch.float64) / cnt.clamp(min=1.0), valid
            return s, valid
        s = mm[:, sl[1]]
        return (s / cnt.clamp(min=1.0) if agg.op == "mean" else s), valid
    kind, idx = slots[agg.op]
    if kind == "sct":
        return out["sct"][idx], valid
    return out["ext"][idx].to(torch.float64), valid


def _sort_passes(v: torch.Tensor, valid: torch.Tensor, desc: bool,
                 nulls_first: bool) -> List[torch.Tensor]:
    """[value key, validity key] of one sort column, as the host's
    ``_column_keys`` (core/kernels/sort.py) builds them: NaN counts as +inf
    and -0.0 as 0.0, a descending key is negated (an integer one
    bit-inverted, which cannot overflow at the minimum), a null's value is
    0, and the validity key (more significant) places nulls by
    ``nulls_first``."""
    if v.is_floating_point():
        v = torch.where(torch.isnan(v), float("inf"), v) + 0.0
        if desc:
            v = -v
    elif desc:
        v = torch.bitwise_not(v)
    v = torch.where(valid, v, torch.zeros((), dtype=v.dtype, device=v.device))
    null_key = torch.where(valid, 0, -1 if nulls_first else 1).to(torch.int8)
    return [v, null_key]


class DeviceJoinTopNRun(DeviceJoinGroupedRun):
    """Join + grouped aggregate + ORDER BY + LIMIT on the device: the group
    tables never leave the card; stable sorts over the cap-length planes
    pick the K winners and only their rows are copied back. That is what
    makes groupbys of an order key's cardinality (TPC-H q3, q10: up to
    millions of groups) a device run: the full-table copy that rules out the
    plain grouped path shrinks to K rows.

    The sort is the reference's ``jax.lax.sort`` over (present, keys...,
    gid), which is XLA's, not a Pallas kernel: here stable ``torch.sort``
    passes from the last key to the first over a permutation that starts as
    ``arange(cap)``, so the dense first-occurrence group id breaks ties, as
    the host's stable sort over first-occurrence groups does. Each key takes
    two passes in the host's terms (``_sort_passes``): its value, in the
    dtype that orders it exactly, then its validity. One fact batch
    only: a second raises DeviceFallback before it launches anything."""

    max_segments = TOPN_MAX_SEGMENTS
    force_host_codes = True

    def __init__(self, stage: GroupedAggStage, ctx: _JoinContext, topn: TopNSpec):
        super().__init__(stage, ctx)
        self.topn = topn

    def feed_batch(self, batch) -> None:
        if self._pending and batch.num_rows:
            raise DeviceFallback("device TopN path requires a single fact batch")
        super().feed_batch(batch)

    def finalize_topn(self):
        """(key_rows, agg_results) of the K winners, in output order."""
        stage = self.stage
        pending, self._pending = self._pending, []
        self._row_offset = 0
        counters.bump("device_stage_runs")
        if not pending:
            return [], [(np.empty(0), np.empty(0, dtype=bool)) for _ in stage.aggs]
        (out, decode), = pending
        fc, cap = decode.fact_codes, decode.cap
        k_eff = min(self.topn.offset + self.topn.limit, cap)
        mm = out["mm"]
        present = mm[:, 0] > 0
        # sort keys from the most significant: present, then per column its
        # validity before its value
        terms = [(~present).to(torch.int8)]
        for kind, idx, desc, nulls_first in self.topn.keys:
            v, valid = _agg_sort_plane(stage, out, idx) if kind == "agg" \
                else fc.rank_plane(idx)
            value_key, null_key = _sort_passes(v, valid, desc, nulls_first)
            terms += [null_key, value_key]
        perm = torch.arange(cap, device=mm.device)
        for t in reversed(terms):
            perm = perm[torch.sort(t[perm], stable=True).indices]
        top = perm[:k_eff]
        # the winners' rows in one copy: every column as f64, the int64 ones
        # (ids, int64 extremes) by their bits
        cols = [top.view(torch.float64), present[top].to(torch.float64)]
        cols += [mm[top, j] for j in range(mm.shape[1])]
        cols += [e[top] for e in out["ext"]]
        cols += [sct[top].view(torch.float64) for sct in out["sct"]]
        host = torch.stack(cols, dim=1).cpu().numpy()
        counters.bump("device_topn_runs")
        rows = host[self.topn.offset:]
        rows = rows[rows[:, 1] > 0]
        gids = np.ascontiguousarray(rows[:, 0]).view(np.int64)
        n_mm, n_ext = mm.shape[1], len(out["ext"])
        mm_rows = rows[:, 2:2 + n_mm]
        ext_rows = [rows[:, 2 + n_mm + j] for j in range(n_ext)]
        sct_rows = [np.ascontiguousarray(rows[:, 2 + n_mm + n_ext + j]).view(np.int64)
                    for j in range(len(out["sct"]))]
        return fc.rows_for(gids), results_from_tables(stage, mm_rows, ext_rows, sct_rows)


def try_capture_join_topn(plan):
    """Match TopN <- [column Project]* <- grouped Aggregate <- star-join
    tree into (JoinAggSpec, TopNSpec, out_map), or None; out_map gives each
    output column of the TopN as ("agg" | "group", index)."""
    from ..plan import logical as lp

    projections: List[Dict[str, str]] = []
    src = plan.input
    while isinstance(src, lp.Project):
        mapping: Dict[str, str] = {}
        for p in src.projection:
            inner = p.child if isinstance(p, Alias) else p
            if not isinstance(inner, ColumnRef):
                return None
            mapping[p.name()] = inner._name
        projections.append(mapping)
        src = src.input
    if not isinstance(src, lp.Aggregate) or not src.groupby:
        return None
    jspec = try_capture_join_agg(src)
    if jspec is None:
        return None

    def resolve(name: str) -> str:
        for m in projections:  # outermost first
            name = m.get(name, name)
        return name

    def place(name: str) -> Optional[Tuple[str, int]]:
        nm = resolve(name)
        if nm in agg_names:
            return "agg", agg_names.index(nm)
        if nm in gb_names:
            return "group", gb_names.index(nm)
        return None

    agg_names = [a.name() for a in jspec.aggregations]
    gb_names = [g.name() for g in jspec.groupby]
    keys: List[Tuple[str, int, bool, bool]] = []
    for e, desc, nf in zip(plan.sort_by, plan.descending, plan.nulls_first):
        node = e.child if isinstance(e, Alias) else e
        where = place(node._name) if isinstance(node, ColumnRef) else None
        if where is None:
            return None
        keys.append(where + (bool(desc), bool(nf)))
    if plan.limit + plan.offset > 4096:
        return None
    out_map = [place(f.name) for f in plan.schema]
    if any(m is None for m in out_map):
        return None
    return jspec, TopNSpec(keys, plan.limit, plan.offset), out_map


class DeviceJoinUngroupedRun(FilterAggRun):
    """FilterAggRun over gather-joined columns (TPC-H q14, q19): the same
    stage program and finalize; only column provisioning differs."""

    def __init__(self, stage, ctx: _JoinContext):
        super().__init__(stage, ctx.device)
        self.ctx = ctx

    def feed_batch(self, batch) -> None:
        n = batch.num_rows
        if n == 0:
            return
        bucket = pad_bucket(n)
        dcols, _codes = self.ctx.provision(batch, bucket,
                                           list(self.stage._input_cols) + ["__join_ok__"])
        self._run(dcols, n, bucket)
        counters.bump("device_join_batches")
