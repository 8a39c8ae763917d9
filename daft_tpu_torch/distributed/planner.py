"""The distributed planner: a physical plan cut into shuffle-separated
stages (counterpart of daft_tpu/distributed/planner.py).

- ``distribute(ctx, node)`` returns the plan's fragments, one per
  partition, and the hash partitioning their outputs satisfy.
- Map operators (project, filter, explode, ...) compose into the fragments.
- An exchange (a join's or grouped aggregation's input not already
  co-partitioned, a hash repartition) runs at once as a stage of
  ShuffleWrite tasks on the worker pool; the fragments after it read their
  partition through a ShuffleRead.
- ``localize()`` replaces each largest distributable subtree with an
  InMemoryScan of its distributed result; the coordinator runs the rest (sorts,
  windows, writes, the device join stages) itself.

A grouped aggregation is two-phase through plan/agg_split.py: partial
aggregations per fragment, a hash shuffle on the keys, final aggregations.
A DeviceGroupedAgg keeps its partial phase a DeviceGroupedAgg, which each
worker runs on its own device (the coordinator's, handed over by the pool) or,
under device_mode "off", on the host; a DeviceUdfProject stays a map node.
"""

from __future__ import annotations

import itertools
import uuid
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..cancellation import raise_if_cancelled
from ..core.micropartition import MicroPartition
from ..core.recordbatch import RecordBatch
from ..expressions.expressions import Alias, ColumnRef
from ..observability.metrics import registry
from ..plan import physical as pp
from ..utils.env import env_int
from .shuffle import ShuffleDataLost, ShufflePeerUnreachable
from .task import SubPlanTask


@dataclass
class DistContext:
    pool: object               # WorkerPool
    shuffle_dir: str
    n_partitions: int
    # fetch-server endpoints [(host, port, authkey_hex)]; when set, reduce
    # tasks read shuffle partitions over the socket tier, never the local dir
    fetch_endpoints: Optional[list] = None
    # QueryTrace (distributed/trace.py): when set, every stage's tasks are
    # stamped with the query's trace context and their runtime stats recorded
    trace: Optional[object] = None
    # StageCheckpointer (checkpoint/stages.py) — None unless
    # DAFT_TPU_CHECKPOINT_DIR is set AND the plan fingerprinted (the
    # zero-overhead gate lives in DistributedRunner)
    ckpt: Optional[object] = None
    _task_seq: itertools.count = None  # type: ignore[assignment]
    _stage_seq: itertools.count = None  # type: ignore[assignment]
    _run_tag: str = ""
    shuffle_ids: List[str] = None  # type: ignore[assignment]
    # shuffle lineage: shuffle_id -> {map_id: SubPlanTask}, retained for the
    # query's lifetime so lost map outputs can be re-executed from their
    # original plan blobs (the task -> plan_blob -> output partitions chain)
    lineage: Dict[str, dict] = None  # type: ignore[assignment]
    # bounded regeneration budget (DAFT_TPU_SHUFFLE_REGEN_ROUNDS, default 2):
    # each lost-data recovery consumes one round; exhaustion fails the query
    # cleanly instead of looping against a flapping cluster
    regen_rounds_left: int = 0
    # checkpoint keying state: subtree-scoped so stage keys are deterministic
    # regardless of how many earlier subtrees were resumed from checkpoints
    _subtree_seq: itertools.count = None  # type: ignore[assignment]
    ckpt_subtree: str = ""
    ckpt_shuffle_seq: int = 0

    def __post_init__(self):
        self._task_seq = itertools.count()
        self._stage_seq = itertools.count()
        self._subtree_seq = itertools.count()
        # unique per context: a reused pool must never confuse this run's task
        # ids with a previous query's (stale-result isolation)
        self._run_tag = uuid.uuid4().hex[:8]
        self.shuffle_ids = []
        self.lineage = {}
        self.regen_rounds_left = env_int("DAFT_TPU_SHUFFLE_REGEN_ROUNDS", 2,
                                         lo=0)

    def task_id(self, prefix: str) -> str:
        return f"{prefix}-{self._run_tag}-{next(self._task_seq)}"

    def stage_id(self, kind: str) -> str:
        return f"{kind}:{next(self._stage_seq)}"


@dataclass
class Partitioned:
    fragments: List[pp.PhysicalPlan]
    # hash-partition property: column names the fragments are co-partitioned on
    # (None = unknown/none). Only ever set for fragment lists of length
    # ctx.n_partitions produced by a shuffle (or preserved through map ops).
    partitioned_by: Optional[Tuple[str, ...]] = None


_MAP_NODES = (pp.Project, pp.PhysFilter, pp.UDFProject, pp.DeviceUdfProject,
              pp.PhysExplode, pp.PhysUnpivot, pp.PhysSample)
_SUPPORTED = _MAP_NODES + (pp.InMemoryScan, pp.StreamingScan, pp.HashJoin,
                           pp.HashAggregate, pp.PhysRepartition, pp.Dedup,
                           pp.DeviceGroupedAgg)


def subtree_distributable(node: pp.PhysicalPlan) -> bool:
    for n in node.walk():
        if not isinstance(n, _SUPPORTED):
            return False
        if isinstance(n, pp.StreamingScan) and n.post_limit is not None:
            return False
        if isinstance(n, pp.PhysRepartition) and n.scheme not in ("hash",):
            return False
        if isinstance(n, pp.HashJoin) and n.how == "cross":
            return False
    return True


def worth_distributing(node: pp.PhysicalPlan, min_rows: int = 0) -> bool:
    """Only ship subtrees containing an exchange-heavy op; pure scans/maps are
    cheaper executed in-process than serialized across workers.
    DeviceGroupedAgg counts: it IS a grouped aggregation (the device-lowered
    form), and omitting it silently kept every plain groupby on the coordinator."""
    return any(isinstance(n, (pp.HashJoin, pp.HashAggregate, pp.PhysRepartition,
                              pp.Dedup, pp.DeviceGroupedAgg))
               for n in node.walk())


def _fingerprint(ctx: DistContext, frag: pp.PhysicalPlan):
    """Residency fingerprint for one fragment — but ONLY once some worker
    actually holds planes (a non-empty heartbeat digest). On a cold pool every
    digest is empty and affinity can never hit, so skipping the fingerprint
    skips its content-hash pass over the fragment's input columns on the
    dispatch path; from the second query on, the hashes are computed (and
    memoized per Series) exactly when they can pay off."""
    from .affinity import plan_fingerprint

    try:
        workers = getattr(ctx.pool, "workers", {}).values()
        if not any(getattr(w, "last_digest", None) for w in workers):
            return ()
    except Exception:  # lint: ignore[broad-except] -- affinity fingerprint is advisory
        return ()
    return plan_fingerprint(frag)


def localize(ctx: DistContext, node: pp.PhysicalPlan) -> pp.PhysicalPlan:
    """Replace maximal distributable subtrees with their distributed results."""
    if subtree_distributable(node) and worth_distributing(node):
        parts = run_distributed(ctx, node)
        return pp.InMemoryScan(parts, node.schema)
    if isinstance(node, pp.PhysConcat):
        node.inputs = [localize(ctx, c) for c in node.inputs]
        return node
    if isinstance(node, (pp.HashJoin, pp.CrossJoin)):
        node.left = localize(ctx, node.left)
        node.right = localize(ctx, node.right)
        return node
    if hasattr(node, "input"):
        node.input = localize(ctx, node.input)
    return node


def _run_stage_recovering(ctx: DistContext, make_tasks, stage: str):
    """Run one task stage with lost-shuffle recovery: a reduce-side
    ShuffleDataLost (precise missing map ids) or ShufflePeerUnreachable
    (whole peer gone — every map of the shuffle is suspect) re-executes the
    lost map tasks from lineage on the surviving workers, then retries the
    stage with FRESH task ids (a stale in-flight result from the aborted
    attempt can never be mistaken for the retry's). Bounded by
    ctx.regen_rounds_left; exhaustion raises the final loss cleanly.

    `make_tasks` builds the stage's task list — called once per attempt so
    retries are new task objects, never mutated reruns. Returns
    (tasks, results)."""
    while True:
        raise_if_cancelled()
        tasks = make_tasks()
        try:
            return tasks, ctx.pool.run_tasks(tasks, stage_id=stage,
                                             trace=ctx.trace)
        except (ShuffleDataLost, ShufflePeerUnreachable) as e:
            if ctx.regen_rounds_left <= 0:
                raise
            ctx.regen_rounds_left -= 1
            lost = e.map_ids if isinstance(e, ShuffleDataLost) else None
            _regenerate_maps(ctx, e.shuffle_id, lost, cause=e)


def _regenerate_maps(ctx: DistContext, shuffle_id: str,
                     map_ids: Optional[Tuple[int, ...]], cause) -> None:
    """Re-execute lost map tasks (map_ids; None = all of the shuffle) from
    lineage on the surviving workers. The regenerated outputs publish under
    the same deterministic file names (atomic tmp+rename), so the retried
    reduce simply finds them."""
    lin = ctx.lineage.get(shuffle_id)
    if lin is None:
        raise RuntimeError(
            f"shuffle {shuffle_id} data lost and no lineage retained — "
            f"cannot regenerate") from cause
    originals = lin["tasks"]
    wanted = sorted(originals) if map_ids is None else sorted(map_ids)
    missing = [m for m in wanted if m not in originals]
    if missing:
        raise RuntimeError(
            f"shuffle {shuffle_id}: lost map ids {missing} unknown to "
            f"lineage — cannot regenerate") from cause
    stage = ctx.stage_id("regen")

    def make_tasks():
        return [
            SubPlanTask(task_id=ctx.task_id("regen"),
                        plan_blob=originals[m].plan_blob,
                        strategy=originals[m].strategy,
                        priority=originals[m].priority,
                        stage_id=stage,
                        rfingerprint=originals[m].rfingerprint)
            for m in wanted
        ]

    # the regen stage runs under the same recovery wrapper: its map tasks may
    # themselves read an EARLIER shuffle whose files were on the dead worker
    # (cascading lineage replay, still bounded by regen_rounds_left)
    _run_stage_recovering(ctx, make_tasks, stage)
    registry().inc("shuffle_maps_regenerated_total", len(wanted))
    if ctx.trace is not None:
        ctx.trace.note_recovery("maps_regenerated", len(wanted))


def run_distributed(ctx: DistContext, node: pp.PhysicalPlan) -> List[MicroPartition]:
    """Distribute a subtree and run its final fragments as a task stage.

    Shuffle intermediates for this subtree are deleted once the results are
    gathered (reference: cluster-wide shuffle dir cleanup on plan end,
    daft/runners/flotilla.py:70-106).

    With checkpointing armed (ctx.ckpt), a subtree whose result was committed
    by a previous run of the same plan fingerprint is restored wholesale —
    no stages run; otherwise the gathered result is committed at the
    boundary so a later re-submission can skip it.
    """
    from . import shuffle as shf

    subtree_key = None
    if ctx.ckpt is not None:
        idx = next(ctx._subtree_seq)
        ctx.ckpt_subtree = f"subtree-{idx}"
        ctx.ckpt_shuffle_seq = 0
        subtree_key = f"{ctx.ckpt_subtree}/result"
        restored = ctx.ckpt.restore_result(subtree_key, node.schema)
        if restored is not None:
            return restored
    try:
        dist = distribute(ctx, node)
        stage = ctx.stage_id("final")

        def make_tasks():
            return [SubPlanTask.from_plan(ctx.task_id("final"), frag,
                                          stage_id=stage,
                                          rfingerprint=_fingerprint(ctx, frag))
                    for frag in dist.fragments]

        tasks, results = _run_stage_recovering(ctx, make_tasks, stage)
        parts: List[MicroPartition] = []
        for t in tasks:  # preserve fragment order
            parts.extend(results[t.task_id].partitions)
        parts = parts or [MicroPartition(node.schema, [])]
        if subtree_key is not None:
            ctx.ckpt.commit_result(subtree_key, parts)
        return parts
    finally:
        for sid in ctx.shuffle_ids:
            shf.cleanup(ctx.shuffle_dir, sid)
            ctx.lineage.pop(sid, None)
        ctx.shuffle_ids.clear()


def distribute(ctx: DistContext, node: pp.PhysicalPlan) -> Partitioned:
    N = ctx.n_partitions

    if isinstance(node, pp.InMemoryScan):
        groups = _split_partitions(node.partitions, N, node.schema)
        return Partitioned([pp.InMemoryScan(g, node.schema) for g in groups])

    if isinstance(node, pp.StreamingScan):
        if len(node.tasks) <= 1:
            return Partitioned([node])
        groups = [node.tasks[i::N] for i in range(min(N, len(node.tasks)))]
        return Partitioned([pp.StreamingScan(g, node.schema, node.post_filter, None)
                            for g in groups if g])

    if isinstance(node, _MAP_NODES):
        child = distribute(ctx, node.input)
        frags = []
        for f in child.fragments:
            clone = _clone_unary(node, f)
            frags.append(clone)
        keep = child.partitioned_by
        if keep is not None and not set(keep).issubset(set(node.schema.column_names())):
            keep = None  # partition keys projected away
        return Partitioned(frags, keep)

    if isinstance(node, pp.PhysRepartition):
        child = distribute(ctx, node.input)
        keys = _key_names(node.by)
        reads = _shuffle(ctx, child.fragments, node.by, node.schema)
        return Partitioned(reads, keys)

    if isinstance(node, pp.Dedup):
        # co-partition on the dedup keys, then dedup each partition independently
        child = distribute(ctx, node.input)
        from ..expressions.expressions import col as _col

        on = node.on or [_col(c) for c in node.input.schema.column_names()]
        keys = _key_names(on)
        if child.partitioned_by is None or child.partitioned_by != keys:
            reads = _shuffle(ctx, child.fragments, on, node.input.schema)
        else:
            reads = child.fragments
        return Partitioned([pp.Dedup(f, node.on, node.schema) for f in reads], keys)

    if isinstance(node, pp.HashJoin):
        left = distribute(ctx, node.left)
        # broadcast join: a build side small enough to replicate skips BOTH
        # shuffles — every left fragment joins against the full right sub-plan
        # (reference: pipeline_node/join broadcast variant + the 10MiB
        # broadcast_join_size_bytes default)
        from ..config import execution_config

        r_bytes = _phys_bytes_estimate(node.right)
        if (node.how in ("inner", "left", "semi", "anti")
                and r_bytes is not None
                and r_bytes <= execution_config().broadcast_join_size_bytes):
            frags = [_join(node, lf, node.right) for lf in left.fragments]
            keep = left.partitioned_by
            if keep is not None and not set(keep).issubset(set(node.schema.column_names())):
                keep = None
            return Partitioned(frags, keep)
        right = distribute(ctx, node.right)
        lkeys = _key_names(node.left_on)
        rkeys = _key_names(node.right_on)
        if left.partitioned_by is None or left.partitioned_by != lkeys:
            lfrags = _shuffle(ctx, left.fragments, node.left_on, node.left.schema)
        else:
            lfrags = left.fragments
        if right.partitioned_by is None or right.partitioned_by != rkeys:
            rfrags = _shuffle(ctx, right.fragments, node.right_on, node.right.schema)
        else:
            rfrags = right.fragments
        frags = [_join(node, lf, rf) for lf, rf in zip(lfrags, rfrags)]
        out_keys = lkeys if lkeys and set(lkeys).issubset(set(node.schema.column_names())) else None
        return Partitioned(frags, out_keys)

    if isinstance(node, pp.DeviceGroupedAgg):
        # workers keep the device stage: each worker's executor runs it on
        # the device its lease names (device_mode and device from the pool),
        # or on the host in a worker without a lease. The partial phase stays
        # a DeviceGroupedAgg while the split aggregations still build a stage
        from ..ops.grouped_stage import try_build_grouped_agg_stage

        def device_frag(f, groupby, aggs, schema):
            if try_build_grouped_agg_stage(f.schema, node.predicate,
                                           groupby, aggs) is not None:
                return pp.DeviceGroupedAgg(f, node.predicate, groupby, aggs,
                                           schema, node.region_ops)
            inner = f
            if node.predicate is not None:
                inner = pp.PhysFilter(inner, node.predicate, inner.schema)
            return pp.HashAggregate(inner, groupby, aggs, schema)

        def raw_frag(f):
            if node.predicate is not None:
                return pp.PhysFilter(f, node.predicate, f.schema)
            return f

        return _two_phase_agg(ctx, node, device_frag, raw_frag)

    if isinstance(node, pp.HashAggregate):
        return _two_phase_agg(
            ctx, node,
            lambda f, groupby, aggs, schema: pp.HashAggregate(
                f, groupby, aggs, schema),
            lambda f: f)

    raise NotImplementedError(f"distribute: unhandled node {type(node).__name__}")


def _two_phase_agg(ctx: DistContext, node, make_leaf, raw_frag) -> Partitioned:
    """Shared grouped-aggregation distribution (HashAggregate and
    DeviceGroupedAgg differ only in the leaf-agg constructor):
    co-partitioned -> aggregate in place; splittable -> partial per fragment,
    shuffle on keys, final combine; unsplittable -> shuffle raw rows."""
    from ..expressions.expressions import col as _col
    from ..plan.agg_split import split_aggs

    child = distribute(ctx, node.input)
    keys = _key_names(node.groupby)
    if child.partitioned_by is not None and child.partitioned_by == keys:
        frags = [make_leaf(f, node.groupby, node.aggregations, node.schema)
                 for f in child.fragments]
        return Partitioned(frags, keys)
    split = split_aggs(node.aggregations)
    if split is not None:
        partial_schema = _agg_schema(node.input.schema, node.groupby, split.partial)
        partials = [make_leaf(f, node.groupby, split.partial, partial_schema)
                    for f in child.fragments]
        key_cols = [_col(e.name()) for e in node.groupby]
        reads = _shuffle(ctx, partials, key_cols, partial_schema)
        frags = []
        for r in reads:
            final = pp.HashAggregate(
                r, key_cols, split.final,
                _agg_schema(partial_schema, key_cols, split.final))
            frags.append(pp.Project(final, key_cols + _typed(split.projection, node.schema),
                                    node.schema))
        return Partitioned(frags, keys)
    # unsplittable aggs (e.g. count_distinct): shuffle raw rows by key
    reads = _shuffle(ctx, [raw_frag(f) for f in child.fragments],
                     node.groupby, node.input.schema)
    frags = [pp.HashAggregate(r, node.groupby, node.aggregations, node.schema)
             for r in reads]
    return Partitioned(frags, keys)


def _shuffle(ctx: DistContext, fragments: List[pp.PhysicalPlan], by,
             schema) -> List[pp.PhysicalPlan]:
    """Run a shuffle stage: wrap each fragment in ShuffleWrite, execute on the
    pool, return per-partition ShuffleRead fragments.

    Fault-tolerance bookkeeping: the map tasks are registered in
    ctx.lineage[sid] BEFORE the stage runs (regeneration source), and each
    reduce partition's ShuffleRead carries the expected map ids derived from
    the map results' rows-per-partition — the completeness contract that
    turns a dead worker's missing files into a ShuffleDataLost the recovery
    loop can act on. With checkpointing armed, a committed stage restores
    its files instead of re-running, and a fresh run commits at the boundary.
    """
    ckpt_key = None
    if ctx.ckpt is not None:
        ckpt_key = f"{ctx.ckpt_subtree}/shuffle-{ctx.ckpt_shuffle_seq}"
        ctx.ckpt_shuffle_seq += 1
        restored = ctx.ckpt.restore_shuffle(ckpt_key, ctx.shuffle_dir)
        if restored is not None:
            rsid, rexpected = restored
            ctx.shuffle_ids.append(rsid)
            return _shuffle_reads(ctx, rsid, schema, rexpected)
    sid = uuid.uuid4().hex[:12]
    ctx.shuffle_ids.append(sid)
    stage = ctx.stage_id("shuffle")

    def make_tasks():
        tasks = [
            SubPlanTask.from_plan(
                ctx.task_id("shuffle"),
                pp.ShuffleWrite(frag, sid, map_id=i,
                                num_partitions=ctx.n_partitions,
                                by=list(by), shuffle_dir=ctx.shuffle_dir,
                                schema=schema),
                stage_id=stage,
                # residency fingerprint of the map fragment (the device planes
                # its partial-agg stage would probe): repeat shuffles of a
                # resident table stick to the workers already holding them
                rfingerprint=_fingerprint(ctx, frag))
            for i, frag in enumerate(fragments)
        ]
        # lineage registered pre-run: keyed by map id so a retried attempt
        # (fresh task ids) overwrites in place
        ctx.lineage[sid] = {"stage": stage,
                            "tasks": {i: t for i, t in enumerate(tasks)}}
        return tasks

    tasks, results = _run_stage_recovering(ctx, make_tasks, stage)
    # derive per-partition expected maps from the lineage records the map
    # tasks shipped back (rows written per partition — a map that wrote no
    # rows for partition p legitimately has no file there)
    rows_by_map: Dict[int, List[int]] = {}
    for t in tasks:
        res = results[t.task_id]
        for mo in res.map_outputs:
            if mo.get("shuffle_id") == sid:
                rows_by_map[int(mo["map_id"])] = list(mo.get("rows", ()))
    expected = {
        p: tuple(sorted(m for m, rows in rows_by_map.items()
                        if p < len(rows) and rows[p] > 0))
        for p in range(ctx.n_partitions)
    }
    if ckpt_key is not None:
        ctx.ckpt.commit_shuffle(ckpt_key, ctx.shuffle_dir, sid, expected)
    return _shuffle_reads(ctx, sid, schema, expected)


def _shuffle_reads(ctx: DistContext, sid: str, schema,
                   expected: Dict[int, tuple]) -> List[pp.PhysicalPlan]:
    """The reduce-side fragments of a shuffle — ONE construction site for
    both the fresh and checkpoint-restored paths, so transport selection and
    the expected-maps completeness contract can never drift between them."""
    return [pp.ShuffleRead(sid, p,
                           "" if ctx.fetch_endpoints else ctx.shuffle_dir,
                           schema, ctx.fetch_endpoints,
                           expected_maps=expected.get(p))
            for p in range(ctx.n_partitions)]


def _phys_bytes_estimate(node: pp.PhysicalPlan) -> Optional[int]:
    """Upper-bound byte estimate for a physical subtree (broadcast decisions).
    Exact for in-memory sources; filters/projects pass through (upper bound);
    unknown sources return None (never broadcast blindly)."""
    if isinstance(node, pp.InMemoryScan):
        total = 0
        for p in node.partitions:
            for b in p.batches:
                total += b.size_bytes()
        return total
    if isinstance(node, pp.StreamingScan):
        sizes = [getattr(t, "size_bytes", None) for t in node.tasks]
        if any(s is None for s in sizes):
            return None
        return int(sum(sizes))
    if isinstance(node, (pp.Project, pp.PhysFilter, pp.PhysLimit, pp.PhysSample)):
        return _phys_bytes_estimate(node.input)
    return None


def _join(node: pp.HashJoin, left, right) -> pp.HashJoin:
    return pp.HashJoin(left, right, node.left_on, node.right_on, node.merged_keys,
                       node.right_rename, node.schema, node.how, node.null_equals_null)


def _typed(projection, schema):
    """The final projection's expressions, each cast to its output field's
    type (a count's partial counts sum to a count again)."""
    return [e.cast(schema[e.name()].dtype).alias(e.name()) for e in projection]


def _key_names(exprs) -> Optional[Tuple[str, ...]]:
    names = []
    for e in exprs:
        node = e.child if isinstance(e, Alias) else e
        if not isinstance(node, ColumnRef):
            return None
        names.append(e.name())
    return tuple(names)


def _clone_unary(node, new_input):
    import copy

    clone = copy.copy(node)
    clone.input = new_input
    return clone


def _agg_schema(in_schema, groupby, aggs):
    from ..schema import Schema

    fields = [e.to_field(in_schema) for e in list(groupby) + list(aggs)]
    return Schema(fields)


def _split_partitions(partitions, n: int, schema) -> List[List[MicroPartition]]:
    """Round-robin micropartitions into n groups; a single big partition is
    sliced by rows so every worker gets real work."""
    parts = [p for p in partitions if p.num_rows > 0]
    if not parts:
        return [[MicroPartition(schema, [])]]
    if len(parts) < n:
        batches = [b for p in parts for b in p.batches if b.num_rows > 0]
        total = sum(b.num_rows for b in batches)
        if total == 0:
            return [[MicroPartition(schema, [])]]
        big = RecordBatch.concat(batches) if len(batches) > 1 else batches[0]
        step = (total + n - 1) // n
        groups = []
        for s in range(0, total, step):
            groups.append([MicroPartition(schema, [big.slice(s, min(s + step, total))])])
        return groups
    return [parts[i::n] for i in range(n)]
