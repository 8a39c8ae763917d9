"""The distributed workers (daft_tpu_torch/distributed/) against the
reference's (counterpart of tests/test_distributed_engine.py).

The scheduler's placement rules run hermetically on both packages'
``Scheduler`` with the same mock workers and must decide alike. End to
end, the same seeded columns go through the reference's single-process
run (``daft_tpu``'s NativeRunner) and through the port's
``DistributedRunner`` on real worker processes (fresh subprocesses over a
UNIX socket, device="cpu": a leased worker runs its device stages on the
CPU), and their ``to_pydict`` must agree: keys, counts and integer
aggregates exactly, float sums within rtol 1e-12 (1e-9 where the
partitioning changes the summation order, as the reference's own test
allows). A device stage holds float columns as f32 planes, so where one
runs, float sums agree with the port's single-process run within 1e-12
and with the reference's host sums within 1e-5 (the reference's own
device-vs-host tolerance; test_torch_tpch_sweep.py's too). One worker pool per module serves every end-to-end test that
needs no setting of its own (each spawn imports torch).
"""

import os
import sys
import time

import numpy as np
import pytest

import daft_tpu
import daft_tpu.distributed.scheduler as ref_sched
import daft_tpu.distributed.task as ref_task
import daft_tpu_torch
import daft_tpu_torch.distributed.scheduler as port_sched
import daft_tpu_torch.distributed.task as port_task
import daft_tpu_torch.runners as runners
from daft_tpu_torch import col
from daft_tpu_torch.config import execution_config_ctx

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = dict(device="cpu")
# a float sum of a device stage against the reference's host sum: the stage
# holds float columns as f32 planes (the reference's device-vs-host
# tolerance, tests/test_device_path.py)
F32_RTOL = 1e-5


@pytest.fixture(params=["reference", "port"])
def sched(request):
    return ref_sched if request.param == "reference" else port_sched


@pytest.fixture
def task(sched):
    return ref_task if sched is ref_sched else port_task


def _task(task, tid, strategy=None, priority=0, excluded=()):
    return task.SubPlanTask(task_id=tid, plan_blob=b"", strategy=strategy or task.Spread(),
                       priority=priority, excluded_workers=tuple(excluded))


# ---------------------------------------------------------------------------
# Scheduler (hermetic, no processes)
# ---------------------------------------------------------------------------

def test_spread_picks_most_available_slots(sched, task):
    s = sched.Scheduler({"w0": 2, "w1": 4})
    s.submit(_task(task, "t0"))
    [(t, wid)] = s.schedule()
    assert wid == "w1"  # 4 free > 2 free


def test_spread_balances_as_slots_fill(sched, task):
    s = sched.Scheduler({"w0": 2, "w1": 2})
    for i in range(4):
        s.submit(_task(task, f"t{i}"))
    assigned = s.schedule()
    by_worker = {}
    for t, wid in assigned:
        by_worker.setdefault(wid, []).append(t.task_id)
    assert len(assigned) == 4
    assert len(by_worker["w0"]) == 2 and len(by_worker["w1"]) == 2


def test_excess_tasks_stay_pending_until_capacity_frees(sched, task):
    s = sched.Scheduler({"w0": 1})
    s.submit(_task(task, "t0"))
    s.submit(_task(task, "t1"))
    assigned = s.schedule()
    assert [t.task_id for t, _ in assigned] == ["t0"]
    assert s.pending_count() == 1
    assert s.schedule() == []  # still full
    s.task_finished("w0")
    [(t, wid)] = s.schedule()
    assert t.task_id == "t1" and wid == "w0"


def test_priority_order(sched, task):
    s = sched.Scheduler({"w0": 1})
    s.submit(_task(task, "low", priority=10))
    s.submit(_task(task, "high", priority=0))
    [(t, _)] = s.schedule()
    assert t.task_id == "high"


def test_soft_affinity_prefers_worker_but_falls_back(sched, task):
    s = sched.Scheduler({"w0": 1, "w1": 1})
    s.submit(_task(task, "t0", strategy=task.WorkerAffinity("w0")))
    [(_, wid)] = s.schedule()
    assert wid == "w0"
    # w0 now full: soft affinity falls back to any free worker
    s.submit(_task(task, "t1", strategy=task.WorkerAffinity("w0")))
    [(_, wid2)] = s.schedule()
    assert wid2 == "w1"


def test_hard_affinity_waits_for_its_worker(sched, task):
    s = sched.Scheduler({"w0": 1, "w1": 1})
    s.submit(_task(task, "t0", strategy=task.WorkerAffinity("w0", hard=True)))
    [(_, wid)] = s.schedule()
    assert wid == "w0"
    s.submit(_task(task, "t1", strategy=task.WorkerAffinity("w0", hard=True)))
    assert s.schedule() == []  # w1 free but hard affinity refuses it
    s.task_finished("w0")
    [(_, wid2)] = s.schedule()
    assert wid2 == "w0"


def test_excluded_workers_skipped(sched, task):
    s = sched.Scheduler({"w0": 4, "w1": 1})
    s.submit(_task(task, "t0", excluded=["w0"]))
    [(_, wid)] = s.schedule()
    assert wid == "w1"  # w0 has more slots but is excluded (failed there before)


# ---------------------------------------------------------------------------
# Cache-affinity placement (hermetic: fingerprints vs heartbeat digests)
# ---------------------------------------------------------------------------

def _fp_task(task, tid, fp, excluded=()):
    return task.SubPlanTask(task_id=tid, plan_blob=b"", strategy=task.Spread(),
                       rfingerprint=tuple(fp), excluded_workers=tuple(excluded))


def test_soft_affinity_wins_when_slots_free(sched, task):
    """A task whose fingerprint intersects a worker's residency digest lands
    there, even though spread would pick the emptier worker."""
    s = sched.Scheduler({"w0": 4, "w1": 2})
    s.update_residency("w1", [(101, 1 << 20)])
    s.submit(_fp_task(task, "t0", [(101, 1 << 20), (999, 64)]))
    [(_, wid)] = s.schedule()
    assert wid == "w1"
    stats = s.placement_stats()
    assert stats["affinity_hits"] == 1
    assert stats["bytes_avoided"] == 1 << 20


def test_affinity_falls_back_to_spread_when_preferred_full(sched, task):
    """Saturated resident worker: the task spreads instead of waiting (soft
    policy — no head-of-line blocking), recorded as an affinity miss."""
    s2 = sched.Scheduler({"w0": 2, "w1": 1})
    s2.update_residency("w1", [(7, 1 << 20)])
    s2._workers["w1"].active_tasks = 1  # saturated resident worker
    s2.submit(_fp_task(task, "t0", [(7, 1 << 20)]))
    [(_, wid)] = s2.schedule()
    assert wid == "w0"
    stats = s2.placement_stats()
    assert stats["affinity_hits"] == 0 and stats["affinity_misses"] == 1


def test_affinity_load_penalty_prefers_idle_when_overlap_small(sched, task):
    """A tiny resident overlap does not justify queueing behind a loaded
    worker: score = bytes − penalty·load must be positive to win."""
    s = sched.Scheduler({"w0": 4, "w1": 4})
    s.update_residency("w1", [(5, 1024)])  # 1KiB resident, far below penalty
    s._workers["w1"].active_tasks = 2      # loaded but not full
    s.submit(_fp_task(task, "t0", [(5, 1024)]))
    [(_, wid)] = s.schedule()
    assert wid == "w0"  # spread wins: locality value below the load penalty


def test_affinity_respects_excluded_workers(sched, task):
    """A requeued task never returns to the failed worker, resident planes or
    not."""
    s = sched.Scheduler({"w0": 1, "w1": 1})
    s.update_residency("w0", [(42, 1 << 20)])
    s.submit(_fp_task(task, "t0", [(42, 1 << 20)], excluded=["w0"]))
    [(_, wid)] = s.schedule()
    assert wid == "w1"
    assert s.placement_stats()["affinity_hits"] == 0


def test_hard_affinity_blocks_despite_resident_elsewhere(sched, task):
    """Hard affinity still pins to its worker: residency elsewhere is
    irrelevant."""
    s = sched.Scheduler({"w0": 1, "w1": 1})
    s._workers["w0"].active_tasks = 1
    s.update_residency("w1", [(9, 1 << 20)])
    t = task.SubPlanTask(task_id="t0", plan_blob=b"",
                    strategy=task.WorkerAffinity("w0", hard=True),
                    rfingerprint=((9, 1 << 20),))
    s.submit(t)
    assert s.schedule() == []  # waits for w0; never steals w1
    s.task_finished("w0")
    [(_, wid)] = s.schedule()
    assert wid == "w0"


def test_hard_affinity_skip_set_avoids_head_of_line_spin(sched, task):
    """Once one hard-affinity task finds its preferred worker full, later
    heap entries bound to the same worker are requeued without an eligibility
    scan (counted), and all run once the worker frees up."""
    s = sched.Scheduler({"w0": 1, "w1": 1})
    s._workers["w0"].active_tasks = 1
    for i in range(4):
        s.submit(_task(task, f"h{i}", strategy=task.WorkerAffinity("w0", hard=True)))
    assert s.schedule() == []
    # first task discovered the full worker; the other three skipped via the set
    assert s.placement_stats()["affinity_skips"] == 3
    assert s.pending_count() == 4
    s.task_finished("w0")
    done = []
    while s.pending_count():
        for t, wid in s.schedule():
            assert wid == "w0"
            done.append(t.task_id)
            s.task_finished("w0")
    assert sorted(done) == ["h0", "h1", "h2", "h3"]


def test_hard_affinity_excluded_pref_does_not_poison_skip_set(sched, task):
    """A hard-affinity task whose preferred worker is merely EXCLUDED (after a
    requeue) must not block siblings whose affinity to that worker is
    satisfiable — only a genuinely full worker enters the skip set."""
    s = sched.Scheduler({"w0": 1, "w1": 1})
    # t_excluded pops first (lower seq) and cannot run on w0; t_ok can
    t_excl = task.SubPlanTask(task_id="t_excl", plan_blob=b"",
                         strategy=task.WorkerAffinity("w0", hard=True),
                         excluded_workers=("w0",))
    t_ok = task.SubPlanTask(task_id="t_ok", plan_blob=b"",
                       strategy=task.WorkerAffinity("w0", hard=True))
    s.submit(t_excl)
    s.submit(t_ok)
    assigned = {t.task_id: wid for t, wid in s.schedule()}
    assert assigned == {"t_ok": "w0"}  # w0 had a slot; t_ok was not starved
    assert s.placement_stats()["affinity_skips"] == 0




# ---------------------------------------------------------------------------
# End to end on a real worker pool
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dist_runner():
    from daft_tpu_torch.distributed import DistributedRunner

    with execution_config_ctx(**CPU):
        r = DistributedRunner(num_workers=2, n_partitions=3)
        r._ensure_pool()
    yield r
    r.shutdown()


def _run_port(df_build, runner=None):
    """The port's answer: single-process, or through ``runner``."""
    with execution_config_ctx(**CPU):
        if runner is None:
            return df_build().to_pydict()
        runners.set_runner(runner)
        try:
            return df_build().to_pydict()
        finally:
            runners.set_runner(None)


def _close(got, want, rtol, ints=()):
    assert list(got) == list(want)
    for c in want:
        if c in ints or not any(isinstance(v, float) for v in want[c]):
            assert got[c] == want[c], c
        else:
            np.testing.assert_allclose(np.array(got[c], dtype=float),
                                       np.array(want[c], dtype=float), rtol=rtol,
                                       err_msg=c)


def _groupby_cols(seed=0, n=10_000):
    rng = np.random.default_rng(seed)
    return {"k": rng.choice(["a", "b", "c", "d", "e"], n).tolist(),
            "v": rng.uniform(0, 100, n).tolist()}


def test_distributed_groupby_matches_reference(dist_runner):
    data = _groupby_cols()

    def q(pkg):
        return (pkg.from_pydict(data).groupby("k")
                .agg(pkg.col("v").sum().alias("s"), pkg.col("v").mean().alias("m"),
                     pkg.col("v").count().alias("c"), pkg.col("v").min().alias("lo"),
                     pkg.col("v").max().alias("hi"))
                .sort("k"))

    want = q(daft_tpu).to_pydict()
    got = _run_port(lambda: q(daft_tpu_torch), dist_runner)
    _close(got, want, 1e-12, ints=("k", "c", "lo", "hi"))
    assert dist_runner.last_trace is None  # untraced: the zero-overhead path


def test_distributed_join_matches_reference(dist_runner):
    rng = np.random.default_rng(1)
    n = 5_000
    left = {"id": rng.integers(0, 1000, n).tolist(), "x": rng.uniform(0, 10, n).tolist()}
    right = {"id": list(range(1000)), "name": [f"n{i}" for i in range(1000)]}

    def q(pkg):
        return (pkg.from_pydict(left).join(pkg.from_pydict(right), on="id")
                .groupby("name").agg(pkg.col("x").sum().alias("sx")).sort("name"))

    want = q(daft_tpu).to_pydict()
    _close(_run_port(lambda: q(daft_tpu_torch), dist_runner), want, 1e-9, ints=("name",))


def test_distributed_shuffled_join_matches_reference(dist_runner, monkeypatch):
    """A right side past ``broadcast_join_size_bytes``: both sides shuffle
    on the key (the co-partitioned join), then the two-phase aggregate."""
    rng = np.random.default_rng(2)
    left = {"id": rng.integers(0, 500, 4000).tolist(), "x": rng.integers(0, 9, 4000).tolist()}
    right = {"id": list(range(500)), "w": rng.integers(0, 100, 500).tolist()}

    def q(pkg):
        return (pkg.from_pydict(left).join(pkg.from_pydict(right), on="id")
                .groupby("w").agg(pkg.col("x").sum().alias("sx"),
                                  pkg.col("id").count().alias("n")).sort("w"))

    want = q(daft_tpu).to_pydict()
    with execution_config_ctx(broadcast_join_size_bytes=0):
        got = _run_port(lambda: q(daft_tpu_torch), dist_runner)
    assert got == want


def _tpch_tables():
    """The reference's SF 0.01 TPC-H tables, carried into the port column
    for column."""
    sys.path.insert(0, REPO)
    from benchmarking.tpch.datagen import load_dataframes
    from daft_tpu_torch.interop import from_numpy_columns

    out = {}
    for name, ref_df in load_dataframes(sf=0.01, seed=0).items():
        batch = ref_df.collect()._result[0].concat_or_empty()
        schema = daft_tpu_torch.Schema.from_pydict(
            {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_df.schema})
        out[name] = from_numpy_columns(
            {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)
    return out


def _port_queries():
    import types

    import benchmarking.tpch.queries as q

    src = open(q.__file__).read().replace("from daft_tpu import", "from daft_tpu_torch import")
    mod = types.ModuleType("port_tpch_queries_dist")
    exec(compile(src, q.__file__, "exec"), mod.__dict__)
    return mod.ALL_QUERIES


@pytest.fixture(scope="module")
def tpch():
    return _tpch_tables(), _port_queries()


@pytest.mark.parametrize("qnum", [1, 3, 5, 10, 12])
def test_distributed_tpch_matches_single_process(dist_runner, tpch, qnum):
    """TPC-H shapes (scan-agg, join-agg-topn, multi-join) through the
    workers equal the port's single-process run (itself held to the
    reference's by tests/test_torch_tpch_sweep.py) within that file's
    tolerance, rtol 1e-5: a device stage computes its float expressions in
    f32, so the sums of another split of the rows round apart."""
    tables, queries = tpch
    want = _run_port(lambda: queries[qnum](tables))
    got = _run_port(lambda: queries[qnum](tables), dist_runner)
    assert list(got) == list(want)
    _close(got, want, 1e-5)


def test_distributed_left_outer_join_matches_reference(dist_runner):
    left = {"id": [1, 2, 3, 4], "x": [1.0, 2.0, 3.0, 4.0]}
    right = {"id": [2, 4, 6], "y": ["b", "d", "f"]}

    def q(pkg):
        return pkg.from_pydict(left).join(pkg.from_pydict(right), on="id",
                                          how="left").sort("id")

    assert _run_port(lambda: q(daft_tpu_torch), dist_runner) == q(daft_tpu).to_pydict()


def test_distributed_dedup_matches_reference(dist_runner):
    data = {"k": ["a", "b", "a", "c", "b", "a"] * 100, "v": list(range(600))}

    def q(pkg):
        return pkg.from_pydict(data).select("k").distinct().sort("k")

    assert _run_port(lambda: q(daft_tpu_torch), dist_runner) == q(daft_tpu).to_pydict()


def _scan_plan(values):
    from daft_tpu_torch.core.micropartition import MicroPartition
    from daft_tpu_torch.plan import physical as pp

    part = MicroPartition.from_pydict({"a": values})
    return pp.InMemoryScan([part], part.schema)


def test_worker_failure_requeues_on_another_worker():
    """A dead worker's tasks run on the other worker (excluded from them)."""
    from daft_tpu_torch.distributed.task import SubPlanTask
    from daft_tpu_torch.distributed.worker import WorkerPool

    pool = WorkerPool(2)
    try:
        plan = _scan_plan([1, 2, 3])
        w0 = pool.workers["worker-0"]
        w0._proc.terminate()
        w0._proc.wait()
        results = pool.run_tasks([SubPlanTask.from_plan(f"t{i}", plan) for i in range(4)])
        assert len(results) == 4
        assert all(r.rows == 3 for r in results.values())
    finally:
        pool.shutdown()


def test_task_error_propagates_with_traceback():
    from daft_tpu_torch.distributed.task import SubPlanTask
    from daft_tpu_torch.distributed.worker import WorkerPool
    from daft_tpu_torch.plan import physical as pp

    scan = _scan_plan([1, 2, 3])
    bad = pp.PhysFilter(scan, col("missing") > 0, scan.schema)
    pool = WorkerPool(1)
    try:
        with pytest.raises(RuntimeError, match="failed on worker-0") as exc:
            pool.run_tasks([SubPlanTask.from_plan("boom", bad)])
        assert "Traceback" in str(exc.value)
    finally:
        pool.shutdown()


def test_socket_shuffle_transport_matches_reference():
    """shuffle_transport="socket": reduce tasks fetch their partitions from
    the fetch server only (their ShuffleRead carries no shuffle_dir)."""
    from daft_tpu_torch.distributed import DistributedRunner

    rng = np.random.default_rng(3)
    n = 8_000
    data = {"k": rng.integers(0, 300, n).tolist(), "v": rng.uniform(0, 10, n).tolist()}
    dim = {"k": list(range(300)), "w": [float(i) for i in range(300)]}

    def q(pkg):
        return (pkg.from_pydict(data).join(pkg.from_pydict(dim), on="k")
                .groupby("k").agg(pkg.col("v").sum().alias("s"),
                                  pkg.col("w").max().alias("mw")).sort("k"))

    want = q(daft_tpu).to_pydict()
    with execution_config_ctx(**CPU):
        r = DistributedRunner(num_workers=2, n_partitions=3, shuffle_transport="socket")
    try:
        got = _run_port(lambda: q(daft_tpu_torch), r)
        assert r._fetch_server.stats()["requests"] > 0
    finally:
        r.shutdown()
    _close(got, want, 1e-12, ints=("k",))


def test_fetch_server_rejects_bad_auth_and_traversal(tmp_path):
    import multiprocessing.connection as mpc

    from daft_tpu_torch.distributed.fetch_server import ShuffleFetchServer

    srv = ShuffleFetchServer(str(tmp_path))
    try:
        host, port, key = srv.endpoint
        with pytest.raises(Exception):
            c = mpc.Client((host, port), family="AF_INET", authkey=b"wrong-key")
            c.close()
        good = mpc.Client((host, port), family="AF_INET", authkey=bytes.fromhex(key))
        good.send(("list", "../etc", 0))
        kind, detail = good.recv()
        assert kind == "error" and "bad shuffle id" in detail
        good.close()
    finally:
        srv.close()


def test_device_nodes_survive_distribution():
    """The partial phase keeps DeviceGroupedAgg in the shipped fragments;
    the partials ran (the final fragments read a shuffle) and the result
    equals the single-process run."""
    from daft_tpu_torch.distributed.planner import DistContext, distribute
    from daft_tpu_torch.distributed.runner import DistributedRunner
    from daft_tpu_torch.plan import physical as pp
    from daft_tpu_torch.plan.optimizer import Optimizer

    rng = np.random.default_rng(3)
    n = 5000
    data = {"k": rng.integers(0, 9, n).tolist(), "v": rng.uniform(0, 1, n).tolist()}

    def q(pkg):
        return (pkg.from_pydict(data).where(pkg.col("v") > 0.2).groupby("k")
                .agg(pkg.col("v").sum().alias("s"), pkg.col("v").count().alias("c"))
                .sort("k"))

    with execution_config_ctx(device_mode="on", **CPU):
        phys = pp.translate(Optimizer().optimize(q(daft_tpu_torch)._plan))
        agg = next(nd for nd in phys.walk() if isinstance(nd, pp.DeviceGroupedAgg))
        r = DistributedRunner(num_workers=2, device_workers=1)
        try:
            pool = r._ensure_pool()
            ctx = DistContext(pool=pool, shuffle_dir=r._shuffle_dir,
                              n_partitions=r.n_partitions)
            dist = distribute(ctx, agg)
            assert any(isinstance(nd, pp.ShuffleRead)
                       for frag in dist.fragments for nd in frag.walk())
            partials = [t for t in ctx.lineage.values()]
            assert partials and all(
                any(isinstance(nd, pp.DeviceGroupedAgg) for nd in t.plan().walk())
                for lin in partials for t in lin["tasks"].values())
            got = _run_port(lambda: q(daft_tpu_torch), r)
            single = _run_port(lambda: q(daft_tpu_torch))
        finally:
            r.shutdown()
    # one leased worker: its partials are f32 device sums, the other's f64
    # host sums, so both comparisons take the device-vs-host tolerance
    _close(got, single, F32_RTOL, ints=("k", "c"))
    _close(got, q(daft_tpu).to_pydict(), F32_RTOL, ints=("k", "c"))


def _worker_h2d(pool, after_ts):
    """Each worker's cumulative upload bytes from beats sent after
    ``after_ts`` (they postdate every upload of the query's tasks)."""
    out = {}
    deadline = time.time() + 20
    while time.time() < deadline and set(out) != set(pool.workers):
        for hb in pool.drain_heartbeats():
            if hb.get("ts", 0.0) > after_ts:
                out[hb["worker_id"]] = hb.get("hbm_h2d_bytes", 0)
        time.sleep(0.05)
    assert set(out) == set(pool.workers), f"missing fresh heartbeats: {out}"
    return out


def test_repeat_query_cache_affinity_two_workers(monkeypatch):
    """The second run of one query places each sub-plan on the worker
    already holding its planes (sched_affinity_hits > 0) and the workers
    upload nothing again (per-worker hbm_h2d_bytes flat), results equal."""
    from daft_tpu_torch.distributed.runner import DistributedRunner
    from daft_tpu_torch.observability.metrics import registry

    monkeypatch.setenv("DAFT_TPU_HEARTBEAT_S", "0.2")
    rng = np.random.default_rng(11)
    n = 20_000
    data = {"k": rng.integers(0, 8, n).tolist(), "v": rng.uniform(0, 1, n).tolist()}

    def q(pkg):
        return (pkg.from_pydict(data).groupby("k")
                .agg(pkg.col("v").sum().alias("s"), pkg.col("v").count().alias("c"))
                .sort("k"))

    with execution_config_ctx(device_mode="on", **CPU):
        r = DistributedRunner(num_workers=2, n_partitions=2, device_workers=2)
        try:
            first = _run_port(lambda: q(daft_tpu_torch), r)
            pool = r._pool
            h2d_first = _worker_h2d(pool, time.time())
            assert any(v > 0 for v in h2d_first.values()), "no upload: no device stage ran"
            before = registry().snapshot()
            second = _run_port(lambda: q(daft_tpu_torch), r)
            diff = registry().diff(before)
            h2d_second = _worker_h2d(pool, time.time())
        finally:
            r.shutdown()
    assert first == second
    _close(first, q(daft_tpu).to_pydict(), F32_RTOL, ints=("k", "c"))
    assert diff.get("sched_affinity_hits", 0) > 0, diff
    assert diff.get("sched_bytes_avoided", 0) > 0, diff
    assert h2d_second == h2d_first


def test_affinity_saturated_worker_no_deadlock():
    """More tasks claiming one worker's (pinned) resident slot than it has
    slots: every task completes, each on some worker. Only what does not
    depend on timing is asserted: how the tasks split between the workers
    depends on when each finishes."""
    from daft_tpu_torch.distributed.task import SubPlanTask
    from daft_tpu_torch.distributed.worker import WorkerPool

    plan = _scan_plan(list(range(64)))
    pool = WorkerPool(2, slots_per_worker=1)
    try:
        w0 = pool.workers["worker-0"]
        w0.last_digest = {12345: 1 << 20}
        w0._note_heartbeat = lambda hb, _w=w0: _w.heartbeats.append(hb)
        tasks = [SubPlanTask.from_plan(f"t{i}", plan) for i in range(6)]
        for t in tasks:
            t.rfingerprint = ((12345, 1 << 20),)
        results = pool.run_tasks(tasks)
        assert sorted(results) == sorted(t.task_id for t in tasks)
        assert all(r.rows == 64 and r.worker_id in pool.workers for r in results.values())
    finally:
        pool.shutdown()


def _spawn_env(pool):
    out = {}
    for wid, w in pool.workers.items():
        with open(f"/proc/{w._proc.pid}/environ", "rb") as f:
            env = dict(x.split(b"=", 1) for x in f.read().split(b"\0") if b"=" in x)
        out[wid] = env
    return out


def _spawn_config(pool):
    import json

    out = {}
    for wid, w in pool.workers.items():
        with open(f"/proc/{w._proc.pid}/cmdline", "rb") as f:
            out[wid] = json.loads(f.read().split(b"\0")[5])
    return out


@pytest.mark.skipif(not sys.platform.startswith("linux"), reason="reads /proc")
def test_device_worker_lease_env():
    """The first ``device_workers`` workers get the coordinator's device_mode in
    DAFT_TPU_DEVICE, the rest "off"; every worker gets the coordinator's device
    on its command line, and the leased ones a share of its budget."""
    from daft_tpu_torch.distributed.worker import WorkerPool

    with execution_config_ctx(device_mode="auto", hbm_budget_bytes=3 << 20, **CPU):
        pool = WorkerPool(3, device_workers=1)
    try:
        modes = {wid: env.get(b"DAFT_TPU_DEVICE", b"").decode()
                 for wid, env in _spawn_env(pool).items()}
        assert modes == {"worker-0": "auto", "worker-1": "off", "worker-2": "off"}
        cfg = _spawn_config(pool)
        assert {c["device"] for c in cfg.values()} == {"cpu"}
        assert cfg["worker-0"]["hbm_budget_bytes"] == (3 << 20) // 2
        assert cfg["worker-1"]["hbm_budget_bytes"] == 3 << 20
    finally:
        pool.shutdown()


@pytest.mark.skipif(not sys.platform.startswith("linux"), reason="reads /proc")
def test_device_lease_shares_budget_with_coordinator():
    """While a pool leases the card to its workers, the coordinator holds one
    share of its budget too: its budget plus the leased workers' stays within
    the budget it had, and shutdown gives the coordinator its whole budget
    back."""
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.distributed.worker import WorkerPool

    budget = 3 << 20
    with execution_config_ctx(device_mode="auto", hbm_budget_bytes=budget, **CPU):
        assert manager().budget_bytes() == budget
        pool = WorkerPool(2, device_workers=2)
        try:
            mine = manager().budget_bytes()
            leased = [c["hbm_budget_bytes"] for c in _spawn_config(pool).values()]
            assert mine == budget // 3 and leased == [budget // 3] * 2
            assert mine + sum(leased) <= budget
        finally:
            pool.shutdown()
        assert manager().budget_bytes() == budget


def test_worker_pool_plumbs_batching_config():
    """The coordinator's batching knobs (set in its config, not its environment)
    reach the workers' command lines."""
    from daft_tpu_torch.distributed.worker import WorkerPool

    with execution_config_ctx(batching_mode="dynamic", batch_fill_target=0.25,
                              batch_latency_ms=12.5, morsel_size_rows=4096):
        pool = WorkerPool(0)
    try:
        assert pool._config["batching_mode"] == "dynamic"
        assert pool._config["batch_fill_target"] == 0.25
        assert pool._config["batch_latency_ms"] == 12.5
        assert pool._config["morsel_size_rows"] == 4096
    finally:
        pool.shutdown()


def test_device_leased_workers_dispatch_on_device_with_counters():
    """Leased workers run the shipped partial DeviceGroupedAgg stages on
    their device (the CPU here): the per-task engine counters carry
    device_grouped_batches, dispatch_coalesced and the kernels' counts
    (plain_* on the CPU, launches_* on the card), the operator stats ride
    along, and the coordinator's registry mirrors the device counters."""
    from daft_tpu_torch.distributed.runner import DistributedRunner
    from daft_tpu_torch.observability.metrics import registry
    from daft_tpu_torch.observability.runtime_stats import StatsCollector, set_collector

    rng = np.random.default_rng(19)
    n = 20_000
    data = {"k": rng.integers(0, 8, n).tolist(), "v": rng.integers(0, 1 << 40, n).tolist()}

    def q(pkg):
        return (pkg.from_pydict(data).groupby("k")
                .agg(pkg.col("v").sum().alias("s"), pkg.col("v").count().alias("c"))
                .sort("k"))

    with execution_config_ctx(device_mode="on", **CPU):
        r = DistributedRunner(num_workers=2, n_partitions=2, device_workers=2)
        try:
            runners.set_runner(r)
            before = registry().snapshot()
            set_collector(StatsCollector())
            try:
                got = q(daft_tpu_torch).to_pydict()
            finally:
                set_collector(None)
                runners.set_runner(None)
            trace = r.last_trace
            diff = registry().diff(before)
        finally:
            r.shutdown()
    assert got == q(daft_tpu).to_pydict()  # int64 sums: exact
    per_task = [dict(ts.engine_counters) for ts in trace.tasks]
    dev = sum(t.get("device_grouped_batches", 0) for t in per_task)
    assert dev > 0, per_task
    assert sum(t.get("plain_segment_sum_planes", 0) for t in per_task) > 0
    assert any(ts.operator_stats for ts in trace.tasks)
    assert sum(t.get("dispatch_coalesced", 0) for t in per_task) > 0
    assert diff.get("device_grouped_batches", 0) == dev


def test_leased_cuda_worker_without_a_card_reports_its_error():
    """A worker leased device "cuda" on a machine without a card raises at
    its first device stage; the coordinator reports that task's error, and
    nothing reruns it on the host."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the leased worker would run")
    from daft_tpu_torch.distributed.task import SubPlanTask
    from daft_tpu_torch.distributed.worker import WorkerPool
    from daft_tpu_torch.plan import physical as pp
    from daft_tpu_torch.plan.optimizer import Optimizer

    df = daft_tpu_torch.from_pydict({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
    with execution_config_ctx(device="cpu", device_mode="on"):
        phys = pp.translate(Optimizer().optimize(
            df.groupby("k").agg(col("v").sum())._plan))
    agg = next(nd for nd in phys.walk() if isinstance(nd, pp.DeviceGroupedAgg))
    with execution_config_ctx(device="cuda", device_mode="on"):
        pool = WorkerPool(1, device_workers=1)
    try:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pool.run_tasks([SubPlanTask.from_plan("dev", agg)])
    finally:
        pool.shutdown()
