"""Elastic fault tolerance of the distributed workers
(daft_tpu_torch/distributed/; counterpart of tests/test_fault_tolerance.py,
its eleven distributed cases: the serving cancellation cases are ported in
tests/test_torch_serving.py).

- completeness gates: a reduce input with a missing map file raises
  ShuffleDataLost naming the lost map ids (never a short result);
- the fetch client: a peer mid-restart is retried with backoff, a dead
  one raises ShufflePeerUnreachable past the budget;
- the liveness monitor: kill -9 (exit detection, also in an idle pool)
  and SIGSTOP (the heartbeat timeout) declare the worker dead, requeue its
  tasks and mark it in the dashboard's worker table;
- lost-map regeneration: a worker that dies with its shuffle files
  (fault mode kill_lose) has exactly its lost maps replayed on the
  survivors; the query equals an undisturbed distributed run bit for bit
  and the reference's single-process run (keys and counts exactly, float
  sums rtol 1e-9);
- elastic respawn (DAFT_TPU_WORKER_RESPAWN), capped;
- plan files: a requeued task and a speculative loser read the plan file
  the pool wrote once, and no file outlives its readers;
- stage checkpoints: committed stages restore on a resubmission of the
  same plan; with DAFT_TPU_CHECKPOINT_DIR unset nothing is imported and no
  counter moves.

Faults are armed through the environment the workers inherit
(distributed/faults.py); the coordinator-side helpers are below.
"""

import os
import signal
import sys
import time
import uuid

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
import daft_tpu_torch.runners as runners
from daft_tpu_torch.config import execution_config_ctx
from daft_tpu_torch.observability.metrics import registry

requires_fault_injection = pytest.mark.skipif(
    not (os.name == "posix" and hasattr(signal, "SIGKILL") and hasattr(signal, "SIGSTOP")),
    reason="fault injection needs POSIX kill/SIGSTOP semantics")


def arm_fault(monkeypatch, point, mode="kill", worker="", stage="", once_dir=""):
    """Arm a tripwire for every worker spawned after this call (the coordinator
    read DAFT_TPU_FAULT_POINT at its own import, so it stays immune)."""
    env = {"DAFT_TPU_FAULT_POINT": point, "DAFT_TPU_FAULT_MODE": mode}
    if worker:
        env["DAFT_TPU_FAULT_WORKER"] = worker
    if stage:
        env["DAFT_TPU_FAULT_STAGE"] = stage
    if once_dir:
        env["DAFT_TPU_FAULT_ONCE_FILE"] = os.path.join(
            once_dir, f"fault-once-{uuid.uuid4().hex[:8]}")
    for k, v in env.items():
        monkeypatch.setenv(k, v)


def kill9(pool, worker_id):
    os.kill(pool.workers[worker_id]._proc.pid, signal.SIGKILL)


def sigstop(pool, worker_id):
    os.kill(pool.workers[worker_id]._proc.pid, signal.SIGSTOP)


def wait_until(predicate, timeout_s=15.0, interval_s=0.05, what="condition"):
    deadline = time.time() + timeout_s
    while time.time() < deadline:
        if predicate():
            return
        time.sleep(interval_s)
    pytest.fail(f"timed out after {timeout_s}s waiting for {what}")


def _groupby_data(n=10_000, keys=50, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, keys, n).tolist(), "v": rng.uniform(0, 100, n).tolist()}


def _groupby_query(pkg, data):
    return (pkg.from_pydict(data).groupby("k")
            .agg(pkg.col("v").sum().alias("s"), pkg.col("v").count().alias("c"))
            .sort("k"))


def _runner(**kw):
    from daft_tpu_torch.distributed import DistributedRunner

    with execution_config_ctx(device="cpu"):
        return DistributedRunner(**kw)


def _run_on(runner, data):
    with execution_config_ctx(device="cpu"):
        runners.set_runner(runner)
        try:
            return _groupby_query(daft_tpu_torch, data).to_pydict()
        finally:
            runners.set_runner(None)


def _reference(data):
    return _groupby_query(daft_tpu, data).to_pydict()


# ---------------------------------------------------------------------------
# Completeness gates and fetch classification (no worker processes)
# ---------------------------------------------------------------------------

def test_missing_map_file_raises_data_lost_with_precise_ids(tmp_path):
    from daft_tpu_torch.core.recordbatch import RecordBatch
    from daft_tpu_torch.distributed.shuffle import (ShuffleDataLost, read_partition,
                                                    write_map_output)

    base = str(tmp_path)
    batch = RecordBatch.from_pydict({"a": [1, 2, 3]})
    write_map_output(base, "s1", 0, [[batch]])
    write_map_output(base, "s1", 1, [[batch]])
    schema = batch.schema
    got = list(read_partition(base, "s1", 0, schema, expected_maps=(0, 1)))
    assert sum(p.num_rows for p in got) == 6
    os.unlink(os.path.join(base, "s1", "p0", "m0.arrow"))
    with pytest.raises(ShuffleDataLost) as ei:
        list(read_partition(base, "s1", 0, schema, expected_maps=(0, 1)))
    assert ei.value.shuffle_id == "s1"
    assert ei.value.map_ids == (0,)
    assert list(read_partition(base, "s1", 0, schema, expected_maps=())) != []


def test_fetch_peer_unreachable_after_retry_budget(monkeypatch):
    import socket

    from daft_tpu_torch.distributed.fetch_server import fetch_partition
    from daft_tpu_torch.distributed.shuffle import ShufflePeerUnreachable
    from daft_tpu_torch.schema import Schema

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("DAFT_TPU_FETCH_RETRIES", "1")
    before = registry().get("fetch_retries_total")
    ep = [("127.0.0.1", port, "ab" * 16)]
    with pytest.raises(ShufflePeerUnreachable):
        list(fetch_partition(ep, "sx", 0, Schema([]), parallelism=1, prefetch=0))
    assert registry().get("fetch_retries_total") - before == 1
    with pytest.raises(ShufflePeerUnreachable):
        list(fetch_partition(ep, "sx", 0, Schema([]), parallelism=2, prefetch=2))


def test_fetch_transient_retry_rides_out_peer_restart(tmp_path, monkeypatch):
    import socket
    import threading

    from daft_tpu_torch.core.recordbatch import RecordBatch
    from daft_tpu_torch.distributed.fetch_server import ShuffleFetchServer, fetch_partition
    from daft_tpu_torch.distributed.shuffle import write_map_output

    base = str(tmp_path)
    batch = RecordBatch.from_pydict({"a": [1, 2, 3, 4]})
    write_map_output(base, "s2", 0, [[batch]])
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    authkey = os.urandom(16)
    ep = [("127.0.0.1", port, authkey.hex())]
    srv_slot = {}
    monkeypatch.setenv("DAFT_TPU_FETCH_RETRIES", "8")
    before = registry().get("fetch_retries_total")

    def _late_restart():
        # up only once the client was refused at least once
        deadline = time.time() + 5.0
        while registry().get("fetch_retries_total") == before and time.time() < deadline:
            time.sleep(0.01)
        srv_slot["srv"] = ShuffleFetchServer(base, port=port, authkey=authkey)

    threading.Thread(target=_late_restart, daemon=True).start()
    try:
        got = list(fetch_partition(ep, "s2", 0, batch.schema, parallelism=1, prefetch=0,
                                   expected_maps=(0,)))
        assert sum(p.num_rows for p in got) == 4
    finally:
        if "srv" in srv_slot:
            srv_slot["srv"].close()
    assert registry().get("fetch_retries_total") - before >= 1


# ---------------------------------------------------------------------------
# Liveness monitor and elastic respawn (real worker processes)
# ---------------------------------------------------------------------------

def _scan_tasks(n, rows=64):
    from daft_tpu_torch.core.micropartition import MicroPartition
    from daft_tpu_torch.distributed.task import SubPlanTask
    from daft_tpu_torch.plan import physical as pp

    part = MicroPartition.from_pydict({"a": np.arange(rows, dtype=np.int64)})
    plan = pp.InMemoryScan([part], part.schema)
    return [SubPlanTask.from_plan(f"t{i}", plan) for i in range(n)]


def _pool(n, **kw):
    from daft_tpu_torch.distributed.worker import WorkerPool

    with execution_config_ctx(device="cpu"):
        return WorkerPool(n, **kw)


@requires_fault_injection
def test_heartbeat_timeout_detects_sigstopped_worker(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_HEARTBEAT_S", "0.2")
    monkeypatch.setenv("DAFT_TPU_HEARTBEAT_TIMEOUT_S", "1.0")
    # speculation would finish the stalled task elsewhere before the timeout
    monkeypatch.setenv("DAFT_TPU_SPECULATIVE", "0")
    fail0 = registry().get("worker_failures_total")
    req0 = registry().get("tasks_requeued_total")
    pool = _pool(2)
    try:
        assert len(pool.run_tasks(_scan_tasks(2))) == 2  # both warm
        sigstop(pool, "worker-0")
        results = pool.run_tasks(_scan_tasks(4))
        assert len(results) == 4 and all(r.rows == 64 for r in results.values())
        assert "worker-0" in pool.dead_workers
        assert "no heartbeat" in pool.dead_workers["worker-0"]["reason"]
        assert "worker-0" not in pool.workers
    finally:
        pool.shutdown()
    assert registry().get("worker_failures_total") - fail0 == 1
    assert registry().get("tasks_requeued_total") - req0 >= 1


@requires_fault_injection
def test_idle_pool_liveness_detects_kill9_without_work(monkeypatch, tmp_path):
    from daft_tpu_torch.observability import flight

    monkeypatch.setenv("DAFT_TPU_HEARTBEAT_S", "0.2")
    monkeypatch.setenv("DAFT_TPU_HEARTBEAT_TIMEOUT_S", "1.0")
    monkeypatch.setenv("DAFT_TPU_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("DAFT_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("DAFT_TPU_ANOMALY_COOLDOWN_S", "0")
    flight._reset_for_tests()
    fail0 = registry().get("worker_failures_total")
    pool = _pool(2)
    try:
        assert len(pool.run_tasks(_scan_tasks(2))) == 2
        kill9(pool, "worker-0")
        wait_until(lambda: "worker-0" in pool.dead_workers, timeout_s=5.0,
                   what="the idle liveness tick declaring the killed worker dead")
        assert "worker-0" not in pool.workers
        assert len(pool.run_tasks(_scan_tasks(2))) == 2
    finally:
        pool.shutdown()
        flight._reset_for_tests()
    assert registry().get("worker_failures_total") - fail0 == 1
    assert list(tmp_path.glob("flight_worker_death_*.json"))


@requires_fault_injection
def test_respawn_cap_honored(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_WORKER_RESPAWN", "1")
    # queue-pressure autoscaling would race the respawn for the freed headroom
    monkeypatch.setenv("DAFT_TPU_AUTOSCALING_THRESHOLD", "1000")
    resp0 = registry().get("worker_respawns_total")
    pool = _pool(2)
    try:
        assert len(pool.run_tasks(_scan_tasks(2))) == 2
        kill9(pool, "worker-0")
        assert len(pool.run_tasks(_scan_tasks(4))) == 4
        wait_until(lambda: registry().get("worker_respawns_total") - resp0 == 1,
                   timeout_s=45.0, what="the replacement worker's spawn")
        wait_until(lambda: len(pool.workers) == 2, timeout_s=30.0,
                   what="the replacement joining the pool")
        # the respawned worker inherits the coordinator's config
        new = [w for wid, w in pool.workers.items() if wid != "worker-1"]
        assert new and new[0].spawn_config["device"] == "cpu"
        kill9(pool, sorted(pool.workers)[0])
        assert len(pool.run_tasks(_scan_tasks(4))) == 4
        assert pool._respawn_attempts == 1
    finally:
        pool.shutdown()
    assert registry().get("worker_respawns_total") - resp0 == 1


@requires_fault_injection
def test_requeued_task_rereads_its_plan_file(monkeypatch, tmp_path):
    """worker-0 dies on its first task before running it; the requeued copy
    runs on another worker from the plan file the pool wrote, and the run
    leaves no plan file behind."""
    arm_fault(monkeypatch, "task_start", worker="worker-0", once_dir=str(tmp_path))
    monkeypatch.setenv("DAFT_TPU_SPECULATIVE", "0")
    req0 = registry().get("tasks_requeued_total")
    pool = _pool(2)
    try:
        results = pool.run_tasks(_scan_tasks(4))
        assert len(results) == 4 and all(r.rows == 64 for r in results.values())
        assert "worker-0" not in {r.worker_id for r in results.values()}
        assert "worker-0" in pool.dead_workers
        assert os.listdir(pool._blob_dir) == []
    finally:
        pool.shutdown()
    assert registry().get("tasks_requeued_total") - req0 >= 1


@requires_fault_injection
def test_speculative_loser_reads_its_plan_file(monkeypatch, tmp_path):
    """worker-0 stalls on its first task; the duplicate wins on worker-1 and
    ends the run, but the stalled copy still finds its plan file (it fails
    no task), which the pool unlinks once that late result is in."""
    from daft_tpu_torch.distributed.task import SubPlanTask

    arm_fault(monkeypatch, "task_start", mode="delay:1.5", worker="worker-0",
              once_dir=str(tmp_path))
    monkeypatch.setenv("DAFT_TPU_HEARTBEAT_S", "0.2")
    monkeypatch.setenv("DAFT_TPU_SPECULATIVE_MIN_S", "0.1")
    monkeypatch.setenv("DAFT_TPU_STRAGGLER_K", "2.0")
    wins0 = registry().get("sched_speculative_wins")
    pool = _pool(2)
    try:
        results = pool.run_tasks(_scan_tasks(4))
        assert len(results) == 4 and all(r.rows == 64 for r in results.values())
        assert registry().get("sched_speculative_wins") - wins0 >= 1
        plan = _scan_tasks(1)[0].plan()
        more = iter(range(1000))

        def drained():
            # a dispatch pass takes the late result in and drops its file
            pool.run_tasks([SubPlanTask.from_plan(f"u{next(more)}", plan)])
            return os.listdir(pool._blob_dir) == []

        wait_until(drained, timeout_s=15.0, interval_s=0.2,
                   what="the stalled copy's late result")

        def beat():
            return pool.latest_heartbeats().get("worker-0", {})

        wait_until(lambda: beat().get("tasks_completed", 0) >= 1, timeout_s=10.0,
                   what="worker-0's heartbeat after its stalled task")
        assert beat()["tasks_failed"] == 0
    finally:
        pool.shutdown()


# ---------------------------------------------------------------------------
# kill -9 of one worker mid-shuffle on a three-worker pool
# ---------------------------------------------------------------------------

@requires_fault_injection
def test_kill9_mid_shuffle_completes_bit_identical(tmp_path, monkeypatch):
    """worker-0 finishes its shuffle map, unlinks its published map files
    and dies (kill_lose); the reduce finds them lost, lineage replays those
    maps on the survivors, and the result equals an undisturbed run bit for
    bit."""
    data = _groupby_data(seed=7)
    r_clean = _runner(num_workers=3, n_partitions=3)
    try:
        clean = _run_on(r_clean, data)
    finally:
        r_clean.shutdown()
    arm_fault(monkeypatch, "task_sent", mode="kill_lose", worker="worker-0",
              stage="shuffle", once_dir=str(tmp_path))
    fail0 = registry().get("worker_failures_total")
    regen0 = registry().get("shuffle_maps_regenerated_total")
    r = _runner(num_workers=3, n_partitions=3)
    try:
        got = _run_on(r, data)
        # the pool notes the death on its next pass, idle or not
        wait_until(lambda: "worker-0" in r._pool.dead_workers, timeout_s=10.0,
                   what="the pool noting worker-0's death")
    finally:
        r.shutdown()
    assert got == clean
    want = _reference(data)
    assert got["k"] == want["k"] and got["c"] == want["c"]
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9)
    assert registry().get("worker_failures_total") - fail0 >= 1
    assert registry().get("shuffle_maps_regenerated_total") - regen0 >= 1


@requires_fault_injection
def test_recovery_renders_in_explain_analyze_and_metrics(tmp_path, monkeypatch):
    from daft_tpu_torch.observability.metrics import prometheus_text

    arm_fault(monkeypatch, "task_sent", mode="kill_lose", worker="worker-1",
              stage="shuffle", once_dir=str(tmp_path))
    data = _groupby_data(seed=11)
    r = _runner(num_workers=3, n_partitions=3)
    with execution_config_ctx(device="cpu"):
        runners.set_runner(r)
        try:
            report = _groupby_query(daft_tpu_torch, data).explain_analyze()
        finally:
            runners.set_runner(None)
            r.shutdown()
    assert "recovery:" in report
    assert "worker failures" in report
    assert "maps regenerated" in report
    text = prometheus_text()
    assert "worker_failures_total" in text
    assert "shuffle_maps_regenerated_total" in text


@requires_fault_injection
def test_dashboard_marks_dead_workers():
    from daft_tpu_torch.observability.dashboard import DashboardState
    from daft_tpu_torch.observability.events import WorkerHeartbeat

    def beat(**kw):
        base = dict(worker_id="w0", ts=time.time(), busy_slots=0, total_slots=1,
                    tasks_completed=1, tasks_failed=0, rss_bytes=1 << 20)
        base.update(kw)
        return WorkerHeartbeat(**base)

    state = DashboardState()
    state.on_worker_heartbeat("q1", beat())
    assert state.workers()["w0"]["dead"] is False
    state.on_worker_heartbeat("q1", beat(dead=True, death_reason="no heartbeat for 6.0s"))
    w = state.workers()["w0"]
    assert w["dead"] is True and "no heartbeat" in w["death_reason"]
    state.on_worker_heartbeat("q1", beat())
    assert state.workers()["w0"]["dead"] is False


# ---------------------------------------------------------------------------
# Stage checkpoints
# ---------------------------------------------------------------------------

@requires_fault_injection
def test_checkpoint_resume_skips_committed_stages(tmp_path, monkeypatch):
    """Resubmitting the same plan over the same content on a fresh runner
    restores the committed stages instead of rerunning them."""
    monkeypatch.setenv("DAFT_TPU_CHECKPOINT_DIR", str(tmp_path / "ckpt"))
    data = _groupby_data(seed=3)
    com0 = registry().get("checkpoint_stages_committed")
    skip0 = registry().get("checkpoint_stages_skipped")
    r1 = _runner(num_workers=2, n_partitions=2)
    try:
        first = _run_on(r1, data)
    finally:
        r1.shutdown()
    committed = registry().get("checkpoint_stages_committed") - com0
    assert committed >= 1
    assert registry().get("checkpoint_stages_skipped") - skip0 == 0
    r2 = _runner(num_workers=2, n_partitions=2)
    try:
        second = _run_on(r2, data)
    finally:
        r2.shutdown()
    assert second == first
    want = _reference(data)
    assert second["k"] == want["k"] and second["c"] == want["c"]
    assert registry().get("checkpoint_stages_skipped") - skip0 >= 1
    assert registry().get("checkpoint_stages_committed") - com0 == committed


@requires_fault_injection
def test_checkpoint_zero_overhead_when_unset(monkeypatch):
    monkeypatch.delenv("DAFT_TPU_CHECKPOINT_DIR", raising=False)
    sys.modules.pop("daft_tpu_torch.checkpoint.stages", None)
    before = registry().snapshot()
    data = _groupby_data(n=4000, seed=5)
    r = _runner(num_workers=2, n_partitions=2)
    try:
        _run_on(r, data)
    finally:
        r.shutdown()
    assert "daft_tpu_torch.checkpoint.stages" not in sys.modules
    diff = registry().diff(before)
    assert not [k for k in diff if k.startswith("checkpoint_")]
