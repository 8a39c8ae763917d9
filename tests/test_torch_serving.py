"""The port's serving tier (daft_tpu_torch/serving/, cancellation.py, the
admission controller of device/residency.py) against the reference's
(daft_tpu/serving/).

The cases of tests/test_serving.py this slice covers (the fair queue, the
HBM admission controller, the session end to end, the prepared cache's
literal contract, the hammer tests of the shared caches, /metrics) and
tests/test_fault_tolerance.py:453-510 (cancellation), each on the CPU
(``execution_config_ctx(device="cpu")``). A served result is held against
the reference's result of the same query over the same columns (numpy
planes carried across with ``from_numpy_columns``). Not here: the four
distributed cases (speculative dispatch, concurrent distributed queries,
the scheduler's round-robin), which wait for the distributed workers.

The port's own: ``runner=`` refuses; a warm repeat of a device query run
on stage threads observes its pinned bytes (the pin observation's hand-off
to stage threads), so its reservation calibrates; a kept stage thread
drops the observation; a cancelled running device query leaves no pin and
no reservation; the admission invariant under a short switch interval.
"""

import json
import sys
import threading
import time
import urllib.request

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.config import execution_config_ctx
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.observability.metrics import registry
from daft_tpu_torch.serving import FairAdmissionQueue, ServingSession


@pytest.fixture(autouse=True)
def _cpu():
    with execution_config_ctx(device="cpu"):
        yield


def _columns(n, keys=13):
    i = np.arange(n, dtype=np.int64)
    return {"k": i % keys, "v": (i % 1009).astype(np.float64), "w": i % 83}


def _tables(n=60_000, keys=13):
    """(reference frame, port frame) over the same numpy columns."""
    cols = _columns(n, keys)
    ref = daft_tpu.from_pydict({k: v.tolist() for k, v in cols.items()})
    port = from_numpy_columns({k: (v, np.ones(n, dtype=bool)) for k, v in cols.items()},
                              {"k": dt.DataType.int64(), "v": dt.DataType.float64(),
                               "w": dt.DataType.int64()})
    return ref, port


def _table(n=60_000, keys=13):
    return _tables(n, keys)[1]


# ---- the fair admission queue ------------------------------------------------------


def test_fair_queue_round_robin_across_tenants():
    q = FairAdmissionQueue()
    for i in range(3):
        q.push("a", f"a{i}")
    q.push("b", "b0")
    q.push("c", "c0")
    order = [q.pop(0) for _ in range(5)]
    assert order[:3] == ["a0", "b0", "c0"]
    assert order[3:] == ["a1", "a2"]
    assert q.depth() == 0 and q.pop(0) is None


def test_fair_queue_fifo_within_tenant_and_late_tenant():
    q = FairAdmissionQueue()
    for i in range(4):
        q.push("bulk", i)
    assert q.pop(0) == 0
    q.push("interactive", "x")
    nxt = [q.pop(0), q.pop(0)]
    assert "x" in nxt
    assert q.pop(0) in (2, 3)


def test_admission_queue_remove_preserves_rotation():
    q = FairAdmissionQueue()
    q.push("a", "a1")
    q.push("a", "a2")
    q.push("b", "b1")
    assert q.remove("a", "a1") is True
    assert q.remove("a", "a1") is False
    assert q.remove("ghost", "x") is False
    order = [q.pop(timeout=1), q.pop(timeout=1)]
    assert set(order) == {"a2", "b1"}
    assert q.depth() == 0
    q.push("c", "c1")
    assert q.remove("c", "c1") is True
    assert q.depth() == 0
    assert q.pop(timeout=0.05) is None


# ---- the HBM admission controller --------------------------------------------------


def _run_admits(est, n, tenant_budget=0, tenants=None, hold_s=0.03):
    active = [0]
    peak = [0]
    waited = []
    lock = threading.Lock()

    def go(i):
        t = tenants[i] if tenants else "t"
        with manager().admit(est, tenant=t, tenant_budget=tenant_budget) as w:
            with lock:
                active[0] += 1
                peak[0] = max(peak[0], active[0])
                waited.append(w)
            time.sleep(hold_s)
            with lock:
                active[0] -= 1

    ts = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    assert not any(t.is_alive() for t in ts)
    return peak[0], waited


def test_admission_budget_serializes_overbudget_queries():
    before = registry().get("admission_waits_total")
    with execution_config_ctx(hbm_budget_bytes=1000):
        peak, waited = _run_admits(800, 4)
    assert peak == 1
    assert sum(waited) >= 3
    assert registry().get("admission_waits_total") - before >= 3
    assert manager().reserved_bytes() == 0


def test_admission_budget_packs_within_budget():
    with execution_config_ctx(hbm_budget_bytes=1000):
        peak, _ = _run_admits(400, 4, hold_s=0.1)
    assert peak == 2


def test_admission_zero_estimate_never_waits():
    with execution_config_ctx(hbm_budget_bytes=10):
        peak, waited = _run_admits(0, 4)
    assert peak == 4 and not any(waited)


def test_admission_no_deadlock_when_estimate_exceeds_budget():
    with execution_config_ctx(hbm_budget_bytes=64):
        done = []

        def go():
            with manager().admit(1 << 20):
                done.append(1)

        ts = [threading.Thread(target=go) for _ in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert len(done) == 3


def test_admission_per_tenant_budget():
    with execution_config_ctx(hbm_budget_bytes=-1):
        peak_same, _ = _run_admits(800, 2, tenant_budget=1000, tenants=["a", "a"])
        peak_diff, _ = _run_admits(800, 2, tenant_budget=1000, tenants=["a", "b"])
    assert peak_same == 1
    assert peak_diff == 2


def test_admission_invariant_under_switch_pressure():
    """Sixteen threads (more than the cores) admitting reservations of
    several sizes under a short switch interval: the admitted bytes never
    pass the budget unless one reservation stands alone, and nothing stays
    reserved."""
    budget = 1000
    lock = threading.Lock()
    held = []
    violations = []

    def go(i):
        est = (200, 300, 450, 700)[i % 4]
        for _ in range(20):
            with manager().admit(est, tenant=f"t{i % 3}"):
                with lock:
                    held.append(est)
                    if len(held) > 1 and sum(held) > budget:
                        violations.append(list(held))
                with lock:
                    held.remove(est)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with execution_config_ctx(hbm_budget_bytes=budget):
            ts = [threading.Thread(target=go, args=(i,)) for i in range(16)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(60)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in ts)
    assert not violations, violations[:3]
    assert manager().reserved_bytes() == 0 and manager().reservation_count() == 0


# ---- the session end to end --------------------------------------------------------


def test_session_concurrent_results_identical_and_prepared_hits():
    ref_df, df = _tables()
    ref = ref_df.groupby("k").agg(daft_tpu.col("v").sum().alias("s"),
                                  daft_tpu.col("w").max().alias("mw")).sort("k").to_pydict()
    mk = lambda: df.groupby("k").agg(col("v").sum().alias("s"),  # noqa: E731
                                     col("w").max().alias("mw")).sort("k")
    assert mk().to_pydict() == ref
    hits0 = registry().get("serve_prepared_hits")
    with ServingSession(max_concurrent=3) as sess:
        sess.run(mk())
        futs = [sess.submit(mk(), tenant=f"t{i % 3}") for i in range(9)]
        outs = [f.to_pydict(timeout=60) for f in futs]
        stats = sess.tenant_stats()
    assert all(o == ref for o in outs)
    assert registry().get("serve_prepared_hits") - hits0 >= 9
    assert sum(s["queries"] for s in stats.values()) == 10
    assert set(stats) == {"default", "t0", "t1", "t2"}
    assert registry().snapshot().get("serve_queue_depth") == 0.0


def test_session_error_propagates_to_future():
    df = _table(1000)
    with ServingSession(max_concurrent=1) as sess:
        with pytest.raises(Exception):
            sess.submit(df.select(col("nope"))).result(timeout=30)
        assert sess.run(df.agg(col("v").sum().alias("s")), timeout=30) is not None


def test_prepared_literal_contract_and_cold_parity():
    ref_df, df = _tables()
    c = daft_tpu.col
    ref_lo = ref_df.where(c("w") > 10).agg(c("v").sum().alias("s")).to_pydict()
    ref_hi = ref_df.where(c("w") > 70).agg(c("v").sum().alias("s")).to_pydict()
    q_lo = lambda: df.where(col("w") > 10).agg(col("v").sum().alias("s"))  # noqa: E731
    q_hi = lambda: df.where(col("w") > 70).agg(col("v").sum().alias("s"))  # noqa: E731
    cold_lo = q_lo().to_pydict()
    cold_hi = q_hi().to_pydict()
    assert cold_lo != cold_hi
    with ServingSession(max_concurrent=1) as sess:
        a = sess.submit(q_lo()).to_pydict(timeout=30)
        b = sess.submit(q_lo()).to_pydict(timeout=30)
        c_ = sess.submit(q_hi()).to_pydict(timeout=30)
        d = sess.submit(q_lo()).to_pydict(timeout=30)
        assert len(sess.prepared) == 1
    assert a == b == d == cold_lo
    assert c_ == cold_hi
    np.testing.assert_allclose(a["s"], ref_lo["s"], rtol=1e-12)
    np.testing.assert_allclose(c_["s"], ref_hi["s"], rtol=1e-12)


def test_session_device_tiny_budget_queues_not_thrashes():
    """Under a tiny budget over-budget device queries queue (admission
    waits rise) rather than failing or deadlocking; every result equals the
    reference's."""
    ref_df, df = _tables()
    ref = ref_df.groupby("k").agg(daft_tpu.col("v").sum().alias("s")).sort("k").to_pydict()
    mk = lambda: df.groupby("k").agg(col("v").sum().alias("s")).sort("k")  # noqa: E731
    with execution_config_ctx(device_mode="on", device_min_rows=1):
        waits0 = registry().get("admission_waits_total")
        with execution_config_ctx(hbm_budget_bytes=2048):
            with ServingSession(max_concurrent=3) as sess:
                sess.run(mk(), timeout=60)
                est = sess.prepared.get_or_plan(mk()._plan)[0].est_pin_bytes
                assert est > 2048
                futs = [sess.submit(mk()) for _ in range(6)]
                outs = [f.to_pydict(timeout=60) for f in futs]
        assert registry().get("admission_waits_total") - waits0 >= 1
        assert manager().reserved_bytes() == 0
    for o in outs:
        assert o["k"] == ref["k"]
        np.testing.assert_allclose(o["s"], ref["s"], rtol=1e-12)


def test_serve_query_records_reach_subscribers():
    from daft_tpu_torch.observability import Subscriber, attach_subscriber, detach_subscriber

    class Cap(Subscriber):
        def __init__(self):
            self.recs = []

        def on_serve_query(self, rec):
            self.recs.append(rec)

    df = _table(5000)
    cap = Cap()
    attach_subscriber(cap)
    try:
        with ServingSession(max_concurrent=2) as sess:
            sess.run(df.agg(col("v").sum().alias("s")), tenant="acme", timeout=30)
            sess.run(df.agg(col("v").sum().alias("s")), tenant="acme", timeout=30)
            sess.run(df.agg(col("v").max().alias("m")), tenant="globex", timeout=30)
    finally:
        detach_subscriber(cap)
    assert len(cap.recs) == 3
    by_tenant = {}
    for r in cap.recs:
        by_tenant.setdefault(r.tenant, []).append(r)
    assert set(by_tenant) == {"acme", "globex"}
    assert any(r.prepared_hit for r in by_tenant["acme"])
    assert all(r.error is None and r.seconds > 0 and r.in_process for r in cap.recs)


def test_warm_repeat_observes_its_pins_on_stage_threads():
    """A device query whose stages run on stage threads (pipeline "force"):
    its warm repeat observes more than 0 pinned bytes on the CPU device
    (the observation rides to the stage threads), the prepared entry keeps
    the observation, and no stage thread keeps it once the query ended."""
    from daft_tpu_torch.device import residency

    df = _table()
    mk = lambda: df.groupby("k").agg(col("v").sum().alias("s")).sort("k")  # noqa: E731
    seen_on_stage_threads = []
    real_pin_scope = residency.ResidencyManager.pin_scope

    def spy(self):
        if threading.current_thread().name.startswith("daft-stage"):
            seen_on_stage_threads.append(residency.current_pin_observation())
        return real_pin_scope(self)

    with execution_config_ctx(device_mode="on", device_min_rows=1, pipeline_mode="force"):
        with ServingSession(max_concurrent=1) as sess:
            sess.run(mk(), timeout=60)
            residency.ResidencyManager.pin_scope = spy
            try:
                sess.run(mk(), timeout=60)
            finally:
                residency.ResidencyManager.pin_scope = real_pin_scope
            entry = sess.prepared.get_or_plan(mk()._plan)[0]
    assert seen_on_stage_threads and all(o is not None for o in seen_on_stage_threads)
    assert entry.observed_pin_bytes is not None and entry.observed_pin_bytes > 0
    assert entry.est_pin_bytes > 0

    # a kept stage thread runs the next stage without the served query's
    # observation
    from daft_tpu_torch.execution import pipeline

    def gen():
        yield residency.current_pin_observation()

    assert list(pipeline.spawn_stage(gen())) == [None]


def test_session_runner_is_not_ported():
    """A runner is taken since the distributed workers landed: the session
    hands it the prepared optimized plan (the workers' own cases are in
    tests/test_torch_distributed_serving.py)."""
    from daft_tpu_torch.runners import NativeRunner

    class Recording(NativeRunner):
        def __init__(self):
            self.plans = []

        def run(self, plan):
            self.plans.append(plan)
            return super().run(plan)

    runner = Recording()
    _ref_df, df = _tables(2_000)
    with dt.execution_config_ctx(device="cpu"):
        want = df.groupby("k").agg(col("v").sum().alias("s")).sort("k").to_pydict()
        with dt.serving_session(max_concurrent=1, runner=runner) as sess:
            got = sess.submit(df.groupby("k").agg(col("v").sum().alias("s")).sort("k"),
                              tenant="a").to_pydict()
    assert got == want
    assert len(runner.plans) == 1


# ---- the shared state under many threads -------------------------------------------


def test_many_threads_no_lost_updates_and_no_span_bleed():
    from daft_tpu_torch.observability.dashboard import DashboardState
    from daft_tpu_torch.observability.runtime_stats import SpanRecorder, set_spans, span_scope
    from daft_tpu_torch.observability.subscribers import attach_subscriber, detach_subscriber

    ref_df, df = _tables(30_000)
    ref = ref_df.groupby("k").agg(daft_tpu.col("v").sum().alias("s")).sort("k").to_pydict()
    mk = lambda: df.groupby("k").agg(col("v").sum().alias("s")).sort("k")  # noqa: E731
    state = DashboardState()
    profiler_rec = SpanRecorder()
    cfg = dict(device_mode="on", device_min_rows=1, pipeline_mode="off")
    with execution_config_ctx(**cfg):
        first = mk().to_pydict()
        own = SpanRecorder()
        with span_scope(own):
            mk().to_pydict()
        assert own.drain(), "device span sites recorded nothing"
    assert first["k"] == ref["k"]
    np.testing.assert_allclose(first["s"], ref["s"], rtol=1e-12)
    attach_subscriber(state)
    set_spans(profiler_rec)
    try:
        with execution_config_ctx(**cfg):
            with ServingSession(max_concurrent=4) as sess:
                sess.run(mk(), timeout=60)
                futs = [sess.submit(mk(), tenant=f"t{i % 3}") for i in range(24)]
                outs = [f.to_pydict(timeout=60) for f in futs]
        assert all(o == first for o in outs)
        assert profiler_rec.drain() == []
        assert state.query_latency._count == 25
        serving = state.serving()
        assert sum(s["queries"] for s in serving.values()) == 25
        assert all(0 <= s["prepared_hit_rate"] <= 1 for s in serving.values())
    finally:
        set_spans(None)
        detach_subscriber(state)


def test_decision_caches_thread_safe_under_hammer():
    from daft_tpu_torch.execution.executor import _BoundedDecisionCache

    cache = _BoundedDecisionCache(cap=64)
    errs = []

    def hammer(tid):
        try:
            for i in range(3000):
                cache.put((tid, i), i % 2 == 0)
                cache.get((tid, i - 7))
                len(cache)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    ts = [threading.Thread(target=hammer, args=(t,)) for t in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert not errs
    assert len(cache) <= 64


def test_histogram_concurrent_observe_no_lost_updates():
    from daft_tpu_torch.observability.metrics import Histogram

    h = Histogram()
    n, t_count = 2000, 8

    def obs():
        for i in range(n):
            h.observe(0.001 * (i % 50))

    ts = [threading.Thread(target=obs) for _ in range(t_count)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(60)
    assert h._count == n * t_count


def test_metrics_exposition_has_serving_series():
    df = _table(5000)
    dash = dt.launch_dashboard(port=0)
    try:
        with ServingSession(max_concurrent=2) as sess:
            sess.run(df.agg(col("v").sum().alias("s")), tenant="acme", timeout=30)
            sess.run(df.agg(col("v").sum().alias("s")), tenant="globex", timeout=30)
        body = urllib.request.urlopen(dash.url + "/metrics", timeout=10).read().decode()
        assert "# TYPE daft_tpu_serve_queue_depth gauge" in body
        assert "# TYPE daft_tpu_admission_waits_total counter" in body
        assert "# TYPE daft_tpu_serve_prepared_hits counter" in body
        assert body.count("# TYPE daft_tpu_query_latency_seconds histogram") == 1
        assert 'daft_tpu_query_latency_seconds_bucket{tenant="acme",le=' in body
        assert 'daft_tpu_query_latency_seconds_count{tenant="acme"}' in body
        serving = json.loads(urllib.request.urlopen(dash.url + "/api/serving",
                                                    timeout=10).read())
        assert set(serving) >= {"acme", "globex"}
        assert serving["acme"]["queries"] >= 1
        assert "prepared_hit_rate" in serving["acme"]
    finally:
        dash.shutdown()


def test_serving_config_validation():
    from daft_tpu_torch.config import ExecutionConfig

    with pytest.raises(ValueError, match="max_concurrent_queries"):
        ExecutionConfig(max_concurrent_queries=0)
    with pytest.raises(ValueError, match="tenant_budget_bytes"):
        ExecutionConfig(tenant_budget_bytes=-1)
    with pytest.raises(ValueError, match="shuffle_compression"):
        ExecutionConfig(shuffle_compression="brotli")
    with pytest.raises(ValueError, match="max_concurrent"):
        ServingSession(max_concurrent=0)


# ---- cancellation ------------------------------------------------------------------


def _slow_df(n=60, delay_s=0.02):
    @dt.func
    def crawl(x: int) -> int:
        time.sleep(delay_s)
        return x

    df = dt.from_pydict({"x": list(range(n))})
    return df.select(crawl(col("x")).alias("x"))


def test_cancel_queued_serving_query():
    from daft_tpu_torch.serving import QueryCancelled

    can0 = registry().get("serve_cancelled_total")
    with ServingSession(max_concurrent=1) as sess:
        running = sess.submit(_slow_df(n=60))
        time.sleep(0.3)
        keep = sess.submit(dt.from_pydict({"y": [1, 2]}))
        victim = sess.submit(dt.from_pydict({"y": [3, 4]}))
        assert victim.cancel() is True
        assert victim.cancelled is True
        with pytest.raises(QueryCancelled):
            victim.result(timeout=5)
        assert keep.result(timeout=30)[0].num_rows == 2
        assert sum(p.num_rows for p in running.result(timeout=30)) == 60
    assert registry().get("serve_cancelled_total") - can0 >= 1
    assert registry().snapshot().get("serve_queue_depth") == 0.0


def test_cancel_running_serving_query():
    from daft_tpu_torch.serving import QueryCancelled

    with ServingSession(max_concurrent=1) as sess:
        fut = sess.submit(_slow_df(n=100, delay_s=0.02))
        time.sleep(0.3)
        assert fut.cancel() is True
        with pytest.raises(QueryCancelled):
            fut.result(timeout=30)
        assert fut.cancelled is True
        out = sess.run(dt.from_pydict({"z": [1, 2, 3]}), timeout=30)
        assert sum(p.num_rows for p in out) == 3


def test_cancel_resolved_future_returns_false():
    with ServingSession(max_concurrent=1) as sess:
        fut = sess.submit(dt.from_pydict({"a": [1]}))
        fut.result(timeout=30)
        assert fut.cancel() is False
        assert fut.cancelled is False


def test_cancel_while_waiting_for_admission_leaves_nothing_reserved():
    """A query waiting at the admission controller leaves the wait when
    cancelled: no reservation, no pin, QueryCancelled to the caller."""
    from daft_tpu_torch.serving import QueryCancelled

    df = _table()
    mk = lambda: df.groupby("k").agg(col("v").sum().alias("s"))  # noqa: E731
    with execution_config_ctx(device_mode="on", device_min_rows=1, hbm_budget_bytes=1 << 40):
        with ServingSession(max_concurrent=1) as sess:
            with manager().admit(1 << 40, tenant="hold"):
                fut = sess.submit(mk())
                deadline = time.time() + 10
                while registry().snapshot()["serve_queue_depth"] and time.time() < deadline:
                    time.sleep(0.01)
                time.sleep(0.1)  # the worker is in the admission wait
                assert fut.cancel() is True
                with pytest.raises(QueryCancelled):
                    fut.result(timeout=10)
            assert manager().reserved_bytes() == 0
            assert manager().pinned_count() == 0
            assert sess.run(mk(), timeout=60)[0].num_rows == 13


def test_serving_hammer_dump_carries_only_the_erroring_tenant(monkeypatch, tmp_path):
    """Four tenants' queries and one failing tenant's through one session:
    the query_error dump holds only the failing tenant's events and the
    engine's untagged ones (tests/test_flight_recorder.py's serving
    hammer)."""
    from daft_tpu_torch.observability import flight

    for k, v in {"DAFT_TPU_FLIGHT_RECORDER": "1", "DAFT_TPU_FLIGHT_RING": "64",
                 "DAFT_TPU_FLIGHT_DIR": str(tmp_path), "DAFT_TPU_ANOMALY_WALL_K": "1.0",
                 "DAFT_TPU_ANOMALY_MIN_S": "0.0", "DAFT_TPU_ANOMALY_COOLDOWN_S": "0.0"}.items():
        monkeypatch.setenv(k, v)
    flight._reset_for_tests()
    try:
        rec = flight.recorder()
        df = dt.from_pydict({"k": [i % 7 for i in range(500)], "v": [float(i) for i in range(500)]})

        @dt.func
        def boom(x: int) -> int:
            raise ValueError("tenant-bad exploded")

        mk_good = lambda: df.groupby("k").agg(col("v").sum().alias("s")).sort("k")  # noqa: E731
        errors = []
        with ServingSession(max_concurrent=4) as sess:
            def good_client(tid):
                for _ in range(6):
                    sess.submit(mk_good(), tenant=f"t{tid}").to_pydict(timeout=60)

            threads = [threading.Thread(target=good_client, args=(t,)) for t in range(4)]
            for t in threads:
                t.start()
            with pytest.raises(Exception) as ei:
                sess.submit(df.select(boom(col("k"))), tenant="bad").result(timeout=60)
            errors.append(ei.value)
            for t in threads:
                t.join(60)
        assert not any(t.is_alive() for t in threads)
        assert len(rec.snapshot()) <= 64
        dumps = sorted(str(p) for p in tmp_path.glob("flight_query_error_*.json"))
        assert dumps, "no query_error dump from the serving hammer"
        with open(dumps[-1]) as f:
            dump = json.load(f)
        assert dump["tenant"] == "bad"
        assert {ev.get("tenant", "") for ev in dump["ring"]} <= {"", "bad"}
        assert any(ev.get("tenant", "").startswith("t") for ev in rec.snapshot())
    finally:
        flight._reset_for_tests()
