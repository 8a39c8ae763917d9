"""The port's flight recorder (daft_tpu_torch/observability/flight.py), the
reference's tests/test_flight_recorder.py cases for what the port has: the
bounded ring and its drop accounting (registry-silent), the off switch, a
ring hammered from many threads, each anomaly trigger (slow query by the
plan's EMA, its floor, query error, host-ledger pressure crossing, a
DeviceFallback in a device join run, worker death), the cooldown, an
unwritable dump directory, the native runner's query records, and a
subscriber seeing the anomaly. The default dump directory is the port's own,
``<tmp>/daft_tpu_torch_flight``. The reference's serving hammer and its
doctor CLI cases are not ported (no serving tier, no doctor yet)."""

import json
import os
import tempfile
import threading

import pytest

import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.observability import flight
from daft_tpu_torch.observability.metrics import registry


@pytest.fixture(autouse=True)
def _fresh_recorder():
    """Each test resolves its own recorder from (monkeypatched) env."""
    flight._reset_for_tests()
    yield
    flight._reset_for_tests()


def _recorder(monkeypatch, tmp_path, ring=8, wall_k=1.0, min_s=0.0, cooldown=0.0):
    monkeypatch.setenv("DAFT_TPU_FLIGHT_RECORDER", "1")
    monkeypatch.setenv("DAFT_TPU_FLIGHT_RING", str(ring))
    monkeypatch.setenv("DAFT_TPU_FLIGHT_DIR", str(tmp_path))
    monkeypatch.setenv("DAFT_TPU_ANOMALY_WALL_K", str(wall_k))
    monkeypatch.setenv("DAFT_TPU_ANOMALY_MIN_S", str(min_s))
    monkeypatch.setenv("DAFT_TPU_ANOMALY_COOLDOWN_S", str(cooldown))
    rec = flight.recorder()
    assert rec is not None
    return rec


def _dumps(tmp_path):
    return sorted(str(p) for p in tmp_path.glob("flight_*.json"))


def _load(path):
    with open(path) as f:
        return json.load(f)


def cpu(**kw):
    return dt.execution_config_ctx(device="cpu", **kw)


def test_ring_bounded_with_drop_accounting_and_registry_silent(monkeypatch, tmp_path):
    rec = _recorder(monkeypatch, tmp_path, ring=8)
    before = registry().snapshot()
    for i in range(30):
        rec.record("query", query_id=f"q{i}", seconds=0.001)
    assert len(rec.snapshot()) == 8
    assert rec.dropped == 22
    assert [ev["query_id"] for ev in rec.snapshot()] == [f"q{i}" for i in range(22, 30)]
    assert rec.snapshot(limit=3) == rec.snapshot()[-3:]
    assert registry().diff(before) == {}
    assert not _dumps(tmp_path)


def test_recorder_off_is_none_and_registry_silent(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_FLIGHT_RECORDER", "0")
    before = registry().snapshot()
    assert flight.recorder() is None
    assert flight.recorder() is None  # resolved once, stays None
    df = dt.from_pydict({"k": [1, 2, 1, 2], "v": [1.0, 2.0, 3.0, 4.0]})
    with cpu():
        df.groupby("k").agg(col("v").sum().alias("s")).sort("k").to_pydict()
    assert {k: v for k, v in registry().diff(before).items()
            if k.startswith("flight_")} == {}


def test_default_dump_dir_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("DAFT_TPU_FLIGHT_DIR", raising=False)
    monkeypatch.delenv("DAFT_TPU_FLIGHT_RECORDER", raising=False)
    rec = flight.recorder()
    assert rec is not None  # on by default
    assert rec.dump_dir == os.path.join(tempfile.gettempdir(), "daft_tpu_torch_flight")


def test_ring_hammer_from_many_threads_stays_bounded(monkeypatch, tmp_path):
    rec = _recorder(monkeypatch, tmp_path, ring=16)
    n_threads, per_thread = 8, 200

    def hammer(tid):
        for i in range(per_thread):
            rec.record("query", tenant=f"t{tid}", query_id=f"{tid}-{i}")

    threads = [threading.Thread(target=hammer, args=(t,)) for t in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(rec.snapshot()) == 16
    assert rec.dropped == n_threads * per_thread - 16


def test_slow_query_trigger_via_ema(monkeypatch, tmp_path):
    rec = _recorder(monkeypatch, tmp_path, wall_k=2.0)
    a0 = registry().get("flight_anomalies_total")
    rec.note_query("planA", 0.01)
    rec.note_query("planA", 0.012)
    assert not _dumps(tmp_path)
    rec.note_query("planA", 0.5)
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1
    dump = _load(dumps[0])
    assert dump["kind"] == "slow_query"
    assert "planA" in dump["detail"] and "EMA" in dump["detail"]
    assert dump["ema"]["planA"] > 0
    assert [ev["kind"] for ev in dump["ring"]].count("query") == 3
    assert registry().get("flight_anomalies_total") - a0 == 1
    assert rec.dumps == dumps


def test_slow_query_floor_suppresses_fast_queries(monkeypatch, tmp_path):
    rec = _recorder(monkeypatch, tmp_path, wall_k=1.0, min_s=10.0)
    rec.note_query("planA", 0.001)
    rec.note_query("planA", 1.0)
    assert not _dumps(tmp_path)


def test_query_error_trigger(monkeypatch, tmp_path):
    rec = _recorder(monkeypatch, tmp_path)
    rec.note_query("planB", 0.01, query_id="qerr", error="ValueError: boom")
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1
    dump = _load(dumps[0])
    assert dump["kind"] == "query_error"
    assert dump["query_id"] == "qerr"
    assert "boom" in dump["detail"]


def test_query_error_through_the_runner(monkeypatch, tmp_path):
    """A failing query's error reaches the recorder through the runner."""
    _recorder(monkeypatch, tmp_path, wall_k=100.0, min_s=100.0)

    @dt.func
    def boom(x: int) -> int:
        raise ValueError("nope")

    with pytest.raises(Exception), cpu():
        dt.from_pydict({"a": [1, 2]}).select(boom(col("a"))).to_pydict()
    dump = _load(_dumps(tmp_path)[0])
    assert dump["kind"] == "query_error" and "nope" in dump["detail"]


def test_ledger_pressure_crossing_triggers(monkeypatch, tmp_path):
    from daft_tpu_torch.memory import manager

    _recorder(monkeypatch, tmp_path)
    m = manager()
    m.clear()
    try:
        with dt.execution_config_ctx(memory_limit_bytes=1000, memory_pressure=0.8):
            m.track(700)
            assert not _dumps(tmp_path)
            m.track(200)  # 900 >= 800: upward crossing
            dumps = _dumps(tmp_path)
            assert len(dumps) == 1
            dump = _load(dumps[0])
            assert dump["kind"] == "ledger_pressure"
            ev = [e for e in dump["ring"] if e["kind"] == "ledger_pressure"]
            assert ev and ev[0]["tracked_bytes"] == 900
            assert ev[0]["limit_bytes"] == 1000
            m.track(50)  # still in pressure: no re-fire
            assert len(_dumps(tmp_path)) == 1
    finally:
        m.release(950)
        m.clear()


def test_device_fallback_trigger(monkeypatch, tmp_path):
    """A device join run over a dim whose keys are not unique raises
    DeviceFallback before any launch; the executor reruns the host plan and
    the recorder dumps a device_fallback anomaly."""
    from daft_tpu_torch.ops import counters

    _recorder(monkeypatch, tmp_path, wall_k=100.0, min_s=100.0)
    fact = dt.from_pydict({"f_k": [1, 2, 3, 1, 2, 3] * 100, "f_tag": [0, 1] * 300})
    dim = dt.from_pydict({"d_k": [1, 2, 2, 3], "d_w": [1, 2, 3, 4]})
    q = (fact.join(dim, left_on="f_k", right_on="d_k")
         .groupby("f_tag").agg(col("d_w").sum().alias("s")).sort("f_tag"))
    counters.reset()
    with cpu():
        got = q.to_pydict()
    with cpu(device_mode="off"):
        assert got == q.to_pydict()
    assert counters.device_fallbacks == 1
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1
    dump = _load(dumps[0])
    assert dump["kind"] == "device_fallback"
    assert "DeviceFallback" in dump["detail"] and "not unique" in dump["detail"]


def test_worker_death_trigger(monkeypatch, tmp_path):
    rec = _recorder(monkeypatch, tmp_path)
    rec.note_worker_death("worker-3", "no heartbeat for 1.0s")
    dumps = _dumps(tmp_path)
    assert len(dumps) == 1
    dump = _load(dumps[0])
    assert dump["kind"] == "worker_death"
    assert "worker-3" in dump["detail"]


def test_cooldown_suppresses_dumps_but_counts_anomalies(monkeypatch, tmp_path):
    rec = _recorder(monkeypatch, tmp_path, cooldown=60.0)
    a0 = registry().get("flight_anomalies_total")
    d0 = registry().get("flight_dumps_total")
    for _ in range(5):
        rec.note_query("p", 0.0, error="boom")
    assert len(_dumps(tmp_path)) == 1
    assert registry().get("flight_anomalies_total") - a0 == 5
    assert registry().get("flight_dumps_total") - d0 == 1


def test_unwritable_dump_dir_degrades_to_counter(monkeypatch, tmp_path):
    bad = tmp_path / "nope"
    bad.write_text("a file, not a directory")
    monkeypatch.setenv("DAFT_TPU_FLIGHT_DIR", str(bad))
    monkeypatch.setenv("DAFT_TPU_ANOMALY_COOLDOWN_S", "0")
    flight._reset_for_tests()
    rec = flight.recorder()
    f0 = registry().get("flight_dump_failures")
    rec.note_query("p", 0.0, error="boom")  # must not raise
    assert registry().get("flight_dump_failures") - f0 == 1
    assert rec.dumps == []


def test_native_runner_records_queries_in_ring(monkeypatch, tmp_path):
    rec = _recorder(monkeypatch, tmp_path, wall_k=100.0, min_s=100.0)
    df = dt.from_pydict({"k": [1, 2, 1, 2], "v": [1.0, 2.0, 3.0, 4.0]})
    with cpu():
        out = df.groupby("k").agg(col("v").sum().alias("s")).sort("k").to_pydict()
    assert out == {"k": [1, 2], "s": [4.0, 6.0]}
    queries = [ev for ev in rec.snapshot() if ev["kind"] == "query"]
    assert queries, "native runner never reached the flight recorder"
    q = queries[-1]
    assert q["fingerprint"] and q["seconds"] > 0 and q["query_id"]
    assert q["rows"] == 2
    assert q["metrics"]["device_grouped_batches"] == 1
    assert not _dumps(tmp_path)


def test_subscriber_sees_flight_anomaly(monkeypatch, tmp_path):
    from daft_tpu_torch.observability import attach_subscriber, detach_subscriber
    from daft_tpu_torch.observability.subscribers import Subscriber

    rec = _recorder(monkeypatch, tmp_path)
    seen = []

    class Sub(Subscriber):
        def on_flight_anomaly(self, event):
            seen.append(event)

    sub = Sub()
    attach_subscriber(sub)
    try:
        rec.note_query("p", 0.0, query_id="qx", error="boom")
    finally:
        detach_subscriber(sub)
    assert len(seen) == 1
    assert seen[0].kind == "query_error" and seen[0].query_id == "qx"
    assert seen[0].dump_path and os.path.exists(seen[0].dump_path)


def test_tenant_dump_has_no_cross_tenant_bleed(monkeypatch, tmp_path):
    """The no-bleed filter without the serving tier: a tenant's anomaly dump
    holds that tenant's and untagged events only."""
    rec = _recorder(monkeypatch, tmp_path, ring=64)
    for t in ("acme", "globex"):
        for i in range(3):
            rec.record("query", tenant=t, query_id=f"{t}-{i}")
    rec.record("ledger_pressure", tracked_bytes=1)
    rec.note_query("p", 0.0, query_id="acme-x", tenant="acme", error="boom")
    dump = _load(_dumps(tmp_path)[0])
    tenants = {ev.get("tenant", "") for ev in dump["ring"]}
    assert tenants == {"acme", ""}
