"""The port's query timeline profiler: stall attribution through the
pipeline's channels, stable node ids, EXPLAIN ANALYZE's stall columns, the
span recorder and the engine's spans (device h2d / dispatch / d2h and the
coalescer's flush on a device_mode="on" stage; the scan's per-task
"scan.stream", the pool's "pipeline.morsel", the spill arms' spans), the
Chrome trace export of ``explain_analyze(profile=...)`` and of a synthetic
trace (``distributed/trace.py``), the straggler report, the Prometheus
``/metrics`` surface, histogram quantiles, the spill counters in the
registry, and the event log's schema. The reference's tests/test_profiler.py
cases that need its distributed runner or bench.py are not ported."""

import json
import time
import urllib.request

import numpy as np
import pytest

import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.observability.events import OperatorStats, TaskStats
from daft_tpu_torch.observability.runtime_stats import (SpanRecorder, StatsCollector,
                                                        current_spans, profile_span,
                                                        set_collector, set_spans)

SEED = 20261018


def cpu(**kw):
    return dt.execution_config_ctx(device="cpu", **kw)


class _FakeNode:
    def __init__(self, name):
        self._name = name

    def name(self):
        return self._name


class _Part:
    num_rows = 1


def test_channel_starve_attributed_to_consumer():
    from daft_tpu_torch.execution.pipeline import spawn_stage

    c = StatsCollector()
    producer, consumer = _FakeNode("producer"), _FakeNode("consumer")

    def produce():
        for _ in range(3):
            time.sleep(0.03)
            yield _Part()

    set_collector(c)
    try:
        upstream = spawn_stage(c.wrap(producer, produce()), node=producer)

        def consume():
            for part in upstream:
                yield part

        n = sum(p.num_rows for p in c.wrap(consumer, consume()))
    finally:
        set_collector(None)
    assert n == 3
    stats = {s.name: s for s in c.finish()}
    cons = stats["consumer"]
    assert cons.starve_seconds > 0.05, cons
    assert cons.compute_seconds < cons.starve_seconds
    for s in stats.values():
        assert s.seconds == pytest.approx(
            s.compute_seconds + s.starve_seconds + s.blocked_seconds)


def test_channel_blocked_attributed_to_producer():
    from daft_tpu_torch.execution.pipeline import spawn_stage

    c = StatsCollector()
    producer = _FakeNode("producer")

    def produce():
        for _ in range(8):
            yield _Part()

    set_collector(c)
    try:
        upstream = spawn_stage(c.wrap(producer, produce()), maxsize=1, node=producer)
        n = 0
        for part in upstream:
            time.sleep(0.02)
            n += part.num_rows
    finally:
        set_collector(None)
    assert n == 8
    prod = {s.name: s for s in c.finish()}["producer"]
    assert prod.blocked_seconds > 0.03, prod
    assert prod.seconds == pytest.approx(
        prod.compute_seconds + prod.starve_seconds + prod.blocked_seconds)


def test_stable_node_ids_survive_id_reuse():
    c = StatsCollector()
    ids = set()
    for i in range(50):
        nid = c.node_id(_FakeNode(f"n{i}"))
        assert nid not in ids
        ids.add(nid)
    assert ids == set(range(1, 51))


def _kv_frame(n=20_000):
    rng = np.random.default_rng(SEED)
    return dt.from_pydict({"k": rng.choice(["a", "b", "c"], n).tolist(),
                           "v": rng.uniform(0, 1, n).tolist()})


def test_explain_analyze_shows_stall_columns():
    with cpu(pipeline_mode="force"):
        report = (_kv_frame().where(col("v") > 0.25)
                  .groupby("k").agg(col("v").sum().alias("s"))
                  .explain_analyze())
    assert "compute" in report and "starve" in report and "blocked" in report
    assert "== Runtime Stats ==" in report


def test_span_recorder_profile_span_and_cap():
    rec = SpanRecorder(cap=2)
    set_spans(rec)
    try:
        with profile_span("a", "device", rows=5):
            pass
        with profile_span("b", "io"):
            pass
        with profile_span("c", "io"):
            pass
    finally:
        set_spans(None)
    assert current_spans() is None
    spans = rec.drain()
    assert [s["name"] for s in spans] == ["a", "b"]
    assert spans[0]["args"] == {"rows": 5}
    assert rec.dropped == 1
    with profile_span("ghost", "device"):
        pass
    assert rec.drain() == []


def test_device_stage_records_dispatch_spans():
    """device_mode="on" on the CPU (the kernels' plain versions): the
    grouped stage emits h2d / dispatch / d2h spans while a recorder is
    installed."""
    rng = np.random.default_rng(1)
    df = dt.from_pydict({"k": rng.integers(0, 8, 30_000).tolist(),
                         "v": rng.uniform(0, 100, 30_000).tolist()})
    rec = SpanRecorder()
    set_spans(rec)
    try:
        with cpu(device_mode="on"):
            out = df.groupby("k").agg(col("v").sum().alias("s")).to_pydict()
    finally:
        set_spans(None)
    assert len(out["k"]) == 8
    spans = rec.drain()
    names = {s["name"] for s in spans}
    assert {"device.h2d", "device.dispatch", "device.d2h",
            "device.coalesce_flush"} <= names, names
    disp = next(s for s in spans if s["name"] == "device.dispatch")
    assert disp["args"]["op"] == "grouped_agg" and disp["args"]["rows"] == 30_000


def test_ungrouped_and_join_stages_record_spans():
    fact = dt.from_pydict({"f_k": [1, 2, 3] * 1000, "f_v": [1.0, 2.0, 3.0] * 1000})
    dim = dt.from_pydict({"d_k": [1, 2, 3], "d_g": [10, 20, 10]})
    rec = SpanRecorder()
    set_spans(rec)
    try:
        with cpu(device_mode="on"):
            fact.where(col("f_v") > 1).agg(col("f_v").sum()).to_pydict()
            (fact.join(dim, left_on="f_k", right_on="d_k")
             .groupby("d_g").agg(col("f_v").sum()).to_pydict())
    finally:
        set_spans(None)
    ops = [(s["name"], s.get("args", {}).get("op")) for s in rec.drain()]
    assert ("device.dispatch", "filter_agg") in ops and ("device.d2h", "filter_agg") in ops
    assert ("device.dispatch", "join_agg") in ops and ("device.d2h", "grouped_agg") in ops


def test_explain_analyze_profile_writes_chrome_trace(tmp_path):
    rng = np.random.default_rng(2)
    df = dt.from_pydict({"k": rng.integers(0, 8, 30_000).tolist(),
                         "v": rng.uniform(0, 100, 30_000).tolist()})
    path = tmp_path / "trace.json"
    t0 = time.time()
    with cpu(device_mode="on"):
        report = df.groupby("k").agg(col("v").sum().alias("s")).explain_analyze(
            profile=str(path))
    t1 = time.time()
    assert "DeviceGroupedAgg" in report
    data = json.loads(path.read_text())
    xs = [e for e in data["traceEvents"] if e["ph"] == "X"]
    names = {e["name"] for e in xs}
    assert {"device.h2d", "device.dispatch", "device.d2h"} <= names
    assert any(e["cat"] == "operator" and e["name"].startswith("DeviceGroupedAgg")
               for e in xs)
    # every span lies inside the run's wall clock (trace times are µs from
    # the trace's start, which is the run's start)
    assert all(e["ts"] >= 0 and e["ts"] + e["dur"] <= (t1 - t0) * 1e6 + 1e3
               for e in xs if e["cat"] == "device")


def test_scan_morsel_and_spill_spans(tmp_path):
    rng = np.random.default_rng(3)
    n = 40_000
    df = dt.from_pydict({"k": rng.integers(0, 500, n).tolist(),
                         "v": rng.uniform(0, 1, n).tolist()})
    with cpu():
        df.write_parquet(str(tmp_path / "t"))
    rec = SpanRecorder()
    set_spans(rec)
    try:
        with cpu(device_mode="off", pipeline_mode="force", scan_split_bytes=64 * 1024,
                 morsel_size_rows=4096):
            dt.read_parquet(str(tmp_path / "t")).where(col("v") > 0.5).to_pydict()
        with cpu(device_mode="off", memory_limit_bytes=64 * 1024,
                 spill_dir=str(tmp_path / "spill")):
            df.sort("v").to_pydict()
            df.groupby("k").agg(col("v").sum()).to_pydict()
    finally:
        set_spans(None)
    names = {s["name"] for s in rec.drain()}
    assert {"scan.stream", "pipeline.morsel", "spill.sort_run", "spill.grace_agg"} <= names


def test_spill_annotation_in_explain_analyze(tmp_path):
    rng = np.random.default_rng(5)
    df = dt.from_pydict({"k": rng.integers(0, 500, 50_000).tolist(),
                         "v": rng.uniform(0, 1, 50_000).tolist()})
    with cpu(device_mode="off", memory_limit_bytes=64 * 1024, spill_dir=str(tmp_path)):
        report = df.sort("v").explain_analyze()
    assert "PhysSort [memory: spilled" in report and "runs]" in report
    assert "spill_runs" in report


def _mk_task(stage, task_id, worker, started, exec_s, ops=(), **kw):
    return TaskStats(stage_id=stage, task_id=task_id, worker_id=worker,
                     queue_wait_s=0.0, schedule_latency_s=0.0, exec_s=exec_s,
                     rows_out=10, bytes_out=100, retries=0,
                     started_at=started, operator_stats=tuple(ops), **kw)


def test_chrome_trace_synthetic_lanes_and_offsets():
    from daft_tpu_torch.distributed.trace import QueryTrace

    tr = QueryTrace("qtest")
    t0 = tr.started_wall
    op = OperatorStats(node_id=1, name="PhysAgg", rows_out=10, batches_out=1,
                       seconds=0.3, compute_seconds=0.1, starve_seconds=0.15,
                       blocked_seconds=0.05)
    tr.tasks.append(_mk_task("s0", "t0", "worker-0", t0 + 0.1, 0.5, [op]))
    tr.tasks.append(_mk_task("s0", "t1", "worker-1", t0 + 0.1, 0.4))
    tr.task_spans["t0"] = [{"name": "device.dispatch", "cat": "device",
                            "ts": t0 + 0.2, "dur": 0.05, "args": {"rows": 10}}]
    tr.add_heartbeat({"worker_id": "worker-1", "ts": t0 - 2.0, "recv_ts": t0 + 0.001})
    tr.add_heartbeat({"worker_id": "worker-1", "ts": t0 - 1.5, "recv_ts": t0 + 0.6})
    offs = tr.clock_offsets()
    assert offs["worker-1"] == pytest.approx(2.001, abs=1e-6)

    data = tr.to_chrome_trace(total_seconds=1.0)
    evs = data["traceEvents"]
    assert all(isinstance(e["pid"], int) or e["ph"] == "M" for e in evs)
    xs = [e for e in evs if e["ph"] == "X"]
    assert all(e["dur"] >= 0 and isinstance(e["ts"], float) for e in xs)
    assert len({e["pid"] for e in xs if e["cat"] == "task"}) == 2
    disp = [e for e in xs if e["name"] == "device.dispatch"]
    assert len(disp) == 1 and disp[0]["ts"] == pytest.approx(0.2e6, abs=1e3)
    assert any(e["cat"] == "operator" and e["name"] == "PhysAgg" for e in xs)
    assert any(e["name"] == "starve:PhysAgg" for e in xs)
    assert any(e["cat"] == "stage" and e["pid"] == 0 for e in xs)
    assert any(e["cat"] == "query" and e["pid"] == 0 for e in xs)
    assert data["metadata"]["clock_offsets_s"]["worker-1"] > 1.9
    json.dumps(data)


def test_straggler_report_thresholds(monkeypatch):
    from daft_tpu_torch.distributed.trace import QueryTrace

    tr = QueryTrace("qs")
    tr._stage_order.append("s0")
    tr._shuffle["s0"] = {}
    for i in range(4):
        tr.tasks.append(_mk_task("s0", f"t{i}", "w0", 0.0, 0.1))
    tr.tasks.append(_mk_task("s0", "slow", "w1", 0.0, 1.0))
    flagged = tr.straggler_report(threshold=2.0)
    assert [r["task_id"] for r in flagged] == ["slow"]
    assert flagged[0]["ratio"] == pytest.approx(10.0)
    assert tr.straggler_report(threshold=20.0) == []
    monkeypatch.setenv("DAFT_TPU_STRAGGLER_K", "20")
    assert tr.straggler_report() == []
    monkeypatch.setenv("DAFT_TPU_STRAGGLER_K", "2")
    assert len(tr.straggler_report()) == 1
    assert "stragglers" in tr.render() and "slow" in tr.render()


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.headers.get("Content-Type", ""), r.read()


def _parse_prometheus(text):
    samples, types = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            _, _, name, kind = line.split()
            types[name] = kind
        elif line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            samples[name] = float(value)
    return samples, types


def test_metrics_endpoint_prometheus_format():
    from daft_tpu_torch.observability.dashboard import launch

    dash = launch()
    try:
        with cpu():
            dt.from_pydict({"a": list(range(100))}).where(col("a") > 10).to_pydict()
        ctype, body = _get(dash.url + "/metrics")
        assert ctype.startswith("text/plain")
        samples, types = _parse_prometheus(body.decode())
        assert types["daft_tpu_hbm_bytes_resident"] == "gauge"
        assert types.get("daft_tpu_device_stage_batches") == "counter"
        assert types.get("daft_tpu_launches_segment_sum_planes") == "counter"
        assert "daft_tpu_spill_batches" in samples
        assert types["daft_tpu_query_latency_seconds"] == "histogram"
        assert samples["daft_tpu_query_latency_seconds_count"] >= 1
        vals = [v for k, v in samples.items()
                if k.startswith("daft_tpu_query_latency_seconds_bucket")]
        assert vals and vals == sorted(vals)
        assert vals[-1] == samples["daft_tpu_query_latency_seconds_count"]
    finally:
        dash.shutdown()


def test_histogram_quantiles():
    from daft_tpu_torch.observability.metrics import Histogram

    h = Histogram()
    for _ in range(90):
        h.observe(0.02)
    for _ in range(10):
        h.observe(4.0)
    assert h.quantile(0.5) == 0.025
    assert h.quantile(0.99) == 5.0
    lines = h.prometheus_lines("m")
    assert lines[0] == "# TYPE m histogram"
    assert 'm_bucket{le="+Inf"} 100' in lines
    assert "m_count 100" in lines


def test_spill_counters_flow_through_registry(tmp_path):
    from daft_tpu_torch.execution import memory as mem
    from daft_tpu_torch.observability.metrics import registry
    from daft_tpu_torch.ops import counters

    rng = np.random.default_rng(5)
    df = dt.from_pydict({"k": rng.integers(0, 500, 50_000).tolist(),
                         "v": rng.uniform(0, 1, 50_000).tolist()})
    mem.reset_counters()
    before = registry().snapshot()
    with cpu(memory_limit_bytes=64 * 1024, device_mode="off", spill_dir=str(tmp_path)):
        df.groupby("k").agg(col("v").sum().alias("s")).to_pydict()
    diff = registry().diff(before)
    assert diff.get("spill_batches", 0) > 0, diff
    assert diff.get("spill_bytes", 0) > 0, diff
    assert counters.spill_batches == registry().get("spill_batches")
    assert counters.spill_bytes == registry().get("spill_bytes")
    mem.reset_counters()
    assert counters.spill_batches == 0 and counters.spill_bytes == 0


def test_event_log_round_trip(tmp_path):
    from daft_tpu_torch.observability.event_log import (SCHEMA_VERSION, disable_event_log,
                                                        enable_event_log)

    assert SCHEMA_VERSION == 11
    p = str(tmp_path / "ev.jsonl")
    sub = enable_event_log(p)
    try:
        with cpu():
            dt.from_pydict({"a": list(range(100))}).where(col("a") > 4).to_pydict()
    finally:
        disable_event_log(sub)
    events = [json.loads(line) for line in open(p)]
    assert events and all(e["schema_version"] == 11 for e in events)
    ops = [e for e in events if e["event"] == "operator_stats"]
    assert ops
    for o in ops:
        for f in ("compute_seconds", "starve_seconds", "blocked_seconds"):
            assert f in o, o
        assert o["seconds"] == pytest.approx(
            o["compute_seconds"] + o["starve_seconds"] + o["blocked_seconds"])


def test_progress_subscriber_prints_one_line_per_query():
    import io

    from daft_tpu_torch.observability.progress import ProgressSubscriber
    from daft_tpu_torch.observability.subscribers import attach_subscriber, detach_subscriber

    stream = io.StringIO()
    sub = ProgressSubscriber(stream)
    attach_subscriber(sub)
    try:
        with cpu():
            dt.from_pydict({"a": [1, 2, 3]}).where(col("a") > 1).to_pydict()
    finally:
        detach_subscriber(sub)
    out = stream.getvalue()
    assert out.startswith("✓ query ") and ": 2 rows in " in out
