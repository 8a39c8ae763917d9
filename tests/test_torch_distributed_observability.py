"""The distributed tier's observability (counterpart of
tests/test_distributed_observability.py): per-task stats, shuffle
counters, worker heartbeats, the trace's task spans in OTLP, the
dashboard's worker table, distributed EXPLAIN ANALYZE, the fetch server's
counters, and the metrics registry they all write through. Each
distributed query's result is also held to the reference's single-process
run on the same seeded columns (keys exactly, float sums rtol 1e-12).
"""

import json
import threading

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
import daft_tpu_torch.runners as runners
from daft_tpu_torch import col
from daft_tpu_torch.config import execution_config_ctx
from daft_tpu_torch.observability.metrics import MetricsRegistry, registry


@pytest.fixture(scope="module")
def dist_runner():
    import os

    from daft_tpu_torch.distributed import DistributedRunner

    os.environ["DAFT_TPU_HEARTBEAT_S"] = "0.2"
    with execution_config_ctx(device="cpu"):
        r = DistributedRunner(num_workers=2, n_partitions=2)
    try:
        yield r
    finally:
        r.shutdown()
        os.environ.pop("DAFT_TPU_HEARTBEAT_S", None)


def _groupby_cols(n=20_000, seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 50, n).tolist(), "v": rng.uniform(0, 1, n).tolist()}


def _groupby_df(n=20_000, seed=0):
    return daft_tpu_torch.from_pydict(_groupby_cols(n, seed))


def _run_distributed(dist_runner, q):
    with execution_config_ctx(device="cpu"):
        runners.set_runner(dist_runner)
        try:
            return q().to_pydict()
        finally:
            runners.set_runner(None)


def test_distributed_groupby_equals_reference(dist_runner):
    data = _groupby_cols(seed=9)
    got = _run_distributed(dist_runner, lambda: daft_tpu_torch.from_pydict(data)
                           .groupby("k").agg(col("v").sum().alias("s")).sort("k"))
    want = (daft_tpu.from_pydict(data).groupby("k")
            .agg(daft_tpu.col("v").sum().alias("s")).sort("k").to_pydict())
    assert got["k"] == want["k"]
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-12)


def test_distributed_event_log_has_tasks_shuffles_heartbeats(dist_runner, tmp_path):
    from daft_tpu_torch.observability.event_log import (disable_event_log,
                                                  enable_event_log)

    p = str(tmp_path / "dist_events.jsonl")
    sub = enable_event_log(p)
    df = _groupby_df()
    try:
        out = _run_distributed(
            dist_runner,
            lambda: df.groupby("k").agg(col("v").sum().alias("s")).sort("k"))
        assert len(out["k"]) == 50
    finally:
        disable_event_log(sub)

    events = [json.loads(l) for l in open(p)]
    assert all(e["schema_version"] == 11 for e in events)
    by_kind = {}
    for e in events:
        by_kind.setdefault(e["event"], []).append(e)

    # per-task stats with queue wait / exec time / rows
    tasks = by_kind["task_stats"]
    assert len(tasks) >= 4  # 2 shuffle-map + 2 final tasks
    for t in tasks:
        assert t["worker_id"].startswith("worker-")
        assert t["exec_s"] > 0
        assert t["queue_wait_s"] >= 0
        assert t["schedule_latency_s"] >= 0
        assert "retries" in t and t["retries"] == 0
        assert t["stage_id"]
    assert sum(t["rows_out"] for t in tasks) >= 50
    # worker-side operator stats rode along
    assert any(t["operator_stats"] for t in tasks)
    # v4: per-task worker engine-counter deltas ship in the record
    assert all("engine_counters" in t for t in tasks)

    # per-stage shuffle byte counters
    shuffles = by_kind["shuffle_stats"]
    assert any(s["bytes_written"] > 0 and s["rows_written"] > 0
               for s in shuffles)
    assert any(s["bytes_fetched"] > 0 and s["fetch_requests"] > 0
               for s in shuffles)
    # v5: wire/logical + overlap attribution travels in the record
    assert all("wire_bytes_written" in s and "fetch_wall_seconds" in s
               and "overlap_seconds" in s and "fetch_fanin" in s
               for s in shuffles)
    assert any(s["wire_bytes_written"] > 0 for s in shuffles)

    # >= 1 worker heartbeat with utilization fields
    hbs = by_kind["worker_heartbeat"]
    assert len(hbs) >= 1
    assert all(h["total_slots"] >= 1 and h["rss_bytes"] > 0 for h in hbs)

    # query_end carries the per-query metrics-registry deltas
    end = by_kind["query_end"][0]
    assert end["metrics"].get("shuffle_bytes_written", 0) > 0


def test_distributed_explain_analyze_renders_stage_skew(dist_runner):
    df = _groupby_df(seed=1)
    with execution_config_ctx(device="cpu"):
        runners.set_runner(dist_runner)
        try:
            report = (df.groupby("k").agg(col("v").sum().alias("s"))
                      .explain_analyze())
        finally:
            runners.set_runner(None)
    assert "== Distributed Stages ==" in report
    assert "min/median/max task" in report
    assert "shuffle:" in report and "final:" in report
    assert "worker-0" in report or "worker-1" in report
    # device/shuffle attribution appears in the report, not only bench.py
    assert "== Engine Counters ==" in report
    assert "shuffle_bytes_written" in report


def test_distributed_otlp_spans_share_query_trace(dist_runner):
    """Worker-side task + operator spans join the coordinator query's OTLP trace:
    span tree daft.query -> daft.task -> daft.operator, one trace id, and the
    trace id is the stable hash of the query id (otlp._trace_id)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from daft_tpu_torch.observability.otlp import OTLPSubscriber, _trace_id
    from daft_tpu_torch.observability.subscribers import (attach_subscriber,
                                                    detach_subscriber)

    received = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            received.append(json.loads(body))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    sub = OTLPSubscriber(f"http://127.0.0.1:{srv.server_address[1]}",
                         asynchronous=False)
    attach_subscriber(sub)
    df = _groupby_df(seed=2)
    try:
        _run_distributed(
            dist_runner,
            lambda: df.groupby("k").agg(col("v").sum().alias("s")))
    finally:
        detach_subscriber(sub)
        srv.shutdown()

    assert sub.exported == 1 and sub.last_error is None
    spans = received[0]["resourceSpans"][0]["scopeSpans"][0]["spans"]
    roots = [s for s in spans if "parentSpanId" not in s]
    assert len(roots) == 1 and roots[0]["name"] == "daft.query"
    root = roots[0]
    # trace-id stability: derived from the query id via the shared scheme
    qid_attr = {a["key"]: a["value"] for a in root["attributes"]}
    qid = qid_attr["daft.query_id"]["stringValue"]
    assert root["traceId"] == _trace_id(qid)
    # every span (coordinator ops, worker tasks, worker ops) shares the trace
    assert all(s["traceId"] == root["traceId"] for s in spans)
    task_spans = [s for s in spans if s["name"].startswith("daft.task:")]
    assert len(task_spans) >= 4
    assert all(t["parentSpanId"] == root["spanId"] for t in task_spans)
    task_ids = {t["spanId"] for t in task_spans}
    worker_ops = [s for s in spans if s.get("parentSpanId") in task_ids]
    assert worker_ops, "no worker-side operator spans under task spans"
    names = {s["name"] for s in worker_ops}
    assert any(n.startswith("daft.operator:") for n in names)


def test_dashboard_worker_utilization_endpoint(dist_runner):
    import urllib.request

    from daft_tpu_torch.observability.dashboard import launch

    dash = launch()
    df = _groupby_df(seed=3)
    try:
        _run_distributed(
            dist_runner,
            lambda: df.groupby("k").agg(col("v").mean().alias("m")))
        with urllib.request.urlopen(dash.url + "/api/workers", timeout=5) as r:
            workers = json.loads(r.read())
        assert workers, "no worker heartbeats reached the dashboard"
        w = next(iter(workers.values()))
        assert w["heartbeats"] >= 1 and w["last"]["rss_bytes"] > 0
        # engine endpoint now serves the full registry incl. shuffle volume
        with urllib.request.urlopen(dash.url + "/api/engine", timeout=5) as r:
            eng = json.loads(r.read())
        assert "device_join_batches" in eng
        assert eng.get("shuffle_bytes_written", 0) > 0
    finally:
        dash.shutdown()


def test_pool_trace_survives_worker_death(tmp_path):
    """With one worker dead, the pool still records a full trace for the
    stage: every finished task carries timing + the stamped trace context."""
    from daft_tpu_torch.core.micropartition import MicroPartition
    from daft_tpu_torch.distributed.task import SubPlanTask
    from daft_tpu_torch.distributed.trace import QueryTrace
    from daft_tpu_torch.distributed.worker import WorkerPool
    from daft_tpu_torch.plan import physical as pp

    pool = WorkerPool(2)
    try:
        part = MicroPartition.from_pydict({"a": [1, 2, 3]})
        plan = pp.InMemoryScan([part], part.schema)
        w0 = pool.workers["worker-0"]
        w0._proc.terminate()
        w0._proc.wait()
        trace = QueryTrace("q-test")
        tasks = [SubPlanTask.from_plan(f"t{i}", plan, stage_id="s0")
                 for i in range(4)]
        results = pool.run_tasks(tasks, stage_id="s0", trace=trace)
        assert len(results) == 4
        assert len(trace.tasks) == 4
        assert all(t.exec_s > 0 for t in trace.tasks)
        # trace context was stamped at dispatch
        assert all(t.trace_id == trace.trace_id for t in trace.tasks)
        summaries = trace.stage_summaries()
        assert summaries[0]["tasks"] == 4
        assert summaries[0]["max_s"] >= summaries[0]["min_s"]
    finally:
        pool.shutdown()


def test_socket_transport_fetch_server_counts_requests():
    """With shuffle_transport='socket', the coordinator-side fetch server counts
    requests/bytes served (per-server stats + registry counters)."""
    from daft_tpu_torch.distributed import DistributedRunner

    with execution_config_ctx(device="cpu"):
        r = DistributedRunner(num_workers=2, n_partitions=2, shuffle_transport="socket")
    before = registry().snapshot()
    try:
        df = _groupby_df(n=8_000, seed=4)
        out = _run_distributed(r, lambda: df.groupby("k").agg(col("v").sum().alias("s")))
        assert len(out["k"]) == 50
        st = r._fetch_server.stats()
        assert st["requests"] > 0 and st["bytes_served"] > 0
        deltas = registry().diff(before)
        assert deltas.get("shuffle_fetch_server_requests", 0) > 0
    finally:
        r.shutdown()


# ---------------------------------------------------------------------------
# Metrics registry
# ---------------------------------------------------------------------------

def test_metrics_registry_snapshot_and_diff():
    reg = MetricsRegistry()
    reg.declare("a")
    before = reg.snapshot()
    assert before == {"a": 0}
    reg.inc("a", 3)
    reg.inc("b")
    reg.set_gauge("g", 1.5)
    snap = reg.snapshot()
    assert snap == {"a": 3, "b": 1, "g": 1.5}
    d = reg.diff(before)
    assert d == {"a": 3, "b": 1, "g": 1.5}
    reg.reset()
    assert reg.snapshot() == {"a": 0, "b": 0}


def test_metrics_registry_thread_safety():
    reg = MetricsRegistry()

    def work():
        for _ in range(1000):
            reg.inc("n")

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert reg.get("n") == 8000


def test_counters_module_reads_registry():
    """ops.counters module attributes are views over the shared registry."""
    from daft_tpu_torch.ops import counters

    counters.reset()
    assert counters.device_stage_batches == 0
    counters.bump("device_stage_batches", 2)
    assert counters.device_stage_batches == 2
    assert registry().get("device_stage_batches") == 2
    assert counters.snapshot()["device_stage_batches"] == 2
    counters.reset()
    assert counters.device_stage_batches == 0
