"""The port's observability tier (daft_tpu_torch/observability/, runners/,
the executor's and the pipeline's hooks) against the reference's
(daft_tpu/observability/, tests/test_observability.py's cases):

- subscriber lifecycle events, errors in QueryEnd, a broken subscriber never
  failing a query (and counted in ``subscriber_errors``), the zero-overhead
  guard (no wrap, no span record, no stall clock, no profiled channel, an
  empty registry diff on a host query with no observer), self-time
  attribution, EXPLAIN ANALYZE, the dashboard, the event log, the OTLP
  exporter against a local collector on port 0;
- kept stage threads: an observed query, then an unobserved one on the same
  kept threads, takes the zero-overhead path, and a stage that leaves a
  collector or a span override set on its thread does not hand it on;
- parity with the reference on the same seeded query on the CPU: the same
  subscriber event sequence, the same operator names and rows out (the
  physical plans are equal), the same registry deltas for the names both
  packages have (exact: they count batches, rows and bytes), the same span
  names and counts per name on a device_mode="on" grouped aggregation (the
  reference's JAX CPU backend against the port's plain kernels on CPU
  tensors), equal Histogram quantiles and equal Prometheus text for the
  same registry content.

Differences allowed in the registry parity, each for its reason:
``plain_*`` / ``launches_*`` (the port's kernel counters), ``hbm_bytes_resident`` /
``hbm_bytes_high_water`` (gauges: the port counts only card bytes, and on
the CPU its planes are host tensors).
"""

import json
import threading
import time
import urllib.request
from collections import Counter

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch as dt
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch import col
from daft_tpu_torch.observability import (OperatorStats, QueryEnd, QueryOptimized,
                                          QueryStart, Subscriber, attach_subscriber,
                                          detach_subscriber)

SEED = 20261018


def cpu(**kw):
    """The port's execution config for a CPU run (no card here)."""
    return dt.execution_config_ctx(device="cpu", **kw)


def _recorder_class(base):
    class Recorder(base):
        def __init__(self):
            self.events = []

        def on_query_start(self, e):
            self.events.append(("start", e))

        def on_query_optimized(self, e):
            self.events.append(("optimized", e))

        def on_operator_stats(self, qid, s):
            self.events.append(("op", s))

        def on_query_end(self, e):
            self.events.append(("end", e))

    return Recorder


Recorder = _recorder_class(Subscriber)


@pytest.fixture
def recorder():
    r = Recorder()
    attach_subscriber(r)
    yield r
    detach_subscriber(r)


def test_event_sequence_and_contents(recorder):
    df = dt.from_pydict({"a": list(range(100)), "b": ["x", "y"] * 50})
    with cpu():
        out = df.where(col("a") >= 50).select("a").to_pydict()
    assert len(out["a"]) == 50

    kinds = [k for k, _ in recorder.events]
    assert kinds[0] == "start"
    assert kinds[1] == "optimized"
    assert kinds[-1] == "end"
    assert "op" in kinds

    start = recorder.events[0][1]
    assert isinstance(start, QueryStart) and start.query_id
    optimized = recorder.events[1][1]
    assert isinstance(optimized, QueryOptimized)
    assert "Filter" in start.unoptimized_plan
    assert optimized.physical_plan
    end = recorder.events[-1][1]
    assert isinstance(end, QueryEnd)
    assert end.rows == 50
    assert end.error is None
    assert end.query_id == start.query_id
    ops = {s.name: s for k, s in recorder.events if k == "op"}
    assert all(isinstance(s, OperatorStats) for s in ops.values())
    assert any(s.rows_out == 50 for s in ops.values()), ops


def test_error_reported_in_query_end(recorder):
    df = dt.from_pydict({"a": [1, 2, 3]})

    @dt.func
    def boom(x: int) -> int:
        raise ValueError("nope")

    with pytest.raises(Exception), cpu():
        df.select(boom(col("a"))).to_pydict()
    end = recorder.events[-1][1]
    assert isinstance(end, QueryEnd)
    assert end.error is not None and ("nope" in end.error or "ValueError" in end.error)


def test_broken_subscriber_never_fails_query():
    from daft_tpu_torch.observability.metrics import registry

    class Broken(Subscriber):
        def on_query_start(self, e):
            raise RuntimeError("subscriber bug")

    b = Broken()
    attach_subscriber(b)
    e0 = registry().get("subscriber_errors")
    try:
        with cpu():
            out = dt.from_pydict({"a": [1]}).to_pydict()
        assert out == {"a": [1]}
    finally:
        detach_subscriber(b)
    assert registry().get("subscriber_errors") - e0 == 1


def test_no_subscribers_no_overhead_path():
    """Without subscribers the collector stays None (zero-overhead path)."""
    from daft_tpu_torch.observability.runtime_stats import current_collector

    with cpu():
        dt.from_pydict({"a": [1, 2]}).where(col("a") > 1).to_pydict()
    assert current_collector() is None


def _forbid_instrumentation(monkeypatch):
    """The reference guard's four bans, installed on the port's classes."""
    from daft_tpu_torch.execution import pipeline
    from daft_tpu_torch.observability import runtime_stats

    def _forbidden_wrap(self, node, iterator):
        raise AssertionError("StatsCollector.wrap called on the zero-overhead path")

    def _forbidden_span(self, *a, **k):
        raise AssertionError("SpanRecorder.record called on the zero-overhead path")

    def _forbidden_stall(self, *a, **k):
        raise AssertionError("stall attribution ran on the zero-overhead path")

    monkeypatch.setattr(runtime_stats.StatsCollector, "wrap", _forbidden_wrap)
    monkeypatch.setattr(runtime_stats.SpanRecorder, "record", _forbidden_span)
    monkeypatch.setattr(runtime_stats.StatsCollector, "note_starve", _forbidden_stall)
    monkeypatch.setattr(runtime_stats.StatsCollector, "note_blocked", _forbidden_stall)

    orig_channel_init = pipeline.Channel.__init__

    def _checked_init(self, maxsize=4, profile=None):
        assert profile is None, "profiled Channel on the zero-overhead path"
        orig_channel_init(self, maxsize, profile)

    monkeypatch.setattr(pipeline.Channel, "__init__", _checked_init)


def _guard_query():
    df = dt.from_pydict({"a": list(range(1000)), "b": ["x", "y"] * 500})
    return df.where(col("a") >= 500).groupby("b").agg(col("a").sum().alias("s"))


def test_overhead_guard_zero_subscribers_zero_instrumentation(monkeypatch):
    """With no subscribers attached, a host query takes the zero-overhead
    path: no StatsCollector wrapping, no span recording, no stall-clock
    reads on the pipeline channels, and the metrics registry untouched
    (the flight recorder, on by default, reads the registry but writes
    nothing)."""
    from daft_tpu_torch.observability import runtime_stats
    from daft_tpu_torch.observability.metrics import registry
    from daft_tpu_torch.observability.subscribers import subscribers_active

    assert not subscribers_active(), \
        "leaked subscriber from another test would invalidate this guard"
    assert runtime_stats.current_spans() is None, \
        "leaked span recorder from another test would invalidate this guard"
    _forbid_instrumentation(monkeypatch)
    before = registry().snapshot()
    with cpu(device_mode="off", pipeline_mode="force"):
        out = _guard_query().to_pydict()
    assert len(out["b"]) == 2
    assert registry().diff(before) == {}, "registry touched with no observers"


def test_kept_stage_threads_do_not_leak_observers(monkeypatch, tmp_path):
    """An observed query (explain_analyze with a profile: collector, span
    recorder, profiled channels) and then an unobserved one on the same kept
    stage threads: the second takes the zero-overhead path, the guard's bans
    installed."""
    from daft_tpu_torch.execution.pipeline import IDLE_THREAD_NAME

    with cpu(device_mode="off", pipeline_mode="force"):
        report = _guard_query().explain_analyze(profile=str(tmp_path / "t.json"))
        assert "== Runtime Stats ==" in report
        idle = {t.ident for t in threading.enumerate() if t.name == IDLE_THREAD_NAME}
        assert idle, "no stage thread was kept"
        _forbid_instrumentation(monkeypatch)
        out = _guard_query().to_pydict()
    assert sorted(out["b"]) == ["x", "y"]


def test_kept_stage_thread_drops_a_stage_left_collector_and_span_override():
    """A stage that sets a collector and a span-recorder override on its
    thread and never restores them: the next stage on that kept thread sees
    neither."""
    from daft_tpu_torch.execution.pipeline import spawn_stage
    from daft_tpu_torch.observability import runtime_stats

    seen = []

    def leaky():
        runtime_stats.set_collector(runtime_stats.StatsCollector())
        runtime_stats.span_scope(runtime_stats.SpanRecorder()).__enter__()
        seen.append(threading.get_ident())
        yield from ()

    def probe():
        seen.append((threading.get_ident(), runtime_stats.current_collector(),
                     runtime_stats.current_spans()))
        yield from ()

    list(spawn_stage(leaky()))
    list(spawn_stage(probe()))
    ident, collector, spans = seen[1]
    assert ident == seen[0], "the second stage ran on another thread"
    assert collector is None and spans is None


def test_stats_collector_nested_self_time():
    """Self-time attribution with nested operators: the parent's attributed
    time excludes its child's production time."""
    from daft_tpu_torch.observability.runtime_stats import StatsCollector

    class FakeNode:
        def __init__(self, name):
            self._name = name

        def name(self):
            return self._name

    class Part:
        num_rows = 1

    child_node, parent_node = FakeNode("child"), FakeNode("parent")
    c = StatsCollector()

    def child_gen():
        for _ in range(3):
            time.sleep(0.02)
            yield Part()

    child_stream = c.wrap(child_node, child_gen())

    def parent_gen():
        for part in child_stream:
            time.sleep(0.005)
            yield part

    parent_stream = c.wrap(parent_node, parent_gen())
    assert sum(p.num_rows for p in parent_stream) == 3
    stats = {s.name: s for s in c.finish()}
    assert stats["child"].rows_out == 3 and stats["parent"].rows_out == 3
    assert stats["child"].seconds >= 0.05
    assert stats["parent"].seconds < stats["child"].seconds
    assert stats["parent"].seconds < 0.045


def test_otlp_trace_id_stable_and_derived_from_query_id():
    from daft_tpu_torch.observability.otlp import _span_id, _trace_id

    assert _trace_id("abc") == _trace_id("abc")
    assert _trace_id("abc") != _trace_id("abd")
    assert len(_trace_id("abc")) == 32
    assert _span_id("abc", "task", "t0") == _span_id("abc", "task", "t0")
    assert len(_span_id("abc", "task", "t0")) == 16


def test_explain_analyze_reports_operators():
    rng = np.random.default_rng(0)
    df = dt.from_pydict({
        "k": rng.choice(["a", "b", "c"], 10_000).tolist(),
        "v": rng.uniform(0, 1, 10_000).tolist(),
    })
    with cpu():
        report = (df.where(col("v") > 0.5)
                  .groupby("k").agg(col("v").sum().alias("s"))
                  .sort("k")
                  .explain_analyze())
    assert "== Physical Plan ==" in report
    assert "== Runtime Stats ==" in report
    assert "rows out" in report
    assert "PhysSort" in report
    sort_row = next(line for line in report.splitlines() if line.startswith("PhysSort "))
    assert sort_row.split()[1] == "3"
    assert "== Engine Counters ==" in report and "device_grouped_batches" in report


def test_explain_show_all_and_placement():
    df = dt.from_pydict({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
    q = df.where(col("v") > 1).groupby("k").agg(col("v").sum().alias("s"))
    assert q.explain().startswith("== Unoptimized Logical Plan ==")
    assert "Physical Plan" not in q.explain()
    with cpu():
        full = q.explain(show_all=True)
    assert "== Optimized Logical Plan ==" in full
    assert "== Physical Plan ==\n* DeviceGroupedAgg" in full
    with cpu():
        report = q.explain_placement()
    # device_mode="on" prices nothing: one forced record of the grouped stage
    assert report.startswith("== Placement Decisions ==\n#1 grouped agg")
    assert "-> device  [forced]" in report


def test_metrics_record_batch():
    df = dt.from_pydict({"k": [1, 2, 1, 2], "v": [1.0, 2.0, 3.0, 4.0]})
    with cpu():
        m = df.where(col("v") > 1).select("k").metrics().to_pydict()
    assert set(m) == {"operator", "rows_out", "batches", "self_time_s"}
    assert dict(zip(m["operator"], m["rows_out"]))["PhysFilter"] == 3
    assert all(t >= 0 for t in m["self_time_s"])


def _get(url):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.headers.get("Content-Type", ""), r.read()


def test_dashboard_serves_query_history():
    from daft_tpu_torch.observability.dashboard import launch

    dash = launch()
    try:
        with cpu():
            dt.from_pydict({"a": list(range(10))}).where(col("a") > 4).to_pydict()
        data = json.loads(_get(dash.url + "/api/queries")[1])
        assert data and data[0]["done"] and data[0]["rows"] == 5
        assert data[0]["operators"], "no operator stats recorded"
        assert b"daft_tpu_torch" in _get(dash.url + "/")[1]
    finally:
        dash.shutdown()


def test_event_log_writes_jsonl(tmp_path):
    from daft_tpu_torch.observability.event_log import disable_event_log, enable_event_log

    p = str(tmp_path / "events.jsonl")
    sub = enable_event_log(p)
    try:
        with cpu():
            dt.from_pydict({"a": [1, 2, 3]}).where(col("a") > 1).to_pydict()
    finally:
        disable_event_log(sub)
    events = [json.loads(line) for line in open(p)]
    kinds = [e["event"] for e in events]
    assert kinds[0] == "query_start" and kinds[-1] == "query_end"
    assert "operator_stats" in kinds
    assert events[-1]["rows"] == 2


def test_otlp_subscriber_exports_span_tree():
    """OTLP/HTTP JSON export: one root query span with optimize + operator
    children, against a collector on 127.0.0.1, port 0."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    from daft_tpu_torch.observability.otlp import OTLPSubscriber

    received = []

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            body = self.rfile.read(int(self.headers["Content-Length"]))
            received.append((self.path, json.loads(body)))
            self.send_response(200)
            self.send_header("Content-Length", "2")
            self.end_headers()
            self.wfile.write(b"{}")

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        sub = OTLPSubscriber(f"http://127.0.0.1:{srv.server_address[1]}",
                             asynchronous=False)
        attach_subscriber(sub)
        try:
            df = dt.from_pydict({"a": list(range(100))})
            with cpu():
                df.where(col("a") > 40).select((col("a") * 3).alias("b")).to_pydict()
        finally:
            detach_subscriber(sub)

        assert sub.exported == 1 and sub.last_error is None
        path, payload = received[0]
        assert path == "/v1/traces"
        rs = payload["resourceSpans"][0]
        svc = {a["key"]: a["value"] for a in rs["resource"]["attributes"]}
        assert svc["service.name"]["stringValue"] == "daft_tpu_torch"
        spans = rs["scopeSpans"][0]["spans"]
        roots = [s for s in spans if "parentSpanId" not in s]
        assert len(roots) == 1 and roots[0]["name"] == "daft.query"
        root = roots[0]
        children = [s for s in spans if s.get("parentSpanId") == root["spanId"]]
        names = {s["name"] for s in children}
        assert "daft.optimize" in names
        assert any(n.startswith("daft.operator:") for n in names)
        assert all(s["traceId"] == root["traceId"] for s in spans)
        assert all(int(s["endTimeUnixNano"]) <= int(root["endTimeUnixNano"]) + 10**9
                   for s in children)
    finally:
        srv.shutdown()


def test_dashboard_detail_and_engine_endpoints():
    from daft_tpu_torch.observability.dashboard import launch

    dash = launch()
    try:
        df = dt.from_pydict({"a": list(range(50)), "g": [i % 3 for i in range(50)]})
        with cpu(device_mode="off"):
            df.where(col("a") > 5).groupby("g").agg(col("a").sum().alias("s")).to_pydict()
        queries = json.loads(_get(dash.url + "/api/queries")[1])
        assert queries and queries[0]["done"]
        qid = queries[0]["query_id"]
        detail = json.loads(_get(dash.url + f"/api/query/{qid}")[1])
        assert detail["query_id"] == qid
        assert "physical_plan" in detail and detail["operators"]
        assert any(o["rows_out"] > 0 for o in detail["operators"])
        eng = json.loads(_get(dash.url + "/api/engine")[1])
        assert "device_join_batches" in eng and "launches_segment_sum_planes" in eng
        html = _get(dash.url + "/")[1].decode()
        assert "physical plan" in html and "/api/engine" in html
        assert json.loads(_get(dash.url + "/api/query/nope")[1])["error_404"] is True
        placement = json.loads(_get(dash.url + "/api/placement")[1])
        assert {"records", "stats", "error", "calibration"} <= set(placement)
        assert json.loads(_get(dash.url + "/api/flight")[1])["enabled"] in (True, False)
    finally:
        dash.shutdown()


# ---------------------------------------------------------------------------
# parity with the reference on the CPU
# ---------------------------------------------------------------------------

def _data(n=30_000):
    rng = np.random.default_rng(SEED)
    return {"k": rng.integers(0, 8, n).tolist(), "v": rng.uniform(0, 100, n).tolist(),
            "a": list(range(n))}


def _filter_query(pkg, data):
    return pkg.from_pydict(data).where(pkg.col("a") >= 50).select("a", "k")


def _grouped_query(pkg, data):
    return pkg.from_pydict(data).groupby("k").agg(pkg.col("v").sum().alias("s"))


def _observe_both(query, device_mode):
    """(reference events, port events) of ``query`` under one recording
    subscriber each."""
    from daft_tpu.observability import Subscriber as RefSubscriber
    from daft_tpu.observability import attach_subscriber as ref_attach
    from daft_tpu.observability import detach_subscriber as ref_detach

    data = _data()
    ref = _recorder_class(RefSubscriber)()
    ref_attach(ref)
    try:
        with ref_ctx(device_mode=device_mode):
            want = query(daft_tpu, data).to_pydict()
    finally:
        ref_detach(ref)
    port = Recorder()
    attach_subscriber(port)
    try:
        with cpu(device_mode=device_mode):
            got = query(dt, data).to_pydict()
    finally:
        detach_subscriber(port)
    assert sorted(got) == sorted(want) and len(got["k"]) == len(want["k"])
    return ref.events, port.events


@pytest.mark.parametrize("query,device_mode", [(_filter_query, "off"),
                                               (_grouped_query, "on")],
                         ids=["host_filter", "device_grouped"])
def test_parity_event_sequence_and_operator_stats(query, device_mode):
    ref, port = _observe_both(query, device_mode)
    assert [k for k, _ in port] == [k for k, _ in ref]
    # the physical plans are equal, so the operators are too
    assert port[1][1].physical_plan == ref[1][1].physical_plan
    assert sorted((s.name, s.rows_out, s.batches_out) for k, s in port if k == "op") == \
        sorted((s.name, s.rows_out, s.batches_out) for k, s in ref if k == "op")
    assert port[-1][1].rows == ref[-1][1].rows


# names both vocabularies declare whose per-query deltas differ by design
_ALLOWED_DIFFERENT = ("hbm_bytes_resident", "hbm_bytes_high_water")


@pytest.mark.parametrize("query,device_mode", [(_filter_query, "off"),
                                               (_grouped_query, "on")],
                         ids=["host_filter", "device_grouped"])
def test_parity_registry_deltas_for_shared_names(query, device_mode):
    from daft_tpu.observability import metrics as ref_metrics
    from daft_tpu_torch.observability import metrics as port_metrics

    ref, port = _observe_both(query, device_mode)
    ref_m, port_m = ref[-1][1].metrics, port[-1][1].metrics
    shared = (set(ref_metrics.DECLARED_COUNTERS) | set(ref_metrics.DECLARED_GAUGES)) & \
        (set(port_metrics.DECLARED_COUNTERS) | set(port_metrics.DECLARED_GAUGES))
    shared -= set(_ALLOWED_DIFFERENT)
    assert {k: v for k, v in port_m.items() if k in shared} == \
        {k: v for k, v in ref_m.items() if k in shared}
    if device_mode == "on":
        assert port_m["device_grouped_batches"] == 1 and port_m["hbm_h2d_bytes"] > 0


def test_parity_device_span_names_and_counts():
    from daft_tpu.observability.runtime_stats import SpanRecorder as RefSpans
    from daft_tpu.observability.runtime_stats import set_spans as ref_set_spans
    from daft_tpu_torch.observability.runtime_stats import SpanRecorder, set_spans

    data = _data()
    ref = RefSpans()
    ref_set_spans(ref)
    try:
        with ref_ctx(device_mode="on"):
            _grouped_query(daft_tpu, data).to_pydict()
    finally:
        ref_set_spans(None)
    port = SpanRecorder()
    set_spans(port)
    try:
        with cpu(device_mode="on"):
            _grouped_query(dt, data).to_pydict()
    finally:
        set_spans(None)
    want = Counter(s["name"] for s in ref.drain())
    got = Counter(s["name"] for s in port.drain())
    assert got == want
    assert {"device.h2d", "device.dispatch", "device.d2h"} <= set(got)


def test_parity_histogram_quantiles():
    from daft_tpu.observability.metrics import Histogram as RefHistogram
    from daft_tpu_torch.observability.metrics import Histogram

    rng = np.random.default_rng(SEED)
    values = np.concatenate([rng.exponential(0.05, 500), rng.uniform(1, 400, 50)])
    h, r = Histogram(), RefHistogram()
    for v in values.tolist():
        h.observe(v)
        r.observe(v)
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert h.quantile(q) == r.quantile(q)
    assert h.prometheus_lines("m", labels='tenant="a"') == \
        r.prometheus_lines("m", labels='tenant="a"')
    # the reference's own case
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


def test_parity_prometheus_text_same_registry_content(monkeypatch):
    from daft_tpu.observability import metrics as ref_metrics
    from daft_tpu_torch.observability import metrics as port_metrics

    ref_reg, port_reg = ref_metrics.MetricsRegistry(), port_metrics.MetricsRegistry()
    monkeypatch.setattr(ref_metrics, "_REGISTRY", ref_reg)
    monkeypatch.setattr(port_metrics, "_REGISTRY", port_reg)
    for reg in (ref_reg, port_reg):
        reg.declare("device_stage_batches", "spill_bytes")
        reg.inc("device_stage_batches", 3)
        reg.inc("spill_bytes", 4096)
        reg.inc("a-b.c")
        reg.set_gauge("hbm_bytes_resident", 1.5e9)
        reg.set_gauge_max("scan_window_peak", 4)
        reg.set_gauge_max("scan_window_peak", 2)
    hists = {}
    for mod in (ref_metrics, port_metrics):
        h = mod.Histogram()
        for v in (0.003, 0.2, 7.0):
            h.observe(v)
        hists[mod] = h
    want = ref_metrics.prometheus_text(extra_gauges={"hbm_entries": 3},
                                       histograms={"query_latency_seconds":
                                                   hists[ref_metrics]})
    got = port_metrics.prometheus_text(extra_gauges={"hbm_entries": 3},
                                       histograms={"query_latency_seconds":
                                                   hists[port_metrics]})
    assert got == want
    assert "daft_tpu_a_b_c 1" in got


def test_registry_declares_every_counter_name():
    """Every name ops/counters.py reports is in the registry's vocabulary,
    and a fresh registry sees every series from the first scrape."""
    from daft_tpu_torch.observability.metrics import (DECLARED_COUNTERS, DECLARED_GAUGES,
                                                      MetricsRegistry, declare_vocabulary)
    from daft_tpu_torch.ops import counters

    assert set(counters.COUNTER_NAMES) <= set(DECLARED_COUNTERS) | set(DECLARED_GAUGES)
    reg = MetricsRegistry()
    declare_vocabulary(reg)
    snap = reg.snapshot()
    assert all(snap[n] == 0 for n in DECLARED_COUNTERS + DECLARED_GAUGES)
    assert isinstance(snap["scan_decode_ms"], float) and isinstance(snap["scan_tasks"], int)
    reg.inc("scan_decode_ms", 2.5)
    reg.reset(["scan_decode_ms"])
    assert reg.get("scan_decode_ms") == 0.0 and isinstance(reg.get("scan_decode_ms"), float)


def test_counters_read_the_registry_and_reset_is_scoped():
    from daft_tpu_torch.observability.metrics import registry
    from daft_tpu_torch.ops import counters

    counters.reset()
    counters.bump("device_stage_batches", 2)
    registry().set_gauge_max("scan_window_peak", 3)
    registry().inc("flight_anomalies_total")
    f0 = registry().get("flight_anomalies_total")
    assert counters.device_stage_batches == 2 == registry().get("device_stage_batches")
    assert counters.snapshot()["scan_window_peak"] == 3
    counters.reset()
    assert counters.device_stage_batches == 0 and counters.scan_window_peak == 0
    assert registry().get("flight_anomalies_total") == f0  # not counters' to wipe
    assert isinstance(counters.snapshot()["fingerprint_ms"], float)


def test_bucket_fill_ratio_gauge():
    """The coalescer's fill ratio as a registry gauge, dropped by
    counters.reset() with the coalescing counters it derives from."""
    from daft_tpu_torch.observability.metrics import registry
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.plan import logical as lp

    base = dt.from_pydict({"k": [i % 3 for i in range(3000)], "v": [1.0] * 3000})
    with cpu():
        part = base.collect()._result[0]
    df = dt.DataFrame(lp.InMemorySource(part.schema, [part] * 4))
    counters.reset()
    with cpu(morsel_size_rows=4096):
        df.groupby("k").agg(col("v").sum()).to_pydict()
    ratio = registry().value("bucket_fill_ratio")
    assert ratio == round(counters.bucket_fill_rows / counters.bucket_capacity_rows, 4)
    assert 0.5 <= ratio <= 1.0
    counters.reset()
    assert registry().value("bucket_fill_ratio") == 0


def test_residency_gauges_and_pins():
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.observability.metrics import registry

    df = dt.from_pydict({"k": [1, 2, 1, 2] * 100, "v": [1.0, 2.0, 3.0, 4.0] * 100})
    manager().clear()
    before = registry().snapshot()
    with cpu():
        df.groupby("k").agg(col("v").sum()).to_pydict()
    d = registry().diff(before)
    assert d["hbm_pins"] >= 1 and d["hbm_cache_misses"] >= 1 and d["hbm_h2d_bytes"] > 0
    before = registry().snapshot()
    with cpu():
        df.groupby("k").agg(col("v").sum()).to_pydict()
    d = registry().diff(before)
    assert "hbm_h2d_bytes" not in d and d["hbm_cache_hits"] >= 1  # warm: nothing uploaded


def test_registry_hammered_from_many_threads_loses_no_update():
    """More threads than cores bump one counter and race a high-water gauge
    under a short switch interval: the total and the peak are exact."""
    import os
    import sys

    from daft_tpu_torch.observability.metrics import MetricsRegistry

    reg = MetricsRegistry()
    n_threads, per_thread = 4 * (os.cpu_count() or 1) + 4, 2000
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer(t):
            for i in range(per_thread):
                reg.inc("n")
                reg.set_gauge_max("peak", t * per_thread + i)

        threads = [threading.Thread(target=hammer, args=(t,)) for t in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert reg.get("n") == n_threads * per_thread
    assert reg.value("peak") == n_threads * per_thread - 1
