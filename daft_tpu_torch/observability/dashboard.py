"""Embedded web dashboard: live query history + per-operator stats
(counterpart of daft_tpu/observability/dashboard.py).

A Subscriber records query lifecycle events into a bounded in-memory
history; a threaded HTTP server (127.0.0.1 by default, port 0 picks a free
one) renders them as JSON (/api/queries, /api/query/<id>, /api/engine,
/api/flight, ...), Prometheus text (/metrics) and a self-contained HTML page
(/). /api/placement serves the cost model's placement ledger and the
calibration in effect.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

from .events import OperatorStats, QueryEnd, QueryOptimized, QueryStart
from .metrics import Histogram, prometheus_text
from .subscribers import Subscriber, attach_subscriber, detach_subscriber

_HTML = """<!doctype html><html><head><title>daft_tpu_torch dashboard</title>
<style>
body{font-family:monospace;margin:1.5em;background:#111;color:#ddd}
table{border-collapse:collapse;width:100%%}
td,th{border:1px solid #333;padding:4px 8px;text-align:left;vertical-align:top}
th{background:#222}.ok{color:#7c7}.err{color:#e77}.run{color:#cc7}
tr.q{cursor:pointer} tr.q:hover{background:#1a1a2a}
pre{background:#181820;padding:8px;overflow-x:auto;border:1px solid #333}
.bar{background:#357;display:inline-block;height:10px;vertical-align:middle}
#detail{margin-top:1em} .counters span{margin-right:2em;color:#9cf}
h2,h3{color:#eee}
</style></head><body>
<h2>daft_tpu_torch — live queries</h2>
<div class="counters" id="eng"></div>
<div class="counters" id="wk"></div>
<div class="counters" id="srv"></div>
<div id="t"></div><div id="detail"></div>
<script>
let selected = null;
function esc(x){ return String(x ?? '').replace(/&/g,'&amp;').replace(/</g,'&lt;').replace(/>/g,'&gt;'); }
async function refresh(){
  const [qs, eng, wk, srv] = await Promise.all([
    (await fetch('/api/queries')).json(), (await fetch('/api/engine')).json(),
    (await fetch('/api/workers')).json(), (await fetch('/api/serving')).json()]);
  document.getElementById('eng').innerHTML =
    Object.entries(eng).map(([k,v])=>`<span>${k}: ${v}</span>`).join('');
  document.getElementById('wk').innerHTML =
    Object.entries(wk).map(([k,v])=>`<span>${esc(k)}: busy ${(100*v.busy_fraction).toFixed(0)}% `+
      `done ${v.last?v.last.tasks_completed:0} rss ${v.last?(v.last.rss_bytes/1048576).toFixed(0):0}MiB</span>`).join('');
  document.getElementById('srv').innerHTML =
    Object.entries(srv).map(([t,s])=>`<span>tenant ${esc(t)}: ${s.queries}q `+
      `hit ${(100*s.prepared_hit_rate).toFixed(0)}% waits ${s.admission_waits} `+
      `p99 ${(1000*s.p99_s).toFixed(0)}ms</span>`).join('');
  let h = '<table><tr><th>id</th><th>status</th><th>rows</th><th>seconds</th><th>top operators</th></tr>';
  for (const q of qs){
    const ops = (q.operators||[]).slice(0,3).map(o=>`${esc(o.name)}: ${o.rows_out}r / ${(o.seconds*1000).toFixed(1)}ms`).join('<br>');
    const st = q.error ? 'err' : (q.done ? 'ok' : 'run');
    h += `<tr class="q" onclick="show('${esc(q.query_id)}')"><td>${esc(q.query_id)}</td>`+
         `<td class="${st}">${esc(q.error)||(q.done?'done':'running')}</td>`+
         `<td>${q.rows??''}</td><td>${q.seconds?.toFixed?.(3)??''}</td><td>${ops}</td></tr>`;
  }
  document.getElementById('t').innerHTML = h + '</table>';
  if (selected) show(selected, true);
}
async function show(id, silent){
  selected = id;
  const q = await (await fetch('/api/query/'+id)).json();
  if (q.error_404){ if(!silent) document.getElementById('detail').innerHTML=''; return; }
  const maxs = Math.max(1e-9, ...(q.operators||[]).map(o=>o.seconds));
  const rows = (q.operators||[]).map(o=>
    `<tr><td>${esc(o.name)}</td><td>${o.rows_out}</td><td>${o.batches}</td>`+
    `<td>${(o.seconds*1000).toFixed(1)}ms <span class="bar" style="width:${(120*o.seconds/maxs)|0}px"></span></td></tr>`).join('');
  document.getElementById('detail').innerHTML =
    `<h3>query ${esc(id)}</h3>`+
    `<table><tr><th>operator</th><th>rows out</th><th>batches</th><th>self time</th></tr>${rows}</table>`+
    `<h3>physical plan (execution DAG)</h3><pre>${esc(q.physical_plan)||'(pending)'}</pre>`+
    `<h3>logical plan</h3><pre>${esc(q.plan)}</pre>`;
}
refresh(); setInterval(refresh, 1000);
</script></body></html>"""


class DashboardState(Subscriber):
    """Bounded history of query events (newest first) + a time-windowed view
    of worker heartbeats (slot occupancy, task counts, RSS)."""

    def __init__(self, max_queries: int = 100, max_heartbeats: int = 512,
                 max_traces: int = 32):
        self._lock = threading.Lock()
        self._queries: deque = deque(maxlen=max_queries)
        self._by_id: dict = {}
        self._max_heartbeats = max_heartbeats
        self._workers: dict = {}  # worker_id -> deque of heartbeat dicts
        # worker_id -> {ts, reason}: latched by the liveness monitor's
        # synthetic dead beat; cleared if the id beats again (respawn reuse)
        self._dead_workers: dict = {}
        # query_id -> QueryTrace (bounded separately from the query records:
        # traces hold per-task spans and are served as downloads, not JSON'd
        # into /api/queries)
        self._traces: dict = {}
        self._trace_order: deque = deque()
        self._max_traces = max_traces
        # per-query wall-clock latency, fixed Prometheus buckets -> p50/p99
        # derivable by any scraper (and locally via .quantile)
        self.query_latency = Histogram()
        # serving tier: per-tenant latency histograms (the tenant label on
        # daft_tpu_query_latency_seconds in /metrics) + per-tenant serving
        # totals for the hit-rate table (/api/serving)
        self.tenant_latency: dict = {}
        self._serving: dict = {}
        # gateway tier: per-tenant wire rollup (/api/gateway)
        self._gateway: dict = {}

    def on_query_start(self, event: QueryStart) -> None:
        rec = {"query_id": event.query_id, "started": time.time(),
               "plan": event.unoptimized_plan, "done": False, "operators": []}
        with self._lock:
            self._queries.appendleft(rec)
            self._by_id[event.query_id] = rec

    def on_query_optimized(self, event: QueryOptimized) -> None:
        with self._lock:
            rec = self._by_id.get(event.query_id)
            if rec is not None:
                rec["physical_plan"] = event.physical_plan

    def on_operator_stats(self, query_id: str, stats: OperatorStats) -> None:
        with self._lock:
            rec = self._by_id.get(query_id)
            if rec is not None:
                rec["operators"].append({
                    "name": stats.name, "rows_out": stats.rows_out,
                    "batches": stats.batches_out, "seconds": stats.seconds,
                })

    def on_task_stats(self, query_id: str, stats) -> None:
        with self._lock:
            rec = self._by_id.get(query_id)
            if rec is not None:
                rec.setdefault("tasks", []).append({
                    "stage_id": stats.stage_id, "task_id": stats.task_id,
                    "worker_id": stats.worker_id, "exec_s": stats.exec_s,
                    "rows_out": stats.rows_out,
                })

    def on_shuffle_stats(self, query_id: str, stats) -> None:
        with self._lock:
            rec = self._by_id.get(query_id)
            if rec is not None:
                rec.setdefault("shuffles", []).append({
                    "stage_id": stats.stage_id,
                    "bytes_written": stats.bytes_written,
                    "bytes_fetched": stats.bytes_fetched,
                    "fetch_requests": stats.fetch_requests,
                    "wire_bytes_written": getattr(stats, "wire_bytes_written", 0),
                    "overlap_seconds": getattr(stats, "overlap_seconds", 0.0),
                    "fetch_fanin": getattr(stats, "fetch_fanin", 0),
                })

    def on_worker_heartbeat(self, query_id: str, hb) -> None:
        with self._lock:
            dq = self._workers.get(hb.worker_id)
            if dq is None:
                dq = self._workers[hb.worker_id] = deque(
                    maxlen=self._max_heartbeats)
            # idempotent on re-delivery: the runner's fast-query fallback
            # (WorkerPool.latest_heartbeats survives window drains) can hand
            # a later query the SAME beat an earlier query already notified;
            # per-worker beat ts is monotonic, so a duplicate appends nothing
            # and the busy-fraction window never double-counts a beat
            if dq and dq[-1]["ts"] >= hb.ts and not getattr(hb, "dead", False):
                return
            dq.append({"ts": hb.ts, "busy_slots": hb.busy_slots,
                       "total_slots": hb.total_slots,
                       "tasks_completed": hb.tasks_completed,
                       "tasks_failed": hb.tasks_failed,
                       "rss_bytes": hb.rss_bytes,
                       "hbm_bytes": getattr(hb, "hbm_bytes", 0),
                       "hbm_h2d_bytes": getattr(hb, "hbm_h2d_bytes", 0),
                       "hbm_digest_entries": getattr(hb, "hbm_digest_entries", 0)})
            # a dead beat is the liveness monitor's synthetic FINAL report:
            # latch it per worker so /api/workers marks the row dead instead
            # of silently letting it go stale (and a later respawn under the
            # same id un-latches by sending real beats again)
            if getattr(hb, "dead", False):
                self._dead_workers[hb.worker_id] = {
                    "ts": hb.ts, "reason": getattr(hb, "death_reason", "")}
            elif hb.worker_id in self._dead_workers:
                self._dead_workers.pop(hb.worker_id, None)

    def on_query_trace(self, query_id: str, trace) -> None:
        with self._lock:
            if query_id not in self._traces:
                self._trace_order.append(query_id)
                while len(self._trace_order) > self._max_traces:
                    self._traces.pop(self._trace_order.popleft(), None)
            self._traces[query_id] = trace

    def trace(self, query_id: str):
        with self._lock:
            return self._traces.get(query_id)

    def on_serve_query(self, rec) -> None:
        """One ServingSession query: observe latency into the aggregate AND
        the tenant's labeled histogram, accumulate the per-tenant hit-rate
        row. Serving's in-process fast path does not emit QueryEnd, so this
        is where its latency reaches the aggregate histogram; runner-backed
        serving DOES emit QueryEnd (observed in on_query_end), so only the
        tenant series records here — never both."""
        if getattr(rec, "in_process", True):
            self.query_latency.observe(rec.seconds)
        with self._lock:
            h = self.tenant_latency.get(rec.tenant)
            if h is None:
                h = self.tenant_latency[rec.tenant] = Histogram()
            st = self._serving.setdefault(rec.tenant, {
                "queries": 0, "errors": 0, "prepared_hits": 0,
                "admission_waits": 0, "wait_s": 0.0, "seconds": 0.0,
                "rows": 0})
            st["queries"] += 1
            st["seconds"] += rec.seconds
            st["rows"] += rec.rows
            st["wait_s"] += rec.admission_wait_s
            if rec.prepared_hit:
                st["prepared_hits"] += 1
            if getattr(rec, "admission_waited", False):
                st["admission_waits"] += 1
            if rec.error:
                st["errors"] += 1
        h.observe(rec.seconds)

    def serving(self) -> dict:
        """Per-tenant serving rollup: queries, prepared hit RATE, admission
        waits, mean latency + local p50/p99 from the tenant histogram."""
        with self._lock:
            tenants = {k: dict(v) for k, v in self._serving.items()}
            hists = dict(self.tenant_latency)
        out = {}
        for tenant, st in tenants.items():
            n = max(st["queries"], 1)
            h = hists.get(tenant)
            out[tenant] = {
                **st,
                "prepared_hit_rate": round(st["prepared_hits"] / n, 4),
                "mean_s": st["seconds"] / n,
                "p50_s": h.quantile(0.5) if h else 0.0,
                "p99_s": h.quantile(0.99) if h else 0.0,
            }
        return out

    def on_gateway_query(self, rec) -> None:
        """One gateway query (execute->fetch over the wire): accumulate the
        per-tenant wire rollup, split by result tier. Engine-side latency
        already lands via on_serve_query (the gateway executes through a
        ServingSession), so only wire-level totals accrue here."""
        with self._lock:
            st = self._gateway.setdefault(rec.tenant, {
                "queries": 0, "errors": 0, "bytes_streamed": 0, "rows": 0,
                "seconds": 0.0, "executed": 0, "result_cache": 0,
                "checkpoint": 0})
            st["queries"] += 1
            st["seconds"] += rec.seconds
            st["rows"] += rec.rows
            st["bytes_streamed"] += rec.bytes_streamed
            if rec.source in st:
                st[rec.source] += 1
            if rec.error:
                st["errors"] += 1

    def gateway(self) -> dict:
        """Per-tenant gateway rollup: wire queries by result tier (executed /
        result_cache / checkpoint), cache-hit RATE, bytes streamed, mean wire
        latency — /api/gateway's data source."""
        with self._lock:
            tenants = {k: dict(v) for k, v in self._gateway.items()}
        out = {}
        for tenant, st in tenants.items():
            n = max(st["queries"], 1)
            out[tenant] = {
                **st,
                "cache_hit_rate":
                    round((st["result_cache"] + st["checkpoint"]) / n, 4),
                "mean_s": st["seconds"] / n,
            }
        return out

    def on_query_end(self, event: QueryEnd) -> None:
        self.query_latency.observe(event.seconds)
        with self._lock:
            rec = self._by_id.get(event.query_id)
            if rec is not None:
                rec.update(done=True, rows=event.rows, seconds=event.seconds,
                           error=event.error)
                if event.metrics:
                    rec["metrics"] = dict(event.metrics)
                rec["operators"].sort(key=lambda o: -o["seconds"])

    def snapshot(self) -> list:
        with self._lock:
            return [dict(r) for r in self._queries]

    def query(self, query_id: str) -> Optional[dict]:
        with self._lock:
            rec = self._by_id.get(query_id)
            return dict(rec) if rec is not None else None

    def workers(self, window_s: float = 60.0) -> dict:
        """Per-worker utilization: last report + busy fraction over beats from
        the last `window_s` seconds (the deque maxlen only bounds memory; the
        utilization view is scoped by TIME, so a long-idle worker's stale
        beats don't report as current load)."""
        now = time.time()
        with self._lock:
            out = {}
            for wid, dq in self._workers.items():
                beats = list(dq)
                recent = [b for b in beats if b["ts"] >= now - window_s]
                busy = sum(1 for b in recent if b["busy_slots"] > 0)
                dead = self._dead_workers.get(wid)
                out[wid] = {
                    "last": beats[-1] if beats else None,
                    "heartbeats": len(beats),
                    "recent": len(recent),
                    "busy_fraction": busy / len(recent) if recent else 0.0,
                    # liveness-monitor verdict: a dead worker stays in the
                    # table, MARKED, with its failure classification
                    "dead": dead is not None,
                    "death_reason": dead["reason"] if dead else "",
                    # HBM residency gauges from the latest beat: device-buffer
                    # bytes held across queries, cumulative h2d upload bytes
                    # (flat across repeats = served from residency), and the
                    # size of the digest the scheduler uses for cache affinity
                    "hbm_bytes": beats[-1].get("hbm_bytes", 0) if beats else 0,
                    "hbm_h2d_bytes":
                        beats[-1].get("hbm_h2d_bytes", 0) if beats else 0,
                    "hbm_digest_entries":
                        beats[-1].get("hbm_digest_entries", 0) if beats else 0,
                }
            return out


def _label_escape(v: str) -> str:
    """Prometheus label-value escaping (backslash, quote, newline)."""
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Handler(BaseHTTPRequestHandler):
    def log_message(self, *a):
        pass

    def _metrics_text(self) -> str:
        """Prometheus exposition: full registry + live HBM residency gauges
        (read straight off the manager, so hbm_bytes_resident is present and
        current even in a process that never updated the registry gauge) +
        the per-query latency histogram."""
        from ..device.residency import manager
        from .metrics import registry

        st = manager().stats()
        extra = {"hbm_bytes_resident": st["bytes_resident"],
                 "hbm_bytes_high_water": registry().value("hbm_bytes_high_water"),
                 "hbm_entries": st["entries"]}
        state = self.server.state
        with state._lock:
            tenant_hists = dict(state.tenant_latency)
        labeled = {}
        if tenant_hists:
            # per-tenant label on the query-latency histogram family: the
            # unlabeled aggregate and the tenant series share one TYPE line
            labeled["query_latency_seconds"] = {
                f'tenant="{_label_escape(t)}"': h
                for t, h in tenant_hists.items()}
        return prometheus_text(
            extra_gauges=extra,
            histograms={"query_latency_seconds": state.query_latency},
            labeled_histograms=labeled)

    def do_GET(self):
        if self.path.startswith("/api/queries"):
            body = json.dumps(self.server.state.snapshot(), default=str).encode()
            ctype = "application/json"
        elif self.path.startswith("/api/query/") and self.path.endswith("/trace"):
            # Chrome trace-event JSON download for one query's timeline
            # (open in Perfetto / chrome://tracing)
            qid = self.path.split("/")[-2]
            trace = self.server.state.trace(qid)
            if trace is None:
                body = json.dumps({"error_404": True}).encode()
            else:
                rec = self.server.state.query(qid) or {}
                body = json.dumps(trace.to_chrome_trace(
                    total_seconds=rec.get("seconds"))).encode()
            ctype = "application/json"
        elif self.path.startswith("/api/query/"):
            qid = self.path.rsplit("/", 1)[1]
            rec = self.server.state.query(qid)
            body = json.dumps(rec if rec is not None else {"error_404": True},
                              default=str).encode()
            ctype = "application/json"
        elif self.path == "/metrics" or self.path.startswith("/metrics?"):
            body = self._metrics_text().encode()
            ctype = "text/plain; version=0.0.4"
        elif self.path.startswith("/api/engine"):
            from .metrics import registry as _registry

            # the full registry: device counters, kernel launches, spill
            body = json.dumps(_registry().snapshot()).encode()
            ctype = "application/json"
        elif self.path.startswith("/api/workers"):
            body = json.dumps(self.server.state.workers(), default=str).encode()
            ctype = "application/json"
        elif self.path.startswith("/api/serving"):
            # per-tenant serving rollup (queries, prepared hit rate,
            # admission waits, p50/p99) — the hit-rate table's data source
            body = json.dumps(self.server.state.serving(), default=str).encode()
            ctype = "application/json"
        elif self.path.startswith("/api/gateway"):
            # per-tenant gateway rollup (wire queries by result tier, cache
            # hit rate, bytes streamed) + the process result-cache counters
            from .metrics import registry as _registry

            snap = _registry().snapshot()
            body = json.dumps({
                "tenants": self.server.state.gateway(),
                "counters": {k: v for k, v in snap.items()
                             if k.startswith(("gateway_", "result_cache_"))},
            }, default=str).encode()
            ctype = "application/json"
        elif self.path.startswith("/api/flight"):
            # the flight recorder's live ring + anomaly dump inventory
            # (observability/flight.py), served hot for a triage view
            from . import flight

            frec = flight.recorder()
            if frec is None:
                body = json.dumps({"enabled": False}).encode()
            else:
                body = json.dumps({
                    "enabled": True,
                    "ring": frec.snapshot(limit=128),
                    "ring_dropped": frec.dropped,
                    "dump_dir": frec.dump_dir,
                    "dumps": list(frec.dumps),
                }, default=str).encode()
            ctype = "application/json"
        elif self.path.startswith("/api/placement"):
            # the cost-model decision ledger: recent placement records
            # (chosen tier, per-term breakdowns, observed-vs-predicted),
            # ledger stats, the aggregate model-error summary, and the
            # effective calibration terms the process is pricing with
            from ..ops.costmodel import calibration_dict
            from .placement import ledger

            led = ledger()
            body = json.dumps({
                "records": led.snapshot(limit=128),
                "stats": led.stats(),
                "error": led.error_summary(),
                "calibration": calibration_dict(),
            }, default=str).encode()
            ctype = "application/json"
        elif self.path == "/" or self.path.startswith("/index"):
            body = _HTML.encode()
            ctype = "text/html"
        else:
            self.send_response(404)
            self.end_headers()
            return
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


class Dashboard:
    """launch() attaches the subscriber and serves until shutdown()."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0):
        self.state = DashboardState()
        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.state = self.state
        self._thread: Optional[threading.Thread] = None

    @property
    def url(self) -> str:
        h, p = self._server.server_address[:2]
        return f"http://{h}:{p}"

    def launch(self) -> "Dashboard":
        attach_subscriber(self.state)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()
        return self

    def shutdown(self) -> None:
        detach_subscriber(self.state)
        self._server.shutdown()


def launch(host: str = "127.0.0.1", port: int = 0) -> Dashboard:
    """Start the dashboard and attach its subscriber."""
    return Dashboard(host, port).launch()
