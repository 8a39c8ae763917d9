"""OpenTelemetry trace export: query lifecycle -> OTLP/HTTP JSON spans
(counterpart of daft_tpu/observability/otlp.py).

The OTLP JSON encoding (ExportTraceServiceRequest shape) is emitted directly
over stdlib urllib: no SDK dependency, works against any OTLP/HTTP collector
at {endpoint}/v1/traces.

Span tree per query:
    daft.query  (root: query id, row count, error status)
      +- daft.optimize               (plan optimization)
      +- daft.operator:{name} x N    (per-physical-operator self time + rows)
      +- daft.task:{stage} x M       (distributed sub-plan tasks, when a
           +- daft.operator:{name}     runner reports them; none in the port
                                       until its workers are ported)

Attach with:
    from daft_tpu_torch.observability.otlp import OTLPSubscriber
    attach_subscriber(OTLPSubscriber("http://localhost:4318"))
or set DAFT_TPU_OTLP_ENDPOINT before importing daft_tpu_torch.observability,
which then attaches one (maybe_attach_from_env). The service and scope name
is "daft_tpu_torch", so a collector tells the two packages apart.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
import urllib.request
from typing import Dict, List, Optional

from .events import (OperatorStats, QueryEnd, QueryOptimized, QueryStart,
                     TaskStats)
from .subscribers import Subscriber, attach_subscriber


def _span_id(*parts: str) -> str:
    return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]


def _trace_id(query_id: str) -> str:
    return hashlib.sha256(query_id.encode()).hexdigest()[:32]


def _attr(key: str, value) -> dict:
    if isinstance(value, bool):
        return {"key": key, "value": {"boolValue": value}}
    if isinstance(value, int):
        return {"key": key, "value": {"intValue": str(value)}}
    if isinstance(value, float):
        return {"key": key, "value": {"doubleValue": value}}
    return {"key": key, "value": {"stringValue": str(value)}}


class OTLPSubscriber(Subscriber):
    """Buffers spans per query; exports one OTLP/HTTP JSON request per query
    end. Export runs on a daemon thread and failures are swallowed (the
    subscriber contract: observability must never fail a query)."""

    def __init__(self, endpoint: str, service_name: str = "daft_tpu_torch",
                 timeout: float = 5.0, asynchronous: bool = True):
        self.endpoint = endpoint.rstrip("/")
        self.service_name = service_name
        self.timeout = timeout
        self.asynchronous = asynchronous
        self._starts: Dict[str, float] = {}
        self._optimize: Dict[str, QueryOptimized] = {}
        self._op_stats: Dict[str, List[OperatorStats]] = {}
        self._task_stats: Dict[str, List[TaskStats]] = {}
        self._lock = threading.Lock()
        self.exported = 0          # test/observability hook
        self.last_error: Optional[str] = None

    # ---- lifecycle ---------------------------------------------------------------
    def on_query_start(self, event: QueryStart) -> None:
        with self._lock:
            self._starts[event.query_id] = time.time()

    def on_query_optimized(self, event: QueryOptimized) -> None:
        with self._lock:
            self._optimize[event.query_id] = event

    def on_operator_stats(self, query_id: str, stats: OperatorStats) -> None:
        with self._lock:
            self._op_stats.setdefault(query_id, []).append(stats)

    def on_task_stats(self, query_id: str, stats: TaskStats) -> None:
        with self._lock:
            self._task_stats.setdefault(query_id, []).append(stats)

    def on_query_end(self, event: QueryEnd) -> None:
        with self._lock:
            t0 = self._starts.pop(event.query_id, time.time() - event.seconds)
            opt = self._optimize.pop(event.query_id, None)
            ops = self._op_stats.pop(event.query_id, [])
            tasks = self._task_stats.pop(event.query_id, [])
        payload = self._encode(event, t0, opt, ops, tasks)
        if self.asynchronous:
            threading.Thread(target=self._post, args=(payload,), daemon=True,
                             name="daft-otlp").start()
        else:
            self._post(payload)

    # ---- OTLP JSON ----------------------------------------------------------------
    def _encode(self, end: QueryEnd, t0: float, opt: Optional[QueryOptimized],
                ops: List[OperatorStats],
                tasks: Optional[List[TaskStats]] = None) -> dict:
        qid = end.query_id
        trace = _trace_id(qid)
        root = _span_id(qid, "query")
        ns0 = int(t0 * 1e9)
        ns_end = int((t0 + end.seconds) * 1e9)
        spans = [{
            "traceId": trace, "spanId": root, "name": "daft.query",
            "kind": 1, "startTimeUnixNano": str(ns0), "endTimeUnixNano": str(ns_end),
            "attributes": [_attr("daft.query_id", qid), _attr("daft.rows", end.rows)],
            "status": {"code": 2, "message": end.error} if end.error else {"code": 1},
        }]
        if opt is not None:
            spans.append({
                "traceId": trace, "spanId": _span_id(qid, "optimize"),
                "parentSpanId": root, "name": "daft.optimize", "kind": 1,
                "startTimeUnixNano": str(ns0),
                "endTimeUnixNano": str(ns0 + int(opt.optimize_seconds * 1e9)),
                "attributes": [],
                "status": {"code": 1},
            })
        for s in ops:
            spans.append({
                "traceId": trace, "spanId": _span_id(qid, "op", str(s.node_id)),
                "parentSpanId": root, "name": f"daft.operator:{s.name}", "kind": 1,
                "startTimeUnixNano": str(ns0),
                "endTimeUnixNano": str(ns0 + int(s.seconds * 1e9)),
                "attributes": [_attr("daft.rows_out", s.rows_out),
                               _attr("daft.batches_out", s.batches_out),
                               _attr("daft.compute_s", s.compute_seconds),
                               _attr("daft.starve_s", s.starve_seconds),
                               _attr("daft.blocked_s", s.blocked_seconds)],
                "status": {"code": 1},
            })
        # distributed sub-plan tasks: the worker computed span_id from the
        # trace context stamped on its SubPlanTask (same _trace_id/_span_id
        # scheme), so its task + operator spans join THIS query's waterfall
        for ts in tasks or ():
            t_trace = ts.trace_id or trace
            t_span = ts.span_id or _span_id(t_trace, "task", ts.task_id)
            t_ns0 = int(ts.started_at * 1e9) if ts.started_at else ns0
            t_ns1 = t_ns0 + int(ts.exec_s * 1e9)
            spans.append({
                "traceId": t_trace, "spanId": t_span,
                "parentSpanId": ts.parent_span_id or root,
                "name": f"daft.task:{ts.stage_id}", "kind": 1,
                "startTimeUnixNano": str(t_ns0), "endTimeUnixNano": str(t_ns1),
                "attributes": [
                    _attr("daft.task_id", ts.task_id),
                    _attr("daft.worker_id", ts.worker_id),
                    _attr("daft.rows_out", ts.rows_out),
                    _attr("daft.bytes_out", ts.bytes_out),
                    _attr("daft.queue_wait_s", ts.queue_wait_s),
                    _attr("daft.schedule_latency_s", ts.schedule_latency_s),
                    _attr("daft.retries", ts.retries),
                ],
                "status": {"code": 1},
            })
            for s in ts.operator_stats:
                spans.append({
                    "traceId": t_trace,
                    "spanId": _span_id(t_span, "op", str(s.node_id)),
                    "parentSpanId": t_span,
                    "name": f"daft.operator:{s.name}", "kind": 1,
                    "startTimeUnixNano": str(t_ns0),
                    "endTimeUnixNano": str(t_ns0 + int(s.seconds * 1e9)),
                    "attributes": [_attr("daft.rows_out", s.rows_out),
                                   _attr("daft.batches_out", s.batches_out),
                                   _attr("daft.compute_s", s.compute_seconds),
                                   _attr("daft.starve_s", s.starve_seconds),
                                   _attr("daft.blocked_s", s.blocked_seconds)],
                    "status": {"code": 1},
                })
        return {"resourceSpans": [{
            "resource": {"attributes": [_attr("service.name", self.service_name)]},
            "scopeSpans": [{"scope": {"name": "daft_tpu_torch"}, "spans": spans}],
        }]}

    def _post(self, payload: dict) -> None:
        try:
            body = json.dumps(payload).encode("utf-8")
            req = urllib.request.Request(
                self.endpoint + "/v1/traces", data=body,
                headers={"Content-Type": "application/json"}, method="POST")
            with urllib.request.urlopen(req, timeout=self.timeout):
                pass
            self.exported += 1
            self.last_error = None
        except Exception as e:  # noqa: BLE001 — never fail the query
            self.last_error = f"{type(e).__name__}: {e}"


def maybe_attach_from_env() -> Optional[OTLPSubscriber]:
    """Attach an exporter when DAFT_TPU_OTLP_ENDPOINT is set."""
    endpoint = os.environ.get("DAFT_TPU_OTLP_ENDPOINT")
    if not endpoint:
        return None
    sub = OTLPSubscriber(endpoint)
    attach_subscriber(sub)
    return sub
