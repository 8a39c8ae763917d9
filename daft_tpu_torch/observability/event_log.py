"""JSONL query event log (counterpart of daft_tpu/observability/event_log.py,
the same record shapes and schema version).

Attach an EventLogSubscriber to append one JSON line per lifecycle event —
a durable, grep-able audit trail that doubles as the integration point for
external trace pipelines (each record carries the query id, wall time, and
the event payload).
"""

from __future__ import annotations

import dataclasses
import json
import threading
import time

from .subscribers import Subscriber, attach_subscriber, detach_subscriber

# Bumped whenever a record's shape changes so downstream trace pipelines can
# branch on it. v1: implicit (no field). v2: adds schema_version to every
# record plus the distributed task_stats/shuffle_stats/worker_heartbeat kinds
# and query_end.metrics. v3: worker_heartbeat gains hbm_h2d_bytes +
# hbm_digest_entries (cache-affinity scheduling observability). v4:
# task_stats gains engine_counters (per-task worker registry deltas — device
# dispatches, coalescing, HBM traffic).
# v5: shuffle_stats gains wire_bytes_written / fetch_wall_seconds /
# overlap_seconds / fetch_fanin (pipelined compressed shuffle transport).
# v6: operator_stats records (standalone and nested in task_stats) gain the
# stall-attribution split compute_seconds / starve_seconds / blocked_seconds
# (seconds == their sum); worker_heartbeat gains recv_ts (coordinator receive
# stamp backing the Chrome-trace clock-offset estimate); spill counters
# (spill_batches/spill_bytes) now appear in query_end.metrics.
# v7: adds the serve_query record kind (serving tier — tenant, latency,
# prepared-cache hit, admission wait; see events.ServeQueryRecord).
# v8: worker_heartbeat gains dead + death_reason (synthetic final beat from
# the pool's liveness monitor — elastic fault tolerance); query_end.metrics
# may now carry the recovery counters (worker_failures_total,
# tasks_requeued_total, shuffle_maps_regenerated_total, worker_respawns_total,
# fetch_retries_total, checkpoint_stages_committed/skipped).
# v9: query_end gains placements — the query's placement-decision records
# (site, chosen tier, per-term cost breakdowns for every priced tier,
# cached/forced flags, margin, and observed-vs-predicted device seconds for
# dispatched stages; observability/placement.py); query_end.metrics may carry
# the placement_* counters and the cost_* calibration/error gauges.
# v10: adds the flight_anomaly record kind (observability/flight.py — kind,
# detail, query_id, tenant, dump_path); query_end.metrics may carry the
# flight_* counters; bench captures gain per_query_profile (per-query
# operator compute/starve/blocked splits + counter deltas).
# v11: adds the gateway_query record kind (the reference's gateway — tenant,
# seconds, rows, source executed|result_cache|checkpoint, bytes_streamed,
# prepared_handle; see events.GatewayQueryRecord); query_end.metrics and
# serve captures may carry the gateway_*/result_cache_* counters.
SCHEMA_VERSION = 11


class EventLogSubscriber(Subscriber):
    def __init__(self, path: str):
        self.path = path
        self._lock = threading.Lock()

    def _emit(self, kind: str, payload: dict) -> None:
        rec = {"ts": time.time(), "schema_version": SCHEMA_VERSION,
               "event": kind, **payload}
        # the lock serializes appends to this log file; subscribers are off
        # the engine's hot path
        with self._lock, open(self.path, "a") as f:
            f.write(json.dumps(rec, default=str) + "\n")

    def on_query_start(self, e) -> None:
        self._emit("query_start", dataclasses.asdict(e))

    def on_query_optimized(self, e) -> None:
        self._emit("query_optimized", dataclasses.asdict(e))

    def on_operator_stats(self, qid, s) -> None:
        self._emit("operator_stats", {"query_id": qid, **dataclasses.asdict(s)})

    def on_task_stats(self, qid, s) -> None:
        d = dataclasses.asdict(s)
        # operator stats are emitted as spans/records of their own scale; keep
        # the task record flat and grep-able
        d["operator_stats"] = [{"name": o["name"], "rows_out": o["rows_out"],
                                "seconds": o["seconds"],
                                "compute_seconds": o.get("compute_seconds", 0.0),
                                "starve_seconds": o.get("starve_seconds", 0.0),
                                "blocked_seconds": o.get("blocked_seconds", 0.0)}
                               for o in d.get("operator_stats", ())]
        self._emit("task_stats", {"query_id": qid, **d})

    def on_shuffle_stats(self, qid, s) -> None:
        self._emit("shuffle_stats", {"query_id": qid, **dataclasses.asdict(s)})

    def on_worker_heartbeat(self, qid, hb) -> None:
        self._emit("worker_heartbeat", {"query_id": qid,
                                        **dataclasses.asdict(hb)})

    def on_serve_query(self, rec) -> None:
        self._emit("serve_query", dataclasses.asdict(rec))

    def on_gateway_query(self, rec) -> None:
        self._emit("gateway_query", dataclasses.asdict(rec))

    def on_flight_anomaly(self, e) -> None:
        self._emit("flight_anomaly", dataclasses.asdict(e))

    def on_query_end(self, e) -> None:
        d = dataclasses.asdict(e)
        d.pop("operator_stats", None)  # emitted individually above
        self._emit("query_end", d)


def enable_event_log(path: str) -> EventLogSubscriber:
    sub = EventLogSubscriber(path)
    attach_subscriber(sub)
    return sub


def disable_event_log(sub: EventLogSubscriber) -> None:
    detach_subscriber(sub)
