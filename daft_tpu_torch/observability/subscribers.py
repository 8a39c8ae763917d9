"""Subscriber registry (counterpart of daft_tpu/observability/subscribers.py).

Attach a Subscriber to receive query lifecycle events from every runner in
the process. Callbacks must not raise; exceptions are swallowed so a broken
subscriber can never fail a query.
"""

from __future__ import annotations

import threading
from typing import List

from .metrics import registry
from .events import (FlightAnomaly, GatewayQueryRecord, OperatorStats,
                     QueryEnd, QueryOptimized, QueryStart, ServeQueryRecord,
                     ShuffleStats, TaskStats, WorkerHeartbeat)


class Subscriber:
    """Override any subset of the lifecycle callbacks."""

    def on_query_start(self, event: QueryStart) -> None:  # pragma: no cover
        pass

    def on_query_optimized(self, event: QueryOptimized) -> None:  # pragma: no cover
        pass

    def on_operator_stats(self, query_id: str, stats: OperatorStats) -> None:  # pragma: no cover
        pass

    def on_task_stats(self, query_id: str, stats: TaskStats) -> None:  # pragma: no cover
        pass

    def on_shuffle_stats(self, query_id: str, stats: ShuffleStats) -> None:  # pragma: no cover
        pass

    def on_worker_heartbeat(self, query_id: str, hb: WorkerHeartbeat) -> None:  # pragma: no cover
        pass

    def on_query_trace(self, query_id: str, trace) -> None:  # pragma: no cover
        """The distributed run's assembled QueryTrace (distributed/trace.py)
        at query end — the timeline profiler's source object. Subscribers
        that persist it should render via trace.to_chrome_trace()."""
        pass

    def on_serve_query(self, rec: ServeQueryRecord) -> None:  # pragma: no cover
        """One query served through a ServingSession (per-tenant latency,
        prepared-cache hit, admission wait) — the reference's serving tier."""
        pass

    def on_gateway_query(self, rec: GatewayQueryRecord) -> None:  # pragma: no cover
        """One query answered over the gateway wire protocol (per-tenant
        bytes streamed + which tier answered: executed, result cache, or
        checkpoint restore) — the reference's gateway."""
        pass

    def on_flight_anomaly(self, event: FlightAnomaly) -> None:  # pragma: no cover
        """The flight recorder fired an anomaly trigger (slow query, query
        error, ledger pressure, device fallback, worker death) — see
        observability/flight.py. event.dump_path names the ring
        snapshot when one was written."""
        pass

    def on_query_end(self, event: QueryEnd) -> None:  # pragma: no cover
        pass


_SUBSCRIBERS: List[Subscriber] = []
_LOCK = threading.Lock()


def attach_subscriber(sub: Subscriber) -> None:
    with _LOCK:
        _SUBSCRIBERS.append(sub)


def detach_subscriber(sub: Subscriber) -> None:
    with _LOCK:
        if sub in _SUBSCRIBERS:
            _SUBSCRIBERS.remove(sub)


def subscribers_active() -> bool:
    return bool(_SUBSCRIBERS)


def notify(method: str, *args) -> None:
    with _LOCK:
        subs = list(_SUBSCRIBERS)
    for s in subs:
        try:
            getattr(s, method)(*args)
        except Exception:
            # a broken subscriber must never fail the query — but its
            # failures must be visible somewhere, so they hit the scrape
            # surface instead of vanishing
            registry().inc("subscriber_errors")
