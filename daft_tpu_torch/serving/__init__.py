"""Serving tier: concurrent multi-tenant queries over one warm engine
(counterpart of daft_tpu/serving/).

A ``ServingSession`` runs N queries at once behind a fair admission queue
(per-tenant round-robin, FIFO within a tenant), brackets each run with an
HBM admission-controller reservation (queries wait while the budget is
spoken for instead of evicting each other's pinned planes), and serves
repeat queries through a prepared-query cache that skips optimize and
translate and lands on the warm device planes.

    from daft_tpu_torch.serving import ServingSession

    with ServingSession(max_concurrent=4) as sess:
        fut = sess.submit(df.groupby("k").agg(...), tenant="acme")
        parts = fut.result()          # list[MicroPartition]

Observability: the ``serve_queue_depth`` / ``hbm_reserved_bytes`` gauges,
the ``admission_waits_total`` / ``serve_prepared_hits`` /
``serve_prepared_misses`` / ``serve_queries_total`` counters, and one
ServeQueryRecord per query to subscribers.
"""

from ..cancellation import QueryCancelled
from .admission import FairAdmissionQueue, TenantQueueFull, tenant_queue_cap, tenant_weight
from .prepared import PreparedQueryCache, estimate_pin_bytes, plan_structure
from .session import ServeFuture, ServingSession

__all__ = [
    "FairAdmissionQueue",
    "PreparedQueryCache",
    "QueryCancelled",
    "ServeFuture",
    "ServingSession",
    "TenantQueueFull",
    "estimate_pin_bytes",
    "plan_structure",
    "tenant_queue_cap",
    "tenant_weight",
]
