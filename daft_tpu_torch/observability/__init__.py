"""Observability: query lifecycle events and subscribers, the metrics
registry, per-operator runtime stats with stall attribution, timeline spans,
the always-on flight recorder and the cost model's placement ledger
(placement.py; counterpart of daft_tpu/observability/).

    from daft_tpu_torch.observability import Subscriber, attach_subscriber
    df.explain_analyze(profile="trace.json")   # operators, counters, spans

Setting DAFT_TPU_OTLP_ENDPOINT before this package is imported attaches an
OTLP/HTTP exporter (otlp.py).
"""

from .events import (
    FlightAnomaly,
    GatewayQueryRecord,
    OperatorStats,
    QueryEnd,
    QueryOptimized,
    QueryStart,
    ServeQueryRecord,
    ShuffleStats,
    TaskStats,
    WorkerHeartbeat,
)
from .metrics import Histogram, MetricsRegistry, prometheus_text, registry
from .subscribers import (
    Subscriber,
    attach_subscriber,
    detach_subscriber,
    notify,
    subscribers_active,
)
from .runtime_stats import (SpanRecorder, StatsCollector, current_collector,
                            current_spans, profile_span, set_spans)

__all__ = [
    "FlightAnomaly",
    "GatewayQueryRecord",
    "OperatorStats",
    "QueryEnd",
    "QueryOptimized",
    "QueryStart",
    "ShuffleStats",
    "TaskStats",
    "ServeQueryRecord",
    "WorkerHeartbeat",
    "Histogram",
    "MetricsRegistry",
    "prometheus_text",
    "registry",
    "Subscriber",
    "attach_subscriber",
    "detach_subscriber",
    "notify",
    "subscribers_active",
    "SpanRecorder",
    "StatsCollector",
    "current_collector",
    "current_spans",
    "profile_span",
    "set_spans",
]

# OTLP trace export opt-in via environment (DAFT_TPU_OTLP_ENDPOINT)
from .otlp import OTLPSubscriber, maybe_attach_from_env as _maybe_attach_otlp  # noqa: E402

_maybe_attach_otlp()
