"""Query lifecycle event payloads (counterpart of
daft_tpu/observability/events.py, every record of it).

The task, shuffle, heartbeat, serve and gateway records have no producer in
the port until its workers and serving tier are ported; they are data that
``distributed/trace.py`` and the subscribers already read."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass(frozen=True)
class QueryStart:
    query_id: str
    unoptimized_plan: str


@dataclass(frozen=True)
class QueryOptimized:
    query_id: str
    optimized_plan: str
    physical_plan: str
    optimize_seconds: float


@dataclass(frozen=True)
class OperatorStats:
    """Per-physical-operator runtime metrics for one query execution.

    `node_id` is a stable per-query sequential id (wrap order), NOT id() —
    see StatsCollector.node_id. `seconds` (attributed self time) always
    equals compute + starve + blocked, so the stall split reconciles with
    the headline column: compute is the operator's own body, starve is time
    blocked pulling from an empty upstream stage channel, blocked is time
    its producer thread spent pushing into a full downstream channel."""

    node_id: int
    name: str
    rows_out: int
    batches_out: int
    seconds: float        # wall time attributed to this operator (self time)
    detail: str = ""
    compute_seconds: float = 0.0
    starve_seconds: float = 0.0
    blocked_seconds: float = 0.0


@dataclass(frozen=True)
class TaskStats:
    """One distributed sub-plan task's runtime record, shipped from the worker
    back with the result and aggregated per stage by the coordinator (reference:
    Flotilla per-task stats through the subscriber path)."""

    stage_id: str
    task_id: str
    worker_id: str
    queue_wait_s: float        # coordinator: submit -> dispatch (time in the scheduler heap)
    schedule_latency_s: float  # dispatch -> worker exec start (transport + unpickle)
    exec_s: float              # worker-side execution wall time
    rows_out: int
    bytes_out: int
    retries: int               # workers this task already failed on
    started_at: float = 0.0    # unix time on the worker
    trace_id: str = ""         # stamped trace context (otlp._trace_id scheme)
    span_id: str = ""
    parent_span_id: str = ""
    operator_stats: Tuple[OperatorStats, ...] = ()
    # worker metrics-registry counter deltas over the task (device dispatches,
    # coalescing, HBM traffic) — proves WHICH engine path the worker took
    engine_counters: Tuple[Tuple[str, float], ...] = ()


@dataclass(frozen=True)
class ShuffleStats:
    """Per-stage shuffle/transport volume (reference: shuffle_cache +
    flight_server counters)."""

    stage_id: str
    bytes_written: int = 0        # logical (uncompressed Arrow) bytes
    rows_written: int = 0
    partitions_written: int = 0
    bytes_fetched: int = 0        # wire bytes received
    rows_fetched: int = 0
    fetch_seconds: float = 0.0    # CUMULATIVE per-request in-flight time
    fetch_requests: int = 0
    # pipelined-transport additions: bytes that actually hit disk/the wire
    # (compression ratio = wire/logical), the union fetch transfer window
    # (fetch_seconds over-counts it by the overlapped seconds once requests
    # run concurrently), the overlap itself, and the max fetch fan-in
    wire_bytes_written: int = 0
    fetch_wall_seconds: float = 0.0
    overlap_seconds: float = 0.0
    fetch_fanin: int = 0


@dataclass(frozen=True)
class WorkerHeartbeat:
    """Periodic worker self-report: slot occupancy, task counts, RSS, HBM."""

    worker_id: str
    ts: float                  # unix time on the worker
    busy_slots: int
    total_slots: int
    tasks_completed: int
    tasks_failed: int
    rss_bytes: int
    uptime_s: float = 0.0
    # device bytes this worker's HBM residency manager holds (0 = no device
    # buffers cached) — see device/residency.py
    hbm_bytes: int = 0
    # cumulative host->device upload bytes on this worker (hbm_h2d_bytes):
    # flat across a repeat query = its planes were served from residency
    hbm_h2d_bytes: int = 0
    # entries in the worker's residency digest (the stable-slot-key list the
    # scheduler intersects with sub-plan fingerprints); the digest itself
    # stays out of the event record — it is scheduler input, not telemetry
    hbm_digest_entries: int = 0
    # coordinator time.time() when the beat arrived (0 until the coordinator stamps
    # it). ts is the WORKER's clock at send; recv_ts - ts, minimized over a
    # query's beats, estimates the worker->coordinator clock offset (one-way
    # Cristian bound) used to align worker span timestamps in the Chrome
    # trace export (QueryTrace.clock_offsets)
    recv_ts: float = 0.0
    # synthetic FINAL beat emitted by the pool's liveness monitor when it
    # declares this worker dead (heartbeat timeout / connection EOF / process
    # exit) — the dashboard marks dead workers instead of silently letting
    # their last real beat go stale; death_reason carries the classification
    dead: bool = False
    death_reason: str = ""


@dataclass(frozen=True)
class FlightAnomaly:
    """One flight-recorder anomaly trigger (observability/flight.py): the
    recorder noticed a slow query (wall clock > k x its plan-fingerprint
    EMA), a query error, a host-ledger pressure crossing, a DeviceFallback,
    or a worker death, and (cooldown permitting) snapshotted its ring to
    `dump_path`. `tenant` is set for serving-tier anomalies; dumps for a
    tenant-tagged anomaly carry only that tenant's ring events plus
    engine-global ones (no cross-tenant bleed)."""

    kind: str                  # slow_query | query_error | ledger_pressure |
                               # device_fallback | worker_death
    detail: str = ""
    query_id: str = ""
    tenant: str = ""
    dump_path: str = ""        # empty when suppressed by cooldown or failed
    ts: float = 0.0


@dataclass(frozen=True)
class QueryEnd:
    query_id: str
    rows: int
    seconds: float
    error: Optional[str] = None
    operator_stats: List[OperatorStats] = field(default_factory=list)
    # per-query metrics-registry counter deltas (device batches, shuffle
    # bytes, rejections dropped, ...) — see observability/metrics.py
    metrics: Dict[str, float] = field(default_factory=dict)
    # per-query placement-decision records (observability/placement.py
    # PlacementRecord.to_dict(): site, chosen tier, cached/forced flags, both
    # sides' cost-term breakdowns, margin, observed device seconds +
    # error_ratio for dispatched stages) — empty when the query made no
    # device placement decision
    placements: List[dict] = field(default_factory=list)


@dataclass(frozen=True)
class ServeQueryRecord:
    """One query served through a ServingSession (the reference's serving tier): the
    per-tenant accounting the dashboard's hit-rate table and the /metrics
    tenant-labeled latency histogram are built from. Emitted IN ADDITION to
    the regular lifecycle events — serving executes the prepared physical
    plan directly, so QueryStart/QueryEnd do not fire for the in-process
    fast path and this record is the authoritative serving telemetry."""

    query_id: str
    tenant: str
    seconds: float             # submit -> result (includes queue + admission)
    exec_seconds: float        # execution only (post-admission)
    rows: int
    prepared_hit: bool         # planning skipped via the prepared-query cache
    admission_wait_s: float    # time queued at the HBM admission controller
    est_pin_bytes: int         # declared pin-scope budget estimate
    error: Optional[str] = None
    # True only when the admission controller actually made this query WAIT
    # (the authoritative flag — admission_wait_s is nonzero even on an
    # immediate admit, it includes the lock acquisition)
    admission_waited: bool = False
    # True for the session's in-process fast path (no QueryStart/QueryEnd
    # fired); False when a runner executed it (QueryEnd fired too — consumers
    # aggregating both event kinds must not double-count such queries)
    in_process: bool = True


@dataclass(frozen=True)
class GatewayQueryRecord:
    """One query answered over the gateway wire protocol (the reference's gateway).

    Emitted when the fetch stream completes (or fails) — it records the
    NETWORK view of the query: where the bytes came from (``source``) and how
    many hit the wire. Queries that actually executed ALSO emit a
    ServeQueryRecord from the underlying ServingSession; result-cache and
    checkpoint-restored answers never reach the session, so this record is
    the only telemetry they produce."""

    query_id: str
    tenant: str
    seconds: float             # execute accepted -> fetch stream finished
    rows: int
    # executed | result_cache | checkpoint — which tier answered
    source: str
    bytes_streamed: int        # compressed Arrow IPC payload bytes sent
    prepared_handle: str = ""  # non-empty when executed via a prepared handle
    error: Optional[str] = None
