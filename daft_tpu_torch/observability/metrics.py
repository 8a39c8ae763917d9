"""Thread-safe metrics registry: named counters and gauges with snapshot/diff
(counterpart of daft_tpu/observability/metrics.py).

The registry is the one home of the engine's path-attribution counters:
``ops/counters.py`` keeps its ``bump`` / ``snapshot`` / ``reset`` surface and
module attributes over it, and the runner records a per-query ``diff()``
into ``QueryEnd.metrics`` and the flight recorder's ring, so device batches,
kernel launches and spill bytes land in EXPLAIN ANALYZE and the event log.

Zero-overhead contract: nothing on the engine's hot path reads the
registry; writes happen on coarse events only (a device dispatch, a morsel,
a scan task, a spill file), never per row.

The vocabulary is the reference's for the subsystems the port has (device,
spill, memory, observability, flight, placement), plus the names only the port writes
(``PORT_COUNTER_NAMES``: the kernels' ``launches_*`` / ``plain_*``, the scan
reader's counters, ``fingerprint_ms``, ``mesh_exchange_bytes``,
``device_fallbacks``). Counters that add host milliseconds or seconds are
floats (``FLOAT_COUNTER_NAMES``): they stay floats through ``reset``.
"""

from __future__ import annotations

import threading
from typing import Dict, Iterable, Optional


class MetricsRegistry:
    """Named monotonically-increasing counters + last-value gauges.

    All methods are safe to call from any thread (stage threads, compute
    pool threads, the spill IO pool).
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}
        self._gauges: Dict[str, float] = {}
        # counters that reset to 0.0, not 0 (host milliseconds, seconds)
        self._floats: set = set()

    # ---- writes ------------------------------------------------------------------
    def declare(self, *names: str) -> None:
        """Pre-register counters at 0 so they always appear in snapshots."""
        with self._lock:
            for n in names:
                self._counters.setdefault(n, 0)

    def declare_float(self, *names: str) -> None:
        """Pre-register float counters at 0.0; a reset keeps them floats."""
        with self._lock:
            for n in names:
                self._floats.add(n)
                self._counters.setdefault(n, 0.0)

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = value

    def set_gauge_max(self, name: str, value: float) -> None:
        """High-water gauge: keep the largest value ever reported (e.g.
        scan_window_peak, the most scan tasks reading at once)."""
        with self._lock:
            if value > self._gauges.get(name, float("-inf")):
                self._gauges[name] = value

    # ---- reads -------------------------------------------------------------------
    def get(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0)

    def value(self, name: str) -> float:
        """A counter's or a gauge's current value (0 when unset)."""
        with self._lock:
            if name in self._gauges:
                return self._gauges[name]
            return self._counters.get(name, 0)

    def snapshot(self) -> Dict[str, float]:
        """Point-in-time copy of every counter and gauge."""
        with self._lock:
            out: Dict[str, float] = dict(self._counters)
            out.update(self._gauges)
            return out

    def export(self) -> "tuple[Dict[str, float], Dict[str, float]]":
        """(counters, gauges) as separate copies — the Prometheus exposition
        needs the TYPE distinction that snapshot() flattens away."""
        with self._lock:
            return dict(self._counters), dict(self._gauges)

    def diff(self, before: Dict[str, float]) -> Dict[str, float]:
        """Counter deltas since `before` (a prior snapshot); gauges report
        their current value, but only when it CHANGED since `before` — a
        standing gauge (e.g. hbm_bytes_resident left by an earlier query)
        must not show up in the per-query record of a query that never
        touched it (the zero-overhead guard depends on this). Zero counter
        deltas are dropped so per-query records stay small; negative deltas
        (a reset() between the snapshots) clamp to zero and drop rather than
        reporting nonsense."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
        out: Dict[str, float] = {}
        for k, v in gauges.items():
            if v != before.get(k, 0):
                out[k] = v
        for k, v in counters.items():
            d = v - before.get(k, 0)
            if d > 0:
                out[k] = d
        return out

    def reset(self, names: Optional[Iterable[str]] = None) -> None:
        """Zero counters (all, or just `names`) and drop gauges."""
        with self._lock:
            if names is None:
                for k in self._counters:
                    self._counters[k] = 0.0 if k in self._floats else 0
                self._gauges.clear()
            else:
                for k in names:
                    if k in self._counters:
                        self._counters[k] = 0.0 if k in self._floats else 0
                    self._gauges.pop(k, None)


_REGISTRY = MetricsRegistry()

# ---- the metric-name vocabulary -----------------------------------------------------
# Every name the port writes, pre-declared at import so a scrape of a fresh
# process sees every series at 0.

# The reference's device/mesh/UDF names that the port writes (the rest of
# the reference's group belongs to tiers not ported: the mesh stages,
# serving, the distributed scheduler, the Pallas tier's counters).
DEVICE_COUNTER_NAMES = (
    "device_stage_batches",    # batches through the ungrouped stage
    "device_grouped_batches",  # batches through the grouped stage
    "device_stage_runs",       # device stage runs finalized
    "device_join_batches",     # fact batches through the star-join stages
    "device_topn_runs",        # join + agg + TopN device runs finalized
    # the mesh repartition's exchanges (parallel/distributed.py)
    "mesh_alltoall_dispatches",    # all_to_all exchanges (kernel_mode="off")
    "mesh_alltoall_rows",          # rows sent through a mesh exchange
    # device-UDF tier (ops/udf_stage.py)
    "device_udf_dispatches",   # device-UDF calls (chunks of batch_size rows)
    "device_udf_rows",         # real rows through those calls
    "device_udf_runs",         # device-UDF runs finalized (one copy back each)
    "device_udf_weight_h2d_bytes",  # weight bytes uploaded (0 on a repeat)
    "device_udf_fallbacks",    # device-UDF stages "auto" kept on the host path
    # the dispatch coalescer (ops/stage.py DispatchCoalescer) and adaptive
    # batching (execution/batching.py)
    "dispatch_coalesced",      # batches the coalescer fed on
    "coalesce_morsels_in",     # morsels it took (÷ dispatch_coalesced)
    "bucket_fill_rows",        # real rows of those batches
    "bucket_capacity_rows",    # their power-of-two buckets (fill denominator)
    "morsel_resize",           # adaptive batching morsel-size changes
    # residency (device/residency.py)
    "hbm_cache_hits",          # lookups that found their slot (rebinds too)
    "hbm_cache_misses",        # lookups that built their slot
    "hbm_evictions",           # entries evicted under the budget
    "hbm_eviction_bytes",      # device bytes those evictions released
    "hbm_pins",                # entries pinned by a running query
    "hbm_h2d_bytes",           # host->device upload bytes (columns, UDF inputs
                               # and weights; flat on a warm run)
    "hbm_stable_rehits",       # slots rebound by content identity
    "hbm_evict_cost_saved",    # µs of rebuild cost avoided vs pure-LRU eviction
    # fused regions (ops/region.py): ops_fused / dispatches = operators
    # amortized per dispatch
    "device_region_dispatches",
    "device_region_ops_fused",
    # the K6 tier of the mesh repartition (one launch an exchange)
    "mesh_fused_permute_dispatches",
)

# Host memory manager spill (memory/spill.py), the reference's names.
SPILL_COUNTER_NAMES = (
    "spill_batches",        # batches written to spill files
    "spill_bytes",          # their size_bytes
    "spill_wire_bytes",     # bytes the files hold (after the codec)
    "spill_files",          # spill files opened (runs + Grace partitions)
    "spill_runs",           # sorted runs made by the external sort
    "spill_merge_passes",   # its intermediate k-way merges
    "spill_dirs_gced",      # stale spill artifacts of dead processes removed
    "spill_write_seconds",       # the IO pool's compress + write seconds
    "spill_write_wall_seconds",  # the seconds the writers waited for it
    "spill_read_seconds",        # the IO pool's decode seconds (prefetch)
    "spill_read_wall_seconds",   # the seconds the readers waited for it
    "spill_merge_sort_rows",     # rows through the k-way merge's sort
)

# Streaming scans under a budget and the host memory ledger (memory/).
MEMORY_COUNTER_NAMES = (
    "scan_batches",             # morsels yielded by streaming scans
    "scan_rows",                # rows through streaming scans
    "scan_bytes",               # size_bytes through budgeted streaming scans
    "scan_tasks_split",         # scan tasks made by row-group splitting
    "scan_tasks_merged",        # small scan tasks absorbed by merging
    "scan_backpressure_stalls", # a scan's bounded waits for headroom
    "scan_stall_ms",            # their milliseconds
    "host_over_budget_events",  # operators that crossed the budget -> spill
)

# The serving tier (serving/): the HBM admission controller and the
# prepared-query cache. Outside ops/counters.py's reset scope, as in the
# reference: a counter reset mid-session must not wipe them.
SERVING_COUNTER_NAMES = (
    "admission_waits_total",   # queries queued at the HBM admission controller
    "serve_queries_total",     # queries executed through a ServingSession
    "serve_prepared_hits",     # prepared-query cache hits (planning skipped)
    "serve_prepared_misses",   # prepared-query cache misses (planned + cached)
    "serve_pin_calibrations",  # reservations shrunk toward observed pin high-water
    "serve_cancelled_total",   # queries cancelled (queued or running)
    "serve_over_cap_rejections",  # submits refused at a tenant queue-depth cap
)

# The gateway (gateway/): the wire front door and its cross-tenant result
# cache. Connection, auth and protocol failures count here (they never reach
# a ServeQueryRecord).
GATEWAY_COUNTER_NAMES = (
    "gateway_connections_total",   # TCP connections accepted
    "gateway_disconnects_total",   # connections closed (any reason)
    "gateway_requests_total",      # wire requests served (all verbs)
    "gateway_queries_total",       # execute verbs answered (any source)
    "gateway_auth_failures",       # hello rejected (bad token / unknown tenant)
    "gateway_errors_total",        # protocol/IO errors answered or logged
    "gateway_bytes_streamed",      # Arrow IPC payload bytes sent to clients
    "result_cache_hits",           # queries served from the result cache
    "result_cache_misses",         # result-cache lookups that executed
    "result_cache_evictions",      # entries evicted under the byte budget
)

# Stage checkpoints (checkpoint/stages.py).
CHECKPOINT_COUNTER_NAMES = (
    "checkpoint_stages_committed",
    "checkpoint_stages_skipped",     # committed stages restored instead of run
    "checkpoint_commit_failures",
    "checkpoint_restore_failures",   # committed stage unreadable -> stage re-run
    "checkpoint_stages_gced",        # committed stages removed by the TTL sweep
)

# Subscriber callbacks that raised (swallowed so a broken subscriber never
# fails a query; counted so it is not invisible).
OBS_COUNTER_NAMES = ("subscriber_errors",)

# Flight recorder (observability/flight.py): only anomalies touch the
# registry, so the always-on recorder keeps the per-query empty diff.
FLIGHT_COUNTER_NAMES = (
    "flight_anomalies_total",  # anomaly triggers fired (cooldown-suppressed too)
    "flight_dumps_total",      # ring snapshots written to the dump dir
    "flight_dump_failures",    # dump writes that failed (unwritable dir)
)

# Placement observability (observability/placement.py): the cost-model
# decision ledger. Counters move ONLY on costed/forced placement decisions —
# pre-cost gate rejections (a CPU device, below device_min_rows) are ledger
# records without registry writes, preserving the unobserved-path
# empty-registry-diff guarantee.
PLACEMENT_COUNTER_NAMES = (
    "placement_decisions_total",   # costed auto-tier placement decisions
    "placement_device_wins",       # decisions that chose the device
    "placement_host_wins",         # decisions that kept the stage on host
    "placement_cached_verdicts",   # verdicts served from the bounded cache
    "placement_forced_runs",       # device_mode=on runs recorded uncosted
    "placement_feedback_total",    # dispatched stages reporting actual seconds
    "placement_records_dropped",   # ledger appends evicted at the bounded cap
)

# The port's kernels: one launches_<kernel> per launch on the card, one
# plain_<kernel> per wrapper call routed to the plain PyTorch version.
KERNEL_NAMES = ("segment_sum_planes", "segment_extreme_planes", "segment_extreme_int64",
                "hash_probe_build", "hash_probe_index", "segment_sum_planes_f32",
                "hash_probe_segment_sum", "ring_permute_words",
                "segment_sum_float_planes")

# Names only the port writes (deliberate differences from the reference's
# vocabulary, ROADMAP Queue 3).
PORT_COUNTER_NAMES = (
    "device_fallbacks",        # device runs that raised DeviceFallback
    "mesh_exchange_bytes",     # bytes a mesh exchange moved (the reference's
                               # mesh_alltoall_ici_bytes)
    "scan_tasks",              # scan tasks a streaming scan ran
    "scan_row_groups",         # Parquet row groups read
    "scan_row_groups_pruned",  # row groups zone maps excluded
    "scan_files_pruned",       # whole files zone maps excluded
    "scan_decode_ms",          # host ms reading and decoding column chunks
    "scan_filter_ms",          # host ms applying a pushed predicate
    "scan_window_tasks",       # tasks read through the IO-parallel window
    "fingerprint_ms",          # host ms computing content fingerprints
) + tuple(f"{kind}_{k}" for kind in ("launches", "plain") for k in KERNEL_NAMES)

FLOAT_COUNTER_NAMES = ("scan_decode_ms", "scan_filter_ms", "fingerprint_ms",
                       "spill_write_seconds", "spill_write_wall_seconds",
                       "spill_read_seconds", "spill_read_wall_seconds")

DECLARED_COUNTERS = (DEVICE_COUNTER_NAMES + SPILL_COUNTER_NAMES + MEMORY_COUNTER_NAMES +
                     SERVING_COUNTER_NAMES + GATEWAY_COUNTER_NAMES +
                     CHECKPOINT_COUNTER_NAMES +
                     OBS_COUNTER_NAMES + FLIGHT_COUNTER_NAMES + PLACEMENT_COUNTER_NAMES +
                     PORT_COUNTER_NAMES)

DECLARED_GAUGES = (
    "serve_queue_depth",       # admission queue depth (serving/session.py)
    "result_cache_bytes",      # gateway result-cache resident payload bytes
    "gateway_active_connections",  # live gateway client connections
    "hbm_reserved_bytes",      # admission-controller reservations outstanding
    "hbm_bytes_resident",      # device bytes the residency manager holds
    "hbm_bytes_high_water",
    "host_bytes_tracked",      # host bytes admitted against the memory ledger
    "host_bytes_high_water",   # ledger high-water since process start / clear()
    "spill_prefetch_inflight",  # high-water decoded batches queued per reader
    "bucket_fill_ratio",       # coalescer padding efficiency (per run)
    "scan_window_peak",        # the most scan tasks reading at once (port only)
    # cost-model observability (ops/costmodel.py + observability/placement.py)
    "cost_model_error_ratio",  # last dispatched stage: observed/predicted s/row
    # the effective Calibration terms, exported at calibrate() so every
    # scrape states the calibration the process ran under
    "cost_rtt_s",
    "cost_h2d_bytes_per_s",
    "cost_d2h_bytes_per_s",
    "cost_udf_flops_per_s",
)


def declare_vocabulary(reg: "MetricsRegistry") -> None:
    """Pre-register the full vocabulary (counters at 0, gauges seeded 0.0) —
    called on the process registry at import; tests call it on fresh
    registries to assert first-scrape visibility."""
    reg.declare(*(n for n in DECLARED_COUNTERS if n not in FLOAT_COUNTER_NAMES))
    reg.declare_float(*FLOAT_COUNTER_NAMES)
    for g in DECLARED_GAUGES:
        reg.set_gauge(g, 0.0)


declare_vocabulary(_REGISTRY)


def registry() -> MetricsRegistry:
    """The process-wide registry."""
    return _REGISTRY


# ---- Prometheus text exposition ------------------------------------------------------

_NAME_SANITIZE = None  # compiled lazily; /metrics is a cold path


def _prom_name(name: str) -> str:
    global _NAME_SANITIZE
    if _NAME_SANITIZE is None:
        import re

        _NAME_SANITIZE = re.compile(r"[^a-zA-Z0-9_:]")
    return _NAME_SANITIZE.sub("_", name)


def prometheus_text(prefix: str = "daft_tpu_",
                    extra_gauges: Optional[Dict[str, float]] = None,
                    histograms: Optional[Dict[str, "Histogram"]] = None,
                    labeled_histograms: Optional[
                        "Dict[str, Dict[str, Histogram]]"] = None) -> str:
    """The whole registry in Prometheus text exposition format (version
    0.0.4): every counter as `<prefix><name>` TYPE counter, every gauge TYPE
    gauge, plus caller-supplied live gauges (e.g. hbm_bytes_resident read
    straight off the residency manager) and fixed-bucket histograms. Served
    by the dashboard's /metrics endpoint. The prefix is the reference's, so
    one scrape config reads either package.

    `labeled_histograms` maps a metric name to {label_string: Histogram}
    (label_string like 'tenant="acme"'): every labeled series shares one
    metric family — one TYPE line, the label riding each sample. A name
    present in BOTH dicts emits the unlabeled aggregate and the labeled
    series under a single TYPE line."""
    counters, gauges = _REGISTRY.export()
    if extra_gauges:
        for k, v in extra_gauges.items():
            counters.pop(k, None)
            gauges[k] = v
    lines = []
    for name in sorted(counters):
        m = prefix + _prom_name(name)
        lines.append(f"# TYPE {m} counter")
        lines.append(f"{m} {counters[name]}")
    for name in sorted(gauges):
        m = prefix + _prom_name(name)
        lines.append(f"# TYPE {m} gauge")
        lines.append(f"{m} {gauges[name]}")
    labeled = labeled_histograms or {}
    for name in sorted(set(histograms or ()) | set(labeled)):
        m = prefix + _prom_name(name)
        lines.append(f"# TYPE {m} histogram")
        if histograms and name in histograms:
            lines.extend(histograms[name].prometheus_lines(m, include_type=False))
        for label in sorted(labeled.get(name, ())):
            lines.extend(labeled[name][label].prometheus_lines(
                m, labels=label, include_type=False))
    return "\n".join(lines) + "\n"


class Histogram:
    """Fixed-bucket cumulative histogram (Prometheus semantics: bucket counts
    are cumulative, le labels are upper bounds). Fixed buckets make p50/p99
    derivable by any scraper via histogram_quantile; the default bucket set
    spans interactive sub-second queries through multi-minute batch scans."""

    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
                       1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0)

    def __init__(self, buckets: Optional[Iterable[float]] = None):
        self.buckets = tuple(sorted(buckets)) if buckets else self.DEFAULT_BUCKETS
        self._lock = threading.Lock()
        self._counts = [0] * (len(self.buckets) + 1)  # +1 for +Inf
        self._sum = 0.0
        self._count = 0

    def observe(self, value: float) -> None:
        with self._lock:
            self._sum += value
            self._count += 1
            for i, b in enumerate(self.buckets):
                if value <= b:
                    self._counts[i] += 1
                    return
            self._counts[-1] += 1

    def quantile(self, q: float) -> float:
        """Bucket-resolution quantile estimate (the upper bound of the bucket
        the q-th observation falls in) — what a scraper's
        histogram_quantile() would report, computable locally."""
        with self._lock:
            total = self._count
            if total == 0:
                return 0.0
            rank = q * total
            cum = 0
            for i, b in enumerate(self.buckets):
                cum += self._counts[i]
                if cum >= rank:
                    return b
            return float("inf")

    def prometheus_lines(self, metric: str, labels: str = "",
                         include_type: bool = True) -> list:
        """Text-exposition sample lines. `labels` is an optional pre-rendered
        label string ('tenant="acme"') merged with the le bucket label."""
        with self._lock:
            counts = list(self._counts)
            total_sum, total_count = self._sum, self._count
        lines = [f"# TYPE {metric} histogram"] if include_type else []
        sep = f"{labels}," if labels else ""
        suffix = f"{{{labels}}}" if labels else ""
        cum = 0
        for b, c in zip(self.buckets, counts[:-1]):
            cum += c
            lines.append(f'{metric}_bucket{{{sep}le="{b}"}} {cum}')
        cum += counts[-1]
        lines.append(f'{metric}_bucket{{{sep}le="+Inf"}} {cum}')
        lines.append(f"{metric}_sum{suffix} {total_sum}")
        lines.append(f"{metric}_count{suffix} {total_count}")
        return lines
