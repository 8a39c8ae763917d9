"""Device-execution counters (counterpart of daft_tpu/ops/counters.py).

Bumped where device work actually happens, so tests and chip_smoke.py can
show which path a query took:

- ``device_grouped_batches``: batches fed through a device grouped stage
  (a star-join run's batches included);
- ``device_stage_batches``: batches fed through a device ungrouped
  (filter + aggregate) stage;
- ``device_join_batches``: fact batches fed through a device star-join run;
- ``device_stage_runs``: device stage runs finalized;
- ``device_topn_runs``: star-join TopN runs finalized on the device (only
  the K winners' rows copied back);
- ``device_region_dispatches`` / ``device_region_ops_fused``: the device
  dispatches of finished fused-region runs of at least 2 operators (a
  Filter/Project chain fused into its aggregate, a join run), and those
  dispatches times the run's operator count (ops/region.py);
- ``device_fallbacks``: device runs that raised DeviceFallback and reran on
  the host;
- ``coalesce_morsels_in`` / ``dispatch_coalesced``: morsels handed to a
  dispatch coalescer (ops/stage.py ``DispatchCoalescer``) and the batches it
  fed on (their ratio is the amortization factor);
- ``bucket_fill_rows`` / ``bucket_capacity_rows``: the rows of those batches
  and the power-of-two buckets they pad to (their ratio is the fill);
- ``mesh_fused_permute_dispatches`` / ``mesh_alltoall_dispatches``: mesh
  repartition exchanges run by the kernel tier (one K6 launch) / by the
  all_to_all tier (kernel_mode="off");
- ``mesh_alltoall_rows``: rows sent through a mesh exchange;
- ``mesh_exchange_bytes``: bytes the exchanges moved (the packed word
  buffer, or the bins and counts of the all_to_all tier; the reference's
  ``mesh_alltoall_ici_bytes``);
- ``scan_tasks``: scan tasks a streaming scan ran (after the split and the
  merge); ``scan_tasks_split`` / ``scan_tasks_merged``: tasks made by
  splitting a file at row groups, and small tasks absorbed by merging;
  ``scan_batches`` / ``scan_rows``: morsels and rows the scans yielded;
  ``scan_row_groups`` / ``scan_row_groups_pruned`` / ``scan_files_pruned``:
  Parquet row groups read, and row groups and whole files that zone maps
  excluded (io/parquet.py); ``scan_decode_ms``: host
  milliseconds spent reading and decoding Parquet column chunks, and
  ``scan_filter_ms`` those spent applying a pushed predicate on the host,
  in a reader or after the scan (floats); ``scan_window_tasks``: tasks
  read through the IO-parallel window (executor.py ``_streaming_scan``),
  and ``scan_window_peak``: the most of them a scan had reading at once
  (the largest over the scans since the reset, not a sum);
- ``morsel_resize``: morsel-size changes of the adaptive batching
  strategies (execution/batching.py);
- ``hbm_cache_hits`` / ``hbm_cache_misses``: residency lookups that found
  their slot (a rebind included) / built it (device/residency.py);
  ``hbm_stable_rehits``: hits through a content key, the slot rebound to a
  new Series of equal content; ``fingerprint_ms``: host milliseconds spent
  computing content fingerprints (``Series.content_fingerprint``, a float);
- ``device_udf_dispatches`` / ``device_udf_rows``: device-UDF calls (one
  per chunk of at most ``Func.batch_size`` rows) and their real rows;
  ``device_udf_runs``: device-UDF runs finalized (one copy back each);
  ``device_udf_weight_h2d_bytes``:
  weight bytes put on a stage's device (made into tensors on a CPU device;
  ops/udf_stage.py); ``device_udf_fallbacks``: device-UDF stages that
  ``device_mode="auto"`` ran on the host path;
- the host memory budget's (memory/, under ``memory_limit_bytes`` > 0
  only; the reference's names): ``spill_batches``, ``spill_bytes`` (their
  ``size_bytes``), ``spill_wire_bytes`` (the bytes the files hold, after the
  codec), ``spill_files``, ``spill_runs`` (the external sort's sorted
  runs), ``spill_merge_passes`` (its intermediate merges), ``spill_merge_sort_rows``
  (rows through the k-way merge's interleave sort), ``spill_dirs_gced``
  (stale spill artifacts of dead processes removed); the spill IO pool's
  ``spill_write_seconds`` / ``spill_read_seconds`` (off the caller's
  thread) beside ``spill_write_wall_seconds`` / ``spill_read_wall_seconds``
  (what the caller waited), whose differences make
  ``spill_io_overlap_seconds`` (``spill_overlap_seconds``), and
  ``spill_prefetch_inflight`` (the deepest read-ahead queue, a peak);
  ``scan_bytes`` (``size_bytes`` of what budgeted scans yielded),
  ``scan_backpressure_stalls`` / ``scan_stall_ms`` (a scan's bounded waits
  for headroom), ``host_over_budget_events`` (operators that crossed the
  budget and spilled), and the ledger's gauges ``host_bytes_tracked`` and
  ``host_bytes_high_water``;
- ``launches_<kernel>``: one per launch of a hand-written kernel, bumped by
  its wrapper (ops/segment_kernels.py, ops/probe_kernels.py,
  ops/permute_kernels.py) where it launches and nowhere else;
- ``plain_<kernel>``: one per wrapper call routed to the plain PyTorch
  version (a CPU tensor), so a CPU run can show the path went through the
  wrapper without counting a launch.

``rejections`` records why a stage stayed on the host: {reason: count}.
The counters live in the process-wide metrics registry
(observability/metrics.py), so the same numbers reach EXPLAIN ANALYZE, the
query events (``QueryEnd.metrics``), the flight recorder and the dashboard.
``bump``, ``snapshot`` and ``reset`` keep their signatures, scoped to
``COUNTER_NAMES``; module attribute reads (``counters.device_grouped_batches``)
read the registry. ``scan_window_peak``, ``spill_prefetch_inflight`` and the
ledger's two are registry gauges (``set_gauge_max`` / ``set_gauge``), as the
residency manager's ``hbm_bytes_resident`` / ``hbm_bytes_high_water`` and the
coalescer's ``bucket_fill_ratio`` are.
"""

from __future__ import annotations

import threading
from typing import Dict

from ..observability.metrics import FLOAT_COUNTER_NAMES, KERNEL_NAMES, registry

SEGMENT_KERNELS = KERNEL_NAMES[:3]
# K4 has two entry points: the table build and the probe; K1a and K5 have no
# engine caller (nor in the reference), K6 runs the mesh repartition, K7 the
# grouped stages' float and bool sums
SPILL_COUNTER_NAMES = ("spill_batches", "spill_bytes", "spill_wire_bytes", "spill_files",
                       "spill_runs", "spill_merge_passes", "spill_dirs_gced",
                       "spill_write_seconds", "spill_write_wall_seconds",
                       "spill_read_seconds", "spill_read_wall_seconds",
                       "spill_merge_sort_rows", "spill_prefetch_inflight")
MEMORY_COUNTER_NAMES = ("scan_bytes", "scan_backpressure_stalls", "scan_stall_ms",
                        "host_over_budget_events", "host_bytes_tracked",
                        "host_bytes_high_water")
COUNTER_NAMES = ("device_grouped_batches", "device_stage_batches", "device_join_batches",
                 "device_stage_runs", "device_topn_runs",
                 "device_region_dispatches", "device_region_ops_fused",
                 "device_fallbacks", "coalesce_morsels_in", "dispatch_coalesced",
                 "bucket_fill_rows", "bucket_capacity_rows", "mesh_alltoall_dispatches",
                 "mesh_fused_permute_dispatches", "mesh_alltoall_rows",
                 "mesh_exchange_bytes", "scan_tasks", "scan_tasks_split",
                 "scan_tasks_merged", "scan_batches", "scan_rows", "scan_row_groups",
                 "scan_row_groups_pruned",
                 "scan_files_pruned", "scan_decode_ms", "scan_filter_ms",
                 "scan_window_tasks", "scan_window_peak", "morsel_resize", "hbm_cache_hits",
                 "hbm_cache_misses", "hbm_stable_rehits", "fingerprint_ms",
                 "device_udf_dispatches", "device_udf_rows", "device_udf_runs",
                 "device_udf_weight_h2d_bytes", "device_udf_fallbacks") + \
    SPILL_COUNTER_NAMES + \
    MEMORY_COUNTER_NAMES + tuple(
    f"{kind}_{k}" for kind in ("launches", "plain") for k in KERNEL_NAMES)
# the counters that add host milliseconds or seconds; every other counts events
FLOAT_COUNTERS = FLOAT_COUNTER_NAMES
# reset with the counters (the reference's reset drops the fill-ratio gauge
# with the coalescing counters it is derived from)
_RESET_ALSO = ("hbm_evictions", "hbm_eviction_bytes", "hbm_pins", "hbm_h2d_bytes",
               "bucket_fill_ratio")

_LOCK = threading.Lock()
rejections: Dict[str, int] = {}


def __getattr__(name: str) -> float:
    if name in COUNTER_NAMES:
        return registry().value(name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def bump(name: str, n: float = 1) -> None:
    registry().inc(name, n)


def spill_overlap_seconds(snap: Dict[str, float]) -> float:
    """``spill_io_overlap_seconds`` of a snapshot: the spill IO pool's
    seconds the caller did not wait for, writes and reads."""
    return max(snap["spill_write_seconds"] - snap["spill_write_wall_seconds"], 0.0) + \
        max(snap["spill_read_seconds"] - snap["spill_read_wall_seconds"], 0.0)


def reject(site: str, reason: str) -> None:
    """Record one host-placement decision (`reason` is a static template)."""
    key = f"{site}: {reason}"
    with _LOCK:
        rejections[key] = rejections.get(key, 0) + 1


def snapshot() -> Dict[str, float]:
    """The counters (``COUNTER_NAMES``) as the registry holds them now."""
    snap = registry().snapshot()
    return {name: snap.get(name, 0.0 if name in FLOAT_COUNTERS else 0)
            for name in COUNTER_NAMES}


def reset(names=None) -> None:
    """Zero every counter and the rejection record, or only ``names``.
    Scoped to this module's names: the registry's other counters (the flight
    recorder's, subscriber errors) are not this module's to wipe; per-query
    attribution uses the registry's snapshot / diff instead."""
    registry().reset(COUNTER_NAMES + _RESET_ALSO if names is None else tuple(names))
    if names is None:
        with _LOCK:
            rejections.clear()
