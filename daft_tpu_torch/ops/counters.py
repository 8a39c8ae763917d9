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
- ``launches_<kernel>``: one per launch of a hand-written kernel, bumped by
  its wrapper (ops/segment_kernels.py, ops/probe_kernels.py,
  ops/permute_kernels.py) where it launches and nowhere else;
- ``plain_<kernel>``: one per wrapper call routed to the plain PyTorch
  version (a CPU tensor), so a CPU run can show the path went through the
  wrapper without counting a launch.

``rejections`` records why a stage stayed on the host: {reason: count}.
Module attribute reads (``counters.device_grouped_batches``) read the table.
"""

from __future__ import annotations

import threading
from typing import Dict

SEGMENT_KERNELS = ("segment_sum_planes", "segment_extreme_planes",
                   "segment_extreme_int64")
# K4 has two entry points: the table build and the probe; K1a and K5 have no
# engine caller (nor in the reference), K6 runs the mesh repartition, K7 the
# grouped stages' float and bool sums
KERNEL_NAMES = SEGMENT_KERNELS + ("hash_probe_build", "hash_probe_index",
                                  "segment_sum_planes_f32", "hash_probe_segment_sum",
                                  "ring_permute_words", "segment_sum_float_planes")
COUNTER_NAMES = ("device_grouped_batches", "device_stage_batches", "device_join_batches",
                 "device_stage_runs", "device_topn_runs",
                 "device_region_dispatches", "device_region_ops_fused",
                 "device_fallbacks", "coalesce_morsels_in", "dispatch_coalesced",
                 "bucket_fill_rows", "bucket_capacity_rows", "mesh_alltoall_dispatches",
                 "mesh_fused_permute_dispatches", "mesh_alltoall_rows",
                 "mesh_exchange_bytes") + tuple(
    f"{kind}_{k}" for kind in ("launches", "plain") for k in KERNEL_NAMES)

_LOCK = threading.Lock()
_COUNTS: Dict[str, int] = {name: 0 for name in COUNTER_NAMES}
rejections: Dict[str, int] = {}


def __getattr__(name: str) -> int:
    if name in _COUNTS:
        return _COUNTS[name]
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def bump(name: str, n: int = 1) -> None:
    with _LOCK:
        _COUNTS[name] += n


def reject(site: str, reason: str) -> None:
    """Record one host-placement decision (`reason` is a static template)."""
    key = f"{site}: {reason}"
    with _LOCK:
        rejections[key] = rejections.get(key, 0) + 1


def snapshot() -> Dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def reset() -> None:
    """Zero every counter and the rejection record."""
    with _LOCK:
        for name in _COUNTS:
            _COUNTS[name] = 0
        rejections.clear()
