"""Execution configuration (counterpart of daft_tpu/config.py, the subset the
port's slices read).

Frozen dataclass snapshot; ``set_execution_config`` replaces the process
default and ``execution_config_ctx`` scopes an override.

- ``device``: where device stages run, "cuda" (default) or "cpu". A query
  with ``device_mode="on"`` resolves it first and raises when the card is
  missing (utils/torch_setup.py).
- ``device_mode``: "on" (default) runs qualifying stages as device stages,
  "off" runs everything on the host. The reference's cost-model "auto" is
  not ported yet.
- ``region_mode``: "on" (default) lets the planner fuse the chain of
  Filters and Projects under an aggregate into the aggregate's device stage
  (ops/region.py); "off" peels at most the one Filter directly under it.
- ``kernel_mode``: "on" (default) lets device stages run their
  hand-written kernel tier (the reference's ``pallas_mode``). "off" plans
  every grouped aggregation to the host, since the port has no other grouped
  device tier yet, and makes the mesh repartition's exchange take its
  all_to_all tier (one block copy per source and destination) instead of
  the ring-permute kernel K6.
- ``morsel_size_rows``: morsel size of the host aggregation, and the size
  the dispatch coalescer's bucket is taken at.
- ``batch_fill_target``: the device dispatch coalescer (ops/stage.py
  ``DispatchCoalescer``) feeds its stage once the pending morsels' rows
  reach this share of the power-of-two bucket at ``morsel_size_rows``
  (execution/batching.py ``coalesce_target_rows``); in [0, 1], 0 turns
  coalescing off (every morsel is fed alone).
- ``batch_latency_ms``: a morsel arriving after the oldest pending one has
  waited this long flushes the pending ones (checked at each arrival, no
  timer thread); must be > 0.
- ``mesh_devices``: 0 or 1 = no mesh; N >= 2 = a forced mesh of N shard
  slots on ``device`` for qualifying stages (today the hash repartition into
  N partitions). The port has no cost model, so no "auto" width.
- ``device_min_rows``: inputs under this many rows stay on the host (the
  mesh repartition's gate reads it).
- ``hbm_budget_bytes``: device residency budget (device/residency.py);
  positive = bytes, 0 = auto (3/4 of the card's memory), negative =
  unbounded.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, replace
from typing import Iterator, Optional


@dataclass(frozen=True)
class ExecutionConfig:
    device: str = "cuda"
    device_mode: str = "on"
    region_mode: str = "on"
    kernel_mode: str = "on"
    morsel_size_rows: int = 128 * 1024
    batch_fill_target: float = 0.5
    batch_latency_ms: float = 50.0
    hbm_budget_bytes: int = 0
    mesh_devices: int = 0
    device_min_rows: int = 65_536

    def __post_init__(self) -> None:
        if self.device_mode not in ("on", "off"):
            raise ValueError(f"device_mode must be 'on' or 'off', got {self.device_mode!r}")
        if self.region_mode not in ("on", "off"):
            raise ValueError(f"region_mode must be one of 'on'/'off', got "
                             f"{self.region_mode!r}")
        if self.kernel_mode not in ("on", "off"):
            raise ValueError(f"kernel_mode must be 'on' or 'off', got {self.kernel_mode!r}")
        if self.morsel_size_rows < 1:
            raise ValueError(f"morsel_size_rows must be >= 1, got {self.morsel_size_rows!r}")
        if not 0.0 <= self.batch_fill_target <= 1.0:
            raise ValueError(f"batch_fill_target must be in [0, 1] (0 turns coalescing "
                             f"off), got {self.batch_fill_target!r}")
        if self.batch_latency_ms <= 0:
            raise ValueError(f"batch_latency_ms must be positive, got "
                             f"{self.batch_latency_ms!r}")
        if self.mesh_devices < 0:
            raise ValueError(f"mesh_devices must be >= 0, got {self.mesh_devices!r}")


_default: Optional[ExecutionConfig] = None


def execution_config() -> ExecutionConfig:
    global _default
    if _default is None:
        _default = ExecutionConfig()
    return _default


def set_execution_config(**kwargs) -> ExecutionConfig:
    """Update the process-default execution config; returns the new snapshot."""
    global _default
    _default = replace(execution_config(), **kwargs)
    return _default


@contextlib.contextmanager
def execution_config_ctx(**kwargs) -> Iterator[ExecutionConfig]:
    """Scoped execution-config override."""
    global _default
    prev = execution_config()
    _default = replace(prev, **kwargs)
    try:
        yield _default
    finally:
        _default = prev
