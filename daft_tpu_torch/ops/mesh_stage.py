"""Row sharding over the mesh (counterpart of the helpers of
daft_tpu/ops/mesh_stage.py that the mesh repartition uses). The mesh stages
themselves (grouped, ungrouped, join) are not ported yet.

A batch of n rows shards over the mesh's shard slots as one flat array of
``mesh_total(n, size)`` rows on the mesh's device: each shard holds a
power-of-two bucket (ops/stage.py ``pad_bucket``) of contiguous rows, the
tail padded with zeros and masked out by ``mesh_row_mask``.
"""

from __future__ import annotations

import numpy as np
import torch

from .stage import device_row_mask, pad_bucket


def mesh_total(n: int, n_devices: int) -> int:
    """Global padded row count of an n-row batch over ``n_devices`` shards."""
    return pad_bucket(max((n + n_devices - 1) // n_devices, 1)) * n_devices


def mesh_row_mask(mesh, n: int, total: int) -> torch.Tensor:
    """bool[total] on the mesh's device marking the first n rows real
    (cached per (n, total, device))."""
    return device_row_mask(n, total, mesh.device)


def _shard_np(mesh, arr: np.ndarray, total: int) -> torch.Tensor:
    """One host array on the mesh's device, zero-padded to ``total`` rows.
    Unsigned 16/32/64-bit values travel as the same-width signed integers (a
    view: the bits do not change), since torch's unsigned types lack most
    ops."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype.kind == "u" and arr.dtype.itemsize > 1:
        arr = arr.view(f"i{arr.dtype.itemsize}")
    if len(arr) < total:
        arr = np.concatenate([arr, np.zeros(total - len(arr), dtype=arr.dtype)])
    return torch.from_numpy(arr).to(mesh.device)
