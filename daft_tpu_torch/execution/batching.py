"""Batch sizing for device dispatch (counterpart of
daft_tpu/execution/batching.py, the one function the port's dispatch
coalescer reads; the reference's adaptive morsel strategies are not ported).
"""

from __future__ import annotations


def coalesce_target_rows(cfg) -> int:
    """Flush threshold of the device dispatch coalescer: ``batch_fill_target``
    of the power-of-two bucket at the configured morsel size; 0 = coalescing
    off."""
    if cfg.batch_fill_target <= 0:
        return 0
    from ..ops.stage import pad_bucket

    return int(cfg.batch_fill_target * pad_bucket(cfg.morsel_size_rows))
