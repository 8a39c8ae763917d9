"""The distributed tier's query trace (counterpart of daft_tpu/distributed/,
whose runner, scheduler and workers are not ported yet)."""

from .trace import QueryTrace

__all__ = ["QueryTrace"]
