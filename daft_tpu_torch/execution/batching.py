"""Morsel sizing (counterpart of daft_tpu/execution/batching.py): the
adaptive batching strategies and the dispatch coalescer's flush threshold.

``executor._map_op`` cuts an operator's input with ``adaptive_morsel_stream``
under ``batching_mode`` "dynamic" or "latency", and ``pipeline.pmap_stream``
feeds each morsel's rows and wall time back through ``record()``. Under
"static" (the default) the executor cuts fixed ``morsel_size_rows`` morsels
and makes no strategy. Sizes move on a power-of-two ladder, so the device
stages' padding buckets stay well filled at every step. Every strategy is
thread-safe: ``record()`` runs on pool threads while ``current_size()`` is
read from the stage thread that cuts the morsels. A resize counts in
``counters.morsel_resize``.
"""

from __future__ import annotations

import threading
from typing import Iterator, Protocol, runtime_checkable


@runtime_checkable
class BatchingStrategy(Protocol):
    """One operator's morsel-size policy."""

    def current_size(self) -> int:
        """Rows the next morsel should carry."""
        ...

    def record(self, rows: int, seconds: float) -> None:
        """Feed back one processed morsel's size and wall time."""
        ...


def _pow2(n: int) -> int:
    """The largest power of two <= n (at least 1)."""
    return 1 << max(int(n).bit_length() - 1, 0)


def _note_resize() -> None:
    from ..ops import counters

    counters.bump("morsel_resize")


class StaticBatching:
    """A fixed morsel size."""

    def __init__(self, rows: int):
        self._rows = max(int(rows), 1)

    def current_size(self) -> int:
        return self._rows

    def record(self, rows: int, seconds: float) -> None:  # noqa: ARG002
        return None


class DynamicBatching:
    """Throughput feedback: climb the ladder toward the knee of rows/s.

    A step's rate is measured over SAMPLES_PER_STEP morsels (summed rows
    over summed seconds) before any decision; a morsel outside [size/2,
    2*size] of the current step (cut at an older size) does not count. A
    better rate keeps the direction (x2 or /2), a worse one reverses it,
    and a change inside the deadband holds the size. The first step sets
    the baseline and takes one probing move. The floor never exceeds the
    configured initial size.
    """

    #: relative change of rows/s below which the size holds
    DEADBAND = 0.05
    #: morsels measured per ladder step before a decision
    SAMPLES_PER_STEP = 3

    def __init__(self, initial: int, min_rows: int = 4096,
                 max_rows: int = 16 * 1024 * 1024):
        self._lock = threading.Lock()
        self._min = _pow2(max(min(min_rows, max(initial, 1)), 1))
        self._max = _pow2(max(max_rows, self._min))
        self._size = min(max(_pow2(initial), self._min), self._max)
        self._grow = True
        self._prev_rate = 0.0
        self._acc_rows = 0
        self._acc_secs = 0.0
        self._acc_n = 0

    def current_size(self) -> int:
        with self._lock:
            return self._size

    def record(self, rows: int, seconds: float) -> None:
        if rows <= 0:
            return
        with self._lock:
            if not self._size // 2 <= rows <= self._size * 2:
                return
            self._acc_rows += rows
            self._acc_secs += seconds
            self._acc_n += 1
            if self._acc_n < self.SAMPLES_PER_STEP:
                return
            rate = self._acc_rows / max(self._acc_secs, 1e-9)
            self._acc_rows, self._acc_secs, self._acc_n = 0, 0.0, 0
            prev = self._prev_rate
            self._prev_rate = rate
            if prev <= 0.0:
                if self._size >= self._max:
                    self._grow = False
            else:
                change = (rate - prev) / prev
                if abs(change) < self.DEADBAND:
                    return
                if change < 0:
                    self._grow = not self._grow
            nxt = self._size * 2 if self._grow else self._size // 2
            nxt = min(max(nxt, self._min), self._max)
            if nxt != self._size:
                self._size = nxt
                _note_resize()


class LatencyConstrainedBatching:
    """Size each morsel so its processing stays under a latency target: an
    EMA of the observed rows/s times the target, on the ladder."""

    #: EMA weight of the newest rows/s
    ALPHA = 0.3

    def __init__(self, target_seconds: float, initial: int,
                 min_rows: int = 1024, max_rows: int = 16 * 1024 * 1024):
        self._lock = threading.Lock()
        self._target = max(float(target_seconds), 1e-4)
        self._min = _pow2(max(min(min_rows, max(initial, 1)), 1))
        self._max = _pow2(max(max_rows, self._min))
        self._size = min(max(_pow2(initial), self._min), self._max)
        self._rate = 0.0

    def current_size(self) -> int:
        with self._lock:
            return self._size

    def record(self, rows: int, seconds: float) -> None:
        if rows <= 0:
            return
        rate = rows / max(seconds, 1e-9)
        with self._lock:
            self._rate = rate if self._rate <= 0.0 else (
                self.ALPHA * rate + (1.0 - self.ALPHA) * self._rate)
            nxt = min(max(_pow2(int(self._rate * self._target) or 1), self._min), self._max)
            if nxt != self._size:
                self._size = nxt
                _note_resize()


def coalesce_target_rows(cfg) -> int:
    """Flush threshold of the device dispatch coalescer: ``batch_fill_target``
    of the power-of-two bucket at the configured morsel size; 0 = coalescing
    off."""
    if cfg.batch_fill_target <= 0:
        return 0
    from ..ops.stage import pad_bucket

    return int(cfg.batch_fill_target * pad_bucket(cfg.morsel_size_rows))


def make_strategy(cfg) -> BatchingStrategy:
    """A strategy for one operator's stream from the execution config (each
    operator climbs on its own)."""
    if cfg.batching_mode == "dynamic":
        return DynamicBatching(cfg.morsel_size_rows)
    if cfg.batching_mode == "latency":
        return LatencyConstrainedBatching(cfg.batch_latency_ms / 1e3, cfg.morsel_size_rows)
    return StaticBatching(cfg.morsel_size_rows)


def adaptive_morsel_stream(stream: Iterator, strategy: BatchingStrategy) -> Iterator:
    """Morsels cut at the strategy's current size, consulted per morsel:

    - a batch of more than twice the size is sliced as the consumer pulls,
      so a resize applies to the rest of the batch being cut;
    - smaller batches gather, whole and in order, into one multi-batch
      MicroPartition until they reach the size; a batch that would take the
      gathered rows past twice the size flushes them first.

    Empty partitions pass through; row order is kept."""
    pending: list = []
    pending_rows = 0
    schema = None

    def flush():
        nonlocal pending, pending_rows
        if pending:
            out = MicroPartition(schema, pending)
            pending, pending_rows = [], 0
            yield out

    from ..core.micropartition import MicroPartition

    for part in stream:
        schema = part.schema
        if part.num_rows == 0:
            yield from flush()
            yield part
            continue
        for b in part.batches:
            if b.num_rows == 0:
                continue
            size = max(strategy.current_size(), 1)
            if b.num_rows > size * 2:
                yield from flush()
                s = 0
                while s < b.num_rows:
                    size = max(strategy.current_size(), 1)
                    yield MicroPartition(part.schema, [b.slice(s, min(s + size, b.num_rows))])
                    s += size
                continue
            if pending_rows and pending_rows + b.num_rows > size * 2:
                yield from flush()
            pending.append(b)
            pending_rows += b.num_rows
            if pending_rows >= size:
                yield from flush()
    yield from flush()
