"""Pipeline-parallel execution primitives (counterpart of
daft_tpu/execution/pipeline.py, without its stats collector, placement scope
and stall attribution).

- ``Channel`` / ``spawn_stage``: one operator's generator runs on a stage
  thread of its own (kept between stages by ``_StagePool``) and puts its
  output into a bounded queue. The bounded
  queue is the backpressure. An error on the stage thread travels through
  the channel and is raised by the consumer. When the consumer stops pulling
  (a limit, an error downstream) the channel is cancelled and the
  generator is closed on its own thread, so its ``finally`` blocks (a
  device stage's residency pin scope among them) unwind on the thread that
  entered them.
- ``pmap_stream``: an ordered map over a stream, a bounded window of calls
  in flight on the compute pool (utils/pool.py), results in input order.
- ``morsels`` / ``morsel_stream``: one large MicroPartition cut into slices
  of its batches, views of the same numpy planes (``RecordBatch.slice``),
  so a single in-memory partition still feeds the whole pool.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import wait
from queue import Empty, Full, Queue, SimpleQueue
from typing import Callable, Iterator, List, Optional

from ..core.micropartition import MicroPartition

STAGE_THREAD_NAME = "daft-stage"
IDLE_THREAD_NAME = "daft-idle"
# seconds a kept stage thread waits for another stage before it ends
STAGE_THREAD_IDLE_S = 60.0


class StageCancelled(BaseException):
    """Raised in a producer blocked on a cancelled channel. A BaseException,
    so an operator's ``except Exception`` cannot swallow it."""


_SENTINEL = object()


class Channel:
    """Bounded single-producer, single-consumer channel that carries the
    producer's error and the consumer's cancellation."""

    def __init__(self, maxsize: int = 4):
        self._q: Queue = Queue(maxsize)
        self._cancel = threading.Event()
        self._err: Optional[BaseException] = None

    # ---- producer side -----------------------------------------------------------
    def put(self, item) -> None:
        while True:
            if self._cancel.is_set():
                raise StageCancelled()
            try:
                self._q.put(item, timeout=0.05)
                return
            except Full:
                continue

    def close(self, err: Optional[BaseException] = None) -> None:
        """End the stream; ``err``, when given, is raised by the consumer."""
        self._err = err
        while True:
            if self._cancel.is_set():
                return
            try:
                self._q.put(_SENTINEL, timeout=0.05)
                return
            except Full:
                continue

    # ---- consumer side -----------------------------------------------------------
    def __iter__(self) -> Iterator:
        try:
            while True:
                item = self._q.get()
                if item is _SENTINEL:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            # exhausted, abandoned (GeneratorExit) or failed: release the
            # producer either way
            self._cancel.set()


class _StageThread(threading.Thread):
    """A thread that runs one stage at a time for the stage pool, named
    STAGE_THREAD_NAME while it runs one and IDLE_THREAD_NAME between them;
    it ends after STAGE_THREAD_IDLE_S seconds without a stage."""

    def __init__(self, pool: "_StagePool"):
        super().__init__(daemon=True, name=IDLE_THREAD_NAME)
        self._pool = pool
        self.tasks: SimpleQueue = SimpleQueue()

    def run(self) -> None:
        while True:
            try:
                fn, done = self.tasks.get(timeout=STAGE_THREAD_IDLE_S)
            except Empty:
                if self._pool.retire(self):
                    return
                continue  # handed a stage as it timed out: the task is queued
            self.name = STAGE_THREAD_NAME
            try:
                fn()
            finally:
                self.name = IDLE_THREAD_NAME
                self._pool.release(self)
                done.set()


class _StagePool:
    """Stage threads kept between stages, grown on demand and never capped:
    every running stage holds a thread until its consumer lets it go, so a
    plan of any number of stage nodes runs at once. A kept thread keeps its
    allocator's warm heap: a fresh thread's first large allocations cost
    far more on a sandboxed host (``pipeline_timings.py --threads``)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._idle: List[_StageThread] = []

    def run(self, fn: Callable[[], None]) -> threading.Event:
        """Run ``fn`` on a stage thread; the event is set once it returned
        and the thread is idle again."""
        done = threading.Event()
        with self._lock:
            worker = self._idle.pop() if self._idle else None
        if worker is None:
            worker = _StageThread(self)
            worker.start()
        worker.tasks.put((fn, done))
        return done

    def release(self, worker: _StageThread) -> None:
        with self._lock:
            self._idle.append(worker)

    def retire(self, worker: _StageThread) -> bool:
        """Take an idle ``worker`` out of the pool; False when it was handed
        a stage meanwhile."""
        with self._lock:
            if worker in self._idle:
                self._idle.remove(worker)
                return True
            return False


_STAGES = _StagePool()


def spawn_stage(gen: Iterator, maxsize: int = 4) -> Iterator:
    """Run ``gen`` on a stage thread; return an iterator over its output
    through a bounded channel. The stage starts on the first pull: a stream
    that is built and dropped unread starts nothing. When the iterator
    ends, fails or is closed, it waits for the stage to finish (the
    reference leaves it to finish alone), so a query that returns, a limited
    or failed one included, leaves no stage running and no open pin scope.
    The reference starts a new thread per stage; here the thread comes from
    ``_StagePool``, which keeps it for the next stage."""
    ch = Channel(maxsize)

    def run():
        err: Optional[BaseException] = None
        try:
            for item in gen:
                ch.put(item)
        except StageCancelled:
            pass
        except BaseException as e:  # noqa: BLE001 -- carried to the consumer
            err = e
        finally:
            try:
                gen.close()  # unwind the generator's finally blocks on this thread
            except BaseException:  # noqa: BLE001 -- the error ch.close(err) reports
                pass
            ch.close(err)

    def consume():
        done = _STAGES.run(run)
        try:
            yield from ch
        finally:
            # the channel is cancelled or ended: wait until the stage has
            # unwound, so nothing of it outlives the consumer
            done.wait()

    return consume()


def pmap_stream(stream: Iterator, fn: Callable, window: int = 0,
                strategy=None) -> Iterator:
    """``fn(item, index)`` over ``stream`` with up to ``window`` calls (the
    pool's width when 0) in flight on the compute pool, yielded in input
    order. While the window is full this thread waits on the oldest call, so
    upstream, the pool and downstream overlap. ``strategy`` (a
    batching.BatchingStrategy) is fed each morsel's rows and seconds from
    the pool thread that ran it."""
    from ..utils.pool import compute_pool

    pool = compute_pool()
    if window <= 0:
        window = pool._max_workers
    if strategy is not None:
        inner = fn

        def fn(item, i):  # noqa: F811 -- the caller's fn, timed
            t0 = time.perf_counter()
            out = inner(item, i)
            strategy.record(item.num_rows, time.perf_counter() - t0)
            return out
    futs: deque = deque()
    try:
        for i, item in enumerate(stream):
            futs.append(pool.submit(fn, item, i))
            if len(futs) >= window:
                yield futs.popleft().result()
        while futs:
            yield futs.popleft().result()
    finally:
        # abandoned: drop the calls not started, wait for the running ones
        running = [f for f in futs if not f.cancel()]
        wait(running)


def morsels(part: MicroPartition, morsel_rows: int) -> List[MicroPartition]:
    """``part`` cut into slices of about ``morsel_rows`` rows, each a view of
    its batch's planes; a part of at most twice that passes whole, and a
    batch of at most twice that stays one morsel."""
    n = part.num_rows
    if n <= morsel_rows * 2 or not part.batches:
        return [part]
    out: List[MicroPartition] = []
    for b in part.batches:
        if b.num_rows <= morsel_rows * 2:
            out.append(MicroPartition(part.schema, [b]))
            continue
        for s in range(0, b.num_rows, morsel_rows):
            out.append(MicroPartition(part.schema,
                                      [b.slice(s, min(s + morsel_rows, b.num_rows))]))
    return out or [part]


def morsel_stream(stream: Iterator, morsel_rows: int) -> Iterator:
    for part in stream:
        yield from morsels(part, morsel_rows)
