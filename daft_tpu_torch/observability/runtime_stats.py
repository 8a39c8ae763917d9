"""Per-operator runtime statistics and the timeline profiler's span sink
(counterpart of daft_tpu/observability/runtime_stats.py).

The executor asks current_collector() per node; when a collector is active
(subscribers attached or explain_analyze running) every physical node's
output iterator is wrapped to count rows/batches and attribute self-time.
When inactive the executor takes its zero-overhead path.

Wall-clock attribution: an operator's attributed self time splits three
ways —

- compute: time its own body spent producing (total next() time minus nested
  same-thread children minus channel starvation),
- starve: time blocked pulling from an UPSTREAM stage channel that had
  nothing ready (pipeline.Channel get-side, attributed to the consumer node
  active on that thread),
- blocked: time the operator's stage thread spent blocked pushing into a
  FULL downstream channel (pipeline.Channel put-side backpressure, attributed
  to the channel's producer node).

seconds == compute + starve + blocked by construction, so EXPLAIN ANALYZE's
stall columns always reconcile with the self-time column.

SpanRecorder is the timeline profiler's sink: coarse wall-clock spans
(device dispatch, H2D/D2H copies, coalescer flushes, spill writes) recorded
by the engine only while a recorder is installed — the no-recorder path is a
single attribute read, preserving the zero-overhead guarantee. A span
measures the host's wall clock: on the card a ``device.dispatch`` span
covers the kernels' enqueue (the card works meanwhile), and the device time
still to run when the host asks for the result lands in the span that waits
for it, the ``.cpu()`` copy of ``device.d2h``. No span synchronizes.

The port keeps stage threads between stages (execution/pipeline.py
``_StagePool``): a stage thread takes its query's collector when its stage
starts and ``reset_thread()`` drops every per-thread slot of this module when
it ends, so the next query on that thread starts unobserved.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from .events import OperatorStats

_local = threading.local()


class StatsCollector:
    def __init__(self) -> None:
        # nid -> [name, rows, batches, total_seconds, child_seconds,
        #         starve_seconds, blocked_seconds]
        self._nodes: Dict[int, list] = {}
        # stable per-query sequential node ids: keyed off id(node) for O(1)
        # lookup, but every wrapped node is ANCHORED (strong ref) for the
        # collector's lifetime so CPython can never reuse a freed node's id
        # mid-query and silently merge two operators' stats (the id()-reuse
        # bug class fixed for _decision_key in the residency manager)
        self._ids: Dict[int, int] = {}
        self._anchors: List[object] = []
        self._seq = 0
        # nid -> execution-path annotation (e.g. "mesh: 8 devices"), rendered
        # as a suffix on the operator name in EXPLAIN ANALYZE
        self._notes: Dict[int, str] = {}

    def node_id(self, node) -> int:
        """Stable sequential id for `node` within this collector (1-based in
        wrap order — deterministic across identical runs, unlike id())."""
        nid = self._ids.get(id(node))
        if nid is None:
            self._seq += 1
            nid = self._seq
            self._ids[id(node)] = nid
            self._anchors.append(node)
        return nid

    def wrap(self, node, iterator):
        """Wrap one operator's output iterator with row/time accounting.

        Attributed time is SELF time: total time blocked in this operator's
        next() minus time its direct children spent producing for it.
        """
        nid = self.node_id(node)
        entry = self._nodes.setdefault(
            nid, [node.name(), 0, 0, 0.0, 0.0, 0.0, 0.0])

        def gen():
            while True:
                t0 = time.perf_counter()
                prev = getattr(_local, "active", None)
                _local.active = nid
                try:
                    part = next(iterator)
                except StopIteration:
                    _local.active = prev
                    dt = time.perf_counter() - t0
                    entry[3] += dt
                    if prev is not None and prev in self._nodes:
                        self._nodes[prev][4] += dt
                    return
                finally:
                    _local.active = prev
                dt = time.perf_counter() - t0
                entry[3] += dt
                if prev is not None and prev in self._nodes:
                    self._nodes[prev][4] += dt
                entry[1] += part.num_rows
                entry[2] += 1
                yield part

        return gen()

    # ---- stall attribution (called by pipeline.Channel) --------------------------
    def note_starve(self, seconds: float) -> None:
        """Upstream starvation: the calling thread's active node spent
        `seconds` blocked on an empty stage channel. The wait happened inside
        that node's next() window, so it is carved OUT of compute at finish()."""
        nid = getattr(_local, "active", None)
        if nid is not None:
            entry = self._nodes.get(nid)
            if entry is not None:
                entry[5] += seconds

    def note_blocked(self, nid: int, seconds: float) -> None:
        """Downstream backpressure: node `nid`'s stage thread spent `seconds`
        blocked pushing into a full channel. Happens OUTSIDE the node's
        next() window (the producer loop), so finish() adds it on top."""
        entry = self._nodes.get(nid)
        if entry is not None:
            entry[6] += seconds

    def annotate(self, node, note: str) -> None:
        """Attach an execution-path note to one operator ("mesh: 8 devices");
        EXPLAIN ANALYZE renders it beside the operator name so the chosen
        tier is visible in the report, not only in the counters."""
        self._notes[self.node_id(node)] = note

    def finish(self) -> List[OperatorStats]:
        out = []
        for nid, (name, rows, batches, total, child, starve,
                  blocked) in self._nodes.items():
            compute = max(total - child - starve, 0.0)
            note = self._notes.get(nid)
            if note:
                name = f"{name} [{note}]"
            out.append(OperatorStats(
                node_id=nid, name=name, rows_out=rows, batches_out=batches,
                seconds=compute + starve + blocked,
                compute_seconds=compute, starve_seconds=starve,
                blocked_seconds=blocked))
        return out


def current_collector() -> Optional[StatsCollector]:
    return getattr(_local, "collector", None)


def set_collector(c: Optional[StatsCollector]) -> None:
    _local.collector = c


def reset_thread() -> None:
    """Drop this thread's collector, active node and span override: what a
    kept stage thread does when its stage ends."""
    _local.__dict__.clear()


# ---- timeline spans ------------------------------------------------------------------


class SpanRecorder:
    """Thread-safe wall-clock span sink for the query timeline profiler.

    Spans are plain dicts (picklable, as the reference's workers ship them):
    {"name", "cat", "ts": unix seconds, "dur": seconds, "args": {...}}.
    Bounded: past `cap` spans the recorder counts drops instead of growing —
    a pathological query must never OOM the profiler.
    """

    def __init__(self, cap: int = 8192):
        self._lock = threading.Lock()
        self._spans: List[dict] = []
        self.cap = cap
        self.dropped = 0

    def record(self, name: str, cat: str, t0: float, t1: float,
               args: Optional[dict] = None) -> None:
        span = {"name": name, "cat": cat, "ts": t0, "dur": max(t1 - t0, 0.0)}
        if args:
            span["args"] = args
        with self._lock:
            if len(self._spans) >= self.cap:
                self.dropped += 1
                return
            self._spans.append(span)

    def drain(self) -> List[dict]:
        with self._lock:
            spans, self._spans = self._spans, []
            return spans


# process-global active span recorder (None = profiling off everywhere; the
# engine's instrumentation sites pay one module-attribute read)
_ACTIVE_SPANS: Optional[SpanRecorder] = None

# per-thread override sentinel: a thread inside span_scope() reads its own
# slot INSTEAD of the global one, so a query can isolate itself from a query
# being profiled elsewhere in the process (their device spans must not bleed
# into that query's recorder, and vice versa)
_UNSET = object()


def current_spans() -> Optional[SpanRecorder]:
    rec = getattr(_local, "spans", _UNSET)
    if rec is not _UNSET:
        return rec
    return _ACTIVE_SPANS


def set_spans(rec: Optional[SpanRecorder]) -> None:
    global _ACTIVE_SPANS
    _ACTIVE_SPANS = rec


@contextmanager
def span_scope(rec: Optional[SpanRecorder]):
    """Thread-scoped span recorder override: inside the scope, THIS thread's
    instrumentation sites record into `rec` (or nowhere, for rec=None)
    regardless of the process-global slot (the reference's serving threads
    run queries under span_scope(None)). Spans recorded from pipeline stage
    and pool threads still follow the global slot: per-query profiling is a
    serialized, opt-in path."""
    prev = getattr(_local, "spans", _UNSET)
    _local.spans = rec
    try:
        yield
    finally:
        if prev is _UNSET:
            del _local.spans
        else:
            _local.spans = prev


@contextmanager
def profile_span(name: str, cat: str, **args):
    """Record the enclosed block as a timeline span when a SpanRecorder is
    active; a no-op (no clock read, no record) otherwise. Used at COARSE
    sites only (a device dispatch, a coalescer flush, a spill write), never
    per row."""
    rec = current_spans()
    if rec is None:
        yield
        return
    t0 = time.time()
    try:
        yield
    finally:
        rec.record(name, cat, t0, time.time(), args or None)


def span_iter(name: str, cat: str, inner, **args):
    """Stream `inner` through as-is; while a SpanRecorder is active, record
    ONE span covering the whole consumption window (first pull to exhaustion
    or consumer close), with rows/batches accumulated into the span args on
    top of the caller's. The no-recorder path delegates without timing —
    the streaming counterpart of profile_span (the scan, spill reads)."""
    rec = current_spans()
    if rec is None:
        yield from inner
        return
    t0 = time.time()
    rows = batches = 0
    try:
        for part in inner:
            rows += part.num_rows
            batches += 1
            yield part
    finally:
        rec.record(name, cat, t0, time.time(),
                   {**args, "rows": rows, "batches": batches})


def format_stats(stats: List[OperatorStats], total_seconds: float) -> str:
    lines = [f"{'operator':<24} {'rows out':>12} {'batches':>8} "
             f"{'self time':>10} {'compute':>10} {'starve':>10} {'blocked':>10}"]
    for s in sorted(stats, key=lambda s: -s.seconds):
        lines.append(
            f"{s.name:<24} {s.rows_out:>12} {s.batches_out:>8} "
            f"{s.seconds * 1000:>8.1f}ms {s.compute_seconds * 1000:>8.1f}ms "
            f"{s.starve_seconds * 1000:>8.1f}ms "
            f"{s.blocked_seconds * 1000:>8.1f}ms")
    lines.append(f"{'TOTAL':<24} {'':>12} {'':>8} {total_seconds * 1000:>8.1f}ms")
    return "\n".join(lines)
