"""Task scheduler: per-stream priority heaps, worker snapshots and the
placement strategies (counterpart of daft_tpu/distributed/scheduler.py).

Each scheduling pass assigns pending tasks to workers with free slots:
Spread picks the worker with the most free slots, a soft WorkerAffinity its
worker when it has a slot (else spread), a hard one only its worker. A
hard-affinity task that finds its worker full puts that worker in the
pass's skip set, so later tasks bound to it are passed over without a scan
(``sched_affinity_skips``).

Cache affinity: each WorkerSnapshot carries the worker's residency digest
(the content keys of the device planes it holds, from its heartbeats,
device/residency.py ``digest``). A task whose ``rfingerprint``
(distributed/affinity.py) meets a free worker's digest goes there, scored
by the bytes it would not upload less a load penalty; a saturated or losing
worker falls back to spread, so no task waits for locality.

Fairness: pending tasks live in one heap per stream (one per concurrent
``run_tasks`` call); with several streams a pass deals one task per stream
per rotation, and the rotation's start advances between passes. The
scheduler takes no lock: the pool's dispatcher thread alone drives it.
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ..observability.metrics import registry
from ..utils.env import env_float, env_int
from .task import SubPlanTask, WorkerAffinity


@dataclass
class WorkerSnapshot:
    worker_id: str
    total_slots: int
    active_tasks: int = 0
    # latest heartbeat residency digest: stable slot key -> device bytes held
    resident: Dict[int, int] = field(default_factory=dict)

    @property
    def available_slots(self) -> int:
        return max(self.total_slots - self.active_tasks, 0)


class Scheduler:
    """Assigns pending tasks to workers with capacity.

    Usage: submit() tasks, then schedule() to drain as many as capacity allows
    (schedule() itself marks assigned slots busy); call task_finished() as
    results arrive to free slots. update_residency() feeds worker heartbeat
    digests in between passes.
    """

    def __init__(self, workers: Dict[str, int]):
        self._workers: Dict[str, WorkerSnapshot] = {
            wid: WorkerSnapshot(wid, slots) for wid, slots in workers.items()
        }
        # stream_key -> pending heap (insertion-ordered for the rotation)
        self._queues: "Dict[str, List[Tuple[int, int, SubPlanTask]]]" = {}
        self._stream_order: List[str] = []
        self._rr_pos = 0
        self._seq = itertools.count()
        self._autoscaling_threshold = env_float(
            "DAFT_TPU_AUTOSCALING_THRESHOLD", 1.25)
        # load penalty per active task when scoring affinity candidates: an
        # affinity pick must beat spread by more than this many bytes per unit
        # of load, or locality is not worth queueing behind a busy worker
        self._affinity_penalty_bytes = env_int(
            "DAFT_TPU_AFFINITY_PENALTY_BYTES", 8 * 1024 * 1024)
        # per-scheduler placement totals (the pool snapshots these into the
        # query trace; the same increments go to the process registry)
        self._stats = {"affinity_hits": 0, "affinity_misses": 0,
                       "bytes_avoided": 0, "affinity_skips": 0}

    # ---- worker lifecycle ----------------------------------------------------
    def add_worker(self, worker_id: str, slots: int) -> None:
        self._workers[worker_id] = WorkerSnapshot(worker_id, slots)

    def remove_worker(self, worker_id: str) -> None:
        self._workers.pop(worker_id, None)

    def task_finished(self, worker_id: str) -> None:
        w = self._workers.get(worker_id)
        if w is not None and w.active_tasks > 0:
            w.active_tasks -= 1

    def update_residency(self, worker_id: str, digest) -> None:
        """Install a worker's latest heartbeat residency digest (iterable of
        (stable_slot_key, bytes) pairs, or a dict)."""
        w = self._workers.get(worker_id)
        if w is None:
            return
        w.resident = dict(digest) if digest else {}

    def snapshots(self) -> List[WorkerSnapshot]:
        return list(self._workers.values())

    def placement_stats(self) -> Dict[str, int]:
        """Affinity placement totals since construction (one Scheduler serves
        one stage, so these are per-stage numbers for the query trace)."""
        return dict(self._stats)

    # ---- scheduling ----------------------------------------------------------
    def submit(self, task: SubPlanTask, stream_key: Optional[str] = None) -> None:
        # lower priority value = scheduled first (matches reference heap
        # order) WITHIN a stream; streams deal round-robin against each other
        key = stream_key if stream_key is not None else (task.stage_id or "")
        q = self._queues.get(key)
        if q is None:
            q = self._queues[key] = []
            self._stream_order.append(key)
        heapq.heappush(q, (task.priority, next(self._seq), task))

    def drop_stream(self, stream_key: str) -> int:
        """Purge a stream's pending tasks (its stage errored/was abandoned);
        returns how many were dropped. In-flight tasks are unaffected."""
        q = self._queues.pop(stream_key, None)
        if stream_key in self._stream_order:
            self._stream_order.remove(stream_key)
        return len(q) if q else 0

    def pending_count(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _pending_tasks(self) -> List[SubPlanTask]:
        return [t for q in self._queues.values() for _p, _s, t in q]

    def needs_autoscaling(self) -> bool:
        """True when pending demand exceeds total capacity by the threshold
        factor (DAFT_TPU_AUTOSCALING_THRESHOLD, default 1.25 — reference:
        default.rs needs_autoscaling). Cheap: called every dispatch loop."""
        pending = self.pending_count()
        if not pending:
            return False
        if not self._workers:
            return True
        total_capacity = sum(w.total_slots for w in self._workers.values())
        return pending > total_capacity * self._autoscaling_threshold

    def get_autoscaling_request(self) -> Optional[List[SubPlanTask]]:
        """Pending tasks justifying scale-up, or None (reference:
        default.rs get_autoscaling_request)."""
        if not self.needs_autoscaling():
            return None
        return self._pending_tasks()

    def schedule(self) -> List[Tuple[SubPlanTask, str]]:
        """Assign as many pending tasks as current capacity allows.

        Tasks whose strategy cannot be satisfied right now (hard affinity to a
        busy/absent worker, every eligible worker full) stay pending. A
        hard-affinity task that finds its preferred worker full marks that
        worker in a per-pass skip set: later heap entries bound to the same
        worker are re-queued without an eligibility scan instead of spinning
        the heap head-of-line (counted in sched_affinity_skips).

        With several pending streams, assignments rotate one-per-stream so
        concurrent queries share worker capacity fairly instead of FIFO
        head-of-line (see the module docstring).
        """
        live = [k for k in self._stream_order if self._queues.get(k)]
        blocked_prefs: Set[str] = set()
        if len(live) <= 1:
            # single stream: the original one-pass greedy drain
            return (self._drain_stream(live[0], blocked_prefs, limit=0)
                    if live else [])
        # rotate the starting stream across calls so no stream is always first
        start = self._rr_pos % len(live)
        self._rr_pos += 1
        order = live[start:] + live[:start]
        assigned: List[Tuple[SubPlanTask, str]] = []
        progress = True
        while progress:
            progress = False
            for key in order:
                got = self._drain_stream(key, blocked_prefs, limit=1)
                if got:
                    assigned.extend(got)
                    progress = True
        return assigned

    def _drain_stream(self, key: str, blocked_prefs: Set[str],
                      limit: int) -> List[Tuple[SubPlanTask, str]]:
        """Pop schedulable tasks from one stream's heap (at most `limit`;
        0 = until capacity runs out). Unschedulable entries are re-queued,
        preserving the head-of-line skip-set behavior within the stream."""
        heap = self._queues.get(key)
        if not heap:
            return []
        assigned: List[Tuple[SubPlanTask, str]] = []
        skipped: List[Tuple[int, int, SubPlanTask]] = []
        while heap:
            prio, seq, task = heapq.heappop(heap)
            strategy = task.strategy
            if (isinstance(strategy, WorkerAffinity) and strategy.hard
                    and strategy.worker_id in blocked_prefs):
                self._stats["affinity_skips"] += 1
                registry().inc("sched_affinity_skips")
                skipped.append((prio, seq, task))
                continue
            wid = self._pick_worker(task)
            if wid is None:
                if isinstance(strategy, WorkerAffinity) and strategy.hard:
                    # only a genuinely FULL preferred worker poisons the skip
                    # set: a task whose pref is merely excluded (requeue) or
                    # absent must not starve siblings the worker could serve
                    pref = self._workers.get(strategy.worker_id)
                    if (pref is not None and pref.available_slots == 0
                            and strategy.worker_id not in task.excluded_workers):
                        blocked_prefs.add(strategy.worker_id)
                skipped.append((prio, seq, task))
                continue
            self._workers[wid].active_tasks += 1
            assigned.append((task, wid))
            if limit and len(assigned) >= limit:
                break
        for item in skipped:
            heapq.heappush(heap, item)
        if not heap:
            self._queues.pop(key, None)
            if key in self._stream_order:
                self._stream_order.remove(key)
        return assigned

    def _pick_worker(self, task: SubPlanTask) -> Optional[str]:
        strategy = task.strategy
        eligible = [w for w in self._workers.values()
                    if w.worker_id not in task.excluded_workers]
        if isinstance(strategy, WorkerAffinity):
            pref = self._workers.get(strategy.worker_id)
            pref_ok = (pref is not None and pref.available_slots > 0
                       and pref.worker_id not in task.excluded_workers)
            if pref_ok:
                return pref.worker_id
            if strategy.hard:
                return None
        free = [w for w in eligible if w.available_slots > 0]
        if not free:
            return None
        wid = self._pick_resident(task, free, eligible)
        if wid is not None:
            return wid
        # Spread: most available slots; stable tiebreak by id for determinism
        return max(free, key=lambda w: (w.available_slots, w.worker_id)).worker_id

    def _pick_resident(self, task: SubPlanTask, free: List[WorkerSnapshot],
                       eligible: List[WorkerSnapshot]) -> Optional[str]:
        """Cache-affinity pick: the free worker with the best
        (bytes-avoided − load·penalty) score, when positive. Returns None to
        fall through to spread (also recording a miss when the task's planes
        sit only on workers with no free slot — locality lost to saturation)."""
        fp = task.rfingerprint
        if not fp:
            return None
        best: Optional[WorkerSnapshot] = None
        best_score = 0
        best_avoided = 0
        for w in free:
            avoided = self._overlap_bytes(w, fp)
            if avoided <= 0:
                continue
            score = avoided - self._affinity_penalty_bytes * w.active_tasks
            if best is None or (score, w.available_slots, w.worker_id) > \
                    (best_score, best.available_slots, best.worker_id):
                best, best_score, best_avoided = w, score, avoided
        if best is not None and best_score > 0:
            self._stats["affinity_hits"] += 1
            self._stats["bytes_avoided"] += best_avoided
            registry().inc("sched_affinity_hits")
            registry().inc("sched_bytes_avoided", best_avoided)
            return best.worker_id
        if any(w.available_slots == 0 and self._overlap_bytes(w, fp) > 0
               for w in eligible):
            self._stats["affinity_misses"] += 1
            registry().inc("sched_affinity_misses")
        return None

    @staticmethod
    def _overlap_bytes(w: WorkerSnapshot, fp) -> int:
        if not w.resident:
            return 0
        # bytes the worker actually holds for the slots this task would probe
        return sum(w.resident.get(k, 0) for k, _est in fp)
