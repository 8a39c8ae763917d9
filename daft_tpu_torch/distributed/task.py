"""Task model of the distributed tier (counterpart of
daft_tpu/distributed/task.py).

A ``SubPlanTask`` is one pickled physical sub-plan of the port's nodes and
the strategy that places it; a ``TaskResult`` is what a worker ships back:
the result partitions, the shuffle lineage records, and, when the task was
asked for stats, the operator stats, shuffle volume, spans and the worker's
registry deltas over the task (``engine_counters``, which carry the kernels'
``launches_*`` counts out of the worker process).
"""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple


@dataclass(frozen=True)
class Spread:
    """Run anywhere; the scheduler picks the worker with the most free slots."""


@dataclass(frozen=True)
class WorkerAffinity:
    """Prefer (soft) or require (hard) one worker."""

    worker_id: str
    hard: bool = False


@dataclass
class SubPlanTask:
    """A pickled physical sub-plan to run on one worker. Its leaves are
    InMemoryScan, StreamingScan or ShuffleRead nodes; a plan rooted at a
    ShuffleWrite writes shuffle files and returns no rows."""

    task_id: str
    plan_blob: bytes
    strategy: Any = field(default_factory=Spread)
    priority: int = 0
    # workers that already failed this task (a requeue excludes them)
    excluded_workers: Tuple[str, ...] = ()
    # the stage this task belongs to (the planner's, e.g. "shuffle:0")
    stage_id: str = ""
    # the query trace's context, stamped at dispatch
    trace_id: str = ""
    parent_span_id: str = ""
    # run under a StatsCollector and ship the stats back
    collect_stats: bool = False
    # coordinator time.time() when the task entered the scheduler
    submitted_at: float = 0.0
    # (slot key, estimated bytes) of the device planes the sub-plan would
    # probe (distributed/affinity.py); () = plain spread placement
    rfingerprint: Tuple[Tuple[int, int], ...] = ()
    # the pool sends the plan as a file the worker reads (WorkerPool's task
    # directory), and ``plan_blob`` is then empty
    blob_path: str = ""

    @classmethod
    def from_plan(cls, task_id: str, plan, strategy=None, priority: int = 0,
                  stage_id: str = "", rfingerprint: Tuple = ()) -> "SubPlanTask":
        # cloudpickle, where installed, pickles by value what a fresh worker
        # cannot import (a class defined in __main__ or a test module);
        # workers unpickle with plain pickle
        try:
            import cloudpickle

            blob = cloudpickle.dumps(plan, protocol=pickle.HIGHEST_PROTOCOL)
        except ImportError:
            blob = pickle.dumps(plan, protocol=pickle.HIGHEST_PROTOCOL)
        return cls(task_id=task_id, plan_blob=blob, strategy=strategy or Spread(),
                   priority=priority, stage_id=stage_id, rfingerprint=tuple(rfingerprint))

    def plan(self):
        if self.blob_path:
            with open(self.blob_path, "rb") as f:
                return pickle.loads(f.read())
        return pickle.loads(self.plan_blob)


@dataclass
class TaskResult:
    task_id: str
    worker_id: str
    # inline result partitions; empty for a shuffle write
    partitions: List[Any] = field(default_factory=list)
    rows: int = 0
    error: Optional[str] = None
    error_tb: Optional[str] = None
    # "" (generic), "shuffle_data_lost" (error_data: shuffle_id, map_ids) or
    # "shuffle_peer_unreachable" (error_data: shuffle_id): the pool re-raises
    # these typed, so the planner regenerates the lost map outputs
    error_kind: str = ""
    error_data: Optional[dict] = None
    # shuffle map-output lineage records ({shuffle_id, map_id, rows per
    # partition, paths}); always filled for a ShuffleWrite task: the coordinator
    # derives each reduce partition's expected maps from them
    map_outputs: Tuple[dict, ...] = ()
    # ---- stats (filled when the task asked for collect_stats) ----------------------
    bytes_out: int = 0
    exec_seconds: float = 0.0
    started_at: float = 0.0
    span_id: str = ""
    op_stats: Tuple[Any, ...] = ()
    # the task's shuffle volume (ShuffleRecorder.as_dict())
    shuffle: Optional[dict] = None
    # the worker registry's counter deltas over the task: which engine path
    # it took (device batches, coalescing, the kernels' launches_* counts)
    engine_counters: Optional[dict] = None
    # the task's timeline spans (worker-clock unix times)
    spans: Tuple[dict, ...] = ()
