"""The distributed runner (counterpart of daft_tpu/distributed/runner.py).

    import daft_tpu_torch as dt
    from daft_tpu_torch.distributed import DistributedRunner
    dt.runners.set_runner(DistributedRunner(num_workers=2, device_workers=2))

Distributable subtrees (scans, maps, joins, grouped aggregations, hash
repartitions) run as sub-plan tasks on worker processes with a disk-backed
Arrow IPC shuffle; the coordinator runs what remains (sorts, windows, writes,
the device join stages) over the gathered results.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Iterator, Optional

from ..core.micropartition import MicroPartition
from ..plan import logical as lp
from ..runners.native import Runner
from .planner import DistContext, localize
from .worker import WorkerPool


class DistributedRunner(Runner):
    def __init__(self, num_workers: int = 4, n_partitions: Optional[int] = None,
                 slots_per_worker: int = 1, shuffle_dir: Optional[str] = None,
                 shuffle_transport: str = "local",
                 max_workers: Optional[int] = None,
                 device_workers: int = 0):
        """shuffle_transport: "local" (reduce tasks read the shared shuffle
        directory — single-host fast path) or "socket" (reduce tasks fetch
        partitions from the HMAC-authenticated ShuffleFetchServer, the
        multi-host topology; reference flight_server.rs)."""
        if shuffle_transport not in ("local", "socket"):
            raise ValueError(f"unknown shuffle transport {shuffle_transport!r}")
        self.num_workers = num_workers
        self.max_workers = max_workers
        self.device_workers = device_workers
        self.n_partitions = n_partitions or num_workers
        self.slots_per_worker = slots_per_worker
        self.shuffle_transport = shuffle_transport
        self._shuffle_dir = shuffle_dir
        self._owns_shuffle_dir = shuffle_dir is None
        self._pool: Optional[WorkerPool] = None
        self._fetch_server = None
        # QueryTrace of the most recent traced run (distributed EXPLAIN ANALYZE)
        self.last_trace = None
        # concurrent run_iter callers (serving tier) must not race pool
        # creation; the pool itself is concurrent-caller safe once built
        import threading

        self._pool_init_lock = threading.Lock()

    def _ensure_pool(self) -> WorkerPool:
        with self._pool_init_lock:
            if self._pool is None:
                self._pool = WorkerPool(self.num_workers, self.slots_per_worker,
                                        max_workers=self.max_workers,
                                        device_workers=self.device_workers)
                if self._shuffle_dir is None:
                    self._shuffle_dir = tempfile.mkdtemp(prefix="daft_tpu_shuffle_")
                if self.shuffle_transport == "socket" and self._fetch_server is None:
                    from .fetch_server import ShuffleFetchServer

                    self._fetch_server = ShuffleFetchServer(self._shuffle_dir)
            return self._pool

    def run_iter(self, plan: lp.LogicalPlan) -> Iterator[MicroPartition]:
        """Execute with the full observability lifecycle: subscriber events
        (QueryStart/Optimized/End) like the native runner, PLUS a QueryTrace
        that collects per-task stats, per-stage shuffle counters, and worker
        heartbeats from the pool — emitted to subscribers at query end and
        kept on `self.last_trace` for distributed EXPLAIN ANALYZE."""
        import time
        import uuid

        from ..execution.executor import execute_plan
        from ..observability import (QueryEnd, QueryOptimized, QueryStart,
                                     notify, subscribers_active)
        from ..observability.metrics import registry
        from ..observability.runtime_stats import (StatsCollector,
                                                   current_collector,
                                                   set_collector)
        from ..config import execution_config
        from ..plan.optimizer import Optimizer
        from ..plan.physical import translate
        from .trace import QueryTrace

        pool = self._ensure_pool()
        # discard beats buffered in the worker pipes since the LAST drain
        # (the idle gap between queries): the end-of-query window filter
        # below judges by coordinator receive time, and these would all be
        # stamped inside THIS query's window at the first poll. Queued
        # worker-DEATH events survive this discard (preserve_deaths) — they
        # are one-shot and the dashboard's dead-worker latch needs them
        pool.drain_heartbeats(preserve_deaths=True)
        observed = subscribers_active()
        prev = current_collector()
        # trace when anyone is watching: attached subscribers OR an ambient
        # collector (explain_analyze / DataFrame.metrics). Otherwise tasks run
        # with collect_stats=False — the distributed zero-overhead path.
        traced = observed or prev is not None
        qid = uuid.uuid4().hex[:12] if traced else ""
        t_start = time.perf_counter()
        t_wall0 = time.time()
        reg_before = registry().snapshot() if traced else {}
        if observed:
            notify("on_query_start", QueryStart(qid, plan.display()))
        t0 = time.perf_counter()
        optimized = Optimizer().optimize(plan)
        # translated with the coordinator's own config: the coordinator's remainder may
        # use the device, and the Device* nodes of shipped subtrees survive
        # distribution, each worker running them under its own lease
        phys = translate(optimized)
        if observed:
            notify("on_query_optimized", QueryOptimized(
                qid, optimized.display(), phys.display(),
                time.perf_counter() - t0))
        trace = QueryTrace(qid) if traced else None
        if trace is not None:
            # trace epoch = query start (pre-optimize), so the timeline's
            # t=0 is where the user's wall clock started, not post-planning
            trace.started_wall = t_wall0
        self.last_trace = trace
        endpoints = [self._fetch_server.endpoint] if self._fetch_server else None
        ctx = DistContext(pool=pool, shuffle_dir=self._shuffle_dir,
                          n_partitions=self.n_partitions,
                          fetch_endpoints=endpoints, trace=trace,
                          ckpt=self._make_checkpointer(phys))
        collector = prev if prev is not None \
            else (StatsCollector() if observed else None)
        # coordinator-side placement scope (worker-side decisions stay in each
        # worker's own process ledger): the coordinator remainder's device stages
        # still record, and explain_placement's ambient scope is inherited
        from ..observability import placement as _placement

        prev_scope = _placement.current_scope()
        pscope = prev_scope if prev_scope is not None \
            else (_placement.PlacementScope() if traced else None)
        rows = 0
        err = None
        try:
            if execution_config().device_mode != "off":
                # a query asked to run on a missing card raises here
                from ..utils.torch_setup import resolve_device

                resolve_device(execution_config().device)
            set_collector(collector)
            _placement.set_scope(pscope)
            try:
                # localize EXECUTES distributed stages eagerly (shuffle + final
                # task waves run on the pool here, recording into the trace)
                plan = localize(ctx, phys)
                stream = execute_plan(plan)
            finally:
                set_collector(prev)
                _placement.set_scope(prev_scope)
            while True:
                set_collector(collector)
                _placement.set_scope(pscope)
                try:
                    part = next(stream)
                except StopIteration:
                    break
                finally:
                    set_collector(prev)
                    _placement.set_scope(prev_scope)
                rows += part.num_rows
                yield part
        except Exception as e:
            err = f"{type(e).__name__}: {e}"
            raise
        finally:
            set_collector(prev)
            _placement.set_scope(prev_scope)
            # drain even when untraced so beats from idle periods or untraced
            # queries never pile up and get misattributed to a later query
            beats = pool.drain_heartbeats()
            if trace is not None:
                for hb in beats:
                    # only beats from THIS query's window, judged by the
                    # COORDINATOR-side receive stamp (0.5s slack): the worker's
                    # send clock may be skewed — that skew is exactly what
                    # clock_offsets() estimates from these beats, so a
                    # worker-clock filter would drop the skewed beats it
                    # needs (send-ts fallback for beats predating the stamp)
                    # dead=True synthetic beats are kept regardless of the
                    # window: a death during the idle gap before this query
                    # must still reach the dashboard's dead-worker latch
                    if hb.get("dead") or \
                            hb.get("recv_ts", hb.get("ts", 0.0)) >= t_wall0 - 0.5:
                        trace.add_heartbeat(hb)
                # a warm pool can run a whole query in less than one
                # heartbeat period, leaving NO beat inside the window; fall
                # back to each silent worker's latest known beat so the
                # dashboard reflects the full pool after fast queries too
                seen = {h.worker_id for h in trace.heartbeats}
                for wid, hb in pool.latest_heartbeats().items():
                    if wid not in seen:
                        trace.add_heartbeat(hb)
            if observed and trace is not None:
                for ts in list(trace.tasks):
                    notify("on_task_stats", qid, ts)
                for sh in trace.shuffle_stats():
                    notify("on_shuffle_stats", qid, sh)
                for hb in list(trace.heartbeats):
                    notify("on_worker_heartbeat", qid, hb)
                # the assembled QueryTrace itself (timeline profiler source):
                # the dashboard serves its Chrome trace as a download
                notify("on_query_trace", qid, trace)
            if observed:
                stats = collector.finish() if collector else []
                for s in stats:
                    notify("on_operator_stats", qid, s)
                notify("on_query_end", QueryEnd(
                    qid, rows, time.perf_counter() - t_start, err, stats,
                    metrics=registry().diff(reg_before),
                    placements=pscope.to_dicts() if pscope is not None else []))

    def _make_checkpointer(self, phys):
        """Stage-boundary checkpoint/resume, armed ONLY by
        DAFT_TPU_CHECKPOINT_DIR (the zero-overhead gate: with it unset the
        checkpoint subsystem is never imported and no checkpoint counters
        move). The CheckpointId is the plan's content fingerprint — a
        re-submission of the same plan over the same data resumes past every
        committed stage; a plan we cannot fingerprint by content (opaque scan
        tasks, UDF handles) safely runs uncheckpointed."""
        root = os.environ.get("DAFT_TPU_CHECKPOINT_DIR", "")
        if not root:
            return None
        try:
            from ..checkpoint.stages import StageCheckpointer, query_fingerprint

            fp = query_fingerprint(phys)
            if fp is None:
                return None
            # the partition count is part of the checkpoint identity: a
            # committed shuffle's p0..pN-1 files are only complete for the
            # SAME fan-out — resuming an 8-partition checkpoint on a
            # 4-partition runner would silently drop half the rows
            return StageCheckpointer(root, f"{fp}-p{self.n_partitions}")
        except Exception:  # lint: ignore[broad-except] -- checkpointing is advisory
            return None

    def shutdown(self) -> None:
        if self._fetch_server is not None:
            self._fetch_server.close()
            self._fetch_server = None
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        if self._owns_shuffle_dir and self._shuffle_dir and os.path.isdir(self._shuffle_dir):
            shutil.rmtree(self._shuffle_dir, ignore_errors=True)
            self._shuffle_dir = None

    def __del__(self):  # best-effort cleanup
        try:
            self.shutdown()
        except Exception:  # lint: ignore[broad-except] -- interpreter-teardown __del__: anything
            pass  # may already be torn down; raising here prints noise
