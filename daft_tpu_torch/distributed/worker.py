"""Worker processes and the pool that dispatches to them (counterpart of
daft_tpu/distributed/worker.py).

Workers are fresh ``python -m daft_tpu_torch.distributed._worker_entry``
subprocesses that connect back to the coordinator's UNIX socket
(multiprocessing.connection framing, pickle payloads, an HMAC key passed in
the child's environment). They are never forked: the coordinator may hold a CUDA
context, which a forked child cannot use.

The device lease: the pool hands every worker the coordinator's execution
config on its command line (``device``, the batching, shuffle and spill
knobs), since the port's ``ExecutionConfig.device`` has no environment
variable. The first ``device_workers`` workers get ``device_mode`` through
``DAFT_TPU_DEVICE`` as in the reference (the coordinator's mode, "auto" when the
coordinator's is "off"), and an even share of the coordinator's residency budget,
which the coordinator itself is cut to while the pool lives, so the processes
sharing one card together claim no more than it did alone; the rest run "off". A leased "cuda" worker on a
machine without a card raises at its first device stage, and that task's
error reaches the coordinator; nothing reruns it on the host.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import uuid
from collections import deque
from multiprocessing import AuthenticationError
from multiprocessing.connection import Client, Listener
from typing import Dict, List, Optional

from ..observability.metrics import registry
from ..utils.env import env_bool, env_float, env_int
from . import faults
from .task import SubPlanTask, TaskResult

# the execution config's fields a worker runs under, from the coordinator's
WORKER_CONFIG_KEYS = ("device", "kernel_mode", "region_mode", "morsel_size_rows",
                      "batch_fill_target", "batch_latency_ms", "batching_mode",
                      "pipeline_mode", "hbm_budget_bytes", "shuffle_compression",
                      "shuffle_fetch_parallelism", "shuffle_prefetch_batches",
                      "spill_io_threads", "spill_prefetch_batches", "device_min_rows")


def _rss_bytes() -> int:
    """Resident set size of this process (linux /proc; getrusage fallback)."""
    try:
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * (os.sysconf("SC_PAGE_SIZE") or 4096)
    except (OSError, ValueError, IndexError):
        try:
            import resource

            return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
        except Exception:  # lint: ignore[broad-except] -- heartbeat must never fail the worker
            return 0


def _residency_module():
    """The already-imported residency module, or None — the heartbeat thread
    must NEVER trigger an import itself: the main thread's first task import
    (the executor and torch, seconds on a cold cache) holds per-module import
    locks, and a heartbeat thread blocked on them falls silent exactly long
    enough for the coordinator's liveness monitor to declare this worker dead."""
    import sys

    return sys.modules.get(f"{__package__.rsplit('.', 1)[0]}.device.residency")


def _hbm_bytes() -> int:
    """Device bytes held by this worker's HBM residency manager (0 when the
    worker never touched a device)."""
    try:
        mod = _residency_module()
        return mod.manager().bytes_resident() if mod is not None else 0
    except Exception:  # lint: ignore[broad-except] -- heartbeat must never fail the worker
        return 0


def _hbm_digest() -> list:
    """Compact residency digest: (stable_slot_key, bytes) pairs for the device
    planes this worker holds (capped). The coordinator drains these into scheduler
    WorkerSnapshots for cache-affinity placement."""
    try:
        mod = _residency_module()
        return mod.manager().digest() if mod is not None else []
    except Exception:  # lint: ignore[broad-except] -- heartbeat must never fail the worker
        return []


def _hbm_h2d_bytes() -> int:
    """Cumulative host->device upload bytes in this worker (hbm_h2d_bytes
    counter) — a repeat sub-plan served from resident planes shows a zero
    delta, which the affinity tests assert end to end."""
    try:
        return registry().get("hbm_h2d_bytes")
    except Exception:  # lint: ignore[broad-except] -- heartbeat must never fail the worker
        return 0


def _run_task(task: SubPlanTask, worker_id: str) -> TaskResult:
    """Execute one sub-plan. When the task asks for stats (coordinator has
    subscribers attached or explain_analyze running) the plan runs under a
    StatsCollector with a ShuffleRecorder installed, and the result ships the
    per-operator stats + shuffle volume + a task span id within the stamped
    trace context back to the coordinator."""
    from ..execution.executor import execute_plan
    from . import shuffle as shf

    collector = recorder = span_rec = None
    reg_before = None
    # map-output lineage sink: installed for EVERY task (not just traced
    # ones) — the coordinator's reduce-side completeness check and the lost-map
    # regeneration path depend on these records, so they are correctness
    # state, not telemetry. Costs one list per task.
    map_sink: list = []
    shf.set_map_outputs(map_sink)
    if task.collect_stats:
        from ..observability.metrics import registry
        from ..observability.otlp import _span_id
        from ..observability.runtime_stats import (SpanRecorder, StatsCollector,
                                                   set_collector, set_spans)

        collector = StatsCollector()
        recorder = shf.ShuffleRecorder()
        span_rec = SpanRecorder()
        reg_before = registry().snapshot()
        set_collector(collector)
        set_spans(span_rec)
        shf.set_recorder(recorder)
    started_at = time.time()
    t0 = time.perf_counter()
    try:
        plan = task.plan()
        parts = [p for p in execute_plan(plan)]
        exec_s = time.perf_counter() - t0
        rows = sum(p.num_rows for p in parts)
        res = TaskResult(task_id=task.task_id, worker_id=worker_id,
                         partitions=parts, rows=rows,
                         exec_seconds=exec_s, started_at=started_at)
        res.map_outputs = tuple(map_sink)
        if collector is not None:
            res.bytes_out = sum(p.size_bytes() for p in parts)
            res.op_stats = tuple(collector.finish())
            res.shuffle = recorder.as_dict()
            # timeline spans (device dispatch/h2d/d2h, shuffle fetch) in
            # worker-clock unix time; the coordinator's QueryTrace re-aligns them
            res.spans = tuple(span_rec.drain())
            res.span_id = _span_id(task.trace_id or task.task_id,
                                   "task", task.task_id)
            from ..observability.metrics import registry

            # which engine paths THIS task took in THIS process (device
            # dispatches, coalescing, HBM traffic) — per-operator stats can't
            # carry that; see TaskResult.engine_counters
            res.engine_counters = registry().diff(reg_before)
        return res
    finally:
        shf.set_map_outputs(None)
        if task.collect_stats:
            from ..observability.runtime_stats import set_collector, set_spans

            set_collector(None)
            set_spans(None)
            shf.set_recorder(None)


def _unlink(path: str) -> None:
    try:
        os.unlink(path)
    except OSError:
        pass


def _classify_error(e: BaseException):
    """(error_kind, error_data) for recoverable failure classes the coordinator
    can act on; ("", None) for everything else."""
    from . import shuffle as shf

    if isinstance(e, shf.ShuffleDataLost):
        return "shuffle_data_lost", {"shuffle_id": e.shuffle_id,
                                     "map_ids": list(e.map_ids)}
    if isinstance(e, shf.ShufflePeerUnreachable):
        return "shuffle_peer_unreachable", {"shuffle_id": e.shuffle_id}
    return "", None


def _worker_loop(conn, worker_id: str) -> None:
    """Receive pickled SubPlanTasks, execute, reply TaskResult. A background
    thread interleaves ("heartbeat", {...}) reports — slot occupancy, task
    counts, RSS — on the same connection (send-locked; the coordinator routes them
    out of band in WorkerProcess.poll)."""
    send_lock = threading.Lock()
    stop = threading.Event()
    state = {"busy": 0, "completed": 0, "failed": 0}
    t_start = time.time()

    def _send(msg) -> None:
        # serialize OUTSIDE the lock: pickling a large TaskResult can take
        # whole seconds, and the heartbeat thread shares this lock — holding
        # it through the dumps would silence beats long enough for the
        # coordinator's liveness monitor to SIGKILL a healthy worker mid-send.
        # send_bytes(ForkingPickler.dumps(x)) is exactly what conn.send(x)
        # does internally, so the coordinator's recv() decodes it unchanged.
        from multiprocessing.reduction import ForkingPickler

        buf = bytes(ForkingPickler.dumps(msg))
        with send_lock:
            # lint: ignore[blocking-under-lock] -- send_lock exists to serialize
            # this pipe; the payload is pre-pickled so the hold is one write
            conn.send_bytes(buf)

    total_slots = env_int("DAFT_TPU_WORKER_SLOTS", 1, lo=1)

    def _heartbeat_loop(interval: float) -> None:
        # first beat immediately so even sub-second queries observe >=1
        while not stop.is_set():
            try:
                _send(("heartbeat", {
                    "worker_id": worker_id, "ts": time.time(),
                    "busy_slots": state["busy"], "total_slots": total_slots,
                    "tasks_completed": state["completed"],
                    "tasks_failed": state["failed"],
                    "rss_bytes": _rss_bytes(),
                    "hbm_bytes_resident": _hbm_bytes(),
                    "hbm_digest": _hbm_digest(),
                    "hbm_h2d_bytes": _hbm_h2d_bytes(),
                    "uptime_s": time.time() - t_start,
                }))
            except (BrokenPipeError, OSError):
                return  # coordinator gone; main loop will notice on recv
            stop.wait(interval)

    _send(("hello", worker_id))
    interval = env_float("DAFT_TPU_HEARTBEAT_S", 2.0)
    if interval > 0:
        threading.Thread(target=_heartbeat_loop, args=(interval,),
                         daemon=True, name="daft-heartbeat").start()
    # the engine's import (torch among it) while the beats run, so the first
    # task does not pay it; the device itself is resolved by the first device
    # stage, which raises there when the leased card is missing
    from ..execution import executor as _executor  # noqa: F401
    try:
        while True:
            try:
                msg = conn.recv()
            except (EOFError, KeyboardInterrupt):
                return
            if msg is None or msg[0] == "stop":
                return
            kind, task = msg
            assert kind == "task"
            state["busy"] = 1
            try:
                if faults.ENABLED:
                    faults.set_stage(task.stage_id)
                    faults.maybe_trip("task_start", stage_id=task.stage_id)
                res = _run_task(task, worker_id)
                state["completed"] += 1
                _send(res)
                if faults.ENABLED:
                    # the post-publish window: the task's result is already on
                    # the wire, so a trip here simulates a host that finished
                    # its map work and THEN died (optionally taking its
                    # shuffle files with it — the regeneration trigger)
                    faults.maybe_trip(
                        "task_sent", stage_id=task.stage_id,
                        paths=[p for mo in res.map_outputs
                               for p in mo.get("paths", ())])
            except Exception as e:  # noqa: BLE001 — errors must cross the process boundary
                state["failed"] += 1
                err_kind, err_data = _classify_error(e)
                _send(TaskResult(task_id=task.task_id, worker_id=worker_id,
                                 error=f"{type(e).__name__}: {e}",
                                 error_tb=traceback.format_exc(),
                                 error_kind=err_kind, error_data=err_data))
            finally:
                state["busy"] = 0
    finally:
        stop.set()


def main(argv: List[str]) -> None:
    import json

    address, worker_id = argv[0], argv[1]
    # the coordinator's execution config, handed over on the command line (the
    # device lease's device_mode arrives in DAFT_TPU_DEVICE, which the
    # config reads)
    if len(argv) > 2:
        from ..config import set_execution_config

        set_execution_config(**json.loads(argv[2]))
    # exported so fault tripwires (faults.py) can target one worker by id
    os.environ["DAFT_TPU_WORKER_ID"] = worker_id
    authkey = bytes.fromhex(os.environ["DAFT_TPU_WORKER_AUTHKEY"])
    conn = Client(address, family="AF_UNIX", authkey=authkey)
    try:
        _worker_loop(conn, worker_id)
    finally:
        conn.close()


class WorkerProcess:
    """Handle to one worker subprocess (the WorkerHandle the scheduler targets)."""

    def __init__(self, worker_id: str, acceptor, address: str, slots: int = 1,
                 env: Optional[Dict[str, str]] = None, config: Optional[dict] = None,
                 connect: bool = True):
        import json

        self.worker_id = worker_id
        self.slots = slots
        # the execution config this worker was spawned with; a respawned
        # replacement inherits it with the env (the lease above all)
        self.spawn_config: dict = dict(config or {})
        # the extra env this worker was spawned with (device lease, fault
        # tripwires): a respawned replacement must inherit it, or a dead
        # device-leased worker comes back host-only and the pool silently
        # loses device capability for its remaining lifetime
        self.spawn_env: Dict[str, str] = dict(env or {})
        child_env = dict(os.environ)
        child_env.setdefault("DAFT_TPU_DEVICE", "off")
        child_env["DAFT_TPU_WORKER_SLOTS"] = str(slots)
        # make the engine AND everything the coordinator can import resolvable in
        # the child (script dir, pytest-inserted test dirs): shipped sub-plans
        # may reference classes from any module on the coordinator's sys.path
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        prev = child_env.get("PYTHONPATH", "")
        paths = [pkg_root] + [p for p in sys.path if p and p != pkg_root]
        if prev:
            paths.append(prev)
        child_env["PYTHONPATH"] = os.pathsep.join(paths)
        child_env.update(env or {})
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "daft_tpu_torch.distributed._worker_entry",
             address, worker_id, json.dumps(config or {})],
            env=child_env)
        self._acceptor = acceptor
        self._conn = None
        if connect:
            self.connect()
        self.inflight: Dict[str, SubPlanTask] = {}
        # out-of-band worker heartbeats received during poll (bounded window)
        self.heartbeats: deque = deque(maxlen=256)
        # results received while draining heartbeats; poll() serves these first
        self._pending_results: deque = deque()
        # latest residency digest from a heartbeat: stable slot key -> bytes
        # (scheduler cache-affinity input; survives heartbeat window drains).
        # digest_seq bumps on every refresh so the dispatch loop pushes the
        # digest to the scheduler only when it actually changed
        self.last_digest: Dict[int, int] = {}
        self.digest_seq = 0
        # most recent heartbeat payload, surviving window drains: a warm pool
        # can finish a whole query in less than one heartbeat period, and the
        # runner falls back to this so /api/workers never shows an empty pool
        # after a sub-period query
        self.last_hb: Optional[dict] = None
        # multiprocessing.Connection framing is not thread-safe: the pool's
        # dispatcher thread polls while a coordinator thread may drain heartbeats
        # (concurrent serving queries), so every send/recv on this connection
        # goes through one lock
        self._io_lock = threading.RLock()
        # ---- liveness state (coordinator-side failure detection) -----------------
        # last time ANY traffic arrived from this worker (heartbeat or
        # result): results prove liveness as much as beats do, and a poll()
        # returning a result may leave beats buffered behind it — judging by
        # beats alone would false-positive on a busy, healthy worker
        self.last_beat = time.time()
        # the connection EOF'd while the process still looks alive (hung
        # worker that closed its socket) — treated as a failure by the pool
        self.conn_dead = False
        # set by WorkerPool when the liveness monitor declares this worker
        # dead (heartbeat timeout / connection EOF); the reason string flows
        # to counters, the query trace, and the dashboard's dead-worker list
        self.failed_reason: Optional[str] = None

    def connect(self) -> None:
        """Wait for the spawned worker's hello (the pool spawns every worker
        first and then connects each, so their imports overlap)."""
        acceptor, worker_id = self._acceptor, self.worker_id
        # accept with a liveness check and a hard deadline: a child that
        # crashes on startup (or a stranger stalling the auth handshake) must
        # never hang the coordinator in accept()
        # the acceptor is shared pool-wide, so an accepted connection may
        # belong to a sibling worker — route by the hello's worker id
        routed = getattr(acceptor, "routed_hellos", None)
        if routed is None:
            routed = {}
            acceptor.routed_hellos = routed
        deadline = 60.0
        while self._conn is None:
            if worker_id in routed:
                self._conn = routed.pop(worker_id)
                break
            try:
                conn = acceptor.accept(0.5)
            except AuthenticationError:
                conn = None  # stranger with the wrong key; keep waiting
            if conn is not None:
                if not conn.poll(30):
                    self._proc.terminate()
                    raise RuntimeError("worker connection never sent hello")
                hello = conn.recv()
                assert hello[0] == "hello", hello
                if hello[1] == worker_id:
                    self._conn = conn
                else:
                    routed[hello[1]] = conn
                continue
            rc = self._proc.poll()
            if rc is not None:
                raise RuntimeError(
                    f"worker {worker_id} exited with code {rc} before connecting")
            deadline -= 0.5
            if deadline <= 0:
                self._proc.terminate()
                raise RuntimeError(f"worker {worker_id} never connected (60s)")
        self.last_beat = time.time()

    def mark_failed(self, reason: str) -> None:
        """Declare this worker dead: record the reason and SIGKILL the
        process (SIGKILL acts even on a SIGSTOP'd process — the case the
        heartbeat timeout exists to catch)."""
        if self.failed_reason is None:
            self.failed_reason = reason
        try:
            self._proc.kill()
        except OSError:
            pass

    def submit(self, task: SubPlanTask) -> None:
        with self._io_lock:
            self.inflight[task.task_id] = task
            # lint: ignore[blocking-under-lock] -- _io_lock exists to serialize
            # this conn; tasks are small and no liveness path shares it
            self._conn.send(("task", task))

    def _note_heartbeat(self, hb: dict) -> None:
        # coordinator-side receive stamp: recv_ts - ts (worker send clock) over a
        # query's beats lower-bounds to the worker->coordinator clock offset used
        # to align worker span timestamps in the Chrome trace export
        hb = dict(hb)
        hb["recv_ts"] = time.time()
        self.heartbeats.append(hb)
        self.last_hb = hb
        digest = hb.get("hbm_digest")
        if digest is not None:
            self.last_digest = dict(digest)
            self.digest_seq += 1

    def poll(self, timeout: float = 0.0) -> Optional[TaskResult]:
        with self._io_lock:
            if self._pending_results:
                res = self._pending_results.popleft()
                self.inflight.pop(res.task_id, None)
                return res
            try:
                while self._conn.poll(timeout):
                    # lint: ignore[blocking-under-lock] -- poll() said data is
                    # ready; _io_lock serializes this conn by design
                    msg = self._conn.recv()
                    self.last_beat = time.time()  # any traffic = alive
                    if isinstance(msg, tuple) and msg and msg[0] == "heartbeat":
                        # out-of-band heartbeat: record and keep draining
                        # (without blocking again — the result may already be
                        # queued)
                        self._note_heartbeat(msg[1])
                        timeout = 0.0
                        continue
                    res: TaskResult = msg
                    self.inflight.pop(res.task_id, None)
                    return res
            except (EOFError, BrokenPipeError, OSError):
                # dead worker: the pool's liveness pass re-queues its
                # in-flight tasks (conn_dead catches the hung-but-running
                # process whose exit code never changes)
                self.conn_dead = True
            return None

    def pump(self) -> None:
        """Drain whatever the connection holds without consuming anything:
        heartbeats land in the window (and refresh last_digest), results are
        stashed for the next poll(). Lets the pool refresh residency digests
        before scheduling a stage."""
        with self._io_lock:
            try:
                while self._conn.poll(0.0):
                    # lint: ignore[blocking-under-lock] -- zero-timeout poll()
                    # said data is ready; _io_lock serializes this conn
                    msg = self._conn.recv()
                    self.last_beat = time.time()
                    if isinstance(msg, tuple) and msg and msg[0] == "heartbeat":
                        self._note_heartbeat(msg[1])
                    else:
                        self._pending_results.append(msg)
            except (EOFError, BrokenPipeError, OSError):
                self.conn_dead = True

    def drain_heartbeats(self) -> List[dict]:
        """Non-destructively empty the connection: heartbeats are collected;
        any TaskResult encountered is stashed for the next poll() (a stale
        result from an errored stage must not be silently consumed here)."""
        with self._io_lock:
            self.pump()
            out = list(self.heartbeats)
            self.heartbeats.clear()
            return out

    @property
    def alive(self) -> bool:
        return self._proc.poll() is None

    def stop(self) -> None:
        try:
            if self.alive:
                with self._io_lock:
                    # lint: ignore[blocking-under-lock] -- shutdown path; the
                    # lock serializes the conn and nothing else is running
                    self._conn.send(("stop",))
                self._proc.wait(timeout=2)
        except (BrokenPipeError, OSError, subprocess.TimeoutExpired):
            pass
        finally:
            if self.alive:
                self._proc.terminate()
                try:
                    self._proc.wait(timeout=2)
                except subprocess.TimeoutExpired:
                    self._proc.kill()
            try:
                self._conn.close()
            except OSError:
                pass


class _StageRun:
    """One run_tasks() call in flight on the pool dispatcher: the caller
    thread waits on `done` while the dispatcher routes this stage's results
    here. `key` is the scheduler stream key — one per concurrent stage, so
    the per-stream round-robin in Scheduler.schedule() interleaves concurrent
    queries' tasks fairly across the shared workers."""

    __slots__ = ("key", "stage_id", "trace", "tasks", "expected", "results",
                 "error", "error_kind", "error_data", "done",
                 "completed_times", "running", "speculated",
                 "dup_worker", "dispatched_at", "stats_before",
                 "placement_stats")

    def __init__(self, key: str, tasks: List[SubPlanTask], stage_id: str,
                 trace) -> None:
        self.key = key
        self.stage_id = stage_id
        self.trace = trace
        self.tasks: Dict[str, SubPlanTask] = {t.task_id: t for t in tasks}
        self.expected = set(self.tasks)
        self.results: Dict[str, TaskResult] = {}
        self.error: Optional[str] = None
        # structured classification of the failing task's error (see
        # TaskResult.error_kind): run_tasks re-raises typed exceptions from
        # these so the planner's recovery loop can regenerate lost shuffle
        # maps instead of failing the whole query
        self.error_kind: str = ""
        self.error_data: Optional[dict] = None
        self.done = threading.Event()
        self.completed_times: List[float] = []   # exec seconds (speculation median)
        self.running: Dict[str, tuple] = {}      # task_id -> (worker_id, dispatch ts)
        self.speculated: set = set()
        self.dup_worker: Dict[str, str] = {}     # task_id -> speculative copy's worker
        self.dispatched_at: Dict[str, float] = {}
        self.stats_before: Dict[str, int] = {}
        self.placement_stats: Dict[str, int] = {}

    def fail(self, error: str, kind: str = "",
             data: Optional[dict] = None) -> None:
        self.error = error
        self.error_kind = kind
        self.error_data = data
        self.done.set()


class WorkerPool:
    """N local workers + scheduler-driven dispatch with failure re-queue.

    run_tasks() drives a stage to completion and is safe to call from
    CONCURRENT coordinator threads (the serving tier runs several distributed
    queries over one pool): all worker-connection I/O and scheduling run on a
    single pool-level dispatcher thread; each run_tasks call registers a
    _StageRun and waits. The shared Scheduler deals pending tasks round-robin
    across concurrent stages, re-queues tasks whose worker died (excluding
    that worker, like the reference's snapshot-based retry), and raises the
    original traceback for task-level errors.

    Failure detection (elastic fault tolerance): workers heartbeat on their
    connections; the dispatcher declares a worker DEAD on process exit,
    connection EOF, or DAFT_TPU_HEARTBEAT_TIMEOUT_S of silence (default ~= 3
    missed DAFT_TPU_HEARTBEAT_S beats — catches SIGSTOP'd/hung workers that
    neither exit nor EOF). A dead worker's in-flight tasks requeue with it
    excluded (worker_failures_total / tasks_requeued_total), and with
    DAFT_TPU_WORKER_RESPAWN > 0 the pool spawns up to that many replacements
    over its lifetime, spaced by a doubling backoff.

    Speculative re-execution (the action half of QueryTrace.straggler_report):
    once a stage has >= 2 finished tasks, a still-running task whose elapsed
    time exceeds DAFT_TPU_STRAGGLER_K x the stage's completed-task median
    (and a floor, DAFT_TPU_SPECULATIVE_MIN_S) is duplicate-dispatched to a
    different worker; the first result wins and the loser is discarded.
    DAFT_TPU_SPECULATIVE=0 disables. Shuffle map duplicates are safe because
    MapOutputWriter publishes atomically (write-temp + rename, identical
    deterministic content).
    """

    def __init__(self, num_workers: int, slots_per_worker: int = 1,
                 env: Optional[Dict[str, str]] = None,
                 max_workers: Optional[int] = None,
                 device_workers: int = 0,
                 device_mode: Optional[str] = None):
        sock = os.path.join(tempfile.gettempdir(),
                            f"daft_tpu_{os.getpid()}_{uuid.uuid4().hex[:8]}.sock")
        # HMAC-authenticated socket: only processes holding the per-pool
        # secret (passed via the child environment) can deliver pickles
        authkey = os.urandom(32)
        self._listener = Listener(sock, family="AF_UNIX", authkey=authkey)
        # every sub-plan travels to its worker as a file here, not through the
        # socket: with SF1 lineitem halves (165 MB plans) through the socket,
        # chip_smoke.py's dist phase took 27.4 s for a warm q1 on an H100, as
        # files 1.9 s (dist_timings.py times the two transports)
        self._blob_dir = tempfile.mkdtemp(prefix="daft_tpu_torch_tasks_")
        self._blob_files: Dict[str, str] = {}
        # files of finished runs that a worker may still be about to read (a
        # speculative loser's copy): unlinked when its late result arrives
        self._stale_blobs: Dict[str, str] = {}
        env = dict(env or {})
        env["DAFT_TPU_WORKER_AUTHKEY"] = authkey.hex()
        # the coordinator's execution config, handed to every worker on its
        # command line (fixed at spawn: a config change after the pool exists
        # reaches the coordinator's planning, not the spawned workers). The port's
        # ExecutionConfig reads no environment variable for most of these.
        from ..config import execution_config

        cfg = execution_config()
        self._config = {k: getattr(cfg, k) for k in WORKER_CONFIG_KEYS}
        # heartbeat cadence: coordinator (liveness timeout) and workers (beat
        # interval) must agree — mirror the effective interval into the
        # children; an explicit env entry passed by the caller wins
        hb = env_float("DAFT_TPU_HEARTBEAT_S", 2.0)
        try:
            hb = float(env.get("DAFT_TPU_HEARTBEAT_S", hb))
        except ValueError:
            pass
        env.setdefault("DAFT_TPU_HEARTBEAT_S", str(hb))
        self._hb_interval = hb
        from ..utils.sockets import DeadlineAcceptor

        acceptor = DeadlineAcceptor(self._listener)
        # kept for elastic scale-up (reference: autoscaling scheduler hook)
        self._sock = sock
        self._env = env
        self._acceptor = acceptor
        self._slots_per_worker = slots_per_worker
        # default: fixed-size pool (scale-up is an explicit opt-in via
        # max_workers > num_workers, mirroring how the reference only scales
        # when the runtime honors the scheduler's autoscaling request)
        self.max_workers = max_workers if max_workers is not None else num_workers
        self._next_worker_id = num_workers
        self.workers: Dict[str, WorkerProcess] = {}
        self.device_workers = device_workers
        leased_config = dict(self._config)
        self._budget_share = None
        if device_workers > 0 and cfg.hbm_budget_bytes >= 0:
            # the lease's residency budget: the coordinator's, split evenly
            # between the leased workers and the coordinator itself (which
            # holds its share until shutdown)
            from ..device.residency import manager as _residency

            self._budget_share = _residency().share(device_workers + 1)
            leased_config["hbm_budget_bytes"] = _residency().budget_bytes()
        for i in range(num_workers):
            wid = f"worker-{i}"
            wenv = dict(env)
            wcfg = self._config
            if i < device_workers:
                # the device lease (fixed at spawn): the coordinator's device_mode,
                # or "auto" when the coordinator's is "off"
                if device_mode is None:
                    device_mode = cfg.device_mode
                wenv["DAFT_TPU_DEVICE"] = device_mode if device_mode != "off" else "auto"
                wcfg = leased_config
            self.workers[wid] = WorkerProcess(wid, acceptor, sock, slots_per_worker,
                                              env=wenv, config=wcfg, connect=False)
        for w in self.workers.values():
            w.connect()
        # ---- dispatcher state (single thread owns scheduler + worker I/O) ----
        from .scheduler import Scheduler

        self._pool_lock = threading.RLock()
        self._sched = Scheduler({w.worker_id: w.slots
                                 for w in self.workers.values() if w.alive})
        self._runs: Dict[str, _StageRun] = {}
        self._task_route: Dict[str, _StageRun] = {}
        self._incoming: deque = deque()
        self._stage_seq = 0
        self._digest_seen: Dict[str, int] = {}
        self._dispatcher: Optional[threading.Thread] = None
        self._wake = threading.Event()
        self._closed = False
        # ---- liveness monitor + elastic respawn knobs -----------------------
        hb = self._hb_interval
        # a worker silent for this long is DEAD (default ~= 3 missed beats,
        # floored so a worker busy importing torch on its first task is never
        # declared dead by an aggressive beat interval); 0/heartbeats-off
        # disables the timeout (EOF and exit-code detection still apply)
        self._hb_timeout = env_float("DAFT_TPU_HEARTBEAT_TIMEOUT_S",
                                     max(3 * hb, 6.0))
        if hb <= 0:
            self._hb_timeout = 0.0
        # elastic respawn: replace up to this many dead workers over the
        # pool's lifetime (0 = off), spaced by a doubling backoff so a
        # crash-looping environment can't hot-spin spawns
        self._respawn_cap = env_int("DAFT_TPU_WORKER_RESPAWN", 0, lo=0)
        self._respawn_attempts = 0
        self._respawn_backoff = 0.5
        self._respawn_next_t = 0.0
        # replacements still owed (one per death, so N deaths in one pass
        # respawn N workers, budget allowing — a boolean would coalesce them)
        self._pending_respawns = 0
        # spawn-env of each dead worker awaiting replacement (device leases
        # must survive respawn; FIFO pairs deaths with replacements)
        self._respawn_envs: deque = deque()
        # death ledger: worker_id -> {ts, reason} (dashboard dead-worker
        # marking); _death_events drains into synthetic heartbeats
        self.dead_workers: Dict[str, dict] = {}
        self._death_events: deque = deque()
        # cancellation requests from client threads (ServeFuture.cancel):
        # the DISPATCHER performs the actual _fail_run/drop_stream on its
        # next pass — the scheduler has no lock of its own, so only the
        # dispatcher thread may mutate it
        self._cancel_requests: set = set()
        # recovery notes that found no traced run active when the death was
        # detected (a worker can die BETWEEN stages — the EOF surfaces on the
        # next dispatch pass): drained into the next traced run so EXPLAIN
        # ANALYZE still renders the failure its recovery responded to
        self._unattributed_recovery: List[tuple] = []
        # idle-pool liveness: the dispatcher's idle loop runs a low-rate
        # liveness check (see _idle_liveness_tick), so a worker that dies
        # while NO stage is dispatching is still detected within one
        # heartbeat timeout instead of on the next dispatch pass. Start the
        # dispatcher at construction — lazily-on-first-run_tasks would leave
        # an idle pool blind until its first query.
        self._idle_check_t = 0.0
        with self._pool_lock:
            self._ensure_dispatcher()

    def scale_up(self, n: int = 1, env: Optional[Dict[str, str]] = None,
                 config: Optional[dict] = None) -> List[str]:
        """Spawn up to n extra workers (bounded by max_workers over ALIVE
        workers, so crashed workers free headroom); returns the new worker
        ids. Spawn failures are non-fatal — the pool keeps serving with what
        it has. The local realization of the reference's autoscaling request
        path (default.rs get_autoscaling_request -> runtime scale-up)."""
        added = []
        while n > 0 and sum(1 for w in self.workers.values()
                            if w.alive) < self.max_workers:
            wid = f"worker-{self._next_worker_id}"
            self._next_worker_id += 1
            try:
                self.workers[wid] = WorkerProcess(
                    wid, self._acceptor, self._sock,
                    self._slots_per_worker,
                    env=env if env is not None else self._env,
                    config=config if config is not None else self._config)
            except Exception:  # lint: ignore[broad-except] -- a failed spawn (resource limits,
                # exactly when demand spikes) must not abort the stage the
                # existing pool can still run
                break
            added.append(wid)
            n -= 1
        return added

    def run_tasks(self, tasks: List[SubPlanTask], stage_id: str = "",
                  trace=None) -> Dict[str, TaskResult]:
        """Drive one stage of tasks to completion (concurrent-caller safe).

        When `trace` (a distributed.trace.QueryTrace) is given, every task is
        stamped with the query's trace context at dispatch (trace id + parent
        span id, the otlp.py scheme) and asked to collect stats; finished
        tasks are recorded into the trace with coordinator-side queue-wait/dispatch
        timing joined to the worker-side execution record.
        """
        now = time.time()
        for t in tasks:
            if stage_id and not t.stage_id:
                t.stage_id = stage_id
            if trace is not None:
                t.collect_stats = True
                t.trace_id = trace.trace_id
                t.parent_span_id = trace.root_span_id
            t.submitted_at = now
        with self._pool_lock:
            if self._closed:
                raise RuntimeError("worker pool is shut down")
            self._stage_seq += 1
            key = f"{stage_id or 'stage'}#{self._stage_seq}"
            run = _StageRun(key, tasks, stage_id or "stage", trace)
            self._incoming.append(run)
            self._ensure_dispatcher()
        self._wake.set()
        # the calling thread's cancellation token (serving ServeFuture.cancel
        # installs one; bare runner threads have none): checked while waiting
        # so a cancelled query's stage stops consuming the pool — its pending
        # stream is dropped (best-effort Scheduler.drop_stream; tasks already
        # on workers finish and their results are discarded)
        from ..cancellation import QueryCancelled, cancel_event

        cancel_ev = cancel_event()
        while not run.done.wait(timeout=0.5):
            if cancel_ev is not None and cancel_ev.is_set():
                self._cancel_run(run)
            with self._pool_lock:
                alive = (self._dispatcher is not None
                         and self._dispatcher.is_alive())
            if not alive and not run.done.is_set():
                raise RuntimeError("worker pool dispatcher died")
        if run.error_kind == "cancelled":
            raise QueryCancelled(run.error or "query cancelled")
        if run.error is not None:
            # re-raise recoverable failure classes TYPED so the planner's
            # recovery loop can regenerate lost shuffle maps (worker.py
            # _classify_error is the other end of this contract)
            if run.error_kind == "shuffle_data_lost" and run.error_data:
                from .shuffle import ShuffleDataLost

                raise ShuffleDataLost(
                    run.error_data.get("shuffle_id", ""),
                    run.error_data.get("map_ids", ()), run.error)
            if run.error_kind == "shuffle_peer_unreachable" and run.error_data:
                from .shuffle import ShufflePeerUnreachable

                raise ShufflePeerUnreachable(
                    run.error_data.get("shuffle_id", ""), run.error)
            raise RuntimeError(run.error)
        if trace is not None:
            trace.note_placement(run.stage_id, run.placement_stats)
        return dict(run.results)

    # ---- dispatcher ---------------------------------------------------------------
    def _ensure_dispatcher(self) -> None:
        """Start the dispatcher lazily (pool lock held by caller)."""
        if self._dispatcher is None or not self._dispatcher.is_alive():
            self._dispatcher = threading.Thread(
                target=self._dispatch_loop, daemon=True, name="daft-dispatch")
            self._dispatcher.start()

    def _dispatch_loop(self) -> None:
        import traceback as _tb

        try:
            while True:
                with self._pool_lock:
                    if self._closed:
                        return
                    has_work = bool(self._runs or self._incoming)
                if not has_work:
                    self._wake.wait(0.05)
                    self._wake.clear()
                    self._idle_liveness_tick()
                    continue
                self._dispatch_pass()
        except Exception as e:  # noqa: BLE001 — a dispatcher crash must fail callers loudly
            err = (f"pool dispatcher crashed: {type(e).__name__}: {e}\n"
                   f"{_tb.format_exc()}")
            with self._pool_lock:
                runs = list(self._runs.values()) + list(self._incoming)
                self._runs.clear()
                self._incoming.clear()
                self._task_route.clear()
            for r in runs:
                r.fail(err)

    def _register_incoming(self) -> None:
        while True:
            with self._pool_lock:
                if not self._incoming:
                    return
                run = self._incoming.popleft()
            # seed residency digests from the latest heartbeats so this
            # stage's FIRST scheduling pass is already cache-affinity aware
            for w in list(self.workers.values()):
                if w.alive and w.failed_reason is None:
                    w.pump()
                    if self._digest_seen.get(w.worker_id) != w.digest_seq:
                        self._sched.update_residency(w.worker_id, w.last_digest)
                        self._digest_seen[w.worker_id] = w.digest_seq
            # sync scheduler membership with the pool (workers added by an
            # external scale_up() between stages must become schedulable)
            known = {s.worker_id for s in self._sched.snapshots()}
            for w in self.workers.values():
                if w.alive and w.failed_reason is None \
                        and w.worker_id not in known:
                    self._sched.add_worker(w.worker_id, w.slots)
            run.stats_before = self._sched.placement_stats()
            self._runs[run.key] = run
            if run.trace is not None and self._unattributed_recovery:
                # deaths detected while no traced run was active land on the
                # next traced run's report (see _note_worker_death)
                for key, n in self._unattributed_recovery:
                    run.trace.note_recovery(key, n)
                self._unattributed_recovery.clear()
            for t in run.tasks.values():
                self._task_route[t.task_id] = run
                self._sched.submit(t, stream_key=run.key)

    def _requeue_elsewhere(self, w: WorkerProcess, task: SubPlanTask,
                           run: _StageRun) -> None:
        clone = SubPlanTask(
            task_id=task.task_id, plan_blob=task.plan_blob,
            strategy=task.strategy, priority=task.priority,
            excluded_workers=task.excluded_workers + (w.worker_id,),
            stage_id=task.stage_id, trace_id=task.trace_id,
            parent_span_id=task.parent_span_id,
            collect_stats=task.collect_stats,
            # keep the FIRST submit time: a retry's queue wait includes
            # the failed attempt's scheduling delay
            submitted_at=task.submitted_at,
            rfingerprint=task.rfingerprint, blob_path=task.blob_path)
        run.tasks[task.task_id] = clone
        run.running.pop(task.task_id, None)
        run.speculated.discard(task.task_id)
        run.dup_worker.pop(task.task_id, None)
        registry().inc("tasks_requeued_total")
        self._sched.submit(clone, stream_key=run.key)

    def _spill_blob(self, task: SubPlanTask) -> SubPlanTask:
        """``task`` as it goes to its worker: its plan written once to the
        pool's task directory (a requeue or a speculative copy reuses the
        file) and sent as the file's path."""
        import dataclasses

        path = self._blob_files.get(task.task_id)
        if path is None:
            path = os.path.join(self._blob_dir, f"{uuid.uuid4().hex}.plan")
            tmp = f"{path}.tmp"
            with open(tmp, "wb") as f:
                f.write(task.plan_blob)
            os.replace(tmp, path)
            self._blob_files[task.task_id] = path
        return dataclasses.replace(task, plan_blob=b"", blob_path=path)

    def _drop_blobs(self, run: _StageRun) -> None:
        """Unlink the plan files of a finished or failed run; a file whose
        task a worker still holds waits in ``_stale_blobs`` for that
        worker's late result."""
        held = {tid for w in list(self.workers.values()) for tid in w.inflight}
        for tid in run.expected:
            path = self._blob_files.pop(tid, None)
            if path is None:
                continue
            if tid in held:
                self._stale_blobs[tid] = path
            else:
                _unlink(path)

    def _finish_run(self, run: _StageRun) -> None:
        self._drop_blobs(run)
        now = self._sched.placement_stats()
        run.placement_stats = {
            k: now.get(k, 0) - run.stats_before.get(k, 0) for k in now}
        with self._pool_lock:
            self._runs.pop(run.key, None)
            for tid in run.expected:
                self._task_route.pop(tid, None)
        run.done.set()

    def _cancel_run(self, run: _StageRun) -> None:
        """Best-effort mid-stage cancellation (ServeFuture.cancel while the
        stage runs), called from the CLIENT thread: park a request for the
        dispatcher, which drops the run's pending stream and fails it on its
        next pass — in-flight tasks complete on their workers and their late
        results are dropped by the routing table. The scheduler is only ever
        touched by the dispatcher thread (it has no lock; a client-side
        drop_stream racing the dispatcher's own _fail_run corrupted the
        stream rotation)."""
        with self._pool_lock:
            if run.key in self._runs:
                self._cancel_requests.add(run.key)
        self._wake.set()

    def _fail_run(self, run: _StageRun, error: str, kind: str = "",
                  data: Optional[dict] = None) -> None:
        self._drop_blobs(run)
        self._sched.drop_stream(run.key)
        with self._pool_lock:
            self._runs.pop(run.key, None)
            for tid in run.expected:
                self._task_route.pop(tid, None)
        run.fail(error, kind, data)

    def _dispatch_pass(self) -> None:
        sched = self._sched
        self._register_incoming()
        # client-thread cancellations parked by _cancel_run: performed here
        # so every scheduler mutation stays on this thread
        with self._pool_lock:
            cancelled = [self._runs[k] for k in self._cancel_requests
                         if k in self._runs]
            self._cancel_requests.clear()
        for run in cancelled:
            self._fail_run(run, "query cancelled", kind="cancelled")
        # elastic scale-up: when queued demand exceeds capacity by the
        # autoscaling threshold, grow the pool toward max_workers — ONE
        # worker per dispatch pass, so result polling of busy workers is
        # never starved behind a burst of blocking spawns
        if sched.needs_autoscaling():
            for wid in self.scale_up(1):
                sched.add_worker(wid, self._slots_per_worker)
        assignments = sched.schedule()
        for task, wid in assignments:
            w = self.workers.get(wid)
            run = self._task_route.get(task.task_id)
            if w is None or run is None:
                # worker vanished between snapshot and submit, or the run
                # was failed/abandoned: give the slot back
                sched.task_finished(wid)
                continue
            try:
                w.submit(self._spill_blob(task))
            except (BrokenPipeError, OSError):
                w.inflight.pop(task.task_id, None)
                sched.remove_worker(wid)
                self._requeue_elsewhere(w, task, run)
                continue
            now = time.time()
            if (task.task_id in run.running
                    or task.task_id in run.results):
                # second concurrent attempt = the speculative copy
                run.dup_worker[task.task_id] = wid
            else:
                run.running[task.task_id] = (wid, now)
                run.dispatched_at.setdefault(task.task_id, now)
        progressed = bool(assignments)
        for w in list(self.workers.values()):
            res = w.poll(timeout=0.005)
            # heartbeats may have arrived during the poll: refresh this
            # worker's residency digest for the next scheduling pass —
            # but only when it actually changed (seq check), not a dict
            # copy per worker per 5ms dispatch iteration
            if self._digest_seen.get(w.worker_id) != w.digest_seq:
                sched.update_residency(w.worker_id, w.last_digest)
                self._digest_seen[w.worker_id] = w.digest_seq
            if res is not None:
                progressed = True
                sched.task_finished(res.worker_id)
                run = self._task_route.get(res.task_id)
                if run is not None:
                    self._route_result(run, res)
                elif res.task_id in self._stale_blobs:
                    _unlink(self._stale_blobs.pop(res.task_id))
            # ---- liveness monitor: ACT on missing heartbeats ----------------
            # the poll above just drained whatever the connection held, so a
            # stale last_beat here is real silence, not an undrained buffer.
            # A SIGSTOP'd/hung worker never EOFs and never exits — the beat
            # timeout is the only detector that catches it.
            if w.alive and w.failed_reason is None:
                if w.conn_dead:
                    w.mark_failed("connection closed")
                elif (self._hb_timeout > 0
                        and time.time() - w.last_beat > self._hb_timeout):
                    w.mark_failed(
                        f"no heartbeat for {self._hb_timeout:.1f}s "
                        f"(interval {self._hb_interval:.1f}s)")
            if not w.alive or w.failed_reason is not None:
                # worker died: re-queue its tasks elsewhere and DROP the
                # entry (leaving it would leak its fd and pay a poll
                # error every loop; scale_up counts alive workers so the
                # slot frees for a replacement)
                if self._note_worker_death(w):
                    progressed = True
                if not any(ww.alive and ww.failed_reason is None
                           for ww in self.workers.values()):
                    # last worker gone: an immediate respawn (cap allowing)
                    # is the only alternative to failing every run
                    self._maybe_respawn(force=True)
                    if not self.workers:
                        for run in list(self._runs.values()):
                            self._fail_run(run, "all workers died")
                        return
        self._maybe_speculate()
        if self._pending_respawns > 0:
            self._maybe_respawn()
        respawn_pending = (self._pending_respawns > 0
                           and self._respawn_attempts < self._respawn_cap)
        if not progressed and sched.pending_count() and not respawn_pending \
                and not any(w.inflight for w in self.workers.values()):
            # nothing running, nothing newly assignable -> unschedulable;
            # fail every run that still has unfinished tasks
            for run in list(self._runs.values()):
                if len(run.results) < len(run.expected):
                    self._fail_run(
                        run, f"{sched.pending_count()} tasks unschedulable "
                             f"(no eligible workers)")

    def _idle_liveness_tick(self) -> None:
        """Low-rate liveness check for an IDLE pool (dispatcher thread, no
        dispatch pass running). The _dispatch_pass liveness monitor only runs
        while stages are in flight, so without this an idle pool never
        noticed a kill -9'd worker — the dashboard's dead-worker marking and
        the respawn path both waited for the next query. Same detection as
        the dispatch-pass block: pump() first so a stale last_beat is real
        silence, then connection-EOF / process-exit / heartbeat-timeout."""
        if self._hb_timeout > 0:
            interval = max(min(self._hb_timeout / 3.0, 2.0), 0.1)
        else:
            interval = 1.0  # EOF/exit detection still applies with beats off
        now = time.time()
        if now - self._idle_check_t < interval:
            return
        self._idle_check_t = now
        for w in list(self.workers.values()):
            if not (w.alive and w.failed_reason is None):
                self._note_worker_death(w)
                continue
            w.pump()
            if w.conn_dead:
                w.mark_failed("connection closed")
            elif (self._hb_timeout > 0
                    and time.time() - w.last_beat > self._hb_timeout):
                w.mark_failed(
                    f"no heartbeat for {self._hb_timeout:.1f}s "
                    f"(interval {self._hb_interval:.1f}s)")
            if not w.alive or w.failed_reason is not None:
                self._note_worker_death(w)
        if self._pending_respawns > 0:
            self._maybe_respawn()

    def _note_worker_death(self, w: WorkerProcess) -> bool:
        """Handle one dead worker: counters + death ledger, requeue its
        in-flight tasks (excluding it), drop it from scheduler and pool, and
        arm a respawn. Returns True when tasks were requeued (dispatch
        progress)."""
        now = time.time()
        rc = w._proc.poll()
        reason = w.failed_reason or f"process exited (code {rc})"
        registry().inc("worker_failures_total")
        from ..observability import flight as _flight

        frec = _flight.recorder()
        if frec is not None:
            frec.note_worker_death(w.worker_id, reason)
        self.dead_workers[w.worker_id] = {"ts": now, "reason": reason}
        self._death_events.append(
            {"worker_id": w.worker_id, "ts": now, "reason": reason})
        self._sched.remove_worker(w.worker_id)
        progressed = False
        requeued = 0
        if w.inflight:
            for t in list(w.inflight.values()):
                run = self._task_route.get(t.task_id)
                if run is None or t.task_id in run.results:
                    continue  # result already won elsewhere
                self._requeue_elsewhere(w, t, run)
                requeued += 1
                if run.trace is not None:
                    run.trace.note_recovery("tasks_requeued", 1)
            w.inflight.clear()
            progressed = requeued > 0
        # the failure is an event of the QUERIES sharing this pool: note it
        # once per distinct active trace so EXPLAIN ANALYZE can render
        # "recovery: N worker failures, ..."
        seen_traces = set()
        for run in self._runs.values():
            tr = run.trace
            if tr is not None and id(tr) not in seen_traces:
                seen_traces.add(id(tr))
                tr.note_recovery("worker_failures", 1)
        if not seen_traces:
            # no traced run was active at detection time (death between
            # stages): park the note for the next traced run's report
            self._unattributed_recovery.append(("worker_failures", 1))
        w.stop()
        self.workers.pop(w.worker_id, None)
        if self._respawn_cap > 0:
            self._pending_respawns += 1
            # the replacement inherits the dead worker's spawn env (device
            # lease above all) so recovery restores capability, not just count
            self._respawn_envs.append((dict(w.spawn_env), dict(w.spawn_config)))
        return progressed

    def _maybe_respawn(self, force: bool = False) -> None:
        """Spawn a replacement for a dead worker, bounded by
        DAFT_TPU_WORKER_RESPAWN total attempts with a doubling backoff
        between them (force=True skips the backoff wait — the all-workers-
        dead case where the alternative is failing every run)."""
        if self._respawn_cap <= 0 or self._respawn_attempts >= self._respawn_cap:
            self._pending_respawns = 0
            self._respawn_envs.clear()
            return
        alive = sum(1 for w in self.workers.values()
                    if w.alive and w.failed_reason is None)
        if alive >= self.max_workers:
            # capacity already restored — queue-pressure autoscaling raced
            # the respawn for the dead worker's freed headroom. The pool is
            # whole again; a no-op scale_up here would silently burn a
            # capped attempt.
            self._pending_respawns = 0
            self._respawn_envs.clear()
            return
        now = time.time()
        if not force and now < self._respawn_next_t:
            return  # backoff window; retried on a later pass
        self._respawn_attempts += 1
        self._respawn_next_t = now + self._respawn_backoff
        self._respawn_backoff = min(self._respawn_backoff * 2, 30.0)
        env, config = self._respawn_envs.popleft() if self._respawn_envs else (None, None)
        added = self.scale_up(1, env=env, config=config)
        for wid in added:
            self._sched.add_worker(wid, self._slots_per_worker)
            registry().inc("worker_respawns_total")
        if added:
            self._pending_respawns = max(0, self._pending_respawns - 1)

    def _route_result(self, run: _StageRun, res: TaskResult) -> None:
        if res.task_id in run.results:
            return  # speculative loser (or duplicate retry): first result won
        if res.error is not None:
            # a failed SPECULATIVE copy must never fail a stage the original
            # attempt can still win — speculation may only mask stragglers,
            # not introduce failures
            if (res.task_id in run.speculated
                    and res.worker_id == run.dup_worker.get(res.task_id)):
                run.dup_worker.pop(res.task_id, None)
                run.speculated.discard(res.task_id)
                return
            self._fail_run(
                run,
                f"task {res.task_id} failed on {res.worker_id}:\n{res.error_tb}",
                res.error_kind, res.error_data)
            return
        run.results[res.task_id] = res
        run.running.pop(res.task_id, None)
        run.completed_times.append(res.exec_seconds or 0.0)
        if (res.task_id in run.speculated
                and res.worker_id == run.dup_worker.get(res.task_id)):
            registry().inc("sched_speculative_wins")
        if run.trace is not None and res.task_id in run.tasks:
            run.trace.record_task(run.tasks[res.task_id], res,
                                  run.dispatched_at.get(res.task_id, 0.0))
        if len(run.results) == len(run.expected):
            self._finish_run(run)

    def _maybe_speculate(self) -> None:
        """Duplicate-dispatch running stragglers (first result wins). A task
        qualifies once its stage has >= 2 completed tasks and its elapsed
        time exceeds straggler_threshold() x the completed median and the
        DAFT_TPU_SPECULATIVE_MIN_S floor (default 0.25s — trivial tasks are
        never worth a duplicate)."""
        if not env_bool("DAFT_TPU_SPECULATIVE", True):
            return
        import statistics

        from .trace import straggler_threshold

        floor = env_float("DAFT_TPU_SPECULATIVE_MIN_S", 0.25)
        k = straggler_threshold()
        now = time.time()
        for run in list(self._runs.values()):
            if len(run.completed_times) < 2 or not run.running:
                continue
            med = statistics.median(run.completed_times)
            cutoff = max(k * med, floor)
            for task_id, (wid, t0) in list(run.running.items()):
                if task_id in run.speculated or task_id in run.results:
                    continue
                if now - t0 <= cutoff:
                    continue
                task = run.tasks.get(task_id)
                if task is None:
                    continue
                excluded = task.excluded_workers + (wid,)
                if not any(w.alive and w.worker_id not in excluded
                           for w in self.workers.values()):
                    continue  # nowhere else to run the duplicate
                clone = SubPlanTask(
                    task_id=task.task_id, plan_blob=task.plan_blob,
                    strategy=task.strategy, priority=task.priority,
                    excluded_workers=excluded,
                    stage_id=task.stage_id, trace_id=task.trace_id,
                    parent_span_id=task.parent_span_id,
                    collect_stats=task.collect_stats,
                    submitted_at=task.submitted_at,
                    rfingerprint=task.rfingerprint, blob_path=task.blob_path)
                run.speculated.add(task_id)
                self._sched.submit(clone, stream_key=run.key)
                registry().inc("sched_speculative_dispatches")

    def drain_heartbeats(self, preserve_deaths: bool = False) -> List[dict]:
        """Collect heartbeats received from every live worker since the last
        drain (the runner forwards them to subscribers / the dashboard).
        Task results encountered while draining are preserved for poll().
        Worker deaths since the last drain are appended as synthetic final
        beats carrying dead=True + the failure reason, so the dashboard MARKS
        dead workers instead of silently letting them go stale.
        preserve_deaths=True empties only the worker pipes and leaves queued
        death events for the next full drain — the runner's start-of-query
        DISCARD drain must not swallow the one-shot dead=True records the
        dashboard's latch depends on."""
        out: List[dict] = []
        # snapshot: the dispatcher thread pops dead workers / inserts
        # respawns concurrently with this (runner-thread) drain
        for w in list(self.workers.values()):
            out.extend(w.drain_heartbeats())
        if preserve_deaths:
            out.sort(key=lambda h: h.get("ts", 0.0))
            return out
        while self._death_events:
            try:
                ev = self._death_events.popleft()
            except IndexError:
                break
            out.append({"worker_id": ev["worker_id"], "ts": ev["ts"],
                        "recv_ts": ev["ts"], "busy_slots": 0,
                        "total_slots": 0, "tasks_completed": 0,
                        "tasks_failed": 0, "rss_bytes": 0, "uptime_s": 0.0,
                        "dead": True, "death_reason": ev["reason"]})
        out.sort(key=lambda h: h.get("ts", 0.0))
        return out

    def latest_heartbeats(self) -> Dict[str, dict]:
        """worker_id -> most recent heartbeat payload for every live worker
        that has ever beaten. The runner's end-of-query window filter can
        come up empty for a query faster than one heartbeat period; these
        survive that filter so the dashboard still sees the whole pool."""
        return {w.worker_id: w.last_hb
                for w in list(self.workers.values()) if w.last_hb is not None}

    def shutdown(self) -> None:
        with self._pool_lock:
            self._closed = True
            dispatcher = self._dispatcher
            runs = list(self._runs.values()) + list(self._incoming)
            self._runs.clear()
            self._incoming.clear()
            self._task_route.clear()
        self._wake.set()
        if dispatcher is not None and dispatcher.is_alive():
            dispatcher.join(timeout=2.0)
        for r in runs:
            r.fail("worker pool shut down mid-stage")
        for w in self.workers.values():
            w.stop()
        self.workers.clear()
        try:
            self._listener.close()
        except OSError:
            pass
        import shutil

        shutil.rmtree(self._blob_dir, ignore_errors=True)
        if self._budget_share is not None:
            from ..device.residency import manager as _residency

            _residency().unshare(self._budget_share)
            self._budget_share = None


if __name__ == "__main__":
    main(sys.argv[1:])
