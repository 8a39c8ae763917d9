"""The query trace: per-stage task stats, shuffle volume, worker heartbeats,
and the Chrome trace-event export (counterpart of
daft_tpu/distributed/trace.py, the class as plain Python).

A DistributedRunner's traced query fills one: the worker pool records each
finished task (``record_task``: its stats, shuffle volume, spans and engine
counters from the TaskResult), the runner adds the workers' heartbeats, the
pool notes placement and recovery totals. ``explain_analyze`` renders it
under "Distributed Stages". With the native runner,
``explain_analyze(profile=...)`` builds an empty trace for the
coordinator's lanes (its operators, their stall slices, and the engine's
device, scan and spill spans) and renders it with ``to_chrome_trace``.
"""

from __future__ import annotations

import statistics
import threading
import time
from typing import Dict, List, Optional

from ..observability.events import ShuffleStats, TaskStats, WorkerHeartbeat
from ..observability.metrics import registry
from ..observability.otlp import _span_id, _trace_id
from ..utils.env import env_float as _env_float

# straggler detection threshold: a task is flagged when its exec time exceeds
# k x its stage's median (the detection half of speculative re-execution)
_DEFAULT_STRAGGLER_K = 2.0


def straggler_threshold() -> float:
    return _env_float("DAFT_TPU_STRAGGLER_K", _DEFAULT_STRAGGLER_K)


# Worker engine counters mirrored into the coordinator registry per finished task
# (device-path + batching attribution; shuffle volume arrives via
# result.shuffle, hbm gauges stay per-process).
_MIRRORED_ENGINE_COUNTERS = (
    "device_stage_batches", "device_grouped_batches", "device_stage_runs",
    "device_join_batches", "device_topn_runs", "mesh_grouped_runs",
    "dispatch_coalesced", "coalesce_morsels_in", "bucket_fill_rows",
    "bucket_capacity_rows", "morsel_resize",
)


class QueryTrace:
    """Accumulates one distributed query's task/shuffle/heartbeat records.

    Thread-safe: the pool's dispatch loop appends while the coordinator thread may
    concurrently render (explain_analyze on a partially-streamed query).
    """

    def __init__(self, query_id: str):
        self.query_id = query_id
        self.trace_id = _trace_id(query_id) if query_id else ""
        self.root_span_id = _span_id(query_id, "query") if query_id else ""
        self.started_wall = time.time()   # trace epoch for the timeline export
        self._lock = threading.Lock()
        self.tasks: List[TaskStats] = []
        self.heartbeats: List[WorkerHeartbeat] = []
        # task_id -> worker-clock timeline spans shipped in the TaskResult
        # (kept off TaskStats so event-log task records stay flat/grep-able)
        self.task_spans: Dict[str, List[dict]] = {}
        # stage_id -> accumulated shuffle dict (insertion-ordered)
        self._shuffle: Dict[str, dict] = {}
        self._stage_order: List[str] = []
        # stage_id -> scheduler placement totals (affinity hits/misses,
        # bytes avoided, head-of-line skips) — see Scheduler.placement_stats
        self._placement: Dict[str, Dict[str, int]] = {}
        # fault-recovery totals for this query (worker_failures,
        # tasks_requeued, maps_regenerated) — the pool's liveness monitor and
        # the planner's regeneration loop note into these; EXPLAIN ANALYZE
        # renders the "recovery:" line when any is nonzero
        self._recovery: Dict[str, int] = {}

    # ---- recording (called by WorkerPool.run_tasks) ------------------------------
    def record_task(self, task, result, dispatched_at: float) -> None:
        """One successfully finished task: join coordinator-side queueing times with
        the worker-side execution record shipped in the TaskResult."""
        queue_wait = max(dispatched_at - task.submitted_at, 0.0) \
            if task.submitted_at else 0.0
        sched_lat = max(result.started_at - dispatched_at, 0.0) \
            if result.started_at else 0.0
        ts = TaskStats(
            stage_id=task.stage_id or "stage",
            task_id=task.task_id,
            worker_id=result.worker_id,
            queue_wait_s=queue_wait,
            schedule_latency_s=sched_lat,
            exec_s=result.exec_seconds,
            rows_out=result.rows,
            bytes_out=result.bytes_out,
            retries=len(task.excluded_workers),
            started_at=result.started_at,
            trace_id=task.trace_id,
            span_id=result.span_id,
            parent_span_id=task.parent_span_id,
            operator_stats=tuple(result.op_stats),
            engine_counters=tuple(sorted((result.engine_counters or {}).items())),
        )
        with self._lock:
            self.tasks.append(ts)
            if result.spans:
                self.task_spans[ts.task_id] = list(result.spans)
            if ts.stage_id not in self._shuffle:
                self._shuffle[ts.stage_id] = {}
                self._stage_order.append(ts.stage_id)
            if result.shuffle:
                acc = self._shuffle[ts.stage_id]
                for k, v in result.shuffle.items():
                    if k == "fetch_fanin":
                        # a max across tasks, not a volume — summing would
                        # report nonsense parallelism
                        acc[k] = max(acc.get(k, 0), v)
                    else:
                        acc[k] = acc.get(k, 0) + v
        if result.shuffle:
            # mirror into the coordinator's registry so the per-query metrics diff
            # (QueryEnd.metrics, bench snapshot) carries cluster-wide volume
            for k in ("bytes_written", "rows_written", "bytes_fetched",
                      "rows_fetched"):
                v = result.shuffle.get(k, 0)
                if v:
                    registry().inc(f"shuffle_{k}", int(v))
            # wire/logical + overlap attribution (workers count these in
            # THEIR registries; re-home them so the coordinator-side per-query
            # diff can assert compression ratio and transfer overlap)
            for src, dst in (("bytes_written", "shuffle_logical_bytes"),
                             ("wire_bytes_written", "shuffle_wire_bytes")):
                v = result.shuffle.get(src, 0)
                if v:
                    registry().inc(dst, int(v))
            for src, dst in (("fetch_seconds", "shuffle_fetch_seconds"),
                             ("fetch_wall_seconds", "shuffle_fetch_wall_seconds"),
                             ("overlap_seconds", "shuffle_overlap_seconds")):
                v = result.shuffle.get(src, 0.0)
                if v:
                    registry().inc(dst, float(v))
        if result.engine_counters:
            # device-path attribution crosses the process boundary the same
            # way: a device-leased worker's dispatches/coalescing land in the
            # coordinator's per-query diff (distributed EXPLAIN ANALYZE engine
            # counters, QueryEnd.metrics, bench snapshot). Curated list —
            # shuffle counters are mirrored above from result.shuffle, and
            # gauges don't sum across processes.
            for k in _MIRRORED_ENGINE_COUNTERS:
                v = result.engine_counters.get(k, 0)
                if v:
                    registry().inc(k, int(v))

    def add_heartbeat(self, hb: dict) -> None:
        rec = WorkerHeartbeat(
            worker_id=hb.get("worker_id", "?"),
            ts=hb.get("ts", 0.0),
            busy_slots=hb.get("busy_slots", 0),
            total_slots=hb.get("total_slots", 1),
            tasks_completed=hb.get("tasks_completed", 0),
            tasks_failed=hb.get("tasks_failed", 0),
            rss_bytes=hb.get("rss_bytes", 0),
            uptime_s=hb.get("uptime_s", 0.0),
            hbm_bytes=hb.get("hbm_bytes_resident", 0),
            hbm_h2d_bytes=hb.get("hbm_h2d_bytes", 0),
            hbm_digest_entries=len(hb.get("hbm_digest") or ()),
            recv_ts=hb.get("recv_ts", 0.0),
            dead=bool(hb.get("dead", False)),
            death_reason=hb.get("death_reason", ""),
        )
        with self._lock:
            self.heartbeats.append(rec)

    def clock_offsets(self) -> Dict[str, float]:
        """Per-worker clock offset estimate (coordinator = worker + offset).

        Cristian-style one-way bound from heartbeat round trips: every beat
        gives recv_ts(coordinator) - ts(worker) = true offset + transit; the MIN
        over a query's beats is the tightest bound (transit >= 0). On
        same-host workers (shared clock) this converges to the send/recv
        latency, typically sub-millisecond. Workers without beats map to 0.
        """
        with self._lock:
            hbs = list(self.heartbeats)
        out: Dict[str, float] = {}
        for hb in hbs:
            if hb.ts <= 0 or hb.recv_ts <= 0:
                continue
            d = hb.recv_ts - hb.ts
            if hb.worker_id not in out or d < out[hb.worker_id]:
                out[hb.worker_id] = d
        return out

    def note_placement(self, stage_id: str, stats: Dict[str, int]) -> None:
        """Record one stage's scheduler placement totals (called by the pool
        when the stage drains)."""
        with self._lock:
            self._placement[stage_id] = dict(stats)

    def note_recovery(self, key: str, n: int = 1) -> None:
        """Accumulate one fault-recovery event (worker_failures /
        tasks_requeued / maps_regenerated) into this query's totals."""
        with self._lock:
            self._recovery[key] = self._recovery.get(key, 0) + n

    def recovery_totals(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._recovery)

    # ---- aggregation -------------------------------------------------------------
    def shuffle_stats(self) -> List[ShuffleStats]:
        with self._lock:
            out = []
            for sid in self._stage_order:
                acc = self._shuffle[sid]
                if not acc:
                    continue
                out.append(ShuffleStats(
                    stage_id=sid,
                    bytes_written=int(acc.get("bytes_written", 0)),
                    rows_written=int(acc.get("rows_written", 0)),
                    partitions_written=int(acc.get("partitions_written", 0)),
                    bytes_fetched=int(acc.get("bytes_fetched", 0)),
                    rows_fetched=int(acc.get("rows_fetched", 0)),
                    fetch_seconds=float(acc.get("fetch_seconds", 0.0)),
                    fetch_requests=int(acc.get("fetch_requests", 0)),
                    wire_bytes_written=int(acc.get("wire_bytes_written", 0)),
                    fetch_wall_seconds=float(acc.get("fetch_wall_seconds", 0.0)),
                    overlap_seconds=float(acc.get("overlap_seconds", 0.0)),
                    fetch_fanin=int(acc.get("fetch_fanin", 0)),
                ))
            return out

    def stage_summaries(self) -> List[dict]:
        """Per-stage rollup in execution order: task count, exec-time skew
        (min/median/max), rows, queue wait, shuffle volume."""
        with self._lock:
            by_stage: Dict[str, List[TaskStats]] = {}
            for t in self.tasks:
                by_stage.setdefault(t.stage_id, []).append(t)
            order = list(self._stage_order)
            shuffle = {k: dict(v) for k, v in self._shuffle.items()}
            placement = {k: dict(v) for k, v in self._placement.items()}
        out = []
        for sid in order:
            tasks = by_stage.get(sid, [])
            if not tasks:
                continue
            times = sorted(t.exec_s for t in tasks)
            sh = shuffle.get(sid, {})
            pl = placement.get(sid, {})
            out.append({
                "affinity_hits": int(pl.get("affinity_hits", 0)),
                "affinity_misses": int(pl.get("affinity_misses", 0)),
                "sched_bytes_avoided": int(pl.get("bytes_avoided", 0)),
                "stage_id": sid,
                "tasks": len(tasks),
                "workers": len({t.worker_id for t in tasks}),
                "retries": sum(t.retries for t in tasks),
                "rows_out": sum(t.rows_out for t in tasks),
                "bytes_out": sum(t.bytes_out for t in tasks),
                "queue_wait_s": sum(t.queue_wait_s for t in tasks),
                "min_s": times[0],
                "median_s": statistics.median(times),
                "max_s": times[-1],
                "shuffle_bytes_written": int(sh.get("bytes_written", 0)),
                "shuffle_bytes_fetched": int(sh.get("bytes_fetched", 0)),
                "shuffle_wire_bytes": int(sh.get("wire_bytes_written", 0)),
                "shuffle_fetch_cum_s": float(sh.get("fetch_seconds", 0.0)),
                "shuffle_fetch_wall_s": float(sh.get("fetch_wall_seconds", 0.0)),
                "shuffle_overlap_s": float(sh.get("overlap_seconds", 0.0)),
                "shuffle_fetch_fanin": int(sh.get("fetch_fanin", 0)),
            })
        return out

    def worker_summary(self) -> List[dict]:
        with self._lock:
            tasks = list(self.tasks)
            hbs = list(self.heartbeats)
        by_worker: Dict[str, dict] = {}
        for t in tasks:
            w = by_worker.setdefault(t.worker_id,
                                     {"tasks": 0, "exec_s": 0.0, "rows": 0})
            w["tasks"] += 1
            w["exec_s"] += t.exec_s
            w["rows"] += t.rows_out
        for hb in hbs:
            w = by_worker.setdefault(hb.worker_id,
                                     {"tasks": 0, "exec_s": 0.0, "rows": 0})
            w["rss_bytes"] = hb.rss_bytes      # latest wins (list is in order)
            w["heartbeats"] = w.get("heartbeats", 0) + 1
        return [{"worker_id": k, **v} for k, v in sorted(by_worker.items())]

    def straggler_report(self, threshold: Optional[float] = None) -> List[dict]:
        """Tasks whose exec time exceeded `threshold` x their stage median —
        the detection half of speculative re-execution (the scheduler can act
        on exactly this list). Stages need >= 2 tasks for a meaningful
        median; threshold defaults from DAFT_TPU_STRAGGLER_K (2.0)."""
        k = threshold if threshold is not None else straggler_threshold()
        with self._lock:
            by_stage: Dict[str, List[TaskStats]] = {}
            for t in self.tasks:
                by_stage.setdefault(t.stage_id, []).append(t)
        out = []
        for sid, tasks in by_stage.items():
            if len(tasks) < 2:
                continue
            med = statistics.median(t.exec_s for t in tasks)
            if med <= 1e-9:
                continue
            for t in tasks:
                if t.exec_s > k * med:
                    out.append({
                        "stage_id": sid, "task_id": t.task_id,
                        "worker_id": t.worker_id, "exec_s": t.exec_s,
                        "median_s": med, "ratio": t.exec_s / med,
                    })
        out.sort(key=lambda r: -r["ratio"])
        return out

    # ---- timeline export ---------------------------------------------------------
    def to_chrome_trace(self, coordinator_ops=None, coordinator_spans=None,
                        total_seconds: Optional[float] = None) -> dict:
        """The query as Chrome trace-event JSON (open in Perfetto / chrome://
        tracing): coordinator lane (query + stage windows + operator slices) and
        one process per worker with a task lane, an operator lane, and a
        device/io lane of REAL wall-clock spans (dispatch, h2d/d2h, coalescer
        flushes, shuffle fetches). Worker timestamps are re-aligned onto the
        coordinator clock via heartbeat-estimated offsets (clock_offsets).

        Operator slices have no per-batch timestamps by design (recording
        them would tax the hot path), so each lane lays its operators out
        SEQUENTIALLY from the lane's start — slice WIDTH is the attributed
        self time, position within the lane is schematic. Stall slices
        (starve/blocked) ride a separate lane the same way. Device/io spans
        are true wall-clock intervals.
        """
        epoch = self.started_wall
        offsets = self.clock_offsets()
        events: List[dict] = []
        # trace-event pids/tids are integers; names arrive via "M" metadata.
        # coordinator = pid 0; workers 1..N. Lane (tid) layout per process:
        # 0 query/tasks, 1 stages (coordinator only), 2 operators, 3 stalls,
        # 4 device/io
        T_MAIN, T_STAGES, T_OPS, T_STALLS, T_IO = 0, 1, 2, 3, 4

        def ev(name, cat, pid, tid, ts_s, dur_s, args=None):
            e = {"name": name, "cat": cat, "ph": "X", "pid": pid, "tid": tid,
                 "ts": round(ts_s * 1e6, 1),
                 "dur": round(max(dur_s, 0.0) * 1e6, 1)}
            if args:
                e["args"] = args
            events.append(e)

        def meta(pid, kind, label, tid=None):
            e = {"name": kind, "ph": "M", "pid": pid, "args": {"name": label}}
            if tid is not None:
                e["tid"] = tid
            events.append(e)

        def name_lanes(pid, main_label):
            meta(pid, "thread_name", main_label, T_MAIN)
            meta(pid, "thread_name", "operators", T_OPS)
            meta(pid, "thread_name", "stalls", T_STALLS)
            meta(pid, "thread_name", "device/io", T_IO)

        def op_lanes(ops, pid, start_s):
            """Sequential operator + stall lanes for one process/task."""
            cursor = start_s
            for s in ops:
                # slice width = compute when the stall split is populated
                # (stall lanes draw starve/blocked separately — a fully-
                # starved operator must not double-draw its wait); whole
                # self time only for split-less legacy records
                split = (s.compute_seconds + s.starve_seconds
                         + s.blocked_seconds)
                width = s.compute_seconds if split > 0 else s.seconds
                ev(s.name, "operator", pid, T_OPS, cursor, width,
                   {"node_id": s.node_id, "rows_out": s.rows_out,
                    "batches_out": s.batches_out,
                    "compute_s": round(s.compute_seconds, 6),
                    "starve_s": round(s.starve_seconds, 6),
                    "blocked_s": round(s.blocked_seconds, 6)})
                cursor += width
            cursor = start_s
            for s in ops:
                if s.starve_seconds > 0:
                    ev(f"starve:{s.name}", "stall", pid, T_STALLS, cursor,
                       s.starve_seconds)
                    cursor += s.starve_seconds
                if s.blocked_seconds > 0:
                    ev(f"blocked:{s.name}", "stall", pid, T_STALLS, cursor,
                       s.blocked_seconds)
                    cursor += s.blocked_seconds

        def raw_spans(spans, pid, offset):
            for sp in spans:
                ev(sp["name"], sp.get("cat", "span"), pid, T_IO,
                   sp["ts"] + offset - epoch, sp["dur"], sp.get("args"))

        with self._lock:
            tasks = list(self.tasks)
            task_spans = {k: list(v) for k, v in self.task_spans.items()}

        worker_pid = {wid: i + 1 for i, wid in
                      enumerate(sorted({t.worker_id for t in tasks}))}

        meta(0, "process_name", "coordinator")
        name_lanes(0, "query")
        meta(0, "thread_name", "stages", T_STAGES)
        end = epoch + (total_seconds or 0.0)
        for t in tasks:
            off = offsets.get(t.worker_id, 0.0)
            if t.started_at:
                end = max(end, t.started_at + off + t.exec_s)
        ev(f"query:{self.query_id or 'local'}", "query", 0, T_MAIN,
           0.0, end - epoch, {"query_id": self.query_id})

        # stage windows on the coordinator lane: [first task start, last task end]
        by_stage: Dict[str, List[TaskStats]] = {}
        for t in tasks:
            by_stage.setdefault(t.stage_id, []).append(t)
        for sid, sts in by_stage.items():
            timed = [t for t in sts if t.started_at]
            if not timed:
                continue
            s0 = min(t.started_at + offsets.get(t.worker_id, 0.0)
                     for t in timed)
            s1 = max(t.started_at + offsets.get(t.worker_id, 0.0) + t.exec_s
                     for t in timed)
            ev(f"stage:{sid}", "stage", 0, T_STAGES, s0 - epoch, s1 - s0,
               {"tasks": len(sts)})

        if coordinator_ops:
            op_lanes(coordinator_ops, 0, 0.0)
        if coordinator_spans:
            raw_spans(coordinator_spans, 0, 0.0)

        stragglers = {r["task_id"] for r in self.straggler_report()}
        for wid, pid in worker_pid.items():
            meta(pid, "process_name", f"worker {wid}")
            name_lanes(pid, "tasks")
        for t in tasks:
            pid = worker_pid[t.worker_id]
            off = offsets.get(t.worker_id, 0.0)
            t0 = (t.started_at + off - epoch) if t.started_at else 0.0
            ev(f"task:{t.task_id}", "task", pid, T_MAIN, t0, t.exec_s,
               {"stage_id": t.stage_id, "worker_id": t.worker_id,
                "rows_out": t.rows_out, "retries": t.retries,
                "queue_wait_s": round(t.queue_wait_s, 6),
                "straggler": t.task_id in stragglers})
            if t.operator_stats:
                op_lanes(t.operator_stats, pid, t0)
            if t.task_id in task_spans:
                raw_spans(task_spans[t.task_id], pid, off)

        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "metadata": {
                "query_id": self.query_id,
                "trace_id": self.trace_id,
                "trace_epoch_unix_s": epoch,
                "clock_offsets_s": offsets,
                "workers": {w: p for w, p in worker_pid.items()},
            },
        }

    # ---- rendering ---------------------------------------------------------------
    def render(self) -> str:
        """The distributed EXPLAIN ANALYZE section: stage DAG rollup with task
        skew (min/median/max task time) and shuffle volumes, then per-worker
        attribution."""
        stages = self.stage_summaries()
        if not stages:
            return "(no distributed stages ran)"
        lines = [f"{'stage':<22} {'tasks':>5} {'rows out':>12} "
                 f"{'min/median/max task':>24} {'queue wait':>10} "
                 f"{'shuffle w':>10} {'shuffle r':>10}"]
        for s in stages:
            skew = (f"{s['min_s']*1e3:.1f}/{s['median_s']*1e3:.1f}/"
                    f"{s['max_s']*1e3:.1f}ms")
            lines.append(
                f"{s['stage_id']:<22} {s['tasks']:>5} {s['rows_out']:>12} "
                f"{skew:>24} {s['queue_wait_s']*1e3:>8.1f}ms "
                f"{_fmt_bytes(s['shuffle_bytes_written']):>10} "
                f"{_fmt_bytes(s['shuffle_bytes_fetched']):>10}")
            if s["retries"]:
                lines.append(f"  {'':<20} ({s['retries']} task retries)")
            if s["shuffle_wire_bytes"] and s["shuffle_bytes_written"]:
                # per-stage compression ratio: wire bytes on disk/socket vs
                # logical Arrow buffer bytes
                ratio = s["shuffle_wire_bytes"] / s["shuffle_bytes_written"]
                lines.append(
                    f"  {'':<20} (compression: "
                    f"{_fmt_bytes(s['shuffle_wire_bytes'])} wire / "
                    f"{_fmt_bytes(s['shuffle_bytes_written'])} logical = "
                    f"{ratio:.2f}x)")
            if s["shuffle_fetch_cum_s"]:
                # fetch_seconds is CUMULATIVE in-flight time (over-counts the
                # wall-clock transfer window once requests overlap); the wall
                # window and the overlap bought by the pipelined fan-in are
                # labeled separately
                lines.append(
                    f"  {'':<20} (fetch: "
                    f"{s['shuffle_fetch_cum_s']*1e3:.1f}ms cumulative / "
                    f"{s['shuffle_fetch_wall_s']*1e3:.1f}ms wall, "
                    f"overlap {s['shuffle_overlap_s']*1e3:.1f}ms, "
                    f"fan-in {s['shuffle_fetch_fanin']})")
            if s["affinity_hits"] or s["affinity_misses"]:
                lines.append(
                    f"  {'':<20} (cache affinity: {s['affinity_hits']} hits, "
                    f"{s['affinity_misses']} misses, "
                    f"{_fmt_bytes(s['sched_bytes_avoided'])} transfer avoided)")
        recovery = self.recovery_totals()
        if recovery:
            pieces = []
            for key, label in (("worker_failures", "worker failures"),
                               ("tasks_requeued", "tasks requeued"),
                               ("maps_regenerated", "maps regenerated")):
                if recovery.get(key):
                    pieces.append(f"{recovery[key]} {label}")
            for key in sorted(recovery):
                if key not in ("worker_failures", "tasks_requeued",
                               "maps_regenerated"):
                    pieces.append(f"{recovery[key]} {key}")
            lines.append("")
            lines.append("recovery: " + ", ".join(pieces))
        stragglers = self.straggler_report()
        if stragglers:
            k = straggler_threshold()
            lines.append("")
            lines.append(f"stragglers (> {k:g}x stage median task time — "
                         "speculative re-execution candidates):")
            for r in stragglers:
                lines.append(
                    f"  {r['stage_id']}/{r['task_id']} on {r['worker_id']}: "
                    f"{r['exec_s']*1e3:.1f}ms vs median "
                    f"{r['median_s']*1e3:.1f}ms ({r['ratio']:.1f}x)")
        workers = self.worker_summary()
        if workers:
            lines.append("")
            lines.append(f"{'worker':<12} {'tasks':>5} {'busy':>10} "
                         f"{'rows out':>12} {'rss':>10} {'heartbeats':>10}")
            for w in workers:
                lines.append(
                    f"{w['worker_id']:<12} {w['tasks']:>5} "
                    f"{w['exec_s']*1e3:>8.1f}ms {w['rows']:>12} "
                    f"{_fmt_bytes(w.get('rss_bytes', 0)):>10} "
                    f"{w.get('heartbeats', 0):>10}")
        return "\n".join(lines)


def _fmt_bytes(n: int) -> str:
    if n <= 0:
        return "-"
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024:
            return f"{n:.0f}{unit}" if unit == "B" else f"{n:.1f}{unit}"
        n /= 1024
    return f"{n:.1f}TiB"
