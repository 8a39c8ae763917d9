"""ServingSession: the concurrent query session (counterpart of
daft_tpu/serving/session.py).

``submit()`` puts a ticket in the fair admission queue (per-tenant
round-robin, admission.py) and returns a ``ServeFuture``;
``max_concurrent`` session worker threads take tickets, prepare them
through the PreparedQueryCache (optimize and translate skipped on a repeat
shape), pass the HBM admission controller (``ResidencyManager.admit``: a
reservation of the query's estimated pin-scope bytes that makes an
over-budget query wait instead of evicting another's pinned planes), and run
the cached physical plan through the executor on the configured device,
or, with ``runner=`` (a DistributedRunner), hand the prepared optimized
plan to the runner, whose pool deals the concurrent queries' sub-plan
tasks round-robin across its shared workers.
Pin scopes are per thread, so concurrent queries' scopes never mix; the
stage caches, the decision cache and the residency manager take their own
locks; each query runs under ``span_scope(None)`` so a query profiled
elsewhere never receives its spans, and under its own placement scope.

Every query emits a ServeQueryRecord to subscribers (the dashboard's
per-tenant hit-rate table, the tenant-labeled latency histogram, the event
log) and bumps ``serve_queries_total`` / ``serve_prepared_hits`` /
``admission_waits_total``; ``serve_queue_depth`` tracks the queue.
"""

from __future__ import annotations

import threading
import time
import uuid
from typing import Any, List, Optional

from ..cancellation import QueryCancelled, raise_if_cancelled, set_cancel_event
from ..config import execution_config
from ..device.residency import manager as _residency
from ..observability import ServeQueryRecord, notify, subscribers_active
from ..observability.metrics import registry
from .admission import FairAdmissionQueue
from .prepared import PreparedQueryCache


class ServeFuture:
    """Result handle for one submitted query."""

    def __init__(self, query_id: str, tenant: str):
        self.query_id = query_id
        self.tenant = tenant
        self._done = threading.Event()
        self._parts: Optional[List[Any]] = None
        self._error: Optional[BaseException] = None
        # the event is the executing thread's cancellation token
        # (cancellation.py); _queue/_ticket let cancel() pull a still-queued
        # query out of the admission queue before it starts
        self._cancel_ev = threading.Event()
        self._queue: Optional[FairAdmissionQueue] = None
        self._ticket: Optional["_Ticket"] = None
        # filled at resolution for the caller's attribution
        self.seconds = 0.0
        self.prepared_hit = False
        self.admission_wait_s = 0.0
        self.cancelled = False

    def result(self, timeout: Optional[float] = None) -> List[Any]:
        """The query's result MicroPartitions (raises what execution raised)."""
        if not self._done.wait(timeout):
            raise TimeoutError(f"query {self.query_id} not done within {timeout}s")
        if self._error is not None:
            raise self._error
        return self._parts  # type: ignore[return-value]

    def to_pydict(self, timeout: Optional[float] = None) -> dict:
        parts = self.result(timeout)
        out: dict = {}
        for p in parts:
            for k, v in p.to_pydict().items():
                out.setdefault(k, []).extend(v)
        return out

    def done(self) -> bool:
        return self._done.is_set()

    def cancel(self) -> bool:
        """Cancel this query. A still-queued query leaves the admission
        queue, never reserves, and resolves at once with QueryCancelled. A
        running one is cancelled at its next check (the admission wait,
        between streamed result partitions); a stage already running
        completes and its result is dropped. False only when the query had
        already resolved (its result stands)."""
        if self._done.is_set():
            return False
        self._cancel_ev.set()
        q, t = self._queue, self._ticket
        if q is not None and t is not None and q.remove(t.tenant, t):
            registry().set_gauge("serve_queue_depth", float(q.depth()))
            registry().inc("serve_cancelled_total")
            self.cancelled = True
            self._reject(QueryCancelled(f"query {self.query_id} cancelled while queued"))
        return True

    def _resolve(self, parts: List[Any]) -> None:
        self._parts = parts
        self._done.set()

    def _reject(self, err: BaseException) -> None:
        self._error = err
        self._done.set()


class _Ticket:
    __slots__ = ("plan", "tenant", "future", "submitted")

    def __init__(self, plan, tenant: str, future: ServeFuture):
        self.plan = plan
        self.tenant = tenant
        self.future = future
        self.submitted = time.perf_counter()


class ServingSession:
    """N concurrent queries over the warm engine (see the module doc).

    Args:
        max_concurrent: session worker threads (default
            ExecutionConfig.max_concurrent_queries).
        runner: run through this Runner (a DistributedRunner) instead of the
            in-process executor.
        prepared_cap: prepared-query cache slots (one per plan skeleton).
    """

    def __init__(self, max_concurrent: Optional[int] = None, runner=None,
                 prepared_cap: int = 64):
        self._runner = runner
        cfg = execution_config()
        self.max_concurrent = (cfg.max_concurrent_queries if max_concurrent is None
                               else max_concurrent)
        if self.max_concurrent < 1:
            raise ValueError(f"max_concurrent must be >= 1, got {self.max_concurrent}")
        self._queue = FairAdmissionQueue()
        self.prepared = PreparedQueryCache(prepared_cap)
        self._closed = threading.Event()
        self._stats_lock = threading.Lock()
        # tenant -> {"queries", "errors", "prepared_hits", "admission_waits",
        #            "wait_s", "seconds", "rows"}
        self._tenants: dict = {}
        self._threads = [threading.Thread(target=self._worker_loop, daemon=True,
                                          name=f"daft-serve-{i}")
                         for i in range(self.max_concurrent)]
        for t in self._threads:
            t.start()

    # ---- client API ----------------------------------------------------------------
    def submit(self, query, tenant: str = "default") -> ServeFuture:
        """Queue one query (a DataFrame or a logical plan) for ``tenant``;
        returns its ServeFuture at once."""
        if self._closed.is_set():
            raise RuntimeError("serving session is closed")
        plan = getattr(query, "_plan", query)
        fut = ServeFuture(uuid.uuid4().hex[:12], tenant)
        ticket = _Ticket(plan, tenant, fut)
        fut._queue = self._queue
        fut._ticket = ticket
        depth = self._queue.push(tenant, ticket)
        registry().set_gauge("serve_queue_depth", float(depth))
        if self._closed.is_set():
            # close() raced the push and may have drained the queue before
            # it landed: reject the stragglers so no client blocks
            self._drain_reject()
        return fut

    def run(self, query, tenant: str = "default", timeout: Optional[float] = None) -> List[Any]:
        """submit + result."""
        return self.submit(query, tenant).result(timeout)

    def tenant_stats(self) -> dict:
        """Per-tenant totals (queries, prepared hits, admission waits,
        latency): the dashboard's hit-rate table."""
        with self._stats_lock:
            return {k: dict(v) for k, v in self._tenants.items()}

    def close(self, timeout: float = 10.0) -> None:
        """Stop taking queries and join the workers; queued tickets not yet
        started are rejected so no client blocks."""
        self._closed.set()
        for t in self._threads:
            t.join(timeout)
        self._drain_reject()

    def _drain_reject(self) -> None:
        while True:
            ticket = self._queue.pop(timeout=0)
            if ticket is None:
                break
            ticket.future._reject(RuntimeError("serving session closed"))
        registry().set_gauge("serve_queue_depth", 0.0)

    def __enter__(self) -> "ServingSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---- worker side ---------------------------------------------------------------
    def _worker_loop(self) -> None:
        while not self._closed.is_set():
            ticket = self._queue.pop(timeout=0.1)
            if ticket is None:
                continue
            registry().set_gauge("serve_queue_depth", float(self._queue.depth()))
            self._execute(ticket)

    def _run_plan(self, fut: ServeFuture, entry) -> List[Any]:
        """The cached physical plan through the executor, with a cancellation
        check between streamed partitions; a device query resolves its
        device first (no card: it raises)."""
        from ..execution.executor import execute_plan

        if execution_config().device_mode != "off":
            from ..utils.torch_setup import resolve_device

            resolve_device(execution_config().device)
        parts = []
        stream = execute_plan(entry.physical)
        try:
            for p in stream:
                raise_if_cancelled(f"query {fut.query_id} cancelled")
                parts.append(p)
        finally:
            # a cancel unwinds the stages here, on this thread: each stage
            # waits for its own thread to close its pin scope
            stream.close()
        return parts

    def _execute(self, ticket: _Ticket) -> None:
        from ..observability.placement import query_scope as _placement_scope
        from ..observability.runtime_stats import span_scope

        fut = ticket.future
        t0 = time.perf_counter()
        cfg = execution_config()
        entry = None
        err: Optional[str] = None
        rows = 0
        hit = False
        waited = False
        wait_s = 0.0
        exec_s = 0.0
        est = 0
        exc: Optional[BaseException] = None
        parts: List[Any] = []
        set_cancel_event(fut._cancel_ev)
        try:
            # a cancel() that lost the race for the queue still wins here
            raise_if_cancelled(f"query {fut.query_id} cancelled")
            entry, hit = self.prepared.get_or_plan(ticket.plan)
            est = entry.est_pin_bytes
            t_adm = time.perf_counter()
            with _residency().admit(est, tenant=ticket.tenant,
                                    tenant_budget=cfg.tenant_budget_bytes) as waited:
                wait_s = time.perf_counter() - t_adm
                t_exec = time.perf_counter()
                if self._runner is None:
                    with span_scope(None), _placement_scope(tag=fut.query_id), \
                            _residency().observe_pins() as observed_pins:
                        parts = self._run_plan(fut, entry)
                    entry.note_observed_pin(observed_pins())
                else:
                    with span_scope(None), _placement_scope(tag=fut.query_id):
                        parts = list(self._runner.run(entry.plan))
                exec_s = time.perf_counter() - t_exec
            rows = sum(p.num_rows for p in parts)
        except BaseException as e:  # noqa: BLE001 -- the future carries it to the client
            err = f"{type(e).__name__}: {e}"
            exc = e
        finally:
            set_cancel_event(None)
        seconds = time.perf_counter() - t0
        # attribution before resolution: a client waking from result() sees it
        fut.seconds = seconds
        fut.prepared_hit = hit
        fut.admission_wait_s = wait_s
        if isinstance(exc, QueryCancelled):
            fut.cancelled = True
            registry().inc("serve_cancelled_total")
        if err is None:
            fut._resolve(parts)
        else:
            fut._reject(exc)
        registry().inc("serve_queries_total")
        with self._stats_lock:
            st = self._tenants.setdefault(ticket.tenant, {
                "queries": 0, "errors": 0, "prepared_hits": 0, "admission_waits": 0,
                "wait_s": 0.0, "seconds": 0.0, "rows": 0})
            st["queries"] += 1
            st["seconds"] += seconds
            st["rows"] += rows
            st["prepared_hits"] += int(hit)
            st["admission_waits"] += int(bool(waited))
            st["wait_s"] += wait_s
            st["errors"] += int(err is not None)
        if subscribers_active():
            notify("on_serve_query", ServeQueryRecord(
                query_id=fut.query_id, tenant=ticket.tenant, seconds=seconds,
                exec_seconds=exec_s, rows=rows, prepared_hit=hit, admission_wait_s=wait_s,
                est_pin_bytes=est, error=err, admission_waited=bool(waited),
                in_process=self._runner is None))
        from ..observability import flight as _flight

        frec = _flight.recorder()
        if frec is not None:
            # tenant-tagged; no metrics on the record: concurrent tenants
            # share one registry, so a per-query delta would mix them
            if waited:
                frec.record("admission", tenant=ticket.tenant, query_id=fut.query_id,
                            wait_s=round(wait_s, 6), est_pin_bytes=est)
            if isinstance(exc, QueryCancelled):
                # a client's cancel is not an engine anomaly: a ring record only
                frec.record("cancelled", tenant=ticket.tenant, query_id=fut.query_id,
                            seconds=round(seconds, 6))
            else:
                fp = str(getattr(entry, "fingerprint", "") or "")
                frec.note_query(_flight.plan_key(fp) if fp else "", seconds,
                                query_id=fut.query_id, tenant=ticket.tenant, rows=rows,
                                error=err)
