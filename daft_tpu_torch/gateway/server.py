"""GatewayServer: the network front door over a ServingSession (counterpart
of daft_tpu/gateway/server.py).

One process-wide serving surface: a listener thread accepts TCP connections,
one daemon thread per connection speaks the length-framed protocol
(protocol.py), and every query funnels through a single
:class:`~daft_tpu_torch.serving.ServingSession` — so the gateway inherits the
serving tier's whole QoS stack unchanged: per-tenant weighted round-robin
admission with depth caps (typed ``over_capacity`` wire error), the HBM
admission controller, the prepared-query cache, and cooperative
cancellation (the ``cancel`` verb trips the same token the engine's
checkpoints poll — a cancel on the wire lands between streamed partitions,
not at the next query boundary).

Three result tiers, cheapest first, consulted at ``execute``:

1. **Result cache** (result_cache.py) — wire-encoded chunks keyed by
   ``query_fingerprint`` (plan structure + source content fingerprints);
   a hit streams without touching the engine.
2. **Checkpoint restore** — with ``DAFT_TPU_CHECKPOINT_DIR`` set, a
   committed result under ``{root}/gw-{fingerprint}/result`` is loaded via
   the StageCheckpointer (checkpoint/stages.py). This IS the restartable
   driver: the checkpoint
   tree is the persisted {plan fingerprint -> result} map, so a gateway
   killed mid-replay and relaunched serves committed work from disk and
   re-runs only what never committed — never a client-visible wrong result
   (the fingerprint embeds the source data identity).
3. **Execute** — submit to the ServingSession; on success the result is
   committed to the checkpointer and inserted into the result cache.

Prepared handles are server-scoped, not connection-scoped: a handle is the
stable hash of the plan's (skeleton, literals) structure, kept in a bounded
map that survives reconnects — a client that drops and redials resumes
executing by handle with no re-prepare round trip.

Auth: shared-secret per tenant (``DAFT_TPU_GATEWAY_TOKENS``); an empty map
is OPEN mode for development. Failures answer ``bad_token``, count
``gateway_auth_failures``, and fire a flight-recorder ``gateway_error``
anomaly so repeated bad tokens surface in tools/doctor.py's triage.

Queries run where ``ExecutionConfig`` says (``device``, "cuda" by default;
``device_mode``, "on"): the gateway adds no device choice of its own, and a
device query with no card answers ``exec_error``.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import socket
import threading
import time
import uuid
from collections import OrderedDict
from typing import Dict, Optional

from ..observability import GatewayQueryRecord, notify, subscribers_active
from ..observability.metrics import registry
from ..serving import ServingSession, TenantQueueFull, plan_structure
from ..utils.env import env_int
from . import protocol as proto
from .result_cache import CachedResult, ResultCache


def handle_cap() -> int:
    """DAFT_TPU_GATEWAY_HANDLES: prepared handles the server retains across
    all tenants/connections (LRU past the cap; a client holding an evicted
    handle gets unknown_handle and re-prepares)."""
    return env_int("DAFT_TPU_GATEWAY_HANDLES", 256, lo=8)


def _handle_of(plan) -> str:
    """Prepared-statement handle: stable digest of the plan's (skeleton,
    literals). Deterministic across connections for the same query text over
    the same registered tables, which is what lets a reconnecting client
    resume by handle."""
    skel, lits = plan_structure(plan)
    return hashlib.blake2s(repr((skel, lits)).encode(),
                           digest_size=12).hexdigest()


class _QueryState:
    """Per-execute bookkeeping between the execute and fetch verbs."""

    __slots__ = ("tenant", "future", "cached", "source", "fingerprint",
                 "schema", "ckpt", "handle", "t0")

    def __init__(self, tenant: str, source: str, future=None, cached=None,
                 fingerprint=None, schema=None, ckpt=None, handle: str = ""):
        self.tenant = tenant
        self.source = source        # executed | result_cache | checkpoint
        self.future = future
        self.cached = cached        # CachedResult when already materialized
        self.fingerprint = fingerprint
        self.schema = schema
        self.ckpt = ckpt
        self.handle = handle
        self.t0 = time.perf_counter()


class GatewayServer:
    """Socket front door over one ServingSession (see module doc).

    Args:
        host/port: bind address (port 0 picks a free port; read ``.port``).
        tokens: {tenant: token} override; None reads DAFT_TPU_GATEWAY_TOKENS.
        tables: {name: DataFrame} initial SQL bindings (``set_table`` later).
        max_concurrent: ServingSession worker threads.
        result_cache_budget: byte budget override for the result cache.
    """

    # in-flight execute->fetch states retained; far above any sane number of
    # unfetched queries per process, it only bounds a client that executes
    # forever without fetching
    _QUERY_STATE_CAP = 4096

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 tokens: Optional[Dict[str, str]] = None, tables=None,
                 max_concurrent: Optional[int] = None,
                 result_cache_budget: Optional[int] = None):
        self._tokens = (proto.parse_token_map() if tokens is None
                        else dict(tokens))
        self._session = ServingSession(max_concurrent=max_concurrent)
        self.cache = ResultCache(result_cache_budget)
        self._lock = threading.Lock()
        self._tables: Dict[str, object] = dict(tables or {})
        self._handles: "OrderedDict[str, object]" = OrderedDict()
        self._queries: "OrderedDict[str, _QueryState]" = OrderedDict()
        self._closed = threading.Event()
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        self._listener.listen(64)
        self._listener.settimeout(0.2)
        self.host, self.port = self._listener.getsockname()[:2]
        self._accept_thread: Optional[threading.Thread] = None

    # ---- lifecycle -----------------------------------------------------------------
    def start(self) -> "GatewayServer":
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name="daft-gateway-accept")
        self._accept_thread.start()
        return self

    def close(self) -> None:
        self._closed.set()
        if self._accept_thread is not None:
            self._accept_thread.join(timeout=5.0)
        try:
            self._listener.close()
        except OSError:
            pass
        self._session.close()

    def __enter__(self) -> "GatewayServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    def set_table(self, name: str, df) -> None:
        """(Re)bind a SQL table name. Rebinding flows straight into result
        correctness: new source data -> new content fingerprints -> new cache
        keys, so stale cached results are unreachable by construction."""
        with self._lock:
            self._tables[name] = df

    # ---- accept loop (fetch_server idiom: backoff on error, never die) -------------
    def _accept_loop(self) -> None:
        backoff = 0.005
        while not self._closed.is_set():
            try:
                conn, addr = self._listener.accept()
            except socket.timeout:
                continue
            except OSError:
                if self._closed.is_set():
                    return
                time.sleep(backoff)
                backoff = min(backoff * 2, 0.25)
                continue
            backoff = 0.005
            registry().inc("gateway_connections_total")
            threading.Thread(target=self._serve_connection, args=(conn,),
                             daemon=True, name="daft-gateway-conn").start()

    # ---- per-connection protocol loop ----------------------------------------------
    def _serve_connection(self, conn: socket.socket) -> None:
        reg = registry()
        reg.set_gauge("gateway_active_connections",
                      reg.get("gateway_connections_total")
                      - reg.get("gateway_disconnects_total"))
        tenant = ""
        try:
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            tenant = self._handshake(conn)
            if tenant is None:
                return
            while not self._closed.is_set():
                req = proto.recv_json(conn)
                reg.inc("gateway_requests_total")
                verb = req.get("verb", "")
                if verb == "bye":
                    proto.send_json(conn, {"ok": True, "bye": True})
                    return
                handler = getattr(self, f"_verb_{verb}", None)
                if handler is None:
                    proto.send_error(conn, "unknown_verb",
                                     f"unknown verb {verb!r}")
                    reg.inc("gateway_errors_total")
                    continue
                try:
                    handler(conn, tenant, req)
                except proto.WireError as e:
                    # request-level typed failure: answer it, keep serving
                    # this connection (the framing is still intact)
                    proto.send_error(conn, e.code, str(e))
                    reg.inc("gateway_errors_total")
        except EOFError:
            pass  # clean between-frames close
        except proto.WireError as e:
            # framing-level failure (truncated/oversized/undecodable frame):
            # the byte stream can't be resynchronized — answer a typed error
            # so the client sees WHY, then drop the connection
            reg.inc("gateway_errors_total")
            self._flight_error(f"wire error: {e}", tenant)
            try:
                proto.send_error(conn, e.code, str(e))
            except OSError:
                pass
        except OSError as e:
            reg.inc("gateway_errors_total")
            self._flight_error(f"connection error: {e}", tenant)
        finally:
            reg.inc("gateway_disconnects_total")
            reg.set_gauge("gateway_active_connections",
                          max(0.0, reg.get("gateway_connections_total")
                              - reg.get("gateway_disconnects_total")))
            try:
                conn.close()
            except OSError:
                pass

    def _handshake(self, conn) -> Optional[str]:
        """First frame must be hello; returns the authenticated tenant or
        None (error already answered)."""
        req = proto.recv_json(conn)
        if req.get("verb") != "hello":
            proto.send_error(conn, "bad_request",
                             "first frame must be the hello verb")
            registry().inc("gateway_errors_total")
            return None
        tenant = str(req.get("tenant", "") or "")
        token = str(req.get("token", "") or "")
        if not tenant:
            proto.send_error(conn, "bad_request", "hello carries no tenant")
            registry().inc("gateway_errors_total")
            return None
        if self._tokens:
            expected = self._tokens.get(tenant, "")
            if not expected or not hmac.compare_digest(
                    expected.encode(), token.encode()):
                registry().inc("gateway_auth_failures")
                self._flight_error(
                    f"auth failure for tenant {tenant!r}", tenant)
                proto.send_error(conn, "bad_token",
                                 f"bad token for tenant {tenant!r}")
                return None
        proto.send_json(conn, {"ok": True, "server": "daft_tpu-gateway",
                               "open_mode": not self._tokens})
        return tenant

    def _flight_error(self, detail: str, tenant: str = "") -> None:
        from ..observability import flight as _flight

        frec = _flight.recorder()
        if frec is not None:
            frec.trigger("gateway_error", detail=detail, tenant=tenant)

    # ---- query resolution ----------------------------------------------------------
    def _resolve_sql(self, sql_text: str):
        from ..sql import sql as _sql

        with self._lock:
            bindings = dict(self._tables)
        try:
            df = _sql(sql_text, **bindings)
        except Exception as e:  # noqa: BLE001 — client's query text: answer, don't die
            raise proto.WireError("bad_request", f"SQL error: {e}")
        return df._plan

    def _plan_for(self, req: dict):
        """execute/prepare request -> (logical plan, handle). Registers the
        handle (bounded LRU) so any later connection can execute by handle."""
        handle = req.get("handle")
        if handle is not None:
            with self._lock:
                plan = self._handles.get(handle)
                if plan is not None:
                    self._handles.move_to_end(handle)
            if plan is None:
                raise proto.WireError(
                    "unknown_handle",
                    f"unknown prepared handle {handle!r} (evicted or from "
                    f"another server); re-prepare")
            return plan, handle
        sql_text = req.get("sql")
        if not sql_text:
            raise proto.WireError("bad_request",
                                  "request carries neither sql nor handle")
        plan = self._resolve_sql(str(sql_text))
        handle = _handle_of(plan)
        with self._lock:
            self._handles[handle] = plan
            self._handles.move_to_end(handle)
            while len(self._handles) > handle_cap():
                self._handles.popitem(last=False)
        return plan, handle

    def _fingerprint(self, physical) -> Optional[str]:
        """Content fingerprint (cache/checkpoint key), or None for unkeyable
        plans — those bypass both tiers and always execute."""
        from ..checkpoint.stages import query_fingerprint

        return query_fingerprint(physical)

    def _checkpointer(self, fingerprint: Optional[str]):
        root = os.environ.get("DAFT_TPU_CHECKPOINT_DIR", "")
        if not root or fingerprint is None:
            return None
        try:
            from ..checkpoint.stages import StageCheckpointer

            return StageCheckpointer(root, f"gw-{fingerprint}")
        except Exception:  # noqa: BLE001 -- checkpointing is advisory: an unusable
            # root degrades to no-restore, never to a failure
            return None

    def _remember(self, qid: str, state: _QueryState) -> None:
        with self._lock:
            self._queries[qid] = state
            while len(self._queries) > self._QUERY_STATE_CAP:
                self._queries.popitem(last=False)

    # ---- verbs ---------------------------------------------------------------------
    def _verb_prepare(self, conn, tenant: str, req: dict) -> None:
        plan, handle = self._plan_for(req)
        entry, hit = self._session.prepared.get_or_plan(plan)
        proto.send_json(conn, {"ok": True, "handle": handle,
                               "prepared_hit": hit,
                               "columns": entry.physical.schema.column_names()})

    def _verb_execute(self, conn, tenant: str, req: dict) -> None:
        plan, handle = self._plan_for(req)
        entry, _hit = self._session.prepared.get_or_plan(plan)
        fp = self._fingerprint(entry.physical)
        qid = uuid.uuid4().hex[:12]
        cached = self.cache.get(fp)
        thrash = self.cache.note_thrash()
        if thrash is not None:
            from ..observability import flight as _flight

            frec = _flight.recorder()
            if frec is not None:
                frec.trigger("cache_thrash", detail=thrash, tenant=tenant)
        if cached is not None:
            self._remember(qid, _QueryState(tenant, "result_cache",
                                            cached=cached, fingerprint=fp,
                                            handle=handle))
            proto.send_json(conn, {"ok": True, "query_id": qid,
                                   "source": "result_cache"})
            return
        ckpt = self._checkpointer(fp)
        if ckpt is not None and ckpt.committed("result"):
            parts = ckpt.restore_result("result", entry.physical.schema)
            if parts is not None:
                entry_c = CachedResult(
                    proto.encode_result_chunks(parts),
                    sum(p.num_rows for p in parts),
                    entry.physical.schema.column_names())
                self.cache.put(fp, entry_c)
                self._remember(qid, _QueryState(tenant, "checkpoint",
                                                cached=entry_c,
                                                fingerprint=fp,
                                                handle=handle))
                proto.send_json(conn, {"ok": True, "query_id": qid,
                                       "source": "checkpoint"})
                return
        try:
            fut = self._session.submit(plan, tenant=tenant)
        except TenantQueueFull as e:
            raise proto.WireError("over_capacity", str(e))
        self._remember(fut.query_id, _QueryState(
            tenant, "executed", future=fut, fingerprint=fp,
            schema=entry.physical.schema, ckpt=ckpt, handle=handle))
        proto.send_json(conn, {"ok": True, "query_id": fut.query_id,
                               "source": "executed"})

    def _state_for(self, tenant: str, req: dict) -> (str, _QueryState):
        qid = str(req.get("query_id", "") or "")
        with self._lock:
            state = self._queries.get(qid)
        # tenant check folds into unknown_query: another tenant's query ids
        # are indistinguishable from nonexistent ones (no probing oracle)
        if state is None or state.tenant != tenant:
            raise proto.WireError("unknown_query",
                                  f"unknown query id {qid!r}")
        return qid, state

    def _verb_fetch(self, conn, tenant: str, req: dict) -> None:
        from ..cancellation import QueryCancelled

        qid, state = self._state_for(tenant, req)
        entry_c = state.cached
        error: Optional[str] = None
        if entry_c is None:
            try:
                parts = state.future.result(
                    timeout=req.get("timeout"))
                entry_c = CachedResult(
                    proto.encode_result_chunks(parts),
                    sum(p.num_rows for p in parts),
                    state.schema.column_names())
                # publish AFTER success, durable first: a kill between commit
                # and cache-insert just means the relaunch restores from disk
                if state.ckpt is not None:
                    state.ckpt.commit_result("result", parts)
                self.cache.put(state.fingerprint, entry_c)
            except QueryCancelled as e:
                self._finish(qid, state, 0, error=f"cancelled: {e}")
                raise proto.WireError("cancelled", str(e))
            except TimeoutError as e:
                # not terminal: the query is still running; the client may
                # fetch again (state stays registered)
                raise proto.WireError("timeout", str(e))
            except Exception as e:  # noqa: BLE001 — execution error crosses the wire typed
                error = f"{type(e).__name__}: {e}"
                self._flight_error(f"query {qid} failed: {error}", tenant)
                self._finish(qid, state, 0, error=error)
                raise proto.WireError("exec_error", error)
        streamed = 0
        for chunk in entry_c.chunks:
            proto.send_frame(conn, proto.TAG_BINARY, chunk)
            streamed += len(chunk)
        registry().inc("gateway_bytes_streamed", streamed)
        proto.send_json(conn, {"ok": True, "done": True,
                               "rows": entry_c.rows,
                               "columns": entry_c.columns,
                               "source": state.source,
                               "chunks": len(entry_c.chunks)})
        self._finish(qid, state, streamed)

    def _finish(self, qid: str, state: _QueryState, streamed: int,
                error: Optional[str] = None) -> None:
        with self._lock:
            self._queries.pop(qid, None)
        registry().inc("gateway_queries_total")
        if error is not None:
            registry().inc("gateway_errors_total")
        if subscribers_active():
            rows = state.cached.rows if (error is None
                                         and state.cached is not None) else 0
            notify("on_gateway_query", GatewayQueryRecord(
                query_id=qid, tenant=state.tenant,
                seconds=time.perf_counter() - state.t0, rows=rows,
                source=state.source, bytes_streamed=streamed,
                prepared_handle=state.handle, error=error))

    def _verb_cancel(self, conn, tenant: str, req: dict) -> None:
        qid, state = self._state_for(tenant, req)
        delivered = state.future.cancel() if state.future is not None else False
        proto.send_json(conn, {"ok": True, "cancelled": delivered})

    def _verb_stats(self, conn, tenant: str, req: dict) -> None:
        snap = registry().snapshot()
        proto.send_json(conn, {
            "ok": True,
            "metrics": {k: v for k, v in snap.items()
                        if k.startswith(("gateway_", "result_cache_",
                                         "serve_"))},
            "result_cache": self.cache.stats(),
            "tenants": self._session.tenant_stats(),
        })
