"""GatewayClient: the Python client for the gateway wire protocol
(counterpart of daft_tpu/gateway/client.py; it speaks to the reference's
gateway as to the port's).

Blocking, one socket per client, prepared-statement shaped::

    from daft_tpu_torch.gateway import GatewayClient

    with GatewayClient("127.0.0.1", 8642, tenant="acme", token="s3cr3t") as c:
        h = c.prepare("SELECT k, SUM(v) AS s FROM t GROUP BY k ORDER BY k")
        qid = c.execute(handle=h)
        for batch in c.fetch(qid):          # the port's RecordBatches, streamed
            ...
        out = c.query("SELECT COUNT(*) AS n FROM t")   # one-shot -> pydict

Reconnect semantics: handles are SERVER-scoped, so a client that redials
keeps executing by handle. ``execute`` additionally remembers the SQL text
behind each handle it prepared, and transparently re-prepares on an
``unknown_handle`` reply (the handle aged out of the server's bounded map) —
the caller never sees the round trip. Typed failures raise
:class:`GatewayError` with ``.code`` from the protocol vocabulary
(``bad_token``, ``over_capacity``, ``cancelled``, ...).
"""

from __future__ import annotations

import socket
from typing import Dict, Iterator, List, Optional

from . import protocol as proto
from .protocol import GatewayError


class GatewayClient:
    """Blocking gateway connection for one tenant (see module doc)."""

    def __init__(self, host: str, port: int, tenant: str = "default",
                 token: str = "", timeout: Optional[float] = None,
                 connect_retries: int = 0):
        self.host = host
        self.port = port
        self.tenant = tenant
        self.token = token
        self.timeout = timeout
        self._connect_retries = connect_retries
        self._sock: Optional[socket.socket] = None
        # handle -> SQL text, for transparent re-prepare after server-side
        # handle eviction or a gateway restart
        self._prepared_sql: Dict[str, str] = {}
        # terminal fetch frame ({rows, columns, source, chunks}) and the
        # last execute's source tier, for caller-side attribution
        self.last_fetch: dict = {}
        self.last_source = ""
        self._connect()

    # ---- connection ----------------------------------------------------------------
    def _connect(self) -> None:
        import time as _time

        attempt = 0
        while True:
            try:
                self._sock = socket.create_connection(
                    (self.host, self.port), timeout=self.timeout)
                break
            except OSError:
                attempt += 1
                if attempt > self._connect_retries:
                    raise
                _time.sleep(min(0.05 * (2 ** attempt), 1.0))
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        proto.send_json(self._sock, {"verb": "hello", "tenant": self.tenant,
                                     "token": self.token})
        self._reply()

    def reconnect(self) -> None:
        """Redial and re-authenticate (prepared handles survive server-side;
        this client's handle->SQL memory survives client-side)."""
        self.close()
        self._connect()

    def close(self) -> None:
        if self._sock is None:
            return
        try:
            proto.send_json(self._sock, {"verb": "bye"})
            proto.recv_json(self._sock)
        except (OSError, GatewayError, EOFError):
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        self._sock = None

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _reply(self) -> dict:
        obj = proto.recv_json(self._sock)
        if not obj.get("ok", False):
            raise GatewayError(obj.get("code", "error"),
                               obj.get("error", "gateway error"))
        return obj

    def _request(self, obj: dict) -> dict:
        if self._sock is None:
            raise GatewayError("bad_request", "client is closed")
        proto.send_json(self._sock, obj)
        return self._reply()

    # ---- verbs ---------------------------------------------------------------------
    def prepare(self, sql: str) -> str:
        """Plan `sql` server-side; returns a handle that survives reconnects
        (and, via client-side re-prepare, server restarts)."""
        reply = self._request({"verb": "prepare", "sql": sql})
        handle = reply["handle"]
        self._prepared_sql[handle] = sql
        return handle

    def execute(self, sql: Optional[str] = None,
                handle: Optional[str] = None) -> str:
        """Admit one query (by SQL text or prepared handle); returns its
        query id immediately — results stream on :meth:`fetch`."""
        if (sql is None) == (handle is None):
            raise GatewayError("bad_request",
                               "execute takes exactly one of sql / handle")
        req = ({"verb": "execute", "sql": sql} if sql is not None
               else {"verb": "execute", "handle": handle})
        try:
            reply = self._request(req)
        except GatewayError as e:
            known = handle is not None and handle in self._prepared_sql
            if e.code != "unknown_handle" or not known:
                raise
            # the server aged the handle out (bounded map / restart):
            # re-prepare from the remembered SQL and retry once
            fresh = self.prepare(self._prepared_sql[handle])
            reply = self._request({"verb": "execute", "handle": fresh})
        self.last_source = reply.get("source", "")
        return reply["query_id"]

    def fetch(self, query_id: str,
              timeout: Optional[float] = None) -> Iterator:
        """Stream the query's result as the port's RecordBatches (decoded by
        io/arrow_ipc.py). The terminal control frame's fields land on
        ``.last_fetch`` (rows/source/columns)."""
        if self._sock is None:
            raise GatewayError("bad_request", "client is closed")
        req = {"verb": "fetch", "query_id": query_id}
        if timeout is not None:
            req["timeout"] = timeout
        proto.send_json(self._sock, req)
        while True:
            tag, payload = proto.recv_frame(self._sock)
            if tag == proto.TAG_BINARY:
                for batch in proto.decode_result_chunk(payload):
                    yield batch
                continue
            import json as _json

            obj = _json.loads(payload.decode())
            if not obj.get("ok", False):
                raise GatewayError(obj.get("code", "error"),
                                   obj.get("error", "gateway error"))
            self.last_fetch = obj
            return

    def fetch_pydict(self, query_id: str,
                     timeout: Optional[float] = None) -> dict:
        """Fetch and assemble into a column dict (empty result keeps the
        schema via the terminal frame's column list)."""
        out: dict = {}
        cols: List[str] = []
        for batch in self.fetch(query_id, timeout=timeout):
            d = batch.to_pydict()
            cols = cols or list(d)
            for k, v in d.items():
                out.setdefault(k, []).extend(v)
        for name in self.last_fetch.get("columns", []):
            out.setdefault(name, [])
        return out

    def query(self, sql: str, timeout: Optional[float] = None) -> dict:
        """One-shot convenience: execute + fetch_pydict."""
        return self.fetch_pydict(self.execute(sql=sql), timeout=timeout)

    def cancel(self, query_id: str) -> bool:
        """Cancel a submitted query; True when the cancellation was
        delivered (the fetch will then answer a typed ``cancelled`` error)."""
        return bool(self._request({"verb": "cancel",
                                   "query_id": query_id}).get("cancelled"))

    def stats(self) -> dict:
        """Server-side gateway/serving metrics + result-cache occupancy."""
        return self._request({"verb": "stats"})
