"""The shuffle fetch server: partition files served over authenticated TCP
(counterpart of daft_tpu/distributed/fetch_server.py).

Every host that runs map tasks serves its shuffle directory; a reduce task
fetches each partition from every endpoint and merges. The transport is a
multiprocessing.connection TCP listener with its HMAC challenge, serving
the Arrow IPC files shuffle.py writes, decoded by io/arrow_ipc.py.

Protocol (pickle frames over the authenticated connection):
    -> ("list",   shuffle_id, partition_idx)         <- ("files", [name, ...])
    -> ("fetch",  shuffle_id, partition_idx, name)   <- ("file", bytes)
    -> ("fetchs", shuffle_id, partition_idx, name)   <- ("part", bytes)* ("end", total)
    -> ("bye",)                                       closes the connection

"fetch" sends a whole file in one frame (the serial path); "fetchs" streams
it in chunks so the first batch decodes before the last byte arrives.
Replies on one connection keep request order, so a client pipelines: it
asks for file k+1 while still draining file k.

``fetch_partition`` runs one fetch thread per endpoint (up to
``shuffle_fetch_parallelism``) into a queue of ``shuffle_prefetch_batches``
decoded batches; with 1 and 0 it is the serial loop, no threads and no
queue. A connection refused past ``DAFT_TPU_FETCH_RETRIES`` or lost
mid-stream raises ``ShufflePeerUnreachable``; an expected map file that no
endpoint lists raises ``ShuffleDataLost``.
"""

from __future__ import annotations

import io
import os
import queue as _queue
import re
import secrets
import threading
import time
from multiprocessing import AuthenticationError
from multiprocessing.connection import Client, Listener
from typing import Iterator, List, Optional, Tuple

from ..core.micropartition import MicroPartition
from ..io import arrow_ipc
from ..observability.metrics import registry
from ..schema import Schema
from ..utils.env import env_int
from . import faults
from .shuffle import (ShuffleDataLost, ShufflePeerUnreachable, _note_fetch,
                      _note_fetch_wall, check_expected_maps, iter_ipc_batches,
                      partition_dir)

_SAFE_ID = re.compile(r"^[A-Za-z0-9_\-]+$")
_SAFE_FILE = re.compile(r"^m\d+\.arrow$")

# chunk size for the streamed "fetchs" reply — big enough to amortize the
# pickle-frame overhead, small enough that a batch decodes mid-file
_STREAM_CHUNK = 512 * 1024

Endpoint = Tuple[str, int, str]  # (host, port, authkey_hex)


class _FetchAborted(Exception):
    """Internal: the consumer closed the fetch generator (stop event set);
    producer threads unwind promptly instead of blocking in recv() forever
    against a stalled peer — no leaked threads or connection fds."""


def _recv_interruptible(conn, stop):
    """conn.recv() that polls in short slices so a set stop event aborts the
    wait (a blocking recv would never observe it)."""
    while not conn.poll(0.1):
        if stop.is_set():
            raise _FetchAborted()
    return conn.recv()


# transient-connect retry schedule: first retry after _RETRY_BASE_S, doubling,
# capped — a peer mid-restart answers within a few hundred ms; a DEAD peer
# should be classified quickly so map regeneration can start
_RETRY_BASE_S = 0.05
_RETRY_CAP_S = 0.5

_TRANSIENT_CONNECT_ERRORS = (EOFError, OSError)  # OSError covers every Connection*Error


def _fetch_retries() -> int:
    return env_int("DAFT_TPU_FETCH_RETRIES", 2, lo=0)


def _connect_retrying(ep: Endpoint, shuffle_id: str, stop=None):
    """Connect to a fetch peer, retrying refused/reset handshakes with capped
    exponential backoff (DAFT_TPU_FETCH_RETRIES, default 2) so a peer
    mid-restart doesn't immediately classify as dead and trigger map
    regeneration. Exhaustion raises ShufflePeerUnreachable — the signal the
    coordinator's recovery path regenerates from."""
    host, port, key_hex = ep
    retries = _fetch_retries()
    delay = _RETRY_BASE_S
    last: Optional[BaseException] = None
    for attempt in range(retries + 1):
        try:
            return Client((host, port), family="AF_INET",
                          authkey=bytes.fromhex(key_hex))
        except _TRANSIENT_CONNECT_ERRORS as e:
            last = e
            if attempt >= retries:
                break
            registry().inc("fetch_retries_total")
            if stop is not None:
                if stop.wait(delay):
                    raise _FetchAborted()
            else:
                time.sleep(delay)
            delay = min(delay * 2, _RETRY_CAP_S)
    raise ShufflePeerUnreachable(
        shuffle_id,
        f"shuffle {shuffle_id}: peer {host}:{port} unreachable after "
        f"{retries + 1} attempts ({type(last).__name__}: {last})")


class ShuffleFetchServer:
    """Serves one host's shuffle directory. Thread-per-connection; all state
    is the immutable base path, so concurrent fetches need no locks."""

    def __init__(self, base: str, host: str = "127.0.0.1", port: int = 0,
                 authkey: Optional[bytes] = None):
        self.base = base
        self.authkey = authkey if authkey is not None else secrets.token_bytes(32)
        self._listener = Listener((host, port), family="AF_INET", authkey=self.authkey)
        self._closed = False
        self._threads: List[threading.Thread] = []
        # served-request counters (reference: flight_server metrics); mirrored
        # into the metrics registry so EXPLAIN ANALYZE / bench can attribute
        # transport traffic
        self._stats_lock = threading.Lock()
        self.requests = 0
        self.bytes_served = 0
        t = threading.Thread(target=self._accept_loop, daemon=True,
                             name="daft-shuffle-fetch")
        t.start()
        self._threads.append(t)

    def _note_request(self, nbytes: int = 0) -> None:
        with self._stats_lock:
            self.requests += 1
            self.bytes_served += nbytes
        registry().inc("shuffle_fetch_server_requests")
        if nbytes:
            registry().inc("shuffle_fetch_server_bytes", nbytes)

    def stats(self) -> dict:
        with self._stats_lock:
            return {"requests": self.requests, "bytes_served": self.bytes_served}

    @property
    def endpoint(self) -> Endpoint:
        host, port = self._listener.address
        return (host, port, self.authkey.hex())

    def _accept_loop(self) -> None:
        # a rejected handshake (bad auth, reset mid-challenge) is per-client
        # and cheap to retry; a PERSISTENT accept error (fd exhaustion,
        # half-closed listener) must not spin the thread hot — back off
        # exponentially, resetting once an accept succeeds again
        backoff = 0.005
        while not self._closed:
            try:
                conn = self._listener.accept()
                backoff = 0.005
            except (OSError, EOFError, AuthenticationError):
                if self._closed:
                    return
                time.sleep(backoff)
                backoff = min(backoff * 2, 0.25)
                continue
            threading.Thread(target=self._serve, args=(conn,), daemon=True,
                             name="daft-shuffle-conn").start()

    def _serve(self, conn) -> None:
        try:
            while True:
                try:
                    msg = conn.recv()
                except (EOFError, OSError):
                    return
                if not msg or msg[0] == "bye":
                    return
                try:
                    if msg[0] == "list":
                        _kind, sid, pidx = msg
                        self._note_request()
                        conn.send(("files", self._list(sid, int(pidx))))
                    elif msg[0] == "fetch":
                        _kind, sid, pidx, name = msg
                        data = self._read(sid, int(pidx), name)
                        self._note_request(len(data))
                        conn.send(("file", data))
                    elif msg[0] == "fetchs":
                        _kind, sid, pidx, name = msg
                        total = 0
                        for chunk in self._read_chunks(sid, int(pidx), name):
                            total += len(chunk)
                            conn.send(("part", chunk))
                        conn.send(("end", total))
                        self._note_request(total)
                    else:
                        conn.send(("error", f"unknown request {msg[0]!r}"))
                except Exception as e:  # noqa: BLE001 — refuse the request, keep serving
                    try:
                        conn.send(("error", f"{type(e).__name__}: {e}"))
                    except (BrokenPipeError, OSError):
                        return  # client hung up mid-reply (abandoned fetch)
        finally:
            conn.close()

    def _pdir(self, shuffle_id: str, partition_idx: int) -> str:
        if not _SAFE_ID.match(shuffle_id):
            raise ValueError(f"bad shuffle id {shuffle_id!r}")
        return partition_dir(self.base, shuffle_id, partition_idx)

    def _list(self, shuffle_id: str, partition_idx: int) -> List[str]:
        d = self._pdir(shuffle_id, partition_idx)
        if not os.path.isdir(d):
            return []
        return sorted(n for n in os.listdir(d) if _SAFE_FILE.match(n))

    def _path(self, shuffle_id: str, partition_idx: int, name: str) -> str:
        if not _SAFE_FILE.match(name):
            raise ValueError(f"bad shuffle file name {name!r}")
        return os.path.join(self._pdir(shuffle_id, partition_idx), name)

    def _read(self, shuffle_id: str, partition_idx: int, name: str) -> bytes:
        with open(self._path(shuffle_id, partition_idx, name), "rb") as f:
            return f.read()

    def _read_chunks(self, shuffle_id: str, partition_idx: int,
                     name: str) -> Iterator[bytes]:
        with open(self._path(shuffle_id, partition_idx, name), "rb") as f:
            while True:
                chunk = f.read(_STREAM_CHUNK)
                if not chunk:
                    return
                yield chunk

    def close(self) -> None:
        self._closed = True
        try:
            self._listener.close()
        except OSError:
            pass


class _FrameStream(io.RawIOBase):
    """Readable over one "fetchs" reply: ("part", bytes)* then ("end", total).

    Pulls frames from the connection on demand — the IPC stream reader layered
    on top decodes batch k while the server is still sending batch k+1's
    bytes. `drain()` consumes any unread tail so the connection is positioned
    at the next reply (the pipelined request's frames must never leak into
    this file's reader or vice versa)."""

    def __init__(self, conn, stop=None):
        self._conn = conn
        self._stop = stop
        self._buf = b""
        self._eof = False
        self.total = 0     # wire bytes, valid once the "end" frame was seen
        self.received = 0  # wire bytes seen so far (partial-fetch accounting)

    def readable(self) -> bool:
        return True

    def _pump(self) -> None:
        msg = _recv_interruptible(self._conn, self._stop) \
            if self._stop is not None else self._conn.recv()
        kind = msg[0]
        if kind == "part":
            self._buf += msg[1]
            self.received += len(msg[1])
        elif kind == "end":
            self._eof = True
            self.total = int(msg[1])
        elif kind == "error":
            raise RuntimeError(f"shuffle fetch refused: {msg[1]}")
        else:
            raise RuntimeError(f"unexpected shuffle frame {kind!r}")

    def readinto(self, b) -> int:
        while not self._buf:
            if self._eof:
                return 0
            self._pump()
        n = min(len(b), len(self._buf))
        b[:n] = self._buf[:n]
        self._buf = self._buf[n:]
        return n

    def drain(self) -> None:
        while not self._eof:
            self._buf = b""
            self._pump()
        self._buf = b""


def fetch_partition(endpoints: List[Endpoint], shuffle_id: str, partition_idx: int,
                    schema: Schema, parallelism: Optional[int] = None,
                    prefetch: Optional[int] = None,
                    expected_maps=None) -> Iterator[MicroPartition]:
    """Stream one shuffle partition by fetching every map file from every
    endpoint (the reference's flight-client fan-in, get_flight_client +
    do_get per partition). Fetch volume/latency is recorded into the active
    ShuffleRecorder (shuffle.py) for per-task transport attribution.

    `parallelism`/`prefetch` default from ExecutionConfig
    (shuffle_fetch_parallelism / shuffle_prefetch_batches). parallelism<=1
    with prefetch==0 selects the serial compatibility path — one endpoint at
    a time, one whole-file request in flight, no threads, no queue.

    `expected_maps` arms the completeness check: once every endpoint has
    listed its files, any expected map file seen on NO endpoint raises
    ShuffleDataLost (missing files never silently shrink a reduce input).
    Peer failures classify distinctly: a connect that stays refused past the
    retry budget, or a connection reset mid-stream, raises
    ShufflePeerUnreachable — both are the coordinator's regeneration triggers."""
    if not endpoints:
        check_expected_maps(shuffle_id, expected_maps, ())
        return
    if faults.ENABLED:
        # stage filter resolves via faults.set_stage (worker loop)
        faults.maybe_trip("fetch")
    if parallelism is None or prefetch is None:
        from ..config import execution_config

        cfg = execution_config()
        if parallelism is None:
            parallelism = cfg.shuffle_fetch_parallelism
        if prefetch is None:
            prefetch = cfg.shuffle_prefetch_batches
    if parallelism <= 1 and prefetch == 0:
        inner = _fetch_serial(endpoints, shuffle_id, partition_idx, schema,
                              expected_maps)
    else:
        inner = _fetch_pipelined(endpoints, shuffle_id, partition_idx,
                                 schema, parallelism, prefetch, expected_maps)
    # timeline profiling: one "shuffle.fetch" slice per partition fan-in,
    # covering the whole consumption window (transfer overlapped with the
    # consumer's reduce work — the wall window, same axis as fetch_wall)
    from ..observability.runtime_stats import span_iter

    yield from span_iter("shuffle.fetch", "io", inner,
                         shuffle_id=shuffle_id, partition=partition_idx,
                         endpoints=len(endpoints))


def _fetch_serial(endpoints: List[Endpoint], shuffle_id: str, partition_idx: int,
                  schema: Schema, expected_maps=None) -> Iterator[MicroPartition]:
    """The original serial transport: every file from every endpoint, one
    request at a time over one connection. Batches still decode one IPC
    message at a time (bounded memory), but nothing overlaps."""
    seen: set = set()
    for ep in endpoints:
        host, port, _key = ep
        conn = _connect_retrying(ep, shuffle_id)

        def _peer_io(fn, *args):
            # sends fail too (BrokenPipeError on a dead peer), not just
            # recvs: every wire op on an established connection classifies
            # uniformly so the coordinator regenerates instead of failing
            try:
                return fn(*args)
            except (EOFError, OSError) as e:
                raise ShufflePeerUnreachable(
                    shuffle_id, f"shuffle {shuffle_id}: peer {host}:{port} "
                                f"connection lost mid-fetch ({e})")

        try:
            _peer_io(conn.send, ("list", shuffle_id, partition_idx))
            kind, names = _peer_io(conn.recv)
            if kind == "error":
                raise RuntimeError(f"shuffle fetch refused: {names}")
            assert kind == "files", kind
            seen.update(names)
            for name in names:
                t0 = time.perf_counter()
                _peer_io(conn.send, ("fetch", shuffle_id, partition_idx, name))
                kind, data = _peer_io(conn.recv)
                if kind == "error":
                    raise RuntimeError(f"shuffle fetch refused: {data}")
                assert kind == "file", kind
                # yield each batch as it decodes (peak memory: the wire bytes
                # plus ONE decoded batch); segmented timing keeps the
                # consumer's processing between yields out of fetch_seconds.
                # The finally records even when the consumer closes the
                # generator mid-file — the wire bytes WERE transferred
                rows = 0
                spent = 0.0
                t_seg = t0
                try:
                    for rb in iter_ipc_batches(data):
                        batch = arrow_ipc.onto_schema(rb, schema)
                        rows += batch.num_rows
                        spent += time.perf_counter() - t_seg
                        yield MicroPartition(schema, [batch])
                        t_seg = time.perf_counter()
                    spent += time.perf_counter() - t_seg
                finally:
                    _note_fetch(rows, len(data), spent)
            try:
                conn.send(("bye",))
            except (EOFError, OSError):
                pass  # courtesy close only — every file already arrived
        finally:
            conn.close()
    check_expected_maps(shuffle_id, expected_maps, seen)


def _fetch_pipelined(endpoints: List[Endpoint], shuffle_id: str,
                     partition_idx: int, schema: Schema, parallelism: int,
                     prefetch: int, expected_maps=None) -> Iterator[MicroPartition]:
    """Parallel multi-peer fetch with bounded prefetch.

    One thread per endpoint (endpoints round-robined when there are more than
    `parallelism`), each pipelining chunk-streamed "fetchs" requests on its
    connection (the request for file k+1 is sent before file k finishes
    decoding). Decoded batches land in a bounded queue the caller drains —
    the queue depth, not the map-file size, bounds reduce-side memory, and a
    slow consumer backpressures the network naturally.

    Overlap accounting: each request's in-flight time runs from its send to
    its last decoded byte, NET of time this connection spent blocked on the
    full prefetch queue (consumer backpressure is reduce compute, not
    transfer, and must not masquerade as fetch time); summed over requests
    this over-counts the union transfer window by the seconds two requests
    were in flight together — `shuffle_overlap_seconds`."""
    n_threads = min(max(parallelism, 1), len(endpoints))
    groups = [endpoints[i::n_threads] for i in range(n_threads)]
    q: _queue.Queue = _queue.Queue(maxsize=max(prefetch, 1))
    stop = threading.Event()
    agg_lock = threading.Lock()
    agg = {"cum": 0.0, "first_send": None, "last_end": None, "hw": 0}
    seen: set = set()  # file names listed across every endpoint (agg_lock)
    from ..memory.manager import manager

    # budgeted reduce: a fetch thread stuck on the full prefetch queue may
    # DIVERT to a spill file instead of blocking — decoded batches keep
    # landing on disk at transfer speed rather than stalling the peer, and
    # the consumer drains the overflow (prefetching reader) after the
    # thread's queued batches. Unbudgeted queries never divert (and so never
    # touch the spill pool): the queue block IS the backpressure contract.
    divert_ok = manager().limit_bytes() > 0

    def _put(item) -> bool:
        # never block forever: a consumer that stopped draining (closed
        # generator) sets `stop`, and the producer gives up instead of
        # leaking a thread wedged in put()
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except _queue.Full:
                continue
        return False

    def _put_or_divert(item) -> str:
        # "ok" | "stopped" | "divert" — divert only after the queue has been
        # full long enough that this is sustained consumer backpressure,
        # not a transient blip
        t0 = time.perf_counter()
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return "ok"
            except _queue.Full:
                if divert_ok and time.perf_counter() - t0 > 0.25:
                    return "divert"
        return "stopped"

    def _note_send(t: float) -> None:
        with agg_lock:
            if agg["first_send"] is None or t < agg["first_send"]:
                agg["first_send"] = t

    def _note_done(in_flight: float, t_end: float) -> None:
        with agg_lock:
            agg["cum"] += in_flight
            if agg["last_end"] is None or t_end > agg["last_end"]:
                agg["last_end"] = t_end

    def _fetch_endpoint(ep: Endpoint, spill: dict) -> None:
        host, port, _key = ep
        conn = _connect_retrying(ep, shuffle_id, stop)
        try:
            conn.send(("list", shuffle_id, partition_idx))
            # socket-level failures propagate to _run, which classifies them
            # as ShufflePeerUnreachable — one classification site, not three
            kind, names = _recv_interruptible(conn, stop)
            if kind == "error":
                raise RuntimeError(f"shuffle fetch refused: {names}")
            assert kind == "files", kind
            with agg_lock:
                seen.update(names)
            if not names:
                try:
                    conn.send(("bye",))
                except (EOFError, OSError):
                    pass  # courtesy close only — nothing was owed
                return
            send_at: dict = {}
            sent_blocked: dict = {}
            # cumulative seconds THIS connection spent blocked on the full
            # prefetch queue — consumer backpressure, subtracted from every
            # request clock spanning it so reduce compute never masquerades
            # as fetch/overlap time
            tally = {"blocked": 0.0}

            def _send_req(i: int) -> None:
                send_at[i] = time.perf_counter()
                sent_blocked[i] = tally["blocked"]
                _note_send(send_at[i])
                conn.send(("fetchs", shuffle_id, partition_idx, names[i]))

            _send_req(0)
            for i in range(len(names)):
                if i + 1 < len(names):
                    # pipeline: file k+1's request rides behind file k's
                    # reply frames; the server serves in order
                    _send_req(i + 1)
                frames = _FrameStream(conn, stop)
                rows = 0
                for rb in iter_ipc_batches(io.BufferedReader(frames)):
                    batch = arrow_ipc.onto_schema(rb, schema)
                    rows += batch.num_rows
                    if spill["f"] is not None:
                        # this thread already diverted: all later batches
                        # follow (per-thread arrival order is preserved —
                        # the overflow file replays after the queued prefix)
                        spill["f"].append(batch)
                        registry().inc("shuffle_reduce_spill_bytes",
                                       batch.size_bytes())
                        continue
                    t_put = time.perf_counter()
                    res = _put_or_divert(("batch",
                                          MicroPartition(schema, [batch])))
                    if res == "stopped":
                        # consumer gone mid-file: account the transfer that
                        # DID happen (received wire bytes, decoded rows)
                        # before unwinding
                        _note_fetch(rows, frames.received, max(
                            (time.perf_counter() - send_at[i])
                            - (tally["blocked"] - sent_blocked[i]), 0.0))
                        return
                    tally["blocked"] += time.perf_counter() - t_put
                    if res == "divert":
                        from ..memory.spill import SpillFile

                        spill["f"] = SpillFile(schema)
                        spill["f"].append(batch)
                        registry().inc("shuffle_reduce_spill_bytes",
                                       batch.size_bytes())
                        continue
                    sz = q.qsize()
                    with agg_lock:
                        if sz > agg["hw"]:
                            agg["hw"] = sz
                frames.drain()  # position the connection at the next reply
                t_end = time.perf_counter()
                in_flight = max(
                    (t_end - send_at[i])
                    - (tally["blocked"] - sent_blocked[i]), 0.0)
                _note_done(in_flight, t_end)
                _note_fetch(rows, frames.total, in_flight)
            try:
                conn.send(("bye",))
            except (EOFError, OSError):
                pass  # courtesy close only — every file already arrived; a
                # peer exiting now must NOT classify as unreachable (that
                # would trigger spurious full-shuffle regeneration)
        finally:
            conn.close()

    def _run(eps: List[Endpoint]) -> None:
        spill = {"f": None}  # this thread's overflow file, once diverted
        try:
            for ep in eps:
                if stop.is_set():
                    return
                try:
                    _fetch_endpoint(ep, spill)
                except (EOFError, OSError) as e:
                    # peer vanished mid-stream (EOF, reset, broken pipe,
                    # timeout — ANY socket-level failure on an established
                    # connection): classify distinctly so the coordinator
                    # regenerates instead of failing the query
                    host, port, _k = ep
                    raise ShufflePeerUnreachable(
                        shuffle_id,
                        f"shuffle {shuffle_id}: peer {host}:{port} "
                        f"connection lost mid-fetch ({e})")
            if spill["f"] is not None:
                # hand the overflow to the consumer (it deletes after replay)
                if _put(("spill", spill["f"])):
                    spill["f"] = None
            _put(("done", None))
        except _FetchAborted:
            return  # consumer closed the generator; nothing to report
        except Exception as e:  # noqa: BLE001 — crossed to the consumer, re-raised there
            _put(("err", e))
        finally:
            if spill["f"] is not None:
                spill["f"].delete()  # never handed off: clean up here

    threads = [threading.Thread(target=_run, args=(g,), daemon=True,
                                name="daft-shuffle-fetch-client")
               for g in groups]
    for t in threads:
        t.start()
    try:
        done = 0
        while done < len(threads):
            kind, payload = q.get()
            if kind == "done":
                done += 1
            elif kind == "err":
                if isinstance(payload, (ShuffleDataLost, ShufflePeerUnreachable)):
                    raise payload  # typed recovery triggers survive the fan-in
                raise RuntimeError(f"shuffle fetch failed: {payload}") from payload
            elif kind == "spill":
                # replay one thread's diverted overflow (prefetching reader)
                try:
                    for b in payload.read():
                        yield MicroPartition(schema, [b])
                finally:
                    payload.delete()
            else:
                yield payload
        with agg_lock:
            listed = set(seen)
        check_expected_maps(shuffle_id, expected_maps, listed)
    finally:
        stop.set()
        while True:  # unblock producers wedged in put()
            try:
                kind, payload = q.get_nowait()
            except _queue.Empty:
                break
            if kind == "spill":
                payload.delete()  # overflow never replayed: remove the file
        for t in threads:
            t.join(timeout=5)
        with agg_lock:
            cum, hw = agg["cum"], agg["hw"]
            window = (agg["last_end"] - agg["first_send"]) \
                if agg["first_send"] is not None and agg["last_end"] is not None \
                else 0.0
        _note_fetch_wall(window, n_threads, max(cum - window, 0.0))
        registry().set_gauge_max("shuffle_fetch_inflight", hw)
