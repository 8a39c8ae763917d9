"""Socket helpers of the distributed worker pool (counterpart of daft_tpu/utils/sockets.py)."""

from __future__ import annotations

import queue
import threading


class DeadlineAcceptor:
    """listener.accept() with a wall-clock deadline and no lost connections.

    multiprocessing's accept() performs the HMAC auth handshake on the
    accepted socket in BLOCKING mode, so a stranger that connects and sends
    nothing would hang a naive caller forever. Accepts run in background
    threads feeding a queue; accept(timeout) polls the queue. A completed
    handshake is NEVER discarded (late arrivals are picked up by the next
    call), and a stalled stranger only pins one of the bounded accept threads
    — the caller keeps its deadline and reports an error instead of hanging.
    """

    _MAX_THREADS = 8

    def __init__(self, listener):
        self.listener = listener
        self._q: queue.Queue = queue.Queue()
        self._inflight = 0
        self._lock = threading.Lock()

    def _spawn(self) -> None:
        with self._lock:
            if self._inflight >= self._MAX_THREADS:
                return
            self._inflight += 1

        def run():
            try:
                conn = self.listener.accept()
                self._q.put(conn)
            except Exception as e:  # noqa: BLE001 — surfaced to the caller
                self._q.put(e)
            finally:
                with self._lock:
                    self._inflight -= 1

        threading.Thread(target=run, daemon=True).start()

    def accept(self, timeout_s: float):
        """Returns a connection, None on timeout, or raises accept's error
        (e.g. AuthenticationError for a wrong-key client)."""
        with self._lock:
            need = self._inflight == 0
        if need:
            self._spawn()
        try:
            item = self._q.get(timeout=timeout_s)
        except queue.Empty:
            # current accept may be pinned by a stalled handshake; allow one
            # more concurrent accept so real workers still get through
            self._spawn()
            return None
        if isinstance(item, Exception):
            raise item
        return item
