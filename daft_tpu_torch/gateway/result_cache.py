"""Gateway result cache (counterpart of daft_tpu/gateway/result_cache.py):
encoded result payloads keyed by content fingerprint.

The cache key is ``checkpoint.stages.query_fingerprint`` — a digest over the
physical plan's structural walk **plus the content fingerprint of every
in-memory source column**. Source data changing therefore changes the key,
so invalidation is free and exact: a stale entry can never be served because
a mutated source simply hashes to a different key (the stale bytes age out
of the LRU instead). Queries that cannot be keyed (fingerprint ``None``)
bypass the cache entirely.

Entries hold the *wire-encoded* chunks (compressed Arrow IPC streams), not
MicroPartitions: a hit streams straight to the socket with zero re-encoding,
and the byte budget meters exactly what the cache actually holds.

Budget and accounting: ``DAFT_TPU_GATEWAY_RESULT_CACHE`` bounds resident
bytes (0 disables the cache); evictions are LRU. When the host memory ledger
is active (memory/manager.py, a ``memory_limit_bytes`` > 0) cached bytes are
tracked against it so serving pressure and execution pressure share one
accounting.
Counters: ``result_cache_hits`` / ``result_cache_misses`` /
``result_cache_evictions`` and the ``result_cache_bytes`` gauge.

Thrash detection (flight-recorder hook): a sliding window of recent lookups;
when the window shows repeat traffic (fewer distinct keys than lookups) yet
the hit rate sits below ``DAFT_TPU_GATEWAY_THRASH_RATIO``, the cache is
churning — the budget is too small for the working set — and ``note_thrash``
returns a detail string the gateway turns into a ``cache_thrash`` anomaly
trigger, which tools/doctor.py diagnoses from the dump alone.
"""

from __future__ import annotations

import threading
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from ..observability.metrics import registry
from ..utils.env import env_float, env_int


def result_cache_budget() -> int:
    """DAFT_TPU_GATEWAY_RESULT_CACHE: resident-byte budget for cached result
    payloads (0 disables result caching)."""
    return env_int("DAFT_TPU_GATEWAY_RESULT_CACHE", 64 * 1024 * 1024, lo=0)


class CachedResult:
    """One cached query result: wire-ready chunks + the fetch-reply footer
    fields (rows/columns) so a hit never touches the engine."""

    __slots__ = ("chunks", "rows", "columns", "nbytes")

    def __init__(self, chunks: List[bytes], rows: int, columns: List[str]):
        self.chunks = chunks
        self.rows = rows
        self.columns = columns
        self.nbytes = sum(len(c) for c in chunks)


class ResultCache:
    """LRU over encoded result payloads, bounded by a byte budget, shared
    across tenants (the fingerprint key embeds the data identity, so a
    cross-tenant hit is by construction the same bytes)."""

    def __init__(self, budget_bytes: Optional[int] = None):
        self._budget = (result_cache_budget() if budget_bytes is None
                        else budget_bytes)
        self._lock = threading.Lock()
        self._entries: "OrderedDict[str, CachedResult]" = OrderedDict()
        self._bytes = 0
        self._ledgered = 0  # bytes registered with the host memory ledger
        # thrash window: (key, hit) per lookup, newest last
        self._window: deque = deque(
            maxlen=env_int("DAFT_TPU_GATEWAY_THRASH_WINDOW", 32, lo=4))
        self._thrash_ratio = min(
            env_float("DAFT_TPU_GATEWAY_THRASH_RATIO", 0.25, lo=0.0), 1.0)

    @property
    def budget_bytes(self) -> int:
        return self._budget

    def _ledger_sync(self, manager) -> None:
        """Mirror resident bytes into the host ledger (advisory: only when a
        limit is configured; a 0-limit ledger is untracked by contract)."""
        if manager.limit_bytes() <= 0:
            return
        if self._bytes > self._ledgered:
            manager.track(self._bytes - self._ledgered)
        elif self._ledgered > self._bytes:
            manager.release(self._ledgered - self._bytes)
        self._ledgered = self._bytes

    def get(self, key: Optional[str]) -> Optional[CachedResult]:
        """Lookup; bumps LRU recency and the hit/miss counters. ``None`` key
        (unkeyable query) is a silent bypass, not a miss."""
        if key is None or self._budget <= 0:
            return None
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None:
                self._entries.move_to_end(key)
            self._window.append((key, entry is not None))
        if entry is None:
            registry().inc("result_cache_misses")
        else:
            registry().inc("result_cache_hits")
        return entry

    def put(self, key: Optional[str], entry: CachedResult) -> bool:
        """Insert (idempotent; re-insert refreshes recency). Entries larger
        than the whole budget are refused rather than evicting everything."""
        if key is None or self._budget <= 0 or entry.nbytes > self._budget:
            return False
        from ..memory.manager import manager

        evicted = 0
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = entry
            self._bytes += entry.nbytes
            while self._bytes > self._budget and len(self._entries) > 1:
                _, victim = self._entries.popitem(last=False)
                self._bytes -= victim.nbytes
                evicted += 1
            self._ledger_sync(manager())
            resident = self._bytes
        if evicted:
            registry().inc("result_cache_evictions", evicted)
        registry().set_gauge("result_cache_bytes", resident)
        return True

    def note_thrash(self) -> Optional[str]:
        """Inspect the lookup window; returns an anomaly detail string when
        repeat traffic is missing the cache (budget below working set), else
        None. Consumes the window on detection so one sustained thrash burst
        yields one trigger, not one per lookup."""
        with self._lock:
            if len(self._window) < self._window.maxlen:
                return None
            lookups = list(self._window)
            distinct = len({k for k, _ in lookups})
            hits = sum(1 for _, h in lookups if h)
            rate = hits / len(lookups)
            if distinct >= len(lookups) or rate >= self._thrash_ratio:
                return None
            self._window.clear()
            return (f"result-cache thrash: hit rate {rate:.2f} over last "
                    f"{len(lookups)} lookups ({distinct} distinct keys) — "
                    f"budget {self._budget} bytes below the repeat working "
                    f"set; raise DAFT_TPU_GATEWAY_RESULT_CACHE")

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"entries": len(self._entries), "bytes": self._bytes,
                    "budget": self._budget}

    def clear(self) -> None:
        from ..memory.manager import manager

        with self._lock:
            self._entries.clear()
            self._bytes = 0
            self._ledger_sync(manager())
        registry().set_gauge("result_cache_bytes", 0)
