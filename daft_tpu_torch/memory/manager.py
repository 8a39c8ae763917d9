"""HostMemoryManager: the process-wide host byte ledger (counterpart of
daft_tpu/memory/manager.py).

One authority knows how many bytes the engine's blocking host operators
hold, against a budget from ``ExecutionConfig.memory_limit_bytes``
(``DAFT_TPU_MEMORY_LIMIT``):

- positive: that many bytes, shared by every admitting operator in the
  process, so concurrent queries draw down one ledger;
- 0 (default): unbounded and untracked. An unbudgeted query allocates no
  ledger state and moves no counter, and its operators run their in-memory
  paths;
- negative: ``memory_fraction`` (0.6) of the system's RAM, probed once.

A blocking operator takes an ``operator_budget()`` handle and admits each
batch it buffers (``RecordBatch.size_bytes``); once the ledger is over the
budget, ``admit`` answers False and the operator switches to its spilling
strategy (execution/executor.py), releasing its bytes as they reach disk
and, in a ``finally``, whatever it still holds. Device stages take no host
budget. Streaming scans admit nothing: they call ``under_pressure()`` /
``wait_for_headroom()`` so a fast producer stalls, for at most ``max_wait``
each time, while the ledger sits at or over ``memory_pressure`` (0.8) of the
budget. The wait is pacing, never a gate on correctness: a budget smaller
than one operator's working set costs throughput, not a deadlock.

Counters (ops/counters.py): ``host_bytes_tracked`` and
``host_bytes_high_water`` (registry gauges), ``host_over_budget_events``,
``scan_backpressure_stalls`` and ``scan_stall_ms``. Each upward crossing of
the pressure threshold is noted by the flight recorder
(observability/flight.py), callbacks or not.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Callable, List, Optional

from ..observability.metrics import registry
from ..ops import counters

# the bounded pacing wait: long enough that a spilling operator usually
# drains the ledger first, short enough that a stuck ledger costs only time
_DEFAULT_MAX_WAIT_S = 0.25


class HostMemoryManager:
    """The process-wide host byte ledger."""

    def __init__(self) -> None:
        self._cond = threading.Condition(threading.Lock())
        self._tracked = 0
        self._high_water = 0
        self._auto_limit: Optional[int] = None
        self._pressure_cbs: List[Callable[[int, int], None]] = []
        self._in_pressure = False
        self._scopes: List["QueryMemoryScope"] = []

    # ---- the budget -----------------------------------------------------------------
    def limit_bytes(self) -> int:
        """The host budget in bytes (0 = unbounded and untracked)."""
        from ..config import execution_config

        b = execution_config().memory_limit_bytes
        if b >= 0:
            return b
        if self._auto_limit is None:
            ram = system_ram_bytes()
            self._auto_limit = int(ram * execution_config().memory_fraction) if ram > 0 else 0
        return self._auto_limit

    # ---- the ledger -----------------------------------------------------------------
    def track(self, nbytes: int) -> None:
        """Admit ``nbytes`` into the ledger (one call per buffered batch)."""
        if nbytes <= 0:
            return
        fire = None
        with self._cond:
            self._tracked += nbytes
            if self._tracked > self._high_water:
                self._high_water = self._tracked
            for s in self._scopes:
                if self._tracked > s._peak:
                    s._peak = self._tracked
            registry().set_gauge("host_bytes_tracked", float(self._tracked))
            registry().set_gauge("host_bytes_high_water", float(self._high_water))
            under = self._under_pressure_locked()
            crossed = False
            if not self._in_pressure and under:
                self._in_pressure = True
                crossed = True
                if self._pressure_cbs:
                    fire = list(self._pressure_cbs)
            elif self._in_pressure and not under:
                self._in_pressure = False
            tracked = self._tracked
        if crossed:
            # the flight recorder sees every crossing, callbacks or not
            from ..observability import flight

            frec = flight.recorder()
            if frec is not None:
                frec.note_pressure(tracked, self.limit_bytes())
        if fire:
            limit = self.limit_bytes()
            for cb in fire:
                try:
                    cb(tracked, limit)
                except Exception:  # noqa: BLE001 -- a broken callback must not fail the admit
                    pass

    def release(self, nbytes: int) -> None:
        if nbytes <= 0:
            return
        with self._cond:
            self._tracked = max(self._tracked - nbytes, 0)
            registry().set_gauge("host_bytes_tracked", float(self._tracked))
            if self._in_pressure and not self._under_pressure_locked():
                self._in_pressure = False
            self._cond.notify_all()

    def tracked_bytes(self) -> int:
        with self._cond:
            return self._tracked

    def high_water_bytes(self) -> int:
        with self._cond:
            return self._high_water

    # ---- pressure -------------------------------------------------------------------
    def _pressure_threshold(self) -> int:
        from ..config import execution_config

        limit = self.limit_bytes()
        if limit <= 0:
            return 0
        return int(limit * execution_config().memory_pressure)

    def _under_pressure_locked(self) -> bool:
        t = self._pressure_threshold()
        return t > 0 and self._tracked >= t

    def under_pressure(self) -> bool:
        """True while the ledger holds at least ``memory_pressure`` of the
        budget: the signal streaming producers pace themselves by."""
        t = self._pressure_threshold()
        if t <= 0:
            return False
        with self._cond:
            return self._tracked >= t

    def wait_for_headroom(self, max_wait_s: float = _DEFAULT_MAX_WAIT_S) -> float:
        """Block while the ledger is under pressure, for at most
        ``max_wait_s``; returns the seconds stalled (counted in
        ``scan_backpressure_stalls`` and ``scan_stall_ms``)."""
        if not self.under_pressure():
            return 0.0
        t0 = time.perf_counter()
        deadline = t0 + max_wait_s
        with self._cond:
            while self._under_pressure_locked():
                now = time.perf_counter()
                if now >= deadline:
                    break
                self._cond.wait(min(0.02, deadline - now))
        stalled = time.perf_counter() - t0
        counters.bump("scan_backpressure_stalls")
        counters.bump("scan_stall_ms", max(int(stalled * 1000), 1))
        return stalled

    def on_pressure(self, cb: Callable[[int, int], None]) -> Callable[[], None]:
        """Register ``cb(tracked_bytes, limit_bytes)``, called once on each
        upward crossing of the pressure threshold; returns the unsubscribe."""
        with self._cond:
            self._pressure_cbs.append(cb)

        def _unsub() -> None:
            with self._cond:
                if cb in self._pressure_cbs:
                    self._pressure_cbs.remove(cb)

        return _unsub

    # ---- admission ------------------------------------------------------------------
    def operator_budget(self) -> "LedgerBudget":
        """The admission handle of one blocking operator; inert (pure
        arithmetic) when no budget is in force."""
        return LedgerBudget(self, self.limit_bytes())

    @contextlib.contextmanager
    def query_scope(self):
        """Bracket one query to observe its ledger footprint: the scope's
        ``peak_bytes()`` is the ledger's peak while it was open (process
        wide). Releasing does not depend on scopes: every operator budget
        releases in its own ``finally``."""
        scope = QueryMemoryScope()
        with self._cond:
            self._scopes.append(scope)
            scope._peak = self._tracked
        try:
            yield scope
        finally:
            with self._cond:
                if scope in self._scopes:
                    self._scopes.remove(scope)

    def clear(self) -> None:
        """Drop the ledger's state (a test hook); the counters are
        ``spill.reset_counters``'."""
        with self._cond:
            self._tracked = 0
            self._high_water = 0
            self._auto_limit = None
            self._in_pressure = False
            self._pressure_cbs.clear()
            self._scopes.clear()
            registry().set_gauge("host_bytes_tracked", 0.0)
            registry().set_gauge("host_bytes_high_water", 0.0)


class QueryMemoryScope:
    """What ``query_scope()`` yields: the ledger's peak while it was open."""

    __slots__ = ("_peak",)

    def __init__(self) -> None:
        self._peak = 0

    def peak_bytes(self) -> int:
        return self._peak


class LedgerBudget:
    """The byte account of one blocking operator, drawn on the shared
    ledger. ``admit`` answers True while the ledger stays within the
    budget, so two queries each buffering 60 % of it both spill. With no
    budget (limit <= 0) the handle is arithmetic alone. The operator owns
    the release: ``release`` as batches reach disk, ``close`` in a
    ``finally``, so a failed query leaves the ledger where it found it."""

    __slots__ = ("_mgr", "limit", "used", "_over_counted")

    def __init__(self, mgr: HostMemoryManager, limit: int):
        self._mgr = mgr
        self.limit = limit
        self.used = 0
        self._over_counted = False

    def admit(self, nbytes: int) -> bool:
        """Account ``nbytes``; True while the ledger is within budget."""
        self.used += nbytes
        if self.limit <= 0:
            return True
        self._mgr.track(nbytes)
        ok = self._mgr.tracked_bytes() <= self.limit
        if not ok and not self._over_counted:
            self._over_counted = True
            counters.bump("host_over_budget_events")
        return ok

    def release(self, nbytes: int) -> None:
        """Return ``nbytes`` (at most what is held) to the ledger."""
        n = min(nbytes, self.used)
        if n <= 0:
            return
        self.used -= n
        if self.limit > 0:
            self._mgr.release(n)

    def release_all(self) -> None:
        if self.limit > 0 and self.used:
            self._mgr.release(self.used)
        self.used = 0

    def close(self) -> None:
        self.release_all()


def system_ram_bytes() -> int:
    """Physical RAM, or 0 where the platform does not say."""
    try:
        pages = os.sysconf("SC_PHYS_PAGES")
        page = os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return 0
    if pages <= 0 or page <= 0:
        return 0
    return int(pages) * int(page)


_MANAGER = HostMemoryManager()


def manager() -> HostMemoryManager:
    """The process-wide host memory manager."""
    return _MANAGER


def operator_budget() -> LedgerBudget:
    """An admission handle on the process ledger for one blocking operator."""
    return _MANAGER.operator_budget()
