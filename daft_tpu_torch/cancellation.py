"""Cooperative query cancellation token (counterpart of
daft_tpu/cancellation.py).

A thread-local cancellation event installed around a query's execution (the
serving tier installs the ServeFuture's cancel event in its session worker
thread). Engine layers that reach natural yield points — the serving
executor between streamed result partitions, the HBM admission wait — call
``raise_if_cancelled()``; nothing polls, nothing pays when no token is
installed (one thread-local attribute read).

Cancellation is BEST-EFFORT by design: a device stage already running
completes (its results are discarded), kernels are never interrupted
mid-launch, and a query past its last check point resolves normally. What is
guaranteed: a still-queued serving query never starts at all
(ServeFuture.cancel pulls it from the FairAdmissionQueue), and a running one
stops at its next check.
"""

from __future__ import annotations

import threading


class QueryCancelled(RuntimeError):
    """Raised inside a cancelled query's execution; carried to the caller by
    whatever future/iterator was driving it."""


_TL = threading.local()


def set_cancel_event(ev) -> None:
    """Install (or clear, with None) this thread's cancellation event."""
    _TL.ev = ev


def cancel_event():
    return getattr(_TL, "ev", None)


def raise_if_cancelled(message: str = "query cancelled") -> None:
    ev = getattr(_TL, "ev", None)
    if ev is not None and ev.is_set():
        raise QueryCancelled(message)
