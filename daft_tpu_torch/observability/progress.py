"""Terminal progress reporting fed by query lifecycle events (counterpart of
daft_tpu/observability/progress.py): a Subscriber, so it works with any
runner and costs nothing when not attached.
"""

from __future__ import annotations

import sys
import time
from typing import Optional

from .events import QueryEnd, QueryStart
from .subscribers import Subscriber, attach_subscriber, detach_subscriber


class ProgressSubscriber(Subscriber):
    """Prints one line per query: spinner while running, summary at the end."""

    def __init__(self, stream=None):
        self.stream = stream or sys.stderr
        self._start: dict = {}

    def on_query_start(self, event: QueryStart) -> None:
        self._start[event.query_id] = time.perf_counter()
        if self.stream.isatty():
            self.stream.write(f"\r⏳ query {event.query_id} running...")
            self.stream.flush()

    def on_query_end(self, event: QueryEnd) -> None:
        t0 = self._start.pop(event.query_id, None)
        dt = f"{event.seconds:.2f}s" if t0 is not None else "?"
        status = "✗ " + (event.error or "") if event.error else "✓"
        if self.stream.isatty():
            self.stream.write("\r\x1b[2K")
        self.stream.write(
            f"{status} query {event.query_id}: {event.rows} rows in {dt}\n")
        self.stream.flush()


_active: Optional[ProgressSubscriber] = None


def enable_progress() -> None:
    global _active
    if _active is None:
        _active = ProgressSubscriber()
        attach_subscriber(_active)


def disable_progress() -> None:
    global _active
    if _active is not None:
        detach_subscriber(_active)
        _active = None
