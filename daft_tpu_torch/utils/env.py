"""Defensive environment-variable parsing (counterpart of
daft_tpu/utils/env.py).

One site for the parse-or-default idiom the distributed knobs repeat
(heartbeat cadence, respawn caps, retry budgets): a malformed value NEVER
raises — production knobs must degrade to their defaults, not crash a worker
or coordinator at import/spawn time. `lo` clamps the floor where a knob has one
(slot counts >= 1, retry budgets >= 0).

These four helpers are the port's idiom for reading the observability
tier's knobs (the flight recorder's, the straggler threshold).
"""

from __future__ import annotations

import os
from typing import Optional


def env_int(name: str, default: int, lo: Optional[int] = None) -> int:
    try:
        v = int(os.environ.get(name, default))
    except ValueError:
        v = default
    return v if lo is None else max(v, lo)


def env_float(name: str, default: float, lo: Optional[float] = None) -> float:
    try:
        v = float(os.environ.get(name, default))
    except ValueError:
        v = default
    return v if lo is None else max(v, lo)


def env_str(name: str, default: str = "") -> str:
    """String knob (mode selectors, file paths). Trivial today, but the one
    spelling keeps every knob read greppable and lintable at a single call
    shape."""
    return os.environ.get(name, default)


_FALSY = ("0", "off", "false", "no", "")


def env_bool(name: str, default: bool) -> bool:
    """Flag knob. Absent -> default; set -> anything but a falsy spelling
    ("0"/"off"/"false"/"no"/empty, case-insensitive) counts as on — matching
    the reference's DAFT_TPU_SPECULATIVE=0 convention."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in _FALSY
