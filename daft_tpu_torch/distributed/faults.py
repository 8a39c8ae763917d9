"""Fault-injection tripwires armed through the environment (counterpart of
daft_tpu/distributed/faults.py; the worker-side half of the
fault-injection harness; the coordinator-side helpers live in
tests/test_torch_fault_tolerance.py).

A tripwire is armed entirely through the environment — the pool passes its
``env=`` dict into worker subprocesses, so a test arms one worker without
touching any production code path:

- ``DAFT_TPU_FAULT_POINT``: named injection point. Wired points:
    * ``shuffle_map``  — first batch appended by a MapOutputWriter
    * ``fetch``        — entry of a shuffle fetch fan-in (fetch_server client)
    * ``task_start``   — worker loop, before a task executes
    * ``task_sent``    — worker loop, after a task's RESULT was sent (the
      window where a map stage has completed but its files can still be lost)
- ``DAFT_TPU_FAULT_WORKER``: only trip in the worker whose id matches
  (workers export DAFT_TPU_WORKER_ID at startup); empty = any process.
- ``DAFT_TPU_FAULT_STAGE``: only trip when the active stage id starts with
  this prefix (e.g. ``shuffle``); empty = any stage.
- ``DAFT_TPU_FAULT_MODE``:
    * ``kill``       (default) — SIGKILL self: the hard crash
    * ``kill_lose``  — unlink the files the trip point reports (a map task's
      just-published shuffle outputs), then SIGKILL: simulates losing the
      whole host AND its shuffle storage, the per-worker-dir topology
    * ``stop``       — SIGSTOP self: the hung-but-not-dead worker the
      heartbeat-timeout detector must catch
    * ``delay:<s>``  — sleep s seconds, then continue: the 10x straggler
- ``DAFT_TPU_FAULT_ONCE_FILE``: sentinel path created atomically (O_EXCL)
  before tripping so a point fires at most once across every process sharing
  it (a regenerated map task must not re-trip forever).

Zero-overhead contract: call sites guard on the module constant ``ENABLED``
(False unless DAFT_TPU_FAULT_POINT was set when the process started), so the
production path pays one module-attribute read per coarse event.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Iterable, Optional

from ..utils.env import env_str

_POINT = env_str("DAFT_TPU_FAULT_POINT")

# read once at import: fault injection is armed per-process via spawn env
ENABLED = bool(_POINT)

# the stage id of the task this worker is currently executing (set by the
# worker loop): trip sites deep inside shuffle/fetch code don't carry the
# stage id, so the DAFT_TPU_FAULT_STAGE filter falls back to this
_STAGE = ""


def set_stage(stage_id: str) -> None:
    """Record the active task's stage id (worker loop, per task) so the
    stage filter works at trip points that only know a shuffle id."""
    global _STAGE
    _STAGE = stage_id


def maybe_trip(point: str, stage_id: str = "",
               paths: Optional[Iterable[str]] = None) -> None:
    """Fire the armed fault if `point` (and the worker/stage filters) match.
    Never raises — a misconfigured tripwire must not fail a healthy worker."""
    if point != _POINT:
        return
    want_worker = env_str("DAFT_TPU_FAULT_WORKER")
    if want_worker and env_str("DAFT_TPU_WORKER_ID") != want_worker:
        return
    want_stage = env_str("DAFT_TPU_FAULT_STAGE")
    if want_stage and not (stage_id or _STAGE).startswith(want_stage):
        return
    once = env_str("DAFT_TPU_FAULT_ONCE_FILE")
    if once:
        try:
            fd = os.open(once, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            os.close(fd)
        except FileExistsError:
            return  # already fired somewhere
        except OSError:
            return
    mode = env_str("DAFT_TPU_FAULT_MODE", "kill")
    if mode.startswith("delay:"):
        try:
            time.sleep(float(mode.split(":", 1)[1]))
        except ValueError:
            pass
        return
    if mode == "stop" and hasattr(signal, "SIGSTOP"):
        os.kill(os.getpid(), signal.SIGSTOP)
        return
    if mode == "kill_lose":
        for p in paths or ():
            try:
                os.unlink(p)
            except OSError:
                pass
    # "kill" and "kill_lose" end the same way: the unblockable hard crash
    os.kill(os.getpid(), signal.SIGKILL)
