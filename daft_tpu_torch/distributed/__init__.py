"""The distributed tier: sub-plan tasks on local worker processes
(counterpart of daft_tpu/distributed/).

A scheduler places pickled physical sub-plans (``SubPlanTask``) on workers
(``worker.py``: fresh subprocesses over an authenticated UNIX socket);
bulk data moves through a disk-backed Arrow IPC shuffle (``shuffle.py``,
``fetch_server.py`` for the socket transport). ``DistributedRunner`` is the
entry point, registered with ``runners.set_runner``; ``trace.py`` keeps a
query's task, shuffle and heartbeat records.
"""

from .runner import DistributedRunner
from .scheduler import Scheduler, WorkerSnapshot
from .task import Spread, SubPlanTask, TaskResult, WorkerAffinity
from .trace import QueryTrace

__all__ = [
    "DistributedRunner",
    "QueryTrace",
    "Scheduler",
    "Spread",
    "WorkerAffinity",
    "WorkerSnapshot",
    "SubPlanTask",
    "TaskResult",
]
