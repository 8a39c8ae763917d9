"""The shared compute thread pool (counterpart of daft_tpu/utils/pool.py).

numpy's large operations release the GIL, so morsels fan out on threads.
The pool is ``os.cpu_count()`` wide, or ``DAFT_TPU_NUM_THREADS`` where that
is set (at least 1). A pool task never submits to this pool and waits on
it: ``pool_map`` is called from a stage thread or the caller's thread.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

_POOL: Optional[ThreadPoolExecutor] = None


def _env_threads() -> int:
    default = os.cpu_count() or 4
    try:
        n = int(os.environ.get("DAFT_TPU_NUM_THREADS", default))
    except ValueError:
        n = default
    return max(n, 1)


def compute_pool() -> ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = ThreadPoolExecutor(max_workers=_env_threads(),
                                   thread_name_prefix="daft-compute")
    return _POOL


def pool_width() -> int:
    """The compute pool's number of worker threads."""
    return compute_pool()._max_workers


def pool_map(fn, items):
    """``[fn(x) for x in items]`` on the pool, in order; 0 or 1 items run on
    the caller's thread."""
    items = list(items)
    if len(items) <= 1:
        return [fn(x) for x in items]
    return list(compute_pool().map(fn, items))
