"""The executor's view over the host memory tier (counterpart of
daft_tpu/execution/memory.py): the ledger's admission handles, the spill
files, and the counters' reset."""

from __future__ import annotations

from ..memory.manager import (HostMemoryManager, LedgerBudget,  # noqa: F401
                              manager, operator_budget)
from ..memory.spill import (SpillFile, SpillPartitions,  # noqa: F401
                            gc_stale_spills, reset_counters, spill_root)
