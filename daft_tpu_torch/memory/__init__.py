"""Process-wide host memory management: the out-of-core tier (counterpart
of daft_tpu/memory/).

``manager()`` is the one byte ledger the host's memory-hungry operators
(sort, aggregation, join build, window) admit against, and ``spill.py``
the spill files (the port's own format, snappy or no codec), Grace hash
partitions and sorted runs they switch to when the ledger says no.
``execution/memory.py`` is the executor's view over this package.
"""

from .manager import (HostMemoryManager, LedgerBudget, QueryMemoryScope, manager,
                      operator_budget, system_ram_bytes)
from .spill import (SpillFile, SpillPartitions, gc_stale_spills, prefetch_iter,
                    reset_counters, spill_root)

__all__ = [
    "HostMemoryManager", "LedgerBudget", "QueryMemoryScope", "manager", "operator_budget",
    "system_ram_bytes", "SpillFile", "SpillPartitions", "gc_stale_spills", "prefetch_iter",
    "reset_counters", "spill_root",
]
