"""Prepared-query cache (counterpart of daft_tpu/serving/prepared.py): the
optimized plan, the physical plan and the pin-bytes estimate, keyed by the
logical plan's STRUCTURE, under the residency manager's literal-compare
contract.

A serving session's repeat query skips the optimizer and the physical
translation and executes the cached physical plan, whose device stages then
land on the warm device planes (residency rebinds by content, the decision
caches hold the cost model's verdicts for the same structural keys, the
stage caches hold the built stages): a repeat is admission, dispatch and
copy back.

Key contract (as device/residency.py ``expr_structure``): the key is the
plan's skeleton (node types, masked expressions, source identity tokens),
and the literal values are stored in the entry and compared on lookup. Two
plans that differ only in predicate literals never share an entry: the
mismatch replans and replaces the slot (one slot per query shape), so a
stream of varying literals stays bounded and a stale-literal plan is never
served.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict
from typing import Any, List, Tuple

from ..device.residency import expr_structure, identity_token
from ..expressions.expressions import Expression
from ..observability.metrics import registry
from ..schema import Schema

# prepared entries kept per cache (LRU on lookup order): serving sessions see
# a bounded set of query shapes; past the cap the coldest shape replans
DEFAULT_PREPARED_CAP = 64


def _walk(plan):
    yield plan
    for c in plan.children():
        yield from _walk(c)


def plan_structure(plan) -> Tuple[tuple, tuple]:
    """(skeleton, literals) of one LOGICAL plan (a DataFrame's ``_plan``).

    The skeleton walks the plan preorder; each node gives its type name and
    every public field, expressions masked to their literal-free skeletons
    (the literals collected apart, in walk order), child plans reduced to a
    marker (the preorder walk carries the shape), schemas to their names and
    types, and in-memory partitions and any other object (scan operators, UDF
    handles) to identity tokens (device/residency.py: monotonic, never
    reused, so a new table never aliases a dead one)."""
    skel: List[tuple] = []
    lits: List[tuple] = []
    for node in _walk(plan):
        row: List[Any] = [type(node).__name__]
        fields = vars(node)
        for name in sorted(fields):
            if name.startswith("_"):
                continue
            row.append(name)
            row.append(_field_key(fields[name], lits))
        skel.append(tuple(row))
    return tuple(skel), tuple(lits)


def _field_key(val, lits: List[tuple]):
    from ..plan.logical import LogicalPlan

    if isinstance(val, LogicalPlan):
        return "<child>"
    if isinstance(val, Expression):
        s, lit = expr_structure(val)
        lits.extend(lit)
        return ("expr", s)
    if isinstance(val, Schema):
        return ("schema", tuple((f.name, repr(f.dtype)) for f in val))
    if isinstance(val, (list, tuple)):
        return tuple(_field_key(v, lits) for v in val)
    if isinstance(val, (str, int, float, bool, bytes, type(None))):
        return ("p", val)
    if isinstance(val, dict):
        return tuple((k, _field_key(v, lits)) for k, v in sorted(val.items()))
    # partitions, scan operators, UDF handles: same object, same slot; a
    # rebuilt source replans
    return ("id", type(val).__name__, identity_token(val))


def estimate_pin_bytes(physical, fingerprint=None) -> int:
    """The device bytes one physical plan's run is expected to pin, for the
    HBM admission controller (ResidencyManager.admit): the slot bytes of its
    fingerprint (distributed/affinity.py ``plan_fingerprint``), or, where
    that is empty (the join stages' slots are left out of it), the in-memory
    input bytes under each device node, a coarse upper bound. A host plan
    estimates 0 and admits at once. Advisory: a failure counts as 0.
    ``fingerprint``: the plan's fingerprint where the caller has it."""
    from ..distributed.affinity import plan_fingerprint
    from ..plan import physical as pp

    fp = plan_fingerprint(physical) if fingerprint is None else fingerprint
    total = sum(est for _k, est in fp)
    if total:
        return total
    device_types = (pp.DeviceGroupedAgg, pp.DeviceFilterAgg, pp.DeviceJoinAgg,
                    pp.DeviceJoinTopN, pp.DeviceUdfProject)
    try:
        for node in physical.walk():
            if isinstance(node, device_types):
                for scan in (n for n in node.walk() if isinstance(n, pp.InMemoryScan)):
                    for part in scan.partitions:
                        for b in part.batches:
                            total += b.size_bytes()
    except Exception:  # noqa: BLE001 -- the estimate is advisory
        return total
    return total


class PreparedEntry:
    __slots__ = ("literals", "plan", "physical", "est_pin_bytes", "fingerprint", "hits",
                 "plan_seconds", "observed_pin_bytes", "_est_upper_bytes")

    def __init__(self, literals, plan, physical, est_pin_bytes: int, fingerprint,
                 plan_seconds: float):
        self.literals = literals
        self.plan = plan                # the optimized logical plan
        self.physical = physical        # the cached physical plan
        self.est_pin_bytes = est_pin_bytes
        self.fingerprint = fingerprint  # (slot_key, est_bytes) pairs
        self.hits = 0
        self.plan_seconds = plan_seconds
        # the most pin-scope bytes observed across this entry's runs (None
        # before the first), and the fingerprint's upper bound the
        # calibrated estimate can climb back to
        self.observed_pin_bytes = None
        self._est_upper_bytes = est_pin_bytes

    def note_observed_pin(self, observed: int) -> None:
        """Calibrate the reservation toward the observed pin-scope
        high-water: ``est = min(upper bound, max observed)``. A warm repeat
        reserves what repeats pin, so admission packs tighter; since the
        floor is the most seen so far, a cold run's partial working set
        cannot under-reserve for good. A zero observation (a run that pinned
        nothing: the host path) is discarded."""
        observed = int(observed)
        if observed <= 0:
            return
        prev = self.observed_pin_bytes
        self.observed_pin_bytes = observed if prev is None else max(prev, observed)
        new_est = min(self._est_upper_bytes, self.observed_pin_bytes)
        if new_est < self.est_pin_bytes:
            registry().inc("serve_pin_calibrations")
        self.est_pin_bytes = new_est


class PreparedQueryCache:
    """Thread-safe bounded cache of prepared queries, one slot per plan
    skeleton."""

    def __init__(self, cap: int = DEFAULT_PREPARED_CAP):
        self._lock = threading.Lock()
        self._entries: "OrderedDict[tuple, PreparedEntry]" = OrderedDict()
        self.cap = cap

    def get_or_plan(self, plan) -> Tuple[PreparedEntry, bool]:
        """(entry, hit) for a logical plan. A hit needs the skeleton to match
        and the stored literals to equal the query's; a literal mismatch
        replans in the same slot."""
        skel, lits = plan_structure(plan)
        with self._lock:
            e = self._entries.get(skel)
            if e is not None and e.literals == lits:
                self._entries.move_to_end(skel)
                e.hits += 1
                registry().inc("serve_prepared_hits")
                return e, True
        from ..distributed.affinity import plan_fingerprint
        from ..plan.optimizer import Optimizer
        from ..plan.physical import translate

        t0 = time.perf_counter()
        optimized = Optimizer().optimize(plan)
        physical = translate(optimized)
        fp = plan_fingerprint(physical)
        e = PreparedEntry(lits, optimized, physical, estimate_pin_bytes(physical, fp), fp,
                          time.perf_counter() - t0)
        with self._lock:
            self._entries[skel] = e
            self._entries.move_to_end(skel)
            while len(self._entries) > self.cap:
                self._entries.popitem(last=False)
        registry().inc("serve_prepared_misses")
        return e, False

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
