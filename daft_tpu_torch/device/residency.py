"""Device residency manager (counterpart of daft_tpu/device/residency.py, the
subset the grouped-aggregation and join slices need).

A process-wide registry of values built from host objects (column planes,
dictionary-code planes, join index planes, probe tables, synthetic dim
columns), keyed by (anchor identity, slot key): repeated queries over a
table reuse them instead of rebuilding and re-uploading. An entry is a hit
only while every object in its ``deps`` is the identical object (strong
references held in the entry, so a freed object can never alias a new one)
and its ``literals`` compare equal; a miss rebuilds the slot in place, so
queries that differ only in predicate literals reuse one slot per query
shape (``expr_structure``). Entries die with their anchor (weakref), are
evicted least-recently-used first when the device bytes pass
``budget_bytes``, and are never evicted while pinned by a running query
(``pin_scope``). The reference also weights eviction by each entry's
rebuild cost; the port's eviction is plain LRU.

Stable keys (the reference's ``stable_slot_key``): a deps-free slot (a
column plane, a dictionary-code plane: a pure function of its anchor's
content) also carries a key made of the anchor's content fingerprint
(``Series.content_fingerprint``) and the slot key. When the identity probe
misses but an entry with the same stable key and equal literals exists,
the entry is rebound to the new anchor (or, while a running query pins it,
shared) instead of rebuilt (``hbm_stable_rehits``): a re-read file's new
Series of equal content hit the planes the last read uploaded. Slots with
deps stay identity-keyed. An entry whose anchor dies keeps its stable key
as an orphan, up to ``ORPHAN_CAP`` of them, oldest dropped first (the
reference keeps none outside its worker pool: ``DAFT_TPU_HBM_ORPHANS=0``).
Unlike the reference's, an entry still pinned by the running query is kept
too: a streamed morsel's Series dies before its query ends.
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, Tuple

# content-keyed entries kept after their anchor died, so that the next
# Series of equal content (a re-read file's) rebinds them
ORPHAN_CAP = 4096

_TOKENS = itertools.count(1)
_TOKEN_LOCK = threading.Lock()
_TOKEN_MAP: "weakref.WeakKeyDictionary[Any, int]" = weakref.WeakKeyDictionary()


def identity_token(obj) -> int:
    """A monotonic identity token for ``obj``: unlike id(), never reused after
    the object dies."""
    with _TOKEN_LOCK:
        tok = _TOKEN_MAP.get(obj)
        if tok is None:
            tok = next(_TOKENS)
            _TOKEN_MAP[obj] = tok
        return tok


def device_nbytes(value) -> int:
    """Total bytes of non-CPU torch tensors reachable from ``value`` (tuples,
    lists, dicts). Host tensors count zero: the budget is device memory."""
    import torch

    total = 0
    stack = [value]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            if x.device.type != "cpu":
                total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


def expr_structure(expr) -> Tuple[str, tuple]:
    """(skeleton, literals) of one expression: the repr with every literal
    masked, and the literals as (dtype repr, value) pairs in walk order. Two
    predicates that differ only in literal values share a skeleton."""
    from ..expressions.expressions import Literal

    lits = tuple((repr(n.dtype), n.value) for n in expr.walk() if isinstance(n, Literal))
    masked = expr.transform(lambda n: Literal("?") if isinstance(n, Literal) else None)
    return repr(masked), lits


def exprs_structure(exprs: Iterable) -> Tuple[tuple, tuple]:
    """(skeletons, literals) over a sequence of expressions (concatenated)."""
    skels, lits = [], []
    for e in exprs:
        s, lit = expr_structure(e)
        skels.append(s)
        lits.extend(lit)
    return tuple(skels), tuple(lits)


def stable_slot_key(anchor, key: tuple):
    """64-bit content identity of one slot: a hash of the anchor's content
    fingerprint and the slot key, or None when the anchor has none (the
    slot is then keyed by identity only). A column of a table the caller
    holds (``Series.held``) gets none: it keeps its identity across
    queries, so its first run pays no fingerprint (the reference
    fingerprints every deps-free slot)."""
    if getattr(anchor, "held", False):
        return None
    fp_fn = getattr(anchor, "content_fingerprint", None)
    fp = fp_fn() if fp_fn is not None else None
    if fp is None:
        return None
    import hashlib

    h = hashlib.blake2b(digest_size=8)
    h.update(fp.to_bytes(8, "little"))
    h.update(repr(key).encode())
    return int.from_bytes(h.digest(), "little")


class _Entry:
    __slots__ = ("value", "nbytes", "pins", "anchor_ref", "deps", "literals", "stable")

    def __init__(self, value, nbytes: int, deps: tuple, literals, stable=None):
        self.value = value
        self.nbytes = nbytes
        self.pins = 0
        self.anchor_ref = None
        self.deps = deps
        self.literals = literals
        self.stable = stable


class ResidencyManager:
    """Process-wide registry of device-resident buffers with LRU eviction."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._stable: Dict[int, tuple] = {}  # stable key -> full key
        self._orphans: "OrderedDict[tuple, None]" = OrderedDict()
        self._bytes = 0
        self._auto_budget = None
        self._dead: list = []
        self._tl = threading.local()

    def get_or_build(self, anchor, key: tuple, build: Callable[[], Any], deps: tuple = (),
                     literals=None):
        """The cached value for (anchor, key), built by ``build()`` when
        absent, or rebuilt in place when a dep is not the identical object
        or the literals differ. A deps-free slot that misses by identity is
        rebound from an entry of equal content when there is one."""
        from ..ops import counters

        full_key = (identity_token(anchor), key)
        deps = tuple(deps)
        stable = stable_slot_key(anchor, key) if not deps else None
        with self._lock:
            self._sweep_dead()
            e = self._entries.get(full_key)
            if e is not None and len(e.deps) == len(deps) \
                    and all(a is b for a, b in zip(e.deps, deps)) \
                    and e.literals == literals:
                self._entries.move_to_end(full_key)
                self._pin(full_key, e)
                counters.bump("hbm_cache_hits")
                return e.value
            if stable is not None:
                e = self._stable_rebind(stable, full_key, anchor, literals)
                if e is not None:
                    counters.bump("hbm_cache_hits")
                    counters.bump("hbm_stable_rehits")
                    return e.value
        counters.bump("hbm_cache_misses")
        value = build()  # outside the lock: a build may re-enter the manager
        with self._lock:
            old = self._entries.pop(full_key, None)
            e = _Entry(value, device_nbytes(value), deps, literals, stable)
            if old is not None:
                self._drop_accounting(full_key, old)
                e.pins = old.pins
            if stable is not None:
                # a stale slot of the same content under another anchor would
                # hold the device bytes twice: drop it unless a query holds it
                prev_full = self._stable.get(stable)
                prev = self._entries.get(prev_full) if prev_full is not None else None
                if prev is not None and prev_full != full_key and prev.pins == 0:
                    self._entries.pop(prev_full)
                    self._drop_accounting(prev_full, prev)
                self._stable[stable] = full_key
            self._entries[full_key] = e
            self._bytes += e.nbytes
            self._watch_anchor(anchor, full_key, e)
            self._pin(full_key, e)
            self._evict_over_budget()
        return value

    def _stable_rebind(self, stable: int, full_key: tuple, anchor, literals):
        """Move the deps-free entry of content key ``stable`` to the new
        anchor (under the lock), or share it where a running query pins it;
        the entry, or None when there is none (absent, other literals). The
        reference moves only unpinned entries and rebuilds the rest."""
        prev_full = self._stable.get(stable)
        if prev_full is None or prev_full == full_key:
            return None
        e = self._entries.get(prev_full)
        if e is None or e.deps or e.literals != literals:
            return None
        if e.pins != 0:
            # held by key in a running query's scope (two Series of equal
            # content in one query): shared where it is, never re-keyed
            self._pin(prev_full, e)
            return e
        del self._entries[prev_full]
        self._orphans.pop(prev_full, None)
        self._entries[full_key] = e
        self._stable[stable] = full_key
        self._watch_anchor(anchor, full_key, e)
        self._pin(full_key, e)
        return e

    def _watch_anchor(self, anchor, full_key: tuple, e: _Entry) -> None:
        dead = self._dead

        def _on_collect(_ref, _key=full_key, _dead=dead):
            _dead.append(_key)  # list.append is atomic; swept under the lock

        try:
            e.anchor_ref = weakref.ref(anchor, _on_collect)
        except TypeError:
            e.anchor_ref = None  # not weakref-able: lives until evicted

    def _drop_accounting(self, full_key: tuple, e: _Entry) -> None:
        """Bytes and the stable index of an entry already taken out."""
        self._bytes -= e.nbytes
        self._orphans.pop(full_key, None)
        if e.stable is not None and self._stable.get(e.stable) == full_key:
            del self._stable[e.stable]

    @contextlib.contextmanager
    def pin_scope(self):
        """Scope one query execution: every entry touched inside is pinned
        (never evicted) until exit; eviction re-runs at exit."""
        scopes = getattr(self._tl, "scopes", None)
        if scopes is None:
            scopes = self._tl.scopes = []
        pinned: set = set()
        scopes.append(pinned)
        try:
            yield self
        finally:
            scopes.pop()
            with self._lock:
                for k in pinned:
                    e = self._entries.get(k)
                    if e is not None and e.pins > 0:
                        e.pins -= 1
                self._evict_over_budget()

    def _pin(self, full_key: tuple, e: _Entry) -> None:
        scopes = getattr(self._tl, "scopes", None)
        if scopes and full_key not in scopes[-1]:
            scopes[-1].add(full_key)
            e.pins += 1

    def budget_bytes(self) -> int:
        """Effective budget in bytes (0 = unbounded): the configured
        ``hbm_budget_bytes``, or 3/4 of the card's memory when that is 0."""
        from ..config import execution_config

        b = execution_config().hbm_budget_bytes
        if b > 0:
            return b
        if b < 0:
            return 0
        if self._auto_budget is None:
            import torch

            self._auto_budget = 0
            if torch.cuda.is_available():
                _free, total = torch.cuda.mem_get_info()
                self._auto_budget = (total * 3) // 4
        return self._auto_budget

    def _evict_over_budget(self) -> None:
        budget = self.budget_bytes()
        if budget <= 0:
            return
        while self._bytes > budget:
            victim = next(((k, e) for k, e in self._entries.items() if e.pins == 0), None)
            if victim is None:
                return  # everything pinned: overshoot until the scope ends
            self._entries.pop(victim[0])
            self._drop_accounting(*victim)

    def _sweep_dead(self) -> None:
        """Drop the entries whose anchor died; a content-keyed one stays as
        an orphan (rebindable by equal content), up to ``ORPHAN_CAP``,
        oldest dropped first."""
        cap = ORPHAN_CAP
        while self._dead:
            k = self._dead.pop()
            e = self._entries.get(k)
            if e is None:
                continue
            if cap > 0 and e.stable is not None:
                # kept under its key, pinned or not: a morsel's Series dies
                # while its query runs, and the next run rebinds its planes
                self._orphans[k] = None
                continue
            self._entries.pop(k)
            self._drop_accounting(k, e)
        while len(self._orphans) > cap:
            k = next(iter(self._orphans))
            e = self._entries.pop(k, None)
            if e is not None:
                self._drop_accounting(k, e)
            else:
                self._orphans.pop(k, None)

    def bytes_resident(self) -> int:
        with self._lock:
            self._sweep_dead()
            return self._bytes

    def entry_count(self) -> int:
        with self._lock:
            self._sweep_dead()
            return len(self._entries)

    def clear(self) -> None:
        """Drop every unpinned entry (pinned ones belong to a running query)."""
        with self._lock:
            for k, e in list(self._entries.items()):
                if e.pins == 0:
                    self._entries.pop(k)
                    self._drop_accounting(k, e)

    def pinned_count(self) -> int:
        """Entries a running query's pin scope holds (0 between queries)."""
        with self._lock:
            return sum(1 for e in self._entries.values() if e.pins > 0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            self._sweep_dead()
            return {"bytes_resident": self._bytes, "entries": len(self._entries)}


_MANAGER = ResidencyManager()


def manager() -> ResidencyManager:
    """The process-wide residency manager."""
    return _MANAGER
