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
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import weakref
from collections import OrderedDict
from typing import Any, Callable, Dict, Iterable, Tuple

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


class _Entry:
    __slots__ = ("value", "nbytes", "pins", "anchor_ref", "deps", "literals")

    def __init__(self, value, nbytes: int, deps: tuple, literals):
        self.value = value
        self.nbytes = nbytes
        self.pins = 0
        self.anchor_ref = None
        self.deps = deps
        self.literals = literals


class ResidencyManager:
    """Process-wide registry of device-resident buffers with LRU eviction."""

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._bytes = 0
        self._auto_budget = None
        self._dead: list = []
        self._tl = threading.local()

    def get_or_build(self, anchor, key: tuple, build: Callable[[], Any], deps: tuple = (),
                     literals=None):
        """The cached value for (anchor, key), built by ``build()`` when
        absent, or rebuilt in place when a dep is not the identical object
        or the literals differ."""
        full_key = (identity_token(anchor), key)
        deps = tuple(deps)
        with self._lock:
            self._sweep_dead()
            e = self._entries.get(full_key)
            if e is not None and len(e.deps) == len(deps) \
                    and all(a is b for a, b in zip(e.deps, deps)) \
                    and e.literals == literals:
                self._entries.move_to_end(full_key)
                self._pin(full_key, e)
                return e.value
        value = build()  # outside the lock: a build may re-enter the manager
        with self._lock:
            old = self._entries.pop(full_key, None)
            e = _Entry(value, device_nbytes(value), deps, literals)
            if old is not None:
                self._bytes -= old.nbytes
                e.pins = old.pins
            self._entries[full_key] = e
            self._bytes += e.nbytes
            dead = self._dead

            def _on_collect(_ref, _key=full_key, _dead=dead):
                _dead.append(_key)  # list.append is atomic; swept under the lock

            try:
                e.anchor_ref = weakref.ref(anchor, _on_collect)
            except TypeError:
                pass  # not weakref-able: lives until evicted
            self._pin(full_key, e)
            self._evict_over_budget()
        return value

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
            self._bytes -= victim[1].nbytes

    def _sweep_dead(self) -> None:
        while self._dead:
            e = self._entries.pop(self._dead.pop(), None)
            if e is not None:
                self._bytes -= e.nbytes

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
                    self._bytes -= e.nbytes

    def stats(self) -> Dict[str, int]:
        with self._lock:
            self._sweep_dead()
            return {"bytes_resident": self._bytes, "entries": len(self._entries)}


_MANAGER = ResidencyManager()


def manager() -> ResidencyManager:
    """The process-wide residency manager."""
    return _MANAGER
