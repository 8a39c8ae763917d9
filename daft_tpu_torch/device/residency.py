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
(``pin_scope``). Eviction is the reference's recency-bucketed LRU, cheapest
to rebuild first: of the ``EVICT_BUCKET`` least-recently-used unpinned
entries (at most the older half), the one with the smallest
``ops/costmodel.py`` ``rebuild_cost_estimate`` (its re-upload plus the host
factorize its build re-runs, ``rebuild_rows``) goes first, so a column plane
sheds before a dictionary-code or join index plane of similar age
(``hbm_evict_cost_saved`` counts the microseconds saved against pure LRU).
``is_resident`` is the cost model's advisory probe.

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

Registry (observability/metrics.py): the counters ``hbm_cache_hits``,
``hbm_cache_misses``, ``hbm_stable_rehits``, ``hbm_pins``, ``hbm_evictions``,
``hbm_eviction_bytes`` and ``hbm_evict_cost_saved``; the gauges ``hbm_bytes_resident`` and
``hbm_bytes_high_water`` (reset to what stays resident by ``clear()``).

Serving admission (the reference's ``observe_pins`` / ``admit``):
``admit(est)`` brackets one served query with a reservation of its
estimated pin-scope bytes and waits while the outstanding reservations plus
this one would pass ``budget_bytes`` (a query is always admissible when no
reservation is outstanding, so an over-budget query runs alone instead of
waiting forever; ``tenant_budget`` caps one tenant's reservations the same
way; a cancelled query leaves the wait through ``raise_if_cancelled``).
``observe_pins()`` yields the high-water of the bytes the query's open pin
scopes hold together, on its thread and on the stage threads its pipeline
spawns (execution/pipeline.py ``spawn_stage`` hands the observation over as
it hands the stats collector). The bytes counted are those on the device
the query runs on: card bytes, or on a CPU device its tensors' bytes (the
budget counts card bytes only). Gauge: ``hbm_reserved_bytes``; counter:
``admission_waits_total``.
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


def held_nbytes(value) -> int:
    """The bytes of the tensors reachable from ``value`` on the device they
    live on: ``device_nbytes``, or, for a value held on the CPU (a CPU
    device's planes), its CPU tensors' bytes."""
    nbytes = device_nbytes(value)
    if nbytes:
        return nbytes
    import torch

    total = 0
    stack = [value]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


# ---- pin-scope observation (serving admission calibration) -------------------------

# Pin scopes open on whichever thread drives a device stage (a session
# worker, or more often a spawn_stage thread), so the observation lives in a
# thread-local that pipeline.spawn_stage hands to its stage thread, as it
# hands the stats collector, and a kept stage thread drops when its stage
# ends.
_OBS_TL = threading.local()


class _PinObservation:
    """Pinned-byte high-water across every pin scope of one query. A plan
    may hold several scopes open at once (device stages on separate stage
    threads), so each exiting scope notes the sum over all of the query's
    open scopes. ``open_scopes`` maps id(pinned set) -> pinned set, changed
    under the manager's lock."""

    __slots__ = ("high_water", "open_scopes")

    def __init__(self) -> None:
        self.high_water = 0
        self.open_scopes: Dict[int, set] = {}

    def note(self, nbytes: int) -> None:
        if nbytes > self.high_water:
            self.high_water = nbytes


def current_pin_observation():
    """This thread's pin observation (None when the query is not observed)."""
    return getattr(_OBS_TL, "obs", None)


def set_pin_observation(obs) -> None:
    """Install (or clear, with None) this thread's pin observation: the
    hand-off to a stage thread."""
    _OBS_TL.obs = obs


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
    __slots__ = ("value", "nbytes", "held", "pins", "anchor_ref", "deps", "literals",
                 "stable", "cost")

    def __init__(self, value, nbytes: int, deps: tuple, literals, stable=None,
                 cost: float = 0.0, held: int = 0):
        self.value = value
        self.nbytes = nbytes
        self.held = held or nbytes  # bytes on its own device (held_nbytes)
        self.pins = 0
        self.anchor_ref = None
        self.deps = deps
        self.literals = literals
        self.stable = stable
        self.cost = cost  # estimated seconds to rebuild (eviction order)


class ResidencyManager:
    """Process-wide registry of device-resident buffers with cost-weighted
    LRU eviction."""

    # Eviction weighs the EVICT_BUCKET least-recently-used unpinned entries
    # (at most the older half) by rebuild cost and drops the cheapest, so a
    # squeeze sheds re-uploadable column planes before index or dictionary
    # planes of similar age; with two entries the pick is pure LRU, so a hot
    # cheap plane is never sacrificed to a cold expensive one.
    EVICT_BUCKET = 8

    def __init__(self) -> None:
        self._lock = threading.RLock()
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        self._stable: Dict[int, tuple] = {}  # stable key -> full key
        self._orphans: "OrderedDict[tuple, None]" = OrderedDict()
        self._bytes = 0
        self._high_water = 0
        self._auto_budget = None
        # budget shares held by worker pools that lease this card to their
        # workers: token -> processes sharing it (share())
        self._shares: Dict[int, int] = {}
        self._share_seq = itertools.count(1)
        self._dead: list = []
        self._tl = threading.local()
        # admission control: outstanding reservations {token: (tenant, bytes)}
        self._adm = threading.Condition(threading.Lock())
        self._reservations: Dict[int, Tuple[str, int]] = {}
        self._rsv_seq = itertools.count(1)

    def get_or_build(self, anchor, key: tuple, build: Callable[[], Any], deps: tuple = (),
                     literals=None, rebuild_rows: int = 0):
        """The cached value for (anchor, key), built by ``build()`` when
        absent, or rebuilt in place when a dep is not the identical object
        or the literals differ. A deps-free slot that misses by identity is
        rebound from an entry of equal content when there is one.
        ``rebuild_rows``: the host rows the build factorizes or probes, which
        an eviction would make it pay again (eviction order)."""
        from ..ops import counters
        from ..ops.costmodel import rebuild_cost_estimate

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
        nbytes = device_nbytes(value)
        cost = rebuild_cost_estimate(nbytes, rebuild_rows)
        held = nbytes or held_nbytes(value)
        with self._lock:
            old = self._entries.pop(full_key, None)
            e = _Entry(value, nbytes, deps, literals, stable, cost, held)
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
            self._note_bytes()
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

    def is_resident(self, anchor, key: tuple) -> bool:
        """Advisory residency probe for the cost model (no deps or literal
        check, no LRU touch, no counters): True when a value for this slot
        is registered, by the anchor's identity or, when the anchor's content
        fingerprint is already computed, by its content (the rebind a re-read
        file's planes take). Never computes a fingerprint."""
        full_key = (identity_token(anchor), key)
        with self._lock:
            if full_key in self._entries:
                return True
        if getattr(anchor, "_content_fp", None) is None:
            return False
        stable = stable_slot_key(anchor, key)
        if stable is None:
            return False
        with self._lock:
            return self._stable.get(stable) in self._entries

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
        obs = current_pin_observation()
        if obs is not None:
            # under the lock: a concurrent scope exit iterates open_scopes
            with self._lock:
                obs.open_scopes[id(pinned)] = pinned
        try:
            yield self
        finally:
            scopes.pop()
            with self._lock:
                if obs is not None:
                    # the bytes all of the query's open scopes hold together
                    keys = set().union(*obs.open_scopes.values())
                    obs.note(sum(e.held for k in keys
                                 if (e := self._entries.get(k)) is not None))
                    obs.open_scopes.pop(id(pinned), None)
                for k in pinned:
                    e = self._entries.get(k)
                    if e is not None and e.pins > 0:
                        e.pins -= 1
                self._evict_over_budget()

    @contextlib.contextmanager
    def observe_pins(self):
        """Observe the pinned-byte high-water of every pin scope the query
        opens inside the context, on this thread and on the stage threads
        its pipeline spawns. Yields a callable returning the high-water so
        far. Nothing is summed while no observation is installed."""
        prev = current_pin_observation()
        obs = _PinObservation()
        set_pin_observation(obs)
        try:
            yield lambda: obs.high_water
        finally:
            set_pin_observation(prev)

    # ---- admission control (serving tier) ------------------------------------------
    @contextlib.contextmanager
    def admit(self, est_bytes: int, tenant: str = "", tenant_budget: int = 0):
        """Bracket one query's execution with a reservation of ``est_bytes``
        estimated pin-scope bytes; wait while the outstanding reservations
        plus this one would pass ``budget_bytes()`` (or one tenant's pass
        ``tenant_budget``). Yields True when the query had to wait. A query
        is always admissible when no reservation is outstanding (its
        tenant's, for the tenant cap), and an estimate of 0 (a host plan)
        never waits. A cancelled query leaves the wait before it reserves
        anything."""
        from ..cancellation import raise_if_cancelled
        from ..observability.metrics import registry

        est = max(int(est_bytes), 0)
        budget = self.budget_bytes()
        waited = False
        with self._adm:
            while not self._admissible(est, tenant, budget, tenant_budget):
                raise_if_cancelled("query cancelled while awaiting admission")
                if not waited:
                    waited = True
                    registry().inc("admission_waits_total")
                # timed: the budget is read again, so a config change
                # unblocks waiters without a signal
                self._adm.wait(0.05)
                budget = self.budget_bytes()
            tok = next(self._rsv_seq)
            self._reservations[tok] = (tenant, est)
            registry().set_gauge("hbm_reserved_bytes", float(self._reserved()))
        try:
            yield waited
        finally:
            with self._adm:
                self._reservations.pop(tok, None)
                registry().set_gauge("hbm_reserved_bytes", float(self._reserved()))
                self._adm.notify_all()

    def _reserved(self) -> int:
        return sum(b for _t, b in self._reservations.values())

    def _admissible(self, est: int, tenant: str, budget: int, tenant_budget: int) -> bool:
        """Under ``self._adm``. The empty-ledger escapes make over-budget
        queries run one at a time instead of deadlocking."""
        if est <= 0 or not self._reservations:
            return True
        if budget > 0 and self._reserved() + est > budget:
            return False
        if tenant_budget > 0:
            mine = sum(b for t, b in self._reservations.values() if t == tenant)
            if mine and mine + est > tenant_budget:
                return False
        return True

    def reserved_bytes(self) -> int:
        """Outstanding admission reservations, in bytes."""
        with self._adm:
            return self._reserved()

    def reservation_count(self) -> int:
        with self._adm:
            return len(self._reservations)

    def _pin(self, full_key: tuple, e: _Entry) -> None:
        from ..observability.metrics import registry

        scopes = getattr(self._tl, "scopes", None)
        if scopes and full_key not in scopes[-1]:
            scopes[-1].add(full_key)
            e.pins += 1
            registry().inc("hbm_pins")

    def _note_bytes(self) -> None:
        """The ``hbm_bytes_resident`` / ``hbm_bytes_high_water`` gauges (the
        lock held)."""
        from ..observability.metrics import registry

        if self._bytes > self._high_water:
            self._high_water = self._bytes
        registry().set_gauge("hbm_bytes_resident", float(self._bytes))
        registry().set_gauge("hbm_bytes_high_water", float(self._high_water))

    def budget_bytes(self) -> int:
        """Effective budget in bytes (0 = unbounded): the configured
        ``hbm_budget_bytes``, or 3/4 of the card's memory when that is 0,
        divided by the most processes any held ``share()`` splits it among."""
        from ..config import execution_config

        b = execution_config().hbm_budget_bytes
        if b < 0:
            return 0
        if b == 0:
            if self._auto_budget is None:
                import torch

                self._auto_budget = 0
                if torch.cuda.is_available():
                    _free, total = torch.cuda.mem_get_info()
                    self._auto_budget = (total * 3) // 4
            b = self._auto_budget
        shares = list(self._shares.values())
        return b // max(shares) if b > 0 and shares else b

    def share(self, processes: int) -> int:
        """Split this process's budget ``processes`` ways while the returned
        token is held (a worker pool that leases the card to
        ``processes - 1`` workers, each given ``budget_bytes()`` after this
        call); entries past the smaller budget are evicted now.
        ``unshare(token)`` restores it."""
        with self._lock:
            token = next(self._share_seq)
            self._shares[token] = max(1, int(processes))
            self._evict_over_budget()
            self._note_bytes()
        return token

    def unshare(self, token: int) -> None:
        with self._lock:
            self._shares.pop(token, None)

    def _evict_over_budget(self) -> None:
        budget = self.budget_bytes()
        if budget <= 0:
            return
        from ..observability.metrics import registry

        evicted = False
        while self._bytes > budget:
            # front = least recently used; only unpinned entries count toward
            # the half, or pinned ones would pad the window into the hot tail
            unpinned = [(k, e) for k, e in self._entries.items() if e.pins == 0]
            if not unpinned:
                break  # everything pinned: overshoot until the scope ends
            bucket = unpinned[:min(self.EVICT_BUCKET, max(1, (len(unpinned) + 1) // 2))]
            victim_key, victim = min(bucket, key=lambda kv: kv[1].cost)
            lru_cost = bucket[0][1].cost
            if victim.cost < lru_cost:
                # rebuild seconds the pure-LRU victim would have cost (µs)
                registry().inc("hbm_evict_cost_saved", int((lru_cost - victim.cost) * 1e6))
            self._entries.pop(victim_key)
            self._drop_accounting(victim_key, victim)
            registry().inc("hbm_evictions")
            registry().inc("hbm_eviction_bytes", victim.nbytes)
            evicted = True
        if evicted:
            self._note_bytes()

    def _sweep_dead(self) -> None:
        """Drop the entries whose anchor died; a content-keyed one stays as
        an orphan (rebindable by equal content), up to ``ORPHAN_CAP``,
        oldest dropped first."""
        cap = ORPHAN_CAP
        before = self._bytes
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
        if self._bytes != before:
            self._note_bytes()

    def bytes_resident(self) -> int:
        with self._lock:
            self._sweep_dead()
            return self._bytes

    def digest(self, cap: int = 64) -> list:
        """The residency digest a distributed worker's heartbeats carry: up
        to ``cap`` (stable key, device bytes) pairs, most recently used
        first, the bytes on the device the slot lives on (card bytes, or a
        CPU device's tensor bytes: ``held_nbytes``). Only content-keyed slots
        appear: they are the ones a repeat sub-plan rebinds, so the
        scheduler's bytes avoided stay honest."""
        out = []
        with self._lock:
            self._sweep_dead()
            for k in reversed(self._entries):
                e = self._entries[k]
                if e.stable is not None:
                    out.append((e.stable, e.held))
                    if len(out) >= cap:
                        break
        return out

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
            self._high_water = self._bytes
            self._note_bytes()

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
