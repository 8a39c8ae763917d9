"""FlightRecorder: always-on, bounded black-box telemetry with anomaly dumps
(counterpart of daft_tpu/observability/flight.py).

Production engines answer "why was THAT run slow?" without asking the
operator to reproduce under a profiler: a cheap, always-on ring of recent
coarse events (query summaries with their per-query counter deltas, ledger
pressure crossings, device fallbacks) plus
anomaly triggers that snapshot the ring to a JSON dump the moment something
crosses a line. This module is that black box for the engine:

- ``recorder()`` resolves the process recorder ONCE from the environment and
  returns it (or ``None`` when ``DAFT_TPU_FLIGHT_RECORDER=0`` — the
  zero-overhead path: no ring allocation, no per-query snapshots, and the
  hook sites skip entirely on one ``is None`` check).
- The ring follows the SpanRecorder's cap+drop discipline
  (``DAFT_TPU_FLIGHT_RING`` events, FIFO eviction, a ``dropped`` count kept
  as recorder state — ring maintenance is registry-SILENT so the tier-1
  empty-registry-diff guard holds with the recorder on).
- Anomaly triggers — slow query (wall clock > ``DAFT_TPU_ANOMALY_WALL_K`` x
  the plan fingerprint's EMA, above the ``DAFT_TPU_ANOMALY_MIN_S`` floor),
  query error, host-ledger pressure crossing, DeviceFallback (and the
  reference's worker death, which has no producer in the port yet) —
  snapshot the ring to ``DAFT_TPU_FLIGHT_DIR`` as one JSON file, bump the
  ``flight_*`` registry counters, and notify ``on_flight_anomaly``
  subscribers. Per-kind cooldown (``DAFT_TPU_ANOMALY_COOLDOWN_S``) bounds
  the dump rate under a storm; suppressed anomalies still count.
- Multi-tenant no-bleed: a dump for a tenant-tagged anomaly filters the
  ring to that tenant's events plus engine-global (untagged) events, so one
  tenant's dump never carries another tenant's queries.
- The default dump directory is ``<tmp>/daft_tpu_torch_flight``, not the
  reference's ``daft_tpu_flight``: the two packages' dumps never mix.

Lock discipline: ring/EMA state mutates under one lock; the dump file write
happens OUTSIDE it (a slow disk must never stall a query-end hook on the
recorder lock). A dump is one JSON object: ``kind``, ``detail``,
``query_id``, ``ring`` (the recent events, oldest first), ``ema`` and the
registry's ``metrics`` at the trigger.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional

from ..utils.env import env_bool, env_float, env_int, env_str
from .events import FlightAnomaly
from .metrics import registry
from .subscribers import notify, subscribers_active

_EMA_ALPHA = 0.2   # per-fingerprint wall-clock EMA smoothing
_EMA_CAP = 512     # distinct plan fingerprints tracked (LRU beyond)
_DUMPS_KEPT = 32   # dump paths remembered on the recorder (files stay on disk)


class FlightRecorder:
    """Bounded ring of recent engine events + anomaly-triggered dumps."""

    def __init__(self, cap: int, dump_dir: str, wall_k: float,
                 min_s: float, cooldown_s: float):
        self.cap = cap
        self.dump_dir = dump_dir
        self.wall_k = wall_k
        self.min_s = min_s
        self.cooldown_s = cooldown_s
        self._lock = threading.Lock()
        self._ring: deque = deque()
        self.dropped = 0               # events evicted at the cap (not registry)
        self._ema: "OrderedDict[str, float]" = OrderedDict()
        self._last_trigger: Dict[str, float] = {}
        self._seq = 0
        self.dumps: List[str] = []

    # ---- ring ----------------------------------------------------------------------
    def record(self, kind: str, tenant: str = "", **fields) -> None:
        """Append one coarse event. Registry-silent by design: ring
        maintenance (including eviction) must not perturb per-query counter
        diffs — only ANOMALIES touch the registry."""
        ev = {"kind": kind, "ts": time.time()}
        if tenant:
            ev["tenant"] = tenant
        for k, v in fields.items():
            if v:
                ev[k] = v
        with self._lock:
            if len(self._ring) >= self.cap:
                self._ring.popleft()
                self.dropped += 1
            self._ring.append(ev)

    def snapshot(self, limit: Optional[int] = None) -> List[dict]:
        with self._lock:
            out = list(self._ring)
        return out[-limit:] if limit else out

    # ---- per-query hook ------------------------------------------------------------
    def note_query(self, fingerprint: str, seconds: float, query_id: str = "",
                   tenant: str = "", rows: int = 0,
                   error: Optional[str] = None,
                   metrics: Optional[Dict[str, float]] = None,
                   placements: Optional[List[dict]] = None) -> None:
        """Record one finished query and run the slow-query / query-error
        anomaly checks. `fingerprint` keys the wall-clock EMA (plan_key of
        the physical plan); `metrics` carries the query's registry counter
        deltas; `placements` the placement-verdict briefs when a scope was
        active."""
        self.record("query", tenant=tenant, query_id=query_id,
                    fingerprint=fingerprint, seconds=round(seconds, 6),
                    rows=rows, error=error, metrics=metrics,
                    placements=placements)
        if error is not None:
            self.trigger("query_error", detail=error, query_id=query_id,
                         tenant=tenant)
            return
        with self._lock:
            ema = self._ema.get(fingerprint) if fingerprint else None
        if (ema is not None and seconds >= self.min_s
                and seconds > self.wall_k * ema):
            self.trigger(
                "slow_query",
                detail=(f"wall {seconds:.3f}s > {self.wall_k:g}x EMA "
                        f"{ema:.3f}s for plan {fingerprint}"),
                query_id=query_id, tenant=tenant)
        if fingerprint:
            with self._lock:
                prev = self._ema.get(fingerprint)
                self._ema[fingerprint] = seconds if prev is None \
                    else prev + _EMA_ALPHA * (seconds - prev)
                self._ema.move_to_end(fingerprint)
                while len(self._ema) > _EMA_CAP:
                    self._ema.popitem(last=False)

    # ---- other engine hooks --------------------------------------------------------
    def note_pressure(self, tracked: int, limit: int) -> None:
        """Host-ledger pressure crossing (memory/manager.py track())."""
        self.record("ledger_pressure", tracked_bytes=tracked,
                    limit_bytes=limit)
        self.trigger("ledger_pressure",
                     detail=f"host ledger {tracked} of {limit} bytes crossed "
                            f"the pressure threshold")

    def note_fallback(self, detail: str = "") -> None:
        """A DeviceFallback unwound a device stage back to host."""
        self.record("device_fallback", detail=detail)
        self.trigger("device_fallback", detail=detail)

    def note_worker_death(self, worker_id: str, reason: str) -> None:
        self.record("worker_death", worker_id=worker_id, detail=reason)
        self.trigger("worker_death", detail=f"{worker_id}: {reason}")

    # ---- anomalies -----------------------------------------------------------------
    def trigger(self, kind: str, detail: str = "", query_id: str = "",
                tenant: str = "") -> Optional[str]:
        """Fire one anomaly: count it, dump the (tenant-filtered) ring to a
        JSON file unless the per-kind cooldown suppresses the write, append
        an `anomaly` ring event, and notify subscribers. Returns the dump
        path, or None when suppressed/failed."""
        now = time.time()
        with self._lock:
            last = self._last_trigger.get(kind, 0.0)
            suppressed = self.cooldown_s > 0 and now - last < self.cooldown_s
            if not suppressed:
                self._last_trigger[kind] = now
            self._seq += 1
            seq = self._seq
            if tenant:
                # no-bleed: this tenant's events + engine-global (untagged)
                # events only — never another tenant's queries
                ring = [ev for ev in self._ring
                        if ev.get("tenant", "") in ("", tenant)]
            else:
                ring = list(self._ring)
            dropped = self.dropped
            ema = dict(self._ema)
        registry().inc("flight_anomalies_total")
        path = ""
        if not suppressed:
            dump = {"kind": kind, "detail": detail, "ts": now,
                    "query_id": query_id, "tenant": tenant,
                    "pid": os.getpid(), "ring": ring,
                    "ring_dropped": dropped, "ema": ema,
                    "metrics": registry().snapshot()}
            path = os.path.join(
                self.dump_dir,
                f"flight_{kind}_{os.getpid()}_{int(now * 1000)}_{seq}.json")
            try:
                os.makedirs(self.dump_dir, exist_ok=True)
                with open(path, "w") as f:
                    json.dump(dump, f, default=str)
            except (OSError, TypeError, ValueError):
                # an unwritable dump dir degrades to counters, never to a
                # failed query
                registry().inc("flight_dump_failures")
                path = ""
            else:
                registry().inc("flight_dumps_total")
                with self._lock:
                    self.dumps.append(path)
                    del self.dumps[:-_DUMPS_KEPT]
        self.record("anomaly", tenant=tenant, anomaly=kind, detail=detail,
                    query_id=query_id, dump_path=path)
        if subscribers_active():
            notify("on_flight_anomaly", FlightAnomaly(
                kind=kind, detail=detail, query_id=query_id, tenant=tenant,
                dump_path=path, ts=now))
        return path or None


def plan_key(display: str) -> str:
    """Stable short fingerprint of a physical plan rendering — keys the
    slow-query EMA across repeats of the same plan shape. blake2s, not
    hash(): per-process salting would reset every EMA on restart."""
    import hashlib

    return hashlib.blake2s(display.encode()).hexdigest()[:16]


_RESOLVE_LOCK = threading.Lock()
_RECORDER: Optional[FlightRecorder] = None
_RESOLVED = False


def recorder() -> Optional[FlightRecorder]:
    """The process recorder, or None when DAFT_TPU_FLIGHT_RECORDER=0.
    Resolved from the environment once per process; every hook site guards
    on `is None`, so the disabled path allocates nothing."""
    global _RECORDER, _RESOLVED
    if _RESOLVED:
        return _RECORDER
    with _RESOLVE_LOCK:
        if not _RESOLVED:
            if env_bool("DAFT_TPU_FLIGHT_RECORDER", True):
                _RECORDER = FlightRecorder(
                    cap=env_int("DAFT_TPU_FLIGHT_RING", 256, lo=8),
                    dump_dir=env_str(
                        "DAFT_TPU_FLIGHT_DIR",
                        os.path.join(tempfile.gettempdir(),
                                     "daft_tpu_torch_flight")),
                    wall_k=env_float("DAFT_TPU_ANOMALY_WALL_K", 4.0, lo=1.0),
                    min_s=env_float("DAFT_TPU_ANOMALY_MIN_S", 1.0, lo=0.0),
                    cooldown_s=env_float("DAFT_TPU_ANOMALY_COOLDOWN_S", 5.0,
                                         lo=0.0))
            _RESOLVED = True
    return _RECORDER


def _reset_for_tests() -> None:
    """Drop the resolved recorder so the next recorder() re-reads the
    environment (monkeypatched knobs)."""
    global _RECORDER, _RESOLVED
    with _RESOLVE_LOCK:
        _RECORDER = None
        _RESOLVED = False
