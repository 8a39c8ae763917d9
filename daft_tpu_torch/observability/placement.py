"""Placement observability: the cost-model decision ledger (counterpart of
daft_tpu/observability/placement.py).

Every placement decision the executor makes under ``device_mode="auto"``
(grouped and ungrouped aggregates, the star join and its TopN, device UDFs)
and every forced ``"on"`` run is recorded here:

- :class:`PlacementRecord` — one decision: the stage shape, the chosen tier,
  both sides' :class:`~daft_tpu_torch.ops.costmodel.CostBreakdown` terms,
  whether the verdict came from the bounded decision cache, and — fed back
  from the stage run's span timings — the device seconds the run took, per
  term, so each prediction carries its error.
- :class:`PlacementLedger` — the process-wide, bounded, lock-guarded sink
  (cap ``DAFT_TPU_PLACEMENT_LEDGER``, drops counted). Serves
  ``df.explain_placement()``, SQL ``EXPLAIN PLACEMENT``, the dashboard's
  ``/api/placement`` and ``python -m daft_tpu_torch.tools.calibrate``.
- :func:`query_scope` — per-query record isolation. The scope rides the
  thread-local slot that ``pipeline.spawn_stage`` hands to each stage
  thread, so concurrent queries never see each other's records.
- :class:`feedback` — wraps one device stage run: wall-clocks the
  feed→finalize window and tees the run's device.* spans (h2d / dispatch /
  d2h) into observed seconds per term WITHOUT taking them from a recorder
  that is profiling the same query.

The reference's records also carry a mesh arm and a Pallas what-if arm; the
port has neither yet (its device arm is its kernel tier, and the mesh arms
wait for the mesh stages), so a record prices the device and the host.

Zero-overhead contract: nothing here runs unless a device placement decision
actually happens (plain host queries never touch the ledger or the
registry), decisions are coarse events (one record per stage, never per
row), and ``DAFT_TPU_PLACEMENT_LEDGER=0`` disables recording entirely.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, List, Optional

from ..utils.env import env_int
from .metrics import registry
from .runtime_stats import SpanRecorder, current_spans, span_scope


def _terms(side) -> Optional[Dict[str, float]]:
    """A CostBreakdown (or dict) as the ledger's stored dict shape."""
    if side is None:
        return None
    if isinstance(side, dict):
        return dict(side)
    return side.as_dict()


class PlacementRecord:
    """One placement decision + (for dispatched stages) its observed outcome.

    Mutable on purpose: the executor records the decision before the stage
    runs and the feedback context fills ``observed`` afterwards, so a scope
    snapshot taken at query end sees the completed record. All mutation goes
    through the owning ledger's lock."""

    __slots__ = ("seq", "site", "chosen", "rows", "cached", "forced", "reason",
                 "detail", "ts", "device", "host", "observed", "error_ratio",
                 "query_tag")

    def __init__(self, seq: int, site: str, chosen: str, rows: int,
                 cached: bool, forced: bool, reason: str, detail: str,
                 device=None, host=None, query_tag: str = ""):
        self.seq = seq
        self.site = site
        self.chosen = chosen
        self.rows = rows
        self.cached = cached
        self.forced = forced
        self.reason = reason
        self.detail = detail
        self.ts = time.time()
        self.device = _terms(device)
        self.host = _terms(host)
        # filled by feedback(): {"total": s, "h2d": s, "dispatch": s,
        # "d2h": s, "rows": n, "dispatches": k, "fallback": 0/1}
        self.observed: Optional[Dict[str, float]] = None
        self.error_ratio: Optional[float] = None
        self.query_tag = query_tag

    def margin(self) -> Optional[float]:
        """How close the losing tier was: losing total / winning total
        (>= 1.0). None when fewer than two tiers were priced."""
        totals = [d["total"] for d in (self.device, self.host)
                  if d is not None and "total" in d]
        if len(totals) < 2:
            return None
        totals.sort()
        return totals[1] / max(totals[0], 1e-12)

    def predicted(self) -> Optional[Dict[str, float]]:
        """The chosen tier's priced breakdown (None for gate/forced records
        that never ran the cost model)."""
        return {"device": self.device, "host": self.host}.get(self.chosen)

    def to_dict(self) -> dict:
        out = {"seq": self.seq, "site": self.site, "chosen": self.chosen,
               "rows": self.rows, "cached": self.cached, "forced": self.forced,
               "ts": self.ts}
        for k in ("reason", "detail"):
            v = getattr(self, k)
            if v:
                out[k] = v
        for k in ("device", "host", "observed"):
            v = getattr(self, k)
            if v is not None:
                out[k] = dict(v)
        m = self.margin()
        if m is not None:
            out["margin"] = round(m, 4)
        if self.error_ratio is not None:
            out["error_ratio"] = round(self.error_ratio, 4)
        return out


class PlacementScope:
    """Per-query record collector (bounded). Installed thread-locally by
    query_scope() and handed to stage threads by pipeline.spawn_stage —
    records created anywhere in one query's execution land here and ONLY
    here, so concurrent queries never see each other's decisions."""

    def __init__(self, cap: int = 64, tag: str = ""):
        self._lock = threading.Lock()
        self._records: List[PlacementRecord] = []
        self.cap = cap
        self.dropped = 0
        self.tag = tag

    def _add(self, rec: PlacementRecord) -> None:
        with self._lock:
            if len(self._records) >= self.cap:
                self.dropped += 1
                return
            self._records.append(rec)

    def records(self) -> List[PlacementRecord]:
        with self._lock:
            return list(self._records)

    def to_dicts(self) -> List[dict]:
        return [r.to_dict() for r in self.records()]


_local = threading.local()


def current_scope() -> Optional[PlacementScope]:
    return getattr(_local, "scope", None)


def set_scope(scope: Optional[PlacementScope]) -> None:
    _local.scope = scope


@contextmanager
def query_scope(cap: int = 64, tag: str = ""):
    """Collect this thread's (and its stage threads') placement records for
    one query. Nests save/restore like the stats collector."""
    scope = PlacementScope(cap=cap, tag=tag)
    prev = current_scope()
    set_scope(scope)
    try:
        yield scope
    finally:
        set_scope(prev)


class PlacementLedger:
    """Process-wide bounded decision ledger (one per process, lock-guarded,
    cap + drop counter so a pathological session can never exhaust memory
    through the observability layer)."""

    def __init__(self, cap: Optional[int] = None):
        self._lock = threading.Lock()
        self._records: List[PlacementRecord] = []
        self.cap = env_int("DAFT_TPU_PLACEMENT_LEDGER", 512, lo=0) \
            if cap is None else cap
        self.dropped = 0
        self._seq = 0

    @property
    def enabled(self) -> bool:
        return self.cap > 0

    def _append(self, rec: PlacementRecord, count_drop: bool) -> None:
        """Locked bounded append (FIFO eviction + drop accounting), shared by
        record() and gate(). `count_drop=False` on the gate path: gates must
        stay registry-silent end to end (the zero-overhead contract), so
        their evictions land only in stats()['dropped']."""
        with self._lock:
            if len(self._records) >= self.cap:
                self._records.pop(0)
                self.dropped += 1
                if count_drop:
                    registry().inc("placement_records_dropped")
            self._records.append(rec)

    def _next_rec(self, site: str, chosen: str, rows: int, cached: bool,
                  forced: bool, reason: str, detail: str, scope,
                  device=None, host=None) -> PlacementRecord:
        with self._lock:
            self._seq += 1
            return PlacementRecord(self._seq, site, chosen, rows, cached,
                                   forced, reason, detail, device=device,
                                   host=host, query_tag=scope.tag if scope else "")

    def record(self, site: str, chosen: str, rows: int = 0, *,
               cached: bool = False, forced: bool = False, reason: str = "",
               detail: str = "", device=None, host=None) -> Optional[PlacementRecord]:
        """Record one COSTED (or forced) placement decision; returns the
        record so the executor can feed observed timings back, or None when
        the ledger is disabled. Registry counters move here — and only here —
        so the unobserved host path never writes the registry."""
        if not self.enabled:
            return None
        scope = current_scope()
        rec = self._next_rec(site, chosen, rows, cached, forced, reason,
                             detail, scope, device=device, host=host)
        self._append(rec, count_drop=True)
        reg = registry()
        if forced:
            reg.inc("placement_forced_runs")
        else:
            reg.inc("placement_decisions_total")
            if cached:
                reg.inc("placement_cached_verdicts")
            if chosen == "device":
                reg.inc("placement_device_wins")
            else:
                reg.inc("placement_host_wins")
        if scope is not None:
            scope._add(rec)
        return rec

    def gate(self, site: str, reason: str, rows: int = 0,
             only_scoped: bool = False) -> None:
        """Record a pre-cost gate rejection (a CPU device, below
        device_min_rows, a group count over the ceiling) — ledger + scope
        only, NO registry writes: gate rejects fire on paths whose tests pin
        empty registry diffs, and the counters' job is to attribute COSTED
        decisions.

        `only_scoped=True` marks the high-frequency common-path bails (every
        tiny host query crosses the device_min_rows gate): those append
        nothing unless an explain_placement()/query scope is listening."""
        if not self.enabled:
            return
        scope = current_scope()
        if only_scoped and scope is None:
            return
        rec = self._next_rec(site, "host", rows, False, False, reason, "",
                             scope)
        self._append(rec, count_drop=False)
        if scope is not None:
            scope._add(rec)

    def observe(self, rec: Optional[PlacementRecord], total_s: float,
                term_seconds: Optional[Dict[str, float]] = None,
                rows: int = 0, dispatches: int = 0,
                fallback: bool = False) -> None:
        """Feed one dispatched stage's measured outcome back into its
        decision record; updates the cost_model_error_ratio gauge. The error
        ratio is per-row normalized (observed s/row over predicted s/row)
        when both row counts are known — the prediction priced the FIRST
        partition's shape while the observation covers the whole run."""
        if rec is None or not self.enabled:
            return
        obs: Dict[str, float] = {"total": float(total_s)}
        if term_seconds:
            obs.update({k: float(v) for k, v in term_seconds.items() if v})
        if rows:
            obs["rows"] = float(rows)
        if dispatches:
            obs["dispatches"] = float(dispatches)
        if fallback:
            obs["fallback"] = 1.0
        err: Optional[float] = None
        pred = rec.predicted()
        if not fallback and pred and pred.get("total", 0) > 0 and total_s > 0:
            pred_total = pred["total"]
            if rows and rec.rows:
                err = (total_s / rows) / (pred_total / rec.rows)
            else:
                err = total_s / pred_total
        with self._lock:
            rec.observed = obs
            rec.error_ratio = err
        reg = registry()
        reg.inc("placement_feedback_total")
        if err is not None:
            reg.set_gauge("cost_model_error_ratio", err)

    # ---- reads -------------------------------------------------------------------
    def records(self, limit: int = 0) -> List[PlacementRecord]:
        with self._lock:
            recs = list(self._records)
        return recs[-limit:] if limit else recs

    def snapshot(self, limit: int = 0) -> List[dict]:
        return [r.to_dict() for r in self.records(limit)]

    def stats(self) -> dict:
        with self._lock:
            return {"records": len(self._records), "dropped": self.dropped,
                    "cap": self.cap, "seq": self._seq}

    def error_summary(self) -> dict:
        """Aggregate prediction-error stats over records with feedback:
        {"samples": n, "median": r, "max": r} (error_ratio 1.0 = the model
        predicted the dispatch exactly; 10.0 = 10x too optimistic)."""
        ratios = sorted(r.error_ratio for r in self.records()
                        if r.error_ratio is not None)
        if not ratios:
            return {"samples": 0}
        return {"samples": len(ratios),
                "median": round(ratios[len(ratios) // 2], 4),
                "max": round(ratios[-1], 4)}

    def clear(self) -> None:
        with self._lock:
            self._records.clear()
            self.dropped = 0


_LEDGER = PlacementLedger()


def ledger() -> PlacementLedger:
    """The process-wide placement ledger."""
    return _LEDGER


# ---- stage-run feedback --------------------------------------------------------------


class _TeeSpans(SpanRecorder):
    """SpanRecorder that ALSO forwards every span to the recorder that was
    active when the feedback scope opened — the placement feedback must never
    take device spans from a query being profiled (explain_analyze) on the
    same thread. The cap bounds a pathological run; feedback checks the drop
    counter and falls back to the wall-clock observation when spans were
    lost, so a truncated span sum can never masquerade as the full run."""

    def __init__(self, forward: Optional[SpanRecorder]):
        super().__init__(cap=4096)
        self._forward = forward

    def record(self, name, cat, t0, t1, args=None) -> None:
        super().record(name, cat, t0, t1, args)
        if self._forward is not None:
            self._forward.record(name, cat, t0, t1, args)


def _span_term(name: str) -> Optional[str]:
    """Map a device span name to its cost-model term: device.h2d /
    device.udf_h2d -> h2d, *_dispatch -> dispatch (the round trip and the
    launches' enqueue), *_d2h -> d2h."""
    if not name.startswith("device."):
        return None
    leaf = name.rsplit(".", 1)[-1]
    for term in ("h2d", "dispatch", "d2h"):
        if leaf == term or leaf.endswith("_" + term):
            return term
    return None


class feedback:
    """Context manager wrapping one device stage run (feed -> finalize):
    wall-clocks the window, tees the run's device.* spans into per-term
    observed seconds, and reports the outcome into the decision record on
    exit. A DeviceFallback unwinding through the block is reported as
    fallback=True (the observation then carries no error signal — the device
    never finished the work being priced). No-op when `rec` is None (ledger
    disabled / decision not recorded)."""

    def __init__(self, rec: Optional[PlacementRecord], rows: int = 0):
        self._rec = rec
        self._rows = rows
        self._tee: Optional[_TeeSpans] = None
        self._scope = None
        self._t0 = 0.0

    def set_rows(self, rows: int) -> None:
        """Total rows actually fed (the executor learns this only after the
        stream drains)."""
        self._rows = rows

    def cancel(self) -> None:
        """Drop the observation: the stage bailed to host before any device
        work (a TopN's second fact batch), so there is nothing to feed back —
        an observation of the bail-out path would poison the error signal."""
        self._rec = None

    def __enter__(self) -> "feedback":
        if self._rec is not None:
            self._tee = _TeeSpans(current_spans())
            self._scope = span_scope(self._tee)
            self._scope.__enter__()
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._scope is None:
            return False
        wall = time.perf_counter() - self._t0
        self._scope.__exit__(exc_type, exc, tb)
        if self._rec is None:  # cancelled mid-block: nothing to observe
            return False
        # matched by name so this module never imports the device tier:
        # DeviceFallback is the stages' typed host-rerun signal. Any OTHER
        # exception means the run died mid-flight — its partial timings are
        # not an observation of the work that was priced, so nothing is
        # recorded (a truncated sample would poison the error gauge and the
        # calibrate tool).
        fallback = exc is not None and type(exc).__name__ == "DeviceFallback"
        if exc is not None and not fallback:
            return False
        terms: Dict[str, float] = {}
        dispatches = 0
        rows = self._rows
        for span in self._tee.drain():
            term = _span_term(span["name"])
            if term is None:
                continue
            args = span.get("args") or {}
            if term == "h2d" and args.get("op") == "weights":
                # model-weight uploads are residency-managed one-time
                # investments the cost model deliberately prices at ZERO
                # (ops/costmodel.device_udf_cost) — counting their span into
                # observed h2d would skew the bandwidth error on cold runs
                continue
            terms[term] = terms.get(term, 0.0) + span["dur"]
            if term == "dispatch":
                dispatches += 1
            elif term == "h2d":
                if not self._rows:
                    rows += int(args.get("rows", 0))
        # The feed loop inside the wrapped block DRAINS the upstream stream
        # (scan/decode/filter host work), so the wall clock over-states the
        # device's share. The span sum covers exactly the device windows
        # (h2d + dispatch + d2h), so when spans arrived intact they ARE the
        # observed device seconds; the wall window rides along for context.
        # A tee that dropped spans has an UNDERcounted sum — fall back to
        # the wall clock rather than report a truncated run as complete.
        if terms and not self._tee.dropped:
            total = sum(terms.values())
        else:
            total = wall
            terms = {}
            if self._tee.dropped:
                terms["spans_dropped"] = float(self._tee.dropped)
        terms["wall"] = wall
        _LEDGER.observe(self._rec, total, term_seconds=terms, rows=rows,
                        dispatches=dispatches, fallback=fallback)
        return False  # never swallow


# ---- rendering (explain_placement) ---------------------------------------------------

_TERM_ORDER = ("rtt", "h2d", "probe", "compute", "table", "d2h", "factorize", "extra")


def _fmt_ms(v: Optional[float]) -> str:
    return f"{v * 1e3:.2f}ms" if v is not None else "-"


def render(records: List[PlacementRecord]) -> str:
    """The `EXPLAIN PLACEMENT` report: one block per decision with the chosen
    tier, the what-if margin (how close the losing tier was), the per-term
    cost table for every priced tier, and — for dispatched stages — the
    observed seconds next to the prediction."""
    if not records:
        return ("== Placement Decisions ==\n"
                "(no device placement decisions: plan has no device-eligible "
                "stages, or device_mode=off)")
    lines = ["== Placement Decisions =="]
    for i, r in enumerate(records, 1):
        head = f"#{i} {r.site}"
        if r.rows:
            head += f" ({r.rows:,} rows)"
        head += f" -> {r.chosen}"
        flags = []
        if r.forced:
            flags.append("forced")
        if r.cached:
            flags.append("cached verdict")
        if r.reason:
            flags.append(r.reason)
        if flags:
            head += f"  [{', '.join(flags)}]"
        lines.append(head)
        if r.detail:
            lines.append(f"    shape: {r.detail}")
        m = r.margin()
        if m is not None:
            tiers = {"device": r.device["total"], "host": r.host["total"]}
            winner = min(tiers, key=tiers.get)
            loser = "host" if winner == "device" else "device"
            lines.append(
                f"    margin: {winner} wins by "
                f"{(tiers[loser] - tiers[winner]) * 1e3:.2f}ms "
                f"({loser} {_fmt_ms(tiers[loser])} vs "
                f"{winner} {_fmt_ms(tiers[winner])}, {m:.2f}x)")
        sides = [(n, d) for n, d in (("device", r.device), ("host", r.host))
                 if d is not None]
        if sides:
            names = [n for n, _ in sides]
            lines.append("    " + f"{'term':<14}"
                         + "".join(f"{n:>12}" for n in names))
            seen = [t for t in _TERM_ORDER
                    if any(t in d for _, d in sides)]
            for t in seen:
                row = f"    {t:<14}"
                for _, d in sides:
                    row += f"{_fmt_ms(d.get(t)):>12}"
                lines.append(row)
            row = f"    {'TOTAL':<14}"
            for _, d in sides:
                row += f"{_fmt_ms(d.get('total')):>12}"
            lines.append(row)
            for _, d in sides:
                credit = d.get("note_residency_credit_s")
                if credit:
                    lines.append(f"    residency credit: "
                                 f"{_fmt_ms(credit)} of h2d priced free "
                                 f"(planes already resident)")
                    break
        if r.observed:
            o = r.observed
            obs = f"    observed: {_fmt_ms(o.get('total'))} device"
            parts = [f"{t} {_fmt_ms(o[t])}"
                     for t in ("h2d", "dispatch", "d2h") if o.get(t)]
            if o.get("wall"):
                parts.append(f"wall {_fmt_ms(o['wall'])}")
            if parts:
                obs += " (" + ", ".join(parts) + ")"
            if o.get("dispatches"):
                obs += f", {int(o['dispatches'])} dispatches"
            if o.get("rows"):
                obs += f", {int(o['rows']):,} rows"
            if o.get("fallback"):
                obs += ", FELL BACK TO HOST"
            lines.append(obs)
            if r.error_ratio is not None:
                lines.append(f"    model error: {r.error_ratio:.2f}x "
                             f"(observed s/row vs predicted)")
    return "\n".join(lines)
