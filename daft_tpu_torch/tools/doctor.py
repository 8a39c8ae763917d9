"""doctor: ranked triage over flight-recorder dumps and bench capture pairs
(counterpart of daft_tpu/tools/doctor.py).

Two input shapes, one question — "what ate the time?":

- ``python -m daft_tpu_torch.tools.doctor --compare OLD.json NEW.json`` reads two
  bench captures (bench.py one-line JSON, raw or driver-wrapped) and emits
  a regression attribution report: the top regressed queries ranked by
  slowdown, their per-operator compute/starve/blocked deltas and counter
  deltas when the captures carry ``per_query_profile``, capture-level
  counter movement otherwise, and an engine-tax hint when the movement
  matches a known signature (streaming-scan/host-ledger, device->host
  placement flips). The reference's ``bench.py --compare`` prints the same
  attribution through :func:`attribution_lines` when its gate fails.
- ``python -m daft_tpu_torch.tools.doctor CAPTURE.json`` where the JSON is a
  bench capture record (it carries ``metric``) triages it as an
  out-of-core capture: spill volume, IO-overlap attribution, budget
  headroom, the sync-vs-async A/B verdict, and the query with the worst
  spill-write wall share.
- ``python -m daft_tpu_torch.tools.doctor DUMP.json ...`` reads flight-recorder
  anomaly dumps (observability/flight.py: the port writes the reference's
  dump layout, under ``<tmp>/daft_tpu_torch_flight`` by default) and emits
  a ranked triage report:
  errors and worker deaths first, then stall attribution (scan
  backpressure), ledger pressure and admission waits, placement flips, h2d
  traffic, and a straggler/skew summary over the ring's query records.

Exit code is always 0 — doctor is a triage lens, not a gate. Stdlib-only on
purpose: it runs against committed artifacts without importing the engine.
"""

from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence

TOLERANCE = 0.05        # the reference's bench.REGRESSION_TOLERANCE
_TOP_QUERIES = 3
_TOP_OPERATORS = 3
_TOP_COUNTERS = 5


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"


def _fmt_val(key: str, v: float) -> str:
    if "bytes" in key:
        return _fmt_bytes(v)
    if float(v).is_integer():
        return f"{int(v):+d}"
    return f"{v:+.3f}"


def load_capture(path: str) -> dict:
    """Shape-tolerant bench-capture loader: the raw one-line JSON or a
    driver record wrapping it under "parsed". Captures WITHOUT
    per_query_profile (every capture before schema v10) load cleanly —
    attribution then falls back to capture-level counters."""
    with open(path) as f:
        data = json.load(f)
    if isinstance(data, dict) and "metric" not in data \
            and isinstance(data.get("parsed"), dict):
        data = data["parsed"]
    if not isinstance(data, dict):
        raise SystemExit(f"{path}: not a bench capture (JSON object expected, "
                         f"got {type(data).__name__})")
    return data


# ---- capture-pair attribution --------------------------------------------------------

def _regressed_queries(old: dict, new: dict) -> List[str]:
    old_q, new_q = old.get("per_query_ms", {}), new.get("per_query_ms", {})
    out = []
    for q in old_q:
        o, n = old_q[q], new_q.get(q)
        if n is not None and n > o * (1 + TOLERANCE):
            out.append(q)
    return out


def _profile_lines(q: str, oldp: Optional[dict], newp: Optional[dict]) -> List[str]:
    """Per-operator + counter deltas for one query, from per_query_profile."""
    lines: List[str] = []
    if not newp:
        lines.append("    (no per_query_profile in NEW capture — re-capture "
                     "with current bench.py for operator attribution)")
        return lines
    old_ops = {o["name"]: o for o in (oldp or {}).get("operators", [])}
    scored = []
    for o in newp.get("operators", []):
        prev = old_ops.get(o["name"], {})
        d = o.get("seconds", 0.0) - prev.get("seconds", 0.0)
        scored.append((d, o, prev))
    scored.sort(key=lambda t: t[0], reverse=True)
    for d, o, prev in scored[:_TOP_OPERATORS]:
        if d <= 0 and prev:
            continue
        split = ", ".join(
            f"{k} {o.get(f'{k}_seconds', o.get(k, 0.0)) - prev.get(f'{k}_seconds', prev.get(k, 0.0)):+.3f}s"
            for k in ("compute", "starve", "blocked"))
        tag = f"{d:+.3f}s" if prev else f"{o.get('seconds', 0.0):.3f}s (new)"
        lines.append(f"    operator {o['name']}: {tag}  [{split}]")
    old_c = (oldp or {}).get("counters", {})
    new_c = newp.get("counters", {})
    deltas = sorted(
        ((k, new_c.get(k, 0) - old_c.get(k, 0)) for k in set(new_c) | set(old_c)),
        key=lambda kv: abs(kv[1]), reverse=True)
    for k, d in deltas[:_TOP_COUNTERS]:
        if d:
            lines.append(f"    counter {k}: {_fmt_val(k, d)}")
    return lines


def _capture_counter_lines(old: dict, new: dict) -> List[str]:
    old_m, new_m = old.get("metrics", {}) or {}, new.get("metrics", {}) or {}
    lines: List[str] = []
    deltas = sorted(
        ((k, new_m.get(k, 0) - old_m.get(k, 0)) for k in set(new_m) | set(old_m)),
        key=lambda kv: abs(kv[1]), reverse=True)
    for k, d in deltas[:_TOP_COUNTERS + 2]:
        if not d:
            continue
        origin = "" if k in old_m else "  (absent from OLD)"
        lines.append(f"  counter {k}: {_fmt_val(k, d)}{origin}")
    ob, nb = old.get("device_batches"), new.get("device_batches")
    if ob is not None and nb is not None and nb < ob:
        lines.append(f"  device_batches: {ob} -> {nb}"
                     + ("  (device tier disengaged)" if nb == 0 else ""))
    return lines


def _tax_hint(old: dict, new: dict, regressed: Sequence[str]) -> List[str]:
    """Name the engine tax when the movement matches a known signature."""
    old_m, new_m = old.get("metrics", {}) or {}, new.get("metrics", {}) or {}
    tax = {k: new_m.get(k, 0) - old_m.get(k, 0)
           for k in new_m
           if k.startswith(("scan_", "host_", "spill_", "rss_"))
           and new_m.get(k, 0) > old_m.get(k, 0)}
    hints: List[str] = []
    nq = len(new.get("per_query_ms", {}) or ())
    broad = nq and len(regressed) >= max(2, nq // 3)
    if tax and broad:
        keys = ", ".join(f"{k}={_fmt_val(k, d)}" for k, d in
                         sorted(tax.items(), key=lambda kv: abs(kv[1]),
                                reverse=True)[:4])
        hints.append(
            f"  likely engine tax: streaming-scan / host-ledger overhead — "
            f"{len(regressed)}/{nq} queries regressed while host-memory/scan "
            f"attribution grew ({keys})")
    ob, nb = old.get("device_batches"), new.get("device_batches")
    if ob and nb == 0:
        reasons = set((new.get("host_reasons") or {}).values())
        why = f" ({'; '.join(sorted(reasons)[:2])})" if reasons else ""
        hints.append(
            f"  likely placement regression: device tier disengaged "
            f"(device_batches {ob} -> 0){why}")
    return hints


def attribution_lines(old: dict, new: dict,
                      regressed: Optional[Sequence[str]] = None) -> List[str]:
    """Regression attribution for a capture pair: top regressed queries by
    slowdown with their profile deltas, capture-level counter movement, and
    the engine-tax hint. Shape-tolerant: captures without per_query_profile
    (pre-v10) get capture-level attribution only."""
    if regressed is None:
        regressed = _regressed_queries(old, new)
    if not regressed:
        return []
    old_q, new_q = old.get("per_query_ms", {}), new.get("per_query_ms", {})
    old_p = old.get("per_query_profile", {}) or {}
    new_p = new.get("per_query_profile", {}) or {}
    ranked = sorted(
        (q for q in regressed if q in old_q and q in new_q),
        key=lambda q: new_q[q] / old_q[q] if old_q[q] else float("inf"),
        reverse=True)
    lines = ["attribution (top regressed queries):"]
    for q in ranked[:_TOP_QUERIES]:
        o, n = old_q[q], new_q[q]
        lines.append(f"  {q}: {o:.1f} -> {n:.1f} ms "
                     f"({n / o if o else float('inf'):.2f}x slower)")
        lines.extend(_profile_lines(q, old_p.get(q), new_p.get(q)))
    lines.extend(_capture_counter_lines(old, new))
    lines.extend(_tax_hint(old, new, regressed))
    return lines


def triage_pair(old_path: str, new_path: str) -> List[str]:
    old, new = load_capture(old_path), load_capture(new_path)
    regressed = _regressed_queries(old, new)
    ov, nv = old.get("value", 0), new.get("value", 0)
    lines = [f"doctor: capture pair {old_path} -> {new_path}"]
    if ov and nv:
        lines.append(f"headline: {old.get('metric', '?')} {ov:g} -> {nv:g} "
                     f"({nv / ov:.2f}x)")
    if not regressed and not (ov and nv and nv < ov * (1 - TOLERANCE)):
        lines.append(f"no per-query regressions > {TOLERANCE:.0%}")
        return lines
    lines.append(f"regressed queries (> {TOLERANCE:.0%}): "
                 f"{', '.join(regressed) or '(headline only)'}")
    lines.extend(attribution_lines(old, new, regressed))
    return lines


# ---- flight-dump triage --------------------------------------------------------------

def _ring_events(dump: dict, kind: str) -> List[dict]:
    return [ev for ev in dump.get("ring", []) if ev.get("kind") == kind]


def triage_dump(dump: dict, path: str = "") -> List[str]:
    """Ranked triage over one flight-recorder anomaly dump: highest-severity
    findings (errors, deaths) first, then stalls, ledger, placement, h2d,
    straggler/skew."""
    lines = [f"doctor: flight dump {path or '(stdin)'}",
             f"anomaly: {dump.get('kind', '?')} — {dump.get('detail', '')}"]
    if dump.get("tenant"):
        lines.append(f"tenant: {dump['tenant']}")
    metrics = dump.get("metrics", {}) or {}
    queries = _ring_events(dump, "query")
    findings: List[tuple] = []  # (severity, line) — rendered ranked

    errors = [q for q in queries if q.get("error")]
    if errors:
        last = errors[-1]
        findings.append((100, f"{len(errors)} errored quer"
                         f"{'ies' if len(errors) != 1 else 'y'} in the ring; "
                         f"last: {last.get('query_id', '?')}: {last['error']}"))
    # gateway-tier findings: anomaly dumps fired by the serving gateway
    # (gateway/server.py) carry their cause in the dump header and/or the
    # gateway counters in `metrics` — triage-able with no server access
    if dump.get("kind") == "gateway_error":
        findings.append((98, f"gateway error: {dump.get('detail', '?')} — "
                         f"auth_failures="
                         f"{int(metrics.get('gateway_auth_failures', 0))}, "
                         f"wire errors="
                         f"{int(metrics.get('gateway_errors_total', 0))} over "
                         f"{int(metrics.get('gateway_connections_total', 0))} "
                         f"connection(s)"))
    if dump.get("kind") == "cache_thrash":
        findings.append((85, f"result-cache thrash: {dump.get('detail', '?')}"))
    rc_hits = metrics.get("result_cache_hits", 0)
    rc_miss = metrics.get("result_cache_misses", 0)
    if rc_hits or rc_miss:
        rate = rc_hits / max(rc_hits + rc_miss, 1)
        sev = 58 if (rate < 0.5 and dump.get("kind") != "cache_thrash") else 15
        findings.append((sev, f"result cache: {int(rc_hits)} hit(s) / "
                         f"{int(rc_miss)} miss(es) ({rate:.0%} hit rate), "
                         f"{int(metrics.get('result_cache_evictions', 0))} "
                         f"eviction(s), "
                         f"{_fmt_bytes(metrics.get('result_cache_bytes', 0))} "
                         f"resident"))
    deaths = _ring_events(dump, "worker_death")
    if deaths:
        who = ", ".join(f"{d.get('worker_id', '?')} ({d.get('detail', '')})"
                        for d in deaths[-3:])
        findings.append((95, f"{len(deaths)} worker death(s): {who}"))
    fallbacks = _ring_events(dump, "device_fallback")
    if fallbacks:
        findings.append((80, f"{len(fallbacks)} device fallback(s); last: "
                         f"{fallbacks[-1].get('detail', '')}"))
    stall_ms = metrics.get("scan_stall_ms", 0)
    if stall_ms:
        findings.append((70, f"scan backpressure: {int(stall_ms)} ms stalled "
                         f"across {int(metrics.get('scan_backpressure_stalls', 0))} "
                         f"stall(s) — producers paced at the memory wall"))
    pressure = _ring_events(dump, "ledger_pressure")
    if pressure:
        last = pressure[-1]
        findings.append((65, f"{len(pressure)} host-ledger pressure "
                         f"crossing(s); last at "
                         f"{_fmt_bytes(last.get('tracked_bytes', 0))} of "
                         f"{_fmt_bytes(last.get('limit_bytes', 0))}"))
    over = metrics.get("host_over_budget_events", 0)
    if over:
        findings.append((60, f"{int(over)} operator(s) crossed the host "
                         f"budget into spill "
                         f"(spill_bytes {_fmt_bytes(metrics.get('spill_bytes', 0))})"))
    admissions = _ring_events(dump, "admission")
    if admissions:
        total_wait = sum(a.get("wait_s", 0.0) for a in admissions)
        findings.append((55, f"{len(admissions)} HBM admission wait(s), "
                         f"{total_wait:.3f}s total queued"))
    flips = sum(1 for q in queries
                for p in q.get("placements", []) or []
                if isinstance(p, dict) and p.get("tier") in ("host", "cpu"))
    if flips:
        findings.append((50, f"{flips} placement verdict(s) kept stages on "
                         f"host across recent queries"))
    h2d = metrics.get("hbm_h2d_bytes", 0)
    if h2d:
        findings.append((40, f"h2d traffic: {_fmt_bytes(h2d)} uploaded "
                         f"(hbm hits {int(metrics.get('hbm_cache_hits', 0))} / "
                         f"misses {int(metrics.get('hbm_cache_misses', 0))})"))
    # straggler/skew: per-fingerprint wall-clock spread over the ring
    by_fp: Dict[str, List[float]] = {}
    for q in queries:
        if q.get("fingerprint") and not q.get("error"):
            by_fp.setdefault(q["fingerprint"], []).append(q.get("seconds", 0.0))
    for fp, secs in by_fp.items():
        if len(secs) >= 3:
            med = sorted(secs)[len(secs) // 2]
            if med > 0 and max(secs) > 3 * med:
                findings.append((45, f"straggler/skew: plan {fp} spread "
                                 f"{min(secs):.3f}s..{max(secs):.3f}s "
                                 f"(median {med:.3f}s) over {len(secs)} runs"))
    if not findings:
        findings.append((0, "no ranked findings — ring holds "
                         f"{len(dump.get('ring', []))} event(s), "
                         f"{int(dump.get('ring_dropped', 0))} dropped at the cap"))
    findings.sort(key=lambda t: t[0], reverse=True)
    lines.append("findings (ranked):")
    lines.extend(f"  {i + 1}. {msg}" for i, (_, msg) in enumerate(findings))
    if queries:
        lines.append("recent queries:")
        for q in queries[-5:]:
            err = f"  ERROR {q['error']}" if q.get("error") else ""
            lines.append(f"  {q.get('query_id') or '(anon)'}"
                         f"  {q.get('seconds', 0.0):.3f}s"
                         f"  rows={q.get('rows', 0)}{err}")
    return lines


# ---- OOM-capture triage --------------------------------------------------------------

def triage_oom_capture(cap: dict, path: str = "") -> List[str]:
    """Ranked triage over one BENCH_OOM capture (bench.py one-line JSON):
    where the out-of-core run's time went. Names the query with the worst
    spill-write wall share — spill-write stalls as a fraction of that
    query's best wall time, i.e. the query the spill path starved hardest —
    plus spill volume/compression, IO-overlap attribution (cumulative vs
    wall discipline), budget headroom, and the sync-vs-async A/B verdict
    when the capture carries one."""
    m = cap.get("metrics", {}) or {}
    lines = [f"doctor: OOM capture {path or '(stdin)'}",
             f"headline: {cap.get('metric', '?')} = {cap.get('value', 0):g} "
             f"{cap.get('unit', '')}".rstrip()]
    findings: List[tuple] = []  # (severity, line) — rendered ranked

    # worst spill-write wall share: per-query spill_write_wall_seconds
    # (from the instrumented profile pass) over the query's best wall time.
    # The profile pass is a separate run under the same budget, so the
    # share is an attribution estimate, not an exact decomposition.
    per_q_ms = cap.get("per_query_ms", {}) or {}
    per_q_prof = cap.get("per_query_profile", {}) or {}
    shares = []
    for q, prof in per_q_prof.items():
        wall_s = per_q_ms.get(q, 0.0) / 1000.0
        stall = (prof.get("counters", {}) or {}).get(
            "spill_write_wall_seconds", 0.0)
        if wall_s > 0 and stall > 0:
            shares.append((stall / wall_s, stall, q))
    if shares:
        shares.sort(reverse=True)
        share, stall, q = shares[0]
        findings.append((90, f"worst spill-write wall share: {q} spent "
                         f"{stall:.3f}s stalled on spill writes "
                         f"({share:.0%} of its {per_q_ms[q]:.1f} ms wall) — "
                         f"the query the spill path starved hardest"))
    elif per_q_prof:
        findings.append((20, "no query recorded spill-write stalls in the "
                         "profile pass — spill writes fully overlapped (or "
                         "never happened per-query)"))

    spill = m.get("spill_bytes", 0)
    if spill:
        wire = m.get("spill_wire_bytes", 0)
        comp = f", {wire / spill:.2f}x on the wire" if wire else ""
        findings.append((70, f"spilled {_fmt_bytes(spill)} across "
                         f"{int(m.get('spill_files', 0))} file(s), "
                         f"{int(m.get('spill_runs', 0))} sort run(s), "
                         f"{int(m.get('spill_merge_passes', 0))} cascade "
                         f"merge pass(es){comp}"))
    w_cum = m.get("spill_write_seconds", 0.0)
    if w_cum or m.get("spill_read_seconds", 0.0):
        ratio = m.get("spill_io_overlap_ratio", 0.0)
        overlap = m.get("spill_io_overlap_seconds", 0.0)
        if ratio:
            findings.append((60, f"spill IO overlap: {overlap:.3f}s "
                             f"({ratio:.0%} of cumulative spill IO) hidden "
                             f"behind compute by the async pool"))
        else:
            findings.append((75, "spill IO never overlapped (overlap ratio "
                             "0 with nonzero IO time) — synchronous compat "
                             "path, or the pool never got ahead; check "
                             "DAFT_TPU_SPILL_IO_THREADS"))
    budget = cap.get("memory_limit_bytes", 0)
    rss = cap.get("rss_high_water_bytes", 0)
    ledger = cap.get("host_bytes_high_water", 0)
    if budget and (ledger or rss):
        over = " <-- OVER LEDGER BUDGET" if ledger > budget else ""
        findings.append((50 if over else 30,
                         f"budget {_fmt_bytes(budget)}: ledger high-water "
                         f"{_fmt_bytes(ledger)}{over}; process RSS peak "
                         f"{_fmt_bytes(rss)}"))
    ab = cap.get("spill_ab") or {}
    if ab:
        findings.append((55, f"sync-vs-async A/B: {ab.get('speedup', 0):.2f}x "
                         f"({ab.get('sync_wall_seconds', 0):.2f}s -> "
                         f"{ab.get('async_wall_seconds', 0):.2f}s), async "
                         f"overlap ratio "
                         f"{(ab.get('async_metrics', {}) or {}).get('spill_io_overlap_ratio', 0):.0%}"))
    if not findings:
        findings.append((0, "no spill activity recorded — not an "
                         "out-of-core capture (or counters absent)"))
    findings.sort(key=lambda t: t[0], reverse=True)
    lines.append("findings (ranked):")
    lines.extend(f"  {i + 1}. {msg}" for i, (_, msg) in enumerate(findings))
    if per_q_ms:
        lines.append("slowest queries:")
        for q in sorted(per_q_ms, key=per_q_ms.get, reverse=True)[:5]:
            stall = (per_q_prof.get(q, {}).get("counters", {}) or {}).get(
                "spill_write_wall_seconds", 0.0)
            lines.append(f"  {q}  {per_q_ms[q]:.1f} ms"
                         f"  spill-write stall {stall:.3f}s")
    return lines


def main(argv: Optional[Sequence[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print("usage: python -m daft_tpu_torch.tools.doctor --compare OLD.json NEW.json\n"
              "       python -m daft_tpu_torch.tools.doctor DUMP.json [DUMP.json ...]",
              file=sys.stderr)
        return 0 if argv else 2
    if argv[0] == "--compare":
        if len(argv) != 3:
            print("usage: python -m daft_tpu_torch.tools.doctor --compare "
                  "OLD.json NEW.json", file=sys.stderr)
            return 2
        print("\n".join(triage_pair(argv[1], argv[2])))
        return 0
    for i, path in enumerate(argv):
        if i:
            print()
        with open(path) as f:
            dump = json.load(f)
        # shape dispatch: bench capture records (raw or driver-wrapped)
        # carry "metric"; everything else is a flight-recorder dump
        if isinstance(dump, dict) and "metric" not in dump \
                and isinstance(dump.get("parsed"), dict):
            dump = dump["parsed"]
        if isinstance(dump, dict) and "metric" in dump:
            print("\n".join(triage_oom_capture(dump, path)))
        else:
            print("\n".join(triage_dump(dump, path)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
