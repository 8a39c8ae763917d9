"""Measured dispatch-cost model: host against device for the device stages
(counterpart of daft_tpu/ops/costmodel.py).

``device_mode="auto"`` prices each device stage's first morsel both ways and
runs it where it is cheaper. The link terms are measured live on the card,
once per process (``calibrate``):

- ``rtt_s``: one tiny launch, a ``synchronize`` and an ``.item()`` copy back
  (median of three). Every device run pays it once per dispatch, divided by
  the dispatch coalescer's expected horizon (``expected_coalesce_factor``).
- ``h2d_bytes_per_s`` / ``d2h_bytes_per_s``: an 8 MB pageable upload and a
  1 MB copy back (best of two), as the port's uploads are pageable. Only
  bytes not already resident are priced: the executor probes the residency
  manager (device/residency.py) per input plane, and a resident in-memory
  table's first touch amortizes over ``ExecutionConfig.device_amortize_runs``.

Every other rate is a default measured on the H100 machine
(``python -m daft_tpu_torch.tools.calibrate --measure``; PERF.md has the
table), each overridable by its ``DAFT_TPU_COST_*`` variable. None is the
reference's: its rates were measured on a TPU v5e and its host.

The reference prices three TPU tiers (one-hot matmul cells, sort passes,
Pallas tiles in VMEM). The port has one device tier, its hand-written
kernels, which read each plane once at every cap, so its device arms are its
own: ``device_grouped_kernel_cost`` (K1, K7, K2, K3 at their families'
rates, plus the cap-sized table each launch zeroes and the finalize reads
back) and ``device_join_kernel_cost`` (K4's probe and the per-dim gathers in
front of the same reduce). The arms shared with the reference
(``device_ungrouped_cost``, ``device_udf_cost``, the host arms, the base
terms, ``rebuild_cost_estimate``) are its code unchanged. The mesh arms wait
for the mesh stages (ROADMAP Queue 1 item 3).

Every ``*_cost`` function returns a ``CostBreakdown``: the total and its
named terms (rtt, h2d, compute, probe, table, d2h, factorize), so the
placement ledger (observability/placement.py), ``explain_placement()`` and
``python -m daft_tpu_torch.tools.calibrate`` can say which term set a
verdict and how far each was from what the run measured. A CostBreakdown
compares and formats like its float total.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from dataclasses import fields as _dc_fields
from typing import Callable, Dict, List, Optional

from ..utils.env import env_float as _env_f


class CostBreakdown:
    """One tier's predicted cost: total seconds plus the named terms it sums.

    Behaves like the float total for comparison/ordering/formatting so the
    executor's decision sites keep reading ``dev < host``; the terms ride
    along for the placement ledger and the calibration report. ``notes``
    carries informational values that are NOT part of the total (the coalesce
    horizon used, the residency credit — bytes priced at zero because they
    were already resident on the device).
    """

    __slots__ = ("terms", "notes")

    def __init__(self, _notes: Optional[Dict[str, float]] = None, **terms):
        self.terms: Dict[str, float] = {k: float(v) for k, v in terms.items()
                                        if v}
        self.notes: Dict[str, float] = dict(_notes) if _notes else {}

    @property
    def total(self) -> float:
        return sum(self.terms.values())

    def add(self, term: str, seconds: float) -> "CostBreakdown":
        """Fold extra seconds into a named term (in place); returns self so
        call sites can chain."""
        if seconds:
            self.terms[term] = self.terms.get(term, 0.0) + float(seconds)
        return self

    def note(self, key: str, value: float) -> "CostBreakdown":
        self.notes[key] = float(value)
        return self

    def as_dict(self) -> Dict[str, float]:
        """{"total": s, <term>: s, ...} (+ "note_<k>" informational values) —
        the picklable/JSON shape the placement ledger stores."""
        out: Dict[str, float] = {"total": self.total}
        out.update(self.terms)
        for k, v in self.notes.items():
            out[f"note_{k}"] = v
        return out

    # ---- float-compatible surface (decision call sites) ----------------------------
    @staticmethod
    def _tot(other) -> float:
        return other.total if isinstance(other, CostBreakdown) else float(other)

    def __float__(self) -> float:
        return self.total

    def __lt__(self, other) -> bool:
        return self.total < self._tot(other)

    def __le__(self, other) -> bool:
        return self.total <= self._tot(other)

    def __gt__(self, other) -> bool:
        return self.total > self._tot(other)

    def __ge__(self, other) -> bool:
        return self.total >= self._tot(other)

    def __eq__(self, other) -> bool:
        return self.total == self._tot(other)

    def __ne__(self, other) -> bool:
        return not self.__eq__(other)

    def __hash__(self):  # totals are the identity, like the float they replace
        return hash(self.total)

    def __add__(self, other) -> "CostBreakdown":
        out = CostBreakdown(_notes=self.notes, **self.terms)
        if isinstance(other, CostBreakdown):
            for k, v in other.terms.items():
                out.add(k, v)
            out.notes.update(other.notes)
        else:
            out.add("extra", float(other))
        return out

    __radd__ = __add__

    def __mul__(self, k) -> float:
        # display sites do `cost * 1e3` for milliseconds — a plain float
        return self.total * float(k)

    __rmul__ = __mul__

    def __repr__(self) -> str:
        inner = ", ".join(f"{k}={v * 1e3:.3f}ms"
                          for k, v in sorted(self.terms.items()))
        return f"CostBreakdown(total={self.total * 1e3:.3f}ms, {inner})"


# Default rates: each measured on one H100 80GB HBM3 at 700.00 W and its
# host (8 cores), the mean of two runs of `python -m
# daft_tpu_torch.tools.calibrate --measure` (PERF.md, "Calibration"); the
# three host rates measured again over the host kernel library (native.py).
# Name -> (its DAFT_TPU_COST_* override, the measured value).
RATES = {
    # FilterAggStage's reduce on the card: rows x partials per second
    "mm_plane_rows_per_s": ("DAFT_TPU_COST_MM_RATE", 3.355e10),
    # the host path (the port's executor on the host kernel library):
    # value-ops, factorized key rows and hash-join probe rows per second
    "host_agg_rate": ("DAFT_TPU_COST_HOST_AGG", 2.458e8),
    "host_factorize_rate": ("DAFT_TPU_COST_HOST_FACT", 1.258e7),
    "host_probe_rate": ("DAFT_TPU_COST_HOST_PROBE", 3.834e7),
    # the seeded MiniLM-L6 encoder's forward, card and host (FLOP/s)
    "udf_device_flops_per_s": ("DAFT_TPU_COST_UDF_FLOPS", 2.629e13),
    "udf_host_flops_per_s": ("DAFT_TPU_COST_UDF_HOST_FLOPS", 3.478e11),
    # the port's kernel families: plane-rows per second at SF1's 2^23
    # bucket (K1 8 integer planes, K7 4 f32 planes, K2 and K3 one plane
    # each), and K4's probe rows per second against a 1.5 M-key table
    "k1_plane_rows_per_s": ("DAFT_TPU_COST_K1_RATE", 4.786e11),
    "k7_plane_rows_per_s": ("DAFT_TPU_COST_K7_RATE", 2.047e11),
    "k2_plane_rows_per_s": ("DAFT_TPU_COST_K2_RATE", 1.482e11),
    "k3_plane_rows_per_s": ("DAFT_TPU_COST_K3_RATE", 3.669e10),
    "k4_probe_rows_per_s": ("DAFT_TPU_COST_K4_PROBE_RATE", 3.501e10),
    # a dim plane gathered through an index plane (rows per second), one
    # device sort pass (the join TopN's), zeroing a cap-sized table (bytes/s)
    "gather_plane_rows_per_s": ("DAFT_TPU_COST_GATHER_RATE", 9.263e10),
    "sort_rows_per_s": ("DAFT_TPU_COST_SORT_RATE", 8.001e9),
    "table_bytes_per_s": ("DAFT_TPU_COST_TABLE_BW", 1.910e12),
}


@dataclass(frozen=True)
class Calibration:
    rtt_s: float
    h2d_bytes_per_s: float
    d2h_bytes_per_s: float
    mm_plane_rows_per_s: float
    host_agg_rate: float
    host_factorize_rate: float
    host_probe_rate: float
    udf_device_flops_per_s: float = RATES["udf_device_flops_per_s"][1]
    udf_host_flops_per_s: float = RATES["udf_host_flops_per_s"][1]
    k1_plane_rows_per_s: float = RATES["k1_plane_rows_per_s"][1]
    k7_plane_rows_per_s: float = RATES["k7_plane_rows_per_s"][1]
    k2_plane_rows_per_s: float = RATES["k2_plane_rows_per_s"][1]
    k3_plane_rows_per_s: float = RATES["k3_plane_rows_per_s"][1]
    k4_probe_rows_per_s: float = RATES["k4_probe_rows_per_s"][1]
    gather_plane_rows_per_s: float = RATES["gather_plane_rows_per_s"][1]
    sort_rows_per_s: float = RATES["sort_rows_per_s"][1]
    table_bytes_per_s: float = RATES["table_bytes_per_s"][1]


_CAL: Optional[Calibration] = None

# Recalibration must invalidate every cached placement verdict priced under
# the OLD calibration (the executor's decision cache) — otherwise a process
# that recalibrates keeps routing repeat shapes on stale terms. The executor
# registers its cache-clearing hook here at import; the list is module-level
# mutable state shared by serving threads, hence the lock.
_RESET_HOOKS: List[Callable[[], None]] = []
_HOOK_LOCK = threading.Lock()

# The calibration terms exported as gauges (observability/metrics.py declares
# them) so /metrics and QueryEnd.metrics state the calibration the process
# actually ran under. The reference's ICI and mesh-dispatch gauges come with
# the mesh arms.
_CAL_GAUGES = (
    ("cost_rtt_s", "rtt_s"),
    ("cost_h2d_bytes_per_s", "h2d_bytes_per_s"),
    ("cost_d2h_bytes_per_s", "d2h_bytes_per_s"),
    ("cost_udf_flops_per_s", "udf_device_flops_per_s"),
)


def on_calibration_reset(hook: Callable[[], None]) -> None:
    """Register a hook fired by reset_calibration() — used by the executor to
    invalidate its cached placement verdicts, which were priced under the
    Calibration being discarded."""
    with _HOOK_LOCK:
        _RESET_HOOKS.append(hook)


def current_calibration() -> Optional[Calibration]:
    """The completed calibration, or None — NEVER triggers a live probe
    (reporting surfaces must not pay two round trips on a scrape)."""
    return _CAL


def calibration_dict() -> Dict[str, float]:
    """The effective calibration terms as a flat dict ({} when the process
    never calibrated) — served by the dashboard's /api/placement so each
    capture states the terms it ran under."""
    cal = _CAL
    if cal is None:
        return {}
    return {f.name: getattr(cal, f.name) for f in _dc_fields(cal)}


def _rate(name: str) -> float:
    env, default = RATES[name]
    return _env_f(env, default)


def calibrate() -> Calibration:
    """Measure the link terms once per process (lazily, on the first priced
    decision): ``DAFT_TPU_COST_RTT``, ``_H2D`` and ``_D2H`` pin them, and
    when all three are set nothing is probed. Otherwise they are measured
    on the card (``torch.cuda``): about three round trips and an 8 MB upload.
    The executor never prices a stage on a CPU device (its gate keeps "auto"
    there on the host), so a process without a card calibrates only from
    the environment; without it this raises."""
    global _CAL
    if _CAL is not None:
        return _CAL

    rtt = _env_f("DAFT_TPU_COST_RTT", -1.0)
    h2d = _env_f("DAFT_TPU_COST_H2D", -1.0)
    d2h = _env_f("DAFT_TPU_COST_D2H", -1.0)
    if rtt < 0 or h2d < 0 or d2h < 0:
        p_rtt, p_h2d, p_d2h = _probe_link(rtt)
        rtt = p_rtt if rtt < 0 else rtt
        h2d = p_h2d if h2d < 0 else h2d
        d2h = p_d2h if d2h < 0 else d2h

    _CAL = Calibration(
        rtt_s=rtt,
        h2d_bytes_per_s=h2d,
        d2h_bytes_per_s=d2h,
        **{name: _rate(name) for name in RATES},
    )
    _export_calibration_gauges(_CAL)
    return _CAL


def _probe_link(rtt: float):
    """(rtt_s, h2d_bytes_per_s, d2h_bytes_per_s) measured on the card: a
    tiny sum launched, synchronized and read back with ``.item()`` (median of
    three; ``rtt`` >= 0 keeps the given one), an 8 MB pageable upload summed
    and read back, and a 1 MB copy of a device tensor to the host (each
    best of two, its round trip taken off)."""
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError(
            "cost model: no card to calibrate the link on (torch.cuda is not "
            "available); set DAFT_TPU_COST_RTT, DAFT_TPU_COST_H2D and "
            "DAFT_TPU_COST_D2H to price without one")
    dev = torch.device("cuda")
    x = torch.ones(64, dtype=torch.float32, device=dev)
    x.sum().item()  # first launch (context, allocator) outside the timed region
    torch.cuda.synchronize()
    if rtt < 0:
        samples = []
        for _ in range(3):
            t0 = time.perf_counter()
            x.sum().item()
            samples.append(time.perf_counter() - t0)
        rtt = sorted(samples)[1]
    buf = torch.from_numpy(np.ones(2 * 1024 * 1024, np.float32))  # 8 MB, pageable
    buf.to(dev).sum().item()
    best = 0.0
    for _ in range(2):  # best of two: one sample is biased low by jitter
        t0 = time.perf_counter()
        buf.to(dev).sum().item()  # upload + tiny fetch
        dt = max(time.perf_counter() - t0 - rtt, 1e-6)
        best = max(best, buf.numel() * 4 / dt)
    h2d = best
    big = torch.ones(256 * 1024, dtype=torch.float32, device=dev)  # 1 MB down
    big.cpu()
    best = 0.0
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        big.cpu()
        dt = max(time.perf_counter() - t0, 1e-6)
        best = max(best, big.numel() * 4 / dt)
    return rtt, h2d, best


def _export_calibration_gauges(cal: Calibration) -> None:
    """Publish the effective terms as gauges so every scrape states the
    calibration it ran under (cost_rtt_s & co)."""
    from ..observability.metrics import registry

    reg = registry()
    for gauge, attr in _CAL_GAUGES:
        reg.set_gauge(gauge, getattr(cal, attr))


def reset_calibration() -> None:
    """Drop the measured calibration AND invalidate every cached placement
    verdict priced under it (the executor's decision cache via the
    registered hooks) — a recalibrated process must re-decide placements,
    not replay stale ones. Calibration gauges zero until the next
    calibrate()."""
    global _CAL
    _CAL = None
    from ..observability.metrics import registry

    reg = registry()
    for gauge, _attr in _CAL_GAUGES:
        reg.set_gauge(gauge, 0.0)
    with _HOOK_LOCK:
        hooks = list(_RESET_HOOKS)
    for hook in hooks:
        hook()


# Default link rates for ADVISORY estimates that must never trigger a live
# device probe (eviction ordering runs inside the residency manager's lock,
# possibly in a process that never calibrated): the pageable upload rate of
# one H100 80GB HBM3 at 700.00 W (the mean of two `calibrate --measure`
# runs) and the host factorize rate (PERF.md, "Calibration").
# Overridable via the same env knobs calibrate() honors; a completed
# calibration takes precedence.
_STATIC_H2D_BPS = 1.138e10
_STATIC_FACTORIZE_RPS = RATES["host_factorize_rate"][1]


def rebuild_cost_estimate(nbytes: int, factorize_rows: int = 0) -> float:
    """Estimated seconds to rebuild one evicted residency entry: the
    re-upload of its device bytes plus any host factorize work its build
    re-runs (dictionary codes, join indices). This orders cost-weighted
    eviction (device/residency.py): a plain column plane is cheap (pure
    re-upload) while an index/dictionary plane of the same size carries the
    host pass that produced it, so it evicts last."""
    cal = _CAL
    if cal is not None:
        h2d, fact = cal.h2d_bytes_per_s, cal.host_factorize_rate
    else:
        h2d = _env_f("DAFT_TPU_COST_H2D", -1.0)
        if h2d <= 0:
            h2d = _STATIC_H2D_BPS
        fact = _env_f("DAFT_TPU_COST_HOST_FACT", _STATIC_FACTORIZE_RPS)
        if fact <= 0:
            fact = _STATIC_FACTORIZE_RPS
    return nbytes / h2d + factorize_rows / fact


_COALESCE_CAP = 64.0


def expected_coalesce_factor(first_rows: int, target_rows: int) -> float:
    """How many incoming morsels one coalesced device dispatch is expected to
    cover, from the first morsel's size and the coalescer's flush threshold
    (batch_fill_target × the power-of-two bucket at the configured morsel
    size — see executor._make_coalescer / stage.DispatchCoalescer).

    The device cost functions divide their fixed per-dispatch price by this
    horizon: a stream of small morsels that each lose to the host on a full
    RTT can honestly win once one dispatch covers N of them. Bucket-filling
    morsels (first_rows >= target) coalesce 1:1 — no optimism for inputs the
    coalescer cannot help. Capped like device_amortize_runs so a degenerate
    first morsel cannot promise an unbounded horizon."""
    if target_rows <= 0 or first_rows <= 0:
        return 1.0
    return float(min(max(target_rows / first_rows, 1.0), _COALESCE_CAP))


def _base_terms(cal: Calibration, nonresident_bytes: int, coalesce: float,
                resident_bytes: int = 0) -> CostBreakdown:
    """The terms every device tier pays: the coalesce-amortized dispatch round
    trip + non-resident uploads. `resident_bytes` records the residency
    CREDIT as a note — bytes priced at zero because a prior run left them in
    HBM — so the breakdown can show why a repeat query got cheaper."""
    c = max(coalesce, 1.0)
    out = CostBreakdown(rtt=cal.rtt_s / c,
                        h2d=nonresident_bytes / cal.h2d_bytes_per_s)
    if c > 1.0:
        out.note("coalesce", c)
    if resident_bytes:
        out.note("residency_credit_s", resident_bytes / cal.h2d_bytes_per_s)
    return out


def _kernel_terms(out: CostBreakdown, cal: Calibration, rows: int, k1: int, k7: int,
                  k2: int, k3: int, cap: int) -> CostBreakdown:
    """The grouped reduce on the port's kernels: each family reads its
    planes once at its measured plane-row rate, whatever the cap, and each
    launch zeroes its cap-sized f64 table first (``table``)."""
    out.add("compute", rows * (k1 / cal.k1_plane_rows_per_s + k7 / cal.k7_plane_rows_per_s
                               + k2 / cal.k2_plane_rows_per_s
                               + k3 / cal.k3_plane_rows_per_s))
    out.add("table", max(cap, 8) * (k1 + k7 + k2 + k3) * 8 / cal.table_bytes_per_s)
    return out


def device_grouped_kernel_cost(cal: Calibration, rows: int, nonresident_bytes: int,
                               k1: int, k7: int, k2: int, k3: int, cap: int,
                               factorize_rows: int, coalesce: float = 1.0,
                               resident_bytes: int = 0) -> CostBreakdown:
    """One grouped stage run on the kernel tier (ops/grouped_stage.py): the
    coalesce-amortized round trip and non-resident uploads, one launch of
    each family over its planes (K1 the integer-valued sums, K7 the float
    sums, K2 the first-row index, K3 the exact extremes), the cap-sized
    tables zeroed and copied back at finalize (``d2h``), and the host key
    factorize (a dictionary build per new Series, or the host factorize of
    computed keys). The counterpart of the reference's
    ``device_grouped_pallas_cost``: no rows x cap cells."""
    out = _base_terms(cal, nonresident_bytes, coalesce, resident_bytes)
    _kernel_terms(out, cal, rows, k1, k7, k2, k3, cap)
    out.add("d2h", max(cap, 8) * (k1 + k7 + k2 + k3) * 8 / cal.d2h_bytes_per_s)
    out.add("factorize", factorize_rows / cal.host_factorize_rate)
    return out


def device_ungrouped_cost(cal: Calibration, rows: int, nonresident_bytes: int,
                          n_partials: int, coalesce: float = 1.0,
                          resident_bytes: int = 0) -> CostBreakdown:
    out = _base_terms(cal, nonresident_bytes, coalesce, resident_bytes)
    out.add("compute", rows * n_partials / cal.mm_plane_rows_per_s)
    return out


def device_join_kernel_cost(cal: Calibration, rows: int, upload_bytes: int,
                            probe_rows: int, n_gathers: int, k1: int, k7: int, k2: int,
                            k3: int, n_partials: int, cap_est: int, fetch_bytes: int,
                            factorize_rows: int, coalesce: float = 1.0,
                            resident_bytes: int = 0) -> CostBreakdown:
    """One star join + aggregate run on the kernel tier (ops/device_join.py):
    the round trip and uploads, K4's probe of every fact row whose index
    plane is not resident (``probe_rows``), one gather per dim plane
    (values and visibility), the reduce (the grouped stage's kernels and
    their tables, or ``n_partials`` ungrouped partials), the finalize copy
    back, and the host work the port does per fact batch (``factorize``:
    each batch's host dim index, a uniqueness check over every adjacent
    dim's keys, and the host factorize of the joined group keys). The
    counterpart of the reference's ``device_join_pallas_cost``."""
    out = _base_terms(cal, upload_bytes, coalesce, resident_bytes)
    out.add("probe", probe_rows / cal.k4_probe_rows_per_s)
    out.add("compute", n_gathers * rows / cal.gather_plane_rows_per_s)
    if k1 + k7 + k2 + k3:
        _kernel_terms(out, cal, rows, k1, k7, k2, k3, cap_est)
    else:
        out.add("compute", rows * max(n_partials, 1) / cal.mm_plane_rows_per_s)
    out.add("factorize", factorize_rows / cal.host_factorize_rate)
    out.add("d2h", fetch_bytes / cal.d2h_bytes_per_s)
    return out


def device_udf_cost(cal: Calibration, rows: int, h2d_bytes: int, flops: float,
                    fetch_bytes: int, coalesce: float = 1.0) -> CostBreakdown:
    """One device-UDF stage run: the (coalesce-amortized) dispatch round trip
    + per-morsel input uploads (token ids / masks — derived arrays, never
    resident) + the model forward at the device flop rate + the finalize
    fetch of the output rows. Weight uploads are absent on purpose: they are
    residency-managed one-time investments (flat across repeat queries), so
    pricing them per run would mis-reject every warm repeat."""
    out = _base_terms(cal, h2d_bytes, coalesce)
    out.add("compute", flops / cal.udf_device_flops_per_s)
    out.add("d2h", fetch_bytes / cal.d2h_bytes_per_s)
    return out


def host_udf_cost(cal: Calibration, flops: float) -> CostBreakdown:
    """The same model forward on the host path (today's plain batch UDF)."""
    return CostBreakdown(compute=flops / cal.udf_host_flops_per_s)


def host_join_agg_cost(cal: Calibration, rows: int, n_dims: int, n_aggs: int,
                       grouped: bool, has_predicate: bool) -> CostBreakdown:
    """Host execution of the same star query: probe-table passes over the fact
    stream (one per dim) + the aggregation."""
    out = host_agg_cost(cal, rows, n_aggs, grouped, has_predicate)
    out.add("probe", rows * max(n_dims, 1) / cal.host_probe_rate)
    return out


def host_agg_cost(cal: Calibration, rows: int, n_aggs: int, grouped: bool,
                  has_predicate: bool, n_region_ops: int = 0) -> CostBreakdown:
    """Host execution of the same (possibly fused-region) aggregate.
    ``n_region_ops``: operators the region capture absorbed BEYOND the
    filter+agg the other terms already price (extra projects/filters the
    host fallback evaluates per batch) — one vectorized pass each."""
    out = CostBreakdown(compute=rows * max(n_aggs, 1) / cal.host_agg_rate)
    if has_predicate:
        out.add("compute", rows / cal.host_agg_rate)
    if n_region_ops > 0:
        out.add("compute", rows * n_region_ops / cal.host_agg_rate)
    if grouped:
        out.add("factorize", rows / cal.host_factorize_rate)
    return out
