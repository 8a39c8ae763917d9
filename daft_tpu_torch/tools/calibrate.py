"""Cost-model calibration: observed-vs-predicted samples -> cost overrides,
and the measurement of the default rates (counterpart of
daft_tpu/tools/calibrate.py).

``python -m daft_tpu_torch.tools.calibrate`` replays the placement ledger's
observed-vs-predicted samples (observability/placement.py: each dispatched
device stage's span timings beside the CostBreakdown its decision priced)
into suggested ``DAFT_TPU_COST_*`` overrides: run a representative workload
on the card, read the report, export the suggestions.

Modes:
- no arguments: run a small built-in probe workload (an ungrouped filter +
  aggregate and a grouped aggregate, each twice) under ``device_mode="on"``
  with ``DAFT_TPU_PLACEMENT_PRICE_FORCED=1`` on ``--device`` (default
  "cuda"), so every forced run carries a priced breakdown and an
  observation. A CPU device is never priced (the executor's CPU gate), so
  there it yields records without samples.
- ``--ledger FILE.json``: read records dumped with
  ``placement.ledger().snapshot()`` (a list, or {"records": [...],
  "calibration": {...}}) instead of running the workload.
- ``--measure``: time every default rate of ``ops/costmodel.py`` ``RATES``
  on ``--device`` and its host (``measure_rates``) and print them with the
  link terms ``calibrate()`` measures; the defaults committed in
  ``RATES`` come from this mode on the H100 machine.
- ``--json``: the report (or the measured rates) as JSON.

Suggestion mechanics (coarse on purpose: the model only needs to be right
within ~2x), as the reference's:
- h2d / d2h: observed over predicted term seconds, r (the median over
  samples); the bandwidth knob scales by 1/r.
- rtt: the least observed dispatch span per dispatch, suggested when it is
  more than 2x away from the calibration.
- compute: the observed dispatch window minus the per-dispatch rtt against
  the predicted compute term scales the site's rate knobs (the ungrouped
  reduce for "agg", the four kernel families for "grouped agg", the gathers
  and the kernels for the joins, the device flop rate for "udf").
- probe (the port's own): the join's observed h2d span (its provisioning:
  uploads, K4's probe, the gathers) less the predicted uploads against the
  predicted probe term scales ``DAFT_TPU_COST_K4_PROBE_RATE``.
The reference's mesh (ICI, mesh dispatch) and Pallas suggestions wait for
the port's mesh stages; it has no Pallas tier.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Dict, List, Optional

_KERNEL_KNOBS = ["DAFT_TPU_COST_K1_RATE", "DAFT_TPU_COST_K7_RATE", "DAFT_TPU_COST_K2_RATE",
                 "DAFT_TPU_COST_K3_RATE"]

# site -> the compute-rate knobs its residual calibrates
_SITE_RATE_KNOBS = {
    "agg": ["DAFT_TPU_COST_MM_RATE"],
    "grouped agg": _KERNEL_KNOBS,
    "join agg": ["DAFT_TPU_COST_GATHER_RATE"] + _KERNEL_KNOBS,
    "join topn": ["DAFT_TPU_COST_GATHER_RATE"] + _KERNEL_KNOBS,
    "udf": ["DAFT_TPU_COST_UDF_FLOPS"],
}

# knob -> its Calibration field
_KNOB_FIELD = {
    "DAFT_TPU_COST_MM_RATE": "mm_plane_rows_per_s",
    "DAFT_TPU_COST_K1_RATE": "k1_plane_rows_per_s",
    "DAFT_TPU_COST_K7_RATE": "k7_plane_rows_per_s",
    "DAFT_TPU_COST_K2_RATE": "k2_plane_rows_per_s",
    "DAFT_TPU_COST_K3_RATE": "k3_plane_rows_per_s",
    "DAFT_TPU_COST_GATHER_RATE": "gather_plane_rows_per_s",
    "DAFT_TPU_COST_UDF_FLOPS": "udf_device_flops_per_s",
}

# bandwidth-term -> knob; suggested value = current * predicted/observed
_BW_KNOBS = {"h2d": "DAFT_TPU_COST_H2D", "d2h": "DAFT_TPU_COST_D2H"}

_MIN_TERM_S = 1e-5   # ignore sub-10µs predictions/observations: pure noise


def _median(xs: List[float]) -> float:
    xs = sorted(xs)
    return xs[len(xs) // 2]


def _samples(records: List[dict]) -> List[dict]:
    """Records that carry both a priced breakdown for the chosen tier and an
    observed timing (a dispatched device stage with feedback)."""
    out = []
    for r in records:
        obs = r.get("observed")
        if not obs or obs.get("fallback"):
            continue
        if obs.get("spans_dropped"):
            # the feedback tee lost spans: the per-term sums are truncated
            # and the total fell back to the wall clock — not a calibration
            # sample (wall time includes upstream host work)
            continue
        chosen = r.get("chosen", "")
        pred = r.get(chosen) if chosen == "device" else None
        if not pred or not pred.get("total"):
            continue
        out.append({"site": r.get("site", "?"), "pred": pred, "obs": obs,
                    "rows_pred": r.get("rows", 0),
                    "error_ratio": r.get("error_ratio")})
    return out


def suggest(records: List[dict],
            calibration: Optional[Dict[str, float]] = None) -> dict:
    """The report dict: per-term observed/predicted ratios, sample counts,
    and suggested cost-model env override values."""
    from ..ops.costmodel import calibration_dict

    cal = calibration if calibration is not None else calibration_dict()
    samples = _samples(records)
    report: dict = {
        "samples": len(samples),
        "records": len(records),
        "calibration": cal,
        "terms": {},
        "suggestions": {},
    }
    if not samples:
        return report

    # bandwidth terms: ratio of observed to predicted seconds per sample
    cal_bw = {"h2d": cal.get("h2d_bytes_per_s"), "d2h": cal.get("d2h_bytes_per_s")}
    for term, knob in _BW_KNOBS.items():
        ratios = []
        for s in samples:
            p, o = s["pred"].get(term, 0.0), s["obs"].get(term, 0.0)
            if p > _MIN_TERM_S and o > _MIN_TERM_S:
                ratios.append(o / p)
        if ratios:
            r = _median(ratios)
            report["terms"][term] = {"samples": len(ratios),
                                     "observed_over_predicted": round(r, 4)}
            cur = cal_bw.get(term)
            if cur:
                report["suggestions"][knob] = f"{cur / r:.4g}"

    # rtt: the fixed per-dispatch floor — min observed dispatch span per
    # dispatch (min, not median: compute rides inside the dispatch window,
    # so the floor is the best estimate of the pure round trip)
    rtts = []
    for s in samples:
        d, n = s["obs"].get("dispatch", 0.0), s["obs"].get("dispatches", 0)
        if d > _MIN_TERM_S and n:
            rtts.append(d / n)
    if rtts:
        floor = min(rtts)
        report["terms"]["rtt"] = {"samples": len(rtts),
                                  "observed_floor_s": round(floor, 6)}
        pred_rtt = cal.get("rtt_s")
        # only suggest when the observation disagrees with the calibration by
        # more than 2x — within 2x the decision is already right by contract
        if pred_rtt and (floor > 2 * pred_rtt or floor < pred_rtt / 2):
            report["suggestions"]["DAFT_TPU_COST_RTT"] = f"{floor:.6g}"

    # compute rates, per site: the dispatch window (launch + on-device
    # compute) minus the calibrated per-dispatch rtt floor, vs the predicted
    # compute term. The dispatch SPAN is the device-seconds observation —
    # the wall window would conflate upstream scan/decode time with compute.
    cal_rtt = cal.get("rtt_s") or 0.0
    per_site: Dict[str, List[float]] = {}
    for s in samples:
        pred_c = s["pred"].get("compute", 0.0)
        obs = s["obs"]
        n_disp = obs.get("dispatches", 0)
        residual = obs.get("dispatch", 0.0) - n_disp * cal_rtt
        if pred_c > _MIN_TERM_S and residual > _MIN_TERM_S:
            per_site.setdefault(s["site"], []).append(residual / pred_c)
    for site, ratios in per_site.items():
        r = _median(ratios)
        report["terms"][f"compute[{site}]"] = {
            "samples": len(ratios), "observed_over_predicted": round(r, 4)}
        if r > 2 or r < 0.5:
            # a rate knob scales inversely with observed seconds
            for knob in _SITE_RATE_KNOBS.get(site, ()):
                base = cal.get(_KNOB_FIELD[knob])
                if base:
                    report["suggestions"][knob] = f"{base / r:.4g}"

    # the join's probe: its provisioning span (uploads, K4's probe, the
    # gathers) less the predicted uploads, against the predicted probe
    probe_ratios = []
    for s in samples:
        pred_p = s["pred"].get("probe", 0.0)
        residual = s["obs"].get("h2d", 0.0) - s["pred"].get("h2d", 0.0)
        if pred_p > _MIN_TERM_S and residual > _MIN_TERM_S:
            probe_ratios.append(residual / pred_p)
    if probe_ratios:
        r = _median(probe_ratios)
        report["terms"]["probe"] = {"samples": len(probe_ratios),
                                    "observed_over_predicted": round(r, 4)}
        cur = cal.get("k4_probe_rows_per_s")
        if cur and (r > 2 or r < 0.5):
            report["suggestions"]["DAFT_TPU_COST_K4_PROBE_RATE"] = f"{cur / r:.4g}"

    errs = [s["error_ratio"] for s in samples
            if s.get("error_ratio") is not None]
    if errs:
        report["error_ratio_median"] = round(_median(errs), 4)
    return report


def render(report: dict) -> str:
    lines = ["== Cost-model calibration report =="]
    lines.append(f"records: {report['records']}, "
                 f"observed-vs-predicted samples: {report['samples']}")
    if report.get("error_ratio_median") is not None:
        lines.append(f"model error (median observed/predicted s/row): "
                     f"{report['error_ratio_median']}x")
    cal = report.get("calibration") or {}
    if cal:
        lines.append("calibration in effect:")
        for k, v in sorted(cal.items()):
            lines.append(f"  {k:<24} {v:g}")
    if report["terms"]:
        lines.append("per-term observed vs predicted:")
        for term, t in sorted(report["terms"].items()):
            detail = ", ".join(f"{k}={v}" for k, v in t.items())
            lines.append(f"  {term:<18} {detail}")
    if report["suggestions"]:
        lines.append("suggested overrides (export before the next run):")
        for knob, val in sorted(report["suggestions"].items()):
            lines.append(f"  export {knob}={val}")
    else:
        lines.append("no overrides suggested"
                     + (" (no samples — run a device workload first, or pass"
                        " --ledger FILE.json)" if not report["samples"]
                        else " (model within 2x everywhere — calibrated)"))
    return "\n".join(lines)


def _probe_workload(rows: int, device: str = "cuda") -> None:
    """Populate the process ledger: forced device runs of the aggregate
    shapes the cost model prices (an ungrouped filter + aggregate, a grouped
    aggregate), each priced through DAFT_TPU_PLACEMENT_PRICE_FORCED so
    predicted-vs-observed samples exist (join and udf sites calibrate from
    real-workload ledgers through --ledger)."""
    import numpy as np

    import daft_tpu_torch
    from daft_tpu_torch import col
    from daft_tpu_torch.config import execution_config_ctx

    i = np.arange(rows)
    df = daft_tpu_torch.from_pydict({"k": i % 97, "v": (i % 8191).astype(np.float64),
                                     "w": (i % 31).astype(np.float64)})
    with execution_config_ctx(device=device, device_mode="on", device_min_rows=1):
        # ungrouped filter + agg (the q6 shape), twice: the second run hits
        # resident planes, sampling the warm path's h2d credit too
        for _ in range(2):
            df.where(col("w") > 4).agg(col("v").sum().alias("s"),
                                       col("v").min().alias("lo"),
                                       col("v").max().alias("hi")).to_pydict()
        # grouped agg (the q1 shape)
        for _ in range(2):
            (df.groupby("k").agg(col("v").sum().alias("s"),
                                 col("v").mean().alias("m"),
                                 col("v").count().alias("n"))
               .sort("k").to_pydict())


# ---- measuring the default rates --------------------------------------------------


def _timed(fn, sync, reps: int) -> float:
    """Median seconds of ``fn()`` over ``reps`` calls after one warm call,
    each ended by ``sync()``."""
    fn()
    sync()
    samples = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def measure_rates(device: str = "cuda", rows: int = 1 << 23, reps: int = 5,
                  udf_rows: int = 1024, host_udf_rows: int = 16) -> Dict[str, float]:
    """Every rate of ``ops/costmodel.py`` ``RATES``, timed on ``device`` and
    the host (medians of ``reps``, each call synchronized), at the shapes
    the defaults are taken at: the SF1 bucket of 2^23 rows, a cap of 16,
    K1 over 8 integer planes, K7 over 4 f32 planes, K2 and K3 over one, K4
    probing against 1.5 M keys (SF1's orders), a gather from a 1.5 M-row
    plane, one sort pass, the zeroing of a 2^20 x 8 f64 table, the ungrouped
    stage's program over four sums with a predicate, the host's filter +
    four sums (value-ops), factorize of 2^20 distinct keys and join probe
    over ``rows / 2`` rows, and the MiniLM-L6 encoder's forward
    (``udf_rows`` texts of 128 tokens on the device, ``host_udf_rows`` on
    the host). A smaller ``rows`` shrinks the dim to at most ``rows``
    keys."""
    import numpy as np
    import torch

    import daft_tpu_torch as dt
    from daft_tpu_torch import col
    from daft_tpu_torch.ai import torch_provider as tp
    from daft_tpu_torch.core.kernels.groupby import make_groups
    from daft_tpu_torch.core.kernels.join import ProbeTable
    from daft_tpu_torch.core.series import Series
    from daft_tpu_torch.datatype import DataType, Field
    from daft_tpu_torch.ops import probe_kernels as pk
    from daft_tpu_torch.ops import segment_kernels as sk
    from daft_tpu_torch.ops.stage import FilterAggStage
    from daft_tpu_torch.ops.udf_stage import _to_tensors
    from daft_tpu_torch.schema import Schema
    from daft_tpu_torch.utils.torch_setup import resolve_device

    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(20261018)
    cap, dims = 16, min(1_500_000, rows)
    out: Dict[str, float] = {}
    seg = torch.from_numpy(rng.integers(0, cap, rows).astype(np.int32)).to(dev)
    ints = [torch.from_numpy(rng.integers(0, 256, rows).astype(np.float32)).to(dev)
            for _ in range(8)]
    out["k1_plane_rows_per_s"] = rows * 8 / _timed(
        lambda: sk.segment_sum_planes(ints, seg, cap), sync, reps)
    floats = [torch.from_numpy(rng.uniform(0, 1e5, rows).astype(np.float32)).to(dev)
              for _ in range(4)]
    out["k7_plane_rows_per_s"] = rows * 4 / _timed(
        lambda: sk.segment_sum_float_planes(floats, seg, cap), sync, reps)
    first = torch.arange(rows, dtype=torch.float32, device=dev)
    out["k2_plane_rows_per_s"] = rows / _timed(
        lambda: sk.segment_extreme_planes([first], seg, cap, "min"), sync, reps)
    big = torch.from_numpy(rng.integers(-(1 << 40), 1 << 40, rows)).to(dev)
    keep = torch.ones(rows, dtype=torch.bool, device=dev)
    out["k3_plane_rows_per_s"] = rows / _timed(
        lambda: sk.segment_extreme_int64(big, keep, seg, cap, "max"), sync, reps)
    del ints, floats, first, big

    dim_keys = rng.permutation(np.arange(1, 4 * dims, 4, dtype=np.int64))[:dims]
    table = pk.build_probe_table(torch.from_numpy(dim_keys).to(dev),
                                 torch.ones(dims, dtype=torch.bool, device=dev),
                                 pk.probe_table_slots(dims))
    probe_keys = torch.from_numpy(dim_keys[rng.integers(0, dims, rows)]).to(dev)
    out["k4_probe_rows_per_s"] = rows / _timed(
        lambda: pk.hash_probe_index(probe_keys, keep, table), sync, reps)
    plane = torch.from_numpy(rng.uniform(0, 1, dims).astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(0, dims, rows)).to(dev)
    out["gather_plane_rows_per_s"] = rows / _timed(lambda: plane[idx], sync, reps)
    out["sort_rows_per_s"] = rows / _timed(lambda: torch.sort(probe_keys), sync, reps)
    nbytes = (1 << 20) * 8 * 8
    out["table_bytes_per_s"] = nbytes / _timed(
        lambda: torch.zeros((1 << 20, 8), dtype=torch.float64, device=dev), sync, reps)
    del table, probe_keys, plane, idx

    names = ["a", "b", "c", "d"]
    schema = Schema([Field(n, DataType.float32()) for n in names])
    stage = FilterAggStage(schema, col("a") > 0.5,
                           [(f"s{n}", col(n).sum()) for n in names])
    dcols = {n: (torch.from_numpy(rng.uniform(0, 1, rows).astype(np.float32)).to(dev),
                 keep) for n in names}
    program = stage.program()
    out["mm_plane_rows_per_s"] = rows * len(names) / _timed(
        lambda: program(dcols, keep), sync, reps)
    del dcols

    host_rows = max(rows // 2, 1)
    frame = dt.from_pydict({n: rng.uniform(0, 1, host_rows) for n in names})
    with dt.execution_config_ctx(device_mode="off"):
        # a new DataFrame each call: a collected one keeps its result
        out["host_agg_rate"] = host_rows * (len(names) + 1) / _timed(
            lambda: frame.where(col("a") > 0.5).agg(
                *[col(n).sum().alias(f"s{n}") for n in names]).to_pydict(),
            lambda: None, reps)
    keys = Series.from_numpy(rng.integers(0, 1 << 20, host_rows), "k")
    out["host_factorize_rate"] = host_rows / _timed(lambda: make_groups([keys]),
                                                    lambda: None, reps)
    right = Series.from_numpy(dim_keys, "o")
    probe = ProbeTable([right], [right.dtype])
    left = Series.from_numpy(dim_keys[rng.integers(0, dims, host_rows)], "l")
    out["host_probe_rate"] = host_rows / _timed(lambda: probe.probe([left], "inner"),
                                                lambda: None, reps)

    weights = tp.TorchEncoderWeights.seeded("calibrate-minilm-l6", vocab=30522, dim=384,
                                            layers=6, heads=12, max_len=128)
    fwd = tp.TorchTextEmbedder("calibrate-minilm-l6", weights).encoder_fn()
    d, layers, length = weights.dim, weights.layers, weights.max_len
    flops_per_row = 2 * (12 * d * d + 2 * length * d) * layers * length
    for key, on, n in (("udf_device_flops_per_s", dev, udf_rows),
                       ("udf_host_flops_per_s", torch.device("cpu"), host_udf_rows)):
        params = _to_tensors(weights.params, on)
        ids = torch.from_numpy(rng.integers(0, weights.vocab, (n, length))
                               .astype(np.int32)).to(on)
        mask = torch.ones((n, length), dtype=torch.float32, device=on)

        def forward(params=params, ids=ids, mask=mask):
            with torch.inference_mode():
                fwd(params, ids, mask)

        out[key] = n * flops_per_row / _timed(forward, sync if on == dev else (lambda: None),
                                              reps)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m daft_tpu_torch.tools.calibrate",
        description="Replay placement-ledger observed-vs-predicted samples "
                    "into suggested cost-model env overrides, or measure the "
                    "default rates.")
    ap.add_argument("--ledger", help="read records from a ledger JSON dump "
                                     "instead of running the probe workload")
    ap.add_argument("--rows", type=int, default=65_536,
                    help="probe workload rows (default 65536)")
    ap.add_argument("--device", default="cuda",
                    help="the device the probe workload or --measure runs on "
                         "(default cuda)")
    ap.add_argument("--measure", action="store_true",
                    help="time every default rate and the link terms on --device")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="machine-readable output")
    args = ap.parse_args(argv)

    if args.measure:
        from ..ops.costmodel import _probe_link

        rates = measure_rates(args.device)
        if args.device.startswith("cuda"):
            rates.update(zip(("rtt_s", "h2d_bytes_per_s", "d2h_bytes_per_s"),
                             _probe_link(-1.0)))
        if args.as_json:
            print(json.dumps(rates))
        else:
            for k, v in rates.items():
                print(f"{k:<26} {v:.4g}")
        return 0

    calibration = None
    if args.ledger:
        with open(args.ledger) as f:
            data = json.load(f)
        records = data["records"] if isinstance(data, dict) else data
        if isinstance(data, dict) and data.get("calibration"):
            calibration = data["calibration"]
    else:
        import os

        os.environ["DAFT_TPU_PLACEMENT_PRICE_FORCED"] = "1"
        try:
            _probe_workload(args.rows, args.device)
        finally:
            os.environ.pop("DAFT_TPU_PLACEMENT_PRICE_FORCED", None)
        from ..observability.placement import ledger

        records = ledger().snapshot()

    report = suggest(records, calibration)
    if args.as_json:
        print(json.dumps(report))
    else:
        print(render(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
