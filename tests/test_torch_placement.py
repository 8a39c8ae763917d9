"""The port's placement tier (daft_tpu_torch/observability/placement.py, the
executor's ``device_mode="auto"`` decision points, ops/costmodel.py's
calibration hooks, tools/calibrate.py, cost-weighted eviction) against the
reference's (tests/test_placement.py's cases, each with its counterpart;
``test_bench_compare_warns_on_error_ratio_drift`` waits for the port's
benchmark).

The port prices a stage only on a card: a CPU device is gated to the host
(``executor._auto_gate``), as the reference gates its CPU backend. Tests
that price on CPU tensors monkeypatch that one function, as the reference's
patch ``jax.default_backend``, and pin the link terms
(``DAFT_TPU_COST_RTT`` / ``_H2D`` / ``_D2H``), which a card would measure.
Every "auto" result is held to the port's host path (``device_mode="off"``)
and, where the reference runs the same query, to the reference's result:
integers, keys and extremes exactly, float sums within rtol 1e-5.
"""

from __future__ import annotations

import json
import threading

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.execution import executor
from daft_tpu_torch.observability import placement
from daft_tpu_torch.observability.metrics import registry
from daft_tpu_torch.ops import costmodel, counters

SEED = 20261018
RTOL = 1e-5


def _cal(rtt: float = 0.001) -> costmodel.Calibration:
    return costmodel.Calibration(
        rtt_s=rtt, h2d_bytes_per_s=1e9, d2h_bytes_per_s=2e6, mm_plane_rows_per_s=5e9,
        host_agg_rate=1.5e8, host_factorize_rate=8e6, host_probe_rate=3e7)


@pytest.fixture
def priced(monkeypatch):
    """Price stages on CPU tensors: the CPU gate open, the link terms
    pinned (a fast link: a 50 µs round trip, 10 GB/s both ways)."""
    monkeypatch.setattr(executor, "_auto_gate", lambda cfg: None)
    for env, v in (("DAFT_TPU_COST_RTT", "5e-5"), ("DAFT_TPU_COST_H2D", "1e10"),
                   ("DAFT_TPU_COST_D2H", "1e10")):
        monkeypatch.setenv(env, v)
    costmodel.reset_calibration()
    yield monkeypatch
    costmodel.reset_calibration()


def _same(got, want, floats=()):
    assert list(got) == list(want)
    for c in got:
        if c in floats:
            np.testing.assert_allclose(np.array(got[c], dtype=float),
                                       np.array(want[c], dtype=float), rtol=RTOL, atol=0.0)
        else:
            assert got[c] == want[c], c


def _grouped_data(n: int = 80_000, groups: int = 7):
    rng = np.random.default_rng(SEED)
    return {"k": rng.integers(0, groups, n), "v": np.round(rng.uniform(0, 100, n), 2),
            "w": rng.integers(0, 1000, n)}


def _grouped(df, c=col):
    return (df.groupby("k").agg(c("v").sum().alias("s"), c("w").max().alias("m"),
                                c("v").count().alias("n")).sort("k"))


def _host(query):
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        return query().to_pydict()


# ---------------------------------------------------------------------------
# CostBreakdown and the ledger
# ---------------------------------------------------------------------------

def test_cost_breakdown_terms_and_float_surface():
    cal = _cal(0.010)
    dev = costmodel.device_ungrouped_cost(cal, 1_000_000, 4_000_000, 2, coalesce=4.0,
                                          resident_bytes=8_000)
    assert set(dev.terms) == {"rtt", "h2d", "compute"}
    assert dev.terms["rtt"] == pytest.approx(0.010 / 4.0)
    assert dev.terms["h2d"] == pytest.approx(4_000_000 / 1e9)
    assert dev.total == pytest.approx(sum(dev.terms.values()))
    assert dev.notes["coalesce"] == 4.0
    assert dev.notes["residency_credit_s"] == pytest.approx(8_000 / 1e9)
    host = costmodel.host_agg_cost(cal, 1_000_000, 2, grouped=True, has_predicate=True)
    assert "factorize" in host.terms and "compute" in host.terms
    assert (dev < host) == (dev.total < host.total)
    assert dev * 1e3 == pytest.approx(dev.total * 1e3)
    assert float(dev) == dev.total
    assert (dev + 0.5).total == pytest.approx(dev.total + 0.5)
    d = dev.as_dict()
    assert d["total"] == pytest.approx(dev.total)
    assert d["note_residency_credit_s"] == pytest.approx(8_000 / 1e9)


def test_cost_breakdown_terms_cover_every_tier():
    cal = _cal()
    join = costmodel.device_join_kernel_cost(cal, 100_000, 1_000_000, 100_000, 3, k1=2, k7=1,
                                             k2=1, k3=0, n_partials=0, cap_est=64,
                                             fetch_bytes=4096, factorize_rows=100_000)
    assert {"rtt", "h2d", "probe", "compute", "table", "d2h", "factorize"} <= set(join.terms)
    grouped = costmodel.device_grouped_kernel_cost(cal, 1_000_000, 0, k1=3, k7=1, k2=1, k3=1,
                                                   cap=1024, factorize_rows=1_000_000)
    assert {"rtt", "compute", "table", "d2h", "factorize"} <= set(grouped.terms)
    hj = costmodel.host_join_agg_cost(cal, 100_000, 3, 2, True, False)
    assert "probe" in hj.terms
    udf = costmodel.device_udf_cost(cal, 4096, 4096 * 1024, 1e9, 4096 * 512)
    assert {"rtt", "h2d", "compute", "d2h"} <= set(udf.terms)
    before = join.terms["compute"]
    join.add("compute", 0.25)
    assert join.terms["compute"] == pytest.approx(before + 0.25)


def test_ledger_record_margin_and_render():
    led = placement.PlacementLedger(cap=16)
    cal = _cal(0.090)
    dev = costmodel.device_ungrouped_cost(cal, 200_000, 0, 1)
    host = costmodel.host_agg_cost(cal, 200_000, 1, grouped=False, has_predicate=True)
    rec = led.record("agg", "host", 200_000, device=dev, host=host, detail="1 aggs, filtered")
    assert rec is not None
    assert rec.margin() == pytest.approx(max(dev.total, host.total)
                                         / min(dev.total, host.total))
    text = placement.render(led.records())
    assert "#1 agg" in text and "-> host" in text
    assert "rtt" in text and "margin:" in text and "TOTAL" in text
    led.observe(rec, 0.5, term_seconds={"h2d": 0.1, "dispatch": 0.3}, rows=400_000,
                dispatches=2)
    assert rec.observed["total"] == 0.5
    assert rec.error_ratio is not None
    assert "observed:" in placement.render(led.records())


def test_ledger_bounded_with_drop_counter():
    led = placement.PlacementLedger(cap=4)
    for i in range(10):
        led.record("agg", "host", i)
    st = led.stats()
    assert st["records"] == 4 and st["dropped"] == 6 and st["seq"] == 10
    assert [r.rows for r in led.records()] == [6, 7, 8, 9]
    led_off = placement.PlacementLedger(cap=0)
    assert led_off.record("agg", "host", 1) is None
    assert led_off.stats()["records"] == 0


# ---------------------------------------------------------------------------
# Scopes: concurrency and the pipeline's stage threads
# ---------------------------------------------------------------------------

def test_concurrent_scopes_no_bleed_no_loss():
    led = placement.PlacementLedger(cap=64)
    N, M = 8, 40
    results, errors = {}, []

    def worker(tid: int) -> None:
        try:
            with placement.query_scope(cap=M) as scope:
                for i in range(M):
                    led.record("agg", "host", rows=tid * 1000 + i, detail=f"t{tid}")
                results[tid] = scope.to_dicts()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(N)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    for tid in range(N):
        recs = results[tid]
        assert len(recs) == M, f"thread {tid} lost records"
        assert all(r["detail"] == f"t{tid}" for r in recs), "cross-query bleed"
        assert sorted(r["rows"] for r in recs) == [tid * 1000 + i for i in range(M)]
    st = led.stats()
    assert st["records"] == 64 and st["dropped"] == N * M - 64 and st["seq"] == N * M


def test_scope_propagates_to_stage_threads():
    """Decision sites fire on pipeline stage threads: the scope rides
    spawn_stage, and a kept stage thread drops it when its stage ends."""
    from daft_tpu_torch.execution.pipeline import spawn_stage

    led = placement.ledger()
    with placement.query_scope() as scope:
        def gen():
            led.gate("agg", "stage-thread probe", 123, only_scoped=True)
            yield 1

        list(spawn_stage(gen()))
    recs = scope.to_dicts()
    assert len(recs) == 1 and recs[0]["reason"] == "stage-thread probe"
    seen = []

    def after():
        seen.append(placement.current_scope())
        yield 1

    list(spawn_stage(after()))  # a kept thread, no scope on the caller
    assert seen == [None]


def test_auto_decisions_on_stage_threads_land_in_their_own_scope(priced):
    """Two auto queries at once, each under pipeline_mode="force" (the
    device aggregate on a stage thread) in its own scope: each scope holds
    its own query's decision and nothing of the other's."""
    frames = {g: dt.from_pydict(_grouped_data(70_000, g)) for g in (3, 5)}
    scopes, errors = {}, []

    def run(g):
        try:
            with placement.query_scope() as scope:
                _grouped(frames[g]).to_pydict()
            scopes[g] = scope.to_dicts()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    # the process-wide config, set once: execution_config_ctx is not
    # thread-local
    with dt.execution_config_ctx(device="cpu", device_mode="auto", device_min_rows=1,
                                 pipeline_mode="force"):
        threads = [threading.Thread(target=run, args=(g,)) for g in frames]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errors
    for g in frames:
        sites = [r for r in scopes[g] if r["site"] == "grouped agg"]
        assert len(sites) == 1 and f"~{g} groups" in sites[0]["detail"]


# ---------------------------------------------------------------------------
# Recalibration, gauges, the zero-overhead guard
# ---------------------------------------------------------------------------

def test_reset_calibration_invalidates_decision_caches():
    executor._DECISION_CACHE.put(("stale", "join"), False)
    assert len(executor._DECISION_CACHE)
    costmodel.reset_calibration()
    assert len(executor._DECISION_CACHE) == 0, "stale join verdict survived recalibration"


def test_calibration_terms_exported_as_gauges(monkeypatch):
    monkeypatch.setenv("DAFT_TPU_COST_RTT", "0.042")
    monkeypatch.setenv("DAFT_TPU_COST_H2D", "2e9")
    monkeypatch.setenv("DAFT_TPU_COST_D2H", "3e6")
    costmodel.reset_calibration()
    try:
        cal = costmodel.calibrate()
        assert cal.rtt_s == 0.042
        snap = registry().snapshot()
        assert snap["cost_rtt_s"] == 0.042 and snap["cost_h2d_bytes_per_s"] == 2e9
        assert snap["cost_d2h_bytes_per_s"] == 3e6
        d = costmodel.calibration_dict()
        assert d["rtt_s"] == 0.042
        assert d["host_factorize_rate"] == costmodel.RATES["host_factorize_rate"][1]
    finally:
        costmodel.reset_calibration()
    assert registry().snapshot()["cost_rtt_s"] == 0.0
    assert costmodel.calibration_dict() == {}


def test_placement_zero_overhead_on_host_path():
    """A plain host query (no scope) leaves the process ledger AND the
    registry untouched: device_mode="off", and "auto" on a CPU device,
    where a large query crosses the min-rows gate and the CPU gate (both
    only_scoped: scope-less queries record nothing)."""
    led = placement.ledger()
    seq_before = led.stats()["seq"]
    before = registry().snapshot()
    df = dt.from_pydict({"a": list(range(1000)), "b": ["x", "y"] * 500})
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        out = (df.where(col("a") >= 500).groupby("b").agg(col("a").sum().alias("s"))
               .to_pydict())
    assert len(out["b"]) == 2
    big = dt.from_pydict({"k": [i % 3 for i in range(80_000)],
                          "v": [float(i) for i in range(80_000)]})
    with dt.execution_config_ctx(device="cpu", device_mode="auto", device_min_rows=1):
        big.groupby("k").agg(col("v").sum().alias("s")).to_pydict()
    assert led.stats()["seq"] == seq_before, "ledger touched on host path"
    assert registry().diff(before) == {}, "registry touched on host path"


# ---------------------------------------------------------------------------
# "auto" end to end on CPU tensors
# ---------------------------------------------------------------------------

def test_auto_on_a_cpu_device_never_builds_a_device_stage():
    """Without the gate patched, "auto" on device="cpu" runs every stage on
    the host: no device batch, no kernel call, the host path's result; in a
    scope the gate is recorded with its reason."""
    df = dt.from_pydict(_grouped_data())
    counters.reset()
    with dt.execution_config_ctx(device="cpu", device_mode="auto", device_min_rows=1):
        with placement.query_scope() as scope:
            got = _grouped(df).to_pydict()
    snap = counters.snapshot()
    assert snap["device_grouped_batches"] == 0 and snap["device_stage_batches"] == 0
    assert not any(v for k, v in snap.items() if k.startswith(("plain_", "launches_")))
    assert [(r["site"], r["chosen"], r["reason"]) for r in scope.to_dicts()] == \
        [("grouped agg", "host", "cpu device")]
    _same(got, _host(lambda: _grouped(df)), ("s",))


def test_auto_with_cuda_and_no_card_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    df = dt.from_pydict(_grouped_data(1000))
    with dt.execution_config_ctx(device="cuda", device_mode="auto"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            _grouped(df).to_pydict()


def test_device_mode_env_and_amortize_knob(monkeypatch):
    from daft_tpu.config import ExecutionConfig as RefConfig
    from daft_tpu_torch.config import ExecutionConfig

    assert ExecutionConfig().device_mode == "on"  # the port's default (ROADMAP Queue 3)
    monkeypatch.setenv("DAFT_TPU_DEVICE", "auto")
    monkeypatch.setenv("DAFT_TPU_DEVICE_AMORTIZE", "16")
    assert ExecutionConfig().device_mode == RefConfig().device_mode == "auto"
    assert ExecutionConfig().device_amortize_runs == RefConfig().device_amortize_runs == 16
    monkeypatch.delenv("DAFT_TPU_DEVICE_AMORTIZE")
    assert ExecutionConfig().device_amortize_runs == RefConfig().device_amortize_runs == 64
    with pytest.raises(ValueError, match="DAFT_TPU_DEVICE"):
        ExecutionConfig(device_mode="maybe")


def test_explain_placement_costed_decision(priced):
    """On a 90 ms link with 1 MB/s uploads "auto" cost-rejects a grouped
    aggregate to the host; explain_placement shows both per-term tables,
    the margin and the host verdict; the placement counters attribute it;
    the result is the host path's."""
    priced.setenv("DAFT_TPU_COST_RTT", "0.090")
    priced.setenv("DAFT_TPU_COST_H2D", "1e6")
    priced.setenv("DAFT_TPU_COST_D2H", "1e6")
    costmodel.reset_calibration()
    before = registry().snapshot()
    df = dt.from_pydict({"k": [i % 7 for i in range(80_000)],
                         "v": [float(i % 101) for i in range(80_000)]})
    q = df.groupby("k").agg(col("v").sum().alias("s"))
    counters.reset()
    with dt.execution_config_ctx(device="cpu", device_mode="auto", device_min_rows=1):
        text = q.explain_placement()
        got = df.groupby("k").agg(col("v").sum().alias("s")).sort("k").to_pydict()
    assert "grouped agg" in text and "-> host" in text
    assert "margin:" in text and "rtt" in text and "factorize" in text
    assert counters.device_grouped_batches == 0
    diff = registry().diff(before)
    assert diff.get("placement_decisions_total", 0) >= 1
    assert diff.get("placement_host_wins", 0) >= 1
    _same(got, _host(lambda: df.groupby("k").agg(col("v").sum().alias("s")).sort("k")),
          ("s",))


def test_fast_link_sends_the_grouped_aggregate_to_the_stage(priced):
    """On a fast link the same kind of query goes to the grouped stage (on
    CPU tensors: its kernels' plain versions), equal to the host path and
    to the reference's result; the verdict and both sides ride the record."""
    data = _grouped_data()
    df = dt.from_pydict(data)
    counters.reset()
    with dt.execution_config_ctx(device="cpu", device_mode="auto", device_min_rows=1):
        with placement.query_scope() as scope:
            got = _grouped(df).to_pydict()
    assert counters.device_grouped_batches == 1 and counters.plain_segment_sum_planes >= 1
    rec = scope.to_dicts()[0]
    assert rec["site"] == "grouped agg" and rec["chosen"] == "device" and not rec["forced"]
    assert rec["device"]["total"] < rec["host"]["total"] and rec["margin"] > 1
    assert {"compute", "table"} <= set(rec["device"])
    assert rec["observed"]["rows"] == len(data["k"])
    _same(got, _host(lambda: _grouped(df)), ("s",))
    ref = daft_tpu.from_pydict({k: v.tolist() for k, v in data.items()})
    with daft_tpu.execution_config_ctx(device_mode="off"):
        _same(got, _grouped(ref, daft_tpu.col).to_pydict(), ("s",))


def test_auto_ungrouped_aggregate_both_ways(priced):
    data = _grouped_data()
    df = dt.from_pydict(data)

    def q():
        return df.where(col("w") > 100).agg(col("v").sum().alias("s"),
                                            col("w").min().alias("lo"))

    want = _host(q)
    for rtt, stage_batches in (("5e-5", 1), ("10.0", 0)):
        priced.setenv("DAFT_TPU_COST_RTT", rtt)
        costmodel.reset_calibration()
        counters.reset()
        with dt.execution_config_ctx(device="cpu", device_mode="auto", device_min_rows=1):
            with placement.query_scope() as scope:
                got = q().to_pydict()
        assert counters.device_stage_batches == stage_batches
        assert scope.to_dicts()[0]["site"] == "agg"
        _same(got, want, ("s",))


def _star(n: int = 70_000, dim: int = 5_000, groups: int = 9):
    rng = np.random.default_rng(SEED)
    fact = dt.from_pydict({"fk": rng.integers(0, dim, n), "v": np.round(rng.uniform(0, 10, n), 2),
                           "q": rng.integers(1, 50, n)})
    d = dt.from_pydict({"dk": np.arange(dim), "g": rng.integers(0, groups, dim),
                        "flag": rng.integers(0, 2, dim)})
    return fact, d


def _join_grouped(fact, d, c=col):
    return (fact.join(d, left_on="fk", right_on="dk").where(c("flag") == 1)
            .groupby("g").agg(c("v").sum().alias("s"), c("q").max().alias("m")).sort("g"))


def _join_ungrouped(fact, d):
    return fact.join(d, left_on="fk", right_on="dk").where(col("flag") == 1).agg(
        col("v").sum().alias("s"), col("q").count().alias("n"))


def _join_topn(fact, d):
    return (fact.join(d, left_on="fk", right_on="dk")
            .groupby("fk", "g").agg(col("v").sum().alias("s"))
            .sort(["s", "fk"], desc=[True, False]).limit(5))


@pytest.mark.parametrize("shape,site", [(_join_grouped, "join agg"),
                                        (_join_ungrouped, "join agg"),
                                        (_join_topn, "join topn")],
                         ids=["grouped", "ungrouped", "topn"])
def test_auto_star_join_both_ways(priced, shape, site):
    """The star join, its ungrouped form and its TopN under "auto": a fast
    link runs the join stage, a slow one the host plan, and the cached
    reject serves a repeat without pricing; every result equals the host
    path's."""
    fact, d = _star()
    want = _host(lambda: shape(fact, d))
    with dt.execution_config_ctx(device="cpu", device_mode="auto", device_min_rows=1):
        counters.reset()
        with placement.query_scope() as scope:
            got = shape(fact, d).to_pydict()
        assert counters.device_join_batches == 1
        rec = next(r for r in scope.to_dicts() if r["site"] == site)
        assert rec["chosen"] == "device" and {"probe", "compute"} <= set(rec["device"])
        _same(got, want, ("s",))
        priced.setenv("DAFT_TPU_COST_RTT", "10.0")
        costmodel.reset_calibration()
        for cached in (False, True):
            counters.reset()
            with placement.query_scope() as scope:
                got = shape(fact, d).to_pydict()
            assert counters.device_join_batches == 0
            rec = next(r for r in scope.to_dicts() if r["site"] == site)
            assert rec["chosen"] == "host" and rec["cached"] == cached
            _same(got, want, ("s",))


def test_auto_device_udf_both_ways(priced):
    """A device UDF under "auto": a fast link runs the device-UDF stage, a
    slow one the host path on the CPU (``device_udf_fallbacks``); the
    verdict is cached per function and batch layout."""
    import torch

    # a million weights: the model's flops (2 a weight a row) outweigh the
    # reference's per-row upload and copy-back estimates on a fast link
    w = np.full(1 << 20, 1e-6, dtype=np.float32)

    @dt.func(return_dtype=dt.DataType.float64(), on_device=True,
             device_params=lambda: {"w": w})
    def score(params, x):
        return x.to(torch.float64) * params["w"].sum().to(torch.float64)

    df = dt.from_pydict({"x": np.arange(70_000, dtype=np.float64)})

    def q():
        return df.select(col("x"), score(col("x")).alias("y"))

    want = _host(q)
    with dt.execution_config_ctx(device="cpu", device_mode="auto", device_min_rows=1):
        counters.reset()
        with placement.query_scope() as scope:
            got = q().to_pydict()
        assert counters.device_udf_runs == 1 and counters.device_udf_fallbacks == 0
        assert scope.to_dicts()[0]["site"] == "udf"
        assert scope.to_dicts()[0]["chosen"] == "device"
        _same(got, want)
        priced.setenv("DAFT_TPU_COST_UDF_HOST_FLOPS", "1e30")  # the host wins
        costmodel.reset_calibration()
        for cached in (False, True):
            counters.reset()
            with placement.query_scope() as scope:
                got = q().to_pydict()
            assert counters.device_udf_runs == 0 and counters.device_udf_fallbacks == 1
            recs = scope.to_dicts()
            assert recs[0]["chosen"] == "host" and recs[0]["cached"] == cached
            _same(got, want)


def test_slice_auto_equals_the_references_auto(priced, monkeypatch):
    """The same seeded grouped aggregate and star join through the
    reference's "auto" (its backend check patched to a TPU, the same link
    terms) and the port's: whatever each places where, the results are
    equal, and each package records one costed decision per stage."""
    import jax

    from daft_tpu.observability import placement as ref_placement
    from daft_tpu.ops import costmodel as ref_costmodel

    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    ref_costmodel.reset_calibration()
    data = _grouped_data()
    rng = np.random.default_rng(SEED + 1)
    n, dim = 70_000, 5_000
    star = {"fk": rng.integers(0, dim, n), "v": np.round(rng.uniform(0, 10, n), 2),
            "q": rng.integers(1, 50, n)}
    dims = {"dk": np.arange(dim), "g": rng.integers(0, 9, dim), "flag": rng.integers(0, 2, dim)}
    try:
        for shape in ("grouped", "join"):
            results, sites = {}, {}
            for pkg, pl, ctx in ((daft_tpu, ref_placement,
                                  dict(device_mode="auto", device_min_rows=1, mesh_devices=1)),
                                 (dt, placement,
                                  dict(device="cpu", device_mode="auto", device_min_rows=1))):
                if shape == "grouped":
                    query = _grouped(pkg.from_pydict({k: v.tolist() for k, v in data.items()}),
                                     pkg.col)
                else:
                    query = _join_grouped(pkg.from_pydict({k: v.tolist() for k, v in star.items()}),
                                          pkg.from_pydict({k: v.tolist() for k, v in dims.items()}),
                                          pkg.col)
                with pkg.execution_config_ctx(**ctx):
                    with pl.query_scope() as scope:
                        results[pkg] = query.to_pydict()
                sites[pkg] = sorted(r["site"] for r in scope.to_dicts())
            _same(results[dt], results[daft_tpu], ("s",))
            assert sites[dt] == sites[daft_tpu]
    finally:
        ref_costmodel.reset_calibration()


# ---------------------------------------------------------------------------
# Forced pricing, feedback, the surfaces
# ---------------------------------------------------------------------------

def test_forced_priced_run_feeds_back_observed(priced):
    """device_mode="on" + DAFT_TPU_PLACEMENT_PRICE_FORCED: the forced run
    carries a priced breakdown AND an observation (total seconds, per-term
    span seconds, dispatches, rows), the error-ratio gauge moves, and
    QueryEnd.placements ships the record."""
    priced.setenv("DAFT_TPU_PLACEMENT_PRICE_FORCED", "1")
    from daft_tpu_torch.observability.subscribers import attach_subscriber, detach_subscriber

    ends = []

    class _Sub:
        def on_query_end(self, e):
            ends.append(e)

    before = registry().snapshot()
    sub = _Sub()
    attach_subscriber(sub)
    try:
        df = dt.from_pydict({"k": [i % 13 for i in range(50_000)],
                             "v": [float(i % 97) for i in range(50_000)]})
        with dt.execution_config_ctx(device="cpu", device_mode="on", device_min_rows=1):
            out = df.groupby("k").agg(col("v").sum().alias("s")).sort("k").to_pydict()
        assert len(out["k"]) == 13
    finally:
        detach_subscriber(sub)
    diff = registry().diff(before)
    assert diff.get("placement_forced_runs", 0) >= 1
    assert diff.get("placement_feedback_total", 0) >= 1
    assert "cost_model_error_ratio" in diff
    placements = [p for e in ends for p in e.placements]
    assert placements, "QueryEnd carried no placement records"
    rec = next(p for p in placements if p.get("observed"))
    assert rec["forced"] and rec["chosen"] == "device"
    assert rec["device"]["total"] > 0
    assert rec["observed"]["total"] > 0
    assert rec["observed"]["wall"] >= rec["observed"]["total"]
    assert rec["observed"].get("dispatches", 0) >= 1
    assert rec["observed"].get("rows", 0) == 50_000
    assert "error_ratio" in rec


def test_forced_runs_on_a_cpu_device_are_recorded_unpriced(monkeypatch):
    """On a CPU device PRICE_FORCED prices nothing (no calibration to price
    with): the forced record carries the observation alone."""
    monkeypatch.setenv("DAFT_TPU_PLACEMENT_PRICE_FORCED", "1")
    df = dt.from_pydict(_grouped_data(20_000))
    with dt.execution_config_ctx(device="cpu", device_mode="on"):
        with placement.query_scope() as scope:
            _grouped(df).to_pydict()
    rec = scope.to_dicts()[0]
    assert rec["forced"] and "device" not in rec and rec["observed"]["total"] > 0


def test_feedback_tee_does_not_steal_profiler_spans():
    from daft_tpu_torch.observability.runtime_stats import (SpanRecorder, current_spans,
                                                             set_spans)

    outer = SpanRecorder()
    prev = current_spans()
    set_spans(outer)
    try:
        df = dt.from_pydict({"k": [i % 5 for i in range(20_000)],
                             "v": [float(i) for i in range(20_000)]})
        with dt.execution_config_ctx(device="cpu", device_mode="on", device_min_rows=1):
            df.groupby("k").agg(col("v").sum().alias("s")).to_pydict()
    finally:
        set_spans(prev)
    names = {s["name"] for s in outer.drain()}
    assert any(n.startswith("device.") for n in names), \
        f"profiler lost device spans to the placement tee: {names}"


def test_sql_explain_placement():
    df = dt.from_pydict({"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]})
    with dt.execution_config_ctx(device="cpu"):
        out = dt.sql("EXPLAIN PLACEMENT SELECT a, sum(b) AS s FROM df GROUP BY a",
                     df=df).to_pydict()
    ref = daft_tpu.sql("EXPLAIN PLACEMENT SELECT a, sum(b) AS s FROM df GROUP BY a",
                       df=daft_tpu.from_pydict({"a": [1, 2, 3], "b": [1.0, 2.0, 3.0]}))
    assert out["explain"][0] == ref.to_pydict()["explain"][0] == "== Placement Decisions =="
    with pytest.raises(ValueError, match="requires a query"):
        dt.sql("EXPLAIN PLACEMENT")


def test_api_placement_endpoint():
    from urllib.request import urlopen

    from daft_tpu_torch.observability.dashboard import launch

    d = launch()
    try:
        placement.ledger().record("agg", "host", 42,
                                  device=costmodel.device_ungrouped_cost(_cal(), 42, 0, 1),
                                  host=costmodel.host_agg_cost(_cal(), 42, 1, False, False))
        body = json.loads(urlopen(d.url + "/api/placement").read())
        assert {"records", "stats", "error", "calibration"} <= set(body)
        assert body["stats"]["records"] >= 1
        assert any(r["site"] == "agg" and "margin" in r for r in body["records"])
        text = urlopen(d.url + "/metrics").read().decode()
        assert "daft_tpu_placement_decisions_total" in text
        assert "daft_tpu_cost_model_error_ratio" in text
        assert "daft_tpu_cost_rtt_s" in text
    finally:
        d.shutdown()


def test_event_log_query_end_carries_placements(tmp_path, monkeypatch):
    from daft_tpu_torch.observability.event_log import disable_event_log, enable_event_log

    p = str(tmp_path / "ev.jsonl")
    sub = enable_event_log(p)
    try:
        df = dt.from_pydict({"k": [i % 3 for i in range(20_000)],
                             "v": [float(i) for i in range(20_000)]})
        with dt.execution_config_ctx(device="cpu", device_mode="on", device_min_rows=1):
            df.groupby("k").agg(col("v").sum().alias("s")).to_pydict()
    finally:
        disable_event_log(sub)
    events = [json.loads(line) for line in open(p)]
    ends = [e for e in events if e["event"] == "query_end"]
    assert ends and all(e["schema_version"] == 11 for e in events)
    placements = [p for e in ends for p in e.get("placements", [])]
    assert placements and placements[0]["site"] in ("agg", "grouped agg")


# ---------------------------------------------------------------------------
# The calibrate tool
# ---------------------------------------------------------------------------

def _records():
    """Agg- and udf-site samples (the sites both tools key alike): observed
    h2d 4x slower than priced, dispatch windows 10x the compute term."""
    return [{
        "site": "agg", "chosen": "device", "rows": 100_000,
        "device": {"total": 0.011, "rtt": 0.001, "h2d": 0.004, "compute": 0.006},
        "host": {"total": 0.02, "compute": 0.02},
        "observed": {"total": 0.078, "h2d": 0.016, "dispatch": 0.062, "d2h": 0.0,
                     "rows": 100_000, "dispatches": 2},
        "error_ratio": 7.4,
    }, {
        "site": "udf", "chosen": "device", "rows": 4096,
        "device": {"total": 0.05, "rtt": 0.001, "h2d": 0.002, "compute": 0.04, "d2h": 0.007},
        "host": {"total": 0.5, "compute": 0.5},
        "observed": {"total": 0.02, "h2d": 0.001, "dispatch": 0.012, "d2h": 0.007,
                     "rows": 4096, "dispatches": 4},
        "error_ratio": 0.4,
    }, {
        "site": "agg", "chosen": "host", "rows": 10,
        "device": {"total": 0.5, "rtt": 0.5}, "host": {"total": 0.001, "compute": 0.001},
    }]


def test_calibrate_suggest_equals_the_references():
    from daft_tpu.tools import calibrate as ref_tool
    from daft_tpu_torch.tools import calibrate as cal_tool

    cal = _cal(0.001)
    calibration = {k: getattr(cal, k) for k in cal.__dataclass_fields__}
    report = cal_tool.suggest(_records(), calibration)
    assert report == ref_tool.suggest(_records(), calibration)
    assert report["samples"] == 2
    assert report["terms"]["h2d"]["observed_over_predicted"] == 4.0
    assert float(report["suggestions"]["DAFT_TPU_COST_H2D"]) == pytest.approx(2.5e8)
    assert "DAFT_TPU_COST_MM_RATE" in report["suggestions"]
    text = cal_tool.render(report)
    assert text == ref_tool.render(report)
    assert "suggested overrides" in text and "DAFT_TPU_COST_H2D" in text


def test_calibrate_suggests_the_ports_kernel_and_probe_rates():
    from daft_tpu_torch.tools import calibrate as cal_tool

    cal = costmodel.Calibration(**{**{f: 1.0 for f in costmodel.Calibration.__dataclass_fields__},
                                   "rtt_s": 0.0001})
    calibration = {k: getattr(cal, k) for k in cal.__dataclass_fields__}
    rec = {"site": "join agg", "chosen": "device", "rows": 1000,
           "device": {"total": 0.01, "h2d": 0.001, "probe": 0.002, "compute": 0.004},
           "observed": {"total": 0.1, "h2d": 0.021, "dispatch": 0.0401, "dispatches": 1}}
    report = cal_tool.suggest([rec], calibration)
    assert report["terms"]["probe"]["observed_over_predicted"] == 10.0
    assert float(report["suggestions"]["DAFT_TPU_COST_K4_PROBE_RATE"]) == pytest.approx(0.1)
    for knob in ("DAFT_TPU_COST_GATHER_RATE", "DAFT_TPU_COST_K1_RATE", "DAFT_TPU_COST_K7_RATE",
                 "DAFT_TPU_COST_K2_RATE", "DAFT_TPU_COST_K3_RATE"):
        assert float(report["suggestions"][knob]) == pytest.approx(0.1)


def test_calibrate_cli_ledger_mode(tmp_path, capsys):
    from daft_tpu_torch.tools import calibrate as cal_tool

    p = tmp_path / "ledger.json"
    p.write_text(json.dumps({"records": [], "calibration": {}}))
    assert cal_tool.main(["--ledger", str(p), "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["samples"] == 0 and report["suggestions"] == {}
    p.write_text(json.dumps(_records()))
    assert cal_tool.main(["--ledger", str(p)]) == 0
    assert "observed-vs-predicted samples: 2" in capsys.readouterr().out


def test_calibrate_cli_probe_workload(priced, capsys):
    """The CLI's probe workload on CPU tensors (the gate patched open): forced,
    priced runs whose observations become samples."""
    from daft_tpu_torch.tools import calibrate as cal_tool

    placement.ledger().clear()
    assert cal_tool.main(["--device", "cpu", "--rows", "20000", "--json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["samples"] >= 4 and report["calibration"]["rtt_s"] == 5e-5


# ---------------------------------------------------------------------------
# Cost-weighted eviction (device/residency.py)
# ---------------------------------------------------------------------------

def _kb():
    import torch

    return torch.empty(256, dtype=torch.float32, device="meta")


class _Anchor:
    pass


def test_cost_weighted_eviction_cheapest_first():
    from daft_tpu_torch.config import execution_config_ctx
    from daft_tpu_torch.device.residency import ResidencyManager

    m = ResidencyManager()
    saved_before = registry().get("hbm_evict_cost_saved")
    dear, cheap, extra = _Anchor(), _Anchor(), _Anchor()
    with execution_config_ctx(hbm_budget_bytes=2 * 1024 + 512):
        # the EXPENSIVE entry first: the LRU-oldest, which pure recency
        # eviction would take
        m.get_or_build(dear, ("d",), _kb, rebuild_rows=50_000_000)
        m.get_or_build(cheap, ("c",), _kb)
        m.get_or_build(extra, ("x",), _kb)
        assert m.is_resident(dear, ("d",))
        assert not m.is_resident(cheap, ("c",))
        assert m.bytes_resident() <= 2 * 1024 + 512
    assert registry().get("hbm_evict_cost_saved") > saved_before


def test_eviction_keeps_recency_with_few_entries():
    from daft_tpu_torch.config import execution_config_ctx
    from daft_tpu_torch.device.residency import ResidencyManager

    m = ResidencyManager()
    cold_dear, hot_cheap = _Anchor(), _Anchor()
    with execution_config_ctx(hbm_budget_bytes=1024 + 512):
        m.get_or_build(cold_dear, ("d",), _kb, rebuild_rows=50_000_000)
        m.get_or_build(hot_cheap, ("c",), _kb)
        assert m.is_resident(hot_cheap, ("c",))
        assert not m.is_resident(cold_dear, ("d",))


def test_eviction_bucket_ignores_pinned_padding():
    from daft_tpu_torch.config import execution_config_ctx
    from daft_tpu_torch.device.residency import ResidencyManager

    m = ResidencyManager()
    pinned, cold_dear, hot_cheap = _Anchor(), _Anchor(), _Anchor()
    with execution_config_ctx(hbm_budget_bytes=2 * 1024 + 512):
        with m.pin_scope():
            m.get_or_build(pinned, ("pin",), _kb)
            m.get_or_build(cold_dear, ("d",), _kb, rebuild_rows=50_000_000)
        with m.pin_scope():
            m.get_or_build(pinned, ("pin",), _kb)
            m.get_or_build(hot_cheap, ("c",), _kb)
            assert m.is_resident(hot_cheap, ("c",))
            assert not m.is_resident(cold_dear, ("d",))


def test_cost_weighted_eviction_never_touches_pins():
    from daft_tpu_torch.config import execution_config_ctx
    from daft_tpu_torch.device.residency import ResidencyManager

    m = ResidencyManager()
    pinned_cheap, dear = _Anchor(), _Anchor()
    with execution_config_ctx(hbm_budget_bytes=1024 + 512):
        m.get_or_build(dear, ("d",), _kb, rebuild_rows=10_000_000)
        with m.pin_scope():
            m.get_or_build(pinned_cheap, ("p",), _kb)
            assert m.is_resident(pinned_cheap, ("p",))
            assert not m.is_resident(dear, ("d",))


def test_residency_probe_sees_a_content_rebind_without_fingerprinting():
    """is_resident: a plane registered for a Series is seen through another
    Series of equal content only once that Series' fingerprint is known;
    the probe never computes one."""
    from daft_tpu_torch.core.series import Series
    from daft_tpu_torch.device.residency import ResidencyManager

    m = ResidencyManager()
    a = Series.from_numpy(np.arange(1000, dtype=np.float64), "a")
    b = Series.from_numpy(np.arange(1000, dtype=np.float64), "b")
    m.get_or_build(a, ("col", 1024, True, "cpu"), _kb)
    assert m.is_resident(a, ("col", 1024, True, "cpu"))
    assert not m.is_resident(b, ("col", 1024, True, "cpu"))
    assert b._content_fp is None, "the probe computed a fingerprint"
    b.content_fingerprint()
    assert m.is_resident(b, ("col", 1024, True, "cpu"))


@pytest.mark.parametrize("distinct", [3, 10_000, 200_000])
def test_group_estimate_stays_near_the_true_count(distinct):
    """The grouped decision's group-count estimate (``estimate_distinct``:
    an evenly spread sample and Chao1) is within 25 % of the true count of
    uniform keys over 600,000 rows, exact once the column's dictionary
    codes are cached, and never above the rows."""
    from daft_tpu_torch.core.series import Series
    from daft_tpu_torch.ops.grouped_stage import estimate_distinct, estimate_groups

    rng = np.random.default_rng(SEED)
    s = Series.from_numpy(rng.integers(0, distinct, 600_000), "k")
    true = len(np.unique(s.to_numpy()))
    assert abs(estimate_distinct(s) - true) <= 0.25 * true
    s.dict_codes()
    assert estimate_distinct(s) == true
    assert estimate_groups([s, s], 1000) == 1000 or distinct == 3


def test_host_run_after_a_device_run_keeps_its_pace():
    """A device run may leave dictionary codes on a dim's unique key (the
    join TopN's host factorize codes ``o_orderkey``); Series taken from it
    and concatenated again keep its value list instead of re-mapping it
    value by value per part. Their codes equal a fresh factorize's."""
    from daft_tpu_torch.core.series import Series

    rng = np.random.default_rng(SEED)
    key = Series.from_numpy(rng.permutation(300_000).astype(np.int64), "o_orderkey")
    key.dict_codes()
    parts = [key.take(rng.integers(0, 300_000, 50_000)) for _ in range(12)]
    out = Series.concat(parts)
    assert out._dict_codes[2] is key.dict_codes()[1]  # the shared value list
    fresh = Series.from_numpy(out.to_numpy(), "o_orderkey")
    codes, values, k = out.dict_codes()
    want_codes, want_values, want_k = fresh.dict_codes()
    assert k == want_k and values == want_values
    np.testing.assert_array_equal(codes, want_codes)
    mixed = Series.concat([parts[0], Series.from_numpy(np.arange(5), "o_orderkey")])
    assert mixed._dict_codes is None or mixed.dict_codes()[2] == len(
        np.unique(mixed.to_numpy()))
