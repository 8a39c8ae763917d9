"""The sketch aggregates against the reference (daft_tpu/core/kernels/
sketches.py), on the same seeded inputs: ``approx_count_distinct`` equal
(HyperLogLog ungrouped, the exact distinct count grouped, as the
reference), ``approx_percentile`` at rtol 1e-12, one and several
percentiles, ungrouped and grouped, as DataFrames and, for
APPROX_COUNT_DISTINCT, in SQL; the HLL registers equal the reference's;
the sketches run as one phase over many morsels and under a memory budget."""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.core.kernels import sketches as ref_sk
from daft_tpu_torch.core.kernels import sketches as port_sk

SEED = 7070


def _data(n=20_000, seed=SEED):
    rng = np.random.default_rng(seed)
    v = rng.lognormal(3, 1.5, n) * np.where(rng.random(n) < 0.2, -1, 1)
    v[rng.random(n) < 0.05] = 0.0
    return {"k": rng.integers(0, 7, n).tolist(),
            "i": [None if j % 31 == 0 else int(x)
                  for j, x in enumerate(rng.integers(0, 3000, n))],
            "s": [None if j % 29 == 0 else f"s{x}"
                  for j, x in enumerate(rng.integers(0, 900, n))],
            "v": [None if j % 17 == 0 else float(x) for j, x in enumerate(v)]}


def _run(q, data, **port_cfg):
    with ref_ctx(device_mode="off"):
        want = q(daft_tpu, daft_tpu.from_pydict(data)).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu", **port_cfg):
        got = q(daft_tpu_torch, daft_tpu_torch.from_pydict(data)).to_pydict()
    return got, want


def _same(got, want):
    assert got.keys() == want.keys()
    for c in got:
        for g, w in zip(got[c], want[c]):
            if isinstance(w, list):
                assert len(g) == len(w)
                for a, b in zip(g, w):
                    assert (a is None and b is None) or a == pytest.approx(b, rel=1e-12, abs=0)
            elif isinstance(w, float):
                assert g == pytest.approx(w, rel=1e-12, abs=0)
            else:
                assert g == w


@pytest.mark.parametrize("column", ["i", "s", "v"])
def test_approx_count_distinct_ungrouped_equals_reference(column):
    got, want = _run(lambda m, df: df.agg(m.col(column).approx_count_distinct().alias("n")),
                     _data())
    assert got == want


@pytest.mark.parametrize("column", ["i", "s"])
def test_approx_count_distinct_grouped_equals_reference(column):
    got, want = _run(lambda m, df: df.groupby("k").agg(
        m.col(column).approx_count_distinct().alias("n")).sort("k"), _data())
    assert got == want


@pytest.mark.parametrize("ps", [(0.5,), (0.01, 0.25, 0.5, 0.9, 0.99), (0.0, 1.0)])
@pytest.mark.parametrize("alpha", [0.01, 0.05])
def test_approx_percentile_ungrouped_equals_reference(ps, alpha):
    got, want = _run(lambda m, df: df.agg(
        m.col("v").approx_percentile(*ps, alpha=alpha).alias("p")), _data())
    _same(got, want)


@pytest.mark.parametrize("ps", [(0.5,), (0.1, 0.5, 0.9)])
def test_approx_percentile_grouped_equals_reference(ps):
    data = _data()
    data["v"] = [None if k == 6 else v for k, v in zip(data["k"], data["v"])]  # a null group
    got, want = _run(lambda m, df: df.groupby("k").agg(
        m.col("v").approx_percentile(*ps).alias("p"),
        m.col("i").approx_percentile(0.5).alias("q")).sort("k"), data)
    _same(got, want)


def test_sketches_over_many_morsels_and_device_mode_on():
    """Both aggregate in one phase over every row: many morsels and the
    device mode give the reference's answers."""
    q = (lambda m, df: df.groupby("k").agg(m.col("i").approx_count_distinct().alias("n"),
                                           m.col("v").approx_percentile(0.5, 0.9).alias("p"),
                                           m.col("v").sum().alias("t")).sort("k"))
    got, want = _run(q, _data(), morsel_size_rows=1000, device_mode="on")
    _same(got, want)
    got, want = _run(lambda m, df: df.agg(m.col("i").approx_count_distinct().alias("n"),
                                          m.col("v").approx_percentile(0.3).alias("p")),
                     _data(), morsel_size_rows=1000)
    _same(got, want)


def test_sketches_under_a_memory_budget(tmp_path):
    data = _data()
    q = (lambda m, df: df.agg(m.col("i").approx_count_distinct().alias("n"),
                              m.col("v").approx_percentile(0.5).alias("p")))
    got, want = _run(q, data, memory_limit_bytes=20_000, spill_dir=str(tmp_path),
                     morsel_size_rows=2000)
    _same(got, want)


def test_approx_count_distinct_in_sql_equals_reference():
    data = _data()
    sql = "SELECT k, APPROX_COUNT_DISTINCT(i) AS n FROM t GROUP BY k ORDER BY k"
    with ref_ctx(device_mode="off"):
        want = daft_tpu.sql(sql, t=daft_tpu.from_pydict(data)).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.sql(sql, t=daft_tpu_torch.from_pydict(data)).to_pydict()
        whole = daft_tpu_torch.sql("SELECT APPROX_COUNT_DISTINCT(s) AS n FROM t",
                                   t=daft_tpu_torch.from_pydict(data)).to_pydict()
    assert got == want
    with ref_ctx(device_mode="off"):
        assert whole == daft_tpu.sql("SELECT APPROX_COUNT_DISTINCT(s) AS n FROM t",
                                     t=daft_tpu.from_pydict(data)).to_pydict()


@pytest.mark.parametrize("n", [0, 10, 5000, 300_000])
def test_hll_registers_and_estimate_equal_reference(n):
    v = np.random.default_rng(n).integers(0, max(n // 2, 1), n)
    r = daft_tpu.Series.from_numpy(v)
    p = daft_tpu_torch.Series.from_numpy(v)
    assert np.array_equal(port_sk.hll_registers(p), ref_sk.hll_registers(r))
    assert port_sk.hll_count_distinct(p) == ref_sk.hll_count_distinct(r)


def test_empty_and_all_null_inputs_equal_reference():
    data = {"k": [1, 1, 2], "v": [None, None, 3.0], "i": [None, None, None]}
    got, want = _run(lambda m, df: df.groupby("k").agg(
        m.col("v").approx_percentile(0.5).alias("p"),
        m.col("v").approx_percentile(0.2, 0.8).alias("pp")).sort("k"), data)
    _same(got, want)
    got, want = _run(lambda m, df: df.where(m.col("k") > 5).agg(
        m.col("v").approx_percentile(0.5).alias("p"),
        m.col("v").approx_count_distinct().alias("n")), data)
    _same(got, want)
