"""The other aggregates (any_value, stddev, var, skew, bool_and, bool_or)
against the reference (daft_tpu/core/relational.py, plan/agg_split.py).

Grouped and ungrouped over the same seeded columns (nulls, an all-null
group, a one-row group, a zero-variance group): in one phase, in two
phases (morsels of 512 rows: the reference's agg_split.py:74-111
decomposition, sums of powers with ddof), under a host memory budget
(the Grace aggregation's partials, or the streamed ungrouped partials) and
with the device stage on: each equals the reference's host, floats within
rtol 1e-5. The budgeted runs spill and equal the unbudgeted ones. They are
host aggregates in both packages: a device stage never takes them.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch.ops import counters

RTOL = 1e-5


def _data(n=6000, seed=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 8, n)
    x = np.round(rng.normal(5, 3, n), 3)
    i = rng.integers(-100, 100, n)
    b = rng.integers(0, 2, n).astype(bool)
    xl = [None if r % 17 == 0 or kk == 6 else float(v)
          for r, (kk, v) in enumerate(zip(k.tolist(), x.tolist()))]
    bl = [None if r % 13 == 0 or kk == 6 else bool(v)
          for r, (kk, v) in enumerate(zip(k.tolist(), b.tolist()))]
    kl = k.tolist()
    kl[7] = 9            # a one-row group
    xl[7] = 2.5
    for r in range(20, 26):
        kl[r] = 11       # a zero-variance group
        xl[r] = 4.0
    return {"k": kl, "x": xl, "i": i.tolist(), "b": bl}


DATA = _data()


def _aggs(m):
    col = m.col
    return [col("x").stddev().alias("sd"), col("x").stddev(ddof=1).alias("sd1"),
            col("x").var().alias("v"), col("x").var(ddof=1).alias("v1"),
            col("x").skew().alias("sk"), col("i").stddev().alias("isd"),
            col("i").skew().alias("isk"), col("b").bool_and().alias("ba"),
            col("b").bool_or().alias("bo"), col("x").any_value().alias("av"),
            col("x").any_value(ignore_nulls=True).alias("avn"),
            col("i").any_value().alias("ai"), col("x").mean().alias("m"),
            col("i").count().alias("n")]


def _grouped(m):
    return m.from_pydict(DATA).groupby("k").agg(*_aggs(m)).sort("k")


def _ungrouped(m):
    return m.from_pydict(DATA).where(m.col("k") != 11).agg(*_aggs(m))


def _same(got, want):
    assert list(got) == list(want)
    for c in want:
        g, w = got[c], want[c]
        assert [v is None for v in g] == [v is None for v in w], c
        if any(isinstance(v, float) for v in w):
            np.testing.assert_allclose([np.nan if v is None else v for v in g],
                                       [np.nan if v is None else v for v in w],
                                       rtol=RTOL, atol=0.0, err_msg=c)
        else:
            assert g == w, c


CONFIGS = {
    "one_phase": {},
    "two_phase": {"morsel_size_rows": 512},
    "budget": {"morsel_size_rows": 512, "memory_limit_bytes": 20_000},
    "device_on": {"device_mode": "on"},
}


@pytest.mark.parametrize("shape", ["grouped", "ungrouped"])
@pytest.mark.parametrize("cfg", sorted(CONFIGS))
def test_new_aggregates_match_the_reference(shape, cfg, tmp_path):
    q = _grouped if shape == "grouped" else _ungrouped
    with ref_ctx(device_mode="off"):
        want = q(daft_tpu).to_pydict()
    settings = dict(CONFIGS[cfg])
    settings.setdefault("device_mode", "off")
    if "memory_limit_bytes" in settings:
        settings["spill_dir"] = str(tmp_path)
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", **settings):
        got = q(daft_tpu_torch).to_pydict()
    if cfg == "budget":
        assert counters.spill_files > 0 or shape == "ungrouped"
    assert counters.device_grouped_batches == counters.device_stage_batches == 0
    _same(got, want)


def test_budgeted_equals_unbudgeted(tmp_path):
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off",
                                             morsel_size_rows=512):
        free = _grouped(daft_tpu_torch).to_pydict()
        counters.reset()
        with daft_tpu_torch.execution_config_ctx(memory_limit_bytes=20_000,
                                                 spill_dir=str(tmp_path)):
            budgeted = _grouped(daft_tpu_torch).to_pydict()
    assert counters.spill_files > 0
    _same(budgeted, free)


def test_zero_variance_skew_is_null_grouped_and_zero_ungrouped_as_the_reference():
    data = {"k": [1, 1, 1, 2, 2], "x": [3.0, 3.0, 3.0, 1.0, 2.0]}
    for m, ctx in ((daft_tpu, ref_ctx(device_mode="off")),
                   (daft_tpu_torch, daft_tpu_torch.execution_config_ctx(device="cpu"))):
        with ctx:
            g = m.from_pydict(data).groupby("k").agg(m.col("x").skew().alias("s")) \
                .sort("k").to_pydict()
            u = m.from_pydict(data).where(m.col("k") == 1).agg(
                m.col("x").skew().alias("s")).to_pydict()
        assert g["s"][0] is None and g["s"][1] == 0.0
        assert u == {"s": [0.0]}


def test_aggregate_types():
    schema = daft_tpu_torch.from_pydict(DATA).schema
    fields = {e.name(): e.to_field(schema).dtype.kind for e in _aggs(daft_tpu_torch)}
    ref_schema = daft_tpu.from_pydict(DATA).schema
    want = {e.name(): e.to_field(ref_schema).dtype.kind for e in _aggs(daft_tpu)}
    assert fields == want


SQL = [
    "SELECT k, STDDEV(x) AS s, STDDEV_SAMP(x) AS s1, VAR(x) AS v, VARIANCE(i) AS vi, "
    "SKEW(x) AS sk, ANY_VALUE(i) AS a, BOOL_AND(b) AS ba, BOOL_OR(b) AS bo FROM t "
    "GROUP BY k ORDER BY k",
    "SELECT STDDEV(x) AS s, SKEW(i) AS sk, BOOL_OR(b) AS bo FROM t WHERE k < 5",
]


@pytest.mark.parametrize("i", range(len(SQL)))
def test_sql_aggregate_names(i):
    with ref_ctx(device_mode="off"):
        want = daft_tpu.sql(SQL[i], t=daft_tpu.from_pydict(DATA)).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.sql(SQL[i], t=daft_tpu_torch.from_pydict(DATA)).to_pydict()
    _same(got, want)
