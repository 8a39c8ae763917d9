"""The grouped-aggregation slice end to end: the same seeded table goes
through the reference (daft_tpu, device_mode="on", pallas_mode="on": its
Pallas kernels in interpret mode on JAX CPU) and through the port
(daft_tpu_torch, device="cpu", device_mode="on": its kernel tier with the
plain kernel versions), and the two ``to_pydict`` results must be equal. The
port's host path (device_mode="off") must give the same answer.

On the CPU the port's wrappers count ``plain_<kernel>`` calls; launches are
counted only for CUDA tensors, so they stay 0 here.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.ops import counters as ref_counters
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import grouped_stage as port_gs
from daft_tpu_torch.plan import physical as pp

CUTOFF = datetime.date(1998, 9, 2)
KERNELS = counters.SEGMENT_KERNELS


def _port_df(ref_df):
    """The reference table carried across column for column."""
    batch = ref_df.collect()._result[0].concat_or_empty()
    schema = daft_tpu_torch.Schema.from_pydict(
        {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_df.schema})
    return from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)


def _ref_run(query, df, device: bool):
    with ref_ctx(device_mode="on" if device else "off", pallas_mode="on",
                 mesh_devices=1):
        return query(daft_tpu, df).to_pydict()


def _port_run(query, df, device: bool):
    with daft_tpu_torch.execution_config_ctx(device="cpu",
                                             device_mode="on" if device else "off"):
        return query(daft_tpu_torch, df).to_pydict()


def _check_slice(query, tbl):
    """Reference device == port device == port host; the port ran its kernel
    tier with no fallback, and the reference ran its Pallas tier."""
    ref_df = daft_tpu.from_arrow(tbl)
    port_df = _port_df(ref_df)
    ref_counters.reset()
    want = _ref_run(query, ref_df, device=True)
    assert ref_counters.snapshot().get("pallas_dispatches", 0) > 0
    counters.reset()
    got = _port_run(query, port_df, device=True)
    snap = counters.snapshot()
    assert snap["device_grouped_batches"] >= 1 and snap["device_fallbacks"] == 0
    assert all(snap[f"plain_{k}"] > 0 for k in KERNELS), snap
    assert all(snap[f"launches_{k}"] == 0 for k in KERNELS), snap
    assert got == want
    assert _port_run(query, port_df, device=False) == want
    return got


def _lineitem(n, n_supp, seed):
    rng = np.random.default_rng(seed)
    n_ord = max(n // 4, 1)
    lines = rng.integers(1, 8, n_ord)
    orderkey = np.repeat(np.arange(1, n_ord + 1), lines)[:n]
    n = len(orderkey)
    starts = np.cumsum(lines) - lines
    linenumber = (np.arange(len(np.repeat(starts, lines)))
                  - np.repeat(starts, lines) + 1)[:n]
    return pa.table({
        "l_orderkey": pa.array(orderkey, pa.int64()),
        "l_suppkey": pa.array(rng.integers(1, n_supp + 1, n), pa.int64()),
        "l_linenumber": pa.array(linenumber.astype(np.int32), pa.int32()),
        "l_shipdate": pa.array((8036 + rng.integers(0, 2500, n)).astype(np.int32),
                               pa.date32()),
    })


def supplier_query(m, df):
    col, lit = m.col, m.lit
    return (df.where(col("l_shipdate") <= lit(CUTOFF))
            .groupby("l_suppkey")
            .agg(col("l_orderkey").count().alias("n_lines"),
                 col("l_linenumber").sum().alias("sum_linenumber"),
                 col("l_shipdate").min().alias("first_ship"),
                 col("l_shipdate").max().alias("last_ship"),
                 col("l_orderkey").min().alias("first_order"),
                 col("l_orderkey").max().alias("last_order"))
            .sort("l_suppkey"))


def test_supplier_query_matches_reference():
    # ~5200 suppliers in 6000 rows: cap 8192, past the reference's one-hot
    # matmul ceiling of 4096, so both engines take their kernel tiers
    got = _check_slice(supplier_query, _lineitem(6000, 20000, seed=1))
    assert 4096 < len(got["l_suppkey"]) <= 8192
    assert isinstance(got["first_ship"][0], datetime.date)


def _nullable_table(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 40, n), pa.int64(), mask=rng.random(n) < 0.05),
        "s": pa.array(rng.choice(["red", "green", "blue", "gold"], n),
                      mask=rng.random(n) < 0.05),
        "a": pa.array(rng.integers(-1000, 1000, n).astype(np.int32), pa.int32(),
                      mask=rng.random(n) < 0.1),
        "big": pa.array(rng.integers(-(2**55), 2**55, n, dtype=np.int64)
                        + np.int64(2**53 + 1), pa.int64(), mask=rng.random(n) < 0.1),
        "d": pa.array((8036 + rng.integers(0, 2500, n)).astype(np.int32), pa.date32(),
                      mask=rng.random(n) < 0.1),
        "x": pa.array(rng.standard_normal(n) * 1e3),
    })


def test_null_keys_and_values_match_reference():
    def query(m, df):
        col, lit = m.col, m.lit
        return (df.where((col("a") > -900) | col("a").is_null())
                .groupby("k")
                .agg(col("a").sum().alias("sum_a"), col("a").count().alias("n_a"),
                     col("a").mean().alias("mean_a"), col("a").min().alias("min_a"),
                     col("d").max().alias("max_d"), col("big").min().alias("min_big"),
                     lit(1).count("all").alias("rows"))
                .sort("k"))

    got = _check_slice(query, _nullable_table(3000, seed=2))
    assert got["k"][-1] is None            # the null key is a group, sorted last
    assert any(v < 0 for v in got["sum_a"] if v is not None)


def test_string_int_multi_key_matches_reference():
    def query(m, df):
        col = m.col
        return (df.where(col("d") <= m.lit(CUTOFF))
                .groupby("s", "k")
                .agg(col("big").max().alias("max_big"), col("big").sum().alias("sum_big"),
                     col("a").mean().alias("mean_a"), col("d").min().alias("min_d"))
                .sort(["s", "k"]))

    got = _check_slice(query, _nullable_table(2500, seed=3))
    assert {v for v in got["s"] if v is not None} <= {"red", "green", "blue", "gold"}
    # int64 values past 2^53 come back exact
    assert any(v is not None and abs(v) > 2**53 for v in got["max_big"])


def test_projection_under_the_aggregate_matches_reference():
    def query(m, df):
        col, lit = m.col, m.lit
        return (df.select(col("k"), (col("a") * 2 - 1).alias("a2"),
                          (col("a") > 0).if_else(col("big"), lit(0)).alias("pos_big"),
                          col("d"))
                .where(col("d") <= lit(CUTOFF))
                .groupby("k")
                .agg(col("a2").sum().alias("s"), col("pos_big").max().alias("m"),
                     col("a2").count().alias("n"))
                .sort("k"))

    got = _check_slice(query, _nullable_table(2000, seed=7))
    assert len(got["k"]) > 30


def test_float_sum_plans_to_host_and_matches_reference_host():
    # a float sum runs on the device (K7) by default; under kernel_mode="off"
    # the port has no device tier for it, so it plans to the host
    def query(m, df):
        col = m.col
        return df.groupby("k").agg(col("x").sum().alias("sx"),
                                   col("a").count().alias("n")).sort("k")

    ref_df = daft_tpu.from_arrow(_nullable_table(3000, seed=4))
    port_df = _port_df(ref_df)
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on"):
        assert any(isinstance(n, pp.DeviceGroupedAgg)
                   for n in pp.translate(query(daft_tpu_torch, port_df)._plan).walk())
        with daft_tpu_torch.execution_config_ctx(kernel_mode="off"):
            plan = pp.translate(query(daft_tpu_torch, port_df)._plan)
            assert not any(isinstance(n, pp.DeviceGroupedAgg) for n in plan.walk())
            assert counters.rejections
            got = query(daft_tpu_torch, port_df).to_pydict()
    assert counters.snapshot()["device_grouped_batches"] == 0
    want = _ref_run(query, ref_df, device=False)
    assert got["k"] == want["k"] and got["n"] == want["n"]
    np.testing.assert_allclose(np.array(got["sx"], dtype=float),
                               np.array(want["sx"], dtype=float), rtol=1e-12)


def test_group_count_past_kernel_ceiling_reruns_on_host(monkeypatch):
    # a ceiling of 64 segments stands in for 2^20: ~100 groups exceed it
    monkeypatch.setattr(port_gs, "MAX_SORT_SEGMENTS", 64)
    tbl = _lineitem(1200, 100, seed=5)
    ref_df = daft_tpu.from_arrow(tbl)
    port_df = _port_df(ref_df)
    counters.reset()
    got = _port_run(supplier_query, port_df, device=True)
    snap = counters.snapshot()
    assert snap["device_fallbacks"] == 1
    assert all(snap[f"plain_{k}"] == 0 for k in KERNELS)
    assert got == _ref_run(supplier_query, ref_df, device=False)


def test_host_path_morsels_match_one_phase():
    tbl = _nullable_table(3000, seed=6)
    port_df = _port_df(daft_tpu.from_arrow(tbl))

    def query(m, df):
        col = m.col
        return (df.groupby("s").agg(col("a").sum().alias("sa"), col("a").mean().alias("ma"),
                                    col("d").min().alias("md"), col("a").count().alias("n"))
                .sort("s"))

    with daft_tpu_torch.execution_config_ctx(device_mode="off"):
        one = query(daft_tpu_torch, port_df).to_pydict()
        with daft_tpu_torch.execution_config_ctx(morsel_size_rows=256):
            two = query(daft_tpu_torch, port_df).to_pydict()
    assert one["s"] == two["s"] and one["sa"] == two["sa"]
    assert one["md"] == two["md"] and one["n"] == two["n"]
    np.testing.assert_allclose(np.array(one["ma"], dtype=float),
                               np.array(two["ma"], dtype=float), rtol=1e-12)


@pytest.mark.parametrize("device_mode", ["on", "off"])
def test_port_matches_on_fresh_python_values(device_mode):
    # from_pydict with Python lists and dates, no reference involved
    data = {"g": ["a", "b", "a", None, "b", "a"],
            "v": [1, -2, 3, 4, None, 6],
            "d": [datetime.date(2020, 1, i + 1) for i in range(6)]}
    df = daft_tpu_torch.from_pydict(data)
    col = daft_tpu_torch.col
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode=device_mode):
        out = (df.where(col("d") > daft_tpu_torch.lit(datetime.date(2020, 1, 1)))
               .groupby("g").agg(col("v").sum().alias("s"), col("d").max().alias("last"))
               .sort("g").to_pydict())
    assert out == {"g": ["a", "b", None], "s": [9, -2, 4],
                   "last": [datetime.date(2020, 1, 6), datetime.date(2020, 1, 5),
                            datetime.date(2020, 1, 4)]}
