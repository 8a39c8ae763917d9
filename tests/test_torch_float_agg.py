"""Float aggregation on the device, grouped and ungrouped, against the
reference. The same numpy-seeded columns go through the reference
(daft_tpu, JAX on the CPU: its XLA one-hot matmul tier ``_build`` up to 4096
groups, its sort tier ``_build_sorted`` past that) and through the port
(daft_tpu_torch, device="cpu": K1, K2, K3 and K7 by their plain versions),
and through both packages' host paths.

Tolerances: float sums and means at the reference's own device-vs-host
tolerance, rtol 1e-5 (tests/test_device_path.py), since the reference sums
f32 values in f32 chunks and the port widens them to f64 (F3 in ROADMAP.md);
keys, counts, integer sums and every min/max bit for bit.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.ops import grouped_stage as ref_gs
from daft_tpu.ops.stage import device_row_mask as ref_row_mask
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import grouped_stage as port_gs
from daft_tpu_torch.ops import segment_kernels as sk
from daft_tpu_torch.ops import stage as port_stage
from daft_tpu_torch.ops.stage import device_row_mask as port_row_mask
from daft_tpu_torch.plan import physical as pp

import jax.numpy as jnp

RTOL = 1e-5


def _carry(ref_df):
    """The reference table carried across column for column."""
    batch = ref_df.collect()._result[0].concat_or_empty()
    schema = daft_tpu_torch.Schema.from_pydict(
        {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_df.schema})
    return from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)


def _frames(tbl):
    ref = daft_tpu.from_arrow(tbl).collect()
    return ref, _carry(ref)


def _ref(query, df, device):
    with ref_ctx(device_mode="on" if device else "off", pallas_mode="on", mesh_devices=1):
        return query(daft_tpu, df).to_pydict()


def _port(query, df, device):
    with daft_tpu_torch.execution_config_ctx(device="cpu",
                                             device_mode="on" if device else "off"):
        return query(daft_tpu_torch, df).to_pydict()


def _same(got, want, floats=()):
    """Equal column for column: ``floats`` at RTOL (nulls in the same
    places), every other column exactly."""
    assert list(got) == list(want)
    for c in got:
        if c in floats:
            g, w = got[c], want[c]
            assert [v is None for v in g] == [v is None for v in w], c
            np.testing.assert_allclose([v for v in g if v is not None],
                                       [v for v in w if v is not None], rtol=RTOL, err_msg=c)
        else:
            assert got[c] == want[c], c


def _bits(values):
    """Float values as their f64 bit patterns (None kept), so -0.0 and NaN
    compare exactly."""
    return [None if v is None else int(np.float64(v).view(np.int64)) for v in values]


def _run_grouped(query, ref_df, port_df, floats, ref_device=True):
    """Port device against the reference (device or host) and the port's
    host path; the port's run stays on its grouped stage with no fallback."""
    want = _ref(query, ref_df, device=ref_device)
    manager().clear()
    counters.reset()
    got = _port(query, port_df, device=True)
    snap = counters.snapshot()
    assert snap["device_grouped_batches"] >= 1 and snap["device_fallbacks"] == 0, \
        (snap, counters.rejections)
    assert all(snap[f"launches_{k}"] == 0 for k in counters.KERNEL_NAMES)
    _same(got, want, floats)
    _same(_port(query, port_df, device=False), got, floats)
    return got, snap


# ---- TPC-H q1's shape -------------------------------------------------------------


def _q1_table(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({
        "l_returnflag": rng.choice(["A", "N", "R"], n),
        "l_linestatus": rng.choice(["O", "F"], n),
        "l_quantity": rng.integers(1, 51, n).astype(np.float64),
        "l_extendedprice": np.round(rng.uniform(900, 105000, n), 2),
        "l_discount": np.round(rng.uniform(0, 0.1, n), 2),
        "l_tax": np.round(rng.uniform(0, 0.08, n), 2),
        "l_shipdate_days": rng.integers(8000, 10000, n).astype(np.int64),
    })


def q1(m, df, extremes=False):
    """TPC-H q1 as tests/test_device_path.py writes it (ship dates as day
    numbers); ``extremes`` adds l_extendedprice's min and max."""
    col = m.col
    disc_price = col("l_extendedprice") * (1 - col("l_discount"))
    charge = disc_price * (1 + col("l_tax"))
    aggs = [col("l_quantity").sum().alias("sum_qty"),
            col("l_extendedprice").sum().alias("sum_base_price"),
            disc_price.sum().alias("sum_disc_price"),
            charge.sum().alias("sum_charge"),
            col("l_quantity").mean().alias("avg_qty"),
            col("l_extendedprice").mean().alias("avg_price"),
            col("l_discount").mean().alias("avg_disc"),
            col("l_quantity").count().alias("count_order")]
    if extremes:
        aggs += [col("l_extendedprice").min().alias("min_price"),
                 col("l_extendedprice").max().alias("max_price")]
    return (df.where(col("l_shipdate_days") <= 9190)
            .groupby("l_returnflag", "l_linestatus").agg(*aggs)
            .sort(["l_returnflag", "l_linestatus"]))


Q1_FLOATS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
             "avg_price", "avg_disc")


def test_q1_shape_matches_reference_device_and_host():
    ref_df, port_df = _frames(_q1_table(20_000, seed=2))
    got, snap = _run_grouped(q1, ref_df, port_df, Q1_FLOATS)
    assert len(got["l_returnflag"]) == 6
    # seven float sum planes, one K7 call; K1 for rows and counts; K2 for
    # the first-row index; no K3 in an f32 stage without extremes
    assert snap["plain_segment_sum_float_planes"] == 1
    assert snap["plain_segment_sum_planes"] == 1 and snap["plain_segment_extreme_planes"] == 1
    assert snap["plain_segment_extreme_int64"] == 0
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        plan = pp.translate(q1(daft_tpu_torch, port_df)._plan)
    assert any(isinstance(n, pp.DeviceGroupedAgg) for n in plan.walk())
    _same(got, _ref(q1, ref_df, device=False), Q1_FLOATS)


def test_q1_with_float_extremes_is_an_f64_stage_exact_against_reference():
    ref_df, port_df = _frames(_q1_table(6_000, seed=3))

    def query(m, df):
        return q1(m, df, extremes=True)

    got, snap = _run_grouped(query, ref_df, port_df, Q1_FLOATS)
    # K3 on the f64 key, and K3 again for each extreme's first zero row
    assert snap["plain_segment_extreme_int64"] == 4
    host = _ref(query, ref_df, device=False)
    assert _bits(got["min_price"]) == _bits(host["min_price"])
    assert _bits(got["max_price"]) == _bits(host["max_price"])


# ---- float and bool sums, nulls, predicates ------------------------------------------


def _mixed_table(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({
        "k": pa.array(rng.integers(0, 30, n), pa.int64(), mask=rng.random(n) < 0.05),
        "s": pa.array(rng.choice(["red", "green", "blue"], n), mask=rng.random(n) < 0.05),
        "x": pa.array(rng.standard_normal(n) * 1e3, mask=rng.random(n) < 0.1),
        "y": pa.array(rng.uniform(0, 1, n).astype(np.float32), pa.float32(),
                      mask=rng.random(n) < 0.1),
        "a": pa.array(rng.integers(-1000, 1000, n).astype(np.int32), pa.int32(),
                      mask=rng.random(n) < 0.1),
        "f": pa.array(rng.random(n) < 0.3, pa.bool_(), mask=rng.random(n) < 0.1),
    })


def test_float_sums_with_nulls_and_a_predicate_match_reference():
    def query(m, df):
        col = m.col
        return (df.where((col("a") > -800) & col("x").not_null())
                .groupby("k")
                .agg(col("x").sum().alias("sx"), col("y").sum().alias("sy"),
                     (col("x") * col("y")).sum().alias("sxy"), col("x").mean().alias("mx"),
                     col("a").sum().alias("sa"), col("y").count().alias("ny"),
                     col("d").sum().alias("sd"))
                .sort("k"))

    tbl = _mixed_table(5000, seed=4)
    tbl = tbl.append_column("d", pa.array(np.arange(5000) % 7 * 0.25))
    ref_df, port_df = _frames(tbl)
    got, snap = _run_grouped(query, ref_df, port_df, ("sx", "sy", "sxy", "mx", "sd"))
    assert got["k"][-1] is None  # the null key is a group, sorted last
    assert snap["plain_segment_sum_float_planes"] == 1
    # the integer sum stays on K1's exact digit planes
    assert all(isinstance(v, int) for v in got["sa"])


def test_bool_sums_match_reference():
    def query(m, df):
        col = m.col
        return (df.groupby("s")
                .agg(col("f").sum().alias("nf"), (col("a") > 0).sum().alias("npos"),
                     col("f").count().alias("cf"))
                .sort("s"))

    ref_df, port_df = _frames(_mixed_table(4000, seed=5))
    got, snap = _run_grouped(query, ref_df, port_df, ())
    assert snap["plain_segment_sum_float_planes"] == 1
    assert all(isinstance(v, int) for v in got["nf"] + got["npos"])


def test_f64_stage_extremes_bit_exact_with_signed_zeros_and_nan():
    # every group holds zeros of both signs in some order, NaN rows, or NaN
    # alone: the port's device and host paths must give the reference host's
    # bits (NaN skipped, a group of NaN alone keeps +-inf, the first zero's
    # sign)
    n = 3000
    rng = np.random.default_rng(6)
    x = rng.choice([0.0, -0.0, 1.5, -2.25, np.nan, 7.0], n)
    k = rng.integers(0, 40, n)
    x[k == 39] = np.nan
    x[:8] = [0.0, -0.0, -0.0, 0.0, np.nan, np.nan, -0.0, 0.0]
    k[:8] = [41, 41, 42, 42, 43, 43, 44, 44]
    tbl = pa.table({"k": pa.array(k, pa.int64()),
                    "x": pa.array(x, mask=rng.random(n) < 0.05),
                    "z": pa.array(np.where(rng.random(n) < 0.5, 0.0, -0.0))})

    def query(m, df):
        col = m.col
        return (df.groupby("k")
                .agg(col("x").min().alias("lo"), col("x").max().alias("hi"),
                     col("z").min().alias("zlo"), col("z").max().alias("zhi"),
                     col("x").sum().alias("sx"), col("x").count().alias("n"))
                .sort("k"))

    ref_df, port_df = _frames(tbl)
    want = _ref(query, ref_df, device=False)
    manager().clear()
    counters.reset()
    got = _port(query, port_df, device=True)
    snap = counters.snapshot()
    assert snap["device_grouped_batches"] == 1 and snap["device_fallbacks"] == 0
    host = _port(query, port_df, device=False)
    for c in ("lo", "hi", "zlo", "zhi"):
        assert _bits(got[c]) == _bits(want[c]), c
        assert _bits(host[c]) == _bits(want[c]), c
    assert got["k"] == want["k"] and got["n"] == want["n"]
    np.testing.assert_array_equal(np.array(got["sx"], dtype=float),
                                  np.array(want["sx"], dtype=float))  # NaN in place
    for only_nan in (39, 43):
        j = got["k"].index(only_nan)
        assert got["lo"][j] == np.inf and got["hi"][j] == -np.inf
    j = got["k"].index(42)  # -0.0 then 0.0
    assert np.signbit(got["lo"][j]) and np.signbit(got["hi"][j])


def test_f64_stage_over_several_batches_keeps_the_first_zero():
    # two partitions: the first holds +0.0 for the group, the second -0.0;
    # the merge keeps the earlier batch's zero, as the host's row-order pass
    parts = [{"k": [1, 1, 2], "x": [0.0, 3.0, -1.0]}, {"k": [1, 2, 2], "x": [-0.0, -0.0, 0.0]}]

    def query(m, df):
        col = m.col
        return (df.groupby("k").agg(col("x").min().alias("lo"), col("x").max().alias("hi"))
                .sort("k"))

    ref_df = daft_tpu.from_pydict(parts[0]).concat(daft_tpu.from_pydict(parts[1]))
    with ref_ctx(device_mode="off"):
        want = query(daft_tpu, ref_df).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        port_df = daft_tpu_torch.DataFrame(daft_tpu_torch.plan.logical.InMemorySource(
            daft_tpu_torch.from_pydict(parts[0]).schema,
            [daft_tpu_torch.from_pydict(p).collect()._result[0] for p in parts]))
    counters.reset()
    # coalescing off: each partition is its own batch, merged at finalize
    with daft_tpu_torch.execution_config_ctx(batch_fill_target=0):
        got = _port(query, port_df, device=True)
    assert counters.snapshot()["device_grouped_batches"] == 2
    assert _bits(got["lo"]) == _bits(want["lo"]) and _bits(got["hi"]) == _bits(want["hi"])
    assert _bits(_port(query, port_df, device=False)["lo"]) == _bits(want["lo"])


# ---- many groups -------------------------------------------------------------------


def test_20000_groups_match_reference_sort_tier():
    rng = np.random.default_rng(7)
    n, groups = 60_000, 20_000
    tbl = pa.table({"k": rng.integers(0, groups, n), "v": rng.uniform(0, 100, n),
                    "q": rng.integers(0, 1000, n)})

    def query(m, df):
        col = m.col
        return (df.groupby("k")
                .agg(col("v").sum().alias("sv"), col("q").sum().alias("sq"),
                     col("q").max().alias("mq"), col("v").count().alias("cv"))
                .sort("k"))

    ref_df, port_df = _frames(tbl)
    got, snap = _run_grouped(query, ref_df, port_df, ("sv",))
    assert len(got["k"]) > 4096 * 4
    assert snap["plain_segment_sum_float_planes"] == 1


def test_150000_groups_run_on_the_device_past_the_old_ceiling():
    # past 2^17 groups: cap 2^18, no DeviceFallback
    rng = np.random.default_rng(8)
    groups = 150_000
    k = np.concatenate([rng.permutation(groups), rng.integers(0, groups, 30_000)])
    n = len(k)
    tbl = pa.table({"k": k, "v": np.round(rng.uniform(0, 100, n), 2),
                    "q": rng.integers(-50, 50, n).astype(np.int32)})

    def query(m, df):
        col = m.col
        return (df.groupby("k")
                .agg(col("v").sum().alias("sv"), col("v").max().alias("mv"),
                     col("q").min().alias("mq"), col("q").count().alias("n"))
                .sort("k"))

    ref_df, port_df = _frames(tbl)
    got, snap = _run_grouped(query, ref_df, port_df, ("sv",), ref_device=False)
    assert len(got["k"]) == groups
    assert _bits(got["mv"]) == _bits(_ref(query, ref_df, device=False)["mv"])


# ---- K7's plain version against the reference's XLA tiers --------------------------


@pytest.mark.parametrize("cap,tier", [(64, "_build"), (8192, "_build_sorted")])
def test_k7_tables_match_reference_build_tiers(cap, tier):
    n, bucket, offset = 3000, 4096, 777
    rng = np.random.default_rng(cap)
    tbl = pa.table({"k": rng.integers(0, 50, n),
                    "x": pa.array(rng.standard_normal(n) * 100, mask=rng.random(n) < 0.1),
                    "y": rng.uniform(0, 5, n), "f": rng.random(n) < 0.5,
                    "a": rng.integers(-9, 9, n).astype(np.int32)})
    ref_df, port_df = _frames(tbl)

    def exprs(m):
        col = m.col
        return (col("a") > -5, [col("k")],
                [col("x").sum().alias("sx"), (col("x") * col("y")).sum().alias("sxy"),
                 col("f").sum().alias("sf"), col("y").mean().alias("my"),
                 col("a").count().alias("c")])

    pred, keys, aggs = exprs(daft_tpu)
    ref = ref_gs.try_build_grouped_agg_stage(ref_df.schema, pred, keys, aggs)
    pred, keys, aggs = exprs(daft_tpu_torch)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        port = port_gs.try_build_grouped_agg_stage(port_df.schema, pred, keys, aggs)
    assert port._mm_specs == ref._mm_specs
    k1, k7 = port.sum_routes()
    assert [port._mm_specs[j][1] for j in k7] == ["sum"] * 4
    codes = np.full(bucket, cap, dtype=np.int32)
    codes[:n] = rng.integers(0, min(cap, 3000), n)
    ref_batch = ref_df._result[0].concat_or_empty()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        port_batch = port_df.collect()._result[0].concat_or_empty()
    ref_cols = {c: ref_batch.get_column(c).to_device(bucket, f32=True)
                for c in ref._input_cols}
    port_cols = {c: port_batch.get_column(c).to_device(bucket, f32=True, device="cpu")
                 for c in port._input_cols}
    want = getattr(ref, tier)(cap)(ref_cols, jnp.asarray(codes), ref_row_mask(n, bucket),
                                   jnp.asarray(float(offset)))
    before = counters.snapshot()["plain_segment_sum_float_planes"]
    got = port._build_kernel(cap)(port_cols, torch.from_numpy(codes),
                                  port_row_mask(n, bucket, "cpu"), offset)
    assert counters.snapshot()["plain_segment_sum_float_planes"] == before + 1
    mm_got, mm_want = got["mm"].numpy(), np.asarray(want["mm"])
    np.testing.assert_array_equal(mm_got[:, k1], mm_want[:, k1])
    np.testing.assert_allclose(mm_got[:, k7], mm_want[:, k7], rtol=RTOL, atol=1e-9)
    present = mm_want[:, 0] > 0
    np.testing.assert_array_equal(got["ext"][0].numpy()[present],
                                  np.asarray(want["ext"][0])[present])


def test_k7_plain_is_an_f64_index_add():
    rng = np.random.default_rng(10)
    n, cap = 5000, 300
    codes = rng.integers(-3, cap + 3, n).astype(np.int32)
    for dtype in (np.float32, np.float64):
        planes = [rng.standard_normal(n).astype(dtype) for _ in range(3)]
        got = sk.segment_sum_float_planes([torch.from_numpy(p) for p in planes],
                                          torch.from_numpy(codes), cap)
        assert got.dtype == torch.float64 and tuple(got.shape) == (cap, 3)
        want = np.zeros((cap, 3))
        inside = (codes >= 0) & (codes < cap)
        for j, p in enumerate(planes):
            np.add.at(want[:, j], codes[inside], p[inside].astype(np.float64))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    with pytest.raises(TypeError):
        sk.segment_sum_float_planes([torch.zeros(4, dtype=torch.int32)],
                                    torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(TypeError):   # one dtype for every plane
        sk.segment_sum_float_planes([torch.zeros(4), torch.zeros(4, dtype=torch.float64)],
                                    torch.zeros(4, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        sk.segment_sum_float_planes([torch.zeros(32)[::2]], torch.zeros(16, dtype=torch.int32),
                                    2)


# ---- ungrouped aggregation ----------------------------------------------------------


def _q6_table(n, seed):
    rng = np.random.default_rng(seed)
    return pa.table({"l_quantity": rng.uniform(1, 50, n),
                     "l_extendedprice": rng.uniform(100, 10000, n),
                     "l_discount": rng.uniform(0.0, 0.1, n)})


def q6(m, df):
    """q6 as tests/test_device_path.py writes it."""
    col = m.col
    return (df.where((col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
                     & (col("l_quantity") < 24.0))
            .agg((col("l_extendedprice") * col("l_discount")).sum().alias("revenue")))


def test_q6_runs_on_the_device_and_matches_reference():
    ref_df, port_df = _frames(_q6_table(10_000, seed=0))
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        plan = pp.translate(q6(daft_tpu_torch, port_df)._plan)
    assert any(isinstance(n, pp.DeviceFilterAgg) for n in plan.walk())
    counters.reset()
    got = _port(q6, port_df, device=True)
    snap = counters.snapshot()
    assert snap["device_stage_batches"] == 1 and snap["device_stage_runs"] == 1
    for want in (_ref(q6, ref_df, device=True), _ref(q6, ref_df, device=False),
                 _port(q6, port_df, device=False)):
        _same(got, want, ("revenue",))
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        plan = pp.translate(q6(daft_tpu_torch, port_df)._plan)
    assert not any(isinstance(n, pp.DeviceFilterAgg) for n in plan.walk())


@pytest.mark.parametrize("device", [True, False])
def test_ungrouped_count_modes_match_reference(device):
    tbl = pa.table({"v": pa.array([1.0, None, 3.0, None, 5.0]),
                    "i": pa.array([4, 5, None, -7, 9], pa.int64()),
                    "b": pa.array([True, None, False, True, True])})

    def query(m, df):
        col, lit = m.col, m.lit
        return df.agg(col("v").count().alias("c_valid"), col("v").sum().alias("s"),
                      col("v").mean().alias("m"), col("v").min().alias("lo"),
                      col("v").max().alias("hi"), col("i").sum().alias("si"),
                      col("i").min().alias("mi"), col("b").sum().alias("sb"),
                      col("b").max().alias("mb"), lit(1).count("all").alias("rows"))

    ref_df, port_df = _frames(tbl)
    want = _ref(query, ref_df, device=False)
    counters.reset()
    got = _port(query, port_df, device=device)
    assert (counters.snapshot()["device_stage_batches"] == 1) == device
    assert got == want
    assert got == _ref(query, ref_df, device=True)


def test_ungrouped_frame_methods_match_reference():
    ref_df, port_df = _frames(_mixed_table(2000, seed=11))
    for method, cols in (("sum", ("x", "a", "f")), ("mean", ("x", "y")),
                         ("min", ("x", "a")), ("max", ("y", "f")), ("count", ())):
        want = _ref(lambda m, df: getattr(df, method)(*cols), ref_df, device=False)
        for device in (True, False):
            got = _port(lambda m, df: getattr(df, method)(*cols), port_df, device=device)
            _same(got, want, [c for c in got if isinstance(want[c][0], float)])


def test_ungrouped_float_extremes_follow_the_reference_host():
    tbl = pa.table({"x": [0.0, -0.0, np.nan, 2.5, -0.0], "y": [np.nan, np.nan, 1.0, 1.0, 1.0]})

    def query(m, df):
        col = m.col
        return df.agg(col("x").min().alias("lo"), col("x").max().alias("hi"),
                      col("y").max().alias("yhi"))

    ref_df, port_df = _frames(tbl)
    want = _ref(query, ref_df, device=False)
    for device in (True, False):
        got = _port(query, port_df, device=device)
        for c in want:
            assert _bits(got[c]) == _bits(want[c]), (device, c)
    only_nan = pa.table({"x": [np.nan, np.nan]})
    ref_df, port_df = _frames(only_nan)

    def lo(m, df):
        return df.agg(m.col("x").min().alias("lo"))

    want = _ref(lo, ref_df, device=False)
    assert np.isnan(want["lo"][0])
    for device in (True, False):
        assert np.isnan(_port(lo, port_df, device=device)["lo"][0])


def test_abandoned_ungrouped_run_does_not_corrupt_the_next():
    df = daft_tpu_torch.from_pydict({"v": [1.0, 2.0, 3.0]})

    def query(d):
        return d.agg(daft_tpu_torch.col("v").sum().alias("s"))

    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        plan = pp.translate(query(df)._plan)
        node = next(n for n in plan.walk() if isinstance(n, pp.DeviceFilterAgg))
        stage = port_stage.try_build_filter_agg_stage(node.input.schema, node.predicate,
                                                      node.aggregations)
        run = stage.start_run(torch.device("cpu"))
        for part in node.input.partitions:
            for b in part.batches:
                run.feed_batch(b)
        # no finalize: the run is abandoned
        assert query(df).to_pydict() == {"s": [6.0]}
        assert stage.start_run(torch.device("cpu")).finalize() == {"s": None}


def test_ungrouped_agg_over_nothing():
    df = daft_tpu_torch.from_pydict({"v": [1.0, 2.0]})
    col = daft_tpu_torch.col
    for mode in ("on", "off"):
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode=mode):
            out = df.where(col("v") > 5.0).agg(col("v").sum().alias("s"),
                                               col("v").count().alias("c"),
                                               col("v").min().alias("lo")).to_pydict()
        assert out == {"s": [None], "c": [0], "lo": [None]}
