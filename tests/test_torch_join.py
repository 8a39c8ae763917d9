"""The star join -> grouped aggregate slice end to end. The same seeded tables
go through the reference (daft_tpu, device_mode="on", pallas_mode="on": its
hash-probe and segment kernels in Pallas interpret mode on JAX CPU) and
through the port (daft_tpu_torch, device="cpu", device_mode="on": its join
stage with the plain kernel versions), and the ``to_pydict`` results must be
equal, and equal to the port's host path (device_mode="off"). Integers,
counts and dates compare bit for bit.

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
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import device_join as dj
from daft_tpu_torch.ops import probe_kernels as pk
from daft_tpu_torch.plan import physical as pp

JOIN_KERNELS = ("hash_probe_build", "hash_probe_index", "segment_sum_planes",
                "segment_extreme_planes")


def _carry(ref_df):
    """The reference table carried across column for column."""
    batch = ref_df.collect()._result[0].concat_or_empty()
    schema = daft_tpu_torch.Schema.from_pydict(
        {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_df.schema})
    return from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)


def _tables(arrow_tables):
    ref = {k: daft_tpu.from_arrow(t).collect() for k, t in arrow_tables.items()}
    return ref, {k: _carry(v) for k, v in ref.items()}


def _ref_run(query, tables, pallas=True):
    with ref_ctx(device_mode="on", pallas_mode="on" if pallas else "off", mesh_devices=1):
        return query(daft_tpu, tables).to_pydict()


def _port_run(query, tables, device=True):
    with daft_tpu_torch.execution_config_ctx(device="cpu",
                                             device_mode="on" if device else "off"):
        return query(daft_tpu_torch, tables).to_pydict()


def _check(query, ref_tables, port_tables, pallas=True):
    """Reference device == port device == port host; the port ran the join
    stage through its kernels (plain versions) with no fallback, on a cold
    residency cache."""
    ref_counters.reset()
    want = _ref_run(query, ref_tables, pallas)
    assert ref_counters.snapshot().get("device_join_batches", 0) > 0
    manager().clear()
    counters.reset()
    got = _port_run(query, port_tables)
    snap = counters.snapshot()
    assert snap["device_join_batches"] >= 1 and snap["device_fallbacks"] == 0, \
        (snap, counters.rejections)
    assert all(snap[f"plain_{k}"] > 0 for k in JOIN_KERNELS), snap
    assert all(snap[f"launches_{k}"] == 0 for k in counters.KERNEL_NAMES), snap
    assert got == want
    assert _port_run(query, port_tables, device=False) == want
    return got


# ---- TPC-H q12 -------------------------------------------------------------------------


def q12(dt, t):
    col, lit = dt.col, dt.lit
    high = col("o_orderpriority").is_in(["1-URGENT", "2-HIGH"])
    return (t["lineitem"].where(
                col("l_shipmode").is_in(["MAIL", "SHIP"])
                & (col("l_commitdate") < col("l_receiptdate"))
                & (col("l_shipdate") < col("l_commitdate"))
                & (col("l_receiptdate") >= lit(datetime.date(1994, 1, 1)))
                & (col("l_receiptdate") < lit(datetime.date(1995, 1, 1))))
            .join(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
            .with_column("high_line", high.if_else(lit(1), lit(0)))
            .with_column("low_line", (~high).if_else(lit(1), lit(0)))
            .groupby("l_shipmode")
            .agg(col("high_line").sum().alias("high_line_count"),
                 col("low_line").sum().alias("low_line_count"))
            .sort("l_shipmode"))


@pytest.fixture(scope="module")
def tpch():
    from benchmarking.tpch.datagen import generate

    t = generate(0.01, 0)
    return _tables({"orders": t["orders"], "lineitem": t["lineitem"]})


def test_tpch_q12_matches_reference(tpch):
    from benchmarking.tpch.queries import q12 as ref_q12

    ref_tables, port_tables = tpch
    got = _check(q12, ref_tables, port_tables)
    assert got == ref_q12(ref_tables).to_pydict()
    assert got["l_shipmode"] == ["MAIL", "SHIP"]
    assert all(isinstance(v, int) for v in got["high_line_count"] + got["low_line_count"])


def test_tpch_q12_plans_one_device_join_stage(tpch):
    _ref, port_tables = tpch
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        plan = pp.translate(q12(daft_tpu_torch, port_tables).optimized_plan())
        nodes = [type(n).__name__ for n in plan.walk()]
        assert nodes.count("DeviceJoinAgg") == 1 and "HashJoin" not in nodes
        spec = next(n for n in plan.walk() if isinstance(n, pp.DeviceJoinAgg)).spec
    # the fact is lineitem, orders its one adjacent dim; the orderpriority
    # membership is hoisted into host-evaluated dim columns and the
    # shipmode membership lowered to a dictionary-code plane
    assert [d.key_col for d in spec.dims] == ["o_orderkey"]
    assert spec.dims[0].parent == ("fact", "l_orderkey")
    assert len(spec.dims[0].synthetic) == 2
    assert [v[:2] for v in spec.fact_synthetic.values()] == [("l_shipmode",
                                                              ("MAIL", "SHIP"))]


def test_warm_query_probes_nothing(tpch):
    _ref, port_tables = tpch
    _port_run(q12, port_tables)
    counters.reset()
    _port_run(q12, port_tables)
    snap = counters.snapshot()
    assert snap["device_join_batches"] == 1
    assert snap["plain_hash_probe_build"] == 0 and snap["plain_hash_probe_index"] == 0
    assert snap["plain_segment_sum_planes"] == 1


# ---- a star of small tables ------------------------------------------------------------


N_FACT = 20_000


@pytest.fixture(scope="module")
def star():
    rng = np.random.default_rng(9)
    k1 = rng.integers(0, 500, N_FACT)
    fact = pa.table({
        "f_k1": pa.array(k1, pa.int64(), mask=k1 % 37 == 0),        # null fact keys
        "f_id": pa.array(np.arange(N_FACT), pa.int64()),
        "f_v": rng.uniform(0, 100, N_FACT),
        "f_tag": pa.array(rng.choice(["aa", "bb", "cc", "dd"], N_FACT),
                          mask=rng.random(N_FACT) < 0.05),
        "f_q": pa.array(rng.integers(1, 50, N_FACT), pa.int32()),
        "f_d": pa.array(rng.integers(8000, 9000, N_FACT).astype(np.int32), pa.date32()),
    })
    d1 = pa.table({                       # keyed dim with a chained foreign key
        "d1_k": pa.array(rng.permutation(500), pa.int64()),
        "d1_grp": [f"g{i % 7}" for i in range(500)],
        "d1_w": pa.array(np.arange(500) % 13, pa.int32()),
        "d1_big": pa.array((1 << 45) + np.arange(500) * 7_919, pa.int64()),
        "d1_huge": pa.array((1 << 60) + np.arange(500) * 7_919, pa.int64()),
        "d1_k2": pa.array(np.arange(500) % 40, pa.int32()),
    })
    d2 = pa.table({                       # second-hop dim
        "d2_k": pa.array(np.arange(40), pa.int64()),
        "d2_name": [f"n{i % 5}" for i in range(40)],
        "d2_flag": [i % 3 == 0 for i in range(40)],
    })
    return _tables({"fact": fact, "d1": d1, "d2": d2})


def test_chained_dim_with_dim_filter_and_integer_sum(star):
    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                .join(t["d2"].where(col("d2_flag")), left_on="d1_k2", right_on="d2_k")
                .groupby("d2_name")
                .agg(col("f_q").sum().alias("sq"), col("d1_w").sum().alias("sw"),
                     col("f_d").max().alias("last"))
                .sort("d2_name"))

    got = _check(q, *star)
    assert len(got["d2_name"]) == 5


def test_fact_string_predicate_lowered_to_codes(star):
    def q(dt, t):
        col = dt.col
        return (t["fact"].where(col("f_tag").is_in(["aa", "cc"]))
                .join(t["d1"], left_on="f_k1", right_on="d1_k")
                .groupby("d1_grp")
                .agg(col("f_q").sum().alias("sq"), col("f_q").count().alias("n"))
                .sort("d1_grp"))

    _check(q, *star)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        plan = pp.translate(q(daft_tpu_torch, star[1]).optimized_plan())
    spec = next(n for n in plan.walk() if isinstance(n, pp.DeviceJoinAgg)).spec
    assert list(spec.fact_synthetic.values()) == [("f_tag", ("aa", "cc"), False)]


def test_group_keys_on_dim_and_fact_string_columns(star):
    def q(dt, t):
        col, lit = dt.col, dt.lit
        return (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                .where(col("f_tag") == lit("bb"))
                .groupby("d1_grp", "f_tag")
                .agg(col("f_q").sum().alias("sq"),
                     col("d1_big").min().alias("lo"), col("d1_big").max().alias("hi"),
                     col("d1_big").sum().alias("s"))
                .sort(["d1_grp", "f_tag"]))

    got = _check(q, *star)
    assert set(got["f_tag"]) == {"bb"}
    assert min(got["lo"]) > 1 << 24


def test_int64_dim_values_past_2_53_stay_exact(star):
    """Dim planes are gathered in their own dtype, so int64 values past 2^53
    stay exact (the reference recombines f32 digit planes in f64, exact only
    below 2^53): port device == port host, bit for bit."""
    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                .groupby("d1_grp")
                .agg(col("d1_huge").min().alias("lo"), col("d1_huge").max().alias("hi"),
                     col("d1_huge").sum().alias("s"))
                .sort("d1_grp"))

    want = _port_run(q, star[1], device=False)
    counters.reset()
    got = _port_run(q, star[1])
    assert counters.snapshot()["device_join_batches"] == 1
    assert got == want and min(got["lo"]) > 1 << 53


def test_null_fact_keys_never_match(star):
    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                .groupby("d1_grp").agg(col("f_q").count().alias("n")).sort("d1_grp"))

    got = _check(q, *star)
    n_null = int((star[0]["fact"].to_pydict()["f_k1"].count(None)))
    assert n_null > 0 and sum(got["n"]) == N_FACT - n_null


def test_host_factorized_group_codes(star):
    """f_id x d1_grp has a dictionary product past the run's ceiling, so the
    joined key rows factorize on the host (20,000 true groups)."""
    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                .groupby("f_id", "d1_grp").agg(col("f_q").sum().alias("sq"))
                .sort(["f_id", "d1_grp"]))

    got = _check(q, *star, pallas=False)
    assert len(got["f_id"]) > 1 << 14


def test_group_count_over_the_ceiling_takes_the_host_plan(star, monkeypatch):
    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                .groupby("f_id").agg(col("f_q").sum().alias("sq")).sort("f_id"))

    want = _port_run(q, star[1], device=False)
    monkeypatch.setattr(dj.DeviceJoinGroupedRun, "max_segments", 1 << 10)
    counters.reset()
    assert _port_run(q, star[1]) == want
    snap = counters.snapshot()
    assert snap["device_join_batches"] == 0 and snap["device_fallbacks"] == 1
    assert snap["plain_segment_sum_planes"] == 0 and snap["plain_hash_probe_index"] == 0
    assert any("exceeds the ceiling" in r for r in counters.rejections), counters.rejections


@pytest.mark.parametrize("keys,why,chained", [([1, 2, 2, 3], "not unique", False),
                                              ([1, 2, pk.EMPTY_KEY, 3], "empty marker", False),
                                              ([1, 2, 2, 3], "not unique", True)])
def test_refused_dim_keys_take_the_host_plan(star, keys, why, chained):
    """Refused keys on an adjacent dim, or on a dim chained behind one, fall
    back before anything launches: neither K4 entry point runs."""
    ref_tables, port_tables = star
    dim = pa.table({"d_k": pa.array(keys, pa.int64()), "d_w": pa.array([1, 2, 3, 4])})
    ref_tables = dict(ref_tables, dup=daft_tpu.from_arrow(dim).collect())
    port_tables = dict(port_tables, dup=_carry(ref_tables["dup"]))

    def q(dt, t):
        col = dt.col
        if chained:
            joined = (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                      .join(t["dup"], left_on="d1_k2", right_on="d_k"))
        else:
            joined = t["fact"].join(t["dup"], left_on="f_k1", right_on="d_k")
        return joined.groupby("f_tag").agg(col("d_w").sum().alias("s")).sort("f_tag")

    manager().clear()

    with ref_ctx(device_mode="off"):
        want = q(daft_tpu, ref_tables).to_pydict()
    counters.reset()
    assert _port_run(q, port_tables) == want
    snap = counters.snapshot()
    assert snap["device_join_batches"] == 0 and snap["device_fallbacks"] == 1
    assert snap["plain_hash_probe_build"] == 0 and snap["plain_hash_probe_index"] == 0
    assert any(why in r for r in counters.rejections), counters.rejections
    assert _port_run(q, port_tables, device=False) == want


def test_float_sum_plans_to_the_host_with_the_reason(star):
    # a float sum over the join runs on the device (K7) and equals the
    # reference's device join at its tolerance; only under kernel_mode="off"
    # does it plan to the host, with the reason recorded
    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                .groupby("d1_grp").agg(col("f_v").sum().alias("sv")).sort("d1_grp"))

    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", kernel_mode="off"):
        plan = pp.translate(q(daft_tpu_torch, star[1]).optimized_plan())
    assert [type(n).__name__ for n in plan.walk()].count("HashJoin") == 1
    assert not any(isinstance(n, (pp.DeviceJoinAgg, pp.DeviceGroupedAgg))
                   for n in plan.walk())
    assert any("kernel_mode is off" in r for r in counters.rejections), counters.rejections
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        plan = pp.translate(q(daft_tpu_torch, star[1]).optimized_plan())
    assert [type(n).__name__ for n in plan.walk()].count("DeviceJoinAgg") == 1
    want = _ref_run(q, star[0])
    manager().clear()
    counters.reset()
    got = _port_run(q, star[1])
    snap = counters.snapshot()
    assert snap["device_join_batches"] >= 1 and snap["device_fallbacks"] == 0
    assert snap["plain_segment_sum_float_planes"] >= 1
    assert got["d1_grp"] == want["d1_grp"]
    np.testing.assert_allclose(got["sv"], want["sv"], rtol=1e-5)
    with ref_ctx(device_mode="off"):
        host = q(daft_tpu, star[0]).to_pydict()
    np.testing.assert_allclose(got["sv"], host["sv"], rtol=1e-5)


def test_host_join_output_matches_reference(star):
    def q(dt, t):
        col = dt.col
        return (t["fact"].where(col("f_q") < 5)
                .join(t["d1"], left_on="f_k1", right_on="d1_k")
                .select("f_id", "f_k1", "d1_grp", "f_tag", "d1_big")
                .sort("f_id"))

    with ref_ctx(device_mode="off"):
        want = q(daft_tpu, star[0]).to_pydict()
    assert _port_run(q, star[1], device=False) == want


def test_negated_fact_membership_keeps_null_rows(star):
    """``is_in`` is never null: a null f_tag is not in ("aa", "cc"), so
    ``~is_in`` keeps its row. The port's membership plane follows the host
    semantics; the reference's device plane marks null rows invalid and
    drops them (ROADMAP Queue 3, F4), so the port is held against the
    reference's host path here."""
    def q(dt, t):
        col = dt.col
        return (t["fact"].where(~col("f_tag").is_in(["aa", "cc"]))
                .join(t["d1"], left_on="f_k1", right_on="d1_k")
                .groupby("d1_grp").agg(col("f_q").sum().alias("sq"))
                .sort("d1_grp"))

    with ref_ctx(device_mode="off"):
        want = q(daft_tpu, star[0]).to_pydict()
    counters.reset()
    assert _port_run(q, star[1]) == want
    assert counters.snapshot()["device_join_batches"] == 1
    assert _port_run(q, star[1], device=False) == want


@pytest.mark.parametrize("column,items", [
    ("f_k1", [3, 7, 499]),
    ("f_tag", ["aa", "dd"]),
    ("f_d", [datetime.date(1992, 1, 2), datetime.date(1993, 3, 4)]),
])
def test_is_in_host_evaluation_matches_reference(star, column, items):
    """Host ``is_in`` over numeric, string and date columns with nulls: a
    null row is false, never null."""
    def q(dt, t):
        col = dt.col
        return t["fact"].select(col("f_id"), col(column).is_in(items).alias("hit"))

    with ref_ctx(device_mode="off"):
        want = q(daft_tpu, star[0]).to_pydict()
    got = _port_run(q, star[1], device=False)
    assert got == want and None not in got["hit"]


def test_multi_key_join_with_string_and_null_keys_matches_reference(star):
    rng = np.random.default_rng(12)
    other = pa.table({
        "o_tag": pa.array(rng.choice(["aa", "bb", "cc"], 300), mask=rng.random(300) < 0.1),
        "o_k": pa.array(rng.integers(0, 100, 300), pa.int32()),
        "o_val": pa.array(np.arange(300), pa.int64()),
    })
    ref_other = daft_tpu.from_arrow(other).collect()
    tables = ({**star[0], "other": ref_other}, {**star[1], "other": _carry(ref_other)})

    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["other"], left_on=["f_tag", "f_k1"],
                               right_on=["o_tag", "o_k"])
                .select("f_id", "f_tag", "f_k1", "o_val").sort(["f_id", "o_val"]))

    with ref_ctx(device_mode="off"):
        want = q(daft_tpu, tables[0]).to_pydict()
    assert len(want["f_id"]) > 0
    assert _port_run(q, tables[1], device=False) == want


# ---- float sums and f64 stages over the join ----------------------------------------


@pytest.fixture(scope="module")
def wide_star():
    """A fact joined to a dim of 6,000 rows whose group column has 5,000
    values: past the reference's 4096-group matmul ceiling, where its join
    takes the group-sorted local-dense branch."""
    rng = np.random.default_rng(21)
    n_fact, n_dim = 30_000, 6_000
    fk = rng.integers(0, n_dim + 200, n_fact)             # some keys miss
    fact = pa.table({
        "f_k": pa.array(fk, pa.int64(), mask=fk % 53 == 0),
        "f_v": pa.array(np.round(rng.uniform(0, 100, n_fact), 2), mask=rng.random(n_fact) < 0.05),
        "f_q": pa.array(rng.integers(1, 50, n_fact), pa.int32()),
    })
    dim = pa.table({
        "d_k": pa.array(rng.permutation(n_dim), pa.int64()),
        "d_grp": pa.array(rng.permutation(n_dim) % 5_000, pa.int64()),
        "d_w": rng.uniform(-5, 5, n_dim),
    })
    return _tables({"fact": fact, "dim": dim})


def _check_floats(query, ref_tables, port_tables, floats, exact=(), atol=None):
    """The port's device join against the reference's device run: keys,
    counts and ``exact`` columns bit for bit, ``floats`` at the reference's
    device-vs-host tolerance (rtol 1e-5, plus ``atol[c]`` where a column's
    terms cancel); and against the port's host path."""
    atol = atol or {}
    want = _ref_run(query, ref_tables)
    manager().clear()
    counters.reset()
    got = _port_run(query, port_tables)
    snap = counters.snapshot()
    assert snap["device_join_batches"] >= 1 and snap["device_fallbacks"] == 0, \
        (snap, counters.rejections)
    assert snap["plain_segment_sum_float_planes"] >= 1
    host = _port_run(query, port_tables, device=False)
    for other in (want, host):
        assert list(got) == list(other)
        for c in got:
            if c in floats:
                np.testing.assert_allclose(np.array(got[c], dtype=float),
                                           np.array(other[c], dtype=float), rtol=1e-5,
                                           atol=atol.get(c, 0.0))
            else:
                assert got[c] == other[c], c
    for c in exact:
        assert [np.float64(v).tobytes() for v in got[c]] == \
               [np.float64(v).tobytes() for v in want[c]]
    return got, snap


def test_float_sums_past_4096_joined_groups_match_reference(wide_star):
    def q(dt, t):
        col = dt.col
        return (t["fact"].where(col("f_q") < 40)
                .join(t["dim"], left_on="f_k", right_on="d_k")
                .groupby("d_grp")
                .agg(col("f_v").sum().alias("sv"), col("d_w").sum().alias("sw"),
                     (col("f_v") * col("d_w")).sum().alias("svw"),
                     col("f_v").mean().alias("mv"), col("f_q").sum().alias("sq"),
                     col("f_v").count().alias("n"))
                .sort("d_grp"))

    # f_v * d_w has terms of both signs: an f32 stage rounds each product
    # (and each input) to f32, about 2e-7 of a term of up to 500, and a
    # group sums a handful of them, so a total near 0 is held to 1e-3
    got, _snap = _check_floats(q, *wide_star, floats=("sv", "sw", "svw", "mv"),
                               atol={"svw": 1e-3})
    assert len(got["d_grp"]) > 4096


def test_f64_join_stage_past_4096_groups_runs_on_the_device(wide_star):
    # a float max makes the stage f64: the reference's local-dense branch
    # refuses it (its device run falls back to its host), the port serves it
    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["dim"], left_on="f_k", right_on="d_k")
                .groupby("d_grp")
                .agg(col("f_v").max().alias("top"), col("d_w").min().alias("low"),
                     col("f_v").sum().alias("sv"))
                .sort("d_grp"))

    got, snap = _check_floats(q, *wide_star, floats=("sv",), exact=("top", "low"))
    assert len(got["d_grp"]) > 4096 and snap["plain_segment_extreme_int64"] >= 2


def test_float_sum_and_extreme_over_the_q12_join(tpch):
    # TPC-H's float lineitem columns through the q12 join: an f32 stage for
    # the sums, then an f64 one with extremes
    def sums(dt, t):
        col = dt.col
        return (t["lineitem"].join(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
                .groupby("o_orderpriority")
                .agg(col("l_extendedprice").sum().alias("price"),
                     (col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("disc"),
                     col("o_totalprice").sum().alias("total"),
                     col("l_quantity").count().alias("n"))
                .sort("o_orderpriority"))

    def extremes(dt, t):
        col = dt.col
        return (t["lineitem"].join(t["orders"], left_on="l_orderkey", right_on="o_orderkey")
                .groupby("o_orderpriority")
                .agg(col("l_extendedprice").max().alias("top"),
                     col("o_totalprice").min().alias("low"),
                     col("l_tax").sum().alias("tax"))
                .sort("o_orderpriority"))

    _check_floats(sums, *tpch, floats=("price", "disc", "total"))
    _check_floats(extremes, *tpch, floats=("tax",), exact=("top", "low"))
