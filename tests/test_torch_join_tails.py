"""The join tails end to end: the ungrouped star join (TPC-H q14, q19), the
join TopN with ``limit`` (q3, q10) and the dispatch coalescer. The same
seeded tables go through the reference (daft_tpu, device_mode="on",
pallas_mode="on": its kernels in Pallas interpret mode on JAX CPU) and the
port (daft_tpu_torch, device="cpu": its kernels' plain versions); the
``to_pydict`` results must be equal, and equal to the port's host path
(device_mode="off"). Integers, strings, dates and row order compare
exactly; float sums within rtol 1e-5, the reference's device-vs-host
tolerance (tests/test_device_path.py). On the CPU the wrappers count
``plain_<kernel>`` calls and no launch.
"""

import datetime
import types

import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.ops import counters as ref_counters
from daft_tpu_torch.core.recordbatch import RecordBatch
from daft_tpu_torch.core.series import Series
from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import device_join as dj
from daft_tpu_torch.ops import grouped_stage as gs
from daft_tpu_torch.ops import segment_kernels as sk
from daft_tpu_torch.ops import stage as st
from daft_tpu_torch.plan import logical as lp
from daft_tpu_torch.plan import physical as pp
from daft_tpu_torch.schema import Schema

RTOL = 1e-5
TOPN_KERNELS = ("hash_probe_build", "hash_probe_index", "segment_sum_planes",
                "segment_extreme_planes", "segment_sum_float_planes")
UNGROUPED_KERNELS = ("hash_probe_build", "hash_probe_index")


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


def _same(got, want, floats=()):
    """Column for column: ``floats`` within RTOL (nulls in place), the rest
    exactly, rows in order."""
    assert list(got) == list(want)
    for c in got:
        assert len(got[c]) == len(want[c]), c
        if c in floats:
            g = np.array([np.nan if v is None else v for v in got[c]], dtype=float)
            w = np.array([np.nan if v is None else v for v in want[c]], dtype=float)
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0.0, err_msg=c)
        else:
            assert got[c] == want[c], c


def _ref_run(query, tables):
    with ref_ctx(device_mode="on", pallas_mode="on", mesh_devices=1):
        return query(daft_tpu, tables).to_pydict()


def _port_run(query, tables, device=True, **cfg):
    with daft_tpu_torch.execution_config_ctx(device="cpu",
                                             device_mode="on" if device else "off", **cfg):
        return query(daft_tpu_torch, tables).to_pydict()


def _check(query, ref_tables, port_tables, floats=(), topn=False):
    """Reference device == port device == port host; the port ran the join
    run through its kernels (plain versions), with no fallback, on a cold
    residency cache; a TopN query took one device TopN run."""
    ref_counters.reset()
    want = _ref_run(query, ref_tables)
    assert ref_counters.snapshot().get("device_join_batches", 0) > 0
    if topn:
        assert ref_counters.snapshot().get("device_topn_runs", 0) == 1
    manager().clear()
    counters.reset()
    got = _port_run(query, port_tables)
    snap = counters.snapshot()
    assert snap["device_join_batches"] >= 1 and snap["device_fallbacks"] == 0, \
        (snap, counters.rejections)
    assert snap["device_topn_runs"] == (1 if topn else 0), snap
    kernels = TOPN_KERNELS if topn else UNGROUPED_KERNELS
    assert all(snap[f"plain_{k}"] > 0 for k in kernels), snap
    assert all(snap[f"launches_{k}"] == 0 for k in counters.KERNEL_NAMES), snap
    _same(got, want, floats)
    _same(_port_run(query, port_tables, device=False), want, floats)
    return got


# ---- TPC-H q14, q19, q3, q10 (benchmarking/tpch/queries.py) ----------------------------


def _d(y, m, d):
    return datetime.date(y, m, d)


def q3(dt, t):
    col = dt.col
    C, O, L = t["customer"], t["orders"], t["lineitem"]
    return (C.where(col("c_mktsegment") == "BUILDING")
            .join(O, left_on="c_custkey", right_on="o_custkey")
            .where(col("o_orderdate") < _d(1995, 3, 15))
            .join(L, left_on="o_orderkey", right_on="l_orderkey")
            .where(col("l_shipdate") > _d(1995, 3, 15))
            .groupby(col("o_orderkey").alias("l_orderkey"), "o_orderdate", "o_shippriority")
            .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("revenue"))
            .select("l_orderkey", "revenue", "o_orderdate", "o_shippriority")
            .sort(["revenue", "o_orderdate"], desc=[True, False])
            .limit(10))


def q10(dt, t):
    col = dt.col
    C, O, L, N = t["customer"], t["orders"], t["lineitem"], t["nation"]
    return (O.where((col("o_orderdate") >= _d(1993, 10, 1)) & (col("o_orderdate") < _d(1994, 1, 1)))
            .join(L.where(col("l_returnflag") == "R"), left_on="o_orderkey",
                  right_on="l_orderkey")
            .join(C, left_on="o_custkey", right_on="c_custkey")
            .join(N, left_on="c_nationkey", right_on="n_nationkey")
            .groupby(col("o_custkey").alias("c_custkey"), "c_name", "c_acctbal", "c_phone",
                     "n_name", "c_address", "c_comment")
            .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("revenue"))
            .select("c_custkey", "c_name", "revenue", "c_acctbal", "n_name", "c_address",
                    "c_phone", "c_comment")
            .sort(["revenue", "c_custkey"], desc=[True, False])
            .limit(20))


def q14(dt, t):
    col, lit = dt.col, dt.lit
    L, P = t["lineitem"], t["part"]
    return (L.where((col("l_shipdate") >= _d(1995, 9, 1)) & (col("l_shipdate") < _d(1995, 10, 1)))
            .join(P, left_on="l_partkey", right_on="p_partkey")
            .with_column("revenue", col("l_extendedprice") * (1 - col("l_discount")))
            .with_column("promo", col("p_type").str.startswith("PROMO")
                         .if_else(col("revenue"), lit(0.0)))
            .agg(col("promo").sum().alias("promo_sum"), col("revenue").sum().alias("total_sum"))
            .select((lit(100.0) * col("promo_sum") / col("total_sum")).alias("promo_revenue")))


def q19(dt, t):
    col = dt.col
    L, P = t["lineitem"], t["part"]
    joined = L.where(col("l_shipmode").is_in(["AIR", "REG AIR"])
                     & (col("l_shipinstruct") == "DELIVER IN PERSON")
                     ).join(P, left_on="l_partkey", right_on="p_partkey")
    sm = (col("p_brand") == "Brand#12") & col("p_container").is_in(
        ["SM CASE", "SM BOX", "SM PACK", "SM PKG"]
    ) & (col("l_quantity") >= 1) & (col("l_quantity") <= 11) & (col("p_size") <= 5)
    med = (col("p_brand") == "Brand#23") & col("p_container").is_in(
        ["MED BAG", "MED BOX", "MED PKG", "MED PACK"]
    ) & (col("l_quantity") >= 10) & (col("l_quantity") <= 20) & (col("p_size") <= 10)
    lg = (col("p_brand") == "Brand#34") & col("p_container").is_in(
        ["LG CASE", "LG BOX", "LG PACK", "LG PKG"]
    ) & (col("l_quantity") >= 20) & (col("l_quantity") <= 30) & (col("p_size") <= 15)
    return (joined.where((col("p_size") >= 1) & (sm | med | lg))
            .agg((col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("revenue")))


QUERIES = {"q14": (q14, ("promo_revenue",), False), "q19": (q19, ("revenue",), False),
           "q3": (q3, ("revenue",), True), "q10": (q10, ("revenue",), True)}


@pytest.fixture(scope="module")
def tpch():
    from benchmarking.tpch.datagen import generate

    t = generate(0.01, 0)
    return _tables({k: t[k] for k in ("lineitem", "orders", "customer", "nation", "part")})


@pytest.mark.parametrize("name", list(QUERIES))
def test_tpch_join_tail_matches_reference(tpch, name):
    from benchmarking.tpch import queries

    query, floats, topn = QUERIES[name]
    got = _check(query, *tpch, floats=floats, topn=topn)
    # the port's query text is the benchmark's
    _same(got, getattr(queries, name)(tpch[0]).to_pydict(), floats)
    assert len(next(iter(got.values()))) == {"q14": 1, "q19": 1, "q3": 10, "q10": 20}[name]


@pytest.mark.parametrize("name,node", [("q14", pp.DeviceJoinAgg), ("q19", pp.DeviceJoinAgg),
                                       ("q3", pp.DeviceJoinTopN), ("q10", pp.DeviceJoinTopN)])
def test_tpch_join_tail_plans_one_device_node(tpch, name, node):
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        plan = pp.translate(QUERIES[name][0](daft_tpu_torch, tpch[1])._plan)
    found = [n for n in plan.walk() if isinstance(n, node)]
    assert len(found) == 1 and not any(isinstance(n, pp.HashJoin) for n in plan.walk())
    spec = found[0].spec
    assert spec.fact.schema.column_names()[0] == "l_orderkey"  # lineitem is the fact
    if name == "q14":
        # startswith is host-only: hoisted into a synthetic part column
        (syn, expr), = spec.dims[0].synthetic
        assert isinstance(expr, daft_tpu_torch.expressions.Function)
    if name == "q19":
        # the part string tests become synthetic dim columns, the lineitem
        # ones membership planes; the numeric comparisons stay on the device
        assert len(spec.dims[0].synthetic) == 6 and len(spec.fact_synthetic) == 2
    if name == "q3":
        # orders adjacent, customer chained behind it; the filter over the
        # inner join is lifted into the device predicate
        assert [d.parent for d in spec.dims] == [("fact", "l_orderkey"), ("d0", "o_custkey")]
        assert "o_orderdate" in repr(spec.predicate)
        assert found[0].topn.keys == [("agg", 0, True, True), ("group", 1, False, False)]


def test_startswith_is_host_only():
    from daft_tpu_torch import col
    from daft_tpu_torch.ops import device_eval

    schema = Schema.from_pydict({"s": DataType.string()})
    e = col("s").str.startswith("PR")
    assert not device_eval.is_device_evaluable(e, schema)
    df = daft_tpu_torch.from_pydict({"s": ["PROMO", "xPR", None, "PR"]})
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        assert df.select(e).to_pydict() == {"s": [True, False, None, True]}
    ref = daft_tpu.from_pydict({"s": ["PROMO", "xPR", None, "PR"]})
    assert ref.select(daft_tpu.col("s").str.startswith("PR")).to_pydict() == \
        {"s": [True, False, None, True]}


# ---- the ungrouped star join ----------------------------------------------------------


N_FACT = 20_000


@pytest.fixture(scope="module")
def star():
    """tests/test_device_join.py's star, with nullable columns for the TopN's
    null sort keys."""
    rng = np.random.default_rng(9)
    k1 = rng.integers(0, 500, N_FACT)
    fact = pa.table({
        "f_k1": pa.array(k1, pa.int64(), mask=k1 % 37 == 0),
        "f_v": rng.uniform(0, 100, N_FACT),
        "f_tag": rng.choice(["aa", "bb", "cc", "dd"], N_FACT),
        "f_q": pa.array(rng.integers(1, 50, N_FACT), pa.int32()),
        "f_opt": pa.array(rng.integers(0, 1000, N_FACT), pa.int64(),
                          mask=rng.random(N_FACT) < 0.9),
    })
    d1 = pa.table({
        "d1_k": pa.array(np.arange(500), pa.int64()),
        "d1_grp": [f"g{i % 7}" for i in range(500)],
        "d1_w": pa.array([float(i % 13) for i in range(500)]),
        "d1_opt": pa.array(np.arange(500) % 11, pa.int64(), mask=np.arange(500) % 4 == 0),
    })
    return _tables({"fact": fact, "d1": d1})


def test_ungrouped_join_agg(star):
    """tests/test_device_join.py::test_ungrouped_join_agg through both."""
    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                .where(col("d1_grp").is_in(["g1", "g3"]))
                .agg(col("f_v").sum().alias("s"), col("f_v").mean().alias("m"),
                     col("f_v").count().alias("c")))

    got = _check(q, *star, floats=("s", "m"))
    assert counters.snapshot()["device_stage_batches"] >= 1
    assert isinstance(got["c"][0], int) and got["c"][0] > 0


def test_ungrouped_join_over_no_kept_row(star):
    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                .where(col("d1_grp") == "none")
                .agg(col("f_v").sum().alias("s"), col("f_q").min().alias("lo"),
                     col("f_v").count().alias("c")))

    got = _check(q, *star, floats=("s",))
    assert got == {"s": [None], "lo": [None], "c": [0]}


# ---- the join TopN's edge cases -------------------------------------------------------


def _host_batch(df):
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        return df.collect()._result[0].concat_or_empty()


def _topn(limit, offset=0, by="n", desc=True, nulls_first=None, key="d1_grp"):
    def q(dt, t):
        col = dt.col
        df = (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
              .groupby(key)
              .agg(col("f_q").count().alias("n"), col("f_v").sum().alias("s"),
                   col("f_opt").min().alias("lo"))
              .sort(by, desc=desc, nulls_first=nulls_first))
        if offset:
            df = df.offset(offset)
        return df.limit(limit)
    return q


@pytest.mark.parametrize("limit,offset", [(0, 0), (3, 0), (4, 2), (5, 100)])
def test_topn_limit_and_offset(star, limit, offset):
    got = _check(_topn(limit, offset, by=["s"]), *star, floats=("s",), topn=True)
    assert len(got["d1_grp"]) == max(0, min(limit, 7 - offset))


def test_topn_ties_break_by_first_occurrence(star):
    """d1_k1 % 11 gives groups whose counts tie often; the sort by the count
    alone must order equal counts by first occurrence, as the host's stable
    sort over first-occurrence groups does."""
    q = _topn(40, by="n", key="f_q")
    got = _check(q, *star, floats=("s",), topn=True)
    assert len(set(got["n"])) < len(got["n"])  # there are ties to break


@pytest.mark.parametrize("nulls_first", [True, False])
@pytest.mark.parametrize("key,by", [("d1_opt", "d1_opt"), ("d1_k", "lo")])
def test_topn_null_sort_keys(star, key, by, nulls_first):
    """A null group key (d1_opt) and a null aggregation (min of a column
    with few valid rows), both nulls_first settings, ascending."""
    got = _check(_topn(6, by=[by, "s"], desc=[False, True], nulls_first=[nulls_first, False],
                       key=key), *star, floats=("s",), topn=True)
    nulls = [v is None for v in got[by]]
    # first when asked for; else past the six smallest values
    assert any(nulls) == nulls_first and nulls == sorted(nulls, reverse=nulls_first)


def test_topn_multi_batch_fact_takes_the_host_plan(star):
    _ref, port_tables = star
    batch = _host_batch(port_tables["fact"])
    two = daft_tpu_torch.DataFrame(lp.InMemorySource(
        port_tables["fact"].schema,
        [daft_tpu_torch.MicroPartition(batch.schema, [batch.slice(0, 9000),
                                                      batch.slice(9000, N_FACT)])]))
    q = _topn(5, by=["s"])
    want = _port_run(q, port_tables, device=False)
    counters.reset()
    got = _port_run(q, dict(port_tables, fact=two))
    snap = counters.snapshot()
    assert snap["device_topn_runs"] == 0 and snap["device_fallbacks"] == 1
    # the one join batch is the host plan's grouped join run, fed through
    # the coalescer: the TopN run, which never coalesces, fed nothing
    assert snap["device_join_batches"] == snap["dispatch_coalesced"] == 1
    assert any("join topn" in r and "single fact batch" in r for r in counters.rejections), \
        counters.rejections
    _same(got, want, ("s",))


def test_topn_over_the_ceiling_takes_the_host_plan(star, monkeypatch):
    q = _topn(5, by=["s"], key="f_q")
    want = _port_run(q, star[1], device=False)
    monkeypatch.setattr(dj.DeviceJoinTopNRun, "max_segments", 16)
    manager().clear()
    counters.reset()
    got = _port_run(q, star[1])
    snap = counters.snapshot()
    assert snap["device_topn_runs"] == 0 and snap["device_fallbacks"] >= 1
    assert any("exceeds the ceiling 16 of DeviceJoinTopNRun" in r
               for r in counters.rejections), counters.rejections
    _same(got, want, ("s",))


def test_factorized_codes_number_groups_as_make_groups(star):
    """The join run's factorize (dim codes gathered through the index) gives
    make_groups' ids over the gathered key columns, and builds key tuples
    only for the groups asked for."""
    from daft_tpu_torch.core.kernels.groupby import make_groups

    _ref, port_tables = star
    fact, d1 = _host_batch(port_tables["fact"]), _host_batch(port_tables["d1"])
    idx = dj.unique_key_index(d1.get_column("d1_k"), fact.get_column("f_k1").to_numpy(),
                              fact.get_column("f_k1").validity_numpy(), DataType.int64())
    key_cols = [(d1.get_column("d1_grp"), idx), (fact.get_column("f_tag"), None),
                (d1.get_column("d1_opt"), idx)]
    fc = dj._FactorizedCodes(key_cols, fact.num_rows, st.pad_bucket(fact.num_rows),
                             daft_tpu_torch.utils.torch_setup.resolve_device("cpu"))
    gathered = [d1.get_column("d1_grp").take(np.clip(idx, 0, 499)), fact.get_column("f_tag"),
                d1.get_column("d1_opt").take(np.clip(idx, 0, 499)),
                Series.from_numpy((idx < 0).astype(np.int8), "miss")]
    first, ids, _ = make_groups(gathered)
    np.testing.assert_array_equal(fc.first_idx, first)
    np.testing.assert_array_equal(fc.group_ids, ids)
    assert fc.rows_for([0, 3]) == [tuple(s.to_pylist()[first[g]] for s in gathered[:3])
                                   for g in (0, 3)]
    ranks, ok = fc.rank_plane(2)
    vals = gathered[2].take(first)
    assert ok[:fc.num_groups].tolist() == vals.validity_numpy().tolist()
    live = vals.validity_numpy()
    order = np.argsort(vals.to_numpy()[live], kind="stable")
    assert np.all(np.diff(ranks[:fc.num_groups][live].numpy()[order]) >= 0)


# ---- the kernels' range ---------------------------------------------------------------


def test_wrapper_caps_take_2_22_and_refuse_past_it():
    top = sk.KERNEL_MAX_SEGMENTS
    assert top == 1 << 22 == dj.TOPN_MAX_SEGMENTS
    assert sk.segment_planes_tier(top, 2).kind == "global"
    assert sk.segment_sum_float_tier(top, 1).kind == "global"
    assert sk.segment_extreme_int64_tier(top).cluster == 0
    for tier in (lambda c: sk.segment_planes_tier(c, 2), lambda c: sk.segment_sum_float_tier(c, 1),
                 sk.segment_extreme_int64_tier):
        with pytest.raises(ValueError):
            tier(top + 1)
    # the plain versions take the same range
    codes = torch.tensor([0, top - 1, top, -1], dtype=torch.int32)
    planes = [torch.tensor([1.0, 2.0, 4.0, 8.0])]
    out = sk.segment_sum_planes(planes, codes, top)
    assert out.shape == (top, 1) and out[0, 0] == 1 and out[top - 1, 0] == 2
    fl = sk.segment_sum_float_planes(planes, codes, top)
    assert fl[top - 1, 0] == 2 and fl.sum() == 3
    ext = sk.segment_extreme_planes(planes, codes, top, "max")
    assert ext[top - 1, 0] == 2
    vals, nonempty = sk.segment_extreme_int64(torch.tensor([5, 6, 7, 8]),
                                             torch.ones(4, dtype=torch.bool), codes, top, "min")
    assert vals[top - 1] == 6 and int(nonempty.sum()) == 2


def test_grouped_stage_still_refuses_past_2_20_groups():
    n = (1 << 20) + 1
    assert gs.MAX_SORT_SEGMENTS == 1 << 20 < sk.KERNEL_MAX_SEGMENTS
    schema = Schema.from_pydict({"k": DataType.int64(), "v": DataType.int64()})
    batch = RecordBatch(schema, [Series.from_numpy(np.arange(n), "k", DataType.int64()),
                                 Series.from_numpy(np.ones(n, np.int64), "v",
                                                   DataType.int64())], n)
    from daft_tpu_torch import col

    stage = gs.try_build_grouped_agg_stage(schema, None, [col("k")], [col("v").sum()])
    run = stage.start_run(daft_tpu_torch.utils.torch_setup.resolve_device("cpu"))
    counters.reset()
    with pytest.raises(gs.DeviceFallback, match="groups"):
        run.feed_batch(batch)
    assert all(v == 0 for k, v in counters.snapshot().items() if k.startswith("plain_"))


# ---- the dispatch coalescer (tests/test_batching.py:66-128) ----------------------------


def _morsel_batches(n_batches=8, rows=1024):
    """tests/test_batching.py's morsels: int64 sums near 2^53 and min/max
    past 2^53, which f64 would round."""
    rng = np.random.default_rng(7)
    schema = Schema.from_pydict({"k": DataType.int64(), "v": DataType.int64(),
                                 "w": DataType.int64()})
    out = []
    for _ in range(n_batches):
        k = rng.integers(0, 8, rows)
        v = rng.integers(0, 1 << 40, rows)
        w = rng.integers(-(1 << 60), 1 << 60, rows) | 1
        cols = [Series.from_numpy(k, "k", DataType.int64()),
                Series.from_numpy(v, "v", DataType.int64()),
                Series.from_numpy(w, "w", DataType.int64())]
        out.append(RecordBatch(schema, cols, rows))
    return schema, out


def _aggs():
    from daft_tpu_torch import col

    return [col("v").sum().alias("s"), col("v").mean().alias("m"),
            col("w").min().alias("lo"), col("w").max().alias("hi"),
            col("v").count().alias("c")]


def test_coalescing_grouped_bit_identical():
    from daft_tpu_torch import col

    schema, batches = _morsel_batches(8, 1024)
    stage = gs.try_build_grouped_agg_stage(schema, None, [col("k")], _aggs())
    cpu = daft_tpu_torch.utils.torch_setup.resolve_device("cpu")
    counters.reset()
    run = stage.start_run(cpu)
    coal = st.DispatchCoalescer(run.feed_batch, target_rows=65536, latency_s=3600.0)
    for b in batches:
        coal.add(b)
    coal.close()
    keys_c, res_c = run.finalize()
    snap = counters.snapshot()
    assert snap["coalesce_morsels_in"] == 8 and snap["dispatch_coalesced"] == 1
    assert snap["bucket_fill_rows"] / snap["bucket_capacity_rows"] >= 0.5
    assert snap["device_grouped_batches"] == snap["dispatch_coalesced"]

    run2 = stage.start_run(cpu)
    for b in batches:
        run2.feed_batch(b)
    keys_u, res_u = run2.finalize()
    assert keys_c == keys_u
    for (vc, okc), (vu, oku) in zip(res_c, res_u):
        np.testing.assert_array_equal(okc, oku)
        np.testing.assert_array_equal(vc, vu)


def _chunked(n_parts=8, rows=1024, seed=3):
    rng = np.random.default_rng(seed)
    parts = [daft_tpu_torch.MicroPartition.from_pydict({"k": rng.integers(0, 6, rows),
                                                        "v": rng.integers(0, 1 << 40, rows),
                                                        "x": rng.uniform(0, 1, rows)})
             for _ in range(n_parts)]
    return daft_tpu_torch.DataFrame(lp.InMemorySource(parts[0].schema, parts))


@pytest.mark.parametrize("grouped", [True, False])
def test_coalescing_end_to_end(grouped):
    from daft_tpu_torch import col

    df = _chunked()

    def q():
        out = df.groupby("k") if grouped else df
        out = out.agg(col("v").sum().alias("s"), col("v").count().alias("c"))
        return out.sort("k") if grouped else out

    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        host = q().to_pydict()
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", batch_latency_ms=60_000.0):
        dev = q().to_pydict()
    snap = counters.snapshot()
    assert snap["coalesce_morsels_in"] == 8 and snap["dispatch_coalesced"] * 2 <= 8
    batches = snap["device_grouped_batches" if grouped else "device_stage_batches"]
    assert batches == snap["dispatch_coalesced"]
    assert snap["bucket_fill_rows"] / snap["bucket_capacity_rows"] >= 0.5
    assert dev == host


def test_coalescing_off_feeds_every_morsel():
    from daft_tpu_torch import col

    df = _chunked()
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", batch_fill_target=0):
        df.agg(col("v").sum()).to_pydict()
    snap = counters.snapshot()
    assert snap["device_stage_batches"] == 8 and snap["coalesce_morsels_in"] == 0


def test_coalescer_latency_flush_under_a_patched_clock(monkeypatch):
    now = [0.0]
    monkeypatch.setattr(st, "time", types.SimpleNamespace(perf_counter=lambda: now[0]))
    fed = []
    _schema, batches = _morsel_batches(4, 100)
    coal = st.DispatchCoalescer(fed.append, target_rows=10_000, latency_s=0.05)
    coal.add(batches[0])
    now[0] = 0.01
    coal.add(batches[1])
    assert fed == []  # under the target, inside the deadline
    now[0] = 0.07
    coal.add(batches[2])  # the oldest has waited 70 ms: all three go
    assert len(fed) == 1 and fed[0].num_rows == 300
    coal.add(batches[3])
    assert len(fed) == 1
    coal.close()
    assert len(fed) == 2 and fed[1] is batches[3]


def test_coalescer_hands_one_batch_on_unchanged():
    fed = []
    _schema, batches = _morsel_batches(1, 100)
    coal = st.DispatchCoalescer(fed.append, target_rows=10_000, latency_s=3600.0)
    coal.add(batches[0])
    coal.close()
    assert len(fed) == 1 and fed[0] is batches[0]


def test_coalesced_join_keeps_the_resident_planes(star):
    """A one-batch fact passes the coalescer unchanged, so a warm join query
    finds its index plane resident and probes nothing."""
    def q(dt, t):
        col = dt.col
        return (t["fact"].join(t["d1"], left_on="f_k1", right_on="d1_k")
                .agg(col("f_v").sum().alias("s")))

    _port_run(q, star[1])
    counters.reset()
    _port_run(q, star[1])
    snap = counters.snapshot()
    assert snap["dispatch_coalesced"] == 1 and snap["device_join_batches"] == 1
    assert snap["plain_hash_probe_build"] == 0 and snap["plain_hash_probe_index"] == 0


def test_config_checks_the_coalescer_settings():
    for bad in ({"batch_fill_target": -0.1}, {"batch_fill_target": 1.5},
                {"batch_latency_ms": 0.0}):
        with pytest.raises(ValueError):
            daft_tpu_torch.ExecutionConfig(**bad)
    cfg = daft_tpu_torch.ExecutionConfig()
    assert cfg.batch_fill_target == 0.5 and cfg.batch_latency_ms == 50.0
    from daft_tpu_torch.execution.batching import coalesce_target_rows

    assert coalesce_target_rows(cfg) == 65536
    assert coalesce_target_rows(daft_tpu_torch.ExecutionConfig(batch_fill_target=0)) == 0


# ---- host Limit / Offset / TopN -------------------------------------------------------


def test_host_limit_offset_and_topn_match_reference():
    rng = np.random.default_rng(5)
    data = {"k": rng.integers(0, 20, 300).tolist(), "v": rng.integers(0, 5, 300).tolist()}
    ref = daft_tpu.from_pydict(data)
    port = daft_tpu_torch.from_pydict(data)
    cases = [lambda m, d: d.limit(7), lambda m, d: d.offset(295),
             lambda m, d: d.offset(3).limit(4), lambda m, d: d.limit(0),
             lambda m, d: d.sort("v").limit(12), lambda m, d: d.sort("v", desc=True).offset(5),
             lambda m, d: d.sort(["v", "k"], desc=[True, False]).offset(2).limit(9),
             lambda m, d: d.sort("k").limit(500)]
    for case in cases:
        with ref_ctx(device_mode="off"):
            want = case(daft_tpu, ref).to_pydict()
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
            assert case(daft_tpu_torch, port).to_pydict() == want
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        plan = pp.translate(port.sort("v").offset(3).limit(4)._plan)
    assert isinstance(plan, pp.PhysTopN) and (plan.limit, plan.offset) == (4, 3)
