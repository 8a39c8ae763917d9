"""chip_smoke.py refuses to report a result where it cannot drive the card:
without a CUDA card, and when it stands alone in a directory without the
port beside it. Both exit non-zero and print no {"ok": ...} line."""

import os
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_without_card_fails():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run in full")
    proc = _run(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no CUDA card" in proc.stderr


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path / "chip_smoke.py")
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_partkey_kernel_cases_get_the_stages_inputs(monkeypatch):
    """chip_smoke.py's kernel cases at the partkey cell's shapes feed K1, K2,
    K3 and K7 what the grouped stage itself passes them for that query (on
    the CPU, at a small size: 3,000 rows of 200 parts, bucket 4096, cap
    256), tensor for tensor."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch import col
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.ops import segment_kernels as sk

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    n, parts = 3000, 200
    rng = np.random.default_rng(7)
    cols = {"l_partkey": rng.permutation(np.arange(n) % parts + 1).astype(np.int64),
            "l_extendedprice": np.round(rng.uniform(900, 100_000, n), 2),
            "l_quantity": rng.integers(1, 51, n).astype(np.float64)}
    seen = {}
    for name in ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes",
                 "segment_extreme_int64"):
        def record(*args, _name=name, _fn=getattr(sk, name)):
            seen.setdefault(_name, []).append(args)
            return _fn(*args)
        monkeypatch.setattr(sk, name, record)
    manager().clear()
    df = dt.from_pydict(cols)
    with dt.execution_config_ctx(device="cpu", device_mode="on"):
        (df.groupby("l_partkey")
         .agg(col("l_extendedprice").sum().alias("revenue"),
              col("l_partkey").count().alias("lines"),
              col("l_quantity").max().alias("top_qty"))
         .to_pydict())
    monkeypatch.setattr(cs, "BUCKET", 4096)
    monkeypatch.setattr(cs, "PARTKEY_CAP", 256)
    want = cs.partkey_inputs(cols, torch.device("cpu"))

    def same(a, b):
        return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                        for x, y in zip(a, b))
    ((k1_planes, k1_codes, k1_cap),) = seen["segment_sum_planes"]
    assert k1_cap == 256 and torch.equal(k1_codes, want["codes"])
    assert same(k1_planes, want["planes"])
    ((k2_planes, _c, _cap, k2_op),) = seen["segment_extreme_planes"]
    assert k2_op == "min" and same(k2_planes, want["first"])
    ((k7_planes, _c, _cap),) = seen["segment_sum_float_planes"]
    assert same(k7_planes, want["price"])
    (key, keep, _c, _cap, op), (rows, zero, _c2, _cap2, op2) = seen["segment_extreme_int64"]
    assert op == "max" and op2 == "min"
    assert same([key, keep, rows, zero],
                [want["qty_key"], want["keep"], want["rows"], want["zero"]])


def test_profile_counts_the_ports_own_kernel_activities(monkeypatch):
    """phase_profile holds a capture against the run's counted launches
    with the activities of the port's own kernels only: every __global__
    function of the package's csrc, the warp tier's (nested parentheses in
    its launch bounds) too; torch's elementwise kernels and copies do not
    count, nor a name that only ends in a kernel's name."""
    import re

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    names = cs.port_kernel_names()
    csrc = os.path.join(REPO, "daft_tpu_torch", "ops", "csrc")
    declared = sum(len(re.findall(r"__global__", open(os.path.join(csrc, f)).read()))
                   for f in os.listdir(csrc) if f.endswith(".cu"))
    assert len(names) == declared
    assert {"k7_warp_kernel", "k7_partial_kernel", "k7_merge_kernel", "plane_partial_kernel",
            "k3_partial_kernel", "probe_index_kernel", "bulk_transpose_kernel"} <= set(names)

    class Event:
        def __init__(self, key, count):
            self.key, self.count = key, count

    events = [Event("void (anonymous namespace)::k7_partial_kernel<float, 4, 2>((anonymous", 3),
              Event("(anonymous namespace)::k7_merge_kernel(double const*, int, int)", 3),
              Event("void at::native::vectorized_elementwise_kernel<4, at::native::FillFunctor", 40),
              Event("Memcpy HtoD (Pageable -> Device)", 7),
              Event("void other::my_k7_partial_kernel<float>(float*)", 5)]
    assert cs.own_activities(events, names) == 6


def _small_tpch(cs):
    """chip_smoke.py's tables at a small size: 40,000 orders (about 160,000
    lineitem rows, enough for q19 to keep a few), 2,000 parts, 4,000
    customers."""
    return cs.tpch_sf1(11, n_orders=40_000, n_parts=2_000, n_customers=4_000)


@pytest.mark.parametrize("name", ["q14", "q19", "q3", "q10"])
def test_join_tail_oracles_match_the_port(monkeypatch, name):
    """chip_smoke.py's numpy oracles of the join tails equal the port's host
    path and its device path on the CPU (the one TopN run for q3 and q10)
    at a small size."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, orders, dims = _small_tpch(cs)
    frames = cs.tails_frames(lineitem, orders, dims)
    query, oracle, floats, topn = cs.TAILS[name]
    want = oracle(lineitem, orders, dims)
    if topn:
        want, margin = want
        assert margin is not None and margin > 0
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        assert cs.same_result(query(frames).to_pydict(), want, floats)
    counters.reset()
    with dt.execution_config_ctx(device="cpu"):
        assert cs.same_result(query(frames).to_pydict(), want, floats)
    snap = counters.snapshot()
    assert snap["device_join_batches"] == 1 and snap["device_fallbacks"] == 0
    assert snap["device_topn_runs"] == int(topn)


def test_topn_kernel_cases_get_the_runs_inputs(monkeypatch):
    """chip_smoke.py's kernel cases at q3's shapes feed K1, K2 and K7 what
    q3's TopN run itself passes them (on the CPU, at a small size), tensor
    for tensor."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.ops import grouped_stage
    from daft_tpu_torch.ops import segment_kernels as sk
    from daft_tpu_torch.ops.stage import pad_bucket

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, orders, dims = _small_tpch(cs)
    frames = cs.tails_frames(lineitem, orders, dims)
    seen = {}
    for name in ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes"):
        def record(*args, _name=name, _fn=getattr(sk, name)):
            seen.setdefault(_name, []).append(args)
            return _fn(*args)
        monkeypatch.setattr(sk, name, record)
    manager().clear()
    with dt.execution_config_ctx(device="cpu"):
        cs.q3_query(frames).to_pydict()
    bucket = pad_bucket(len(lineitem["l_orderkey"]))
    cap = grouped_stage._pad_groups(len(orders["o_orderkey"]))
    monkeypatch.setattr(cs, "BUCKET", bucket)
    monkeypatch.setattr(cs, "Q3_CAP", cap)
    want = cs.topn_inputs(lineitem, orders, dims, torch.device("cpu"))["q3"]

    def same(a, b):
        return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                        for x, y in zip(a, b))
    ((k1_planes, k1_codes, k1_cap),) = seen["segment_sum_planes"]
    assert k1_cap == cap and torch.equal(k1_codes, want["codes"])
    assert same(k1_planes, want["planes"])
    ((k2_planes, _c, _cap, k2_op),) = seen["segment_extreme_planes"]
    assert k2_op == "min" and same(k2_planes, want["first"])
    ((k7_planes, _c, _cap),) = seen["segment_sum_float_planes"]
    assert same(k7_planes, want["revenue"])


@pytest.mark.parametrize("cell", ["q5", "topn_order"])
def test_new_cells_kernel_cases_get_the_runs_inputs(monkeypatch, cell):
    """chip_smoke.py's kernel cases at q5's shapes (K1, K2 and K7 at cap 32;
    K4's build over supplier and its probe of l_suppkey) and at the TopN
    order cell's (K1 over eight digit planes, K2 and K7) feed the kernels
    what the cell's own run passes them (on the CPU, at a small size),
    tensor for tensor."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.ops import grouped_stage
    from daft_tpu_torch.ops import probe_kernels as pk
    from daft_tpu_torch.ops import segment_kernels as sk
    from daft_tpu_torch.ops.stage import pad_bucket

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, orders, dims = _small_tpch(cs)
    seen = {}
    for mod, names in ((sk, ("segment_sum_planes", "segment_extreme_planes",
                             "segment_sum_float_planes")),
                       (pk, ("build_probe_table", "hash_probe_index"))):
        for name in names:
            def record(*args, _name=name, _fn=getattr(mod, name)):
                seen.setdefault(_name, []).append(args)
                return _fn(*args)
            monkeypatch.setattr(mod, name, record)
    manager().clear()
    with dt.execution_config_ctx(device="cpu"):
        if cell == "q5":
            cs.q5_query(cs.q5_frames(lineitem, orders, dims)).to_pydict()
        else:
            t = {"lineitem": dt.from_pydict({c: lineitem[c] for c in (
                    "l_orderkey", "l_partkey", "l_quantity")}),
                 "orders": dt.from_pydict({c: orders[c] for c in ("o_orderkey", "o_custkey")})}
            cs.topn_sf1_query(t).to_pydict()
    bucket = pad_bucket(len(lineitem["l_orderkey"]))
    monkeypatch.setattr(cs, "BUCKET", bucket)
    dev = torch.device("cpu")
    if cell == "q5":
        cap, floats = cs.Q5_CAP, "revenue"
        want = cs.q5_inputs(lineitem, orders, dims, dev)
    else:
        cust = orders["o_custkey"][lineitem["l_orderkey"] - 1]
        cap, floats = grouped_stage._pad_groups(len(set(cust.tolist()))), "qty"
        monkeypatch.setattr(cs, "TOPN_SF1_CAP", cap)
        want = cs.topn_sf1_inputs(lineitem, orders, dev)

    def same(a, b):
        return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                        for x, y in zip(a, b))
    ((k1_planes, k1_codes, k1_cap),) = seen["segment_sum_planes"]
    assert k1_cap == cap and torch.equal(k1_codes, want["codes"])
    assert same(k1_planes, want["planes"])
    ((k2_planes, _c, _cap, k2_op),) = seen["segment_extreme_planes"]
    assert k2_op == "min" and same(k2_planes, want["first"])
    ((k7_planes, _c, _cap),) = seen["segment_sum_float_planes"]
    assert same(k7_planes, want[floats])
    if cell == "q5":
        # the supplier's table and probe, beside the orders' (the q12 cases)
        builds = {len(a[0]): a for a in seen["build_probe_table"]}
        keys, valid, slots = builds[cs.SF1_SUPPLIERS]
        assert torch.equal(keys, torch.from_numpy(dims["supplier"]["s_suppkey"]))
        assert bool(valid.all()) and slots == pk.probe_table_slots(cs.SF1_SUPPLIERS)
        want_keys, want_valid = cs.fact_keys_on(lineitem, "l_suppkey", dev)
        assert any(torch.equal(k, want_keys) and torch.equal(v, want_valid)
                   and t.shape[0] == slots for k, v, t in seen["hash_probe_index"])


def test_generator_keeps_the_earlier_cells_data(monkeypatch):
    """Drawing q5's tables last leaves every earlier cell's columns as they
    were: their digest at a small size is the one the generator gave
    before supplier, region and n_regionkey were added. The new tables hold
    the generator's domains."""
    import hashlib

    import numpy as np

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, orders, dims = _small_tpch(cs)
    h = hashlib.sha256()
    nation = {k: dims["nation"][k] for k in ("n_nationkey", "n_name")}
    for table in (lineitem, orders, dims["part"], dims["customer"], nation):
        for k in sorted(table):
            a = table[k]
            h.update(k.encode())
            h.update(a.tobytes() if a.dtype != object else "\x00".join(a.tolist()).encode())
    assert h.hexdigest() == "f7331dd4a0db33c07de5ac8bcaca0fd39ba6d5d6462a4187e5ff654257947fab"
    assert dims["nation"]["n_regionkey"].tolist() == cs.NATION_REGIONS
    assert dims["region"]["r_name"].tolist() == cs.REGIONS
    s = dims["supplier"]
    assert s["s_suppkey"].tolist() == list(range(1, cs.SF1_SUPPLIERS + 1))
    assert set(np.unique(s["s_nationkey"]).tolist()) == set(range(len(cs.NATIONS)))


def test_q5_oracle_matches_the_port(monkeypatch):
    """chip_smoke.py's q5 (the benchmark's text), over its tables, equals
    its numpy oracle on the port's host path and as one device join on the
    CPU, with no rejection and no fallback."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, orders, dims = _small_tpch(cs)
    frames = cs.q5_frames(lineitem, orders, dims)
    want = cs.q5_oracle(lineitem, orders, dims)
    assert len(want["n_name"]) == 5
    assert set(want["n_name"]) == {n for n, r in zip(cs.NATIONS, cs.NATION_REGIONS)
                                   if cs.REGIONS[r] == "ASIA"}
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        assert cs.same_result(cs.q5_query(frames).to_pydict(), want, ("revenue",))
    counters.reset()
    with dt.execution_config_ctx(device="cpu"):
        assert cs.same_result(cs.q5_query(frames).to_pydict(), want, ("revenue",))
    snap = counters.snapshot()
    assert snap["device_join_batches"] == 1 and snap["device_fallbacks"] == 0
    assert not counters.rejections
    # two adjacent dims (orders, supplier): one table and one probe each
    assert snap["plain_hash_probe_build"] == snap["plain_hash_probe_index"] == 2


@pytest.mark.parametrize("name", ["q1", "q6"])
def test_chain_cells_fuse_and_match(monkeypatch, name):
    """The q1 and q6 chains plan as one device node over the scan and give
    their cell's result: q1's bit for bit (the same program), q6's within
    rtol 1e-5, and each its numpy oracle."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.plan import physical as pp

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, _orders, _dims = _small_tpch(cs)
    if name == "q1":
        df = cs.q1_frame(lineitem)
        chain, plain, floats = cs.q1_chain_query, cs.q1_query, cs.Q1_FLOATS
        oracle, node, ops = cs.q1_oracle(lineitem), pp.DeviceGroupedAgg, \
            ("filter", "project", "project", "agg")
    else:
        df = dt.from_pydict({**{c: lineitem[c] for c in ("l_quantity", "l_extendedprice",
                                                         "l_discount")},
                             "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]")})
        chain, floats = cs.q6_chain_query, ("revenue",)
        oracle, node, ops = cs.q6_oracle(lineitem), pp.DeviceFilterAgg, \
            ("filter", "project", "agg")
    with dt.execution_config_ctx(device="cpu"):
        cs.region_plan_check(name, pp.translate(chain(df).optimized_plan()), node, ops)
        counters.reset()
        got = chain(df).to_pydict()
        assert counters.device_region_ops_fused == len(ops) * counters.device_region_dispatches
        assert counters.device_region_dispatches == 1
        if name == "q1":
            assert cs.same_result(got, plain(df).to_pydict())
        assert cs.count_uploads(lambda: chain(df).to_pydict()) == 0
    assert cs.same_result(got, oracle, floats)


@pytest.mark.parametrize("desc", [True, False])
def test_topn_order_cells_match(monkeypatch, desc):
    """The TopN order cell's SF1 query equals its numpy oracle (ties by
    first occurrence) as one device TopN run, and its small cases equal the
    host path in both nulls_first settings."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import counters

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, orders, _dims = _small_tpch(cs)
    t = {"lineitem": dt.from_pydict({c: lineitem[c] for c in ("l_orderkey", "l_partkey",
                                                               "l_quantity")}),
         "orders": dt.from_pydict({c: orders[c] for c in ("o_orderkey", "o_custkey")})}
    counters.reset()
    with dt.execution_config_ctx(device="cpu"):
        got = cs.topn_sf1_query(t, desc).to_pydict()
    assert counters.device_topn_runs == 1
    assert cs.same_result(got, cs.topn_sf1_oracle(lineitem, orders, desc), ("qty",))
    for name, (fact, dim, limit) in cs.topn_order_inputs().items():
        f, d = dt.from_pydict(fact), dt.from_pydict(dim)
        for nulls_first in (True, False):
            with dt.execution_config_ctx(device="cpu"):
                dev = cs.topn_order_query(f, d, desc, nulls_first, limit).to_pydict()
            with dt.execution_config_ctx(device_mode="off"):
                host = cs.topn_order_query(f, d, desc, nulls_first, limit).to_pydict()
            assert cs.same_result(dev, host, ("s",) if name == "special" else ()), name


def _sql_tables(cs, dt, lineitem, orders, dims):
    """The tables of each DataFrame cell, built as chip_smoke.py's phases
    build them."""
    df_l, df_o = cs.q12_frames(lineitem, orders)
    q6 = dt.from_pydict({**{c: lineitem[c] for c in ("l_quantity", "l_extendedprice",
                                                     "l_discount")},
                         "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]")})
    return {"q1": {"lineitem": cs.q1_frame(lineitem)}, "q6": {"lineitem": q6},
            "q12": {"lineitem": df_l, "orders": df_o},
            "tails": cs.tails_frames(lineitem, orders, dims),
            "q5": cs.q5_frames(lineitem, orders, dims)}


@pytest.mark.parametrize("qn", [1, 6, 3, 5, 12, 14, 19])
def test_sql_cells_count_as_their_dataframe_cells(monkeypatch, qn):
    """The sql phase's checks on the CPU at a small size: the SQL form's
    first run over its DataFrame cell's tables counts what the DataFrame
    form's run counts (the kernels' plain versions), its three warm runs
    three times as much, the results are equal, and a warm run uploads
    nothing."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.device.residency import manager

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, orders, dims = _small_tpch(cs)
    cell, df_query, floats = cs.SQL_CELLS[qn]
    tables = _sql_tables(cs, dt, lineitem, orders, dims)[cell]
    manager().clear()
    with dt.execution_config_ctx(device="cpu"):
        want, got, df_snap, snap, warm, _first, _warm, df_uploads, uploads = cs.sql_counts(
            cs.TPCH_SQL[qn], tables, df_query)
    assert snap == df_snap
    assert warm == {k: 3 * v for k, v in df_snap.items()}
    assert snap["device_grouped_batches"] + snap["device_stage_batches"] \
        + snap["device_join_batches"] >= 1, snap
    assert cs.same_result(got, want, floats)
    assert len(next(iter(got.values()))) > 0
    assert df_uploads == uploads == 0
