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

    from daft_tpu_torch.device.residency import manager

    lineitem, orders, dims = _small_tpch(cs)
    frames = cs.q5_frames(lineitem, orders, dims)
    want = cs.q5_oracle(lineitem, orders, dims)
    manager().clear()  # another test's tables of equal content would rebind
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


@pytest.fixture(scope="module")
def scan_files(tmp_path_factory):
    """The scan phase's tables at the small size, written and read back by
    chip_smoke.py's own functions on the CPU (row groups of 16,384 rows, so
    the zone maps have something to prune)."""
    import contextlib

    import daft_tpu_torch as dt
    from daft_tpu_torch.io import _parquet_format as pf

    sys.path.insert(0, REPO)
    import chip_smoke as cs

    @contextlib.contextmanager
    def cpu_ctx():
        with dt.execution_config_ctx(device="cpu", device_mode="on") as cfg:
            yield cfg

    mp = pytest.MonkeyPatch()
    mp.setattr(cs, "dt_ctx", cpu_ctx)
    mp.setattr(pf, "ROW_GROUP_ROWS", 1 << 14)
    tables = _small_tpch(cs)
    frames = cs.scan_tables(*tables)
    root = str(tmp_path_factory.mktemp("scan_phase"))
    dirs = cs.scan_write(frames, root, "cpu")
    cs.scan_read_back(frames, dirs, "cpu")
    cs.scan_codec_check(dirs)
    yield cs, tables, frames, dirs
    mp.undo()


def test_scan_tables_hold_every_column_the_cells_read(scan_files):
    """scan_tables keeps every column tpch_sf1 draws, the code columns as
    the strings the cells' own frames hold and dates as dates: each cell's
    in-memory frame is a column subset of the scan phase's tables, value
    for value."""
    import daft_tpu_torch as dt

    cs, (lineitem, orders, dims), frames, _dirs = scan_files
    assert set(frames["lineitem"].column_names) == set(lineitem)
    assert set(frames["orders"].column_names) == set(orders)
    for name in ("part", "customer", "supplier", "nation", "region"):
        assert set(frames[name].column_names) == set(dims[name]), name
    df_l, df_o = cs.q12_frames(lineitem, orders)
    tails = cs.tails_frames(lineitem, orders, dims)
    q5 = cs.q5_frames(lineitem, orders, dims)
    cells = [(cs.q1_frame(lineitem), "lineitem"), (df_l, "lineitem"), (df_o, "orders"),
             (q5["orders"], "orders"), (q5["supplier"], "supplier")] + \
        [(tails[t], t) for t in ("lineitem", "orders", "part", "customer", "nation")]
    for df, name in cells:
        cell = cs._frame_batch(df)
        table = cs._frame_batch(frames[name])
        for c in cell.column_names():
            assert cs._same_series(cell.get_column(c), table.get_column(c)), (name, c)
    assert isinstance(frames["lineitem"], dt.DataFrame)


def _cell_results(cs, dt, lineitem, orders, dims):
    """Each cell's in-memory result on the CPU, as main() collects them."""
    df_l, df_o = cs.q12_frames(lineitem, orders)
    tails = cs.tails_frames(lineitem, orders, dims)
    q6 = dt.from_pydict({**{c: lineitem[c] for c in ("l_quantity", "l_extendedprice",
                                                     "l_discount")},
                         "l_shipdate": lineitem["l_shipdate"].astype("datetime64[D]")})
    with dt.execution_config_ctx(device="cpu"):
        return {"q1": cs.q1_query(cs.q1_frame(lineitem)).to_pydict(),
                "q6": cs.q6_query(q6).to_pydict(),
                "q12": cs.q12_query(df_l, df_o).to_pydict(),
                "q14": cs.q14_query(tails).to_pydict(),
                "q3": cs.q3_query(tails).to_pydict(),
                "q5": cs.q5_query(cs.q5_frames(lineitem, orders, dims)).to_pydict()}


def test_scan_cells_equal_their_in_memory_cells(scan_files):
    """The scan phase's queries over the written files (q5 in SQL through
    current_session() with its dims from CSV) equal the in-memory cells'
    results on the CPU; a second run rebinds every plane and uploads
    nothing; over morsels of 4,096 rows q3's join TopN takes the host plan
    with the single-fact-batch reason; q6 over the copy sorted by
    l_shipdate prunes row groups."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.ops import counters
    from daft_tpu_torch.plan import logical as lp

    cs, (lineitem, orders, dims), frames, dirs = scan_files
    cells = _cell_results(cs, dt, lineitem, orders, dims)

    def pq(name):
        return dt.read_parquet(dirs[name])

    sess = dt.current_session()
    for name in cs.SCAN_CSV:
        sess.create_temp_table(name, dt.read_csv(dirs[f"{name}_csv"]))
    sess.create_temp_table("lineitem", pq("lineitem"))
    sess.create_temp_table("orders", pq("orders"))
    queries = {
        "q1": (lambda: cs.q1_query(pq("lineitem")), cs.Q1_FLOATS),
        "q6": (lambda: cs.q6_query(pq("lineitem")), ("revenue",)),
        "q12": (lambda: cs.q12_query(pq("lineitem"), pq("orders")), ()),
        "q14": (lambda: cs.q14_query({"lineitem": pq("lineitem"), "part": pq("part")}),
                ("promo_revenue",)),
        "q5": (lambda: dt.sql(cs.TPCH_SQL[5]), ("revenue",)),
    }
    try:
        with dt.execution_config_ctx(device="cpu", morsel_size_rows=4096,
                                     batch_latency_ms=cs.SCAN_FLUSH_MS):
            for name, (query, floats) in queries.items():
                manager().clear()
                counters.reset()
                got = query().to_pydict()
                assert counters.scan_tasks >= 1 and counters.device_fallbacks == 0, name
                assert cs.same_result(got, cells[name], floats), name
                counters.reset()
                assert cs.count_uploads(lambda: query().to_pydict()) == 0, name
                assert counters.hbm_stable_rehits > 0, name
            counters.reset()
            got = cs.q3_query({"lineitem": pq("lineitem"), "orders": pq("orders"),
                               "customer": pq("customer")}).to_pydict()
            assert counters.device_fallbacks == 1 and counters.device_topn_runs == 0
            assert any("single fact batch" in r for r in counters.rejections)
            assert cs.same_result(got, cells["q3"], ("revenue",))
            batch = cs._frame_batch(frames["lineitem"])
            order = np.argsort(lineitem["l_shipdate"], kind="stable")
            path = dt.DataFrame(lp.InMemorySource(batch.schema, [dt.MicroPartition(
                batch.schema, [batch.take(order)])])).write_parquet(
                os.path.join(os.path.dirname(dirs["lineitem"]), "sorted")).to_pydict()["path"][0]
            counters.reset()
            got = cs.q6_query(dt.read_parquet(path)).to_pydict()
            assert counters.scan_row_groups_pruned > 0
            assert cs.same_result(got, cells["q6"], ("revenue",))
    finally:
        for name in ("lineitem", "orders") + cs.SCAN_CSV:
            sess.drop_temp_table(name)


@pytest.mark.parametrize("cell", ["q1", "q3"])
def test_scan_kernel_cases_get_the_runs_inputs(scan_files, monkeypatch, cell):
    """chip_smoke.py's kernel cases at the file-fed cells' shapes feed the
    kernels what the first morsel's dispatch passes them: scan q1's K1, K2
    and K7 at cap 8, and scan q3's fallback's K4 build over the orders
    before its date, K4 probe of the morsel's keys, K1, K2 and K7 (on the
    CPU, at a small size: morsels of 4,096 rows), tensor for tensor."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.ops import probe_kernels as pk
    from daft_tpu_torch.ops import segment_kernels as sk

    cs, (lineitem, orders, dims), _frames, dirs = scan_files
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
    with dt.execution_config_ctx(device="cpu", morsel_size_rows=4096,
                                 batch_latency_ms=cs.SCAN_FLUSH_MS):
        if cell == "q1":
            cs.q1_query(dt.read_parquet(dirs["lineitem"])).to_pydict()
        else:
            cs.q3_query({name: dt.read_parquet(dirs[name])
                         for name in ("lineitem", "orders", "customer")}).to_pydict()
    monkeypatch.setattr(cs, "SCAN_MORSEL_ROWS", 4096)
    want = cs.scan_inputs(lineitem, orders, dims, torch.device("cpu"))[cell]

    def same(a, b):
        return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                        for x, y in zip(a, b))
    (k1_planes, k1_codes, k1_cap) = seen["segment_sum_planes"][0]
    assert k1_cap == want["cap"] and torch.equal(k1_codes, want["codes"])
    assert same(k1_planes, want["planes"])
    (k2_planes, k2_codes, _cap, k2_op) = seen["segment_extreme_planes"][0]
    assert k2_op == "min" and same(k2_planes, want["first"])
    assert torch.equal(k2_codes, want["codes"])
    (k7_planes, k7_codes, _cap) = seen["segment_sum_float_planes"][0]
    assert same(k7_planes, want["floats"]) and torch.equal(k7_codes, want["codes"])
    if cell == "q1":
        assert want["cap"] == cs.Q1_CAP
        assert len(seen["segment_sum_planes"]) > 1  # a dispatch per morsel
    else:
        ((keys, valid, slots),) = seen["build_probe_table"]
        assert torch.equal(keys, want["dim_keys"]) and bool(valid.all())
        assert slots == pk.probe_table_slots(len(want["dim_keys"]))
        p_keys, p_valid, table = seen["hash_probe_index"][0]
        assert torch.equal(p_keys, want["keys"]) and torch.equal(p_valid, want["valid"])
        got = pk.hash_probe_index_plain(p_keys, p_valid, table)
        n = want["index"].numel()
        assert torch.equal(got[:n], want["index"]) and bool((got[n:] == -1).all())


AI_SMALL = {"vocab": 2048, "dim": 48, "layers": 2, "heads": 4, "max_len": 128}


@pytest.fixture
def ai_small(monkeypatch):
    """chip_smoke.py's ai cells at a small size on the CPU: 2,048 texts over
    a 2,000-word vocabulary in morsels of 512, a seeded model of small
    widths under its own name. Returns (cs, texts, frame, model)."""
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs
    from daft_tpu_torch.device.residency import manager

    model = "chip-smoke-ai-small"
    cs.install_ai_model(model, AI_SMALL)
    texts = cs.ai_corpus(cs.SEED, 2048, cs.ai_words(2000))
    manager().clear()
    return cs, texts, cs.ai_frame(texts), model


def test_ai_corpus_is_seeded_and_shaped(ai_small):
    cs, texts, frame, _model = ai_small
    again = cs.ai_corpus(cs.SEED, 2048, cs.ai_words(2000))
    assert again == texts
    words = [len(t.split()) for t in texts if t]
    assert min(words) >= 8 and max(words) <= 64
    assert 0 < sum(t is None for t in texts) < 60 and 0 < sum(t == "" for t in texts) < 40
    assert len(set(cs.ai_words())) == cs.AI_WORDS
    part = frame._plan.partitions[0]
    assert [b.num_rows for b in part.batches] == [512] * 4


def test_ai_cells_match_their_oracles(ai_small):
    """embed: nulls where the text is null, unit rows; classify's counts
    equal the oracle's argmax of the embed cell's own embeddings against
    the label matrix; the fused UDF -> sum equals its oracle and fuses."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.ai import torch_provider as tp
    from daft_tpu_torch.ops import counters

    cs, texts, frame, model = ai_small
    with dt.execution_config_ctx(device="cpu", device_mode="on"):
        counters.reset()
        out = cs.ai_embed_query(frame, model).to_pydict()
        assert counters.device_udf_dispatches == 2 < counters.coalesce_morsels_in == 4
        got = cs.ai_classify_query(frame, model).to_pydict()
    assert [v is None for v in out["e"]] == [t is None for t in texts]
    e = np.asarray([v for v in out["e"] if v is not None], dtype=np.float32)
    assert np.abs(np.linalg.norm(e, axis=1) - 1).max() <= 1e-5
    want, labels, _close = cs.ai_classify_oracle(
        out["e"], tp.label_matrix(tp.embedder_for(model), cs.AI_LABELS))
    assert got == want and got["label"][-1] is None
    assert len(labels) == len(texts)

    rng = np.random.default_rng(5)
    price = np.round(rng.uniform(900, 100_000, 5000), 2)
    score, w = cs.ai_score_func()
    frame = dt.from_pydict({"l_extendedprice": price, "l_quantity": np.ones(5000)})
    with dt.execution_config_ctx(device="cpu", device_mode="on"):
        counters.reset()
        fused = cs.ai_fused_query(frame, score).to_pydict()
        assert counters.device_udf_runs == 0 and counters.device_stage_batches == 1
        assert cs.count_uploads(lambda: cs.ai_fused_query(frame, score).to_pydict()) == 0
    assert cs.same_result(fused, cs.ai_fused_oracle(price, w), ("s",))


def test_ai_kernel_cases_get_the_runs_inputs(ai_small, monkeypatch):
    """chip_smoke.py's kernel cases at the classify cell's inputs feed K1 and
    K2 what the classify run's grouped stage passes them: its label codes
    (first occurrence, a null its own code) at its cap, the counted rows'
    plane and the first-row index, tensor for tensor."""
    import daft_tpu_torch as dt
    from daft_tpu_torch import col
    from daft_tpu_torch.functions.ai import classify_text
    from daft_tpu_torch.ops import segment_kernels as sk

    cs, texts, frame, model = ai_small
    seen = {}
    for name in ("segment_sum_planes", "segment_extreme_planes"):
        def record(*args, _name=name, _fn=getattr(sk, name)):
            seen.setdefault(_name, []).append(args)
            return _fn(*args)
        monkeypatch.setattr(sk, name, record)
    with dt.execution_config_ctx(device="cpu", device_mode="on"):
        cs.ai_classify_query(frame, model).to_pydict()
        labels = frame.select(classify_text(col("text"), cs.AI_LABELS, provider="torch",
                                            model=model).alias("l")).to_pydict()["l"]
    want = cs.ai_classify_inputs(labels, torch.device("cpu"))
    assert want["groups"] == len(set(labels)) and want["cap"] == 8

    def same(a, b):
        return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                        for x, y in zip(a, b))
    ((k1_planes, k1_codes, k1_cap),) = seen["segment_sum_planes"]
    assert k1_cap == want["cap"] and torch.equal(k1_codes, want["codes"])
    assert same(k1_planes, want["planes"])
    ((k2_planes, k2_codes, _cap, k2_op),) = seen["segment_extreme_planes"]
    assert k2_op == "min" and same(k2_planes, want["first"])
    assert torch.equal(k2_codes, want["codes"])


def test_pipeline_phase_cells_on_the_cpu(scan_files, monkeypatch):
    """chip_smoke.py's pipeline phase on the CPU at a small size: each cell
    (file-fed q1, q6, q12, q14, q3, q5 in SQL over CSV dims; in-memory
    supplier, q1, q12) in turns off, on, on, off through pipeline_cell,
    equal to its in-memory result in both modes, its kernels and device
    feeds called from the threads the plan puts them on, no stage thread or
    pin left after a run; q5's host joins give the same rows per batch and
    through the build-once probe. Morsels of 4,096 rows, so the files are
    read as several morsels (q3's TopN takes the host plan)."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.execution.pipeline import STAGE_THREAD_NAME
    from daft_tpu_torch.plan import physical as pp

    cs, (lineitem, orders, dims), _frames, dirs = scan_files
    cells = _cell_results(cs, dt, lineitem, orders, dims)
    with dt.execution_config_ctx(device="cpu"):
        cells["supplier"] = cs.supplier_query(cs.supplier_frame(lineitem)).to_pydict()
    monkeypatch.setattr(cs, "PIPELINE_ROUNDS", 1)
    sess = dt.current_session()
    sess.create_temp_table("lineitem", dt.read_parquet(dirs["lineitem"]))
    sess.create_temp_table("orders", dt.read_parquet(dirs["orders"]))
    for name in cs.SCAN_CSV:
        sess.create_temp_table(name, dt.read_csv(dirs[f"{name}_csv"]))
    seen = {}
    try:
        with dt.execution_config_ctx(morsel_size_rows=4096, pipeline_mode="force"):
            for label, query, key, floats, counter, rounds, cold in \
                    cs.pipeline_cells(lineitem, orders, dirs):
                out = cs.pipeline_cell(label, query, cells[key], floats, counter, "cpu",
                                       rounds, cold, profile=key == "q3")
                assert len(out["off"]) + len(out["cold"]) // 2 == 2 * rounds, label
                seen[label] = cs.expected_launch_threads(pp.translate(query().optimized_plan()))
                if key == "q5":
                    joins = cs.host_join_times(label, query, "cpu")
                    assert joins["joins"] >= 3 and joins["left_batches"] >= joins["joins"]
            assert out["launches"] is not None and out["cold"] == {}
    finally:
        for name in ("lineitem", "orders") + cs.SCAN_CSV:
            sess.drop_temp_table(name)
    assert len(seen) == 9
    # the in-memory cells' device stages sit under a stage node
    assert seen["pipeline supplier"] == {STAGE_THREAD_NAME}
    assert seen["pipeline scan q6"] == {STAGE_THREAD_NAME}
