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
    sess = dt.current_session()
    sess.create_temp_table("lineitem", dt.read_parquet(dirs["lineitem"]))
    sess.create_temp_table("orders", dt.read_parquet(dirs["orders"]))
    for name in cs.SCAN_CSV:
        sess.create_temp_table(name, dt.read_csv(dirs[f"{name}_csv"]))
    seen = {}
    try:
        with dt.execution_config_ctx(morsel_size_rows=4096, pipeline_mode="force"):
            for label, query, key, floats, counter, modes, cold in \
                    cs.pipeline_cells(lineitem, orders, dirs):
                out = cs.pipeline_cell(label, query, cells[key], floats, counter, "cpu",
                                       modes, cold, profile=key == "q3")
                assert len(out["off"]) + len(out["cold"]) // 2 == modes.count("off"), label
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


def test_ooc_phase_cells_on_the_cpu(scan_files, monkeypatch, tmp_path):
    """chip_smoke.py's ooc phase on the CPU at a small size: the nine
    benchmark queries (imports rewritten to the port) over the Parquet
    lineitem (a), under the budget with device_mode="off" (b, equal to (a)
    exactly, spilling) and "on" (c, equal by the exactness rule, its device
    stages doing what the unbudgeted card run's do, its fallbacks q3's and
    q10's single-fact-batch TopN alone); the external sort's sync and
    async legs equal to the in-memory sort; q4's semi join and the inner
    join Grace-partitioned and equal to their unbudgeted runs. The phase's
    own checks raise on any difference; the spill directory ends empty."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.memory import manager
    from daft_tpu_torch.ops import counters

    cs, _tables, frames, dirs = scan_files
    queries = cs.tpch_port_queries()
    assert sorted(queries) == list(range(1, 23))
    tables = cs.ooc_tables(frames, dirs["lineitem"])
    spill_dir = str(tmp_path)
    with dt.execution_config_ctx(morsel_size_rows=16_384):
        paths = cs.ooc_queries(queries, tables, "cpu", cs.budget_of(frames, 0.10), spill_dir)
        assert sorted(paths) == sorted(f"ooc_q{q}" for q in cs.OOC_QUERIES)
        assert counters.device_join_batches > 0 or counters.device_grouped_batches > 0
        cs.ooc_sort(dirs["lineitem"], 1 << 20, "cpu", spill_dir)
        paths = cs.ooc_joins(queries, tables, 200_000, "cpu", spill_dir)
    assert list(paths) == ["ooc_q4_grace"]
    assert os.listdir(spill_dir) == [] and manager().tracked_bytes() == 0
    assert cs.budget_of(frames, 0.01) == max(int(cs.frames_bytes(frames) * 0.01), 1 << 20)


@pytest.mark.parametrize("q", [1, 3])
def test_ooc_phase_fails_when_a_budgeted_stage_gives_way(scan_files, monkeypatch, tmp_path,
                                                          q):
    """The ooc phase's (c) check holds each query's card run to its
    fallbacks: a device stage that feeds one batch and then gives way to
    the host only under the budget (its result still right, from the host
    rerun) fails the phase."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.config import execution_config
    from daft_tpu_torch.execution import executor
    from daft_tpu_torch.ops.grouped_stage import DeviceFallback

    cs, _tables, frames, dirs = scan_files
    feed_stream = executor._feed_stream

    def gives_way(stream, feed, cfg):
        if execution_config().memory_limit_bytes <= 0:
            return feed_stream(stream, feed, cfg)
        feed(next(b for p in stream for b in p.batches if b.num_rows))
        raise DeviceFallback("gave way under the budget")

    monkeypatch.setattr(executor, "_feed_stream", gives_way)
    monkeypatch.setattr(cs, "OOC_QUERIES", (q,))
    queries = cs.tpch_port_queries()
    tables = cs.ooc_tables(frames, dirs["lineitem"])
    with dt.execution_config_ctx(morsel_size_rows=16_384):
        with pytest.raises(cs.SmokeFailure, match=f"ooc q{q} \\(under the budget on the "
                                                  "card\\): fallbacks"):
            cs.ooc_queries(queries, tables, "cpu", 20_000, str(tmp_path))


def test_ooc_fallback_check():
    """ooc_check_fallbacks: none for q1, exactly one single-fact-batch
    fallback for q3, and the query's device counters moved."""
    import chip_smoke as cs

    moved = {"device_grouped_batches": 1, "device_join_batches": 1}
    cs.ooc_check_fallbacks(1, dict(moved, device_fallbacks=0), [], "t")
    one = ["join topn: device fallback: device TopN path requires a single fact batch"]
    cs.ooc_check_fallbacks(3, dict(moved, device_fallbacks=1), one, "t")
    for q, fb, reasons in ((1, 1, ["grouped agg: device fallback: DeviceFallback"]),
                           (3, 0, []), (3, 2, one * 2),
                           (3, 1, ["join topn: device fallback: other"])):
        with pytest.raises(cs.SmokeFailure, match="fallbacks"):
            cs.ooc_check_fallbacks(q, dict(moved, device_fallbacks=fb), reasons, "t")
    with pytest.raises(cs.SmokeFailure, match="did not move"):
        cs.ooc_check_fallbacks(3, dict(moved, device_fallbacks=1, device_join_batches=0),
                               one, "t")


def test_window_cells_on_the_cpu(scan_files):
    """chip_smoke.py's window cells on the CPU at a small size: W1 equal
    to its numpy oracle (row_number, the running sum) and, under a budget
    that Grace-partitions it, to its unbudgeted run keyed by (l_orderkey,
    l_linenumber); W2 as a DataFrame and in SQL equal to each other, to the
    device_mode="off" run and to its numpy oracle, its aggregate on the
    device join stage."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch.memory import manager
    from daft_tpu_torch.ops import counters

    cs, (lineitem, _orders, dims), frames, _dirs = scan_files
    df = cs.w1_frame(lineitem)
    with dt.execution_config_ctx(device="cpu"):
        want = cs.w1_keyed(cs.w1_query(df).collect()._result)
        counters.reset()
        with dt.execution_config_ctx(memory_limit_bytes=1 << 20):
            got = cs.w1_keyed(cs.w1_query(df).collect()._result)
    assert counters.spill_files >= 32 and manager().tracked_bytes() == 0
    oracle = cs.w1_oracle(lineitem)
    assert np.array_equal(want["rn"], oracle["rn"])
    assert np.array_equal(want["run_qty"], oracle["run_qty"])
    for c in ("rn", "rk", "drk", "run_qty", "prev_valid", "l_suppkey"):
        assert np.array_equal(got[c], want[c]), c
    np.testing.assert_allclose(got["share"], want["share"], rtol=1e-5)
    t = {"lineitem": frames["lineitem"], "part": frames["part"]}
    oracle = cs.w2_oracle(lineitem, dims)
    sess = dt.current_session()
    sess.create_temp_table("lineitem", t["lineitem"])
    sess.create_temp_table("part", t["part"])
    try:
        with dt.execution_config_ctx(device="cpu"):
            counters.reset()
            frame = cs.w2_query(t).to_pydict()
            assert counters.device_join_batches == 1
            sql = dt.sql(cs.W2_SQL).to_pydict()
            with dt.execution_config_ctx(device_mode="off"):
                off = cs.w2_query(t).to_pydict()
    finally:
        sess.drop_temp_table("lineitem")
        sess.drop_temp_table("part")
    assert len(frame["p_type"]) == 100
    for a, b in ((frame, sql), (frame, off), (frame, oracle)):
        assert cs.same_result(a, b, cs.W2_FLOATS)


def test_w2_kernel_cases_get_the_runs_inputs(monkeypatch):
    """chip_smoke.py's kernel cases at W2's shapes (``w2_inputs``) feed K4
    (the build over part's keys, the probe of every l_partkey), K1, K2 and
    K7 what W2's own device join run passes them (on the CPU, at a small
    size), tensor for tensor; W2's cap is the brand x type dictionary
    product's."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.device.residency import manager
    from daft_tpu_torch.ops import grouped_stage
    from daft_tpu_torch.ops import probe_kernels as pk
    from daft_tpu_torch.ops import segment_kernels as sk
    from daft_tpu_torch.ops.stage import pad_bucket

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, orders, dims = _small_tpch(cs)
    frames = cs.scan_tables(lineitem, orders, dims)
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
        cs.w2_query({"lineitem": frames["lineitem"], "part": frames["part"]}).to_pydict()
    monkeypatch.setattr(cs, "BUCKET", pad_bucket(len(lineitem["l_orderkey"])))
    want = cs.w2_inputs(lineitem, dims, torch.device("cpu"))

    def same(a, b):
        return len(a) == len(b) and all(x.dtype == y.dtype and torch.equal(x, y)
                                        for x, y in zip(a, b))
    ((k1_planes, k1_codes, k1_cap),) = seen["segment_sum_planes"]
    assert k1_cap == cs.W2_CAP == grouped_stage._pad_groups(len(cs.P_BRANDS) * len(cs.P_TYPES))
    assert torch.equal(k1_codes, want["codes"]) and same(k1_planes, want["planes"])
    ((k2_planes, _c, _cap, k2_op),) = seen["segment_extreme_planes"]
    assert k2_op == "min" and same(k2_planes, want["first"])
    ((k7_planes, _c, _cap),) = seen["segment_sum_float_planes"]
    assert same(k7_planes, want["revenue"])
    ((keys, valid, slots),) = seen["build_probe_table"]
    assert torch.equal(keys, want["dim_keys"]) and bool(valid.all())
    assert slots == pk.probe_table_slots(len(want["dim_keys"]))
    ((p_keys, p_valid, _table),) = seen["hash_probe_index"]
    assert torch.equal(p_keys, want["keys"]) and torch.equal(p_valid, want["valid"])


def _obs_tables(cs, lineitem, orders, dims):
    df_l, df_o = cs.q12_frames(lineitem, orders)
    return {"q1": cs.q1_frame(lineitem), "q6": cs.q6_frame(lineitem),
            "q12": {"lineitem": df_l, "orders": df_o},
            "tails": cs.tails_frames(lineitem, orders, dims)}


def test_obs_phase_on_the_cpu(scan_files, monkeypatch, capsys):
    """chip_smoke.py's obs phase on the CPU at a small size (the kernels'
    plain versions, counted as plain calls): EXPLAIN ANALYZE of q1, q12, q3
    and the file-fed q6 equal to their unobserved runs, counters count for
    count, rows out; q12's trace with its three device spans inside the
    run; the subscriber's event order; the four overhead settings, the
    flight recorder off only under "bare" and back on after."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.observability import flight

    cs, (lineitem, orders, dims), _frames, dirs = scan_files
    monkeypatch.setattr(cs, "OBS_KERNEL_PREFIX", "plain_")
    monkeypatch.setattr(cs, "OBS_ROUNDS", 2)
    with dt.execution_config_ctx(morsel_size_rows=16_384, pipeline_mode="force"):
        paths = cs.phase_obs(_obs_tables(cs, lineitem, orders, dims), dirs["lineitem"], "cpu")
    out = capsys.readouterr().out
    assert list(paths) == ["obs"]
    assert "obs scan q6: stalls" in out and "obs q12 trace:" in out
    for setting in cs.OBS_SETTINGS:
        assert f"{setting}: q1 " in out
    assert flight.recorder() is not None


def test_obs_phase_refuses_an_observation_that_moves_the_counters(scan_files, monkeypatch):
    """A stand-in device path that feeds one more batch when a stats
    collector is active: the obs phase's count-for-count check refuses it."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.execution import executor
    from daft_tpu_torch.observability.runtime_stats import current_collector
    from daft_tpu_torch.ops import counters

    cs, (lineitem, _orders, _dims), _frames, _dirs = scan_files
    feed_stream = executor._feed_stream

    def observed_differs(stream, feed, cfg):
        if current_collector() is not None:
            counters.bump("device_grouped_batches")
        return feed_stream(stream, feed, cfg)

    monkeypatch.setattr(executor, "_feed_stream", observed_differs)
    monkeypatch.setattr(cs, "OBS_KERNEL_PREFIX", "plain_")
    df = cs.q1_frame(lineitem)
    with dt.execution_config_ctx(morsel_size_rows=16_384):
        with pytest.raises(cs.SmokeFailure, match="obs q1: the observed run's engine counters "
                                                  "differ"):
            cs.obs_cell("q1", lambda: cs.q1_query(df), cs.Q1_FLOATS, "cpu",
                        "device_grouped_batches")


def test_obs_trace_check_refuses_a_trace_without_h2d(scan_files, monkeypatch):
    """obs_profile refuses a trace whose device.h2d spans are missing."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.observability import runtime_stats

    cs, (lineitem, orders, _dims), _frames, _dirs = scan_files
    real = runtime_stats.profile_span

    def no_h2d(name, cat, **args):
        return real("device.other" if name == "device.h2d" else name, cat, **args)

    import importlib

    for mod in ("daft_tpu_torch.ops.grouped_stage", "daft_tpu_torch.ops.device_join",
                "daft_tpu_torch.ops.stage"):
        monkeypatch.setattr(importlib.import_module(mod), "profile_span", no_h2d)
    df_l, df_o = cs.q12_frames(lineitem, orders)
    with dt.execution_config_ctx(morsel_size_rows=16_384):
        with pytest.raises(cs.SmokeFailure, match="no device.h2d span"):
            cs.obs_profile("q12", lambda: cs.q12_query(df_l, df_o), "cpu")


def _auto_on_the_cpu(cs, monkeypatch):
    """chip_smoke.py's auto phase pointed at the CPU: the executor's CPU gate
    patched open, the link terms pinned (a CPU device never calibrates), the
    rates measured at small shapes."""
    from daft_tpu_torch.execution import executor
    from daft_tpu_torch.ops import costmodel

    monkeypatch.setattr(cs, "AUTO_DEVICE", "cpu")
    monkeypatch.setattr(cs, "AUTO_MEASURE_ROWS", 4096)
    monkeypatch.setattr(cs, "AUTO_UDF_ROWS", 1)
    monkeypatch.setattr(cs, "AUTO_HOST_UDF_ROWS", 1)
    monkeypatch.setattr(executor, "_auto_gate", lambda cfg: None)
    for env, v in (("DAFT_TPU_COST_RTT", "2.7e-5"), ("DAFT_TPU_COST_H2D", "1.1e10"),
                   ("DAFT_TPU_COST_D2H", "7.4e9")):
        monkeypatch.setenv(env, v)
    costmodel.reset_calibration()


def test_auto_phase_on_the_cpu(scan_files, monkeypatch, capsys):
    """chip_smoke.py's auto phase on the CPU at a small size: the calibration
    and every rate printed, the nine ooc queries over the Parquet lineitem
    and the in-memory supplier, q1, q12 and partkey cells each run under
    "auto" (a first run, then the counted warm run), held to their "off"
    results by the phase's own checks, every verdict printed with both
    totals and its margin."""
    import re

    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import costmodel

    cs, (lineitem, orders, _dims), frames, dirs = scan_files
    _auto_on_the_cpu(cs, monkeypatch)
    try:
        with dt.execution_config_ctx(morsel_size_rows=16_384, device_min_rows=1):
            paths = cs.phase_auto(frames, dirs["lineitem"], "cpu",
                                  cs.auto_runs(lineitem, orders))
    finally:
        costmodel.reset_calibration()
    out = capsys.readouterr().out
    assert sorted(paths) == sorted([f"auto ooc q{q}" for q in cs.OOC_QUERIES]
                                   + [f"auto {c}" for c in cs.AUTO_MEMORY_CELLS])
    assert "auto calibration" in out
    for name in costmodel.RATES:
        assert f"auto rate {name} " in out
    for label in [f"ooc q{q}" for q in cs.OOC_QUERIES] + list(cs.AUTO_MEMORY_CELLS):
        assert f"auto {label} (warm): " in out and f"auto {label}: warm " in out
    # priced verdicts carry both totals and the margin
    assert re.search(r"-> (device|host); device [0-9.]+ ms, host [0-9.]+ ms, margin "
                     r"[0-9.]+x", out)


def test_auto_cell_refuses_a_result_that_differs_from_off(scan_files, monkeypatch):
    """auto_cell holds the auto run to the "off" result: a stand-in run that
    drifts under "auto" fails the phase."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.config import execution_config

    cs, (lineitem, _orders, _dims), _frames, _dirs = scan_files
    _auto_on_the_cpu(cs, monkeypatch)
    df = cs.supplier_frame(lineitem)

    def run():
        got = cs.supplier_query(df).to_pydict()
        if execution_config().device_mode == "auto":
            got["n_lines"][0] += 1
        return got

    with dt.execution_config_ctx(device_min_rows=1):
        with pytest.raises(cs.SmokeFailure, match="auto supplier: the first run differs"):
            cs.auto_cell("supplier", run, (), "cpu")


def test_auto_ai_embed_on_the_cpu(ai_small, monkeypatch, capsys):
    """The ai embed cell under "auto" (the CPU gate patched open): its one
    device-UDF verdict printed, the result within 1e-5 of the "on" run and
    of the CPU's first 256 rows."""
    import daft_tpu_torch as dt
    from daft_tpu_torch.ops import costmodel

    cs, _texts, frame, model = ai_small
    _auto_on_the_cpu(cs, monkeypatch)
    monkeypatch.setattr(cs, "AI_MODEL", model)
    monkeypatch.setattr(cs.ai_embed_query, "__defaults__", (model, cs.AI_BATCH))
    try:
        with dt.execution_config_ctx(device="cpu", device_mode="on"):
            out = cs.ai_embed_query(frame).to_pydict()
        with dt.execution_config_ctx(device="cpu", device_mode="off"):
            head = cs.ai_embed_query(cs.ai_frame(_texts[:256], 256)).to_pydict()
        with dt.execution_config_ctx(device_min_rows=1):
            paths = cs.auto_ai_embed(frame, out, head, "cpu")
    finally:
        costmodel.reset_calibration()
    assert list(paths) == ["auto ai embed"]
    assert "auto ai embed (warm): udf (" in capsys.readouterr().out


def _cpu_cells(monkeypatch):
    """chip_smoke.py with its cells on the CPU: the cells' config on
    device="cpu", the kernels' plain calls counted as their launches, no
    profile (torch.profiler's card capture)."""
    import contextlib

    import daft_tpu_torch as dt

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    @contextlib.contextmanager
    def cpu_ctx():
        with dt.execution_config_ctx(device="cpu", device_mode="on") as cfg:
            yield cfg

    monkeypatch.setattr(cs, "dt_ctx", cpu_ctx)
    monkeypatch.setattr(cs, "CELL_KERNEL_PREFIX", "plain_")
    monkeypatch.setattr(cs, "phase_profile", lambda *a, **k: None)
    return cs


def test_functions_phase_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's functions phase on the CPU at a small size: the
    filter and the eight function aggregates plan as one DeviceGroupedAgg,
    equal to the "off" run and to the numpy oracle, K1, K2, K3 and K7's
    plain versions called, and the oracle itself equal to the port's host
    path."""
    import daft_tpu_torch as dt

    cs = _cpu_cells(monkeypatch)
    lineitem, _orders, _dims = _small_tpch(cs)
    paths = cs.phase_functions(lineitem, "cpu")
    launches = paths["functions"]
    assert all(launches[k] > 0 for k in cs.FUNCTIONS_KERNELS), launches
    out = capsys.readouterr().out
    assert "functions: 6 result rows, equal to the host path and the numpy oracle" in out
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        host = cs.functions_query(cs.functions_frame(lineitem)).to_pydict()
    assert cs.same_result(host, cs.functions_oracle(lineitem), cs.FUNCTIONS_FLOATS)


def test_functions_phase_fails_on_a_wrong_oracle(monkeypatch):
    cs = _cpu_cells(monkeypatch)
    lineitem, _orders, _dims = _small_tpch(cs)
    oracle = cs.functions_oracle

    def off_by_one(cols):
        out = oracle(cols)
        out["part_k"] = [v + 1 for v in out["part_k"]]
        return out

    monkeypatch.setattr(cs, "functions_oracle", off_by_one)
    with pytest.raises(cs.SmokeFailure, match="numpy oracle"):
        cs.phase_functions(lineitem, "cpu")


def _tpcds_sf001(monkeypatch, cs):
    """The stages and fallbacks of the tpcds phase's cold runs at SF 0.01:
    SF1's, except that q48, q88 and q96 take a dim larger than
    store_sales' 28,800 rows as the capture's fact and fall back (q88 in
    each of its eight time windows), and q51, q73, q79 and q89's joined
    groups stay under the join run's ceiling, so they ride the device
    join."""
    unique = "dim keys are not unique"
    rides = {**cs.TPCDS_RIDES, 48: "host", 88: "host", 96: "host",
             51: "device join", 73: "device join", 79: "device join", 89: "device join"}
    monkeypatch.setattr(cs, "TPCDS_RIDES", rides)
    monkeypatch.setattr(cs, "TPCDS_FALLBACKS", {48: (1, unique), 88: (8, unique),
                                                96: (1, unique)})


def test_tpcds_phase_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's tpcds phase on the CPU at SF 0.01: all 25 queries,
    "on" equal to "off", each query on the stage, with the fallbacks and
    the launches, that the phase holds it to (at this size's maps), its
    times and launches printed, the star joins' K4 counted."""
    cs = _cpu_cells(monkeypatch)
    _tpcds_sf001(monkeypatch, cs)
    paths = cs.phase_tpcds(cs.tpcds_tables(0.01, 0), "cpu")
    out = capsys.readouterr().out
    for qn in cs.tpcds_port_queries():
        assert f"tpcds q{qn}: {cs.TPCDS_RIDES[qn]}; " in out
    for k in ("hash_probe_build", "hash_probe_index", "segment_sum_planes",
              "segment_extreme_planes", "segment_sum_float_planes"):
        assert paths["tpcds"][k] > 0, k
    assert "22 of 25 queries rode the card" in out
    assert out.count("fell back to the host") == 3
    assert "tpcds phase " in out


def test_tpcds_phase_fails_when_a_query_falls_back(monkeypatch):
    """A query that rides the device join at this size (q12) falls back at
    run time when the join run's ceiling is 1 group: the phase fails on
    it."""
    from daft_tpu_torch.ops import device_join

    cs = _cpu_cells(monkeypatch)
    _tpcds_sf001(monkeypatch, cs)
    monkeypatch.setattr(device_join.DeviceJoinGroupedRun, "max_segments", 1)
    with pytest.raises(cs.SmokeFailure, match="tpcds q12: "):
        cs.phase_tpcds(cs.tpcds_tables(0.01, 0), "cpu")


def test_tpcds_kernel_calls_on_the_cpu(monkeypatch):
    """The inputs the tpcds kernel cases take: q98's cold run calls K1, K2
    and K7 once each, builds K4 over item's and date_dim's keys and probes
    store_sales' keys into each table; the wrappers are restored after."""
    from daft_tpu_torch.ops import probe_kernels as pk
    from daft_tpu_torch.ops import segment_kernels as sk

    cs = _cpu_cells(monkeypatch)
    before = (sk.segment_sum_planes, pk.hash_probe_index)
    tables = cs.tpcds_tables(0.01, 0)
    named = cs.tpcds_kernel_calls(tables)
    assert (sk.segment_sum_planes, pk.hash_probe_index) == before
    for k in ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes"):
        assert len(named[k]) == 1, k
    (planes, codes, cap), out, _name = named["segment_sum_planes"][0]
    assert out.shape == (cap, len(planes)) and len(codes) >= len(
        tables["store_sales"]["ss_item_sk"])
    assert sorted(n for _a, _o, n in named["build_probe_table"]) == ["date_dim", "item"]
    assert sorted(n for _a, _o, n in named["hash_probe_index"]) == ["date_dim", "item"]
    for (keys, _valid, _table), _out, _name in named["hash_probe_index"]:
        assert len(keys) >= len(tables["store_sales"]["ss_item_sk"])


def test_tpcds_phase_fails_when_on_differs_from_off(monkeypatch):
    import daft_tpu_torch as dt

    cs = _cpu_cells(monkeypatch)
    _tpcds_sf001(monkeypatch, cs)
    queries = cs.tpcds_port_queries()

    def one_query(root=cs.HERE):
        q = queries[96]
        calls = []

        def wrong(t):
            calls.append(1)
            df = q(t)
            # the "on" run (the second call) gives one more
            return df.with_column("count", dt.col("count") + 1) if len(calls) == 2 else df
        return {**{n: queries[n] for n in queries if n != 96}, 96: wrong}

    monkeypatch.setattr(cs, "tpcds_port_queries", one_query)
    with pytest.raises(cs.SmokeFailure, match="q96: the \"on\" run differs"):
        cs.phase_tpcds(cs.tpcds_tables(0.01, 0), "cpu")


def test_native_phase_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's native phase on the CPU at a small size (TPC-DS at SF
    0.01), with every cell of ``--phase native``: the layers timed both
    ways with equal results, each host cell equal with the library and
    with the switch set, its warm times and the library's calls printed;
    the ``native`` line names the port's build and counts all 25 exports."""
    from daft_tpu_torch import native

    cs = _cpu_cells(monkeypatch)
    real = cs.tpcds_tables
    monkeypatch.setattr(cs, "tpcds_tables", lambda: real(0.01, 0))
    lineitem, orders, dims = _small_tpch(cs)
    cs.native_load("cpu")
    cs.phase_native(lineitem, orders, dims, "cpu", full=True)
    out = capsys.readouterr().out
    assert "native library " in out and os.environ.get(native.DISABLE_ENV) is None
    for label in ("make_groups l_suppkey", "grouped_reduce var l_extendedprice by l_suppkey",
                  "join_indices lineitem x orders", "ProbeTable probe lineitem (hashed)",
                  "selection vector"):
        assert f"native layer {label}" in out, label
    cells = ["supplier", "q1", "q3", "q12", "partkey", "file-fed q3", "file-fed q5 sql",
             "tpcds q65", "tpcds q51", "functions"] + [f"ooc q{q} B10" for q in cs.OOC_QUERIES]
    for label in cells:
        assert f"native {label}: warm library " in out, label
    summary = cs.native_summary()
    assert summary["path"].endswith(".so") and len(summary["calls"]) == 25
    assert summary["calls"]["factorize_i64"] > 0 and summary["calls"]["probe_fill"] > 0


def test_native_cell_refuses_a_plain_version_that_differs(monkeypatch):
    """A plain version that gives another answer fails the cell."""
    import numpy as np

    import daft_tpu_torch as dt
    from daft_tpu_torch import native

    cs = _cpu_cells(monkeypatch)
    real = native.plain_grouped_sum

    def off_by_one(*args):
        sums, cnt = real(*args)
        return sums + 1, cnt

    monkeypatch.setattr(native, "plain_grouped_sum", off_by_one)
    df = dt.from_pydict({"k": np.arange(100) % 7, "v": np.arange(100.0)})
    with pytest.raises(cs.SmokeFailure, match="native sums: the plain run differs"):
        cs.native_cell("sums", lambda: df.groupby("k").agg(dt.col("v").sum()).sort("k")
                       .to_pydict(), "cpu")


def test_temporal_phase_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's temporal phase on the CPU at a small size (row groups
    of 16,384 rows, so the file-fed T1 prunes): T1 as one fused region
    under a DeviceGroupedAgg with four K3 calls, in SQL and file-fed; T2's
    grouped cells over host functions; the windowed stddev / var; the plan
    surface; each equal to "off" and its numpy oracle. The kernel cases at
    T1's inputs need the card's events and are left out here."""
    from daft_tpu_torch.io import _parquet_format as pf

    cs = _cpu_cells(monkeypatch)
    monkeypatch.setattr(pf, "ROW_GROUP_ROWS", 16384)
    monkeypatch.setattr(cs, "temporal_kernel_cases", lambda *a, **k: None)
    lineitem, _orders, _dims = _small_tpch(cs)
    paths = cs.phase_temporal(lineitem, "cpu", {})
    assert paths["temporal_t1"]["segment_extreme_int64"] == 4, paths
    for path in ("temporal_t1_sql", "temporal_t1_file", "temporal_t2_hour",
                 "temporal_t2_ny_hour", "temporal_t2_day", "temporal_sample"):
        assert paths[path]["segment_sum_planes"] >= 1, (path, paths[path])
    out = capsys.readouterr().out
    assert "T1 plan: one DeviceGroupedAgg over the scan, fused region" in out
    assert "zone database:" in out and "T1 file: 0 column uploads on a warm run" in out
    assert "T1 file: row groups read" in out


def test_temporal_phase_fails_on_a_wrong_oracle(monkeypatch):
    cs = _cpu_cells(monkeypatch)
    monkeypatch.setattr(cs, "temporal_kernel_cases", lambda *a, **k: None)
    lineitem, _orders, _dims = _small_tpch(cs)
    oracle = cs.t1_oracle

    def shifted(cols, ts):
        out = oracle(cols, ts)
        out["last_ship"] = [v + cs.datetime.timedelta(microseconds=1) for v in out["last_ship"]]
        return out

    monkeypatch.setattr(cs, "t1_oracle", shifted)
    with pytest.raises(cs.SmokeFailure, match="numpy oracle"):
        cs.phase_temporal(lineitem, "cpu", {})


def test_nested_phase_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's nested phase on the CPU at a small size: N1's lists
    held to numpy, N2 as one DeviceGroupedAgg over the explode with K1,
    K2, K7 and K3's plain calls, equal to the flat aggregation, "off" and
    numpy; N3's Parquet round trip equal and N2 over the file without a
    warm upload; every N4 function equal to its oracle; N5 in SQL equal to
    N2. The kernel cases at N2's inputs need the card and are left out."""
    from daft_tpu_torch.device.residency import manager

    cs = _cpu_cells(monkeypatch)
    monkeypatch.setattr(cs, "nested_kernel_cases", lambda *a, **k: None)
    monkeypatch.setattr(cs, "clear_residency", lambda: manager().clear())
    monkeypatch.setattr(cs, "NESTED_VALUE_ROWS", 2_000)
    monkeypatch.setattr(cs, "NESTED_SAMPLE", 500)
    lineitem = cs.tpch_sf1(11, n_orders=4_000, n_parts=200, n_customers=400)[0]
    paths = cs.phase_nested(lineitem, "cpu", {})
    for path in ("nested_n2", "nested_n3_file", "nested_n5_sql"):
        for k in cs.NESTED_KERNELS:
            assert paths[path][k] >= 1, (path, k, paths[path])
    out = capsys.readouterr().out
    assert "N1: 4000 rows" in out and "N3 file: 0 column uploads on a warm run" in out
    assert "N2: equal to the flat aggregation over lineitem" in out
    assert out.count("sampled rows equal to the plain-Python oracle") == \
        len(cs.n4_functions())
    assert "N5: SQL build" in out


def test_nested_phase_fails_on_a_wrong_oracle(monkeypatch):
    from daft_tpu_torch.device.residency import manager

    cs = _cpu_cells(monkeypatch)
    monkeypatch.setattr(cs, "nested_kernel_cases", lambda *a, **k: None)
    monkeypatch.setattr(cs, "clear_residency", lambda: manager().clear())
    lineitem = cs.tpch_sf1(11, n_orders=2_000, n_parts=200, n_customers=400)[0]
    oracle = cs.n2_oracle

    def shifted(cols):
        out = oracle(cols)
        out["last_order"] = [v + 1 for v in out["last_order"]]
        return out

    monkeypatch.setattr(cs, "n2_oracle", shifted)
    with pytest.raises(cs.SmokeFailure, match="numpy oracle"):
        cs.phase_nested(lineitem, "cpu", {})


def _small_ingest(cs, monkeypatch):
    """chip_smoke.py's ingest phase at a small size on the CPU; the kernel
    cases (which need the card) replaced by a record of the calls the cold
    runs handed them."""
    from daft_tpu_torch.device.residency import manager

    monkeypatch.setattr(cs, "clear_residency", lambda: manager().clear())
    for name, v in (("J1_IMAGES", 120), ("J1_BAD", 5), ("J1_SIDES", (20, 72)),
                    ("MM_SIZE", 28), ("MM_CHECK_ROWS", 40), ("MM_BATCH", 32),
                    ("J1_PLAIN_FILES", 6), ("W1_RESPONSES", 60), ("W1_HOSTS", 25),
                    ("W1_PAYLOAD", (150, 600))):
        monkeypatch.setattr(cs, name, v)
    cases = {}

    def record(tag, label, calls, required, kernel_results, card):
        for wrapper in required:
            assert calls[wrapper], (label, wrapper)
        cases[tag] = {w: len(seen) for w, seen in calls.items()}

    monkeypatch.setattr(cs, "stage_kernel_cases", record)
    return cases


def test_ingest_phase_on_the_cpu(monkeypatch, capsys):
    """J1 (a JSONL manifest of JPEGs through a device UDF into the grouped
    stage) and W1 (gzipped WARC tokenized with the committed BPE file into
    the grouped stage) at a small size: equal to "off" and their oracles,
    nothing uploaded warm, the library's JPEG decode equal to the plain one
    on files and fixtures, and every kernel a path's cold run called
    counted among its launches."""
    cs = _cpu_cells(monkeypatch)
    cases = _small_ingest(cs, monkeypatch)
    paths = cs.phase_ingest("cpu", {})
    assert set(cases) == {"j1", "w1"}
    for tag, path in (("j1", "ingest_j1"), ("w1", "ingest_w1")):
        for w, n in cases[tag].items():
            assert n == paths[path][w], (tag, w, n, paths[path])
    for k in cs.MM_KERNELS:
        assert paths["ingest_j1"][k] >= 1, paths
    for k in cs.W1_KERNELS:
        assert paths["ingest_w1"][k] >= 1, paths
    out = capsys.readouterr().out
    assert "J1: the library's JPEG decode equals the plain version bit for bit on 6 files" \
        in out
    assert "J1: 21 result rows, equal to the host path and the numpy oracle" in out
    assert "J1: the warm runs upload 0 bytes, 0 residency misses" in out
    assert "W1: the warm runs upload 0 bytes, 0 residency misses" in out
    assert "W1: 25 hosts" in out or "equal to the oracle" in out
    assert "J1 host split of the cold run (s): read_json" in out
    assert "W1 host split of the cold run (s): scan (gunzip, parse)" in out


def test_j1_oracle_and_data_follow_the_mix(monkeypatch, tmp_path):
    """J1's writer: the kinds in their shares, the rows of no image
    unreadable, the others decoding to their sides; the oracle's counts
    skip the rows of no image."""
    import numpy as np

    from daft_tpu_torch.core.kernels import jpeg

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    monkeypatch.setattr(cs, "J1_IMAGES", 200)
    monkeypatch.setattr(cs, "J1_BAD", 6)
    monkeypatch.setattr(cs, "J1_SIDES", (16, 40))
    meta = cs.j1_write(str(tmp_path))
    assert int(meta["bad"].sum()) == 6
    assert set(meta["kinds"].tolist()) <= {"4:2:0", "4:4:4", "L", "4:1:1"}
    for i, p in enumerate(meta["paths"]):
        data = open(p, "rb").read()
        if meta["bad"][i]:
            with pytest.raises(OSError):
                jpeg.decode_jpeg(data)
        else:
            img = jpeg.decode_jpeg(data)
            assert img.mode == ("L" if meta["kinds"][i] == "L" else "RGB")
    dist = np.arange(200, dtype=np.float64)
    out = cs.j1_oracle(meta, dist)
    assert sum(out["n"]) == 194


def _serve_on_the_cpu(monkeypatch):
    """chip_smoke.py's serve phase on the CPU: the cells' config on
    device="cpu", the kernels' plain calls counted as their launches; the
    kernel cases and the profile need the card and are left out."""
    from daft_tpu_torch.device.residency import manager

    cs = _cpu_cells(monkeypatch)
    monkeypatch.setattr(cs, "serve_kernel_cases", lambda *a, **k: None)
    monkeypatch.setattr(cs, "clear_residency", lambda: manager().clear())
    return cs


def test_serve_phase_on_the_cpu(monkeypatch, capsys):
    """The serve phase at a small size on the CPU: four tenants' rounds
    through one gateway, every answer equal to "off", prepared hits,
    result-cache repeats, admission waits under the tight budget, the
    typed cancel, and K1, K2, K3, K4 and K7's plain versions called."""
    from daft_tpu_torch.device.residency import manager

    cs = _serve_on_the_cpu(monkeypatch)
    lineitem, orders, dims = _small_tpch(cs)
    launches = cs.phase_serve(lineitem, orders, dims, "cpu", {})
    assert all(launches[k] > 0 for k in cs.SERVE_KERNELS), launches
    out = capsys.readouterr().out
    for line in ("serve cold: 28 answers equal", "serve warm: 28 answers equal",
                 "serve cached: 56 answers equal", "serve tight: 28 answers equal",
                 "the last query cancelled with the typed error"):
        assert line in out, line
    assert "admission waits 0" not in out.split("serve tight:")[-1].split("\n")[0]
    assert manager().reserved_bytes() == 0 and manager().pinned_count() == 0


def test_serve_phase_fails_when_an_answer_differs_from_off(monkeypatch):
    cs = _serve_on_the_cpu(monkeypatch)
    lineitem, orders, dims = _small_tpch(cs)
    off = cs.serve_off

    def shifted(tables):
        want, warm = off(tables)
        want["q12"]["high_line_count"] = [v + 1 for v in want["q12"]["high_line_count"]]
        return want, warm

    monkeypatch.setattr(cs, "serve_off", shifted)
    with pytest.raises(cs.SmokeFailure, match="q12 .*differs from the \"off\" run"):
        cs.phase_serve(lineitem, orders, dims, "cpu", {})


def _dist_on_the_cpu(monkeypatch):
    """chip_smoke.py's dist phase on the CPU: the cells' config on
    device="cpu" (the pool hands it to its workers), the kernels' plain
    calls counted as their launches."""
    from daft_tpu_torch.device.residency import manager

    cs = _cpu_cells(monkeypatch)
    monkeypatch.setattr(cs, "clear_residency", lambda: manager().clear())
    return cs


def test_dist_phase_on_the_cpu(monkeypatch, capsys):
    """The dist phase at a small size on the CPU: q1 through two leased
    workers equal to the single-process, "off" and oracle runs, K1, K2, K3
    and K7 counted in the workers, the repeat's affinity hits with each
    worker's h2d bytes flat, q12 both ways, four served tenants, and the
    killed worker's query equal."""
    cs = _dist_on_the_cpu(monkeypatch)
    lineitem, orders, _dims = _small_tpch(cs)
    launches = cs.phase_dist(lineitem, orders, "cpu")
    for k in ("segment_sum_planes", "segment_sum_float_planes", "segment_extreme_planes",
              "segment_extreme_int64"):
        assert launches[k] > 0, launches
    out = capsys.readouterr().out
    for line in ("dist q1 cold", "h2d bytes by worker unchanged", "dist q12",
                 "worker tasks; both equal", "dist serve: 8 queries of 4 tenants",
                 "1 failure, 1 map(s) regenerated; equal"):
        assert line in out, line


class _Stats:
    def __init__(self, worker, counters, exec_s=0.1, queue_wait_s=0.0):
        self.worker_id = worker
        self.engine_counters = tuple(sorted(counters.items()))
        self.exec_s = exec_s
        self.queue_wait_s = queue_wait_s


class _Trace:
    def __init__(self, tasks):
        self.tasks = tasks


def test_dist_launches_sum_the_workers_counters(monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    trace = _Trace([_Stats("worker-0", {"launches_segment_sum_planes": 2,
                                        "launches_segment_sum_float_planes": 1,
                                        "plain_segment_sum_planes": 9}),
                    _Stats("worker-1", {"launches_segment_sum_planes": 1}),
                    _Stats("worker-0", {})])
    got = cs.dist_launches(trace)
    assert got["total"]["segment_sum_planes"] == 3
    assert got["total"]["segment_sum_float_planes"] == 1
    assert got["by_worker"] == {"worker-0": {"segment_sum_planes": 2,
                                             "segment_sum_float_planes": 1},
                                "worker-1": {"segment_sum_planes": 1}}
    assert "3 worker tasks" in cs.dist_task_times(trace)
    cs.dist_check_launches("ok", got)


@pytest.mark.parametrize("missing", ["segment_sum_planes", "segment_sum_float_planes"])
def test_dist_fails_on_zero_worker_launches(monkeypatch, missing):
    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    counters = {"launches_segment_sum_planes": 1, "launches_segment_sum_float_planes": 1}
    counters[f"launches_{missing}"] = 0
    got = cs.dist_launches(_Trace([_Stats("worker-0", counters)]))
    with pytest.raises(cs.SmokeFailure, match=f"kernel {missing} was not launched in a worker"):
        cs.dist_check_launches("dist q1", got)


def test_dist_oracle_holds_ints_exactly_and_floats_to_rtol(monkeypatch):
    """dist_same_q1: the oracle of the CPU-sized q1 equals the port's host
    run; an integer count one off, or a float sum off by more than
    DIST_RTOL, fails; one within it passes."""
    import numpy as np

    import daft_tpu_torch as dt

    monkeypatch.syspath_prepend(REPO)
    import chip_smoke as cs

    lineitem, _orders, _dims = _small_tpch(cs)
    df = cs.q1_frame(lineitem)
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        host = cs.q1_query(df, extremes=True).to_pydict()
    oracle = cs.q1_oracle(lineitem, extremes=True)
    assert cs.dist_same_q1(host, host, oracle)
    off = {k: list(v) for k, v in host.items()}
    off["count_order"][0] += 1
    assert not cs.dist_same_q1(off, host, oracle)
    near = {k: list(v) for k, v in host.items()}
    near["sum_charge"][0] *= 1 + cs.DIST_RTOL / 10
    assert cs.dist_same_q1(near, host, oracle)
    far = {k: list(v) for k, v in host.items()}
    far["sum_charge"][0] *= 1 + cs.DIST_RTOL * 10
    assert not cs.dist_same_q1(far, host, oracle)
    maxed = {k: list(v) for k, v in host.items()}
    maxed["max_price"][0] = float(np.nextafter(maxed["max_price"][0], np.inf))
    assert not cs.dist_same_q1(maxed, host, oracle)
