"""All 22 TPC-H queries through the port, against the reference's host
path (the port's counterpart of tests/test_device_join.py
``test_tpch_device_join_sweep``).

``benchmarking/tpch/queries.py`` runs unchanged, its ``from daft_tpu
import`` read as ``from daft_tpu_torch import``, over the reference's
SF 0.01 tables (``generate(0.01, 0)``) carried across column for column.
Each query runs through the port with device_mode on (device="cpu": the
kernels' plain versions) and off, and both equal the reference's host
result: rows in order, floats within rtol 1e-5 (the reference's
device-vs-host tolerance), everything else exactly. Both packages
optimize every query before translating it.

Which queries ride the device join is computed here for both packages: the
reference's set from its own counters with device_mode="on" (as
tests/test_device_join.py ``test_tpch_device_join_sweep`` reads them), the
port's from its counters. The port's set holds the reference's and the
queries it rode before the optimizer came (q3, q5, q8, q10, q12, q14,
q19); a query only the port rides is one of ``PORT_ONLY``, the deliberate
difference ROADMAP.md lists.
"""

import fcntl
import os
import subprocess
import tempfile
import types

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters
from daft_tpu_torch.plan import physical as pp

RTOL = 1e-5
# the queries the port rode on the device join before the optimizer
RODE_BEFORE = {3, 5, 8, 10, 12, 14, 19}
# q2 takes a float min (ps_supplycost) through its star join: the port's join
# stage runs it in f64, the reference's capture refuses a float min/max
PORT_ONLY = {2}


def _carry(ref_df):
    batch = ref_df.collect()._result[0].concat_or_empty()
    schema = daft_tpu_torch.Schema.from_pydict(
        {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_df.schema})
    return from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)


def _port_queries():
    """benchmarking/tpch/queries.py with the port's ``col`` and ``lit``."""
    import benchmarking.tpch.queries as q

    src = open(q.__file__).read()
    assert "from daft_tpu import col, lit" in src
    mod = types.ModuleType("port_tpch_queries")
    exec(compile(src.replace("from daft_tpu import", "from daft_tpu_torch import"),
                 q.__file__, "exec"), mod.__dict__)
    return mod.ALL_QUERIES


def _reference_native_lib():
    """The reference's host library, complete and loaded in this worker.

    The reference builds ``daft_tpu/_native/libdaft_native.so`` in place at
    its first ``get_lib()`` call and latches the outcome: under xdist a
    worker that loads the file while another still writes it latches None
    for its whole life, and the reference's numpy arm of
    ``unique_key_index`` then fails on an empty dimension table (ROADMAP
    Queue 3, F11). Under an exclusive lock, build the library to a
    temporary name with the reference's own compiler line and rename it into
    place, then let a loader that latched None try once more.
    """
    from daft_tpu import native as ref_native

    so = ref_native._SO_PATH
    src = os.path.join(ref_native._REPO_ROOT, "native", "src", "kernels.cpp")
    lock_path = os.path.join(tempfile.gettempdir(), "daft_tpu_native_build.lock")

    def build():
        os.makedirs(os.path.dirname(so), exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, so)

    def load():
        if ref_native._LIB is None and ref_native._TRIED:
            ref_native._TRIED = False
            try:
                ref_native.get_lib()
            finally:
                ref_native._TRIED = True
        return ref_native.get_lib()

    with open(lock_path, "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not os.path.exists(so) or os.path.getmtime(src) > os.path.getmtime(so):
                build()
            if load() is None:
                # another process's in-place build may have been mid-write
                build()
                load()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    assert ref_native.get_lib() is not None, (
        "F11: the reference's host library did not load in this worker, and its numpy "
        "arm of unique_key_index fails on an empty dimension table")


# at collection, in every worker, before any test of either package runs: the
# reference's own tests (tests/test_device_join.py) reach its numpy arm too
try:
    _reference_native_lib()
except (OSError, subprocess.SubprocessError, AssertionError):
    pass  # the fixture below runs the guard again and fails naming F11


@pytest.fixture(scope="module")
def tpch():
    _reference_native_lib()
    from benchmarking.tpch.datagen import generate
    from benchmarking.tpch.queries import ALL_QUERIES

    ref = {k: daft_tpu.from_arrow(v).collect() for k, v in generate(0.01, 0).items()}
    return ref, {k: _carry(v) for k, v in ref.items()}, ALL_QUERIES, _port_queries()


def _same(got, want):
    assert list(got) == list(want)
    for c in got:
        g, w = got[c], want[c]
        assert len(g) == len(w), c
        if any(isinstance(v, float) for v in w):
            assert [v is None for v in g] == [v is None for v in w], c
            np.testing.assert_allclose([np.nan if v is None else v for v in g],
                                       [np.nan if v is None else v for v in w],
                                       rtol=RTOL, atol=0.0, err_msg=c)
        else:
            assert g == w, c


@pytest.fixture(scope="module")
def ref_device_join_set(tpch):
    """The queries whose reference run (device_mode="on") counts a device
    join batch."""
    from daft_tpu.ops import counters as ref_counters

    ref, _port, ref_queries, _pq = tpch
    rode = set()
    for qn in range(1, 23):
        ref_counters.reset()
        with ref_ctx(device_mode="on"):
            ref_queries[qn](ref).to_pydict()
        if ref_counters.device_join_batches:
            rode.add(qn)
    return rode


@pytest.mark.parametrize("qn", range(1, 23))
def test_tpch_query_matches_reference_host(tpch, ref_device_join_set, qn):
    ref, port, ref_queries, port_queries = tpch
    with ref_ctx(device_mode="off"):
        want = ref_queries[qn](ref).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        host = port_queries[qn](port).to_pydict()
    _same(host, want)
    manager().clear()
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        dev = port_queries[qn](port).to_pydict()
    _same(dev, want)
    snap = counters.snapshot()
    assert all(snap[f"launches_{k}"] == 0 for k in counters.KERNEL_NAMES)
    rides = snap["device_join_batches"] >= 1
    if qn in ref_device_join_set | RODE_BEFORE:
        assert rides and snap["device_fallbacks"] == 0, (qn, snap, counters.rejections)
        # every join batch is a fused region; q11, q17 and q18 also run a
        # grouped stage of their own
        assert snap["device_region_dispatches"] >= snap["device_join_batches"]
        if qn in RODE_BEFORE:
            assert snap["device_region_dispatches"] == snap["device_join_batches"]
    assert rides == (qn in ref_device_join_set | RODE_BEFORE | PORT_ONLY), \
        (qn, snap, counters.rejections)


def test_device_join_sets(ref_device_join_set):
    """The reference's set as its run counts it: with the optimizer, every
    query the port rode before is in it, and no query of PORT_ONLY is."""
    assert ref_device_join_set == {3, 5, 8, 10, 11, 12, 14, 17, 18, 19}
    assert RODE_BEFORE <= ref_device_join_set
    assert not PORT_ONLY & ref_device_join_set


def _aggregates(node, cls):
    out = [node] if isinstance(node, cls) else []
    for c in node.children():
        out += _aggregates(c, cls)
    return out


def _capture_form(spec):
    """A join capture's fact columns and its dims: name, key, parent and the
    column sets of their filters; None when refused."""
    if spec is None:
        return None
    return (tuple(spec.fact.schema.column_names()),
            tuple((d.name, d.key_col, d.parent,
                   tuple(sorted(tuple(sorted(f.referenced_columns())) for f in d.filters)))
                  for d in spec.dims))


@pytest.mark.parametrize("qn", range(1, 23))
def test_join_capture_matches_reference(tpch, qn):
    """Over each aggregate of the optimized plan, the port's join capture
    picks the reference's fact and grows its dim tree, dim for dim, with the
    same filters stripped onto each relation (q2: the reference refuses its
    float min, PORT_ONLY)."""
    from daft_tpu.ops.device_join import try_capture_join_agg as ref_capture
    from daft_tpu.plan import logical as rlp
    from daft_tpu_torch.ops.device_join import try_capture_join_agg
    from daft_tpu_torch.plan import logical as plp

    ref, port, ref_queries, port_queries = tpch
    with ref_ctx(device_mode="on"):
        want = [_capture_form(ref_capture(a)) for a in _aggregates(
            ref_queries[qn](ref)._builder.optimize().plan, rlp.Aggregate)]
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = [_capture_form(try_capture_join_agg(a)) for a in _aggregates(
            port_queries[qn](port).optimized_plan(), plp.Aggregate)]
    if qn in PORT_ONLY:
        assert want == [None] and got[0] is not None
    else:
        assert got == want


def test_q5_plans_one_device_join(tpch):
    """q5 as one DeviceJoinAgg over lineitem: orders and supplier adjacent,
    customer -> nation -> region chained behind orders (region's filter on
    its own rows), and the second supplier key a predicate over two dims."""
    _ref, port, _rq, port_queries = tpch
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        plan = pp.translate(port_queries[5](port).optimized_plan())
    nodes = [n for n in plan.walk() if isinstance(n, pp.DeviceJoinAgg)]
    assert len(nodes) == 1 and not any(isinstance(n, pp.HashJoin) for n in plan.walk())
    spec = nodes[0].spec
    assert spec.fact.schema.column_names()[0] == "l_orderkey"
    dims = {d.key_col: d for d in spec.dims}
    assert dims["o_orderkey"].parent == ("fact", "l_orderkey")
    assert dims["s_suppkey"].parent == ("fact", "l_suppkey")
    names = {d.name: d.key_col for d in spec.dims}
    assert (names[dims["c_custkey"].parent[0]], dims["c_custkey"].parent[1]) == \
        ("o_orderkey", "o_custkey")
    assert (names[dims["n_nationkey"].parent[0]], dims["n_nationkey"].parent[1]) == \
        ("c_custkey", "c_nationkey")
    assert (names[dims["r_regionkey"].parent[0]], dims["r_regionkey"].parent[1]) == \
        ("n_nationkey", "n_regionkey")
    assert [repr(f) for f in dims["r_regionkey"].filters] == ["(col(r_name) == lit('ASIA'))"]
    assert "(col(n_nationkey) == col(s_nationkey))" in repr(spec.predicate)
    # the optimizer pushed the orders filter into orders' relation
    assert "o_orderdate" in repr(dims["o_orderkey"].filters)


# ---- the host operators the sweep needs, one by one ------------------------------


def _pair(data):
    return daft_tpu.from_pydict(data), daft_tpu_torch.from_pydict(data)


def _both(query, ref_df, port_df, *more):
    with ref_ctx(device_mode="off"):
        want = query(daft_tpu, ref_df, *[m[0] for m in more]).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = query(daft_tpu_torch, port_df, *[m[1] for m in more]).to_pydict()
    return got, want


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_join_indices_match_reference(how):
    """Two-column keys with nulls on both sides, duplicates on the right."""
    from daft_tpu.core.kernels.join import join_indices as ref_join_indices
    from daft_tpu_torch.core.kernels.join import join_indices

    rng = np.random.default_rng(5)
    cols = []
    for n in (300, 200):
        a = rng.integers(0, 12, n).tolist()
        b = rng.integers(0, 3, n).tolist()
        for i in rng.choice(n, 20, replace=False):
            a[i] = None
        cols.append((a, b))
    ref_keys = [[daft_tpu.Series.from_pylist(c) for c in side] for side in cols]
    port_keys = [[daft_tpu_torch.Series.from_pylist(c) for c in side] for side in cols]
    want = ref_join_indices(ref_keys[0], ref_keys[1], how)
    got = join_indices(port_keys[0], port_keys[1], how)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("how", ["left", "semi", "anti", "cross"])
def test_non_inner_join_is_never_captured(how):
    """An aggregate over a semi, anti, left or cross join keeps the join on
    the host: flattened into the star join as an inner one it would give
    wrong rows with no error. The aggregate itself may still run as a device
    stage over the host join."""
    from daft_tpu_torch.ops.device_join import try_capture_join_agg

    rng = np.random.default_rng(6)
    fact = {"fk": rng.integers(0, 60, 2000).tolist(), "v": rng.integers(0, 100, 2000).tolist()}
    dim = {"k": list(range(0, 50)), "g": [i % 4 for i in range(50)]}

    def q(dt, f, d):
        col = dt.col
        if how == "cross":
            j = f.join(d.where(col("k") < 2), how="cross")
        else:
            j = f.join(d, left_on="fk", right_on="k", how=how)
        return j.groupby("fk").agg(col("v").sum().alias("s"), col("v").count().alias("c")) \
            .sort("fk")

    (rf, pf), (rd, pd) = _pair(fact), _pair(dim)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        lplan = q(daft_tpu_torch, pf, pd)._plan.input
        assert try_capture_join_agg(lplan) is None
        inner = daft_tpu_torch.col
        assert try_capture_join_agg(
            pf.join(pd, left_on="fk", right_on="k").groupby("fk")
            .agg(inner("v").sum().alias("s"))._plan) is not None
    got, want = _both(q, rf, pf, (rd, pd))
    assert got == want and len(got["fk"]) > 0


def test_left_join_fills_nulls_and_keeps_unmatched_rows():
    left = {"a": [1, 2, None, 4, 2], "x": ["p", "q", "r", "s", "t"]}
    right = {"a": [2, 4, 4, 9], "y": [1.5, None, 3.0, 4.0], "x": ["u", "v", "w", "z"]}

    def q(dt, l, r):
        return l.join(r, on="a", how="left")

    (rl, pl), (rr, pr) = _pair(left), _pair(right)
    got, want = _both(q, rl, pl, (rr, pr))
    assert got == want
    assert got["right.x"].count(None) == 2 and got["y"].count(None) == 3


def test_string_and_date_functions_match_reference():
    import datetime

    data = {"s": ["PROMO BRASS", "green forest", None, "xBRASS", "", "31-555"],
            "d": [datetime.date(1995, 3, 1), None, datetime.date(1970, 1, 1),
                  datetime.date(1969, 12, 31), datetime.date(2000, 2, 29),
                  datetime.date(1998, 12, 1)]}

    def q(dt, d):
        col = dt.col
        return d.select(col("s").str.contains("BRASS").alias("c"),
                        col("s").str.endswith("BRASS").alias("e"),
                        col("s").str.startswith("gr").alias("b"),
                        col("s").str.left(2).alias("l"),
                        col("d").dt.year().alias("y"))

    got, want = _both(q, *_pair(data))
    assert got == want


def test_string_functions_stay_on_the_host():
    from daft_tpu_torch.ops import device_eval

    schema = daft_tpu_torch.Schema.from_pydict({"s": daft_tpu_torch.DataType.string(),
                                                "d": daft_tpu_torch.DataType.date()})
    col = daft_tpu_torch.col
    for e in (col("s").str.contains("x"), col("s").str.endswith("x"),
              col("s").str.left(2) == "ab", col("d").dt.year() > 1995):
        assert not device_eval.is_device_evaluable(e, schema)
    with pytest.raises(ValueError, match="literal"):
        col("s").str.left("2").to_field(schema)
    with pytest.raises(ValueError, match="date column"):
        col("s").dt.year().to_field(schema)


@pytest.mark.parametrize("grouped", [True, False])
def test_count_distinct_matches_reference_and_stays_on_the_host(grouped):
    rng = np.random.default_rng(8)
    v = rng.integers(0, 30, 3000).tolist()
    for i in rng.choice(3000, 100, replace=False):
        v[i] = None
    data = {"k": rng.integers(0, 7, 3000).tolist(), "v": v}

    def q(dt, d):
        col = dt.col
        aggs = (col("v").count_distinct().alias("n"), col("v").sum().alias("s"))
        return d.groupby("k").agg(*aggs).sort("k") if grouped else d.agg(*aggs)

    counters.reset()
    with daft_tpu_torch.execution_config_ctx(morsel_size_rows=1000):
        got, want = _both(q, *_pair(data))
    assert got == want
    assert counters.device_grouped_batches == counters.device_stage_batches == 0
    assert any("bare sum/mean/min/max/count" in r for r in counters.rejections)


def test_distinct_matches_reference():
    rng = np.random.default_rng(9)
    data = {"a": rng.integers(0, 5, 400).tolist(), "b": rng.choice(["x", "y", None], 400)
            .tolist(), "c": rng.integers(0, 1000, 400).tolist()}

    def on_two(dt, d):
        return d.distinct("a", "b")

    def on_all(dt, d):
        return d.select("a", "b").distinct()

    for q in (on_two, on_all):
        got, want = _both(q, *_pair(data))
        assert got == want and len(got["a"]) <= 15


def test_f11_guard_reloads_a_latched_reference_library():
    """The guard of the fixtures (ROADMAP Queue 3, F11): a reference loader
    that latched None in this worker loads the library again, and its
    latch is left set."""
    from daft_tpu import native as ref_native

    saved = (ref_native._LIB, ref_native._TRIED)
    try:
        ref_native._LIB, ref_native._TRIED = None, True
        assert ref_native.get_lib() is None
        _reference_native_lib()
        assert ref_native._LIB is not None and ref_native._TRIED
    finally:
        if ref_native._LIB is None:
            ref_native._LIB, ref_native._TRIED = saved
