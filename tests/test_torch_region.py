"""Whole-stage device fusion (ops/region.py), ported from
tests/test_fused_region.py: the planner collapses the chain of Filters and
Projects under an aggregate into the aggregate's one device stage over the
chain's base.

The same data goes through the reference (daft_tpu, device_mode="on",
pallas_mode="on": its kernels in Pallas interpret mode on JAX CPU) and the
port (device="cpu": its kernels' plain versions). Integer sums, counts,
min/max and keys compare bit for bit; float sums within rtol 1e-5, the
reference's device-vs-host tolerance.
"""

import datetime
import os
import subprocess
import sys

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch.execution import executor as ex
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import grouped_stage as gs
from daft_tpu_torch.ops import region
from daft_tpu_torch.plan import physical as pp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5


def _chain_query(dt, d):
    """project -> filter -> groupby-agg: the canonical fused-region shape."""
    col = dt.col
    return (d.select(col("k"), (col("v") * 3).alias("w"), col("v"))
            .where(col("w") > -2400)
            .groupby("k")
            .agg(col("w").sum().alias("s"),
                 col("w").count().alias("c"),
                 col("v").min().alias("lo"))
            .sort("k"))


def _data(n=4096, null_keys=False, big=False):
    rng = np.random.default_rng(7)
    keys = rng.choice(["a", "b", "c", "d", None] if null_keys
                      else ["a", "b", "c", "d"], n).tolist()
    if big:
        # past 2^53: only exact int64 digit planes keep these
        base = (1 << 60) + 12345
        vals = [(base + int(i)) * (1 if i % 2 else -1) for i in range(n)]
    else:
        vals = rng.integers(-1000, 1000, n).tolist()
    return {"k": keys, "v": vals}


def _port(query, data, **cfg):
    cfg = {"device": "cpu", **cfg}
    with daft_tpu_torch.execution_config_ctx(**cfg):
        return query(daft_tpu_torch, daft_tpu_torch.from_pydict(data)).to_pydict()


def _ref(query, data):
    with ref_ctx(device_mode="on", pallas_mode="on", mesh_devices=1):
        return query(daft_tpu, daft_tpu.from_pydict(data)).to_pydict()


def _plan(query, df, **cfg):
    with daft_tpu_torch.execution_config_ctx(device="cpu", **cfg):
        return pp.translate(query(daft_tpu_torch, df).optimized_plan())


@pytest.mark.parametrize("null_keys", [False, True])
def test_region_three_way_bit_identity(null_keys):
    data = _data(null_keys=null_keys)
    fused = _port(_chain_query, data, region_mode="on")
    unfused = _port(_chain_query, data, region_mode="off")
    host = _port(_chain_query, data, device_mode="off")
    assert fused == unfused == host
    assert fused == _ref(_chain_query, data)
    assert (None in fused["k"]) == null_keys


def test_region_int64_exactness_past_2_53():
    data = _data(n=512, big=True)

    def q(dt, d):
        col = dt.col
        return (d.where(col("v") != 0).groupby("k")
                .agg(col("v").sum().alias("s"), col("v").max().alias("hi"))
                .sort("k"))

    fused = _port(q, data, region_mode="on")
    assert fused == _port(q, data, device_mode="off") == _ref(q, data)
    assert any(abs(v) > (1 << 53) for v in fused["hi"])


def test_region_attribution_counters():
    counters.reset()
    _port(_chain_query, _data(), region_mode="on")
    snap = counters.snapshot()
    assert snap["device_region_dispatches"] > 0
    # project + filter + agg = 3 ops over every region dispatch
    assert snap["device_region_ops_fused"] == 3 * snap["device_region_dispatches"]
    node = next(n for n in _plan(_chain_query, daft_tpu_torch.from_pydict(_data())).walk()
                if isinstance(n, pp.DeviceGroupedAgg))
    assert node.region_ops == ("project", "filter", "agg")
    assert region.region_label(node.region_ops) == "project→filter→agg"


def test_region_fuses_fewer_dispatches_than_unfused():
    """The fused region dispatches one device program where the unfused plan
    runs the chain as host operators feeding a bare device stage."""
    data = _data()
    counters.reset()
    fused = _port(_chain_query, data, region_mode="on")
    fused_d = counters.device_grouped_batches
    assert counters.device_region_dispatches == fused_d > 0
    counters.reset()
    unfused = _port(_chain_query, data, region_mode="off")
    assert fused == unfused
    assert fused_d <= max(counters.device_grouped_batches, 1)
    # unfused, the stage fuses only the Filter peeled into it
    assert counters.device_region_ops_fused == 2 * counters.device_region_dispatches


def test_mid_region_fallback_reruns_whole_region_on_host(monkeypatch):
    """A DeviceFallback after batches were fed and buffered discards every
    partial device table and replays the whole buffered region through the
    host operators, bit-identically."""
    data = _data()
    host = _port(_chain_query, data, device_mode="off")
    fed = {"n": 0}
    real_feed = gs.GroupedAggRun.feed_batch

    def feeding(self, batch):
        real_feed(self, batch)
        fed["n"] += 1

    def exploding_finalize(self):
        raise gs.DeviceFallback("injected mid-region failure")

    monkeypatch.setattr(gs.GroupedAggRun, "feed_batch", feeding)
    monkeypatch.setattr(gs.GroupedAggRun, "finalize", exploding_finalize)
    counters.reset()
    out = _port(_chain_query, data, region_mode="on")
    assert fed["n"] > 0, "the device region never accumulated before the fallback"
    assert counters.device_fallbacks == 1 and counters.device_region_dispatches == 0
    assert out == host


def _wide_query(dt, d):
    col = dt.col
    return (d.select("k", "v", (col("v") * 2).alias("w"))
            .where(col("w") > 4)
            .groupby("k").agg(col("w").sum().alias("s"))
            .sort("k"))


def _wide_data(n=512):
    return {"k": [i % 7 for i in range(n)], "v": list(range(n)),
            "pad": ["x" * 64] * n}  # never referenced by the region


def test_region_host_path_narrows_to_referenced_columns(monkeypatch):
    """Absorbing a Project moves the region's base below it, to the full
    width; the host path (device_mode="off" at run time, the fallback's
    rerun buffer) reads only the referenced columns."""
    data = _wide_data()
    plan = _plan(_wide_query, daft_tpu_torch.from_pydict(data))
    node = next(nd for nd in plan.walk() if isinstance(nd, pp.DeviceGroupedAgg))
    assert "pad" in node.input.schema.column_names()  # the base is the wide table
    assert ex._region_keep_columns(node) == ["k", "v"]
    seen = []
    real_filter = ex._filter_part

    def spying(part, predicate, keep=None):
        seen.append(part.schema.column_names())
        return real_filter(part, predicate, keep)

    monkeypatch.setattr(ex, "_filter_part", spying)
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        host = list(ex.execute_plan(plan))  # a plan made under device_mode="on"
    assert seen and all(cols == ["k", "v"] for cols in seen)
    fused = _port(_wide_query, data)
    assert daft_tpu_torch.MicroPartition.concat(host).to_pydict() == fused
    assert fused == _port(_wide_query, data, device_mode="off") == _ref(_wide_query, data)


def test_fallback_rerun_buffer_is_narrowed(monkeypatch):
    data = _wide_data()
    seen = []
    real_two_phase = ex._two_phase_agg

    def spying(stream, *args):
        parts = list(stream)
        seen.extend(p.schema.column_names() for p in parts)
        return real_two_phase(iter(parts), *args)

    def exploding_finalize(self):
        raise gs.DeviceFallback("injected")

    monkeypatch.setattr(ex, "_two_phase_agg", spying)
    monkeypatch.setattr(gs.GroupedAggRun, "finalize", exploding_finalize)
    out = _port(_wide_query, data)
    assert seen and all(cols == ["k", "v"] for cols in seen)
    assert out == _port(_wide_query, data, device_mode="off")


def test_ungrouped_region_host_path_narrows():
    def q(dt, d):
        col = dt.col
        return d.select("v", (col("v") * 2).alias("w")).where(col("w") > 4) \
            .agg(col("w").sum().alias("s"), col("v").max().alias("hi"))

    data = _wide_data()
    plan = _plan(q, daft_tpu_torch.from_pydict(data))
    node = next(nd for nd in plan.walk() if isinstance(nd, pp.DeviceFilterAgg))
    # the optimizer's pruning Project over the source (pad dropped) fuses too
    assert node.region_ops == ("project", "project", "filter", "agg")
    assert ex._region_keep_columns(node) == ["v"]
    counters.reset()
    fused = _port(q, data)
    assert counters.device_region_ops_fused == 4 * counters.device_region_dispatches == 4
    assert fused == _port(q, data, device_mode="off") == _ref(q, data)


def test_region_caps_at_eight_ops():
    """A chain of ten operators (five Projects, each under a Filter on what
    it computed, so the optimizer neither merges nor moves them) absorbs the
    eight nearest the aggregate; the other two run as host operators under
    the device node."""
    def q(dt, d):
        col = dt.col
        for i in range(5):
            d = d.with_column("v", col("v") + 1).where(col("v") > -1000 + i)
        return d.groupby("k").agg(col("v").sum().alias("s")).sort("k")

    data = _data()
    plan = _plan(q, daft_tpu_torch.from_pydict(data))
    node = next(nd for nd in plan.walk() if isinstance(nd, pp.DeviceGroupedAgg))
    assert len(node.region_ops) == region.REGION_MAX_OPS + 1
    assert [type(n) for n in plan.walk()][-3:] == [pp.PhysFilter, pp.Project,
                                                   pp.InMemoryScan]
    assert _port(q, data) == _port(q, data, device_mode="off") == _ref(q, data)


def test_untypeable_candidate_gives_way_to_a_shorter_chain():
    """A Project that changes a group key's dtype cannot be absorbed (the
    output schema would drift): the capture falls back to a shorter chain."""
    def q(dt, d):
        col = dt.col
        return (d.select(col("k"), col("v").cast(dt.DataType.int32()).alias("v"))
                .where(col("v") > 0).groupby("v").agg(col("k").count().alias("c"))
                .sort("v"))

    data = _data(n=256)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        lplan = q(daft_tpu_torch, daft_tpu_torch.from_pydict(data))._plan.input
    cands = list(region.agg_region_candidates(lplan))
    assert [c.ops for c in cands][-1] == ("agg",)
    assert _port(q, data) == _port(q, data, device_mode="off")


def test_planner_composes_only_the_accepted_candidate(monkeypatch):
    """Candidates compose lazily: a chain the grouped stage accepts whole is
    composed once, not once per shorter chain."""
    calls = []
    real = region._compose

    def counting(plan, chain, k):
        calls.append(k)
        return real(plan, chain, k)

    monkeypatch.setattr(region, "_compose", counting)
    df = daft_tpu_torch.from_pydict(_data(n=256))
    plan = _plan(_chain_query, df)
    node = next(n for n in plan.walk() if isinstance(n, pp.DeviceGroupedAgg))
    assert node.region_ops == ("project", "filter", "agg")
    # one composition by the join capture's look (no join under it), one
    # by the region capture: the full chain both times
    assert calls == [2, 2]


def _join_chain_query(dt, t):
    """A Project and a Filter over an inner join, under a grouped
    aggregate: the join capture composes the chain over the join tree."""
    col = dt.col
    return (t["fact"].join(t["dim"], left_on="fk", right_on="dk")
            .with_column("w", col("v") * col("m"))
            .where(col("g") != 2)
            .groupby("g").agg(col("w").sum().alias("s"), col("w").count().alias("c"))
            .sort("g"))


def test_join_capture_composes_the_chain_over_the_join():
    rng = np.random.default_rng(5)
    fact = {"fk": rng.integers(0, 40, 3000).tolist(),
            "v": rng.integers(-500, 500, 3000).tolist()}
    dim = {"dk": list(range(40)), "g": [i % 5 for i in range(40)],
           "m": rng.integers(1, 9, 40).tolist()}

    def run(dt, **cfg):
        t = {"fact": dt.from_pydict(fact), "dim": dt.from_pydict(dim)}
        with daft_tpu_torch.execution_config_ctx(device="cpu", **cfg):
            plan = pp.translate(_join_chain_query(dt, t).optimized_plan())
            return plan, _join_chain_query(dt, t).to_pydict()

    plan, got = run(daft_tpu_torch)
    node = next(n for n in plan.walk() if isinstance(n, pp.DeviceJoinAgg))
    # the optimizer pushed the dim-only filter into the dim's relation
    (dim_spec,) = node.spec.dims
    assert [f.referenced_columns() for f in dim_spec.filters] == [["g"]]
    assert not any(isinstance(n, (pp.Project, pp.PhysFilter, pp.HashJoin))
                   for n in plan.walk())
    _plan_off, host = run(daft_tpu_torch, device_mode="off")
    assert got == host
    with ref_ctx(device_mode="off"):
        t = {"fact": daft_tpu.from_pydict(fact), "dim": daft_tpu.from_pydict(dim)}
        assert got == _join_chain_query(daft_tpu, t).to_pydict()


def test_region_mode_is_validated():
    with pytest.raises(ValueError, match="region_mode"):
        daft_tpu_torch.ExecutionConfig(region_mode="auto")


# ---- the TPC-H chains --------------------------------------------------------------


def _carry(ref_df):
    batch = ref_df.collect()._result[0].concat_or_empty()
    schema = daft_tpu_torch.Schema.from_pydict(
        {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_df.schema})
    return from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)


@pytest.fixture(scope="module")
def lineitem():
    from benchmarking.tpch.datagen import generate

    ref = daft_tpu.from_arrow(generate(0.01, 0)["lineitem"]).collect()
    return ref, _carry(ref)


Q1_AGGS = ("sum_qty", "sum_base_price", "sum_disc_price", "sum_charge", "avg_qty",
           "avg_price", "avg_disc", "count_order")


def q1_chain(dt, L):
    """TPC-H q1 with its derived columns written as ``with_column`` first."""
    col, lit = dt.col, dt.lit
    return (L.with_column("disc_price", col("l_extendedprice") * (1 - col("l_discount")))
            .with_column("charge", col("disc_price") * (1 + col("l_tax")))
            .where(col("l_shipdate") <= lit(datetime.date(1998, 9, 2)))
            .groupby("l_returnflag", "l_linestatus")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").sum().alias("sum_base_price"),
                 col("disc_price").sum().alias("sum_disc_price"),
                 col("charge").sum().alias("sum_charge"),
                 col("l_quantity").mean().alias("avg_qty"),
                 col("l_extendedprice").mean().alias("avg_price"),
                 col("l_discount").mean().alias("avg_disc"),
                 col("l_quantity").count().alias("count_order"))
            .sort(["l_returnflag", "l_linestatus"]))


def q6_chain(dt, L):
    """TPC-H q6 with its product written as ``with_column`` after the
    filter."""
    col, lit = dt.col, dt.lit
    return (L.where((col("l_shipdate") >= lit(datetime.date(1994, 1, 1)))
                    & (col("l_shipdate") < lit(datetime.date(1995, 1, 1)))
                    & (col("l_discount") >= 0.05) & (col("l_discount") <= 0.07)
                    & (col("l_quantity") < 24))
            .with_column("rev", col("l_extendedprice") * col("l_discount"))
            .agg(col("rev").sum().alias("revenue")))


def _close(got, want, floats):
    assert list(got) == list(want)
    for c in got:
        if c in floats:
            np.testing.assert_allclose(got[c], want[c], rtol=RTOL, atol=0.0, err_msg=c)
        else:
            assert got[c] == want[c], c


@pytest.mark.parametrize("name,node_type", [("q1", pp.DeviceGroupedAgg),
                                            ("q6", pp.DeviceFilterAgg)])
def test_tpch_chain_plans_one_device_node_over_the_scan(lineitem, name, node_type):
    query = {"q1": q1_chain, "q6": q6_chain}[name]
    plan = _plan(lambda dt, d: query(dt, d), lineitem[1])
    nodes = [n for n in plan.walk() if isinstance(n, (pp.DeviceGroupedAgg,
                                                       pp.DeviceFilterAgg))]
    assert len(nodes) == 1 and isinstance(nodes[0], node_type)
    assert isinstance(nodes[0].input, pp.InMemoryScan)
    assert not any(isinstance(n, (pp.Project, pp.PhysFilter)) for n in plan.walk())
    # the optimizer moved each Filter under the Projects and put its pruning
    # Project over the scan; the region fuses them all, as the reference's
    assert nodes[0].region_ops == {
        "q1": ("project", "filter", "project", "project", "agg"),
        "q6": ("project", "filter", "project", "agg")}[name]
    # under region_mode="off" the Project stays a host operator
    off = _plan(lambda dt, d: query(dt, d), lineitem[1], region_mode="off")
    assert any(isinstance(n, pp.Project) for n in off.walk())


def test_q1_chain_is_q1(lineitem):
    """The composed chain is q1's own expressions: the same stage, the same
    results bit for bit, and the reference's within its tolerance."""
    from benchmarking.tpch import queries

    ref, port = lineitem
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        chain = q1_chain(daft_tpu_torch, port).to_pydict()
        snap = counters.snapshot()
        q1 = _q1_port(port).to_pydict()
    with ref_ctx(device_mode="off"):
        plain = queries.q1({"lineitem": ref}).to_pydict()
    assert chain == q1
    assert snap["device_region_ops_fused"] == 5 * snap["device_region_dispatches"] == 5
    _close(chain, plain, Q1_AGGS[:7])
    with ref_ctx(device_mode="on", pallas_mode="on", mesh_devices=1):
        _close(chain, q1_chain(daft_tpu, ref).to_pydict(), Q1_AGGS[:7])


def _q1_port(L):
    col, lit = daft_tpu_torch.col, daft_tpu_torch.lit
    return (L.where(col("l_shipdate") <= lit(datetime.date(1998, 9, 2)))
            .groupby("l_returnflag", "l_linestatus")
            .agg(col("l_quantity").sum().alias("sum_qty"),
                 col("l_extendedprice").sum().alias("sum_base_price"),
                 (col("l_extendedprice") * (1 - col("l_discount"))).sum().alias("sum_disc_price"),
                 (col("l_extendedprice") * (1 - col("l_discount")) * (1 + col("l_tax")))
                 .sum().alias("sum_charge"),
                 col("l_quantity").mean().alias("avg_qty"),
                 col("l_extendedprice").mean().alias("avg_price"),
                 col("l_discount").mean().alias("avg_disc"),
                 col("l_quantity").count().alias("count_order"))
            .sort(["l_returnflag", "l_linestatus"]))


def test_q6_chain_matches_host_and_reference(lineitem):
    ref, port = lineitem
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = q6_chain(daft_tpu_torch, port).to_pydict()
    assert counters.device_stage_batches == 1 and counters.device_region_dispatches == 1
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        _close(got, q6_chain(daft_tpu_torch, port).to_pydict(), ("revenue",))
    with ref_ctx(device_mode="on", pallas_mode="on", mesh_devices=1):
        _close(got, q6_chain(daft_tpu, ref).to_pydict(), ("revenue",))


def test_warm_chain_run_uploads_nothing_new(lineitem, monkeypatch):
    """The fused stage reads the scan's own Series, so a warm run finds
    every plane resident; unfused, the host Filter (which the optimizer put
    under the Projects) and the Projects make new Series on every run:
    with no orphans kept (``ORPHAN_CAP`` 0, the reference's default outside
    its workers) each run uploads the five the stage reads again, and by
    default their planes rebind by content (``hbm_stable_rehits``)."""
    from daft_tpu_torch.core.series import Series
    from daft_tpu_torch.device import residency
    from daft_tpu_torch.device.residency import manager

    port = lineitem[1]
    uploads = []
    real = Series.to_device

    def counting(self, *args, **kwargs):
        uploads.append(self.name)
        return real(self, *args, **kwargs)

    monkeypatch.setattr(Series, "to_device", counting)
    five = sorted(["charge", "disc_price", "l_discount", "l_extendedprice", "l_quantity"])
    for mode, orphans, warm_uploads in (("on", 0, 0), ("off", 0, 5),
                                        ("off", residency.ORPHAN_CAP, 0)):
        manager().clear()
        monkeypatch.setattr(residency, "ORPHAN_CAP", orphans)
        with daft_tpu_torch.execution_config_ctx(device="cpu", region_mode=mode):
            q1_chain(daft_tpu_torch, port).to_pydict()
            uploads.clear()
            counters.reset()
            q1_chain(daft_tpu_torch, port).to_pydict()
        assert sorted(uploads) == (five if warm_uploads else []), (mode, orphans, uploads)
        if mode == "off" and orphans:
            assert counters.hbm_stable_rehits >= 5


_OFF_QUERY = """
import sys
sys.path.insert(0, {repo!r})
import daft_tpu_torch as dt
from daft_tpu_torch import col
df = dt.from_pydict({{"k": [i % 5 for i in range(256)], "v": list(range(256))}})
with dt.execution_config_ctx(device_mode="off"):
    out = (df.select(col("k"), (col("v") * 3).alias("w")).where(col("w") > 30)
           .groupby("k").agg(col("w").sum().alias("s")).sort("k").to_pydict())
assert out["k"] == [0, 1, 2, 3, 4], out
print("REGION", "daft_tpu_torch.ops.region" in sys.modules)
"""


def test_device_off_never_imports_the_region_module():
    proc = subprocess.run([sys.executable, "-c", _OFF_QUERY.format(repo=REPO)],
                          capture_output=True, text=True, timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
    assert "REGION False" in proc.stdout, proc.stdout
