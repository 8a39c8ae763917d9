"""The port's out-of-core operators (daft_tpu_torch/execution/executor.py's
budgeted arms over memory/) against the reference's (daft_tpu/execution/
executor.py, tests/test_oom_budget.py), on the same seeded columns carried
across (``from_numpy_columns``), the reference under device_mode="off":

- Grace aggregation: splittable aggregations (partials spilled) and a
  count_distinct (raw rows spilled), grouped and ungrouped;
- the external sort: ties across runs, descending keys with nulls, strings,
  and a cascade past 16 runs;
- the Grace join: inner, left, semi and anti;
- the Grace window;
- scan backpressure and the budgeted decode-ahead over Parquet;
- TPC-H q1, q3, q4, q5, q6, q10, q12, q14 and q19 at SF 0.01 under 10 % of
  the tables' bytes.

Each budgeted result equals the unbudgeted one and the reference's under
the same budget. Where both engines see the same batches and the same
``size_bytes`` (the spill is synchronous, ``spill_io_threads=0``, so no
queued write is on the ledger), the spill counters and the rows' order equal
the reference's too.

Tolerance (the ROADMAP's rule): integers, counts, strings, dates and
min/max bit for bit; float sums and means within rtol 1e-5 against the
reference; the port budgeted against the port unbudgeted exactly, except
where Grace partitioning reorders the rows that feed a float sum (stated
at the test).
"""

import os
import types

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch as dt
import daft_tpu_torch.functions  # noqa: F401  (dt.functions)
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.execution import memory as ref_mem
from daft_tpu.observability.metrics import registry
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.memory import manager, reset_counters, spill_root
from daft_tpu_torch.ops import counters

SEED = 20261018
COUNTERS = ("spill_batches", "spill_bytes", "spill_files", "spill_runs",
            "spill_merge_passes", "host_over_budget_events")


@pytest.fixture(autouse=True)
def _clean():
    reset_counters()
    manager().clear()
    ref_mem.reset_counters()
    ref_mem.manager().clear()
    yield
    assert manager().tracked_bytes() == 0, "a query left bytes on the ledger"
    manager().clear()
    ref_mem.manager().clear()


def _norm(v):
    return "nan" if isinstance(v, float) and v != v else v


def same(got: dict, want: dict, floats=(), ordered=True) -> bool:
    """Equal pydicts: exactly, ``floats`` columns within rtol 1e-5; with
    ``ordered`` False, as multisets of rows."""
    if list(got) != list(want):
        return False
    if not ordered:
        def rows(d):
            cols = list(d)
            return sorted(zip(*[[("~" if v is None else _norm(v)) for v in d[c]]
                                for c in cols]), key=repr)
        g, w = rows(got), rows(want)
        got = {c: [r[i] for r in g] for i, c in enumerate(got)}
        want = {c: [r[i] for r in w] for i, c in enumerate(want)}
    for c in got:
        if c in floats:
            a = np.array([np.nan if v in (None, "~") else v for v in got[c]], dtype=float)
            b = np.array([np.nan if v in (None, "~") else v for v in want[c]], dtype=float)
            if len(a) != len(b) or not np.allclose(a, b, rtol=1e-5, atol=0.0, equal_nan=True):
                return False
        elif [_norm(v) for v in got[c]] != [_norm(v) for v in want[c]]:
            return False
    return True


def _pair(cols: dict, kinds: dict, parts: int = 1):
    """(reference frame, port frame) over the same columns, cut into the
    same ``parts`` in-memory partitions."""
    from daft_tpu.plan.builder import LogicalPlanBuilder
    from daft_tpu_torch.plan import logical as lp

    port_whole = from_numpy_columns(cols, {c: dt.DataType(k) for c, k in kinds.items()})
    batch = port_whole._plan.partitions[0].concat_or_empty()
    n = batch.num_rows
    bounds = [n * i // parts for i in range(parts + 1)]
    pieces = [batch.slice(a, b) for a, b in zip(bounds[:-1], bounds[1:])]
    port = dt.DataFrame(lp.InMemorySource(batch.schema, [dt.MicroPartition(batch.schema, [p])
                                                          for p in pieces]))
    ref_parts = []
    for p in pieces:
        data = {c: p.get_column(c).to_pylist() for c in kinds}
        ref_parts.append(daft_tpu.from_pydict(data).with_columns(
            {c: daft_tpu.col(c).cast(daft_tpu.DataType(k)) for c, k in kinds.items()})
            .collect()._result[0])
    ref = daft_tpu.DataFrame(LogicalPlanBuilder.from_in_memory(ref_parts[0].schema, ref_parts))
    return ref, port


def _fact(n=60_000, seed=SEED, parts=6):
    rng = np.random.default_rng(seed)
    vocab = np.array(["AIR", "MAIL", "SHIP", "RAIL", "TRUCK", "FOB"], dtype=object)
    cols = {"k": (rng.integers(0, 400, n), np.ones(n, bool)),
            "g": (rng.integers(0, 7, n), rng.random(n) < 0.97),
            "v": (rng.integers(-1000, 1000, n), rng.random(n) < 0.95),
            "x": (rng.standard_normal(n), rng.random(n) < 0.97),
            "s": (vocab[rng.integers(0, 6, n)], rng.random(n) < 0.98),
            "d": (rng.integers(9000, 9400, n).astype(np.int32), np.ones(n, bool))}
    kinds = {"k": "int64", "g": "int64", "v": "int64", "x": "float64", "s": "string",
             "d": "date"}
    return _pair(cols, kinds, parts)


@pytest.fixture(scope="module")
def fact():
    return _fact()


@pytest.fixture(scope="module")
def dim():
    rng = np.random.default_rng(SEED + 1)
    n = 30_000
    # about 0.3 matches a fact row: a build side over the budget, a small output
    cols = {"dk": (rng.integers(0, 40_000, n), rng.random(n) < 0.98),
            "w": (rng.integers(0, 1000, n), rng.random(n) < 0.9),
            "t": (rng.standard_normal(n), np.ones(n, bool))}
    return _pair(cols, {"dk": "int64", "w": "int64", "t": "float64"}, 3)


def _port(query, budget, **cfg):
    reset_counters()
    manager().clear()
    with dt.execution_config_ctx(device="cpu", device_mode=cfg.pop("device_mode", "off"),
                                 memory_limit_bytes=budget, **cfg):
        out = query(dt).to_pydict()
    return out, counters.snapshot()


def _ref(query, budget, **cfg):
    ref_mem.reset_counters()
    ref_mem.manager().clear()
    with ref_ctx(device_mode="off", memory_limit_bytes=budget, **cfg):
        out = query(daft_tpu).to_pydict()
    return out, registry().snapshot()


SYNC = {"spill_io_threads": 0, "spill_prefetch_batches": 0}


def _check(query, budget, floats=(), ordered=True, port_cfg=None, ref_cfg=None, spills=True,
           self_ordered=None, self_floats=(), counters_equal=False):
    """The port budgeted equals the port unbudgeted (in order unless
    ``self_ordered`` is False, exactly but for ``self_floats``) and the
    reference budgeted (``floats`` within the rule, in order unless
    ``ordered`` is False); returns the port's counters."""
    port_cfg = dict(port_cfg or {})
    self_ordered = ordered if self_ordered is None else self_ordered
    want, _ = _port(query, 0, **port_cfg)
    got, snap = _port(query, budget, **port_cfg)
    ref, rsnap = _ref(query, budget, **(ref_cfg or {}))
    assert same(got, want, self_floats, ordered=self_ordered)
    assert same(got, ref, floats, ordered=ordered)
    if spills:
        assert snap["spill_bytes"] > 0 and snap["host_over_budget_events"] > 0
    if counters_equal:
        assert {c: snap[c] for c in COUNTERS} == {c: int(rsnap.get(c, 0)) for c in COUNTERS}
    return snap


# ---- Grace aggregation ---------------------------------------------------------------


def test_grace_agg_split_spills_partials(fact):
    ref, port = fact
    frames = {daft_tpu: ref, dt: port}

    def q(d):
        c = d.col
        return (frames[d].groupby("k", "g").agg(c("v").sum().alias("sv"),
                                                c("x").sum().alias("sx"),
                                                c("x").mean().alias("mx"),
                                                c("d").min().alias("lo"),
                                                c("s").count().alias("n"))
                .sort(["k", "g"]))

    snap = _check(q, 200_000, floats=("sx", "mx"), port_cfg={"morsel_size_rows": 4096})
    assert snap["spill_files"] == 32 and snap["spill_runs"] == 0


def test_grace_agg_split_partials_and_order_equal_reference(fact):
    """One partial a batch (the morsel no smaller than a batch), as the
    reference's Grace aggregation does: the same partials spill, as many
    batches into as many files, and the groups come out in the reference's
    order. Their bytes differ: the reference's aggregation kernels give
    every output column a validity bitmap, nulls or none (Arrow's
    ``nbytes`` counts it), where the port counts one only under a null."""
    ref, port = fact
    frames = {daft_tpu: ref, dt: port}

    def q(d):
        c = d.col
        return frames[d].groupby("g").agg(c("v").sum().alias("sv"), c("v").max().alias("mv"),
                                          c("x").min().alias("mn"))

    snap = _check(q, 200_000, port_cfg={"morsel_size_rows": 1 << 20, **SYNC}, ref_cfg=SYNC,
                  self_ordered=False)
    _ref_out, rsnap = _ref(q, 200_000, **SYNC)
    for c in ("spill_batches", "spill_files", "host_over_budget_events"):
        assert snap[c] == rsnap[c] > 0, c


def test_grace_agg_unsplittable_spills_raw_rows_and_matches_reference_order(fact):
    ref, port = fact
    frames = {daft_tpu: ref, dt: port}

    def q(d):
        c = d.col
        return frames[d].groupby("k").agg(c("v").count_distinct().alias("cd"),
                                          c("x").sum().alias("sx"))

    got = _check(q, 300_000, floats=("sx",), port_cfg=SYNC, ref_cfg=SYNC,
                 counters_equal=True, self_ordered=False)
    assert got["spill_files"] == 32


@pytest.mark.parametrize("distinct", [False, True])
def test_grace_agg_ungrouped(fact, distinct):
    ref, port = fact
    frames = {daft_tpu: ref, dt: port}

    def q(d):
        c = d.col
        aggs = [c("v").sum().alias("sv"), c("x").mean().alias("mx"),
                c("d").max().alias("hi"), c("s").count().alias("n")]
        if distinct:
            aggs.append(c("s").count_distinct().alias("cd"))
        return frames[d].agg(*aggs)

    # with a count_distinct the in-memory path sums each column at once and
    # the spilled one batch by batch: the mean agrees within the rule
    snap = _check(q, 200_000, floats=("mx",), port_cfg={"morsel_size_rows": 4096},
                  spills=distinct, self_floats=("mx",) if distinct else ())
    if distinct:  # the raw rows spill once, then the distinct values by hash
        assert snap["spill_files"] >= 2
    else:  # the partials stream: nothing spills
        assert snap["spill_bytes"] == 0 and snap["host_over_budget_events"] == 1


# ---- the external sort ---------------------------------------------------------------


@pytest.mark.parametrize("case", ["ties", "desc_nulls", "strings"])
def test_external_sort_equals_in_memory_and_reference(fact, case):
    ref, port = fact
    frames = {daft_tpu: ref, dt: port}
    sorts = {"ties": (["g"], [False], None),  # 7 values: ties across every run
             "desc_nulls": (["g", "v"], [True, False], [False, True]),
             "strings": (["s", "d", "k"], [True, False, True], None)}
    by, desc, nf = sorts[case]

    def q(d):
        df = frames[d]
        if nf is None:
            return df.sort(by, desc=desc)
        return df.sort(by, desc=desc, nulls_first=nf)

    snap = _check(q, 250_000, port_cfg=SYNC, ref_cfg=SYNC, counters_equal=True)
    assert snap["spill_runs"] >= 2


def test_external_sort_cascades_past_the_fan_in():
    ref, port = _fact(n=40_000, parts=40)
    frames = {daft_tpu: ref, dt: port}

    def q(d):
        return frames[d].sort(["x", "k"])

    snap = _check(q, 40_000, port_cfg={"morsel_size_rows": 1024, **SYNC}, ref_cfg=SYNC)
    assert snap["spill_runs"] > 16 and snap["spill_merge_passes"] > 0
    assert snap["spill_merge_sort_rows"] > 0


@pytest.mark.parametrize("io", ["sync", "async"])
def test_external_sort_async_equals_sync(fact, io):
    _ref_f, port = fact
    cfg = SYNC if io == "sync" else {"spill_io_threads": 2, "spill_prefetch_batches": 2}
    want, _ = _port(lambda d: port.sort(["x", "k"]), 0)
    got, snap = _port(lambda d: port.sort(["x", "k"]), 150_000, **cfg)
    assert same(got, want)
    assert snap["spill_runs"] >= 2
    if io == "async":
        assert snap["spill_write_seconds"] > 0 and snap["spill_read_seconds"] > 0


# ---- the Grace join ------------------------------------------------------------------


@pytest.mark.parametrize("how", ["inner", "left", "semi", "anti"])
def test_grace_join(fact, dim, how):
    (ref_f, port_f), (ref_d, port_d) = fact, dim
    frames = {daft_tpu: (ref_f, ref_d), dt: (port_f, port_d)}

    def q(d):
        f, g = frames[d]
        return f.join(g, left_on="k", right_on="dk", how=how)

    snap = _check(q, 150_000, ordered=False, port_cfg=SYNC, ref_cfg=SYNC)
    assert snap["spill_files"] == 32


def test_grace_join_feeding_an_aggregate(fact, dim):
    (ref_f, port_f), (ref_d, port_d) = fact, dim
    frames = {daft_tpu: (ref_f, ref_d), dt: (port_f, port_d)}

    def q(d):
        f, g = frames[d]
        c = d.col
        return (f.join(g, left_on="k", right_on="dk").groupby("g")
                .agg(c("w").sum().alias("sw"), c("t").sum().alias("st"),
                     c("v").count().alias("n")).sort("g"))

    # the join's output reaches the float sum in spill-partition order
    _check(q, 150_000, floats=("st",), port_cfg=SYNC, ref_cfg=SYNC, self_floats=("st",))


# ---- the Grace window ----------------------------------------------------------------


def test_grace_window(fact):
    from daft_tpu.window import Window as RefWindow
    from daft_tpu_torch.window import Window

    ref, port = fact
    frames = {daft_tpu: (ref, RefWindow), dt: (port, Window)}

    def q(d):
        df, W = frames[d]
        fns = daft_tpu.functions if d is daft_tpu else dt.functions
        w = W().partition_by("k").order_by("d", "v", "x")
        c = d.col
        return df.select(c("k"), c("d"), c("v"), c("x"),
                         fns.row_number().over(w).alias("rn"),
                         fns.rank().over(w).alias("rk"),
                         c("v").sum().over(w).alias("rs"),
                         c("x").lag(1).over(w).alias("lx"),
                         c("x").sum().over(W().partition_by("k")).alias("tot"))

    # a window's sums are prefix-sum differences over its sorted input, so
    # the spilled layout moves their last bits
    snap = _check(q, 200_000, floats=("tot",), ordered=False, port_cfg=SYNC, ref_cfg=SYNC,
                  counters_equal=True, self_floats=("tot",))
    assert snap["spill_files"] == 32  # two window specs, 16 partitions each


def test_global_window_over_budget_gathers(fact):
    from daft_tpu_torch.window import Window

    _ref, port = fact
    def q(_d):
        return port.select(dt.col("k"), dt.functions.row_number().over(
            Window().order_by("x", "k")).alias("rn"))

    want, _ = _port(q, 0)
    got, snap = _port(q, 100_000)
    assert got == want and snap["spill_bytes"] == 0 and snap["host_over_budget_events"] == 1


# ---- scans ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory, fact):
    _ref, port = fact
    root = str(tmp_path_factory.mktemp("ooc_scan"))
    with dt.execution_config_ctx(device="cpu"):
        port.write_parquet(root)
    return root


def _hold_first_release_until_the_scan_sees_pressure(monkeypatch):
    """Pin the scan's stall under the pipeline: the sort's first release of
    ledger bytes (after its first spill) waits, at most 10 s, until the
    scan thread has asked ``under_pressure`` and been told yes. Each batch
    here is over the budget, so the sort holds bytes only while it spills
    one; the scan asks after each morsel it hands on, and on a loaded host
    it could ask only between spills and never stall."""
    import threading

    from daft_tpu_torch.memory.manager import HostMemoryManager

    seen = threading.Event()
    real_pressure = HostMemoryManager.under_pressure
    real_release = HostMemoryManager.release

    def under_pressure(self):
        yes = real_pressure(self)
        if yes:
            seen.set()
        return yes

    def release(self, nbytes):
        seen.wait(10.0)
        return real_release(self, nbytes)

    monkeypatch.setattr(HostMemoryManager, "under_pressure", under_pressure)
    monkeypatch.setattr(HostMemoryManager, "release", release)


@pytest.mark.parametrize("pipeline_mode", ["off", "force"])
def test_scan_backpressure_and_decode_ahead(parquet_dir, monkeypatch, pipeline_mode):
    """A budgeted scan under a spilling sort waits (boundedly) for headroom,
    counts its bytes, decodes ahead on the spill pool, and gives the
    unbudgeted rows; unbudgeted, none of this runs."""
    from daft_tpu_torch.memory import spill as spill_mod

    calls = []
    real = spill_mod.prefetch_iter

    def spy(*args, **kwargs):
        calls.append(args[1])
        return real(*args, **kwargs)

    monkeypatch.setattr(spill_mod, "prefetch_iter", spy)

    def q(d):
        return dt.read_parquet(parquet_dir).where(dt.col("v") > -900).sort(["x", "k"])

    cfg = {"pipeline_mode": pipeline_mode, "morsel_size_rows": 4096,
           "scan_split_bytes": 100_000}
    want, snap0 = _port(q, 0, **cfg)
    assert not calls and snap0["scan_bytes"] == 0 and snap0["scan_backpressure_stalls"] == 0
    if pipeline_mode == "force":
        _hold_first_release_until_the_scan_sees_pressure(monkeypatch)
    got, snap = _port(q, 120_000, memory_pressure=0.5, **cfg)
    assert got == want
    assert calls and set(calls) == {2}  # every reader decoded ahead, depth 2
    assert snap["scan_bytes"] > 0 and snap["spill_runs"] >= 2
    if pipeline_mode == "force":  # the scan runs ahead of the sort on its own thread
        assert snap["scan_backpressure_stalls"] > 0 and snap["scan_stall_ms"] > 0


# ---- cancellation --------------------------------------------------------------------


def test_abandoned_spilling_query_removes_its_spill_files(fact):
    from daft_tpu_torch.execution.executor import execute_plan
    from daft_tpu_torch.plan.physical import translate

    _ref, port = fact
    with dt.execution_config_ctx(device="cpu", device_mode="off", memory_limit_bytes=150_000,
                                 morsel_size_rows=2048, pipeline_mode="force"):
        df = port.sort(["x", "k"])
        it = execute_plan(translate(df.optimized_plan()))
        assert next(it).num_rows > 0
        assert counters.spill_files > 0
        it.close()
    root = spill_root()
    if os.path.isdir(root):
        assert not [n for n in os.listdir(root) if f"{os.getpid()}_" in n]


# ---- TPC-H ---------------------------------------------------------------------------

TPCH = (1, 3, 4, 5, 6, 10, 12, 14, 19)


def _port_queries():
    """benchmarking/tpch/queries.py with the port's ``col`` and ``lit``."""
    import benchmarking.tpch.queries as q

    src = open(q.__file__).read()
    mod = types.ModuleType("port_tpch_queries")
    exec(compile(src.replace("from daft_tpu import", "from daft_tpu_torch import"),
                 q.__file__, "exec"), mod.__dict__)
    return mod.ALL_QUERIES


def _carry(ref_df):
    batch = ref_df.collect()._result[0].concat_or_empty()
    schema = dt.Schema.from_pydict({f.name: dt.DataType(f.dtype.kind) for f in ref_df.schema})
    return from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)


@pytest.fixture(scope="module")
def tpch():
    from benchmarking.tpch.datagen import generate
    from benchmarking.tpch.queries import ALL_QUERIES

    ref = {k: daft_tpu.from_arrow(v).collect() for k, v in generate(0.01, 0).items()}
    port = {k: _carry(v) for k, v in ref.items()}
    total = sum(b.size_bytes() for df in port.values()
                for p in df._plan.partitions for b in p.batches)
    return ref, port, ALL_QUERIES, _port_queries(), max(int(total * 0.1), 1 << 16)


TPCH_FLOATS = {1: ("sum_base_price", "sum_disc_price", "sum_charge", "avg_qty", "avg_price",
                   "avg_disc", "sum_qty"),
               3: ("revenue",), 5: ("revenue",), 6: ("revenue",), 10: ("revenue",
                                                                        "c_acctbal"),
               14: ("promo_revenue",), 19: ("revenue",)}


@pytest.mark.parametrize("device_mode", ["off", "on"])
@pytest.mark.parametrize("qnum", TPCH)
def test_tpch_under_ten_percent_budget(tpch, qnum, device_mode):
    ref, port, ref_q, port_q, budget = tpch
    want, _ = _port(lambda d: port_q[qnum](port), 0, device_mode=device_mode)
    got, snap = _port(lambda d: port_q[qnum](port), budget, device_mode=device_mode)
    with ref_ctx(device_mode="off", memory_limit_bytes=budget):
        ref_out = ref_q[qnum](ref).to_pydict()
    floats = TPCH_FLOATS.get(qnum, ())
    if device_mode == "off":
        assert got == want, f"q{qnum} changed under the budget"
    else:  # the device stages' float sums follow the morsels
        assert same(got, want, floats)
    assert same(got, ref_out, floats)


def test_tpch_suite_spills_at_ten_percent(tpch):
    ref, port, _ref_q, port_q, budget = tpch
    reset_counters()
    with dt.execution_config_ctx(device="cpu", device_mode="off", memory_limit_bytes=budget):
        with manager().query_scope() as scope:
            for qnum in TPCH:
                port_q[qnum](port).to_pydict()
    assert counters.host_over_budget_events > 0 and counters.spill_bytes > 0
    assert 0 < scope.peak_bytes() and manager().tracked_bytes() == 0
