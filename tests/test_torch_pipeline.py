"""The port's pipelined streaming executor (daft_tpu_torch/execution/
pipeline.py, utils/pool.py and the pipeline arms of execution/executor.py),
held against the reference's (daft_tpu/execution/pipeline.py,
tests/test_pipeline.py's behaviours):

- ``Channel``, ``spawn_stage``, ``pmap_stream`` and ``morsels``: overlap,
  errors, cancellation unwinding the producer on its own thread,
  backpressure, order, zero-copy morsels (the reference's boundaries), no
  stage running before the first pull or after a limit; stage threads kept
  and reused, grown past any width, ended when idle;
- the compute pool's width and ``_pipeline_on``'s rule;
- queries over columns carried across from the reference give the same
  rows, in the same order, under ``pipeline_mode`` "off", "on" and
  "force", equal to the reference's (integers, counts and min/max bit for
  bit, float sums within rtol 1e-5): a multi-task Parquet scan (a small
  ``scan_split_bytes``, read in the IO-parallel window), a Filter ->
  Project -> grouped aggregate, a join under a filter, a limit;
- a device stage (device="cpu": the kernels' plain versions) runs from a
  stage thread; after every query, a limited or failed one included, no
  ``daft-stage`` thread is alive and no residency entry is pinned.
"""

import os
import threading
import time

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.execution import pipeline as ref_pipeline
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.execution import executor as ex
from daft_tpu_torch.execution.pipeline import (STAGE_THREAD_NAME, Channel, StageCancelled,
                                               morsels, pmap_stream, spawn_stage)
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import segment_kernels as sk
from daft_tpu_torch.utils import pool as pool_mod

SEED = 20261018
MODES = ("off", "on", "force")


def _stage_threads() -> int:
    return sum(1 for t in threading.enumerate() if t.name.startswith(STAGE_THREAD_NAME))


def _assert_clean():
    """No stage thread alive and nothing pinned, right after a query."""
    assert _stage_threads() == 0, [t.name for t in threading.enumerate()]
    assert manager().pinned_count() == 0


@pytest.fixture
def wide_pool():
    """A 4-thread compute pool, whatever the host's cores."""
    from concurrent.futures import ThreadPoolExecutor

    prev = pool_mod._POOL
    pool_mod._POOL = ThreadPoolExecutor(max_workers=4, thread_name_prefix="daft-compute")
    try:
        yield pool_mod._POOL
    finally:
        pool_mod._POOL.shutdown(wait=True)
        pool_mod._POOL = prev


# ---- primitives ----------------------------------------------------------------------


def test_spawn_stage_streams_and_overlaps():
    def produce():
        for i in range(4):
            time.sleep(0.1)
            yield i

    t0 = time.perf_counter()
    out = []
    for item in spawn_stage(produce()):
        time.sleep(0.1)  # the consumer's work overlaps the producer's
        out.append(item)
    assert out == [0, 1, 2, 3]
    assert time.perf_counter() - t0 < 0.7  # serial would take 0.8 s, overlapped 0.5
    _assert_clean()


def test_spawn_stage_propagates_errors():
    def produce():
        yield 1
        raise ValueError("boom")

    it = spawn_stage(produce())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)
    _assert_clean()


def test_spawn_stage_cancellation_unwinds_producer_on_its_thread():
    cleaned = []

    def produce():
        try:
            for i in range(1000):
                yield i
        finally:
            cleaned.append(threading.current_thread().name)

    it = spawn_stage(produce(), maxsize=2)
    assert next(it) == 0
    it.close()  # the consumer abandons the stream (a limit downstream)
    assert cleaned == [STAGE_THREAD_NAME]  # unwound before close() returned
    _assert_clean()


def test_stage_threads_are_kept_and_reused():
    """A stage's thread goes back to the pool when the stage ends (named
    ``daft-idle``), and the next stage runs on it."""
    from daft_tpu_torch.execution.pipeline import IDLE_THREAD_NAME

    def produce(seen):
        seen.append(threading.get_ident())
        yield 1

    first, second = [], []
    assert list(spawn_stage(produce(first))) == [1]
    assert list(spawn_stage(produce(second))) == [1]
    assert first == second
    _assert_clean()
    assert any(t.name == IDLE_THREAD_NAME and t.ident == first[0]
               for t in threading.enumerate())


def test_stage_pool_grows_past_any_width_and_idle_threads_end(monkeypatch):
    """Forty stages chained run at once (each holds a thread while its
    consumer pulls); a pool's idle threads end after the idle timeout."""
    from daft_tpu_torch.execution import pipeline

    def passthrough(stream):
        for item in stream:
            yield item + 1

    stream = iter(range(100))
    for _ in range(40):
        stream = spawn_stage(passthrough(stream), maxsize=1)
    assert list(stream) == list(range(40, 140))
    _assert_clean()

    monkeypatch.setattr(pipeline, "STAGE_THREAD_IDLE_S", 0.05)
    pool = pipeline._StagePool()
    done = [pool.run(lambda: time.sleep(0.01)) for _ in range(3)]
    assert all(d.wait(timeout=5.0) for d in done)
    workers = list(pool._idle)
    assert workers
    for w in workers:
        w.join(timeout=5.0)
        assert not w.is_alive()
    assert pool._idle == []


def test_channel_backpressure_bounds_producer():
    ch = Channel(maxsize=2)
    produced = []

    def run():
        try:
            for i in range(100):
                ch.put(i)
                produced.append(i)
        except StageCancelled:
            pass

    t = threading.Thread(target=run, daemon=True)
    t.start()
    time.sleep(0.2)
    assert len(produced) <= 3  # 2 queued and 1 in flight: no run-ahead
    it = iter(ch)
    assert [next(it) for _ in range(5)] == [0, 1, 2, 3, 4]
    it.close()
    t.join(timeout=5.0)
    assert not t.is_alive()


def test_channel_carries_the_producer_error():
    ch = Channel()
    ch.put(1)
    ch.close(RuntimeError("from the stage"))
    it = iter(ch)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="from the stage"):
        next(it)


def test_pmap_stream_preserves_order_and_parallelizes(wide_pool):
    def slow_double(x, i):
        time.sleep(0.03)
        return (i, x * 2)

    t0 = time.perf_counter()
    out = list(pmap_stream(iter(range(8)), slow_double, window=4))
    assert out == [(i, i * 2) for i in range(8)]
    assert time.perf_counter() - t0 < 0.03 * 8  # the sleeps overlap


def test_pmap_stream_propagates_worker_errors():
    def fn(x, i):
        if x == 3:
            raise RuntimeError("worker failed")
        return x

    with pytest.raises(RuntimeError, match="worker failed"):
        list(pmap_stream(iter(range(6)), fn))


def test_pmap_stream_feeds_the_strategy():
    seen = []

    class Recorder:
        def current_size(self):
            return 10

        def record(self, rows, seconds):
            seen.append((rows, seconds >= 0))

    parts = [daft_tpu_torch.MicroPartition.from_pydict({"a": np.arange(n)}) for n in (3, 5)]
    assert [p.num_rows for p in pmap_stream(iter(parts), lambda p, i: p,
                                            strategy=Recorder())] == [3, 5]
    assert sorted(seen) == [(3, True), (5, True)]


@pytest.mark.parametrize("rows,morsel", [([10_000], 1024), ([3000, 9000, 100], 1000),
                                         ([2048], 1024), ([5000, 5000], 100_000)])
def test_morsels_cut_the_reference_boundaries_as_views(rows, morsel):
    rng = np.random.default_rng(SEED)
    ref_batches, port_batches = [], []
    for n in rows:
        v = rng.integers(0, 1 << 40, n)
        valid = rng.random(n) < 0.9
        port = from_numpy_columns({"v": (v, valid)}, {"v": daft_tpu_torch.DataType.int64()})
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            port_batches.append(port.collect()._result[0].concat_or_empty())
            data = port.to_pydict()
        ref_batches.append(daft_tpu.from_pydict(data).collect()._result[0].concat_or_empty())
    ref_part = daft_tpu.MicroPartition(ref_batches[0].schema, ref_batches)
    part = daft_tpu_torch.MicroPartition(port_batches[0].schema, port_batches)
    got = morsels(part, morsel)
    want = ref_pipeline.morsels(ref_part, morsel)
    assert [[b.num_rows for b in p.batches] for p in got] == \
        [[b.num_rows for b in p.batches] for p in want]
    assert [v for p in got for b in p.batches for v in b.get_column("v").to_pylist()] == \
        [v for b in port_batches for v in b.get_column("v").to_pylist()]
    for p in got:
        for b in p.batches:
            s = b.get_column("v")
            assert any(np.shares_memory(s.to_numpy(), src.get_column("v").to_numpy())
                       and np.shares_memory(s.validity_numpy(),
                                            src.get_column("v").validity_numpy())
                       for src in port_batches)


def test_pool_width_follows_the_environment(monkeypatch):
    monkeypatch.setattr(pool_mod, "_POOL", None)
    monkeypatch.setenv("DAFT_TPU_NUM_THREADS", "3")
    try:
        assert pool_mod.pool_width() == 3
    finally:
        pool_mod._POOL.shutdown(wait=True)
    monkeypatch.setattr(pool_mod, "_POOL", None)
    monkeypatch.delenv("DAFT_TPU_NUM_THREADS")
    try:
        assert pool_mod.pool_width() == (os.cpu_count() or 4)
    finally:
        pool_mod._POOL.shutdown(wait=True)
    assert pool_mod.pool_map(lambda x: x * 2, [1]) == [2]


def test_pipeline_on_rule(monkeypatch):
    for width, mode, on in ((1, "on", False), (1, "force", True), (1, "off", False),
                            (4, "on", True), (4, "off", False), (4, "force", True)):
        monkeypatch.setattr(pool_mod, "pool_width", lambda w=width: w)
        with daft_tpu_torch.execution_config_ctx(pipeline_mode=mode):
            assert ex._pipeline_on() is on, (width, mode)


def test_unstarted_plan_spawns_no_stage_threads():
    from daft_tpu_torch import col
    from daft_tpu_torch.plan import physical as pp

    df = daft_tpu_torch.from_pydict({"a": np.arange(100_000)})
    with daft_tpu_torch.execution_config_ctx(device="cpu", pipeline_mode="force"):
        stream = ex.execute_plan(pp.translate(df.select((col("a") + 1).alias("b"))
                                              .optimized_plan()))
        del stream
    time.sleep(0.2)
    assert _stage_threads() == 0


# ---- queries --------------------------------------------------------------------------


def _carry(cols: dict, kinds: dict):
    """(reference frame, port frame) of the same seeded columns."""
    port = from_numpy_columns(cols, {c: daft_tpu_torch.DataType(k) for c, k in kinds.items()})
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        data = port.to_pydict()
    ref = daft_tpu.from_pydict(data).with_columns(
        {c: daft_tpu.col(c).cast(daft_tpu.DataType(k)) for c, k in kinds.items()})
    return ref, port


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(SEED)
    n = 200_000
    vocab = np.array(["AIR", "MAIL", "SHIP", "RAIL", "TRUCK"], dtype=object)
    mask = rng.random(n) < 0.95
    fact = {"k": (rng.integers(0, 300, n), np.ones(n, dtype=bool)),
            "v": (rng.integers(-(1 << 40), 1 << 40, n), mask),
            "x": (rng.standard_normal(n), rng.random(n) < 0.97),
            "s": (vocab[rng.integers(0, 5, n)], np.ones(n, dtype=bool)),
            "d": (rng.integers(9000, 9600, n).astype(np.int32), np.ones(n, dtype=bool))}
    dim = {"dk": (np.arange(300), np.ones(300, dtype=bool)),
           "w": (rng.integers(0, 50, 300), rng.random(300) < 0.9)}
    f = _carry(fact, {"k": "int64", "v": "int64", "x": "float64", "s": "string",
                      "d": "date"})
    d = _carry(dim, {"dk": "int64", "w": "int64"})
    return f, d


def _same(got: dict, want: dict, floats=()) -> bool:
    if list(got) != list(want):
        return False
    for c in got:
        if c in floats:
            g = np.array([np.nan if v is None else v for v in got[c]], dtype=float)
            w = np.array([np.nan if v is None else v for v in want[c]], dtype=float)
            if [v is None for v in got[c]] != [v is None for v in want[c]] or \
                    not np.allclose(g, w, rtol=1e-5, atol=0.0, equal_nan=True):
                return False
        elif got[c] != want[c]:
            return False
    return True


def _queries():
    """name -> (query(dt, fact, dim), float columns)."""
    def grouped(dt, f, _d):
        c = dt.col
        return (f.where(c("v") > -(1 << 39)).with_column("t", c("v") * 3 + c("k"))
                .groupby("s").agg(c("t").sum().alias("st"), c("x").sum().alias("sx"),
                                  c("v").min().alias("lo"), c("d").max().alias("hi"),
                                  c("x").count().alias("n"))
                .sort("s"))

    def join(dt, f, d):
        c = dt.col
        return (f.where(c("x") > 0.25).join(d, left_on="k", right_on="dk")
                .where(c("w") > 10).groupby("w").agg(c("v").sum().alias("sv"),
                                                     c("x").mean().alias("mx"))
                .sort("w"))

    def limit(dt, f, _d):
        c = dt.col
        return f.where(c("x") > 0.0).select(c("v"), (c("k") + 1).alias("k1")).limit(1234)

    def ungrouped(dt, f, _d):
        c = dt.col
        return f.where(c("k") < 200).agg(c("x").sum().alias("sx"), c("v").max().alias("mv"),
                                         c("v").count().alias("n"))

    return {"grouped": (grouped, ("sx",)), "join": (join, ("mx",)), "limit": (limit, ()),
            "ungrouped": (ungrouped, ("sx",))}


@pytest.mark.parametrize("name", ["grouped", "join", "limit", "ungrouped"])
@pytest.mark.parametrize("device_mode", ["off", "on"])
def test_queries_equal_in_every_pipeline_mode_and_to_reference(frames, name, device_mode):
    (ref_f, port_f), (ref_d, port_d) = frames
    query, floats = _queries()[name]
    with ref_ctx(device_mode="off"):
        want = query(daft_tpu, ref_f, ref_d).to_pydict()
    got = {}
    for mode in MODES:
        counters.reset()
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode=device_mode,
                                                 pipeline_mode=mode, morsel_size_rows=16_384):
            got[mode] = query(daft_tpu_torch, port_f, port_d).to_pydict()
        _assert_clean()
        assert _same(got[mode], want, floats), (mode, name)
    # the modes agree with each other to the same rule (the order of the
    # partial sums follows the morsels)
    assert _same(got["on"], got["off"], floats) and _same(got["force"], got["off"], floats)


@pytest.fixture(scope="module")
def parquet_dir(tmp_path_factory):
    """Four Parquet files of row groups of 5,000 rows, written by pyarrow."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(SEED + 1)
    root = tmp_path_factory.mktemp("pipeline_scan")
    for i in range(4):
        n = 20_000
        t = pa.table({"k": pa.array(rng.integers(0, 50, n)),
                      "v": pa.array(rng.integers(-1000, 1000, n), mask=rng.random(n) < 0.05),
                      "x": pa.array(rng.standard_normal(n)),
                      "s": pa.array(rng.choice(["a", "bb", "ccc"], n))})
        pq.write_table(t, str(root / f"part-{i}.parquet"), row_group_size=5000)
    return str(root)


def test_multi_task_scan_equal_in_every_pipeline_mode_and_to_reference(parquet_dir):
    def q(dt):
        c = dt.col
        return (dt.read_parquet(parquet_dir).where(c("v") > -900)
                .with_column("t", c("v") * 2).groupby("s", "k")
                .agg(c("t").sum().alias("st"), c("x").sum().alias("sx"),
                     c("v").max().alias("mv")).sort(["s", "k"]))

    def rows(dt):
        return dt.read_parquet(parquet_dir).select(dt.col("v"), dt.col("s"))

    with ref_ctx(device_mode="off"):
        want = q(daft_tpu).to_pydict()
        want_rows = rows(daft_tpu).to_pydict()
    for mode in MODES:
        for device_mode in ("off", "on"):
            counters.reset()
            with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode=device_mode,
                                                     pipeline_mode=mode,
                                                     scan_split_bytes=20_000,
                                                     morsel_size_rows=4096):
                got = q(daft_tpu_torch).to_pydict()
                snap = counters.snapshot()
                assert rows(daft_tpu_torch).to_pydict() == want_rows  # the rows' order
            _assert_clean()
            assert _same(got, want, ("sx",)), (mode, device_mode)
            kept = sum(1 for v in want_rows["v"] if v is not None and v > -900)
            assert snap["scan_tasks"] == 16 and snap["scan_rows"] == kept, snap
            windowed = mode != "off"
            assert (snap["scan_window_tasks"] == 16) == windowed, snap
            assert (snap["scan_window_peak"] >= 1) == windowed, snap


def test_scan_limit_streams_and_counts_exactly(parquet_dir):
    for mode in MODES:
        counters.reset()
        with daft_tpu_torch.execution_config_ctx(device="cpu", pipeline_mode=mode,
                                                 scan_split_bytes=20_000):
            out = daft_tpu_torch.read_parquet(parquet_dir).limit(7000).to_pydict()
        _assert_clean()
        assert len(out["v"]) == 7000
        snap = counters.snapshot()
        assert snap["scan_rows"] == 7000 and snap["scan_window_tasks"] == 0, snap


def test_device_stage_runs_on_a_stage_thread(frames, monkeypatch):
    (_ref_f, port_f), _dims = frames
    threads = []
    plain = sk.segment_sum_planes

    def spy(*args, **kwargs):
        threads.append(threading.current_thread().name)
        return plain(*args, **kwargs)

    monkeypatch.setattr(sk, "segment_sum_planes", spy)
    from daft_tpu_torch import col

    def q():
        return port_f.groupby("s").agg(col("v").sum().alias("sv")).sort("s").to_pydict()

    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on", pipeline_mode="off"):
        want = q()
    assert threads and set(threads) == {"MainThread"}
    threads.clear()
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on",
                                             pipeline_mode="force"):
        assert q() == want
    assert threads and set(threads) == {STAGE_THREAD_NAME}
    assert counters.device_grouped_batches >= 1
    _assert_clean()


def test_limit_and_failure_leave_no_stage_thread_or_pin(frames, monkeypatch):
    (_ref_f, port_f), _dims = frames
    from daft_tpu_torch import col

    with daft_tpu_torch.execution_config_ctx(device="cpu", pipeline_mode="force",
                                             morsel_size_rows=4096):
        out = port_f.select((col("v") + 1).alias("b")).limit(5).to_pydict()
    assert len(out["b"]) == 5
    _assert_clean()

    def broken(*args, **kwargs):
        raise RuntimeError("segment_sum_planes: CUDA launch failed with error 98")

    monkeypatch.setattr(sk, "segment_sum_planes", broken)
    for mode in ("on", "force"):
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on",
                                                 pipeline_mode=mode):
            df = port_f.where(col("x") > 0).groupby("s").agg(col("v").sum())
            with pytest.raises(RuntimeError, match="launch failed"):
                df.to_pydict()
        _assert_clean()
