"""The port's host memory ledger (daft_tpu_torch/memory/manager.py) against
the reference's behaviour (daft_tpu/memory/manager.py, tests/
test_host_memory.py): track and release, the high-water mark, budget
resolution, one ledger shared by every operator, pressure and its
callbacks, a bounded ``wait_for_headroom``, a query scope's peak, the
unbudgeted query that moves nothing, concurrent spilling queries, and the
ledger back at 0 after a query that raises.

Tolerance (the ROADMAP's rule): results bit for bit, except float sums and
means within rtol 1e-5; the budgeted runs here equal the unbudgeted ones
exactly.
"""

import os
import threading

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch as dt
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch import col
from daft_tpu_torch.memory import manager, reset_counters, spill_root
from daft_tpu_torch.memory.manager import system_ram_bytes
from daft_tpu_torch.ops import counters


@pytest.fixture(autouse=True)
def _clean_manager():
    reset_counters()
    manager().clear()
    yield
    manager().clear()


def test_ledger_track_release_high_water():
    m = manager()
    m.track(1000)
    m.track(500)
    assert m.tracked_bytes() == 1500
    m.release(600)
    assert m.tracked_bytes() == 900
    assert m.high_water_bytes() == 1500
    snap = counters.snapshot()
    assert snap["host_bytes_tracked"] == 900
    assert snap["host_bytes_high_water"] == 1500
    m.release(10_000)  # clamps at zero
    assert m.tracked_bytes() == 0


def test_limit_resolution_modes():
    m = manager()
    with dt.execution_config_ctx(memory_limit_bytes=12345):
        assert m.limit_bytes() == 12345
    with dt.execution_config_ctx(memory_limit_bytes=0):
        assert m.limit_bytes() == 0
    with dt.execution_config_ctx(memory_limit_bytes=-1, memory_fraction=0.5):
        ram = system_ram_bytes()
        assert m.limit_bytes() == (int(ram * 0.5) if ram > 0 else 0)


@pytest.mark.parametrize("kwargs", [{"memory_fraction": 0.0}, {"memory_fraction": 1.5},
                                    {"memory_pressure": 0.0}, {"spill_io_threads": -1},
                                    {"spill_prefetch_batches": -1},
                                    {"spill_compression": "gzip"}])
def test_config_validation(kwargs):
    with pytest.raises(ValueError):
        dt.ExecutionConfig(**kwargs)


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_reference_codecs_refused_naming_the_ports(codec):
    with pytest.raises(ValueError, match="'none'/'snappy'"):
        dt.ExecutionConfig(spill_compression=codec)


def test_config_defaults_and_environment(monkeypatch):
    cfg = dt.ExecutionConfig()
    assert (cfg.memory_limit_bytes, cfg.memory_fraction, cfg.memory_pressure,
            cfg.spill_compression, cfg.spill_dir, cfg.spill_io_threads,
            cfg.spill_prefetch_batches) == (0, 0.6, 0.8, "snappy", "", 2, 2)
    monkeypatch.setenv("DAFT_TPU_MEMORY_LIMIT", "4096")
    monkeypatch.setenv("DAFT_TPU_SPILL_COMPRESSION", "none")
    monkeypatch.setenv("DAFT_TPU_SPILL_IO_THREADS", "0")
    cfg = dt.ExecutionConfig()
    assert (cfg.memory_limit_bytes, cfg.spill_compression, cfg.spill_io_threads) == \
        (4096, "none", 0)


def test_shared_budget_across_operators():
    m = manager()
    with dt.execution_config_ctx(memory_limit_bytes=1000):
        a = m.operator_budget()
        b = m.operator_budget()
        assert a.admit(600)
        assert not b.admit(600)  # the ledger at 1200 > 1000: b spills
        assert counters.host_over_budget_events == 1
        b.release_all()
        assert m.tracked_bytes() == 600
        a.close()
        assert m.tracked_bytes() == 0


def test_inert_budget_when_unbudgeted():
    m = manager()
    with dt.execution_config_ctx(memory_limit_bytes=0):
        b = m.operator_budget()
        assert b.admit(10**12)
        assert m.tracked_bytes() == 0
        b.close()


def test_partial_release_clamps_to_holdings():
    m = manager()
    with dt.execution_config_ctx(memory_limit_bytes=10_000):
        b = m.operator_budget()
        b.admit(300)
        b.release(100)
        assert (b.used, m.tracked_bytes()) == (200, 200)
        b.release(10_000)
        assert (b.used, m.tracked_bytes()) == (0, 0)


def test_pressure_threshold_and_callbacks():
    m = manager()
    fired = []
    unsub = m.on_pressure(lambda tracked, limit: fired.append((tracked, limit)))
    with dt.execution_config_ctx(memory_limit_bytes=1000, memory_pressure=0.8):
        m.track(700)
        assert not m.under_pressure()
        m.track(200)  # 900 >= 800: one upward crossing
        assert m.under_pressure()
        assert fired == [(900, 1000)]
        m.track(50)
        assert len(fired) == 1
        m.release(900)
        assert not m.under_pressure()
        m.track(850)
        assert len(fired) == 2
        unsub()
        m.release(900)
        m.track(900)
        assert len(fired) == 2


def test_broken_pressure_callback_does_not_fail_the_admit():
    m = manager()
    m.on_pressure(lambda tracked, limit: 1 / 0)
    with dt.execution_config_ctx(memory_limit_bytes=1000):
        assert m.operator_budget().admit(900)


def test_wait_for_headroom_bounded_and_counted():
    m = manager()
    with dt.execution_config_ctx(memory_limit_bytes=1000, memory_pressure=0.5):
        m.track(900)
        t = threading.Timer(0.05, lambda: m.release(900))
        t.start()
        stalled = m.wait_for_headroom(max_wait_s=5.0)
        t.join()
        assert 0.0 < stalled < 5.0  # woke on the release
        assert counters.scan_backpressure_stalls == 1
        assert counters.scan_stall_ms >= 1
        m.track(900)  # pressure that never clears: back at the bound
        stalled = m.wait_for_headroom(max_wait_s=0.05)
        assert stalled >= 0.05
        m.release(900)
    assert m.wait_for_headroom() == 0.0  # no budget: no wait, no count
    assert counters.scan_backpressure_stalls == 2


def test_query_scope_observes_peak():
    m = manager()
    with dt.execution_config_ctx(memory_limit_bytes=10_000):
        m.track(100)
        with m.query_scope() as scope:
            assert scope.peak_bytes() == 100
            m.track(700)
            m.release(500)
            m.track(100)
        assert scope.peak_bytes() == 800
        m.release(400)
        assert scope.peak_bytes() == 800


def _group_frames(n=40_000, seed=3):
    rng = np.random.default_rng(seed)
    data = {"k": rng.integers(0, 50, n), "v": rng.uniform(0, 1, n)}
    return (daft_tpu.from_pydict({c: v.tolist() for c, v in data.items()}),
            dt.from_pydict(data))


def test_zero_overhead_unbudgeted_query():
    """An unbudgeted query moves no ledger, spill or memory counter and
    leaves no spill file."""
    _ref, df = _group_frames(10_000)

    def q():
        return df.groupby("k").agg(col("v").sum().alias("s")).sort("k")

    with dt.execution_config_ctx(device="cpu", device_mode="off", memory_limit_bytes=0):
        q().to_pydict()
        before = counters.snapshot()
        q().to_pydict()
        after = counters.snapshot()
    for name in counters.SPILL_COUNTER_NAMES + counters.MEMORY_COUNTER_NAMES:
        assert after[name] == before[name] == 0, name
    assert manager().tracked_bytes() == 0 and manager().high_water_bytes() == 0
    root = spill_root()
    if os.path.isdir(root):
        assert not [n for n in os.listdir(root) if f"{os.getpid()}_" in n]


def test_concurrent_queries_share_ledger_and_stay_exact():
    """Four spilling queries at once under one small budget: each equal to
    the unbudgeted run and to the reference's; the ledger drains to 0."""
    ref, df = _group_frames()

    def q(d, frame):
        return frame.groupby("k").agg(d.col("v").sum().alias("s")).sort("k").to_pydict()

    with ref_ctx(device_mode="off"):
        want_ref = q(daft_tpu, ref)
    with dt.execution_config_ctx(device="cpu", device_mode="off", morsel_size_rows=4096):
        expected = q(dt, df)
    assert expected["k"] == want_ref["k"]
    np.testing.assert_allclose(expected["s"], want_ref["s"], rtol=1e-5)
    results = [None] * 4
    errs = []
    with dt.execution_config_ctx(device="cpu", device_mode="off", morsel_size_rows=4096,
                                 memory_limit_bytes=128 * 1024):
        def run(i):
            try:
                results[i] = q(dt, df)
            except Exception as e:  # noqa: BLE001 -- surfaced by the assert below
                errs.append(e)

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert not errs
    assert all(r == expected for r in results)
    assert counters.spill_batches > 0
    assert manager().tracked_bytes() == 0


def _failing_after(n_ok: int):
    calls = [0]

    def fn(x):
        calls[0] += 1
        if calls[0] > n_ok:
            raise RuntimeError("the query fails here")
        return x

    return fn


@pytest.mark.parametrize("pipeline_mode", ["off", "force"])
@pytest.mark.parametrize("op", ["sort", "agg", "join", "window"])
def test_ledger_back_at_zero_after_a_query_that_raises(op, pipeline_mode):
    """A budgeted operator whose input raises part way releases what it
    admitted (its budget closes in a finally), and its spill files go."""
    from daft_tpu_torch.window import Window

    from daft_tpu_torch.plan import logical as lp

    rng = np.random.default_rng(11)
    parts = [dt.MicroPartition.from_pydict({"k": rng.integers(0, 300, 10_000),
                                            "v": rng.standard_normal(10_000)})
             for _ in range(6)]
    df = dt.DataFrame(lp.InMemorySource(parts[0].schema, parts))
    other = dt.from_pydict({"dk": np.arange(300), "w": rng.standard_normal(300)})
    fn = _failing_after(35_000)  # a value function: it fails in the fourth part
    failing = df.with_column("v", col("v").apply(fn, dt.DataType.float64()))
    queries = {
        "sort": lambda: failing.sort("v"),
        "agg": lambda: failing.groupby("k").agg(col("v").sum()),
        "join": lambda: other.join(failing, left_on="dk", right_on="k"),
        "window": lambda: failing.select(col("k"), col("v").sum().over(
            Window().partition_by("k")).alias("t")),
    }
    with dt.execution_config_ctx(device="cpu", device_mode="off", morsel_size_rows=4096,
                                 memory_limit_bytes=50_000, pipeline_mode=pipeline_mode):
        with pytest.raises(Exception, match="the query fails here"):
            queries[op]().to_pydict()
    assert manager().tracked_bytes() == 0
    assert manager().high_water_bytes() > 0  # the budget was in force
    root = spill_root()
    if os.path.isdir(root):
        assert not [n for n in os.listdir(root) if f"{os.getpid()}_" in n]
