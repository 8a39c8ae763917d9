"""The port's adaptive batching (daft_tpu_torch/execution/batching.py) held
against the reference's (daft_tpu/execution/batching.py): each strategy,
fed the same sequence of (rows, seconds), picks the same sequence of morsel
sizes and counts the same resizes; ``adaptive_morsel_stream`` cuts the same
morsel boundaries from the same partitions; ``make_strategy`` and the
config follow the reference's modes and validation; and a query gives the
same rows under every batching mode.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import ExecutionConfig as RefConfig
from daft_tpu.execution import batching as ref_batching
from daft_tpu.ops import counters as ref_counters
from daft_tpu_torch.config import ExecutionConfig
from daft_tpu_torch.execution import batching
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters

SEED = 20261018


def _knee_seconds(knee):
    def seconds(rows, size):
        rate = 2e8 / (knee / size + size / knee)
        return rows / rate
    return seconds


def _drive(strategy, steps, seconds):
    """Feed ``steps`` morsels of the strategy's current size; the sizes."""
    sizes = []
    for i in range(steps):
        s = strategy.current_size()
        sizes.append(s)
        strategy.record(s, seconds(s, i))
    sizes.append(strategy.current_size())
    return sizes


def _both(make, steps, seconds):
    """The size sequences and resize counts of the port's and the
    reference's strategy under the same feedback."""
    counters.reset()
    ref_counters.reset()
    got = _drive(make(batching), steps, seconds)
    want = _drive(make(ref_batching), steps, seconds)
    assert counters.morsel_resize == ref_counters.morsel_resize
    return got, want


@pytest.mark.parametrize("knee,initial", [(32 * 1024, 512 * 1024), (8 * 1024, 4096),
                                          (1 << 20, 64 * 1024)])
def test_dynamic_sizes_equal_reference_at_a_knee(knee, initial):
    f = _knee_seconds(knee)
    got, want = _both(lambda m: m.DynamicBatching(initial=initial, min_rows=1024,
                                                  max_rows=8 * 1024 * 1024),
                      60, lambda s, _i: f(s, s))
    assert got == want
    assert knee // 2 <= got[-1] <= knee * 2, got


def test_dynamic_sizes_equal_reference_under_noise_and_stragglers():
    rng = np.random.default_rng(SEED)
    jitter = rng.uniform(0.9, 1.1, 200)
    straggle = rng.random(200) < 0.2

    def feed(module):
        strategy = module.DynamicBatching(initial=64 * 1024, min_rows=1024)
        sizes = []
        for i in range(200):
            s = strategy.current_size()
            sizes.append(s)
            rows = s * 8 if straggle[i] else s  # out of the step's window
            strategy.record(rows, rows / (1e8 * jitter[i]))
        return sizes

    counters.reset()
    ref_counters.reset()
    assert feed(batching) == feed(ref_batching)
    assert counters.morsel_resize == ref_counters.morsel_resize


@pytest.mark.parametrize("initial,min_rows,max_rows", [(4096, 4096, 8192), (1024, 4096, 1 << 24),
                                                       (3000, 512, 1 << 14)])
def test_dynamic_bounds_equal_reference(initial, min_rows, max_rows):
    got, want = _both(lambda m: m.DynamicBatching(initial=initial, min_rows=min_rows,
                                                  max_rows=max_rows),
                      30, lambda s, i: 1.0 + 0.5 * (i % 4))
    assert got == want
    assert all(min(initial, min_rows) // 2 <= s <= max(max_rows, initial) for s in got)


@pytest.mark.parametrize("target", [0.001, 0.01, 0.5])
def test_latency_sizes_equal_reference(target):
    rng = np.random.default_rng(SEED + 1)
    rates = rng.uniform(1e5, 1e8, 80)
    got, want = _both(lambda m: m.LatencyConstrainedBatching(target, initial=128 * 1024),
                      80, lambda s, i: s / rates[i])
    assert got == want


def test_static_sizes_equal_reference():
    got, want = _both(lambda m: m.StaticBatching(5000), 10, lambda s, i: 0.1 * (i + 1))
    assert got == want == [5000] * 11
    assert counters.morsel_resize == 0


class _Scripted:
    """A strategy whose size follows a script, one step per consult."""

    def __init__(self, sizes):
        self.sizes = list(sizes)
        self.i = 0

    def current_size(self):
        s = self.sizes[min(self.i, len(self.sizes) - 1)]
        self.i += 1
        return s

    def record(self, rows, seconds):
        return None


def _parts(rows_per_batch, per_part):
    """The same partitions in both packages: batches of the given row
    counts, ``per_part`` batches a partition."""
    rng = np.random.default_rng(SEED + 2)
    ref_parts, port_parts = [], []
    for i in range(0, len(rows_per_batch), per_part):
        ref_batches, port_batches = [], []
        for n in rows_per_batch[i:i + per_part]:
            v = rng.integers(-1000, 1000, n)
            ref_b = daft_tpu.from_pydict({"v": v}).collect()._result[0].concat_or_empty()
            ref_batches.append(ref_b)
            port = from_numpy_columns({"v": (v, np.ones(n, dtype=bool))},
                                      {"v": daft_tpu_torch.DataType.int64()})
            with daft_tpu_torch.execution_config_ctx(device="cpu"):
                port_batches.append(port.collect()._result[0].concat_or_empty())
        ref_parts.append(daft_tpu.MicroPartition(ref_batches[0].schema, ref_batches))
        port_parts.append(daft_tpu_torch.MicroPartition(port_batches[0].schema, port_batches))
    return ref_parts, port_parts


@pytest.mark.parametrize("rows,per_part,script", [
    ([100_000], 1, [8192, 8192, 16384, 4096, 32768]),
    ([500, 700, 300, 9000, 20, 4000, 4000, 4000], 3, [2048, 1024, 4096, 8192]),
    ([3000] * 10, 2, [4096]),
    ([65536, 10, 10, 65536], 1, [16384, 65536, 1024]),
])
def test_adaptive_morsel_stream_cuts_the_reference_boundaries(rows, per_part, script):
    ref_parts, port_parts = _parts(rows, per_part)
    got = [[b.num_rows for b in p.batches]
           for p in batching.adaptive_morsel_stream(iter(port_parts), _Scripted(script))]
    want = [[b.num_rows for b in p.batches]
            for p in ref_batching.adaptive_morsel_stream(iter(ref_parts), _Scripted(script))]
    assert got == want
    values = [v for p in batching.adaptive_morsel_stream(iter(port_parts), _Scripted(script))
              for b in p.batches for v in b.get_column("v").to_pylist()]
    assert values == [v for p in ref_parts for b in p.batches
                      for v in b.get_column("v").to_pylist()]


def test_adaptive_morsels_are_views():
    _ref, port_parts = _parts([50_000], 1)
    src = port_parts[0].batches[0].get_column("v")
    for p in batching.adaptive_morsel_stream(iter(port_parts), _Scripted([4096])):
        s = p.batches[0].get_column("v")
        assert np.shares_memory(s.to_numpy(), src.to_numpy())
        assert np.shares_memory(s.validity_numpy(), src.validity_numpy())


@pytest.mark.parametrize("mode", ["static", "dynamic", "latency"])
def test_make_strategy_follows_reference(mode):
    cfg = ExecutionConfig(batching_mode=mode, morsel_size_rows=20_000, batch_latency_ms=7.0)
    ref_cfg = RefConfig(batching_mode=mode, morsel_size_rows=20_000, batch_latency_ms=7.0)
    got = batching.make_strategy(cfg)
    want = ref_batching.make_strategy(ref_cfg)
    assert type(got).__name__ == type(want).__name__
    assert got.current_size() == want.current_size()
    assert isinstance(got, batching.BatchingStrategy)
    assert batching.coalesce_target_rows(cfg) == ref_batching.coalesce_target_rows(ref_cfg)


def test_config_modes_and_validation_follow_reference():
    cfg = ExecutionConfig()
    assert cfg.pipeline_mode == RefConfig().pipeline_mode == "on"
    assert cfg.batching_mode == RefConfig().batching_mode == "static"
    for field, good, bad in (("pipeline_mode", ("on", "off", "force"), "auto"),
                             ("batching_mode", ("static", "dynamic", "latency"), "fast")):
        for value in good:
            assert getattr(ExecutionConfig(**{field: value}), field) == value
        with pytest.raises(ValueError, match=field):
            ExecutionConfig(**{field: bad})
        with pytest.raises(ValueError, match=field):
            RefConfig(**{field: bad})


@pytest.mark.parametrize("mode", ["dynamic", "latency"])
def test_query_rows_equal_under_adaptive_batching(mode):
    rng = np.random.default_rng(SEED + 3)
    n = 120_000
    cols = {"k": rng.integers(0, 40, n), "v": rng.integers(-10**6, 10**6, n)}
    ref = daft_tpu.from_pydict(cols)
    port = from_numpy_columns({k: (v, np.ones(n, dtype=bool)) for k, v in cols.items()},
                              {"k": daft_tpu_torch.DataType.int64(),
                               "v": daft_tpu_torch.DataType.int64()})

    def q(dt, df):
        c = dt.col
        return (df.where(c("v") > -500_000).with_column("w", c("v") * 3 + c("k"))
                .groupby("k").agg(c("w").sum().alias("s"), c("v").max().alias("m"))
                .sort("k").to_pydict())

    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off",
                                             pipeline_mode="off"):
        want = q(daft_tpu_torch, port)
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off",
                                             pipeline_mode="force", batching_mode=mode,
                                             morsel_size_rows=4096):
        got = q(daft_tpu_torch, port)
    from daft_tpu.config import execution_config_ctx as ref_ctx

    with ref_ctx(device_mode="off"):
        ref_out = q(daft_tpu, ref)
    assert got == want == ref_out
