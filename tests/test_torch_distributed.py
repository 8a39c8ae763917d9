"""Grouped and ungrouped aggregation across worker processes
(daft_tpu_torch/distributed/; counterpart of tests/test_distributed.py).

The reference's file tests its JAX mesh tier (sharded filter-aggregates and
the exact sharded groupby over 8 virtual devices: not ported, ROADMAP
Queue 1) and the pool's autoscaling. Here the same semantic cases run
through the port's DistributedRunner, whose workers split the rows and
combine partial aggregates through the hash shuffle: sums, the count
modes, mean / min / max, nulls left out, exact groups for negative and
huge keys, null keys, an all-null group, an empty filter, and a seeded
random table against numpy, each against the reference's single-process
run on the same columns (integers, keys and counts exactly, floats rtol
1e-12). Then the autoscaling request and a pool growing toward
``max_workers``, on both packages' schedulers where hermetic.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu.distributed.scheduler as ref_sched
import daft_tpu.distributed.task as ref_task
import daft_tpu_torch
import daft_tpu_torch.distributed.scheduler as port_sched
import daft_tpu_torch.distributed.task as port_task
import daft_tpu_torch.runners as runners
from daft_tpu_torch.config import execution_config_ctx


@pytest.fixture(scope="module")
def dist_runner():
    from daft_tpu_torch.distributed import DistributedRunner

    with execution_config_ctx(device="cpu"):
        r = DistributedRunner(num_workers=2, n_partitions=4)
        r._ensure_pool()
    yield r
    r.shutdown()


def _both(dist_runner, build, data):
    want = build(daft_tpu, daft_tpu.from_pydict(data)).to_pydict()
    with execution_config_ctx(device="cpu"):
        runners.set_runner(dist_runner)
        try:
            got = build(daft_tpu_torch, daft_tpu_torch.from_pydict(data)).to_pydict()
        finally:
            runners.set_runner(None)
    return got, want


def _same(got, want, floats=()):
    assert list(got) == list(want)
    for c in want:
        if c in floats:
            assert [v is None for v in got[c]] == [v is None for v in want[c]], c
            np.testing.assert_allclose([np.nan if v is None else v for v in got[c]],
                                       [np.nan if v is None else v for v in want[c]],
                                       rtol=1e-12, err_msg=c)
        else:
            assert got[c] == want[c], c


def _xy(n=5000, seed=7, nulls=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-50, 50, n).tolist()
    y = rng.uniform(0, 10, n).tolist()
    if nulls:
        x = [None if i % nulls == 0 else v for i, v in enumerate(x)]
    return {"x": x, "y": y}


def test_filter_agg_sum(dist_runner):
    got, want = _both(dist_runner, lambda p, df: df.where(p.col("y") > 3)
                      .groupby(p.lit(1).alias("g")).agg(p.col("x").sum().alias("s")),
                      _xy())
    _same(got, want, ("s",))


@pytest.mark.parametrize("mode", ["valid", "null", "all"])
def test_filter_agg_count_modes(dist_runner, mode):
    data = _xy(nulls=7)
    data["g"] = [i % 3 for i in range(len(data["x"]))]
    got, want = _both(dist_runner, lambda p, df: df.where(p.col("y") > 2).groupby("g")
                      .agg(p.col("x").count(mode).alias("c")).sort("g"), data)
    _same(got, want)


def test_filter_agg_mean_min_max(dist_runner):
    data = _xy(seed=8)
    data["g"] = [i % 5 for i in range(len(data["x"]))]
    got, want = _both(dist_runner, lambda p, df: df.where(p.col("y") < 8).groupby("g")
                      .agg(p.col("x").mean().alias("m"), p.col("x").min().alias("lo"),
                           p.col("x").max().alias("hi")).sort("g"), data)
    _same(got, want, ("m",))


def test_filter_agg_nulls_excluded(dist_runner):
    data = _xy(seed=9, nulls=3)
    data["g"] = [i % 4 for i in range(len(data["x"]))]
    got, want = _both(dist_runner, lambda p, df: df.groupby("g")
                      .agg(p.col("x").sum().alias("s"), p.col("x").count().alias("c"))
                      .sort("g"), data)
    _same(got, want, ("s",))


def test_groupby_exact_no_bucket_collisions(dist_runner):
    n = 20_000
    data = {"k": [(i * 7919) % 5003 for i in range(n)], "v": list(range(n))}
    got, want = _both(dist_runner, lambda p, df: df.groupby("k")
                      .agg(p.col("v").sum().alias("s"), p.col("v").count().alias("c"))
                      .sort("k"), data)
    _same(got, want)
    assert len(got["k"]) == 5003


def test_groupby_negative_and_huge_keys(dist_runner):
    keys = [-(1 << 62), -5, 0, 3, (1 << 62) + 17, -(1 << 40)]
    data = {"k": [keys[i % len(keys)] for i in range(6000)], "v": list(range(6000))}
    got, want = _both(dist_runner, lambda p, df: df.groupby("k")
                      .agg(p.col("v").sum().alias("s")).sort("k"), data)
    _same(got, want)


def test_groupby_null_keys(dist_runner):
    data = {"k": [None if i % 5 == 0 else i % 4 for i in range(4000)],
            "v": [float(i) for i in range(4000)]}
    got, want = _both(dist_runner, lambda p, df: df.groupby("k")
                      .agg(p.col("v").sum().alias("s")).sort("k"), data)
    _same(got, want, ("s",))


def test_groupby_all_null_value_group(dist_runner):
    data = {"k": [i % 3 for i in range(3000)],
            "v": [None if i % 3 == 1 else float(i) for i in range(3000)]}
    got, want = _both(dist_runner, lambda p, df: df.groupby("k")
                      .agg(p.col("v").sum().alias("s"), p.col("v").max().alias("m"))
                      .sort("k"), data)
    _same(got, want, ("s", "m"))
    assert got["s"][1] is None


def test_grouped_agg_empty_after_filter(dist_runner):
    data = {"k": ["a", "b"], "v": [1.0, 2.0], "w": [1, 2]}
    got, want = _both(dist_runner, lambda p, df: df.where(p.col("w") > 100).groupby("k")
                      .agg(p.col("v").sum().alias("s")), data)
    assert got == want == {"k": [], "s": []}


def test_groupby_random_vs_numpy(dist_runner):
    rng = np.random.default_rng(21)
    n = 30_000
    k = rng.integers(0, 97, n)
    v = rng.integers(-1000, 1000, n)
    got, want = _both(dist_runner, lambda p, df: df.groupby("k")
                      .agg(p.col("v").sum().alias("s")).sort("k"),
                      {"k": k.tolist(), "v": v.tolist()})
    _same(got, want)
    sums = np.bincount(k, weights=v, minlength=97).astype(np.int64)
    assert got["s"] == [int(sums[i]) for i in got["k"]]


@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_autoscaling_scale_up(pkg):
    """Pending demand past capacity x threshold asks for more workers."""
    sched, task = (ref_sched, ref_task) if pkg == "reference" else (port_sched, port_task)
    s = sched.Scheduler({"w0": 1})
    assert s.get_autoscaling_request() is None
    for i in range(4):
        s.submit(task.SubPlanTask(task_id=f"t{i}", plan_blob=b"", strategy=None, priority=0))
    req = s.get_autoscaling_request()
    assert req is not None and len(req) == 4
    s2 = sched.Scheduler({"w0": 8})
    s2.submit(task.SubPlanTask(task_id="t", plan_blob=b"", strategy=None, priority=0))
    assert s2.get_autoscaling_request() is None


def test_autoscaling_pool_grows():
    """A pool with max_workers > num_workers spawns workers while its queue
    exceeds its capacity, and completes every task."""
    from daft_tpu_torch.distributed.runner import DistributedRunner

    n = 20_000
    left = {"id": list(range(n)), "v": list(range(n))}
    right = {"id": list(range(0, n, 2)), "w": list(range(0, n, 2))}
    with execution_config_ctx(device="cpu"):
        runner = DistributedRunner(num_workers=1, n_partitions=6, max_workers=3)
        try:
            q = daft_tpu_torch.from_pydict(left).join(daft_tpu_torch.from_pydict(right),
                                                      on="id", how="inner")
            parts = runner.run(q._plan)
            assert sum(p.num_rows for p in parts) == n // 2
            assert len(runner._pool.workers) > 1, "the pool never grew"
        finally:
            runner.shutdown()
