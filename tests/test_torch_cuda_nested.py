"""Exploded lists on the card: lists built on the host (agg_list by order),
exploded, then grouped on the card (count, sums, float and int64
extremes by supplier), at a small size, against the port's host path and
against the same aggregation over the flat rows. Marked ``cuda``: skipped
where no card is present.

Run on a machine with the card (tests/conftest.py imports JAX, which that
machine lacks):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_nested.py

The aggregate plans one DeviceGroupedAgg over the explode and launches
K1, K2, K7 and K3; keys, counts and extremes equal the host bit for bit,
the float sums within rtol 1e-5.
"""

import numpy as np
import pytest
import torch

import daft_tpu_torch as dt
from daft_tpu_torch import col
from daft_tpu_torch.ops import counters
from daft_tpu_torch.plan import physical as pp

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")


N_ORDERS = 40_000


def _flat():
    rng = np.random.default_rng(23)
    lines = rng.integers(1, 8, N_ORDERS)
    n = int(lines.sum())
    qty = rng.integers(1, 51, n).astype(np.float64)
    return dt.from_pydict({
        "o": np.repeat(np.arange(1, N_ORDERS + 1, dtype=np.int64), lines),
        "s": rng.integers(1, 1001, n).astype(np.int64), "q": qty,
        "p": np.round(qty * rng.uniform(900, 2000, n) / 10, 2)})


def _aggs():
    return (col("o").count().alias("n"), col("q").sum().alias("qty"),
            col("p").sum().alias("rev"), col("p").min().alias("lo"),
            col("p").max().alias("hi"), col("o").min().alias("first"),
            col("o").max().alias("last"))


def _same(got, want):
    assert list(got) == list(want)
    for c in got:
        if c in ("qty", "rev"):
            np.testing.assert_allclose(got[c], want[c], rtol=1e-5, atol=0)
        else:
            assert got[c] == want[c], c


def test_explode_into_the_grouped_stage_on_the_card():
    flat = _flat()
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        lists = flat.groupby("o").agg_list("s", "q", "p").collect()
        want = flat.groupby("s").agg(*_aggs()).sort("s").to_pydict()
    q = lists.explode("s", "q", "p").groupby("s").agg(*_aggs()).sort("s")
    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on"):
        plan = pp.translate(q.optimized_plan())
        node = plan.input if isinstance(plan, pp.PhysSort) else plan
        assert type(node).__name__ == "DeviceGroupedAgg"
        assert type(node.input).__name__ == "PhysExplode"
        counters.reset()
        got = q.to_pydict()
        snap = counters.snapshot()
    for k in ("segment_sum_planes", "segment_extreme_planes", "segment_sum_float_planes",
              "segment_extreme_int64"):
        assert snap[f"launches_{k}"] >= 1, k
    assert snap["device_fallbacks"] == 0
    _same(got, want)
    with dt.execution_config_ctx(device_mode="off"):
        _same(got, q.to_pydict())


def test_list_functions_under_a_card_aggregate_stay_on_the_host():
    flat = _flat()
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        lists = flat.groupby("o").agg_list("s", "q").collect()
        want = (lists.with_column("n", col("q").list.length().cast(dt.DataType.int64()))
                .groupby(col("o") % 10).agg(col("n").sum()).sort("o").to_pydict())
    q = (lists.with_column("n", col("q").list.length().cast(dt.DataType.int64()))
         .groupby(col("o") % 10).agg(col("n").sum()).sort("o"))
    with dt.execution_config_ctx(device="cuda", device_mode="on", kernel_mode="on"):
        counters.reset()
        got = q.to_pydict()
        assert counters.snapshot()["device_grouped_batches"] >= 1
    assert got == want
