"""The device-UDF tier (daft_tpu_torch/ops/udf_stage.py) on the CPU: the
contract tests of the reference's tests/test_device_udf.py, with the
reference run on the same inputs where it computes the same thing.

- the tier and the host path are bit-identical on one batch (nulls and
  empty strings included), and within 1e-6 of the reference's tier;
- classify through the coalescer equals the host path and the reference;
- morsels coalesce into fewer dispatches; ``batch_size`` caps a dispatch;
- weights are resident: a repeat query puts no weight bytes on the device,
  and embed and every classify label set share one encoder entry;
- a budget far below the weights is safe while the query pins them (the
  residency manager's byte count is made to count CPU tensors);
- a scalar device UDF under an ungrouped aggregate fuses: no standalone
  UDF run (no copy back in between), equal to the host path and the
  reference, and a warm run uploads no column;
- ``@cls`` device methods, keyword arguments refused, a misaligned prepare
  output raising (the reference falls back to the host instead), and host
  UDFs importing nothing of the tier;
- a device UDF the planner makes no stage of (inside an expression, a
  filter or an aggregation) runs on the configured device: with no card
  it raises, under ``device_mode="off"`` it runs on the CPU.

Left out: the reference's process tier, its distributed plan and its
satellite tests (test_device_udf.py:423-522).
"""

import sys

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.datatype import DataType as RDataType
from daft_tpu.functions import ai as rai
from daft_tpu_torch import DataType, col
from daft_tpu_torch.device import residency
from daft_tpu_torch.functions.ai import classify_text, embed_text
from daft_tpu_torch.ops import counters
from daft_tpu_torch.plan import logical as lp

from test_torch_ai import _ref_embedder  # noqa: E402

MODEL = "device-udf-seeded"
LABELS = ["alpha topic", "beta topic", "gamma topic"]


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="on",
                                             device_min_rows=1):
        yield


@pytest.fixture
def one_thread():
    """One CPU thread: MKL may split a product across threads differently
    from one call to the next, which changes float results in the last bits;
    the bit-for-bit comparisons run on one thread."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _texts(n):
    words = [f"term{i}" for i in range(17)]
    return [" ".join(words[(i * k) % len(words)] for k in (1, 3, 7)) for i in range(n)]


def _batched(data: dict, rows: int):
    """A port DataFrame of ``data`` in partitions of ``rows`` rows (the
    reference's ``into_batches(rows).collect()``)."""
    whole = daft_tpu_torch.MicroPartition.from_pydict(data).concat_or_empty()
    parts = [daft_tpu_torch.MicroPartition(whole.schema, [whole.slice(s, s + rows)])
             for s in range(0, whole.num_rows, rows)]
    return daft_tpu_torch.DataFrame(lp.InMemorySource(whole.schema, parts))


def _score_func(dt, dtype, seed=3):
    """A scalar device Func (x scaled by a weight sum): the reference's
    stand-in model, in either package."""
    w = np.random.default_rng(seed).standard_normal(8).astype(np.float32)

    def fn(params, x):
        return x * params["w"].sum()

    return dt.func(fn, on_device=True, return_dtype=dtype, device_params=lambda: {"w": w},
                   device_key=f"test_score:{seed}")


def _embed(df, **kw):
    return df.select(col("id"), embed_text(col("t"), provider="torch", model=MODEL, **kw)
                     .alias("e")).to_pydict()


def test_embed_device_vs_host_bit_identical_single_batch(one_thread):
    texts = _texts(40) + [None, "", None]
    df = daft_tpu_torch.from_pydict({"id": list(range(len(texts))), "t": texts})
    counters.reset()
    dev = _embed(df)
    assert counters.device_udf_dispatches == 1 and counters.device_udf_runs == 1
    with daft_tpu_torch.execution_config_ctx(device_mode="off"):
        host = _embed(df)
    assert dev == host
    assert dev["e"][40] is None and dev["e"][42] is None
    assert len(dev["e"][41]) == 128
    _ref_embedder(MODEL)
    with ref_ctx(device_mode="on", device_min_rows=1, mesh_devices=1):
        ref = daft_tpu.from_pydict({"id": list(range(len(texts))), "t": texts}).select(
            daft_tpu.col("id"), rai.embed_text(daft_tpu.col("t"), provider="jax",
                                               model=MODEL).alias("e")).to_pydict()
    assert [v is None for v in ref["e"]] == [v is None for v in dev["e"]]
    assert max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
               for a, b in zip(dev["e"], ref["e"]) if a is not None) <= 1e-6


def test_classify_device_vs_host_multi_batch(one_thread):
    texts = _texts(120) + [None]
    df = _batched({"id": list(range(len(texts))), "t": texts}, 32)

    def q():
        return (df.select(col("id"), classify_text(col("t"), LABELS, provider="torch",
                                                   model=MODEL).alias("lab"))
                .groupby("lab").agg(col("id").count().alias("n")).sort("lab").to_pydict())

    counters.reset()
    dev = q()
    assert counters.device_udf_dispatches >= 1 and counters.device_grouped_batches == 1
    assert counters.plain_segment_sum_planes >= 1  # the count through K1's wrapper
    with daft_tpu_torch.execution_config_ctx(device_mode="off"):
        host = q()
    assert dev == host
    assert sum(dev["n"]) == 121 and dev["lab"][-1] is None
    _ref_embedder(MODEL)
    with ref_ctx(device_mode="on", device_min_rows=1, mesh_devices=1):
        ref = (daft_tpu.from_pydict({"id": list(range(len(texts))), "t": texts})
               .into_batches(32).collect()
               .select(daft_tpu.col("id"), rai.classify_text(daft_tpu.col("t"), LABELS,
                                                             provider="jax", model=MODEL)
                       .alias("lab"))
               .groupby("lab").agg(daft_tpu.col("id").count().alias("n")).sort("lab")
               .to_pydict())
    assert dev == ref


def test_empty_frame():
    df = daft_tpu_torch.from_pydict({"t": daft_tpu_torch.Series.empty("t", DataType.string())})
    out = df.select(embed_text(col("t"), provider="torch", model=MODEL).alias("e")).to_pydict()
    assert out == {"e": []}


def test_classifier_label_cache_deterministic():
    """Equal label sets share one resident label entry; every label set and
    the embed Func share one resident encoder entry."""
    import torch

    from daft_tpu_torch.ai.torch_provider import torch_classify_func, torch_embed_func
    from daft_tpu_torch.ops.udf_stage import resident_weights

    cpu = torch.device("cpu")
    w1 = resident_weights(torch_classify_func(LABELS, MODEL), cpu)
    w2 = resident_weights(torch_classify_func(list(LABELS), MODEL), cpu)
    assert w1["lab"] is w2["lab"] and w1["enc"] is w2["enc"]
    w3 = resident_weights(torch_classify_func(LABELS + ["delta topic"], MODEL), cpu)
    assert w3["lab"] is not w1["lab"] and w3["enc"] is w1["enc"]
    assert w3["lab"].shape[0] == len(LABELS) + 1
    assert resident_weights(torch_embed_func(MODEL), cpu) is w1["enc"]


def test_coalesced_feed_one_dispatch():
    df = _batched({"id": list(range(64)), "t": _texts(64)}, 8)
    counters.reset()
    _embed(df)
    assert counters.coalesce_morsels_in == 8
    assert counters.dispatch_coalesced == 1
    assert counters.device_udf_dispatches == 1 and counters.device_udf_rows == 64


def test_batch_size_caps_dispatch_bucket():
    df = daft_tpu_torch.from_pydict({"id": list(range(64)), "t": _texts(64)})
    counters.reset()
    capped = _embed(df, batch_size=16)
    assert counters.device_udf_dispatches == 4
    flat = _embed(df)
    for a, b in zip(capped["e"], flat["e"]):
        np.testing.assert_allclose(a, b, atol=1e-5)


def test_weights_resident_and_repeat_h2d_flat():
    df = daft_tpu_torch.from_pydict({"id": list(range(32)), "t": _texts(32)})
    residency.manager().clear()
    counters.reset()
    _embed(df)
    w1 = counters.device_udf_weight_h2d_bytes
    assert w1 == sum(v.nbytes for v in daft_tpu_torch.ai.get_provider("torch")
                     .get_text_embedder(MODEL).device_params().values())
    n_entries = residency.manager().entry_count()
    hits = counters.hbm_cache_hits
    _embed(df)
    assert counters.device_udf_weight_h2d_bytes == w1, "a repeat query uploaded weights"
    assert counters.hbm_cache_hits == hits + 1
    assert residency.manager().entry_count() == n_entries
    # classify shares the encoder entry: only the label matrix is new
    df.select(classify_text(col("t"), LABELS, provider="torch", model=MODEL)).to_pydict()
    lab = counters.device_udf_weight_h2d_bytes - w1
    assert lab == len(LABELS) * 128 * 4


def test_tiny_budget_pin_safety(monkeypatch):
    """Weights pinned by the running query survive a budget far below their
    size and are shed when the query ends."""
    monkeypatch.setattr(residency, "device_nbytes", _nbytes_all)
    df = daft_tpu_torch.from_pydict({"id": list(range(32)), "t": _texts(32)})
    residency.manager().clear()
    with daft_tpu_torch.execution_config_ctx(hbm_budget_bytes=1024):
        out = _embed(df)
        assert len(out["e"]) == 32 and out["e"][0] is not None
        assert residency.manager().bytes_resident() <= 1024
        again = _embed(df)
    assert again == out


def _nbytes_all(value):
    """device_nbytes counting CPU tensors too."""
    import torch

    total, stack = 0, [value]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            total += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
    return total


def test_fused_udf_agg_no_intermediate_copy():
    """A scalar device UDF feeding an ungrouped aggregate: its plane goes
    into the aggregate's program (device_stage_batches moves, no standalone
    UDF run), equal to the host path and the reference; a warm run uploads
    no column."""
    from chip_smoke import count_uploads

    n = 3000
    xs = [float(i % 89) for i in range(n)]
    score = _score_func(daft_tpu_torch, DataType.float32())
    df = daft_tpu_torch.from_pydict({"x": xs})

    def q():
        return df.select(score(col("x")).alias("s")).agg(
            col("s").sum().alias("ss"), col("s").count().alias("c")).to_pydict()

    counters.reset()
    dev = q()
    assert counters.device_udf_dispatches == 1 and counters.device_stage_batches == 1
    assert counters.device_udf_runs == 0, "the fused path ran a standalone UDF run"
    assert counters.device_region_dispatches == 1
    assert count_uploads(q) == 0
    with daft_tpu_torch.execution_config_ctx(device_mode="off"):
        host = q()
    assert dev["c"] == host["c"] == [n]
    np.testing.assert_allclose(dev["ss"], host["ss"], rtol=1e-5)
    rscore = _score_func(daft_tpu, RDataType.float32())
    with ref_ctx(device_mode="on", device_min_rows=1, mesh_devices=1):
        ref = daft_tpu.from_pydict({"x": xs}).select(rscore(daft_tpu.col("x")).alias("s")).agg(
            daft_tpu.col("s").sum().alias("ss"), daft_tpu.col("s").count().alias("c")).to_pydict()
    assert dev["c"] == ref["c"]
    np.testing.assert_allclose(dev["ss"], ref["ss"], rtol=1e-5)


def test_unfused_grouped_pipeline_still_device():
    score = _score_func(daft_tpu_torch, DataType.float32(), seed=11)
    n = 1200
    df = daft_tpu_torch.from_pydict({"x": [float(i % 53) for i in range(n)],
                                     "k": [i % 4 for i in range(n)]})

    def q():
        return (df.select(col("k"), score(col("x")).alias("s")).groupby("k")
                .agg(col("s").sum().alias("ss")).sort("k").to_pydict())

    counters.reset()
    dev = q()
    assert counters.device_udf_dispatches == 1 and counters.device_udf_runs == 1
    assert counters.device_grouped_batches == 1
    with daft_tpu_torch.execution_config_ctx(device_mode="off"):
        host = q()
    assert dev["k"] == host["k"]
    np.testing.assert_allclose(dev["ss"], host["ss"], rtol=1e-5)


def test_cls_device_params_hook():
    loads = {"n": 0}

    @daft_tpu_torch.cls
    class Scaler:
        def __init__(self, k):
            loads["n"] += 1
            self.k = float(k)

        def device_params(self):
            return {"k": np.float32(self.k)}

        @daft_tpu_torch.method(on_device=True, return_dtype=DataType.float32())
        def scale(self, params, x):
            return x * params["k"]

    s = Scaler(2.5)
    df = _batched({"x": [float(i) for i in range(100)]}, 30)
    counters.reset()
    out = df.select(s.scale(col("x")).alias("y")).to_pydict()
    assert counters.device_udf_dispatches == 1
    np.testing.assert_allclose(out["y"], [i * 2.5 for i in range(100)], rtol=1e-6)
    assert loads["n"] == 1


def test_cls_device_methods_do_not_collide():
    import daft_tpu_torch.udf as udf_mod

    @udf_mod.cls
    class Mul:
        def device_params(self):
            return {"k": np.float32(3.0)}

        @udf_mod.method(on_device=True, return_dtype=DataType.float32())
        def apply(self, params, x):
            return x * params["k"]

    @udf_mod.cls
    class Add:
        def device_params(self):
            return {"b": np.float32(10.0)}

        @udf_mod.method(on_device=True, return_dtype=DataType.float32())
        def apply(self, params, x):
            return x + params["b"]

    fm, fa = Mul().apply, Add().apply
    df = daft_tpu_torch.from_pydict({"x": [1.0, 2.0]})
    assert df.select(fm(col("x")).alias("y")).to_pydict()["y"] == [3.0, 6.0]
    assert df.select(fa(col("x")).alias("y")).to_pydict()["y"] == [11.0, 12.0]


def test_device_func_rejects_kwargs():
    f = daft_tpu_torch.func(lambda params, x: x, on_device=True,
                            return_dtype=DataType.float32(), device_key="kwargs_guard:v1")
    df = daft_tpu_torch.from_pydict({"x": [1.0]})
    with pytest.raises(TypeError, match="keyword"):
        df.select(f(col("x"), scale=2).alias("y")).to_pydict()


def test_misaligned_prepare_raises():
    """Misaligned on the first batch (nothing launched) or on a later one:
    the contract error, and nothing reruns on the host."""
    def bad_prepare(xs):
        return (np.zeros((3,), np.float32),)

    f = daft_tpu_torch.func(lambda params, x: x, on_device=True,
                            return_dtype=DataType.float32(), device_prepare=bad_prepare,
                            device_key="bad_prepare:v1")
    counters.reset()
    with pytest.raises(ValueError, match="row-aligned"):
        daft_tpu_torch.from_pydict({"x": [1.0, 2.0, 3.0, 4.0]}).select(
            f(col("x")).alias("y")).to_pydict()
    assert counters.device_udf_dispatches == 0

    def later_bad(xs):
        return (np.asarray(xs[:3] if len(xs) == 5 else xs, np.float32),)

    g = daft_tpu_torch.func(lambda params, x: x, on_device=True,
                            return_dtype=DataType.float32(), device_prepare=later_bad,
                            device_key="later_bad_prepare:v1")
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(batch_fill_target=0.0):
        with pytest.raises(ValueError, match="row-aligned"):
            _batched({"x": [float(i) for i in range(13)]}, 8).select(
                g(col("x")).alias("y")).to_pydict()
    assert counters.device_udf_dispatches == 1


UDF_SHAPES = {
    "expression": lambda df, f: df.select((f(col("x")) * 2).alias("y")),
    "filter": lambda df, f: df.where(f(col("x")) > 7.0),
    "aggregation": lambda df, f: df.agg(f(col("x")).sum().alias("s")),
}
UDF_SHAPE_RESULTS = {"expression": {"y": [6.0, 12.0, 18.0, 24.0]},
                     "filter": {"x": [3.0, 4.0]}, "aggregation": {"s": [30.0]}}


@pytest.mark.parametrize("shape", sorted(UDF_SHAPES))
def test_device_udf_off_the_stage_runs_on_the_configured_device(shape, monkeypatch):
    """A device UDF the planner makes no stage of (inside an expression, a
    filter or an aggregation) runs on the configured device: with no card
    the default device raises, device="cpu" and device_mode="off" run on
    the CPU, with the same result."""
    import torch

    seen = []

    def fn(params, x):
        seen.append(x.device.type)
        return x * params["w"]

    f = daft_tpu_torch.func(fn, on_device=True, return_dtype=DataType.float32(),
                            device_params=lambda: {"w": np.float32(3.0)})
    df = daft_tpu_torch.from_pydict({"x": [1.0, 2.0, 3.0, 4.0]})
    counters.reset()
    assert UDF_SHAPES[shape](df, f).to_pydict() == UDF_SHAPE_RESULTS[shape]
    assert counters.device_udf_dispatches == 0 and seen and set(seen) == {"cpu"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seen.clear()
    with daft_tpu_torch.execution_config_ctx(device="cuda"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            UDF_SHAPES[shape](df, f).to_pydict()
        assert not seen
        with daft_tpu_torch.execution_config_ctx(device_mode="off"):
            assert UDF_SHAPES[shape](df, f).to_pydict() == UDF_SHAPE_RESULTS[shape]
    assert seen and set(seen) == {"cpu"}


def test_funcs_of_one_body_keep_their_own_weights():
    """Device Funcs of one body over other weights, and over equal bytes
    under other names, each run with their own weights."""
    body = lambda p, x: x * p["w"].sum()  # noqa: E731
    fs = [daft_tpu_torch.func(body, on_device=True, return_dtype=DataType.float32(),
                              device_params=lambda w=w: {"w": np.float32(w)})
          for w in ([1.0, 2.0], [3.0, 4.0])]
    fk = daft_tpu_torch.func(lambda p, x: x * p["k"].sum(), on_device=True,
                             return_dtype=DataType.float32(),
                             device_params=lambda: {"k": np.float32([3.0, 4.0])})
    df = daft_tpu_torch.from_pydict({"x": [1.0, 2.0]})
    got = [df.select(f(col("x")).alias("y")).to_pydict()["y"] for f in fs + [fk]]
    assert got == [[3.0, 6.0], [7.0, 14.0], [7.0, 14.0]]


def test_zero_overhead_host_only_udfs():
    """A query of host UDFs imports nothing of the device tier and moves no
    device-UDF counter."""
    sys.modules.pop("daft_tpu_torch.ops.udf_stage", None)

    @daft_tpu_torch.func(return_dtype=DataType.int64())
    def plus_one(x: int) -> int:
        return x + 1

    df = daft_tpu_torch.from_pydict({"x": list(range(64))})
    counters.reset()
    out = df.select(plus_one(col("x")).alias("y"), (col("x") * 2).alias("z")).to_pydict()
    assert out["y"][:3] == [1, 2, 3]
    assert "daft_tpu_torch.ops.udf_stage" not in sys.modules
    assert not any(v for k, v in counters.snapshot().items()
                   if k.startswith(("device_udf_", "coalesce_", "hbm_")))
