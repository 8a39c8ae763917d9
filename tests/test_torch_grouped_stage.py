"""The port's grouped-aggregation kernel tier against the reference's Pallas
tier: ``GroupedAggStage._build_kernel(cap)`` (daft_tpu_torch, plain kernel
versions on the CPU) and ``GroupedAggStage._build_pallas(cap, interpret=True)``
(daft_tpu, JAX on the CPU) run on identical columns, codes, row mask and row
offset, and their {"mm", "ext", "sct"} tables must agree bit for bit.
"""

import datetime

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import daft_tpu
import daft_tpu_torch
from daft_tpu.ops import grouped_stage as ref_gs
from daft_tpu.ops.stage import device_row_mask as ref_row_mask
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import grouped_stage as port_gs
from daft_tpu_torch.ops.stage import device_row_mask as port_row_mask

CUTOFF = datetime.date(1998, 9, 2)


def _table(n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(-1000, 1000, n).astype(np.int32)
    b = rng.integers(-(2**62), 2**62, n, dtype=np.int64)
    b[:3] = [2**53 + 1, -(2**53) - 3, 2**62 + 11]
    d = (8036 + rng.integers(0, 2500, n)).astype(np.int32)
    a_null = rng.random(n) < 0.1
    b_null = rng.random(n) < 0.1
    return pa.table({
        "k": pa.array(rng.integers(0, 50, n), pa.int64()),
        "a": pa.array(a, pa.int32(), mask=a_null),
        "b": pa.array(b, pa.int64(), mask=b_null),
        "d": pa.array(d, pa.date32()),
        "line": pa.array(rng.integers(1, 8, n).astype(np.int32), pa.int32()),
    })


def _stage_exprs(m, case):
    col, lit = m.col, m.lit
    if case == "slice":
        pred = col("d") <= lit(CUTOFF)
        aggs = [col("b").count().alias("n"), col("line").sum().alias("s"),
                col("d").min().alias("d0"), col("d").max().alias("d1"),
                col("b").min().alias("b0"), col("b").max().alias("b1")]
    elif case == "nulls":
        pred = (col("a") > -500) & col("b").not_null()
        aggs = [col("a").sum().alias("s"), col("a").mean().alias("m"),
                col("a").count().alias("c"), col("a").min().alias("a0"),
                col("b").max().alias("b1"), lit(1).count("all").alias("all")]
    elif case == "bounds":  # a CASE-of-literals sum needs one digit plane
        pred = None
        aggs = [(col("a") > 0).if_else(lit(1), lit(0)).sum().alias("pos"),
                (col("a") * 3 - 7).sum().alias("lin")]
    else:  # "wide": 8 int64 sums of 9 planes each, past one 64-plane K1 chunk,
        # and two aggregations of a literal child, which broadcasts
        pred = col("d") <= lit(CUTOFF)
        aggs = [(col("b") + lit(i)).sum().alias(f"s{i}") for i in range(8)]
        aggs += [lit(7).sum().alias("seven"), lit(1).count("all").alias("all")]
    return pred, [col("k")], aggs


def _both_stages(tbl, case):
    ref_df = daft_tpu.from_arrow(tbl)
    ref_schema = ref_df.schema
    pred, keys, aggs = _stage_exprs(daft_tpu, case)
    ref = ref_gs.try_build_grouped_agg_stage(ref_schema, pred, keys, aggs)
    port_schema = daft_tpu_torch.Schema.from_pydict(
        {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_schema})
    pred, keys, aggs = _stage_exprs(daft_tpu_torch, case)
    with daft_tpu_torch.execution_config_ctx(device="cpu", kernel_mode="on"):
        port = port_gs.try_build_grouped_agg_stage(port_schema, pred, keys, aggs)
    assert ref is not None and port is not None
    # the reference's Pallas tier serves these stages, and the port sums
    # every one of their planes in K1, none in K7
    assert ref._pallas_eligible() and not port.sum_routes()[1]
    assert port._mm_specs == ref._mm_specs
    assert port._ext_specs == ref._ext_specs and port._sct_specs == ref._sct_specs
    batch = ref_df.collect()._result[0].concat_or_empty()
    port_df = from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, port_schema)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        port_batch = port_df.collect()._result[0].concat_or_empty()
    return ref, port, batch, port_batch


@pytest.mark.parametrize("case", ["slice", "nulls", "bounds"])
def test_build_kernel_matches_build_pallas(case):
    _compare_stage_tables(case)


def test_stage_passes_contiguous_planes_past_one_chunk(monkeypatch):
    # K1 and K2 get lists of full-length stride-1 planes (a broadcast child's
    # planes included), 76 sum planes in all, and still match the reference
    from daft_tpu_torch.ops import segment_kernels as sk

    seen = []

    def spy(fn):
        def call(planes, codes, *args):
            seen.append([(tuple(p.shape), p.stride(), p.is_contiguous()) for p in planes])
            return fn(planes, codes, *args)
        return call

    monkeypatch.setattr(sk, "segment_sum_planes", spy(sk.segment_sum_planes))
    monkeypatch.setattr(sk, "segment_extreme_planes", spy(sk.segment_extreme_planes))
    _compare_stage_tables("wide")
    assert [len(s) for s in seen] == [1 + 8 * 9 + 2 + 1, 1]
    assert all(shape == (4096,) and stride == (1,) and contiguous
               for s in seen for shape, stride, contiguous in s)


def _compare_stage_tables(case):
    n, cap, offset = 3000, 64, 12345
    tbl = _table(n, seed=len(case))
    ref, port, ref_batch, port_batch = _both_stages(tbl, case)
    bucket = 4096
    rng = np.random.default_rng(3)
    codes = np.full(bucket, cap, dtype=np.int32)
    codes[:n] = rng.integers(0, cap - 14, n)
    codes[:n:97] = cap + 5   # trash codes beyond the table
    ref_cols = {name: ref_batch.get_column(name).to_device(bucket, f32=True)
                for name in ref._input_cols}
    port_cols = {name: port_batch.get_column(name).to_device(bucket, f32=True,
                                                              device="cpu")
                 for name in port._input_cols}
    want = ref._build_pallas(cap, interpret=True)(
        ref_cols, jnp.asarray(codes), ref_row_mask(n, bucket), jnp.asarray(float(offset)))
    got = port._build_kernel(cap)(
        port_cols, torch.from_numpy(codes), port_row_mask(n, bucket, "cpu"), offset)
    np.testing.assert_array_equal(got["mm"].numpy(), np.asarray(want["mm"]))
    assert len(got["ext"]) == len(want["ext"]) and len(got["sct"]) == len(want["sct"])
    for g, w in zip(got["ext"], want["ext"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for g, w in zip(got["sct"], want["sct"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_kernel_tier_refuses_float_sums_and_float_extremes():
    # the kernels serve float sums (K7) and float extremes (K3 on an f64
    # key, in a stage computed in f64); only kernel_mode="off" refuses them,
    # as it refuses every stage
    schema = daft_tpu_torch.Schema.from_pydict(
        {"k": daft_tpu_torch.DataType.int64(), "x": daft_tpu_torch.DataType.float64()})
    col = daft_tpu_torch.col
    from daft_tpu_torch.ops import counters

    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        sums = port_gs.try_build_grouped_agg_stage(schema, None, [col("k")],
                                                   [col("x").sum()])
        assert sums.sum_routes() == ([0, 1], [2]) and not sums._use_f64
        top = port_gs.try_build_grouped_agg_stage(schema, None, [col("k")],
                                                  [col("x").max()])
        assert top._use_f64 and top._float_ext == [1]
        assert port_gs.try_build_grouped_agg_stage(
            schema, None, [col("k")], [col("x").count()]) is not None
    assert not counters.rejections
    with daft_tpu_torch.execution_config_ctx(device="cpu", kernel_mode="off"):
        for agg in (col("x").sum(), col("x").max(), col("x").count()):
            assert port_gs.try_build_grouped_agg_stage(schema, None, [col("k")],
                                                       [agg]) is None
    assert sum(counters.rejections.values()) == 3
