"""The mesh hash repartition slice on the CPU. The port's mesh is 8 shard slots
on ``device="cpu"`` (K6 runs its plain version there); the reference runs on
the 8 forced host devices of tests/conftest.py.

- ``repartition(8, col(...))`` through the port's mesh, under both
  ``kernel_mode`` values (K6 tier and all_to_all tier), equals the
  reference's host repartition partition by partition, rows in order and
  nulls included, and so does the port's host path;
- the port's ring and all_to_all steps equal the reference's
  ``sharded_alltoall_repartition_step`` bit for bit (its ring step does not
  run on this jax, ROADMAP F1);
- every gate refusal records its reason and still gives the host partitions;
- the random scheme equals the reference's;
- ``_pack_words`` / ``_unpack_words`` round-trip every dtype bit for bit.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch import col
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters
from daft_tpu_torch.parallel import distributed as dist

N_DEV = 8


def _carry(ref_df):
    batch = ref_df.collect()._result[0].concat_or_empty()
    schema = daft_tpu_torch.Schema.from_pydict(
        {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_df.schema})
    return from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)


def _parts(df_result):
    return [p.to_pydict() for p in df_result]


def _ref_host(ref_df, *by):
    with ref_ctx(device_mode="off"):
        return _parts(ref_df.repartition(N_DEV, *by).collect()._result)


def _port(df, *by, **cfg):
    cfg = {"device": "cpu", **cfg}
    with daft_tpu_torch.execution_config_ctx(**cfg):
        return _parts(df.repartition(N_DEV, *by).collect()._result)


def _table(seed: int, n: int, big: bool) -> pa.Table:
    """The columns of the reference's own repartition tests (k, v, w with
    nulls; big past 2^53), plus the other numeric kinds."""
    rng = np.random.default_rng(seed)
    cols = {
        "k": pa.array(rng.integers(0, 997, n), pa.int64()),
        "v": pa.array(rng.random(n) * 100),
        "w": pa.array([None if i % 17 == 0 else int(i % 31) for i in range(n)], pa.int64()),
        "f32": pa.array(rng.standard_normal(n).astype(np.float32),
                        mask=rng.random(n) < 0.05),
        "i8": pa.array(rng.integers(-128, 128, n).astype(np.int8), pa.int8()),
        "u32": pa.array(rng.integers(0, 2**32, n).astype(np.uint32), pa.uint32()),
        "b": pa.array(rng.random(n) < 0.5, mask=rng.random(n) < 0.1),
    }
    if big:
        cols["big"] = pa.array(2**53 + rng.integers(0, 1000, n), pa.int64())
        cols["u64"] = pa.array(rng.integers(0, 2**64 - 1, n, dtype=np.uint64, endpoint=True),
                               pa.uint64())
    return pa.table(cols)


@pytest.mark.parametrize("kernel_mode", ["on", "off"])
@pytest.mark.parametrize("seed,n,big,by", [(5, 80_000, False, ("k",)),
                                           (4, 16_000, True, ("k",)),
                                           (6, 20_000, True, ("big", "w"))])
def test_mesh_repartition_matches_reference_host(kernel_mode, seed, n, big, by):
    ref_df = daft_tpu.from_arrow(_table(seed, n, big))
    df = _carry(ref_df)
    want = _ref_host(ref_df, *[daft_tpu.col(c) for c in by])
    assert len(want) == N_DEV and sum(len(p[by[0]]) for p in want) == n
    counters.reset()
    got = _port(df, *[col(c) for c in by], mesh_devices=N_DEV, device_min_rows=1,
                kernel_mode=kernel_mode)
    snap = counters.snapshot()
    assert not counters.rejections
    assert snap["mesh_alltoall_rows"] == n and snap["mesh_exchange_bytes"] > 0
    if kernel_mode == "on":
        assert snap["mesh_fused_permute_dispatches"] == 1
        assert snap["mesh_alltoall_dispatches"] == 0
        assert snap["plain_ring_permute_words"] == 1
    else:
        assert snap["mesh_alltoall_dispatches"] == 1
        assert snap["mesh_fused_permute_dispatches"] == 0
        assert snap["plain_ring_permute_words"] == 0
    assert snap["launches_ring_permute_words"] == 0
    assert got == want
    assert _port(df, *[col(c) for c in by], device_mode="off") == want


def _step_inputs(seed: int, S: int = 512):
    rng = np.random.default_rng(seed)
    total = N_DEV * S
    dest = rng.integers(0, N_DEV, total).astype(np.int64)
    row_mask = rng.random(total) > 0.1
    f64 = rng.standard_normal(total)
    f64[:4] = [np.nan, -0.0, np.inf, np.frombuffer(b"\x01\x00\x00\x00\x00\x00\xf8\x7f",
                                                   np.float64)[0]]  # a NaN payload
    planes = (f64,                                                   # f64
              rng.random(total) > 0.5,                               # bool validity
              (1 << 62) + rng.integers(0, 1 << 20, total),           # int64 past 2^53
              rng.integers(-100, 100, total).astype(np.int32))
    return dest, row_mask, planes


@pytest.mark.parametrize("tier", ["ring", "alltoall"])
def test_steps_match_reference_alltoall_step(tier):
    from daft_tpu.parallel.distributed import default_mesh as ref_mesh
    from daft_tpu.parallel.distributed import sharded_alltoall_repartition_step as ref_step

    dest, row_mask, planes = _step_inputs(3)
    ref = ref_step(ref_mesh(N_DEV), tuple(p.dtype for p in planes))
    want_counts, want_planes = ref(dest, row_mask, *planes)
    mesh = dist.default_mesh(N_DEV, "cpu")
    step = (dist.sharded_ring_repartition_step if tier == "ring"
            else dist.sharded_alltoall_repartition_step)
    counters.reset()
    got_counts, got_planes = step(mesh, torch.from_numpy(dest), torch.from_numpy(row_mask),
                                  *[torch.from_numpy(p) for p in planes])
    assert counters.snapshot()["plain_ring_permute_words"] == (tier == "ring")
    np.testing.assert_array_equal(got_counts.numpy(), np.asarray(want_counts))
    for g, w, p in zip(got_planes, want_planes, planes):
        g, w = g.numpy(), np.asarray(jax.device_get(w))
        assert g.dtype == p.dtype and g.shape == w.shape == (N_DEV * N_DEV, 512)
        np.testing.assert_array_equal(g.view(f"u{g.itemsize}") if g.dtype != bool else g,
                                      w.view(f"u{w.itemsize}") if w.dtype != bool else w)


def test_ring_and_alltoall_steps_agree_with_all_rows_to_one_shard():
    """One destination receives every row: its bins fill to the full shard
    size S, and the counts say so."""
    S = 512
    dest = np.full(N_DEV * S, 3, dtype=np.int64)
    row_mask = np.ones(N_DEV * S, dtype=bool)
    vals = np.arange(N_DEV * S, dtype=np.int64)
    mesh = dist.default_mesh(N_DEV, "cpu")
    args = (torch.from_numpy(dest), torch.from_numpy(row_mask), torch.from_numpy(vals))
    rc, (rp,) = dist.sharded_ring_repartition_step(mesh, *args)
    ac, (ap,) = dist.sharded_alltoall_repartition_step(mesh, *args)
    assert torch.equal(rc, ac) and torch.equal(rp, ap)
    counts = rc.view(N_DEV, N_DEV)
    assert counts[3].tolist() == [S] * N_DEV and counts.sum().item() == N_DEV * S
    np.testing.assert_array_equal(rp.view(N_DEV, N_DEV, S)[3].reshape(-1).numpy(), vals)


@pytest.mark.parametrize("dtype", [torch.bool, torch.int8, torch.uint8, torch.int16,
                                   torch.int32, torch.int64, torch.float32, torch.float64])
def test_pack_unpack_round_trip_is_bit_exact(dtype):
    rng = np.random.default_rng(9)
    raw = rng.integers(0, 256, (3, 4, 64 * 8), dtype=np.uint8)
    if dtype == torch.bool:
        mat = torch.from_numpy(raw[..., :64] > 127)
    else:
        mat = torch.from_numpy(raw).view(dtype)
    words = dist._pack_words(mat)
    assert words.dtype == torch.int32
    assert words.shape[-1] == dist._word_width(dtype, mat.shape[-1])
    back = dist._unpack_words(words, dtype)
    assert back.dtype == dtype
    assert torch.equal(back.view(torch.uint8) if dtype != torch.bool else back,
                       mat.view(torch.uint8) if dtype != torch.bool else mat)


def _refusal_case(kind: str):
    rng = np.random.default_rng(12)
    n = 4000
    cols = {"k": pa.array(rng.integers(0, 50, n), pa.int64()),
            "v": pa.array(rng.integers(0, 9, n), pa.int32(), mask=rng.random(n) < 0.1)}
    if kind == "string":
        cols["s"] = pa.array([f"x{i % 13}" for i in range(n)])
    if kind == "date":
        cols["d"] = pa.array(rng.integers(-400, 400, n).astype(np.int32), pa.date32())
    return daft_tpu.from_arrow(pa.table(cols))


@pytest.mark.parametrize("kind,cfg,reason", [
    ("string", {}, "a column is neither numeric nor boolean"),
    ("date", {}, "a column is neither numeric nor boolean"),
    ("plain", {"mesh_devices": 4}, "partition count differs from mesh_devices"),
    ("plain", {"mesh_devices": 1}, "mesh_devices < 2: no mesh"),
    ("plain", {"mesh_devices": 0}, "mesh_devices < 2: no mesh"),
    ("plain", {"device_min_rows": 4001}, "fewer rows than device_min_rows"),
])
def test_gate_refusals_record_and_match_host(kind, cfg, reason):
    ref_df = _refusal_case(kind)
    df = _carry(ref_df)
    want = _ref_host(ref_df, daft_tpu.col("k"))
    counters.reset()
    got = _port(df, col("k"), **{"mesh_devices": N_DEV, "device_min_rows": 1, **cfg})
    assert counters.rejections == {f"repartition: {reason}": 1}
    snap = counters.snapshot()
    assert snap["mesh_fused_permute_dispatches"] == snap["mesh_alltoall_dispatches"] == 0
    assert snap["plain_ring_permute_words"] == 0
    assert got == want


def test_host_path_records_nothing():
    ref_df = _refusal_case("plain")
    counters.reset()
    got = _port(_carry(ref_df), col("k"), device_mode="off", mesh_devices=N_DEV)
    assert not counters.rejections
    assert got == _ref_host(ref_df, daft_tpu.col("k"))


def test_random_scheme_matches_reference():
    ref_df = daft_tpu.from_arrow(_table(7, 5000, False))
    with ref_ctx(device_mode="off"):
        want = _parts(ref_df.repartition(N_DEV).collect()._result)
    got = _port(_carry(ref_df), mesh_devices=N_DEV, device_min_rows=1)
    assert got == want
    assert sorted(len(p["k"]) for p in got) != [625] * N_DEV  # really random


def test_repartition_plan_refuses_what_is_not_ported():
    df = daft_tpu_torch.from_pydict({"k": np.arange(10)})
    with pytest.raises(ValueError, match="at least one key"):
        daft_tpu_torch.plan.logical.Repartition(df._plan, 4, "hash", [])
    with pytest.raises(NotImplementedError, match="range"):
        daft_tpu_torch.plan.logical.Repartition(df._plan, 4, "range", [col("k")])
