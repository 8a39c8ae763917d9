"""The join TopN's row order (``DeviceJoinTopNRun.finalize_topn``) against
the host's sort, on inputs where an ordering plane in f64, or one that maps
null to an infinity, gives the wrong rows:

- an int64 sum over a plain column has eight two's-complement digit
  planes; the device must rebuild it signed (a negative sum is not
  v + 2^64), and order it as int64 (sums past 2^53 that differ in their low
  bits must not tie);
- NaN, +-inf and null sort keys are placed as the host places them: NaN
  counts as +inf, and nulls go first or last by ``nulls_first`` whatever
  the values are.

Each case runs in all four (desc x nulls_first) settings through the port's
device path (device="cpu": the kernels' plain versions), its host path and
the reference's host path (daft_tpu, device_mode="off"). The reference's
device TopN shares the first fault and gives NaN for every group on the
second, so it is not the oracle here.
"""

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch.device.residency import manager
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.ops import counters
from daft_tpu_torch.plan import physical as pp

N_FACT = 4000
SETTINGS = [(d, nf) for d in (True, False) for nf in (True, False)]


def _carry(ref_df):
    batch = ref_df.collect()._result[0].concat_or_empty()
    schema = daft_tpu_torch.Schema.from_pydict(
        {f.name: daft_tpu_torch.DataType(f.dtype.kind) for f in ref_df.schema})
    return from_numpy_columns(
        {s.name: (s.to_numpy(), s.validity_numpy()) for s in batch.columns}, schema)


def _tables(fact: pa.Table, dim: pa.Table):
    ref = {"fact": daft_tpu.from_arrow(fact).collect(),
           "dim": daft_tpu.from_arrow(dim).collect()}
    return ref, {k: _carry(v) for k, v in ref.items()}


def _query(dt, t, desc, nulls_first, limit):
    col = dt.col
    return (t["fact"].join(t["dim"], left_on="fk", right_on="k")
            .groupby("k").agg(col("v").sum().alias("s"), col("v").count().alias("n"))
            .sort("s", desc=desc, nulls_first=nulls_first).limit(limit))


def _run_all(tables, desc, nulls_first, limit):
    """(port device, port host, reference host) results; the port's device
    run must have been one device TopN run."""
    ref, port = tables
    with ref_ctx(device_mode="off"):
        want = _query(daft_tpu, ref, desc, nulls_first, limit).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        host = _query(daft_tpu_torch, port, desc, nulls_first, limit).to_pydict()
    manager().clear()
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        df = _query(daft_tpu_torch, port, desc, nulls_first, limit)
        assert any(isinstance(n, pp.DeviceJoinTopN)
                   for n in pp.translate(df.optimized_plan()).walk())
        got = df.to_pydict()
    snap = counters.snapshot()
    assert snap["device_topn_runs"] == 1 and snap["device_fallbacks"] == 0, \
        (snap, counters.rejections)
    return got, host, want


def _same_rows(a, b):
    """Equal column for column, rows in order: the float sums within rtol
    1e-5 (the device stage sums f32 planes; the reference's device-vs-host
    tolerance), NaN equal to NaN and nulls in place; the rest exactly."""
    assert list(a) == list(b)
    for c in a:
        if any(isinstance(v, float) for v in a[c]):
            f = [np.nan if v is None else v for v in a[c]]
            g = [np.nan if v is None else v for v in b[c]]
            assert [v is None for v in a[c]] == [v is None for v in b[c]], c
            np.testing.assert_allclose(f, g, rtol=1e-5, atol=0.0, err_msg=c)
        else:
            assert a[c] == b[c], c


@pytest.fixture(scope="module")
def negative_sums():
    """ROADMAP's P2 input: 4,000 fact rows, fk in 0..49, v int64 in
    [-1000, 1000), group 7 all -100,000, joined to a 50-row dim on k."""
    rng = np.random.default_rng(2)
    fk = rng.integers(0, 50, N_FACT)
    v = rng.integers(-1000, 1000, N_FACT)
    v[fk == 7] = -100_000
    fact = pa.table({"fk": pa.array(fk, pa.int64()), "v": pa.array(v, pa.int64())})
    dim = pa.table({"k": pa.array(np.arange(50), pa.int64())})
    return _tables(fact, dim)


@pytest.fixture(scope="module")
def wide_sums():
    """Sums past 2^53 that differ only below an f64 ulp: every group has 80
    rows of 2^55 plus a small per-group offset."""
    fk = np.arange(N_FACT) % 50
    v = (1 << 55) + (fk * 7919) % 97 - 48
    fact = pa.table({"fk": pa.array(fk, pa.int64()), "v": pa.array(v, pa.int64())})
    dim = pa.table({"k": pa.array(np.arange(50), pa.int64())})
    return _tables(fact, dim)


@pytest.fixture(scope="module")
def special_floats():
    """ROADMAP's P3 input: 12 groups of float sums, one +inf (group 3), one
    NaN (group 5), one null (group 8: every value null)."""
    rng = np.random.default_rng(3)
    fk = np.arange(600) % 12
    v = rng.uniform(-50, 50, 600)
    v[np.flatnonzero(fk == 3)[0]] = np.inf
    v[np.flatnonzero(fk == 5)[1]] = np.nan
    fact = pa.table({"fk": pa.array(fk, pa.int64()),
                     "v": pa.array(v, pa.float64(), mask=fk == 8)})
    dim = pa.table({"k": pa.array(np.arange(12), pa.int64())})
    return _tables(fact, dim)


@pytest.mark.parametrize("desc,nulls_first", SETTINGS)
def test_negative_int_sums_order_as_the_host(negative_sums, desc, nulls_first):
    got, host, want = _run_all(negative_sums, desc, nulls_first, 5)
    assert got == host == want
    assert got["s"] == sorted(got["s"], reverse=desc)
    # group 7's sum is the one far below zero: never among the largest
    assert (7 in got["k"]) == (not desc)
    if not desc:
        assert got["k"][0] == 7 and got["s"][0] < -100_000 * 50


@pytest.mark.parametrize("desc,nulls_first", SETTINGS)
def test_int_sums_past_2_53_order_exactly(wide_sums, desc, nulls_first):
    got, host, want = _run_all(wide_sums, desc, nulls_first, 12)
    assert got == host == want
    s = got["s"]
    assert all(abs(x) > 1 << 53 for x in s)
    # in f64 these sums tie: the order rests on the low bits
    assert len({float(x) for x in s}) < len(set(s))
    assert s == sorted(s, reverse=desc)


@pytest.mark.parametrize("desc,nulls_first", SETTINGS)
def test_nan_inf_and_null_keys_place_as_the_host(special_floats, desc, nulls_first):
    got, host, want = _run_all(special_floats, desc, nulls_first, 12)
    _same_rows(got, host)
    _same_rows(got, want)
    k = got["k"]
    assert (k[0] == 8) == nulls_first and (k[-1] == 8) == (not nulls_first)
    # NaN sorts as +inf, after the real +inf (first occurrence breaks the tie)
    assert k.index(5) == k.index(3) + 1
