"""The port's row hash (daft_tpu_torch/core/kernels/hashing.py) is bit-identical
to the reference's for every port dtype: the same column, built once in
Arrow for the reference and carried across as numpy planes, must hash to the
same uint64 per row. Hash repartitions, host and mesh alike, depend on it.
"""

import datetime

import numpy as np
import pyarrow as pa
import pytest

from daft_tpu.core.kernels import hashing as ref_hashing
from daft_tpu.core.series import Series as RefSeries
from daft_tpu_torch.core.kernels import hashing
from daft_tpu_torch.core.series import Series
from daft_tpu_torch.datatype import DataType

N = 2000


def _carry(ref: RefSeries) -> Series:
    return Series.from_numpy(ref.to_numpy(), ref.name, dtype=DataType(ref.dtype.kind),
                             validity=ref.validity_numpy())


def _ints(rng, np_dtype):
    info = np.iinfo(np_dtype)
    vals = rng.integers(info.min, info.max, N, dtype=np_dtype, endpoint=True)
    vals[:4] = [info.min, info.max, 0, 1]
    return vals


def _floats(rng, np_dtype):
    vals = (rng.standard_normal(N) * 1e6).astype(np_dtype)
    vals[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, -np.nan]
    return vals


def _case(kind: str, rng) -> pa.Array:
    mask = rng.random(N) < 0.1
    mask[:8] = False
    if kind in ("int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64"):
        return pa.array(_ints(rng, np.dtype(kind)), type=getattr(pa, kind)(), mask=mask)
    if kind in ("float32", "float64"):
        return pa.array(_floats(rng, np.dtype(kind)), type=getattr(pa, kind)(), mask=mask)
    if kind == "bool":
        return pa.array(rng.random(N) < 0.5, mask=mask)
    if kind == "date":
        days = rng.integers(-30_000, 30_000, N).astype(np.int32)
        days[:4] = [-1, 0, 1, -719_162]      # 1969-12-31, the epoch, 0001-01-01
        return pa.array(days, type=pa.date32(), mask=mask)
    raise AssertionError(kind)


KINDS = ["int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
         "float32", "float64", "bool", "date"]


@pytest.mark.parametrize("kind", KINDS)
def test_hash_matches_reference(kind):
    rng = np.random.default_rng(KINDS.index(kind))
    ref = RefSeries.from_arrow(_case(kind, rng), "c")
    port = _carry(ref)
    assert port.dtype == DataType(kind)
    want = ref.hash().to_numpy()
    got = port.hash().to_numpy()
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    assert (got[~port.validity_numpy()] == hashing.NULL_HASH).all()
    # a seeded hash mixes the seed the same way
    seed = rng.integers(0, 2**63, N).astype(np.uint64)
    np.testing.assert_array_equal(port.hash(Series.from_numpy(seed)).to_numpy(),
                                  ref.hash(RefSeries.from_numpy(seed)).to_numpy())


def test_float_canonicalization():
    """-0.0 hashes as 0.0, every NaN alike, f32 as the same f64 value."""
    h = Series.from_numpy(np.array([0.0, -0.0, np.nan, -np.nan, 1.5])).hash().to_numpy()
    assert h[0] == h[1] and h[2] == h[3]
    h32 = Series.from_numpy(np.array([1.5, np.nan], dtype=np.float32)).hash().to_numpy()
    assert h32[0] == h[4] and h32[1] == h[2]


def test_date_hashes_like_its_day_count():
    days = [-1, 0, 19_000]
    dates = Series.from_pylist([datetime.date(1970, 1, 1) + datetime.timedelta(days=d)
                                for d in days])
    ints = Series.from_numpy(np.array(days, dtype=np.int64))
    np.testing.assert_array_equal(dates.hash().to_numpy(), ints.hash().to_numpy())


STRINGS = ["", "a", "abc", "x" * 255, "x" * 256, "x" * 257, "y" * 1000,
           "é" * 128, "é" * 129, "日本語のテキスト", "🙂" * 64, "🙂" * 65, "a\x00b", None]


def test_string_hash_matches_reference():
    rng = np.random.default_rng(3)
    vals = [STRINGS[i] for i in rng.integers(0, len(STRINGS), N)] + STRINGS
    ref = RefSeries.from_arrow(pa.array(vals, type=pa.large_string()), "s")
    port = _carry(ref)
    assert port.dtype.is_string()
    np.testing.assert_array_equal(port.hash().to_numpy(), ref.hash().to_numpy())
    # the cut between FNV-1a and blake2b is 256 UTF-8 bytes, by row
    lens = [len(s.encode()) for s in STRINGS[3:9]]
    assert lens == [255, 256, 257, 1000, 256, 258]


def test_golden_abc_and_null_column():
    assert int(Series.from_pylist(["abc"]).hash().to_numpy()[0]) == 12578444927678923021
    assert int(RefSeries.from_pylist(["abc"]).hash().to_numpy()[0]) == 12578444927678923021
    nulls = Series.from_pylist([None, None])
    assert (nulls.hash().to_numpy() == hashing.NULL_HASH).all()


@pytest.mark.parametrize("n_keys", [2, 3])
def test_combine_hashes_matches_reference(n_keys):
    rng = np.random.default_rng(n_keys)
    hashes = [rng.integers(0, 2**64 - 1, N, dtype=np.uint64, endpoint=True)
              for _ in range(n_keys)]
    np.testing.assert_array_equal(hashing.combine_hashes(hashes),
                                  ref_hashing.combine_hashes(hashes))
    np.testing.assert_array_equal(hashing.splitmix64(hashes[0]),
                                  ref_hashing.splitmix64(hashes[0]))
