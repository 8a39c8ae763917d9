"""The port's host kernel library (daft_tpu_torch/native.py, csrc/kernels.cpp)
against the reference's (daft_tpu/native.py over native/src/kernels.cpp)
and against its own plain numpy versions.

Each of the 25 exports runs on the same seeded inputs three ways: through
the port's wrapper on the port's library, through the same wrapper on the
reference's library (its ``get_lib`` build, declared with the port's
argument types) and, where the reference has a wrapper of the same name,
through that too, and through the plain version (``DAFT_TPU_DISABLE_NATIVE``
set). Integers, codes, group ids, pair order and f64 sums (all three add
in row order) are held bit for bit; a NaN only as a NaN. The edge cases:
empty inputs, every row null, no codes, int64's extremes, NaN and +-0 in
min/max, duplicate build keys.

Then the engine: grouped aggregates, every join type (the whole-input
join and the build-once probe table: dense, hashed, unique, multi-column
and null-matching keys) and filters run through the port with the library
and with the switch set, equal to each other and to the reference; a
library that fails to build raises; pool threads probing one table and
counting calls at once lose nothing.
"""

import ctypes
import sys
import threading
import zlib

import numpy as np
import pyarrow as pa
import pytest

import daft_tpu
import daft_tpu.native as ref_native
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch import native
from daft_tpu_torch.core.kernels.join import ProbeTable
from daft_tpu_torch.core.series import Series
from daft_tpu_torch.ops import _build

SEED = 2110
I64 = np.iinfo(np.int64)


@pytest.fixture(scope="module", autouse=True)
def ref_lib():
    """The reference's library, loaded before any test sets the switch (its
    ``get_lib`` reads the environment once), then opened again as a second
    handle that carries the port's declarations of all 25 exports."""
    assert ref_native.get_lib() is not None, "the reference's library did not build"
    return native.declare(ctypes.CDLL(ref_native._SO_PATH))


def same(a, b) -> bool:
    """Equal bit for bit (dtype, shape and values; floats by their bits but
    for NaN, which matches NaN), recursively through tuples."""
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) \
            and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        b = np.asarray(b)
        if a.dtype != b.dtype or a.shape != b.shape:
            return False
        if a.dtype.kind == "f":
            na, nb = np.isnan(a), np.isnan(b)
            return bool(np.array_equal(na, nb)
                        and np.array_equal(a[~na].view(np.int64), b[~nb].view(np.int64)))
        return bool(np.array_equal(a, b))
    return a == b


def three_ways(monkeypatch, ref_lib, call, export: str, ref_call=None):
    """call() on the port's library, on the reference's, and plain (the
    switch set); with ``ref_call``, the reference's own wrapper too. Each
    library run counts ``export`` once or more, the plain run never."""
    before = native.calls().get(export, 0)
    mine = call()
    assert native.calls().get(export, 0) > before, export
    with monkeypatch.context() as m:
        m.setattr(native, "_LIB", ref_lib)
        theirs = call()
    with monkeypatch.context() as m:
        m.setenv(native.DISABLE_ENV, "1")
        counted = native.calls()
        plain = call()
        assert native.calls() == counted
    assert same(mine, theirs), (mine, theirs)
    if ref_call is not None:
        assert same(mine, ref_call()), export
    return mine, plain


def _rng(case) -> np.random.Generator:
    """A generator seeded by SEED and the case's name (crc32: str's hash
    changes from process to process)."""
    return np.random.default_rng([SEED, zlib.crc32(str(case).encode())])


# ---- hashing -------------------------------------------------------------------------


@pytest.mark.parametrize("size", [0, 1, 3, 4, 7, 8, 15, 31, 32, 33, 64, 100, 257])
@pytest.mark.parametrize("seed", [0, 1, 2**64 - 1])
def test_xxhash64(monkeypatch, ref_lib, size, seed):
    data = _rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
    mine, plain = three_ways(monkeypatch, ref_lib, lambda: native.native_xxhash64(data, seed),
                             "xxhash64")
    assert mine == plain == native.plain_xxhash64(data, seed)


@pytest.mark.parametrize("case", ["mixed", "empty_rows", "no_rows"])
def test_hash_binary_column(monkeypatch, ref_lib, case):
    rng = _rng(case)
    lens = {"mixed": rng.integers(0, 70, 200), "empty_rows": np.zeros(5, np.int64),
            "no_rows": np.zeros(0, np.int64)}[case]
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    data = rng.integers(0, 256, int(offsets[-1]), dtype=np.uint8)
    mine, plain = three_ways(
        monkeypatch, ref_lib, lambda: native.native_hash_binary_column(data, offsets, 7),
        "hash_binary_column")
    assert same(mine, plain) and len(mine) == len(lens)


@pytest.mark.parametrize("case", ["random", "extremes", "empty"])
def test_hash_u64_column(monkeypatch, ref_lib, case):
    vals = {"random": _rng(case).integers(I64.min, I64.max, 1000, dtype=np.int64),
            "extremes": np.array([I64.min, -1, 0, 1, I64.max], dtype=np.int64),
            "empty": np.zeros(0, np.int64)}[case]
    mine, plain = three_ways(monkeypatch, ref_lib,
                             lambda: native.native_hash_u64_column(vals, 11), "hash_u64_column")
    assert same(mine, plain)
    assert all(int(h) == native.plain_xxhash64(int(v).to_bytes(8, "little", signed=True), 11)
               for h, v in zip(mine[:20], vals[:20]))


# ---- factorize -----------------------------------------------------------------------


FACTORIZE_CASES = {
    "small_domain": lambda r: r.integers(0, 30, 5000),
    "wide": lambda r: r.integers(I64.min, I64.max, 3000, dtype=np.int64),
    "null_code": lambda r: r.integers(-1, 5, 2000),
    "extremes": lambda r: np.array([I64.max, I64.min, 0, -1, I64.max, I64.min, -1, 0]),
    "empty": lambda r: np.zeros(0, np.int64),
    "one": lambda r: np.array([42]),
    "all_same": lambda r: np.full(100, -7),
}


@pytest.mark.parametrize("case", sorted(FACTORIZE_CASES))
def test_factorize_i64(monkeypatch, ref_lib, case):
    keys = FACTORIZE_CASES[case](_rng(case)).astype(np.int64)
    mine, plain = three_ways(monkeypatch, ref_lib, lambda: native.native_factorize(keys),
                             "factorize_i64", lambda: ref_native.native_factorize(keys))
    assert same(mine, plain)
    codes, g = mine
    assert g == len(np.unique(keys))
    if len(keys):  # first-occurrence order: a new code is one past the largest so far
        assert codes[0] == 0 and np.all(np.diff(np.maximum.accumulate(codes)) <= 1)


@pytest.mark.parametrize("case", ["pairs", "nulls", "wide_b", "empty"])
def test_combine_factorize_i64(monkeypatch, ref_lib, case):
    r = _rng(case)
    n = 0 if case == "empty" else 4000
    a = r.integers(-1 if case == "nulls" else 0, 50, n)
    b = r.integers(-1 if case == "nulls" else 0, 100_000 if case == "wide_b" else 20, n)
    dom = int(b.max(initial=-1)) + 1
    mine, plain = three_ways(monkeypatch, ref_lib,
                             lambda: native.native_combine_factorize(a, b, dom),
                             "combine_factorize_i64",
                             lambda: ref_native.native_combine_factorize(a, b, dom))
    assert same(mine, plain)
    assert mine[1] == len(set(zip(a.tolist(), b.tolist())))


# ---- grouped aggregation -------------------------------------------------------------


def _grouped_inputs(case, dtype):
    r = _rng((case, dtype))
    n, g = {"random": (5000, 40), "empty": (0, 0), "no_rows_some_groups": (0, 4),
            "all_null": (300, 5), "sparse_groups": (200, 1000)}[case]
    gids = r.integers(0, max(g, 1), n)
    valid = r.random(n) < (0.0 if case == "all_null" else 0.85)
    if dtype == "f64":
        vals = r.standard_normal(n) * 1e3
        special = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e308, -1e308])
        vals[r.integers(0, max(n, 1), min(n, 60))] = special[r.integers(0, 7, min(n, 60))]
    else:
        vals = r.integers(-10**6, 10**6, n)  # the extremes wrap the int64 sums
        vals[r.integers(0, max(n, 1), min(n, 30))] = I64.max
        vals[:min(n, 3)] = [I64.max, I64.min, I64.max][:min(n, 3)]
    return gids.astype(np.int64), vals.astype(np.float64 if dtype == "f64" else np.int64), \
        valid, g


GROUPED = ["random", "empty", "no_rows_some_groups", "all_null", "sparse_groups"]


@pytest.mark.parametrize("case", GROUPED)
@pytest.mark.parametrize("dtype", ["f64", "i64"])
def test_grouped_sum(monkeypatch, ref_lib, case, dtype):
    gids, vals, valid, g = _grouped_inputs(case, dtype)
    mine, plain = three_ways(monkeypatch, ref_lib,
                             lambda: native.native_grouped_sum(gids, vals, valid, g),
                             f"grouped_sum_{dtype}",
                             lambda: ref_native.native_grouped_sum(gids, vals, valid, g))
    assert same(mine, plain)
    assert mine[1].sum() == valid.sum()


@pytest.mark.parametrize("case", GROUPED)
@pytest.mark.parametrize("dtype", ["f64", "i64"])
def test_grouped_minmax(monkeypatch, ref_lib, case, dtype):
    gids, vals, valid, g = _grouped_inputs(case, dtype)
    mine, plain = three_ways(monkeypatch, ref_lib,
                             lambda: native.native_grouped_minmax(gids, vals, valid, g),
                             f"grouped_minmax_{dtype}",
                             lambda: ref_native.native_grouped_minmax(gids, vals, valid, g))
    assert same(mine, plain)


def test_grouped_minmax_nan_and_signed_zeros(monkeypatch, ref_lib):
    """NaN never wins, an all-NaN group keeps the identity, and of 0.0 and
    -0.0 the group's first stays, in either order."""
    gids = np.array([0, 0, 1, 1, 2, 2, 3, 3, 3], dtype=np.int64)
    vals = np.array([0.0, -0.0, -0.0, 0.0, np.nan, np.nan, np.nan, 2.0, np.nan])
    valid = np.ones(9, dtype=bool)
    (mn, mx), _ = three_ways(monkeypatch, ref_lib,
                             lambda: native.native_grouped_minmax(gids, vals, valid, 5),
                             "grouped_minmax_f64")
    assert np.signbit(mn[:2]).tolist() == [False, True]
    assert np.signbit(mx[:2]).tolist() == [False, True]
    assert mn[2] == np.inf and mx[2] == -np.inf and mn[3] == mx[3] == 2.0
    assert mn[4] == np.inf and mx[4] == -np.inf  # a group with no rows


def test_grouped_routes_other_dtypes_back():
    """As the reference's wrappers: only float64 and int64 values reach the
    kernels; the caller picks the type it sums in."""
    g = np.zeros(3, np.int64)
    ok = np.ones(3, bool)
    for vals in (np.ones(3, np.float32), np.ones(3, np.uint64), np.ones(3, np.int32)):
        assert native.native_grouped_sum(g, vals, ok, 1) is None
        assert native.native_grouped_minmax(g, vals, ok, 1) is None


# ---- the bucket join -----------------------------------------------------------------


JOIN_CASES = {
    "dups": (lambda r: r.integers(0, 50, 700), lambda r: r.integers(0, 50, 300), 50),
    "negatives": (lambda r: r.integers(-2, 20, 500), lambda r: r.integers(-3, 20, 400), 20),
    "no_codes": (lambda r: np.full(10, -2), lambda r: np.full(5, -3), 0),
    "empty_left": (lambda r: np.zeros(0, np.int64), lambda r: r.integers(0, 9, 40), 9),
    "empty_right": (lambda r: r.integers(0, 9, 40), lambda r: np.zeros(0, np.int64), 9),
    "unique_right": (lambda r: r.integers(0, 1000, 800), lambda r: r.permutation(1000), 1000),
}


def _join_inputs(case):
    lf, rf, g = JOIN_CASES[case]
    r = _rng(case)
    return lf(r).astype(np.int64), rf(r).astype(np.int64), g


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_join_count(monkeypatch, ref_lib, case):
    lc, rc, g = _join_inputs(case)
    mine, plain = three_ways(monkeypatch, ref_lib,
                             lambda: native.native_join_counts(lc, rc, g), "join_count",
                             lambda: ref_native.native_join_counts(lc, rc, g))
    assert same(mine, plain)


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_join_fill(monkeypatch, ref_lib, case):
    lc, rc, g = _join_inputs(case)
    mine, plain = three_ways(monkeypatch, ref_lib,
                             lambda: native.native_join_indices(lc, rc, g), "join_fill",
                             lambda: ref_native.native_join_indices(lc, rc, g))
    assert same(mine, plain)
    l, r, _ = mine  # left-major, a left row's right rows in row order
    want = [(i, j) for i in range(len(lc)) for j in range(len(rc))
            if lc[i] >= 0 and lc[i] == rc[j]]
    assert list(zip(l.tolist(), r.tolist())) == want


# ---- buckets and the probe -----------------------------------------------------------


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_bucket_build_and_scatter(monkeypatch, ref_lib, case):
    _lc, rc, g = _join_inputs(case)
    built, plain = three_ways(monkeypatch, ref_lib, lambda: native.native_bucket_build(rc, g),
                              "bucket_build", lambda: ref_native.native_bucket_build(rc, g))
    assert same(built, plain)
    counts, offsets, _mx = built
    total = int(counts.sum())
    rows, plain = three_ways(
        monkeypatch, ref_lib, lambda: native.native_bucket_scatter(rc, g, offsets, total),
        "bucket_scatter", lambda: ref_native.native_bucket_scatter(rc, g, offsets, total))
    assert same(rows, plain)


@pytest.mark.parametrize("case", sorted(JOIN_CASES))
def test_probe_count_and_fill(monkeypatch, ref_lib, case):
    lc, rc, g = _join_inputs(case)
    counts, offsets, _ = native.plain_bucket_build(rc, g)
    counts, offsets = (counts, offsets) if g else (np.zeros(1, np.int64),) * 2
    rows = native.plain_bucket_scatter(rc, g, offsets, int(counts.sum()))
    mine, plain = three_ways(
        monkeypatch, ref_lib, lambda: native.native_probe(lc, g, offsets, counts, rows),
        "probe_count", lambda: ref_native.native_probe(lc, g, offsets, counts, rows))
    assert same(mine, plain)
    assert same(mine, native.plain_join_indices(lc, rc, g))
    total = int(mine[2].sum())
    fill, plain = three_ways(
        monkeypatch, ref_lib,
        lambda: native.native_probe_fill(lc, g, offsets, counts, rows, total), "probe_fill",
        lambda: ref_native.native_probe_fill(lc, g, offsets, counts, rows, total))
    assert same(fill, plain) and same(fill, mine[:2])


# ---- maps ----------------------------------------------------------------------------


MAP_CASES = {
    "sparse": lambda r: r.choice(np.arange(0, 10**12, 7919), 3000, replace=False),
    "extremes": lambda r: np.array([I64.min, I64.max, -1, 0, 1, I64.min + 1]),
    "empty": lambda r: np.zeros(0, np.int64),
    "duplicates": lambda r: np.array([5, 9, 5, 12, 9, 9]),
}


def _map_inputs(case):
    r = _rng(case)
    keys = MAP_CASES[case](r).astype(np.int64)
    probes = np.concatenate([keys, r.integers(I64.min, I64.max, 500, dtype=np.int64),
                             [I64.min, I64.max, 0, -1]]).astype(np.int64)
    return keys, r.permutation(probes)


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_i64_pairmap(monkeypatch, ref_lib, case):
    """The interleaved map: the same slots from both libraries, the same
    positions from every lookup (a duplicated key gives its first)."""
    keys, probes = _map_inputs(case)
    def ref_build():  # the reference leaves an empty slot's key unwritten
        slots, cap = ref_native.native_i64_map_build(keys)
        slots[0::2][slots[1::2] == -1] = -1
        return slots, cap

    hm, plain_hm = three_ways(monkeypatch, ref_lib, lambda: native.native_i64_map_build(keys),
                              "i64_pairmap_build", ref_build)
    assert isinstance(plain_hm[0], native.PlainMap)
    got, plain = three_ways(monkeypatch, ref_lib,
                            lambda: native.native_i64_map_lookup(*hm, probes),
                            "i64_pairmap_lookup",
                            lambda: ref_native.native_i64_map_lookup(*hm, probes))
    assert same(got, plain) and same(got, native.native_i64_map_lookup(*plain_hm, probes))
    first = {}
    for i, k in enumerate(keys.tolist()):
        first.setdefault(k, i)
    assert got.tolist() == [first.get(p, -1) for p in probes.tolist()]


@pytest.mark.parametrize("case", sorted(MAP_CASES))
def test_i64_split_map(monkeypatch, ref_lib, case):
    keys, probes = _map_inputs(case)
    m, plain_m = three_ways(monkeypatch, ref_lib,
                            lambda: native.native_i64_split_map_build(keys), "i64_map_build")
    got, plain = three_ways(monkeypatch, ref_lib,
                            lambda: native.native_i64_split_map_lookup(*m, probes),
                            "i64_map_lookup")
    assert same(got, plain)
    assert same(got, native.native_i64_split_map_lookup(*plain_m, probes))
    assert same(got, native.plain_i64_map_lookup(native.plain_i64_map_build(keys)[0], 0,
                                                 probes))


# ---- the fused probes ----------------------------------------------------------------


def _fused_inputs(case, masked):
    r = _rng((case, masked))
    build = r.integers(0, 400, 600) * (1 if case == "dense" else 10**9 + 7)
    kept, g = native.plain_factorize(build)
    keys = np.empty(g, np.int64)
    keys[kept] = build
    counts, offsets, _ = native.plain_bucket_build(kept, g)
    vals = np.concatenate([r.choice(build, 700), r.integers(-50, 10**12, 300),
                           [I64.min, I64.max]]).astype(np.int64)
    valid = (r.random(len(vals)) < 0.8) if masked else None
    return build, kept, keys, g, counts, offsets, vals, valid


@pytest.mark.parametrize("layout", ["dense", "hashmap", "splitmap"])
@pytest.mark.parametrize("masked", [False, True])
def test_probe_lookup_count(monkeypatch, ref_lib, layout, masked):
    build, kept, keys, g, counts, offsets, vals, valid = _fused_inputs(layout, masked)
    if layout == "dense":
        lo, hi = int(build.min()), int(build.max())
        kept = build - lo
        counts, offsets, _ = native.plain_bucket_build(kept, hi - lo + 1)
        g = hi - lo + 1
        lookup, export = ("dense", lo, hi), "probe_lookup_count_dense"
    elif layout == "hashmap":
        lookup, export = ("hashmap", native.native_i64_map_build(keys)), "probe_lookup_count_pair"
    else:
        lookup, export = ("splitmap", native.native_i64_split_map_build(keys)), \
            "probe_lookup_count_hash"
    ref = None if layout == "splitmap" else \
        (lambda: ref_native.native_probe_lookup_count(vals, valid, lookup, counts, g))
    mine, plain = three_ways(
        monkeypatch, ref_lib,
        lambda: native.native_probe_lookup_count(vals, valid, lookup, counts, g), export, ref)
    assert same(mine, plain)
    codes, l_match, total = mine
    rows = native.plain_bucket_scatter(kept, g, offsets, len(build))
    fill = native.native_probe_fill(codes, g, offsets, counts, rows, total)
    want_l, want_r = [], []
    for i, v in enumerate(vals.tolist()):
        if valid is None or valid[i]:
            hits = np.flatnonzero(build == v).tolist()
            want_l += [i] * len(hits)
            want_r += hits
    assert fill[0].tolist() == want_l and fill[1].tolist() == want_r and total == len(want_l)


@pytest.mark.parametrize("layout", ["pairmap", "dense"])
@pytest.mark.parametrize("masked", [False, True])
def test_probe_unique(monkeypatch, ref_lib, layout, masked):
    r = _rng((layout, masked))
    build = r.permutation(5000)[:3000].astype(np.int64) * (1 if layout == "dense" else 104729)
    vals = np.concatenate([r.choice(build, 2000), r.integers(-9, 10**10, 500),
                           [I64.min, I64.max]]).astype(np.int64)
    valid = (r.random(len(vals)) < 0.75) if masked else None
    if layout == "dense":
        lo, hi = int(build.min()), int(build.max())
        table = np.full(hi - lo + 1, -1, np.int64)
        table[build - lo] = np.arange(len(build))
        direct = ("dense", lo, hi, table)
        export = "probe_unique_dense"
    else:
        direct = ("pairmap",) + native.native_i64_map_build(build)
        export = "probe_unique_pair"
    mine, plain = three_ways(monkeypatch, ref_lib,
                             lambda: native.native_probe_unique(vals, valid, direct), export,
                             lambda: ref_native.native_probe_unique(vals, valid, direct))
    assert same(mine, plain)
    where = {k: i for i, k in enumerate(build.tolist())}
    want = [where.get(v, -1) if valid is None or valid[i] else -1
            for i, v in enumerate(vals.tolist())]
    assert mine[0].tolist() == want
    assert mine[1].tolist() == [i for i, w in enumerate(want) if w >= 0]


# ---- selection vectors ---------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 3, 64, 67])
@pytest.mark.parametrize("n", [0, 1, 63, 64, 65, 1000])
@pytest.mark.parametrize("with_validity", [False, True])
def test_bool_mask_indices(monkeypatch, ref_lib, offset, n, with_validity):
    """Arrow-style bitmaps (np.packbits, LSB first) at a bit offset, against
    the reference's wrapper over the same buffers as a pyarrow array."""
    r = _rng((offset, n, with_validity))
    values = r.random(offset + n) < 0.4
    validity = r.random(offset + n) < 0.8
    bits = native.pack_mask(values)
    vbits = native.pack_mask(validity) if with_validity else None
    arr = pa.BooleanArray.from_buffers(
        pa.bool_(), n, [pa.py_buffer(vbits.tobytes()) if with_validity else None,
                        pa.py_buffer(bits.tobytes())], offset=offset)
    mine, plain = three_ways(monkeypatch, ref_lib,
                             lambda: native.native_mask_indices(bits, vbits, offset, n),
                             "bool_mask_indices", lambda: ref_native.native_mask_indices(arr))
    keep = values[offset:] & (validity[offset:] if with_validity else True)
    assert same(mine, plain) and mine.tolist() == np.flatnonzero(keep).tolist()


def test_wrappers_refuse_what_a_kernel_would_read_past():
    """The C side checks no length: the wrappers refuse a short bitmap,
    misaligned columns, a bucket table shorter than its codes and a map
    whose slots do not match its capacity."""
    z = np.zeros(8, np.int64)
    with pytest.raises(ValueError, match="bits read by words"):
        native.native_mask_indices(np.zeros(4, np.uint8), None, 0, 32)
    with pytest.raises(ValueError, match="differ in length"):
        native.native_grouped_sum(z, np.zeros(7), np.ones(8, bool), 1)
    with pytest.raises(ValueError, match="shorter than its"):
        native.native_probe(z, 9, z, z, z)
    with pytest.raises(ValueError, match="2 x cap"):
        native.native_i64_map_lookup(np.full(6, -1, np.int64), 4, z)
    with pytest.raises(ValueError, match="past the data buffer"):
        native.native_hash_binary_column(np.zeros(3, np.uint8), np.array([0, 5]))


# ---- the engine ----------------------------------------------------------------------


def _columns(n: int = 3000):
    r = np.random.default_rng(SEED)
    strs = np.array(["ab", "cd", "ef", "gh", "", "ij"], dtype=object)
    return {
        "k": (r.integers(0, 40, n), r.random(n) < 0.9),
        "sparse": (r.integers(0, 300, n) * 1_000_003 - 7 * 10**11, r.random(n) < 0.95),
        "s": (strs[r.integers(0, 6, n)], r.random(n) < 0.9),
        "b": (r.random(n) < 0.5, r.random(n) < 0.9),
        "i": (r.integers(-10**6, 10**6, n), r.random(n) < 0.8),
        "u": (r.integers(0, 2**40, n).astype(np.uint64), r.random(n) < 0.8),
        "f": (np.round(r.standard_normal(n) * 100, 2), r.random(n) < 0.85),
        "g": (r.standard_normal(n).astype(np.float32), r.random(n) < 0.85),
    }


def _frames(cols):
    def pylist(v, ok):
        return [x if o else None for x, o in zip(v.tolist(), ok.tolist())]

    data = {name: pylist(*c) for name, c in cols.items()}
    return daft_tpu.from_pydict(data), daft_tpu_torch.from_pydict(data)


@pytest.fixture(scope="module")
def frames():
    return _frames(_columns())


@pytest.fixture(scope="module")
def dims():
    r = np.random.default_rng(SEED + 1)
    n = 400
    return _frames({
        "k": (r.permutation(400) % 50, r.random(n) < 0.95),              # dense, dups
        "sparse": (r.permutation(400) * 1_000_003 - 7 * 10**11, np.ones(n, bool)),  # unique
        "s": (np.array(["ab", "cd", "zz", "ef"], dtype=object)[r.integers(0, 4, n)],
              r.random(n) < 0.9),
        "w": (r.integers(0, 1000, n), r.random(n) < 0.9),
    })


def _three(query, *frames_):
    """The query through the reference, the port with the library and the
    port with the switch set: (reference, library, plain, library calls)."""
    with ref_ctx(device_mode="off"):
        want = query(daft_tpu, *[f[0] for f in frames_]).to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        before = native.calls()
        got = query(daft_tpu_torch, *[f[1] for f in frames_]).to_pydict()
        after = native.calls()
        mp = pytest.MonkeyPatch()
        try:
            mp.setenv(native.DISABLE_ENV, "1")
            plain = query(daft_tpu_torch, *[f[1] for f in frames_]).to_pydict()
            assert native.calls() == after
        finally:
            mp.undo()
    return want, got, plain, {k: v - before.get(k, 0) for k, v in after.items()
                              if v > before.get(k, 0)}


AGGS = ["sum", "mean", "min", "max", "stddev", "var", "count"]


@pytest.mark.parametrize("keys", [["k"], ["s"], ["k", "s"], ["b", "k"], ["sparse"]])
def test_groupby_with_and_without_the_library(frames, keys):
    def q(m, df):
        aggs = [getattr(m.col(c), op)().alias(f"{op}_{c}") for c in ("i", "u", "f", "g", "b")
                for op in AGGS if not (c == "b" and op in ("stddev", "var"))]
        return df.groupby(*keys).agg(*aggs).sort(keys)

    want, got, plain, used = _three(q, frames)
    assert got == plain == want
    assert used.get("factorize_i64", 0) + used.get("combine_factorize_i64", 0) > 0
    assert used.get("grouped_sum_f64") and used.get("grouped_sum_i64")
    assert used.get("grouped_minmax_f64") and used.get("grouped_minmax_i64")


JOIN_KEYS = {"dense": ["k"], "sparse_unique": ["sparse"], "string": ["s"],
             "multi": ["k", "s"]}


@pytest.mark.parametrize("how", ["inner", "left", "right", "outer", "semi", "anti"])
@pytest.mark.parametrize("keys", sorted(JOIN_KEYS))
def test_joins_with_and_without_the_library(frames, dims, how, keys):
    on = JOIN_KEYS[keys]

    def q(m, df, dim):
        j = df.select(*on, "i").join(dim.select(*on, "w"), on=on, how=how)
        return j.sort(j.column_names)

    want, got, plain, used = _three(q, frames, dims)
    assert got == plain == want
    assert used, "no library call"


@pytest.mark.parametrize("how", ["semi", "anti", "inner"])
def test_null_matching_joins_with_and_without_the_library(frames, dims, how):
    def q(m, df, dim):
        j = df.select("k", "s").join(dim.select("k", "s"), left_on=["k", "s"],
                                     right_on=["k", "s"], how=how, null_equals_null=True)
        return j.sort(j.column_names)

    want, got, plain, _used = _three(q, frames, dims)
    assert got == plain == want


@pytest.mark.parametrize("pred", ["nulls", "all", "none", "broadcast"])
def test_filters_with_and_without_the_library(frames, pred):
    def q(m, df):
        p = {"nulls": (m.col("i") > 0) & m.col("b"), "all": m.col("k") >= -1,
             "none": m.col("k") < -1, "broadcast": m.lit(True)}[pred]
        return df.where(p).select("k", "i", "f").sort(["k", "i", "f"])

    want, got, plain, _used = _three(q, frames)
    assert got == plain == want


def _batch(df):
    return df.collect()._result[0].concat_or_empty()


def test_probe_table_paths_match_the_plain_versions(frames, dims, monkeypatch):
    """ProbeTable's four probes (unique keys in one read, the fused single
    key over a dense range and over the hashed map, the general path over
    strings and two columns) against the same table built plain."""
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        left = _batch(frames[1])
        right = _batch(dims[1])
    for names in (["sparse"], ["k"], ["s"], ["k", "s"]):
        lk = [left.get_column(n) for n in names]
        rk = [right.get_column(n) for n in names]
        table = ProbeTable(rk, [s.dtype for s in lk])
        with monkeypatch.context() as m:
            m.setenv(native.DISABLE_ENV, "1")
            plain_table = ProbeTable(rk, [s.dtype for s in lk])
        for how in ("inner", "left", "semi", "anti"):
            got = table.probe(lk, how)
            assert same(got, plain_table.probe(lk, how)), (names, how)
            with monkeypatch.context() as m:
                m.setenv(native.DISABLE_ENV, "1")
                assert same(got, table.probe(lk, how)), (names, how)


def test_concurrent_probes_and_counts_lose_nothing(frames, dims):
    """Pool threads probing one table at once (the build-once host join)
    get the sequential pairs, and the call counter misses no call, with a
    short switch interval and more threads than cores."""
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        left, right = _batch(frames[1]), _batch(dims[1])
    lk, rk = [left.get_column("k")], [right.get_column("k")]
    table = ProbeTable(rk, [lk[0].dtype])
    want = table.probe(lk, "inner")
    threads, rounds = 24, 20
    results, errors = [], []
    before = native.calls().get("probe_fill", 0)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            try:
                for _ in range(rounds):
                    results.append(same(table.probe(lk, "inner"), want))
            except Exception as exc:  # noqa: BLE001 -- reported below
                errors.append(exc)
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and len(results) == threads * rounds and all(results)
    assert native.calls()["probe_fill"] - before == threads * rounds


def test_grouped_reduce_keeps_the_reference_exclusions():
    """uint64 sums, min and max stay exact in uint64 (the int64 kernels
    would wrap at 2^63); a uint64 mean goes through the f64 kernel."""
    from daft_tpu_torch.core.kernels.groupby import grouped_reduce

    vals = np.array([2**63 + 5, 2**63 + 1, 7], dtype=np.uint64)
    gids = np.array([0, 0, 1], dtype=np.int64)
    ok = np.ones(3, dtype=bool)
    before = native.calls()
    s, _ = grouped_reduce("sum", vals, ok, gids, 2)
    mn, _ = grouped_reduce("min", vals, ok, gids, 2)
    assert s.dtype == np.uint64 and s.tolist() == [(2**64 + 6) % 2**64, 7]
    assert mn.tolist() == [2**63 + 1, 7] and native.calls() == before
    m, _ = grouped_reduce("mean", vals, ok, gids, 2)
    assert native.calls().get("grouped_sum_f64", 0) == before.get("grouped_sum_f64", 0) + 1
    assert m.tolist() == [(float(2**63 + 5) + float(2**63 + 1)) / 2, 7.0]


def test_a_failed_build_raises_instead_of_running_numpy(monkeypatch, tmp_path):
    """CXX=false: the first load raises, and so does a query that reaches
    the library; only the switch runs the plain versions."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(_build, "BUILD_INFO", {})
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setenv("CXX", "false")
    with pytest.raises(RuntimeError, match="failed for .*kernels.cpp"):
        native.native_factorize(np.arange(5))
    df = daft_tpu_torch.from_pydict({"k": [1, 2, 1], "v": [1.0, 2.0, 3.0]})
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        with pytest.raises(RuntimeError, match="kernels.cpp"):
            df.groupby("k").agg(daft_tpu_torch.col("v").sum()).to_pydict()
        monkeypatch.setenv(native.DISABLE_ENV, "1")
        out = df.groupby("k").agg(daft_tpu_torch.col("v").sum()).sort("k").to_pydict()
    assert out == {"k": [1, 2], "v": [4.0, 2.0]}
    assert native._LIB is None and not list(tmp_path.glob("*.so"))


def test_library_is_built_from_the_port_source():
    lib = native.get_lib()
    info = _build.BUILD_INFO["kernels.cpp"]
    assert info["path"].startswith(_build.BUILD_DIR + "/libkernels_host_")
    assert lib._name == info["path"] and native.SOURCE.endswith("daft_tpu_torch/csrc/kernels.cpp")
    assert all(getattr(lib, name).argtypes is not None for name in native.EXPORTS)
    assert len(native.EXPORTS) == 25


def test_equality_codes_first_occurrence_and_nulls():
    """Numeric keys take the library's first-occurrence codes; -0.0 groups
    with 0.0, every NaN together; a null is -1."""
    from daft_tpu_torch.core.kernels.groupby import equality_codes, make_groups

    s = Series.from_pylist([3.0, -0.0, None, float("nan"), 0.0, 3.0, float("nan")])
    assert equality_codes(s).tolist() == [0, 1, -1, 2, 1, 0, 2]
    first, ids, counts = make_groups([s])
    assert first.tolist() == [0, 1, 2, 3] and ids.tolist() == [0, 1, 2, 3, 1, 0, 3]
    assert counts.tolist() == [2, 2, 1, 2]
