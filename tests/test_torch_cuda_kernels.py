"""The hand-written CUDA kernels (K1-K3, K7 and K1a segment reduce, K4 and K5
hash probe, K6 mesh exchange) against their plain PyTorch versions, and
grouped queries (integer, float, f64 and 150,000 groups), an ungrouped
query, star join queries (the join TopN's row order among them), a fused
region and one mesh repartition through them against the host path, on
the card. Marked ``cuda``: skipped where no card
is present.

Run on a machine with the card (tests/conftest.py imports JAX, which that
machine lacks, so it is skipped):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_kernels.py

Every comparison is bit for bit but two: K1, K1a and K5 sum integer-valued
planes (exact whatever the atomic order: in f64, and in f32 below 2^24), K2/K3 are
order-independent extremes, K4's probe answers do not depend on where its
build placed each key (the table's (key, row) entries are compared as a
sorted set), and K6 only moves words. K1a, K5 and K7 are also held on
fractional planes within the worst case of f32 (K1a) or f64 (K5, K7)
summation in another order, each test stating its bound; K7 on
integer-valued planes is exact. K4's and K5's cases include keys
chosen on the host to share one home slot (chains of 1,500 slots, one of
them wrapping past the last slot), a 4096-slot region of the partitioned
build given more keys than slots, a table past 2^25 slots (the CAS tier),
facts that all miss, and every row count modulo the probe's rows per
thread.
"""

import numpy as np
import pytest
import torch

import daft_tpu_torch
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import permute_kernels as rk
from daft_tpu_torch.ops import probe_kernels as pk
from daft_tpu_torch.ops import segment_kernels as sk

pytestmark = pytest.mark.cuda

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")
    return torch.device("cuda")


def _codes(rng, n, cap):
    # trash (>= cap) and negative codes must be dropped
    return rng.integers(-2, cap + 3, n).astype(np.int32)


def _kept_codes(rng, n, cap, keep):
    # a `keep` share of rows in [0, cap), the rest trashed below 0 or at and
    # above cap
    trash = rng.choice(np.array([-2, -1, cap, cap + 7], dtype=np.int64), n)
    return np.where(rng.random(n) < keep, rng.integers(0, cap, n), trash).astype(np.int32)


# K1 and K2 by tier (segment_kernels.segment_planes_tier): block tables of
# plane groups (also at cap 8 with nearly every row kept on 8 entries), one
# table in device memory at cap 2^17, a list past one 64-plane chunk; n not
# a multiple of 4 in each tier, and every row trashed
PLANE_CASES = [
    (65536, 256, 15, 0.7), (1 << 20, 16384, 15, 0.98), (1 << 22, 8, 5, 0.98),
    (1 << 20, 1 << 17, 4, 0.7), (1 << 18, 4096, 73, 0.7),
    (4099, 256, 3, 0.7), (4099, 8, 3, 0.7), (4099, 1 << 17, 2, 0.7),
    (4096, 256, 3, 0.0), (4096, 8, 3, 0.0), (4096, 1 << 17, 3, 0.0),
    (4096, 8, 1, 1.0), (1, 16, 1, 1.0),
    # the global table at the grouped stage's ceiling, 2^20
    (1 << 21, 1 << 20, 3, 0.7), (4099, 1 << 20, 2, 0.7),
    # the join TopN's caps: TPC-H q3's 2^21 and the kernels' ceiling 2^22
    (1 << 22, 1 << 21, 2, 0.7), (1 << 22, 1 << 22, 3, 0.7), (4099, 1 << 22, 2, 0.7),
]


@pytest.mark.parametrize("n,cap,p,keep", PLANE_CASES)
def test_segment_sum_planes_matches_plain(cuda, n, cap, p, keep):
    rng = np.random.default_rng(n + cap + p)
    planes = rng.integers(0, 256, (p, n)).astype(np.float32)
    planes[rng.random((p, n)) < 0.3] = 0.0
    codes = _kept_codes(rng, n, cap, keep)
    # the rows of one (P, N) tensor: 16-byte aligned planes when n % 4 == 0
    tp, tc = torch.from_numpy(planes).to(cuda), torch.from_numpy(codes).to(cuda)
    before = counters.snapshot()["launches_segment_sum_planes"]
    got = sk.segment_sum_planes(list(tp), tc, cap)
    torch.cuda.synchronize()
    # one launch per chunk of PLANE_CHUNK planes
    chunks = -(-p // sk.PLANE_CHUNK)
    assert counters.snapshot()["launches_segment_sum_planes"] == before + chunks
    want = sk.segment_sum_planes_plain(list(tp), tc, cap)
    assert got.dtype == torch.float64 and got.shape == (cap, p)
    assert torch.equal(got, want)
    cpu = sk.segment_sum_planes(list(torch.from_numpy(planes)), torch.from_numpy(codes), cap)
    assert torch.equal(got.cpu(), cpu)
    if keep == 0:
        assert not got.any()
    # views one row in: off their 16-byte alignment, the single-row path
    if n > 1:
        got = sk.segment_sum_planes([t[1:] for t in tp], tc[1:], cap)
        assert torch.equal(got, sk.segment_sum_planes_plain([t[1:] for t in tp], tc[1:], cap))


@pytest.mark.parametrize("cap", [1, 256, 1 << 17, 1 << 20])
def test_segment_sum_planes_exact_at_the_contract_edge(cuda, cap):
    # 2^23 rows of 255 in one segment: 2,139,095,040, past f32's exact
    # integers and near uint32's end, must come out exact in every tier
    n = 1 << 23
    planes = [torch.full((n,), 255.0, device=cuda), torch.ones(n, device=cuda)]
    codes = torch.zeros(n, dtype=torch.int32, device=cuda)
    got = sk.segment_sum_planes(planes, codes, cap)
    assert got[0].tolist() == [2_139_095_040.0, float(n)]
    assert torch.equal(got, sk.segment_sum_planes_plain(planes, codes, cap))
    assert not got[1:].any()


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("n,cap,q,keep", PLANE_CASES)
def test_segment_extreme_planes_matches_plain(cuda, op, n, cap, q, keep):
    rng = np.random.default_rng(n + q)
    ident = np.inf if op == "min" else -np.inf
    planes = (rng.standard_normal((q, n)) * 1e6).astype(np.float32)
    planes[rng.random((q, n)) < 0.4] = ident
    codes = _kept_codes(rng, n, cap, keep)
    k = min(n, 4)
    planes[0, :k] = [np.inf, -np.inf, -1.5, 3.0][:k]
    codes[:k] = np.where(keep > 0, [0, 0, 1 % cap, 1 % cap], cap)[:k]
    tp, tc = torch.from_numpy(planes).to(cuda), torch.from_numpy(codes).to(cuda)
    before = counters.snapshot()["launches_segment_extreme_planes"]
    got = sk.segment_extreme_planes(list(tp), tc, cap, op)
    torch.cuda.synchronize()
    chunks = -(-q // sk.PLANE_CHUNK)
    assert counters.snapshot()["launches_segment_extreme_planes"] == before + chunks
    want = sk.segment_extreme_planes_plain(list(tp), tc, cap, op)
    assert got.dtype == torch.float32 and got.shape == (cap, q)
    assert torch.equal(got, want)
    if keep == 0:
        assert (got == ident).all()
    if n > 1:
        got = sk.segment_extreme_planes([t[1:] for t in tp], tc[1:], cap, op)
        want = sk.segment_extreme_planes_plain([t[1:] for t in tp], tc[1:], cap, op)
        assert torch.equal(got, want)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("n,cap,keep", [
    (1 << 20, 16384, 0.6), (8192, 64, 0.6),
    (1 << 22, 8, 0.98),            # every kept row on 8 addresses: warp pre-aggregation
    (1 << 20, 1 << 17, 0.6),       # past one block's shared memory: a cluster of 8
    (1 << 18, 40000, 0.6),         # a cluster of 4, the last block's slice part used
    (4099, 256, 0.0),              # every row masked out
    (1, 16, 1.0), (4099, 8, 0.6), (4099, 24576, 0.6),  # n not a multiple of 4
    (1 << 22, 1 << 20, 0.6),       # past a cluster's tables: the global tier
    (4099, (1 << 17) + 1, 0.6), (4096, 1 << 20, 0.0),
    (1 << 22, 1 << 22, 0.6),       # the kernels' ceiling (the join TopN's)
])
def test_segment_extreme_int64_matches_plain(cuda, op, n, cap, keep):
    rng = np.random.default_rng(cap + n)
    special = [I64_MIN, I64_MAX, 2**53 + 1, -(2**53) - 1, 0, -1, 2**62 + 7, -5]
    k = min(n, len(special))
    vals = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64, endpoint=True)
    vals[:k] = special[:k]
    mask = rng.random(n) < keep
    codes = _codes(rng, n, cap)  # codes below 0 and at or above cap: dropped
    codes[:k] = np.arange(k) % cap
    mask[:k] = keep > 0
    tv, tm, tc = (torch.from_numpy(a).to(cuda) for a in (vals, mask, codes))
    before = counters.snapshot()["launches_segment_extreme_int64"]
    got, got_ne = sk.segment_extreme_int64(tv, tm, tc, cap, op)
    torch.cuda.synchronize()
    assert counters.snapshot()["launches_segment_extreme_int64"] == before + 1
    want, want_ne = sk.segment_extreme_int64_plain(tv, tm, tc, cap, op)
    assert torch.equal(got, want) and torch.equal(got_ne, want_ne)
    assert got_ne.any().item() == (keep > 0)
    # views one row in: vals and codes off their 16-byte alignment take the
    # single-row path
    if n > 1:
        got, got_ne = sk.segment_extreme_int64(tv[1:], tm[1:], tc[1:], cap, op)
        want, want_ne = sk.segment_extreme_int64_plain(tv[1:], tm[1:], tc[1:], cap, op)
        assert torch.equal(got, want) and torch.equal(got_ne, want_ne)


def test_empty_segments_keep_identity(cuda):
    codes = torch.full((1024,), 7, dtype=torch.int32, device=cuda)
    vals = torch.arange(1024, dtype=torch.int64, device=cuda)
    mask = torch.zeros(1024, dtype=torch.bool, device=cuda)
    mask[3] = True
    mn, ne = sk.segment_extreme_int64(vals, mask, codes, 16, "min")
    mx, _ = sk.segment_extreme_int64(vals, mask, codes, 16, "max")
    assert ne.cpu().tolist() == [i == 7 for i in range(16)]
    assert mn[7].item() == 3 and mx[7].item() == 3
    assert mn[0].item() == I64_MAX and mx[0].item() == I64_MIN
    planes = [torch.full((1024,), float("inf"), device=cuda)]
    out = sk.segment_extreme_planes(planes, codes, 16, "min")
    assert torch.isinf(out).all()


def test_grouped_query_on_card_launches_kernels_and_matches_host(cuda):
    import datetime

    import daft_tpu_torch as dt
    from daft_tpu_torch import col, lit

    rng = np.random.default_rng(5)
    n = 50_000
    df = dt.from_pydict({
        "k": rng.integers(0, 6000, n),
        "v": rng.integers(-1000, 1000, n).astype(np.int32),
        "big": rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64),
        "d": rng.integers(8000, 10000, n).astype("datetime64[D]"),
    })

    def query():
        return (df.where(col("d") <= lit(datetime.date(1995, 1, 1))).groupby("k")
                .agg(col("v").sum().alias("s"), col("v").count().alias("n"),
                     col("d").min().alias("d0"), col("big").max().alias("b1"))
                .sort("k").to_pydict())

    counters.reset()
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        got = query()
    snap = counters.snapshot()
    assert all(snap[f"launches_{k}"] > 0 for k in counters.SEGMENT_KERNELS), snap
    assert snap["device_fallbacks"] == 0
    with dt.execution_config_ctx(device_mode="off"):
        assert got == query()


@pytest.mark.parametrize("n_dim,n_fact", [(300, 4096), (1 << 20, 1 << 22)])
def test_hash_probe_kernels_match_plain(cuda, n_dim, n_fact):
    rng = np.random.default_rng(n_dim)
    dim_keys = rng.choice(np.int64(1) << 60, n_dim, replace=False).astype(np.int64)
    dim_keys[:3] = [(1 << 53) + 11, -(1 << 62), 0]
    dim_valid = rng.random(n_dim) > 0.05
    fact_keys = dim_keys[rng.integers(0, n_dim, n_fact)].copy()
    fact_keys[::7] += 1
    fact_keys[::1001] = pk.EMPTY_KEY
    fact_valid = rng.random(n_fact) > 0.1
    dk, dv = torch.from_numpy(dim_keys).to(cuda), torch.from_numpy(dim_valid).to(cuda)
    fk, fv = torch.from_numpy(fact_keys).to(cuda), torch.from_numpy(fact_valid).to(cuda)
    slots = pk.probe_table_slots(n_dim)
    before = counters.snapshot()
    table = pk.build_probe_table(dk, dv, slots)
    got = pk.hash_probe_index(fk, fv, table)
    torch.cuda.synchronize()
    after = counters.snapshot()
    assert after["launches_hash_probe_build"] == before["launches_hash_probe_build"] + 1
    assert after["launches_hash_probe_index"] == before["launches_hash_probe_index"] + 1
    plain_table = pk.build_probe_table_plain(dk, dv, slots)
    for a, b in zip(pk.table_entries(table), pk.table_entries(plain_table)):
        assert torch.equal(a, b)
    want = pk.hash_probe_index_plain(fk, fv, table)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    assert torch.equal(pk.hash_probe_index_plain(fk, fv, plain_table), want)
    lut = {int(k): i for i, (k, v) in enumerate(zip(dim_keys, dim_valid)) if v}
    sample = rng.integers(0, n_fact, 2000)
    assert [got[i].item() for i in sample] == [
        lut.get(int(fact_keys[i]), -1) if fact_valid[i] else -1 for i in sample]


def test_star_join_query_on_card_launches_kernels_and_matches_host(cuda):
    import daft_tpu_torch as dt
    from daft_tpu_torch import col

    rng = np.random.default_rng(6)
    n, n_dim = 200_000, 30_000
    fact = dt.from_pydict({
        "f_k": rng.integers(0, n_dim + 500, n),
        "f_tag": np.array(["aa", "bb", "cc"], dtype=object)[rng.integers(0, 3, n)],
        "f_q": rng.integers(1, 50, n).astype(np.int32),
    })
    dim = dt.from_pydict({
        "d_k": rng.permutation(n_dim),
        "d_grp": np.array([f"g{i}" for i in range(9)], dtype=object)[
            rng.integers(0, 9, n_dim)],
        "d_big": (1 << 60) + rng.integers(0, 1 << 40, n_dim),
    })

    def query():
        return (fact.where(col("f_tag").is_in(["aa", "cc"]))
                .join(dim, left_on="f_k", right_on="d_k")
                .groupby("d_grp")
                .agg(col("f_q").sum().alias("s"), col("f_q").count().alias("n"),
                     col("d_big").max().alias("b"))
                .sort("d_grp").to_pydict())

    counters.reset()
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        got = query()
    snap = counters.snapshot()
    for k in ("hash_probe_build", "hash_probe_index", "segment_sum_planes",
              "segment_extreme_planes", "segment_extreme_int64"):
        assert snap[f"launches_{k}"] > 0, snap
    assert snap["device_join_batches"] == 1 and snap["device_fallbacks"] == 0
    with dt.execution_config_ctx(device_mode="off"):
        assert got == query()


@pytest.mark.parametrize("n,cap,p", [(1 << 20, 16384, 15), (4096, 8, 2)])
def test_segment_sum_planes_f32_matches_plain(cuda, n, cap, p):
    rng = np.random.default_rng(n + p)
    planes = rng.integers(0, 256, (n, p)).astype(np.float32)
    planes[rng.random((n, p)) < 0.3] = 0.0
    codes = _codes(rng, n, cap)
    tp, tc = torch.from_numpy(planes).to(cuda), torch.from_numpy(codes).to(cuda)
    before = counters.snapshot()["launches_segment_sum_planes_f32"]
    got = sk.segment_sum_planes_f32(tp, tc, cap)
    torch.cuda.synchronize()
    assert counters.snapshot()["launches_segment_sum_planes_f32"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (cap, p)
    assert torch.equal(got, sk.segment_sum_planes_f32_plain(tp, tc, cap))
    assert torch.equal(got, sk.segment_sum_planes(list(tp.t().contiguous()), tc, cap).float())


# K1a by tier (segment_kernels.segment_sum_f32_tier): block tables (one
# copy at cap 3000, two at cap 400, one per warp at cap 8 with nearly
# every row kept), the global table (the supplier's cap 16,384 and cap
# 2^17); n not a multiple of 4, P of 1-3 (a stack start 4, 8 or 12 bytes
# off 16-byte alignment when a view begins one row in), and n across
# several 2048-row tiles
F32_CASES = [
    (1 << 20, 16384, 15, 0.7, ("global", 1)), (1 << 20, 3000, 15, 0.7, ("block", 1)),
    (100_003, 400, 15, 0.9, ("block", 2)), (1 << 20, 8, 15, 0.98, ("block", 32)),
    (100_003, 1 << 17, 4, 0.7, ("global", 1)), (100_003, 20_000, 15, 0.7, ("global", 1)),
    (4099, 8, 1, 0.9, ("block", 32)), (4099, 100, 3, 0.9, ("block", 32)),
    (5001, 300, 2, 0.9, ("block", 27)), (70_001, 1 << 17, 1, 0.9, ("global", 1)),
    (4096, 8, 15, 0.0, ("block", 32)),
]


@pytest.mark.parametrize("n,cap,p,keep,tier", F32_CASES)
def test_segment_sum_planes_f32_tiers_match_plain(cuda, n, cap, p, keep, tier):
    assert tuple(sk.segment_sum_f32_tier(cap, p)) == tier
    rng = np.random.default_rng(n + cap + p)
    planes = rng.integers(0, 256, (n, p)).astype(np.float32)
    planes[rng.random((n, p)) < 0.3] = 0.0
    codes = _kept_codes(rng, n, cap, keep)
    tp, tc = torch.from_numpy(planes).to(cuda), torch.from_numpy(codes).to(cuda)
    before = counters.snapshot()["launches_segment_sum_planes_f32"]
    got = sk.segment_sum_planes_f32(tp, tc, cap)
    torch.cuda.synchronize()
    assert counters.snapshot()["launches_segment_sum_planes_f32"] == before + 1
    assert got.dtype == torch.float32 and got.shape == (cap, p)
    assert torch.equal(got, sk.segment_sum_planes_f32_plain(tp, tc, cap))
    if keep == 0:
        assert not got.any()
    # a view one row in: its first float 4p bytes past the tensor's start
    got = sk.segment_sum_planes_f32(tp[1:], tc[1:], cap)
    assert torch.equal(got, sk.segment_sum_planes_f32_plain(tp[1:], tc[1:], cap))


@pytest.mark.parametrize("cap,p", [(3000, 15), (16384, 15), (8, 3)])
def test_segment_sum_planes_f32_skips_trash_tiles(cuda, cap, p):
    """Runs of trashed rows as long as a 4096-row tile or longer, at and off
    tile boundaries, between kept rows, and a trashed tail as padding: a
    tile whose codes are all outside [0, cap) loads no vector, and a kept
    row just before or after such a run still counts. Its planes hold
    nonzero values, so a skipped tile that should have counted shows."""
    n = 9 * 4096 + 5
    rng = np.random.default_rng(cap + p)
    planes = rng.integers(1, 256, (n, p)).astype(np.float32)
    codes = _kept_codes(rng, n, cap, 0.9)
    for lo, hi in ((4096, 2 * 4096), (3 * 4096 - 1, 5 * 4096 + 1), (6 * 4096 + 7, n)):
        codes[lo:hi] = cap + 1
    codes[6 * 4096 + 6] = 0
    tp, tc = torch.from_numpy(planes).to(cuda), torch.from_numpy(codes).to(cuda)
    for start in (0, 1):  # a view one row in moves every tile boundary
        got = sk.segment_sum_planes_f32(tp[start:], tc[start:], cap)
        assert torch.equal(got, sk.segment_sum_planes_f32_plain(tp[start:], tc[start:], cap))


@pytest.mark.parametrize("n,cap,p", [(1 << 20, 16384, 15), (1 << 20, 8, 15),
                                     (100_003, 1 << 17, 4), (100_003, 3000, 15)])
def test_segment_sum_planes_f32_fractions_within_f32_order_bound(cuda, n, cap, p):
    """Fractional planes of both signs against an f64 sum of the same f32
    values. Each of a segment's n_seg additions in f32 rounds by at most
    2^-24 of a partial sum, and no partial sum exceeds the sum of |v|, so
    any order of f32 additions lies within n_seg * 2^-24 * sum|v| of the
    exact sum: the worst case of f32 summation in another order."""
    rng = np.random.default_rng(cap + p)
    planes = rng.normal(0.0, 100.0, (n, p)).astype(np.float32)
    codes = _kept_codes(rng, n, cap, 0.8)
    tp, tc = torch.from_numpy(planes).to(cuda), torch.from_numpy(codes).to(cuda)
    got = sk.segment_sum_planes_f32(tp, tc, cap).double()
    inside = (tc >= 0) & (tc < cap)
    idx = torch.where(inside, tc, cap).long()
    exact = torch.zeros((cap + 1, p), dtype=torch.float64, device=cuda)
    exact.index_add_(0, idx, tp.double())
    mags = torch.zeros((cap + 1, p), dtype=torch.float64, device=cuda)
    mags.index_add_(0, idx, tp.double().abs())
    n_seg = torch.bincount(idx, minlength=cap + 1).double()[:, None]
    bound = n_seg * 2.0 ** -24 * mags
    assert bool(((got - exact[:cap]).abs() <= bound[:cap]).all())
    assert bool((got != 0).any())


def _k5_case(rng, n_dim, n_fact, cap, p, keep, fractions=False):
    """Dim keys (the first two: a key past 2^53 and a negative one) with 5 %
    null, facts drawing dim keys with every 7th shifted to a miss, 10 %
    null, an INT64_MIN key, and a `keep` share of codes in [0, cap)."""
    dim_keys = rng.choice(np.int64(1) << 60, n_dim, replace=False).astype(np.int64)
    dim_keys[:2] = [(1 << 53) + 11, -(1 << 62)]
    dim_valid = rng.random(n_dim) > 0.05
    if fractions:
        planes = rng.normal(0.0, 10.0, (n_dim, p)).astype(np.float32)
    else:
        planes = rng.integers(0, 3, (n_dim, p)).astype(np.float32)
    fact_keys = dim_keys[rng.integers(0, n_dim, n_fact)].copy()
    fact_keys[::7] += 1
    fact_keys[5] = I64_MIN
    fact_valid = rng.random(n_fact) > 0.1
    fact_valid[5] = True
    codes = _kept_codes(rng, n_fact, cap, keep)
    return dim_keys, dim_valid, planes, fact_keys, fact_valid, codes


# K5 by tier (probe_kernels.hash_probe_segment_sum_tier): the shared table,
# with every row kept on 3 or 7 segments (the warps' groups are large) and
# with few rows kept; a cap whose table overflows the shared tier; fact
# counts not a multiple of 4
K5_CASES = [
    (300, 1 << 20, 3, 2, 1.0, "shared"), (1 << 16, 1 << 20, 7, 2, 1.0, "shared"),
    (1 << 16, 1 << 20, 8, 2, 0.004, "shared"), (1 << 16, 100_003, 2000, 2, 0.9, "global"),
    (5000, 4099, 16, 5, 0.9, "shared"), (5000, 4099, 5000, 1, 0.9, "global"),
]


@pytest.mark.parametrize("n_dim,n_fact,cap,p,keep,tier", K5_CASES)
def test_hash_probe_segment_sum_tiers_match_plain(cuda, n_dim, n_fact, cap, p, keep, tier):
    assert pk.hash_probe_segment_sum_tier(cap, p) == tier
    rng = np.random.default_rng(n_fact + cap)
    dim_keys, dim_valid, planes, fact_keys, fact_valid, codes = _k5_case(
        rng, n_dim, n_fact, cap, p, keep)
    table = pk.build_probe_table(torch.from_numpy(dim_keys).to(cuda),
                                 torch.from_numpy(dim_valid).to(cuda),
                                 pk.probe_table_slots(n_dim))
    args = [torch.from_numpy(a).to(cuda) for a in (fact_keys, fact_valid, codes)]
    tp = torch.from_numpy(planes).to(cuda)
    before = counters.snapshot()["launches_hash_probe_segment_sum"]
    sums, counts = pk.hash_probe_segment_sum(*args, table, tp, cap)
    torch.cuda.synchronize()
    assert counters.snapshot()["launches_hash_probe_segment_sum"] == before + 1
    want_sums, want_counts = pk.hash_probe_segment_sum_plain(*args, table, tp, cap)
    assert torch.equal(sums, want_sums) and torch.equal(counts, want_counts)
    assert counts.sum().item() > 0
    # the rows one in: codes off 16-byte alignment, one row a lane
    view = [a[1:] for a in args]
    sums, counts = pk.hash_probe_segment_sum(*view, table, tp, cap)
    want_sums, want_counts = pk.hash_probe_segment_sum_plain(*view, table, tp, cap)
    assert torch.equal(sums, want_sums) and torch.equal(counts, want_counts)


@pytest.mark.parametrize("n_fact", [1 << 20, (1 << 20) + 3])
def test_hash_probe_segment_sum_full_queue_repeats_match_plain(cuda, n_fact):
    """Every fact row kept, so each of a block's 4096-row chunks queues
    exactly 4096 rows and every other flush decision falls on the queue's
    limit: a warp that queues the next chunk before another warp has read
    the count would split the block's decision. Twenty runs, each equal to
    the plain version."""
    rng = np.random.default_rng(n_fact)
    dim_keys, dim_valid, planes, fact_keys, fact_valid, _ = _k5_case(
        rng, 1 << 16, n_fact, 7, 2, 1.0)
    dim_valid[:] = True
    fact_keys = dim_keys[rng.integers(0, len(dim_keys), n_fact)]
    fact_valid[:] = True
    codes = rng.integers(0, 7, n_fact).astype(np.int32)
    table = pk.build_probe_table(torch.from_numpy(dim_keys).to(cuda),
                                 torch.from_numpy(dim_valid).to(cuda),
                                 pk.probe_table_slots(len(dim_keys)))
    args = [torch.from_numpy(a).to(cuda) for a in (fact_keys, fact_valid, codes)]
    tp = torch.from_numpy(planes).to(cuda)
    want_sums, want_counts = pk.hash_probe_segment_sum_plain(*args, table, tp, 7)
    assert want_counts.sum().item() == n_fact
    for _ in range(20):
        sums, counts = pk.hash_probe_segment_sum(*args, table, tp, 7)
        assert torch.equal(sums, want_sums) and torch.equal(counts, want_counts)


@pytest.mark.parametrize("cap,keep", [(7, 1.0), (2000, 0.9)])
def test_hash_probe_segment_sum_fractions_within_f64_order_bound(cuda, cap, keep):
    """Fractional f32 planes: the kernel adds in f64 in another order than
    the plain version. Each of a segment's n_seg f64 additions rounds by at
    most 2^-53 of a partial sum, bounded by the sum of |v|, so the two lie
    within 2 * n_seg * 2^-53 * sum|v| of each other (each within half of
    it of the exact sum). Counts stay exact."""
    rng = np.random.default_rng(cap)
    dim_keys, dim_valid, planes, fact_keys, fact_valid, codes = _k5_case(
        rng, 1 << 16, 1 << 20, cap, 3, keep, fractions=True)
    table = pk.build_probe_table(torch.from_numpy(dim_keys).to(cuda),
                                 torch.from_numpy(dim_valid).to(cuda),
                                 pk.probe_table_slots(len(dim_keys)))
    args = [torch.from_numpy(a).to(cuda) for a in (fact_keys, fact_valid, codes)]
    tp = torch.from_numpy(planes).to(cuda)
    sums, counts = pk.hash_probe_segment_sum(*args, table, tp, cap)
    want_sums, want_counts = pk.hash_probe_segment_sum_plain(*args, table, tp, cap)
    assert torch.equal(counts, want_counts)
    idx = pk.hash_probe_index_plain(args[0], args[1], table)
    hit = (idx >= 0) & (args[2] >= 0) & (args[2] < cap)
    seg = torch.where(hit, args[2], cap).long()
    mags = torch.zeros((cap + 1, 3), dtype=torch.float64, device=cuda)
    mags.index_add_(0, seg, tp[idx.clamp(min=0).long()].double().abs())
    bound = 2 * want_counts.double()[:, None] * 2.0 ** -53 * mags[:cap]
    assert bool(((sums - want_sums).abs() <= bound).all())
    assert bool((sums != 0).any())


@pytest.mark.parametrize("n_dim,n_fact,cap,p", [(300, 4096, 16, 3), (1 << 20, 1 << 22, 8, 2)])
def test_hash_probe_segment_sum_matches_plain(cuda, n_dim, n_fact, cap, p):
    rng = np.random.default_rng(n_fact)
    dim_keys = rng.choice(np.int64(1) << 60, n_dim, replace=False).astype(np.int64)
    dim_keys[:2] = [(1 << 53) + 11, -(1 << 62)]
    dim_valid = rng.random(n_dim) > 0.05
    planes = rng.integers(0, 3, (n_dim, p)).astype(np.float32)
    fact_keys = dim_keys[rng.integers(0, n_dim, n_fact)].copy()
    fact_keys[::7] += 1
    fact_valid = rng.random(n_fact) > 0.1
    codes = _codes(rng, n_fact, cap)
    dk, dv = torch.from_numpy(dim_keys).to(cuda), torch.from_numpy(dim_valid).to(cuda)
    args = [torch.from_numpy(a).to(cuda) for a in (fact_keys, fact_valid, codes)]
    table = pk.build_probe_table(dk, dv, pk.probe_table_slots(n_dim))
    tp = torch.from_numpy(planes).to(cuda)
    before = counters.snapshot()["launches_hash_probe_segment_sum"]
    sums, counts = pk.hash_probe_segment_sum(*args, table, tp, cap)
    torch.cuda.synchronize()
    assert counters.snapshot()["launches_hash_probe_segment_sum"] == before + 1
    want_sums, want_counts = pk.hash_probe_segment_sum_plain(*args, table, tp, cap)
    assert sums.dtype == torch.float64 and counts.dtype == torch.int64
    assert torch.equal(sums, want_sums) and torch.equal(counts, want_counts)
    assert counts.sum().item() > 0


def _home_slots(keys: np.ndarray, slots: int) -> np.ndarray:
    """Each key's first slot in K4's table: splitmix64's finalizer of the
    key bits, masked (ops/csrc/hash_probe.cu mix64)."""
    x = keys.view(np.uint64).copy()
    with np.errstate(over="ignore"):
        x ^= x >> np.uint64(30)
        x *= np.uint64(0xBF58476D1CE4E5B9)
        x ^= x >> np.uint64(27)
        x *= np.uint64(0x94D049BB133111EB)
        x ^= x >> np.uint64(31)
    return (x & np.uint64(slots - 1)).astype(np.int64)


def _chain_case(home: int, seed: int):
    """1,500 dim keys that all start at slot ``home`` of a 4096-slot table
    (a chain of 1,500 slots; past the last slot when home + 1500 > 4096),
    500 others, 5 % null; 4099 facts: the dim keys, misses that start at
    the same slot (they walk the whole chain to an empty slot), other misses,
    nulls and one int64 min."""
    rng = np.random.default_rng(seed)
    slots = 4096
    cand = rng.permutation(np.arange(8_000_000, dtype=np.int64) - (1 << 49))
    same = cand[_home_slots(cand, slots) == home]
    assert len(same) >= 1600
    rest = cand[_home_slots(cand, slots) != home]
    dim_keys = np.concatenate([same[:1500], rest[:500]])
    rng.shuffle(dim_keys)
    dim_valid = rng.random(len(dim_keys)) > 0.05
    fact_keys = np.concatenate([dim_keys, dim_keys, same[1500:1600], rest[500:1399]])
    fact_keys = rng.permutation(fact_keys)[:4099]
    fact_keys[17] = pk.EMPTY_KEY
    fact_valid = rng.random(len(fact_keys)) > 0.05
    assert pk.probe_table_slots(len(dim_keys)) == slots
    return dim_keys, dim_valid, fact_keys, fact_valid, slots


@pytest.mark.parametrize("home", [100, 4096 - 300])
def test_hash_probe_long_chains_match_plain(cuda, home):
    dim_keys, dim_valid, fact_keys, fact_valid, slots = _chain_case(home, home)
    dk, dv = torch.from_numpy(dim_keys).to(cuda), torch.from_numpy(dim_valid).to(cuda)
    fk, fv = torch.from_numpy(fact_keys).to(cuda), torch.from_numpy(fact_valid).to(cuda)
    table = pk.build_probe_table(dk, dv, slots)
    got = pk.hash_probe_index(fk, fv, table)
    torch.cuda.synchronize()
    for a, b in zip(pk.table_entries(table), pk.table_entries(
            pk.build_probe_table_plain(dk, dv, slots))):
        assert torch.equal(a, b)
    # the chain is contiguous from its home slot, wrapping past S - 1
    occupied = (table[:, 0] != 0).cpu().numpy()
    chain = (home + np.arange(1500)) % slots
    assert occupied[chain].all()
    assert torch.equal(got, pk.hash_probe_index_plain(fk, fv, table))
    lut = {int(k): i for i, (k, v) in enumerate(zip(dim_keys, dim_valid)) if v}
    assert got.cpu().tolist() == [lut.get(int(k), -1) if v else -1
                                  for k, v in zip(fact_keys, fact_valid)]
    assert (got >= 0).sum().item() > 1000 and (got < 0).sum().item() > 500


@pytest.mark.parametrize("n_dim,n_fact", [(1 << 20, 1 << 22), (3000, 4099)])
def test_hash_probe_all_miss_matches_plain(cuda, n_dim, n_fact):
    """Every fact key valid and absent: every probe walks to an empty slot."""
    rng = np.random.default_rng(n_fact)
    dim_keys = rng.choice(np.int64(1) << 40, n_dim, replace=False).astype(np.int64)
    fact_keys = dim_keys[rng.integers(0, n_dim, n_fact)] + (np.int64(1) << 41)
    dk = torch.from_numpy(dim_keys).to(cuda)
    table = pk.build_probe_table(dk, torch.ones_like(dk, dtype=torch.bool),
                                 pk.probe_table_slots(n_dim))
    fk = torch.from_numpy(fact_keys).to(cuda)
    fv = torch.ones_like(fk, dtype=torch.bool)
    got = pk.hash_probe_index(fk, fv, table)
    assert torch.equal(got, pk.hash_probe_index_plain(fk, fv, table))
    assert (got == -1).all()


@pytest.mark.parametrize("n", [1, 3, 1027, 4097])
def test_hash_probe_rows_per_thread_any_row_count(cuda, n):
    """The probe's 2 rows per thread at row counts that are not a multiple
    of 2 or of a block's 2 x 256 rows."""
    dim_keys, dim_valid, fact_keys, fact_valid, slots = _chain_case(100, 7)
    table = pk.build_probe_table(torch.from_numpy(dim_keys).to(cuda),
                                 torch.from_numpy(dim_valid).to(cuda), slots)
    # views one row in: the fact columns need no alignment
    fk = torch.from_numpy(fact_keys).to(cuda)[1:n + 1]
    fv = torch.from_numpy(fact_valid).to(cuda)[1:n + 1]
    before = counters.snapshot()["launches_hash_probe_index"]
    got = pk.hash_probe_index(fk, fv, table)
    torch.cuda.synchronize()
    assert counters.snapshot()["launches_hash_probe_index"] == before + 1
    assert got.shape == (n,) and torch.equal(got, pk.hash_probe_index_plain(fk, fv, table))


def test_hash_probe_build_over_full_region_matches_plain(cuda):
    """5,000 of 8,000 dim keys start in the first 4096-slot region of a
    16,384-slot table: the partitioned build places 4096 of them in that
    region's shared memory and the rest through its overflow pass."""
    rng = np.random.default_rng(21)
    slots = 1 << 14
    cand = rng.permutation(np.arange(200_000, dtype=np.int64) + (1 << 40))
    homes = _home_slots(cand, slots)
    dim_keys = rng.permutation(np.concatenate([cand[homes < 4096][:5000],
                                               cand[homes >= 4096][:3000]]))
    assert len(dim_keys) == 8000 and pk.probe_table_slots(len(dim_keys)) == slots
    dk = torch.from_numpy(dim_keys).to(cuda)
    dv = torch.ones_like(dk, dtype=torch.bool)
    table = pk.build_probe_table(dk, dv, slots)
    for a, b in zip(pk.table_entries(table),
                    pk.table_entries(pk.build_probe_table_plain(dk, dv, slots))):
        assert torch.equal(a, b)
    fk = torch.cat([dk, dk + 1, dk[:100] - 1])
    fv = torch.ones_like(fk, dtype=torch.bool)
    got = pk.hash_probe_index(fk, fv, table)
    assert torch.equal(got, pk.hash_probe_index_plain(fk, fv, table))
    assert torch.equal(got[:8000].cpu(), torch.arange(8000, dtype=torch.int32))


def test_hash_probe_build_cas_tier_matches_plain(cuda):
    """Over 2^24 dim keys make a table past 2^25 slots, past the partitioned
    build's regions: the CAS tier builds it."""
    n_dim = (1 << 24) + 1
    gen = torch.Generator(device=cuda)
    gen.manual_seed(3)
    # distinct keys 3 apart, so a key + 1 is no key
    dim_keys = torch.randperm(1 << 26, device=cuda, generator=gen)[:n_dim] * 3 - (1 << 40)
    dim_valid = torch.rand(n_dim, device=cuda, generator=gen) > 0.05
    slots = pk.probe_table_slots(n_dim)
    assert slots == 1 << 26
    table = pk.build_probe_table(dim_keys, dim_valid, slots)
    for a, b in zip(pk.table_entries(table),
                    pk.table_entries(pk.build_probe_table_plain(dim_keys, dim_valid, slots))):
        assert torch.equal(a, b)
    pick = torch.randint(0, n_dim, (1 << 22,), device=cuda, generator=gen)
    fk = dim_keys[pick] + (torch.rand(1 << 22, device=cuda, generator=gen) < 0.1)
    fv = torch.ones_like(fk, dtype=torch.bool)
    got = pk.hash_probe_index(fk, fv, table)
    assert torch.equal(got, pk.hash_probe_index_plain(fk, fv, table))
    assert (got >= 0).sum().item() > 3_000_000


def test_hash_probe_refused_launch_raises(cuda, monkeypatch):
    """A launch the library refuses (a nonzero CUDA error) raises and is
    not counted: nothing falls back."""
    keys = torch.arange(8, dtype=torch.int64, device=cuda)
    valid = torch.ones(8, dtype=torch.bool, device=cuda)
    table = pk.build_probe_table(keys, valid, 16)

    class Refusing:
        @staticmethod
        def daft_hash_probe_index(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(pk, "_library", Refusing)
    before = counters.snapshot()
    with pytest.raises(RuntimeError, match="launch failed"):
        pk.hash_probe_index(keys, valid, table)
    after = counters.snapshot()
    assert after["launches_hash_probe_index"] == before["launches_hash_probe_index"]
    assert after["plain_hash_probe_index"] == before["plain_hash_probe_index"]


@pytest.mark.parametrize("home", [100, 4096 - 300])
def test_hash_probe_segment_sum_long_chains_match_plain(cuda, home):
    dim_keys, dim_valid, fact_keys, fact_valid, slots = _chain_case(home, home + 1)
    rng = np.random.default_rng(home)
    planes = rng.integers(0, 5, (len(dim_keys), 3)).astype(np.float32)
    codes = _codes(rng, len(fact_keys), 16)
    args = [torch.from_numpy(a).to(cuda) for a in (fact_keys, fact_valid, codes)]
    table = pk.build_probe_table(torch.from_numpy(dim_keys).to(cuda),
                                 torch.from_numpy(dim_valid).to(cuda), slots)
    tp = torch.from_numpy(planes).to(cuda)
    sums, counts = pk.hash_probe_segment_sum(*args, table, tp, 16)
    want_sums, want_counts = pk.hash_probe_segment_sum_plain(*args, table, tp, 16)
    assert torch.equal(sums, want_sums) and torch.equal(counts, want_counts)
    assert counts.sum().item() > 500


@pytest.mark.parametrize("n,w", [
    (8, 23 * 4096 + 4), (8, 23 * 4096 + 2), (3, 5), (1, 64),
    (8, 4),                # one 16-byte bulk copy per block
    (16, 1028),            # 256 blocks
    (4, 8192 + 4),         # 32 KB + 16 B per block: a short last chunk
    (2, 3 * 8192),         # blocks of exactly three chunks
])
def test_ring_permute_words_matches_plain(cuda, n, w):
    rng = np.random.default_rng(n * w)
    send = torch.from_numpy(rng.integers(-2**31, 2**31, (n, n, w), dtype=np.int64)
                            .astype(np.int32)).to(cuda)
    before = counters.snapshot()["launches_ring_permute_words"]
    got = rk.ring_permute_words(send)
    torch.cuda.synchronize()
    assert counters.snapshot()["launches_ring_permute_words"] == before + 1
    assert torch.equal(got, rk.ring_permute_words_plain(send))
    assert torch.equal(got, send.transpose(0, 1).contiguous())
    # a misaligned view takes the word path
    if w > 1:
        odd = send.view(-1)[1:1 + n * n * (w - 1)].view(n, n, w - 1)
        assert torch.equal(rk.ring_permute_words(odd), odd.transpose(0, 1).contiguous())
    # so does the same words at a 4-byte offset, whatever W is
    buf = torch.empty(n * n * w + 1, dtype=torch.int32, device=cuda)
    buf[1:] = send.view(-1)
    shifted = buf[1:].view(n, n, w)
    assert shifted.data_ptr() % 16 == 4
    assert torch.equal(rk.ring_permute_words(shifted), got)


def test_mesh_repartition_on_card_matches_host(cuda):
    import daft_tpu_torch as dt
    from daft_tpu_torch import col

    rng = np.random.default_rng(8)
    n = 100_000
    df = dt.from_pydict({
        "k": rng.integers(0, 997, n),
        "v": rng.standard_normal(n),
        "w": dt.Series.from_numpy(rng.integers(0, 31, n).astype(np.int32),
                                  validity=rng.random(n) > 0.05),
        "big": (1 << 53) + rng.integers(0, 1000, n),
        "b": rng.random(n) < 0.5,
    })
    with dt.execution_config_ctx(device_mode="off"):
        host = [p.to_pydict() for p in df.repartition(8, col("k")).collect()._result]
    for kernel_mode, launches in (("on", 1), ("off", 0)):
        counters.reset()
        with dt.execution_config_ctx(device="cuda", mesh_devices=8, device_min_rows=1,
                                     kernel_mode=kernel_mode):
            got = [p.to_pydict() for p in df.repartition(8, col("k")).collect()._result]
        snap = counters.snapshot()
        assert snap["launches_ring_permute_words"] == launches, snap
        assert snap["mesh_alltoall_dispatches"] == 1 - launches, snap
        assert got == host


# K7 by tier (segment_kernels.segment_sum_float_tier): a table per thread at
# cap 8 with nearly every row kept (TPC-H q1's shape), warp tables from cap
# 33 to the largest cap whose 16 tables hold every plane, block tables at the
# supplier's cap 16,384 (four groups of one plane) and up to cap 29,056 for
# one plane, the global table past that and at 2^20; each tier's
# boundary from both sides; f32 and f64 planes; past one 64-plane chunk; n
# not a multiple of the rows a vector holds; every row trashed
K7_WARP_MAX_CAP = max(c for c in range(33, 4096)
                      if sk.segment_sum_float_tier(c, 4).kind == "warp")
K7_CASES = [
    (1 << 22, 8, 7, 0.98, "thread"), (1 << 20, 16384, 4, 0.7, "block"),
    (1 << 21, 1 << 20, 3, 0.7, "global"), (1 << 18, 32, 70, 0.7, "thread"),
    (4099, 8, 3, 0.9, "thread"), (4099, 3000, 3, 0.9, "block"),
    (4099, 1 << 20, 2, 0.9, "global"), (4096, 8, 3, 0.0, "thread"),
    (4096, 16384, 2, 0.0, "block"), (4096, 1 << 20, 2, 0.0, "global"), (1, 8, 1, 1.0, "thread"),
    (1 << 20, 32, 4, 0.7, "thread"), (1 << 20, 33, 4, 0.7, "warp"),
    (1 << 20, 64, 4, 0.98, "warp"), (1 << 20, K7_WARP_MAX_CAP, 4, 0.7, "warp"),
    (1 << 20, K7_WARP_MAX_CAP + 1, 4, 0.7, "block"), (1 << 20, 29056, 1, 0.7, "block"),
    (1 << 20, 29057, 1, 0.7, "global"), (1 << 20, 1 << 20, 1, 0.7, "global"),
    (4099, 33, 3, 0.9, "warp"), (4099, K7_WARP_MAX_CAP, 4, 0.9, "warp"),
    (4099, 16384, 2, 0.9, "block"), (4099, 29057, 1, 0.9, "global"),
    (4096, 33, 3, 0.0, "warp"), (4096, 29056, 1, 0.0, "block"),
    (1 << 18, 33, 70, 0.7, "block"), (1 << 18, 1 << 20, 70, 0.7, "global"),
    # the join TopN's caps: TPC-H q3's 2^21 and the kernels' ceiling 2^22
    (1 << 22, 1 << 21, 1, 0.7, "global"), (1 << 22, 1 << 22, 2, 0.7, "global"),
]


def _f64_order_bound(planes, codes, cap):
    """The worst case of f64 summation in any order, per entry: each of a
    segment's n_seg additions rounds by at most 2^-53 of a partial sum, and
    no partial sum exceeds the sum of |v|."""
    inside = (codes >= 0) & (codes < cap)
    idx = torch.where(inside, codes, cap).long()
    stack = torch.stack([t.double() for t in planes], dim=1)
    mags = torch.zeros((cap + 1, stack.shape[1]), dtype=torch.float64, device=codes.device)
    mags.index_add_(0, idx, stack.abs())
    n_seg = torch.bincount(idx, minlength=cap + 1).double()[:, None]
    return (n_seg * 2.0 ** -53 * mags)[:cap]


def _k7_holds(planes, codes, cap):
    """K7 on ``planes`` within twice the f64 order bound of its plain
    version; returns the kernel's table."""
    got = sk.segment_sum_float_planes(planes, codes, cap)
    want = sk.segment_sum_float_planes_plain(planes, codes, cap)
    assert bool(((got - want).abs() <= 2 * _f64_order_bound(planes, codes, cap)).all())
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n,cap,p,keep,tier", K7_CASES)
def test_segment_sum_float_planes_tiers_match_plain(cuda, dtype, n, cap, p, keep, tier):
    assert sk.segment_sum_float_tier(cap, min(p, sk.PLANE_CHUNK)).kind == tier
    rng = np.random.default_rng(n + cap + p)
    codes = _kept_codes(rng, n, cap, keep)
    tc = torch.from_numpy(codes).to(cuda)
    # integer-valued planes: exact in f64 in any order, so bit for bit
    ints = torch.from_numpy(rng.integers(-50, 50, (p, n)).astype(np.float64)).to(dtype).to(cuda)
    before = counters.snapshot()["launches_segment_sum_float_planes"]
    got = sk.segment_sum_float_planes(list(ints), tc, cap)
    torch.cuda.synchronize()
    chunks = -(-p // sk.PLANE_CHUNK)
    assert counters.snapshot()["launches_segment_sum_float_planes"] == before + chunks
    assert got.dtype == torch.float64 and got.shape == (cap, p)
    assert torch.equal(got, sk.segment_sum_float_planes_plain(list(ints), tc, cap))
    if keep == 0:
        assert not got.any()
    # fractional planes of both signs, within the f64 order bound; the
    # thread and warp tiers add in a fixed order: two runs agree bit for bit
    fr = list(torch.from_numpy(rng.normal(0.0, 100.0, (p, n))).to(dtype).to(cuda))
    got = _k7_holds(fr, tc, cap)
    if tier in ("thread", "warp"):
        assert torch.equal(got, sk.segment_sum_float_planes(fr, tc, cap))
    # views one row in: off their 16-byte alignment, the single-row path
    if n > 1:
        _k7_holds([t[1:] for t in fr], tc[1:], cap)


@pytest.mark.parametrize("cap,p,kind", [(5, 1, "thread"), (64, 4, "warp"), (16384, 4, "block"),
                                        (1 << 18, 1, "global")])
def test_segment_sum_float_planes_refused_launch_raises(cuda, monkeypatch, cap, p, kind):
    """A launch the library refuses (a nonzero CUDA error) raises and is
    not counted, in every tier: nothing falls back."""
    assert sk.segment_sum_float_tier(cap, p).kind == kind
    planes = [torch.ones(64, device=cuda) for _ in range(p)]
    codes = torch.zeros(64, dtype=torch.int32, device=cuda)

    class Refusing:
        @staticmethod
        def daft_segment_sum_float_planes_blocks(*args):
            args[-1]._obj.value = 4
            return 0

        @staticmethod
        def daft_segment_sum_float_planes(*args):
            return 1  # cudaErrorInvalidValue

    monkeypatch.setattr(sk, "_library", Refusing)
    monkeypatch.setattr(sk, "_float_plans", {})
    before = counters.snapshot()
    with pytest.raises(RuntimeError, match="launch failed"):
        sk.segment_sum_float_planes(planes, codes, cap)
    after = counters.snapshot()
    assert after["launches_segment_sum_float_planes"] == \
        before["launches_segment_sum_float_planes"]
    assert after["plain_segment_sum_float_planes"] == before["plain_segment_sum_float_planes"]


def _float_frame(n, groups, seed):
    import daft_tpu_torch as dt

    rng = np.random.default_rng(seed)
    x = np.round(rng.uniform(-100, 100, n), 2)
    x[:6] = [0.0, -0.0, np.nan, -0.0, 0.0, np.nan]
    return dt.from_pydict({
        "k": np.concatenate([np.arange(6) % 3, rng.integers(0, groups, n - 6)]),
        "x": x, "y": rng.uniform(0, 1, n).astype(np.float32),
        "f": rng.random(n) < 0.4,
    })


@pytest.mark.parametrize("groups", [6, 150_000])
def test_float_grouped_query_on_card_matches_host(cuda, groups):
    import daft_tpu_torch as dt
    from daft_tpu_torch import col

    df = _float_frame(400_000, groups, seed=groups)

    def sums():
        return (df.groupby("k").agg(col("x").sum().alias("sx"), col("y").mean().alias("my"),
                                    col("f").sum().alias("nf"), col("x").count().alias("n"))
                .sort("k").to_pydict())

    def extremes():
        return (df.groupby("k").agg(col("x").min().alias("lo"), col("x").max().alias("hi"),
                                    col("y").sum().alias("sy"))
                .sort("k").to_pydict())

    for query, floats, kernels in ((sums, ("sx", "my"), ("segment_sum_float_planes",)),
                                   (extremes, ("sy",), ("segment_sum_float_planes",
                                                        "segment_extreme_int64"))):
        counters.reset()
        with dt.execution_config_ctx(device="cuda", device_mode="on"):
            got = query()
        snap = counters.snapshot()
        assert all(snap[f"launches_{k}"] > 0 for k in kernels), snap
        assert snap["device_fallbacks"] == 0
        with dt.execution_config_ctx(device_mode="off"):
            want = query()
        for c in got:
            if c in floats:
                # the stage computes in f32 (F3): each value of |x| <= 100 is
                # off by up to 2^-24 x 100 before the f64 sum, so a group
                # whose few values cancel to near 0 is held absolutely
                np.testing.assert_allclose(got[c], want[c], rtol=1e-5, atol=1e-4)
            elif c in ("lo", "hi"):
                assert [np.float64(v).tobytes() for v in got[c]] == \
                       [np.float64(v).tobytes() for v in want[c]], c
            else:
                assert got[c] == want[c], c


def test_ungrouped_query_on_card_matches_host(cuda):
    import daft_tpu_torch as dt
    from daft_tpu_torch import col

    df = _float_frame(300_000, 10, seed=3)

    def query():
        return (df.where(col("y") < 0.5)
                .agg((col("x") * col("y")).sum().alias("s"), col("x").min().alias("lo"),
                     col("x").max().alias("hi"), col("f").sum().alias("nf"),
                     col("x").count().alias("n"))
                .to_pydict())

    counters.reset()
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        got = query()
    assert counters.snapshot()["device_stage_batches"] == 1
    with dt.execution_config_ctx(device_mode="off"):
        want = query()
    np.testing.assert_allclose(got["s"], want["s"], rtol=1e-9)
    assert [np.float64(v).tobytes() for v in got["lo"] + got["hi"]] == \
           [np.float64(v).tobytes() for v in want["lo"] + want["hi"]]
    assert got["nf"] == want["nf"] and got["n"] == want["n"]


def _tails_tables(seed=3):
    """A small star: 20,000 fact rows on 3,000 orders-like dim rows (one
    group per dim row) and a 40-row chained dim."""
    rng = np.random.default_rng(seed)
    n = 20_000
    fact = daft_tpu_torch.from_pydict({
        "f_k": rng.integers(1, 3001, n), "f_v": np.round(rng.uniform(1, 1000, n), 2),
        "f_d": np.round(rng.uniform(0, 0.1, n), 2), "f_q": rng.integers(1, 51, n)})
    dim = daft_tpu_torch.from_pydict({
        "d_k": np.arange(1, 3001), "d_c": rng.integers(0, 40, 3000),
        "d_date": rng.integers(8000, 9000, 3000).astype("datetime64[D]")})
    chained = daft_tpu_torch.from_pydict({
        "c_k": np.arange(40), "c_seg": np.array(["A", "B", "C", "D"], dtype=object)[
            np.arange(40) % 4]})
    return fact, dim, chained


def test_join_topn_on_card_matches_host(cuda):
    """q3's shape on the card: a chained dim filter, groups by a dim key and
    date, the top 10 by a float sum: one TopN run, K4 and K1, K2, K7
    launched, equal to the host path (floats at rtol 1e-5)."""
    col = daft_tpu_torch.col
    fact, dim, chained = _tails_tables()

    def q():
        return (chained.where(col("c_seg") == "B")
                .join(dim, left_on="c_k", right_on="d_c")
                .join(fact, left_on="d_k", right_on="f_k")
                .groupby("d_k", "d_date")
                .agg((col("f_v") * (1 - col("f_d"))).sum().alias("rev"))
                .sort(["rev", "d_date"], desc=[True, False]).limit(10))

    with daft_tpu_torch.execution_config_ctx(device_mode="off"):
        want = q().to_pydict()
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cuda"):
        got = q().to_pydict()
    snap = counters.snapshot()
    assert snap["device_topn_runs"] == 1 and snap["device_fallbacks"] == 0
    for k in ("hash_probe_build", "hash_probe_index", "segment_sum_planes",
              "segment_extreme_planes", "segment_sum_float_planes"):
        assert snap[f"launches_{k}"] >= 1, k
    assert got["d_k"] == want["d_k"] and got["d_date"] == want["d_date"]
    np.testing.assert_allclose(got["rev"], want["rev"], rtol=1e-5)


def test_ungrouped_join_on_card_matches_host(cuda):
    """q14's shape on the card: startswith hoisted to the dim, an ungrouped
    sum over the join; K4 launched, equal to the host path."""
    col, lit = daft_tpu_torch.col, daft_tpu_torch.lit
    fact, dim, chained = _tails_tables()

    def q():
        return (fact.join(dim, left_on="f_k", right_on="d_k")
                .join(chained, left_on="d_c", right_on="c_k")
                .with_column("promo", col("c_seg").str.startswith("B")
                             .if_else(col("f_v"), lit(0.0)))
                .agg(col("promo").sum().alias("p"), col("f_q").sum().alias("q")))

    with daft_tpu_torch.execution_config_ctx(device_mode="off"):
        want = q().to_pydict()
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cuda"):
        got = q().to_pydict()
    snap = counters.snapshot()
    assert snap["device_join_batches"] == 1 and snap["device_fallbacks"] == 0
    assert snap["launches_hash_probe_build"] == 1 and snap["launches_hash_probe_index"] == 1
    assert got["q"] == want["q"]
    np.testing.assert_allclose(got["p"], want["p"], rtol=1e-5)


@pytest.mark.parametrize("desc", [True, False])
@pytest.mark.parametrize("nulls_first", [True, False])
def test_join_topn_order_on_card_matches_host(cuda, desc, nulls_first):
    """The join TopN's order on the card (P2, P3): negative int64 sums, sums
    past 2^53 that tie in f64, and float sums with +inf, NaN and a null
    group, each one TopN run giving the host's rows."""
    col = daft_tpu_torch.col
    rng = np.random.default_rng(2)
    fk = rng.integers(0, 50, 4000)
    v = rng.integers(-1000, 1000, 4000)
    v[fk == 7] = -100_000
    wide_fk = np.arange(4000) % 50
    floats = rng.uniform(-50, 50, 600)
    floats[3], floats[17] = np.inf, np.nan  # groups 3 and 5 of 12
    cases = [({"fk": fk, "v": v}, 50, False),
             ({"fk": wide_fk, "v": (1 << 55) + (wide_fk * 7919) % 97 - 48}, 50, False),
             ({"fk": np.arange(600) % 12,
               "v": [None if k == 8 else x for k, x in zip((np.arange(600) % 12).tolist(),
                                                          floats.tolist())]}, 12, True)]
    for fact, groups, is_float in cases:
        f = daft_tpu_torch.from_pydict(fact)
        d = daft_tpu_torch.from_pydict({"k": np.arange(groups)})

        def q():
            return (f.join(d, left_on="fk", right_on="k").groupby("k")
                    .agg(col("v").sum().alias("s"))
                    .sort("s", desc=desc, nulls_first=nulls_first).limit(12))

        with daft_tpu_torch.execution_config_ctx(device_mode="off"):
            want = q().to_pydict()
        counters.reset()
        with daft_tpu_torch.execution_config_ctx(device="cuda"):
            got = q().to_pydict()
        assert counters.snapshot()["device_topn_runs"] == 1
        assert got["k"] == want["k"]
        if is_float:
            np.testing.assert_allclose([np.nan if x is None else x for x in got["s"]],
                                       [np.nan if x is None else x for x in want["s"]],
                                       rtol=1e-5)
        else:
            assert got["s"] == want["s"]


def test_fused_region_on_card_matches_host(cuda):
    """A Project, a Filter and a Project under a grouped aggregate fuse into
    one device stage over the scan on the card: one region dispatch of 4
    ops, equal to region_mode="off" and to the host path."""
    col = daft_tpu_torch.col
    rng = np.random.default_rng(4)
    n = 50_000
    df = daft_tpu_torch.from_pydict({"k": rng.integers(0, 300, n),
                                     "v": rng.integers(-1000, 1000, n),
                                     "x": rng.uniform(0, 10, n)})

    def q():
        return (df.with_column("w", col("v") * 3 + 1).where(col("w") > -1500)
                .with_column("y", col("x") * col("w"))
                .groupby("k").agg(col("w").sum().alias("s"), col("y").sum().alias("t"),
                                  col("v").min().alias("lo"))
                .sort("k"))

    with daft_tpu_torch.execution_config_ctx(device_mode="off"):
        want = q().to_pydict()
    with daft_tpu_torch.execution_config_ctx(device="cuda", region_mode="off"):
        unfused = q().to_pydict()
    counters.reset()
    with daft_tpu_torch.execution_config_ctx(device="cuda"):
        got = q().to_pydict()
    snap = counters.snapshot()
    assert snap["device_region_dispatches"] == 1 and snap["device_region_ops_fused"] == 4
    assert snap["launches_segment_sum_planes"] >= 1
    for other in (want, unfused):
        assert got["k"] == other["k"] and got["s"] == other["s"] and got["lo"] == other["lo"]
        np.testing.assert_allclose(got["t"], other["t"], rtol=1e-5)
