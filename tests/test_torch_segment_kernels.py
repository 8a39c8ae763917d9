"""The port's segment kernels K1-K3 and K1a (daft_tpu_torch/ops/segment_kernels.py)
on CPU tensors, where each wrapper runs its plain PyTorch version, against
the reference's Pallas kernels (daft_tpu/ops/pallas_kernels.py) in interpret
mode on the same numpy inputs. K1 and K2 take a list of planes, the
reference its (N, P) stack of the same planes. Every comparison is bit for
bit where the planes are integer-valued (exact in f32 per 32K-row window and
in f64 across windows; K1a in one f32 window below 2^24), and extremes do
not depend on order. K1a over normal (non-integer) planes keeps the
reference's own tolerance, atol 1e-3 (tests/test_pallas.py), since f32 sums
in another order differ in the last bits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from daft_tpu.ops import pallas_kernels as pk
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import segment_kernels as sk

I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def _codes(rng, n, cap):
    # negative and trash (>= cap) codes must be dropped
    return rng.integers(-3, cap + 3, n).astype(np.int32)


def _columns(planes: np.ndarray):
    """The columns of an (N, P) array as a list of P contiguous tensors."""
    return [torch.from_numpy(np.ascontiguousarray(planes[:, j]))
            for j in range(planes.shape[1])]


@pytest.mark.parametrize("n,cap,p", [(65536, 256, 5), (4096, 8, 1), (2048, 2048, 3),
                                     (8192, 16384, 15), (4096, 64, 73)])
def test_segment_sum_planes_matches_pallas(n, cap, p):
    rng = np.random.default_rng(n + cap + p)
    planes = rng.integers(0, 256, (n, p)).astype(np.float32)
    planes[rng.random((n, p)) < 0.25] = 0.0
    codes = _codes(rng, n, cap)
    want = np.asarray(pk.segment_sum_planes_windowed(
        jnp.asarray(planes), jnp.asarray(codes), cap, interpret=True))
    before = counters.snapshot()
    got = sk.segment_sum_planes(_columns(planes), torch.from_numpy(codes), cap)
    after = counters.snapshot()
    assert got.dtype == torch.float64 and tuple(got.shape) == (cap, p)
    np.testing.assert_array_equal(got.numpy(), want)
    # a CPU tensor takes the plain version: counted as such, never as a launch
    assert after["plain_segment_sum_planes"] == before["plain_segment_sum_planes"] + 1
    assert after["launches_segment_sum_planes"] == before["launches_segment_sum_planes"]


@pytest.mark.parametrize("op", ["sum", "min", "max"])
def test_planes_as_rows_of_a_p_by_n_tensor(op):
    # the rows of one (P, N) tensor are contiguous planes: no stack needed
    rng = np.random.default_rng(11)
    n, cap, p = 4096, 96, 6
    rows = rng.integers(0, 256, (p, n)).astype(np.float32)
    codes = _codes(rng, n, cap)
    codes[:3] = [-1, cap, cap + 100]
    t = torch.from_numpy(rows)
    if op == "sum":
        want = np.asarray(pk.segment_sum_planes_windowed(
            jnp.asarray(rows.T.copy()), jnp.asarray(codes), cap, interpret=True))
        got = sk.segment_sum_planes(list(t), torch.from_numpy(codes), cap)
    else:
        want = np.asarray(pk.segment_extreme_planes(
            jnp.asarray(rows.T.copy()), jnp.asarray(codes), cap, op, interpret=True))
        got = sk.segment_extreme_planes(list(t.unbind(0)), torch.from_numpy(codes), cap, op)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_sum_planes_two_windows_exceed_f32_window():
    # one segment collects 65536 rows of 255: 16.7M per plane, past a single
    # f32 window's exact range only if windows were not combined in f64
    n, cap = 65536, 256
    planes = np.full((n, 2), 255.0, dtype=np.float32)
    codes = np.zeros(n, dtype=np.int32)
    want = np.asarray(pk.segment_sum_planes_windowed(
        jnp.asarray(planes), jnp.asarray(codes), cap, interpret=True))
    got = sk.segment_sum_planes(_columns(planes), torch.from_numpy(codes), cap)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0].item() == 255.0 * n


@pytest.mark.parametrize("n,cap,p", [(8192, 16, 6), (65536, 256, 5), (2048, 2048, 3)])
def test_segment_sum_planes_f32_matches_pallas_on_integer_planes(n, cap, p):
    rng = np.random.default_rng(n + p)
    planes = rng.integers(0, 256, (n, p)).astype(np.float32)
    planes[rng.random((n, p)) < 0.25] = 0.0
    codes = _codes(rng, n, cap)
    want = np.asarray(pk.segment_sum_planes(jnp.asarray(planes), jnp.asarray(codes), cap,
                                            interpret=True))
    before = counters.snapshot()
    got = sk.segment_sum_planes_f32(torch.from_numpy(planes), torch.from_numpy(codes), cap)
    after = counters.snapshot()
    assert got.dtype == torch.float32 and tuple(got.shape) == (cap, p)
    np.testing.assert_array_equal(got.numpy(), want)
    # K1's f64 output over the same planes, cast to f32
    np.testing.assert_array_equal(
        sk.segment_sum_planes(_columns(planes), torch.from_numpy(codes),
                              cap).float().numpy(), want)
    assert after["plain_segment_sum_planes_f32"] == before["plain_segment_sum_planes_f32"] + 1
    assert after["launches_segment_sum_planes_f32"] == before["launches_segment_sum_planes_f32"]


def test_segment_sum_planes_f32_matches_pallas_on_normal_planes():
    rng = np.random.default_rng(0)
    n, p, cap = 8192, 6, 16
    planes = rng.standard_normal((n, p)).astype(np.float32)
    codes = rng.integers(0, cap + 1, n).astype(np.int32)  # cap = trash (dropped)
    want = np.asarray(pk.segment_sum_planes(jnp.asarray(planes), jnp.asarray(codes), cap,
                                            interpret=True))
    got = sk.segment_sum_planes_f32(torch.from_numpy(planes), torch.from_numpy(codes), cap)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_segment_sum_planes_f32_single_block_and_empty_segments():
    planes = np.ones((1024, 2), np.float32)
    codes = np.zeros(1024, np.int32)
    want = np.asarray(pk.segment_sum_planes(jnp.asarray(planes), jnp.asarray(codes), 8,
                                            interpret=True))
    got = sk.segment_sum_planes_f32(torch.from_numpy(planes), torch.from_numpy(codes), 8)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, 0].item() == 1024.0 and (got[1:] == 0).all()


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("n,cap,q", [(8192, 256, 2), (2048, 16, 1), (4096, 64, 15),
                                     (2048, 32, 73)])
def test_segment_extreme_planes_matches_pallas(op, n, cap, q):
    rng = np.random.default_rng(cap + q)
    ident = np.inf if op == "min" else -np.inf
    planes = (rng.standard_normal((n, q)) * 1e6).astype(np.float32)
    planes[rng.random((n, q)) < 0.3] = ident
    # the opposite infinity is a real value, and must win or lose by order
    planes[:4, 0] = [np.inf, -np.inf, -1.5, 3.0]
    codes = _codes(rng, n, cap)
    codes[:4] = [0, 0, 1, 1]
    want = np.asarray(pk.segment_extreme_planes(
        jnp.asarray(planes), jnp.asarray(codes), cap, op, interpret=True))
    got = sk.segment_extreme_planes(_columns(planes), torch.from_numpy(codes), cap, op)
    assert got.dtype == torch.float32 and tuple(got.shape) == (cap, q)
    np.testing.assert_array_equal(got.numpy(), want)


def test_segment_extreme_planes_empty_segments_keep_identity():
    n, cap = 1024, 32
    codes = np.full(n, 5, dtype=np.int32)
    planes = np.arange(n, dtype=np.float32)[:, None]
    for op, ident in (("min", np.inf), ("max", -np.inf)):
        want = np.asarray(pk.segment_extreme_planes(
            jnp.asarray(planes), jnp.asarray(codes), cap, op, interpret=True))
        got = sk.segment_extreme_planes(_columns(planes),
                                        torch.from_numpy(codes), cap, op).numpy()
        np.testing.assert_array_equal(got, want)
        assert np.all(got[np.arange(cap) != 5] == ident)


@pytest.mark.parametrize("op", ["min", "max"])
@pytest.mark.parametrize("n,cap,keep", [
    (8192, 64, 0.6),
    (1 << 15, 8, 0.98),  # heavy contention: every kept row on 8 segments
])
def test_segment_extreme_int64_matches_pallas(op, n, cap, keep):
    rng = np.random.default_rng(7)
    vals = rng.integers(I64_MIN, I64_MAX, n, dtype=np.int64, endpoint=True)
    special = [I64_MIN, I64_MAX, 2**53 + 1, -(2**53) - 1, 2**53, 0, -1, 2**62 + 7, -5]
    vals[:len(special)] = special
    mask = rng.random(n) < keep
    codes = _codes(rng, n, cap)
    codes[:len(special)] = np.arange(len(special)) % cap
    mask[:len(special)] = True
    if cap > 50:
        codes[codes == 40] = 41          # segment 40: empty
        mask[codes == 50] = False        # segment 50: every row masked out
    want_v, want_ne = pk.segment_extreme_int64(
        jnp.asarray(vals), jnp.asarray(mask), jnp.asarray(codes), cap, op,
        interpret=True)
    got_v, got_ne = sk.segment_extreme_int64(
        torch.from_numpy(vals), torch.from_numpy(mask), torch.from_numpy(codes), cap, op)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_ne.numpy(), np.asarray(want_ne))
    ident = I64_MAX if op == "min" else I64_MIN
    if cap > 50:
        assert not got_ne[40] and not got_ne[50]
        assert got_v[40].item() == ident and got_v[50].item() == ident
    # each special value sits in its segment's first rows: it must be the
    # extreme exactly when it beats the rest of that segment
    for seg in range(min(cap, len(special))):
        rows = (codes == seg) & mask
        expect = vals[rows].min() if op == "min" else vals[rows].max()
        assert got_v[seg].item() == int(expect)


@pytest.mark.parametrize("cap,tier", [
    (1, (1, 32, True)), (8, (1, 32, True)), (16, (1, 32, True)), (17, (1, 32, False)),
    (100, (1, 128, False)), (16384, (1, 16384, False)), (24576, (1, 24576, False)),
    (24577, (2, 16384, False)), (32768, (2, 16384, False)), (40000, (4, 16384, False)),
    (65537, (8, 16384, False)), (1 << 17, (8, 16384, False)),
])
def test_segment_extreme_int64_tier(cap, tier):
    got = sk.segment_extreme_int64_tier(cap)
    assert tuple(got) == tier
    # the table covers the caps, in whole bitmap words, within a block's 227 KB
    # of shared memory; a cluster's blocks split it on a power of two
    assert got.cluster * got.slice >= cap and got.slice % 32 == 0
    assert got.slice * 8 + got.slice // 32 * 4 <= 232448
    assert got.cluster in (1, 2, 4, 8)
    if got.cluster > 1:
        assert got.slice & (got.slice - 1) == 0 and not got.warp_agg
    for bad in (0, -1, sk.KERNEL_MAX_SEGMENTS + 1):
        with pytest.raises(ValueError):
            sk.segment_extreme_int64_tier(bad)


def test_wrappers_validate_inputs():
    planes = torch.zeros((16, 2), dtype=torch.float32)
    cols = [torch.zeros(16), torch.zeros(16)]
    codes = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(TypeError):
        sk.segment_sum_planes([c.double() for c in cols], codes, 4)
    with pytest.raises(TypeError):
        sk.segment_sum_planes(cols, codes.long(), 4)
    with pytest.raises(ValueError):
        sk.segment_sum_planes(cols, codes[:8], 4)
    with pytest.raises(TypeError):
        sk.segment_sum_planes_f32(planes.double(), codes, 4)
    with pytest.raises(ValueError):
        sk.segment_sum_planes_f32(planes, codes[:8], 4)
    with pytest.raises(ValueError):
        sk.segment_extreme_planes([planes[:, 0]], codes, 4, "min")  # stride 2
    with pytest.raises(ValueError):
        sk.segment_extreme_planes(cols, codes, 4, "median")
    with pytest.raises(TypeError):
        sk.segment_extreme_int64(torch.zeros(16, dtype=torch.int32),
                                 torch.ones(16, dtype=torch.bool), codes, 4, "min")


@pytest.mark.parametrize("fn", ["sum", "min"])
def test_plane_wrappers_refuse_what_the_kernels_do_not_take(fn):
    codes = torch.zeros(16, dtype=torch.int32)
    good = torch.zeros(16)

    def call(planes, c=codes):
        if fn == "sum":
            return sk.segment_sum_planes(planes, c, 4)
        return sk.segment_extreme_planes(planes, c, 4, "min")

    call([good, good])  # the accepted form
    with pytest.raises(ValueError):   # a broadcast: stride 0
        call([good, torch.zeros(1).expand(16)])
    with pytest.raises(ValueError):   # a strided view
        call([torch.zeros(32)[::2]])
    with pytest.raises(ValueError):   # planes of unequal length
        call([good, torch.zeros(15)])
    with pytest.raises(ValueError):   # a 2-D plane
        call([torch.zeros(16, 1)])
    with pytest.raises(ValueError):   # planes on two devices
        call([good, torch.zeros(16, device="meta")])
    with pytest.raises(ValueError):   # no planes
        call([])
    with pytest.raises(TypeError):    # one stacked tensor, not a list of planes
        call(torch.zeros(2, 16))
    if fn == "sum":
        # K1's contract: fewer than 2^24 rows
        big = torch.zeros(sk.MAX_KERNEL_BUCKET, dtype=torch.int32)
        with pytest.raises(ValueError):
            call([torch.zeros(sk.MAX_KERNEL_BUCKET)], big)


@pytest.mark.parametrize("cap,nplanes,tier", [
    (8, 5, ("block", 5)), (16, 64, ("block", 64)), (17, 15, ("block", 15)),
    (4096, 73 - 64, ("block", 9)), (4096, 64, ("block", 14)),
    (16384, 15, ("block", 3)), (16384, 1, ("block", 1)), (32768, 15, ("block", 1)),
    (58112, 2, ("block", 1)), (58113, 2, ("global", 2)), (65536, 15, ("global", 15)),
    (1 << 17, 64, ("global", 64)),
])
def test_segment_planes_tier(cap, nplanes, tier):
    got = sk.segment_planes_tier(cap, nplanes)
    assert tuple(got) == tier
    if got.kind == "global":
        # one table of every plane, in device memory: no block holds one plane
        assert got.group == nplanes and cap * 4 > sk.PLANE_SMEM_MAX
    else:
        # the most planes whose table fits a block's 227 KB of shared memory
        assert got.group * cap * 4 <= sk.PLANE_SMEM_MAX
        assert got.kind == "block"
        assert got.group == nplanes or (got.group + 1) * cap * 4 > sk.PLANE_SMEM_MAX
    for bad_cap, bad_planes in ((0, 1), (-1, 1), (sk.KERNEL_MAX_SEGMENTS + 1, 1),
                                (8, 0), (8, sk.PLANE_CHUNK + 1)):
        with pytest.raises(ValueError):
            sk.segment_planes_tier(bad_cap, bad_planes)


# K1a's tiers at the cap x P boundaries: the block tier's last table that
# fits beside the staged codes and vectors (45,816 entries), its copies, and
# the global tier past it
@pytest.mark.parametrize("cap,p,tier", [
    (8, 15, ("block", 32)), (1, 1, ("block", 32)),
    (279, 15, ("block", 4)), (280, 15, ("block", 3)),
    (558, 15, ("block", 2)), (559, 15, ("block", 1)),
    (3054, 15, ("block", 1)), (3055, 15, ("global", 1)),
    (45816, 1, ("block", 1)), (45817, 1, ("global", 1)),
    (16384, 15, ("global", 1)), (1 << 17, 15, ("global", 1)), (1 << 17, 1, ("global", 1)),
])
def test_segment_sum_f32_tier(cap, p, tier):
    got = sk.segment_sum_f32_tier(cap, p)
    assert tuple(got) == tier
    table = cap * p * 4
    if got.kind == "block":
        # the whole table, in as many copies as two blocks an SM leave room
        # for (one at least, one a warp at most)
        assert table <= sk.F32_TABLE_BYTES
        assert got.copies == 1 or got.copies * table <= sk.F32_COPIES_BYTES
        assert got.copies == sk.F32_MAX_COPIES or (got.copies + 1) * table > sk.F32_COPIES_BYTES
    else:
        assert table > sk.F32_TABLE_BYTES and got.copies == 1
    for bad_cap, bad_p in ((0, 1), (-1, 1), (8, 0)):
        with pytest.raises(ValueError):
            sk.segment_sum_f32_tier(bad_cap, bad_p)
