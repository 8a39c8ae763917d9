"""The hash-probe kernels K4 and K5 (daft_tpu_torch/ops/probe_kernels.py) on the
CPU, where their wrappers run the plain PyTorch versions. K5's sums and
counts equal the reference's ``hash_probe_segment_sum`` in Pallas interpret
mode exactly (integer-valued planes). K4 is held bit for bit against:

- the reference's ``hash_probe_index`` in Pallas interpret mode, fed with
  its own ``build_probe_table`` and ``probe_key_digits``;
- the reference's ``unique_key_index`` (and the port's numpy copy of it);
- a Python dict.

Keys past 2^53, keys near -2^62, the keys at the empty-slot encoding's
edges (0, -1, int64 max), nulls on both sides, misses and an empty dim are
covered, and so are the table's refusals (duplicate keys, a key equal to
the empty-slot marker) and its layout: one (S, 2) int64 tensor of 16-byte
slots, ``[key ^ int64 min, row]``, zero where empty. The CUDA kernels
themselves are held against the plain versions by the ``cuda``-marked tests
of tests/test_torch_cuda_kernels.py, which skip without a card.
"""

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from daft_tpu.core.series import Series as RefSeries
from daft_tpu.datatype import DataType as RefDataType
from daft_tpu.ops import pallas_kernels as ref_pk
from daft_tpu.ops.device_join import unique_key_index as ref_unique_key_index
from daft_tpu_torch.core.series import Series
from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.ops import counters
from daft_tpu_torch.ops import probe_kernels as pk
from daft_tpu_torch.ops.device_join import unique_key_index

BIG = (1 << 53) + 11          # past f64's exact-integer range
N_FACT = 4096


def _case(seed: int, n_dim: int = 300):
    """Dim keys (small, past 2^53, near -2^62) with nulls; fact keys drawn
    from them with misses and nulls."""
    rng = np.random.default_rng(seed)
    third = n_dim // 3
    dim_keys = np.concatenate([
        rng.choice(10_000, n_dim - 2 * third, replace=False).astype(np.int64),
        BIG + rng.choice(1_000_000, third, replace=False).astype(np.int64),
        -(1 << 62) - np.arange(third, dtype=np.int64),
    ])
    rng.shuffle(dim_keys)
    dim_valid = rng.random(n_dim) > 0.05
    fact_keys = dim_keys[rng.integers(0, n_dim, N_FACT)].copy()
    fact_keys[::7] += 1_000_003            # misses
    fact_valid = rng.random(N_FACT) > 0.1  # null fact keys
    return dim_keys, dim_valid, fact_keys, fact_valid


def _dict_probe(fact_keys, fact_valid, dim_keys, dim_valid):
    lut = {int(k): i for i, (k, v) in enumerate(zip(dim_keys, dim_valid)) if v}
    return np.array([lut.get(int(k), -1) if v else -1
                     for k, v in zip(fact_keys, fact_valid)], dtype=np.int32)


def _port_probe(fact_keys, fact_valid, dim_keys, dim_valid):
    """Table build + probe through the wrappers (CPU: the plain versions)."""
    slots = pk.probe_table_slots(len(dim_keys))
    table = pk.build_probe_table(torch.from_numpy(dim_keys), torch.from_numpy(dim_valid),
                                 slots)
    return pk.hash_probe_index(torch.from_numpy(fact_keys), torch.from_numpy(fact_valid),
                               table).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_probe_matches_reference_pallas_kernel(seed):
    dim_keys, dim_valid, fact_keys, fact_valid = _case(seed)
    tbl = ref_pk.build_probe_table(dim_keys, dim_valid)
    assert tbl[0].shape[1] <= 512
    fh, fl = ref_pk.probe_key_digits(jnp.asarray(fact_keys), jnp.asarray(fact_valid))
    want = np.asarray(ref_pk.hash_probe_index(
        fh, fl, jnp.asarray(tbl[0]), jnp.asarray(tbl[1]), jnp.asarray(tbl[2]),
        interpret=True))
    got = _port_probe(fact_keys, fact_valid, dim_keys, dim_valid)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _dict_probe(fact_keys, fact_valid, dim_keys,
                                                   dim_valid))


@pytest.mark.parametrize("seed", [3, 4])
def test_probe_matches_unique_key_index(seed):
    dim_keys, dim_valid, fact_keys, fact_valid = _case(seed, n_dim=3000)
    ref_series = RefSeries.from_arrow(pa.array(dim_keys, pa.int64(), mask=~dim_valid),
                                      "k")
    want = ref_unique_key_index(ref_series, fact_keys, fact_valid, RefDataType.int64())
    port_series = Series.from_numpy(dim_keys, "k", validity=dim_valid)
    np.testing.assert_array_equal(
        unique_key_index(port_series, fact_keys, fact_valid, DataType.int64()), want)
    np.testing.assert_array_equal(_port_probe(fact_keys, fact_valid, dim_keys, dim_valid),
                                  want)


def test_probe_small_dense_domain_matches_unique_key_index():
    """unique_key_index's dense-table branch (a small key domain)."""
    rng = np.random.default_rng(5)
    dim_keys = rng.permutation(np.arange(-50, 250, dtype=np.int64))
    dim_valid = rng.random(300) > 0.1
    fact_keys = rng.integers(-80, 300, N_FACT).astype(np.int64)
    fact_valid = rng.random(N_FACT) > 0.1
    port_series = Series.from_numpy(dim_keys, "k", validity=dim_valid)
    want = _dict_probe(fact_keys, fact_valid, dim_keys, dim_valid)
    np.testing.assert_array_equal(
        unique_key_index(port_series, fact_keys, fact_valid, DataType.int64()), want)
    np.testing.assert_array_equal(_port_probe(fact_keys, fact_valid, dim_keys, dim_valid),
                                  want)


def test_empty_dim_and_all_null_dim_match_nothing():
    rng = np.random.default_rng(6)
    fact_keys = rng.integers(-5, 5, N_FACT).astype(np.int64)
    fact_valid = np.ones(N_FACT, dtype=bool)
    for dim_keys, dim_valid in ((np.empty(0, np.int64), np.empty(0, bool)),
                                (np.arange(8, dtype=np.int64), np.zeros(8, bool))):
        got = _port_probe(fact_keys, fact_valid, dim_keys, dim_valid)
        assert (got == -1).all()


def test_fact_key_equal_to_the_empty_marker_never_matches():
    dim_keys = np.array([1, 2, 3], dtype=np.int64)
    fact_keys = np.array([pk.EMPTY_KEY, 2, pk.EMPTY_KEY, 7], dtype=np.int64)
    got = _port_probe(fact_keys, np.ones(4, bool), dim_keys, np.ones(3, bool))
    np.testing.assert_array_equal(got, [-1, 1, -1, -1])


def test_table_refusals():
    assert pk.probe_key_refusal(np.array([3, 7, 3]), np.ones(3, bool)) \
        == "dim keys are not unique"
    assert "empty marker" in pk.probe_key_refusal(np.array([1, pk.EMPTY_KEY]),
                                                  np.ones(2, bool))
    # a duplicate or a marker hidden behind a null is fine: nulls never match
    assert pk.probe_key_refusal(np.array([3, 7, 3, pk.EMPTY_KEY]),
                                np.array([True, True, False, False])) is None
    # the reference refuses the same keys
    with pytest.raises(ValueError, match="not unique"):
        ref_pk.build_probe_table(np.array([3, 7, 3], dtype=np.int64))
    with pytest.raises(ValueError, match="sentinel"):
        ref_pk.build_probe_table(np.array([1, ref_pk.PROBE_SENTINEL], dtype=np.int64))
    assert ref_pk.PROBE_SENTINEL == pk.EMPTY_KEY


@pytest.mark.parametrize("seed", [7, 8])
def test_plain_build_places_every_key_on_its_probe_sequence(seed):
    """The plain build holds every valid (key, row) once, and the plain
    probe finds each dim key's own row (a null dim key finds nothing)."""
    dim_keys, dim_valid, _fk, _fv = _case(seed)
    slots = pk.probe_table_slots(len(dim_keys))
    assert slots >= 2 * len(dim_keys) and slots & (slots - 1) == 0
    table = pk.build_probe_table(torch.from_numpy(dim_keys), torch.from_numpy(dim_valid),
                                 slots)
    words = table.numpy()
    occupied = words[:, 0] != 0
    assert occupied.sum() == dim_valid.sum()
    assert sorted(zip((words[occupied, 0] ^ pk.EMPTY_KEY).tolist(),
                      words[occupied, 1].tolist())) \
        == sorted((int(k), i) for i, (k, v) in enumerate(zip(dim_keys, dim_valid)) if v)
    found = pk.hash_probe_index(torch.from_numpy(dim_keys),
                                torch.ones(len(dim_keys), dtype=torch.bool), table)
    np.testing.assert_array_equal(found.numpy(),
                                  np.where(dim_valid, np.arange(len(dim_keys)), -1))


@pytest.mark.parametrize("n_keys,slots", [(8, 8), (9, 16), (1, 1)])
def test_build_refuses_a_table_under_twice_the_keys(n_keys, slots):
    """A table that could fill would never let the kernels' probe loops
    end, so the wrapper refuses it before any launch."""
    keys = torch.arange(n_keys, dtype=torch.int64)
    counters.reset()
    with pytest.raises(ValueError, match="twice the keys"):
        pk.build_probe_table(keys, torch.ones(n_keys, dtype=torch.bool), slots)
    assert counters.snapshot()["plain_hash_probe_build"] == 0


def test_wrappers_count_plain_calls_and_validate():
    counters.reset()
    dim_keys, dim_valid, fact_keys, fact_valid = _case(10)
    _port_probe(fact_keys, fact_valid, dim_keys, dim_valid)
    snap = counters.snapshot()
    assert snap["plain_hash_probe_build"] == 1 and snap["plain_hash_probe_index"] == 1
    assert snap["launches_hash_probe_build"] == 0 and snap["launches_hash_probe_index"] == 0
    keys = torch.zeros(8, dtype=torch.int64)
    valid = torch.ones(8, dtype=torch.bool)
    with pytest.raises(TypeError):
        pk.build_probe_table(keys.int(), valid, 16)
    with pytest.raises(ValueError):
        pk.build_probe_table(keys, valid[:4], 16)
    with pytest.raises(ValueError):
        pk.build_probe_table(keys, valid, 12)
    table = pk.build_probe_table(keys[:1], valid[:1], 16)
    with pytest.raises(ValueError):
        pk.hash_probe_index(keys, valid, table[:12])
    with pytest.raises(TypeError):
        pk.hash_probe_index(keys, valid, table.int())
    with pytest.raises(ValueError):
        pk.hash_probe_index(keys, valid, table[:, 0].contiguous())


I64_MAX = (1 << 63) - 1


def test_keys_at_the_empty_encodings_edges_are_stored_and_found():
    """0, -1 and int64 max store as int64 min, int64 max and -1: none is the
    empty word 0, so each is placed and found. Held against the reference's
    interpret-mode kernel and unique_key_index."""
    dim_keys = np.array([7, 0, -1, I64_MAX, pk.EMPTY_KEY + 1, 1 << 62], dtype=np.int64)
    dim_valid = np.ones(len(dim_keys), dtype=bool)
    table = pk.build_probe_table(torch.from_numpy(dim_keys), torch.from_numpy(dim_valid),
                                 pk.probe_table_slots(len(dim_keys)))
    stored = table[:len(dim_keys), 0].tolist()
    assert stored[1:4] == [pk.EMPTY_KEY, I64_MAX, -1] and 0 not in stored
    keys, rows = pk.table_entries(table)
    assert keys.tolist() == sorted(dim_keys.tolist())
    assert rows.tolist() == np.argsort(dim_keys).tolist()
    fact_keys = np.concatenate([dim_keys, [1, -2, I64_MAX - 1, pk.EMPTY_KEY]]).astype(np.int64)
    fact_valid = np.ones(len(fact_keys), dtype=bool)
    got = _port_probe(fact_keys, fact_valid, dim_keys, dim_valid)
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 4, 5, -1, -1, -1, -1])
    tbl = ref_pk.build_probe_table(dim_keys, dim_valid)
    fh, fl = ref_pk.probe_key_digits(jnp.asarray(fact_keys), jnp.asarray(fact_valid))
    want = np.asarray(ref_pk.hash_probe_index(
        fh, fl, jnp.asarray(tbl[0]), jnp.asarray(tbl[1]), jnp.asarray(tbl[2]),
        interpret=True))
    np.testing.assert_array_equal(got, want)
    ref_series = RefSeries.from_arrow(pa.array(dim_keys, pa.int64()), "k")
    np.testing.assert_array_equal(
        got, ref_unique_key_index(ref_series, fact_keys, fact_valid, RefDataType.int64()))


def test_the_key_whose_stored_word_is_empty_is_still_refused():
    """int64 min XOR int64 min is 0, the empty slot: such a dim key is
    refused on the host, and a fact key equal to it never matches, even in
    a table whose empty slots it would equal."""
    assert "empty marker" in pk.probe_key_refusal(
        np.array([0, -1, I64_MAX, pk.EMPTY_KEY]), np.ones(4, bool))
    assert pk.probe_key_refusal(np.array([0, -1, I64_MAX]), np.ones(3, bool)) is None
    empty = pk.build_probe_table(torch.zeros(0, dtype=torch.int64),
                                 torch.zeros(0, dtype=torch.bool), 16)
    assert not empty.any()
    got = pk.hash_probe_index(torch.tensor([pk.EMPTY_KEY, 0]), torch.ones(2, dtype=torch.bool),
                              empty)
    assert got.tolist() == [-1, -1]


@pytest.mark.parametrize("seed", [11, 12])
def test_table_holds_every_valid_entry_once_in_16_byte_slots(seed):
    """The layout itself: (S, 2) int64, 16 bytes a slot, the stored key in
    bytes 0-7, the int32 row in bytes 8-11 (little-endian), 4 zero bytes of
    padding; every valid (key, row) in exactly one slot, every other slot
    all zero."""
    dim_keys, dim_valid, _fk, _fv = _case(seed, n_dim=900)
    slots = pk.probe_table_slots(len(dim_keys))
    table = pk.build_probe_table(torch.from_numpy(dim_keys), torch.from_numpy(dim_valid),
                                 slots)
    assert table.shape == (slots, 2) and table.dtype == torch.int64 and table.is_contiguous()
    raw = table.numpy().view(np.uint8).reshape(slots, 16)
    stored = raw[:, :8].copy().view("<i8").ravel()
    rows = raw[:, 8:12].copy().view("<i4").ravel()
    assert not raw[:, 12:].any()
    occupied = stored != 0
    assert not raw[~occupied].any()
    entries = sorted(zip((stored[occupied] ^ pk.EMPTY_KEY).tolist(), rows[occupied].tolist()))
    want = sorted((int(k), i) for i, (k, v) in enumerate(zip(dim_keys, dim_valid)) if v)
    assert entries == want
    assert len({k for k, _ in entries}) == len(entries) == int(dim_valid.sum())
    keys, rows_t = pk.table_entries(table)
    assert list(zip(keys.tolist(), rows_t.tolist())) == want


def test_table_must_be_16_byte_aligned():
    table = pk.build_probe_table(torch.arange(4, dtype=torch.int64),
                                 torch.ones(4, dtype=torch.bool), 16)
    shifted = torch.zeros(2 * 16 + 1, dtype=torch.int64)[1:].view(16, 2)
    shifted.copy_(table)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pk.hash_probe_index(torch.arange(4, dtype=torch.int64),
                            torch.ones(4, dtype=torch.bool), shifted)


# ---- K5: probe + segment sum ----------------------------------------------------------


@pytest.mark.parametrize("seed,cap,p", [(1, 64, 3), (2, 8, 2)])
def test_probe_segment_sum_matches_reference_pallas_kernel(seed, cap, p):
    """The setup of the reference's own test (tests/test_pallas_join.py), with
    null dim keys, misses, null fact keys, keys past 2^53 and codes outside
    [0, cap) added."""
    rng = np.random.default_rng(seed)
    n_dim, n = 200, N_FACT
    dim_keys = np.concatenate([
        rng.choice(5_000, n_dim - 40, replace=False).astype(np.int64),
        BIG + np.arange(40, dtype=np.int64)])
    dim_valid = rng.random(n_dim) > 0.05
    planes = rng.integers(0, 100, (n_dim, p)).astype(np.float32)
    fact_keys = dim_keys[rng.integers(0, n_dim, n)].copy()
    fact_keys[::5] = -9                   # misses
    fact_valid = rng.random(n) > 0.15     # null fact keys
    codes = rng.integers(-2, cap + 2, n).astype(np.int32)
    tbl = ref_pk.build_probe_table(dim_keys, dim_valid)
    tp = np.zeros((tbl[0].shape[1], p), dtype=np.float32)
    tp[:n_dim] = planes                   # the reference's slots are dim rows
    fh, fl = ref_pk.probe_key_digits(jnp.asarray(fact_keys), jnp.asarray(fact_valid))
    want_sums, want_counts = ref_pk.hash_probe_segment_sum(
        fh, fl, jnp.asarray(codes), jnp.asarray(tbl[0]), jnp.asarray(tbl[1]),
        jnp.asarray(tbl[2]), jnp.asarray(tp), cap, interpret=True)

    slots = pk.probe_table_slots(n_dim)
    table = pk.build_probe_table(torch.from_numpy(dim_keys), torch.from_numpy(dim_valid),
                                 slots)
    counters.reset()
    sums, counts = pk.hash_probe_segment_sum(
        torch.from_numpy(fact_keys), torch.from_numpy(fact_valid), torch.from_numpy(codes),
        table, torch.from_numpy(planes), cap)
    snap = counters.snapshot()
    assert snap["plain_hash_probe_segment_sum"] == 1
    assert snap["launches_hash_probe_segment_sum"] == 0
    assert sums.dtype == torch.float64 and sums.shape == (cap, p)
    assert counts.dtype == torch.int64 and counts.shape == (cap,)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(want_sums).astype(np.float64))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts).astype(np.int64))
    # and against a dict probe in numpy
    idx = _dict_probe(fact_keys, fact_valid, dim_keys, dim_valid)
    hit = (idx >= 0) & (codes >= 0) & (codes < cap)
    exp = np.zeros((cap, p))
    np.add.at(exp, codes[hit], planes[idx[hit]].astype(np.float64))
    np.testing.assert_array_equal(sums.numpy(), exp)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(codes[hit], minlength=cap))
    assert counts.sum().item() > 0


def test_probe_segment_sum_empty_dim_and_validation():
    keys = torch.arange(16, dtype=torch.int64)
    valid = torch.ones(16, dtype=torch.bool)
    codes = torch.zeros(16, dtype=torch.int32)
    table = pk.build_probe_table(keys[:0], valid[:0], 16)
    sums, counts = pk.hash_probe_segment_sum(keys, valid, codes, table,
                                             torch.zeros((0, 2)), 4)
    assert (sums == 0).all() and (counts == 0).all()
    table = pk.build_probe_table(keys[:4], valid[:4], 16)
    planes = torch.ones((4, 2))
    with pytest.raises(ValueError):
        pk.hash_probe_segment_sum(keys, valid, codes[:8], table, planes, 4)
    with pytest.raises(TypeError):
        pk.hash_probe_segment_sum(keys, valid, codes, table, planes.double(), 4)
    with pytest.raises(ValueError, match="cannot hold"):
        pk.hash_probe_segment_sum(keys, valid, codes, table, torch.ones((9, 2)), 4)
