"""The port's spill files (daft_tpu_torch/memory/spill.py) and byte
accounting, against the reference's behaviour (daft_tpu/memory/spill.py,
tests/test_spill_async.py):

- ``size_bytes`` equals the reference's (Arrow's ``nbytes``) on the same
  columns: every dtype, with and without nulls, sliced and taken;
- a frame and a spill file give back the batch that was written, bit for
  bit (values under nulls, NaN, -0.0, dates, dictionary-coded strings,
  lists, Python objects, empty batches), with the codec "none" and
  "snappy", synchronously and on the IO pool, with and without prefetch;
- a deferred write error surfaces and leaves nothing behind; the stale-file
  GC takes a dead pid's files and ``.tmp`` names and never a live one's;
- "lz4" and "zstd" are refused;
- ``SpillPartitions`` puts each row in the partition the reference's hash
  partitioning does.

Tolerance: everything here is bit for bit.
"""

import errno
import io
import os
import time

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch as dt
from daft_tpu_torch.core.recordbatch import RecordBatch
from daft_tpu_torch.core.series import Series
from daft_tpu_torch.datatype import DataType
from daft_tpu_torch.interop import from_numpy_columns
from daft_tpu_torch.memory import SpillFile, SpillPartitions, gc_stale_spills, manager
from daft_tpu_torch.memory import reset_counters, spill
from daft_tpu_torch.ops import counters

SEED = 20261018


@pytest.fixture(autouse=True)
def _clean():
    reset_counters()
    manager().clear()
    yield
    manager().clear()


KINDS = {"i8": "int8", "i16": "int16", "i32": "int32", "i64": "int64", "u8": "uint8",
         "u32": "uint32", "u64": "uint64", "f32": "float32", "f64": "float64",
         "b": "bool", "s": "string", "d": "date"}


def _columns(n: int, nulls: bool, seed: int = SEED):
    rng = np.random.default_rng(seed)
    words = np.array(["", "a", "bb", "héllo", "ünïcode ✓", "x" * 40], dtype=object)
    cols = {
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "i16": rng.integers(-30000, 30000, n).astype(np.int16),
        "i32": rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
        "i64": rng.integers(-(1 << 62), 1 << 62, n),
        "u8": rng.integers(0, 256, n).astype(np.uint8),
        "u32": rng.integers(0, 1 << 32, n).astype(np.uint32),
        "u64": rng.integers(0, 1 << 63, n).astype(np.uint64),
        "f32": rng.standard_normal(n).astype(np.float32),
        "f64": rng.standard_normal(n),
        "b": rng.random(n) < 0.5,
        "s": words[rng.integers(0, len(words), n)],
        "d": rng.integers(-1000, 20000, n).astype(np.int32),
    }
    if n:
        cols["f64"][: min(n, 3)] = [np.nan, -0.0, np.inf][: min(n, 3)]
        cols["f32"][: min(n, 2)] = [np.nan, -0.0][: min(n, 2)]
    return {c: (v, (rng.random(n) < 0.85) if nulls else np.ones(n, dtype=bool))
            for c, v in cols.items()}


def _port_batch(cols) -> RecordBatch:
    df = from_numpy_columns(cols, {c: DataType(k) for c, k in KINDS.items()})
    return df._plan.partitions[0].concat_or_empty()


def _ref_batch(port: RecordBatch):
    data = {c: port.get_column(c).to_pylist() for c in KINDS}
    df = daft_tpu.from_pydict(data).with_columns(
        {c: daft_tpu.col(c).cast(daft_tpu.DataType(k)) for c, k in KINDS.items()})
    return df.collect()._result[0].concat_or_empty()


def _same_series(a: Series, b: Series) -> bool:
    """Equal dtype, name, validity, and values bit for bit (under nulls too)."""
    if (a.dtype, a.name, len(a)) != (b.dtype, b.name, len(b)):
        return False
    if not np.array_equal(a.validity_numpy(), b.validity_numpy()):
        return False
    av, bv = a.to_numpy(), b.to_numpy()
    if av.dtype != bv.dtype:
        return False
    if av.dtype == object:
        return all((x is None and y is None) or (type(x) is type(y) and x == y)
                   for x, y in zip(av.tolist(), bv.tolist()))
    return av.tobytes() == bv.tobytes()


def _same_batch(a: RecordBatch, b: RecordBatch) -> bool:
    return a.schema == b.schema and a.num_rows == b.num_rows and \
        all(_same_series(x, y) for x, y in zip(a.columns(), b.columns()))


def _nan_equal(a: dict, b: dict) -> bool:
    """Equal pydicts, NaN equal to NaN."""
    def norm(v):
        return "nan" if isinstance(v, float) and v != v else v
    return list(a) == list(b) and all([norm(v) for v in a[c]] == [norm(v) for v in b[c]]
                                      for c in a)


# ---- size_bytes ----------------------------------------------------------------------


@pytest.mark.parametrize("nulls", [False, True])
@pytest.mark.parametrize("n", [0, 1, 9, 1000])
def test_size_bytes_equals_reference(n, nulls):
    port = _port_batch(_columns(n, nulls))
    ref = _ref_batch(port)
    for c in KINDS:
        assert port.get_column(c).size_bytes() == \
            ref.get_column(c).to_arrow().nbytes, (c, n, nulls)
    assert port.size_bytes() == ref.size_bytes()


def test_size_bytes_of_taken_rows_equals_reference():
    port = _port_batch(_columns(500, True))
    ref = _ref_batch(port)
    idx = np.random.default_rng(1).permutation(500)[:123]
    assert port.take(idx).size_bytes() == ref.take(idx).size_bytes()


def test_size_bytes_of_lists_python_and_null_columns():
    from daft_tpu.core.series import Series as RefSeries

    lists = [[1.0, 2.0], [3.0], None, []]
    assert Series.from_pylist(lists, "l", DataType.list(DataType.float64())).size_bytes() \
        == RefSeries.from_pylist(lists, "l").to_arrow().nbytes
    assert Series.from_pylist([None] * 5, "n").size_bytes() == \
        RefSeries.from_pylist([None] * 5, "n").to_arrow().nbytes == 0
    assert Series.from_pylist([object(), 3], "p", DataType.python()).size_bytes() == 128
    part = dt.MicroPartition.from_pydict({"a": np.arange(10), "b": np.arange(10.0)})
    assert part.size_bytes() == 160


def _dictionary_coded(how: str, tmp_path) -> Series:
    """A string column (nulls, non-ASCII) whose dictionary codes are known,
    made the way ``how`` names."""
    rng = np.random.default_rng(SEED)
    words = np.array(["", "a", "bb", "héllo", "ünïcode ✓", "x" * 40], dtype=object)
    vals = words[rng.integers(0, len(words), 600)]
    valid = rng.random(600) < 0.8
    vals[~valid] = None
    if how in ("parquet", "slice", "take", "concat", "wide_dictionary"):
        with dt.execution_config_ctx(device="cpu"):
            dt.from_pydict({"s": vals.tolist()}).write_parquet(str(tmp_path / "pq")).to_pydict()
            s = dt.read_parquet(str(tmp_path / "pq")).collect()._result[0] \
                .concat_or_empty().get_column("s")
        if how == "slice":
            s = s.slice(17, 450)
        elif how == "take":
            s = s.take(rng.permutation(600)[:321])
        elif how == "concat":
            s = Series.concat([s.slice(0, 200), s.slice(350, 600)])
        elif how == "wide_dictionary":  # fewer rows than entries: the values are measured
            s = s.slice(5, 8)
        return s
    s = Series.from_pylist(vals.tolist(), "s", DataType.string())
    if how == "dict_codes":
        s.dict_codes()
        return s
    f = SpillFile(RecordBatch.from_pydict({"s": s}).schema, spill_dir=str(tmp_path),
                  compression="none")
    s._dict_codes = ("raw", *s.dict_codes()[:2])
    f.append(RecordBatch.from_pydict({"s": s}))
    f.finish()
    out = RecordBatch.concat(list(f.read())).get_column("s")
    f.delete()
    return out


@pytest.mark.parametrize("how", ["parquet", "spill", "slice", "take", "concat", "dict_codes",
                                 "wide_dictionary"])
def test_size_bytes_of_dictionary_coded_strings(how, tmp_path):
    """A string column whose dictionary codes are known (a Parquet or spill
    read, a slice, take or concatenation of one, a factorized column)
    counts what the same values count as a plain column, and the
    reference's ``nbytes``."""
    from daft_tpu.core.series import Series as RefSeries

    s = _dictionary_coded(how, tmp_path)
    assert s._raw_codes() is not None
    assert (len(s._raw_codes()[1]) > len(s)) == (how == "wide_dictionary")
    rows = s.to_pylist()
    assert any(v is None for v in rows) or how == "wide_dictionary"
    plain = Series.from_pylist(rows, "s", DataType.string())
    assert plain._raw_codes() is None
    assert s.size_bytes() == plain.size_bytes() == RefSeries.from_pylist(rows, "s") \
        .to_arrow().nbytes


# ---- the frame format ----------------------------------------------------------------


@pytest.mark.parametrize("codec", ["none", "snappy"])
@pytest.mark.parametrize("n", [0, 1, 777])
@pytest.mark.parametrize("nulls", [False, True])
def test_frame_round_trip_is_bit_exact(codec, n, nulls):
    batch = _port_batch(_columns(n, nulls))
    # values under a null kept as written, not as the fill
    got = spill.read_frame(io.BytesIO(spill.encode_batch(batch, codec)))
    assert _same_batch(got, batch)


def test_frame_round_trip_of_dictionary_strings_lists_and_objects():
    codes = np.array([2, 1, 0, 0, 2], dtype=np.int32)
    values = np.array(["zz", None, "y", "y", "zz"], dtype=object)
    s = Series("s", DataType.string(), values, np.array([1, 0, 1, 1, 1], dtype=bool))
    s._dict_codes = ("raw", codes, ["y", None, "zz"])
    lst = Series.from_pylist([[1, 2], None, [], [3], [4, 5, 6]], "l",
                             DataType.list(DataType.int64()))
    obj = Series.from_pylist([{"a": 1}, None, 3.5, "x", (1,)], "o", DataType.python())
    nul = Series.from_pylist([None] * 5, "n")
    b = RecordBatch.from_pydict({"s": s, "l": lst, "o": obj, "n": nul})
    for codec in ("none", "snappy"):
        frame = spill.encode_batch(b, codec)
        got = spill.read_frame(io.BytesIO(frame))
        assert _same_batch(got, b)
        assert got.get_column("s")._raw_codes() is not None  # the codes travel
    assert '"form": "dict"' in spill.encode_batch(b, "none")[8:400].decode(errors="ignore")


def test_snappy_shrinks_what_none_writes(tmp_path):
    batch = _port_batch(_columns(4000, False))
    sizes = {}
    for codec in ("none", "snappy"):
        with dt.execution_config_ctx(spill_compression=codec, spill_io_threads=0):
            f = SpillFile(batch.schema, spill_dir=str(tmp_path))
            rep = RecordBatch.from_pydict({"s": batch.get_column("s")})
            f.schema = rep.schema
            for _ in range(3):
                f.append(rep)
            f.finish()
            sizes[codec] = os.path.getsize(f.path)
            assert _same_batch(RecordBatch.concat(list(f.read())),
                               RecordBatch.concat([rep] * 3))
            f.delete()
    assert sizes["snappy"] < sizes["none"]


# ---- spill files ---------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["none", "snappy"])
@pytest.mark.parametrize("io_threads,prefetch", [(0, 0), (2, 0), (2, 2), (1, 3)])
def test_spill_file_round_trip(tmp_path, codec, io_threads, prefetch):
    batches = [_port_batch(_columns(n, True, seed=SEED + n)) for n in (300, 0, 1, 2000)]
    with dt.execution_config_ctx(memory_limit_bytes=1 << 24, spill_compression=codec,
                                 spill_io_threads=io_threads,
                                 spill_prefetch_batches=prefetch):
        f = SpillFile(batches[0].schema, spill_dir=str(tmp_path))
        for b in batches:
            f.append(b)
        f.finish_async()
        got = list(f.read())
    assert [b.num_rows for b in got] == [300, 1, 2000]  # empty batches are not written
    for g, w in zip(got, [b for b in batches if b.num_rows]):
        assert _same_batch(g, w)
    snap = counters.snapshot()
    assert snap["spill_batches"] == 3 and snap["spill_files"] == 1
    assert snap["spill_bytes"] == sum(b.size_bytes() for b in batches)
    assert f.bytes_written == snap["spill_bytes"] and f.rows == 2301
    assert snap["spill_wire_bytes"] == os.path.getsize(f.path)
    if io_threads:
        assert snap["spill_write_seconds"] > 0
    else:  # the synchronous path touches no overlap counter
        assert snap["spill_write_seconds"] == snap["spill_write_wall_seconds"] == 0
        assert snap["spill_read_seconds"] == snap["spill_read_wall_seconds"] == 0
    if io_threads and prefetch:
        assert snap["spill_read_seconds"] > 0
        assert 1 <= snap["spill_prefetch_inflight"] <= prefetch
    else:
        assert snap["spill_prefetch_inflight"] == 0
    assert manager().tracked_bytes() == 0  # queued bytes left the ledger once written
    f.delete()
    assert not os.path.exists(f.path) and not os.path.exists(f._tmp)


def test_overlap_seconds_of_a_snapshot():
    snap = dict.fromkeys(counters.COUNTER_NAMES, 0)
    snap.update(spill_write_seconds=3.0, spill_write_wall_seconds=1.0,
                spill_read_seconds=1.0, spill_read_wall_seconds=2.0)
    assert counters.spill_overlap_seconds(snap) == 2.0


def test_async_queue_holds_its_bytes_on_the_ledger(tmp_path, monkeypatch):
    """Queued-but-unwritten batches are on the ledger until written."""
    batch = _port_batch(_columns(1000, False))
    gate = []

    real = SpillFile._write

    def slow_write(self, b):
        while not gate:
            time.sleep(0.005)
        real(self, b)

    monkeypatch.setattr(SpillFile, "_write", slow_write)
    with dt.execution_config_ctx(memory_limit_bytes=1 << 26, spill_io_threads=2):
        f = SpillFile(batch.schema, spill_dir=str(tmp_path))
        f.append(batch)
        f.append(batch)
        assert manager().tracked_bytes() == 2 * batch.size_bytes()
        gate.append(1)
        f.finish()
        assert manager().tracked_bytes() == 0
        f.delete()


def test_deferred_write_error_surfaces_and_cleans(tmp_path, monkeypatch):
    batch = _port_batch(_columns(1000, True))
    with dt.execution_config_ctx(memory_limit_bytes=1 << 24, spill_io_threads=2,
                                 spill_prefetch_batches=2):
        f = SpillFile(batch.schema, spill_dir=str(tmp_path))
        f.append(batch)

        def _enospc(src, dst):
            raise OSError(errno.ENOSPC, "No space left on device", dst)

        monkeypatch.setattr(spill.os, "replace", _enospc)
        f.finish_async()
        deadline = time.time() + 10
        while time.time() < deadline and f._io_err is None:
            time.sleep(0.01)
        assert f._io_err is not None
        with pytest.raises(RuntimeError, match="deferred spill write failed"):
            f.finish()
        with pytest.raises(RuntimeError, match="deferred spill write failed"):
            f.append(batch)
        monkeypatch.undo()
        assert manager().tracked_bytes() == 0
        f.delete()
    assert os.listdir(tmp_path) == []


def test_a_truncated_file_raises_on_read(tmp_path):
    batch = _port_batch(_columns(500, False))
    with dt.execution_config_ctx(spill_io_threads=0):
        f = SpillFile(batch.schema, spill_dir=str(tmp_path))
        f.append(batch)
        f.finish()
        with open(f.path, "r+b") as fh:
            fh.truncate(os.path.getsize(f.path) - 10)
        with pytest.raises(IOError, match="truncated"):
            list(f.read())
        f.delete()


def test_gc_sweeps_dead_pid_tmp_not_live(tmp_path):
    dead = None
    for pid in range(300_000, 300_064):
        try:
            os.kill(pid, 0)
        except ProcessLookupError:
            dead = pid
            break
        except OSError:
            continue
    assert dead is not None
    root = tmp_path / "spillroot"
    root.mkdir()
    live_tmp = f"s{os.getpid()}_cafecafe01.spill.tmp"
    (root / live_tmp).write_bytes(b"x")
    (root / f"s{dead}_deadbeef01.spill.tmp").write_bytes(b"x")
    (root / f"s{dead}_deadbeef02.spill").write_bytes(b"x")
    (root / f"g{dead}_deadbeef04").mkdir()
    (root / f"g{dead}_deadbeef04" / "x.spill").write_bytes(b"x")
    # a name that only resembles an artifact never parses into a pid
    (root / f"s{dead}_deadbeef03.spill.tmp.bak").write_bytes(b"x")
    (root / f"s{dead}_deadbeef05.arrow").write_bytes(b"x")  # the reference's, not ours
    assert gc_stale_spills(str(root)) == 3
    assert sorted(os.listdir(root)) == sorted(
        [live_tmp, f"s{dead}_deadbeef03.spill.tmp.bak", f"s{dead}_deadbeef05.arrow"])
    assert counters.spill_dirs_gced == 3


def test_spill_root_is_the_ports_own(tmp_path):
    import tempfile

    from daft_tpu.memory import spill_root as ref_root

    with dt.execution_config_ctx(spill_dir=""):
        assert spill.spill_root() == os.path.join(tempfile.gettempdir(),
                                                  "daft_tpu_torch_spill")
        assert spill.spill_root() != ref_root()
    with dt.execution_config_ctx(spill_dir=str(tmp_path)):
        assert spill.spill_root() == str(tmp_path)


@pytest.mark.parametrize("codec", ["lz4", "zstd"])
def test_reference_codecs_refused(tmp_path, codec):
    batch = _port_batch(_columns(10, False))
    with pytest.raises(ValueError, match="'none' or 'snappy'"):
        SpillFile(batch.schema, spill_dir=str(tmp_path), compression=codec)


# ---- Grace partitions ----------------------------------------------------------------


@pytest.mark.parametrize("keys", [["i64"], ["s"], ["i32", "d"], ["f64", "b"]])
def test_spill_partitions_match_reference_hash_partitioning(tmp_path, keys):
    port = _port_batch(_columns(3000, True))
    ref = _ref_batch(port)
    k = 16
    want = ref.partition_by_hash([ref.get_column(c) for c in keys], k)
    with dt.execution_config_ctx(spill_dir=str(tmp_path)):
        sp = SpillPartitions(port.schema, k)
        try:
            sp.append_partitioned(port.slice(0, 1700), [dt.col(c) for c in keys])
            sp.append_partitioned(port.slice(1700, 3000), [dt.col(c) for c in keys])
            for j, f in enumerate(sp.files):
                bs = list(f.read())
                got = RecordBatch.concat(bs).to_pydict() if bs else \
                    {c: [] for c in KINDS}
                assert _nan_equal(got, want[j].to_pydict()), j
            assert sp.bytes_written == counters.spill_bytes > 0
            assert sum(f.rows for f in sp.files) == 3000
        finally:
            sp.delete()
    assert not os.path.exists(sp.dir)
