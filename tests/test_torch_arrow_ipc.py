"""The port's Arrow IPC stream writer and reader (daft_tpu_torch/io/
arrow_ipc.py) and its LZ4 codec (native.py over csrc/kernels.cpp) against
pyarrow, which the reference writes and reads them with.

- Every type the port holds, with nulls, under "none" and "lz4": the
  port's bytes read by ``pyarrow.ipc.open_stream`` (validated in full) give
  the port's values, with the field types the reference's
  ``RecordBatch.to_arrow()`` gives for the same columns; pyarrow's bytes
  of the same table read by the port give them back.
- pyarrow's own variants the port reads: 32-bit offsets (``string``,
  ``binary``, ``list``), time32, date64, a sliced table, a null list row
  holding elements.
- The LZ4 exports against their plain versions (the same compressed bytes,
  the same decoded bytes), pyarrow's frames decoded by both, frames of
  several blocks, stored blocks, checksums; "zstd" raises.
"""

import datetime
import io
import os

import numpy as np
import pyarrow as pa
import pyarrow.ipc as ipc
import pytest

from daft_tpu_torch import native
from daft_tpu_torch.core.recordbatch import RecordBatch
from daft_tpu_torch.core.series import Series
from daft_tpu_torch.datatype import DataType as T
from daft_tpu_torch.datatype import Field
from daft_tpu_torch.io import arrow_ipc
from daft_tpu_torch.schema import Schema

UTC = datetime.timezone.utc


def _columns():
    d = datetime.date
    ts = datetime.datetime
    return [
        Series.from_pylist([1, None, 3, -4, None, 6, 7, 2**40, 0], "i64", T.int64()),
        Series.from_pylist([1, 2, None, -4, 5, 6, 7, 8, -128], "i8", T.int8()),
        Series.from_pylist([1, 2, None, 4, 5, 6, 7, 8, 65535], "u16", T.uint16()),
        Series.from_pylist([1, 2, None, 4, 5, 6, 7, 8, 2**32 - 1], "u32", T.uint32()),
        Series.from_pylist([1.5, None, -0.0, 4, 5, 6, 7, 1e300, 0], "f64", T.float64()),
        Series.from_pylist([1.5, None, 3, 4, 5, 6, 7, 8, 9], "f32", T.float32()),
        Series.from_pylist([True, None, False, True, True, False, None, True, True], "b",
                           T.bool()),
        Series.from_pylist(["a", None, "ccc", "", "é", "x" * 40, None, "日本", "z"], "s",
                           T.string()),
        Series.from_pylist([b"a", None, b"\x00\x01", b"", b"zz", b"q", None, b"\xff", b"k"],
                           "bin", T.binary()),
        Series.from_pylist([b"ab", None, b"cd", b"ef", b"gh", b"ij", b"kl", b"mn", b"op"],
                           "fsb", T.fixed_size_binary(2)),
        Series.from_pylist([d(2020, 1, 1), None, d(1969, 12, 31), d(1970, 1, 1), None,
                            d(2262, 4, 11), d(1900, 2, 28), d(2000, 2, 29), d(1995, 6, 1)], "d",
                           T.date()),
        Series.from_pylist([ts(2020, 1, 1, 3, 4, 5, 6), None, ts(1969, 12, 31, 23, 59, 59),
                            ts(1999, 1, 1), None, ts(2001, 9, 9, 1, 46, 40), ts(1970, 1, 1),
                            ts(2020, 2, 29), ts(1980, 5, 5)], "ts", T.timestamp("us")),
        Series.from_pylist([ts(2020, 1, 1, 3, 4, 5, tzinfo=UTC), None,
                            ts(1999, 1, 1, tzinfo=UTC)] * 3, "tsz", T.timestamp("ms", "UTC")),
        Series.from_pylist([ts(2020, 1, 1, 3, 4, 5, 123456)] * 4 + [None] * 5, "tsn",
                           T.timestamp("ns")),
        Series.from_pylist([datetime.timedelta(seconds=5), None, datetime.timedelta(days=-1)] * 3,
                           "dur", T.duration("us")),
        Series.from_pylist([datetime.timedelta(seconds=5), None, datetime.timedelta(0)] * 3,
                           "durs", T.duration("s")),
        Series.from_pylist([datetime.time(1, 2, 3), None, datetime.time(23, 59, 59, 999999)] * 3,
                           "t", T.time("us")),
        Series.from_pylist([[1, 2], None, [], [3], [None, 5], [6, 7, 8], None, [9], []], "l",
                           T.list(T.int64())),
        Series.from_pylist([["a", None], None, [], ["b"], ["c", "d"], [], ["e"], None, ["é"]],
                           "ls", T.list(T.string())),
        Series.from_pylist([[[1], [2, 3]], None, [], [[None]], [[4]], [], [[5, 6]], [None], []],
                           "ll", T.list(T.list(T.int32()))),
        Series.from_pylist([[1.0, 2.0], None, [3.0, 4.0], [5.0, None], [1, 1], [2, 2], [3, 3],
                            [4, 4], [5, 5]], "fsl", T.fixed_size_list(T.float64(), 2)),
        Series.from_pylist([{"a": 1, "b": "x"}, None, {"a": None, "b": "y"}, {"a": 3, "b": None},
                            {"a": 4, "b": "z"}, {"a": 5, "b": ""}, {"a": 6, "b": "w"}, None,
                            {"a": 8, "b": "v"}], "st",
                           T.struct([("a", T.int64()), ("b", T.string())])),
        Series.from_pylist([{"k": 1}, None, {}, {"a": 2, "b": None}, {"z": 9}, {"y": 8},
                            {"x": 7}, None, {"w": 6}], "m", T.map(T.string(), T.int64())),
        Series.from_pylist([None] * 9, "nul", T.null()),
        Series.from_pylist([[1.0, 2.0, 3.0], None, [0.0, 0.5, 1.0]] * 3, "emb",
                           T.embedding(T.float32(), 3)),
    ]


def _batch():
    cols = _columns()
    return RecordBatch(Schema([c.field() for c in cols]), cols)


def _norm(v):
    """pyarrow's and the port's Python values in one form: a map's rows as
    sorted pairs, an aware datetime as its instant, a NaN kept."""
    if isinstance(v, list):
        if v and all(isinstance(x, tuple) and len(x) == 2 for x in v):
            return sorted(v, key=repr)
        return [_norm(x) for x in v]
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, datetime.datetime) and v.tzinfo is not None:
        return ("instant", v.timestamp())
    if isinstance(v, np.ndarray):
        return [_norm(x) for x in v.tolist()]
    if hasattr(v, "to_pydatetime"):
        return v.to_pydatetime()
    return v


def _port_values(batch):
    return {c.name: [_norm(v) for v in c.to_pylist()] for c in batch.columns()}


@pytest.mark.parametrize("compression", ["none", "lz4"])
def test_pyarrow_reads_every_type_the_port_writes(compression):
    from daft_tpu.core.recordbatch import RecordBatch as RefBatch

    batch = _batch()
    data = arrow_ipc.encode_stream([batch, batch.slice(2, 7)], batch.schema, compression)
    table = ipc.open_stream(io.BytesIO(data)).read_all()
    table.validate(full=True)
    want = _port_values(batch)
    sliced = _port_values(batch.slice(2, 7))
    got = table.to_pydict()
    for name in want:
        assert [_norm(v) for v in got[name]] == want[name] + sliced[name], name
    # the field types are the reference's RecordBatch.to_arrow()'s for these
    # columns (the embedding as its storage, a fixed-size list)
    ref = RefBatch.from_arrow(table.drop_columns(["emb"])).to_arrow()
    assert table.schema.remove(table.schema.get_field_index("emb")).equals(ref.schema)
    assert table.schema.field("emb").type == pa.list_(pa.float32(), 3)


@pytest.mark.parametrize("compression", ["none", "lz4"])
def test_port_reads_pyarrows_stream_of_every_type(compression):
    batch = _batch()
    table = ipc.open_stream(io.BytesIO(arrow_ipc.encode_stream([batch], batch.schema))).read_all()
    sink = io.BytesIO()
    opts = ipc.IpcWriteOptions(compression=None if compression == "none" else compression)
    with ipc.new_stream(sink, table.schema, options=opts) as w:
        w.write_table(table)
        w.write_table(table.slice(3, 4))
    back = arrow_ipc.decode_stream(sink.getvalue(), batch.schema)
    assert [b.num_rows for b in back] == [9, 4]
    assert _port_values(back[0]) == _port_values(batch)
    assert _port_values(back[1]) == _port_values(batch.slice(3, 7))
    assert back[0].schema == batch.schema


def test_port_reads_pyarrows_other_layouts():
    """32-bit offsets, time32, date64, half floats, a null list row that
    holds elements, and a table sliced before writing."""
    list_arr = pa.ListArray.from_arrays(pa.array([0, 2, 4, 5], type=pa.int32()),
                                        pa.array([1, 2, 3, 4, 5], type=pa.int64()),
                                        mask=pa.array([False, True, False]))
    table = pa.table({
        "s": pa.array(["a", None, "bc"], type=pa.string()),
        "b": pa.array([b"x", b"", None], type=pa.binary()),
        "l": list_arr,
        "t32": pa.array([1000, None, 86_399_999], type=pa.time32("ms")),
        "t32s": pa.array([1, 2, None], type=pa.time32("s")),
        "d64": pa.array([0, 86_400_000 * 3, None], type=pa.date64()),
        "h": pa.array(np.array([1.5, -2.0, 0.25], dtype=np.float16)),
        "lst": pa.array([["a"], None, ["b", None]], type=pa.list_(pa.string())),
    })
    for t in (table, table.slice(1, 2)):
        sink = io.BytesIO()
        with ipc.new_stream(sink, t.schema, options=ipc.IpcWriteOptions(compression="lz4")) as w:
            w.write_table(t)
        (b,) = arrow_ipc.decode_stream(sink.getvalue())
        got = b.to_pydict()
        want = t.to_pydict()
        assert got["s"] == want["s"] and got["b"] == want["b"] and got["lst"] == want["lst"]
        assert got["l"] == [v if v is not None else None for v in want["l"]]
        assert got["t32"] == want["t32"] and got["t32s"] == want["t32s"]
        assert got["d64"] == [None if v is None else v.date() if hasattr(v, "date") else v
                              for v in want["d64"]]
        assert got["h"] == [float(v) for v in want["h"]]
        assert b.schema["t32"].dtype == T.time("us") and b.schema["h"].dtype == T.float32()


def test_an_empty_batch_and_an_empty_stream():
    batch = _batch()
    empty = batch.slice(0, 0)
    data = arrow_ipc.encode_stream([empty], batch.schema, "lz4")
    assert ipc.open_stream(io.BytesIO(data)).read_all().num_rows == 0
    assert [b.num_rows for b in arrow_ipc.decode_stream(data)] == [0]
    schema, batches = arrow_ipc.read_stream(arrow_ipc.encode_stream([], batch.schema))
    # a logical column reads back as its storage type (onto_schema rewraps it)
    assert schema == Schema([Field(f.name, f.dtype.storage) for f in batch.schema])
    assert list(batches) == []


def test_stream_writer_to_a_file(tmp_path):
    batch = _batch()
    path = tmp_path / "x.arrow"
    with open(path, "wb") as f, arrow_ipc.StreamWriter(f, batch.schema, "lz4") as w:
        w.write(batch)
        w.write(batch)
    with open(path, "rb") as f:
        got = list(arrow_ipc.iter_ipc_batches(f))
    assert len(got) == 2 and _port_values(got[1]) == _port_values(batch)
    with pa.OSFile(str(path)) as f:
        assert ipc.open_stream(f).read_all().num_rows == 18


def test_zstd_raises_both_ways():
    batch = _batch()
    with pytest.raises(NotImplementedError, match="zstd"):
        arrow_ipc.encode_stream([batch], batch.schema, "zstd")
    with pytest.raises(NotImplementedError, match="zstd"):
        arrow_ipc.StreamWriter(io.BytesIO(), batch.schema, "zstd")
    table = pa.table({"a": pa.array(np.arange(1000))})
    sink = io.BytesIO()
    with ipc.new_stream(sink, table.schema, options=ipc.IpcWriteOptions(compression="zstd")) as w:
        w.write_table(table)
    with pytest.raises(NotImplementedError, match="zstd"):
        arrow_ipc.decode_stream(sink.getvalue())


def test_malformed_streams_raise():
    batch = _batch()
    data = arrow_ipc.encode_stream([batch], batch.schema, "lz4")
    with pytest.raises(ValueError):
        arrow_ipc.decode_stream(data[: len(data) // 2])
    with pytest.raises(ValueError):
        arrow_ipc.decode_stream(b"")


# ---- the LZ4 codec -----------------------------------------------------------------


def _payloads():
    rng = np.random.default_rng(7)
    return [b"", b"a", b"abcabcabcabcabcabcabcabc" * 10,
            rng.integers(0, 4, 50_000).astype(np.int64).tobytes(),
            rng.bytes(5000),
            (np.arange(300_000) % 251).astype(np.uint8).tobytes(),
            b"\x00" * 70_000 + rng.bytes(30)]


@pytest.fixture
def plain(monkeypatch):
    def switch(on: bool):
        if on:
            monkeypatch.setenv(native.DISABLE_ENV, "1")
        else:
            monkeypatch.delenv(native.DISABLE_ENV, raising=False)
    return switch


def test_lz4_exports_equal_their_plain_versions(plain):
    for data in _payloads():
        plain(False)
        block = native.lz4_block_compress(data)
        frame = native.lz4_frame_compress(data)
        h = native.lz4_xxh32(data, 17)
        plain(True)
        assert native.lz4_block_compress(data) == block
        assert native.lz4_frame_compress(data) == frame
        assert native.lz4_xxh32(data, 17) == h
        assert native.lz4_block_decompress(block, len(data)) == data
        assert native.lz4_frame_decompress(frame, len(data)) == data
        plain(False)
        assert native.lz4_block_decompress(block, len(data)) == data
        assert native.lz4_frame_decompress(frame, len(data)) == data
    # xxh32's published vectors
    assert native.lz4_xxh32(b"") == native.plain_lz4_xxh32(b"") == 0x02CC5D05
    assert native.lz4_xxh32(b"a") == 0x550D7456


def test_lz4_frames_both_ways_with_pyarrow(plain):
    codec = pa.Codec("lz4")
    for data in _payloads():
        if not data:
            continue
        theirs = codec.compress(data, asbytes=True)
        for flag in (False, True):
            plain(flag)
            assert native.lz4_frame_decompress(theirs, len(data)) == data
            ours = native.lz4_frame_compress(data)
            assert codec.decompress(ours, decompressed_size=len(data)).to_pybytes() == data


def test_lz4_frames_of_several_blocks_and_stored_blocks():
    rng = np.random.default_rng(3)
    data = (np.arange(5 << 20) % 1013).astype(np.uint16).tobytes()[: (9 << 20) + 5]
    frame = native.lz4_frame_compress(data)
    assert native.lz4_frame_decompress(frame, len(data)) == data
    assert pa.Codec("lz4").decompress(frame, decompressed_size=len(data)).to_pybytes() == data
    noise = rng.bytes(100_000)
    stored = native.lz4_frame_compress(noise)
    assert int.from_bytes(stored[7:11], "little") & 0x80000000  # the block is stored
    assert native.lz4_frame_decompress(stored, len(noise)) == noise
    theirs = pa.Codec("lz4").compress(data, asbytes=True)
    assert native.lz4_frame_decompress(theirs, len(data)) == data


def test_lz4_checksums_and_corruption(plain):
    data = b"hello lz4 " * 1000
    frame = bytearray(native.lz4_frame_compress(data))
    bad_header = bytearray(frame)
    bad_header[6] ^= 0xFF
    for flag in (False, True):
        plain(flag)
        with pytest.raises(ValueError, match="checksum"):
            native.lz4_frame_decompress(bytes(bad_header), len(data))
        with pytest.raises(ValueError):
            native.lz4_frame_decompress(bytes(frame[:-6]), len(data))
        with pytest.raises(ValueError):
            native.lz4_frame_decompress(bytes(frame), len(data) - 1)
        with pytest.raises(ValueError, match="not an LZ4 frame"):
            native.lz4_frame_decompress(b"\x00" * 16, 4)
    # a frame with block and content checksums and the content size, as the
    # format allows (built by hand around one of our blocks)
    block = native.lz4_block_compress(data)
    desc = bytes((0x40 | 0x20 | 0x10 | 0x08 | 0x04, 0x40)) + len(data).to_bytes(8, "little")
    hc = (native.lz4_xxh32(desc) >> 8) & 0xFF
    full = ((0x184D2204).to_bytes(4, "little") + desc + bytes((hc,))
            + len(block).to_bytes(4, "little") + block
            + native.lz4_xxh32(block).to_bytes(4, "little") + bytes(4)
            + native.lz4_xxh32(data).to_bytes(4, "little"))
    for flag in (False, True):
        plain(flag)
        assert native.lz4_frame_decompress(full, len(data)) == data
    assert pa.Codec("lz4").decompress(full, decompressed_size=len(data)).to_pybytes() == data


def test_lz4_bodies_written_by_the_library_or_plain_are_identical(plain):
    batch = _batch()
    plain(False)
    a = arrow_ipc.encode_stream([batch], batch.schema, "lz4")
    plain(True)
    b = arrow_ipc.encode_stream([batch], batch.schema, "lz4")
    assert a == b
    assert os.environ.get(native.DISABLE_ENV) == "1"
