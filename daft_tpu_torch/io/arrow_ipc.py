"""Arrow IPC streams, the port's own writer and reader (the reference writes
and reads them through pyarrow: ``gateway/protocol.py:170-209``,
``checkpoint/stages.py:327-368``, ``distributed/shuffle.py``
``iter_ipc_batches``).

A stream is a Schema message, one RecordBatch message per batch, and the
end-of-stream marker; each message is the continuation marker 0xFFFFFFFF,
its metadata length, a flatbuffer ``Message`` (the flatbuffer code and the
Schema table of io/_arrow_schema.py) padded to 8 bytes, and the body: the
batch's buffers in pre-order, each 8-byte aligned. Field types are what the
reference's ``RecordBatch.to_arrow()`` gives for the same columns: strings
and binary large (64-bit offsets), lists large lists, maps of ``entries``
(``key``, ``value``), a time of day in s or ms as time64[us], a logical type
(an embedding, an image, a tensor, a file) its storage type. The reader
takes every type the port holds, 32- and 64-bit offsets alike (pyarrow's
``string`` and ``list`` too), time32, date64 and half floats.

The reader also takes the IPC file container (pyarrow's ``new_file``): its
magic, then the same messages, then a footer it does not need.

Body compression is Arrow's BodyCompression, per buffer: an int64
uncompressed length, -1 for a buffer stored as it is, then the bytes; an
empty buffer stays empty. "lz4" is LZ4_FRAME (native.py's frame codec over
csrc/kernels.cpp); "zstd" raises NotImplementedError: the port has no zstd
codec (ROADMAP Queue 1, entry 8). A validity bitmap is written only
where a column has nulls, with its exact null count, as pyarrow checks.
"""

from __future__ import annotations

import struct
from typing import BinaryIO, Iterable, Iterator, List, Optional, Tuple, Union

import numpy as np

from ..core.recordbatch import RecordBatch
from ..core.series import Series
from ..datatype import DataType, Field
from ..schema import Schema
from . import _arrow_schema as fb

CONTINUATION = b"\xff\xff\xff\xff"
END_OF_STREAM = CONTINUATION + b"\x00\x00\x00\x00"
FILE_MAGIC = b"ARROW1"
_MESSAGE_SCHEMA, _MESSAGE_DICTIONARY, _MESSAGE_BATCH = 1, 2, 3
_V5 = 4
_LZ4_FRAME, _ZSTD = 0, 1
CODECS = ("none", "lz4", "zstd")


def _refuse_zstd() -> NotImplementedError:
    return NotImplementedError(
        "Arrow IPC body compression 'zstd' is not ported: the port has no zstd codec "
        "(ROADMAP Queue 1, entry 8: the zstd codec); use 'lz4' or 'none'")


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# ---- writing -----------------------------------------------------------------------


def _bitmap(bits: np.ndarray) -> bytes:
    return np.packbits(np.asarray(bits, dtype=bool), bitorder="little").tobytes()


def _validity(s: Series) -> Tuple[int, bytes]:
    valid = s.validity_numpy()
    nulls = int(len(valid) - np.count_nonzero(valid))
    return nulls, (_bitmap(valid) if nulls else b"")


def _var_bytes(values, valid: np.ndarray, text: bool) -> Tuple[bytes, bytes]:
    """(int64 offsets, data) of a string or binary column."""
    enc = [b"" if not ok or v is None else (v.encode("utf-8") if text else bytes(v))
           for v, ok in zip(values, valid)]
    off = np.zeros(len(enc) + 1, dtype=np.int64)
    if enc:
        np.cumsum(np.fromiter(map(len, enc), dtype=np.int64, count=len(enc)), out=off[1:])
    return off.tobytes(), b"".join(enc)


def _column(s: Series, nodes: list, buffers: list) -> None:
    """Append one column's field nodes and buffers (pre-order)."""
    s = s.as_storage()
    dt = s.dtype
    n = len(s)
    kind = dt.kind
    if kind == "python":
        raise ValueError(f"column {s.name!r} holds Python objects; no Arrow representation")
    if kind == "null":
        nodes.append((n, n))
        return
    nulls, validity = _validity(s)
    nodes.append((n, nulls))
    buffers.append(validity)
    valid = s.validity_numpy()
    if kind == "bool":
        buffers.append(_bitmap(np.asarray(s._values, dtype=bool) & valid))
    elif kind in ("string", "binary"):
        off, data = _var_bytes(s._values, valid, kind == "string")
        buffers += [off, data]
    elif kind == "fixed_size_binary":
        size = dt.size
        buffers.append(b"".join(v if ok and v is not None else bytes(size)
                                for v, ok in zip(s._values, valid)))
    elif s.is_nested:
        lay = s.layout
        if kind in ("list", "map"):
            buffers.append(np.asarray(lay.offsets, dtype=(np.int64 if kind == "list"
                                                          else np.int32)).tobytes())
        if kind == "map":
            # the entries struct: key and value, never null
            entries = lay.children[0]
            nodes.append((len(entries), 0))
            buffers.append(b"")
            for child in entries.layout.children:
                _column(child, nodes, buffers)
        else:
            for child in lay.children:
                _column(child, nodes, buffers)
    else:
        buffers.append(np.ascontiguousarray(s._values, dtype=dt.to_numpy()).tobytes())


def _compress(buf: bytes, compression: str) -> bytes:
    if compression == "none" or not buf:
        return buf
    from .. import native

    packed = native.lz4_frame_compress(buf)
    return struct.pack("<q", len(buf)) + packed


def _message(b: fb._Builder, header_type: int, header_writer, body_len: int) -> bytes:
    flat = b.finish(lambda: b.table([(0, "h", _V5), (1, "B", header_type),
                                     (2, "off", header_writer), (3, "q", body_len)]))
    flat += bytes(_pad8(len(flat)) - len(flat))
    return CONTINUATION + struct.pack("<i", len(flat)) + flat


def schema_message(schema: Schema) -> bytes:
    b = fb._Builder()
    return _message(b, _MESSAGE_SCHEMA,
                    fb.schema_table(b, [(f.name, f.dtype) for f in schema], {},
                                    arrow_names=True), 0)


def batch_message(batch: RecordBatch, compression: str = "none") -> bytes:
    """One RecordBatch message with its body."""
    if compression == "zstd":
        raise _refuse_zstd()
    if compression not in CODECS:
        raise ValueError(f"Arrow IPC compression must be one of {CODECS}, got {compression!r}")
    nodes: list = []
    raw: list = []
    for col in batch.columns():
        _column(col, nodes, raw)
    body = bytearray()
    spans = []
    for buf in raw:
        data = _compress(buf, compression)
        spans.append((len(body), len(data)))
        body += data
        body += bytes(_pad8(len(body)) - len(body))
    b = fb._Builder()
    node_bytes = b"".join(struct.pack("<qq", length, nulls) for length, nulls in nodes)
    buf_bytes = b"".join(struct.pack("<qq", off, length) for off, length in spans)
    fields = [(0, "q", batch.num_rows),
              (1, "off", lambda: b.struct_vector(len(nodes), node_bytes)),
              (2, "off", lambda: b.struct_vector(len(spans), buf_bytes))]
    if compression != "none":
        fields.append((3, "off", lambda: b.table([(0, "b", _LZ4_FRAME), (1, "b", 0)])))
    return _message(b, _MESSAGE_BATCH, lambda: b.table(fields), len(body)) + bytes(body)


def encode_stream(batches: Iterable[RecordBatch], schema: Schema,
                  compression: str = "none") -> bytes:
    """A whole IPC stream of ``batches`` (each of ``schema``)."""
    out = bytearray(schema_message(schema))
    for batch in batches:
        out += batch_message(batch, compression)
    return bytes(out + END_OF_STREAM)


class StreamWriter:
    """An IPC stream written to a binary file object batch by batch."""

    def __init__(self, sink: BinaryIO, schema: Schema, compression: str = "none"):
        if compression == "zstd":
            raise _refuse_zstd()
        self._sink = sink
        self._compression = compression
        sink.write(schema_message(schema))

    def write(self, batch: RecordBatch) -> None:
        self._sink.write(batch_message(batch, self._compression))

    def close(self) -> None:
        self._sink.write(END_OF_STREAM)

    def __enter__(self) -> "StreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()


# ---- reading -----------------------------------------------------------------------


class _FieldSpec:
    """One Arrow field as the body decoder needs it: the port type and the
    physical layout (the type tag and its table)."""

    __slots__ = ("name", "dtype", "tag", "t", "children")

    def __init__(self, f: "fb._Table"):
        self.name = f.string(0) or ""
        self.tag = f.scalar(2, "B")
        self.t = f.table(3)
        self.children = [_FieldSpec(c) for c in f.tables(5)]
        dtype = fb._field_type(f)
        if dtype is None:
            raise NotImplementedError(f"Arrow field {self.name!r} has a type the port does "
                                      f"not hold (type tag {self.tag})")
        self.dtype = dtype


def _read_schema(msg: "fb._Table") -> List[_FieldSpec]:
    schema = msg.table(2)
    if schema is None:
        raise ValueError("an Arrow Schema message without its schema")
    for f in schema.tables(1):
        if f.table(4) is not None:
            raise NotImplementedError(f"dictionary-encoded Arrow field {f.string(0)!r} is not "
                                      f"read by the port")
    return [_FieldSpec(f) for f in schema.tables(1)]


class _Body:
    """The nodes and buffers of one RecordBatch message, handed out in
    pre-order."""

    def __init__(self, rb: "fb._Table", body: memoryview):
        self.body = body
        n, at = rb.raw_vector(1)
        self.nodes = [struct.unpack_from("<qq", rb.buf, at + 16 * i) for i in range(n)]
        n, at = rb.raw_vector(2)
        self.spans = [struct.unpack_from("<qq", rb.buf, at + 16 * i) for i in range(n)]
        comp = rb.table(3)
        self.codec = None if comp is None else comp.scalar(0, "b")
        if self.codec == _ZSTD:
            raise _refuse_zstd()
        if self.codec not in (None, _LZ4_FRAME):
            raise ValueError(f"unknown Arrow body compression codec {self.codec}")
        self._node = 0
        self._buf = 0

    def node(self) -> Tuple[int, int]:
        if self._node >= len(self.nodes):
            raise ValueError("an Arrow RecordBatch holds fewer field nodes than its schema")
        out = self.nodes[self._node]
        self._node += 1
        return out

    def buffer(self) -> bytes:
        if self._buf >= len(self.spans):
            raise ValueError("an Arrow RecordBatch holds fewer buffers than its schema")
        off, length = self.spans[self._buf]
        self._buf += 1
        if off < 0 or length < 0 or off + length > len(self.body):
            raise ValueError("an Arrow buffer lies outside its message body")
        raw = self.body[off:off + length]
        if self.codec is None or length == 0:
            return bytes(raw)
        if length < 8:
            raise ValueError("a compressed Arrow buffer without its length prefix")
        size = struct.unpack_from("<q", raw, 0)[0]
        if size == -1:
            return bytes(raw[8:])
        from .. import native

        return native.lz4_frame_decompress(raw[8:], size)


def _bits(buf: bytes, n: int) -> np.ndarray:
    if len(buf) * 8 < n:
        raise ValueError("an Arrow bitmap is shorter than its column")
    return np.unpackbits(np.frombuffer(buf, dtype=np.uint8), count=n,
                         bitorder="little").astype(bool)


def _values(buf: bytes, np_dtype, n: int) -> np.ndarray:
    width = np.dtype(np_dtype).itemsize
    if len(buf) < n * width:
        raise ValueError("an Arrow value buffer is shorter than its column")
    return np.frombuffer(buf, dtype=np_dtype, count=n).copy()


def _offsets(buf: bytes, n: int, large: bool) -> np.ndarray:
    return _values(buf, np.int64 if large else np.int32, n + 1).astype(np.int64)


def _fill_nulls(values: np.ndarray, valid: np.ndarray, dtype: DataType) -> np.ndarray:
    if valid.all():
        return values
    fill = np.nan if dtype.is_floating() else 0
    return np.where(valid, values, values.dtype.type(fill))


def _decode(spec: _FieldSpec, body: _Body) -> Series:
    """One column of the body (its nodes and buffers, pre-order)."""
    n, nulls = body.node()
    dt = spec.dtype
    tag = spec.tag
    if tag == fb._NULL:
        return Series.full_null(spec.name, dt, n)
    vbuf = body.buffer()
    valid = _bits(vbuf, n) if nulls else np.ones(n, dtype=bool)
    if nulls and int(n - np.count_nonzero(valid)) != nulls:
        raise ValueError(f"Arrow field {spec.name!r}: null count {nulls} disagrees with "
                         f"its bitmap")
    if tag == fb._BOOL:
        return Series(spec.name, dt, _bits(body.buffer(), n) & valid, valid)
    if tag in (fb._UTF8, fb._LARGE_UTF8, fb._BINARY, fb._LARGE_BINARY):
        off = _offsets(body.buffer(), n, tag in (fb._LARGE_UTF8, fb._LARGE_BINARY))
        data = body.buffer()
        if n and (off[0] < 0 or off[-1] > len(data)):
            raise ValueError(f"Arrow field {spec.name!r}: offsets past its data")
        text = tag in (fb._UTF8, fb._LARGE_UTF8)
        vals = np.empty(n, dtype=object)
        vals[:] = [(data[a:b].decode("utf-8") if text else data[a:b]) if ok else None
                   for a, b, ok in zip(off[:-1].tolist(), off[1:].tolist(), valid.tolist())]
        return Series(spec.name, dt, vals, valid)
    if tag == fb._FIXED_BINARY:
        size = dt.size
        data = body.buffer()
        vals = np.empty(n, dtype=object)
        vals[:] = [data[i * size:(i + 1) * size] if ok else None
                   for i, ok in enumerate(valid.tolist())]
        return Series(spec.name, dt, vals, valid)
    if tag in (fb._LIST, fb._LARGE_LIST, fb._MAP):
        off = _offsets(body.buffer(), n, tag == fb._LARGE_LIST)
        child = _decode(spec.children[0], body)
        return _nested_rows(spec.name, dt, off, child, valid)
    if tag == fb._FIXED_LIST:
        child = _decode(spec.children[0], body)
        return Series.nested(spec.name, dt, None, [child], valid)
    if tag == fb._STRUCT:
        kids = [_decode(c, body) for c in spec.children]
        return Series.nested(spec.name, dt, None, kids, valid)
    buf = body.buffer()
    if tag == fb._INT:
        vals = _values(buf, dt.to_numpy(), n)
    elif tag == fb._FLOAT:
        precision = spec.t.scalar(0, "h") if spec.t is not None else 0
        vals = _values(buf, {0: np.float16, 1: np.float32, 2: np.float64}[precision], n)
        vals = vals.astype(dt.to_numpy())
    elif tag == fb._DATE:
        if spec.t is not None and spec.t.scalar(0, "h", 1) == 1:  # MILLISECOND: date64
            vals = (_values(buf, np.int64, n) // 86_400_000).astype(np.int32)
        else:
            vals = _values(buf, np.int32, n)
    elif tag == fb._TIME:
        width = spec.t.scalar(1, "i", 32) if spec.t is not None else 32
        unit = fb._UNITS[spec.t.scalar(0, "h", 1)] if spec.t is not None else "ms"
        vals = _values(buf, np.int64 if width == 64 else np.int32, n).astype(np.int64)
        vals = vals * {"s": 1_000_000, "ms": 1_000, "us": 1, "ns": 1}[unit]
    elif tag in (fb._TIMESTAMP, fb._DURATION):
        vals = _values(buf, np.int64, n)
    else:
        raise NotImplementedError(f"Arrow type tag {tag} is not read by the port")
    return Series(spec.name, dt, _fill_nulls(vals, valid, dt), valid)


def _nested_rows(name: str, dt: DataType, off: np.ndarray, child: Series,
                 valid: np.ndarray) -> Series:
    """A list or map column from Arrow offsets: rebased to 0, and a null
    row's elements dropped (the port's null list rows are empty)."""
    from ..core.series import _ranges

    lens = np.diff(off)
    if (lens < 0).any() or (len(off) and (off[0] < 0 or off[-1] > len(child))):
        raise ValueError(f"Arrow field {name!r}: offsets out of order or past its child")
    if len(off) and (off[0] != 0 or off[-1] != len(child) or ((~valid) & (lens > 0)).any()):
        lens = np.where(valid, lens, 0)
        child = child.take(_ranges(off[:-1], lens))
        off = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=off[1:])
    return Series.nested(name, dt, off, [child], valid)


def _messages(read) -> Iterator[Tuple["fb._Table", memoryview]]:
    """(Message table, body) of each message until the end of the stream;
    ``read(n)`` gives the next n bytes (fewer at the end)."""
    while True:
        head = read(4)
        if len(head) < 4:
            return  # a stream cut after its last whole message
        if head == CONTINUATION:
            head = read(4)
            if len(head) < 4:
                raise ValueError("an Arrow IPC stream ends inside a message header")
        length = struct.unpack("<i", head)[0]
        if length == 0:
            return
        if length < 0:
            raise ValueError(f"an Arrow IPC message of {length} bytes")
        meta = read(length)
        if len(meta) < length:
            raise ValueError("an Arrow IPC stream ends inside a message")
        msg = fb._Table(meta, struct.unpack_from("<I", meta, 0)[0])
        body_len = msg.scalar(3, "q")
        body = read(body_len) if body_len else b""
        if len(body) < body_len:
            raise ValueError("an Arrow IPC stream ends inside a message body")
        yield msg, memoryview(body)


def _reader(source: Union[bytes, bytearray, memoryview, BinaryIO]):
    if isinstance(source, (bytes, bytearray, memoryview)):
        data = memoryview(source)
        pos = [0]

        def read(n: int) -> bytes:
            out = data[pos[0]:pos[0] + n]
            pos[0] += len(out)
            return bytes(out)
        return read
    return source.read


def _container(read):
    """``read`` positioned at the stream's first message: a file container
    (the ``ARROW1`` magic padded to 8 bytes, the stream's messages up to its
    end marker, then the footer, which is not read) skips its magic; a
    stream gets its first 8 bytes back."""
    head = read(8)
    if head.startswith(FILE_MAGIC):
        return read
    pending = [head]

    def chained(n: int) -> bytes:
        if pending:
            first = pending.pop()
            if len(first) >= n:
                if len(first) > n:
                    pending.append(first[n:])
                return first[:n]
            return first + read(n - len(first))
        return read(n)
    return chained


def read_stream(source) -> Tuple[Schema, Iterator[RecordBatch]]:
    """(schema, batches) of an IPC stream, or of the file container
    (``FILE_MAGIC``), in ``source`` (bytes or a binary file object); the
    batches are decoded as they are pulled."""
    msgs = _messages(_container(_reader(source)))
    first = next(msgs, None)
    if first is None or first[0].scalar(1, "B") != _MESSAGE_SCHEMA:
        raise ValueError("an Arrow IPC stream must start with its Schema message")
    specs = _read_schema(first[0])
    schema = Schema([Field(s.name, s.dtype) for s in specs])

    def batches() -> Iterator[RecordBatch]:
        for msg, body in msgs:
            kind = msg.scalar(1, "B")
            if kind == _MESSAGE_DICTIONARY:
                raise NotImplementedError("Arrow dictionary batches are not read by the port")
            if kind != _MESSAGE_BATCH:
                raise ValueError(f"unexpected Arrow IPC message type {kind}")
            rb = msg.table(2)
            n = rb.scalar(0, "q")
            b = _Body(rb, body)
            cols = [_decode(s, b) for s in specs]
            if any(len(c) != n for c in cols):
                raise ValueError("an Arrow RecordBatch's columns differ from its length")
            yield RecordBatch(schema, cols, n)
    return schema, batches()


def iter_ipc_batches(source) -> Iterator[RecordBatch]:
    """The batches of an IPC stream (the reference's shuffle reader's name)."""
    _schema, batches = read_stream(source)
    yield from batches


def decode_stream(data, schema: Optional[Schema] = None) -> List[RecordBatch]:
    """Every batch of an IPC stream; with ``schema``, each cast onto it (a
    logical column rewrapped from its storage type)."""
    out = []
    for b in iter_ipc_batches(data):
        out.append(b if schema is None else onto_schema(b, schema))
    return out


def onto_schema(batch: RecordBatch, schema: Schema) -> RecordBatch:
    """``batch``'s columns as ``schema``'s types: a column read as its
    storage type takes its logical type back, the rest are cast."""
    cols = []
    for f in schema:
        s = batch.get_column(f.name)
        if s.dtype != f.dtype and f.dtype.is_logical() and s.dtype == f.dtype.storage:
            s = Series(f.name, f.dtype, s._values, s.validity_numpy())
        cols.append(s.cast(f.dtype))
    return RecordBatch(schema, cols, batch.num_rows)
