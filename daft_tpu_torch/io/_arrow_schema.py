"""The Arrow schema Parquet files carry in their ``ARROW:schema`` key (the
port's own reader and writer of it; the reference's pyarrow reads and
writes it).

The value is a base64 IPC message (0xFFFFFFFF, its length, a flatbuffer
``Message`` whose header is a ``Schema``). pyarrow reads a column's time
zone and a duration's type from it, where the Parquet schema holds only
"adjusted to UTC" and a plain INT64. ``read_arrow_fields`` gives the flat
schema's zone names and durations, ``read_arrow_types`` each field's port
type, nested fields (lists, large lists, fixed-size lists, structs, maps)
and binary included; ``write_arrow_schema`` writes one for a port schema,
nested fields with their children, so pyarrow reads such columns back as
the port wrote them.
"""

from __future__ import annotations

import base64
import struct
from typing import Dict, List, Optional, Tuple

KEY = "ARROW:schema"

# Type union tags (Schema.fbs)
_NULL, _INT, _FLOAT, _UTF8, _BOOL, _DATE, _TIME, _TIMESTAMP = 1, 2, 3, 5, 6, 8, 9, 10
_DURATION, _LARGE_UTF8 = 18, 20
_BINARY, _LIST, _STRUCT, _FIXED_BINARY, _FIXED_LIST, _MAP = 4, 12, 13, 15, 16, 17
_LARGE_BINARY, _LARGE_LIST = 19, 21
_UNITS = ("s", "ms", "us", "ns")  # TimeUnit: SECOND .. NANOSECOND


# ---- reading ---------------------------------------------------------------------------


class _Table:
    def __init__(self, buf: bytes, pos: int):
        self.buf = buf
        self.pos = pos
        vt = pos - struct.unpack_from("<i", buf, pos)[0]
        self.vt = vt
        self.vt_len = struct.unpack_from("<H", buf, vt)[0]

    def _field(self, slot: int) -> int:
        at = 4 + 2 * slot
        if at >= self.vt_len:
            return 0
        return struct.unpack_from("<H", self.buf, self.vt + at)[0]

    def scalar(self, slot: int, fmt: str, default=0):
        off = self._field(slot)
        return default if not off else struct.unpack_from("<" + fmt, self.buf, self.pos + off)[0]

    def _target(self, slot: int) -> Optional[int]:
        off = self._field(slot)
        if not off:
            return None
        at = self.pos + off
        return at + struct.unpack_from("<I", self.buf, at)[0]

    def table(self, slot: int) -> Optional["_Table"]:
        t = self._target(slot)
        return None if t is None else _Table(self.buf, t)

    def string(self, slot: int) -> Optional[str]:
        t = self._target(slot)
        if t is None:
            return None
        n = struct.unpack_from("<I", self.buf, t)[0]
        return self.buf[t + 4:t + 4 + n].decode("utf-8")

    def raw_vector(self, slot: int) -> Tuple[int, int]:
        """(element count, position of the first element) of a vector of
        structs; (0, 0) when absent."""
        t = self._target(slot)
        if t is None:
            return 0, 0
        return struct.unpack_from("<I", self.buf, t)[0], t + 4

    def tables(self, slot: int) -> List["_Table"]:
        t = self._target(slot)
        if t is None:
            return []
        n = struct.unpack_from("<I", self.buf, t)[0]
        out = []
        for k in range(n):
            at = t + 4 + 4 * k
            out.append(_Table(self.buf, at + struct.unpack_from("<I", self.buf, at)[0]))
        return out


def read_arrow_fields(value: str) -> Dict[str, Tuple[str, Optional[str], Optional[str]]]:
    """{column name: (kind, unit, zone)} of the flat schema's timestamp and
    duration fields ("timestamp" with its zone, "duration" with its unit);
    {} for a value it cannot read."""
    try:
        raw = base64.b64decode(value)
        if raw[:4] == b"\xff\xff\xff\xff":  # the continuation marker and length
            raw = raw[8:]
        msg = _Table(raw, struct.unpack_from("<I", raw, 0)[0])
        if msg.scalar(1, "B") != 1:  # header_type Schema
            return {}
        schema = msg.table(2)
        out = {}
        for f in schema.tables(1) if schema is not None else []:
            name = f.string(0)
            tag = f.scalar(2, "B")
            t = f.table(3)
            if name is None or t is None:
                continue
            if tag == _TIMESTAMP:
                out[name] = ("timestamp", _UNITS[t.scalar(0, "h")], t.string(1))
            elif tag == _DURATION:
                # Duration.unit defaults to MILLISECOND (Schema.fbs)
                out[name] = ("duration", _UNITS[t.scalar(0, "h", 1)], None)
        return out
    except (ValueError, IndexError, struct.error, UnicodeDecodeError):
        return {}


def _field_type(f: _Table):
    """The port DataType of one Arrow field table (None where the port has
    no such type)."""
    from ..datatype import DataType

    tag = f.scalar(2, "B")
    t = f.table(3)
    kids = [_field_type(c) for c in f.tables(5)]
    if tag == _NULL:
        return DataType.null()
    if tag == _BOOL:
        return DataType.bool()
    if tag == _INT and t is not None:
        width, signed = t.scalar(0, "i"), t.scalar(1, "?")
        return DataType(("int" if signed else "uint") + str(width))
    if tag == _FLOAT and t is not None:
        return DataType.float32() if t.scalar(0, "h") <= 1 else DataType.float64()
    if tag in (_UTF8, _LARGE_UTF8):
        return DataType.string()
    if tag in (_BINARY, _LARGE_BINARY):
        return DataType.binary()
    if tag == _FIXED_BINARY and t is not None:
        return DataType.fixed_size_binary(t.scalar(0, "i"))
    if tag == _DATE:
        return DataType.date()
    if tag == _TIME and t is not None:
        unit = _UNITS[t.scalar(0, "h", 1)]
        return DataType.time("ns" if unit == "ns" else "us")
    if tag == _TIMESTAMP and t is not None:
        return DataType.timestamp(_UNITS[t.scalar(0, "h")], t.string(1))
    if tag == _DURATION:
        return DataType.duration(_UNITS[t.scalar(0, "h", 1) if t is not None else 1])
    if None in kids:
        return None
    if tag in (_LIST, _LARGE_LIST) and len(kids) == 1:
        return DataType.list(kids[0])
    if tag == _FIXED_LIST and len(kids) == 1 and t is not None:
        return DataType.fixed_size_list(kids[0], t.scalar(0, "i"))
    if tag == _STRUCT:
        return DataType.struct([(c.string(0), k) for c, k in zip(f.tables(5), kids)])
    if tag == _MAP and len(kids) == 1 and kids[0].kind == "struct" \
            and len(kids[0].struct_fields) == 2:
        (_k, kt), (_v, vt) = kids[0].struct_fields
        return DataType.map(kt, vt)
    return None


def read_arrow_types(value: str) -> dict:
    """{column name: port DataType} of the schema's top-level fields the
    port has a type for; {} for a value it cannot read."""
    try:
        raw = base64.b64decode(value)
        if raw[:4] == b"\xff\xff\xff\xff":
            raw = raw[8:]
        msg = _Table(raw, struct.unpack_from("<I", raw, 0)[0])
        if msg.scalar(1, "B") != 1:
            return {}
        schema = msg.table(2)
        out = {}
        for f in schema.tables(1) if schema is not None else []:
            dt = _field_type(f)
            if f.string(0) is not None and dt is not None:
                out[f.string(0)] = dt
        return out
    except (ValueError, IndexError, struct.error, UnicodeDecodeError):
        return {}


# ---- writing ---------------------------------------------------------------------------


class _Builder:
    """A flatbuffer written front to back: every table, string and vector
    lies after what refers to it (uoffsets point forward); each table's
    vtable sits just before it."""

    def __init__(self):
        self.buf = bytearray(4)  # the root offset, patched last

    def _align(self, n: int) -> None:
        while len(self.buf) % n:
            self.buf.append(0)

    def table(self, fields) -> int:
        """fields: (slot, format, value); format "off" takes a function that
        writes the child and returns its position."""
        layout, size = [], 4
        for slot, fmt, val in fields:
            sz = 4 if fmt == "off" else struct.calcsize("<" + fmt)
            size = (size + sz - 1) // sz * sz
            layout.append((slot, fmt, val, size))
            size += sz
        size = (size + 3) // 4 * 4
        nslots = max((s for s, _f, _v in fields), default=-1) + 1
        slots = [0] * nslots
        for slot, _fmt, _val, off in layout:
            slots[slot] = off
        self._align(2)
        vt = len(self.buf)
        self.buf += struct.pack(f"<HH{nslots}H", 4 + 2 * nslots, size, *slots)
        self._align(8)
        pos = len(self.buf)
        self.buf += bytes(size)
        struct.pack_into("<i", self.buf, pos, pos - vt)
        for _slot, fmt, val, off in layout:
            if fmt != "off":
                struct.pack_into("<" + fmt, self.buf, pos + off, val)
        for _slot, fmt, val, off in layout:
            if fmt == "off":
                child = val()
                struct.pack_into("<I", self.buf, pos + off, child - (pos + off))
        return pos

    def string(self, s: str) -> int:
        self._align(4)
        pos = len(self.buf)
        b = s.encode("utf-8")
        self.buf += struct.pack("<I", len(b)) + b + b"\0"
        return pos

    def vector(self, writers) -> int:
        self._align(4)
        pos = len(self.buf)
        self.buf += struct.pack("<I", len(writers)) + bytes(4 * len(writers))
        for k, w in enumerate(writers):
            at = pos + 4 + 4 * k
            child = w()
            struct.pack_into("<I", self.buf, at, child - at)
        return pos

    def struct_vector(self, count: int, raw: bytes) -> int:
        """A vector of ``count`` structs whose bytes are ``raw``, its data
        8-byte aligned (Arrow's FieldNode and Buffer structs hold int64s)."""
        while (len(self.buf) + 4) % 8:
            self.buf.append(0)
        pos = len(self.buf)
        self.buf += struct.pack("<I", count) + raw
        return pos

    def finish(self, root_writer) -> bytes:
        root = root_writer()
        struct.pack_into("<I", self.buf, 0, root)
        self._align(8)
        return bytes(self.buf)


def _type_of(dtype) -> Tuple[int, list]:
    """(union tag, the type table's fields) of a port dtype."""
    kind = dtype.kind
    if kind == "null":
        return _NULL, []
    if kind == "bool":
        return _BOOL, []
    if dtype.is_integer():
        return _INT, [(0, "i", int(kind[kind.index("t") + 1:])),
                      (1, "?", dtype.is_signed_integer())]
    if kind in ("float32", "float64"):
        return _FLOAT, [(0, "h", 1 if kind == "float32" else 2)]
    if kind == "string":
        return _LARGE_UTF8, []
    if kind == "binary":
        return _LARGE_BINARY, []
    if kind == "fixed_size_binary":
        return _FIXED_BINARY, [(0, "i", dtype.size)]
    if kind == "list":
        return _LARGE_LIST, []
    if kind == "fixed_size_list":
        return _FIXED_LIST, [(0, "i", dtype.size)]
    if kind == "struct":
        return _STRUCT, []
    if kind == "map":
        return _MAP, [(0, "?", False)]
    if kind == "date":
        return _DATE, [(0, "h", 0)]
    if kind == "time":
        unit = dtype.storage_unit
        return _TIME, [(0, "h", _UNITS.index(unit)), (1, "i", 64)]
    if kind == "timestamp":
        fields = [(0, "h", _UNITS.index(dtype.time_unit))]
        if dtype.timezone is not None:
            fields.append((1, "str", dtype.timezone))
        return _TIMESTAMP, fields
    if kind == "duration":
        return _DURATION, [(0, "h", _UNITS.index(dtype.time_unit))]
    raise ValueError(f"no Arrow type for {dtype}")


def schema_table(b: "_Builder", fields, units: Dict[str, str], arrow_names: bool = False):
    """A writer of the ``Schema`` table of ``fields`` ((name, dtype) pairs)
    on ``b``. ``units``: the unit each timestamp column is written in.
    Child fields are named as the Parquet schema names them ("element",
    "key_value"), or, with ``arrow_names``, as pyarrow names them ("item",
    "entries"; io/arrow_ipc.py), and a logical type is written as its
    storage type."""
    from ..datatype import DataType

    def type_writer(dtype):
        tag, tfields = _type_of(dtype)
        out = [(slot, "off", lambda v=v: b.string(v)) if fmt == "str" else (slot, fmt, v)
               for slot, fmt, v in tfields]
        return tag, (lambda: b.table(out))

    def children(dtype):
        """(name, dtype, nullable) of a nested type's child fields."""
        k = dtype.kind
        if k in ("list", "fixed_size_list"):
            return [("item" if arrow_names else "element", dtype.inner, True)]
        if k == "struct":
            return [(n, t, True) for n, t in dtype.struct_fields]
        if k == "map":
            return [("entries" if arrow_names else "key_value", dtype.map_entry, False)]
        return []

    def field_writer(name, dtype, nullable=True, entry_key=False):
        if arrow_names:
            dtype = dtype.storage
        if dtype.kind == "timestamp" and name in units:
            dtype = DataType.timestamp(units[name], dtype.timezone)
        tag, tw = type_writer(dtype)
        kids = children(dtype)
        if dtype.kind == "struct" and entry_key:  # a map's entries: a required key
            kid_writers = [field_writer(n, t, i != 0) for i, (n, t, _o) in enumerate(kids)]
        else:
            kid_writers = [field_writer(n, t, o, dtype.kind == "map") for n, t, o in kids]
        return lambda: b.table([(0, "off", lambda: b.string(name)), (1, "?", nullable),
                                (2, "B", tag), (3, "off", tw),
                                (5, "off", lambda: b.vector(kid_writers))])

    return lambda: b.table([(0, "h", 0),
                            (1, "off", lambda: b.vector([field_writer(n, t)
                                                         for n, t in fields]))])


def write_arrow_schema(schema, units: Dict[str, str]) -> str:
    """The ``ARROW:schema`` value of a flat port schema; ``units`` names the
    unit each timestamp column is written in (a seconds column is written
    in milliseconds, and the Arrow type says what the file holds)."""
    b = _Builder()
    schema_writer = schema_table(b, [(f.name, f.dtype) for f in schema], units)

    def message_writer():
        return b.table([(0, "h", 4), (1, "B", 1), (2, "off", schema_writer), (3, "q", 0)])

    flat = b.finish(message_writer)
    return base64.b64encode(b"\xff\xff\xff\xff" + struct.pack("<i", len(flat)) + flat) \
        .decode("ascii")
