"""The Thrift compact protocol, as the Parquet footer and page headers use it
(the port's own: the reference reads Parquet through pyarrow).

``read_struct`` parses one struct generically (every field by its wire
type, so a field this module does not know is skipped by its type, as
Thrift requires) and ``decode`` maps the field ids to names through one of
the specs below. ``encode`` writes a struct from a dict of names.

A spec is a list of ``(field id, name, type, sub)``: type is one of
bool, i8, i16, i32, i64, double, binary, string, struct (sub: its spec) or
list (sub: ``(element type, element sub)``). Only the Parquet structures
the port reads or writes are spelled out; the key/value metadata pyarrow
writes (``ARROW:schema`` among it) is parsed as wire values and dropped.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

# compact-protocol wire types
_STOP, _TRUE, _FALSE, _BYTE, _I16, _I32, _I64, _DOUBLE, _BINARY, _LIST, _SET, _MAP, \
    _STRUCT = range(13)

_WIRE = {"bool": _TRUE, "i8": _BYTE, "i16": _I16, "i32": _I32, "i64": _I64,
         "double": _DOUBLE, "binary": _BINARY, "string": _BINARY, "struct": _STRUCT,
         "list": _LIST}


class ThriftError(ValueError):
    pass


# ---- reading ---------------------------------------------------------------------


def _varint(buf, pos: int) -> Tuple[int, int]:
    shift = 0
    out = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated varint")
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7
        if shift > 70:
            raise ThriftError("varint too long")


def _zigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _read_value(buf, pos: int, wire: int):
    if wire == _TRUE:
        return True, pos
    if wire == _FALSE:
        return False, pos
    if wire == _BYTE:
        v = buf[pos]
        return (v - 256 if v > 127 else v), pos + 1
    if wire in (_I16, _I32, _I64):
        v, pos = _varint(buf, pos)
        return _zigzag(v), pos
    if wire == _DOUBLE:
        return struct.unpack_from("<d", buf, pos)[0], pos + 8
    if wire == _BINARY:
        n, pos = _varint(buf, pos)
        if pos + n > len(buf):
            raise ThriftError("truncated binary field")
        return bytes(buf[pos:pos + n]), pos + n
    if wire in (_LIST, _SET):
        head = buf[pos]
        pos += 1
        size, elem = head >> 4, head & 0x0F
        if size == 15:
            size, pos = _varint(buf, pos)
        out = []
        for _ in range(size):
            if elem in (_TRUE, _FALSE):  # a container's bool is one byte: 1 true
                out.append(buf[pos] == _TRUE)
                pos += 1
            else:
                v, pos = _read_value(buf, pos, elem)
                out.append(v)
        return out, pos
    if wire == _MAP:
        size, pos = _varint(buf, pos)
        if size == 0:
            return [], pos
        kinds = buf[pos]
        pos += 1
        kt, vt = kinds >> 4, kinds & 0x0F
        out = []
        for _ in range(size):
            k, pos = _read_value(buf, pos, kt)
            v, pos = _read_value(buf, pos, vt)
            out.append((k, v))
        return out, pos
    if wire == _STRUCT:
        return read_struct(buf, pos)
    raise ThriftError(f"unknown compact-protocol type {wire}")


def read_struct(buf, pos: int = 0) -> Tuple[Dict[int, Any], int]:
    """One struct at ``pos``: ({field id: wire value}, position after it)."""
    out: Dict[int, Any] = {}
    last = 0
    while True:
        if pos >= len(buf):
            raise ThriftError("truncated struct")
        head = buf[pos]
        pos += 1
        wire = head & 0x0F
        if wire == _STOP:
            return out, pos
        delta = head >> 4
        if delta:
            fid = last + delta
        else:
            raw, pos = _varint(buf, pos)
            fid = _zigzag(raw)
        out[fid], pos = _read_value(buf, pos, wire)
        last = fid


def decode(spec, raw: Dict[int, Any]) -> Dict[str, Any]:
    """A parsed struct's known fields by name (unknown field ids dropped)."""
    out: Dict[str, Any] = {}
    for fid, name, kind, sub in spec:
        if fid not in raw:
            continue
        v = raw[fid]
        if kind == "struct":
            v = decode(sub, v)
        elif kind == "list":
            ek, es = sub
            if ek == "struct":
                v = [decode(es, x) for x in v]
            elif ek == "string":
                v = [x.decode("utf-8") for x in v]
        elif kind == "string":
            v = v.decode("utf-8")
        out[name] = v
    return out


# ---- writing ---------------------------------------------------------------------


def _put_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _put_int(out: bytearray, v: int) -> None:
    _put_varint(out, (v << 1) ^ (v >> 63))


def _put_value(out: bytearray, kind: str, sub, v) -> None:
    if kind == "i8":
        out.append(v & 0xFF)
    elif kind in ("i16", "i32", "i64"):
        _put_int(out, int(v))
    elif kind == "double":
        out += struct.pack("<d", v)
    elif kind in ("binary", "string"):
        b = v.encode("utf-8") if isinstance(v, str) else bytes(v)
        _put_varint(out, len(b))
        out += b
    elif kind == "struct":
        encode(sub, v, out)
    elif kind == "list":
        ek, es = sub
        wire = _WIRE[ek]
        if len(v) < 15:
            out.append((len(v) << 4) | wire)
        else:
            out.append(0xF0 | wire)
            _put_varint(out, len(v))
        for x in v:
            if ek == "bool":
                out.append(_TRUE if x else _FALSE)
            else:
                _put_value(out, ek, es, x)
    else:
        raise ThriftError(f"cannot write a {kind}")


def encode(spec, obj: Dict[str, Any], out: bytearray = None) -> bytearray:
    """Append the struct ``obj`` ({name: value}; absent or None fields are
    left out) to ``out`` and return it."""
    out = bytearray() if out is None else out
    last = 0
    for fid, name, kind, sub in spec:
        v = obj.get(name)
        if v is None:
            continue
        wire = (_TRUE if v else _FALSE) if kind == "bool" else _WIRE[kind]
        delta = fid - last
        if 0 < delta <= 15:
            out.append((delta << 4) | wire)
        else:
            out.append(wire)
            _put_int(out, fid)
        if kind != "bool":
            _put_value(out, kind, sub, v)
        last = fid
    out.append(_STOP)
    return out


# ---- the Parquet structures (parquet-format's parquet.thrift) --------------------

STATISTICS = [(1, "max", "binary", None), (2, "min", "binary", None),
              (3, "null_count", "i64", None), (4, "distinct_count", "i64", None),
              (5, "max_value", "binary", None), (6, "min_value", "binary", None)]
INT_TYPE = [(1, "bit_width", "i8", None), (2, "is_signed", "bool", None)]
DECIMAL_TYPE = [(1, "scale", "i32", None), (2, "precision", "i32", None)]
_EMPTY: List = []
# TimeUnit is a union: the field that is set names the unit
TIME_UNIT = [(1, "MILLIS", "struct", _EMPTY), (2, "MICROS", "struct", _EMPTY),
             (3, "NANOS", "struct", _EMPTY)]
TIME_TYPE = [(1, "isAdjustedToUTC", "bool", None), (2, "unit", "struct", TIME_UNIT)]
# LogicalType is a union: the field that is set names the type
LOGICAL_TYPE = [(1, "STRING", "struct", _EMPTY), (2, "MAP", "struct", _EMPTY),
                (3, "LIST", "struct", _EMPTY), (4, "ENUM", "struct", _EMPTY),
                (5, "DECIMAL", "struct", DECIMAL_TYPE), (6, "DATE", "struct", _EMPTY),
                (7, "TIME", "struct", TIME_TYPE), (8, "TIMESTAMP", "struct", TIME_TYPE),
                (10, "INTEGER", "struct", INT_TYPE), (11, "UNKNOWN", "struct", _EMPTY),
                (12, "JSON", "struct", _EMPTY), (13, "BSON", "struct", _EMPTY),
                (14, "UUID", "struct", _EMPTY), (15, "FLOAT16", "struct", _EMPTY)]
SCHEMA_ELEMENT = [(1, "type", "i32", None), (2, "type_length", "i32", None),
                  (3, "repetition_type", "i32", None), (4, "name", "string", None),
                  (5, "num_children", "i32", None), (6, "converted_type", "i32", None),
                  (7, "scale", "i32", None), (8, "precision", "i32", None),
                  (9, "field_id", "i32", None), (10, "logicalType", "struct", LOGICAL_TYPE)]
COLUMN_META_DATA = [(1, "type", "i32", None), (2, "encodings", "list", ("i32", None)),
                    (3, "path_in_schema", "list", ("string", None)),
                    (4, "codec", "i32", None), (5, "num_values", "i64", None),
                    (6, "total_uncompressed_size", "i64", None),
                    (7, "total_compressed_size", "i64", None),
                    (9, "data_page_offset", "i64", None),
                    (10, "index_page_offset", "i64", None),
                    (11, "dictionary_page_offset", "i64", None),
                    (12, "statistics", "struct", STATISTICS)]
COLUMN_CHUNK = [(1, "file_path", "string", None), (2, "file_offset", "i64", None),
                (3, "meta_data", "struct", COLUMN_META_DATA)]
ROW_GROUP = [(1, "columns", "list", ("struct", COLUMN_CHUNK)),
             (2, "total_byte_size", "i64", None), (3, "num_rows", "i64", None),
             (5, "file_offset", "i64", None), (6, "total_compressed_size", "i64", None),
             (7, "ordinal", "i16", None)]
COLUMN_ORDER = [(1, "TYPE_ORDER", "struct", _EMPTY)]
KEY_VALUE = [(1, "key", "string", None), (2, "value", "string", None)]
FILE_META_DATA = [(1, "version", "i32", None),
                  (2, "schema", "list", ("struct", SCHEMA_ELEMENT)),
                  (3, "num_rows", "i64", None),
                  (4, "row_groups", "list", ("struct", ROW_GROUP)),
                  (5, "key_value_metadata", "list", ("struct", KEY_VALUE)),
                  (6, "created_by", "string", None),
                  (7, "column_orders", "list", ("struct", COLUMN_ORDER))]
DATA_PAGE_HEADER = [(1, "num_values", "i32", None), (2, "encoding", "i32", None),
                    (3, "definition_level_encoding", "i32", None),
                    (4, "repetition_level_encoding", "i32", None),
                    (5, "statistics", "struct", STATISTICS)]
DICTIONARY_PAGE_HEADER = [(1, "num_values", "i32", None), (2, "encoding", "i32", None),
                          (3, "is_sorted", "bool", None)]
DATA_PAGE_HEADER_V2 = [(1, "num_values", "i32", None), (2, "num_nulls", "i32", None),
                       (3, "num_rows", "i32", None), (4, "encoding", "i32", None),
                       (5, "definition_levels_byte_length", "i32", None),
                       (6, "repetition_levels_byte_length", "i32", None),
                       (7, "is_compressed", "bool", None),
                       (8, "statistics", "struct", STATISTICS)]
PAGE_HEADER = [(1, "type", "i32", None), (2, "uncompressed_page_size", "i32", None),
               (3, "compressed_page_size", "i32", None), (4, "crc", "i32", None),
               (5, "data_page_header", "struct", DATA_PAGE_HEADER),
               (7, "dictionary_page_header", "struct", DICTIONARY_PAGE_HEADER),
               (8, "data_page_header_v2", "struct", DATA_PAGE_HEADER_V2)]
