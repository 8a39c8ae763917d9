"""The Parquet file format for flat columns (the port's own; the reference
reads and writes Parquet through pyarrow).

Reading: the footer framed by ``PAR1`` (``read_footer``), the flat schema
mapped to the port's dtypes as the reference's ``read_parquet`` types them
(``column_info``), and each column chunk's pages (``read_column_chunk``):
dictionary pages, data pages v1 and v2, the PLAIN, RLE/bit-packed hybrid,
PLAIN_DICTIONARY and RLE_DICTIONARY encodings, a chunk that begins
dictionary-encoded and falls back to PLAIN pages, and at most one
definition level. Writing: ``write_file`` writes row groups of flat
columns, strings dictionary-encoded (PLAIN past a 1 MiB dictionary), each
chunk with its statistics (``min_value`` / ``max_value``, ``null_count``),
data page v1, at most about 1 MiB of values a page.

Physical and logical types: BOOLEAN; INT32 plain, INT(8/16/32) signed or
unsigned, and DATE (int32 days); INT64 signed or unsigned; FLOAT; DOUBLE;
BYTE_ARRAY annotated STRING/UTF8. Anything else (nested or repeated
columns, DECIMAL, timestamps, times, INT96, fixed-length or unannotated
binary columns, the DELTA_* and BYTE_STREAM_SPLIT encodings) raises
NotImplementedError naming it: never a wrong read. Values decode with numpy;
only BYTE_ARRAY values take a Python loop, one step a value.
"""

from __future__ import annotations

import dataclasses
import math
import os
import struct
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ..core.series import Series
from ..datatype import DataType
from . import _thrift as th
from .codecs import compress, decompress

MAGIC = b"PAR1"

# physical types
BOOLEAN, INT32, INT64, INT96, FLOAT, DOUBLE, BYTE_ARRAY, FIXED_LEN_BYTE_ARRAY = range(8)
TYPE_NAMES = ("BOOLEAN", "INT32", "INT64", "INT96", "FLOAT", "DOUBLE", "BYTE_ARRAY",
              "FIXED_LEN_BYTE_ARRAY")
# encodings
PLAIN, PLAIN_DICTIONARY, RLE, RLE_DICTIONARY = 0, 2, 3, 8
ENCODING_NAMES = {0: "PLAIN", 2: "PLAIN_DICTIONARY", 3: "RLE", 4: "BIT_PACKED",
                  5: "DELTA_BINARY_PACKED", 6: "DELTA_LENGTH_BYTE_ARRAY",
                  7: "DELTA_BYTE_ARRAY", 8: "RLE_DICTIONARY", 9: "BYTE_STREAM_SPLIT"}
# page types
DATA_PAGE, INDEX_PAGE, DICTIONARY_PAGE, DATA_PAGE_V2 = range(4)
# repetition
REQUIRED, OPTIONAL, REPEATED = range(3)
# converted types (legacy annotations)
_UTF8, _DECIMAL, _DATE = 0, 5, 6
_CONVERTED_INT = {15: (8, True), 16: (16, True), 17: (32, True), 18: (64, True),
                  11: (8, False), 12: (16, False), 13: (32, False), 14: (64, False)}
_CONVERTED_NAMES = {1: "MAP", 2: "MAP_KEY_VALUE", 3: "LIST", 4: "ENUM", 5: "DECIMAL",
                    7: "TIME_MILLIS", 8: "TIME_MICROS", 9: "TIMESTAMP_MILLIS",
                    10: "TIMESTAMP_MICROS", 19: "JSON", 20: "BSON", 21: "INTERVAL"}

PAGE_TARGET_BYTES = 1 << 20      # values per data page, about (pyarrow's default)
DICTIONARY_LIMIT_BYTES = 1 << 20  # a larger string dictionary falls back to PLAIN
ROW_GROUP_ROWS = 1 << 20          # pyarrow's default row group size


def _unsupported(what: str) -> NotImplementedError:
    return NotImplementedError(f"Parquet {what} is not supported by the port")


# ---- schema ------------------------------------------------------------------------


@dataclasses.dataclass
class ColumnInfo:
    name: str
    physical: int
    dtype: DataType
    max_def: int  # 0 (REQUIRED) or 1 (OPTIONAL)


def _port_dtype(el: Dict[str, Any]) -> DataType:
    name = el.get("name")
    t = el.get("type")
    conv = el.get("converted_type")
    logical = el.get("logicalType") or {}
    for kind in ("DECIMAL", "TIMESTAMP", "TIME", "JSON", "BSON", "UUID", "ENUM", "FLOAT16",
                 "UNKNOWN", "MAP", "LIST"):
        if kind in logical:
            raise _unsupported(f"logical type {kind} (column {name!r})")
    if conv in _CONVERTED_NAMES:
        raise _unsupported(f"converted type {_CONVERTED_NAMES[conv]} (column {name!r})")
    if t == BOOLEAN:
        return DataType.bool()
    if t in (INT32, INT64):
        if t == INT32 and ("DATE" in logical or conv == _DATE):
            return DataType.date()
        width, signed = 32 if t == INT32 else 64, True
        if "INTEGER" in logical:
            width = logical["INTEGER"].get("bit_width", width)
            signed = logical["INTEGER"].get("is_signed", True)
        elif conv in _CONVERTED_INT:
            width, signed = _CONVERTED_INT[conv]
        if (width == 64) != (t == INT64):
            raise _unsupported(f"{width}-bit integer in {TYPE_NAMES[t]} (column {name!r})")
        return DataType(("int" if signed else "uint") + str(width))
    if t == FLOAT:
        return DataType.float32()
    if t == DOUBLE:
        return DataType.float64()
    if t == BYTE_ARRAY:
        if "STRING" in logical or conv == _UTF8:
            return DataType.string()
        raise _unsupported(f"BYTE_ARRAY column {name!r} without a STRING annotation "
                           "(binary)")
    if t in (INT96, FIXED_LEN_BYTE_ARRAY):
        raise _unsupported(f"physical type {TYPE_NAMES[t]} (column {name!r})")
    raise _unsupported(f"physical type {t} (column {name!r})")


def column_info(schema: List[Dict[str, Any]]) -> List[ColumnInfo]:
    """The leaf columns of a flat schema (the root's direct children)."""
    if not schema:
        raise ValueError("Parquet footer has no schema")
    cols = []
    for el in schema[1:]:
        name = el.get("name")
        if el.get("num_children"):
            raise _unsupported(f"nested column {name!r}")
        rep = el.get("repetition_type", REQUIRED)
        if rep == REPEATED:
            raise _unsupported(f"repeated column {name!r} (repetition levels)")
        cols.append(ColumnInfo(name, el.get("type"), _port_dtype(el),
                               1 if rep == OPTIONAL else 0))
    if len(cols) != (schema[0].get("num_children") or 0):
        raise _unsupported("schema whose root children are not its leaves (nested)")
    return cols


@dataclasses.dataclass
class Footer:
    meta: Dict[str, Any]
    columns: List[ColumnInfo]

    @property
    def num_rows(self) -> int:
        return int(self.meta.get("num_rows", 0))

    @property
    def row_groups(self) -> List[Dict[str, Any]]:
        return self.meta.get("row_groups", [])

    def chunk(self, rg: Dict[str, Any], name: str) -> Dict[str, Any]:
        """The ColumnMetaData of column ``name`` in row group ``rg``."""
        for c in rg["columns"]:
            md = c.get("meta_data") or {}
            if md.get("path_in_schema", [None])[0] == name:
                return md
        raise KeyError(f"column {name!r} not in the row group")


_FOOTERS: Dict[tuple, Footer] = {}  # (path, size, mtime_ns) -> footer


def read_footer(path: str) -> Footer:
    """The file's parsed footer; kept per (path, size, modification time),
    so planning a query (row estimates, pruning, the split) reads each
    footer once and a rewritten file is read again."""
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_size, st.st_mtime_ns)
    footer = _FOOTERS.get(key)
    if footer is None:
        if len(_FOOTERS) >= 4096:
            _FOOTERS.clear()
        footer = _FOOTERS[key] = _parse_footer(path, st.st_size)
    return footer


def _parse_footer(path: str, size: int) -> Footer:
    with open(path, "rb") as f:
        if size < 12:
            raise ValueError(f"{path}: too small to be a Parquet file")
        f.seek(size - 8)
        tail = f.read(8)
        if tail[4:] != MAGIC:
            raise ValueError(f"{path}: not a Parquet file (no PAR1 footer)")
        n = struct.unpack("<I", tail[:4])[0]
        if n + 12 > size:
            raise ValueError(f"{path}: footer length {n} past the file")
        f.seek(size - 8 - n)
        raw, _ = th.read_struct(f.read(n), 0)
    meta = th.decode(th.FILE_META_DATA, raw)
    return Footer(meta, column_info(meta.get("schema", [])))


# ---- RLE / bit-packed hybrid -------------------------------------------------------


def unpack_bits(data, bit_width: int, count: int) -> np.ndarray:
    """``count`` little-endian bit-packed values of ``bit_width`` bits."""
    if bit_width == 0:
        return np.zeros(count, dtype=np.int64)
    raw = np.frombuffer(data, dtype=np.uint8)
    bits = np.unpackbits(raw, bitorder="little")
    if bit_width == 1:
        return bits[:count].astype(np.int64)
    n = min(count, len(bits) // bit_width)
    bits = bits[:n * bit_width].reshape(n, bit_width)
    out = np.zeros(n, dtype=np.int64)
    for k in range(bit_width):
        out |= bits[:, k].astype(np.int64) << k
    return out


def decode_hybrid(buf, pos: int, end: int, bit_width: int, count: int) -> np.ndarray:
    """``count`` values of the RLE/bit-packed hybrid in ``buf[pos:end]``.
    A bit-packed run padded to a multiple of 8 yields no extra values."""
    if bit_width == 0:
        return np.zeros(count, dtype=np.int64)
    vbytes = (bit_width + 7) // 8
    runs: List[Tuple[bool, Any, int]] = []  # (packed, payload, values)
    packed: List[bytes] = []
    got = 0
    while got < count:
        if pos >= end:
            raise ValueError("RLE/bit-packed data ends before its values")
        h, pos = th._varint(buf, pos)
        if h & 1:
            groups = h >> 1
            nb = groups * bit_width
            packed.append(bytes(buf[pos:pos + nb]))
            runs.append((True, None, groups * 8))
            pos += nb
            got += groups * 8
        else:
            n = h >> 1
            runs.append((False, int.from_bytes(bytes(buf[pos:pos + vbytes]), "little"), n))
            pos += vbytes
            got += n
    if len(runs) == 1 and not runs[0][0]:
        return np.full(count, runs[0][1], dtype=np.int64)
    bp = unpack_bits(b"".join(packed), bit_width, sum(n for p, _, n in runs if p)) \
        if packed else None
    out = np.empty(got, dtype=np.int64)
    o = b = 0
    for is_packed, value, n in runs:
        if is_packed:
            out[o:o + n] = bp[b:b + n]
            b += n
        else:
            out[o:o + n] = value
        o += n
    return out[:count]


def encode_hybrid(values: np.ndarray, bit_width: int) -> bytes:
    """The hybrid encoding of ``values``: one RLE run when they are all
    equal, else one bit-packed run (zero-padded to a multiple of 8)."""
    n = len(values)
    out = bytearray()
    if n and (values == values[0]).all():
        th._put_varint(out, n << 1)
        out += int(values[0]).to_bytes((bit_width + 7) // 8, "little")
        return bytes(out)
    groups = (n + 7) // 8
    th._put_varint(out, (groups << 1) | 1)
    v = np.zeros(groups * 8, dtype=np.uint64)
    v[:n] = values
    if bit_width == 1:
        bits = v.astype(np.uint8)
    else:
        shifts = np.arange(bit_width, dtype=np.uint64)
        bits = ((v[:, None] >> shifts) & np.uint64(1)).astype(np.uint8).ravel()
    out += np.packbits(bits, bitorder="little").tobytes()
    return bytes(out)


# ---- values ------------------------------------------------------------------------

_NUMPY_PHYSICAL = {INT32: "<i4", INT64: "<i8", FLOAT: "<f4", DOUBLE: "<f8"}


def decode_plain(data, pos: int, physical: int, count: int):
    """``count`` PLAIN values at ``pos``: (values, position after them)."""
    if physical == BOOLEAN:
        nb = (count + 7) // 8
        raw = np.frombuffer(data, dtype=np.uint8, count=nb, offset=pos)
        return np.unpackbits(raw, bitorder="little")[:count].astype(bool), pos + nb
    if physical in _NUMPY_PHYSICAL:
        dt = np.dtype(_NUMPY_PHYSICAL[physical])
        return np.frombuffer(data, dtype=dt, count=count, offset=pos), \
            pos + count * dt.itemsize
    if physical == BYTE_ARRAY:
        out = np.empty(count, dtype=object)
        mv = memoryview(data)
        unpack = struct.Struct("<I").unpack_from
        for i in range(count):
            n = unpack(data, pos)[0]
            pos += 4
            out[i] = str(mv[pos:pos + n], "utf-8")
            pos += n
        return out, pos
    raise _unsupported(f"PLAIN values of physical type {TYPE_NAMES[physical]}")


def _dictionary_indices(data, pos: int, col: ColumnInfo, count: int, dictionary):
    """The dictionary indices of a dictionary-encoded page's values."""
    if dictionary is None:
        raise ValueError(f"column {col.name!r}: dictionary-encoded page with no "
                         "dictionary page")
    bw = data[pos]
    idx = decode_hybrid(data, pos + 1, len(data), bw, count)
    if count and (idx.max() >= len(dictionary) or idx.min() < 0):
        raise ValueError(f"column {col.name!r}: dictionary index out of range")
    return idx


def _decode_values(data, pos: int, encoding: int, col: ColumnInfo, count: int):
    if encoding == PLAIN:
        return decode_plain(data, pos, col.physical, count)[0]
    if encoding == RLE and col.physical == BOOLEAN:
        n = struct.unpack_from("<I", data, pos)[0]
        return decode_hybrid(data, pos + 4, pos + 4 + n, 1, count).astype(bool)
    raise _unsupported(f"encoding {ENCODING_NAMES.get(encoding, encoding)} "
                       f"(column {col.name!r})")


def _to_port(values: np.ndarray, col: ColumnInfo) -> np.ndarray:
    """Physical values as the port's storage dtype of ``col``."""
    kind = col.dtype.kind
    if kind in ("string", "bool", "date", "int32", "int64", "float32", "float64"):
        return values
    if kind == "uint64":
        return values.view(np.uint64)
    if kind.startswith("uint"):
        return values.view(np.uint32).astype(col.dtype.to_numpy())
    return values.astype(col.dtype.to_numpy())


def read_column_chunk(f, md: Dict[str, Any], col: ColumnInfo, name: str = "") -> Series:
    """The Series of one column chunk (``md``: its ColumnMetaData), read
    from the open file ``f``."""
    codec = md.get("codec", 0)
    start = md["data_page_offset"]
    dict_off = md.get("dictionary_page_offset")
    if dict_off is not None and 0 < dict_off < start:
        start = dict_off
    f.seek(start)
    raw = f.read(md["total_compressed_size"])
    total = md["num_values"]
    pos = 0
    dictionary = None
    values: List[np.ndarray] = []
    valid: List[np.ndarray] = []
    indices: List[Optional[np.ndarray]] = []  # per page; None: not dictionary-encoded
    seen = 0
    while seen < total:
        if pos >= len(raw):
            raise ValueError(f"column {col.name!r}: chunk ends after {seen} of {total} values")
        hraw, pos = th.read_struct(raw, pos)
        ph = th.decode(th.PAGE_HEADER, hraw)
        size = ph["compressed_page_size"]
        page = raw[pos:pos + size]
        pos += size
        kind = ph["type"]
        if kind == DICTIONARY_PAGE:
            dh = ph.get("dictionary_page_header") or {}
            if dh.get("encoding", PLAIN) not in (PLAIN, PLAIN_DICTIONARY):
                raise _unsupported(f"dictionary page encoding "
                                   f"{ENCODING_NAMES.get(dh.get('encoding'))}")
            data = decompress(codec, page, ph["uncompressed_page_size"])
            dictionary = _to_port(decode_plain(data, 0, col.physical,
                                               dh.get("num_values", 0))[0], col)
            continue
        if kind == DATA_PAGE:
            dh = ph["data_page_header"]
            n = dh["num_values"]
            data = decompress(codec, page, ph["uncompressed_page_size"])
            p = 0
            if col.max_def:
                if dh.get("definition_level_encoding", RLE) != RLE:
                    raise _unsupported("definition levels encoded "
                                       + ENCODING_NAMES.get(dh["definition_level_encoding"],
                                                            "?"))
                ln = struct.unpack_from("<I", data, 0)[0]
                defs = decode_hybrid(data, 4, 4 + ln, 1, n)
                p = 4 + ln
            encoding = dh["encoding"]
        elif kind == DATA_PAGE_V2:
            dh = ph["data_page_header_v2"]
            n = dh["num_values"]
            rl = dh.get("repetition_levels_byte_length", 0)
            dl = dh.get("definition_levels_byte_length", 0)
            if rl:
                raise _unsupported(f"repetition levels (column {col.name!r})")
            if col.max_def:
                defs = decode_hybrid(page, 0, dl, 1, n)  # levels are never compressed
            body = page[rl + dl:]
            if dh.get("is_compressed", True):
                body = decompress(codec, body, ph["uncompressed_page_size"] - rl - dl)
            data, p = body, 0
            encoding = dh["encoding"]
        else:  # an index page: nothing to read
            continue
        ok = defs == 1 if col.max_def else None
        nvals = n if ok is None else int(ok.sum())
        if encoding in (PLAIN_DICTIONARY, RLE_DICTIONARY):
            idx = _dictionary_indices(data, p, col, nvals, dictionary)
            values.append(dictionary[idx])  # the dictionary is converted already
        else:
            idx = None
            values.append(_to_port(_decode_values(data, p, encoding, col, nvals), col))
        indices.append(idx)
        valid.append(np.ones(n, dtype=bool) if ok is None else ok)
        seen += n
    out = _assemble(name or col.name, col.dtype, values, valid, total)
    if col.dtype.is_string() and indices and all(i is not None for i in indices):
        attach_dictionary_codes(out, dictionary, np.concatenate(indices))
    return out


def attach_dictionary_codes(s: Series, dictionary: np.ndarray, idx: np.ndarray) -> None:
    """Give a string Series read from dictionary-encoded pages its
    ``dict_codes`` (first-occurrence codes, null its own) from the pages'
    indices, so a grouped stage need not factorize its strings again. Only
    for a dictionary of distinct values (a repeated entry would split one
    group in two). The codes are kept raw; ``dict_codes`` renumbers them
    by first occurrence when a stage asks."""
    k = len(dictionary)
    if k > 1 << 16 or len(set(dictionary.tolist())) != k:
        return
    full = np.full(len(s), k, dtype=np.int32)  # k: the null code
    full[s.validity_numpy()] = idx
    s._dict_codes = ("raw", full, dictionary.tolist() + [None])


def _assemble(name: str, dtype: DataType, values, valid, total: int) -> Series:
    mask = np.concatenate(valid) if valid else np.zeros(0, dtype=bool)
    np_dt = dtype.to_numpy()
    vals = np.concatenate(values) if values else np.zeros(0, dtype=np_dt)
    if len(mask) != total:
        raise ValueError(f"column {name!r}: {len(mask)} values read, {total} declared")
    if len(vals) == total:
        out = vals if vals.dtype == np_dt else vals.astype(np_dt)
    else:
        from ..core.series import _null_fill

        fill = _null_fill(dtype)
        out = np.empty(total, dtype=np_dt)
        if dtype.is_string():
            out[:] = None
        else:
            out[:] = fill
        out[mask] = vals
    return Series(name, dtype, out, mask)


# ---- statistics --------------------------------------------------------------------


def decode_stat(raw: Optional[bytes], col: ColumnInfo):
    """A min_value / max_value as a Python value comparable with the port's
    literal storage values (dates as int32 days), or None where it cannot
    serve a zone map (absent, NaN, undecodable)."""
    if raw is None:
        return None
    kind = col.dtype.kind
    try:
        if col.physical == BOOLEAN:
            return bool(raw[0])
        if col.physical in (INT32, INT64):
            return int.from_bytes(raw, "little", signed=not kind.startswith("uint"))
        if col.physical in (FLOAT, DOUBLE):
            v = struct.unpack("<f" if col.physical == FLOAT else "<d", raw)[0]
            return None if math.isnan(v) else v
        if col.physical == BYTE_ARRAY:
            return raw.decode("utf-8")
    except (ValueError, IndexError, struct.error, UnicodeDecodeError):
        return None
    return None


def _encode_stat(v, col: ColumnInfo) -> bytes:
    if col.physical == BOOLEAN:
        return bytes([1 if v else 0])
    if col.physical == INT32:
        return int(v).to_bytes(4, "little", signed=not col.dtype.kind.startswith("uint"))
    if col.physical == INT64:
        return int(v).to_bytes(8, "little", signed=not col.dtype.kind.startswith("uint"))
    if col.physical == FLOAT:
        return struct.pack("<f", v)
    if col.physical == DOUBLE:
        return struct.pack("<d", v)
    return v.encode("utf-8")


def _chunk_statistics(vals: np.ndarray, col: ColumnInfo, nulls: int,
                      dictionary=None) -> Dict[str, Any]:
    out: Dict[str, Any] = {"null_count": nulls}
    src = dictionary if dictionary is not None else vals
    if col.physical in (FLOAT, DOUBLE):
        src = src[~np.isnan(src)]
    if not len(src):
        return out
    if col.dtype.is_string():
        lo, hi = min(src), max(src)
    else:
        lo, hi = src.min(), src.max()
        if col.physical in (FLOAT, DOUBLE):
            lo = -0.0 if lo == 0 else lo  # the spec's zero signs for float bounds
            hi = 0.0 if hi == 0 else hi
    out["min_value"] = _encode_stat(lo, col)
    out["max_value"] = _encode_stat(hi, col)
    return out


# ---- writing -----------------------------------------------------------------------


def _physical_for(dtype: DataType) -> Tuple[int, Dict[str, Any]]:
    """(physical type, the schema element's annotations) of a port dtype."""
    kind = dtype.kind
    if kind == "bool":
        return BOOLEAN, {}
    if kind == "date":
        return INT32, {"converted_type": _DATE, "logicalType": {"DATE": {}}}
    if kind in ("float32", "float64"):
        return (FLOAT if kind == "float32" else DOUBLE), {}
    if kind == "string":
        return BYTE_ARRAY, {"converted_type": _UTF8, "logicalType": {"STRING": {}}}
    if dtype.is_integer():
        signed = dtype.is_signed_integer()
        width = int(kind[kind.index("t") + 1:])
        conv = next(c for c, v in _CONVERTED_INT.items() if v == (width, signed))
        return (INT64 if width == 64 else INT32), {
            "converted_type": conv,
            "logicalType": {"INTEGER": {"bit_width": width, "is_signed": signed}}}
    raise _unsupported(f"writing a column of type {dtype}")


def encode_plain(vals: np.ndarray, physical: int) -> bytes:
    if physical == BOOLEAN:
        return np.packbits(vals.astype(np.uint8), bitorder="little").tobytes()
    if physical in _NUMPY_PHYSICAL:
        return np.ascontiguousarray(vals).astype(_NUMPY_PHYSICAL[physical],
                                                 copy=False).tobytes()
    if physical == BYTE_ARRAY:
        items = vals.tolist()
        n = len(items)
        joined = "".join(items)
        if joined.isascii():
            data = joined.encode("ascii")
            lens = np.fromiter(map(len, items), dtype=np.int64, count=n)
        else:
            enc = [s.encode("utf-8") for s in items]
            data = b"".join(enc)
            lens = np.fromiter(map(len, enc), dtype=np.int64, count=n)
        out = np.empty(len(data) + 4 * n, dtype=np.uint8)
        starts = np.arange(n, dtype=np.int64) * 4
        starts[1:] += np.cumsum(lens)[:-1]
        out[(starts[:, None] + np.arange(4)).ravel()] = \
            lens.astype("<u4").view(np.uint8)
        if len(data):
            dest = np.arange(len(data), dtype=np.int64) + 4 * np.repeat(
                np.arange(1, n + 1, dtype=np.int64), lens)
            out[dest] = np.frombuffer(data, dtype=np.uint8)
        return out.tobytes()
    raise _unsupported(f"writing PLAIN {TYPE_NAMES[physical]}")


def _storage(vals: np.ndarray, col: ColumnInfo) -> np.ndarray:
    """Port storage values as the physical type's numpy values."""
    kind = col.dtype.kind
    if kind in ("uint8", "uint16", "uint32"):
        return vals.astype(np.uint32).view(np.int32)
    if kind == "uint64":
        return vals.view(np.int64)
    if col.physical == INT32 and vals.dtype != np.int32:
        return vals.astype(np.int32)
    return vals


def _page_header(kind: int, uncompressed: int, compressed: int, **sub) -> bytes:
    return bytes(th.encode(th.PAGE_HEADER, {"type": kind,
                                            "uncompressed_page_size": uncompressed,
                                            "compressed_page_size": compressed, **sub}))


def _string_dictionary(vals: np.ndarray):
    """(dictionary in first-occurrence order, codes) of valid strings, or
    None when the dictionary's PLAIN size passes DICTIONARY_LIMIT_BYTES."""
    index: Dict[str, int] = {}
    codes = np.fromiter((index.setdefault(v, len(index)) for v in vals.tolist()),
                        dtype=np.int64, count=len(vals))
    words = np.empty(len(index), dtype=object)
    words[:] = list(index)
    if sum(map(len, index)) + 4 * len(index) > DICTIONARY_LIMIT_BYTES:
        return None
    return words, codes


def write_column_chunk(f, series: Series, col: ColumnInfo, codec: int) -> Dict[str, Any]:
    """Write one column chunk at the file's position; its ColumnMetaData."""
    start = f.tell()
    valid = series.validity_numpy()
    vals = series.to_numpy()[valid] if not valid.all() else series.to_numpy()
    n = len(series)
    nulls = int(n - len(vals))
    encodings = {RLE}
    dictionary = None
    codes = None
    dict_offset = None
    uncompressed_total = 0
    if col.dtype.is_string() and len(vals):
        found = _string_dictionary(vals)
        if found is not None:
            dictionary, codes = found
    if dictionary is not None:
        body = encode_plain(dictionary, col.physical)
        comp = compress(codec, body)
        head = _page_header(DICTIONARY_PAGE, len(body), len(comp),
                            dictionary_page_header={"num_values": len(dictionary),
                                                    "encoding": PLAIN})
        dict_offset = start
        f.write(head)
        f.write(comp)
        uncompressed_total += len(head) + len(body)
        encodings |= {PLAIN, RLE_DICTIONARY}
        bit_width = max(1, (len(dictionary) - 1).bit_length())
        page_rows = max(1, PAGE_TARGET_BYTES * 8 // bit_width)
    else:
        encodings.add(PLAIN)
        width = 1 if col.physical == BOOLEAN else (
            np.dtype(_NUMPY_PHYSICAL[col.physical]).itemsize
            if col.physical in _NUMPY_PHYSICAL else 16)
        page_rows = max(1, PAGE_TARGET_BYTES // width)
    data_offset = f.tell()
    store = _storage(vals, col) if dictionary is None else None
    v0 = 0
    for r0 in range(0, max(n, 1), page_rows):
        r1 = min(n, r0 + page_rows)
        ok = valid[r0:r1]
        nv = int(ok.sum())
        levels = encode_hybrid(ok.astype(np.int64), 1)
        if dictionary is not None:
            values = bytes([bit_width]) + encode_hybrid(codes[v0:v0 + nv], bit_width)
            enc = RLE_DICTIONARY
        else:
            values = encode_plain(store[v0:v0 + nv], col.physical)
            enc = PLAIN
        v0 += nv
        body = struct.pack("<I", len(levels)) + levels + values
        comp = compress(codec, body)
        head = _page_header(DATA_PAGE, len(body), len(comp),
                            data_page_header={"num_values": r1 - r0, "encoding": enc,
                                              "definition_level_encoding": RLE,
                                              "repetition_level_encoding": RLE})
        f.write(head)
        f.write(comp)
        uncompressed_total += len(head) + len(body)
    stats = _chunk_statistics(vals, col, nulls, dictionary)
    md = {"type": col.physical, "encodings": sorted(encodings), "path_in_schema": [col.name],
          "codec": codec, "num_values": n, "total_uncompressed_size": uncompressed_total,
          "total_compressed_size": f.tell() - start, "data_page_offset": data_offset,
          "statistics": stats}
    if dict_offset is not None:
        md["dictionary_page_offset"] = dict_offset
    return md


def write_file(path: str, batches, schema, codec: int,
               row_group_rows: Optional[int] = None) -> None:
    """Write the RecordBatches ``batches`` (one schema) as one Parquet file,
    in row groups of ``row_group_rows`` (default ``ROW_GROUP_ROWS``)."""
    from ..core.recordbatch import RecordBatch

    row_group_rows = row_group_rows or ROW_GROUP_ROWS
    cols = []
    elements = [{"name": "schema", "num_children": len(schema)}]
    for field in schema:
        physical, ann = _physical_for(field.dtype)
        cols.append(ColumnInfo(field.name, physical, field.dtype, 1))
        elements.append({"type": physical, "repetition_type": OPTIONAL, "name": field.name,
                         **ann})
    batches = [b for b in batches if b.num_rows]
    whole = RecordBatch.concat(batches) if batches else RecordBatch.empty(schema)
    total = whole.num_rows
    row_groups = []
    with open(path, "wb") as f:
        f.write(MAGIC)
        for r0 in range(0, total, row_group_rows):
            part = whole.slice(r0, min(total, r0 + row_group_rows))
            rg_start = f.tell()
            chunks = []
            for col, s in zip(cols, part.columns()):
                md = write_column_chunk(f, s, col, codec)
                chunks.append({"file_offset": md.get("dictionary_page_offset",
                                                     md["data_page_offset"]),
                               "meta_data": md})
            row_groups.append({
                "columns": chunks, "num_rows": part.num_rows,
                "total_byte_size": sum(c["meta_data"]["total_uncompressed_size"]
                                       for c in chunks),
                "file_offset": rg_start, "total_compressed_size": f.tell() - rg_start,
                "ordinal": len(row_groups)})
        meta = th.encode(th.FILE_META_DATA, {
            "version": 1, "schema": elements, "num_rows": total, "row_groups": row_groups,
            "created_by": "daft_tpu_torch", "column_orders": [{"TYPE_ORDER": {}}] * len(cols)})
        f.write(meta)
        f.write(struct.pack("<I", len(meta)))
        f.write(MAGIC)
