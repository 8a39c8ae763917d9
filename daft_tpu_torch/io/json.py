"""Line-delimited JSON scan (counterpart of daft_tpu/io/json.py, whose
reader is ``pyarrow.json.read_json``): the port's own, on the standard
library's ``json``.

Files are the ``.json`` / ``.jsonl`` / ``.ndjson`` files of a path, a
directory or a glob, in ``expand_paths``' order. Each line holds one
object (blank lines are skipped). The schema is inferred from the whole
first file, by pyarrow's rules:

- a field's columns are in the order they first appear; a row without a
  field is null there;
- null, bool, int64, double, string, list and struct; an int and a double
  make a double, as does an integer outside int64; null gives way to any
  kind; a struct's fields and a list's items are inferred the same way;
- a string column whose every value is an ISO-8601 timestamp of whole
  seconds (``YYYY-MM-DD``, then optionally ``T`` or a space and ``HH``,
  ``HH:MM`` or ``HH:MM:SS``, then optionally ``Z``, ``+HH``, ``+HHMM`` or
  ``+HH:MM``) is timestamp[s], the offset applied (UTC, no zone);
- kinds that cannot meet (a number and a string, a bool and a number, an
  object and an array) raise, as pyarrow's "changed from ... to ..." does.

Every file is read against that schema (the reference casts each later
file to the first's): a field outside it is dropped, a value its column
cannot hold raises. A file streams in batches of 64 Ki lines, each parsed
with one ``json.loads`` call; column pruning and the limit are applied as
it reads.
"""

from __future__ import annotations

import calendar
import json
import os
import re
from typing import Any, Dict, List, Optional, Union

from ..core.micropartition import MicroPartition
from ..core.recordbatch import RecordBatch
from ..core.series import Series
from ..datatype import DataType, Field
from ..schema import Schema
from .paths import expand_paths
from .scan import Pushdowns, ScanOperator, ScanTask

LINES_PER_BATCH = 64 * 1024
EXTENSIONS = (".json", ".jsonl", ".ndjson")

_I64_MIN, _I64_MAX = -(1 << 63), (1 << 63) - 1
_TIMESTAMP = re.compile(r"([0-9]{4})-([0-9]{2})-([0-9]{2})"
                        r"(?:[T ]([0-9]{2})(?::([0-9]{2})(?::([0-9]{2}))?)?"
                        r"(Z|[+-][0-9]{2}(?::?[0-9]{2})?)?)?\Z")


def timestamp_seconds(s: str) -> Optional[int]:
    """Seconds since the epoch (UTC) of an ISO-8601 string as pyarrow's
    timestamp[s] parser reads it, or None where it reads none."""
    m = _TIMESTAMP.match(s)
    if m is None:
        return None
    y, mo, d, hh, mi, ss, zone = m.groups()
    y, mo, d = int(y), int(mo), int(d)
    hh, mi, ss = int(hh or 0), int(mi or 0), int(ss or 0)
    if not (1 <= mo <= 12 and 1 <= d <= calendar.monthrange(max(y, 1), mo)[1]
            and hh <= 23 and mi <= 59 and ss <= 59):
        return None
    off = 0
    if zone and zone != "Z":
        digits = zone[1:].replace(":", "")
        oh, om = int(digits[:2]), int(digits[2:] or 0)
        if oh > 23 or om > 59:
            return None
        off = (oh * 3600 + om * 60) * (1 if zone[0] == "+" else -1)
    days = _days_from_civil(y, mo, d)
    return days * 86400 + hh * 3600 + mi * 60 + ss - off


def _days_from_civil(y: int, m: int, d: int) -> int:
    y -= m <= 2
    era = (y if y >= 0 else y - 399) // 400
    yoe = y - era * 400
    doy = (153 * (m + (-3 if m > 2 else 9)) + 2) // 5 + d - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


# ---- inference: a kind is ("null",), ("bool",), ("int",), ("double",), ("ts",),
# ("str",), ("list", kind) or ("struct", {name: kind}) --------------------------------

_NAMES = {"null": "null", "bool": "boolean", "int": "number", "double": "number",
          "ts": "string", "str": "string", "list": "array", "struct": "object"}


def kind_of(v: Any):
    if v is None:
        return ("null",)
    if isinstance(v, bool):
        return ("bool",)
    if isinstance(v, int):
        return ("int",) if _I64_MIN <= v <= _I64_MAX else ("double",)
    if isinstance(v, float):
        return ("double",)
    if isinstance(v, str):
        return ("ts",) if timestamp_seconds(v) is not None else ("str",)
    if isinstance(v, list):
        k = ("null",)
        for x in v:
            k = merge(k, kind_of(x), "")
        return ("list", k)
    fields: Dict[str, Any] = {}
    for name, x in v.items():
        fields[name] = merge(fields.get(name, ("null",)), kind_of(x), name)
    return ("struct", fields)


def merge(a, b, where: str):
    if a[0] == "null":
        return b
    if b[0] == "null" or a == b:
        return a
    pair = {a[0], b[0]}
    if pair == {"int", "double"}:
        return ("double",)
    if pair == {"ts", "str"}:
        return ("str",)
    if a[0] == b[0] == "list":
        return ("list", merge(a[1], b[1], where))
    if a[0] == b[0] == "struct":
        fields = dict(a[1])
        for name, k in b[1].items():
            fields[name] = merge(fields.get(name, ("null",)), k, f"{where}/{name}")
        return ("struct", fields)
    raise ValueError(f"JSON parse error: Column(/{where}) changed from {_NAMES[a[0]]} to "
                     f"{_NAMES[b[0]]}")


def dtype_of(kind) -> DataType:
    tag = kind[0]
    if tag == "list":
        return DataType.list(dtype_of(kind[1]))
    if tag == "struct":
        return DataType.struct({n: dtype_of(k) for n, k in kind[1].items()})
    return {"null": DataType.null(), "bool": DataType.bool(), "int": DataType.int64(),
            "double": DataType.float64(), "ts": DataType.timestamp("s"),
            "str": DataType.string()}[tag]


def _value(v, dt: DataType, where: str):
    """``v`` as a value of a ``dt`` column (a timestamp as its seconds)."""
    if v is None:
        return None
    if dt.is_nested():
        storage = dt.storage
        if storage.kind == "struct" and isinstance(v, dict):
            return {n: _value(v.get(n), fdt, f"{where}/{n}") for n, fdt in storage.struct_fields}
        if storage.kind == "list" and isinstance(v, list):
            inner = storage.inner
            return [_value(x, inner, where) for x in v]
    elif dt.kind == "timestamp" and isinstance(v, str):
        secs = timestamp_seconds(v)
        if secs is not None:
            return secs
    elif dt.is_floating() and isinstance(v, (int, float)) and not isinstance(v, bool):
        return float(v)
    elif dt.is_integer() and isinstance(v, int) and not isinstance(v, bool) \
            and _I64_MIN <= v <= _I64_MAX:
        return v
    elif dt.is_boolean() and isinstance(v, bool):
        return v
    elif dt.is_string() and isinstance(v, str):
        return v
    raise ValueError(f"JSON conversion error: column /{where} of type {dt} cannot hold {v!r}")


def _parse_lines(lines: List[str], path: str) -> List[dict]:
    """One ``json.loads`` over the batch; a batch it refuses is read line
    by line to name the bad line."""
    try:
        rows = json.loads("[" + ",".join(lines) + "]")
    except json.JSONDecodeError:
        rows = []
        for i, ln in enumerate(lines):
            try:
                rows.append(json.loads(ln))
            except json.JSONDecodeError as e:
                raise ValueError(f"JSON parse error in {path}: {e} in line {ln[:80]!r}") from e
    for r in rows:
        if not isinstance(r, dict):
            raise ValueError(f"JSON parse error in {path}: a line holds "
                             f"{type(r).__name__}, not an object")
    return rows


def _line_batches(path: str):
    with open(path, "r", encoding="utf-8") as f:
        buf: List[str] = []
        for line in f:
            s = line.strip()
            if s:
                buf.append(s)
                if len(buf) >= LINES_PER_BATCH:
                    yield buf
                    buf = []
        if buf:
            yield buf


def infer_schema(path: str) -> Schema:
    kind = ("struct", {})
    for lines in _line_batches(path):
        for row in _parse_lines(lines, path):
            kind = merge(kind, kind_of(row), "")
    return Schema([Field(n, dtype_of(k)) for n, k in kind[1].items()])


class JsonScanOperator(ScanOperator):
    def __init__(self, path: Union[str, List[str]], schema: Optional[Schema] = None,
                 **_options):
        self._paths = expand_paths(path, EXTENSIONS)
        if not self._paths:
            raise FileNotFoundError(f"no json files matched {path!r}")
        self._schema = schema

    def name(self) -> str:
        return f"JsonScan({len(self._paths)} files)"

    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = infer_schema(self._paths[0])
        return self._schema

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        schema = self.schema()
        columns = pushdowns.columns
        out_schema = Schema([schema[c] for c in columns]) if columns is not None else schema
        return [ScanTask(read=self._reader(path, pushdowns.limit, out_schema),
                         schema=out_schema,
                         size_bytes=os.path.getsize(path) if os.path.exists(path) else None,
                         source_label=path)
                for path in self._paths]

    @staticmethod
    def _reader(path: str, limit, schema: Schema):
        def read():
            produced = 0
            for lines in _line_batches(path):
                if limit is not None:
                    if produced >= limit:
                        return
                    lines = lines[:limit - produced]
                rows = _parse_lines(lines, path)
                produced += len(rows)
                cols = [Series.from_pylist([_value(r.get(f.name), f.dtype, f.name) for r in rows],
                                           f.name, f.dtype) for f in schema]
                yield MicroPartition(schema, [RecordBatch(schema, cols, len(rows))])

        return read
