"""CSV scan operator (counterpart of daft_tpu/io/csv.py, whose reader is
``pyarrow.csv``): the port's own parser, with pyarrow's documented
``ReadOptions`` / ``ParseOptions`` / ``ConvertOptions`` defaults.

- Options: ``has_headers`` (else the columns are ``column_1``, ...) and
  ``delimiter``; quotes are ``"``, doubled to escape; a newline always ends
  a row (``newlines_in_values`` off); empty lines are skipped.
- Blocks: the file is read in blocks of 1 MiB cut at a newline
  (``block_size``); each block's rows are one morsel.
- Types are inferred from the first block's rows: each column takes the
  first kind that accepts every value there, in pyarrow's order: null,
  int64, bool, date32, time, timestamp, float64, string. Time and timestamp
  columns raise NotImplementedError (the port has no such dtype). A value
  in ``NULL_VALUES`` is null in every kind but string (pyarrow's
  ``strings_can_be_null`` is off). Integers may carry spaces around them
  and a ``0x`` prefix, never a ``+``; floats accept a sign, exponents and
  ``inf`` / ``infinity`` / ``nan`` in any case; booleans are ``TRUE_VALUES``
  / ``FALSE_VALUES``. A later value its column's kind rejects raises, as
  pyarrow's streaming reader does.
"""

from __future__ import annotations

import csv as _csv
import datetime
import os
import re
from typing import List, Optional, Union

import numpy as np

from ..core.micropartition import MicroPartition
from ..core.recordbatch import RecordBatch
from ..core.series import Series
from ..datatype import DataType, Field
from ..schema import Schema
from .paths import expand_paths
from .scan import Pushdowns, ScanOperator, ScanTask

BLOCK_SIZE = 1 << 20
NULL_VALUES = frozenset(["", "#N/A", "#N/A N/A", "#NA", "-1.#IND", "-1.#QNAN", "-NaN",
                         "-nan", "1.#IND", "1.#QNAN", "N/A", "NA", "NULL", "NaN", "n/a",
                         "nan", "null"])
TRUE_VALUES = frozenset(["1", "True", "TRUE", "true"])
FALSE_VALUES = frozenset(["0", "False", "FALSE", "false"])

_INT = re.compile(r"[ \t]*(-?)(?:0[xX]([0-9a-fA-F]+)|([0-9]+))[ \t]*\Z")
_FLOAT = re.compile(r"[ \t]*[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
                    r"|inf|infinity|nan)[ \t]*\Z", re.IGNORECASE)
_DATE = re.compile(r"([0-9]{4})-([0-9]{2})-([0-9]{2})\Z")
_TIME = re.compile(r"[0-9]{2}:[0-9]{2}(?::[0-9]{2}(?:\.[0-9]+)?)?\Z")
_TIMESTAMP = re.compile(r"[0-9]{4}-[0-9]{2}-[0-9]{2}[ T][0-9]{2}:[0-9]{2}"
                        r"(?::[0-9]{2}(?:\.[0-9]+)?)?(?:Z|[+-][0-9]{2}:?[0-9]{2})?\Z")
_EPOCH_ORDINAL = datetime.date(1970, 1, 1).toordinal()
_INT64_MIN, _INT64_MAX = -(1 << 63), (1 << 63) - 1


def _parse_int(v: str):
    m = _INT.match(v)
    if m is None:
        return None
    x = int(m.group(2), 16) if m.group(2) else int(m.group(3))
    x = -x if m.group(1) else x
    return x if _INT64_MIN <= x <= _INT64_MAX else None


def _parse_bool(v: str):
    if v in TRUE_VALUES:
        return True
    if v in FALSE_VALUES:
        return False
    return None


def _parse_date(v: str):
    m = _DATE.match(v)
    if m is None:
        return None
    try:
        return datetime.date(int(m.group(1)), int(m.group(2)),
                             int(m.group(3))).toordinal() - _EPOCH_ORDINAL
    except ValueError:
        return None


def _parse_float(v: str):
    return float(v) if _FLOAT.match(v) else None


def _reject(_v: str):
    return None


# pyarrow's inference order; time and timestamp are recognized only to raise
_KINDS = [("int64", _parse_int), ("bool", _parse_bool), ("date", _parse_date),
          ("time", lambda v: 0 if _TIME.match(v) else None),
          ("timestamp", lambda v: 0 if _TIMESTAMP.match(v) else None),
          ("float64", _parse_float)]


def infer_kind(values: List[str]) -> str:
    """The first kind (null, int64, bool, date, time, timestamp, float64,
    string) that accepts every value of one column."""
    present = [v for v in values if v not in NULL_VALUES]
    if not present:
        return "null"
    for kind, parse in _KINDS:
        if all(parse(v) is not None for v in present):
            return kind
    return "string"


def _dtype_of(kind: str, name: str) -> DataType:
    if kind in ("time", "timestamp"):
        raise NotImplementedError(f"CSV column {name!r} holds {kind} values: the port has "
                                  f"no {kind} type")
    return {"null": DataType.null(), "int64": DataType.int64(), "bool": DataType.bool(),
            "date": DataType.date(), "float64": DataType.float64(),
            "string": DataType.string()}[kind]


def convert_column(values: List[str], dtype: DataType, name: str) -> Series:
    """One column's text values as a Series of ``dtype``; raises on a value
    the type rejects."""
    n = len(values)
    if dtype.is_string():
        arr = np.empty(n, dtype=object)
        arr[:] = values
        return Series(name, dtype, arr, np.ones(n, dtype=bool))
    if dtype.is_null():
        if any(v not in NULL_VALUES for v in values):
            raise ValueError(f"CSV column {name!r}: a value in a column of nulls")
        return Series.full_null(name, dtype, n)
    parse = {"int64": _parse_int, "bool": _parse_bool, "date": _parse_date,
             "float64": _parse_float}[dtype.kind]
    fill = np.nan if dtype.is_floating() else 0
    out = np.empty(n, dtype=dtype.to_numpy())
    valid = np.ones(n, dtype=bool)
    for i, v in enumerate(values):
        if v in NULL_VALUES:
            out[i] = fill
            valid[i] = False
            continue
        x = parse(v)
        if x is None:
            raise ValueError(f"CSV conversion error to {dtype}: invalid value {v!r} in "
                             f"column {name!r}")
        out[i] = x
    return Series(name, dtype, out, valid)


class CsvScanOperator(ScanOperator):
    def __init__(self, path: Union[str, List[str]], schema: Optional[Schema] = None,
                 has_headers: bool = True, delimiter: str = ",", **_options):
        self._paths = expand_paths(path, (".csv", ".tsv"))
        if not self._paths:
            raise FileNotFoundError(f"no csv files matched {path!r}")
        self._schema = schema
        self._has_headers = has_headers
        self._delimiter = delimiter

    def name(self) -> str:
        return f"CsvScan({len(self._paths)} files)"

    def _blocks(self, path: str):
        """(column names, an iterator of each block's rows as lists of
        strings)."""
        with open(path, "rb") as f:
            data = f.read()
        header: Optional[List[str]] = None
        start = 0
        if self._has_headers:
            nl = data.find(b"\n")
            end = len(data) if nl < 0 else nl + 1
            header = self._parse(data[:end])[0] if data[:end].strip() else []
            start = end

        def blocks():
            pos, first_end = start, BLOCK_SIZE
            while pos < len(data):
                limit = max(first_end, pos + 1) if pos == start else pos + BLOCK_SIZE
                if limit >= len(data):
                    end = len(data)
                else:
                    nl = data.rfind(b"\n", pos, limit)
                    if nl < 0:
                        nl = data.find(b"\n", limit)
                    end = len(data) if nl < 0 else nl + 1
                rows = self._parse(data[pos:end])
                pos = end
                if rows:
                    yield rows

        return header, blocks()

    def _parse(self, raw: bytes) -> List[List[str]]:
        text = raw.decode("utf-8")
        return [r for r in _csv.reader(text.splitlines(), delimiter=self._delimiter,
                                       quotechar='"', doublequote=True) if r]

    def schema(self) -> Schema:
        if self._schema is None:
            header, blocks = self._blocks(self._paths[0])
            first = next(blocks, [])
            width = len(header) if header is not None else (len(first[0]) if first else 0)
            names = header if header is not None else [f"column_{i + 1}"
                                                       for i in range(width)]
            cols = list(zip(*first)) if first else [()] * width
            self._schema = Schema([Field(n, _dtype_of(infer_kind(list(c)), n))
                                   for n, c in zip(names, cols)])
        return self._schema

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        schema = self.schema()
        columns = pushdowns.columns
        out_schema = Schema([schema[c] for c in columns]) if columns is not None else schema
        return [ScanTask(read=self._make_reader(path, schema, pushdowns.limit, out_schema),
                         schema=out_schema,
                         size_bytes=os.path.getsize(path) if os.path.exists(path) else None,
                         source_label=path)
                for path in self._paths]

    def _make_reader(self, path: str, schema: Schema, limit, out_schema: Schema):
        def read():
            _header, blocks = self._blocks(path)
            width = len(schema)
            names = out_schema.column_names()
            index = {f.name: i for i, f in enumerate(schema)}
            produced = 0
            for rows in blocks:
                if limit is not None:
                    if produced >= limit:
                        return
                    rows = rows[:limit - produced]
                for r in rows:
                    if len(r) != width:
                        raise ValueError(f"CSV parse error in {path}: expected {width} "
                                         f"columns, got {len(r)}")
                produced += len(rows)
                cols = [convert_column([r[index[n]] for r in rows], out_schema[n].dtype, n)
                        for n in names]
                yield MicroPartition(out_schema, [RecordBatch(out_schema, cols, len(rows))])

        return read
