"""WARC (Web ARChive, Common Crawl) scan (counterpart of
daft_tpu/io/warc.py): a row per record of WARC/1.0 and 1.1 files, plain or
``.gz`` (any number of gzip members, one a record as Common Crawl writes
them: the standard library's gzip reads them in turn).

The columns are the reference's: ``warc_record_id``, ``warc_type``,
``warc_target_uri``, ``warc_date``, ``content_type`` (strings, null where
the header is missing), ``content_length`` (int64, 0 without the header)
and ``content``, the payload decoded as UTF-8 with bad bytes replaced.
Header names are matched without case, values stripped; blank lines
between records are skipped; a record that does not start with a
``WARC/`` line raises. Each file is one scan task, streamed in batches of
1,024 records; a limit stops each file's reading at that many records.
"""

from __future__ import annotations

import gzip
import io
import os
from typing import List, Union

from ..core.micropartition import MicroPartition
from ..core.recordbatch import RecordBatch
from ..core.series import Series
from ..datatype import DataType, Field
from ..schema import Schema
from .paths import expand_paths
from .scan import Pushdowns, ScanOperator, ScanTask

RECORDS_PER_BATCH = 1024

SCHEMA = Schema([
    Field("warc_record_id", DataType.string()),
    Field("warc_type", DataType.string()),
    Field("warc_target_uri", DataType.string()),
    Field("warc_date", DataType.string()),
    Field("content_length", DataType.int64()),
    Field("content_type", DataType.string()),
    Field("content", DataType.string()),
])


def open_binary(path: str) -> io.BufferedIOBase:
    raw = open(path, "rb")
    return gzip.open(raw, "rb") if path.endswith(".gz") else raw


def iter_warc_records(path: str):
    """A dict per WARC record of the file, read as a stream."""
    with open_binary(path) as f:
        while True:
            line = f.readline()
            if not line:
                return
            if line.strip() == b"":
                continue
            if not line.startswith(b"WARC/"):
                raise ValueError(f"{path}: expected WARC version line, got {line[:40]!r}")
            headers = {}
            while True:
                h = f.readline()
                if not h or h.strip() == b"":
                    break
                if b":" in h:
                    k, v = h.split(b":", 1)
                    headers[k.strip().lower().decode("ascii", "replace")] = \
                        v.strip().decode("utf-8", "replace")
            length = int(headers.get("content-length", "0"))
            payload = f.read(length)
            yield {
                "warc_record_id": headers.get("warc-record-id"),
                "warc_type": headers.get("warc-type"),
                "warc_target_uri": headers.get("warc-target-uri"),
                "warc_date": headers.get("warc-date"),
                "content_length": length,
                "content_type": headers.get("content-type"),
                "content": payload.decode("utf-8", "replace"),
            }


def _batch(rows: List[dict], schema: Schema) -> MicroPartition:
    cols = [Series.from_pylist([r[f.name] for r in rows], f.name, f.dtype) for f in schema]
    return MicroPartition(schema, [RecordBatch(schema, cols, len(rows))])


class WarcScanOperator(ScanOperator):
    def __init__(self, path: Union[str, List[str]], **_options):
        self._paths = expand_paths(path)
        if not self._paths:
            raise FileNotFoundError(f"no warc files matched {path!r}")

    def name(self) -> str:
        return f"WarcScan({len(self._paths)} files)"

    def schema(self) -> Schema:
        return SCHEMA

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        cols = pushdowns.columns
        out_schema = SCHEMA if cols is None else Schema([SCHEMA[c] for c in cols])
        limit = pushdowns.limit
        return [ScanTask(read=self._reader(path, limit, out_schema), schema=out_schema,
                         size_bytes=os.path.getsize(path) if os.path.exists(path) else None,
                         source_label=path)
                for path in self._paths]

    @staticmethod
    def _reader(path: str, limit, schema: Schema):
        def read():
            produced = 0
            rows: List[dict] = []
            for rec in iter_warc_records(path):
                if limit is not None and produced >= limit:
                    break
                rows.append(rec)
                produced += 1
                if len(rows) >= RECORDS_PER_BATCH:
                    yield _batch(rows, schema)
                    rows = []
            if rows:
                yield _batch(rows, schema)

        return read
