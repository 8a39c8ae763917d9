"""Line-oriented text scan (counterpart of daft_tpu/io/text.py): one string
column ``text``, a row per line, ``.gz`` read through the standard
library's gzip.

Lines are the reference's: the file decoded as UTF-8 (bad bytes replaced),
universal newlines (``\\n``, ``\\r\\n`` and ``\\r`` each end a line, as
``io.TextIOWrapper`` reads them), the newline dropped, empty lines kept.
Each file is one scan task, streamed in batches of 64 Ki lines; a limit
pushdown stops each file's reading once it has produced that many lines.
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

LINES_PER_BATCH = 64 * 1024


def open_text(path: str):
    raw = open(path, "rb")
    if path.endswith(".gz"):
        raw = gzip.open(raw, "rb")
    return io.TextIOWrapper(raw, encoding="utf-8", errors="replace")


def _batch(lines: List[str], schema: Schema) -> MicroPartition:
    cols = [Series.from_pylist(lines, "text", DataType.string())] if len(schema) else []
    return MicroPartition(schema, [RecordBatch(schema, cols, len(lines))])


class TextScanOperator(ScanOperator):
    def __init__(self, path: Union[str, List[str]], **_options):
        self._paths = expand_paths(path)
        if not self._paths:
            raise FileNotFoundError(f"no text files matched {path!r}")
        self._schema = Schema([Field("text", DataType.string())])

    def name(self) -> str:
        return f"TextScan({len(self._paths)} files)"

    def schema(self) -> Schema:
        return self._schema

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        out_schema = self._schema if pushdowns.columns is None or "text" in pushdowns.columns \
            else Schema([])
        limit = pushdowns.limit
        return [ScanTask(read=self._reader(path, limit, out_schema), schema=out_schema,
                         size_bytes=os.path.getsize(path) if os.path.exists(path) else None,
                         source_label=path)
                for path in self._paths]

    @staticmethod
    def _reader(path: str, limit, schema: Schema):
        def read():
            produced = 0
            buf: List[str] = []
            with open_text(path) as f:
                for line in f:
                    if limit is not None and produced >= limit:
                        break
                    buf.append(line.rstrip("\n"))
                    produced += 1
                    if len(buf) >= LINES_PER_BATCH:
                        yield _batch(buf, schema)
                        buf = []
            if buf:
                yield _batch(buf, schema)

        return read
