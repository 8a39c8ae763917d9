"""``from_glob_path``: a DataFrame of file metadata (counterpart of
daft_tpu/io/glob_files.py): one row per file the pattern names, in
``expand_paths``' order, with its path, its size (null where it does not
exist) and a null row count."""

from __future__ import annotations

import os
from typing import List

from ..core.micropartition import MicroPartition
from ..datatype import DataType, Field
from ..schema import Schema
from .paths import expand_paths
from .scan import Pushdowns, ScanOperator, ScanTask


class GlobPathScanOperator(ScanOperator):
    def __init__(self, pattern):
        self._pattern = pattern
        self._out_schema = Schema([
            Field("path", DataType.string()),
            Field("size", DataType.int64()),
            Field("num_rows", DataType.int64()),
        ])

    def name(self) -> str:
        return f"GlobPathScan({self._pattern})"

    def schema(self) -> Schema:
        return self._out_schema

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        schema = self.schema()
        columns = pushdowns.columns

        def read():
            paths = expand_paths(self._pattern)
            sizes = [os.path.getsize(p) if os.path.exists(p) else None for p in paths]
            part = MicroPartition.from_pydict({
                "path": paths, "size": sizes, "num_rows": [None] * len(paths),
            }).cast_to_schema(schema)
            yield part if columns is None else part.select_columns(list(columns))

        return [ScanTask(read=read, schema=schema if columns is None
                         else Schema([schema[c] for c in columns]),
                         source_label=str(self._pattern))]
