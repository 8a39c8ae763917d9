"""File writers: Parquet, CSV and JSON lines with hive-style partitioning and
size-targeted file rotation (counterpart of daft_tpu/io/writers.py, the
local part; the reference writes through pyarrow, the port through its own
format code).

The physical write node calls ``WriteInfo.execute_write``, which yields one
MicroPartition with a ``path`` column: the files written, as the
reference's result frame. Parquet files use pyarrow's defaults as the
reference writes them: snappy unless asked otherwise, string columns
dictionary-encoded, row groups of 1 Mi rows, with per-row-group statistics
(io/_parquet_format.py). CSV files follow ``pyarrow.csv.write_csv``: a
quoted header, strings quoted (``"`` doubled), nulls empty, booleans
``true`` / ``false``, dates ISO; floats are written by their Python repr
(``1.0``, not pyarrow's ``1``), so a float column reads back as float.
JSON files are ``.jsonl``, a row a line written as the reference writes it,
``json.dumps(row, default=str)`` of the row's values as ``to_pylist``
gives them. A checkpointed write (``checkpoint=(store, key_column)``,
checkpoint/__init__.py) skips the rows whose key a former run sealed and
seals this run's keys with the files it wrote once every batch is written.
Not ported: remote roots (the object store).
"""

from __future__ import annotations

import datetime
import os
import uuid
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ..core.micropartition import MicroPartition
from ..core.recordbatch import RecordBatch
from ..core.series import Series
from ..datatype import DataType, Field
from ..schema import Schema

# rotate output files at about this many bytes of column data
_TARGET_FILE_BYTES = 512 * 1024 * 1024


class WriteInfo:
    def __init__(self, format: str, root_dir: str, options: Dict[str, Any],
                 partition_cols: Optional[List[Any]] = None, write_mode: str = "append",
                 checkpoint=None):
        if format not in ("parquet", "csv", "json"):
            raise NotImplementedError(f"write format {format!r}: only parquet, csv and json "
                                      "are ported")
        if write_mode not in ("append", "overwrite"):
            raise ValueError(f"write_mode must be 'append' or 'overwrite', got "
                             f"{write_mode!r}")
        self.format = format
        self.root_dir = root_dir
        self.options = options
        self.partition_cols = partition_cols
        self.write_mode = write_mode
        # (CheckpointStore, key_column): skip on rerun, seal keys and files
        self.checkpoint = checkpoint

    def __repr__(self) -> str:
        return f"{self.format}://{self.root_dir}"

    def result_schema(self) -> Schema:
        return Schema([Field("path", DataType.string())])

    def execute_write(self, parts: Iterator[MicroPartition],
                      input_schema: Schema) -> Iterator[MicroPartition]:
        from .paths import _REMOTE_SCHEMES

        if self.checkpoint is not None:
            yield from self._execute_checkpointed(parts, input_schema)
            return
        if self.root_dir.startswith(_REMOTE_SCHEMES):
            raise NotImplementedError(f"remote write root {self.root_dir!r}: the object "
                                      "store is not ported yet")
        os.makedirs(self.root_dir, exist_ok=True)
        if self.write_mode == "overwrite":
            _clear_dir(self.root_dir)
        if self.partition_cols:
            written = self._write_partitioned(parts, input_schema)
        else:
            writer = _FileWriter(self.format, self.root_dir, self.options, input_schema)
            for part in parts:
                for b in part.batches:
                    writer.write(b)
            written = writer.close()
        paths = Series.from_pylist(written, "path", DataType.string())
        yield MicroPartition(self.result_schema(),
                             [RecordBatch(self.result_schema(), [paths], len(written))])

    def _execute_checkpointed(self, parts: Iterator[MicroPartition],
                              input_schema: Schema) -> Iterator[MicroPartition]:
        """Rows whose key a former run sealed are skipped; this run's keys
        stage under a fresh checkpoint id, sealed with the manifest of the
        files written once every batch succeeded (daft_tpu/io/writers.py:70-104)."""
        from ..expressions.eval import eval_expression
        from ..expressions.expressions import col

        store, key_col = self.checkpoint
        done = store.get_checkpointed_keys()
        cid = uuid.uuid4().hex[:16]

        def filtered_parts():
            for part in parts:
                for b in part.batches:
                    if b.num_rows == 0:
                        continue
                    keys = eval_expression(b, col(key_col)).to_pylist()
                    if done:
                        keep = np.array([k not in done for k in keys], dtype=bool)
                        if not keep.any():
                            continue
                        if not keep.all():
                            b = b.filter_by_mask(Series.from_numpy(keep, "m"))
                            keys = [k for k, kp in zip(keys, keep) if kp]
                    store.stage_keys(cid, keys)
                    yield MicroPartition(b.schema, [b])

        inner = WriteInfo(self.format, self.root_dir, self.options, self.partition_cols,
                          self.write_mode)
        manifest = list(inner.execute_write(filtered_parts(), input_schema))
        store.stage_files(cid, [p for mp in manifest for p in mp.to_pydict().get("path", [])])
        store.checkpoint(cid)  # seal: keys and files visible at once
        yield from manifest

    def _write_partitioned(self, parts: Iterator[MicroPartition],
                           input_schema: Schema) -> List[str]:
        """One directory per distinct value of the partition columns
        (``<name>=<value>``, nulls as ``__HIVE_DEFAULT_PARTITION__``), each
        with its own rotating writer; the rows keep their order."""
        from ..core.kernels.groupby import make_groups
        from ..expressions.eval import eval_expression

        writers: Dict[tuple, _FileWriter] = {}
        written: List[str] = []
        for part in parts:
            for b in part.batches:
                keys = [eval_expression(b, e) for e in self.partition_cols]
                keys = [k.broadcast(b.num_rows) if len(k) == 1 and b.num_rows != 1 else k
                        for k in keys]
                first_idx, group_ids, _ = make_groups(keys)
                for g, first in enumerate(first_idx):
                    piece = b.take(np.flatnonzero(group_ids == g))
                    krow = {k.name: k.take([first]).to_pylist()[0] for k in keys}
                    kt = tuple(sorted(krow.items(), key=lambda kv: kv[0]))
                    if kt not in writers:
                        subdir = os.path.join(
                            self.root_dir,
                            *[f"{k}={_hive_str(v)}" for k, v in krow.items()])
                        os.makedirs(subdir, exist_ok=True)
                        writers[kt] = _FileWriter(self.format, subdir, self.options,
                                                  input_schema)
                    writers[kt].write(piece)
        for w in writers.values():
            written.extend(w.close())
        return written


def _hive_str(v) -> str:
    return "__HIVE_DEFAULT_PARTITION__" if v is None else str(v)


def _clear_dir(d: str) -> None:
    for root, _dirs, files in os.walk(d):
        for f in files:
            os.unlink(os.path.join(root, f))


def batch_bytes(b: RecordBatch) -> int:
    """Bytes of a batch's column data (strings by their characters plus a
    4-byte offset each, as Arrow would hold them)."""
    total = 0
    for s in b.columns():
        if s.is_nested or s.dtype.is_binary():
            total += s.size_bytes()
            continue
        if s.dtype.is_string():
            valid = s.to_numpy()[s.validity_numpy()]
            total += sum(map(len, valid.tolist())) + 4 * len(s)
        elif not s.dtype.is_null():
            total += s.to_numpy().nbytes
        total += (len(s) + 7) // 8
    return total


class _FileWriter:
    """Size-targeted rotating writer for one directory."""

    def __init__(self, format: str, dir: str, options: Dict[str, Any], schema: Schema):
        self.format = format
        self.dir = dir
        self.options = options
        self.schema = schema
        self.buffer: List[RecordBatch] = []
        self.buffered_bytes = 0
        self.written: List[str] = []

    def write(self, batch: RecordBatch) -> None:
        if batch.num_rows == 0:
            return
        self.buffer.append(batch)
        self.buffered_bytes += batch_bytes(batch)
        if self.buffered_bytes >= _TARGET_FILE_BYTES:
            self._flush()

    def _flush(self) -> None:
        if not self.buffer:
            return
        name = uuid.uuid4().hex
        if self.format == "parquet":
            from . import _parquet_format as pf
            from .codecs import codec_by_name

            path = os.path.join(self.dir, name + ".parquet")
            pf.write_file(path, self.buffer, self.schema,
                          codec_by_name(self.options.get("compression", "snappy")))
        elif self.format == "json":
            path = os.path.join(self.dir, name + ".jsonl")
            write_json_file(path, self.buffer, self.schema)
        else:
            path = os.path.join(self.dir, name + ".csv")
            write_csv_file(path, self.buffer, self.schema)
        self.written.append(path)
        self.buffer = []
        self.buffered_bytes = 0

    def close(self) -> List[str]:
        self._flush()
        return self.written


def _csv_cells(s: Series) -> List[str]:
    vals, valid = s.to_numpy(), s.validity_numpy()
    dt = s.dtype
    if dt.is_string():
        cells = ['"' + v.replace('"', '""') + '"' if ok else ""
                 for v, ok in zip(vals.tolist(), valid.tolist())]
    elif dt.is_boolean():
        cells = [("true" if v else "false") if ok else ""
                 for v, ok in zip(vals.tolist(), valid.tolist())]
    elif dt.kind == "date":
        base = datetime.date(1970, 1, 1).toordinal()
        cells = [datetime.date.fromordinal(base + v).isoformat() if ok else ""
                 for v, ok in zip(vals.tolist(), valid.tolist())]
    elif dt.is_temporal():  # Arrow's string cast, as pyarrow's writer formats them
        cells = [v if ok else "" for v, ok in zip(s.cast(DataType.string()).to_numpy().tolist(),
                                                  valid.tolist())]
    elif dt.is_floating():
        cells = [repr(float(v)) if ok else "" for v, ok in zip(vals.tolist(), valid.tolist())]
    elif dt.is_null():
        cells = [""] * len(s)
    else:
        cells = [str(v) if ok else "" for v, ok in zip(vals.tolist(), valid.tolist())]
    return cells


def write_csv_file(path: str, batches: List[RecordBatch], schema: Schema) -> None:
    with open(path, "w", encoding="utf-8", newline="") as f:
        f.write(",".join('"' + n.replace('"', '""') + '"' for n in schema.column_names())
                + "\n")
        for b in batches:
            cols = [_csv_cells(s) for s in b.columns()]
            f.writelines(",".join(row) + "\n" for row in zip(*cols))


def write_json_file(path: str, batches: List[RecordBatch], schema: Schema) -> None:
    import json

    names = schema.column_names()
    with open(path, "w", encoding="utf-8") as f:
        for b in batches:
            cols = [s.to_pylist() for s in b.columns()]
            f.writelines(json.dumps(dict(zip(names, row)), default=str) + "\n"
                         for row in zip(*cols))
