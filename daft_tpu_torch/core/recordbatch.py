"""RecordBatch: schema + equal-length columns (counterpart of
daft_tpu/core/recordbatch.py, the subset the grouped-aggregation slice needs).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..schema import Schema
from .series import Series


class RecordBatch:
    __slots__ = ("_schema", "_columns", "_num_rows", "_stage_cache")

    def __init__(self, schema: Schema, columns: List[Series], num_rows: Optional[int] = None):
        if num_rows is None:
            num_rows = len(columns[0]) if columns else 0
        for c in columns:
            if len(c) != num_rows:
                raise ValueError(f"column {c.name!r} has {len(c)} rows, expected {num_rows}")
        self._schema = schema
        self._columns = columns
        self._num_rows = num_rows
        self._stage_cache = None

    def stage_cache(self) -> dict:
        """Per-batch cache of derived host state (a device stage's group
        codes), so repeated queries over a resident table skip the work."""
        if self._stage_cache is None:
            self._stage_cache = {}
        return self._stage_cache

    @classmethod
    def from_pydict(cls, data: Dict[str, Any]) -> "RecordBatch":
        """Columns from Series, numpy arrays or Python sequences."""
        cols = []
        for name, vals in data.items():
            if isinstance(vals, Series):
                cols.append(vals.rename(name))
            elif isinstance(vals, np.ndarray):
                cols.append(Series.from_numpy(vals, name))
            else:
                cols.append(Series.from_pylist(list(vals), name))
        return cls(Schema([c.field() for c in cols]), cols)

    @classmethod
    def empty(cls, schema: Schema) -> "RecordBatch":
        return cls(schema, [Series.empty(f.name, f.dtype) for f in schema], 0)

    @property
    def schema(self) -> Schema:
        return self._schema

    def __len__(self) -> int:
        return self._num_rows

    @property
    def num_rows(self) -> int:
        return self._num_rows

    def columns(self) -> List[Series]:
        return list(self._columns)

    def get_column(self, name: str) -> Series:
        return self._columns[self._schema.index_of(name)]

    def column_names(self) -> List[str]:
        return self._schema.column_names()

    def size_bytes(self) -> int:
        """Arrow's bytes of the columns (``Series.size_bytes``), as the
        reference counts a batch against the host memory budget."""
        return sum(c.size_bytes() for c in self._columns)

    def __repr__(self) -> str:
        return f"RecordBatch({self._schema}, rows={self._num_rows})"

    def to_pydict(self) -> Dict[str, list]:
        return {c.name: c.to_pylist() for c in self._columns}

    def cast_to_schema(self, schema: Schema) -> "RecordBatch":
        cols = []
        for f in schema:
            if f.name in self._schema:
                cols.append(self.get_column(f.name).cast(f.dtype))
            else:
                cols.append(Series.full_null(f.name, f.dtype, self._num_rows))
        return RecordBatch(schema, cols, self._num_rows)

    def select_columns(self, names: List[str]) -> "RecordBatch":
        """The columns ``names`` (the same Series), in that order."""
        return RecordBatch(Schema([self._schema[n] for n in names]),
                           [self.get_column(n) for n in names], self._num_rows)

    def slice(self, start: int, end: int) -> "RecordBatch":
        """Rows [start, end): every column's values and validity are views of
        this batch's numpy planes (no copy), as the pipeline's morsels are."""
        start = max(0, min(start, self._num_rows))
        end = max(start, min(end, self._num_rows))
        return RecordBatch(self._schema, [c.slice(start, end) for c in self._columns],
                           end - start)

    def head(self, n: int) -> "RecordBatch":
        return self.slice(0, n)

    def take(self, indices: np.ndarray) -> "RecordBatch":
        return RecordBatch(self._schema, [c.take(indices) for c in self._columns],
                           len(indices))

    def filter_by_mask(self, mask: Series) -> "RecordBatch":
        """Keep rows where the boolean mask is true (null mask rows drop)."""
        keep = mask.to_numpy().astype(bool) & mask.validity_numpy()
        idx = np.flatnonzero(keep)
        return self.take(idx)

    @classmethod
    def concat(cls, batches: List["RecordBatch"]) -> "RecordBatch":
        if not batches:
            raise ValueError("need at least one batch")
        first = batches[0]
        if len(batches) == 1:
            return first
        cols = [Series.concat([b._columns[i] for b in batches])
                for i in range(len(first.schema))]
        return cls(first.schema, cols, sum(b.num_rows for b in batches))

    def sort(self, key_series: List[Series], descending: List[bool],
             nulls_first: Optional[List[bool]] = None) -> "RecordBatch":
        from .kernels.sort import multi_argsort

        return self.take(multi_argsort(key_series, descending, nulls_first))

    def partition_by_hash(self, key_series: List[Series],
                          num_partitions: int) -> List["RecordBatch"]:
        """Split rows by ``combine_hashes`` of the keys mod ``num_partitions``;
        each piece keeps the rows' input order."""
        from .kernels.hashing import combine_hashes

        if self._num_rows == 0:
            return [self.slice(0, 0) for _ in range(num_partitions)]
        hashes = combine_hashes([s.hash().to_numpy() for s in key_series])
        part_ids = (hashes % np.uint64(num_partitions)).astype(np.int64)
        return self._split_by_partition_ids(part_ids, num_partitions)

    def partition_by_random(self, num_partitions: int, seed: int) -> List["RecordBatch"]:
        """Split rows by numpy's ``default_rng(seed)`` draws, as the reference."""
        rng = np.random.default_rng(seed)
        part_ids = rng.integers(0, num_partitions, size=self._num_rows)
        return self._split_by_partition_ids(part_ids.astype(np.int64), num_partitions)

    def _split_by_partition_ids(self, part_ids: np.ndarray,
                                num_partitions: int) -> List["RecordBatch"]:
        order = np.argsort(part_ids, kind="stable")
        bounds = np.searchsorted(part_ids[order], np.arange(num_partitions + 1))
        return [self.take(order[bounds[p]:bounds[p + 1]]) for p in range(num_partitions)]
