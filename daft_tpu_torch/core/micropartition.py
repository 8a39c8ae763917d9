"""MicroPartition: a schema plus a list of RecordBatches (counterpart of
daft_tpu/core/micropartition.py, the subset the grouped-aggregation slice
needs)."""

from __future__ import annotations

from typing import Any, Dict, List

from ..schema import Schema
from .recordbatch import RecordBatch


class MicroPartition:
    __slots__ = ("_schema", "_batches", "__weakref__")

    def __init__(self, schema: Schema, batches: List[RecordBatch]):
        self._schema = schema
        self._batches = [b for b in batches if b.num_rows > 0]

    @classmethod
    def from_pydict(cls, data: Dict[str, Any]) -> "MicroPartition":
        b = RecordBatch.from_pydict(data)
        return cls(b.schema, [b])

    @classmethod
    def concat(cls, parts: List["MicroPartition"]) -> "MicroPartition":
        if not parts:
            raise ValueError("need at least one micropartition")
        batches: List[RecordBatch] = []
        for p in parts:
            batches.extend(p._batches)
        return cls(parts[0].schema, batches)

    @property
    def schema(self) -> Schema:
        return self._schema

    def __len__(self) -> int:
        return sum(b.num_rows for b in self._batches)

    @property
    def num_rows(self) -> int:
        return len(self)

    def size_bytes(self) -> int:
        return sum(b.size_bytes() for b in self._batches)

    @property
    def batches(self) -> List[RecordBatch]:
        return self._batches

    def concat_or_empty(self) -> RecordBatch:
        if not self._batches:
            return RecordBatch.empty(self._schema)
        if len(self._batches) == 1:
            return self._batches[0]
        combined = RecordBatch.concat(self._batches)
        self._batches = [combined]
        return combined

    def hold(self) -> None:
        """Mark every column as held by the caller (``Series.held``)."""
        for b in self._batches:
            for s in b.columns():
                s.held = True

    def select_columns(self, names: List[str]) -> "MicroPartition":
        """The columns ``names`` of every batch (the same Series)."""
        batches = [b.select_columns(names) for b in self.batches]
        return MicroPartition(Schema([self.schema[n] for n in names]), batches)

    def cast_to_schema(self, schema: Schema) -> "MicroPartition":
        return MicroPartition(schema, [b.cast_to_schema(schema) for b in self._batches])

    def to_pydict(self) -> Dict[str, list]:
        return self.concat_or_empty().to_pydict()

    def __repr__(self) -> str:
        return f"MicroPartition({self._schema}, rows={len(self)}, batches={len(self._batches)})"
