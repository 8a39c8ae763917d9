"""Scan planning (counterpart of daft_tpu/io/scan.py).

A ``ScanOperator`` describes an external source; the optimizer attaches
``Pushdowns`` (column pruning, predicate, limit) to its ``ScanSource``, and
physical translation asks it for ``ScanTask``s, each an independently
readable unit (a file or a run of a file's row groups) yielding
MicroPartitions.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, List, Optional

from ..expressions.expressions import Expression
from ..schema import Schema


@dataclasses.dataclass
class Pushdowns:
    """Hints a scan may exploit: a scan may ignore filters and limits as long
    as its tasks report whether they applied them exactly."""

    columns: Optional[List[str]] = None
    filters: Optional[Expression] = None
    limit: Optional[int] = None

    def __repr__(self) -> str:
        parts = []
        if self.columns is not None:
            parts.append(f"columns={self.columns}")
        if self.filters is not None:
            parts.append(f"filters={self.filters}")
        if self.limit is not None:
            parts.append(f"limit={self.limit}")
        return "Pushdowns(" + ", ".join(parts) + ")"


@dataclasses.dataclass
class ScanTask:
    """One unit of scan work: a closure producing MicroPartitions, with the
    metadata the planner reads. ``filters_applied`` / ``limit_applied``: the
    reader applied the pushdown exactly, so the executor need not."""

    read: Callable[[], Iterator[Any]]  # yields MicroPartition
    schema: Schema
    size_bytes: Optional[int] = None
    num_rows: Optional[int] = None
    filters_applied: bool = False
    limit_applied: bool = False
    source_label: str = ""


def merge_small_tasks(tasks: List[ScanTask], target_bytes: int) -> List[ScanTask]:
    """Coalesce runs of small adjacent tasks toward ``target_bytes``.

    Only tasks of a known size merge, only while every member agrees on
    ``filters_applied`` and the schema object, and a limit-absorbing task
    never merges. Order is kept: a merged task reads its members in turn."""
    from ..ops import counters

    if target_bytes <= 0 or len(tasks) <= 1:
        return tasks

    out: List[ScanTask] = []
    group: List[ScanTask] = []
    group_bytes = 0

    def flush() -> None:
        nonlocal group, group_bytes
        if not group:
            return
        if len(group) == 1:
            out.append(group[0])
        else:
            members = list(group)

            def read_all(_members=members):
                for t in _members:
                    yield from t.read()

            rows = [t.num_rows for t in members]
            out.append(ScanTask(
                read=read_all,
                schema=members[0].schema,
                size_bytes=sum(t.size_bytes for t in members),
                num_rows=sum(rows) if all(r is not None for r in rows) else None,
                filters_applied=members[0].filters_applied,
                limit_applied=False,
                source_label=f"{members[0].source_label} (+{len(members) - 1} merged)",
            ))
            counters.bump("scan_tasks_merged", len(members) - 1)
        group, group_bytes = [], 0

    for t in tasks:
        mergeable = (t.size_bytes is not None and not t.limit_applied
                     and t.size_bytes < target_bytes)
        if not mergeable:
            flush()
            out.append(t)
            continue
        if group and (group_bytes + t.size_bytes > target_bytes
                      or group[0].filters_applied != t.filters_applied
                      or group[0].schema is not t.schema):
            flush()
        group.append(t)
        group_bytes += t.size_bytes
    flush()
    return out


class ScanOperator:
    """Base class of the external sources (the Parquet and CSV readers)."""

    def name(self) -> str:
        return type(self).__name__

    def schema(self) -> Schema:
        raise NotImplementedError

    def can_absorb_filter(self) -> bool:
        """Whether the optimizer may push a filter into this scan (its
        tasks report whether they applied it exactly)."""
        return False

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        raise NotImplementedError

    def approx_num_rows(self, pushdowns: Pushdowns) -> Optional[float]:
        return None


def scan_batch_rows() -> int:
    """Rows per emitted morsel: the config's ``morsel_size_rows``, read at
    read time, not plan time, as the reference's readers read it."""
    from ..config import execution_config

    return max(execution_config().morsel_size_rows, 1)
