"""Parquet scan operator (counterpart of daft_tpu/io/parquet.py), reading
through the port's own format code (io/_parquet_format.py), not pyarrow.

Tasks split per file, and per run of row groups for a file past
``scan_split_bytes`` (``_row_group_split_tasks``, on the chunks' on-disk
bytes), so the optimizer's pushdowns prune IO before any page is read:
columns (only the pushed columns' chunks are read), the predicate's zone
maps (``_zone_map_conjuncts`` against each row group's ``min_value`` /
``max_value``: a file or row group they exclude is never read), and the
limit.

The predicate itself: the reference hands a whole-file task's predicate to
pyarrow's dataset scanner (``filters_applied=True``), which prunes row
groups by statistics and filters every batch. The port has no pyarrow; its
whole-file reader does the same with the port's host evaluator: it skips
the row groups the zone maps exclude and filters each morsel, so its tasks
report what the reference's report and give the same rows (ROADMAP Queue
3). A predicate the reference could not hand to pyarrow
(``_arrow_convertible``) is left to the executor's ``post_filter``, as
there. Split tasks never filter (the executor does), as in the reference.

Morsels: a whole-file task yields each row group in slices of
``morsel_size_rows`` (read at read time), filtered, empty ones included,
as pyarrow's scanner yields them; a split task yields ``morsel_size_rows``
slices across its row groups, as ``ParquetFile.iter_batches`` does.

Under a host memory budget, both readers decode ahead on the spill IO pool
(``_maybe_prefetch``, the reference's parquet.py:285-310): up to
``spill_prefetch_batches`` morsels queued while the operators consume the
scan. The budget is read when the task reads, and an unbudgeted read never
sees the pool. Not ported: remote paths (the object store).
"""

from __future__ import annotations

import os
import time
from typing import Iterator, List, Optional, Union

from ..core.micropartition import MicroPartition
from ..core.recordbatch import RecordBatch
from ..core.temporal import common_temporal_type, widen_factor
from ..schema import Schema
from ..datatype import Field
from . import _parquet_format as pf
from .paths import expand_paths
from .scan import Pushdowns, ScanOperator, ScanTask, scan_batch_rows


class ParquetScanOperator(ScanOperator):
    def __init__(self, path: Union[str, List[str]], schema: Optional[Schema] = None,
                 row_groups_per_task: Optional[int] = None, **_options):
        self._paths = expand_paths(path, (".parquet", ".pq"))
        if not self._paths:
            raise FileNotFoundError(f"no parquet files matched {path!r}")
        self._schema = schema
        self._row_groups_per_task = row_groups_per_task

    def name(self) -> str:
        return f"ParquetScan({len(self._paths)} files)"

    def schema(self) -> Schema:
        if self._schema is None:
            # the first file's footer (the reference's schema inference)
            footer = pf.read_footer(self._paths[0])
            self._schema = Schema([Field(c.name, c.dtype) for c in footer.columns])
        return self._schema

    def can_absorb_filter(self) -> bool:
        return True

    def approx_num_rows(self, pushdowns: Pushdowns) -> Optional[float]:
        total = 0
        for p in self._paths:
            try:
                total += pf.read_footer(p).num_rows
            except (OSError, ValueError, NotImplementedError):
                return None  # the estimate is advisory
        if pushdowns.limit is not None:
            total = min(total, pushdowns.limit)
        return float(total)

    def to_scan_tasks(self, pushdowns: Pushdowns) -> List[ScanTask]:
        from ..config import execution_config
        from ..ops import counters

        schema = self.schema()
        columns = pushdowns.columns
        out_schema = Schema([schema[c] for c in columns]) if columns is not None else schema
        predicate = pushdowns.filters if pushdowns.filters is not None \
            and _arrow_convertible(pushdowns.filters) else None
        split_bytes = execution_config().scan_split_bytes
        conjuncts = _zone_map_conjuncts(pushdowns.filters) \
            if pushdowns.filters is not None else []
        tasks = []
        for path in self._paths:
            size = os.path.getsize(path) if os.path.exists(path) else None
            want_split = size is not None and (self._row_groups_per_task is not None
                                               or (split_bytes and size > split_bytes))
            # one footer parse serves zone-map pruning and split planning
            md = _local_metadata(path) if conjuncts or want_split else None
            if conjuncts and md is not None and _prunable_md(md, conjuncts):
                counters.bump("scan_files_pruned")
                continue  # the zone maps prove no row can match
            if want_split and md is not None:
                split = _row_group_split_tasks(path, md, columns, out_schema, conjuncts,
                                               split_bytes or size,
                                               self._row_groups_per_task)
                if split is not None:
                    tasks.extend(split)
                    continue
            tasks.append(ScanTask(
                read=_maybe_prefetch(_make_reader(path, columns, predicate, conjuncts,
                                                  pushdowns.limit, out_schema)),
                schema=out_schema,
                size_bytes=size,
                filters_applied=predicate is not None,
                limit_applied=False,
                source_label=path,
            ))
        return tasks


def _arrow_convertible(expr) -> bool:
    """Whether the reference's ``_expr_to_arrow_filter`` turns ``expr`` into
    a pyarrow filter (only then do its whole-file tasks apply it)."""
    from ..expressions.expressions import Between, BinaryOp, ColumnRef, IsIn, Literal, \
        UnaryOp

    if isinstance(expr, (ColumnRef, Literal)):
        return True
    if isinstance(expr, BinaryOp):
        return expr.op in ("add", "sub", "mul", "div", "eq", "neq", "lt", "le", "gt", "ge",
                           "and", "or") \
            and _arrow_convertible(expr.left) and _arrow_convertible(expr.right)
    if isinstance(expr, UnaryOp):
        return expr.op in ("not", "is_null", "not_null") and _arrow_convertible(expr.child)
    if isinstance(expr, Between):
        return all(_arrow_convertible(e) for e in (expr.child, expr.lower, expr.upper))
    if isinstance(expr, IsIn):
        return _arrow_convertible(expr.child) and all(isinstance(i, Literal)
                                                      for i in expr.items)
    return False


def _zone_map_conjuncts(expr) -> List[tuple]:
    """(column, op, literal) constraints usable against row-group min/max
    statistics: the top-level AND conjuncts that compare a column with a
    literal (the Literal itself: ``_rg_excluded`` puts it on the column's
    scale)."""
    from ..expressions.expressions import Between, BinaryOp, ColumnRef, Literal

    out = []
    flip = {"lt": "gt", "le": "ge", "gt": "lt", "ge": "le", "eq": "eq"}

    def walk(e):
        if isinstance(e, BinaryOp) and e.op == "and":
            walk(e.left)
            walk(e.right)
            return
        if isinstance(e, BinaryOp) and e.op in flip:
            if isinstance(e.left, ColumnRef) and isinstance(e.right, Literal):
                out.append((e.left._name, e.op, e.right))
            elif isinstance(e.right, ColumnRef) and isinstance(e.left, Literal):
                out.append((e.right._name, flip[e.op], e.left))
            return
        if isinstance(e, Between) and isinstance(e.child, ColumnRef):
            if isinstance(e.lower, Literal) and isinstance(e.upper, Literal):
                out.append((e.child._name, "ge", e.lower))
                out.append((e.child._name, "le", e.upper))

    walk(expr)
    return out


def _rg_excluded(md: pf.Footer, rg, conjuncts: List[tuple]) -> bool:
    """True iff the row group's statistics PROVE no row satisfies some
    conjunct. Absent or NaN statistics, and incomparable ones, prove
    nothing."""
    cols = {c.name: c for c in md.columns}
    for name, op, lit in conjuncts:
        col = cols.get(name)
        if col is None or lit.value is None or col.node is not None:
            continue  # a nested column's leaf statistics prune nothing
        # the statistics and the literal on one scale: a temporal pair in
        # the type they meet in, as Arrow compares them
        stat_scale, value = 1, lit.storage_value()
        if lit.dtype != col.dtype and lit.dtype.is_temporal() and col.dtype.is_temporal():
            t = common_temporal_type(lit.dtype, col.dtype)
            if t is None:
                continue
            stat_scale, value = widen_factor(col.dtype, t), value * widen_factor(lit.dtype, t)
        try:
            st = md.chunk(rg, name).get("statistics") or {}
        except KeyError:
            continue
        lo = pf.decode_stat(st.get("min_value"), col)
        hi = pf.decode_stat(st.get("max_value"), col)
        if lo is None or hi is None:
            continue
        lo, hi = lo * stat_scale, hi * stat_scale
        try:
            if op == "lt" and not (lo < value):
                return True
            if op == "le" and not (lo <= value):
                return True
            if op == "gt" and not (hi > value):
                return True
            if op == "ge" and not (hi >= value):
                return True
            if op == "eq" and not (lo <= value <= hi):
                return True
        except TypeError:
            continue  # incomparable (a literal of another kind)
    return False


def _local_metadata(path: str) -> Optional[pf.Footer]:
    """The parsed footer, or None when it is unreadable (the caller then
    plans the whole file without pruning)."""
    try:
        return pf.read_footer(path)
    except (OSError, ValueError):
        return None


def _prunable_md(md: pf.Footer, conjuncts: List[tuple]) -> bool:
    """True iff every row group is excluded by some conjunct."""
    for rg in md.row_groups:
        if not _rg_excluded(md, rg, conjuncts):
            return False
    return len(md.row_groups) > 0


def _row_group_split_tasks(path: str, md: pf.Footer, columns, out_schema: Schema,
                           conjuncts: List[tuple], split_bytes: int,
                           row_groups_per_task: Optional[int]) -> Optional[List[ScanTask]]:
    """One large file as row-group-aligned tasks of at most about
    ``split_bytes`` on-disk (compressed) bytes each, row groups the zone
    maps exclude dropped; None when the file cannot split (one row group,
    or everything in one task): the caller makes the whole-file task.
    Split tasks read without the predicate (``filters_applied`` False)."""
    from ..ops import counters

    rgs = md.row_groups
    if len(rgs) <= 1:
        return None
    groups: List[List[int]] = []
    sizes: List[int] = []
    rows: List[int] = []
    cur: List[int] = []
    cur_bytes = cur_rows = 0
    pruned = 0
    for i, rg in enumerate(rgs):
        if conjuncts and _rg_excluded(md, rg, conjuncts):
            pruned += 1
            continue
        nb = sum((c.get("meta_data") or {}).get("total_compressed_size", 0)
                 for c in rg["columns"])
        if cur and (cur_bytes + nb > split_bytes
                    or (row_groups_per_task is not None
                        and len(cur) >= row_groups_per_task)):
            groups.append(cur)
            sizes.append(cur_bytes)
            rows.append(cur_rows)
            cur, cur_bytes, cur_rows = [], 0, 0
        cur.append(i)
        cur_bytes += nb
        cur_rows += int(rg["num_rows"])
    if cur:
        groups.append(cur)
        sizes.append(cur_bytes)
        rows.append(cur_rows)
    if len(groups) <= 1:
        return None
    counters.bump("scan_row_groups_pruned", pruned)
    counters.bump("scan_tasks_split", len(groups))

    def make_read(rg_ids: List[int]):
        def read():
            batch_rows = scan_batch_rows()
            pending = None  # a row group's tail, short of a morsel
            for rb in _read_row_groups(path, rg_ids, columns, out_schema):
                start = 0
                if pending is not None:  # a morsel across two row groups
                    head = rb.slice(0, batch_rows - pending.num_rows)
                    pending = RecordBatch.concat([pending, head])
                    start = head.num_rows
                    if pending.num_rows < batch_rows:
                        continue
                    yield MicroPartition(out_schema, [pending])
                    pending = None
                while rb.num_rows - start >= batch_rows:
                    yield MicroPartition(out_schema, [rb.slice(start, start + batch_rows)])
                    start += batch_rows
                if start < rb.num_rows:
                    pending = rb.slice(start, rb.num_rows)
            if pending is not None:
                yield MicroPartition(out_schema, [pending])

        return read

    return [ScanTask(read=_maybe_prefetch(make_read(g)), schema=out_schema, size_bytes=nb,
                     num_rows=nr,
                     filters_applied=False, limit_applied=False,
                     source_label=f"{path}[rg{g[0]}..{g[-1]}]")
            for g, nb, nr in zip(groups, sizes, rows)]


def _read_row_groups(path: str, rg_ids, columns, out_schema: Schema,
                     extra: List[str] = ()) -> Iterator[RecordBatch]:
    """Each listed row group as one RecordBatch of ``out_schema``'s columns
    (and ``extra`` after them), its chunks read and decoded."""
    from ..ops import counters

    footer = pf.read_footer(path)
    by_name = {c.name: c for c in footer.columns}
    names = out_schema.column_names() + [c for c in extra
                                         if c not in out_schema.column_names()]
    with open(path, "rb") as f:
        for i in rg_ids:
            rg = footer.row_groups[i]
            t0 = time.perf_counter()
            cols = []
            for name in names:
                if name not in by_name:
                    raise KeyError(f"{path}: no column {name!r}")
                cols.append(pf.read_column(f, footer, rg, by_name[name]))
            counters.bump("scan_decode_ms", (time.perf_counter() - t0) * 1e3)
            counters.bump("scan_row_groups")
            schema = Schema([Field(s.name, s.dtype) for s in cols])
            yield RecordBatch(schema, cols, int(rg["num_rows"]))


def _maybe_prefetch(read_factory):
    """``read_factory`` decoding ahead on the spill IO pool when the query
    that reads runs under a host memory budget (and the pool and read-ahead
    are on): ``spill_prefetch_batches`` morsels queued, decoding overlapping
    the consumer. Otherwise the factory's own iterator, untouched."""

    def read_prefetched():
        from ..config import execution_config
        from ..memory.manager import manager

        cfg = execution_config()
        if (manager().limit_bytes() > 0 and cfg.spill_io_threads > 0
                and cfg.spill_prefetch_batches > 0):
            from ..memory.spill import prefetch_iter

            yield from prefetch_iter(read_factory, cfg.spill_prefetch_batches,
                                     cfg.spill_io_threads, count=False)
        else:
            yield from read_factory()

    return read_prefetched


def _make_reader(path: str, columns, predicate, conjuncts, limit, out_schema: Schema):
    """A whole-file task's reader: each row group (those the zone maps
    exclude skipped, when the predicate is applied here) in morsels of
    ``morsel_size_rows``, each filtered by ``predicate`` (the host
    evaluator), empty ones included, cut at ``limit`` rows."""
    from ..ops import counters

    def read():
        from ..execution.executor import filter_batch

        footer = pf.read_footer(path)
        keep = []
        for i, rg in enumerate(footer.row_groups):
            if predicate is not None and conjuncts and _rg_excluded(footer, rg, conjuncts):
                counters.bump("scan_row_groups_pruned")
                continue
            keep.append(i)
        extra = predicate.referenced_columns() if predicate is not None else []
        batch_rows = scan_batch_rows()
        produced = 0
        for rb in _read_row_groups(path, keep, columns, out_schema, extra):
            for s in range(0, rb.num_rows, batch_rows):
                if limit is not None and produced >= limit:
                    return
                b = rb.slice(s, s + batch_rows)
                if predicate is not None:
                    b = filter_batch(b, predicate)
                if b.schema != out_schema:
                    b = b.select_columns(out_schema.column_names())
                if limit is not None and produced + b.num_rows > limit:
                    b = b.head(limit - produced)
                produced += b.num_rows
                yield MicroPartition(out_schema, [b])

    return read
