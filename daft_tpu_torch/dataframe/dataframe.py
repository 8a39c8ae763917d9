"""DataFrame: the lazy user-facing API (counterpart of
daft_tpu/dataframe/dataframe.py, the subset the port's slices need):
``where``, ``select``, ``with_column(s)``, ``with_column(s)_renamed``,
``join`` (inner, left, semi, anti, cross), ``distinct``, ``repartition``,
``into_partitions``, ``into_batches``, ``sample``, ``unpivot`` / ``melt``,
``pivot``, ``add_monotonically_increasing_id``, ``groupby(...).agg(...)``
(and its ``map_groups`` and aggregate shortcuts), the ungrouped ``agg``
(and ``sum``, ``mean``, ``min``, ``max``, ``count``, ``count_rows``,
``stddev``, ``var``, ``skew``, ``any_value``, ``describe``), ``sort``,
``limit``, ``offset``, ``exclude``, ``drop_null``, ``drop_nan``, ``pipe``,
``transform``, ``collect``, ``to_pydict``, ``to_pylist``, ``iter_rows``,
``iter_partitions``, ``show``, ``write_parquet`` and ``write_csv``; the
readers (``read_parquet``, ``read_csv``) make a DataFrame over a scan
(``from_scan``). ``explain``, ``explain_analyze`` and ``metrics`` report
the plans and a run's per-operator stats (observability/);
``explain_placement`` the cost model's placement decisions.

Every method appends a logical node; ``collect`` hands the plan to the
runner (runners/native.py), which optimizes it (plan/optimizer.py, as the
reference's ``collect`` does), translates it under the current execution
config and runs it; the result partitions are cached.
With ``device_mode`` "on" or "auto" the configured device is resolved
first, so a query asked to run on a missing card raises instead of running
on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Union

from ..core.micropartition import MicroPartition
from ..expressions.expressions import Alias, Expression, col, lit
from ..plan import logical as lp
from ..schema import Schema

ColumnInput = Union[str, Expression]


def _to_expr(c) -> Expression:
    if isinstance(c, Expression):
        return c
    if isinstance(c, str):
        return col(c)
    return lit(c)


def _to_exprs(cols) -> List[Expression]:
    out: List[Expression] = []
    for c in cols:
        if isinstance(c, (list, tuple)):
            out.extend(_to_exprs(c))
        else:
            out.append(_to_expr(c))
    return out


class DataFrame:
    def __init__(self, plan: lp.LogicalPlan):
        self._plan = plan
        self._result: Optional[List[MicroPartition]] = None

    @property
    def schema(self) -> Schema:
        return self._plan.schema

    @property
    def column_names(self) -> List[str]:
        return self.schema.column_names()

    def __repr__(self) -> str:
        return f"DataFrame(schema={self.schema})"

    @property
    def columns(self) -> List[Expression]:
        """The columns as expressions (the reference's DataFrame.columns)."""
        return [col(f.name) for f in self.schema]

    def num_partitions(self) -> int:
        """The partitions of the materialized result, 1 before it runs."""
        if self._result is not None:
            return len(self._result)
        return 1

    def shuffle(self, seed: Optional[int] = None) -> "DataFrame":
        """The rows in a random order: a sort on a seeded hash of the first
        column, as the reference shuffles."""
        import random as _random

        rng_seed = seed if seed is not None else _random.randrange(2 ** 31)
        tmp = "__shuffle_key__"
        keyed = self.with_column(tmp, col(self.column_names[0]).hash(seed=rng_seed)
                                 if self.column_names else lit(0))
        return keyed.sort(tmp).exclude(tmp)

    def skip_existing(self, existing_path, key_column: Union[str, List[str]],
                      file_format: str = "parquet") -> "DataFrame":
        """The rows whose key is not in the output already written under
        ``existing_path`` (a directory, a file, or a list of them): resume a
        bulk write. Reads only the key columns there."""
        import glob as _glob
        import os as _os

        keys = [key_column] if isinstance(key_column, str) else list(key_column)
        paths = existing_path if isinstance(existing_path, list) else [existing_path]
        readers = {"parquet": read_parquet, "csv": read_csv, "json": read_json}
        if file_format not in readers:
            raise ValueError(f"unsupported file_format {file_format!r}")
        existing = None
        for p in paths:
            if _os.path.isdir(p):
                files = sorted(_glob.glob(_os.path.join(p, f"**/*.{file_format}"),
                                          recursive=True))
            else:
                files = [p] if _os.path.exists(p) else []
            for fp in files:
                part = readers[file_format](fp).select(*[col(k) for k in keys])
                existing = part if existing is None else existing.concat(part)
        if existing is None:
            return self
        kexprs = [col(k) for k in keys]
        return self.join(existing.distinct(), left_on=kexprs, right_on=kexprs, how="anti")

    def to_torch_map_dataset(self):
        """A ``torch.utils.data.Dataset`` of the result's rows (dicts)."""
        from .to_torch import DataFrameMapDataset

        return DataFrameMapDataset(self)

    def to_torch_iter_dataset(self):
        """A ``torch.utils.data.IterableDataset`` streaming the result's rows."""
        from .to_torch import DataFrameIterDataset

        return DataFrameIterDataset(self)

    # ---- observability -----------------------------------------------------------
    def metrics(self):
        """Per-operator execution metrics of the plan as a RecordBatch
        (operator, rows_out, batches, self_time_s): runs the plan under a
        stats collector."""
        from ..core.recordbatch import RecordBatch
        from ..observability.runtime_stats import (StatsCollector, current_collector,
                                                   set_collector)
        from ..runners import get_or_create_runner

        collector = StatsCollector()
        prev = current_collector()
        set_collector(collector)
        try:
            for _ in get_or_create_runner().run_iter(self._plan):
                pass
        finally:
            set_collector(prev)
        rows: Dict[str, list] = {"operator": [], "rows_out": [], "batches": [],
                                 "self_time_s": []}
        for s in collector.finish():
            rows["operator"].append(s.name)
            rows["rows_out"].append(s.rows_out)
            rows["batches"].append(s.batches_out)
            rows["self_time_s"].append(s.seconds)
        return RecordBatch.from_pydict(rows)

    def explain(self, show_all: bool = False) -> str:
        """The unoptimized logical plan; with ``show_all``, the optimized
        plan and the physical plan (under the current execution config)
        too."""
        s = "== Unoptimized Logical Plan ==\n" + self._plan.display()
        if show_all:
            from ..plan.physical import translate

            opt = self.optimized_plan()
            s += "\n\n== Optimized Logical Plan ==\n" + opt.display()
            s += "\n\n== Physical Plan ==\n" + translate(opt).display()
        return s

    def explain_analyze(self, profile: Optional[str] = None) -> str:
        """Run the plan through the runner collecting per-operator runtime
        stats; returns the physical plan, the operator table (rows out,
        batches, self time split into compute / starve / blocked) and the
        query's metrics-registry deltas (device batches, kernel launches,
        spill bytes).

        ``profile="trace.json"`` also writes the query's timeline as Chrome
        trace-event JSON (distributed/trace.py ``QueryTrace.to_chrome_trace``:
        the operators' lanes and the engine's spans, ``device.h2d`` /
        ``device.dispatch`` / ``device.d2h`` among them) — open it in
        Perfetto (ui.perfetto.dev) or chrome://tracing."""
        import json
        import time

        from ..observability.metrics import registry
        from ..observability.runtime_stats import (SpanRecorder, StatsCollector,
                                                   current_collector, current_spans,
                                                   format_stats, set_collector, set_spans)
        from ..plan.physical import translate
        from ..runners import get_or_create_runner

        phys = translate(self.optimized_plan())
        collector = StatsCollector()
        prev = current_collector()
        runner = get_or_create_runner()
        reg_before = registry().snapshot()
        set_collector(collector)
        span_rec = prev_spans = None
        if profile:
            # capture the engine's wall-clock device / scan / spill spans
            span_rec = SpanRecorder()
            prev_spans = current_spans()
            set_spans(span_rec)
        t_wall0 = time.time()
        t0 = time.perf_counter()
        try:
            for _ in runner.run_iter(self._plan):
                pass
        finally:
            set_collector(prev)
            if profile:
                set_spans(prev_spans)
        total = time.perf_counter() - t0
        stats = collector.finish()
        report = ("== Physical Plan ==\n" + phys.display()
                  + "\n\n== Runtime Stats ==\n" + format_stats(stats, total))
        # a distributed runner's trace: its stages, shuffles and workers
        trace = getattr(runner, "last_trace", None)
        if trace is not None and trace.tasks:
            report += "\n\n== Distributed Stages ==\n" + trace.render()
        deltas = registry().diff(reg_before)
        if deltas:
            report += "\n\n== Engine Counters ==\n" + "\n".join(
                f"{k:<32} {v:>12g}" for k, v in sorted(deltas.items()))
        if profile:
            if trace is None:
                from ..distributed.trace import QueryTrace

                # the native runner: an empty trace carries the coordinator lanes
                trace = QueryTrace("")
                trace.started_wall = t_wall0
            data = trace.to_chrome_trace(coordinator_ops=stats, coordinator_spans=span_rec.drain(),
                                         total_seconds=total)
            with open(profile, "w") as f:
                json.dump(data, f)
        return report

    def explain_placement(self) -> str:
        """Run the query and report every placement decision the cost model
        made (observability/placement.py ``render``): the chosen tier, the
        per-term cost table of each priced side (rtt, h2d, probe, compute,
        table, d2h, factorize; the residency credit), the margin (how close
        the losing side was), cached against fresh verdicts, and for
        dispatched device stages the observed seconds and the model's error
        per row. The records also ride ``QueryEnd.placements`` and the
        process ledger behind the dashboard's /api/placement."""
        from ..observability import placement
        from ..runners import get_or_create_runner

        with placement.query_scope() as scope:
            for _ in get_or_create_runner().run_iter(self._plan):
                pass
        return placement.render(scope.records())

    def where(self, predicate: ColumnInput) -> "DataFrame":
        return DataFrame(lp.Filter(self._plan, _to_expr(predicate)))

    filter = where

    def select(self, *columns: ColumnInput) -> "DataFrame":
        """A projection; an ``unnest()`` of a struct column becomes one
        column per field (the reference's dataframe.py:175-195)."""
        from ..expressions.expressions import Unnest

        exprs = _to_exprs(columns)
        if any(isinstance(e, Unnest) for e in exprs):
            expanded = []
            for e in exprs:
                if not isinstance(e, Unnest):
                    expanded.append(e)
                    continue
                dt = e.child.to_field(self.schema).dtype
                if not dt.is_struct():
                    raise ValueError(f"unnest() requires a struct column, got {dt}")
                expanded.extend(e.child.struct.get(f).alias(f) for f, _t in dt.struct_fields)
            exprs = expanded
        return DataFrame(lp.Project(self._plan, exprs))

    def explode(self, *columns: ColumnInput) -> "DataFrame":
        """One row per element of the list columns (dataframe.py:232); a
        null or empty list gives one null row."""
        return DataFrame(lp.Explode(self._plan, _to_exprs(columns)))

    def with_column(self, name: str, expr: ColumnInput) -> "DataFrame":
        """Add (or replace) column ``name``: the other columns keep their
        order and the new one comes last, as in the reference."""
        keep = [col(n) for n in self.column_names if n != name]
        return DataFrame(lp.Project(self._plan, keep + [_to_expr(expr).alias(name)]))

    def with_columns(self, columns: Dict[str, ColumnInput]) -> "DataFrame":
        """Add (or replace) several columns at once, as ``with_column``."""
        new = [_to_expr(e).alias(n) for n, e in columns.items()]
        keep = [col(n) for n in self.column_names if n not in columns]
        return DataFrame(lp.Project(self._plan, keep + new))

    def with_column_renamed(self, existing: str, new: str) -> "DataFrame":
        return self.with_columns_renamed({existing: new})

    def with_columns_renamed(self, mapping: Dict[str, str]) -> "DataFrame":
        """Rename columns in place (the others keep their names and order)."""
        return DataFrame(lp.Project(self._plan, [Alias(col(n), mapping[n]) if n in mapping
                                                 else col(n) for n in self.column_names]))

    def sample(self, fraction: float, with_replacement: bool = False,
               seed: Optional[int] = None) -> "DataFrame":
        """A Bernoulli sample of ``fraction`` of the rows; with a seed and
        without replacement, the same rows as the reference keeps for that
        seed, however the stream is batched."""
        return DataFrame(lp.Sample(self._plan, fraction, with_replacement, seed))

    def unpivot(self, ids: Sequence[ColumnInput], values: Sequence[ColumnInput] = (),
                variable_name: str = "variable", value_name: str = "value") -> "DataFrame":
        """Wide to long: the ``ids``, then the name and value of each of
        ``values`` (every other column when none is given), one row each."""
        ids_ex = _to_exprs(ids if isinstance(ids, (list, tuple)) else [ids])
        if not values:
            id_names = {e.name() for e in ids_ex}
            values = [c for c in self.column_names if c not in id_names]
        vals_ex = _to_exprs(values if isinstance(values, (list, tuple)) else [values])
        return DataFrame(lp.Unpivot(self._plan, ids_ex, vals_ex, variable_name, value_name))

    melt = unpivot

    def pivot(self, group_by: Union[ColumnInput, List[ColumnInput]], pivot_col: ColumnInput,
              value_col: ColumnInput, agg_fn: str,
              names: Optional[List[str]] = None) -> "DataFrame":
        """Long to wide: per ``group_by`` key, one column per distinct value
        of ``pivot_col`` (its ``str``, sorted; ``names`` fixes them) holding
        ``agg_fn`` of ``value_col``. Finding the names runs a query."""
        gb = _to_exprs(group_by if isinstance(group_by, list) else [group_by])
        pc_expr = _to_expr(pivot_col)
        if names is None:
            vals = self.select(pc_expr).distinct().sort(pc_expr.name()) \
                .to_pydict()[pc_expr.name()]
            names = [str(v) for v in vals if v is not None]
        return DataFrame(lp.Pivot(self._plan, gb, pc_expr, _to_expr(value_col), agg_fn,
                                  names))

    def add_monotonically_increasing_id(self, column_name: str = "id") -> "DataFrame":
        """A first uint64 column of increasing ids (the partition in the top
        28 bits, the row within it below)."""
        return DataFrame(lp.MonotonicallyIncreasingId(self._plan, column_name))

    _add_monotonically_increasing_id = add_monotonically_increasing_id

    def into_partitions(self, num: int) -> "DataFrame":
        """The rows, in order, as ``num`` partitions of equal size."""
        return DataFrame(lp.IntoPartitions(self._plan, num))

    def into_batches(self, batch_size: int) -> "DataFrame":
        """The stream re-cut into batches of ``batch_size`` rows."""
        return DataFrame(lp.IntoBatches(self._plan, batch_size))

    def drop_null(self, *cols: ColumnInput) -> "DataFrame":
        """Drop the rows with a null in ``cols`` (in any column if none)."""
        exprs = _to_exprs(cols) if cols else [col(c) for c in self.column_names]
        pred = exprs[0].not_null()
        for e in exprs[1:]:
            pred = pred & e.not_null()
        return self.where(pred)

    def drop_nan(self, *cols: ColumnInput) -> "DataFrame":
        """Drop the rows with a NaN in ``cols`` (in any float column if
        none); a null is kept."""
        exprs = _to_exprs(cols) if cols else \
            [col(f.name) for f in self.schema if f.dtype.is_floating()]
        if not exprs:
            return self
        pred = None
        for e in exprs:
            c = e.is_null() | ~e.float.is_nan()
            pred = c if pred is None else pred & c
        return self.where(pred)

    def pipe(self, fn, *args, **kwargs):
        """``fn(self, *args, **kwargs)``."""
        return fn(self, *args, **kwargs)

    def transform(self, fn, *args, **kwargs) -> "DataFrame":
        """``fn(self, *args, **kwargs)``, which must return a DataFrame."""
        out = fn(self, *args, **kwargs)
        if not isinstance(out, DataFrame):
            raise ValueError(f"transform fn must return a DataFrame, got {type(out).__name__}")
        return out

    def join(self, other: "DataFrame",
             on: Optional[Union[ColumnInput, List[ColumnInput]]] = None,
             left_on: Optional[Union[ColumnInput, List[ColumnInput]]] = None,
             right_on: Optional[Union[ColumnInput, List[ColumnInput]]] = None,
             how: str = "inner", prefix: Optional[str] = None,
             suffix: Optional[str] = None, strategy: Optional[str] = None,
             null_equals_null: bool = False) -> "DataFrame":
        """Equi-join on ``on`` (same names both sides) or on ``left_on`` /
        ``right_on``; ``how`` is "inner", "left", "right", "outer", "semi",
        "anti" or "cross" (no keys). A clashing right column is renamed
        ``<prefix><name><suffix>``; ``null_equals_null`` matches null keys
        to each other."""
        if on is not None:
            left_on = right_on = on
        if how == "cross":
            return DataFrame(lp.Join(self._plan, other._plan, [], [], "cross", prefix,
                                     suffix))
        if left_on is None or right_on is None:
            raise ValueError("join requires `on` or both `left_on` and `right_on`")
        lo = _to_exprs(left_on if isinstance(left_on, list) else [left_on])
        ro = _to_exprs(right_on if isinstance(right_on, list) else [right_on])
        return DataFrame(lp.Join(self._plan, other._plan, lo, ro, how, prefix, suffix,
                                 strategy, null_equals_null))

    # ---- set operations (the reference's dataframe.py:292-380) -----------------------
    def concat(self, other: "DataFrame") -> "DataFrame":
        """This frame's rows, then ``other``'s (the same column names)."""
        return DataFrame(lp.Concat([self._plan, other._plan]))

    union_all = concat

    def union(self, other: "DataFrame") -> "DataFrame":
        return self.concat(other).distinct()

    def union_all_by_name(self, other: "DataFrame") -> "DataFrame":
        """Both frames' rows with columns matched by name; a column one side
        lacks is null there."""
        all_names = list(self.column_names)
        all_names += [n for n in other.column_names if n not in all_names]

        def conform(df: "DataFrame", peer: "DataFrame") -> "DataFrame":
            have = set(df.column_names)
            return df.select(*[col(n) if n in have else
                               lit(None).cast(peer.schema[n].dtype).alias(n)
                               for n in all_names])

        return conform(self, other).concat(conform(other, self))

    def union_by_name(self, other: "DataFrame") -> "DataFrame":
        return self.union_all_by_name(other).distinct()

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """The distinct rows in both (null matches null)."""
        keys = [col(n) for n in self.column_names]
        return self.join(other, left_on=keys, right_on=[col(n) for n in other.column_names],
                         how="semi", null_equals_null=True).distinct()

    def except_distinct(self, other: "DataFrame") -> "DataFrame":
        """The distinct rows of this frame absent from ``other`` (null
        matches null)."""
        keys = [col(n) for n in self.column_names]
        return self.join(other, left_on=keys, right_on=[col(n) for n in other.column_names],
                         how="anti", null_equals_null=True).distinct()

    except_ = except_distinct

    def intersect_all(self, other: "DataFrame") -> "DataFrame":
        """INTERSECT ALL: each row min(l, r) times."""
        return self._multiset_setop(other, "semi")

    def except_all(self, other: "DataFrame") -> "DataFrame":
        """EXCEPT ALL: each row max(l - r, 0) times."""
        return self._multiset_setop(other, "anti")

    def _multiset_setop(self, other: "DataFrame", how: str) -> "DataFrame":
        # numbering each duplicate within its row value turns the multiset
        # operation into a semi / anti join on (columns, occurrence)
        from ..functions.window import row_number
        from ..window import Window

        names = list(self.column_names)
        w = Window().partition_by(*names).order_by(names[0])
        rn = "__occurrence__"
        left = self.with_column(rn, row_number().over(w))
        right = other.with_column(rn, row_number().over(w))
        keys = [col(n) for n in names] + [col(rn)]
        return left.join(right, left_on=keys, right_on=keys, how=how,
                         null_equals_null=True).select(*[col(n) for n in names])

    def exclude(self, *names: str) -> "DataFrame":
        """Every column but ``names``."""
        return self.select(*[col(n) for n in self.column_names if n not in names])

    def distinct(self, *on: ColumnInput) -> "DataFrame":
        """The first row of each distinct value of ``on`` (of every column
        when none is given), in input order."""
        return DataFrame(lp.Distinct(self._plan, _to_exprs(on) if on else None))

    def sort(self, by: Union[ColumnInput, List[ColumnInput]],
             desc: Union[bool, List[bool]] = False,
             nulls_first: Optional[Union[bool, List[bool]]] = None) -> "DataFrame":
        exprs = _to_exprs(by if isinstance(by, list) else [by])
        descending = [desc] * len(exprs) if isinstance(desc, bool) else list(desc)
        if isinstance(nulls_first, bool):
            nulls_first = [nulls_first] * len(exprs)
        return DataFrame(lp.Sort(self._plan, exprs, descending, nulls_first))

    def limit(self, n: int) -> "DataFrame":
        """The first ``n`` rows (after a sort: its top ``n``)."""
        return DataFrame(lp.Limit(self._plan, n))

    def offset(self, n: int) -> "DataFrame":
        """Every row after the first ``n``."""
        return DataFrame(lp.Offset(self._plan, n))

    def repartition(self, num: Optional[int], *partition_by: ColumnInput) -> "DataFrame":
        """``num`` partitions by the hash of ``partition_by``, or at random
        when no key is given."""
        if partition_by:
            return DataFrame(lp.Repartition(self._plan, num, "hash", _to_exprs(partition_by)))
        return DataFrame(lp.Repartition(self._plan, num, "random"))

    def groupby(self, *group_by: ColumnInput) -> "GroupedDataFrame":
        return GroupedDataFrame(self, _to_exprs(group_by))

    group_by = groupby

    def agg(self, *aggs: Expression) -> "DataFrame":
        """Aggregate every row into one."""
        return DataFrame(lp.Aggregate(self._plan, [], _to_exprs(aggs)))

    def sum(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).sum() for c in cols])

    def mean(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).mean() for c in cols])

    def min(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).min() for c in cols])

    def max(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).max() for c in cols])

    def count(self, *cols: ColumnInput) -> "DataFrame":
        """The row count as column ``count``, or each column's valid count."""
        if not cols:
            return self.agg(lit(1).count("all").alias("count"))
        return self.agg(*[_to_expr(c).count() for c in cols])

    def count_rows(self) -> int:
        return self.count().to_pydict()["count"][0]

    def __len__(self) -> int:
        return self.count_rows()

    def stddev(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).stddev() for c in cols])

    def var(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).var() for c in cols])

    def skew(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).skew() for c in cols])

    def any_value(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).any_value() for c in cols])

    def agg_list(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).agg_list() for c in cols])

    list_agg = agg_list

    def agg_set(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).agg_set() for c in cols])

    list_agg_distinct = agg_set

    def agg_concat(self, *cols: ColumnInput) -> "DataFrame":
        return self.agg(*[_to_expr(c).agg_concat() for c in cols])

    def string_agg(self, *cols: ColumnInput, delimiter: str = "") -> "DataFrame":
        """Each column's values listed and joined by ``delimiter`` (the
        reference's dataframe.py:437-443: a list holding a null joins to
        null)."""
        names = [_to_expr(c).name() for c in cols]
        out = self.agg(*[_to_expr(c).agg_list().alias(n) for c, n in zip(cols, names)])
        return out.select(*[col(n).list.join(delimiter).alias(n) for n in names])

    def describe(self) -> "DataFrame":
        """Per numeric column: count, mean, stddev, min and max."""
        aggs = []
        for f in self.schema:
            if f.dtype.is_numeric():
                c = col(f.name)
                aggs += [c.count().alias(f"{f.name}_count"), c.mean().alias(f"{f.name}_mean"),
                         c.stddev().alias(f"{f.name}_stddev"), c.min().alias(f"{f.name}_min"),
                         c.max().alias(f"{f.name}_max")]
        if not aggs:
            raise ValueError("describe() needs at least one numeric column")
        return self.agg(*aggs)

    summarize = describe

    def write_parquet(self, root_dir: str, compression: str = "snappy",
                      partition_cols: Optional[List[ColumnInput]] = None,
                      write_mode: str = "append", checkpoint=None) -> "DataFrame":
        """Write the rows as Parquet files under ``root_dir`` (hive-style
        directories by ``partition_cols``; ``write_mode`` "append" or
        "overwrite"); returns the collected frame of written paths.
        ``checkpoint=(CheckpointStore, key_column)`` resumes: rows whose key
        a former run sealed are skipped (checkpoint/__init__.py)."""
        from ..io.writers import WriteInfo

        return self._write(WriteInfo("parquet", root_dir, {"compression": compression},
                                     _to_exprs(partition_cols) if partition_cols else None,
                                     write_mode, checkpoint=checkpoint))

    def write_csv(self, root_dir: str, partition_cols: Optional[List[ColumnInput]] = None,
                  write_mode: str = "append") -> "DataFrame":
        """Write the rows as CSV files under ``root_dir``, as write_parquet."""
        from ..io.writers import WriteInfo

        return self._write(WriteInfo("csv", root_dir, {},
                                     _to_exprs(partition_cols) if partition_cols else None,
                                     write_mode))

    def write_json(self, root_dir: str, write_mode: str = "append",
                   partition_cols: Optional[List[ColumnInput]] = None) -> "DataFrame":
        """Write the rows as JSON-lines files (``.jsonl``) under ``root_dir``,
        as write_csv."""
        from ..io.writers import WriteInfo

        return self._write(WriteInfo("json", root_dir, {},
                                     _to_exprs(partition_cols) if partition_cols else None,
                                     write_mode))

    def _write(self, info) -> "DataFrame":
        return DataFrame(lp.Sink(self._plan, info)).collect()

    def _materialize(self) -> List[MicroPartition]:
        if self._result is None:
            from ..runners import get_or_create_runner

            self._result = get_or_create_runner().run(self._plan)
        return self._result

    def optimized_plan(self) -> lp.LogicalPlan:
        """The logical plan as ``collect`` runs it."""
        from ..plan.optimizer import Optimizer

        return Optimizer().optimize(self._plan)

    def collect(self) -> "DataFrame":
        parts = self._materialize()
        for p in parts:
            p.hold()
        out = DataFrame(lp.InMemorySource(self.schema, parts))
        out._result = parts
        return out

    def to_pydict(self) -> Dict[str, list]:
        parts = self._materialize()
        if not parts:
            return {name: [] for name in self.column_names}
        return MicroPartition.concat(parts).to_pydict()

    def iter_partitions(self) -> Iterator[MicroPartition]:
        """The result partitions, streamed as the plan produces them (or the
        collected ones)."""
        if self._result is not None:
            yield from self._result
            return
        from ..runners import get_or_create_runner

        yield from get_or_create_runner().run_iter(self._plan)

    def iter_rows(self) -> Iterator[Dict[str, Any]]:
        """Each result row as a dict."""
        for part in self.iter_partitions():
            for b in part.batches:
                d = b.to_pydict()
                names = list(d)
                for i in range(b.num_rows):
                    yield {n: d[n][i] for n in names}

    def __iter__(self):
        return self.iter_rows()

    def to_pylist(self) -> List[Dict[str, Any]]:
        return list(self.iter_rows())

    def show(self, n: int = 8) -> None:
        """Print the first ``n`` rows as a table, as the reference prints it."""
        print(self._preview_string(n))

    def _preview_string(self, n: int = 8) -> str:
        d = self.limit(n).to_pydict()
        names = self.column_names
        dtypes = [str(self.schema[c].dtype) for c in names]
        rows = len(d[names[0]]) if names else 0

        def fmt(v) -> str:
            s = "None" if v is None else str(v)
            return s if len(s) <= 30 else s[:29] + "…"

        cols = [[fmt(v) for v in d[c]] for c in names]
        widths = [max(len(c), len(t), *(len(v) for v in vs) if vs else (0,))
                  for c, t, vs in zip(names, dtypes, cols)]
        lines = ["╭" + "┬".join("─" * (w + 2) for w in widths) + "╮",
                 "│" + "│".join(f" {c:<{w}} " for c, w in zip(names, widths)) + "│",
                 "│" + "│".join(f" {t:<{w}} " for t, w in zip(dtypes, widths)) + "│",
                 "├" + "┼".join("─" * (w + 2) for w in widths) + "┤"]
        for i in range(rows):
            cells = (f" {vs[i]:<{w}} " for vs, w in zip(cols, widths))
            lines.append("│" + "│".join(cells) + "│")
        lines.append("╰" + "┴".join("─" * (w + 2) for w in widths) + "╯")
        lines.append(f"(Showing {rows} rows)")
        return "\n".join(lines)


def from_scan(scan_op) -> DataFrame:
    """A DataFrame over a ScanOperator (io/scan.py)."""
    return DataFrame(lp.ScanSource(scan_op))


def read_parquet(path, **options) -> DataFrame:
    """A DataFrame over Parquet files: a path, a directory, a glob or a
    list of them (``schema=``, ``row_groups_per_task=``)."""
    from ..io.parquet import ParquetScanOperator

    return from_scan(ParquetScanOperator(path, **options))


def read_csv(path, **options) -> DataFrame:
    """A DataFrame over CSV files (``has_headers=``, ``delimiter=``,
    ``schema=``)."""
    from ..io.csv import CsvScanOperator

    return from_scan(CsvScanOperator(path, **options))


def read_json(path, **options) -> DataFrame:
    """A DataFrame over line-delimited JSON files (``.json``, ``.jsonl``,
    ``.ndjson``; ``schema=``)."""
    from ..io.json import JsonScanOperator

    return from_scan(JsonScanOperator(path, **options))


def read_text(path, **options) -> DataFrame:
    """A DataFrame of the lines of text files: one string column ``text``
    (``.gz`` read too)."""
    from ..io.text import TextScanOperator

    return from_scan(TextScanOperator(path, **options))


def read_warc(path, **options) -> DataFrame:
    """A DataFrame of the records of WARC (Common Crawl) files, a row per
    record (``.gz`` read too)."""
    from ..io.warc import WarcScanOperator

    return from_scan(WarcScanOperator(path, **options))


class GroupedDataFrame:
    def __init__(self, df: DataFrame, group_by: List[Expression]):
        self._df = df
        self._group_by = group_by

    def agg(self, *aggs: Expression) -> DataFrame:
        return DataFrame(lp.Aggregate(self._df._plan, self._group_by, _to_exprs(aggs)))

    def sum(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).sum() for c in cols])

    def mean(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).mean() for c in cols])

    def min(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).min() for c in cols])

    def max(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).max() for c in cols])

    def count(self, *cols: ColumnInput) -> DataFrame:
        if not cols:
            return self.agg(lit(1).count("all").alias("count"))
        return self.agg(*[_to_expr(c).count() for c in cols])

    def any_value(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).any_value() for c in cols])

    def stddev(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).stddev() for c in cols])

    def var(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).var() for c in cols])

    def skew(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).skew() for c in cols])

    def agg_list(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).agg_list() for c in cols])

    def agg_concat(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).agg_concat() for c in cols])

    def agg_set(self, *cols: ColumnInput) -> DataFrame:
        return self.agg(*[_to_expr(c).agg_set() for c in cols])

    list_agg = agg_list
    list_agg_distinct = agg_set

    def string_agg(self, *cols: ColumnInput, delimiter: str = "") -> DataFrame:
        """As ``DataFrame.string_agg`` per group (dataframe.py:793-802)."""
        names = [_to_expr(c).name() for c in cols]
        out = self.agg(*[_to_expr(c).agg_list().alias(n) for c, n in zip(cols, names)])
        keep = [col(e.name()) for e in self._group_by]
        keep += [col(n).list.join(delimiter).alias(n) for n in names]
        return out.select(*keep)

    def map_groups(self, udf_expr: Expression) -> DataFrame:
        """A UDF over each group's rows; it may emit any number of rows per
        group, each with the group's keys."""
        return DataFrame(lp.MapGroups(self._df._plan, self._group_by, udf_expr))
