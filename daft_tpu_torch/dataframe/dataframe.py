"""DataFrame: the lazy user-facing API (counterpart of
daft_tpu/dataframe/dataframe.py, the subset the port's slices need):
``where``, ``select``, ``with_column``, ``join`` (inner, left, semi, anti,
cross), ``distinct``, ``repartition``,
``groupby(...).agg(...)``, the ungrouped ``agg`` (and ``sum``, ``mean``,
``min``, ``max``, ``count``), ``sort``, ``limit``, ``offset``, ``exclude``,
``collect``, ``to_pydict``, ``write_parquet`` and ``write_csv``; the
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

from typing import Dict, List, Optional, Union

from ..core.micropartition import MicroPartition
from ..expressions.expressions import Expression, col, lit
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
        deltas = registry().diff(reg_before)
        if deltas:
            report += "\n\n== Engine Counters ==\n" + "\n".join(
                f"{k:<32} {v:>12g}" for k, v in sorted(deltas.items()))
        if profile:
            from ..distributed.trace import QueryTrace

            # no workers in the port: an empty trace carries the coordinator lanes
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
        return DataFrame(lp.Project(self._plan, _to_exprs(columns)))

    def with_column(self, name: str, expr: ColumnInput) -> "DataFrame":
        """Add (or replace) column ``name``: the other columns keep their
        order and the new one comes last, as in the reference."""
        keep = [col(n) for n in self.column_names if n != name]
        return DataFrame(lp.Project(self._plan, keep + [_to_expr(expr).alias(name)]))

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

    def write_parquet(self, root_dir: str, compression: str = "snappy",
                      partition_cols: Optional[List[ColumnInput]] = None,
                      write_mode: str = "append") -> "DataFrame":
        """Write the rows as Parquet files under ``root_dir`` (hive-style
        directories by ``partition_cols``; ``write_mode`` "append" or
        "overwrite"); returns the collected frame of written paths."""
        from ..io.writers import WriteInfo

        return self._write(WriteInfo("parquet", root_dir, {"compression": compression},
                                     _to_exprs(partition_cols) if partition_cols else None,
                                     write_mode))

    def write_csv(self, root_dir: str, partition_cols: Optional[List[ColumnInput]] = None,
                  write_mode: str = "append") -> "DataFrame":
        """Write the rows as CSV files under ``root_dir``, as write_parquet."""
        from ..io.writers import WriteInfo

        return self._write(WriteInfo("csv", root_dir, {},
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


class GroupedDataFrame:
    def __init__(self, df: DataFrame, group_by: List[Expression]):
        self._df = df
        self._group_by = group_by

    def agg(self, *aggs: Expression) -> DataFrame:
        return DataFrame(lp.Aggregate(self._df._plan, self._group_by, _to_exprs(aggs)))
