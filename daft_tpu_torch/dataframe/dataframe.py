"""DataFrame: the lazy user-facing API (counterpart of
daft_tpu/dataframe/dataframe.py, the subset the port's slices need):
``where``, ``select``, ``with_column``, ``join`` (inner, left, semi, anti,
cross), ``distinct``, ``repartition``,
``groupby(...).agg(...)``, the ungrouped ``agg`` (and ``sum``, ``mean``,
``min``, ``max``, ``count``), ``sort``, ``limit``, ``offset``, ``exclude``,
``collect`` and ``to_pydict``.

Every method appends a logical node; ``collect`` optimizes the plan
(plan/optimizer.py, as the reference's ``collect`` does), translates it
under the current execution config and runs it, caching the result
partitions.
With ``device_mode="on"`` the configured device is resolved first, so a
query asked to run on a missing card raises instead of running on the CPU.
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
             how: str = "inner") -> "DataFrame":
        """Equi-join on ``on`` (same names both sides) or on ``left_on`` /
        ``right_on``; ``how`` is "inner", "left", "semi", "anti" or "cross"
        (no keys)."""
        if on is not None:
            left_on = right_on = on
        if how == "cross":
            return DataFrame(lp.Join(self._plan, other._plan, [], [], "cross"))
        if left_on is None or right_on is None:
            raise ValueError("join requires `on` or both `left_on` and `right_on`")
        lo = _to_exprs(left_on if isinstance(left_on, list) else [left_on])
        ro = _to_exprs(right_on if isinstance(right_on, list) else [right_on])
        return DataFrame(lp.Join(self._plan, other._plan, lo, ro, how))

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

    def _materialize(self) -> List[MicroPartition]:
        if self._result is None:
            from ..config import execution_config
            from ..execution.executor import execute_plan
            from ..plan.physical import translate
            from ..utils.torch_setup import resolve_device

            if execution_config().device_mode == "on":
                resolve_device(execution_config().device)
            self._result = list(execute_plan(translate(self.optimized_plan())))
        return self._result

    def optimized_plan(self) -> lp.LogicalPlan:
        """The logical plan as ``collect`` runs it."""
        from ..plan.optimizer import Optimizer

        return Optimizer().optimize(self._plan)

    def collect(self) -> "DataFrame":
        parts = self._materialize()
        out = DataFrame(lp.InMemorySource(self.schema, parts))
        out._result = parts
        return out

    def to_pydict(self) -> Dict[str, list]:
        parts = self._materialize()
        if not parts:
            return {name: [] for name in self.column_names}
        return MicroPartition.concat(parts).to_pydict()


class GroupedDataFrame:
    def __init__(self, df: DataFrame, group_by: List[Expression]):
        self._df = df
        self._group_by = group_by

    def agg(self, *aggs: Expression) -> DataFrame:
        return DataFrame(lp.Aggregate(self._df._plan, self._group_by, _to_exprs(aggs)))
