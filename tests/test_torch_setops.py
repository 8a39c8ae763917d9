"""Concat, the DataFrame set operations, right / outer / null-matching joins
and the SQL set operations and grouping sets, against the reference
(daft_tpu/plan/logical.py:546, dataframe.py:292-380, sql/parser.py:673-680,
803-830, planner.py:589).

Every case runs over the same rows in both packages (duplicates, nulls in
every column) and equals the reference's host, under device_mode "on"
(device="cpu") and "off", and under a host memory budget that
Grace-partitions the joins. A Concat passes its inputs' streams through:
each input keeps its own plan (a device aggregate under one arm stays that
arm's), and an aggregate over a Concat does not reach into its inputs.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch.ops import counters
from daft_tpu_torch.plan import logical as lp
from daft_tpu_torch.plan import physical as pp

A = {"x": [1, 2, 2, 3, None, None, 5, 2], "y": ["a", "b", "b", "c", None, None, "e", "b"]}
B = {"x": [2, 2, 2, None, 7, 3, None], "y": ["b", "b", "b", None, "g", "z", "q"]}


def _frames(m):
    return m.from_pydict(A), m.from_pydict(B)


SETOPS = ["concat", "union", "union_all", "intersect", "intersect_all", "except_distinct",
          "except_all", "union_by_name", "union_all_by_name"]
JOINS = ["inner", "left", "right", "outer", "semi", "anti"]


def _cases():
    out = {}
    for name in SETOPS:
        out[name] = lambda m, a, b, _n=name: getattr(a, _n)(b).sort(["x", "y"])
    for how in JOINS:
        out[f"join_{how}"] = lambda m, a, b, _h=how: a.join(
            b, on="x", how=_h, suffix="_r").sort(a.join(b, on="x", how=_h, suffix="_r")
                                                 .column_names)
        out[f"join_{how}_nulls"] = lambda m, a, b, _h=how: a.join(
            b, left_on=["x", "y"], right_on=["x", "y"], how=_h,
            null_equals_null=True).sort(["x", "y"])
    out["join_outer_keys"] = lambda m, a, b: a.join(
        b.select(m.col("x").alias("k"), "y"), left_on="x", right_on="k",
        how="outer").sort(["x", "k", "y", "right.y"])
    out["union_by_name_cols"] = lambda m, a, b: a.union_all_by_name(
        b.select("y", (m.col("x") * 10).alias("z"))).sort(["x", "y", "z"])
    out["concat_agg"] = lambda m, a, b: a.concat(b).groupby("y").agg(
        m.col("x").sum().alias("s"), m.col("x").count().alias("n")).sort("y")
    out["concat_of_aggs"] = lambda m, a, b: a.groupby("y").agg(
        m.col("x").sum().alias("s")).concat(b.groupby("y").agg(
            m.col("x").sum().alias("s"))).sort(["y", "s"])
    return out


CASES = _cases()


def _same(got, want):
    assert got == want


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("mode", ["on", "off", "budget"])
def test_dataframe_case_matches_the_reference(name, mode, tmp_path):
    ra, rb = _frames(daft_tpu)
    with ref_ctx(device_mode="off"):
        want = CASES[name](daft_tpu, ra, rb).to_pydict()
    pa_, pb = _frames(daft_tpu_torch)
    cfg = {"device": "cpu", "device_mode": "on" if mode == "on" else "off"}
    if mode == "budget":
        cfg.update(memory_limit_bytes=64, spill_dir=str(tmp_path))
    with daft_tpu_torch.execution_config_ctx(**cfg):
        got = CASES[name](daft_tpu_torch, pa_, pb).to_pydict()
    _same(got, want)


def test_concat_keeps_each_inputs_plan():
    """Each arm of a Concat keeps its own placement: a device grouped
    aggregate under one arm runs there, the other arm's host aggregate
    stays on the host, and an aggregate over the Concat plans over the
    Concat's stream (it does not fuse into either arm)."""
    rng = np.random.default_rng(1)
    big = daft_tpu_torch.from_pydict({"k": rng.integers(0, 5, 4000),
                                      "v": rng.integers(0, 9, 4000)})
    small = daft_tpu_torch.from_pydict({"k": [1, 2], "v": [3, 4]})
    col = daft_tpu_torch.col
    arm1 = big.groupby("k").agg(col("v").sum().alias("v"))
    arm2 = small.groupby("k").agg(col("v").count_distinct().alias("v")).select(
        "k", col("v").cast(daft_tpu_torch.DataType.int64()))
    df = arm1.concat(arm2)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        plan = pp.translate(df.optimized_plan())
        assert isinstance(plan, pp.PhysConcat)
        kinds = [type(c).__name__ for c in plan.inputs]
        assert kinds[0] == "DeviceGroupedAgg"
        assert not any(type(n).__name__.startswith("Device") for n in _walk(plan.inputs[1]))
        counters.reset()
        got = df.to_pydict()
        assert counters.device_grouped_batches == 1
        outer = df.groupby("k").agg(col("v").sum().alias("t"))
        top = pp.translate(outer.optimized_plan())
        assert any(isinstance(n, pp.PhysConcat) for n in _walk(top))
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        assert got == df.to_pydict()
    assert isinstance(df._plan, lp.Concat)


def _walk(n):
    yield n
    for c in n.children():
        yield from _walk(c)


def test_concat_refuses_mismatched_columns():
    a, b = _frames(daft_tpu_torch)
    with pytest.raises(ValueError, match="matching schemas"):
        a.concat(b.select("y", "x"))


SQL = [
    "SELECT x, y FROM a UNION ALL SELECT x, y FROM b ORDER BY x, y",
    "SELECT x, y FROM a UNION SELECT x, y FROM b ORDER BY x, y",
    "SELECT x, y FROM a INTERSECT SELECT x, y FROM b ORDER BY x, y",
    "SELECT x, y FROM a EXCEPT SELECT x, y FROM b ORDER BY x, y",
    "SELECT x FROM a UNION ALL SELECT x FROM b UNION SELECT 9 ORDER BY x",
    "SELECT y AS w FROM a UNION ALL SELECT y FROM b ORDER BY w LIMIT 4",
    "SELECT y, SUM(x) AS s, COUNT(*) AS n FROM a GROUP BY ROLLUP(y) ORDER BY y, s",
    "SELECT x, y, COUNT(*) AS n FROM b GROUP BY CUBE(x, y) ORDER BY x, y, n",
    "SELECT x, y, SUM(x) AS s FROM a GROUP BY GROUPING SETS ((x, y), (y), ()) "
    "ORDER BY x, y, s",
    "SELECT a.x AS ax, a.y AS ay, b.y AS by FROM a FULL OUTER JOIN b ON a.x = b.x "
    "ORDER BY ax, ay, by",
    "SELECT a.y AS ay, b.x AS bx FROM a RIGHT JOIN b ON a.x = b.x ORDER BY bx, ay",
]


@pytest.mark.parametrize("i", range(len(SQL)))
def test_sql_set_operations_and_grouping_sets(i):
    ra, rb = _frames(daft_tpu)
    with ref_ctx(device_mode="off"):
        want = daft_tpu.sql(SQL[i], a=ra, b=rb).to_pydict()
    pa_, pb = _frames(daft_tpu_torch)
    for mode in ("on", "off"):
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode=mode):
            assert daft_tpu_torch.sql(SQL[i], a=pa_, b=pb).to_pydict() == want
