"""Explode and the list aggregates against the reference: ``explode``
(null and empty lists, several columns, lengths that disagree), ``agg_list``,
``agg_set``, ``agg_concat``, ``product`` and ``string_agg`` ungrouped,
grouped and over a window, their DataFrame and grouped-frame forms, SQL's
ARRAY_AGG and LIST_AGG, the two-phase and budgeted (spilling) arms, and
the device capture: exploded lists feed the grouped stage, a Project of list
functions and an aggregate list holding ``agg_list`` stay on the host with a
counted rejection and the reference's result.

Inputs come from a numpy seed and go through ``daft_tpu`` and
``daft_tpu_torch`` alike; outputs compare by ``to_pydict``: ints, strings
and structure exactly, float sums within rtol 1e-9 (products of floats
within rtol 1e-12). A hypothesis round trip holds explode(agg_list(x)) to
x's rows.
"""

import math

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import daft_tpu
import daft_tpu_torch as dt
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.datatype import DataType as RD
from daft_tpu_torch.datatype import DataType as PD
from daft_tpu_torch.ops import counters


def _data(seed=3, n=400):
    rng = np.random.default_rng(seed)
    lens = rng.integers(0, 5, n)
    lists = [None if rng.random() < 0.1 else
             [None if rng.random() < 0.1 else int(v) for v in rng.integers(-9, 9, k)]
             for k in lens]
    x = [None if rng.random() < 0.1 else int(v) for v in rng.integers(-5, 20, n)]
    return {
        "k": [int(v) for v in rng.integers(0, 7, n)],
        "x": x,
        "f": [None if v is None else v / 4 for v in x],
        "s": [None if rng.random() < 0.1 else "w" + str(int(v)) for v in rng.integers(0, 6, n)],
        "l": lists,
        "o": list(range(n)),
    }


def _frames(data, types=None):
    types = types or {}
    ref = daft_tpu.from_pydict({c: daft_tpu.Series.from_pylist(v, c, types[c][1])
                                if c in types else v for c, v in data.items()})
    port = dt.from_pydict({c: dt.Series.from_pylist(v, c, types[c][0])
                           if c in types else v for c, v in data.items()})
    return ref, port


LIST_T = {"l": (PD.list(PD.int64()), RD.list(RD.int64()))}


def _ref(q):
    with ref_ctx(device_mode="off"):
        return q.to_pydict()


def _port(q, **cfg):
    with dt.execution_config_ctx(device="cpu", **cfg):
        return q.to_pydict()


def _same(got, want, floats=()):
    assert list(got) == list(want)
    for c in got:
        if c in floats:
            g, w = got[c], want[c]
            assert [v is None for v in g] == [v is None for v in w], c
            for a, b in zip(g, w):
                if a is not None:
                    assert math.isclose(a, b, rel_tol=1e-9) or (a != a and b != b), (c, a, b)
        else:
            assert got[c] == want[c], c


# ---- explode -----------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["off", "on"])
def test_explode_matches_the_reference(mode):
    ref, port = _frames(_data(), LIST_T)
    want = _ref(ref.explode("l"))
    _same(_port(port.explode("l"), device_mode=mode), want)


def test_explode_several_columns_and_lengths_that_disagree():
    data = {"a": [[1, 2], None, [], [3]], "b": [["x", "y"], None, [], ["z"]],
            "c": [[1], [2], [3], [4, 5]], "k": [1, 2, 3, 4]}
    ref, port = _frames(data)
    _same(_port(port.explode("a", "b")), _ref(ref.explode("a", "b")))
    for q in (ref.explode("a", "c"), port.explode("a", "c")):
        with pytest.raises(ValueError, match="matching list lengths"):
            _port(q) if q is not None and q.__class__.__module__.startswith(
                "daft_tpu_torch") else _ref(q)


def test_explode_a_non_list_column_raises_in_both():
    ref, port = _frames({"a": [1, 2]})
    with pytest.raises(ValueError):
        _ref(ref.explode("a"))
    with pytest.raises(ValueError):
        _port(port.explode("a"))


@pytest.mark.parametrize("pipeline", ["off", "force"])
def test_explode_under_a_device_aggregate_rides_the_grouped_stage(pipeline):
    data = _data(5, 3000)
    ref, port = _frames(data, LIST_T)
    def q(df, m):
        return (df.explode("l").groupby("l")
                .agg(m.col("o").count().alias("n"), m.col("o").sum().alias("so"),
                     m.col("f").max().alias("fm"), m.col("k").min().alias("km"))
                .sort("l"))
    want = _ref(q(ref, daft_tpu))
    counters.reset()
    got = _port(q(port, dt), device_mode="on", device_min_rows=1, pipeline_mode=pipeline,
                morsel_size_rows=1024)
    assert counters.snapshot()["device_grouped_batches"] >= 1
    assert counters.snapshot()["plain_segment_sum_planes"] >= 1
    _same(got, want)


def test_the_device_stage_never_sees_a_list_column():
    """An explode whose other list columns are unreferenced: the stage
    reads the exploded planes alone (pruned), and a list group key keeps
    the aggregate on the host with a counted rejection."""
    data = _data(6, 500)
    data["l2"] = data["l"]
    types = dict(LIST_T, l2=LIST_T["l"])
    ref, port = _frames(data, types)
    seen = []
    from daft_tpu_torch.core.series import Series
    real = Series.to_device

    def spy(self, *a, **k):
        seen.append(self.dtype)
        return real(self, *a, **k)

    Series.to_device = spy
    try:
        counters.rejections.clear()
        got = _port(port.explode("l").groupby("k").agg(dt.col("l").sum()).sort("k"),
                    device_mode="on", device_min_rows=1)
        got2 = _port(port.groupby("l2").agg(dt.col("o").count()).sort("o"),
                     device_mode="on", device_min_rows=1)
    finally:
        Series.to_device = real
    assert seen and not any(d.is_nested() for d in seen), seen
    assert any("nested" in r for r in counters.rejections), dict(counters.rejections)
    _same(got, _ref(ref.explode("l").groupby("k").agg(daft_tpu.col("l").sum()).sort("k")))
    with ref_ctx(device_mode="off"):
        want2 = ref.groupby("l2").agg(daft_tpu.col("o").count()).sort("o").to_pydict()
    assert sorted(map(repr, zip(*got2.values()))) == sorted(map(repr, zip(*want2.values())))


# ---- the list aggregates -----------------------------------------------------------------


def _aggs(m):
    c = m.col
    return [c("x").agg_list().alias("xl"), c("s").agg_list().alias("sl"),
            c("x").agg_set().alias("xs"), c("s").agg_set().alias("ss"),
            c("f").agg_set().alias("fs"), c("l").agg_concat().alias("lc"),
            c("x").product().alias("xp"), c("f").product().alias("fp"),
            c("s").string_agg(",").alias("sa"), c("l").agg_list().alias("ll")]


@pytest.mark.parametrize("morsel", [None, 64])
def test_list_aggregates_grouped_match_the_reference(morsel):
    ref, port = _frames(_data(), LIST_T)
    want = _ref(ref.groupby("k").agg(*_aggs(daft_tpu)).sort("k"))
    cfg = {"morsel_size_rows": morsel} if morsel else {}
    _same(_port(port.groupby("k").agg(*_aggs(dt)).sort("k"), device_mode="on", **cfg), want,
          ("fp",))


@pytest.mark.parametrize("morsel", [None, 64])
def test_list_aggregates_ungrouped_match_the_reference(morsel):
    ref, port = _frames(_data(), LIST_T)
    want = _ref(ref.agg(*_aggs(daft_tpu)))
    cfg = {"morsel_size_rows": morsel} if morsel else {}
    _same(_port(port.agg(*_aggs(dt)), **cfg), want, ("fp",))


def test_list_aggregates_over_empty_and_all_null_input():
    data = {"k": [1, 1, 2], "x": [None, None, None], "s": [None, None, None],
            "l": [None, None, None]}
    types = {"x": (PD.int64(), RD.int64()), "s": (PD.string(), RD.string()),
             "l": LIST_T["l"]}
    ref, port = _frames(data, types)
    for q in (lambda df, m: df.groupby("k").agg(
            m.col("x").agg_list(), m.col("x").agg_set().alias("xs"),
            m.col("l").agg_concat(), m.col("x").product().alias("p"),
            m.col("s").string_agg("-")).sort("k"),
              lambda df, m: df.agg(m.col("x").agg_list(), m.col("x").agg_set().alias("xs"),
                                   m.col("l").agg_concat(), m.col("x").product().alias("p"),
                                   m.col("s").string_agg("-")),
              lambda df, m: df.where(m.col("k") > 5).agg(
                  m.col("x").agg_list(), m.col("l").agg_concat(),
                  m.col("x").agg_set().alias("xs"))):
        _same(_port(q(port, dt)), _ref(q(ref, daft_tpu)))


def test_frame_and_grouped_frame_forms_match_the_reference():
    ref, port = _frames(_data(), LIST_T)
    for q in (lambda df: df.agg_list("x", "s"), lambda df: df.agg_set("s"),
              lambda df: df.agg_concat("l"), lambda df: df.string_agg("s", delimiter="|"),
              lambda df: df.groupby("k").agg_list("x").sort("k"),
              lambda df: df.groupby("k").agg_set("s").sort("k"),
              lambda df: df.groupby("k").agg_concat("l").sort("k"),
              lambda df: df.groupby("k").list_agg_distinct("x").sort("k"),
              lambda df: df.groupby("k").string_agg("s", delimiter="|").sort("k")):
        _same(_port(q(port)), _ref(q(ref)))


@pytest.mark.parametrize("sql", [
    "SELECT k, ARRAY_AGG(x) AS a, LIST_AGG(s) AS b FROM t GROUP BY k ORDER BY k",
    "SELECT ARRAY_AGG(s) AS a FROM t",
    "SELECT k, LIST_SUM(ARRAY_AGG(x)) AS n FROM t GROUP BY k ORDER BY k",
])
def test_sql_list_aggregates_match_the_reference(sql):
    ref, port = _frames(_data(), LIST_T)
    with ref_ctx(device_mode="off"):
        try:
            want = daft_tpu.sql(sql, t=ref).to_pydict()
        except Exception as exc:  # noqa: BLE001 -- the port refuses alike
            with pytest.raises(next(b for b in type(exc).__mro__
                                    if b.__module__ == "builtins")):
                _port(dt.sql(sql, t=port))
            return
    _same(_port(dt.sql(sql, t=port)), want)


@pytest.mark.parametrize("op", ["agg_list", "agg_set", "agg_concat", "product"])
def test_list_aggregates_over_a_window_are_refused_as_in_the_reference(op):
    ref, port = _frames(_data(), LIST_T)
    for m, df, run in ((daft_tpu, ref, _ref), (dt, port, _port)):
        w = m.Window().partition_by("k")
        child = m.col("l") if op == "agg_concat" else m.col("x")
        with pytest.raises(ValueError):
            run(df.select(getattr(child, op)().over(w).alias("w")))


def test_budgeted_list_aggregates_spill_and_equal_the_unbudgeted(tmp_path):
    ref, port = _frames(_data(9, 4000), LIST_T)
    def q():  # a fresh frame each run: a collected frame keeps its result
        return port.groupby("k").agg(*_aggs(dt)).sort("k")

    want = _port(q(), device_mode="off")
    counters.reset()
    got = _port(q(), device_mode="off", memory_limit_bytes=20_000, spill_dir=str(tmp_path),
                morsel_size_rows=256)
    assert counters.snapshot()["spill_files"] > 0
    _same(got, want, ("fp",))
    counters.reset()
    sorted_ = _port(port.sort("x").select("l", "x", "o"), device_mode="off",
                    memory_limit_bytes=20_000, spill_dir=str(tmp_path))
    assert counters.snapshot()["spill_runs"] >= 1
    _same(sorted_, _port(port.sort("x").select("l", "x", "o"), device_mode="off"))


# ---- device capture ----------------------------------------------------------------------


def test_list_functions_under_an_aggregate_stay_on_the_host_with_a_rejection():
    ref, port = _frames(_data(), LIST_T)
    def q(df, m):
        return (df.with_column("n", m.col("l").list.length().cast(
            (PD if m is dt else RD).int64()))
            .with_column("y", m.col("x") * 2)
            .groupby("k").agg(m.col("n").sum(), m.col("y").max()).sort("k"))
    counters.rejections.clear()
    counters.reset()
    got = _port(q(port, dt), device_mode="on", device_min_rows=1)
    assert counters.snapshot()["device_grouped_batches"] >= 1
    assert any("nested operand" in r for r in counters.rejections), dict(counters.rejections)
    _same(got, _ref(q(ref, daft_tpu)))


def test_an_aggregate_list_holding_agg_list_runs_on_the_host_with_a_rejection():
    ref, port = _frames(_data(), LIST_T)
    def q(df, m):
        return df.groupby("k").agg(m.col("x").sum(), m.col("x").agg_list().alias("xl"),
                                   m.col("x").product().alias("p")).sort("k")
    counters.rejections.clear()
    counters.reset()
    got = _port(q(port, dt), device_mode="on", device_min_rows=1)
    assert counters.snapshot()["device_grouped_batches"] == 0
    assert any("bare sum" in r for r in counters.rejections), dict(counters.rejections)
    _same(got, _ref(q(ref, daft_tpu)))
    counters.rejections.clear()
    got = _port(port.agg(dt.col("x").sum(), dt.col("s").string_agg(",")),
                device_mode="on", device_min_rows=1)
    assert counters.rejections
    _same(got, _ref(ref.agg(daft_tpu.col("x").sum(), daft_tpu.col("s").string_agg(","))))


# ---- round trips -------------------------------------------------------------------------


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.tuples(st.integers(0, 4), st.one_of(st.none(), st.integers(-50, 50))),
                min_size=0, max_size=40))
def test_explode_of_agg_list_gives_back_the_rows(rows):
    keys = [k for k, _v in rows]
    vals = [v for _k, v in rows]
    df = dt.from_pydict({"k": dt.Series.from_pylist(keys, "k", PD.int64()),
                         "v": dt.Series.from_pylist(vals, "v", PD.int64())})
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        lists = df.groupby("k").agg_list("v")
        back = lists.explode("v").to_pydict()
        want = lists.to_pydict()
    pairs = sorted((k, v if v is not None else -999) for k, v in zip(back["k"], back["v"]))
    assert pairs == sorted((k, v if v is not None else -999) for k, v in rows)
    assert [len(x) for x in want["v"]] == [keys.count(k) for k in want["k"]]
