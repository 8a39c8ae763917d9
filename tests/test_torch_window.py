"""The port's window functions (daft_tpu_torch/window.py, functions/
window.py, execution/window.py, the plan's Window node and
``rule_extract_windows``, SQL ``OVER``) against the reference's (daft_tpu/
window.py, tests/test_window.py):

- the reference's own cases, each with its literal expectation, in the port;
- on 3,000 seeded rows carried across (nulls in the partition and order
  keys and in the values, NaN, ties): every ranking function, lag / lead
  with and without a default, first / last value, and the windowed
  aggregations over the default frames, ``rows_between`` and
  ``range_between`` (ascending and descending, ``min_periods``), against the
  reference's results;
- the SQL ``OVER`` forms against the reference's SQL;
- the optimized plans of ``rule_extract_windows`` against the reference's;
- a window expression outside a window raises, as in the reference.

Tolerance (the ROADMAP's rule): ranks, counts, integers, lag / lead, first
/ last value and min / max bit for bit; float sums and means within rtol
1e-5.
"""

import numpy as np
import pytest

import daft_tpu
import daft_tpu.functions as rfn
import daft_tpu_torch as dt
import daft_tpu_torch.functions as pfn
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu_torch import Window, col
from daft_tpu_torch.functions import (cume_dist, dense_rank, ntile, percent_rank, rank,
                                      row_number)
from daft_tpu_torch.interop import from_numpy_columns

SEED = 20261018


@pytest.fixture(autouse=True)
def _cpu():
    with dt.execution_config_ctx(device="cpu"):
        yield


# ---- the reference's cases -----------------------------------------------------------


@pytest.fixture
def df():
    return dt.from_pydict({"k": ["a", "a", "a", "b", "b"], "t": [1, 2, 2, 1, 2],
                           "v": [10.0, 20.0, 30.0, 5.0, 15.0]})


def test_row_number(df):
    w = Window().partition_by("k").order_by("t")
    out = df.select(col("k"), col("v"), row_number().over(w).alias("rn")).sort(["k", "v"])
    assert out.to_pydict()["rn"] == [1, 2, 3, 1, 2]


def test_rank_dense_rank(df):
    w = Window().partition_by("k").order_by("t")
    out = df.select(col("k"), col("v"), rank().over(w).alias("rk"),
                    dense_rank().over(w).alias("dr")).sort(["k", "v"]).to_pydict()
    assert out["rk"] == [1, 2, 2, 1, 2] and out["dr"] == [1, 2, 2, 1, 2]


def test_rank_with_gaps():
    d = dt.from_pydict({"g": ["x"] * 4, "s": [1, 1, 2, 3]})
    w = Window().partition_by("g").order_by("s")
    out = d.select(col("s"), rank().over(w).alias("rk"),
                   dense_rank().over(w).alias("dr")).sort("s").to_pydict()
    assert out["rk"] == [1, 1, 3, 4] and out["dr"] == [1, 1, 2, 3]


def test_percent_rank_cume_dist():
    d = dt.from_pydict({"g": ["x"] * 4, "s": [1, 2, 2, 3]})
    w = Window().partition_by("g").order_by("s")
    out = d.select(col("s"), percent_rank().over(w).alias("pr"),
                   cume_dist().over(w).alias("cd")).sort("s").to_pydict()
    assert out["pr"] == [0.0, 1 / 3, 1 / 3, 1.0]
    assert out["cd"] == [0.25, 0.75, 0.75, 1.0]


def test_ntile():
    d = dt.from_pydict({"g": ["x"] * 5, "s": [1, 2, 3, 4, 5]})
    w = Window().partition_by("g").order_by("s")
    out = d.select(col("s"), ntile(2).over(w).alias("nt")).sort("s").to_pydict()
    assert out["nt"] == [1, 1, 1, 2, 2]


def test_running_sum_includes_peers(df):
    w = Window().partition_by("k").order_by("t")
    out = df.select(col("k"), col("v"), col("v").sum().over(w).alias("rs")).sort(["k", "v"])
    assert out.to_pydict()["rs"] == [10.0, 60.0, 60.0, 5.0, 20.0]


def test_partition_only_agg(df):
    w = Window().partition_by("k")
    out = df.select(col("k"), col("v"), col("v").mean().over(w).alias("m")).sort(["k", "v"])
    assert out.to_pydict()["m"] == [20.0, 20.0, 20.0, 10.0, 10.0]


def test_rows_between(df):
    w = Window().partition_by("k").order_by("t", desc=False).rows_between(-1, 0)
    out = df.select(col("k"), col("t"), col("v"), col("v").sum().over(w).alias("s"))
    assert out.sort(["k", "t", "v"]).to_pydict()["s"] == [10.0, 30.0, 50.0, 5.0, 20.0]


def test_rows_between_unbounded():
    d = dt.from_pydict({"g": ["x"] * 3, "s": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
    w = Window().partition_by("g").order_by("s").rows_between(Window.unbounded_preceding,
                                                              Window.unbounded_following)
    out = d.select(col("s"), col("v").sum().over(w).alias("tot")).sort("s").to_pydict()
    assert out["tot"] == [6.0, 6.0, 6.0]


def test_lag_lead(df):
    w = Window().partition_by("k").order_by("t")
    out = df.select(col("k"), col("v"), col("v").lag(1).over(w).alias("prev"),
                    col("v").lead(1).over(w).alias("next"),
                    col("v").lag(1, default=-1.0).over(w).alias("prev_d")
                    ).sort(["k", "v"]).to_pydict()
    assert out["prev"] == [None, 10.0, 20.0, None, 5.0]
    assert out["next"] == [20.0, 30.0, None, 15.0, None]
    assert out["prev_d"] == [-1.0, 10.0, 20.0, -1.0, 5.0]


def test_first_last_value(df):
    w = Window().partition_by("k").order_by("t")
    out = df.select(col("k"), col("v"), col("v").first_value().over(w).alias("f"),
                    col("v").last_value().over(w).alias("l")).sort(["k", "v"]).to_pydict()
    assert out["f"] == [10.0, 10.0, 10.0, 5.0, 5.0]
    assert out["l"] == [10.0, 30.0, 30.0, 5.0, 15.0]  # the frame ends at the peers


def test_window_min_max():
    d = dt.from_pydict({"g": ["x"] * 4, "s": [1, 2, 3, 4], "v": [3.0, 1.0, 4.0, 2.0]})
    w = Window().partition_by("g").order_by("s").rows_between(-1, 1)
    out = d.select(col("s"), col("v").min().over(w).alias("mn"),
                   col("v").max().over(w).alias("mx")).sort("s").to_pydict()
    assert out["mn"] == [1.0, 1.0, 1.0, 2.0] and out["mx"] == [3.0, 4.0, 4.0, 4.0]


def test_window_count_with_nulls():
    d = dt.from_pydict({"g": ["x", "x", "y"], "v": [1.0, None, 2.0]})
    out = d.select(col("g"), col("v").count().over(Window().partition_by("g")).alias("c"))
    assert out.sort(["g"]).to_pydict()["c"] == [1, 1, 1]


def test_window_no_partition():
    d = dt.from_pydict({"s": [3, 1, 2]})
    out = d.select(col("s"), row_number().over(Window().order_by("s")).alias("rn"))
    assert out.sort("s").to_pydict()["rn"] == [1, 2, 3]


def test_empty_frames_are_null():
    d = dt.from_pydict({"g": ["x"] * 3, "s": [1, 2, 3], "v": [1.0, 2.0, 3.0]})
    w = Window().partition_by("g").order_by("s").rows_between(-3, -2)
    out = d.select(col("s"), col("v").sum().over(w).alias("sm")).sort("s").to_pydict()
    assert out["sm"] == [None, None, 1.0]
    w2 = Window().partition_by("g").order_by("s").rows_between(2, 4)
    out2 = d.select(col("s"), col("v").sum().over(w2).alias("sm")).sort("s").to_pydict()
    assert out2["sm"] == [3.0, None, None]


def test_int64_precision_preserved():
    big = 2**60
    d = dt.from_pydict({"g": ["x", "x"], "v": [big, big + 1]})
    w = Window().partition_by("g")
    out = d.select(col("v").max().over(w).alias("m"), col("v").sum().over(w).alias("s"))
    assert out.to_pydict() == {"m": [big + 1] * 2, "s": [2 * big + 1] * 2}


def test_first_value_respects_frame():
    d = dt.from_pydict({"g": ["x"] * 3, "v": [1.0, 2.0, 3.0]})
    w = Window().partition_by("g").order_by("v").rows_between(-1, 0)
    out = d.select(col("v"), col("v").first_value().over(w).alias("f")).sort("v").to_pydict()
    assert out["f"] == [1.0, 1.0, 2.0]


def test_min_periods():
    d = dt.from_pydict({"g": ["x"] * 3, "v": [1.0, 2.0, 3.0]})
    w = Window().partition_by("g").order_by("v").rows_between(-2, 0, min_periods=3)
    out = d.select(col("v"), col("v").sum().over(w).alias("s")).sort("v").to_pydict()
    assert out["s"] == [None, None, 6.0]


def test_null_dtype_window_agg():
    d = dt.from_pydict({"k": ["a", "a"], "v": [None, None]})
    out = d.select(col("v").mean().over(Window().partition_by("k")).alias("m")).to_pydict()
    assert out["m"] == [None, None]


def test_window_expression_outside_a_window_raises(df):
    from daft_tpu_torch.expressions.eval import eval_expression

    batch = df._plan.partitions[0].concat_or_empty()
    for e in (row_number().over(Window().order_by("t")), col("v").lag(1)):
        with pytest.raises(ValueError, match="outside a window"):
            eval_expression(batch, e)
    with pytest.raises(ValueError, match="only aggregation expressions"):
        (col("v") + 1).over(Window())
    with pytest.raises(ValueError, match="must be bound"):
        df.select(col("v").lag(1).alias("x"))


# ---- seeded columns against the reference --------------------------------------------


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(SEED)
    n = 3000
    keys = np.array(["AIR", "MAIL", "SHIP", "RAIL"], dtype=object)
    x = rng.standard_normal(n)
    x[rng.random(n) < 0.01] = np.nan
    cols = {"k": (keys[rng.integers(0, 4, n)], rng.random(n) < 0.97),
            "p": (rng.integers(0, 40, n), rng.random(n) < 0.98),
            "t": (rng.integers(0, 60, n), rng.random(n) < 0.95),  # ties, nulls
            "v": (rng.integers(-(1 << 40), 1 << 40, n), rng.random(n) < 0.93),
            "x": (x, rng.random(n) < 0.95),
            "d": (rng.integers(9000, 9100, n).astype(np.int32), rng.random(n) < 0.97),
            "s": (keys[rng.integers(0, 4, n)], rng.random(n) < 0.9)}
    kinds = {"k": "string", "p": "int64", "t": "int64", "v": "int64", "x": "float64",
             "d": "date", "s": "string"}
    port = from_numpy_columns(cols, {c: dt.DataType(k) for c, k in kinds.items()})
    with dt.execution_config_ctx(device="cpu"):
        data = port.to_pydict()
    ref = daft_tpu.from_pydict(data).with_columns(
        {c: daft_tpu.col(c).cast(daft_tpu.DataType(k)) for c, k in kinds.items()})
    return ref, port


def _specs(W):
    return {
        "part_order": W().partition_by("k", "p").order_by("t", "v"),
        "part_order_desc": W().partition_by("k").order_by("t", "x", desc=[True, False],
                                                          nulls_first=[False, True]),
        "part_only": W().partition_by("p"),
        "order_only": W().order_by("d", "t"),
        "rows": W().partition_by("k").order_by("t", "v").rows_between(-3, 2),
        "rows_unbounded": W().partition_by("p").order_by("t", "v").rows_between(
            W.unbounded_preceding, W.current_row),
        "rows_min_periods": W().partition_by("k").order_by("t", "v").rows_between(
            -2, 0, min_periods=3),
        "rows_following": W().partition_by("p").order_by("v").rows_between(
            1, W.unbounded_following),
        "range": W().partition_by("k").order_by("t").range_between(-5, 3),
        "range_desc": W().partition_by("p").order_by("t", desc=True).range_between(
            W.unbounded_preceding, 0),
        "range_nulls_first": W().partition_by("k").order_by("t", nulls_first=True)
        .range_between(-2, W.unbounded_following, min_periods=2),
    }


RANKING = ("row_number", "rank", "dense_rank", "percent_rank", "cume_dist")
ORDERED = ("part_order", "part_order_desc", "order_only")
FLOATS = ("sx", "mx", "pr", "cd")


def _exprs(d, fns, spec_name, spec):
    c = d.col
    out = [c("k"), c("p"), c("t"), c("v"), c("x"), c("d")]
    if spec_name in ORDERED:
        out += [getattr(fns, f)().over(spec).alias(f) for f in RANKING]
        out += [fns.ntile(3).over(spec).alias("nt"),
                c("x").lag(2).over(spec).alias("lag_x"),
                c("s").lead(1, default="none").over(spec).alias("lead_s"),
                c("d").lag(1).over(spec).alias("lag_d")]
    if spec_name == "part_only":
        out += [c("v").lead(3, default=-7).over(spec.order_by("v", "t")).alias("lead_v")]
    out += [c("v").sum().over(spec).alias("sv"), c("x").sum().over(spec).alias("sx"),
            c("x").mean().over(spec).alias("mx"), c("v").min().over(spec).alias("mnv"),
            c("x").max().over(spec).alias("mxx"),
            c("t").count().over(spec).alias("n"),
            c("x").first_value().over(spec).alias("fx"),
            c("s").last_value().over(spec).alias("ls")]
    return out


def _same(got: dict, want: dict, floats=FLOATS):
    assert list(got) == list(want)
    for c in got:
        g, w = got[c], want[c]
        if c in floats:
            assert [v is None for v in g] == [v is None for v in w], c
            a = np.array([np.nan if v is None else v for v in g], dtype=float)
            b = np.array([np.nan if v is None else v for v in w], dtype=float)
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-9, equal_nan=True, err_msg=c)
        else:
            norm = (lambda v: "nan" if isinstance(v, float) and v != v else v)
            assert [norm(v) for v in g] == [norm(v) for v in w], c


@pytest.mark.parametrize("spec_name", list(_specs(Window)))
def test_window_functions_match_reference(frames, spec_name):
    ref, port = frames
    from daft_tpu.window import Window as RefWindow

    with ref_ctx(device_mode="off"):
        want = ref.select(*_exprs(daft_tpu, rfn, spec_name,
                                  _specs(RefWindow)[spec_name])).to_pydict()
    for mode in ("off", "force"):
        got = port.select(*_exprs(dt, pfn, spec_name, _specs(Window)[spec_name]))
        with dt.execution_config_ctx(pipeline_mode=mode):
            _same(got.to_pydict(), want)  # rows in input order, as the reference's


def test_window_after_a_filter_and_in_with_column(frames):
    ref, port = frames

    def q(d, fns, W):
        c = d.col
        w = W().partition_by("k").order_by("v")
        return (d_frame[d].where(c("t") > 10)
                .with_column("rn", fns.row_number().over(w))
                .with_column("share", c("v") * 100 / c("v").sum().over(W().partition_by("k")))
                .where(c("rn") <= 3).sort(["k", "rn"]))

    from daft_tpu.window import Window as RefWindow

    d_frame = {daft_tpu: ref, dt: port}
    with ref_ctx(device_mode="off"):
        want = q(daft_tpu, rfn, RefWindow).to_pydict()
    _same(q(dt, pfn, Window).to_pydict(), want, floats=("share",))


# ---- SQL -----------------------------------------------------------------------------

SQL = [
    "SELECT k, t, v, ROW_NUMBER() OVER (PARTITION BY k ORDER BY t, v) AS rn, "
    "RANK() OVER (PARTITION BY k ORDER BY t) AS rk, "
    "DENSE_RANK() OVER (PARTITION BY k ORDER BY t DESC NULLS LAST) AS dr FROM w",
    "SELECT p, v, SUM(v) OVER (PARTITION BY p ORDER BY v ROWS BETWEEN 2 PRECEDING AND "
    "CURRENT ROW) AS rs, COUNT(*) OVER (PARTITION BY w.p) AS c FROM w",
    "SELECT k, t, AVG(x) OVER (PARTITION BY k ORDER BY t RANGE BETWEEN 3 PRECEDING AND "
    "1 FOLLOWING) AS m, NTILE(4) OVER (ORDER BY t, v) AS q FROM w",
    "SELECT k, v, LAG(v, 2, 0) OVER (PARTITION BY k ORDER BY v) AS l2, "
    "LEAD(v) OVER (PARTITION BY k ORDER BY v) AS l1, "
    "FIRST_VALUE(v) OVER (PARTITION BY k ORDER BY v ROWS BETWEEN UNBOUNDED PRECEDING AND "
    "UNBOUNDED FOLLOWING) AS fv, PERCENT_RANK() OVER (PARTITION BY k ORDER BY v) AS pr, "
    "CUME_DIST() OVER (PARTITION BY k ORDER BY v) AS cd FROM w",
    "SELECT p, s, s * 100 / SUM(s) OVER (PARTITION BY p) AS ratio FROM "
    "(SELECT p, k, SUM(v) AS s FROM w GROUP BY p, k) ORDER BY p, s LIMIT 50",
]


@pytest.mark.parametrize("i", range(len(SQL)))
def test_sql_over_matches_reference(frames, i):
    ref, port = frames
    with ref_ctx(device_mode="off"):
        want = daft_tpu.sql(SQL[i], w=ref).to_pydict()
    _same(dt.sql(SQL[i], w=port).to_pydict(), want, floats=("m", "pr", "cd", "ratio"))


@pytest.mark.parametrize("query,match", [
    ("SELECT ROW_NUMBER() AS r FROM w", "requires an OVER clause"),
    ("SELECT UPPER(k) OVER (PARTITION BY k) AS u FROM w", "UPPER"),
    ("SELECT LAG(v, p) OVER (ORDER BY v) AS l FROM w", "offset must be a literal"),
])
def test_sql_window_errors(frames, query, match):
    _ref, port = frames
    with pytest.raises((ValueError, NotImplementedError), match=match):
        dt.sql(query, w=port).to_pydict()


# ---- the optimizer's rule ------------------------------------------------------------


def _canonical(node):
    kind = type(node).__name__
    out = [kind, tuple(node.schema.column_names())]
    if kind == "Window":
        out += [tuple(repr(e) for e in node.window_exprs), repr(node.spec)]
    elif kind == "Project":
        out.append(tuple(repr(e) for e in node.projection))
    return tuple(out), tuple(_canonical(c) for c in node.children())


def _plans(d):
    fns = daft_tpu.functions if d is daft_tpu else dt.functions
    W = Window if d is dt else __import__("daft_tpu.window", fromlist=["Window"]).Window
    c = d.col
    base = d.from_pydict({"k": [1, 2, 1], "t": [3, 1, 2], "v": [1.0, 2.0, 3.0]})
    w1 = W().partition_by("k").order_by("t")
    w1b = W().partition_by("k").order_by("t")  # an equal spec: one Window node
    return {
        "one_spec": base.select(c("k"), fns.row_number().over(w1).alias("rn"),
                                c("v").sum().over(w1b).alias("rs")),
        "two_specs": base.select(c("k"), c("v").sum().over(W().partition_by("k")).alias("t"),
                                 fns.rank().over(w1).alias("r")),
        "dedupe": base.select((c("v").sum().over(w1) / c("v").sum().over(w1b)).alias("one"),
                              c("v").sum().over(w1).alias("s")),
        "nested": base.where(c("v") > 1.0).with_column(
            "x", c("v") * 2 + c("v").mean().over(W().partition_by("k"))).sort("x"),
    }


@pytest.mark.parametrize("case", ["one_spec", "two_specs", "dedupe", "nested"])
def test_rule_extract_windows_matches_reference(case):
    from daft_tpu.plan import optimizer as ropt
    from daft_tpu_torch.plan import optimizer as popt

    ref_df = _plans(daft_tpu)[case]
    port_df = _plans(dt)[case]
    ref_plan = ropt.Optimizer().optimize(ref_df._builder.plan)
    port_plan = popt.Optimizer().optimize(port_df._plan)
    assert _canonical(port_plan) == _canonical(ref_plan)
    ref_rule = ref_df._builder.plan.transform_up(ropt.rule_extract_windows)
    port_rule = port_df._plan.transform_up(popt.rule_extract_windows)
    assert _canonical(port_rule) == _canonical(ref_rule)
    with ref_ctx(device_mode="off"):
        want = ref_df.to_pydict()
    _same(port_df.to_pydict(), want, floats=("rs", "t", "one", "s", "x"))
