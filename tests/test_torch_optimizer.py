"""The logical optimizer (daft_tpu_torch/plan/optimizer.py) against the
reference's (daft_tpu/plan/optimizer.py).

Each rule runs on the same small plan built in both packages; every TPC-H
DataFrame query (benchmarking/tpch/queries.py at SF 0.01) is optimized by
both, and the two plans must be equal in a canonical form: each node's kind
and output column names, a join's type and keys, the column set of each of a
filter's conjuncts and its ``keep``, the sort keys and limits, the group
keys. The rules' own tests compare the predicates' text as well (the two
packages print expressions alike).
"""

import datetime

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.plan import logical as rlp
from daft_tpu.plan import optimizer as ropt
from daft_tpu.plan import stats as rstats
from daft_tpu_torch.plan import logical as plp
from daft_tpu_torch.plan import optimizer as popt
from daft_tpu_torch.plan import physical as pp
from daft_tpu_torch.plan import stats as pstats

PACKAGES = ((daft_tpu, rlp, ropt), (daft_tpu_torch, plp, popt))


def _conjuncts(e):
    if type(e).__name__ == "BinaryOp" and e.op == "and":
        return _conjuncts(e.left) + _conjuncts(e.right)
    return [e]


def canonical(node, exprs: bool = False):
    """A plan's canonical form; with ``exprs``, each predicate's text too."""
    kind = type(node).__name__
    out = [kind, tuple(node.schema.column_names())]
    if kind == "Join":
        out += [node.how, tuple((l.name(), r.name()) for l, r in zip(node.left_on,
                                                                      node.right_on))]
    elif kind == "Filter":
        out += [tuple(sorted(tuple(sorted(c.referenced_columns()))
                             for c in _conjuncts(node.predicate))),
                tuple(node.keep) if node.keep is not None else None]
        if exprs:
            out.append(repr(node.predicate))
    elif kind in ("Sort", "TopN"):
        out += [tuple(e.name() for e in node.sort_by), tuple(node.descending),
                tuple(node.nulls_first)]
        if kind == "TopN":
            out += [node.limit, node.offset]
    elif kind == "Aggregate":
        out += [tuple(e.name() for e in node.groupby)]
    elif kind in ("Limit", "Offset"):
        out.append(getattr(node, kind.lower()))
    elif kind == "Project" and exprs:
        out.append(tuple(repr(e) for e in node.projection))
    return tuple(out), tuple(canonical(c, exprs) for c in node.children())


def _plan_of(df):
    return df._builder.plan if hasattr(df, "_builder") else df._plan


def _both(build, rule=None, exprs=True):
    """canonical(rule applied bottom-up, or the whole optimizer) of
    ``build(dt)`` in each package, reference first."""
    out = []
    for dt, lp, opt in PACKAGES:
        plan = _plan_of(build(dt))
        if rule is None:
            plan = opt.Optimizer().optimize(plan)
        else:
            plan = plan.transform_up(getattr(opt, rule)) if rule.startswith("rule_") \
                else getattr(opt, rule)(plan)
        out.append(canonical(plan, exprs))
    return out


def _frames(dt, n=64):
    rng = np.random.default_rng(3)
    a = dt.from_pydict({"a": rng.integers(0, 10, n).tolist(), "x": rng.random(n).tolist(),
                        "s": [f"s{i % 7}" for i in range(n)]})
    b = dt.from_pydict({"b": list(range(10)), "y": rng.integers(0, 5, 10).tolist()})
    c = dt.from_pydict({"c": list(range(5)), "z": [f"z{i}" for i in range(5)]})
    return a, b, c


# ---- the rules, one by one ------------------------------------------------------------


RULE_CASES = {
    "rule_simplify_expressions": lambda dt: _frames(dt)[0].where(
        ((dt.col("a") + 0) * 1 > dt.lit(1) + dt.lit(2)) & dt.lit(True)),
    "rule_simplify_expressions_project": lambda dt: _frames(dt)[0].select(
        (dt.col("x") - 0).alias("x0"), (~~(dt.col("a") > 2)).alias("p"),
        dt.lit(True).if_else(dt.col("a"), dt.lit(0)).alias("q")),
    "rule_drop_trivial_filter": lambda dt: _frames(dt)[0].where(dt.lit(True)),
    "rule_merge_filters": lambda dt: _frames(dt)[0].where(dt.col("a") > 1)
    .where(dt.col("x") < 0.5).where(dt.col("a") > 1),
    "rule_merge_limits": lambda dt: _frames(dt)[0].limit(7).limit(3),
    "rule_drop_noop_project": lambda dt: _frames(dt)[0].select("a", "x", "s"),
    "rule_cross_join_to_inner": lambda dt: _frames(dt)[0].join(_frames(dt)[1], how="cross")
    .where((dt.col("a") == dt.col("b")) & (dt.col("y") > 1)),
    "rule_push_filter_through_join": lambda dt: _frames(dt)[0]
    .join(_frames(dt)[1], left_on="a", right_on="b")
    .where((dt.col("x") > 0.2) & (dt.col("y") < 3) & (dt.col("x") < dt.col("y"))
           & (((dt.col("a") == 1) & (dt.col("y") == 2)) | ((dt.col("a") == 2) & (dt.col("y") == 4)))),
    "rule_push_filter_through_join_left": lambda dt: _frames(dt)[0]
    .join(_frames(dt)[1], left_on="a", right_on="b", how="left")
    .where((dt.col("x") > 0.2) & (dt.col("y") < 3)),
    "rule_push_filter_through_join_semi": lambda dt: _frames(dt)[0]
    .join(_frames(dt)[1], left_on="a", right_on="b", how="semi").where(dt.col("x") > 0.2),
    "rule_push_filter_through_project": lambda dt: _frames(dt)[0]
    .select(dt.col("a").alias("k"), (dt.col("x") * 2).alias("x2")).where(dt.col("k") > 3),
    "rule_push_limit_through": lambda dt: _frames(dt)[0].select("a", "x").limit(5),
    "rule_detect_topn": lambda dt: _frames(dt)[0].sort("x", desc=True).offset(2).limit(5),
}


@pytest.mark.parametrize("case", sorted(RULE_CASES))
def test_rule_matches_reference(case):
    rule = case if case in vars(popt) else case.rsplit("_", 1)[0]
    ref, port = _both(RULE_CASES[case], rule)
    assert port == ref
    before = canonical(_plan_of(RULE_CASES[case](daft_tpu_torch)), True)
    assert port != before, "the rule did not fire"


def test_optimizer_batches_and_passes_match_reference():
    assert [(b.name, b.max_passes) for b in popt.default_rule_batches(None)] == \
        [(b.name, b.max_passes) for b in ropt.default_rule_batches(None)]
    ported = {r.__name__ for b in popt.default_rule_batches(None) for r in b.rules}
    for batch in ropt.default_rule_batches(None):
        own = [r.__name__ for r in batch.rules if r.__name__ in ported]
        port = next(b for b in popt.default_rule_batches(None) if b.name == batch.name)
        assert [r.__name__ for r in port.rules] == own, batch.name
    # the rule left out reads a window (the scan rules came with IO, the UDF
    # split with the UDF tier)
    assert {r.__name__ for b in ropt.default_rule_batches(None) for r in b.rules} - ported \
        == {"rule_extract_windows"}


@pytest.mark.parametrize("case", ["prune", "prune_join", "prune_semi", "keep_filter"])
def test_prune_columns_matches_reference(case):
    def build(dt):
        a, b, c = _frames(dt)
        col = dt.col
        if case == "prune":
            return a.where(col("x") > 0.5).groupby("a").agg(col("a").count().alias("n"))
        if case == "prune_join":
            return a.join(b, left_on="a", right_on="b").join(c, left_on="y", right_on="c") \
                .select("x", "z")
        if case == "prune_semi":
            return a.join(b.where(col("y") > 1), left_on="a", right_on="b", how="semi") \
                .select("s")
        return a.where(col("s") == "s1").select("a")

    ref, port = _both(build, "prune_columns")
    assert port == ref


def test_keep_filter_narrows_and_runs():
    def q(dt, d):
        return d.where(dt.col("s") == "s1").select("a").sort("a")

    a_ref, a_port = _frames(daft_tpu)[0], _frames(daft_tpu_torch)[0]
    plan = q(daft_tpu_torch, a_port).optimized_plan()
    filters = [n for n in _walk(plan) if isinstance(n, plp.Filter)]
    assert [f.keep for f in filters] == [["a"]]
    assert filters[0].schema.column_names() == ["a"]
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        assert q(daft_tpu_torch, a_port).to_pydict() == q(daft_tpu, a_ref).to_pydict()


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)


def _chain(dt, n_fact=4000):
    """A fact joined to three dims, written largest first: the reorder
    fires."""
    rng = np.random.default_rng(11)
    fact = dt.from_pydict({"f_d1": rng.integers(0, 200, n_fact).tolist(),
                           "f_d2": rng.integers(0, 50, n_fact).tolist(),
                           "f_v": rng.integers(0, 100, n_fact).tolist()})
    d1 = dt.from_pydict({"d1_k": list(range(200)), "d1_g": [i % 9 for i in range(200)]})
    d2 = dt.from_pydict({"d2_k": list(range(50)), "d2_r": [i % 5 for i in range(50)]})
    d3 = dt.from_pydict({"d3_k": list(range(5)), "d3_name": [f"r{i}" for i in range(5)]})
    return (fact.join(d1, left_on="f_d1", right_on="d1_k")
            .join(d2, left_on="f_d2", right_on="d2_k")
            .join(d3.where(dt.col("d3_k") < 2), left_on="d2_r", right_on="d3_k")
            .groupby("d3_name").agg(dt.col("f_v").sum().alias("s")).sort("d3_name"))


def test_join_reorder_matches_reference():
    ref, port = _both(_chain, None)
    assert port == ref
    assert ref != canonical(_plan_of(_chain(daft_tpu)), True), "the reorder did not fire"
    with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"):
        got = _chain(daft_tpu_torch).to_pydict()
    assert got == _chain(daft_tpu).to_pydict()


def test_stats_match_reference():
    """row_width, estimate_rows, estimate_bytes, estimate_distinct (Chao1
    over a strided sample, past the 8,192-row sample too) and
    estimate_join_result give the reference's numbers."""
    rng = np.random.default_rng(2)
    n = 50_000
    data = {"key": np.arange(n).tolist(), "few": rng.integers(0, 40, n).tolist(),
            "mid": rng.integers(0, 9000, n).tolist(), "s": [f"v{i % 300}" for i in range(n)],
            "f": rng.random(n).tolist(), "b": (rng.random(n) < 0.5).tolist()}
    plans = []
    for dt, *_ in PACKAGES:
        df = dt.from_pydict(data)
        plans.append(_plan_of(df.where(dt.col("few") > 3).where(dt.col("s").is_in(["v1", "v2"]))))
    got = [[m.row_width(p.schema), m.estimate_rows(p), m.estimate_bytes(p)]
           + [m.estimate_distinct(p, c) for c in data]
           + [m.estimate_join_result(1e6, 2e4, 1e4, None)]
           for m, p in ((rstats, plans[0]), (pstats, plans[1]))]
    assert got[1] == got[0]


def test_distinct_estimate_samples_each_series_once(monkeypatch):
    calls = []
    real = pstats._chao1_distinct

    def counting(series, n):
        calls.append(series.name)
        return real(series, n)

    monkeypatch.setattr(pstats, "_chao1_distinct", counting)
    df = daft_tpu_torch.from_pydict({"k": list(range(20_000)), "g": [i % 7 for i in range(20_000)]})
    for _ in range(3):
        assert pstats.estimate_distinct(df._plan, "k") == 20_000
        assert pstats.estimate_distinct(df._plan, "g") == 7
    assert calls == ["k", "g"]


def test_simplify_folds_literals_through_the_host_evaluator():
    for dt, _lp, opt in PACKAGES:
        col, lit = dt.col, dt.lit
        schema = dt.from_pydict({"a": [1], "d": [datetime.date(1994, 1, 1)]}).schema
        assert repr(opt.simplify_expr(lit(2) * lit(3) + col("a"), schema)) == \
            "(lit(6) + col(a))"
        # a dtype change is refused: int / 1 stays a float division
        assert repr(opt.simplify_expr(col("a") / 1, schema)) == "(col(a) / lit(1))"
        assert repr(opt.simplify_expr(lit(1) - lit(0.05), schema)) == "lit(0.95)"
        assert repr(opt.simplify_expr(lit(None).if_else(col("a"), lit(0)), schema)) == \
            "lit(None).cast(Int64)"


def test_build_side_swap_matches_reference():
    """An inner join whose left side is much smaller builds on the left:
    the reference's physical swap, under a Project restoring the column
    order."""
    from daft_tpu.plan import physical as rpp

    def q(dt):
        small = dt.from_pydict({"k": list(range(8)), "name": [f"n{i}" for i in range(8)]})
        big = dt.from_pydict({"fk": [i % 8 for i in range(500)], "v": list(range(500))})
        return small.join(big, left_on="k", right_on="fk")

    ref_plan = rpp.translate(q(daft_tpu)._builder.optimize().plan)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        port_plan = pp.translate(q(daft_tpu_torch).optimized_plan())
        got = q(daft_tpu_torch).to_pydict()
    shape = [[type(n).__name__ for n in p.walk()] for p in (ref_plan, port_plan)]
    assert shape[0] == shape[1] == ["Project", "HashJoin", "InMemoryScan", "InMemoryScan"]
    assert got == q(daft_tpu).to_pydict()
    assert list(got) == ["k", "name", "fk", "v"]


def test_collect_runs_the_optimized_plan(monkeypatch):
    """collect optimizes before translating; nothing is cached between
    collects (each runs the optimizer again)."""
    calls = []
    real = popt.Optimizer.optimize

    def counting(self, plan):
        calls.append(type(plan).__name__)
        return real(self, plan)

    monkeypatch.setattr(popt.Optimizer, "optimize", counting)
    df = _frames(daft_tpu_torch)[0].sort("x").limit(3)
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        assert len(df.to_pydict()["a"]) == 3
        assert len(_frames(daft_tpu_torch)[0].sort("x").limit(3).to_pydict()["a"]) == 3
    assert calls == ["Limit", "Limit"]
    assert isinstance(df.optimized_plan(), plp.TopN)
    assert repr(df.optimized_plan()).startswith("* TopN[3]\n  * ")


# ---- TPC-H: the port's optimized plans are the reference's ----------------------------


@pytest.fixture(scope="module")
def tpch():
    from benchmarking.tpch.datagen import generate
    from benchmarking.tpch.queries import ALL_QUERIES
    from test_torch_tpch_sweep import _carry, _port_queries

    ref = {k: daft_tpu.from_arrow(v).collect() for k, v in generate(0.01, 0).items()}
    return ref, {k: _carry(v) for k, v in ref.items()}, ALL_QUERIES, _port_queries()


@pytest.mark.parametrize("qn", range(1, 23))
def test_tpch_optimized_plan_matches_reference(tpch, qn):
    ref, port, ref_queries, port_queries = tpch
    want = canonical(ref_queries[qn](ref)._builder.optimize().plan)
    got = canonical(port_queries[qn](port).optimized_plan())
    assert got == want
