"""Host UDFs (daft_tpu_torch/udf/) against the reference's (daft_tpu/udf/).

Every case of tests/test_udf.py but the process tier (``use_process=True``,
which the port refuses with NotImplementedError) runs through both
packages on the same frame, and the results must be equal; the optimized
plans of the UDF queries must equal the reference's in the canonical form
of tests/test_torch_optimizer.py (node kinds, output names, the ``__udf__``
internal names, the projections' text), and the UDF rules' guards
(a filter conjunct holding a UDF stays above a join and a Project, a Limit
above a Project holding one) must fire as the reference's.
"""

import asyncio

import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.datatype import DataType as RDataType
from daft_tpu_torch import DataType as PDataType

from test_torch_optimizer import _both, canonical  # noqa: E402

PACKAGES = ((daft_tpu, RDataType), (daft_tpu_torch, PDataType))


@pytest.fixture(autouse=True)
def _port_on_cpu():
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        yield


def _frame(dt):
    return dt.from_pydict({"x": [1, 2, 3], "s": ["a", "b", "c"]})


def _row(dt, DataType):
    @dt.func
    def double(x: int) -> int:
        return x * 2

    return _frame(dt).select(double(dt.col("x")))


def _return_dtype_inference(dt, DataType):
    @dt.func
    def as_str(x: int) -> str:
        return f"v{x}"

    out = _frame(dt).select(as_str(dt.col("x")).alias("y"))
    assert out.schema["y"].dtype == DataType.string()
    return out


def _batch(dt, DataType):
    @dt.func(is_batch=True, return_dtype=DataType.float64())
    def scaled(s):
        return dt.Series.from_numpy(s.to_numpy() * 1.5, "x")

    return _frame(dt).select(scaled(dt.col("x")))


def _multi_arg_with_literal(dt, DataType):
    @dt.func
    def combine(x: int, s: str, suffix: str) -> str:
        return f"{s}{x}{suffix}"

    return _frame(dt).select(combine(dt.col("x"), dt.col("s"), "!").alias("c"))


def _async(dt, DataType):
    @dt.func
    async def aplus(x: int) -> int:
        await asyncio.sleep(0)
        return x + 10

    return _frame(dt).select(aplus(dt.col("x")))


def _generator(dt, DataType):
    @dt.func(return_dtype=DataType.int64())
    def expand(x: int):
        for i in range(x):
            yield i

    return _frame(dt).select(dt.col("x"), expand(dt.col("x")).alias("e"))


def _legacy_udf_decorator(dt, DataType):
    @dt.udf(return_dtype=DataType.int64())
    def plus1(s):
        return dt.Series.from_numpy(s.to_numpy() + 1, "x")

    return _frame(dt).select(plus1(dt.col("x")))


def _split_into_udfproject(dt, DataType):
    @dt.func
    def double(x: int) -> int:
        return x * 2

    return _frame(dt).select(dt.col("s"), double(dt.col("x")).alias("d"),
                             (dt.col("x") + 1).alias("p"))


def _apply(dt, DataType):
    return _frame(dt).select(dt.col("x").apply(lambda v: v * 7, return_dtype=DataType.int64()))


def _multiple_udfs_isolated(dt, DataType):
    @dt.func
    def f1(x: int) -> int:
        return x + 1

    @dt.func
    def f2(x: int) -> int:
        return x * 2

    df = dt.from_pydict({"a": [1, 2, 3], "b": [10, 20, 30]})
    return df.select(f1(dt.col("a")).alias("u1"), f2(dt.col("b")).alias("u2"),
                     (dt.col("a") + dt.col("b")).alias("c"))


def _output_shadowing_input(dt, DataType):
    @dt.func
    def f1(x: int) -> int:
        return x + 1

    df = dt.from_pydict({"x": [1, 2], "y": [5, 6]})
    return df.select(f1(dt.col("y")).alias("x"), (dt.col("x") + 100).alias("keep"))


CASES = {
    "row": (_row, {"x": [2, 4, 6]}),
    "return_dtype_inference": (_return_dtype_inference, {"y": ["v1", "v2", "v3"]}),
    "batch": (_batch, {"x": [1.5, 3.0, 4.5]}),
    "multi_arg_with_literal": (_multi_arg_with_literal, {"c": ["a1!", "b2!", "c3!"]}),
    "async": (_async, {"x": [11, 12, 13]}),
    "generator": (_generator, {"x": [1, 2, 3], "e": [[0], [0, 1], [0, 1, 2]]}),
    "legacy_udf_decorator": (_legacy_udf_decorator, {"x": [2, 3, 4]}),
    "split_into_udfproject": (_split_into_udfproject,
                              {"s": ["a", "b", "c"], "d": [2, 4, 6], "p": [2, 3, 4]}),
    "apply": (_apply, {"x": [7, 14, 21]}),
    "multiple_udfs_isolated": (_multiple_udfs_isolated,
                               {"u1": [2, 3, 4], "u2": [20, 40, 60], "c": [11, 22, 33]}),
    "output_shadowing_input": (_output_shadowing_input, {"x": [6, 7], "keep": [101, 102]}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_udf_matches_reference(case):
    build, want = CASES[case]
    ref, port = (build(dt, DataType).to_pydict() for dt, DataType in PACKAGES)
    assert port == ref == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_udf_plans_match_reference(case):
    build = CASES[case][0]
    ref, port = (canonical(_optimized(build(dt, DataType)), True) for dt, DataType in PACKAGES)
    assert port == ref


def _optimized(df):
    return df._builder.optimize().plan if hasattr(df, "_builder") else df.optimized_plan()


def test_udf_plans_stack_udfprojects_with_internal_names():
    """Two UDFs in one projection: two stacked UDFProjects named
    ``__udf__<name>`` under the Project that renames them back; an output
    shadowing an input column keeps the sibling reading the input."""
    plan = _optimized(_multiple_udfs_isolated(daft_tpu_torch, PDataType))
    kinds = [type(n).__name__ for n in _walk(plan)]
    assert kinds == ["Project", "UDFProject", "UDFProject", "InMemorySource"]
    assert plan.input.schema.column_names() == ["a", "b", "__udf__u1", "__udf__u2"]
    shadow = _optimized(_output_shadowing_input(daft_tpu_torch, PDataType))
    assert shadow.input.schema.column_names() == ["x", "y", "__udf__x"]
    assert [repr(e) for e in shadow.projection] == ["col(__udf__x).alias('x')",
                                                   "(col(x) + lit(100)).alias('keep')"]


def test_lone_host_udf_is_not_split():
    assert not any(type(n).__name__ == "UDFProject"
                   for n in _walk(_optimized(_row(daft_tpu_torch, PDataType))))


def _walk(plan):
    yield plan
    for c in plan.children():
        yield from _walk(c)


def _udf_filter_join(dt, DataType):
    @dt.func
    def big(x: int) -> bool:
        return x > 1

    a = dt.from_pydict({"k": [1, 2, 3], "x": [1, 2, 3]})
    b = dt.from_pydict({"j": [1, 2, 3], "y": [4, 5, 6]})
    return a.join(b, left_on="k", right_on="j").where(
        big(dt.col("x")) & (dt.col("y") > 4)
        & ((big(dt.col("x")) & (dt.col("y") == 5)) | ((dt.col("x") == 3) & (dt.col("y") == 6))))


def _udf_filter_project(dt, DataType):
    @dt.func
    def big(x: int) -> bool:
        return x > 1

    return _frame(dt).select(dt.col("x").alias("k"), "s").where(big(dt.col("k")))


def _udf_limit_project(dt, DataType):
    @dt.func
    def double(x: int) -> int:
        return x * 2

    return _frame(dt).select(double(dt.col("x")).alias("d"), "s").limit(2)


@pytest.mark.parametrize("build,rule", [
    (_udf_filter_join, "rule_push_filter_through_join"),
    (_udf_filter_project, "rule_push_filter_through_project"),
    (_udf_limit_project, "rule_push_limit_through"),
], ids=["filter_join", "filter_project", "limit_project"])
def test_udf_guards_match_reference(build, rule):
    ref, port = _both(lambda dt: build(dt, PDataType if dt is daft_tpu_torch else RDataType),
                      rule)
    assert port == ref
    ref_all, port_all = _both(lambda dt: build(dt, PDataType if dt is daft_tpu_torch
                                               else RDataType))
    assert port_all == ref_all
    for dt, DataType in PACKAGES:
        assert build(dt, DataType).to_pydict() == build(*PACKAGES[0]).to_pydict()


def test_process_tier_is_refused():
    with pytest.raises(NotImplementedError, match="process tier"):
        daft_tpu_torch.func(lambda x: x, return_dtype=PDataType.int64(), use_process=True)
    with pytest.raises(NotImplementedError, match="process tier"):
        daft_tpu_torch.cls(use_process=True)(type("C", (), {}))


def test_stateful_cls_builds_once():
    """A @cls instance builds lazily, once, in both packages."""
    for dt, DataType in PACKAGES:
        init_count = {"n": 0}

        @dt.cls
        class Adder:
            def __init__(self, base):
                init_count["n"] += 1
                self.base = base

            def add(self, x: int) -> int:
                return self.base + x

        a = Adder(100)
        assert init_count["n"] == 0
        assert _frame(dt).select(a.add(dt.col("x"))).to_pydict() == {"x": [101, 102, 103]}
        _frame(dt).select(a.add(dt.col("x"))).to_pydict()
        assert init_count["n"] == 1


def test_list_series_round_trip():
    """The port's list column against the reference's on the same lists:
    elements rounded to the element type, nulls kept, slice/take/concat."""
    data = [[1.0, 2.5], None, [3.1, 4.0, 5.0], []]
    got = []
    for dt, DataType in PACKAGES:
        s = dt.Series.from_pylist(data, "e", DataType.list(DataType.float32()))
        got.append((s.to_pylist(), s.slice(1, 3).to_pylist(), s.take([3, 0]).to_pylist(),
                    dt.Series.concat([s, s.slice(0, 1)]).to_pylist(), repr(s.dtype)))
    assert got[1] == got[0]


def test_plan_with_udf_prints_udfproject():
    plan = _optimized(_split_into_udfproject(daft_tpu_torch, PDataType))
    assert "UDFProject[__udf__d]" in plan.display()
    assert canonical(plan) == canonical(
        _optimized(_split_into_udfproject(daft_tpu, RDataType)))
