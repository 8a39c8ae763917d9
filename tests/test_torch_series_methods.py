"""The reference's Series methods and the last DataFrame methods in the port
(daft_tpu_torch/core/series.py, dataframe/dataframe.py; counterpart
of tests/test_series.py's aggregation, null, sort and predicate cases and
tests/test_api_breadth.py:52, 81, 145).

Each Series method runs on both packages' Series over the same seeded
values and the results' ``to_pylist`` must be equal: exactly, but for the
float moments (var, stddev, skew, mean) within rtol 1e-12 and the sketches
(``approx_percentile``) within the sketch's own relative accuracy, 1 %.
The DataFrame methods (``columns``, ``shuffle``, ``skip_existing``,
``num_partitions``, the torch datasets, ``Expression.get_type``) run on
both packages too.
"""

import os

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.core.series import Series as RefSeries
from daft_tpu_torch.config import execution_config_ctx
from daft_tpu_torch.core.series import Series as PortSeries


def _pair(values, name="x", dtype=None):
    ref = RefSeries.from_pylist(values, name, daft_tpu.DataType(dtype) if dtype else None)
    port = PortSeries.from_pylist(values, name,
                                  daft_tpu_torch.DataType(dtype) if dtype else None)
    return ref, port


def _ints(seed=0, n=300, nulls=7):
    rng = np.random.default_rng(seed)
    return [None if i % nulls == 0 else int(v) for i, v in enumerate(rng.integers(-50, 50, n))]


def _floats(seed=1, n=300, nulls=5):
    rng = np.random.default_rng(seed)
    return [None if i % nulls == 0 else float(v) for i, v in enumerate(rng.normal(0, 3, n))]


def _close(a, b, rtol):
    assert [v is None for v in a] == [v is None for v in b]
    np.testing.assert_allclose([np.nan if v is None else v for v in a],
                               [np.nan if v is None else v for v in b], rtol=rtol)


AGGS = [
    ("sum", (), "int", 0), ("sum", (), "float", 1e-12), ("product", (), "small", 0),
    ("mean", (), "int", 1e-12), ("mean", (), "float", 1e-12), ("min", (), "int", 0),
    ("max", (), "float", 0), ("count", (), "int", 0), ("count", ("null",), "int", 0),
    ("count", ("all",), "int", 0), ("count_distinct", (), "int", 0),
    ("any_value", (), "int", 0), ("any_value", (True,), "int", 0),
    ("stddev", (), "float", 1e-12), ("var", (), "float", 1e-12), ("var", (1,), "float", 1e-12),
    ("skew", (), "float", 1e-9), ("bool_and", (), "bool", 0), ("bool_or", (), "bool", 0),
    ("agg_list", (), "int", 0), ("string_agg", (",",), "str", 0),
    ("approx_count_distinct", (), "int", 0), ("approx_percentile", (0.5,), "float", 0.01),
]


def _values(kind):
    if kind == "int":
        return _ints()
    if kind == "float":
        return _floats()
    if kind == "small":
        return [1, 2, None, 3, -1]
    if kind == "bool":
        return [True, None, True, False, True]
    return ["p", None, "q", "r"]


@pytest.mark.parametrize("method,args,kind,rtol", AGGS,
                         ids=[f"{m}{a}-{k}" for m, a, k, _r in AGGS])
def test_aggregation_matches_reference(method, args, kind, rtol):
    ref, port = _pair(_values(kind))
    want = getattr(ref, method)(*args)
    got = getattr(port, method)(*args)
    assert repr(got.dtype) == repr(want.dtype)
    if rtol:
        _close(got.to_pylist(), want.to_pylist(), rtol)
    else:
        assert got.to_pylist() == want.to_pylist()


def test_agg_set_and_concat_match_reference():
    ref, port = _pair(["a", "b", None, "a", "c"])
    assert sorted(port.agg_set().to_pylist()[0]) == sorted(ref.agg_set().to_pylist()[0])
    ref, port = _pair([[1], [2, 3], None, []])
    assert port.agg_concat().to_pylist() == ref.agg_concat().to_pylist()


ELEMENTWISE = [
    ("abs", lambda s, S: s.abs()),
    ("is_null", lambda s, S: s.is_null()),
    ("not_null", lambda s, S: s.not_null()),
    ("fill_null", lambda s, S: s.fill_null(S.from_pylist([0], "f"))),
    ("drop_nulls", lambda s, S: s.drop_nulls()),
    ("is_in", lambda s, S: s.is_in(S.from_pylist([1, 3, -4], "v"))),
    ("between", lambda s, S: s.between(S.from_pylist([-10], "l"), S.from_pylist([10], "u"))),
    ("eq_null_safe", lambda s, S: s.eq_null_safe(S.from_pylist(_ints(seed=2), "o"))),
    ("filter", lambda s, S: s.filter(S.from_pylist(
        [None if i % 11 == 0 else i % 3 == 0 for i in range(300)], "m"))),
    ("sort", lambda s, S: s.sort()),
    ("sort_desc", lambda s, S: s.sort(descending=True)),
    ("sort_desc_nulls_last", lambda s, S: s.sort(descending=True, nulls_first=False)),
    ("sort_nulls_first", lambda s, S: s.sort(nulls_first=True)),
    ("argsort", lambda s, S: s.argsort()),
    ("argsort_desc", lambda s, S: s.argsort(descending=True)),
    ("if_else", lambda s, S: S.if_else(S.from_pylist(
        [None if i % 13 == 0 else i % 2 == 0 for i in range(300)], "p"), s,
        S.from_pylist([99], "f"))),
]


@pytest.mark.parametrize("name,fn", ELEMENTWISE, ids=[e[0] for e in ELEMENTWISE])
def test_elementwise_matches_reference(name, fn):
    ref, port = _pair(_ints())
    want = fn(ref, RefSeries)
    got = fn(port, PortSeries)
    assert got.to_pylist() == want.to_pylist()
    assert repr(got.dtype) == repr(want.dtype)


def test_null_count_matches_reference():
    ref, port = _pair(_ints())
    assert port.null_count() == ref.null_count() == 43


def test_float_sorts_match_reference():
    ref, port = _pair(_floats())
    for desc in (False, True):
        assert port.sort(descending=desc).to_pylist() == ref.sort(descending=desc).to_pylist()
        assert port.argsort(descending=desc).to_pylist() == \
            ref.argsort(descending=desc).to_pylist()


# ---- DataFrame methods (tests/test_api_breadth.py) ---------------------------------

DF = {"g": ["a", "a", "b", "b", "b"], "v": [1, 1, 3, 4, 4], "s": ["p", "q", "r", "s", "t"]}


def test_columns_property():
    assert [e.name() for e in daft_tpu_torch.from_pydict(DF).columns] == \
        [e.name() for e in daft_tpu.from_pydict(DF).columns] == ["g", "v", "s"]


def test_shuffle_preserves_rows():
    with execution_config_ctx(device="cpu"):
        out = daft_tpu_torch.from_pydict(DF).shuffle(seed=7).to_pydict()
    assert sorted(out["v"]) == sorted(daft_tpu.from_pydict(DF).shuffle(seed=7)
                                      .to_pydict()["v"]) == [1, 1, 3, 4, 4]
    assert sorted(zip(out["g"], out["v"], out["s"])) == sorted(zip(DF["g"], DF["v"], DF["s"]))


def test_skip_existing(tmp_path):
    pdir = str(tmp_path / "prev")
    os.makedirs(pdir)
    with execution_config_ctx(device="cpu"):
        daft_tpu_torch.from_pydict({"v": [1, 3], "g": ["a", "b"], "s": ["p", "r"]}) \
            .write_parquet(pdir)
        rem = daft_tpu_torch.from_pydict(DF).skip_existing(pdir, "v").to_pydict()
    # the reference reads the port's files to the same remainder
    want = daft_tpu.from_pydict(DF).skip_existing(pdir, "v").to_pydict()
    assert sorted(rem["v"]) == sorted(want["v"]) == [4, 4]
    with execution_config_ctx(device="cpu"):
        assert daft_tpu_torch.from_pydict(DF).skip_existing(str(tmp_path / "none"), "v") \
            .to_pydict() == DF


def test_num_partitions():
    df = daft_tpu_torch.from_pydict(DF)
    assert df.num_partitions() == 1
    with execution_config_ctx(device="cpu"):
        df.collect()
    assert df.num_partitions() == daft_tpu.from_pydict(DF).collect().num_partitions()


def test_torch_datasets():
    import torch.utils.data

    with execution_config_ctx(device="cpu"):
        df = daft_tpu_torch.from_pydict(DF)
        m = df.to_torch_map_dataset()
        it = df.to_torch_iter_dataset()
        rows = list(it)
    assert isinstance(m, torch.utils.data.Dataset)
    assert isinstance(it, torch.utils.data.IterableDataset)
    assert len(m) == 5 and m[2] == {"g": "b", "v": 3, "s": "r"}
    assert rows == daft_tpu.from_pydict(DF).to_pylist()
    assert [m[i] for i in range(len(m))] == rows


def test_expression_get_type():
    p = daft_tpu_torch.from_pydict(DF)
    r = daft_tpu.from_pydict(DF)
    for name in ("g", "v"):
        assert repr(daft_tpu_torch.col(name).get_type(p.schema)) == \
            repr(daft_tpu.col(name).get_type(r.schema))
    assert repr((daft_tpu_torch.col("v") / 2).get_type(p.schema)) == \
        repr((daft_tpu.col("v") / 2).get_type(r.schema))
