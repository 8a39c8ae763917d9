"""DECIMAL (``decimal128(p, s)``; daft_tpu_torch/core/decimal.py) against the
reference, whose decimals are pyarrow's.

The same seeded columns go through ``daft_tpu`` and ``daft_tpu_torch`` and
every case compares ``to_pydict`` exactly (``decimal.Decimal`` values at
their scale, floats bit for bit): casts from and to integers, floats,
strings and decimals, Decimal literals and their type, the arithmetic
rule (the decimal operand's type), comparisons and filters, sum / min /
max / count, sorting and grouping on a decimal, and SQL's ``CAST(... AS
DECIMAL | NUMERIC[(p[, s])])`` with the defaults 38, 10. Where pyarrow
refuses a cast (a precision too small for an integer type, a lost digit,
an overflow, a malformed string), the reference raises ArrowInvalid, a
ValueError, and the port raises ValueError. Decimals stay on the host.
"""

import decimal

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu_torch.config import execution_config_ctx

D = decimal.Decimal


def _data(seed=0, n=200):
    rng = np.random.default_rng(seed)
    a = [None if i % 9 == 0 else int(v) for i, v in enumerate(rng.integers(-10**6, 10**6, n))]
    f = [None if i % 7 == 0 else round(float(v), 3)
         for i, v in enumerate(rng.uniform(-1000, 1000, n))]
    s = [None if v is None else f"{v:.2f}" for v in f]
    g = [int(v) for v in rng.integers(0, 5, n)]
    return {"a": a, "f": f, "s": s, "g": g}


def _run(pkg, data, build):
    df = build(pkg, pkg.from_pydict(data))
    if pkg is daft_tpu_torch:
        with execution_config_ctx(device="cpu"):
            return df.to_pydict(), df.schema
    return df.to_pydict(), df.schema


def _same(data, build):
    want, wschema = _run(daft_tpu, data, build)
    got, gschema = _run(daft_tpu_torch, data, build)
    assert got == want
    assert [repr(f.dtype) for f in gschema] == [repr(f.dtype) for f in wschema]
    return got


def _dec(p, s):
    return lambda pkg: pkg.DataType.decimal128(p, s)


CASTS = [
    ("int_to_38_10", lambda p, df: df.select(p.col("a").cast(_dec(38, 10)(p)))),
    ("int_to_29_10", lambda p, df: df.select(p.col("a").cast(_dec(29, 10)(p)))),
    ("int_to_19_0", lambda p, df: df.select(p.col("a").cast(_dec(19, 0)(p)))),
    ("float_to_10_2", lambda p, df: df.select(p.col("f").cast(_dec(10, 2)(p)))),
    ("float_to_9_0", lambda p, df: df.select(p.col("f").cast(_dec(9, 0)(p)))),
    ("float_to_38_10", lambda p, df: df.select(p.col("f").cast(_dec(38, 10)(p)))),
    ("string_to_10_2", lambda p, df: df.select(p.col("s").cast(_dec(10, 2)(p)))),
    ("string_to_12_4", lambda p, df: df.select(p.col("s").cast(_dec(12, 4)(p)))),
    ("dec_to_wider", lambda p, df: df.select(p.col("f").cast(_dec(10, 2)(p))
                                             .cast(_dec(14, 5)(p)))),
    ("dec_to_float", lambda p, df: df.select(p.col("f").cast(_dec(10, 2)(p))
                                             .cast(p.DataType.float64()))),
    ("dec_to_int", lambda p, df: df.select(p.col("a").cast(_dec(38, 10)(p))
                                           .cast(p.DataType.int64()))),
    ("dec_to_string", lambda p, df: df.select(p.col("f").cast(_dec(10, 2)(p))
                                              .cast(p.DataType.string()))),
]


@pytest.mark.parametrize("name,build", CASTS, ids=[c[0] for c in CASTS])
def test_cast_matches_reference(name, build):
    _same(_data(), build)


REFUSED = [
    ("int_precision_too_small", lambda p, df: df.select(p.col("a").cast(_dec(10, 2)(p)))),
    ("float_overflow", lambda p, df: df.select(p.col("f").cast(_dec(2, 0)(p)))),
    ("string_loses_digits", lambda p, df: df.select(p.col("s").cast(_dec(10, 1)(p)))),
    ("dec_loses_digits", lambda p, df: df.select(p.col("f").cast(_dec(10, 2)(p))
                                                 .cast(_dec(10, 1)(p)))),
    ("dec_int_with_fraction", lambda p, df: df.select(p.col("f").cast(_dec(10, 2)(p))
                                                      .cast(p.DataType.int64()))),
]


@pytest.mark.parametrize("name,build", REFUSED, ids=[c[0] for c in REFUSED])
def test_refused_cast_raises_as_reference(name, build):
    data = _data()
    with pytest.raises(ValueError) as ref:
        _run(daft_tpu, data, build)
    with pytest.raises(ValueError) as port:
        _run(daft_tpu_torch, data, build)
    assert isinstance(ref.value, ValueError) and isinstance(port.value, ValueError)


def test_malformed_string_raises_as_reference():
    data = {"s": ["1.5", " 2"]}

    def build(p, df):
        return df.select(p.col("s").cast(_dec(5, 2)(p)))

    for pkg in (daft_tpu, daft_tpu_torch):
        with pytest.raises(ValueError, match="not a valid decimal128"):
            _run(pkg, data, build)


def _e(p, df):
    return df.select(p.col("f").cast(_dec(10, 2)(p)).alias("e"), p.col("a"), p.col("g"))


OPS = [
    ("literal", lambda p, df: df.select(p.lit(D("1.25")).alias("l"))),
    ("int_plus_literal", lambda p, df: df.select((p.col("g") + p.lit(D("1.25"))).alias("z"))),
    ("sub", lambda p, df: _e(p, df).select((p.col("e") - p.col("e")).alias("z"))),
    ("div_is_float", lambda p, df: _e(p, df).select((p.col("e") / 2).alias("q"))),
    ("gt_int", lambda p, df: _e(p, df).select((p.col("e") > 1).alias("b"))),
    ("gt_literal", lambda p, df: _e(p, df).select((p.col("e") > p.lit(D("1.5"))).alias("b"))),
    ("eq_self", lambda p, df: _e(p, df).select((p.col("e") == p.col("e")).alias("b"))),
    ("neg", lambda p, df: _e(p, df).select((-p.col("e")).alias("n"))),
    ("abs", lambda p, df: _e(p, df).select(p.col("e").abs().alias("n"))),
    ("is_null", lambda p, df: _e(p, df).select(p.col("e").is_null().alias("n"))),
    ("filter", lambda p, df: _e(p, df).where(p.col("e") > p.lit(D("100.5")))),
    ("sort_desc", lambda p, df: _e(p, df).sort("e", desc=True)),
    ("aggs", lambda p, df: _e(p, df).agg(p.col("e").sum().alias("s"),
                                         p.col("e").min().alias("lo"),
                                         p.col("e").max().alias("hi"),
                                         p.col("e").count().alias("c"))),
    ("group_by_decimal", lambda p, df: df.select(
        p.col("g").cast(_dec(20, 0)(p)).alias("d"), p.col("a"))
        .groupby("d").agg(p.col("a").count().alias("n")).sort("d")),
    ("wide_sum", lambda p, df: df.select(p.col("a").cast(_dec(38, 10)(p)).alias("d"))
        .agg(p.col("d").sum().alias("s"))),
]


@pytest.mark.parametrize("name,build", OPS, ids=[c[0] for c in OPS])
def test_op_matches_reference(name, build):
    _same(_data(1), build)


def test_from_pydict_infers_the_references_type():
    data = {"z": [D("1.5"), D("-2.25"), None, D("100")]}
    got = _same(data, lambda p, df: df)
    assert got["z"][1] == D("-2.25")


SQL = [
    "SELECT CAST(a AS DECIMAL) AS t FROM df",
    "SELECT CAST(a AS NUMERIC) AS t FROM df",
    "SELECT CAST(s AS DECIMAL(12,2)) AS t FROM df",
    "SELECT CAST(f AS NUMERIC(12, 3)) AS t FROM df",
    "SELECT CAST(f AS DECIMAL(9)) AS t FROM df",
    "SELECT SUM(CAST(f AS DECIMAL(12,2))) AS t, MAX(CAST(s AS DECIMAL(12,2))) AS m FROM df",
]


@pytest.mark.parametrize("query", SQL)
def test_sql_cast_matches_reference(query):
    """Equal answers, or a ValueError from both (``DECIMAL(9)`` keeps the
    default scale 10, as the reference parses it, and 373.314 overflows)."""
    data = _data(2)
    try:
        want = daft_tpu.sql(query, df=daft_tpu.from_pydict(data)).to_pydict()
    except ValueError:
        with pytest.raises(ValueError):
            with execution_config_ctx(device="cpu"):
                daft_tpu_torch.sql(query, df=daft_tpu_torch.from_pydict(data)).to_pydict()
        return
    with execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.sql(query, df=daft_tpu_torch.from_pydict(data)).to_pydict()
    assert got == want


def test_sql_decimal_defaults():
    from daft_tpu_torch.sql.parser import DECIMAL_DEFAULT

    e = daft_tpu_torch.sql_expr("CAST(a AS DECIMAL)")
    assert e.dtype == daft_tpu_torch.DataType.decimal128(*DECIMAL_DEFAULT)
    assert DECIMAL_DEFAULT == (38, 10)


def test_grouped_decimal_aggregates_on_the_host():
    """A grouped sum / min / max of a decimal, under device_mode "on": the
    port answers exactly on the host (the reference's grouped kernel has no
    numpy form for a decimal and raises, ROADMAP's deliberate differences),
    held to Python's decimal arithmetic; no device stage runs."""
    from daft_tpu_torch.ops import counters

    data = _data(3)
    with pytest.raises(ValueError, match="no numpy representation"):
        _run(daft_tpu, data, lambda p, df: _e(p, df).groupby("g")
             .agg(p.col("e").sum().alias("s")).sort("g"))
    counters.reset()
    with execution_config_ctx(device="cpu", device_mode="on"):
        got = (_e(daft_tpu_torch, daft_tpu_torch.from_pydict(data)).groupby("g")
               .agg(daft_tpu_torch.col("e").sum().alias("s"),
                    daft_tpu_torch.col("e").min().alias("lo"),
                    daft_tpu_torch.col("e").max().alias("hi")).sort("g").to_pydict())
    assert counters.snapshot()["device_grouped_batches"] == 0
    for i, g in enumerate(got["g"]):
        vals = [D(f"{f:.2f}") for f, gg in zip(data["f"], data["g"])
                if gg == g and f is not None]
        assert got["s"][i] == sum(vals) and got["lo"][i] == min(vals)
        assert got["hi"][i] == max(vals)
        assert got["s"][i].as_tuple().exponent == -2
    assert not daft_tpu_torch.DataType.decimal128(10, 2).is_device_compatible()


def test_type_bounds():
    with pytest.raises(ValueError, match="precision"):
        daft_tpu_torch.DataType.decimal128(39, 0)
    assert repr(daft_tpu_torch.DataType.decimal128(10, 2)) == \
        repr(daft_tpu.DataType.decimal128(10, 2))
