"""The scalar function registry (daft_tpu_torch/functions/registry.py)
against the reference's (daft_tpu/functions/registry.py, extra.py,
breadth.py).

Every function the port registers runs over the same columns in both
packages (strings with non-ASCII, empty and null values; floats with NaN,
+-inf, -0.0 and nulls; integers; dates across year ends, leap days and ISO
week edges; naive microsecond timestamps before and after 1970, durations
and timestamp strings) under device_mode="off", and equals the reference's
host:
floats within rtol 1e-5 (NaN and infinities in the same places), the rest
exactly, with the same name and return type. ``uuid`` is checked for its
shape, ``monotonically_increasing_id`` raises in both. The later waves'
names raise ``NotImplementedError`` naming their wave; the registry API
(``register``, ``get_function``, ``has_function``, ``FunctionSpec``) is
exported from ``daft_tpu_torch.functions``.
"""

import datetime
import math
import re

import numpy as np
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.functions import registry as ref_reg
from daft_tpu_torch.functions import registry as port_reg

RTOL = 1e-5
D = datetime.date
DT = datetime.datetime

DATA = {
    "t": ["hello world", "Ünïcode straße", "", None, "  padded\t", "a,b,,c",
          "camelCaseString", "snake_case-thing Now", "ABC def", "éé", "x1y2z3", "İstanbul"],
    "t2": ["hello", "straße", "", "x", None, "a,b", "camel", "thing", "abc", "é", "xyz", "ist"],
    "ds": ["2024-03-02", "bad", None, "1999-12-31", "2000-02-29", "2001-02-29", "1970-01-01",
           "2038-01-19", "1969-07-20", "", "2020-12-31", "2021-01-03"],
    "f": [1.5, -0.0, 0.0, float("nan"), float("inf"), float("-inf"), -2.25, 0.5, None, 3.0,
          0.75, 17.75],
    "g": [2.0, 0.5, -1.0, 1.5, 2.0, -3.0, 0.75, float("nan"), 4.0, None, -0.5, 2.5],
    "i": [0, 1, -1, 7, -7, 2 ** 40, 12, -(2 ** 33), 255, None, 5, -12],
    "j": [3, 2, 5, 1, 0, 7, 63, 4, 8, 3, None, 2],
    "d": [D(2024, 3, 2), D(1999, 12, 31), None, D(2000, 2, 29), D(1969, 7, 20),
          D(2020, 12, 31), D(2021, 1, 3), D(2019, 12, 30), D(1970, 1, 1), D(2038, 1, 19),
          D(2001, 1, 1), D(1900, 3, 1)],
    "ts": [DT(2024, 3, 2, 23, 59, 59, 999999), DT(1969, 12, 31, 23, 0, 1, 5), None,
           DT(2000, 2, 29, 12, 30), DT(1969, 7, 20, 20, 17, 40), DT(2020, 12, 31, 0, 0, 0, 1),
           DT(2021, 1, 3, 6, 7, 8), DT(2019, 12, 30, 18), DT(1970, 1, 1), DT(2038, 1, 19, 3, 14, 7),
           DT(2001, 1, 1, 1, 1, 1, 1000), DT(1900, 3, 1, 13, 13, 13)],
    "du": [datetime.timedelta(days=3, seconds=7261, microseconds=5), datetime.timedelta(-1), None,
           datetime.timedelta(seconds=-1), datetime.timedelta(0), datetime.timedelta(hours=25),
           datetime.timedelta(minutes=59, seconds=59), datetime.timedelta(days=400),
           datetime.timedelta(microseconds=-1), datetime.timedelta(milliseconds=1500),
           datetime.timedelta(weeks=2), datetime.timedelta(seconds=86399)],
    "dts": ["2024-03-02 10:11:12", "02/29/2000 01:02:03 PM", None, "1969-12-31 23:59:59",
            "2021-01-03T04:05", "bad", "2020-12-31 24:00:00", "1999-12-31 00:00:60", "",
            "2038-01-19 03:14:07", "2001-01-01 1:2:3", "1900-03-01 13:13:13"],
}
N = len(DATA["t"])


def _calls(m):
    """name -> expression of package ``m``, one or more per function."""
    col = m.col
    t, t2, f, g, i, j, d, ds = (col(n) for n in ("t", "t2", "f", "g", "i", "j", "d", "ds"))
    ts, du, dts = col("ts"), col("du"), col("dts")
    out = {}
    for name in ("exp", "sqrt", "sin", "cos", "tan", "arctan", "log2", "log10", "cbrt", "expm1",
                 "log1p", "sinh", "cosh", "tanh", "degrees", "radians", "arccosh", "arcsinh",
                 "arctanh", "cot", "sec", "csc", "arcsin", "arccos", "floor", "ceil", "sign",
                 "is_nan", "is_inf", "not_nan", "bitwise_not"):
        out[name] = (i if name == "bitwise_not" else f)._fn(name)
    out.update({
        "log": f.log(), "log_base": f.log(10.0), "floor_int": i.floor(), "ceil_int": i.ceil(),
        "sign_int": i.sign(), "round": f.round(), "round2": g.round(2),
        "round_int": i.round(-1), "clip": f.clip(-1.0, 2.0), "clip_int": i.clip(0, 100),
        "clip_lo": f.clip(0.0), "hash": i.hash(), "hash_seed": t.hash(seed=7),
        "fill_nan": f.float.fill_nan(-1.0), "arctan2": f._fn("arctan2", g),
        "bitwise_and": i._fn("bitwise_and", j), "bitwise_or": i._fn("bitwise_or", j),
        "bitwise_xor": i._fn("bitwise_xor", j), "shift_left": i._fn("shift_left", 3),
        "shift_right": i._fn("shift_right", 2),
        "utf8_upper": t.str.upper(), "utf8_lower": t.str.lower(),
        "utf8_capitalize": t.str.capitalize(), "utf8_title": t.str.title(),
        "utf8_length": t.str.length(), "utf8_length_bytes": t.str.length_bytes(),
        "utf8_reverse": t.str.reverse(), "utf8_lstrip": t.str.lstrip(),
        "utf8_rstrip": t.str.rstrip(), "utf8_strip": t.str.strip(),
        "utf8_contains": t.str.contains("a"), "utf8_contains_col": t.str.contains(t2),
        "utf8_startswith": t.str.startswith("a"), "utf8_endswith": t.str.endswith("e"),
        "utf8_match": t.str.match(r"[a-z]+_[a-z]"), "utf8_split": t.str.split(","),
        "utf8_split_regex": t.str.split(r"[ ,]", regex=True),
        "utf8_substr": t.str.substr(1, 3), "utf8_substr_open": t.str.substr(2),
        "utf8_substr_neg": t.str.substr(-3, 2),
        "utf8_replace": t.str.replace("a", "@"),
        "utf8_replace_regex": t.str.replace(r"(\w)(\w)", r"\2\1", regex=True),
        "utf8_extract": t.str.extract(r"([a-z])(\d)", 2),
        "utf8_extract_all": t.str.extract_all(r"[a-z]\d"), "utf8_find": t.str.find("o"),
        "utf8_left": t.str.left(3), "utf8_right": t.str.right(3),
        "utf8_right_zero": t.str.right(0), "utf8_repeat": t.str.repeat(2),
        "utf8_concat": t._fn("utf8_concat", t2), "utf8_like": t.str.like("%a%e%"),
        "utf8_ilike": t.str.ilike("A%"), "utf8_lpad": t.str.lpad(12, "*"),
        "utf8_rpad": t.str.rpad(4, "-"), "utf8_to_date": ds.str.to_date("%Y-%m-%d"),
        "utf8_normalize": t.str.normalize(remove_punct=True, lowercase=True,
                                          white_space=True),
        "utf8_normalize_nfd": t.str.normalize(nfd_unicode=True),
        "utf8_count_matches": t.str.count_matches(["a", "e"]),
        "utf8_count_words": t.str.count_matches(["hello", "now"], whole_words=True,
                                                case_sensitive=False),
        "levenshtein": t.str.levenshtein(t2), "jaccard_similarity": t.str.jaccard_similarity(t2),
        "to_snake_case": t._fn("to_snake_case"), "to_kebab_case": t._fn("to_kebab_case"),
        "to_camel_case": t._fn("to_camel_case"),
        "to_upper_camel_case": t._fn("to_upper_camel_case"),
        "to_upper_snake_case": t._fn("to_upper_snake_case"),
        "to_upper_kebab_case": t._fn("to_upper_kebab_case"),
        "to_title_case": t._fn("to_title_case"),
        "dt_year": d.dt.year(), "dt_month": d.dt.month(), "dt_day": d.dt.day(),
        "dt_day_of_month": d.dt.day_of_month(), "dt_day_of_week": d.dt.day_of_week(),
        "dt_day_of_year": d.dt.day_of_year(), "dt_week_of_year": d.dt.week_of_year(),
        "dt_quarter": d.dt.quarter(), "dt_is_leap_year": d.dt.is_leap_year(),
        "dt_days_in_month": d.dt.days_in_month(),
        "dt_to_unix_epoch": d.dt.to_unix_epoch(), "dt_to_unix_epoch_ms": d.dt.to_unix_epoch("ms"),
        "dt_to_unix_epoch_ns": d.dt.to_unix_epoch("ns"), "dt_strftime": d.dt.strftime(),
        "dt_strftime_fmt": d.dt.strftime("%Y/%m/%d %A %j"),
        "coalesce": i._fn("coalesce", j), "coalesce_lit": f._fn("coalesce", g, 0.0),
        # the timestamp wave
        "dt_hour": ts.dt.hour(), "dt_minute": ts.dt.minute(), "dt_second": ts.dt.second(),
        "dt_millisecond": ts.dt.millisecond(), "dt_microsecond": ts.dt.microsecond(),
        "dt_nanosecond": ts._fn("dt_nanosecond"), "dt_date": ts.dt.date(),
        "dt_time": ts.dt.time(), "ts_year": ts.dt.year(), "ts_week": ts.dt.week_of_year(),
        "ts_strftime": ts.dt.strftime(), "ts_strftime_fmt": ts.dt.strftime("%c %p %I"),
        "ts_truncate": ts.dt.truncate("6 hours"), "ts_epoch_ms": ts.dt.to_unix_epoch("us"),
        "utf8_to_datetime": dts.str.to_datetime("%Y-%m-%d %H:%M:%S"),
        "utf8_to_datetime_pm": dts.str.to_datetime("%m/%d/%Y %I:%M:%S %p"),
        "utf8_to_datetime_tz": dts.str.to_datetime("%Y-%m-%dT%H:%M", timezone="UTC"),
        "replace_time_zone": ts._fn("replace_time_zone", tz="America/New_York"),
        "convert_time_zone": ts._fn("replace_time_zone", tz="UTC")._fn(
            "convert_time_zone", tz="Asia/Kolkata"),
        "unix_date": ts.unix_date(), "unix_date_d": d.unix_date(),
        "total_seconds": du.total_seconds(), "total_milliseconds": du.total_milliseconds(),
        "total_microseconds": du.total_microseconds(),
        "total_nanoseconds": du.total_nanoseconds(), "total_minutes": du.total_minutes(),
        "total_hours": du.total_hours(), "total_days": du.total_days(),
        "partition_days": ts.partition_days(), "partition_hours": ts.partition_hours(),
        "partition_months": ts.partition_months(), "partition_years": d.partition_years(),
    })
    for interval in ("1 day", "3 days", "1 week", "2 weeks", "1 month", "5 months",
                     "1 quarter", "1 year", "3 years"):
        out[f"dt_truncate {interval}"] = d.dt.truncate(interval)
    return out


CALLS = sorted(_calls(daft_tpu_torch))


def _run(m, ctx, e):
    with ctx:
        df = m.from_pydict(DATA).select(e.alias("out"))
        return df.to_pydict()["out"], df.schema["out"].dtype


def _same(got, want, name):
    assert [x is None for x in got] == [x is None for x in want], name
    gv = [x for x in got if x is not None]
    wv = [x for x in want if x is not None]
    if any(isinstance(x, float) for x in wv):
        g, w = np.array(gv, dtype=np.float64), np.array(wv, dtype=np.float64)
        assert np.array_equal(np.isnan(g), np.isnan(w)), name
        assert np.array_equal(np.isposinf(g), np.isposinf(w)), name
        assert np.array_equal(np.isneginf(g), np.isneginf(w)), name
        ok = np.isfinite(w)
        np.testing.assert_allclose(g[ok], w[ok], rtol=RTOL, atol=0.0, err_msg=name)
    else:
        assert gv == wv, name


@pytest.mark.parametrize("name", CALLS)
def test_function_matches_the_reference_host(name):
    ref_e = _calls(daft_tpu)[name]
    port_e = _calls(daft_tpu_torch)[name]
    assert ref_e.fname == port_e.fname
    want, want_dt = _run(daft_tpu, ref_ctx(device_mode="off"), ref_e)
    got, got_dt = _run(daft_tpu_torch,
                       daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off"),
                       port_e)
    assert got_dt.kind == want_dt.kind, (name, got_dt, want_dt)
    _same(got, want, name)


def test_every_registered_function_is_called():
    from daft_tpu_torch.functions import media, multimodal, nested

    names = {e.fname for e in _calls(daft_tpu_torch).values()}
    # the nested-types wave's functions are called by tests/test_torch_nested.py,
    # the multimodal wave's by tests/test_torch_multimodal.py, test_torch_image.py
    # and test_torch_media.py
    waves = (nested.__name__, multimodal.__name__, media.__name__)
    wave = {n for n, spec in port_reg._REGISTRY.items() if spec.host.__module__ in waves}
    skipped = {"uuid", "monotonically_increasing_id"}
    assert set(port_reg._REGISTRY) - names - wave == skipped
    for name in port_reg._REGISTRY:
        assert ref_reg.has_function(name), name


def test_uuid_and_monotonically_increasing_id():
    with daft_tpu_torch.execution_config_ctx(device="cpu"):
        got = daft_tpu_torch.from_pydict({"x": [1, 2, 3]}).select(
            daft_tpu_torch.col("x"), port_reg.get_function("uuid") and
            daft_tpu_torch.expressions.Function("uuid", []).alias("u")).to_pydict()
    assert len(set(got["u"])) == 3
    assert all(re.fullmatch(r"[0-9a-f]{8}-[0-9a-f]{4}-4[0-9a-f]{3}-[89ab][0-9a-f]{3}-"
                            r"[0-9a-f]{12}", u) for u in got["u"])
    e = daft_tpu_torch.expressions.Function("monotonically_increasing_id", [])
    with daft_tpu_torch.execution_config_ctx(device="cpu"), pytest.raises(ValueError):
        daft_tpu_torch.from_pydict({"x": [1]}).select(e.alias("m")).to_pydict()


# the nested-types wave is ported (tests/test_torch_nested.py), and the
# multimodal wave (tests/test_torch_multimodal.py, tests/test_torch_image.py)
LATER = ["image_crop", "image_to_mode", "image_height", "image_width", "dot",
         "cosine_distance", "euclidean_distance", "image_decode", "url_download",
         "tokenize_encode", "minhash", "embedding_norm", "image_resize"]


@pytest.mark.parametrize("name", LATER)
def test_later_wave_names_raise_naming_their_wave(name):
    """Every later wave is ported: each name the reference registers builds
    an expression, and no wave names it."""
    assert ref_reg.has_function(name) and port_reg.has_function(name)
    assert port_reg.later_wave(name) is None
    assert daft_tpu_torch.col("t")._fn(name).fname == name


def test_later_wave_namespaces_and_aggregates_raise():
    """The multimodal namespaces and the sketch aggregates build (ported:
    no wave is left to raise)."""
    c = daft_tpu_torch.col("t")
    for ns in ("image", "url", "embedding"):
        assert getattr(c, ns) is not None
    assert c.approx_count_distinct().op == "approx_count_distinct"
    assert c.approx_percentile(0.5).op == "approx_percentile"
    # the nested-types wave's namespaces and aggregates build
    for ns in ("list", "struct", "map", "binary", "json"):
        assert getattr(c, ns) is not None
    for agg in ("agg_list", "agg_set", "agg_concat", "product"):
        assert getattr(c, agg)().op in ("list", "set", "concat", "product")
    with pytest.raises(ValueError, match="unknown function"):
        c._fn("no_such_function")


def test_registry_api_is_exported_and_extensible():
    from daft_tpu_torch.functions import FunctionSpec, get_function, has_function, register

    spec = register("test_double_port", lambda fields, kw: fields[0].dtype,
                    lambda args, kw: args[0].rename(args[0].name).__class__(
                        args[0].name, args[0].dtype, args[0].to_numpy() * 2,
                        args[0].validity_numpy()))
    try:
        assert isinstance(spec, FunctionSpec) and has_function("test_double_port")
        assert get_function("test_double_port") is spec
        with daft_tpu_torch.execution_config_ctx(device="cpu"):
            got = daft_tpu_torch.from_pydict({"x": [1, 2, None]}).select(
                daft_tpu_torch.col("x")._fn("test_double_port")).to_pydict()
        assert got == {"x": [2, 4, None]}
    finally:
        port_reg._REGISTRY.pop("test_double_port")


def test_functions_in_a_filter_and_an_aggregate_match_the_reference():
    """Registry functions, ``abs``, ``%`` and ``is_in`` inside a filter and
    under a grouped aggregate, where the device stage takes them (device
    "cpu"), against the reference's host."""
    rng = np.random.default_rng(5)
    n = 5000
    data = {"k": rng.integers(0, 9, n).tolist(), "x": np.round(rng.normal(10, 5, n), 2).tolist(),
            "y": rng.integers(-40, 40, n).tolist()}

    def q(m):
        col = m.col
        return (m.from_pydict(data)
                .where(col("k").is_in([1, 2, 5, 7]) & ((col("y") % 3) != 0)
                       & ((col("x") - 10).abs() < 8))
                .groupby("k")
                .agg(col("x").sqrt().sum().alias("s"), (col("y") // 4).min().alias("m"),
                     col("x").round(1).mean().alias("r"), (col("x") ** 2).sum().alias("p"),
                     col("x").clip(5.0, 15.0).max().alias("c"),
                     col("x").exp().float.is_inf().cast(m.DataType.int64()).sum().alias("e"))
                .sort("k"))

    with ref_ctx(device_mode="off"):
        want = q(daft_tpu).to_pydict()
    from daft_tpu_torch.ops import counters

    for mode in ("on", "off"):
        counters.reset()
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode=mode):
            got = q(daft_tpu_torch).to_pydict()
        assert (counters.device_grouped_batches >= 1) == (mode == "on")
        for c in want:
            _same(got[c], want[c], c)
    assert not math.isnan(sum(want["s"]))
