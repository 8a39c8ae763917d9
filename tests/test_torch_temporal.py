"""Timestamps, durations and times end to end against the reference.

The same seeded columns (numpy ticks: values before 1970, around the
America/New_York DST edges, nulls) go through the reference and the port
(device_mode="off") in the units s, ms, us and ns, naive and zoned
("UTC", "America/New_York", "+05:30"):

- every name of the timestamp wave and every ``dt_*`` function over
  timestamps, durations and times, with the casts: ints and timestamps /
  durations bit for bit (a timestamp or duration result compared by its
  storage ints, which ns needs: the reference's ``to_pylist`` gives pandas
  objects there, the port datetimes), both raising where Arrow raises;
- literal typing (a ZoneInfo literal's zone is None, a fixed offset's
  "UTC+hh:mm": the reference's ``tzname(None)``), SQL TIMESTAMP / INTERVAL
  / CAST, Parquet both ways (the port reads pyarrow's files, pyarrow the
  port's; timestamp statistics prune row groups), CSV inference;
- T1 at a small size through the reference's device path and the port's
  (plain kernels on the CPU) and both hosts;
- temporal casts, is_in items and operands of different temporal types in
  the port's device program, grouped and ungrouped, equal to its host;
- windowed stddev / var (rows and range frames) bit for bit, and the plan
  surface: sample (the same rows for the same seed), unpivot / melt,
  pivot, add_monotonically_increasing_id, into_partitions, into_batches,
  map_groups, count_rows and the rest of the DataFrame methods.
"""

import datetime
import os
import zoneinfo

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import daft_tpu
import daft_tpu_torch
from daft_tpu.config import execution_config_ctx as ref_ctx
from daft_tpu.core.series import Series as RSeries
from daft_tpu_torch.ops import counters

UNITS = ("s", "ms", "us", "ns")
ZONES = (None, "UTC", "America/New_York", "+05:30")
PER_NS = {"s": 10 ** 9, "ms": 10 ** 6, "us": 10 ** 3, "ns": 1}
N = 64


def _port_ctx():
    return daft_tpu_torch.execution_config_ctx(device="cpu", device_mode="off")


def _ns_values():
    """Nanoseconds since the epoch: New York's 2021 DST edges (and a
    second either side), the epoch's neighbours, values before 1900 and
    after 2037, and seeded values over 1850-2100."""
    rng = np.random.default_rng(22)
    edges = np.array([1615705200, 1615705199, 1615708800, 1636264800, 1636261200,
                      1636264799, 1636268400, 0, -1, 1, -86_400, -2_208_988_800,
                      2_200_000_000], dtype=np.int64) * 10 ** 9
    rest = rng.integers(-3_800_000_000, 4_100_000_000, N - len(edges)) * 10 ** 9 \
        + rng.integers(0, 10 ** 9, N - len(edges))
    return np.concatenate([edges + np.array([0, 1, 999, 0, 1, 0, 5, 0, 7, 0, 0, 0, 0]),
                           rest])


VALID = np.ones(N, dtype=bool)
VALID[[2, 17, 40]] = False


def _frames(kind: str, unit: str, tz=None):
    """(reference frame, port frame) of one column ``t`` of ``kind``
    (timestamp, duration or time) in ``unit``."""
    ns = _ns_values()
    if kind == "timestamp":
        vals = ns // PER_NS[unit]
        at, pdt = pa.timestamp(unit, tz), daft_tpu_torch.DataType.timestamp(unit, tz)
    elif kind == "duration":
        vals = (ns // 1000) // PER_NS[unit]
        at, pdt = pa.duration(unit), daft_tpu_torch.DataType.duration(unit)
    else:
        day = 86_400 * 10 ** 9
        vals = (ns % day) // (1 if unit == "ns" else 1000)
        at = pa.time64("ns" if unit == "ns" else "us")
        pdt = daft_tpu_torch.DataType.time(unit)
    arr = pa.array([int(v) if ok else None for v, ok in zip(vals, VALID)], type=at)
    ref = daft_tpu.from_pydict({"t": RSeries.from_arrow(arr, "t")})
    port = daft_tpu_torch.from_numpy_columns({"t": (vals, VALID)}, {"t": pdt})
    return ref, port


def _run(m, df, e):
    """The column ``o`` of ``df.select(e)``: its storage ints where it is a
    timestamp or duration (cast to int64 first), else its Python values;
    ("raise",) where the query raises."""
    ctx = ref_ctx(device_mode="off") if m is daft_tpu else _port_ctx()
    try:
        with ctx:
            out = df.select(e.alias("o"))
            kind = out.schema["o"].dtype.kind
            if kind in ("timestamp", "duration"):
                out = out.select(m.col("o").cast(m.DataType.int64()).alias("o"))
            return out.to_pydict()["o"]
    except (ValueError, TypeError, NotImplementedError, OverflowError, pa.ArrowException):
        return ("raise",)


def _cases(m, kind: str, unit: str, tz):
    c = m.col("t")
    if kind == "duration":
        out = {f"total_{u}": getattr(c, f"total_{u}")()
               for u in ("days", "hours", "minutes", "seconds", "milliseconds",
                         "microseconds", "nanoseconds")}
        out.update({"neg_cmp": c < m.lit(datetime.timedelta(seconds=-5)),
                    "add_dur": c + c, "as_int": c.cast(m.DataType.int64()),
                    "as_str": c.cast(m.DataType.string())})
        return out
    if kind == "time":
        return {f: getattr(c.dt, f)() for f in ("hour", "minute", "second", "millisecond",
                                                  "microsecond")} | {
            "trunc_hour": c.dt.truncate("1 hour"), "trunc_7m": c.dt.truncate("7 minutes"),
            "as_str": c.cast(m.DataType.string())}
    out = {f: getattr(c.dt, f)() for f in (
        "year", "month", "day", "hour", "minute", "second", "millisecond", "microsecond",
        "day_of_week", "day_of_year", "week_of_year", "quarter", "is_leap_year",
        "days_in_month", "date", "time")}
    out.update({
        "dt_nanosecond": c._fn("dt_nanosecond"),
        "unix_date": c.unix_date(), "partition_days": c.partition_days(),
        "partition_hours": c.partition_hours(), "partition_months": c.partition_months(),
        "partition_years": c.partition_years(),
        "to_unix_epoch_s": c.dt.to_unix_epoch("s"),
        "to_unix_epoch_ns": c.dt.to_unix_epoch("ns"), "strftime": c.dt.strftime(),
        "strftime_fmt": c.dt.strftime("%a %b %e %I %p %j %U %W %V %G %c"),
        "replace_ny": c._fn("replace_time_zone", tz="America/New_York"),
        "replace_none": c._fn("replace_time_zone", tz=None),
        "replace_kolkata": c._fn("replace_time_zone", tz="Asia/Kolkata"),
        "as_str": c.cast(m.DataType.string()), "as_date": c.cast(m.DataType.date()),
        "as_int": c.cast(m.DataType.int64()),
        "as_ns": c.cast(m.DataType.timestamp("ns", tz)),
        "sub_self": c - c, "plus_hour": c + m.lit(datetime.timedelta(hours=1)),
    })
    for interval in ("1 day", "3 hours", "2 months", "1 week", "1 quarter", "15 minutes",
                     "1 year", "7 milliseconds"):
        out[f"truncate {interval}"] = c.dt.truncate(interval)
    # a naive column refuses the first two and a zoned one the third, in both
    out["convert_tokyo"] = c._fn("convert_time_zone", tz="Asia/Tokyo")
    out["strftime_zone"] = c.dt.strftime("%Y-%m-%d %H:%M %z %Z")
    out["cmp_lit"] = c >= m.lit(datetime.datetime(1995, 1, 1, 6, 30))
    return out


_TS_NAMES = sorted(_cases(daft_tpu_torch, "timestamp", "us", "UTC"))
_DUR_NAMES = sorted(_cases(daft_tpu_torch, "duration", "us", None))
_TIME_NAMES = sorted(_cases(daft_tpu_torch, "time", "us", None))
_FRAMES = {}


def _cached(kind, unit, tz):
    key = (kind, unit, tz)
    if key not in _FRAMES:
        _FRAMES[key] = _frames(kind, unit, tz)
    return _FRAMES[key]


@pytest.mark.parametrize("tz", ZONES, ids=lambda z: str(z))
@pytest.mark.parametrize("unit", UNITS)
@pytest.mark.parametrize("name", _TS_NAMES)
def test_timestamp_function_matches_the_reference(name, unit, tz):
    ref, port = _cached("timestamp", unit, tz)
    want = _run(daft_tpu, ref, _cases(daft_tpu, "timestamp", unit, tz)[name])
    got = _run(daft_tpu_torch, port, _cases(daft_tpu_torch, "timestamp", unit, tz)[name])
    assert got == want


@pytest.mark.parametrize("unit", UNITS)
@pytest.mark.parametrize("name", _DUR_NAMES)
def test_duration_function_matches_the_reference(name, unit):
    ref, port = _cached("duration", unit, None)
    want = _run(daft_tpu, ref, _cases(daft_tpu, "duration", unit, None)[name])
    got = _run(daft_tpu_torch, port, _cases(daft_tpu_torch, "duration", unit, None)[name])
    assert got == want


@pytest.mark.parametrize("unit", ("us", "ns"))
@pytest.mark.parametrize("name", _TIME_NAMES)
def test_time_function_matches_the_reference(name, unit):
    ref, port = _cached("time", unit, None)
    want = _run(daft_tpu, ref, _cases(daft_tpu, "time", unit, None)[name])
    got = _run(daft_tpu_torch, port, _cases(daft_tpu_torch, "time", unit, None)[name])
    assert got == want


def test_every_timestamp_wave_name_is_registered_and_called():
    from daft_tpu_torch.functions import registry as port_reg

    wave = ("dt_hour", "dt_minute", "dt_second", "dt_millisecond", "dt_microsecond",
            "dt_nanosecond", "dt_date", "dt_time", "utf8_to_datetime", "replace_time_zone",
            "convert_time_zone", "unix_date", "total_seconds", "total_milliseconds",
            "total_microseconds", "total_nanoseconds", "total_minutes", "total_hours",
            "total_days", "partition_days", "partition_hours", "partition_months",
            "partition_years")
    called = {e.fname for kind in ("timestamp", "duration") for e in
              _cases(daft_tpu_torch, kind, "us", "UTC").values()
              if hasattr(e, "fname")} | {"utf8_to_datetime"}
    for name in wave:
        assert port_reg.later_wave(name) is None, name
        assert port_reg.has_function(name), name
        assert name in called, name


# ---- values and literals ---------------------------------------------------------------


NY = zoneinfo.ZoneInfo("America/New_York")
PY_VALUES = [datetime.datetime(2021, 3, 14, 1, 59, 59, 999999, tzinfo=NY),
             datetime.datetime(2021, 11, 7, 1, 30, tzinfo=NY), None,
             datetime.datetime(1969, 12, 31, 23, 59, 59, tzinfo=NY)]


@pytest.mark.parametrize("data", [
    PY_VALUES,
    [datetime.datetime(1969, 12, 31, 23, 59, 59, 999999), None, datetime.datetime(1900, 1, 1)],
    [datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone(datetime.timedelta(hours=5,
                                                                                  minutes=30)))],
    [datetime.datetime(2020, 1, 1, tzinfo=datetime.timezone.utc), None],
    [datetime.timedelta(days=-1, microseconds=5), None, datetime.timedelta(weeks=3)],
    [datetime.time(23, 59, 59, 999999), None, datetime.time(0, 0)],
], ids=["ny", "naive", "fixed", "utc", "duration", "time"])
def test_python_values_type_and_round_trip_as_the_reference(data):
    want = RSeries.from_pylist(data)
    got = daft_tpu_torch.Series.from_pylist(data)
    assert repr(got.dtype) == repr(want.dtype)
    assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("value", [
    datetime.datetime(2020, 1, 1, 12, tzinfo=NY),
    datetime.datetime(2020, 1, 1, 12, tzinfo=datetime.timezone.utc),
    datetime.datetime(2020, 1, 1, 12, tzinfo=datetime.timezone(datetime.timedelta(hours=5,
                                                                                     minutes=30))),
    datetime.datetime(2020, 1, 1, 12), datetime.timedelta(hours=3), datetime.date(2020, 1, 1)],
    ids=["zoneinfo", "utc", "fixed", "naive", "timedelta", "date"])
def test_literal_typing_names_a_zone_as_the_reference(value):
    """The reference names a literal's zone ``tzinfo.tzname(None)``: None
    for a ZoneInfo zone, "UTC" for UTC, "UTC+05:30" for a fixed offset."""
    want = daft_tpu.lit(value).dtype
    got = daft_tpu_torch.lit(value).dtype
    assert repr(got) == repr(want)
    if isinstance(value, datetime.datetime) and value.tzinfo is NY:
        assert got.timezone is None
    if isinstance(value, datetime.datetime) and isinstance(value.tzinfo, datetime.timezone) \
            and value.utcoffset():
        assert got.timezone == "UTC+05:30"


def test_an_unknown_zone_raises_and_never_falls_back():
    from daft_tpu_torch.core import temporal

    with pytest.raises(ValueError, match="Nowhere/Zone"):
        temporal.get_zone("Nowhere/Zone")
    _ref, port = _cached("timestamp", "us", None)
    with _port_ctx(), pytest.raises(ValueError, match="Nowhere/Zone"):
        port.select(daft_tpu_torch.col("t")._fn("replace_time_zone", tz="Nowhere/Zone")
                    .alias("o")).to_pydict()


@pytest.mark.parametrize("fmt,tz", [("%Y-%m-%d %H:%M:%S", None), ("%m/%d/%Y %I:%M:%S %p", None),
                                    ("%Y-%m-%dT%H:%M", "UTC"), ("%Y-%m-%d %H:%M:%S%z", None),
                                    ("%d %b %Y %H", "America/New_York"), ("%s", None),
                                    ("%Y-%m-%d %T", None)])
def test_utf8_to_datetime_matches_the_reference(fmt, tz):
    data = ["2024-03-02 10:11:12", "02/29/2000 01:02:03 PM", None, "1969-12-31 23:59:59",
            "2021-01-03T04:05", "bad", "2020-12-31 24:00:00", "1999-12-31 00:00:60", "",
            "2021-01-03 04:05:06+0530", "2021-01-03 04:05:06Z", "2021-01-03 04:05:06-08:00",
            "03 Mar 2021 07", "1600000000", "12/31/1969 12:00:00 AM"]
    ref = daft_tpu.from_pydict({"s": data})
    port = daft_tpu_torch.from_pydict({"s": data})
    want = _run(daft_tpu, ref, daft_tpu.col("s").str.to_datetime(fmt, timezone=tz))
    got = _run(daft_tpu_torch, port, daft_tpu_torch.col("s").str.to_datetime(fmt, timezone=tz))
    assert got == want


@pytest.mark.parametrize("target", ["timestamp_ms", "timestamp_utc", "date", "string"])
def test_string_and_date_casts_match_the_reference(target):
    data = ["2020-01-01 00:00:01", "2020-01-01T00:00:01.5", "2020-01-01", None,
            "1969-12-31 23:59:59.123"]
    if target == "timestamp_utc":
        data = ["2020-01-01 00:00:01Z", "2020-01-01T00:00:01.5+05:30", None]

    def dtype(m):
        return {"timestamp_ms": m.DataType.timestamp("ms"),
                "timestamp_utc": m.DataType.timestamp("us", "UTC"),
                "date": m.DataType.timestamp("s"), "string": m.DataType.string()}[target]

    ref = daft_tpu.from_pydict({"s": data})
    port = daft_tpu_torch.from_pydict({"s": data})
    if target == "string":
        ref = ref.select(daft_tpu.col("s").cast(daft_tpu.DataType.timestamp("ms")).alias("s"))
        port = port.select(daft_tpu_torch.col("s").cast(daft_tpu_torch.DataType.timestamp("ms"))
                           .alias("s"))
    want = _run(daft_tpu, ref, daft_tpu.col("s").cast(dtype(daft_tpu)))
    got = _run(daft_tpu_torch, port, daft_tpu_torch.col("s").cast(dtype(daft_tpu_torch)))
    assert got == want


# ---- SQL -------------------------------------------------------------------------------

SQL_TABLE = {
    "ts": [datetime.datetime(1995, 1, 1, 6, 30) + datetime.timedelta(hours=7 * i, seconds=i)
           for i in range(40)],
    "d": [datetime.date(1995, 1, 1) + datetime.timedelta(days=i) for i in range(40)],
    "s": [f"1995-01-{1 + i % 28:02d} 0{i % 10}:00:00" for i in range(40)],
    "k": [i % 3 for i in range(40)],
    "v": [float(i * i % 17) for i in range(40)],
}

SQL_CASES = [
    "SELECT ts FROM t WHERE ts >= TIMESTAMP '1995-01-05 12:00:00' ORDER BY ts",
    "SELECT ts + INTERVAL '2' HOUR AS a, ts - INTERVAL '1' WEEK AS b, "
    "ts + INTERVAL '30' MINUTE AS c, ts + INTERVAL '15' SECOND AS e, "
    "ts + INTERVAL '500' MILLISECOND AS f, ts + INTERVAL '3' DAY AS g FROM t ORDER BY ts",
    "SELECT CAST(s AS TIMESTAMP) AS c FROM t ORDER BY k, s",
    "SELECT CAST(ts AS DATE) AS c, HOUR(ts) AS h, MINUTE(ts) AS mi, EXTRACT(HOUR FROM ts) AS eh "
    "FROM t ORDER BY ts",
    "SELECT DATE_TRUNC('hour', ts) AS h FROM t ORDER BY ts",
    "SELECT k, MIN(ts) AS a, MAX(ts) AS b, COUNT(*) AS n FROM t GROUP BY k ORDER BY k",
    "SELECT TIMESTAMP '2024-01-01 00:00:00' AS t0",
    "SELECT k, v, STDDEV(v) OVER (PARTITION BY k ORDER BY ts ROWS BETWEEN 2 PRECEDING AND "
    "CURRENT ROW) AS sd, VAR(v) OVER (PARTITION BY k) AS va FROM t ORDER BY ts",
    "SELECT ts FROM t WHERE ts - TIMESTAMP '1995-01-01 00:00:00' > INTERVAL '5' DAY ORDER BY ts",
    "SELECT d FROM t WHERE d < DATE '1995-01-01' + INTERVAL '31' DAY ORDER BY d",
]


def _sql(m, q, ctx):
    with ctx:
        return m.sql(q, t=m.from_pydict(SQL_TABLE)).to_pydict()


@pytest.mark.parametrize("q", range(len(SQL_CASES)))
def test_sql_temporal_matches_the_reference(q):
    want = _sql(daft_tpu, SQL_CASES[q], ref_ctx(device_mode="off"))
    got = _sql(daft_tpu_torch, SQL_CASES[q], _port_ctx())
    assert list(got) == list(want)
    for c in want:
        if want[c] and isinstance(want[c][0], float):
            np.testing.assert_allclose(np.array(got[c], dtype=float),
                                       np.array(want[c], dtype=float), rtol=1e-12)
        else:
            assert got[c] == want[c], c


@pytest.mark.parametrize("q,error", [
    ("SELECT ts + INTERVAL '3' MONTH AS m FROM t", NotImplementedError),
    ("SELECT ts + INTERVAL '1' YEAR AS m FROM t", NotImplementedError),
    ("SELECT k, ANY_VALUE(v) OVER (PARTITION BY k) AS a FROM t", ValueError),
    ("SELECT k, SKEW(v) OVER (PARTITION BY k) AS a FROM t", ValueError),
    ("SELECT HOUR(d) AS h FROM t", Exception),
])
def test_sql_raises_where_the_reference_raises(q, error):
    for m, ctx in ((daft_tpu, ref_ctx(device_mode="off")), (daft_tpu_torch, _port_ctx())):
        with pytest.raises(error):
            _sql(m, q, ctx)


# ---- files -------------------------------------------------------------------------------


def _pa_table():
    ns = _ns_values()
    ok = [bool(v) for v in VALID]
    ms = [int(v // 10 ** 6) if o else None for v, o in zip(ns, ok)]
    us = [int(v // 1000) if o else None for v, o in zip(ns, ok)]
    return pa.table({
        "s": pa.array([None if v is None else v // 1000 for v in ms], pa.timestamp("s")),
        "ms_ny": pa.array(ms, pa.timestamp("ms", "America/New_York")),
        "us": pa.array(us, pa.timestamp("us")),
        "us_fixed": pa.array(us, pa.timestamp("us", "+05:30")),
        "ns_utc": pa.array([int(v) if o else None for v, o in zip(ns, ok)],
                           pa.timestamp("ns", "UTC")),
        "dur_ms": pa.array(ms, pa.duration("ms")),
        "dur_s": pa.array([None if v is None else v // 1000 for v in ms], pa.duration("s")),
        "t32": pa.array([None if v is None else (v // 1000) % 86400 for v in ms],
                        pa.time32("s")),
        "t64": pa.array([None if v is None else v % (86_400 * 10 ** 6) for v in us],
                        pa.time64("us")),
        "tns": pa.array([int(v % (86_400 * 10 ** 9)) if o else None for v, o in zip(ns, ok)],
                        pa.time64("ns")),
    })


def _storage(m, df):
    """Every column as (dtype repr, storage ints or Python values)."""
    out = {}
    for f in df.schema:
        e = m.col(f.name)
        if f.dtype.kind in ("timestamp", "duration"):
            e = e.cast(m.DataType.int64())
        elif f.dtype.kind == "time":
            e = e.cast(m.DataType.string())
        out[f.name] = (repr(f.dtype), df.select(e.alias(f.name)).to_pydict()[f.name])
    return out


@pytest.mark.parametrize("kw", [{}, {"store_schema": False},
                                {"use_deprecated_int96_timestamps": True},
                                {"version": "2.6", "data_page_version": "2.0"}],
                         ids=["arrow_schema", "no_arrow_schema", "int96", "v2_pages"])
def test_port_reads_pyarrows_temporal_parquet_as_the_reference(tmp_path, kw):
    table = _pa_table()
    if "use_deprecated_int96_timestamps" in kw:
        table = table.select(["us", "ns_utc"])
    path = str(tmp_path / "t.parquet")
    pq.write_table(table, path, row_group_size=20, **kw)
    with ref_ctx(device_mode="off"):
        want = _storage(daft_tpu, daft_tpu.read_parquet(path))
    with _port_ctx():
        got = _storage(daft_tpu_torch, daft_tpu_torch.read_parquet(path))
    assert got == want


def test_pyarrow_reads_the_ports_temporal_parquet(tmp_path):
    ns = _ns_values()
    T = daft_tpu_torch.DataType
    cols = {"s": (ns // 10 ** 9, VALID), "us_ny": (ns // 1000, VALID), "ns": (ns, VALID),
            "ms_fixed": (ns // 10 ** 6, VALID), "dur": (ns // 10 ** 6, VALID),
            "tod": ((ns % (86_400 * 10 ** 9)) // 1000, VALID)}
    schema = {"s": T.timestamp("s"), "us_ny": T.timestamp("us", "America/New_York"),
              "ns": T.timestamp("ns", "UTC"), "ms_fixed": T.timestamp("ms", "+05:30"),
              "dur": T.duration("ms"), "tod": T.time("us")}
    df = daft_tpu_torch.from_numpy_columns(cols, schema)
    with _port_ctx():
        df.write_parquet(str(tmp_path / "out"))
        back = _storage(daft_tpu_torch, daft_tpu_torch.read_parquet(str(tmp_path / "out")))
    files = [os.path.join(tmp_path / "out", f) for f in os.listdir(tmp_path / "out")]
    table = pq.read_table(files[0])
    assert str(table.schema.field("s").type) == "timestamp[ms]"  # seconds written in ms
    assert str(table.schema.field("us_ny").type) == "timestamp[us, tz=America/New_York]"
    assert str(table.schema.field("ns").type) == "timestamp[ns, tz=UTC]"
    assert str(table.schema.field("ms_fixed").type) == "timestamp[ms, tz=+05:30]"
    assert str(table.schema.field("dur").type) == "duration[ms]"
    assert str(table.schema.field("tod").type) == "time64[us]"
    for name in ("us_ny", "ns", "ms_fixed", "dur"):
        got = [None if v is None else v for v in table.column(name).cast(pa.int64()).to_pylist()]
        assert got == back[name][1], name
    assert table.column("s").cast(pa.int64()).to_pylist() == back["s"][1]
    with ref_ctx(device_mode="off"):
        want = _storage(daft_tpu, daft_tpu.read_parquet(str(tmp_path / "out")))
    assert back == want


def test_timestamp_statistics_prune_row_groups(tmp_path):
    from daft_tpu_torch.io import _parquet_format as pf

    ns = np.sort(_ns_values())
    T = daft_tpu_torch.DataType
    df = daft_tpu_torch.from_numpy_columns({"t": (ns // 1000, np.ones(N, bool)),
                                            "v": (np.arange(N), np.ones(N, bool))},
                                           {"t": T.timestamp("us"), "v": T.int64()})
    old = pf.ROW_GROUP_ROWS
    pf.ROW_GROUP_ROWS = 8
    try:
        with _port_ctx():
            df.write_parquet(str(tmp_path / "p"))
    finally:
        pf.ROW_GROUP_ROWS = old
    lo = datetime.datetime(1995, 1, 1)
    for lit_value in (lo, datetime.date(1995, 1, 1)):
        c = daft_tpu_torch.col("t")
        counters.reset()
        with _port_ctx():
            got = daft_tpu_torch.read_parquet(str(tmp_path / "p"), row_groups_per_task=1) \
                .where(c >= daft_tpu_torch.lit(lit_value)).select("v").to_pydict()["v"]
        assert counters.snapshot()["scan_row_groups_pruned"] > 0
        want_ns = int((lo - datetime.datetime(1970, 1, 1)) / datetime.timedelta(microseconds=1))
        assert got == [int(v) for v in np.flatnonzero(ns // 1000 >= want_ns)]


CSV_CASES = {
    "time": "a\n12:30:00\n01:02\n", "time_frac": "a\n12:30:00.123\n",
    "ts_s": "a\n2020-01-01 12:00:00\n2020-01-01T01:02\n1969-12-31\n",
    "ts_hour": "a\n2020-01-01 12\n", "ts_ns": "a\n2020-01-01 12:00:00.5\n1969-12-31 23:59:59.999\n",
    "ts_zone": "a\n2020-01-01 12:00:00Z\n2020-01-01 12:00:00+05:30\n2020-01-01 12:00-08\n",
    "ts_zone_frac": "a\n2020-01-01 12:00:00.25Z\n",
    "ts_mixed_zone": "a\n2020-01-01 12:00:00Z\n2020-01-01 12:00:00\n",
    "ts_bad": "a\n2020-13-01 12:00:00\n", "ts_24": "a\n2020-01-01 24:00:00\n",
    "time_60": "a\n12:60:00\n", "ts_null": "a\n2020-01-01 12:00:00\nNULL\n\n2020-02-29 00:00:00\n",
    "ts_10": "a\n2020-01-01 12:00:00.1234567891\n",
}


@pytest.mark.parametrize("case", sorted(CSV_CASES))
def test_csv_temporal_inference_matches_the_reference(tmp_path, case):
    path = tmp_path / f"{case}.csv"
    path.write_text(CSV_CASES[case])
    with ref_ctx(device_mode="off"):
        want = _storage(daft_tpu, daft_tpu.read_csv(str(path)))
    with _port_ctx():
        got = _storage(daft_tpu_torch, daft_tpu_torch.read_csv(str(path)))
    assert got == want


def test_csv_round_trip_of_temporal_columns(tmp_path):
    ns = _ns_values()
    T = daft_tpu_torch.DataType
    df = daft_tpu_torch.from_numpy_columns(
        {"a": (ns // 10 ** 9, VALID), "b": (ns // 1000, VALID)},
        {"a": T.timestamp("s"), "b": T.timestamp("us", "UTC")})
    with _port_ctx():
        df.write_csv(str(tmp_path / "c"))
        back = daft_tpu_torch.read_csv(str(tmp_path / "c"))
        got = _storage(daft_tpu_torch, back)
    with ref_ctx(device_mode="off"):
        want = _storage(daft_tpu, daft_tpu.read_csv(str(tmp_path / "c")))
    assert got == want
    assert got["a"][1] == [int(v) if ok else None for v, ok in zip(ns // 10 ** 9, VALID)]


# ---- T1 through both device paths ----------------------------------------------------------


def _t1_columns(n=20_000):
    rng = np.random.default_rng(3)
    day = 86_400_000_000
    ship = rng.integers(8035, 10590, n).astype(np.int64) * day + rng.integers(0, day, n)
    rec = ship + rng.integers(1, 31, n) * day + rng.integers(0, day, n)
    return {"flag": np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, n)],
            "status": np.array(["F", "O"], dtype=object)[rng.integers(0, 2, n)],
            "price": np.round(rng.uniform(900, 105_000, n), 2), "ship": ship, "rec": rec}


def _t1(m, df):
    c = m.col
    transit = c("rec") - c("ship")
    return (df.where((c("ship") >= m.lit(datetime.datetime(1995, 1, 1, 6, 30)))
                     & (c("ship") < m.lit(datetime.datetime(1996, 1, 1, 6, 30)))
                     & (transit > m.lit(datetime.timedelta(days=20))))
            .groupby("flag", "status")
            .agg(c("price").count().alias("n"), c("price").sum().alias("s"),
                 c("ship").min().alias("mn"), c("ship").max().alias("mx"),
                 transit.min().alias("tmn"), transit.max().alias("tmx"))
            .sort(["flag", "status"]))


def test_t1_matches_across_both_device_paths_and_hosts():
    """T1 through the reference's device path (its JAX program on the CPU;
    its host cannot take a duration's min) and the port's device path on
    the CPU (the kernels' plain versions: K1, K2, K7 and four K3) and host:
    keys, counts, timestamps and durations equal, sums within rtol 1e-5."""
    cols = _t1_columns()
    ref = daft_tpu.from_pydict({
        **{k: cols[k] for k in ("flag", "status", "price")},
        "ship": RSeries.from_numpy(cols["ship"].astype("datetime64[us]"), "ship"),
        "rec": RSeries.from_numpy(cols["rec"].astype("datetime64[us]"), "rec")})
    with ref_ctx(device_mode="on"):
        want = _t1(daft_tpu, ref).to_pydict()
    T = daft_tpu_torch.DataType
    ok = np.ones(len(cols["ship"]), dtype=bool)
    port = daft_tpu_torch.from_numpy_columns(
        {k: (v, ok) for k, v in cols.items()},
        {"flag": T.string(), "status": T.string(), "price": T.float64(),
         "ship": T.timestamp("us"), "rec": T.timestamp("us")})
    for mode in ("on", "off"):
        counters.reset()
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode=mode):
            got = _t1(daft_tpu_torch, port).to_pydict()
        snap = counters.snapshot()
        if mode == "on":
            assert snap["device_grouped_batches"] == 1
            assert snap["plain_segment_extreme_int64"] == 4
            assert snap["plain_segment_sum_planes"] >= 1
            assert snap["plain_segment_sum_float_planes"] >= 1
        else:
            assert snap["device_grouped_batches"] == 0
        for c in want:
            if c == "s":
                np.testing.assert_allclose(got[c], want[c], rtol=1e-5)
            else:
                assert got[c] == want[c], (mode, c)


def _mixed_frame(n=3000):
    """A date, naive timestamps in ms / us / ns (one instant each row) and
    a zoned us timestamp, with nulls and values before 1970."""
    rng = np.random.default_rng(11)
    day = 86_400_000_000
    us = rng.integers(-900, 20_000, n).astype(np.int64) * day + rng.integers(0, day, n)
    us[:40] = us[40:80]  # repeated instants, so is_in hits more than one row
    ok = rng.random(n) > 0.05
    T = daft_tpu_torch.DataType
    cols = {"k": (rng.integers(0, 4, n), np.ones(n, dtype=bool)),
            "d": (np.floor_divide(us, day).astype(np.int32), ok),
            "ts": (us, ok), "tsm": (np.floor_divide(us, 1000), ok), "tsn": (us * 1000, ok),
            "tsz": (us, ok)}
    schema = {"k": T.int64(), "d": T.date(), "ts": T.timestamp("us"),
              "tsm": T.timestamp("ms"), "tsn": T.timestamp("ns"),
              "tsz": T.timestamp("us", "America/New_York")}
    return daft_tpu_torch.from_numpy_columns(cols, schema), us


def _mixed_cases(us):
    c, lit, T = daft_tpu_torch.col, daft_tpu_torch.lit, daft_tpu_torch.DataType
    hit = datetime.datetime(1970, 1, 1) + datetime.timedelta(microseconds=int(us[50]))
    return {
        # (predicate, aggregate child, whether the device runs it)
        "cast_date_to_ts": (c("d").cast(T.timestamp("us")) >= lit(datetime.datetime(1995, 1, 1)),
                            c("d").cast(T.timestamp("ms")), True),
        "ts_ns_is_in": (c("tsn").is_in([hit, None]), c("tsn"), True),
        "ts_cast_date": (c("ts").cast(T.date()) < lit(datetime.date(1990, 3, 1)),
                         c("tsn").cast(T.date()), True),
        "date_vs_ts": (c("d") < lit(datetime.datetime(1990, 3, 1, 12)),
                       c("tsm") - c("ts"), True),
        "ms_vs_us_between": (c("tsm").between(lit(datetime.datetime(1969, 6, 1, 0, 0, 0, 1)),
                                              lit(datetime.datetime(2001, 1, 1))),
                             c("tsm").cast(T.timestamp("ns")) + (c("tsn") - c("ts")), True),
        # a zone read, a cast that could lose ticks: left on the host
        "zoned_ts_cast_date": (c("tsz").cast(T.date()) >= lit(datetime.date(1995, 1, 1)),
                               c("ts"), False),
        "ts_cast_coarser": (c("tsn").cast(T.timestamp("us")) >= lit(datetime.datetime(1995, 1, 1)),
                            c("ts"), False),
    }


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "ungrouped"])
@pytest.mark.parametrize("case", sorted(_mixed_cases(np.zeros(100, dtype=np.int64))))
def test_temporal_casts_and_meetings_on_the_device_equal_the_host(case, grouped):
    """Temporal operands of different types, casts and is_in items in the
    device program: the stored ints are rescaled as the host's casts do,
    and a predicate with a cast that reads a zone or could lose ticks is
    left to the host (the aggregates still run on the device)."""
    from daft_tpu_torch.ops.device_eval import is_device_evaluable

    df, us = _mixed_frame()
    pred, child, on_device = _mixed_cases(us)[case]
    assert is_device_evaluable(pred, df.schema) == on_device
    assert is_device_evaluable(child, df.schema)
    c = daft_tpu_torch.col
    q = df.where(pred)
    aggs = [c("k").count().alias("n"), child.min().alias("mn"), child.max().alias("mx")]
    q = q.groupby("k").agg(*aggs).sort("k") if grouped else q.agg(*aggs)
    got = {}
    for mode in ("on", "off"):
        counters.reset()
        with daft_tpu_torch.execution_config_ctx(device="cpu", device_mode=mode,
                                                 device_min_rows=1):
            got[mode] = q.to_pydict()
        ran = counters.snapshot()["device_grouped_batches" if grouped else "device_stage_batches"]
        assert ran == (mode == "on"), (mode, ran)
    assert got["on"] == got["off"]
    assert sum(got["off"]["n"]) > 0


def test_the_temporal_meeting_rule():
    from daft_tpu_torch.core.temporal import common_temporal_type, widen_factor

    T = daft_tpu_torch.DataType
    ny = T.timestamp("ms", "America/New_York")
    assert common_temporal_type(T.date(), T.timestamp("ms")) == T.timestamp("ms")
    assert common_temporal_type(T.timestamp("s"), ny) is None
    assert common_temporal_type(ny, T.timestamp("ns", "UTC")) == T.timestamp("ns", ny.timezone)
    assert common_temporal_type(T.duration("s"), T.duration("us")) == T.duration("us")
    assert common_temporal_type(T.time("s"), T.time("ms")) == T.time("us")
    assert common_temporal_type(T.date(), T.duration("s")) is None
    assert widen_factor(T.date(), T.timestamp("ms")) == 86_400_000
    assert widen_factor(T.time("s"), T.time("us")) == 1
    assert widen_factor(T.timestamp("us"), T.timestamp("ms")) is None
    assert widen_factor(T.duration("s"), T.timestamp("s")) is None


def test_t1_device_literals_are_the_columns_storage_ints():
    from daft_tpu_torch.expressions.expressions import Literal

    T = daft_tpu_torch.DataType
    ny = datetime.datetime(2020, 6, 1, 12, tzinfo=NY)
    assert Literal(ny).storage_value() == 1591027200000000
    assert Literal(datetime.timedelta(days=20)).storage_value() == 20 * 86_400_000_000
    assert Literal(datetime.datetime(1969, 12, 31, 23, 59, 59, 999999), T.timestamp("s")) \
        .storage_value() == -1
    assert Literal(datetime.date(1969, 12, 31)).storage_value() == -1
    assert Literal(datetime.time(1, 2, 3), T.time("ns")).storage_value() == 3_723_000_000_000


# ---- windows ------------------------------------------------------------------------------

WIN = {"k": [i % 4 for i in range(200)], "o": [(i * 37) % 101 for i in range(200)],
       "x": [None if i % 23 == 0 else round(((i * 7919) % 1000) / 7.0, 3) for i in range(200)]}


@pytest.mark.parametrize("frame", ["rows3", "rows_unbounded", "rows_following", "range5",
                                   "partition", "ordered_default"])
@pytest.mark.parametrize("fn", ["stddev", "var"])
def test_windowed_stddev_and_var_bit_for_bit(frame, fn):
    def q(m):
        w = m.Window().partition_by("k")
        if frame != "partition":
            w = w.order_by("o")
        if frame == "rows3":
            w = w.rows_between(-3, m.Window.current_row)
        elif frame == "rows_unbounded":
            w = w.rows_between(m.Window.unbounded_preceding, m.Window.current_row)
        elif frame == "rows_following":
            w = w.rows_between(-1, 2)
        elif frame == "range5":
            w = w.range_between(-5, 5)
        return m.from_pydict(WIN).select(m.col("k"), m.col("o"),
                                         getattr(m.col("x"), fn)().over(w).alias("w"))

    with ref_ctx(device_mode="off"):
        want = q(daft_tpu).to_pydict()
    with _port_ctx():
        got = q(daft_tpu_torch).to_pydict()
    assert [None if v is None else np.float64(v).tobytes() for v in got["w"]] == \
        [None if v is None else np.float64(v).tobytes() for v in want["w"]]


# ---- the plan surface ---------------------------------------------------------------------

_rng = np.random.default_rng(2)
SURF = {"k": _rng.integers(0, 5, 3000).tolist(),
        "f": _rng.choice(["A", "N", "R"], 3000).tolist(),
        "s": _rng.choice(["F", "O"], 3000).tolist(),
        "x": np.round(_rng.normal(0, 10, 3000), 3).tolist(),
        "y": _rng.integers(-100, 100, 3000).tolist()}
SURF["x"][3] = None
SURF["x"][7] = float("nan")


def _pd(df):
    return df.to_pydict()


SURFACE = {
    "sample": lambda m, df: _pd(df.sample(0.1, seed=7)),
    "sample_batched": lambda m, df: _pd(df.into_batches(100).sample(0.1, seed=7)),
    "sample_repl": lambda m, df: len(_pd(df.sample(0.1, with_replacement=True, seed=3))["k"]),
    "unpivot": lambda m, df: _pd(df.unpivot(["k"], ["x", "y"])),
    "unpivot_names": lambda m, df: _pd(df.unpivot("k", ["y"], "var", "val")),
    "melt_mixed": lambda m, df: _pd(df.melt("k")),
    "pivot": lambda m, df: _pd(df.pivot("k", "f", "y", "sum").sort("k")),
    "pivot_mean": lambda m, df: _pd(df.pivot(["k", "s"], "f", "x", "mean").sort(["k", "s"])),
    "pivot_names": lambda m, df: _pd(df.pivot("k", "f", "y", "max", names=["A", "R", "Z"])
                                     .sort("k")),
    "mono_id": lambda m, df: _pd(df.into_partitions(3).add_monotonically_increasing_id()),
    "mono_id_named": lambda m, df: _pd(df.add_monotonically_increasing_id("rid").limit(5)),
    "count_rows": lambda m, df: df.where(m.col("k") > 1).count_rows(),
    "len": lambda m, df: len(df),
    "stddev": lambda m, df: _pd(df.stddev("x", "y")), "var": lambda m, df: _pd(df.var("x")),
    "skew": lambda m, df: _pd(df.skew("y")),
    "any_value": lambda m, df: _pd(df.where(m.col("k") == 1).select("k").any_value("k")),
    "g_stddev": lambda m, df: _pd(df.groupby("k").stddev("x").sort("k")),
    "g_var": lambda m, df: _pd(df.groupby("k").var("y").sort("k")),
    "g_skew": lambda m, df: _pd(df.groupby("k").skew("y").sort("k")),
    "g_any_value": lambda m, df: _pd(df.groupby("k").any_value("f").sort("k")),
    "with_columns": lambda m, df: _pd(df.with_columns({"a": m.col("y") * 2,
                                                       "x": m.col("x") + 1})),
    "renamed": lambda m, df: _pd(df.with_column_renamed("x", "xx")
                                 .with_columns_renamed({"y": "yy", "k": "kk"})),
    "drop_null": lambda m, df: _pd(df.drop_null()),
    "drop_nan": lambda m, df: _pd(df.drop_nan()),
    "drop_nan_x": lambda m, df: _pd(df.drop_nan("x")),
    "describe": lambda m, df: _pd(df.describe()),
    "to_pylist": lambda m, df: df.limit(5).to_pylist(),
    "iter_rows": lambda m, df: list(df.limit(3).iter_rows()),
    "iter_partitions": lambda m, df: [p.num_rows for p in
                                      df.into_partitions(4).iter_partitions()],
    "into_batches": lambda m, df: [p.num_rows for p in df.into_batches(700).iter_partitions()],
    "pipe": lambda m, df: _pd(df.pipe(lambda d, c: d.select(c), "k").limit(3)),
    "transform": lambda m, df: _pd(df.transform(lambda d: d.limit(2))),
    "preview": lambda m, df: df.limit(3)._preview_string(3),
}


def _equal(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, float) and isinstance(b, float):
        return (a != a and b != b) or abs(a - b) <= 1e-9 * max(1.0, abs(a))
    return a == b


@pytest.mark.parametrize("name", sorted(SURFACE))
def test_surface_method_matches_the_reference(name):
    with ref_ctx(device_mode="off"):
        want = SURFACE[name](daft_tpu, daft_tpu.from_pydict(SURF))
    with _port_ctx():
        got = SURFACE[name](daft_tpu_torch, daft_tpu_torch.from_pydict(SURF))
    assert _equal(got, want), (got, want)


def test_seeded_sample_keeps_the_same_rows_however_batched():
    df = daft_tpu_torch.from_pydict({"i": list(range(5000))})
    with _port_ctx():
        a = df.sample(0.05, seed=11).to_pydict()["i"]
        b = df.into_batches(333).sample(0.05, seed=11).to_pydict()["i"]
        c = df.sample(0.05, seed=12).to_pydict()["i"]
    with ref_ctx(device_mode="off"):
        want = daft_tpu.from_pydict({"i": list(range(5000))}).sample(0.05, seed=11) \
            .to_pydict()["i"]
    assert a == b == want and a != c


def test_map_groups_matches_the_reference():
    def q(m):
        @m.udf(return_dtype=m.DataType.float64())
        def spread(x):
            v = x.to_pylist()
            return [max(v) - min(v)]
        return (m.from_pydict({"k": [1, 2, 1, 2, 3, 1], "x": [1.0, 5.0, 4.0, 2.0, 7.0, 0.5]})
                .groupby("k").map_groups(spread(m.col("x")).alias("r")).sort("k"))

    with ref_ctx(device_mode="off"):
        want = q(daft_tpu).to_pydict()
    with _port_ctx():
        got = q(daft_tpu_torch).to_pydict()
    assert got == want == {"k": [1, 2, 3], "r": [3.5, 3.0, 0.0]}


def test_surface_plan_nodes_print_and_optimize():
    from daft_tpu_torch.plan import logical as lp

    df = daft_tpu_torch.from_pydict(SURF)
    q = (df.sample(0.5, seed=1).into_batches(64).add_monotonically_increasing_id()
         .into_partitions(2).unpivot(["id", "k"], ["y"]).select("id", "value"))
    plan = q.optimized_plan()
    names = {type(n).__name__ for n in _walk(plan)}
    assert {"Sample", "IntoBatches", "MonotonicallyIncreasingId", "IntoPartitions",
            "Unpivot"} <= names
    assert isinstance(plan, lp.LogicalPlan)
    with _port_ctx():
        got = q.to_pydict()
    with ref_ctx(device_mode="off"):
        rdf = daft_tpu.from_pydict(SURF)
        want = (rdf.sample(0.5, seed=1).into_batches(64).add_monotonically_increasing_id()
                .into_partitions(2).unpivot(["id", "k"], ["y"]).select("id", "value")
                .to_pydict())
    assert got == want


def _walk(node):
    yield node
    for c in node.children():
        yield from _walk(c)
