"""Timestamp stages on the card: T1 (a filter by TIMESTAMP literals and an
INTERVAL, count, sum and the extremes of a timestamp and a duration by
flag and status) and T2 (grouped by host functions of a timestamp: the
hour, the hour in America/New_York, the day), at a small size, against
the port's host path. Marked ``cuda``: skipped where no card is present.

Run on a machine with the card (tests/conftest.py imports JAX, which that
machine lacks):

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_temporal.py

T1 plans one DeviceGroupedAgg and launches K3 (the exact int64 extremes)
at least four times; keys, counts, timestamps and durations equal the
host bit for bit, the float sum within rtol 1e-5.
"""

import datetime

import numpy as np
import pytest
import torch

import daft_tpu_torch as dt
from daft_tpu_torch import col, lit
from daft_tpu_torch.ops import counters

pytestmark = pytest.mark.cuda


@pytest.fixture(autouse=True)
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is false")


US_PER_DAY = 86_400_000_000
N = 200_000


def _frame():
    rng = np.random.default_rng(22)
    ship = rng.integers(8035, 10590, N).astype(np.int64) * US_PER_DAY + rng.integers(
        0, US_PER_DAY, N)
    rec = ship + rng.integers(1, 31, N) * US_PER_DAY + rng.integers(0, US_PER_DAY, N)
    valid = np.ones(N, dtype=bool)
    valid[::97] = False
    T = dt.DataType
    return dt.from_numpy_columns(
        {"flag": (np.array(["A", "N", "R"], dtype=object)[rng.integers(0, 3, N)], np.ones(N, bool)),
         "status": (np.array(["F", "O"], dtype=object)[rng.integers(0, 2, N)], np.ones(N, bool)),
         "price": (np.round(rng.uniform(900, 105_000, N), 2), np.ones(N, bool)),
         "ship": (ship, valid), "rec": (rec, np.ones(N, bool))},
        {"flag": T.string(), "status": T.string(), "price": T.float64(),
         "ship": T.timestamp("us"), "rec": T.timestamp("us")})


def _t1(df):
    transit = col("rec") - col("ship")
    return (df.where((col("ship") >= lit(datetime.datetime(1995, 1, 1, 6, 30)))
                     & (col("ship") < lit(datetime.datetime(1996, 1, 1, 6, 30)))
                     & (transit > lit(datetime.timedelta(days=20))))
            .groupby("flag", "status")
            .agg(col("price").count().alias("n"), col("price").sum().alias("s"),
                 col("ship").min().alias("mn"), col("ship").max().alias("mx"),
                 transit.min().alias("tmn"), transit.max().alias("tmx"))
            .sort(["flag", "status"]))


def _same(got, want, floats=()):
    assert list(got) == list(want)
    for c in want:
        if c in floats:
            np.testing.assert_allclose(got[c], want[c], rtol=1e-5, atol=0.0)
        else:
            assert got[c] == want[c], c


def test_t1_on_the_card_equals_the_host_and_launches_k3():
    df = _frame()
    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        want = _t1(df).to_pydict()
    counters.reset()
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        got = _t1(df).to_pydict()
        sql = dt.sql("SELECT flag, status, COUNT(*) AS n, SUM(price) AS s, MIN(ship) AS mn, "
                     "MAX(ship) AS mx, MIN(rec - ship) AS tmn, MAX(rec - ship) AS tmx "
                     "FROM t WHERE ship >= TIMESTAMP '1995-01-01 06:30:00' AND "
                     "ship < TIMESTAMP '1996-01-01 06:30:00' AND rec - ship > INTERVAL '20' "
                     "DAY GROUP BY flag, status ORDER BY flag, status", t=df).to_pydict()
    assert counters.device_grouped_batches >= 2
    assert counters.snapshot()["launches_segment_extreme_int64"] >= 8
    assert counters.snapshot()["device_fallbacks"] == 0
    _same(got, want, ("s",))
    _same(sql, want, ("s",))


@pytest.mark.parametrize("key", ["hour", "ny_hour", "day"])
def test_t2_host_functions_feed_a_card_stage(key):
    df = _frame()
    ny = col("ship")._fn("replace_time_zone", tz="UTC")._fn("convert_time_zone",
                                                             tz="America/New_York")
    e = {"hour": col("ship").dt.hour(), "ny_hour": ny.dt.hour(),
         "day": col("ship").dt.truncate("1 day")}[key]

    def q():
        return (df.with_column("k", e).groupby("k")
                .agg(col("ship").count().alias("n"), (col("rec") - col("ship")).max()
                     .alias("m")).sort("k"))

    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        want = q().to_pydict()
    counters.reset()
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        got = q().to_pydict()
    assert counters.device_grouped_batches >= 1
    assert counters.snapshot()["launches_segment_extreme_int64"] >= 1
    _same(got, want)


@pytest.mark.parametrize("grouped", [True, False], ids=["grouped", "ungrouped"])
def test_temporal_casts_and_is_in_on_the_card_equal_the_host(grouped):
    """A date cast to a timestamp (in SQL), a timestamp cast to a date and a
    nanosecond column's is_in of a datetime: the card rescales the stored
    ints as the host's casts do."""
    df = _frame().with_column("d", col("ship").cast(dt.DataType.date()))
    by = "GROUP BY flag ORDER BY flag" if grouped else ""
    key = "flag, " if grouped else ""
    sql = (f"SELECT {key}COUNT(*) AS n, MIN(CAST(d AS TIMESTAMP)) AS mn, "
           f"MAX(CAST(d AS TIMESTAMP)) AS mx FROM t "
           f"WHERE CAST(d AS TIMESTAMP) >= TIMESTAMP '1995-01-01 00:00:00' {by}")
    ns = col("ship").cast(dt.DataType.timestamp("ns"))

    def frame_q():
        q = df.where(ns.is_in([hit]) | (col("ship").cast(dt.DataType.date())
                                        < lit(datetime.date(1993, 1, 1))))
        aggs = [col("price").count().alias("n"), col("d").min().alias("mn")]
        return q.groupby("flag").agg(*aggs).sort("flag") if grouped else q.agg(*aggs)

    with dt.execution_config_ctx(device="cpu", device_mode="off"):
        hit = df.select("ship").limit(3).to_pydict()["ship"][2]
        want = (dt.sql(sql, t=df).to_pydict(), frame_q().to_pydict())
    counters.reset()
    with dt.execution_config_ctx(device="cuda", device_mode="on"):
        got = (dt.sql(sql, t=df).to_pydict(), frame_q().to_pydict())
    snap = counters.snapshot()
    assert snap["device_grouped_batches" if grouped else "device_stage_batches"] >= 2
    assert snap["device_fallbacks"] == 0
    assert got == want
    assert sum(want[1]["n"]) > 0
