"""The temporal functions of the registry (counterpart of the temporal part of
daft_tpu/functions/registry.py, the zone ops, duration totals, ``unix_date``,
``dt_nanosecond`` and the partition transforms of ``breadth.py``, and the
temporal part of ``extra.py``), in numpy over storage ints.

The reference computes these with Arrow's kernels; each here gives Arrow's
answer: fields of a zoned timestamp in its zone's local time (the offset
per value from the zone's transitions, core/temporal.py), days and hours
floored toward minus infinity before 1970, ``dt_truncate`` as Arrow's
``floor_temporal`` (an ambiguous or missing local result raises), and
``dt_strftime`` / ``utf8_to_datetime`` as Arrow's strftime and strptime
read their formats. Every zone function is vectorised: no Python loop per
row.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core import temporal as T
from ..core.series import Series
from ..datatype import DataType
from .registry import _need, _out, _rt_const, _rt_same, _str_map, register

_S = DataType.string()
_PER_DAY = {u: T.SECONDS_PER_DAY * p for u, p in T.PER_SECOND.items()}


# ---- the civil fields of a column -------------------------------------------------------


def _local_ticks(s: Series):
    """(local ticks, unit) of a date or timestamp column; a date is its
    midnight in seconds."""
    v = s.to_numpy().astype(np.int64)
    if s.dtype.kind == "date":
        return v * np.int64(T.SECONDS_PER_DAY), "s"
    return T.to_local(v, s.dtype.time_unit, s.dtype.timezone), s.dtype.time_unit


def _days(s: Series) -> np.ndarray:
    """Local days since 1970-01-01 of a date or timestamp column."""
    if s.dtype.kind == "date":
        return s.to_numpy().astype(np.int64)
    local, unit = _local_ticks(s)
    return np.floor_divide(local, _PER_DAY[unit])


def _time_of_day(s: Series):
    """(ticks since local midnight, unit) of a timestamp or time column."""
    if s.dtype.kind == "time":
        return s.to_numpy().astype(np.int64), s.dtype.storage_unit
    local, unit = _local_ticks(s)
    return np.mod(local, _PER_DAY[unit]), unit


def _weekday(days: np.ndarray) -> np.ndarray:
    """Monday 0 .. Sunday 6 (1970-01-01 was a Thursday)."""
    return (days + 3) % 7


def _iso_week(days: np.ndarray) -> np.ndarray:
    thursday = days - _weekday(days) + 3
    y, _m, _d = T.civil_from_days(thursday)
    jan1 = T.days_from_civil_np(y, np.ones_like(y), np.ones_like(y))
    return (thursday - jan1) // 7 + 1


def _is_leap(year: np.ndarray) -> np.ndarray:
    return (year % 4 == 0) & ((year % 100 != 0) | (year % 400 == 0))


def _date_field(part: str, days: np.ndarray) -> np.ndarray:
    y, m, d = T.civil_from_days(days)
    if part == "year":
        return y
    if part == "month":
        return m
    if part == "day":
        return d
    if part == "day_of_year":
        return days - T.days_from_civil_np(y, np.ones_like(y), np.ones_like(y)) + 1
    if part == "day_of_week":
        return _weekday(days)
    if part == "week_of_year":
        return _iso_week(days)
    if part == "quarter":
        return (m - 1) // 3 + 1
    if part == "is_leap_year":
        return _is_leap(y)
    # days_in_month
    nm = np.where(m == 12, 1, m + 1)
    ny = np.where(m == 12, y + 1, y)
    return T.days_from_civil_np(ny, nm, np.ones_like(nm)) - \
        T.days_from_civil_np(y, m, np.ones_like(m))


def _date_fn(part: str, out_dt: DataType):
    def host(args, kwargs):
        s = args[0]
        return _out(s, out_dt, _date_field(part, _days(s)), s.validity_numpy())
    return host


for _name, _part, _dt in [
    ("dt_year", "year", DataType.int32()), ("dt_month", "month", DataType.uint32()),
    ("dt_day", "day", DataType.uint32()), ("dt_day_of_year", "day_of_year", DataType.uint32()),
    ("dt_day_of_week", "day_of_week", DataType.uint32()),
    ("dt_week_of_year", "week_of_year", DataType.uint32()),
    ("dt_quarter", "quarter", DataType.uint32()),
    ("dt_is_leap_year", "is_leap_year", DataType.bool()),
    ("dt_days_in_month", "days_in_month", DataType.uint32()),
]:
    register(_name, _rt_const(_dt), _date_fn(_part, _dt), check=_need("date"))


def _clock_field(part: str):
    """hour, minute, second, millisecond (of the second) and microsecond
    (of the millisecond), as Arrow's field kernels give them: the second
    and its fractions of a zoned timestamp from its UTC reading (Arrow
    takes them to be the zone's, which holds for whole-minute offsets)."""
    def host(args, kwargs):
        s = args[0]
        if s.dtype.kind == "timestamp" and part not in ("hour", "minute"):
            unit = s.dtype.time_unit
            tod = np.mod(s.to_numpy().astype(np.int64), _PER_DAY[unit])
        else:
            tod, unit = _time_of_day(s)
        ns = T.convert_unit(tod, unit, "ns")
        secs = ns // 1_000_000_000
        out = {"hour": secs // 3600, "minute": secs // 60 % 60, "second": secs % 60,
               "millisecond": ns // 1_000_000 % 1000,
               "microsecond": ns // 1000 % 1000}[part]
        return _out(s, DataType.uint32(), out, s.validity_numpy())
    return host


for _part in ("hour", "minute", "second", "millisecond", "microsecond"):
    register(f"dt_{_part}", _rt_const(DataType.uint32()), _clock_field(_part),
             check=_need("clock"))


def _nanosecond_host(args, kwargs):
    # the reference's dt_nanosecond: the microsecond field times 1000
    s = args[0]
    us = _clock_field("microsecond")([s], {}).to_numpy().astype(np.int64)
    return _out(s, DataType.int64(), us * 1000, s.validity_numpy())


register("dt_nanosecond", _rt_const(DataType.int64()), _nanosecond_host, check=_need("clock"))


def _dt_date(args, kwargs):
    return args[0].cast(DataType.date())


def _dt_time(args, kwargs):
    return args[0].cast(DataType.time("us"))


register("dt_date", _rt_const(DataType.date()), _dt_date, check=_need("date"))
register("dt_time", _rt_const(DataType.time("us")), _dt_time, check=_need("timestamp"))


# ---- dt_truncate (Arrow's floor_temporal) -------------------------------------------------

_SUBDAY_NS = {"nanosecond": 1, "microsecond": 1_000, "millisecond": 1_000_000,
              "second": 1_000_000_000, "minute": 60_000_000_000, "hour": 3_600_000_000_000}
_FLOOR_UNITS = tuple(_SUBDAY_NS) + ("day", "week", "month", "quarter", "year")


def _parse_interval(interval: str):
    count, unit = interval.split()
    unit = unit.rstrip("s")
    if unit not in _FLOOR_UNITS:
        raise ValueError(f"dt_truncate: unknown unit in the interval {interval!r}; "
                         f"expected one of {_FLOOR_UNITS}")
    return int(count), unit


def floor_ticks(v: np.ndarray, unit: str, n: int, what: str) -> np.ndarray:
    """Wall-clock ticks of ``unit`` floored to ``n`` ``what``s, counted from
    1970-01-01 (days, and weeks from the Monday before it) or from January
    of year 0 (months, quarters, years), as floor_temporal counts them."""
    per_ns = 1_000_000_000 // T.PER_SECOND[unit]
    if what in _SUBDAY_NS:
        step = _SUBDAY_NS[what] * n
        if step % per_ns == 0:  # a multiple of the column's tick
            k = step // per_ns
            return np.floor_divide(v, k) * k
        fine = v * np.int64(per_ns)  # work in ns, back by truncation (Arrow's cast)
        floored = np.floor_divide(fine, step) * step
        q = np.abs(floored) // per_ns
        return np.where(floored < 0, -q, q)
    per_day = _PER_DAY[unit]
    d = np.floor_divide(v, per_day)
    if what == "day":
        days = np.floor_divide(d, n) * n
    elif what == "week":
        days = np.floor_divide(d + 3, 7 * n) * (7 * n) - 3
    else:
        y, m, _ = T.civil_from_days(d)
        months = y * 12 + (m - 1)
        step = {"month": n, "quarter": 3 * n, "year": 12 * n}[what]
        fl = np.floor_divide(months, step) * step
        days = T.days_from_civil_np(np.floor_divide(fl, 12), fl % 12 + 1, np.ones_like(fl))
    return days * np.int64(per_day)


def _truncate_host(args, kwargs):
    s = args[0]
    n, what = _parse_interval(kwargs["interval"])
    valid = s.validity_numpy()
    v = np.where(valid, s.to_numpy().astype(np.int64), 0)
    kind = s.dtype.kind
    if kind == "date":
        secs = floor_ticks(v * np.int64(T.SECONDS_PER_DAY), "s", n, what)
        return _out(s, s.dtype, np.floor_divide(secs, T.SECONDS_PER_DAY), valid)
    if kind == "time":
        return _out(s, s.dtype, floor_ticks(v, s.dtype.storage_unit, n, what), valid)
    unit, tz = s.dtype.time_unit, s.dtype.timezone
    local = floor_ticks(T.to_local(v, unit, tz), unit, n, what)
    return _out(s, s.dtype, T.from_local(local, unit, tz, "raise", "raise"), valid)


register("dt_truncate", _rt_same, _truncate_host, check=_need("temporal"))


def _epoch_host(args, kwargs):
    s = args[0]
    unit = kwargs.get("unit", "s")
    valid = s.validity_numpy()
    v = np.where(valid, s.to_numpy().astype(np.int64), 0)
    if s.dtype.kind == "date":
        out = T.convert_unit(v * np.int64(T.SECONDS_PER_DAY), "s", unit)
    else:
        out = T.convert_unit(v, s.dtype.time_unit, unit)
    return _out(s, DataType.int64(), out, valid)


register("dt_to_unix_epoch", _rt_const(DataType.int64()), _epoch_host, check=_need("date"))


# ---- dt_strftime (Arrow's strftime) ---------------------------------------------------------

_DAY_ABBR = ("Mon", "Tue", "Wed", "Thu", "Fri", "Sat", "Sun")
_DAY_FULL = ("Monday", "Tuesday", "Wednesday", "Thursday", "Friday", "Saturday", "Sunday")
_MON_ABBR = ("Jan", "Feb", "Mar", "Apr", "May", "Jun", "Jul", "Aug", "Sep", "Oct", "Nov", "Dec")
_MON_FULL = ("January", "February", "March", "April", "May", "June", "July", "August",
             "September", "October", "November", "December")
# composite directives, as the date library expands them (%c, %x, %X without
# the fraction of a second)
_COMPOSITE = {"D": "%m/%d/%y", "F": "%Y-%m-%d", "R": "%H:%M", "T": "%H:%M:%S",
              "c": "%a %b %e %H:%M:%<S> %Y", "x": "%m/%d/%y", "X": "%H:%M:%<S>"}


def _expand(fmt: str) -> str:
    out, i = [], 0
    while i < len(fmt):
        if fmt[i] == "%" and i + 1 < len(fmt) and fmt[i + 1] in _COMPOSITE:
            out.append(_COMPOSITE[fmt[i + 1]])
            i += 2
        elif fmt[i] == "%" and i + 1 < len(fmt):
            out.append(fmt[i:i + 2])
            i += 2
        else:
            out.append(fmt[i])
            i += 1
    return "".join(out)


def _iso_year(days: int, weekday: int) -> int:
    thursday = days - weekday + 3
    return int(T.civil_from_days(np.asarray([thursday]))[0][0])


def _format_one(fmt: str, local: int, unit: str, utc_off: Optional[int], abbr: Optional[str]):
    per = T.PER_SECOND[unit]
    secs, sub = divmod(local, per)
    days, sod = divmod(secs, T.SECONDS_PER_DAY)
    y, m, d = (int(x[0]) for x in T.civil_from_days(np.asarray([days])))
    hh, rest = divmod(sod, 3600)
    mi, ss = divmod(rest, 60)
    wd = (days + 3) % 7
    doy = days - int(T.days_from_civil_np(y, 1, 1)) + 1
    width = {"s": 0, "ms": 3, "us": 6, "ns": 9}[unit]
    frac = f".{sub:0{width}d}" if width else ""
    out, i = [], 0
    while i < len(fmt):
        c = fmt[i]
        if c != "%" or i + 1 >= len(fmt):
            out.append(c)
            i += 1
            continue
        if fmt.startswith("%<S>", i):
            out.append(f"{ss:02d}")
            i += 4
            continue
        k = fmt[i + 1]
        i += 2
        if k == "Y":
            out.append(f"{y:04d}" if y >= 0 else f"{y:05d}")
        elif k == "m":
            out.append(f"{m:02d}")
        elif k == "d":
            out.append(f"{d:02d}")
        elif k == "e":
            out.append(f"{d:2d}")
        elif k == "H":
            out.append(f"{hh:02d}")
        elif k == "I":
            out.append(f"{(hh % 12) or 12:02d}")
        elif k == "M":
            out.append(f"{mi:02d}")
        elif k == "S":
            out.append(f"{ss:02d}{frac}")
        elif k == "p":
            out.append("AM" if hh < 12 else "PM")
        elif k == "y":
            out.append(f"{y % 100:02d}")
        elif k == "C":
            out.append(f"{y // 100:02d}")
        elif k == "j":
            out.append(f"{doy:03d}")
        elif k == "a":
            out.append(_DAY_ABBR[wd])
        elif k == "A":
            out.append(_DAY_FULL[wd])
        elif k in "bh":
            out.append(_MON_ABBR[m - 1])
        elif k == "B":
            out.append(_MON_FULL[m - 1])
        elif k == "u":
            out.append(str(wd + 1))
        elif k == "w":
            out.append(str((wd + 1) % 7))
        elif k == "U":
            out.append(f"{(doy - 1 - (wd + 1) % 7 + 7) // 7:02d}")
        elif k == "W":
            out.append(f"{(doy - 1 - wd + 7) // 7:02d}")
        elif k == "V":
            out.append(f"{int(_iso_week(np.asarray([days]))[0]):02d}")
        elif k == "G":
            out.append(f"{_iso_year(days, wd):04d}")
        elif k == "g":
            out.append(f"{_iso_year(days, wd) % 100:02d}")
        elif k == "n":
            out.append("\n")
        elif k == "t":
            out.append("\t")
        elif k == "%":
            out.append("%")
        elif k == "z":
            o = utc_off
            out.append(("-" if o < 0 else "+") + f"{abs(o) // 3600:02d}{abs(o) % 3600 // 60:02d}")
        elif k == "Z":
            out.append(abbr)
        else:  # a directive the date library does not know stays as it is
            out.append("%" + k)
    return "".join(out)


def _strftime_host(args, kwargs):
    s = args[0]
    fmt = kwargs.get("format")
    valid = s.validity_numpy()
    v = np.where(valid, s.to_numpy().astype(np.int64), 0)
    if s.dtype.kind == "date":
        fmt = fmt or "%Y-%m-%d"
        unit, tz, utc = "s", None, v * np.int64(T.SECONDS_PER_DAY)
    else:
        fmt = fmt or "%Y-%m-%dT%H:%M:%S%.f"
        unit, tz, utc = s.dtype.time_unit, s.dtype.timezone, v
    fmt = _expand(fmt.replace("%.f", "%f"))
    if tz is None and ("%z" in fmt or "%Z" in fmt):
        raise ValueError(f"Timezone not present, cannot convert to string with timezone: {fmt}")
    local = T.to_local(utc, unit, tz)
    per = T.PER_SECOND[unit]
    out = np.empty(len(s), dtype=object)
    zone = T.get_zone(tz) if tz is not None else None
    rows = []
    for u, lo, ok in zip(utc.tolist(), local.tolist(), valid.tolist()):
        if not ok:
            rows.append(None)
            continue
        off = abbr = None
        if zone is not None:
            off = (lo - u) // per
            abbr = "UTC" if tz == "UTC" else zone.abbrev_of(u // per)
        rows.append(_format_one(fmt, lo, unit, off, abbr))
    out[:] = rows
    return Series(s.name, _S, out, valid.copy())


register("dt_strftime", _rt_const(_S), _strftime_host, check=_need("date"))


# ---- strptime (Arrow's vendored strptime) -----------------------------------------------------

_MONTHS = tuple(m.lower() for m in _MON_FULL)
_WEEKDAYS = tuple(d.lower() for d in _DAY_FULL)
# directive -> (field, max digits, min, max)
_NUMERIC = {"Y": ("year", 4, 0, 9999), "m": ("month", 2, 1, 12), "d": ("day", 2, 1, 31),
            "e": ("day", 2, 1, 31), "y": ("yy", 2, 0, 99), "j": ("doy", 3, 1, 366),
            "H": ("hour", 2, 0, 23), "M": ("minute", 2, 0, 59), "S": ("second", 2, 0, 61),
            "I": ("hour12", 2, 1, 12), "C": ("century", 2, 0, 99)}
_PARSE_COMPOSITE = {"D": "%m/%d/%y", "F": "%Y-%m-%d", "R": "%H:%M", "T": "%H:%M:%S"}


def days_from_civil(y: int, m: int, d: int) -> int:
    """Days since 1970-01-01 of a proleptic Gregorian date, any year."""
    return int(T.days_from_civil_np(y, m, d))


def strptime_seconds(v: str, format: str):
    """``v`` parsed by ``format`` as Arrow's strptime reads it: (seconds
    since 1970-01-01 UTC, whether the format read a zone), or None where it
    does not parse. Whitespace in the format matches any run of it; a
    numeric field skips leading whitespace and reads at most its digits
    within its range (%Y four, %y 69-99 as 19xx and 00-68 as 20xx, %S up to
    61, rolling over); month and weekday names match in any case, whole or
    abbreviated; %p reads AM or PM; %z reads Z, +hh, +hhmm or +hh:mm; %s
    reads epoch seconds; every character of ``v`` is consumed, and a day
    past its month's end rolls into the next."""
    fmt = format
    for k, e in _PARSE_COMPOSITE.items():
        fmt = fmt.replace("%" + k, e)
    i, n = 0, len(v)
    f = 0
    got = {}
    while f < len(fmt):
        c = fmt[f]
        if c.isspace():
            while i < n and v[i].isspace():
                i += 1
            f += 1
            continue
        if c != "%" or f + 1 >= len(fmt):
            if i >= n or v[i] != c:
                return None
            i += 1
            f += 1
            continue
        d = fmt[f + 1]
        f += 2
        if d == "%":
            if i >= n or v[i] != "%":
                return None
            i += 1
        elif d in _NUMERIC:
            field, width, lo, hi = _NUMERIC[d]
            while i < n and v[i].isspace():
                i += 1
            j = i
            while j < n and j - i < width and v[j].isdigit():
                j += 1
            if j == i:
                return None
            val = int(v[i:j])
            if not lo <= val <= hi:
                return None
            i = j
            got[field] = val
        elif d in "bBhaA":
            names = _MONTHS if d in "bBh" else _WEEKDAYS
            low = v[i:].lower()
            for k, name in enumerate(names):
                hit = name if low.startswith(name) else name[:3] if low.startswith(name[:3]) \
                    else None
                if hit is not None:
                    i += len(hit)
                    if d in "bBh":
                        got["month"] = k + 1
                    break
            else:
                return None
        elif d == "p":
            word = v[i:i + 2].upper()
            if word not in ("AM", "PM"):
                return None
            got["pm"] = word == "PM"
            i += 2
        elif d == "z":
            if i < n and v[i] == "Z":
                got["zone"] = 0
                i += 1
                continue
            if i >= n or v[i] not in "+-" or not v[i + 1:i + 3].isdigit():
                return None
            sign = -1 if v[i] == "-" else 1
            hh = int(v[i + 1:i + 3])
            i += 3
            mm = 0
            if i < n and v[i] == ":":
                if not v[i + 1:i + 3].isdigit():
                    return None
                mm = int(v[i + 1:i + 3])
                i += 3
            elif v[i:i + 2].isdigit():
                mm = int(v[i:i + 2])
                i += 2
            got["zone"] = sign * (hh * 3600 + mm * 60)
        elif d == "s":
            j = i + (1 if i < n and v[i] in "+-" else 0)
            k = j
            while k < n and v[k].isdigit():
                k += 1
            if k == j:
                return None
            got["epoch"] = int(v[i:k])
            i = k
        else:
            return None
    if i != n:
        return None
    if "epoch" in got:
        return got["epoch"], "zone" in got
    year = got.get("year")
    if year is None:
        yy = got.get("yy")
        if yy is None:
            year = 1900
        elif "century" in got:
            year = got["century"] * 100 + yy
        else:
            year = 1900 + yy if yy >= 69 else 2000 + yy
    if "doy" in got and "month" not in got:
        days = days_from_civil(year, 1, 1) + got["doy"] - 1
    else:
        days = days_from_civil(year, got.get("month", 1), 1) + got.get("day", 1) - 1
    hour = got.get("hour", 0)
    if "hour12" in got:
        hour = got["hour12"] % 12 + (12 if got.get("pm") else 0)
    elif got.get("pm") and hour < 12:
        hour += 12
    secs = days * T.SECONDS_PER_DAY + hour * 3600 + got.get("minute", 0) * 60 \
        + got.get("second", 0) - got.get("zone", 0)
    return secs, "zone" in got


def strptime_days(v: str, format: str):
    """``v`` parsed by ``format`` in days since 1970-01-01 (Arrow's strptime
    in seconds cast to a date), or None where it does not parse."""
    got = strptime_seconds(v, format)
    return None if got is None else got[0] // T.SECONDS_PER_DAY


register("utf8_to_date", _rt_const(DataType.date()), _str_map(strptime_days, DataType.date()),
         check=_need("string"))


def _rt_to_datetime(fields, kwargs):
    tz = kwargs.get("timezone")
    if tz is None and "%z" in (kwargs.get("format") or ""):
        tz = "UTC"  # Arrow's strptime gives a UTC column when it reads a zone
    return DataType.timestamp("us", tz)


def _to_datetime_host(args, kwargs):
    s = args[0]
    dt = _rt_to_datetime([s.field()], kwargs)
    if dt.timezone is not None:
        T.get_zone(dt.timezone)  # an unknown zone raises

    def parse(v, format, timezone=None):
        got = strptime_seconds(v, format)
        return None if got is None else got[0] * 1_000_000

    return _str_map(parse, dt)([s], kwargs)


register("utf8_to_datetime", _rt_to_datetime, _to_datetime_host, check=_need("string"))


# ---- zones ----------------------------------------------------------------------------------


def _rt_zone(fields, kwargs):
    dt = fields[0].dtype
    unit = dt.time_unit if dt.kind == "timestamp" else "us"
    return DataType.timestamp(unit, kwargs.get("tz"))


def _replace_tz_host(args, kwargs):
    """The same wall-clock reading in another zone (or none): the local
    reading of a zoned column, then Arrow's assume_timezone with the
    earliest instant of an ambiguous or missing wall time."""
    s = args[0]
    tz = kwargs.get("tz")
    valid = s.validity_numpy()
    v = np.where(valid, s.to_numpy().astype(np.int64), 0)
    unit = s.dtype.time_unit
    local = T.to_local(v, unit, s.dtype.timezone)
    out = local if tz is None else T.from_local(local, unit, tz, "earliest", "earliest")
    return _out(s, DataType.timestamp(unit, tz), out, valid)


def _convert_tz_host(args, kwargs):
    s = args[0]
    if s.dtype.kind != "timestamp" or s.dtype.timezone is None:
        raise ValueError("convert_time_zone requires a timezone-aware timestamp; "
                         "use replace_time_zone on naive timestamps")
    tz = kwargs.get("tz")
    if tz is not None:
        T.get_zone(tz)  # an unknown zone raises
    return Series(s.name, DataType.timestamp(s.dtype.time_unit, tz), s.to_numpy(),
                  s.validity_numpy())


register("replace_time_zone", _rt_zone, _replace_tz_host, check=_need("timestamp"))
register("convert_time_zone", _rt_zone, _convert_tz_host, check=_need("timestamp"))


# ---- durations --------------------------------------------------------------------------------

_UNIT_NS = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}


def _total_host(target_ns: int):
    def host(args, kwargs):
        s = args[0]
        if s.dtype.kind != "duration":
            raise ValueError(f"total_* requires a duration column, got {s.dtype}")
        vals = s.to_numpy().astype(np.int64)
        with np.errstate(over="ignore"):
            out = vals * np.int64(_UNIT_NS[s.dtype.time_unit]) // np.int64(target_ns)
        return _out(s, DataType.int64(), out, s.validity_numpy())
    return host


for _name, _ns in [("total_days", 86_400_000_000_000), ("total_hours", 3_600_000_000_000),
                   ("total_minutes", 60_000_000_000), ("total_seconds", 1_000_000_000),
                   ("total_milliseconds", 1_000_000), ("total_microseconds", 1_000),
                   ("total_nanoseconds", 1)]:
    register(_name, _rt_const(DataType.int64()), _total_host(_ns), check=_need("duration"))


# ---- unix_date and the partition transforms ---------------------------------------------------


def _unix_date_host(args, kwargs):
    s = args[0]
    return _out(s, DataType.int64(), _days(s), s.validity_numpy())


register("unix_date", _rt_const(DataType.int64()), _unix_date_host, check=_need("date"))


def _partition(unit: str):
    def host(args, kwargs):
        s = args[0]
        valid = s.validity_numpy()
        if unit == "hours":
            v = np.where(valid, s.to_numpy().astype(np.int64), 0)
            us = v * np.int64(86_400_000_000) if s.dtype.kind == "date" \
                else T.convert_unit(v, s.dtype.time_unit, "us")
            q = np.abs(us) // 3_600_000_000  # Arrow's integer divide truncates
            out = np.where(us < 0, -q, q)
        else:
            days = np.where(valid, _days(s), 0)
            if unit == "days":
                out = days
            else:
                y, m, _ = T.civil_from_days(days)
                out = (y - 1970) * 12 + m - 1 if unit == "months" else y - 1970
        return _out(s, DataType.int32(), out, valid)
    return host


for _u in ("days", "hours", "months", "years"):
    register(f"partition_{_u}", _rt_const(DataType.int32()), _partition(_u),
             check=_need("date"))
