"""Timestamps, durations and times on the host: units, time zones and the
civil calendar, in numpy (the reference holds them in Arrow and computes
with Arrow's kernels; this module gives the same answers without it).

A timestamp is int64 ticks of its unit since 1970-01-01 00:00 UTC; a
zone-aware one keeps the UTC instant and reads its fields in the zone's
local time. A duration is int64 ticks; a time of day is int64 ticks since
midnight, in microseconds for the units s, ms and us and in nanoseconds for
ns (the reference maps ``time(s)`` and ``time(ms)`` to Arrow's time64[us]).

Zones: ``"UTC"``, fixed offsets (``"+05:30"``, ``"-0800"``) and IANA names,
read from the TZif files of ``zoneinfo.TZPATH`` or, failing that, the
``tzdata`` package, as Python's ``zoneinfo`` finds them. The offset of an
instant is a ``searchsorted`` over the zone's transitions. A "slim" file
stops its table early and leaves the rest to its footer rule: the table is
then extended from ``zoneinfo`` up to 2038, where a "fat" file's table
ends; past the table's end the last offset holds, as Arrow reads a zone.
A zone that is found nowhere raises: nothing falls back to UTC.
"""

from __future__ import annotations

import datetime
import os
import re
import struct
import threading
from typing import Dict, Optional

import numpy as np

UNITS = ("s", "ms", "us", "ns")
PER_SECOND = {"s": 1, "ms": 1_000, "us": 1_000_000, "ns": 1_000_000_000}
SECONDS_PER_DAY = 86_400


def convert_unit(values: np.ndarray, frm: str, to: str, safe: bool = True) -> np.ndarray:
    """int64 ticks of ``frm`` as ticks of ``to``. A coarser target raises
    where a value would lose ticks and ``safe`` (Arrow's safe cast), else
    truncates toward zero (Arrow's unsafe cast)."""
    v = np.asarray(values, dtype=np.int64)
    a, b = PER_SECOND[frm], PER_SECOND[to]
    if a == b:
        return v
    if b > a:
        return v * np.int64(b // a)
    k = np.int64(a // b)
    if safe:
        lost = v % k != 0
        if lost.any():
            raise ValueError(f"Casting from {frm} to {to} would lose data: "
                             f"{int(v[np.argmax(lost)])}")
    q = np.abs(v) // k
    return np.where(v < 0, -q, q)


# ---- how two temporal types meet -------------------------------------------------------

_UNIT_RANK = {"s": 0, "ms": 1, "us": 2, "ns": 3}


def finer_unit(*units: str) -> str:
    return max(units, key=_UNIT_RANK.__getitem__)


def common_temporal_type(a, b):
    """The type two temporal operands meet in, as Arrow compares them: dates
    and timestamps on one clock (a date as its UTC midnight) in the finer
    timestamp unit, two durations in the finer unit, two times of day in
    the finer stored unit. None where Arrow refuses: a zoned against a
    naive timestamp, or kinds that do not meet."""
    from ..datatype import DataType

    if a == b:
        return a
    kinds = {a.kind, b.kind}
    if kinds <= {"date", "timestamp"}:
        ts = [d for d in (a, b) if d.kind == "timestamp"]
        if len(ts) == 2 and (ts[0].timezone is None) != (ts[1].timezone is None):
            return None
        return DataType.timestamp(finer_unit(*[d.time_unit for d in ts]), ts[0].timezone)
    if kinds == {"duration"}:
        return DataType.duration(finer_unit(a.time_unit, b.time_unit))
    if kinds == {"time"}:
        return DataType.time(finer_unit(a.storage_unit, b.storage_unit))
    return None


def unit_type(dtype, unit: str):
    """The type of ``dtype``'s values in ``unit``: a timestamp or duration in
    that unit, a date as a naive timestamp (its midnight)."""
    from ..datatype import DataType

    if dtype.kind == "duration":
        return DataType.duration(unit)
    return DataType.timestamp(unit, dtype.timezone if dtype.kind == "timestamp" else None)


def widen_factor(src, dst) -> Optional[int]:
    """k such that a stored value of ``src`` times k is the same value stored
    as ``dst``, for the casts that only rescale: a date to a timestamp (its
    UTC midnight) and a timestamp, duration or time to a finer unit of its
    kind (a timestamp keeps its instant whatever the zone). None for any
    other pair."""
    if src == dst:
        return 1
    if src.kind == "date" and dst.kind == "timestamp":
        return SECONDS_PER_DAY * PER_SECOND[dst.time_unit]
    if src.kind == dst.kind and src.kind in ("timestamp", "duration", "time"):
        a, b = PER_SECOND[src.storage_unit], PER_SECOND[dst.storage_unit]
        return b // a if b >= a else None
    return None


# ---- the civil calendar (days since 1970-01-01) ----------------------------------------


def civil_from_days(days: np.ndarray):
    """(year, month, day) of days since 1970-01-01, proleptic Gregorian."""
    z = np.asarray(days, dtype=np.int64) + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    y = yoe + era * 400
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    return y + (m <= 2), m, d


def days_from_civil_np(y: np.ndarray, m: np.ndarray, d: np.ndarray) -> np.ndarray:
    y = np.asarray(y, dtype=np.int64) - (np.asarray(m) <= 2)
    m = np.asarray(m, dtype=np.int64)
    era = np.floor_divide(y, 400)
    yoe = y - era * 400
    doy = (153 * np.where(m > 2, m - 3, m + 9) + 2) // 5 + np.asarray(d, dtype=np.int64) - 1
    doe = yoe * 365 + yoe // 4 - yoe // 100 + doy
    return era * 146097 + doe - 719468


# ---- zones -----------------------------------------------------------------------------

# 2038-01-01 00:00 UTC: where a fat TZif file's transitions end
_TABLE_END = 2_145_916_800
_FIXED = re.compile(r"^([+-])(\d{2}):?(\d{2})$")
_ZONES: Dict[str, "Zone"] = {}
_ZONES_LOCK = threading.Lock()


class Zone:
    """A time zone: its UTC transitions (int64 seconds, ascending), the
    offset in seconds and the abbreviation in force from each, and the
    offset and abbreviation before the first."""

    def __init__(self, name: str, times, offsets, abbrevs, before, source: str):
        self.name = name
        self.times = np.asarray(times, dtype=np.int64)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.abbrevs = list(abbrevs)
        self.before = before  # (offset, abbreviation)
        self.source = source
        self._extended_to = int(self.times[-1]) if len(self.times) else None
        self._lock = threading.Lock()

    @property
    def fixed(self) -> bool:
        return self.source == "fixed"

    def _cover(self, hi: int) -> None:
        """Extend the transition table past its file's last transition up to
        ``hi`` seconds (at most ``_TABLE_END``), from zoneinfo's footer rule."""
        if self.fixed or self._extended_to is None or hi <= self._extended_to \
                or self._extended_to >= _TABLE_END:
            return
        with self._lock:
            if hi <= self._extended_to:
                return
            import zoneinfo

            zi = zoneinfo.ZoneInfo(self.name)
            utc = datetime.timezone.utc

            def off(t):
                return int(datetime.datetime.fromtimestamp(t, utc).astimezone(zi)
                           .utcoffset().total_seconds())

            def abbr(t):
                return datetime.datetime.fromtimestamp(t, utc).astimezone(zi).tzname()

            start = self._extended_to
            stop = min(hi, _TABLE_END)
            times, offs, names = [], [], []
            t, cur = start, off(start)
            step = SECONDS_PER_DAY
            while t < stop:
                nxt = min(t + step, stop)
                o = off(nxt)
                if o != cur:
                    lo, up = t, nxt  # off(lo) == cur, off(up) != cur
                    while up - lo > 1:
                        mid = (lo + up) // 2
                        if off(mid) == cur:
                            lo = mid
                        else:
                            up = mid
                    times.append(up)
                    offs.append(off(up))
                    names.append(abbr(up))
                    cur = offs[-1]
                t = nxt
            if times:
                self.times = np.concatenate([self.times, np.asarray(times, dtype=np.int64)])
                self.offsets = np.concatenate([self.offsets,
                                               np.asarray(offs, dtype=np.int64)])
                self.abbrevs = self.abbrevs + names
            self._extended_to = stop

    def _index(self, seconds: np.ndarray) -> np.ndarray:
        if len(seconds):
            self._cover(int(seconds.max()))
        return np.searchsorted(self.times, seconds, side="right") - 1

    def offsets_of(self, utc_seconds: np.ndarray) -> np.ndarray:
        """The offset (seconds east of UTC) in force at each UTC instant."""
        s = np.asarray(utc_seconds, dtype=np.int64)
        if self.fixed or not len(self.times):
            return np.full(s.shape, self.before[0], dtype=np.int64)
        idx = self._index(s)
        return np.where(idx < 0, np.int64(self.before[0]), self.offsets[np.maximum(idx, 0)])

    def abbrev_of(self, utc_seconds: int) -> str:
        if self.fixed:
            return self.before[1]
        i = int(self._index(np.asarray([utc_seconds], dtype=np.int64))[0])
        return self.before[1] if i < 0 else self.abbrevs[i]

    def candidates(self, local_seconds: np.ndarray):
        """For wall-clock seconds, the offsets of the zone's two neighbouring
        periods: (offset before, offset after) the transition nearest each
        value; equal where no transition is near."""
        s = np.asarray(local_seconds, dtype=np.int64)
        if self.fixed:
            o = np.full(s.shape, self.before[0], dtype=np.int64)
            return o, o
        # the offset a UTC reading would have if the wall time were UTC,
        # and one day either side, cover every transition's neighbourhood
        a = self.offsets_of(s - SECONDS_PER_DAY)
        b = self.offsets_of(s + SECONDS_PER_DAY)
        return a, b


def _tzif_paths(name: str):
    import zoneinfo

    for root in zoneinfo.TZPATH:
        p = os.path.join(root, name)
        if os.path.isfile(p):
            yield p, p
    try:
        from importlib import resources

        parts = name.split("/")
        pkg = ".".join(["tzdata", "zoneinfo"] + parts[:-1])
        res = resources.files(pkg).joinpath(parts[-1])
        if res.is_file():
            yield f"tzdata package ({pkg}.{parts[-1]})", res
    except (ImportError, ModuleNotFoundError, FileNotFoundError, ValueError, TypeError):
        return


def _parse_tzif(data: bytes):
    if data[:4] != b"TZif":
        raise ValueError("not a TZif file")
    version = data[4]

    def header(pos):
        return struct.unpack(">6l", data[pos + 20:pos + 44])

    isut, isstd, leap, timecnt, typecnt, charcnt = header(0)
    pos = 44
    tsize = 4
    if version >= ord("2"):
        pos += timecnt * 5 + typecnt * 6 + charcnt + leap * 8 + isstd + isut
        isut, isstd, leap, timecnt, typecnt, charcnt = header(pos)
        pos += 44
        tsize = 8
    times = np.frombuffer(data, dtype=">i8" if tsize == 8 else ">i4", count=timecnt,
                          offset=pos).astype(np.int64)
    pos += timecnt * tsize
    idx = np.frombuffer(data, dtype=np.uint8, count=timecnt, offset=pos).astype(np.int64)
    pos += timecnt
    types = []
    for k in range(typecnt):
        off, isdst, ai = struct.unpack(">lBB", data[pos + 6 * k:pos + 6 * k + 6])
        types.append((off, isdst, ai))
    pos += 6 * typecnt
    chars = data[pos:pos + charcnt]

    def abbr(ai):
        end = chars.index(b"\0", ai)
        return chars[ai:end].decode("ascii", "replace")

    offsets = [types[i][0] for i in idx.tolist()]
    abbrevs = [abbr(types[i][2]) for i in idx.tolist()]
    before = (types[0][0], abbr(types[0][2])) if types else (0, "UTC")
    return times, offsets, abbrevs, before


def _fixed_abbrev(seconds: int) -> str:
    sign = "-" if seconds < 0 else "+"
    h, m = divmod(abs(seconds) // 60, 60)
    return f"{sign}{h:02d}{m:02d}"


def get_zone(name: str) -> Zone:
    """The zone named ``name`` (cached); raises ValueError when no zone
    database knows it, never falling back to UTC."""
    z = _ZONES.get(name)
    if z is not None:
        return z
    m = _FIXED.match(name)
    if m:
        sign, hh, mm = m.groups()
        off = (int(hh) * 3600 + int(mm) * 60) * (-1 if sign == "-" else 1)
        z = Zone(name, [], [], [], (off, _fixed_abbrev(off)), "fixed")
    elif name == "UTC":
        z = Zone(name, [], [], [], (0, "UTC"), "fixed")
    else:
        if not name or name.startswith("/") or ".." in name.split("/"):
            raise ValueError(f"Cannot locate or parse timezone {name!r}")
        z = None
        for where, path in _tzif_paths(name):
            data = path.read_bytes() if hasattr(path, "read_bytes") else open(path, "rb").read()
            try:
                times, offsets, abbrevs, before = _parse_tzif(data)
            except (ValueError, struct.error):
                continue
            z = Zone(name, times, offsets, abbrevs, before, where)
            break
        if z is None:
            raise ValueError(f"Cannot locate or parse timezone {name!r}: {name} not found "
                             "in the zone database (zoneinfo.TZPATH or the tzdata package)")
    with _ZONES_LOCK:
        _ZONES[name] = z
    return z


def zone_database() -> str:
    """Where zones are read from here: the first directory of
    ``zoneinfo.TZPATH`` that holds a zone, else the tzdata package, else
    "none"."""
    import zoneinfo

    for root in zoneinfo.TZPATH:
        if os.path.isfile(os.path.join(root, "UTC")) or \
                os.path.isfile(os.path.join(root, "America", "New_York")):
            return root
    try:
        import tzdata

        return f"tzdata package {getattr(tzdata, '__version__', '')} at " \
               f"{os.path.dirname(tzdata.__file__)}"
    except ImportError:
        return "none"


def to_local(values: np.ndarray, unit: str, tz: Optional[str]) -> np.ndarray:
    """UTC ticks as wall-clock ticks of the zone ``tz`` (unchanged when
    naive)."""
    v = np.asarray(values, dtype=np.int64)
    if tz is None:
        return v
    z = get_zone(tz)
    per = PER_SECOND[unit]
    if z.fixed:
        return v + np.int64(z.before[0] * per)
    secs = np.floor_divide(v, per)
    return v + z.offsets_of(secs) * np.int64(per)


def from_local(values: np.ndarray, unit: str, tz: Optional[str],
               ambiguous: str = "earliest", nonexistent: str = "earliest") -> np.ndarray:
    """Wall-clock ticks of the zone ``tz`` as UTC ticks (Arrow's
    ``assume_timezone``): an ambiguous wall time takes its earliest (or
    latest) instant; a wall time in a gap becomes the last instant before
    the gap ("earliest") or the first after it ("latest"); "raise" raises."""
    v = np.asarray(values, dtype=np.int64)
    if tz is None:
        return v
    z = get_zone(tz)
    per = np.int64(PER_SECOND[unit])
    if z.fixed:
        return v - np.int64(z.before[0]) * per
    local_s = np.floor_divide(v, per)
    oa, ob = z.candidates(local_s)
    ua = v - oa * per  # instant if the earlier period's offset applies
    ub = v - ob * per
    ok_a = z.offsets_of(np.floor_divide(ua, per)) == oa
    ok_b = z.offsets_of(np.floor_divide(ub, per)) == ob
    both = ok_a & ok_b & (ua != ub)
    if ambiguous == "raise" and both.any():
        raise ValueError("Timestamp is ambiguous in the time zone " + tz)
    amb = np.minimum(ua, ub) if ambiguous == "earliest" else np.maximum(ua, ub)
    out = np.where(both, amb, np.where(ok_a, ua, ub))
    gap = ~ok_a & ~ok_b
    if gap.any():
        if nonexistent == "raise":
            raise ValueError("Timestamp doesn't exist in the time zone " + tz)
        # the transition instant: wall time read with the later offset
        # lands after it, with the earlier offset before it
        t = np.searchsorted(z.times, np.floor_divide(ua, per), side="right") - 1
        edge = z.times[np.clip(t, 0, len(z.times) - 1)] * per
        out = np.where(gap, edge - 1 if nonexistent == "earliest" else edge, out)
    return out


# ---- Python values ---------------------------------------------------------------------

_EPOCH = datetime.datetime(1970, 1, 1)
_EPOCH_UTC = datetime.datetime(1970, 1, 1, tzinfo=datetime.timezone.utc)


def tzinfo_for(tz: str):
    """The tzinfo Arrow's ``to_pylist`` attaches: a fixed offset for
    "+hh:mm", ZoneInfo otherwise."""
    m = _FIXED.match(tz)
    if m:
        return datetime.timezone(datetime.timedelta(seconds=get_zone(tz).before[0]))
    import zoneinfo

    get_zone(tz)  # raises for an unknown zone
    return zoneinfo.ZoneInfo(tz)


def datetime_ticks(v, unit: str, tz: Optional[str]) -> int:
    """A Python datetime as ticks of ``unit``; a naive value reads as UTC,
    an aware one as its instant; sub-unit digits are floored, as Arrow
    converts them."""
    if not isinstance(v, datetime.datetime):
        raise TypeError(f"object of type {type(v)} cannot be converted to int")
    if v.tzinfo is not None:
        v = v.astimezone(datetime.timezone.utc).replace(tzinfo=None)
    d = v - _EPOCH
    us = (d.days * SECONDS_PER_DAY + d.seconds) * 1_000_000 + d.microseconds
    return _us_to(us, unit)


def _us_to(us: int, unit: str) -> int:
    if unit == "ns":
        return us * 1000
    if unit == "us":
        return us
    return us // (1_000_000 // PER_SECOND[unit])


def timedelta_ticks(v, unit: str) -> int:
    if not isinstance(v, datetime.timedelta):
        raise TypeError(f"object of type {type(v)} cannot be converted to int")
    us = (v.days * SECONDS_PER_DAY + v.seconds) * 1_000_000 + v.microseconds
    return _us_to(us, unit)


def time_ticks(v, unit: str) -> int:
    if not isinstance(v, datetime.time):
        raise TypeError(f"object of type {type(v)} cannot be converted to int")
    us = ((v.hour * 60 + v.minute) * 60 + v.second) * 1_000_000 + v.microsecond
    return _us_to(us, "ns" if unit == "ns" else "us")


def ticks_to_datetimes(values: np.ndarray, valid: np.ndarray, unit: str,
                       tz: Optional[str]) -> list:
    """Python datetimes of ticks (aware in ``tz`` when zoned); ns values
    lose their sub-microsecond digits (a datetime holds microseconds)."""
    v = np.asarray(values, dtype=np.int64)
    us = np.floor_divide(v, 1000) if unit == "ns" else convert_unit(v, unit, "us")
    delta = datetime.timedelta
    if tz is None:
        return [_EPOCH + delta(microseconds=u) if ok else None
                for u, ok in zip(us.tolist(), valid.tolist())]
    info = tzinfo_for(tz)
    return [(_EPOCH_UTC + delta(microseconds=u)).astimezone(info) if ok else None
            for u, ok in zip(us.tolist(), valid.tolist())]


def ticks_to_timedeltas(values: np.ndarray, valid: np.ndarray, unit: str) -> list:
    v = np.asarray(values, dtype=np.int64)
    us = np.floor_divide(v, 1000) if unit == "ns" else convert_unit(v, unit, "us")
    delta = datetime.timedelta
    return [delta(microseconds=u) if ok else None for u, ok in zip(us.tolist(), valid.tolist())]


def ticks_to_times(values: np.ndarray, valid: np.ndarray, unit: str) -> list:
    v = np.asarray(values, dtype=np.int64)
    us = np.floor_divide(v, 1000) if unit == "ns" else v
    out = []
    for u, ok in zip(us.tolist(), valid.tolist()):
        if not ok:
            out.append(None)
            continue
        s, micro = divmod(u, 1_000_000)
        h, rest = divmod(s, 3600)
        m, sec = divmod(rest, 60)
        out.append(datetime.time(h, m, sec, micro))
    return out
