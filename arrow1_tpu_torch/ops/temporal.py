"""Temporal functions: strptime, strftime, the calendar components, the
``*_between`` family, temporal rounding, the time-zone functions and the
``*_interval_between`` family (counterpart of arrow1_tpu/ops/temporal.py;
42 names).

Reference: cpp/src/arrow/compute/kernels/scalar_temporal_unary.cc and
scalar_temporal_binary.cc over the vendored date library. The calendar
math is Howard Hinnant's civil-date arithmetic (the algorithm that library
vendors) as plain integer torch ops on the column's device; every division
floors (``torch.div(..., rounding_mode="floor")``), so that instants
before 1970 fall on the right day, and 32-bit storage widens to int64
before it is scaled. strptime and strftime convert each distinct value
once on the host: strftime finds the distinct values with
``torch.unique`` on the device and returns a pool that holds each
formatted value once, strptime parses the pool and gathers a table by
the codes on the device.

A timestamp with a time zone is stored as UTC instants. Its calendar
components, strftime, the ``*_between`` families and rounding read its
local wall time, as pyarrow does: the zone's offset at each instant comes
from one searchsorted over the zone's transitions and a gather
(utils/tzif.py), and a rounded wall time goes back to UTC through the
zone (the earlier instant where a wall time is ambiguous). The JAX
package computes them from the UTC instant (ROADMAP Queue 3). Rounding
follows pyarrow's rules where the JAX package's differ (Queue 3):
multiples of months count from 1970-01 and of years from year 0, a
step finer than the storage truncates to its ticks, ties round up, and
``calendar_based_origin`` counts from the start of the next larger unit
(a week still from the epoch).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch
from .strings import with_pool

__all__ = ["StrptimeOptions", "StrftimeOptions", "DayOfWeekOptions",
           "WeekOptions", "RoundTemporalOptions", "AssumeTimezoneOptions",
           "civil_from_days", "days_from_civil"]

_UNIT_PER_S = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


def _fdiv(a, b):
    """Floor division (Python's //) of integer tensors."""
    return torch.div(a, b, rounding_mode="floor")


def _per_s(t: dt.DataType) -> int:
    """Storage ticks per second (date32 counts days: 1 here, scaled by
    the callers)."""
    if t.kind == "date32":
        return 1
    if t.kind == "date64":
        return 1000
    return _UNIT_PER_S[t.unit]


def _utc_offsets(col: Column):
    """(offset seconds, DST flag, ticks per second) per row of a
    timestamp with a time zone."""
    from ..utils.tzif import load_tz, offsets_at

    t = col.dtype
    if t.kind != "timestamp" or not t.tz:
        raise Invalid("timezone op requires a tz-aware timestamp column")
    ps = _UNIT_PER_S[t.unit]
    off, dst = offsets_at(load_tz(t.tz), _fdiv(col.data.to(torch.int64), ps))
    return off, dst, ps


def _wall(col: Column) -> torch.Tensor:
    """The storage as int64 wall-clock ticks: a zoned timestamp's UTC
    instants shifted to local time, anything else as stored."""
    x = col.data.to(torch.int64)
    if col.dtype.kind == "timestamp" and col.dtype.tz:
        off, _, ps = _utc_offsets(col)
        x = x + off * ps
    return x


def _days_and_rem(col: Column):
    """(days since 1970-01-01, ticks into that day) of the wall time."""
    x = _wall(col)
    if col.dtype.kind == "date32":
        return x, torch.zeros_like(x)
    per_day = 86400 * _per_s(col.dtype)
    days = _fdiv(x, per_day)
    return days, x - days * per_day


def civil_from_days(days):
    """Days since 1970-01-01 -> (year, month, day), Hinnant's
    civil_from_days."""
    z = days + 719468
    era = _fdiv(torch.where(z >= 0, z, z - 146096), 146097)
    doe = z - era * 146097
    yoe = _fdiv(doe - _fdiv(doe, 1460) + _fdiv(doe, 36524)
                - _fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + _fdiv(yoe, 4) - _fdiv(yoe, 100))
    mp = _fdiv(5 * doy + 2, 153)
    d = doy - _fdiv(153 * mp + 2, 5) + 1
    m = torch.where(mp < 10, mp + 3, mp - 9)
    y = torch.where(m <= 2, y + 1, y)
    return y, m, d


def days_from_civil(y, m, d):
    """Inverse of ``civil_from_days`` (Hinnant's days_from_civil); any of
    the three may be a Python int."""
    y = y - (m <= 2).to(torch.int64) if isinstance(m, torch.Tensor) \
        else y - int(m <= 2)
    era = _fdiv(torch.where(y >= 0, y, y - 399), 400)
    yoe = y - era * 400
    mp = torch.where(m > 2, m - 3, m + 9) if isinstance(m, torch.Tensor) \
        else (m - 3 if m > 2 else m + 9)
    doy = _fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + _fdiv(yoe, 4) - _fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def _check_temporal(name, *cols):
    for c in cols:
        if not c.dtype.is_temporal:
            raise Invalid(f"{name}: expects a temporal column")


def _int_column(x, col):
    return Column(x.to(torch.int64), dt.int64, validity=col.validity)


def _sub_unit(rem, ps: int, per_s: int):
    """Whole ``per_s`` ticks (1e3: ms, 1e6: us, 1e9: ns) in ``rem``
    ticks of ``ps`` per second, mod 1000, without overflowing int64."""
    q = _fdiv(rem, ps // per_s) if ps >= per_s else rem * (per_s // ps)
    return q % 1000


# ---- strptime / strftime ----------------------------------------------

@dataclasses.dataclass
class StrptimeOptions:
    """Reference: api_scalar.h StrptimeOptions (format and unit)."""

    format: str = "%Y-%m-%dT%H:%M:%S"
    unit: str = "us"
    error_is_null: bool = False


@dataclasses.dataclass
class StrftimeOptions:
    format: str = "%Y-%m-%dT%H:%M:%S"


def _parse_ticks(value: str, fmt: str, per_s: int) -> int:
    from datetime import datetime

    d = datetime.strptime(value, fmt)
    days = d.toordinal() - 719163
    secs = days * 86400 + d.hour * 3600 + d.minute * 60 + d.second
    return secs * per_s + d.microsecond * per_s // 10**6


def _strptime_exec(args, options: StrptimeOptions, ctx):
    """Each pool value parsed once on the host; the rows gather the
    table by their codes on the device."""
    (col,) = args
    if not col.dtype.is_binary:
        raise Invalid("strptime expects strings")
    options = options or StrptimeOptions()
    per_s = _UNIT_PER_S[options.unit]
    vals = col.dictionary.values.tolist()
    parsed = np.zeros(max(len(vals), 1), dtype=np.int64)
    ok = np.zeros(max(len(vals), 1), dtype=bool)
    for i, v in enumerate(vals):
        try:
            parsed[i] = _parse_ticks(v, options.format, per_s)
            ok[i] = True
        except (ValueError, TypeError):
            if not options.error_is_null:
                raise Invalid(f"strptime: cannot parse {v!r} with "
                              f"{options.format!r}") from None
    dev = col.device
    codes = col.data.long().clamp(0, max(len(vals) - 1, 0))
    data = torch.from_numpy(parsed).to(dev)[codes]
    validity = col.validity
    if not bool(ok.all()):
        okd = torch.from_numpy(ok).to(dev)[codes]
        validity = okd if validity is None else (validity & okd)
    return Column(data, dt.timestamp(options.unit), validity=validity)


register_function("strptime", "scalar", 1, StrptimeOptions)(_strptime_exec)


def _strftime_exec(args, options: StrftimeOptions, ctx):
    """%S carries the unit's fraction (ms .%03d, us .%06d, ns .%09d), as
    the reference's formatter does. A zoned timestamp formats its local
    time (%z its offset, as pyarrow)."""
    from datetime import datetime, timedelta, timezone

    (col,) = args
    if not col.dtype.is_temporal:
        raise Invalid("strftime expects a temporal column")
    options = options or StrftimeOptions()
    t = col.dtype
    per_s = _per_s(t)
    digits = {1: 0, 10**3: 3, 10**6: 6, 10**9: 9}[per_s]
    x = col.data.to(torch.int64)
    if t.kind == "date32":
        x = x * 86400
    uniq, inv = torch.unique(x, return_inverse=True)
    vals = uniq.cpu().numpy()
    zoned = t.kind == "timestamp" and bool(t.tz)
    if zoned:   # each distinct instant's offset
        from ..utils.tzif import load_tz, offsets_at

        offs = offsets_at(load_tz(t.tz), _fdiv(uniq, per_s))[0].cpu().numpy()
    else:
        offs = np.zeros(len(vals), np.int64)
    out = []
    for v, o in zip(vals.tolist(), offs.tolist()):
        secs, rem = divmod(v, per_s)   # floor: rem in [0, per_s)
        fmt = options.format
        if digits and "%S" in fmt:
            fmt = fmt.replace("%S", "%S." + format(rem, f"0{digits}d"))
        zone = timezone(timedelta(seconds=o)) if zoned else timezone.utc
        out.append(datetime.fromtimestamp(secs, tz=zone).strftime(fmt))
    codes = inv.to(torch.int32)
    return with_pool(codes, dt.string, col.validity,
                     np.asarray(out, dtype=object))


register_function("strftime", "scalar", 1, StrftimeOptions)(_strftime_exec)


# ---- calendar components ----------------------------------------------

def _component(name, fn, out_type=dt.int64):
    def exec_fn(args, options, ctx):
        (col,) = args
        _check_temporal(name, col)
        days, rem = _days_and_rem(col)
        y, m, d = civil_from_days(days)
        out = fn(y, m, d, days, rem, _per_s(col.dtype))
        return Column(out.to(out_type.physical_dtype()), out_type,
                      validity=col.validity)

    return exec_fn


for _name, _fn in [
        ("year", lambda y, m, d, days, rem, ps: y),
        ("month", lambda y, m, d, days, rem, ps: m),
        ("day", lambda y, m, d, days, rem, ps: d),
        ("day_of_year", lambda y, m, d, days, rem, ps:
         days - days_from_civil(y, 1, 1) + 1),
        ("hour", lambda y, m, d, days, rem, ps: _fdiv(rem, 3600 * ps)),
        ("minute", lambda y, m, d, days, rem, ps: _fdiv(rem, 60 * ps) % 60),
        ("second", lambda y, m, d, days, rem, ps: _fdiv(rem, ps) % 60),
        ("millisecond", lambda y, m, d, days, rem, ps:
         _sub_unit(rem, ps, 10**3)),
        ("microsecond", lambda y, m, d, days, rem, ps:
         _sub_unit(rem, ps, 10**6)),
        ("nanosecond", lambda y, m, d, days, rem, ps:
         _sub_unit(rem, ps, 10**9)),
        ("quarter", lambda y, m, d, days, rem, ps: _fdiv(m - 1, 3) + 1)]:
    register_function(_name, "scalar", 1)(_component(_name, _fn))

register_function("is_leap_year", "scalar", 1)(
    _component("is_leap_year", lambda y, m, d, days, rem, ps:
               (y % 4 == 0) & ((y % 100 != 0) | (y % 400 == 0)),
               out_type=dt.bool_))


@dataclasses.dataclass
class DayOfWeekOptions:
    """Reference: api_scalar.h DayOfWeekOptions (count_from_zero,
    week_start 1 = Monday .. 7 = Sunday)."""

    count_from_zero: bool = True
    week_start: int = 1


def _day_of_week_exec(args, options: DayOfWeekOptions, ctx):
    options = options or DayOfWeekOptions()
    if not 1 <= options.week_start <= 7:
        raise Invalid(f"week_start must be 1..7, got {options.week_start}")
    offset = options.week_start - 1
    bias = 0 if options.count_from_zero else 1
    return _component("day_of_week", lambda y, m, d, days, rem, ps:
                      (days + 3 - offset) % 7 + bias)(args, None, ctx)


register_function("day_of_week", "scalar", 1, DayOfWeekOptions)(
    _day_of_week_exec)


def _subsecond_exec(args, options, ctx):
    (col,) = args
    _check_temporal("subsecond", col)
    _, rem = _days_and_rem(col)
    ps = _per_s(col.dtype)
    # a divisor tensor on the column's device: CUDA divides by a Python
    # number through its reciprocal, an ulp away from the CPU's quotient
    div = torch.tensor(float(ps), dtype=torch.float64, device=rem.device)
    return Column((rem % ps).to(torch.float64) / div, dt.float64,
                  validity=col.validity)


register_function("subsecond", "scalar", 1)(_subsecond_exec)


def _week_parts(days, week_starts_monday=True):
    """(pivot year, week number): a week is numbered by its pivot day
    (Thursday for Monday weeks, Wednesday for Sunday weeks), the ISO 8601
    construction (reference: scalar_temporal_unary.cc Week)."""
    dow = (days + 3) % 7 if week_starts_monday else (days + 4) % 7
    pivot = days + (3 - dow)
    py, _, _ = civil_from_days(pivot)
    week = _fdiv(pivot - days_from_civil(py, 1, 1), 7) + 1
    return py, week


def _week_component(name, part, monday):
    def exec_fn(args, options, ctx):
        (col,) = args
        _check_temporal(name, col)
        days, _ = _days_and_rem(col)
        return _int_column(_week_parts(days, monday)[part], col)

    return exec_fn


register_function("iso_week", "scalar", 1)(
    _week_component("iso_week", 1, True))
register_function("iso_year", "scalar", 1)(
    _week_component("iso_year", 0, True))
register_function("us_week", "scalar", 1)(
    _week_component("us_week", 1, False))
register_function("us_year", "scalar", 1)(
    _week_component("us_year", 0, False))


@dataclasses.dataclass
class WeekOptions:
    week_starts_monday: bool = True
    count_from_zero: bool = False
    first_week_is_fully_in_year: bool = False


def _weekday_on_or_after(days, wd: int):
    """The first day >= ``days`` that is weekday ``wd`` (0 = Sunday)."""
    return days + (wd - (days + 4) % 7) % 7


def _week_number(days, options: WeekOptions):
    """pyarrow's week (scalar_temporal_unary.cc Week). Week 1 holds the
    first ``wd`` of January: the first Monday (Sunday) when the first week
    must lie fully in the year, else the first Thursday (Wednesday), the
    ISO rule. Days before week 1 count in the year before's last week,
    or as week 0 with ``count_from_zero``."""
    monday, zero = options.week_starts_monday, options.count_from_zero
    if not zero and not options.first_week_is_fully_in_year:
        return _week_parts(days, monday)[1]
    y, _, _ = civil_from_days(days)
    if options.first_week_is_fully_in_year:
        wd = 1 if monday else 0
        start = _weekday_on_or_after(days_from_civil(y, 1, 1), wd)
        if not zero:
            start = torch.where(days < start, _weekday_on_or_after(
                days_from_civil(y - 1, 1, 1), wd), start)
        return _fdiv(days - start, 7) + 1
    # week 0 starts on the week-start day of the week that holds the
    # year before's last Thursday (Wednesday)
    wd = 4 if monday else 3
    last = _weekday_on_or_after(days_from_civil(y, 1, 1) - 7, wd)
    return _fdiv(days - (last - 3), 7)


def _week_exec(args, options: WeekOptions, ctx):
    """(The JAX package subtracts one for count_from_zero and raises for
    first_week_is_fully_in_year; the port follows pyarrow, ROADMAP
    Queue 3.)"""
    (col,) = args
    _check_temporal("week", col)
    days, _ = _days_and_rem(col)
    return _int_column(_week_number(days, options or WeekOptions()), col)


register_function("week", "scalar", 1, WeekOptions)(_week_exec)


def _iso_calendar_exec(args, options, ctx):
    """A struct {iso_year, iso_week, iso_day_of_week (1 = Monday)}, as a
    RecordBatch."""
    (col,) = args
    _check_temporal("iso_calendar", col)
    days, _ = _days_and_rem(col)
    y, w = _week_parts(days, True)
    return RecordBatch((_int_column(y, col), _int_column(w, col),
                        _int_column((days + 3) % 7 + 1, col)),
                       ("iso_year", "iso_week", "iso_day_of_week"))


register_function("iso_calendar", "scalar", 1)(_iso_calendar_exec)


def _year_month_day_exec(args, options, ctx):
    (col,) = args
    _check_temporal("year_month_day", col)
    days, _ = _days_and_rem(col)
    return RecordBatch(tuple(_int_column(x, col)
                             for x in civil_from_days(days)),
                       ("year", "month", "day"))


register_function("year_month_day", "scalar", 1)(_year_month_day_exec)


# ---- the *_between family: calendar boundaries crossed ----------------

def _unit_count(col: Column, per_s: int):
    """floor(wall time / a unit of ``per_s`` per second), int64."""
    x = _wall(col)
    if col.dtype.kind == "date32":
        return x * (86400 * per_s)
    ps = _per_s(col.dtype)
    return x * (per_s // ps) if per_s >= ps else _fdiv(x, ps // per_s)


def _between(name, fn):
    def exec_fn(args, options, ctx):
        a, b = args
        _check_temporal(name, a, b)
        validity = None
        if a.validity is not None or b.validity is not None:
            validity = a.mask() & b.mask()
        return Column(fn(a, b).to(torch.int64), dt.int64, validity=validity)

    return exec_fn


def _days_of(col):
    return _days_and_rem(col)[0]


def _years_between(a, b):
    return civil_from_days(_days_of(b))[0] - civil_from_days(_days_of(a))[0]


def _quarters_between(a, b):
    def q(col):
        y, m, _ = civil_from_days(_days_of(col))
        return y * 4 + _fdiv(m - 1, 3)

    return q(b) - q(a)


def _weeks_between(a, b, week_start=1):
    """week_start-day boundaries crossed (1 = Monday .. 7 = Sunday)."""
    off = week_start - 1

    def w(days):
        return _fdiv(days - (days + 3 - off) % 7, 7)

    return w(_days_of(b)) - w(_days_of(a))


register_function("years_between", "scalar", 2)(
    _between("years_between", _years_between))
register_function("quarters_between", "scalar", 2)(
    _between("quarters_between", _quarters_between))


def _weeks_between_exec(args, options: DayOfWeekOptions, ctx):
    ws = options.week_start if options is not None else 1
    if not 1 <= ws <= 7:
        raise Invalid(f"week_start must be 1..7, got {ws}")
    return _between("weeks_between",
                    lambda a, b: _weeks_between(a, b, ws))(args, None, ctx)


register_function("weeks_between", "scalar", 2, DayOfWeekOptions)(
    _weeks_between_exec)
register_function("days_between", "scalar", 2)(
    _between("days_between", lambda a, b: _days_of(b) - _days_of(a)))
register_function("hours_between", "scalar", 2)(
    _between("hours_between", lambda a, b: _fdiv(_unit_count(b, 1), 3600)
             - _fdiv(_unit_count(a, 1), 3600)))
register_function("minutes_between", "scalar", 2)(
    _between("minutes_between", lambda a, b: _fdiv(_unit_count(b, 1), 60)
             - _fdiv(_unit_count(a, 1), 60)))
for _name, _ps in [("seconds_between", 1), ("milliseconds_between", 10**3),
                   ("microseconds_between", 10**6),
                   ("nanoseconds_between", 10**9)]:
    register_function(_name, "scalar", 2)(_between(
        _name, lambda a, b, ps=_ps: _unit_count(b, ps) - _unit_count(a, ps)))


# ---- temporal rounding ------------------------------------------------

@dataclasses.dataclass
class RoundTemporalOptions:
    """Reference: api_scalar.h RoundTemporalOptions."""

    multiple: int = 1
    unit: str = "day"
    week_starts_monday: bool = True
    ceil_is_strictly_greater: bool = False
    calendar_based_origin: bool = False


# nanoseconds in one tick of each rounding unit and of each storage
_UNIT_NS = {"nanosecond": 1, "microsecond": 10**3, "millisecond": 10**6,
            "second": 10**9, "minute": 60 * 10**9, "hour": 3600 * 10**9,
            "day": 86400 * 10**9, "week": 604800 * 10**9}


# the next larger unit of each, the origin of calendar_based_origin
_PARENT_NS = {"nanosecond": 10**3, "microsecond": 10**6,
              "millisecond": 10**9, "second": 60 * 10**9,
              "minute": 3600 * 10**9, "hour": 86400 * 10**9}


def _storage_ns(t: dt.DataType) -> int:
    return 86400 * 10**9 if t.kind == "date32" else 10**9 // _per_s(t)


def _round_calendar(mode, x, days, t, options, ps):
    """Month, quarter and year units: the first day of the period that
    holds ``days`` (floor), of the next one (ceil: on a boundary too), or
    the nearer one (a tie: the later). Periods of ``multiple`` months
    count from 1970-01 (from each January with calendar_based_origin),
    of years from year 0, as pyarrow's."""
    y, m, _ = civil_from_days(days)
    if options.unit == "year":
        fy = _fdiv(y, options.multiple) * options.multiple
        lo_days = days_from_civil(fy, 1, 1)
        hi_days = days_from_civil(fy + options.multiple, 1, 1)
    else:
        step = (3 if options.unit == "quarter" else 1) * options.multiple
        if options.calendar_based_origin:
            months = y * 12 + _fdiv(m - 1, step) * step
        else:
            months = 1970 * 12 + _fdiv((y - 1970) * 12 + m - 1, step) * step
        lo_days = days_from_civil(_fdiv(months, 12), months % 12 + 1, 1)
        hi = months + step
        hi_days = days_from_civil(_fdiv(hi, 12), hi % 12 + 1, 1)
    per_day = 1 if t.kind == "date32" else 86400 * ps
    lo, hi = lo_days * per_day, hi_days * per_day
    if mode == "floor":
        return lo
    if mode == "ceil":
        return hi
    return torch.where((x - lo) < (hi - x), lo, hi)


def _tick_step(t: dt.DataType, options) -> int:
    """``multiple`` units in the storage's ticks, truncated toward zero
    as std::chrono's duration_cast (a date32 and 5 hours: 0 days)."""
    unit_ns, tick_ns = _UNIT_NS[options.unit], _storage_ns(t)
    if unit_ns >= tick_ns:
        return unit_ns // tick_ns * options.multiple
    return options.multiple // (tick_ns // unit_ns)


def _round_ticks(mode, x, t, options):
    """A unit of a fixed length, pyarrow's way: ``x`` in whole units
    (floored), floored to a multiple of ``multiple`` units counted from
    the epoch (weeks from a Monday or Sunday), and back to the storage's
    ticks truncated toward zero; the step is ``_tick_step``. ceil adds
    the step unless at the floor (always with ceil_is_strictly_greater);
    round takes the nearer, a tie the later."""
    unit_ns, tick_ns = _UNIT_NS[options.unit], _storage_ns(t)
    shift = 0
    if options.unit == "week":   # 1970-01-01 was a Thursday
        shift = (3 if options.week_starts_monday else 4) * 86400 * 10**9 \
            // tick_ns
    x = x + shift
    step = _tick_step(t, options)
    origin = options.calendar_based_origin and options.unit != "week"
    if options.unit == "day" and origin:   # days counted in the month
        days = x if t.kind == "date32" else _fdiv(x, unit_ns // tick_ns)
        y, m, d = civil_from_days(days)
        lo = (days_from_civil(y, m, 1) + _fdiv(d - 1, options.multiple) *
              options.multiple) * (unit_ns // tick_ns)
    elif unit_ns >= tick_ns:
        # with calendar_based_origin, counted from the start of the next
        # larger unit (the day for hours, the hour for minutes, ...)
        base = _fdiv(x, _PARENT_NS[options.unit] // tick_ns) * (
            _PARENT_NS[options.unit] // tick_ns) if origin else 0
        lo = base + _fdiv(x - base, step) * step
    else:
        ratio = tick_ns // unit_ns
        units = x * ratio
        if origin:
            span = _PARENT_NS[options.unit] // unit_ns
            base = _fdiv(units, span) * span
            units = base + _fdiv(units - base, options.multiple) * \
                options.multiple
        else:
            units = _fdiv(units, options.multiple) * options.multiple
        lo = torch.div(units, ratio, rounding_mode="trunc")
    if mode == "floor":
        out = lo
    elif mode == "ceil":
        bump = (lo < x) | options.ceil_is_strictly_greater
        out = torch.where(bump, lo + step, lo)
    else:
        hi = lo + step
        out = torch.where((x - lo) < (hi - x), lo, hi)
    return out - shift


def _round_temporal(mode):
    def exec_fn(args, options: RoundTemporalOptions, ctx):
        (col,) = args
        options = options or RoundTemporalOptions()
        t = col.dtype
        _check_temporal("temporal rounding", col)
        ps = _per_s(t)
        calendar = options.unit in ("month", "quarter", "year")
        if not calendar and options.unit not in _UNIT_NS:
            raise Invalid(f"temporal rounding: bad unit {options.unit!r}")
        x = _wall(col)
        zoned = t.kind == "timestamp" and bool(t.tz)

        def bound(kind):   # a zoned timestamp's bound goes back to UTC
            if calendar:
                days = x if t.kind == "date32" else _fdiv(x, 86400 * ps)
                out = _round_calendar(kind, x, days, t, options, ps)
            else:
                out = _round_ticks(kind, x, t, options)
            return _wall_to_utc(out, t, "earliest", "transition") \
                if zoned else out

        if zoned and mode == "round":
            # the nearer of the two bounds in UTC, as pyarrow's: to the
            # instant for a fixed-length unit, to the wall time (read as
            # if UTC) for a calendar unit
            lo, hi = bound("floor"), bound("ceil")
            at = x if calendar else col.data.to(torch.int64)
            out = torch.where((at - lo) < (hi - at), lo, hi)
        else:
            out = bound(mode)
        return Column(out.to(col.data.dtype), t, validity=col.validity)

    return exec_fn


register_function("floor_temporal", "scalar", 1, RoundTemporalOptions)(
    _round_temporal("floor"))
register_function("ceil_temporal", "scalar", 1, RoundTemporalOptions)(
    _round_temporal("ceil"))
register_function("round_temporal", "scalar", 1, RoundTemporalOptions)(
    _round_temporal("round"))


# ---- time zones -------------------------------------------------------

@dataclasses.dataclass
class AssumeTimezoneOptions:
    timezone: str = "UTC"
    ambiguous: str = "raise"
    nonexistent: str = "raise"


def _wall_to_utc(wall: torch.Tensor, t: dt.DataType, ambiguous: str,
                 nonexistent: str, validity=None, zone=None):
    """Wall-clock ticks of zone ``zone`` (default ``t.tz``) -> UTC ticks.

    Period p of the zone holds the wall clocks [ws[p], we[p]). A wall
    time in two periods (a fall-back overlap) is ``ambiguous``: the
    earlier period's instant ("earliest") or the later one's ("latest").
    One in none (a spring-forward gap) is ``nonexistent``: the last tick
    before the transition ("earliest"), the transition ("latest" and
    "transition"). "raise" raises if a valid row needs it (one host
    read)."""
    from ..utils.tzif import load_tz

    zone = zone or t.tz
    tz = load_tz(zone)
    ps = _UNIT_PER_S[t.unit]
    if len(tz.trans) == 0:
        return wall - int(tz.utoff[0]) * ps
    tables = tz.on_device(wall.device)
    ws, we, utoff, trans = (tables[k] for k in ("ws", "we", "utoff",
                                                 "trans"))
    local_sec = _fdiv(wall, ps)
    # p_hi: the latest period whose wall-clock window has started
    p_hi = (torch.searchsorted(ws, local_sec, right=True) - 1).clamp(
        0, len(tz.utoff) - 1)
    p_lo = (p_hi - 1).clamp(min=0)
    in_hi = local_sec < we[p_hi]
    in_lo = (local_sec >= ws[p_lo]) & (local_sec < we[p_lo]) & \
        (p_lo != p_hi)
    ambig = in_hi & in_lo
    gap = ~in_hi & ~in_lo
    if validity is not None:
        ambig, gap = ambig & validity, gap & validity
    if ambiguous == "raise" and bool(ambig.any()):
        raise Invalid(f"assume_timezone: ambiguous local time in {zone}")
    if nonexistent == "raise" and bool(gap.any()):
        raise Invalid(f"assume_timezone: nonexistent local time in {zone}")
    use_lo = in_lo & (~in_hi | (ambiguous == "earliest"))
    period = torch.where(use_lo, p_lo, p_hi)
    utc = wall - utoff[period] * ps
    # both wall edges of a gap after period p_hi map to trans[p_hi]
    tr = trans[p_hi.clamp(max=len(tz.trans) - 1)] * ps
    pin = tr - 1 if nonexistent == "earliest" else tr
    return torch.where(~in_hi & ~in_lo, pin, utc)


@register_function("local_timestamp", "scalar", 1)
def local_timestamp_exec(args, options, ctx):
    """UTC instants -> naive local wall time (scalar_temporal_unary.cc
    LocalTimestamp); a naive timestamp is already wall time."""
    (col,) = args
    if col.dtype.kind == "timestamp" and not col.dtype.tz:
        return col
    off, _, ps = _utc_offsets(col)
    return Column(col.data.to(torch.int64) + off * ps,
                  dt.timestamp(col.dtype.unit), validity=col.validity)


@register_function("is_dst", "scalar", 1)
def is_dst_exec(args, options, ctx):
    """(scalar_temporal_unary.cc IsDaylightSavings)"""
    (col,) = args
    _, dst, _ = _utc_offsets(col)
    return Column(dst, dt.bool_, validity=col.validity)


@register_function("assume_timezone", "scalar", 1, AssumeTimezoneOptions)
def assume_timezone_exec(args, options, ctx):
    """Naive wall time -> UTC instants of ``timezone``
    (scalar_temporal_unary.cc AssumeTimezone), with its ambiguous and
    nonexistent options (``_wall_to_utc``)."""
    (col,) = args
    t = col.dtype
    if t.kind != "timestamp":
        raise Invalid("assume_timezone requires a timestamp column")
    if t.tz:
        raise Invalid(f"assume_timezone: input already has tz {t.tz!r}")
    o = options or AssumeTimezoneOptions()
    utc = _wall_to_utc(col.data.to(torch.int64), t, o.ambiguous,
                       o.nonexistent, validity=col.validity,
                       zone=o.timezone)
    return Column(utc, dt.timestamp(t.unit, o.timezone),
                  validity=col.validity)


# ---- the *_interval_between family ------------------------------------

def _calendar_between(a: Column, b: Column):
    """(months, days after the month shift, nanoseconds): months is the
    (year, month) difference; days = end - (start + months), a start day
    past the target month's length running into the next month
    (2020-02-29 + 12 months = 2021-03-01); nanoseconds the difference of
    the times of day."""
    da, ra = _days_and_rem(a)
    db, rb = _days_and_rem(b)
    ya, ma, dda = civil_from_days(da)
    yb, mb, _ = civil_from_days(db)
    months = (yb - ya) * 12 + (mb - ma)
    tot = ya * 12 + (ma - 1) + months
    y2 = _fdiv(tot, 12)
    days = db - days_from_civil(y2, tot - y2 * 12 + 1, dda)

    def nanos(col, rem):
        if col.dtype.kind == "date32":
            return torch.zeros_like(rem)
        return rem * (10**9 // _per_s(col.dtype))

    return months, days, nanos(b, rb) - nanos(a, ra)


def _interval_between(name, kind):
    def exec_fn(args, options, ctx):
        a, b = args
        _check_temporal(name, a, b)
        months, days, nano = _calendar_between(a, b)
        validity = None
        if a.validity is not None or b.validity is not None:
            validity = a.mask() & b.mask()
        if kind == "month":
            return Column(months.to(torch.int32), dt.month_interval(),
                          validity=validity)
        if kind == "day_time":
            # the plain day difference and the milliseconds, packed
            # (days i32 << 32 | ms u32) into one int64
            ms = _fdiv(nano, 1_000_000)
            packed = ((_days_of(b) - _days_of(a)) << 32) | \
                (ms & 0xFFFFFFFF)
            return Column(packed, dt.day_time_interval(), validity=validity)
        packed = (months << 32) | (days & 0xFFFFFFFF)
        return Column(packed, dt.month_day_nano_interval(),
                      validity=validity, data2=nano)

    return exec_fn


register_function("month_interval_between", "scalar", 2)(
    _interval_between("month_interval_between", "month"))
register_function("day_time_interval_between", "scalar", 2)(
    _interval_between("day_time_interval_between", "day_time"))
register_function("month_day_nano_interval_between", "scalar", 2)(
    _interval_between("month_day_nano_interval_between", "mdn"))
