"""One call of each of the 43 names of the temporal slice (the 42 of
ops/temporal.py and ``tdigest``), for the on-card checks
(``chip_smoke.py``, tests/test_torch_cuda.py):

    cols = temporal_columns(10_000_000, "cuda")
    for label in CALLS:
        out = call(label, cols)

The columns come from a seed: ``d`` and ``d2`` are date32 ship dates over
TPC-H's range (the days 8000-10999 of ``profile_main_path.tpch_tables``,
about 3000 distinct), ``ts`` and ``ts2`` timestamp[us] over 1969-2030
(both New York DST edges of every year), ``tsz`` the instants of ``ts``
in America/New_York, ``wall`` naive wall times over the same years (some
in a DST gap or overlap), ``tsp`` timestamp[us] drawn from a pool of
``distinct`` instants and ``strs`` their text (strftime's and strptime's
host work is per distinct value: an SF1-sized pool of 150,000 by
default), ``f`` float64 for tdigest; 1% of each is null.

A call is (function, argument keys, options, kind): ``map`` calls give
one row per input row, so a call's first rows equal the call over the
first rows; the ``aggregate`` call (tdigest) is compared on a window.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from . import compute_strings, compute_tail
from . import dtypes as dt
from .column import Column, Dictionary
from .compute_strings import on_device
from .registry import call_function
from .table import RecordBatch

__all__ = ["ZONE", "CALLS", "call", "temporal_columns", "on_device",
           "same_result"]

ZONE = "America/New_York"
SHIP_DAYS = (8000, 11000)   # profile_main_path.tpch_tables' l_shipdate_days
_US = 10**6
_YEARS_US = (-31536000 * _US, 1893456000 * _US)   # 1969-01-01, 2030-01-01
_EARLIEST = {"timezone": ZONE, "ambiguous": "earliest",
             "nonexistent": "earliest"}

# label -> (function, argument keys, options, kind)
CALLS = {
    **{name: (name, ("ts",), {}, "map") for name in (
        "year", "month", "day", "day_of_week", "day_of_year", "hour",
        "minute", "second", "millisecond", "microsecond", "nanosecond",
        "quarter", "is_leap_year", "subsecond", "iso_week", "iso_year",
        "us_week", "us_year", "week", "iso_calendar", "year_month_day")},
    "year/date32": ("year", ("d",), {}, "map"),
    "day_of_week/tz": ("day_of_week", ("tsz",), {"week_start": 7}, "map"),
    **{name: (name, ("ts", "ts2"), {}, "map") for name in (
        "years_between", "quarters_between", "weeks_between",
        "hours_between", "minutes_between", "seconds_between",
        "milliseconds_between", "microseconds_between",
        "nanoseconds_between", "month_interval_between",
        "day_time_interval_between", "month_day_nano_interval_between")},
    "days_between": ("days_between", ("d", "d2"), {}, "map"),
    "floor_temporal": ("floor_temporal", ("ts",), {"unit": "minute",
                                                   "multiple": 15}, "map"),
    "ceil_temporal": ("ceil_temporal", ("ts",), {"unit": "month"}, "map"),
    "round_temporal": ("round_temporal", ("d",), {"unit": "week"}, "map"),
    "floor_temporal/tz": ("floor_temporal", ("tsz",), {"unit": "day"},
                          "map"),
    "local_timestamp": ("local_timestamp", ("tsz",), {}, "map"),
    "is_dst": ("is_dst", ("tsz",), {}, "map"),
    "assume_timezone": ("assume_timezone", ("wall",), _EARLIEST, "map"),
    "strftime": ("strftime", ("d",), {"format": "%Y-%m-%d"}, "map"),
    "strftime/timestamps": ("strftime", ("tsp",), {}, "map"),
    "strptime": ("strptime", ("strs",), {}, "map"),
    "tdigest": ("tdigest", ("f",), {"q": [0.01, 0.5, 0.99]}, "aggregate"),
}


def call(label: str, cols: Dict[str, Column]):
    """CALLS[label] over ``cols``."""
    name, args, options, _ = CALLS[label]
    return call_function(name, [cols[a] for a in args], **options)


def _column(data: np.ndarray, valid: np.ndarray, t: dt.DataType, device
            ) -> Column:
    return Column(torch.from_numpy(data.astype(t.numpy_dtype())).to(device),
                  t, validity=torch.from_numpy(valid).to(device))


def temporal_columns(n: int, device, seed: int = 0, distinct: int = 150_000
                     ) -> Dict[str, Column]:
    """``n`` rows of each of the module docstring's columns on
    ``device``."""
    rng = np.random.default_rng(seed)

    def valid():
        return rng.random(n) >= 0.01

    ts = rng.integers(*_YEARS_US, n)
    pool = np.unique(rng.integers(*_YEARS_US, distinct) // _US * _US)
    picks = rng.integers(0, len(pool), n)
    text = np.datetime_as_string(pool.astype("datetime64[us]"),
                                 unit="s").astype(object)
    strs_ok = valid()
    cols = {
        "d": _column(rng.integers(*SHIP_DAYS, n), valid(), dt.date32,
                     device),
        "d2": _column(rng.integers(*SHIP_DAYS, n), valid(), dt.date32,
                      device),
        "ts": _column(ts, valid(), dt.timestamp("us"), device),
        "ts2": _column(rng.integers(*_YEARS_US, n), valid(),
                       dt.timestamp("us"), device),
        "tsz": _column(ts, valid(), dt.timestamp("us", ZONE), device),
        "wall": _column(rng.integers(*_YEARS_US, n), valid(),
                        dt.timestamp("us"), device),
        "tsp": _column(pool[picks], valid(), dt.timestamp("us"), device),
        "f": _column(rng.standard_normal(n), valid(), dt.float64, device),
    }
    cols["strs"] = Column(torch.from_numpy(picks.astype(np.int32)).to(device),
                          dt.string,
                          validity=torch.from_numpy(strs_ok).to(device),
                          dictionary=Dictionary(text))
    return cols


def same_result(got, want, rows: Optional[int] = None) -> Optional[str]:
    """None when ``got``'s first ``rows`` rows (all by default) equal
    ``want``'s exactly (a string column by its decoded values, floats bit
    for bit, an interval's nanoseconds too); else the first difference."""
    cols = list(want.columns) if isinstance(want, RecordBatch) else [want]
    if any(c.dictionary is not None for c in cols):
        return compute_strings.same_result(got, want, rows)
    problem = compute_tail.same_result(got, want, 0, rows)
    if problem is None and cols[0].data2 is not None:   # the nanoseconds
        return compute_tail.same_result(
            Column(got.data2, dt.int64, validity=got.validity),
            Column(want.data2, dt.int64, validity=want.validity), 0, rows)
    return problem
