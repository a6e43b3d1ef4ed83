"""The temporal slice of the port (arrow1_tpu_torch/ops/temporal.py: 42
names; ``tdigest``; the temporal casts, compares, arithmetic, sort keys,
set lookup and ``pairwise_diff``) held against the JAX package on small
columns from a numpy seed, with the reference tests' edge dates
(1969-07-20, 2020-02-29, 2021-02-28) and the DST gap and overlap of
America/New_York.

Parity: integers, bools, strings and null masks exactly; ``subsecond``'s
float64 bit for bit (a tick count over a power of ten, one rounding on
both). Where the JAX package is wrong against pyarrow.compute (ROADMAP
Queue 3) the port is held against pyarrow (``PYARROW_DECIDES``): a
timestamp with a time zone has its components, strftime, ``*_between``
and rounding in local time, and a few other cases named there.

The JAX answers are computed once, by the registry sweep's
``jax_answers``, in a worker process (tests/test_torch_answers.py).
"""

import warnings

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import arrow1_tpu as a1t

import arrow1_tpu_torch as pt
import arrow1_tpu_torch.compute  # noqa: F401  (the options classes)
from arrow1_tpu_torch import dtypes as dt
from arrow1_tpu_torch.errors import A1TError
from arrow1_tpu_torch.interop import column_from_arrow
from test_torch_answers import answers_of
from test_torch_registry_sweep import arrow_answers, assert_same, jax_answers

ZONE = "America/New_York"
_rng = np.random.default_rng(13)
_US = 10**6
# edge instants (us since 1970): 1969-07-20 20:17:40.123456, 2020-02-29
# 23:59:59.999999, 2021-02-28, the epoch, one tick before it, the wall
# times of New York's 2021 gap (03-14 02:30) and overlap (11-07 01:30),
# and UTC instants on both sides of each of its 2021 transitions
_TS_EDGES = [-14182939876544, 1583020799999999, 1614470400000000, 0, -1,
             1615689000000000, 1636248600000000, 1615705199000000,
             1615705200000000, 1636263000000000, 1636266600000000]
_N = len(_TS_EDGES) + 5   # 16 rows, one null each
_D32_EDGES = [-165, 18321, 18686, 0, -1, 10471, 11016, 4017, 6269, -366,
              21914]


def _with_null(values, at, type_):
    vals = [int(v) for v in values]
    return pa.array([None if i == at else v for i, v in enumerate(vals)],
                    type_)


def _ts(edges, lo, hi, at, unit="us", tz=None, scale=1):
    vals = list(edges) + _rng.integers(lo, hi, _N - len(edges)).tolist()
    return _with_null([v * scale for v in vals], at,
                      pa.timestamp(unit, tz))


_LO, _HI = -31536000 * _US, 1893456000 * _US   # 1969-01-01, 2030-01-01
INPUTS = {
    "d32": _with_null(_D32_EDGES + _rng.integers(-30000, 30000, _N - 11)
                      .tolist(), 4, pa.date32()),
    "d32b": _with_null(_rng.integers(-30000, 30000, _N), 9, pa.date32()),
    "d64": _with_null([v * 86400000 for v in _D32_EDGES] + [
        int(v) for v in _rng.integers(-10**12, 10**12, _N - 11)], 3,
        pa.date64()),
    "ts": _ts(_TS_EDGES, _LO, _HI, 12),
    "tsb": _ts([], _LO, _HI, 2),
    "ts_ms": _ts([v // 1000 for v in _TS_EDGES], _LO // 1000, _HI // 1000,
                 5, unit="ms"),
    "ts_ns": _ts([v * 1000 + 789 for v in _TS_EDGES], _LO * 1000,
                 _HI * 1000, 7, unit="ns"),
    "ts_s": _ts([v // _US for v in _TS_EDGES], _LO // _US, _HI // _US, 1,
                unit="s"),
    "tsz": _ts(_TS_EDGES, _LO, _HI, 12, tz=ZONE),
    "tszb": _ts([], _LO, _HI, 3, tz=ZONE),
    "t32": _with_null(_rng.integers(0, 86400, _N), 6, pa.time32("s")),
    "t64": _with_null(_rng.integers(0, 86400 * _US, _N), 8,
                      pa.time64("us")),
    "dur": _with_null(_rng.integers(-10**6, 10**6, _N), 10,
                      pa.duration("s")),
    "dur_ms": _with_null(_rng.integers(-10**9, 10**9, _N), 11,
                         pa.duration("ms")),
    "ints": _with_null(_rng.integers(-5, 6, _N), 0, pa.int64()),
    "f64": pa.array([float(v) for v in _rng.standard_normal(_N - 2)]
                    + [None, float("nan")]),
    "strs": pa.array(["2020-02-29T12:00:00", "1969-07-20T20:17:40", None,
                      "2021-11-07T01:30:00"] * 4),
    "bad_strs": pa.array(["2020-02-29T12:00:00", "not a time", None,
                          "1969-07-20T20:17:40"] * 4),
    "iso": pa.array(["2020-02-29", "1969-07-20", None, "2021-02-28"] * 4),
    "iso_ts": pa.array(["2020-02-29 12:00:00.5", "1969-07-20T20:17:40",
                        None, "2021-02-28"] * 4),
    # naive wall times for assume_timezone: none in a gap or an overlap,
    # then New York's 2021 gap and overlap
    "wall": _ts([0, -14182939876544, 1583020799999999], _LO, _HI, 4),
    "wall_gap": _ts([1615689000000000, 1615687200000000], 1615680000000000,
                    1615690000000000, 5),
    "wall_fold": _ts([1636248600000000, 1636246800000000],
                     1636240000000000, 1636249000000000, 6),
}
# the wall-time ranges above avoid a gap or fold only by chance of the
# seed: the plain wall column must hold neither
_COMPONENTS = ["year", "month", "day", "day_of_week", "day_of_year", "hour",
               "minute", "second", "millisecond", "microsecond",
               "nanosecond", "quarter", "is_leap_year", "subsecond",
               "iso_week", "iso_year", "us_week", "us_year", "week",
               "iso_calendar", "year_month_day"]
_BETWEEN = ["years_between", "quarters_between", "weeks_between",
            "days_between", "hours_between", "minutes_between",
            "seconds_between", "milliseconds_between",
            "microseconds_between", "nanoseconds_between"]
_INTERVALS = ["month_interval_between", "day_time_interval_between",
              "month_day_nano_interval_between"]
# the 43 names of the slice
NAMES = (_COMPONENTS + _BETWEEN + _INTERVALS +
         ["floor_temporal", "ceil_temporal", "round_temporal",
          "local_timestamp", "is_dst", "assume_timezone", "strftime",
          "strptime", "tdigest"])


def S(value, kind):
    """A scalar argument of the named type (a dtypes attribute or a
    callable's name with its arguments)."""
    return ("scalar", value, kind)


def _cases():
    cases = {}
    for name in _COMPONENTS:
        for col in ("d32", "ts", "ts_ns", "d64", "tsz"):
            cases[f"{name}-{col}"] = (name, [col], {})
    cases["day_of_week-options"] = ("day_of_week", ["ts"], {
        "count_from_zero": False, "week_start": 7})
    for monday in (True, False):
        for zero in (True, False):
            for full in (True, False):
                cases[f"week-{monday:d}{zero:d}{full:d}"] = ("week", ["wk"], {
                    "week_starts_monday": monday, "count_from_zero": zero,
                    "first_week_is_fully_in_year": full})
    cases["hour-t64"] = ("hour", ["t64"], {})
    cases["second-t32"] = ("second", ["t32"], {})
    for name in _BETWEEN:
        for a, b in (("d32", "d32b"), ("ts", "tsb"), ("ts_ms", "ts"),
                     ("tsz", "tszb")):
            cases[f"{name}-{a}-{b}"] = (name, [a, b], {})
    cases["weeks_between-sunday"] = ("weeks_between", ["d32", "d32b"],
                                     {"week_start": 7})
    for name in _INTERVALS:
        for a, b in (("d32", "d32b"), ("ts", "tsb"), ("ts_ns", "ts_s")):
            cases[f"{name}-{a}-{b}"] = (name, [a, b], {})
    cases["month_day_nano_interval_between-tsz-tszb"] = (
        "month_day_nano_interval_between", ["tsz", "tszb"], {})
    for mode in ("floor", "ceil", "round"):
        name = f"{mode}_temporal"
        for unit, mult in (("day", 1), ("hour", 1), ("minute", 15),
                           ("week", 1), ("month", 1), ("quarter", 1),
                           ("year", 1), ("millisecond", 250),
                           ("second", 7)):
            cases[f"{name}-ts-{unit}-{mult}"] = (name, ["ts"], {
                "unit": unit, "multiple": mult})
        for unit in ("day", "week", "month"):
            cases[f"{name}-d32-{unit}"] = (name, ["d32"], {"unit": unit})
        cases[f"{name}-tsz-day"] = (name, ["tsz"], {"unit": "day"})
        cases[f"{name}-ts_ns-microsecond"] = (name, ["ts_ns"], {
            "unit": "microsecond", "multiple": 3})
    for mode in ("floor", "ceil", "round"):
        for unit, mult in (("month", 1), ("day", 1), ("hour", 1),
                           ("minute", 15), ("year", 1), ("quarter", 1)):
            cases[f"{mode}_temporal-bounds-{unit}"] = (
                f"{mode}_temporal", ["bounds"], {"unit": unit,
                                                "multiple": mult})
        # multiples of calendar units count from 1970-01 (months) or
        # year 0; a date32 steps by whole days of the truncated step; a
        # unit finer than the storage truncates back to it
        for col, unit, mult in (("ts", "month", 5), ("ts", "quarter", 2),
                                ("ts", "year", 3), ("d32", "hour", 5),
                                ("d32", "second", 7), ("d32", "hour", 48),
                                ("ts_s", "millisecond", 1500),
                                ("tsz", "month", 5), ("tsz", "hour", 5)):
            cases[f"{mode}_temporal-{col}-{unit}-{mult}"] = (
                f"{mode}_temporal", [col], {"unit": unit, "multiple": mult})
        for unit, mult in (("month", 5), ("day", 4), ("hour", 5)):
            cases[f"{mode}_temporal-ts-{unit}-{mult}-calendar-origin"] = (
                f"{mode}_temporal", ["ts"], {"unit": unit, "multiple": mult,
                                             "calendar_based_origin": True})
    cases["ceil_temporal-strict"] = ("ceil_temporal", ["ts_s"], {
        "unit": "second", "ceil_is_strictly_greater": True})
    cases["floor_temporal-sunday-week"] = ("floor_temporal", ["ts"], {
        "unit": "week", "week_starts_monday": False})
    cases["local_timestamp-tsz"] = ("local_timestamp", ["tsz"], {})
    cases["local_timestamp-naive"] = ("local_timestamp", ["ts"], {})
    cases["is_dst-tsz"] = ("is_dst", ["tsz"], {})
    cases["is_dst-naive"] = ("is_dst", ["ts"], {})
    cases["assume_timezone-wall"] = ("assume_timezone", ["wall"],
                                     {"timezone": ZONE})
    cases["assume_timezone-utc"] = ("assume_timezone", ["wall"],
                                    {"timezone": "UTC"})
    for col in ("wall_gap", "wall_fold"):
        for how in ("earliest", "latest", "raise"):
            cases[f"assume_timezone-{col}-{how}"] = (
                "assume_timezone", [col], {"timezone": ZONE,
                                           "ambiguous": how,
                                           "nonexistent": how})
    for col in ("d32", "ts", "ts_ns", "ts_s", "tsz", "d64"):
        cases[f"strftime-{col}"] = ("strftime", [col], {})
    cases["strftime-format"] = ("strftime", ["ts"], {
        "format": "%d/%m/%Y %H:%M:%S %j"})
    cases["strptime-default"] = ("strptime", ["strs"], {})
    cases["strptime-s"] = ("strptime", ["strs"], {"unit": "s"})
    cases["strptime-bad-null"] = ("strptime", ["bad_strs"],
                                  {"error_is_null": True})
    cases["strptime-bad-raises"] = ("strptime", ["bad_strs"], {})
    cases["strptime-format"] = ("strptime", ["iso"], {"format": "%Y-%m-%d",
                                                      "unit": "ms"})
    cases["tdigest-f64"] = ("tdigest", ["f64"], {"q": [0.1, 0.5, 0.9]})
    cases["tdigest-ints"] = ("tdigest", ["ints"], {})
    cases["tdigest-all-null"] = ("tdigest", ["no_f64"], {"q": [0.1, 0.9]})
    # casts
    for src, target in (("d32", ("timestamp", "ms")),
                        ("ts", ("timestamp", "s")),
                        ("ts_s", ("timestamp", "ns")), ("d32", ("date64",)),
                        ("d64", ("date32",)), ("ts", ("date32",)),
                        ("d32", ("string",)), ("ts", ("string",)),
                        ("ts_ns", ("string",)), ("tsz", ("string",)),
                        ("t64", ("string",)), ("t32", ("time64", "us")),
                        ("dur", ("string",)), ("dur", ("duration", "ms")),
                        ("iso", ("date32",)), ("iso_ts", ("timestamp", "ms")),
                        ("ints", ("date32",)), ("d32", ("int32",)),
                        ("ts", ("int64",)), ("ts", ("float64",)),
                        ("ts", ("timestamp", "us", ZONE)),
                        ("ts", ("time64", "us")), ("tsz", ("date32",)),
                        ("tsz", ("time64", "us")), ("ts_ms", ("date64",))):
            label = "-".join(str(x) for x in target)
            cases[f"cast-{src}-{label}"] = ("cast", [src], {"target": target})
    cases["cast-ts-s-unsafe"] = ("cast", ["ts"], {
        "target": ("timestamp", "s"), "safe": False})
    # compares
    for name in ("equal", "less", "greater_equal"):
        cases[f"{name}-d32-scalar"] = (name, ["d32", S(10471, "date32")], {})
        cases[f"{name}-d32-ts"] = (name, ["d32", "ts"], {})
        cases[f"{name}-ts-ts_ms"] = (name, ["ts", "ts_ms"], {})
    cases["less_equal-tsz-tszb"] = ("less_equal", ["tsz", "tszb"], {})
    # arithmetic
    for name, a, b in (("add", "ts", "dur"), ("add", "dur", "ts_ms"),
                       ("add", "dur", "dur_ms"), ("add", "t32", "dur"),
                       ("subtract", "ts", "tsb"), ("subtract", "d32", "d32b"),
                       ("subtract", "ts", "dur"), ("subtract", "t64", "t64"),
                       ("subtract", "dur", "dur_ms"),
                       ("subtract_checked", "d32", "d32b"),
                       ("add_checked", "ts", "dur"),
                       ("multiply", "dur", "ints"),
                       ("multiply", "ints", "dur_ms"),
                       ("divide", "dur", "dur_ms"), ("add", "tsz", "dur"),
                       ("subtract", "d64", "ts")):
        cases[f"{name}-{a}-{b}"] = (name, [a, b], {})
    cases["divide-dur-int"] = ("divide", ["dur", S(7, "int64")], {})
    cases["divide-dur-zero"] = ("divide", ["dur", S(0, "int64")], {})
    # sort keys, set lookup, pairwise_diff and the selection functions
    for col in ("d32", "ts", "tsz", "t32", "dur"):
        cases[f"array_sort_indices-{col}"] = ("array_sort_indices", [col],
                                              {})
        cases[f"array_sort_indices-desc-{col}"] = (
            "array_sort_indices", [col], {"order": "descending"})
        cases[f"pairwise_diff-{col}"] = ("pairwise_diff", [col], {})
        cases[f"unique-{col}"] = ("unique", [col], {})
    cases["pairwise_diff-period-d64"] = ("pairwise_diff", ["d64"],
                                         {"period": 2})
    cases["pairwise_diff_checked-ts"] = ("pairwise_diff_checked", ["ts"],
                                         {"period": -3})
    cases["is_in-d32"] = ("is_in", ["d32"], {"value_set": "d32:set"})
    cases["index_in-ts"] = ("index_in", ["ts"], {"value_set": "ts:set"})
    cases["is_in_meta_binary-d32"] = ("is_in_meta_binary", ["d32", "d32"],
                                      {})
    cases["min_max-d32"] = ("min_max", ["d32"], {})
    cases["max-ts"] = ("max", ["ts"], {})
    cases["count_distinct-tsz"] = ("count_distinct", ["tsz"], {})
    cases["fill_null-d32-scalar"] = ("fill_null", ["d32", S(10471, "date32")],
                                     {})
    cases["coalesce-ts"] = ("coalesce", ["ts", "tsb"], {})
    cases["if_else-ts"] = ("if_else", ["mask", "ts", "tsb"], {})
    cases["is_null-t64"] = ("is_null", ["t64"], {})
    cases["take-ts"] = ("take", ["ts", "idx"], {})
    cases["filter-tsz"] = ("filter", ["tsz", "mask"], {})
    return cases


# the days around each new year of 2015-2026 (every weekday a year starts
# on), for the week numbering
INPUTS["wk"] = pa.array(sorted(
    int(d) + k for d in [16436, 16801, 17167, 17532, 17897, 18262, 18628,
                         18993, 19358, 19723, 20089, 20454] for k in
    range(-8, 9, 3)), pa.date32())
# instants on month, day, hour and 15-minute boundaries and at half steps
INPUTS["bounds"] = pa.array([1583020800000000, 1583020800000000 + 1800 * _US,
                             1614470400000000 + 450 * _US, 0,
                             1615705200000000, 43200 * _US, None,
                             -86400 * _US, 1577836800000000,
                             1577836800000000 + 86400 * 15 * _US,
                             -43200 * _US, 1, -1, 1800 * _US, 2700 * _US,
                             1609459200000000], pa.timestamp("us"))
INPUTS["no_f64"] = pa.array([None] * _N, pa.float64())
INPUTS["idx"] = pa.array(_rng.integers(0, _N, _N).tolist(), pa.int64())
INPUTS["mask"] = pa.array((_rng.random(_N) < 0.5).tolist())
CASES = _cases()
_GROUP_BATCH = pa.record_batch({"d": INPUTS["d32"].take(INPUTS["idx"]),
                                "v": INPUTS["ints"]})

# where pyarrow decides (ROADMAP Queue 3): the JAX package reads a zoned
# timestamp's UTC instant where pyarrow reads its local time
_LOCAL = set(_COMPONENTS) | set(_BETWEEN) | set(_INTERVALS) | {
    "floor_temporal", "ceil_temporal", "round_temporal", "strftime"}
PYARROW_DECIDES = {case: "the JAX package reads the UTC instant"
                   for case, (name, args, _) in CASES.items()
                   if name in _LOCAL and "tsz" in args}
PYARROW_DECIDES["add-tsz-dur"] = "the JAX package drops the time zone"
PYARROW_DECIDES["microsecond-ts_ns"] = "rem * 10**6 overflows int64"
PYARROW_DECIDES["cast-ts-s-unsafe"] = "floors where pyarrow truncates"
for _case in ("cast-ts-date32", "cast-ts-time64-us", "cast-tsz-date32",
              "cast-tsz-time64-us", "cast-ts_ms-date64"):
    # the JAX package rescales the instant: a time or date64 keeps all of
    # it (out of a time's range), a date32 is refused, zones are ignored
    PYARROW_DECIDES[_case] = "a timestamp to a date or time rescales"
PYARROW_DECIDES["tdigest-all-null"] = "an empty column, pyarrow's nulls"
for _case, (_name, _args, _opts) in CASES.items():
    if _name == "week" and (_opts.get("count_from_zero") or
                            _opts.get("first_week_is_fully_in_year")):
        PYARROW_DECIDES[_case] = ("count_from_zero subtracts one; "
                                  "first_week_is_fully_in_year raises")
    if _name == "round_temporal":   # a tie rounds down (pyarrow: up)
        PYARROW_DECIDES[_case] = "a tie rounds down"
    elif _name.endswith("_temporal") and (
            _opts.get("multiple", 1) > 1 and _opts["unit"] in ("month",
                                                              "year")
            or _args == ["d32"] and _opts.get("unit") in ("hour",
                                                          "second")
            or _args == ["ts_s"] and _opts.get("unit") == "millisecond") \
            and not _opts.get("calendar_based_origin") \
            or _opts.get("calendar_based_origin") and _opts["unit"] != "month":
        PYARROW_DECIDES[_case] = ("months count from each January, years "
                                  "ignore the multiple; a date32 steps by "
                                  "days; a finer unit rounds in ticks; "
                                  "calendar_based_origin is not read")
for _col in ("ts", "ts_ns"):
    # bit for bit against pyarrow; the JAX package's traced quotient goes
    # through a reciprocal and is an ulp off
    PYARROW_DECIDES[f"subsecond-{_col}"] = "an ulp off under jax.jit"


def _dtype(pkg, spec):
    if isinstance(spec, str):
        spec = (spec,)
    kind, *rest = spec
    target = getattr(pkg, kind, None) or getattr(pkg.dtypes, kind)
    return target(*rest) if rest else target


def _arg(pkg, inp, token):
    if isinstance(token, str):
        return inp[token]
    _, value, kind = token
    return pkg.scalar(value, _dtype(pkg, kind))


def _options(pkg, inp, name, options):
    options = dict(options)
    if name == "cast":
        target = _dtype(pkg, options.pop("target"))
        opts = pkg.compute.CastOptions
        return {"options": opts.safe(target) if options.pop("safe", True)
                else opts.unsafe(target)}
    if "value_set" in options:
        options["value_set"] = INPUTS[options["value_set"].split(":")[0]] \
            .filter(pa.array([i % 3 == 0 for i in range(_N)]))
    return options


def _call(pkg, inp, case):
    name, tokens, options = CASES[case]
    return pkg.call_function(name, [_arg(pkg, inp, t) for t in tokens],
                             **_options(pkg, inp, name, options))


def _raw(out):
    """An interval the Python pyarrow cannot hold (month and day_time) as
    its storage integers and mask."""
    return {"data": np.asarray(out.data.cpu() if hasattr(out.data, "cpu")
                               else out.data).tolist(),
            "valid": np.asarray(out.mask().cpu() if hasattr(out.mask(),
                                                            "cpu")
                                else out.mask()).tolist()}


def _needs_raw(case):
    return CASES[case][0] in ("month_interval_between",
                              "day_time_interval_between")


def _port_inputs():
    return {k: column_from_arrow(a, device="cpu") for k, a in INPUTS.items()}


def reference_answers() -> dict:
    """The JAX package's answer to every case that it decides (pyarrow
    decides the cases of ``PYARROW_DECIDES``)."""
    import arrow1_tpu.compute  # noqa: F401  (the options classes)

    calls = {case: (lambda inp, case=case: _call(a1t, inp, case))
             for case in CASES
             if not _needs_raw(case) and case not in PYARROW_DECIDES}
    inputs = {k: a1t.column(a) for k, a in INPUTS.items()}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        answers = arrow_answers(jax_answers(calls, inputs))
        for case in CASES:
            if _needs_raw(case):
                answers[case] = _raw(_call(a1t, inputs, case))
        answers["group_by-d32"] = a1t.group_by(
            a1t.record_batch(_GROUP_BATCH), ["d"],
            [("v", "sum"), ("v", "count")]).to_arrow()
    return answers


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


def _port(case):
    try:
        out = _call(pt, _port_inputs(), case)
    except (A1TError, TypeError, ValueError) as e:
        return type(e)
    return _raw(out) if _needs_raw(case) else out


def _pyarrow_options(name, options):
    options = dict(options)
    if name == "cast":
        spec = options.pop("target")
        target = getattr(pa, spec[0])(*spec[1:])
        return {"target_type": target, "safe": options.pop("safe", True)}
    if "value_set" in options:
        options["value_set"] = INPUTS[options["value_set"].split(":")[0]] \
            .filter(pa.array([i % 3 == 0 for i in range(_N)]))
    return options


def _pyarrow(case):
    name, tokens, options = CASES[case]
    args = [INPUTS[t] if isinstance(t, str) else
            pa.scalar(t[1], dt.to_arrow(_dtype(pt, t[2]))) for t in tokens]
    return getattr(pc, name)(*args, **_pyarrow_options(name, options))


def test_the_slice_covers_its_names():
    assert len(NAMES) == 43
    covered = {CASES[c][0] for c in CASES}
    assert set(NAMES) <= covered
    assert set(NAMES) <= set(pt.list_functions())


@pytest.mark.parametrize("case", list(CASES))
def test_temporal_matches_the_reference(case, jax_results):
    got = _port(case)
    if case in PYARROW_DECIDES:
        want = _pyarrow(case)
    else:
        want = jax_results[case]
    if isinstance(want, type):
        assert isinstance(got, type), (case, "should raise", got)
        return
    assert not isinstance(got, type), (case, got, want)
    if isinstance(want, dict) and "valid" in want:
        assert got == want, (case, got, want)
        return
    if CASES[case][0] in ("iso_calendar", "year_month_day", "min_max"):
        g, w = _rows(got), _rows(want)
        assert g == w, (case, g, w)
        return
    assert_same(got, want, case, 0)


def _rows(x):
    """A struct result (RecordBatch, StructArray, struct scalar) as row
    dicts; a null struct row as a row of nulls."""
    x = x.to_arrow() if hasattr(x, "to_arrow") else x
    x = x.to_pylist() if hasattr(x, "to_pylist") else x
    rows = [x] if isinstance(x, dict) else x
    names = next((list(r) for r in rows if r is not None), [])
    return [dict.fromkeys(names) if r is None else r for r in rows]


@pytest.mark.parametrize("name", ["month_interval_between",
                                  "day_time_interval_between"])
def test_zoned_intervals_read_local_time(name):
    """pyarrow cannot hold these two interval types in Python: a zoned
    pair must give what its local wall times give (the naive pair is held
    against the JAX package above)."""
    inp = _port_inputs()
    zoned = _raw(pt.call_function(name, [inp["tsz"], inp["tszb"]]))
    local = [pt.call_function("local_timestamp", [inp[k]])
             for k in ("tsz", "tszb")]
    assert zoned == _raw(pt.call_function(name, local))


# ---- ingest, egress and the query layer ----------------------------------

ROUND_TRIP = {
    "date32": INPUTS["d32"], "date64": INPUTS["d64"],
    "timestamp": INPUTS["ts"], "timestamp-ns": INPUTS["ts_ns"],
    "timestamp-tz": INPUTS["tsz"], "time32": INPUTS["t32"],
    "time64": INPUTS["t64"], "duration": INPUTS["dur"],
    "month_day_nano_interval": pa.array(
        [pa.MonthDayNano([1, -2, 3]), None,
         pa.MonthDayNano([-7, 40, -10**12]),
         pa.MonthDayNano([2**31 - 1, -2**31, 2**63 - 1])],
        pa.month_day_nano_interval()),
}


@pytest.mark.parametrize("kind", list(ROUND_TRIP))
def test_round_trip_through_the_port(kind):
    arr = ROUND_TRIP[kind]
    for part in (arr, arr.slice(1)):
        col = column_from_arrow(part, device="cpu")
        assert col.dtype == dt.from_arrow(part.type)
        assert col.to_arrow().equals(part), kind


def test_intervals_keep_their_nanoseconds_through_filter_and_take():
    arr = ROUND_TRIP["month_day_nano_interval"]
    col = column_from_arrow(arr, device="cpu")
    mask = pa.array([True, True, False, True])
    got = pt.call_function("filter", [col, column_from_arrow(
        mask, device="cpu")])
    assert got.to_arrow().equals(arr.filter(mask))
    idx = pa.array([3, 0, 3, 1])
    got = pt.call_function("take", [col, column_from_arrow(
        idx, device="cpu")])
    assert got.to_arrow().equals(arr.take(idx))
    both = pt.concat_columns([col, col.slice(2)])
    assert both.to_arrow().equals(pa.concat_arrays([arr, arr.slice(2)]))


def test_temporal_literals_are_typed_storage_integers():
    import datetime

    s = pt.scalar(10471, dt.date32)
    assert s.as_py() == datetime.date(1998, 9, 2)
    for value in (datetime.date(1998, 9, 2), pa.scalar(10471, pa.date32())):
        with pytest.raises(TypeError):
            pt.scalar(value)
        with pytest.raises(TypeError):
            a1t.scalar(value)


def _lineitem(n, seed=5):
    rng = np.random.default_rng(seed)
    days = rng.integers(8000, 11000, n)
    return pa.table({
        "l_returnflag": pa.array(np.array(["A", "N", "R"])[
            rng.integers(0, 3, n)]),
        "l_quantity": pa.array(rng.integers(1, 51, n)),
        "l_extendedprice": pa.array(np.round(rng.uniform(1, 1000, n), 2)),
        "l_shipdate_days": pa.array(days),
        "l_shipdate": pa.array(days.astype(np.int32), pa.date32()),
    })


def test_q1_on_a_date32_ship_date_equals_the_int_days_template():
    """TPC-H Q1's spec predicate (l_shipdate <= date '1998-12-01' - 90
    days) on a date32 column through query(), projecting year(l_shipdate):
    the same groups as the int-days template, and a group-by on the year
    equal to numpy."""
    from arrow1_tpu_torch import models

    tbl = _lineitem(5000)
    port = pt.interop.table_from_arrow(
        pa.Table.from_batches(tbl.to_batches(max_chunksize=1024)),
        device="cpu")
    cutoff = pt.scalar(10471, dt.date32)

    def q1(group):
        return (pt.query(port)
                .filter(pt.field("l_shipdate") <= cutoff)
                .project([pt.field("l_returnflag"), pt.field("l_quantity"),
                          pt.field("l_extendedprice"),
                          pt.call("year", [pt.field("l_shipdate")])],
                         ["l_returnflag", "l_quantity", "l_extendedprice",
                          "l_year"])
                .group_by([group], [("l_quantity", "sum"),
                                    ("l_extendedprice", "sum"),
                                    ("l_quantity", "count")])
                .order_by([(group, "ascending")])
                .to_batch())

    got = q1("l_returnflag")
    want = models.q1_pricing_summary(port, 10471)
    assert got.to_arrow().to_pylist() == want.to_arrow().to_pylist()
    years = q1("l_year").to_arrow().to_pydict()
    days = tbl["l_shipdate_days"].to_numpy()
    keep = days <= 10471
    year = np.array([d.year for d in tbl["l_shipdate"].to_pylist()])[keep]
    qty = tbl["l_quantity"].to_numpy()[keep]
    uniq = np.unique(year)
    assert years["l_year"] == uniq.tolist()
    assert years["l_quantity_sum"] == [int(qty[year == y].sum())
                                       for y in uniq]
    assert years["l_quantity_count"] == [int((year == y).sum())
                                         for y in uniq]


def test_a_date32_group_key_takes_the_sorted_path_and_keeps_its_type(
        monkeypatch, jax_results):
    """The reference declines its dense path for a date32 key, and so
    does the port: no K3 call, groups in first-appearance order, the key
    still date32, as the JAX package's group_by gives them."""
    import arrow1_tpu_torch.ops.groupby as groupby

    calls = []
    real = groupby.segment_sums
    monkeypatch.setattr(groupby, "segment_sums",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = pt.group_by(pt.interop.record_batch_from_arrow(
        _GROUP_BATCH, device="cpu"), ["d"], [("v", "sum"), ("v", "count")])
    assert not calls
    assert got["d"].dtype == dt.date32
    assert got.to_arrow().equals(jax_results["group_by-d32"])


def test_strftime_gives_each_distinct_value_once():
    col = column_from_arrow(pa.array([5, 5, None, 7, 5, 7], pa.date32()),
                            device="cpu")
    out = pt.call_function("strftime", [col], format="%Y-%m-%d")
    pool = out.dictionary.values.tolist()
    assert len(pool) == len(set(pool)) <= 3   # the null slot's 0 too
    assert out.to_arrow().to_pylist() == ["1970-01-06", "1970-01-06", None,
                                          "1970-01-08", "1970-01-06",
                                          "1970-01-08"]
