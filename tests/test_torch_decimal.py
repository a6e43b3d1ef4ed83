"""The decimal slice of the port (decimal128 and decimal256 through
arithmetic, compares, casts, rounding, aggregates, grouped aggregates on
both paths, sort keys, set lookup, conditionals, joins, the compiled
pipeline and ``query()``) held against the JAX package on small columns
from ``numpy.random.default_rng(14)``: decimal128 at (15, 2) and at (38,
10) across the 2^64 limb boundary, decimal256 at (60, 6) and (76, 0),
with negatives, zeros, both limbs' edges and nulls.

Parity: integers, limbs and null masks exactly; float conversions bit
for bit against the JAX package (the same rounding of each limb, then
one division); a float result that pyarrow decides (it converts a decimal
to float64 another way), or a variance or stddev (a sum of the rows in
another order), within ULPS units in the last place. Where the
JAX package is wrong against pyarrow.compute (ROADMAP Queue 3) the port
is held against pyarrow (``PYARROW_DECIDES``): a decimal Scalar operand,
a precision past the type's maximum, the mean's and product's result
type, an integer operand, ``sign``'s type, ``mode``'s tie and a few
others named there.

The JAX answers are computed once, eagerly, in a worker process
(tests/test_torch_answers.py).
"""

import warnings
from decimal import Context
from decimal import Decimal as D

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
from test_torch_registry_sweep import (arrow_answers, as_arrow, assert_same,
                                       same_value)

_rng = np.random.default_rng(14)
_N = 16
ULPS = 4


def _dec(v: int, scale: int) -> D:
    """The exact Decimal of an unscaled integer (no 28-digit rounding)."""
    return D(int(v)).scaleb(-scale, Context(prec=100))


def _unscaled(values, at, t, edges=()):
    vals = list(edges) + [int(v) for v in values][:_N - len(edges)]
    return pa.array([None if i == at else _dec(v, t.scale)
                     for i, v in enumerate(vals)], t)


def _rand_int(lo, hi, k):
    """k Python ints uniform in [lo, hi), beyond int64 too."""
    span = hi - lo
    return [lo + int.from_bytes(_rng.bytes(40), "little") % span
            for _ in range(k)]


_M64 = 1 << 64
INPUTS = {
    "d15": _unscaled(_rng.integers(-10**7, 10**7, _N), 3,
                     pa.decimal128(15, 2), (0, 1, -1, 10**13 - 1)),
    "d15b": _unscaled(_rng.integers(1, 10**6, _N) * _rng.choice([-1, 1], _N),
                      7, pa.decimal128(15, 2), (5, -7)),
    # across the limb boundary: 2^64 - 1, 2^64, -2^64, -2^64 - 1, -1
    "d38": _unscaled(_rand_int(-10**37, 10**37, _N), 5,
                     pa.decimal128(38, 10),
                     (_M64 - 1, _M64, -_M64, -_M64 - 1, -1, 10**38 - 1)),
    "d38b": _unscaled(_rand_int(-_M64 * 4, _M64 * 4, _N), 2,
                      pa.decimal128(38, 10), (_M64, 1, -_M64 + 1)),
    "d60": _unscaled(_rand_int(-10**59, 10**59, _N), 9,
                     pa.decimal256(60, 6),
                     (_M64, -_M64, 1 << 128, -(1 << 128) - 1, 0)),
    "d76": _unscaled(_rand_int(-10**75, 10**75, _N), 11,
                     pa.decimal256(76, 0),
                     (10**76 - 1, -(10**76 - 1), 1 << 192, -(1 << 192), -1)),
    "ints": pa.array([int(v) for v in _rng.integers(-50, 50, _N)]),
    "f64": pa.array([float(v) for v in _rng.uniform(-1000, 1000, _N)]),
    "strs": pa.array(["1.5", "-2.25", None, "1e2", "0.01", "-0"] * 2
                     + ["7", ".5", "12345678901.23", "-0.10"]),
    "mask": pa.array((_rng.random(_N) < 0.5).tolist()[:-1] + [None]),
    "idx": pa.array([int(v) for v in _rng.integers(0, 2, _N)], pa.int8()),
    "keys": pa.array([int(v) for v in _rng.integers(0, 4, _N)]),
}
S15 = pa.decimal128(15, 2)


def S(value, spec=None):
    """A decimal scalar argument (its type inferred unless given)."""
    return ("scalar", value, spec)


def _cases():
    cases = {}
    for name in ("add", "subtract", "multiply", "divide"):
        cases[f"{name}-d15-d15b"] = (name, ["d15", "d15b"], {})
    for name, a, b in (("add", "d60", "d38"), ("subtract", "d38", "d60"),
                       ("multiply", "d15", "d60"), ("divide", "d60", "d15"),
                       ("divide", "d60", "d38b"), ("add", "d15", "d38"),
                       ("multiply", "d60", "d60"), ("add", "d76", "d76"),
                       ("add_checked", "d15", "d15b"),
                       ("multiply", "d15", "ints"), ("add", "d15", "f64"),
                       ("divide", "d15", "ints")):
        cases[f"{name}-{a}-{b}"] = (name, [a, b], {})
    cases["greater_equal-scalar"] = ("greater_equal",
                                     ["d15", S("0.05")], {})
    cases["subtract-scalar"] = ("subtract", [S("1"), "d15"], {})
    cases["multiply-typed-scalar"] = ("multiply",
                                      ["d15", S("1.00", S15)], {})
    for col in ("d15", "d38", "d60", "d76"):
        for name in ("negate", "abs", "sign"):
            cases[f"{name}-{col}"] = (name, [col], {})
    for name in ("equal", "less", "greater_equal", "not_equal"):
        for a, b in (("d15", "d15b"), ("d15", "d38"), ("d38", "d60"),
                     ("d60", "d76"), ("d38", "d38b")):
            cases[f"{name}-{a}-{b}"] = (name, [a, b], {})
    cases["equal-int"] = ("equal", ["d15", "ints"], {})
    for name in ("max_element_wise", "min_element_wise"):
        cases[f"{name}-d15"] = (name, ["d15", "d15b"], {})
        cases[f"{name}-d60"] = (name, ["d60", "d60"], {})
    # casts
    for src, target in (
            ("d15", ("float64",)), ("d38", ("float64",)),
            ("d60", ("float64",)), ("d76", ("float64",)),
            ("d15", ("decimal128", 20, 4)), ("d15", ("decimal256", 40, 2)),
            ("d38", ("decimal256", 50, 12)), ("d60", ("decimal256", 70, 2)),
            ("d15", ("decimal128", 15, 1)), ("d38", ("decimal128", 38, 2)),
            ("d15", ("string",)), ("d38", ("string",)), ("d76", ("string",)),
            ("strs", ("decimal128", 15, 2)), ("strs", ("decimal256", 40, 3)),
            ("ints", ("decimal128", 25, 2)), ("ints", ("decimal128", 15, 2)),
            ("f64", ("decimal128", 20, 4)), ("d15", ("int64",)),
            ("d15", ("decimal128", 5, 2))):
        label = "-".join(str(x) for x in target)
        cases[f"cast-{src}-{label}"] = ("cast", [src], {"target": target})
    for src, target in (("d15", ("int64",)), ("d38", ("decimal128", 38, 2)),
                        ("d60", ("decimal128", 38, 2)),
                        ("d15", ("decimal128", 15, 1))):
        label = "-".join(str(x) for x in target)
        cases[f"cast-{src}-{label}-unsafe"] = ("cast", [src], {
            "target": target, "safe": False})
    # aggregates
    for col in ("d15", "d38", "d60", "d76"):
        for name in ("sum", "mean", "min", "max", "min_max", "count",
                     "count_distinct", "variance", "stddev", "quantile",
                     "approximate_median", "tdigest", "mode"):
            cases[f"{name}-{col}"] = (name, [col], {})
    cases["product-d15b"] = ("product", ["d15b"], {})
    cases["index-d15"] = ("index", ["d15"], {"value": S("0.01", S15)})
    # vector functions, set lookup, conditionals, rounding
    for col in ("d15", "d38", "d60", "d76"):
        for name in ("unique", "array_sort_indices", "drop_null",
                     "value_counts", "dictionary_encode", "pairwise_diff"):
            cases[f"{name}-{col}"] = (name, [col], {})
        cases[f"array_sort_indices-desc-{col}"] = (
            "array_sort_indices", [col], {"order": "descending"})
        cases[f"is_in-{col}"] = ("is_in", [col], {"value_set": f"{col}:set"})
        cases[f"index_in-{col}"] = ("index_in", [col],
                                    {"value_set": f"{col}:set"})
        cases[f"take-{col}"] = ("take", [col, "keys"], {})
        cases[f"filter-{col}"] = ("filter", [col, "mask"], {})
        cases[f"if_else-{col}"] = ("if_else", ["mask", col, col], {})
        cases[f"floor-{col}"] = ("floor", [col], {})
        cases[f"ceil-{col}"] = ("ceil", [col], {})
        cases[f"trunc-{col}"] = ("trunc", [col], {})
        cases[f"sqrt-{col}"] = ("sqrt", [col], {})
    cases["rank-d38"] = ("rank", ["d38"], {})
    cases["sort_indices-d60"] = ("sort_indices", ["d60"], {})
    cases["fill_null-d15"] = ("fill_null", ["d15", S("7.25", S15)], {})
    cases["fill_null-d38-col"] = ("fill_null", ["d38", "d38b"], {})
    cases["coalesce-d15"] = ("coalesce", ["d15", "d15b"], {})
    cases["choose-d15"] = ("choose", ["idx", "d15", "d15b"], {})
    cases["cumulative_sum-d15"] = ("cumulative_sum", ["d15"], {})
    cases["fill_null_forward-d60"] = ("fill_null_forward", ["d60"], {})
    for mode in ("half_to_even", "half_down", "up", "towards_zero",
                 "half_away_from_zero"):
        cases[f"round-d15--1-{mode}"] = ("round", ["d15"], {
            "ndigits": -1, "round_mode": mode})
        cases[f"round-d38-3-{mode}"] = ("round", ["d38"], {
            "ndigits": 3, "round_mode": mode})
        cases[f"round_to_multiple-d15-{mode}"] = (
            "round_to_multiple", ["d15"], {"multiple": D("0.25"),
                                           "round_mode": mode})
    cases["round-d60-2"] = ("round", ["d60"], {"ndigits": 2})
    cases["round_to_multiple-d60"] = ("round_to_multiple", ["d60"], {
        "multiple": D("0.5")})
    return cases


CASES = _cases()

# where pyarrow decides (ROADMAP Queue 3): the JAX package answers
# otherwise, or raises where pyarrow answers
PYARROW_DECIDES = {
    "greater_equal-scalar": "a decimal Scalar operand raises AttributeError",
    "subtract-scalar": "a decimal Scalar operand raises AttributeError",
    "multiply-typed-scalar": "a decimal Scalar operand raises",
    "add-d15-d38": "precision 39 is capped at 38; pyarrow raises",
    "multiply-d60-d60": "precision 121 is capped at 76; pyarrow raises",
    "add-d76-d76": "precision 77 is capped at 76; pyarrow raises",
    "multiply-d15-ints": "an integer operand raises AttributeError",
    "divide-d15-ints": "an integer operand raises AttributeError",
    "add-d15-f64": "a float operand raises AttributeError",
    "equal-int": "an integer operand raises AttributeError",
    "product-d15b": "decimal128(38, s): pyarrow keeps the input type",
    "cast-d15-decimal128-5-2": "no precision check on a safe cast",
    "cast-ints-decimal128-15-2": "error class",
    "fill_null_forward-d60": "drops the high limbs",
    "cast-strs-decimal256-40-3": "raises OverflowError",
    "pairwise_diff-d38": "precision 39 is capped at 38; pyarrow raises",
    "pairwise_diff-d76": "precision 77 is capped at 76; pyarrow raises",
    "cast-d38-string": "plain digits where Arrow writes 1E-10",
    "cast-d60-decimal128-38-2-unsafe": "an unsafe cast checks the range",
}
for _name in ("equal", "less", "greater_equal", "not_equal"):
    PYARROW_DECIDES[f"{_name}-d60-d76"] = "precision 82 passes 76"
for _col in ("d60", "d76"):
    for _name in ("min", "max", "floor", "ceil", "trunc"):
        PYARROW_DECIDES[f"{_name}-{_col}"] = "decimal256 raises"
for _col in ("d15", "d38", "d60", "d76"):
    PYARROW_DECIDES[f"mean-{_col}"] = \
        "decimal128(38, s): pyarrow keeps the input type"
    PYARROW_DECIDES[f"sign-{_col}"] = "int8: pyarrow gives int64"
    PYARROW_DECIDES[f"mode-{_col}"] = "a tie puts negatives last"
for _case, (_name, _args, _) in CASES.items():
    if _name == "round" and "d60" in _args or \
            _name == "round_to_multiple" and "d60" in _args:
        PYARROW_DECIDES[_case] = "decimal256 round raises"
    if _name in ("variance", "stddev") and _args != ["d15"]:
        # s2/n - mean^2 cancels at these magnitudes (ROADMAP Queue 3)
        PYARROW_DECIDES[_case] = "the variance cancels"

# pyarrow has no kernel for these, and neither package has one either:
# both raise (the classes may differ)
BOTH_RAISE = {"cumulative_sum-d15"}



def _spec_type(pkg, spec):
    kind, *rest = spec
    target = getattr(pkg, kind, None) or getattr(pkg.dtypes, kind)
    return target(*rest) if rest or pkg is pa else target


def _arg(pkg, inp, token):
    if isinstance(token, str):
        return inp[token]
    _, value, spec = token
    if pkg is pa:
        return pa.scalar(D(value), spec)
    t = None if spec is None else pkg.decimal128(spec.precision, spec.scale)
    return pkg.scalar(D(value), t)


def _value_set(key):
    return INPUTS[key].filter(pa.array([i % 3 == 0 for i in range(_N)]))


def _options(pkg, name, options):
    options = dict(options)
    if name == "cast":
        target = _spec_type(pkg, options.pop("target"))
        opts = pkg.compute.CastOptions
        return {"options": opts.safe(target) if options.pop("safe", True)
                else opts.unsafe(target)}
    if "value_set" in options:
        options["value_set"] = _value_set(options["value_set"].split(":")[0])
    if "value" in options:
        options["value"] = _arg(pkg, None, options["value"])
    return options


def _call(pkg, inp, case):
    name, tokens, options = CASES[case]
    return pkg.call_function(name, [_arg(pkg, inp, t) for t in tokens],
                             **_options(pkg, name, options))


def _pyarrow(case):
    name, tokens, options = CASES[case]
    args = [_arg(pa, INPUTS, t) for t in tokens]
    options = dict(options)
    try:
        if name == "cast":
            spec = options.pop("target")
            return pc.cast(args[0], _spec_type(pa, spec),
                           safe=options.pop("safe", True))
        if "value_set" in options:
            options["value_set"] = _value_set(
                options["value_set"].split(":")[0])
        if "value" in options:
            options["value"] = _arg(pa, None, options["value"])
        return getattr(pc, name)(*args, **options)
    except (pa.ArrowException, ValueError, TypeError):
        return Exception


# the grouped, join and pipeline inputs
_GROUPS = pa.record_batch({
    "k": pa.array([int(v) for v in _rng.integers(0, 3, 40)]),
    "g": pa.array(_rng.choice(["x", "y"], 40).tolist()),
    "p": pa.array([None if i == 4 else D(int(v)).scaleb(-2) for i, v in
                   enumerate(_rng.integers(-10**9, 10**9, 40))],
                  pa.decimal128(15, 2)),
    "w": pa.array([None if i == 7 else _dec(v, 6) for i, v in
                   enumerate(_rand_int(-10**55, 10**55, 40))],
                  pa.decimal256(60, 6)),
    "dk": pa.array([None if i == 9 else D(int(v)).scaleb(-1) for i, v in
                    enumerate(_rng.integers(-3, 3, 40))],
                   pa.decimal128(5, 1)),
})
_GROUP_AGGS = [("p", "sum"), ("p", "count"), ("w", "sum")]
_SORTED_AGGS = [("p", "sum"), ("p", "min"), ("w", "max"), ("p", "count")]
_RIGHT = pa.record_batch({
    "dk": pa.array([D("1.0"), D("-2.0"), D("0.0"), None, D("1.0")],
                   pa.decimal128(5, 1)),
    "r": pa.array([1, 2, 3, 4, 5])})


def reference_answers(part=None) -> dict:
    """The JAX package's answer to every case that it decides (parts 0
    and 1, half the cases each), and to the grouped, join and query
    inputs (part 2); all when no part is named. The parts run in worker
    processes of their own, at once."""
    import arrow1_tpu.compute  # noqa: F401  (the options classes)

    answers = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        if part in (None, 0, 1):
            # eagerly: most decimal calls read a flag on the host, and
            # under jax.jit a quotient by 10^scale goes through a
            # reciprocal
            inputs = {k: a1t.column(a) for k, a in INPUTS.items()}
            for i, case in enumerate(CASES):
                if case in PYARROW_DECIDES or case in BOTH_RAISE or \
                        part is not None and i % 2 != part:
                    continue
                try:
                    answers[case] = _call(a1t, inputs, case)
                except Exception as e:   # noqa: BLE001 (the class is kept)
                    answers[case] = type(e)
            answers = arrow_answers(answers)
        if part in (None, 2):
            rb = a1t.record_batch(_GROUPS)
            answers["group_by-int"] = a1t.group_by(rb, ["k"],
                                                   _GROUP_AGGS).to_arrow()
            answers["group_by-decimal-key"] = a1t.group_by(
                rb, ["g", "dk"], _SORTED_AGGS).to_arrow()
            answers["join"] = a1t.interop.record_batch_to_arrow(a1t.join(
                a1t.record_batch(_GROUPS.select(["dk", "k"])),
                a1t.record_batch(_RIGHT), "dk"))
            answers["q1"], answers["q6"] = _reference_queries()
    return answers


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


def _port_inputs():
    return {k: column_from_arrow(a, device="cpu") for k, a in INPUTS.items()}


def _port(case):
    try:
        return _call(pt, _port_inputs(), case)
    except (A1TError, TypeError, ValueError, NotImplementedError) as e:
        return type(e)


def test_the_slice_constructs_its_types():
    assert pt.decimal128(15, 2).precision == 15
    assert pt.decimal256(76, 0).limbs == 4
    for p in (0, 39):
        with pytest.raises(A1TError):
            pt.decimal128(p, 0)


@pytest.mark.parametrize("case", list(CASES))
def test_decimal_matches_the_reference(case, jax_results):
    got = _port(case)
    if case in BOTH_RAISE:
        assert isinstance(got, type), (case, got)
        assert isinstance(_pyarrow(case), type)
        return
    want = _pyarrow(case) if case in PYARROW_DECIDES else jax_results[case]
    if isinstance(want, type):
        assert isinstance(got, type), (case, "should raise", got)
        return
    assert not isinstance(got, type), (case, got, want)
    name = CASES[case][0]
    if name in ("min_max", "mode", "value_counts", "hash_min_max"):
        g, w = _rows(got), _rows(want)
        assert same_value(g, w), (case, g, w)
        return
    # a float sum over rows adds in another order in each package
    loose = case in PYARROW_DECIDES or name in ("variance", "stddev")
    assert_same(got, want, case, ULPS if loose else 0)


def _rows(x):
    x = as_arrow(x)
    x = x.to_pylist() if hasattr(x, "to_pylist") else x
    return [x] if isinstance(x, dict) else x


# ---- ingest and egress --------------------------------------------------

ROUND_TRIP = {
    "decimal128": INPUTS["d38"], "decimal128-15": INPUTS["d15"],
    "decimal256": INPUTS["d60"], "decimal256-76": INPUTS["d76"],
}


@pytest.mark.parametrize("kind", list(ROUND_TRIP))
def test_round_trip_through_the_port_byte_for_byte(kind):
    """An array, a slice of it (an offset), a ChunkedArray, a RecordBatch
    and a Table go in and come back equal, every value's bytes too."""
    arr = ROUND_TRIP[kind]
    for part in (arr, arr.slice(3), arr.slice(5, 4)):
        col = column_from_arrow(part, device="cpu")
        assert col.dtype == dt.from_arrow(part.type)
        back = col.to_arrow()
        assert back.equals(part), kind
        valid = np.asarray(part.is_valid())
        assert [v for v, ok in zip(back.to_pylist(), valid) if ok] == \
            [v for v, ok in zip(part.to_pylist(), valid) if ok]
    chunked = pa.chunked_array([arr.slice(0, 6), arr.slice(6)])
    assert column_from_arrow(chunked, device="cpu").to_arrow().equals(arr)
    rb = pa.record_batch({"x": arr.slice(2)})
    assert pt.interop.record_batch_to_arrow(pt.interop.record_batch_from_arrow(
        rb, device="cpu")).equals(rb)
    table = pa.Table.from_batches([rb, pa.record_batch({"x": arr})])
    assert pt.interop.table_to_arrow(pt.interop.table_from_arrow(
        table, device="cpu")).equals(table)


def test_scalars_are_exact_decimals():
    s = pt.scalar(D("0.05"))
    assert s.dtype == pt.decimal128(2, 2) == dt.from_arrow(
        pa.scalar(D("0.05")).type)
    assert s.as_py() == D("0.05")
    big = pt.scalar(D(10**70 + 1), pt.decimal256(76, 2))
    assert big.as_py() == D(10**70 + 1)
    with pytest.raises(A1TError):
        pt.scalar(D("0.001"), pt.decimal128(15, 2))


def test_decimal_limbs_ride_the_compaction():
    """A filter moves every limb of a decimal128 and a decimal256 column
    through one compaction call (the three high limbs of a decimal256 as
    three streams)."""
    import arrow1_tpu_torch.ops.selection as selection

    calls = []
    real = selection.compact
    rb = pa.record_batch({"a": INPUTS["d38"], "b": INPUTS["d76"]})
    mask = INPUTS["mask"]
    b = pt.interop.record_batch_from_arrow(rb, device="cpu")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(selection, "compact", lambda sel, streams, **k:
                   calls.append(len(streams)) or real(sel, streams, **k))
        got = pt.call_function("filter", [b, column_from_arrow(
            mask, device="cpu")])
    assert calls == [2 + 4 + 2]   # the limbs and validities
    assert pt.interop.record_batch_to_arrow(got).equals(rb.filter(mask))
    both = pt.concat_columns([b["b"], b["b"].slice(4)])
    assert both.to_arrow().equals(pa.concat_arrays(
        [INPUTS["d76"], INPUTS["d76"].slice(4)]))


# ---- grouped aggregates, joins, the compiled pipeline ---------------------

def _sorted_rows(t, keys):
    return sorted(as_arrow(t).to_pylist(), key=lambda r: [
        (r[k] is None, r[k] if r[k] is not None else 0) for k in keys])


def test_dense_group_by_sums_decimal_digits_through_k3(monkeypatch,
                                                       jax_results):
    """An int64 key on the dense path: the decimal sums come from one call
    of K3's plain version here (the kernel on the card), over the 32-bit
    digit planes of the limbs, bit-equal to the JAX package's sorted-path
    sums; the mean, which the JAX package types decimal128(38, s), keeps
    the input type and equals pyarrow's."""
    import arrow1_tpu_torch.ops.groupby as groupby

    calls = []
    real = groupby.segment_sums
    monkeypatch.setattr(groupby, "segment_sums",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    b = pt.interop.record_batch_from_arrow(_GROUPS, device="cpu")
    got = pt.group_by(b, ["k"], _GROUP_AGGS + [("p", "mean"),
                                                ("w", "mean")])
    assert calls == [1]
    rows = _sorted_rows(got, ["k"])
    want = _sorted_rows(jax_results["group_by-int"], ["k"])
    assert [{k: r[k] for k in want[0]} for r in rows] == want
    pa_want = _sorted_rows(pa.table(_GROUPS).group_by("k").aggregate(
        [("p", "mean"), ("w", "mean")]), ["k"])
    assert [(r["p_mean"], r["w_mean"]) for r in rows] == \
        [(r["p_mean"], r["w_mean"]) for r in pa_want]
    assert got["p_mean"].dtype == pt.decimal128(15, 2)


def test_decimal_keys_take_the_sorted_path(jax_results):
    """A string and a decimal key (its limbs are sort keys): the groups
    of the JAX package's group_by, and of pyarrow's."""
    b = pt.interop.record_batch_from_arrow(_GROUPS, device="cpu")
    keys = ["g", "dk"]
    got = _sorted_rows(pt.group_by(b, keys, _SORTED_AGGS), keys)
    assert got == _sorted_rows(jax_results["group_by-decimal-key"], keys)
    assert got == [{k: r[k] for k in got[0]} for r in _sorted_rows(
        pa.table(_GROUPS).group_by(keys, use_threads=False).aggregate(
            _SORTED_AGGS), keys)]


def test_grouped_decimal_variance_matches_pyarrow():
    b = pt.interop.record_batch_from_arrow(_GROUPS, device="cpu")
    aggs = [("p", "variance"), ("p", "stddev"), ("w", "variance")]
    got = _sorted_rows(pt.group_by(b, ["k"], aggs), ["k"])
    want = _sorted_rows(pa.table(_GROUPS).group_by("k").aggregate(aggs),
                        ["k"])
    assert same_value(got, want, ulps=ULPS), (got, want)


@pytest.mark.parametrize("name", ["hash_sum", "hash_mean", "hash_min_max",
                                  "hash_max", "hash_variance"])
@pytest.mark.parametrize("col", ["d15", "d38", "d60"])
def test_hash_aggregates_over_group_ids(name, col):
    """The kernel-level hash_* entry points over group ids equal pyarrow's
    group_by on the same ids (the JAX package raises for a decimal sum and
    gives a float64 mean: it has no exact grouped form on ids)."""
    ids = INPUTS["keys"]
    port = pt.call_function(name, [column_from_arrow(INPUTS[col],
                                                     device="cpu"),
                                   column_from_arrow(ids, device="cpu")])
    fn = name[len("hash_"):]
    want = pa.table({"v": INPUTS[col], "g": ids}).group_by("g").aggregate(
        [("v", fn)]).sort_by("g")
    if fn == "min_max":
        got = _rows(port)
        assert [(r["min"], r["max"]) for r in got] == \
            [(r["min"], r["max"]) for r in want["v_min_max"].to_pylist()]
        return
    assert same_value(as_arrow(port).to_pylist(),
                      want[f"v_{fn}"].to_pylist(), ulps=ULPS), name
    assert as_arrow(port).type == want[f"v_{fn}"].type


def test_join_on_decimal_keys(jax_results):
    left = pt.interop.record_batch_from_arrow(_GROUPS.select(["dk", "k"]),
                                              device="cpu")
    right = pt.interop.record_batch_from_arrow(_RIGHT, device="cpu")
    got = pt.join(left, right, "dk")
    assert pt.interop.record_batch_to_arrow(got).to_pylist() == \
        jax_results["join"].to_pylist()
    outer = pt.join(left, right, "dk", join_type="full outer")
    want = pa.table(_GROUPS.select(["dk", "k"])).join(
        pa.table(_RIGHT), "dk", join_type="full outer")
    assert _sorted_rows(outer, ["dk", "k", "r"]) == \
        _sorted_rows(want, ["dk", "k", "r"])


def test_compiled_pipeline_keys_and_sorts_decimals():
    """Decimal keys and payloads ride the compiled pipeline as limb
    planes; a decimal aggregate other than count raises, as in the JAX
    package."""
    b = pt.interop.record_batch_from_arrow(_GROUPS, device="cpu")
    pipe = pt.PipelineBuilder().group_by(["dk"], [("k", "sum"),
                                                  ("w", "count")]).compile()
    got = _sorted_rows(pipe(b), ["dk"])
    want = _sorted_rows(pa.table(_GROUPS).group_by("dk").aggregate(
        [("k", "sum"), ("w", "count")]), ["dk"])
    assert got == [{k: r[k] for k in got[0]} for r in want]
    srt = pt.PipelineBuilder().sort([("w", "descending")]).compile()(b)
    assert srt.to_arrow().to_pylist() == pa.table(_GROUPS).sort_by(
        [("w", "descending")]).to_pylist()
    with pytest.raises(A1TError):
        pt.PipelineBuilder().group_by(["k"], [("p", "sum")]).compile()(b)


# ---- TPC-H Q1 and Q6 on DECIMAL(15,2) through query() ---------------------

def _lineitem(n=2000, seed=14):
    rng = np.random.default_rng(seed)
    cents = pa.decimal128(15, 2)
    return pa.table({
        "l_returnflag": pa.array(np.array(["A", "N", "R"])[
            rng.integers(0, 3, n)]),
        "l_quantity": pa.array([D(int(v)) for v in rng.integers(1, 51, n)],
                               cents),
        "l_extendedprice": pa.array([D(int(v)).scaleb(-2) for v in
                                     rng.integers(90000, 10494951, n)],
                                    cents),
        "l_discount": pa.array([D(int(v)).scaleb(-2) for v in
                                rng.integers(0, 11, n)], cents),
        "l_tax": pa.array([D(int(v)).scaleb(-2) for v in
                           rng.integers(0, 9, n)], cents),
        "l_shipdate": pa.array(rng.integers(8000, 11000, n).astype(np.int32),
                               pa.date32()),
    })


def _q1(pkg, table, plan):
    """Q1's filtered, projected batch (the spec's arithmetic) and its
    aggregates, grouped by l_returnflag."""
    cents = pkg.decimal128(15, 2)
    one = pkg.scalar(D("1.00"), cents)
    disc_price = pkg.call("multiply", [pkg.field("l_extendedprice"),
                                       pkg.call("subtract", [
                                           one, pkg.field("l_discount")])])
    charge = pkg.call("multiply", [
        pkg.call("cast", [disc_price], options=pkg.compute.CastOptions.safe(
            pkg.decimal256(38, 4))),
        pkg.call("add", [one, pkg.field("l_tax")])])
    q = plan(table).filter(pkg.field("l_shipdate") <= pkg.scalar(
        10471, pkg.date32))
    q = q.project([pkg.field("l_returnflag"), pkg.field("l_quantity"),
                   pkg.field("l_extendedprice"), pkg.field("l_discount"),
                   disc_price, charge],
                  ["l_returnflag", "l_quantity", "l_extendedprice",
                   "l_discount", "disc_price", "charge"])
    return q


_Q1_AGGS = [("l_quantity", "sum"), ("l_extendedprice", "sum"),
            ("disc_price", "sum"), ("charge", "sum"), ("l_quantity", "mean"),
            ("l_extendedprice", "mean"), ("l_discount", "mean"),
            ("l_quantity", "count")]


def _q6(pkg, table, plan):
    cents = pkg.decimal128(15, 2)
    f = pkg.field
    return (plan(table)
            .filter((f("l_shipdate") >= pkg.scalar(8766, pkg.date32))
                    & (f("l_shipdate") < pkg.scalar(9131, pkg.date32))
                    & (f("l_discount") >= pkg.scalar(D("0.05"), cents))
                    & (f("l_discount") <= pkg.scalar(D("0.07"), cents))
                    & (f("l_quantity") < pkg.scalar(D("24"), cents)))
            .project([pkg.call("multiply", [f("l_extendedprice"),
                                            f("l_discount")])],
                     ["revenue"]))


def _reference_queries():
    """The JAX package's eager answers. It fails on a decimal Scalar
    operand (PYARROW_DECIDES), so its literals are columns of the
    constant: Q1's projected rows (filter, price * (1 - disc), the cast
    to decimal256 times (1 + tax)), Q6's revenue summed by its eager
    sum."""
    tbl = _lineitem().combine_chunks()
    n = tbl.num_rows
    cents = pa.decimal128(15, 2)

    def const(v):
        return a1t.column(pa.array([D(v)] * n, cents))

    def f(name, *args, **kw):
        return a1t.call_function(name, list(args), **kw)

    rb = a1t.record_batch(tbl.to_batches()[0])
    keep = f("less_equal", rb["l_shipdate"], a1t.scalar(10471, a1t.date32))
    one = const("1.00")
    disc_price = f("multiply", rb["l_extendedprice"],
                   f("subtract", one, rb["l_discount"]))
    charge = f("multiply", f("cast", disc_price,
                             options=a1t.compute.CastOptions.safe(
                                 a1t.decimal256(38, 4))),
               f("add", one, rb["l_tax"]))
    cols = {"l_returnflag": rb["l_returnflag"],
            "l_quantity": rb["l_quantity"],
            "l_extendedprice": rb["l_extendedprice"],
            "l_discount": rb["l_discount"], "disc_price": disc_price,
            "charge": charge}
    proj = pa.record_batch({k: f("filter", c, keep).to_arrow()
                            for k, c in cols.items()})
    # its projected values, aggregated exactly by pyarrow (the JAX
    # package's grouped decimal sums are held above; here the slice's
    # arithmetic is)
    q1 = pa.table(proj).group_by("l_returnflag", use_threads=False) \
        .aggregate(_Q1_AGGS)
    sel = f("and", f("and", f("greater_equal", rb["l_shipdate"],
                              a1t.scalar(8766, a1t.date32)),
                         f("less", rb["l_shipdate"],
                           a1t.scalar(9131, a1t.date32))),
            f("and", f("and", f("greater_equal", rb["l_discount"],
                                const("0.05")),
                       f("less_equal", rb["l_discount"], const("0.07"))),
              f("less", rb["l_quantity"], const("24.00"))))
    revenue = f("multiply", f("filter", rb["l_extendedprice"], sel),
                f("filter", rb["l_discount"], sel))
    return q1, f("sum", revenue).as_py()


def test_tpch_q1_and_q6_on_decimal_columns(jax_results):
    """Q1 (l_shipdate <= 1998-09-02, the decimal256 sum_charge included)
    and Q6 at 2000 rows in 1024-row batches through query(): Q1 equal to
    the JAX package's projected rows aggregated by pyarrow (types too),
    Q6 to the JAX package's eager sum."""
    tbl = _lineitem()
    port = pt.interop.table_from_arrow(pa.Table.from_batches(
        tbl.to_batches(max_chunksize=1024)), device="cpu")
    got = _q1(pt, port, pt.query).group_by(["l_returnflag"], _Q1_AGGS) \
        .order_by([("l_returnflag", "ascending")]).to_table().to_arrow()
    want = jax_results["q1"]
    assert _sorted_rows(got, ["l_returnflag"]) == \
        _sorted_rows(want, ["l_returnflag"])
    for name in want.column_names:
        assert got.schema.field(name).type == want.schema.field(name).type
    assert got.schema.field("charge_sum").type == pa.decimal256(76, 6)
    rev = _q6(pt, port, pt.query).to_table()
    total = pt.call_function("sum", [pt.concat_columns(
        [b["revenue"] for b in rev.batches])])
    assert total.as_py() == jax_results["q6"]
