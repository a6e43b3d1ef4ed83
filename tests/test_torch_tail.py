"""The numeric compute tail of the port (validity, selection, numeric cast,
the sort tail, element-wise min/max, power/abs/sign, bitwise, math,
cumulative, conditional, set lookup, run-end encoding, ``random``) held
against the JAX package with options, scalars, mixed types and the narrow
unsigned types, on the columns of the registry sweep
(tests/test_torch_registry_sweep.py) and a few more of the same length.

Parity: integers, bools and null masks exactly; floats within ULPS units
in the last place (the packages' libm differ), ``rank_normal`` within 16
(torch.special.ndtri against jax.scipy.special.ndtri). Where the JAX
package is wrong against pyarrow.compute (ROADMAP Queue 3), the port is
held against pyarrow (``test_pyarrow_decides``). ``random`` cannot
reproduce JAX's threefry bits, so it is held to its properties.

The JAX answers are computed once, by the sweep's ``jax_answers`` (most
calls traced to a few ``jax.jit`` programs, the rest eagerly), in a
worker process (tests/test_torch_answers.py) that starts with the first
port test file's fixture.
"""

import math
import warnings

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest
import torch

import arrow1_tpu as a1t
from arrow1_tpu import expr as jexpr

import arrow1_tpu_torch as pt
import arrow1_tpu_torch.compute  # noqa: F401  (the options classes)
from arrow1_tpu_torch import dtypes as dt
from arrow1_tpu_torch import expr as pexpr
from arrow1_tpu_torch.errors import IndexError_, Invalid
from test_torch_answers import answers_of
from test_torch_registry_sweep import (COLUMNS, NAN, arrow_answers,
                                       assert_same, jax_answers)

EXTRA = {
    "ties": pa.array([2, 2, None, -1, 2], pa.int64()),
    "small": pa.array([1, 2, None, 3, 4], pa.int64()),
    "mask": pa.array([True, False, None, True, True]),
    "mask2": pa.array([False, True, True, None, True]),
    "i8": pa.array([100, -100, None, 27, -128], pa.int8()),
    "u16": pa.array([65535, 1, None, 3, 0], pa.uint16()),
    "u32": pa.array([1, 4294967295, None, 7, 0], pa.uint32()),
    "imin": pa.array([-(2 ** 63), 1, None, 2, 3], pa.int64()),
    "str2": pa.array(["kiwi", "b", None, "zz", "a"]),
    "idx": pa.array([0, 2, None, 1, 0], pa.int32()),
    "perm": pa.array([2, 0, None, 2, 4], pa.int64()),
    "slots": pa.array([3, 0, None, 1, 4], pa.int64()),
    "shift": pa.array([0, 3, None, 70, -1], pa.int64()),
    "big": pa.array([1e300, -2.5, None, 3.0, 0.5]),
}
INPUTS = {**COLUMNS, **EXTRA}


def S(value, kind=None):
    """A scalar argument: ``kind`` names its type (default: inferred)."""
    return ("scalar", value, kind)


def B(*keys):
    """A RecordBatch argument of the named input columns."""
    return ("batch",) + keys


def E(key):
    """The named input, dictionary-encoded."""
    return ("encoded", key)


# id -> (function, arguments, options)
CASES = {
    # validity
    "is_null-nan_is_null-f32": ("is_null", ["f32"], {"nan_is_null": True}),
    "is_null-nan_is_null-f64": ("is_null", ["f64"], {"nan_is_null": True}),
    "is_valid-null-scalar": ("is_valid", [S(None)], {}),
    "is_nan-scalar": ("is_nan", [S(NAN)], {}),
    "is_inf-i64": ("is_inf", ["i64"], {}),
    "fill_null-i64-scalar": ("fill_null", ["i64", S(9)], {}),
    "fill_null-f64-scalar": ("fill_null", ["f64", S(2.5)], {}),
    "fill_null-u64-scalar": ("fill_null", ["u64", S(7, "uint64")], {}),
    "fill_null-str-new": ("fill_null", ["str", S("zz")], {}),
    "fill_null-str-known": ("fill_null", ["str", S("a")], {}),
    "fill_null-i64-column": ("fill_null", ["i64", "ties"], {}),
    "fill_null-str-column": ("fill_null", ["str", "str2"], {}),
    "coalesce-three": ("coalesce", ["i64", "ties", S(0)], {}),
    "coalesce-str": ("coalesce", ["str", "str2"], {}),
    "if_else-columns": ("if_else", ["mask", "i64", "ties"], {}),
    "if_else-scalar-left": ("if_else", ["mask", S(1), "i64"], {}),
    "if_else-str": ("if_else", ["mask", "str", "str2"], {}),
    "if_else-null-right": ("if_else", ["mask", "f64", S(None, "float64")],
                           {}),
    "true_unless_null": ("true_unless_null", ["f64"], {}),
    # selection and dictionaries
    "drop_null-batch": ("drop_null", [B("i64", "f64", "mask")], {}),
    "array_take-null-index": ("array_take", ["ties", "idx"], {}),
    "array_filter-emit_null": ("array_filter", ["i64", "mask"],
                               {"null_selection_behavior": "emit_null"}),
    "scatter": ("scatter", ["small", "slots"], {"max_index": 5}),
    "dictionary_decode-str": ("dictionary_decode", [E("str")], {}),
    # numeric cast
    "cast-i64-u8-unsafe": ("cast", ["i64"], {"target": "uint8",
                                             "safe": False}),
    "cast-i64-u8-safe": ("cast", ["i64"], {"target": "uint8"}),
    "cast-i64-f32": ("cast", ["i64"], {"target": "float32"}),
    "cast-u64-f64": ("cast", ["u64"], {"target": "float64"}),
    "cast-u64-i64-safe": ("cast", ["u64"], {"target": "int64"}),
    "cast-u64-i64-unsafe": ("cast", ["u64"], {"target": "int64",
                                              "safe": False}),
    "cast-f64-i64-safe": ("cast", ["f64"], {"target": "int64"}),
    "cast-small-f64-i8": ("cast", ["small"], {"target": "int8"}),
    "cast-f32-f64": ("cast", ["f32"], {"target": "float64"}),
    "cast-f64-f32": ("cast", ["f64"], {"target": "float32"}),
    "cast-big-f32-safe": ("cast", ["big"], {"target": "float32"}),
    "cast-bool-i64": ("cast", ["bool"], {"target": "int64"}),
    "cast-i64-bool": ("cast", ["i64"], {"target": "bool"}),
    "cast-u32-i8-unsafe": ("cast", ["u32"], {"target": "int8",
                                             "safe": False}),
    "cast-i8-u16-unsafe": ("cast", ["i8"], {"target": "uint16",
                                            "safe": False}),
    "cast-u16-u32": ("cast", ["u16"], {"target": "uint32"}),
    "cast-dictionary-string": ("cast", [E("str")], {"target": "string"}),
    # the sort tail
    "rank-min": ("rank", ["ties"], {"tiebreaker": "min"}),
    "rank-max-desc": ("rank", ["ties"], {"tiebreaker": "max",
                                         "sort_keys": "descending"}),
    "rank-dense-at_start": ("rank", ["ties"], {"tiebreaker": "dense",
                                               "null_placement": "at_start"}),
    "rank-first-f64": ("rank", ["f64"], {}),
    "rank-min-f64": ("rank", ["f64"], {"tiebreaker": "min"}),
    "rank-u64": ("rank", ["u64"], {"tiebreaker": "max"}),
    "rank_quantile": ("rank_quantile", ["ties"], {}),
    "rank_normal-desc": ("rank_normal", ["f64"],
                         {"sort_keys": [("x", "descending")]}),
    "partition_nth": ("partition_nth_indices", ["f64"], {"pivot": 2}),
    "select_k": ("select_k_unstable", ["ties"],
                 {"k": 3, "sort_keys": [("x", "descending")]}),
    # element-wise min and max
    "min_element_wise-three": ("min_element_wise", ["i64", "ties", S(1)],
                               {}),
    "max_element_wise-u64": ("max_element_wise", ["u64", S(5, "uint64")],
                             {}),
    "min_element_wise-str": ("min_element_wise", ["str", "str2"], {}),
    "max_element_wise-strict": ("max_element_wise", ["i64", "ties"],
                                {"skip_nulls": False}),
    "min_element_wise-u32-u16": ("min_element_wise", ["u32", "u16"], {}),
    # power, abs, sign
    "power-columns": ("power", ["ties", "small"], {}),
    "power-negative": ("power", ["i64", S(-1)], {}),
    "power-float": ("power", ["f64", S(0.5)], {}),
    "power_checked-overflow": ("power_checked", ["i64", S(40)], {}),
    "power-u32": ("power", ["u32", S(2, "uint32")], {}),
    "abs_checked-min": ("abs_checked", ["imin"], {}),
    "abs-i8": ("abs", ["i8"], {}),
    "abs-min": ("abs", ["imin"], {}),
    "sign-i64": ("sign", ["i64"], {}),
    # bitwise
    "bit_wise_and-u64-scalar": ("bit_wise_and", ["u64", S(6, "uint64")], {}),
    "bit_wise_or-mixed": ("bit_wise_or", ["u8", "i8"], {}),
    "bit_wise_not-u32": ("bit_wise_not", ["u32"], {}),
    "shift_left-out_of_range": ("shift_left", ["ties", "shift"], {}),
    "shift_right-u64": ("shift_right", ["u64", S(1, "uint64")], {}),
    "shift_right-i8": ("shift_right", ["i8", S(2, "int8")], {}),
    "shift_left_checked": ("shift_left_checked", ["ties", "shift"], {}),
    "shift_right-u16": ("shift_right", ["u16", S(3, "uint16")], {}),
    # math
    "round-half_up": ("round", ["f64"], {"ndigits": 1,
                                         "round_mode": "half_up"}),
    "round-int-odd": ("round", ["ties"], {"ndigits": -1,
                                          "round_mode": "half_to_odd"}),
    "round_to_multiple": ("round_to_multiple", ["big"], {"multiple": 0.5}),
    "round_binary": ("round_binary", ["big", "small"], {}),
    "logb": ("logb", ["small", S(2.0)], {}),
    "atan2": ("atan2", ["f32", "f32"], {}),
    "hypot": ("hypot", ["f64", "small"], {}),
    "ln_checked-raises": ("ln_checked", ["i64"], {}),
    "sqrt_checked": ("sqrt_checked", ["small"], {}),
    "floor-f32": ("floor", ["f32"], {}),
    # cumulative
    "cumulative_sum-start": ("cumulative_sum", ["i64"], {"start": 10}),
    "cumulative_sum-skip": ("cumulative_sum", ["i64"], {"skip_nulls": True}),
    "cumulative_sum-u32": ("cumulative_sum", ["u32"], {"skip_nulls": True}),
    "cumulative_prod": ("cumulative_prod", ["ties"], {"skip_nulls": True}),
    "cumulative_mean-skip": ("cumulative_mean", ["i64"],
                             {"skip_nulls": True}),
    "cumulative_max-ties": ("cumulative_max", ["ties"],
                            {"skip_nulls": True}),
    "cumulative_min-u32": ("cumulative_min", ["u32"], {"skip_nulls": True}),
    "pairwise_diff-2": ("pairwise_diff", ["i64"], {"period": 2}),
    "pairwise_diff-back": ("pairwise_diff", ["big"], {"period": -1}),
    "fill_null_forward": ("fill_null_forward", ["i64"], {}),
    "fill_null_backward-str": ("fill_null_backward", ["str"], {}),
    # conditional
    "case_when-else": ("case_when", [B("mask", "mask2"), "i64", "ties",
                                     S(0)], {}),
    "case_when-no-else": ("case_when", [B("mask", "mask2"), "str", "str2"],
                          {}),
    "choose": ("choose", ["idx", "i64", "ties", "small"], {}),
    "replace_with_mask": ("replace_with_mask", ["i64", "mask", "small"], {}),
    "inverse_permutation": ("inverse_permutation", ["perm"],
                            {"max_index": 4}),
    # set lookup
    "is_in-null-member": ("is_in", ["i64"], {"value_set": [3, 7, None]}),
    "is_in-skip_nulls": ("is_in", ["i64"], {"value_set": [3, 7, None],
                                            "skip_nulls": True}),
    "is_in-u64": ("is_in", ["u64"], {"value_set": [2 ** 64 - 1, 3]}),
    "is_in-str": ("is_in", ["str"], {"value_set": ["b", "zz"]}),
    "index_in": ("index_in", ["i64"], {"value_set": [7, 3, None, 3]}),
    "index_in-nan": ("index_in", ["f32"], {"value_set": [NAN, 1.5]}),
    # run ends
    "run_end_encode-int16": ("run_end_encode", ["ties"],
                             {"run_end_type": "int16"}),
}

def _dtype(pkg, kind):
    return getattr(pkg, "bool_" if kind == "bool" else kind)


def _arg(pkg, inp, token):
    if isinstance(token, str):
        return inp[token]
    kind = token[0]
    if kind == "scalar":
        _, value, t = token
        if t is None:
            return pkg.scalar(value)
        return pkg.scalar(value, _dtype(pkg, t))
    if kind == "batch":
        return pkg.RecordBatch(tuple(inp[k] for k in token[1:]), token[1:])
    return inp["encoded:" + token[1]]


def _with_encoded(pkg, inp):
    """The inputs and the dictionary-encoded ones the cases name (made
    outside the traced calls: encoding sizes its pool on the host)."""
    for case in CASES.values():
        for t in case[1]:
            if isinstance(t, tuple) and t[0] == "encoded":
                inp["encoded:" + t[1]] = pkg.call_function(
                    "dictionary_encode", [inp[t[1]]])
    return inp


def _options(pkg, name, options):
    options = dict(options)
    if name == "cast":
        target = _dtype(pkg, options.pop("target"))
        opts = pkg.compute.CastOptions
        return {"options": opts.safe(target) if options.pop("safe", True)
                else opts.unsafe(target)}
    if name == "run_end_encode" and "run_end_type" in options:
        options["run_end_type"] = _dtype(pkg, options["run_end_type"])
    return options


def _call(pkg, inp, case):
    name, tokens, options = CASES[case]
    return pkg.call_function(name, [_arg(pkg, inp, t) for t in tokens],
                             **_options(pkg, name, options))


def _port_inputs():
    return _with_encoded(pt, {k: pt.interop.column_from_arrow(a, device="cpu")
                              for k, a in INPUTS.items()})


def reference_answers() -> dict:
    """The JAX package's answer to every case."""
    import arrow1_tpu.compute  # noqa: F401  (the options classes)

    calls = {case: (lambda inp, case=case: _call(a1t, inp, case))
             for case in CASES}
    inputs = _with_encoded(a1t, {k: a1t.column(a)
                                 for k, a in INPUTS.items()})
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return arrow_answers(jax_answers(calls, inputs))


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


def _port(case):
    try:
        return _call(pt, _port_inputs(), case)
    except (Invalid, IndexError_, NotImplementedError) as e:
        return type(e)


@pytest.mark.parametrize("case", list(CASES))
def test_tail_matches_the_reference(case, jax_results):
    got, want = _port(case), jax_results[case]
    if isinstance(want, type):
        assert isinstance(got, type), (case, "should raise", got)
        return
    assert not isinstance(got, type), (case, got)
    assert_same(got, want, case, 16 if CASES[case][0] == "rank_normal"
                else 4)


# ---- where pyarrow decides (ROADMAP Queue 3) ------------------------------

def _pa_col(values, type_=None):
    return pa.array(values, type_)


PYARROW_CASES = {
    # the JAX package's _checked scans and differences never raise
    "cumulative_sum_checked": (
        "cumulative_sum_checked", [_pa_col([2 ** 62, 2 ** 62], pa.int64())],
        {}),
    "cumulative_prod_checked": (
        "cumulative_prod_checked", [_pa_col([2 ** 40, 2 ** 30], pa.int64())],
        {}),
    "cumulative_sum_checked-u8": (
        "cumulative_sum_checked", [_pa_col([200, None, 100], pa.uint8())],
        {"skip_nulls": True}),
    "pairwise_diff_checked": (
        "pairwise_diff_checked", [_pa_col([-(2 ** 63), 1], pa.int64())],
        {"period": -1}),
    # NaN skipped by the running min and max; the min starts at the
    # largest finite value
    "cumulative_min-nan": (
        "cumulative_min", [_pa_col([NAN, 1.0, float("inf"), 0.5])], {}),
    "cumulative_max-nan": (
        "cumulative_max", [_pa_col([1.0, NAN, -3.0, 3.0], pa.float32())],
        {"skip_nulls": True}),
    # element-wise: NaN skipped, the first of equal zeros kept
    "min_element_wise-nan": (
        "min_element_wise", [_pa_col([NAN, 0.0, -0.0, None]),
                             _pa_col([1.0, -0.0, 0.0, NAN])], {}),
    "max_element_wise-nan": (
        "max_element_wise", [_pa_col([NAN, 2.0, -1.0, NAN], pa.float32()),
                             _pa_col([1.0, NAN, None, NAN], pa.float32())],
        {}),
    "sign-zero": ("sign", [_pa_col([-0.0, 0.0, NAN, -3.0])], {}),
    # set lookup by bits: 0.0 is not -0.0
    "is_in-signed-zero": ("is_in", [_pa_col([0.0, -0.0, NAN, None])],
                          {"value_set": pa.array([-0.0, NAN])}),
    # run ends by bits: NaN runs merge, 0.0 and -0.0 split
    "run_end_encode-floats": (
        "run_end_encode", [_pa_col([1.0, NAN, NAN, -0.0, 0.0, None, None])],
        {}),
    # a numeric dictionary decodes to its values
    "dictionary_decode-numeric": (
        "dictionary_decode",
        [_pa_col([5, 7, 5, None], pa.int64()).dictionary_encode()], {}),
    # integers round to a multiple exactly
    "round_to_multiple-u64": (
        "round_to_multiple", [_pa_col([2 ** 63 + 5, 7], pa.uint64())], {}),
    "round_to_multiple-i8": (
        "round_to_multiple", [_pa_col([5, 15, -25, 7, None], pa.int8())],
        {"multiple": 10}),
    # scatter: an index out of range raises; the last of repeated wins
    "scatter-out-of-range": (
        "scatter", [_pa_col([1, 2, 3]), _pa_col([0, 5, 2])],
        {"max_index": 3}),
    "scatter-repeated": (
        "scatter", [_pa_col([1, None, 3]), _pa_col([0, 0, 2])],
        {"max_index": 3}),
    # mode: NaN after the numbers, 0.0 and -0.0 one value
    "mode-nan": ("mode", [_pa_col([1.5, None, -2.25, -0.0, NAN],
                                  pa.float32())], {}),
    "mode-zeros": ("mode", [_pa_col([-0.0, 1.0, 0.0])], {}),
}


def _pyarrow_options(name, options):
    if name == "scatter":
        return {"max_index": options["max_index"]}
    return options


def _to_port(x):
    if isinstance(x, pa.Array) and pa.types.is_dictionary(x.type):
        p = pt.interop.column_from_arrow(x.dictionary, device="cpu")
        codes = pt.interop.column_from_arrow(x.indices, device="cpu")
        pool = pt.column.Dictionary(x.dictionary.to_numpy(
            zero_copy_only=False))
        return pt.Column(codes.data, dt.dictionary(dt.int32, p.dtype),
                         validity=codes.validity, dictionary=pool)
    return pt.interop.column_from_arrow(x, device="cpu")


@pytest.mark.parametrize("case", list(PYARROW_CASES))
def test_pyarrow_decides(case):
    name, args, options = PYARROW_CASES[case]
    try:
        want = pc.call_function(name, args, pc.FunctionOptions if False
                                else None) if not options else \
            getattr(pc, name)(*args, **_pyarrow_options(name, options))
    except (pa.ArrowInvalid, pa.ArrowIndexError) as e:
        want = type(e)
    port_args = [_to_port(a) for a in args]
    if isinstance(want, type):
        with pytest.raises((Invalid, IndexError_)):
            pt.call_function(name, port_args, **options)
        return
    got = pt.call_function(name, port_args, **options)
    if name in ("mode", "run_end_encode"):
        from test_torch_registry_sweep import as_arrow, same_value
        g = as_arrow(got).to_pylist()
        w = as_arrow(want)
        w = w.to_pylist() if hasattr(w, "to_pylist") else w
        assert same_value(g, w), (case, g, w)
        return
    assert_same(got, want, case, 0)


# ---- Expression methods and rewrites --------------------------------------

def _batches():
    keys = ["i64", "u64", "f64", "str", "bool"]
    return (a1t.RecordBatch(tuple(a1t.column(INPUTS[k]) for k in keys),
                            tuple(keys)),
            pt.RecordBatch(tuple(_port_inputs()[k] for k in keys),
                           tuple(keys)))


EXPRESSIONS = {
    "is_valid": lambda m: m.field("f64").is_valid(),
    "is_null-nan": lambda m: m.field("f64").is_null(nan_is_null=True),
    "is_nan": lambda m: m.field("f64").is_nan(),
    "isin": lambda m: m.field("i64").isin([3, 0, 9]),
    "isin-str": lambda m: m.field("str").isin(["a", "zz"]),
    "cast": lambda m: m.field("i64").cast(m.float64),
    "cast-unsafe": lambda m: m.field("f64").cast(m.int8, safe=False),
    "filter": lambda m: (m.field("f64").is_valid()
                         & m.field("i64").isin([3, -5, 0])
                         & ~m.field("u64").is_null()),
}


@pytest.mark.parametrize("case", list(EXPRESSIONS))
def test_expression_methods_match_the_reference(case):
    jb, pb = _batches()
    want = EXPRESSIONS[case](a1t).execute(jb)
    got = EXPRESSIONS[case](pt).execute(pb)
    assert repr(EXPRESSIONS[case](pt)) == repr(EXPRESSIONS[case](a1t))
    assert_same(got, want, case, 0)


REWRITES = {
    "fold": (lambda m: m.field("x") > (m.literal(2) + 3), None),
    "fold-nested": (lambda m: (m.literal(2) * 3 == 6) & m.field("y"), None),
    "guarantee-drops-conjunct": (
        lambda m: (m.field("year") == 2021) & (m.field("x") > 1),
        lambda m: m.field("year") == 2021),
    "guarantee-false": (
        lambda m: (m.field("year") == 2020) & (m.field("x") > 1),
        lambda m: (m.field("year") == 2021) & (m.field("m") == 3)),
    "guarantee-or-true": (
        lambda m: (m.field("m") == 3) | (m.field("x") > 1),
        lambda m: m.field("m") == 3),
    "guarantee-none": (lambda m: m.field("x") > 1,
                       lambda m: m.field("year") > 2020),
}


@pytest.mark.parametrize("case", list(REWRITES))
def test_fold_and_simplify_match_the_reference(case):
    expr, guarantee = REWRITES[case]
    for mod, pkg in ((jexpr, a1t), (pexpr, pt)):
        if guarantee is None:
            out = mod.fold_constants(expr(pkg))
        else:
            out = mod.simplify_with_guarantee(expr(pkg), guarantee(pkg))
        if mod is jexpr:
            want = repr(out)
        else:
            assert repr(out) == want, (case, repr(out), want)


def test_query_filter_on_the_new_methods_launches_k2(monkeypatch):
    """The slice's query shape through ``query()``: a filter of is_valid,
    isin and is_null, a cast and a fill_null; on the CPU the filter's K2
    call takes its plain version, counted here."""
    from arrow1_tpu_torch.kernels import compaction
    from arrow1_tpu_torch.ops import selection

    calls = []

    def counted(mask, cols, out_limit=None):
        calls.append(mask.shape[0])
        return compaction.compact_plain(mask, cols, out_limit)

    monkeypatch.setattr(selection, "compact", counted)
    rng = np.random.default_rng(3)
    n = 64
    key = rng.integers(0, 8, n)
    v = rng.integers(-50, 50, n)
    f = rng.standard_normal(n)
    f[::7] = np.nan
    vnull = rng.random(n) < 0.2
    fnull = rng.random(n) < 0.1
    t = pt.interop.table_from_arrow(pa.table({
        "key": pa.array(key), "v": pa.array(v, mask=vnull),
        "f": pa.array(f, mask=fnull)}), device="cpu")
    out = (pt.query(t)
           .filter(pt.field("f").is_valid() & pt.field("key").isin([1, 3, 5])
                   & ~pt.field("v").is_null())
           .project([pt.field("v").cast(pt.float64),
                     pt.call("fill_null", [pt.field("f"), 0.0])],
                    ["vf", "f0"])
           .to_table())
    keep = ~fnull & np.isin(key, [1, 3, 5]) & ~vnull
    got = pt.interop.table_to_arrow(out)
    assert got.column("vf").to_pylist() == v[keep].astype(float).tolist()
    np.testing.assert_array_equal(got.column("f0").to_numpy(), f[keep])
    assert calls, "the filter made no K2 call"


# ---- random ---------------------------------------------------------------

def test_random_is_held_to_its_properties():
    """Uniform [0, 1) float64 of the asked length; one seed gives the same
    numbers twice, another seed others (JAX's threefry bits are not
    reproduced)."""
    def draw(seed, n=4096):
        return pt.call_function("random", [], length=n, initializer=seed,
                                device="cpu")

    a, b, c = draw(7), draw(7), draw(8)
    assert a.dtype == dt.float64 and a.length == 4096 and a.validity is None
    assert torch.equal(a.data, b.data) and not torch.equal(a.data, c.data)
    x = a.data.numpy()
    assert x.min() >= 0.0 and x.max() < 1.0
    assert abs(x.mean() - 0.5) < 4 * math.sqrt(1 / 12 / x.size)
    ref = a1t.call_function("random", [], length=16, initializer=7)
    assert ref.length == draw(7, 16).length == 16
    assert draw(None, 3).length == 3 and draw("system", 0).length == 0
