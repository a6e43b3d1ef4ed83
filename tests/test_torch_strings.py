"""Strings in the port (arrow1_tpu_torch/ops/strings*.py, the string
compares of ops/compare.py and the string casts of ops/cast.py) held
against the JAX package on the CPU.

The inputs are made from a seed with numpy: dictionary-encoded columns
over pools of ASCII words, TPC-H's ship modes and customer names,
non-ASCII UTF-8 (accents, CJK, the simple case maps of 'ß' and 'İ',
a title-case digraph), the empty string and whitespace, with nulls and
values that no row uses. Every one of the 73 string names runs its call
of ``arrow1_tpu_torch.compute_strings.CALLS``, and a few more options
(ignore_case, empty patterns, scalar counts, null handling) run as extra
cases; then the six compares (column against column, against a scalar in
and out of the pool, a scalar against a column) and the string casts.
Strings, codes, validity and integers must be equal exactly: no case has
a tolerance. Where the JAX package is wrong against pyarrow.compute
(ROADMAP Queue 3, ``REFERENCE_FAULTS``) the port is held to pyarrow.

``extract_regex`` gives a struct of one string field per named group and
``extract_regex_span`` a struct of one fixed_size_list<int32>[2] per
group, both held as arrow values against the JAX package's structs. The
split family and ``binary_join`` (list inputs and results) are held in
tests/test_torch_nested.py.

The JAX answers are computed once, by the sweep's ``jax_answers`` (the
calls traced to a few ``jax.jit`` programs, the rest eagerly), in a
worker process (tests/test_torch_answers.py).
"""

import warnings

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import arrow1_tpu as a1t

import arrow1_tpu_torch as pt
from arrow1_tpu_torch import compute_strings as cs
from arrow1_tpu_torch.errors import Invalid
from test_torch_answers import answers_of
from test_torch_registry_sweep import (arrow_answers, assert_same,
                                       jax_answers, with_byte_matrices)

ROWS = 48
POOL = ["AIR", "REG AIR", "MAIL", "Customer#000000001", "Customer#000123459",
        "", "  padded\t", "Hello World", "hello", "HELLO", "Title Case",
        "x1y2z3", "0042", "-17", "ß straße", "İstanbul", "ǉubljana",
        "café", "Ça va", "日本語", "ab🙂cd", "١٢٣", "UNUSED", "also unused"]
ASCII = ["AIR", "RAIL", "Customer#000000777", "", " lead", "trail ", "MiXeD",
         "a#b#c", "42", "UNUSED"]
SECOND = ["SHIP", "TRUCK", "FOB", "", "é", "Customer#000000042"]
NUMBERS = ["1", "-2", "0x1F", "1e3", "2.5", "nan", "-inf", "true", "FALSE",
           "0", "9223372036854775807", "bad", "", "UNUSED"]
INTS = ["1", "-2", "0", "127", "-128", "9223372036854775807", "0x1F", "x"]
SMALL = ["1", "0", "127", "42", "0x7f", "18446744073709551615"]
FLOATS = ["1.5", "-0", "nan", "-inf", "1e3", ".5", "2", "inf", "1E-2", "?"]
BOOLS = ["true", "FALSE", "1", "0", "True", "yes"]
# the codes of NUMBERS that float64 cannot parse
NOT_FLOATS = [2, 7, 8, 11, 12]


def _dict_column(pool, seed, used, null_share=0.15, rows=ROWS):
    """A DictionaryArray over ``pool`` whose rows use its first ``used``
    values (the rest stay in the pool unused), with nulls."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, used, rows).astype(np.int32)
    mask = rng.random(rows) < null_share
    return pa.DictionaryArray.from_arrays(
        pa.array(codes, mask=mask), pa.array(pool, pa.string()))


INPUTS = {
    "s": _dict_column(POOL, 1, len(POOL) - 2),
    "a": _dict_column(ASCII, 2, len(ASCII) - 1),
    "t": _dict_column(SECOND, 3, len(SECOND)),
    "num": _dict_column(NUMBERS, 4, 11),
    "ints": _dict_column(INTS, 8, len(INTS) - 1),
    "small": _dict_column(SMALL, 9, 5),
    "floats": _dict_column(FLOATS, 10, len(FLOATS) - 1),
    "bools": _dict_column(BOOLS, 11, len(BOOLS) - 1),
    "n": pa.array(np.random.default_rng(5).integers(0, 3, ROWS)),
    "i": pa.array(np.random.default_rng(6).integers(-9, 9, ROWS),
                  mask=np.random.default_rng(7).random(ROWS) < 0.1),
    "f": pa.array([1.5, -0.0, 0.0, float("nan"), 1e20, 1e-7, -2.25,
                   123456789012.0] * (ROWS // 8)),
    "f32": pa.array([1.5, -0.0, 3.25, 1e-3] * (ROWS // 4), pa.float32()),
    "b": pa.array([True, None, False] * (ROWS // 3)),
}


def S(value):
    """A scalar argument."""
    return ("scalar", value)


# id -> (function, arguments, options): every CALLS entry, then more
CASES = {name: (name, list(args), options)
         for name, (args, options) in cs.CALLS.items()}
CASES.update({
    "match_substring-ignore_case": ("match_substring", ["s"],
                                    {"pattern": "air", "ignore_case": True}),
    "starts_with-ignore_case": ("starts_with", ["s"],
                                {"pattern": "HEL", "ignore_case": True}),
    "ends_with-ignore_case": ("ends_with", ["s"],
                              {"pattern": "SE", "ignore_case": True}),
    "match_like-ignore_case": ("match_like", ["s"],
                               {"pattern": "c%", "ignore_case": True}),
    "match_substring-empty": ("match_substring", ["s"], {"pattern": ""}),
    "count_substring-empty": ("count_substring", ["s"], {"pattern": ""}),
    "find_substring-empty": ("find_substring", ["s"], {"pattern": ""}),
    "count_substring-overlap": ("count_substring", ["a"], {"pattern": "#"}),
    "find_substring-long": ("find_substring", ["a"],
                            {"pattern": "Customer#000000777!"}),
    "count_substring-ignore_case": ("count_substring", ["s"],
                                    {"pattern": "A", "ignore_case": True}),
    "starts_with-longer": ("starts_with", ["a"],
                           {"pattern": "Customer#0000007770"}),
    "ascii_trim-none": ("ascii_trim", ["a"], {"characters": ""}),
    "ascii_trim_whitespace-ascii": ("ascii_trim_whitespace", ["a"], {}),
    "ascii_upper-ascii": ("ascii_upper", ["a"], {}),
    "ascii_title-ascii": ("ascii_title", ["a"], {}),
    "ascii_is_title-ascii": ("ascii_is_title", ["a"], {}),
    "ascii_reverse-utf8": ("ascii_reverse", ["s"], {}),
    "binary_repeat-scalar": ("binary_repeat", ["s", S(2)], {}),
    "binary_join-skip": ("binary_join_element_wise", ["s", "t", S("+")],
                         {"null_handling": "skip"}),
    "binary_join-replace": ("binary_join_element_wise", ["s", "t", "a"],
                            {"null_handling": "replace",
                             "null_replacement": "?"}),
    "replace_substring-max": ("replace_substring", ["s"],
                              {"pattern": "l", "replacement": "L",
                               "max_replacements": 1}),
    "utf8_slice_codeunits-step": ("utf8_slice_codeunits", ["s"],
                                  {"start": -1, "stop": None, "step": -2}),
    "utf8_normalize-nfkc": ("utf8_normalize", ["s"], {"form": "NFKC"}),
    "extract_regex-none": ("extract_regex", ["s"], {"pattern": "[a-z]"}),
    "match_substring_regex-lookahead": ("match_substring_regex", ["s"],
                                        {"pattern": "a(?=b)"}),
    "numeric-string": ("utf8_is_numeric", ["num"], {}),
})
# the compares: each op over a column pair, the pool, scalars in and out
COMPARES = ("equal", "not_equal", "less", "less_equal", "greater",
            "greater_equal")
for _op in COMPARES:
    CASES[f"{_op}-columns"] = (_op, ["s", "t"], {})
    CASES[f"{_op}-itself"] = (_op, ["s", "s"], {})
    CASES[f"{_op}-in-pool"] = (_op, ["s", S("MAIL")], {})
    CASES[f"{_op}-not-in-pool"] = (_op, ["s", S("M")], {})
    CASES[f"{_op}-scalar-first"] = (_op, [S("hello"), "s"], {})
    CASES[f"{_op}-number"] = (_op, ["s", "i"], {})
# the casts: string -> numeric and bool, numeric and bool -> string
CASTS = {
    "num-int64": ("num", "int64"), "num-float64": ("num", "float64"),
    "num-bool": ("num", "bool_"), "num-int8": ("num", "int8"),
    "num-uint64": ("num", "uint64"), "s-int64": ("s", "int64"),
    "ints-int64": ("ints", "int64"), "ints-int8": ("ints", "int8"),
    "small-int8": ("small", "int8"), "small-uint8": ("small", "uint8"),
    "ints-float64": ("ints", "float64"), "floats-float64": ("floats",
                                                              "float64"),
    "floats-float32": ("floats", "float32"), "bools-bool": ("bools",
                                                            "bool_"),
    "s-large_string": ("s", "large_string"), "s-binary": ("s", "binary"),
    "i-string": ("i", "string"), "f-string": ("f", "string"),
    "f32-string": ("f32", "string"), "b-string": ("b", "string"),
    "n-large_string": ("n", "large_string"),
}
for _case, (_key, _target) in CASTS.items():
    CASES[f"cast-{_case}"] = ("cast", [_key], {"target": _target})
# a live row holds only parseable values: the bad ones are unused or null
CASES["cast-num-live-rows"] = ("cast", ["num-ok"], {"target": "float64"})

# where the JAX package is wrong (ROADMAP Queue 3): case -> (function,
# the input strings, options, what the JAX package gives); the port is
# held to pyarrow's answer on the same input
_LONG = ["ab", "c", None]
REFERENCE_FAULTS = {
    # a pattern two or more bytes longer than every value: the JAX
    # package's byte matrix cannot shift that far and raises TypeError
    "starts_with-long-pattern": ("starts_with", _LONG, {"pattern": "abcd"},
                                 TypeError),
    "ends_with-long-pattern": ("ends_with", _LONG, {"pattern": "abcd"},
                               TypeError),
    "match_substring-long-pattern": ("match_substring", _LONG,
                                     {"pattern": "abcd"}, TypeError),
    "count_substring-long-pattern": ("count_substring", _LONG,
                                     {"pattern": "abcd"}, TypeError),
    "find_substring-long-pattern": ("find_substring", _LONG,
                                    {"pattern": "abcd"}, TypeError),
}


def _num_ok():
    """``num`` with every row that holds a value float64 cannot parse
    nulled."""
    arr = INPUTS["num"]
    bad = np.isin(np.asarray(arr.indices.fill_null(0)), NOT_FLOATS)
    return pa.DictionaryArray.from_arrays(
        pa.array(np.asarray(arr.indices.fill_null(0)),
                 mask=np.asarray(arr.is_null()) | bad), arr.dictionary)


def _inputs(pkg, column):
    arrays = dict(INPUTS, **{"num-ok": _num_ok()})
    return {key: column(arr) for key, arr in arrays.items()}


def _arg(pkg, inp, token):
    if isinstance(token, tuple):
        return pkg.scalar(token[1])
    return inp[token] if token in inp else token


def _call(pkg, inp, case):
    name, tokens, options = CASES[case]
    options = dict(options)
    if name == "cast":
        target = getattr(pkg, options.pop("target"))
        options = {"options": pkg.compute.CastOptions.safe(target)}
    return pkg.call_function(name, [_arg(pkg, inp, t) for t in tokens],
                             **options)


def reference_answers() -> dict:
    """The JAX package's answer to every case."""
    import arrow1_tpu.compute  # noqa: F401  (the options classes)

    calls = {case: (lambda inp, case=case: _call(a1t, inp, case))
             for case in CASES}
    inputs = _inputs(a1t, a1t.column)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return arrow_answers(jax_answers(calls, with_byte_matrices(inputs)))


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


@pytest.fixture(scope="module")
def port_inputs():
    import arrow1_tpu_torch.compute  # noqa: F401  (the options classes)

    return _inputs(pt, lambda a: pt.interop.column_from_arrow(a,
                                                               device="cpu"))


def _port(inp, case):
    try:
        return _call(pt, inp, case)
    except (Invalid, NotImplementedError, TypeError) as e:
        return type(e)


@pytest.mark.parametrize("case", list(CASES))
def test_strings_match_the_reference(case, jax_results, port_inputs):
    got, want = _port(port_inputs, case), jax_results[case]
    if isinstance(want, type):
        assert isinstance(got, type), (case, "should raise", got)
        return
    assert not isinstance(got, type), (case, got, want)
    if CASES[case][0] in ("extract_regex", "extract_regex_span"):
        assert isinstance(got, pt.StructColumn), case
    assert_same(got, want, case)


def test_every_string_name_has_a_case():
    strings = {n for n in pt.list_functions()
               if pt.registry.function_registry.get(n).exec.__module__
               == "arrow1_tpu_torch.ops.strings"}
    # the split family and binary_join take or give lists: their cases
    # are in tests/test_torch_nested.py
    lists = {"split_pattern", "split_pattern_regex",
             "ascii_split_whitespace", "utf8_split_whitespace",
             "binary_join"}
    assert strings == set(cs.CALLS) | lists
    assert len(cs.CALLS) == 73 and len(strings) == 78


def test_a_string_compared_with_a_number_raises(port_inputs):
    for op in COMPARES:
        with pytest.raises(Invalid):
            pt.call_function(op, [port_inputs["s"], port_inputs["i"]])


def test_unparseable_live_rows_raise_like_pyarrow(port_inputs):
    with pytest.raises(Invalid):
        pt.ops.cast.cast(port_inputs["num"], pt.float64)
    with pytest.raises(pa.ArrowInvalid):
        pc.cast(INPUTS["num"], pa.float64())
    got = pt.ops.cast.cast(port_inputs["num-ok"], pt.float64)
    assert_same(got, pc.cast(_num_ok(), pa.float64()), "live rows")


def test_transforms_merge_equal_values_like_pyarrow(port_inputs):
    """ascii_lower maps AIR, air and Air to one value: the port's pool
    holds it once, so a group_by and an equality see one string, as in
    pyarrow. The JAX package keeps three codes of "air": its equal gives
    [False, False, True, None, False] and its group_by three groups
    (ROADMAP Queue 3)."""
    col = pt.interop.column_from_arrow(pa.array(["AIR", "air", "Air", None,
                                                 "RAIL"]), device="cpu")
    low = pt.call_function("ascii_lower", [col])
    assert len(low.dictionary) == 2
    assert pt.call_function("equal", [low, "air"]).to_pylist() == \
        [True, True, True, None, False]
    rb = pt.RecordBatch((low, pt.interop.column_from_arrow(
        pa.array([1, 2, 3, 4, 5]), device="cpu")), ("k", "v"))
    out = pt.interop.record_batch_to_arrow(
        pt.group_by(rb, ["k"], [("v", "sum")]))
    assert sorted(zip(out.column("k").to_pylist(),
                      out.column("v_sum").to_pylist()), key=repr) == \
        [("air", 6), ("rail", 5), (None, 4)]


def test_binary_repeat_of_a_null_count_is_null():
    """pyarrow nulls a row whose count is null; the JAX package repeats
    the value 0 times there, "" (ROADMAP Queue 3)."""
    strs = pa.array(["ab", "c", None, "d"])
    counts = pa.array([2, None, 1, 0])
    got = pt.call_function("binary_repeat", [
        pt.interop.column_from_arrow(strs, device="cpu"),
        pt.interop.column_from_arrow(counts, device="cpu")])
    assert got.to_pylist() == pc.binary_repeat(strs, counts).to_pylist() \
        == ["abab", None, None, ""]


@pytest.mark.parametrize("case", list(REFERENCE_FAULTS))
def test_pyarrow_decides(case):
    name, values, options, jax_gives = REFERENCE_FAULTS[case]
    arr = pa.array(values)
    with pytest.raises(jax_gives):
        a1t.call_function(name, [a1t.column(arr)], **options)
    got = pt.call_function(
        name, [pt.interop.column_from_arrow(arr, device="cpu")], **options)
    assert_same(got, pc.call_function(
        name, [arr], pc.MatchSubstringOptions(**options)), case)
