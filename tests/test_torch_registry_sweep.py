"""Registry-wide differential sweep of the port (the twin of
tests/test_registry_sweep.py): every compute function that both packages
register, called with copies of each of eight small typed columns with
nulls (i64, u8, u64, f32 and f64 with NaN and -0.0, bool, a dictionary
string, a decimal128(15, 2)), as many as it takes arguments (two for a varargs function), one
test case per name (``random``, which takes no column, has its own test).
The 42 temporal names take a date32 and a timestamp[us] column (with the
reference tests' edge dates) instead (strptime the string column); the two
interval results pyarrow cannot hold in Python (month_interval,
day_time_interval) are compared as their storage integers and masks.

The port must give the JAX package's answer: the same arrow type, nulls
and integers exactly, floats within ULPS units in the last place (the two
packages' libm differ in transcendental functions), or raise where the
JAX package raises (over the decimal column, an error of the same class).
Where the JAX package is wrong against pyarrow.compute
(ROADMAP Queue 3, ``REFERENCE_FAULTS``) the port must give pyarrow's
answer instead. Where the JAX package accepts a type that pyarrow rejects
(``abs`` of bool, ``sign`` of a string), the port may reject it too.

The JAX answers are computed once (fixture ``jax_results``) by
``jax_answers``: the JAX package compiles every eager operation on first
use and shape, so the calls run traced, many to one ``jax.jit`` program,
with the reference's host-side error checks deferred (their flags come out
of the program and are read after it); the calls that cannot be traced
(their output sizes depend on the data) run eagerly. That work runs in a
worker process (tests/test_torch_answers.py) that starts with the
first port test file's fixture, and the answers come back as pyarrow
values. For the functions of
earlier slices those untraceable calls (the scalar aggregates and
``filter``) are held here against pyarrow; their JAX answers are held in
tests/test_torch_groupby.py and tests/test_torch_compaction.py.
"""

import contextlib
import math
from decimal import Decimal
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import arrow1_tpu as a1t
import arrow1_tpu.ops.arithmetic as jarith
import arrow1_tpu.ops.bitwise as jbitwise
import arrow1_tpu.ops.cast as jcast
import arrow1_tpu.ops.math as jmath
from arrow1_tpu.errors import A1TError as JError
from arrow1_tpu.registry import function_registry as jax_registry

import arrow1_tpu_torch as pt
from arrow1_tpu_torch.errors import A1TError
from arrow1_tpu_torch.registry import function_registry as port_registry
from test_torch_answers import answers_of

ULPS = 4
# wider bounds, each measured: XLA's sinh and cosh of large arguments (200)
# differ from libm's (torch's, pyarrow's) by about 100 ulps, and ndtri by
# up to 5
ULP_BOUNDS = {"sinh": 256, "cosh": 256, "rank_normal": 16}
NAN = float("nan")
COLUMNS = {
    "i64": pa.array([3, None, -5, 7, 0], pa.int64()),
    "u8": pa.array([3, None, 5, 7, 200], pa.uint8()),
    "u64": pa.array([3, None, 2**63 + 5, 0, 2**64 - 1], pa.uint64()),
    "f32": pa.array([1.5, None, -2.25, -0.0, NAN], pa.float32()),
    "f64": pa.array([1.5, None, -0.0, NAN, 0.0]),
    "bool": pa.array([True, None, False, True, False]),
    "str": pa.array(["b", None, "a", "b", ""]),
    "dec": pa.array([Decimal("1.50"), None, Decimal("-2.25"), Decimal("0.00"),
                     Decimal("99999.99")], pa.decimal128(15, 2)),
}
TEMPORAL_COLUMNS = {
    "d32": pa.array([-165, None, 18321, 0, 18686], pa.date32()),
    "ts": pa.array([-14182939876544, None, 1583020799999999,
                    1615689000000000, 7], pa.timestamp("us")),
}
ALL_COLUMNS = {**COLUMNS, **TEMPORAL_COLUMNS}
# the names of ops/temporal.py, swept over the temporal columns
TEMPORAL_NAMES = frozenset((
    "assume_timezone", "ceil_temporal", "day", "day_of_week", "day_of_year",
    "day_time_interval_between", "days_between", "floor_temporal", "hour",
    "hours_between", "is_dst", "is_leap_year", "iso_calendar", "iso_week",
    "iso_year", "local_timestamp", "microsecond", "microseconds_between",
    "millisecond", "milliseconds_between", "minute", "minutes_between",
    "month", "month_day_nano_interval_between", "month_interval_between",
    "nanosecond", "nanoseconds_between", "quarter", "quarters_between",
    "round_temporal", "second", "seconds_between", "strftime", "strptime",
    "subsecond", "us_week", "us_year", "week", "weeks_between", "year",
    "year_month_day", "years_between"))
# results pyarrow has no Python type for: storage integers and mask
RAW_RESULTS = {"month_interval_between", "day_time_interval_between"}
# struct-shaped results: the packages give RecordBatches of the same
# fields, compared as such by the function's own tests
STRUCT_RESULTS = {"min_max", "mode", "first_last", "value_counts",
                  "run_end_encode", "iso_calendar", "year_month_day"}
# (name, column) -> why the JAX package's answer is wrong; pyarrow decides
# (ROADMAP Queue 3)
REFERENCE_FAULTS = {
    ("cumulative_max", "f32"): "NaN propagates; pyarrow skips it",
    ("cumulative_min", "f32"): "NaN propagates; pyarrow skips it",
    ("cumulative_max", "f64"): "NaN propagates; pyarrow skips it",
    ("cumulative_min", "f64"): "NaN propagates; pyarrow skips it",
    ("cumulative_min", "u64"): "raises OverflowError",
    ("cumulative_max", "u64"): "raises OverflowError",
    ("max_element_wise", "f32"): "NaN propagates, -0.0 < 0.0",
    ("min_element_wise", "f32"): "NaN propagates, -0.0 < 0.0",
    ("max_element_wise", "f64"): "NaN propagates, -0.0 < 0.0",
    ("min_element_wise", "f64"): "NaN propagates, -0.0 < 0.0",
    ("sign", "f32"): "sign(-0.0) is -0.0, pyarrow's 0.0",
    ("sign", "f64"): "sign(-0.0) is -0.0, pyarrow's 0.0",
    ("index_in_meta_binary", "f64"): "0.0 matches -0.0",
    ("is_in_meta_binary", "f64"): "0.0 matches -0.0",
    ("pairwise_diff_checked", "u8"): "no overflow check",
    ("pairwise_diff_checked", "u64"): "no overflow check",
    ("pairwise_diff_checked", "i64"): "no overflow check",
    ("round_to_multiple", "u64"): "rounds through float64",
    ("run_end_encode", "f32"): "NaN runs split, 0.0 == -0.0",
    ("run_end_encode", "f64"): "NaN runs split, 0.0 == -0.0",
    ("sign", "dec"): "int8; pyarrow's sign of a decimal is int64",
}
_TRACE_ERRORS = (jax.errors.ConcretizationTypeError,
                 jax.errors.NonConcreteBooleanIndexError,
                 jax.errors.TracerArrayConversionError,
                 jax.errors.TracerIntegerConversionError,
                 jax.errors.TracerBoolConversionError)


class _DeferredChecks:
    """The reference's host-side error checks, deferred out of a trace:
    ``_raise_if`` (arithmetic, cast) and ``bool(jnp.any(flag))`` (math,
    bitwise) record the flag of the call being traced, and return as if
    nothing was wrong; the flags leave the program as outputs, and a call
    whose flag is set raised."""

    def __init__(self):
        self.key = None
        self.flags = {}

    def raise_if(self, flag, message, validity):
        if validity is False:
            return
        if validity is not None:
            flag = flag & validity
        self.flags.setdefault(self.key, []).append(jnp.any(flag))

    def jnp_proxy(self):
        checks = self

        class _Flag:
            def __init__(self, flag):
                self.flag = flag

            def __bool__(self):
                checks.flags.setdefault(checks.key, []).append(self.flag)
                return False

        class _Jnp:
            def __getattr__(self, name):
                return getattr(jnp, name)

            @staticmethod
            def any(x, *a, **k):
                return _Flag(jnp.any(x, *a, **k))

        return _Jnp()

    @contextlib.contextmanager
    def patched(self):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jarith, "_raise_if", self.raise_if)
            mp.setattr(jcast, "_raise_if", self.raise_if)
            for mod in (jmath, jbitwise):
                mp.setattr(mod, "jnp", self.jnp_proxy())
            yield


def _is_array_tree(out) -> bool:
    return all(isinstance(x, (jax.Array, np.ndarray, np.generic, bool, int,
                              float))
               for x in jax.tree_util.tree_leaves(out))


def jax_answers(calls, inputs, chunk=48, eager=None):
    """The JAX package's answer to every call: key -> result, or the
    exception class it raised. ``calls`` maps a key to a function of the
    ``inputs`` pytree (a dict of the package's columns and batches). The
    traceable calls run ``chunk`` to one ``jax.jit`` program; a call that
    cannot be traced runs eagerly when ``eager(key)`` is true (default:
    always), and is left out of the answers otherwise."""
    answers = {}
    untraced = []
    keys = list(calls)
    for lo in range(0, len(keys), chunk):
        part = keys[lo:lo + chunk]
        checks = _DeferredChecks()
        raised = {}

        def program(inp, part=part, checks=checks, raised=raised):
            outs = {}
            for key in part:
                checks.key = key
                try:
                    out = calls[key](inp)
                except _TRACE_ERRORS:
                    untraced.append(key)
                    checks.flags.pop(key, None)
                    continue
                except Exception as e:   # noqa: BLE001 (the class is kept)
                    raised[key] = type(e)
                    checks.flags.pop(key, None)
                    continue
                if _is_array_tree(out):
                    outs[key] = out
                else:
                    untraced.append(key)
                    checks.flags.pop(key, None)
            flags = {k: jnp.stack(v).any() for k, v in checks.flags.items()}
            return outs, flags

        with checks.patched():
            outs, flags = jax.jit(program)(inputs)
        answers.update(raised)
        for key, out in outs.items():
            answers[key] = JError if bool(flags.get(key, False)) else out
    for key in untraced:
        if eager is not None and not eager(key):
            continue
        try:
            answers[key] = calls[key](inputs)
        except Exception as e:   # noqa: BLE001
            answers[key] = type(e)
    return answers


# ---- comparison -----------------------------------------------------------

def as_arrow(x):
    """A result of either package (or pyarrow) as a pyarrow value (a
    run-end-encoded array as its {run_ends, values} rows)."""
    if isinstance(x, pa.RunEndEncodedArray):
        return pa.RecordBatch.from_arrays([x.run_ends, x.values],
                                          ["run_ends", "values"])
    if hasattr(x, "to_arrow"):
        x = x.to_arrow()
    elif hasattr(x, "as_py"):
        return x.as_py()
    if isinstance(x, pa.ChunkedArray):
        x = x.combine_chunks()
    if isinstance(x, pa.Array) and pa.types.is_dictionary(x.type):
        x = x.cast(x.type.value_type)
    if isinstance(x, pa.Scalar):
        return x.as_py()
    return x


def _ulps(a: float, b: float, width: int) -> float:
    ftype = np.float32 if width == 4 else np.float64
    itype = np.int32 if width == 4 else np.int64
    ia, ib = (int(np.array(v, ftype).view(itype)) for v in (a, b))
    # map to a monotonic integer line (negative floats count down)
    ia = ia if ia >= 0 else -(ia & (2 ** (8 * width - 1) - 1))
    ib = ib if ib >= 0 else -(ib & (2 ** (8 * width - 1) - 1))
    return abs(ia - ib)


def same_value(got, want, width=8, ulps=ULPS) -> bool:
    if isinstance(got, float) and isinstance(want, float):
        if math.isnan(got) or math.isnan(want):
            return math.isnan(got) and math.isnan(want)
        if math.isinf(got) or math.isinf(want) or got == 0 or want == 0:
            return got == want and math.copysign(1, got) == \
                math.copysign(1, want)
        return _ulps(got, want, width) <= ulps
    if isinstance(got, dict) and isinstance(want, dict):
        return got.keys() == want.keys() and all(
            same_value(got[k], want[k], width, ulps) for k in got)
    if isinstance(got, list) and isinstance(want, list):
        return len(got) == len(want) and all(
            same_value(g, w, width, ulps) for g, w in zip(got, want))
    return type(got) is type(want) and got == want


def assert_same(got, want, label="", ulps=ULPS):
    """``got`` (the port's result) equals ``want`` (an arrow value or
    result of the JAX package or pyarrow): arrow type, validity and
    values."""
    g, w = as_arrow(got), as_arrow(want)
    width = 8
    if isinstance(w, (pa.Array, pa.RecordBatch, pa.Table)):
        assert type(g) is type(w), (label, g, w)
        if isinstance(w, pa.Array):
            assert g.type == w.type, (label, g.type, w.type)
            if pa.types.is_float32(w.type):
                width = 4
        else:
            assert g.schema.names == w.schema.names, label
        g, w = g.to_pylist(), w.to_pylist()
    assert same_value(g, w, width, ulps), (label, g, w)


def arrow_answers(answers: dict) -> dict:
    """Answers as picklable values: pyarrow values, Python values, or the
    exception class a call raised (an answer that cannot be read counts
    as its call failing)."""
    out = {}
    for key, value in answers.items():
        try:
            out[key] = value if isinstance(value, type) else as_arrow(value)
        except Exception as e:   # noqa: BLE001
            out[key] = type(e)
    return out


# ---- the sweep ------------------------------------------------------------

def _shared_names():
    return sorted(set(port_registry.list_functions()) &
                  set(jax_registry.list_functions()))


def _arity(name) -> int:
    """Copies of the column a sweep call takes: varargs functions two."""
    arity = jax_registry.get(name).arity
    return 2 if arity < 0 else arity


def _sweep_names():
    # random takes no column: its properties are tested on their own
    return [n for n in _shared_names() if n != "random"]


def _keys(name):
    """The columns a name is swept over."""
    if name == "strptime":
        return ("str", "d32")
    return ("d32", "ts") if name in TEMPORAL_NAMES else tuple(COLUMNS)


def _storage(col):
    """A column as its storage integers and mask (``RAW_RESULTS``)."""
    return {"data": col.data, "valid": col.mask()}


def _storage_lists(x):
    return {k: np.asarray(v.cpu() if hasattr(v, "cpu") else v).tolist()
            for k, v in x.items()}


def with_byte_matrices(inputs: dict) -> dict:
    """The JAX package caches a pool's byte matrix on its Dictionary when
    a string kernel first needs it; built inside a trace, that array
    would leak into the next program. So the inputs' matrices are built
    here, outside any trace."""
    from arrow1_tpu.ops.strings_device import byte_matrix

    for col in inputs.values():
        if getattr(col, "dictionary", None) is not None and \
                len(col.dictionary):
            byte_matrix(col.dictionary)
    return inputs


def _reference_inputs():
    return with_byte_matrices({key: a1t.column(arr)
                               for key, arr in ALL_COLUMNS.items()})


def reference_answers() -> dict:
    """The JAX package's answer to every sweep call."""
    new_names = set(pt.list_functions()) - set(_EARLIER_SLICES)
    calls = {}
    sets = _reference_inputs()   # concrete value sets: read on the host
    for name in _sweep_names():
        arity = _arity(name)
        for key in _keys(name):
            if name.endswith("_meta_binary"):
                calls[(name, key)] = (lambda inp, name=name, key=key:
                                      a1t.call_function(
                                          name, [inp[key], sets[key]]))
                continue
            if name in RAW_RESULTS:
                calls[(name, key)] = (lambda inp, name=name, key=key, a=arity:
                                      _storage(a1t.call_function(
                                          name, [inp[key]] * a)))
                continue
            calls[(name, key)] = (lambda inp, name=name, key=key, a=arity:
                                  a1t.call_function(name, [inp[key]] * a))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        answers = arrow_answers(jax_answers(
            calls, _reference_inputs(), eager=lambda k: k[0] in new_names))
    return {k: _storage_lists(v) if k[0] in RAW_RESULTS and
            isinstance(v, dict) else v for k, v in answers.items()}


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


# the 74 names of the slices before this sweep: their untraceable calls
# are held against pyarrow here (module docstring)
_EARLIER_SLICES = (
    "add", "add_checked", "all", "and", "and_kleene", "and_not",
    "and_not_kleene", "any", "approximate_median", "array_sort_indices",
    "count", "count_all", "count_distinct", "dictionary_encode", "divide",
    "divide_checked", "equal", "filter", "first", "first_last", "greater",
    "greater_equal", "hash_all", "hash_any", "hash_approximate_median",
    "hash_count", "hash_count_all", "hash_count_distinct", "hash_first",
    "hash_first_last", "hash_kurtosis", "hash_last", "hash_max",
    "hash_mean", "hash_min", "hash_min_max", "hash_one", "hash_product",
    "hash_skew", "hash_stddev", "hash_sum", "hash_variance", "index",
    "invert", "kurtosis", "last", "less", "less_equal", "max", "mean",
    "min", "min_max", "mode", "multiply", "multiply_checked", "negate",
    "negate_checked", "not_equal", "or", "or_kleene", "product",
    "quantile", "skew", "sort_indices", "stddev", "subtract",
    "subtract_checked", "sum", "take", "unique", "value_counts",
    "variance", "winsorize", "xor")


def _port_column(key):
    return pt.interop.column_from_arrow(ALL_COLUMNS[key], device="cpu")


def _pyarrow(name, key, arity):
    try:
        return pc.call_function(name, [ALL_COLUMNS[key]] * arity)
    except Exception as e:   # noqa: BLE001
        return type(e)


def _rows(x):
    """A struct result as a list of row dicts (a struct scalar is one)."""
    x = x.to_pylist() if hasattr(x, "to_pylist") else x
    return [x] if isinstance(x, dict) else x


def _port(name, key, arity):
    try:
        out = pt.call_function(name, [_port_column(key)] * arity)
        return _storage_lists(_storage(out)) if name in RAW_RESULTS else out
    except (A1TError, TypeError, ValueError, IndexError, KeyError,
            OverflowError, NotImplementedError) as e:
        return type(e)


def test_the_sweep_covers_every_shared_name():
    assert len(_EARLIER_SLICES) == 74
    assert set(_EARLIER_SLICES) <= set(pt.list_functions())
    # 173 + 73 string names + 42 temporal names + tdigest + the 18 names
    # of the nested slice
    assert len(pt.list_functions()) == 307
    assert set(NESTED_SLICE) <= set(pt.list_functions())
    assert TEMPORAL_NAMES <= set(pt.list_functions())


def test_the_two_registries_hold_the_same_names():
    assert set(pt.list_functions()) == set(a1t.list_functions())


# the 18 names of ROADMAP Queue 1 item 9 (nested types); the sweep calls
# them over flat columns, which they refuse or (make_struct, the
# whitespace splits) take: their nested cases are in test_torch_nested.py
NESTED_SLICE = (
    "list_element", "list_flatten", "list_parent_indices", "list_slice",
    "list_value_length", "make_struct", "struct_field", "map_lookup",
    "split_pattern", "split_pattern_regex", "ascii_split_whitespace",
    "utf8_split_whitespace", "binary_join", "hash_list", "hash_distinct",
    "hash_tdigest", "hash_pivot_wider", "pivot_wider")


@pytest.mark.parametrize("name", _sweep_names())
def test_port_matches_the_reference(name, jax_results):
    arity = _arity(name)
    compared = 0
    for key in _keys(name):
        label = (name, key)
        got = _port(name, key, arity)
        want = jax_results.get(label, None)
        if want is None:   # untraceable, earlier slice: pyarrow decides
            want = _pyarrow(name, key, arity)
            if isinstance(want, type):
                continue   # pyarrow rejects it; the JAX tests hold it
        elif label in REFERENCE_FAULTS:
            want = _pyarrow(name, key, arity)
        elif isinstance(got, type) and not isinstance(want, type):
            # the JAX package takes a type that pyarrow rejects (abs of
            # bool, sign of a string): the port may reject it too
            assert isinstance(_pyarrow(name, key, arity), type), \
                (label, got, want)
            continue
        if isinstance(want, type):
            assert isinstance(got, type), (label, "should raise", got)
            if key == "dec" and want is not AssertionError:
                # the decimal column: the same error class (a deferred
                # check raises the base class; an AssertionError is the
                # JAX package's own failure, not an error it raises)
                assert want.__name__ in [c.__name__ for c in got.__mro__], \
                    (label, got, want)
            continue
        assert not isinstance(got, type), (label, got, want)
        if name in RAW_RESULTS:
            assert got == want, (label, got, want)
        elif name in STRUCT_RESULTS:
            got, want = (_rows(as_arrow(x)) for x in (got, want))
            assert same_value(got, want), (label, got, want)
        else:
            assert_same(got, want, label, ULP_BOUNDS.get(name, ULPS))
        compared += 1
    if name not in ("hash_one",):
        assert compared or all(
            isinstance(_pyarrow(name, k, arity), type)
            for k in _keys(name)), name
