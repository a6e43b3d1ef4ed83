"""Five results where the port differed from the JAX package, held
against it and against pyarrow on inputs of a few rows:

- unsigned (uint16, uint32, uint64) add, subtract, multiply, divide, the
  checked forms and the order compares, which torch cannot compute in
  those types (the port computes them in int64);
- the sign of zero in the scalar min, max and min_max of floats;
- a dense-path group_by on a nullable string key, read back to pyarrow;
- the three ingest functions of ``interop``, which must want CUDA unless
  the caller names the CPU (``tests/test_torch_import.py``);
- sort_indices of a uint64 column.

Integers, bools, validity and the sign of zero must match exactly. Where
the JAX package and pyarrow disagree, pyarrow decides, and the test says
which case that is. The JAX package's answers are computed once, in a
module fixture.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pytest

import arrow1_tpu as a1t

import arrow1_tpu_torch as pt
from arrow1_tpu_torch.errors import Invalid

UNSIGNED = ["uint16", "uint32", "uint64"]
ARITH = ["add", "subtract", "multiply", "divide"]
COMPARE = ["less", "less_equal", "greater", "greater_equal", "equal",
           "not_equal"]
CHECKED = ["add_checked", "subtract_checked", "multiply_checked",
           "divide_checked"]
X, Y = [3, 1], [1, 2]

# (function, values): the scalar aggregate of a float64 column and the
# sign pyarrow gives; "agrees" says whether the JAX package gives it too
ZERO_CASES = [
    ("min", [-0.0, 0.0], -1.0, True),
    ("max", [0.0, -0.0], 1.0, True),
    # pyarrow keeps the first of values that tie; the JAX package orders
    # -0.0 below +0.0 (ROADMAP, reference deviations)
    ("min", [0.0, -0.0], 1.0, False),
    ("max", [-0.0, 0.0], -1.0, False),
    # NaN is skipped unless every value is NaN, and a null is ignored
    ("min", [float("nan"), 0.0, -0.0], 1.0, False),
    ("max", [float("nan"), -0.0, 0.0], -1.0, False),
    ("min", [None, -0.0, 0.0], -1.0, True),
]

STRING_KEY = ["b", "a", None, "c", "a", "b"]
U64_SORT = [(1 << 63) + 5, 3, None, (1 << 64) - 1]


def _ref_call(fn, args):
    """The JAX package's result as a list, or the exception it raised."""
    try:
        return a1t.call_function(fn, args).to_pylist()
    except Exception as e:   # the reference's raise is the answer
        return e


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's answers, computed on a thread pool: it compiles
    every operation on first use, and independent compiles overlap."""
    jobs = {}
    for ty in UNSIGNED:
        jb = a1t.record_batch({"x": np.array(X, ty), "y": np.array(Y, ty)})
        for fn in ARITH + COMPARE + CHECKED:
            jobs[ty, fn] = lambda fn=fn, jb=jb: _ref_call(
                fn, [jb["x"], jb["y"]])
    for fn, values, _, _ in ZERO_CASES:
        col = a1t.record_batch(pa.record_batch(
            {"f": pa.array(values, pa.float64())}))["f"]
        jobs[fn, tuple(map(str, values))] = \
            lambda fn=fn, col=col: a1t.call_function(fn, [col]).as_py()
    jobs["group_by"] = lambda: a1t.interop.record_batch_to_arrow(
        a1t.group_by(a1t.record_batch(pa.record_batch(
            {"s": pa.array(STRING_KEY), "k": pa.array(np.arange(6))})),
            ["s"], [("k", "count")]))
    jobs["sort"] = lambda: a1t.call_function("sort_indices", [
        a1t.record_batch(pa.record_batch(
            {"u": pa.array(U64_SORT, pa.uint64())}))["u"]]).to_pylist()
    with ThreadPoolExecutor(8) as ex:
        futures = {key: ex.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


def _port_pair(ty):
    tb = pt.record_batch({"x": np.array(X, ty), "y": np.array(Y, ty)},
                         device="cpu")
    return tb["x"], tb["y"]


@pytest.mark.parametrize("fn", ARITH + COMPARE)
@pytest.mark.parametrize("ty", UNSIGNED)
def test_unsigned_arithmetic_and_compares_match_jax(ty, fn, jax_results):
    got = pt.call_function(fn, list(_port_pair(ty)))
    want = getattr(pc, fn)(pa.array(X, ty), pa.array(Y, ty))
    assert got.dtype.kind == str(want.type)
    assert got.to_pylist() == want.to_pylist() == jax_results[ty, fn]


@pytest.mark.parametrize("fn", CHECKED)
@pytest.mark.parametrize("ty", UNSIGNED)
def test_unsigned_checked_arithmetic_matches_jax(ty, fn, jax_results):
    """subtract_checked([3, 1], [1, 2]) overflows in every unsigned type;
    the other three give values."""
    want = jax_results[ty, fn]
    if isinstance(want, Exception):
        assert "overflow" in str(want)
        with pytest.raises(pa.ArrowInvalid, match="overflow"):
            getattr(pc, fn)(pa.array(X, ty), pa.array(Y, ty))
        with pytest.raises(Invalid, match="overflow"):
            pt.call_function(fn, list(_port_pair(ty)))
    else:
        assert pt.call_function(fn, list(_port_pair(ty))).to_pylist() == \
            want == getattr(pc, fn)(pa.array(X, ty),
                                    pa.array(Y, ty)).to_pylist()


def _extremes(ty):
    hi = np.iinfo(ty).max
    return [0, 1, 2, 3, 7, hi // 2, hi // 2 + 1, hi - 1, hi]


@pytest.mark.parametrize("ty", UNSIGNED)
def test_unsigned_extremes_match_pyarrow(ty):
    """Every pair of values from 0 to the type's top, both halves of the
    uint64 range included (where int64 division and compares would be
    wrong): values, wraparound and each checked overflow as pyarrow."""
    vals = _extremes(ty)
    x = np.repeat(np.array(vals, ty), len(vals))
    y = np.tile(np.array(vals, ty), len(vals))
    tb = pt.record_batch({"x": x, "y": y}, device="cpu")
    for fn in ["add", "subtract", "multiply"] + COMPARE:
        assert pt.call_function(fn, [tb["x"], tb["y"]]).to_pylist() == \
            getattr(pc, fn)(pa.array(x), pa.array(y)).to_pylist(), fn
    nz = y != 0
    tz = pt.record_batch({"x": x[nz], "y": y[nz]}, device="cpu")
    assert pt.call_function("divide", [tz["x"], tz["y"]]).to_pylist() == \
        pc.divide(pa.array(x[nz]), pa.array(y[nz])).to_pylist()
    with pytest.raises(Invalid, match="divide by zero"):
        pt.call_function("divide", [tb["x"], tb["y"]])
    for fn in ["add_checked", "subtract_checked", "multiply_checked"]:
        for i in range(len(x)):
            one = pt.record_batch({"x": x[i:i + 1], "y": y[i:i + 1]},
                                  device="cpu")
            try:
                want = getattr(pc, fn)(pa.array(x[i:i + 1]),
                                       pa.array(y[i:i + 1])).to_pylist()
            except pa.ArrowInvalid:
                with pytest.raises(Invalid, match="overflow"):
                    pt.call_function(fn, [one["x"], one["y"]])
            else:
                assert pt.call_function(
                    fn, [one["x"], one["y"]]).to_pylist() == want, \
                    (fn, x[i], y[i])


@pytest.mark.parametrize("fn,values,sign,agrees", ZERO_CASES)
def test_float_min_max_keep_the_sign_of_zero(fn, values, sign, agrees,
                                             jax_results):
    arr = pa.array(values, pa.float64())
    col = pt.record_batch(pa.record_batch({"f": arr}), device="cpu")["f"]
    got = pt.call_function(fn, [col]).as_py()
    assert np.copysign(1.0, getattr(pc, fn)(arr).as_py()) == sign
    assert got == 0.0 and np.copysign(1.0, got) == sign
    mm = pt.call_function("min_max", [col])[fn].to_pylist()[0]
    assert np.copysign(1.0, mm) == sign
    ref = jax_results[fn, tuple(map(str, values))]
    assert (np.copysign(1.0, ref) == sign) == agrees


def test_group_by_on_a_null_string_key_reads_back(jax_results):
    """The dense path puts the null key last, in key order; the JAX
    package takes its sorted path on the CPU (first-appearance order),
    so the groups are compared as sets."""
    rb = pa.record_batch({"s": pa.array(STRING_KEY),
                          "k": pa.array(np.arange(6))})
    got = pt.interop.record_batch_to_arrow(
        pt.group_by(pt.record_batch(rb, device="cpu"), ["s"],
                    [("k", "count")]))
    assert got.column("s").to_pylist() == ["b", "a", "c", None]
    assert got.column("k_count").to_pylist() == [2, 2, 1, 1]

    def groups(t):
        return sorted(zip(t.column("s").to_pylist(),
                          t.column("k_count").to_pylist()),
                      key=repr)

    want = pa.table(rb).group_by("s").aggregate([("k", "count")])
    assert groups(got) == groups(jax_results["group_by"]) == groups(want)


def test_sort_indices_of_uint64(jax_results):
    arr = pa.array(U64_SORT, pa.uint64())
    col = pt.record_batch(pa.record_batch({"u": arr}), device="cpu")["u"]
    got = pt.call_function("sort_indices", [col]).to_pylist()
    assert got == jax_results["sort"] == pc.sort_indices(arr).to_pylist() \
        == [1, 0, 3, 2]
    desc = pt.call_function("array_sort_indices", [col],
                            pt.ops.sort.ArraySortOptions("descending"))
    assert desc.to_pylist() == pc.array_sort_indices(
        arr, order="descending").to_pylist() == [3, 0, 1, 2]
