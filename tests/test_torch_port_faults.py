"""Results where the port differed from the JAX package or from
pyarrow, held against both on inputs of a few rows:

- unsigned (uint16, uint32, uint64) add, subtract, multiply, divide, the
  checked forms and the order compares, which torch cannot compute in
  those types (the port computes them in int64);
- the sign of zero in the scalar min, max and min_max of floats;
- a dense-path group_by on a nullable string key, read back to pyarrow;
- the three ingest functions of ``interop``, which must want CUDA unless
  the caller names the CPU (``tests/test_torch_import.py``);
- sort_indices of a uint64 column;
- grouped float sums (sum, mean, variance, stddev), which both packages
  took as a cumsum differenced across groups, so one group's magnitude,
  inf or NaN reached every group sorted after it; the eager grouped
  min/max of a group whose valid values are all NaN (NaN, not +-inf); and
  the compiled pipeline's grouped min/max, which must skip NaN as the
  eager path does. Held against pyarrow on the eager group_by (small and
  wide int64 keys), the hash_* entry points, the compiled pipeline and a
  two-batch query() and acero group_by, in float64 and float32;
- a pyarrow DictionaryArray through the three ingest functions (string
  and numeric pools); the dense-path integer mean, and the compiled and
  streaming ones, which divided the wrapped int64 sum; the compiled
  group_by's key of a group of -0.0 rows, which came out as 0.0;
- extract_regex and extract_regex_span, which gave RecordBatches (the
  span as ``g.offset``/``g.length`` columns) where the JAX package gives
  a struct column (of fixed_size_list<int32>[2] for the span);
- the null type, which the port lacked: an all-null CSV or JSON column
  was an all-null string column, ``scalar(None)`` was an int64 null and
  there was no ``NA``. Held against both packages and pyarrow through
  interop, IPC, CSV and JSON, and on a few calls over a null column.

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
import torch

import arrow1_tpu as a1t
from arrow1_tpu.exec.compiled import PipelineBuilder as JaxPipelineBuilder

import arrow1_tpu_torch as pt
import arrow1_tpu_torch.acero as acero
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.exec.streaming import StreamingGroupBy
from test_torch_answers import answers_of

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

NAN, INF = float("nan"), float("inf")
# Grouped float aggregates: groups 1-8 in pairs of cases, a null in group
# 2 and an all-null group 9. In key order a cumsum differenced across
# groups loses group 2's 3.0 under group 1's 2e20, and group 3's inf and
# group 5's NaN reach every group after them; group 5 is all NaN and
# group 7 holds one NaN beside 4.0.
FLOAT_K = [1, 2, 2, 1, 3, 4, 4, 3, 5, 6, 6, 5, 7, 8, 8, 7, 2, 9]
FLOAT_V = [1e20, 1.0, 2.0, 1e20, INF, 5.0, 5.0, INF, NAN, 3.0, 3.0, NAN,
           NAN, 7.0, 1.0, 4.0, None, None]
# the same order with keys far apart in int64
WIDE_KEYS = {1: -(1 << 62), 2: -(1 << 61), 3: -(1 << 40), 4: -1, 5: 0,
             6: 1 << 40, 7: 1 << 61, 8: 1 << 62, 9: (1 << 63) - 1}
FLOAT_AGGS = [("v", "sum"), ("v", "mean"), ("v", "variance"),
              ("v", "stddev"), ("v", "min"), ("v", "max")]
# pyarrow's answer, groups 1-9 (both dtypes: float32 holds every value
# but 1e20, which the float32 test reads from pyarrow)
FLOAT_WANT = {
    "v_sum": [2e20, 3.0, INF, 10.0, NAN, 6.0, NAN, 8.0, None],
    "v_mean": [1e20, 1.5, INF, 5.0, NAN, 3.0, NAN, 4.0, None],
    "v_variance": [0.0, 0.25, NAN, 0.0, NAN, 0.0, NAN, 9.0, None],
    "v_stddev": [0.0, 0.5, NAN, 0.0, NAN, 0.0, NAN, 3.0, None],
    "v_min": [1e20, 1.0, INF, 5.0, NAN, 3.0, 4.0, 1.0, None],
    "v_max": [1e20, 2.0, INF, 5.0, NAN, 3.0, 4.0, 7.0, None],
}
# The JAX package's compiled pipeline on the float64 batch (computed in
# ``jax_results``): the sums leak from group 2 on, and min/max keep NaN.
# Its eager group_by gives the same sums, means, stddevs and variances
# (but 0.0 for group 1's variance), and min/max equal to pyarrow's but
# for the all-NaN group 5, where it gives min = inf and max = -inf (as its
# hash_min_max does, also computed there).
FLOAT_JAX_PIPELINE = {
    "v_sum": [2e20, 0.0, INF, NAN, NAN, NAN, NAN, NAN, None],
    "v_mean": [1e20, 0.0, INF, NAN, NAN, NAN, NAN, NAN, None],
    "v_variance": [3.037860284270037e+23, 0.0] + [NAN] * 6 + [None],
    "v_stddev": [551167876809.7826, 0.0] + [NAN] * 6 + [None],
    "v_min": [1e20, 1.0, INF, 5.0, NAN, 3.0, NAN, 1.0, None],
    "v_max": [1e20, 2.0, INF, 5.0, NAN, 3.0, NAN, 7.0, None],
}
FLOAT_JAX_HASH_MIN_MAX = [(INF, -INF) if g == 5 else
                          (FLOAT_WANT["v_min"][g - 1],
                           FLOAT_WANT["v_max"][g - 1]) for g in range(1, 10)]

STRING_KEY = ["b", "a", None, "c", "a", "b"]
# dictionary-encoded keys (pyarrow DictionaryArrays) and the group sums
# of v = [1, 2, 3, 4] pyarrow gives over them
DICT_KEYS = {"string": ["a", "b", "a", None], "int": [10, 20, 10, None],
             "float": [1.5, 2.5, 1.5, None]}
# k = [1, 1], v = [2^62, 2^62 + 1]: the int64 sum wraps to -(2^63 - 1);
# the mean is of the exact sum, 2^62 + 0.5
WIDE_MEAN = 4.611686018427388e18
EXTRACT_INPUT = pa.array(["ab12", "x9", None, "cd", "é7", "ab12"])
EXTRACT_PATTERN = "(?P<letters>[a-zé]+)(?P<digits>[0-9])?"
NEG_ZERO = pa.record_batch({"f": pa.array([-0.0, 1.0, -0.0]),
                            "v": pa.array([1, 2, 3])})
U64_SORT = [(1 << 63) + 5, 3, None, (1 << 64) - 1]


def _ref_call(fn, args):
    """The JAX package's result as a list, or the exception it raised."""
    try:
        return a1t.call_function(fn, args).to_pylist()
    except Exception as e:   # the reference's raise is the answer
        return e


def reference_answers():
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
    fb = a1t.record_batch(_float_batch("float64", "small"))
    jobs["float_pipeline"] = lambda: a1t.interop.record_batch_to_arrow(
        JaxPipelineBuilder().group_by(["k"], FLOAT_AGGS).compile()(fb))
    jobs["float_hash_min_max"] = lambda: a1t.call_function(
        "hash_min_max", [fb["v"], fb["g"]]).to_pylist()
    for label, values in DICT_KEYS.items():
        jobs["dict", label] = lambda values=values: sorted(
            a1t.interop.record_batch_to_arrow(a1t.group_by(
                a1t.record_batch(_dict_batch(values)), ["k"],
                [("v", "sum")])).to_pylist(), key=repr)
    wide = a1t.record_batch(_wide_mean_batch())
    jobs["wide_mean"] = lambda: a1t.interop.record_batch_to_arrow(
        a1t.group_by(wide, ["k"], [("v", "mean"), ("v", "sum")])
    ).to_pydict()
    jobs["wide_mean_pipeline"] = lambda: a1t.interop.record_batch_to_arrow(
        JaxPipelineBuilder().group_by(["k"], [("v", "mean")]).compile()(
            wide)).to_pydict()
    nz = a1t.record_batch(NEG_ZERO)
    jobs["neg_zero"] = lambda: a1t.interop.record_batch_to_arrow(
        JaxPipelineBuilder().group_by(["f"], [("v", "sum")]).compile()(
            nz)).to_pydict()
    for fn in ("extract_regex", "extract_regex_span"):
        jobs[fn] = lambda fn=fn: a1t.call_function(
            fn, [a1t.column(EXTRACT_INPUT)],
            pattern=EXTRACT_PATTERN).to_arrow()
    with ThreadPoolExecutor(8) as ex:
        futures = {key: ex.submit(job) for key, job in jobs.items()}
        return {key: f.result() for key, f in futures.items()}


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


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


def _dict_batch(values):
    return pa.record_batch({"k": pa.array(values).dictionary_encode(),
                            "v": pa.array([1, 2, 3, 4])})


def _wide_mean_batch():
    return pa.record_batch({"k": pa.array([1, 1]),
                            "v": pa.array([2 ** 62, 2 ** 62 + 1])})


def _sorted_rows(rb):
    return sorted(rb.to_pylist(), key=repr)


@pytest.mark.parametrize("label", list(DICT_KEYS))
def test_dictionary_arrays_ingest(label, jax_results):
    """A pyarrow DictionaryArray ingests through all three interop entry
    points (a ChunkedArray of two dictionary chunks too) as a column of
    its value type, and groups as pyarrow groups it. The JAX package
    keeps a numeric pool's codes as the values (its groups come out as 0
    and 1): pyarrow decides (ROADMAP Queue 3)."""
    rb = _dict_batch(DICT_KEYS[label])
    want = _sorted_rows(pa.table(rb).group_by("k").aggregate(
        [("v", "sum")]).select(["v_sum", "k"]))
    col = pt.interop.column_from_arrow(rb.column(0), device="cpu")
    assert col.to_pylist() == DICT_KEYS[label]
    batch = pt.interop.record_batch_from_arrow(rb, device="cpu")
    got = _sorted_rows(pt.interop.record_batch_to_arrow(
        pt.group_by(batch, ["k"], [("v", "sum")])))
    assert got == want
    assert (jax_results["dict", label] == want) == (label == "string")
    table = pa.Table.from_batches([rb, _dict_batch(DICT_KEYS[label][::-1])])
    assert pt.interop.table_to_arrow(pt.interop.table_from_arrow(
        table, device="cpu")).column("k").to_pylist() == \
        table.column("k").cast(table.schema.field("k").type.value_type
                               ).to_pylist()
    chunked = pt.interop.column_from_arrow(table.column("k"), device="cpu")
    assert chunked.to_pylist() == DICT_KEYS[label] + DICT_KEYS[label][::-1]


def test_dense_integer_mean_is_of_the_exact_sum(jax_results):
    """The dense path (K3's plain version here), the compiled pipeline and
    StreamingGroupBy: the int64 sum wraps as pyarrow's does, the mean is
    the exact sum's. The JAX package's eager group_by takes its sorted
    path on the CPU and agrees; its compiled pipeline divides the wrapped
    sum (-4.61e18): pyarrow decides."""
    rb = _wide_mean_batch()
    want = pa.table(rb).group_by("k").aggregate([("v", "mean"),
                                                 ("v", "sum")])
    assert want.column("v_mean").to_pylist() == [WIDE_MEAN]
    b = pt.record_batch(rb, device="cpu")
    eager = pt.interop.record_batch_to_arrow(
        pt.group_by(b, ["k"], [("v", "mean"), ("v", "sum")])).to_pydict()
    assert eager["v_mean"] == [WIDE_MEAN] == jax_results["wide_mean"][
        "v_mean"]
    assert eager["v_sum"] == want.column("v_sum").to_pylist() == \
        jax_results["wide_mean"]["v_sum"]
    compiled = pt.interop.record_batch_to_arrow(
        pt.PipelineBuilder().group_by(["k"], [("v", "mean")]).compile()(b))
    assert compiled.column("v_mean").to_pylist() == [WIDE_MEAN]
    assert jax_results["wide_mean_pipeline"]["v_mean"] == [-WIDE_MEAN]
    stream = StreamingGroupBy(["k"], [("v", "mean"), ("v", "sum")])
    stream.consume(b)
    stream.consume(b)
    out = pt.interop.record_batch_to_arrow(stream.finalize()).to_pydict()
    assert out["v_mean"] == [WIDE_MEAN]
    assert out["v_sum"] == [2]   # 2 * (2^63 + 1) mod 2^64, as pyarrow's


def test_compiled_group_by_emits_the_first_rows_key(jax_results):
    """The compiled group_by ties -0.0 with 0.0 (matched behaviour) and
    emits the group's first row's key: -0.0 here, as the JAX package and
    pyarrow do."""
    b = pt.record_batch(NEG_ZERO, device="cpu")
    got = pt.interop.record_batch_to_arrow(
        pt.PipelineBuilder().group_by(["f"], [("v", "sum")]).compile()(b))
    want = pa.table(NEG_ZERO).group_by("f").aggregate([("v", "sum")])
    for out in (got.to_pydict(), jax_results["neg_zero"],
                want.to_pydict()):
        assert out["v_sum"] == [4, 2]
        assert [np.copysign(1.0, f) for f in out["f"]] == [-1.0, 1.0]


def _float_batch(ty, keys):
    """The grouped-float input: int64 key ``k`` (small, or ``WIDE_KEYS``),
    values ``v`` of type ``ty``, and int32 group ids ``g`` = k - 1."""
    k = FLOAT_K if keys == "small" else [WIDE_KEYS[x] for x in FLOAT_K]
    return pa.record_batch({"k": pa.array(k, pa.int64()),
                            "v": pa.array(FLOAT_V, ty),
                            "g": pa.array(np.array(FLOAT_K, np.int32) - 1)})


def _same(got, want):
    """Equal lists of floats and None, NaN equal to NaN."""
    return len(got) == len(want) and all(
        a == b or (a is not None and b is not None and a != a and b != b)
        for a, b in zip(got, want))


def _by_key(t, names, key="k"):
    """{column: values in ascending key order} of a pyarrow Table."""
    t = t.sort_by(key)
    return {n: t.column(n).to_pylist() for n in names}


def _pyarrow_float(rb, key="k", aggs=FLOAT_AGGS):
    return _by_key(pa.table(rb).group_by(key, use_threads=False).aggregate(
        aggs), [f"{c}_{f}" for c, f in aggs], key)


def _check_float_want(got, rb):
    want = _pyarrow_float(rb)
    for name, values in got.items():
        assert _same(values, want[name]), (name, values, want[name])
    if rb.schema.field("v").type == pa.float64():
        assert all(_same(want[n], FLOAT_WANT[n]) for n in want)


@pytest.mark.parametrize("keys", ["small", "wide"])
@pytest.mark.parametrize("ty", ["float64", "float32"])
def test_grouped_float_aggregates_match_pyarrow(ty, keys):
    """The eager group_by (the sorted path: the dense path declines float
    columns). The JAX package's answer on the float64 batch: sums as in
    FLOAT_JAX_PIPELINE, min/max of the all-NaN group +-inf."""
    rb = _float_batch(ty, keys)
    got = pt.interop.record_batch_to_arrow(pt.group_by(
        pt.record_batch(rb, device="cpu"), ["k"], FLOAT_AGGS))
    _check_float_want(_by_key(got, [f"v_{f}" for _, f in FLOAT_AGGS]), rb)


@pytest.mark.parametrize("ty", ["float64", "float32"])
def test_hash_float_aggregates_match_pyarrow(ty, jax_results):
    """The hash_* entry points over group ids (pyarrow's answer comes from
    its group_by on the same ids)."""
    rb = _float_batch(ty, "small")
    b = pt.record_batch(rb, device="cpu")
    want = _pyarrow_float(rb, key="g")
    for c, fn in FLOAT_AGGS:
        got = pt.call_function(f"hash_{fn}", [b["v"], b["g"]]).to_pylist()
        assert _same(got, want[f"v_{fn}"]), (fn, got)
    mm = pt.call_function("hash_min_max", [b["v"], b["g"]])
    got = list(zip(mm["min"].to_pylist(), mm["max"].to_pylist()))
    assert _same([x for p in got for x in p],
                 [x for p in zip(want["v_min"], want["v_max"]) for x in p])
    ref = jax_results["float_hash_min_max"]
    assert _same([x for d in ref for x in (d["min"], d["max"])],
                 [x for p in FLOAT_JAX_HASH_MIN_MAX for x in p])


@pytest.mark.parametrize("keys", ["small", "wide"])
@pytest.mark.parametrize("ty", ["float64", "float32"])
def test_compiled_float_aggregates_match_pyarrow(ty, keys, jax_results):
    """The compiled pipeline: per-group float sums, and min/max that skip
    NaN, equal to the eager group_by's. The JAX package's answer is
    FLOAT_JAX_PIPELINE."""
    rb = _float_batch(ty, keys)
    pipe = pt.PipelineBuilder().group_by(["k"], FLOAT_AGGS).compile()
    names = [f"v_{f}" for _, f in FLOAT_AGGS]
    got = _by_key(pt.interop.record_batch_to_arrow(
        pipe(pt.record_batch(rb, device="cpu"))), names)
    _check_float_want(got, rb)
    eager = _by_key(pt.interop.record_batch_to_arrow(pt.group_by(
        pt.record_batch(rb, device="cpu"), ["k"], FLOAT_AGGS)), names)
    assert all(_same(got[n], eager[n]) for n in ("v_min", "v_max"))
    ref = _by_key(jax_results["float_pipeline"], names)
    assert all(_same(ref[n], FLOAT_JAX_PIPELINE[n]) for n in names)


@pytest.mark.parametrize("ty", ["float64", "float32"])
def test_two_batch_float_group_by_matches_pyarrow(ty):
    """query() streams the batches (per-batch group_by, then a group_by
    that sums the partial sums); acero groups the combined batches. Rows
    0-8 and 9-17 split groups 2, 5 and 7 across the batches."""
    rb = _float_batch(ty, "small")
    aggs = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max")]
    names = [f"v_{f}" for _, f in aggs]
    table = pt.Table([pt.record_batch(rb.slice(0, 9), device="cpu"),
                      pt.record_batch(rb.slice(9), device="cpu")])
    want = _pyarrow_float(rb, aggs=aggs)
    streamed = pt.query(table).group_by(["k"], aggs).to_table().to_arrow()
    decl = acero.Declaration.from_sequence([
        acero.Declaration("table_source",
                          acero.TableSourceNodeOptions(table)),
        acero.Declaration("aggregate", acero.AggregateNodeOptions(
            aggs, keys=["k"]))])
    for out in (streamed, decl.to_table().to_arrow()):
        got = _by_key(out, names)
        assert all(_same(got[n], want[n]) for n in names), got


@pytest.mark.parametrize("ty", ["float64", "float32"])
def test_eager_and_compiled_group_by_agree_on_nan(ty):
    """60 rows of 8 keys with 10% NaN and 10% nulls: the eager and the
    compiled min/max are equal to each other and to pyarrow, the float sums
    and means equal pyarrow's bit for bit (both add a group's rows in row
    order), and the int64 sums, near +-2^62 so that they wrap, stay exact
    on both paths."""
    rng = np.random.default_rng(7)
    n = 60
    v = rng.standard_normal(n)
    v[rng.random(n) < 0.1] = np.nan
    rb = pa.record_batch({
        "k": pa.array(rng.integers(0, 8, n), pa.int64()),
        "v": pa.array(v.astype(ty), mask=rng.random(n) < 0.1),
        "w": pa.array(rng.integers(-(1 << 62), 1 << 62, n), pa.int64())})
    aggs = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max"),
            ("w", "sum")]
    names = [f"{c}_{f}" for c, f in aggs]
    b = pt.record_batch(rb, device="cpu")
    eager = _by_key(pt.interop.record_batch_to_arrow(
        pt.group_by(b, ["k"], aggs)), names)
    compiled = _by_key(pt.interop.record_batch_to_arrow(
        pt.PipelineBuilder().group_by(["k"], aggs).compile()(b)), names)
    want = _pyarrow_float(rb, aggs=aggs)
    for name in names:
        assert _same(eager[name], want[name]), name
        assert _same(compiled[name], want[name]), name


# ---- the two aggregate faults shared with the JAX package (ROADMAP Queue
# 3, faults 1-2): pyarrow's answers, hard-coded -------------------------

SKIP_NULLS_INPUT = [1.0, None, 3.0]
# function -> pyarrow's answer with skip_nulls=False (as_py)
SKIP_NULLS_FALSE = {
    "sum": None, "mean": None, "min": None, "max": None, "product": None,
    "variance": None, "stddev": None, "approximate_median": None,
    "skew": None, "kurtosis": None,
    "min_max": {"min": None, "max": None},
    "quantile": [None], "tdigest": [None], "mode": [],
}
# (values, function) -> pyarrow's answer: Kleene logic for any/all, and
# min_count read as pyarrow reads it
BOOL_AND_MIN_COUNT = [
    ([True, None], "all", {"skip_nulls": False}, None),
    ([True, None], "any", {"skip_nulls": False}, True),
    ([False, None], "any", {"skip_nulls": False}, None),
    ([False, None], "all", {"skip_nulls": False}, False),
    ([1.0, 2.0, 3.0], "sum", {"skip_nulls": False, "min_count": 5}, None),
    ([None, None], "sum", {"min_count": 0}, 0.0),
    ([None, None], "product", {"min_count": 0}, 1.0),
    ([1.0, None, 3.0], "sum", {}, 4.0),
]


def _agg_py(out):
    if hasattr(out, "to_pylist"):   # quantile/tdigest columns
        return out.to_pylist()
    if isinstance(out, pt.RecordBatch):   # min_max, mode
        rows = out.to_arrow().to_pylist()
        return rows[0] if out.names == ("min", "max") else rows
    return out.as_py()


@pytest.mark.parametrize("fn", list(SKIP_NULLS_FALSE))
def test_skip_nulls_false_gives_nulls_like_pyarrow(fn):
    """float64 [1.0, null, 3.0] with skip_nulls=False: null (mode: no
    row), as pyarrow gives; the JAX package ignored the option (sum 4.0,
    mean 2.0, ...)."""
    col = pt.interop.column_from_arrow(pa.array(SKIP_NULLS_INPUT),
                                       device="cpu")
    got = _agg_py(pt.call_function(fn, [col], skip_nulls=False))
    assert got == SKIP_NULLS_FALSE[fn], (fn, got)
    # and with the nulls skipped, a value
    kept = _agg_py(pt.call_function(fn, [col]))
    assert kept not in (None, [None], {"min": None, "max": None}, []), fn


@pytest.mark.parametrize("values,fn,options,want", BOOL_AND_MIN_COUNT)
def test_any_all_and_min_count_follow_pyarrow(values, fn, options, want):
    col = pt.interop.column_from_arrow(pa.array(
        values, pa.bool_() if fn in ("any", "all") else pa.float64()),
        device="cpu")
    assert pt.call_function(fn, [col], **options).as_py() == want


# k = [1, 1, 1], v = [1e9+1, 1e9+2, 1e9+3]: pyarrow's variance 2/3; s2/n -
# mean^2 cancels to 0.0. A second group of large values checks skew and
# kurtosis from central moments.
VAR_BATCH = pa.record_batch({
    "k": pa.array([1, 1, 1, 2, 2, 2, 2]),
    "v": pa.array([1e9 + 1, 1e9 + 2, 1e9 + 3,
                   1e12 + 1, 1e12 + 2, 1e12 + 4, 1e12 + 9])})
# pyarrow's answers, by key 1, 2
VAR_WANT = {
    "v_variance": [0.6666666666666666, 9.5],
    "v_stddev": [0.816496580927726, 3.082207001484488],
    "v_skew": [0.0, 0.7684172579878226],
    "v_kurtosis": [-1.5, -1.0],
}


@pytest.mark.parametrize("path", ["eager", "hash", "compiled", "int-key"])
def test_grouped_variance_does_not_cancel(path):
    """The grouped variance and stddev take two passes (the group's mean,
    then the squared deviations), skew and kurtosis central moments: equal
    to pyarrow on values near 1e9 and 1e12, where s2/n - mean^2 (both
    packages before) gives 0.0 and the raw power sums lose every digit."""
    b = pt.record_batch(VAR_BATCH, device="cpu")
    fns = ["variance", "stddev", "skew", "kurtosis"]
    if path in ("eager", "int-key"):
        keys = ["k"]
        if path == "int-key":   # an int64 value column: the same moments
            b = pt.record_batch(pa.record_batch({
                "k": VAR_BATCH["k"], "v": pa.array(
                    [int(x) for x in VAR_BATCH["v"].to_pylist()])}),
                device="cpu")
        got = _by_key(pt.interop.record_batch_to_arrow(pt.group_by(
            b, keys, [("v", f) for f in fns])), list(VAR_WANT))
    elif path == "hash":
        gids = pt.interop.column_from_arrow(pa.array(
            [x - 1 for x in VAR_BATCH["k"].to_pylist()], pa.int32()),
            device="cpu")
        got = {f"v_{f}": pt.call_function(f"hash_{f}", [b["v"], gids])
               .to_pylist() for f in fns}
    else:   # the compiled pipeline has variance and stddev
        fns = fns[:2]
        got = _by_key(pt.interop.record_batch_to_arrow(
            pt.PipelineBuilder().group_by(["k"], [("v", f) for f in fns])
            .compile()(b)), [f"v_{f}" for f in fns])
    for name, values in got.items():
        assert values == pytest.approx(VAR_WANT[name], rel=1e-12,
                                       abs=1e-12), (path, name, values)


@pytest.mark.parametrize("fn", ["extract_regex", "extract_regex_span"])
def test_extract_regex_gives_a_struct_column(fn, jax_results):
    """A struct column, field for field the JAX package's: the string
    groups, or each group's [byte offset, byte length] (a row that does
    not match is null; a group that took no part is [-1, 0])."""
    got = pt.call_function(fn, [pt.interop.column_from_arrow(
        EXTRACT_INPUT, device="cpu")], pattern=EXTRACT_PATTERN)
    assert isinstance(got, pt.StructColumn)
    want = jax_results[fn]
    assert got.to_arrow().type == want.type
    assert got.to_pylist() == want.to_pylist()
    rows = pc.call_function(fn, [EXTRACT_INPUT], pc.ExtractRegexOptions(
        EXTRACT_PATTERN)).to_pylist()
    if fn == "extract_regex_span":
        # pyarrow 25 gives null for a group that took no part in the
        # match; both packages give [-1, 0] (ROADMAP Queue 3)
        rows = [r if r is None else {g: [-1, 0] if v is None else v
                                     for g, v in r.items()} for r in rows]
    assert got.to_pylist() == rows


# ---- the faults repaired with the distributed slice (P1-P3, S8) ----------
# The JAX package agrees with pyarrow on P1-P3 (ROADMAP Queue 3), so these
# take pyarrow's answer; on S8 it keeps the fault and pyarrow decides.

DEC_TYPES = {"d128": pa.decimal128(15, 2), "d256": pa.decimal256(60, 6)}


def _dec(values, typ):
    from decimal import Decimal

    return pa.array([None if v is None else Decimal(v) for v in values],
                    typ)


def _arrow(x):
    """A port result as pyarrow rows, after a full validation."""
    out = x.to_arrow()
    out.validate(full=True)
    return out.to_pylist()


def _zero_row_paths(typ):
    """name -> (the port's result as rows, pyarrow's rows)."""
    import arrow1_tpu_torch.interop as io

    two = _dec(["1.00", "-2.50"], typ)
    empty = pa.array([], typ)
    nulls = pa.array([None, None], typ)
    tb = pa.table({"k": [1, 2, 1], "d": _dec(["1.00", "2.00", None], typ)})

    def col(a):
        return io.column_from_arrow(a, device="cpu")

    def q():
        return pt.query(io.table_from_arrow(tb, device="cpu")).filter(
            pt.field("k") > 5)

    none = tb.filter(pc.greater(tb["k"], 5))
    return {
        "filter": (lambda: _arrow(pt.filter(col(two), col(pa.array(
            [False, False])))), lambda: []),
        "query_select": (lambda: _arrow(q().select(["d"]).to_batch()),
                         lambda: none.select(["d"]).to_pylist()),
        "query_group_by": (
            lambda: _arrow(q().group_by(["d"], [("k", "sum")]).to_batch()),
            lambda: none.group_by("d").aggregate([("k", "sum")]).to_pylist()),
        "eager_group_by": (
            lambda: _arrow(pt.group_by(io.record_batch_from_arrow(
                none, device="cpu"), ["d"], [("k", "sum")])),
            lambda: none.group_by("d").aggregate([("k", "sum")]).to_pylist()),
        "negate": (lambda: _arrow(pt.call_function("negate", [col(empty)])),
                   lambda: pc.negate(empty).to_pylist()),
        "add": (lambda: _arrow(pt.call_function("add", [col(empty),
                                                        col(empty)])),
                lambda: pc.add(empty, empty).to_pylist()),
        "drop_null": (lambda: _arrow(pt.call_function("drop_null",
                                                      [col(empty)])),
                      lambda: pc.drop_null(empty).to_pylist()),
        "drop_null_all_null": (
            lambda: _arrow(pt.call_function("drop_null", [col(nulls)])),
            lambda: pc.drop_null(nulls).to_pylist()),
        "unique": (lambda: _arrow(pt.call_function("unique", [col(empty)])),
                   lambda: pc.unique(empty).to_pylist()),
        "mode": (lambda: _arrow(pt.call_function("mode", [col(empty)])),
                 lambda: pc.mode(empty).to_pylist()),
        "value_counts": (
            lambda: _arrow(pt.call_function("value_counts", [col(empty)])),
            lambda: pc.value_counts(empty).to_pylist()),
        "min_max": (lambda: _arrow(pt.call_function("min_max",
                                                    [col(empty)])),
                    lambda: [pc.min_max(empty).as_py()]),
        "min_max_all_null": (
            lambda: _arrow(pt.call_function("min_max", [col(nulls)])),
            lambda: [pc.min_max(nulls).as_py()]),
    }


ZERO_ROW_PATHS = list(_zero_row_paths(DEC_TYPES["d128"]))


@pytest.mark.parametrize("typ", list(DEC_TYPES))
@pytest.mark.parametrize("path", ZERO_ROW_PATHS)
def test_a_zero_row_decimal_column_leaves_the_port(path, typ):
    """P1: a decimal column of zero rows reaches pyarrow (and min_max of
    no valid value is {min: null, max: null})."""
    got, want = _zero_row_paths(DEC_TYPES[typ])[path]
    assert got() == want()


@pytest.mark.parametrize("null_in", ["second", "first"])
def test_query_group_by_of_a_null_string_key_over_two_batches(null_in):
    """P2: the null group's key code never indexes a pool's remap."""
    b1 = pa.record_batch({"s": ["x", "y", "x"], "v": [1, 2, 3]})
    b2 = pa.record_batch({"s": ["y", "z", None], "v": [10, 20, 30]})
    batches = [b1, b2] if null_in == "second" else [b2, b1]
    tb = pa.Table.from_batches(batches)
    got = pt.query(pt.interop.table_from_arrow(tb, device="cpu")).group_by(
        ["s"], [("v", "sum")]).to_batch()
    want = tb.group_by("s").aggregate([("v", "sum")])

    def rows(r):
        return sorted(repr(sorted(x.items())) for x in r)

    assert rows(_arrow(got)) == rows(want.to_pylist()) == rows(
        [{"s": "x", "v_sum": 4}, {"s": "y", "v_sum": 12},
         {"s": "z", "v_sum": 20}, {"s": None, "v_sum": 30}])


@pytest.mark.parametrize("fn", ["binary_join_element_wise", "binary_repeat"])
def test_zero_row_string_functions(fn):
    """P3: no reduction over zero rows."""
    empty = pa.array([], pa.string())
    args = [empty] * 3 if fn == "binary_join_element_wise" else \
        [empty, pa.array([], pa.int64())]
    got = pt.call_function(fn, [pt.interop.column_from_arrow(
        a, device="cpu") for a in args]).to_arrow()
    want = pc.call_function(fn, args)
    assert got.type == want.type == pa.string() and got.to_pylist() == []


# ROADMAP Queue 3 item 8's inputs: the probe side in two batches
S8_INPUTS = {
    "nulls": ([{"s": ["x", None, "x"], "v": [1, 2, 3]},
               {"s": ["y", "z", None], "v": [4, 5, 6]}],
              {"s": ["z", "x", None], "w": [7, 8, 9]}),
    "semi": ([{"s": ["x", "y"], "v": [1, 2]},
              {"s": ["x", "q"], "v": [3, 4]}],
             {"s": ["x", "z"], "w": [7, 8]}),
}
S8_TYPES = ["right outer", "right semi", "full outer", "right anti"]


def _s8_run(route, probe, build, join_type):
    from arrow1_tpu_torch.exec import plan

    if route == "query":
        return pt.query(probe).join(build, "s",
                                    join_type=join_type).to_batch()
    if route == "plan":
        p = plan.ExecPlan()
        sink = plan.sink_node(p, plan.join_node(
            p, plan.source_node(p, probe.batches),
            plan.source_node(p, [build]), ["s"], None, join_type))
        p.run()
        return sink.result.combine_chunks()
    return acero.Declaration("hashjoin", acero.HashJoinNodeOptions(
        join_type, ["s"], ["s"]), inputs=[
        acero.Declaration("table_source", acero.TableSourceNodeOptions(
            probe)),
        acero.Declaration("table_source", acero.TableSourceNodeOptions(
            build))]).to_batch()


@pytest.mark.parametrize("inputs", list(S8_INPUTS))
@pytest.mark.parametrize("join_type", S8_TYPES)
@pytest.mark.parametrize("route", ["query", "plan", "acero"])
def test_join_over_a_multi_batch_probe_side_matches_pyarrow(route, join_type,
                                                          inputs):
    """S8: the build side is built once and its rows come once (matched,
    or unmatched once), as pyarrow's Table.join gives them; rows compare
    as multisets."""
    probe_rows, build_rows = S8_INPUTS[inputs]
    tb = pa.Table.from_batches([pa.record_batch(b) for b in probe_rows])
    rb = pa.record_batch(build_rows)
    got = _s8_run(route, pt.interop.table_from_arrow(tb, device="cpu"),
                  pt.interop.record_batch_from_arrow(rb, device="cpu"),
                  join_type)
    want = tb.join(pa.Table.from_batches([rb]), "s", join_type=join_type)

    def rows(r):
        return sorted(repr(sorted(x.items())) for x in r)

    assert rows(_arrow(got)) == rows(want.to_pylist())


def test_a_multi_batch_join_builds_its_hash_table_once(monkeypatch):
    """S8: one hash-table build for the whole query (it was one a batch)."""
    import arrow1_tpu_torch.ops.join as ops_join

    builds = []
    real = ops_join._build_table

    def counting(*a):
        builds.append(1)
        return real(*a)

    monkeypatch.setattr(ops_join, "_build_table", counting)
    probe = pt.Table([pt.record_batch({"k": np.arange(i, i + 8)},
                                      device="cpu") for i in range(0, 40, 8)])
    build = pt.record_batch({"k": np.arange(0, 40, 3),
                             "w": np.arange(14)}, device="cpu")
    out = pt.query(probe).join(build, "k").to_batch()
    assert len(builds) == 1 and out.num_rows == 14


# ---- the null type (P4) ----

def _null_batches(kind, n, tmp_path):
    """(port, reference, pyarrow) tables of an int64 column "x" and a
    null column "n" of ``n`` rows, read through ``kind``."""
    from arrow1_tpu.io import csv as ref_csv, json as ref_json
    from arrow1_tpu.io import read_ipc as ref_read_ipc
    from pyarrow import csv as pacsv, json as pajson

    from arrow1_tpu_torch.interop import (record_batch_from_arrow,
                                          table_to_arrow)
    from arrow1_tpu_torch.io import csv as port_csv, json as port_json
    from arrow1_tpu_torch.io import read_ipc, write_ipc

    rb = pa.record_batch({"x": pa.array(range(n), pa.int64()),
                          "n": pa.nulls(n)})
    if kind == "interop":
        got = record_batch_from_arrow(rb, device="cpu")
        ref = a1t.record_batch(rb)
        return (pt.Table([got]).to_arrow(), ref.to_arrow(),
                pa.Table.from_batches([rb]))
    if kind == "ipc":   # two batches, the port's file and pyarrow's
        port_path, pa_path = tmp_path / "p.arrow", tmp_path / "a.arrow"
        port_rb = record_batch_from_arrow(rb, device="cpu")
        write_ipc(pt.Table([port_rb, port_rb]), str(port_path))
        with pa.ipc.new_file(str(pa_path), rb.schema) as w:
            w.write_batch(rb)
            w.write_batch(rb)
        from_pa = read_ipc(str(pa_path), device="cpu")
        assert table_to_arrow(from_pa).equals(
            pa.ipc.open_file(str(pa_path)).read_all())
        return (read_ipc(str(port_path), device="cpu").to_arrow(),
                ref_read_ipc(str(pa_path)).to_arrow(),
                pa.ipc.open_file(str(port_path)).read_all())
    if kind == "csv":
        data = ("x,n\n" + "".join(f"{i},\n" for i in range(n))).encode()
        return (port_csv.read_csv(data, device="cpu").to_arrow(),
                ref_csv.read_csv(data).to_arrow(),
                pacsv.read_csv(pa.BufferReader(data)))
    data = "".join(f'{{"x": {i}, "n": null}}\n' for i in range(n)).encode()
    return (port_json.read_json(data, device="cpu").to_arrow(),
            ref_json.read_json(data).combine_chunks().to_arrow(),
            pajson.read_json(pa.BufferReader(data)))


@pytest.mark.parametrize("n", [3, 0])
@pytest.mark.parametrize("kind", ["interop", "ipc", "csv", "json"])
def test_null_type_round_trips(kind, n, tmp_path):
    if kind == "json" and n == 0:
        n = 1   # pyarrow's JSON reader infers no column from no row
    got, ref, want = _null_batches(kind, n, tmp_path)
    assert got.schema.field("n").type == pa.null()
    assert ref.schema.field("n").type == pa.null()
    assert want.schema.field("n").type == pa.null()
    assert got.column("n").to_pylist() == [None] * want.num_rows
    assert got.column("x").to_pylist() == want.column("x").to_pylist()


def test_null_column_layout_and_scalars():
    col = pt.interop.column_from_arrow(pa.nulls(4), device="cpu")
    assert col.dtype == pt.null and col.dtype.is_null
    assert col.data.dtype == torch.int8 and not col.data.any()
    assert col.validity is not None and not col.validity.any()
    assert pt.scalar(None).dtype == pt.null
    assert not pt.scalar(None).is_valid
    assert a1t.scalar(None).dtype.kind == "null"
    assert pt.NA.dtype == pt.null and not pt.NA.is_valid
    assert a1t.NA.dtype.kind == "null"
    x = pt.interop.column_from_arrow(pa.array([1, 2], pa.int64()),
                                     device="cpu")
    got = pt.call_function("add", [x, pt.scalar(None)])
    want = pc.add(pa.array([1, 2], pa.int64()), pa.scalar(None))
    assert got.to_arrow().equals(want)


# name -> (port call, reference call, pyarrow answer); None as the
# reference's call: the JAX package raises, pyarrow decides (Queue 3)
_NULL_CALLS = {
    "is_null": ("is_null", None),
    "is_valid": ("is_valid", None),
    "take": ("take", [0, 2]),
    "filter": ("filter", [True, False, True, True]),
    "cast_int64": ("cast", "int64"),
    "cast_string": ("cast", "string"),
}
# the JAX package's cast of zero null rows gives one row
# (ops/cast.py: jnp.zeros(n or 1)); pyarrow decides (Queue 3)
_NULL_REF_FAULTS = {("cast_int64", 0)}


@pytest.mark.parametrize("n", [4, 0])
@pytest.mark.parametrize("name", list(_NULL_CALLS))
def test_calls_on_a_null_column_match_pyarrow(name, n):
    from arrow1_tpu.errors import Invalid as RefInvalid
    from arrow1_tpu.ops.cast import CastOptions as RefCast

    from arrow1_tpu_torch.ops.cast import CastOptions

    fn, arg = _NULL_CALLS[name]
    if n == 0 and name in ("take", "filter"):
        arg = []
    arr = pa.nulls(n)
    port_col = pt.interop.column_from_arrow(arr, device="cpu")
    ref_col = a1t.column(arr)
    if fn == "cast":
        want = pc.cast(arr, getattr(pa, arg)())
        got = pt.call_function("cast", [port_col], options=CastOptions.safe(
            getattr(pt, arg)))
        ref = None
        try:
            ref = a1t.call_function("cast", [ref_col], options=RefCast.safe(
                getattr(a1t, arg)))
        except RefInvalid:
            assert name == "cast_string"   # pyarrow decides
    elif arg is None:
        want = getattr(pc, fn)(arr)
        got = pt.call_function(fn, [port_col])
        ref = a1t.call_function(fn, [ref_col])
    else:
        other = pa.array(arg, pa.bool_() if fn == "filter" else pa.int64())
        want = getattr(pc, fn)(arr, other)
        got = pt.call_function(fn, [port_col, pt.interop.column_from_arrow(
            other, device="cpu")])
        ref = a1t.call_function(fn, [ref_col, a1t.column(other)])
    assert got.to_arrow().type == want.type
    assert got.to_arrow().to_pylist() == want.to_pylist()
    if ref is not None:
        same = ref.to_arrow().to_pylist() == want.to_pylist()
        assert same == ((name, n) not in _NULL_REF_FAULTS)
