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
  two-batch query() and acero group_by, in float64 and float32.

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
from arrow1_tpu.exec.compiled import PipelineBuilder as JaxPipelineBuilder

import arrow1_tpu_torch as pt
import arrow1_tpu_torch.acero as acero
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
    fb = a1t.record_batch(_float_batch("float64", "small"))
    jobs["float_pipeline"] = lambda: a1t.interop.record_batch_to_arrow(
        JaxPipelineBuilder().group_by(["k"], FLOAT_AGGS).compile()(fb))
    jobs["float_hash_min_max"] = lambda: a1t.call_function(
        "hash_min_max", [fb["v"], fb["g"]]).to_pylist()
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
