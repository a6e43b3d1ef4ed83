"""The port's eager group_by, hash-aggregate and scalar-aggregate
functions against the JAX package on the same state.

The JAX package's RecordBatch is read out as numpy and handed to the port
with ``from_reference_arrays``, so both engines start from the same bits.
Integers, bools, dictionary codes, validity and row order must match
exactly. The data are small integers, also in the float64 columns, so
float64 sums of values are exact in any order; the statistics that sum
non-integers (the squared and cubed deviations of variance, stddev, skew
and kurtosis) reduce in another order in each engine, so float64 results
must agree to F64_RTOL, relative.

The dense-key path runs the JAX package's Pallas kernel through its
interpreter (``A1T_SEGSUM=interpret``) in two tests. The path decisions
are compared with a stub in place of both kernels, which stops each
call once the path is taken; the wraparound case is held against its
exact answer.

The JAX package's segmented min/max scan (``scan_blocked``) runs here
under ``jax.jit``, one compile per combine function, instead of eagerly,
where every level of the associative scan compiles on its own (some 10 s
per dtype on a CPU). jit changes no result of an exact min/max. The JAX
results of the sorted-path and registry tests are computed once, on a
thread pool: the JAX package compiles every operation on first use, and
the compiles of independent calls overlap.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pyarrow as pa
import pytest

import arrow1_tpu as a1t
import arrow1_tpu.kernels.segsum2 as jax_segsum2
import arrow1_tpu.ops.hash as jax_hash
from arrow1_tpu.kernels.blockscan import scan_blocked
from arrow1_tpu.ops.groupby import _mxu_group_by

import arrow1_tpu_torch as pt
import arrow1_tpu_torch.kernels.segsum2 as pt_segsum2
import arrow1_tpu_torch.ops.groupby as pt_groupby
from arrow1_tpu_torch.ops.groupby import _dense_key_group_by
from test_torch_answers import answers_of

F64_RTOL = 1e-12


def _port(x):
    """A JAX Column or RecordBatch as the port's, on the CPU."""
    if isinstance(x, a1t.RecordBatch):
        return pt.from_reference_arrays(
            x.names, [_triple(c) for c in x.columns], "cpu")
    return pt.from_reference_arrays(["c"], [_triple(x)], "cpu")["c"]


def _triple(c):
    return (np.asarray(c.data),
            None if c.validity is None else np.asarray(c.validity),
            None if c.dictionary is None else c.dictionary.values)


def _assert_same_column(g, w, name):
    wd, gd = np.asarray(w.data), g.data.numpy()
    assert gd.dtype == wd.dtype, (name, gd.dtype, wd.dtype)
    assert gd.shape == wd.shape, (name, gd.shape, wd.shape)
    wv = np.ones(len(wd), bool) if w.validity is None else \
        np.asarray(w.validity)
    gv = np.ones(len(gd), bool) if g.validity is None else \
        g.validity.numpy()
    np.testing.assert_array_equal(gv, wv, err_msg=name)
    if w.dictionary is not None:
        assert list(g.dictionary.values) == list(w.dictionary.values), name
    if wd.dtype.kind == "f":
        np.testing.assert_allclose(gd[wv], wd[wv], rtol=F64_RTOL, atol=0,
                                   equal_nan=True, err_msg=name)
    else:
        np.testing.assert_array_equal(gd[wv], wd[wv], err_msg=name)


def _assert_same(got, want):
    if isinstance(want, a1t.RecordBatch):
        assert list(got.names) == list(want.names)
        for name in want.names:
            _assert_same_column(got[name], want.column(name), name)
    elif isinstance(want, a1t.Scalar):
        assert got.is_valid == want.is_valid
        if want.is_valid:
            w, g = want.as_py(), got.as_py()
            if isinstance(w, float):
                np.testing.assert_allclose(g, w, rtol=F64_RTOL, atol=0)
            else:
                assert g == w and type(g) is type(w), (g, w)
    else:
        _assert_same_column(got, want, "column")


_JITTED_SCANS = {}
_JITTED_SCANS_LOCK = threading.Lock()


def _jitted_scan_blocked(fn, elems, reverse=False):
    key = (fn.__code__, tuple(c.cell_contents for c in fn.__closure__ or ()),
           reverse)
    with _JITTED_SCANS_LOCK:
        if key not in _JITTED_SCANS:
            _JITTED_SCANS[key] = jax.jit(
                lambda e: scan_blocked(fn, e, reverse=reverse))
        jitted = _JITTED_SCANS[key]
    return jitted(elems)


@pytest.fixture(autouse=True)
def _jit_reference_scans(monkeypatch):
    monkeypatch.setattr(jax_hash, "scan_blocked", _jitted_scan_blocked)


def _arr(rng, x, p_null, type=None):
    return pa.array(x, type=type, mask=rng.random(len(x)) < p_null)


WORDS = np.array(["pear", "fig", "apple", "kiwi", "date", "lime", "plum"])


def _mixed_batch(n, seed):
    """Keys and values of every kind the sorted path aggregates, with
    nulls. ``k``, ``s`` and ``f`` each hold 8 groups (counting the null
    group), as ``_GIDS`` does: results of one group count share the JAX
    package's compiled shapes. ``f`` holds small integers, NaN, -0.0 and
    +0.0, which group apart."""
    rng = np.random.default_rng(seed)
    f = rng.choice([-2.0, -1.0, -0.0, 0.0, 1.0, 2.0, np.nan], n)
    return a1t.record_batch(pa.record_batch({
        "k": _arr(rng, rng.integers(-3, 4, n).astype(np.int32), 0.05),
        "s": _arr(rng, WORDS[rng.integers(0, len(WORDS), n)], 0.1),
        "f": _arr(rng, f, 0.1),
        "v": _arr(rng, rng.integers(-1000, 1000, n).astype(np.int64), 0.1),
        "u": _arr(rng, rng.integers(0, 1 << 63, n, dtype=np.uint64), 0.1),
        "w": pa.array(rng.integers(0, 250, n).astype(np.uint8)),
        "b": _arr(rng, rng.random(n) < 0.4, 0.1),
        "p": _arr(rng, rng.integers(1, 4, n).astype(np.int64), 0.2),
    }))


# ---- the dense-key path ---------------------------------------------------

def _dense_batch(kind, seed=3, n=1024):
    rng = np.random.default_rng(seed)
    if kind == "int_key":
        k = _arr(rng, rng.integers(-50, 50, n).astype(np.int32), 0.1)
    else:
        k = _arr(rng, WORDS[rng.integers(0, len(WORDS), n)], 0.1)
    return a1t.record_batch(pa.record_batch({
        "k": k,
        "v": _arr(rng, rng.integers(-1000, 1000, n).astype(np.int64), 0.2),
        "x": _arr(rng, rng.standard_normal(n), 0.3),
    }))


DENSE_AGGS = [("v", "sum"), ("v", "mean"), ("x", "count")]


@pytest.mark.parametrize("kind", ["int_key", "dict_key"])
def test_dense_path_matches_jax_kernel(kind, monkeypatch):
    """Same rows in the same (key) order as the JAX package's Pallas
    kernel, run by its interpreter."""
    monkeypatch.setenv("A1T_SEGSUM", "interpret")
    jb = _dense_batch(kind)
    aggs = DENSE_AGGS if kind == "int_key" else DENSE_AGGS[:2]
    want = a1t.group_by(jb, ["k"], aggs)
    before = pt_segsum2.segment_sums_plain
    calls = []
    monkeypatch.setattr(pt_segsum2, "segment_sums_plain",
                        lambda *a: calls.append(1) or before(*a))
    got = pt.group_by(_port(jb), ["k"], aggs)
    assert calls == [1]   # one K3 call, through the wrapper
    _assert_same(got, want)


class _Taken(Exception):
    """Raised by a stand-in for a K3 call: the dense path was taken."""


def _taken(*args, **kwargs):
    raise _Taken


def _batch(cols):
    return a1t.record_batch(pa.record_batch(cols))


I64 = np.iinfo(np.int64)
WRAP = _batch({"k": pa.array([0, 0, 1, 2, 2], pa.int64()),
               "v": pa.array([1 << 62, 1 << 62, -5, I64.max, I64.max],
                             pa.int64())})
DENSE_CASES = {
    # taken
    "wraparound": (WRAP, ["k"], [("v", "sum"), ("v", "mean")]),
    "u64_count_only": (_batch({"k": pa.array([3, 1, 3], pa.uint16()),
                               "u": pa.array([1, None, 2 ** 64 - 1],
                                             pa.uint64())}),
                       ["k"], [("u", "count")]),
    "all_null_key": (_batch({"k": pa.array([None, None], pa.int64()),
                             "v": pa.array([1, 2], pa.int64())}),
                     ["k"], [("v", "sum")]),
    "range_at_max_g": (_batch({"k": pa.array([0, (1 << 17) - 1],
                                             pa.int64()),
                               "v": pa.array([1, 2], pa.int64())}),
                       ["k"], [("v", "sum")]),
    # declined
    "two_keys": (_batch({"k": pa.array([1, 2], pa.int64()),
                         "j": pa.array([1, 2], pa.int64())}),
                 ["k", "j"], [("k", "sum")]),
    "float_key": (_batch({"k": pa.array([1.5, 2.5]),
                          "v": pa.array([1, 2], pa.int64())}),
                  ["k"], [("v", "sum")]),
    "bool_key": (_batch({"k": pa.array([True, False]),
                         "v": pa.array([1, 2], pa.int64())}),
                 ["k"], [("v", "sum")]),
    "min_aggregate": (_batch({"k": pa.array([1, 2], pa.int64()),
                              "v": pa.array([1, 2], pa.int64())}),
                      ["k"], [("v", "min")]),
    "float_mean": (_batch({"k": pa.array([1, 2], pa.int64()),
                           "v": pa.array([1.0, 2.0])}),
                   ["k"], [("v", "mean")]),
    "dict_value": (_batch({"k": pa.array([1, 2], pa.int64()),
                           "s": pa.array(["a", "b"])}),
                   ["k"], [("s", "count")]),
    "u64_key": (_batch({"k": pa.array([1, 2], pa.uint64()),
                        "v": pa.array([1, 2], pa.int64())}),
                ["k"], [("v", "sum")]),
    "u64_sum": (_batch({"k": pa.array([1, 2], pa.int64()),
                        "u": pa.array([1, 2], pa.uint64())}),
                ["k"], [("u", "sum")]),
    "empty": (_batch({"k": pa.array([], pa.int64()),
                      "v": pa.array([], pa.int64())}),
              ["k"], [("v", "sum")]),
    "range_over_max_g": (_batch({"k": pa.array([0, 1 << 17], pa.int64()),
                                 "v": pa.array([1, 2], pa.int64())}),
                         ["k"], [("v", "sum")]),
    "null_slot_over_max_g": (_batch({"k": pa.array([0, (1 << 17) - 1, None],
                                                   pa.int64()),
                                     "v": pa.array([1, 2, 3], pa.int64())}),
                             ["k"], [("v", "sum")]),
}


def _decision(fn, *args):
    try:
        return "declined" if fn(*args) is None else "taken"
    except _Taken:
        return "taken"


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_path_decides_as_the_reference(case, monkeypatch):
    """The port takes the dense path on exactly the inputs where the
    reference does (both kernels are stood in for by a stub that stops
    the call)."""
    monkeypatch.setenv("A1T_SEGSUM", "interpret")
    monkeypatch.setattr(jax_segsum2, "segment_sums_mxu", _taken)
    monkeypatch.setattr(pt_groupby, "segment_sums", _taken)
    jb, keys, aggs = DENSE_CASES[case]
    want = _decision(_mxu_group_by, jb, keys, aggs)
    assert _decision(_dense_key_group_by, _port(jb), keys, aggs) == want
    assert want == ("taken" if list(DENSE_CASES).index(case) < 4
                    else "declined")


def test_dense_path_sums_wrap_mod_2_64():
    """The reference's wraparound case (tests/test_groupby_mxu.py): sums
    near +-2^63 wrap as int64 addition does, and the mean is the exact
    sum's, as pyarrow gives (the JAX package's dense kernel divides the
    wrapped sum: ROADMAP Queue 3, repaired)."""
    got = pt.group_by(_port(WRAP), ["k"], [("v", "sum"), ("v", "mean")])
    assert got["k"].to_pylist() == [0, 1, 2]
    assert got["v_sum"].to_pylist() == [-(1 << 63), -5, -2]
    assert got["v_mean"].to_pylist() == [float(1 << 62), -5.0,
                                         float((1 << 63) - 1)]


# ---- the sorted path ------------------------------------------------------

# one batch for the sorted path and the registry: shared shapes keep the
# JAX package's compile cache warm
_B = _mixed_batch(300, seed=11)
_GIDS = a1t.record_batch(pa.record_batch({"g": pa.array(
    np.random.default_rng(2).integers(0, 8, 300).astype(np.int32))}))["g"]


SORTED_KEYS = ["k", "s"]
SORTED_AGGS = [("v", "min"), ("v", "max"), ("f", "mean"), ("f", "variance"),
               ("w", "count_distinct"), ("v", "approximate_median")]


# the sums of f: the JAX package differences one cumsum across all groups,
# so the first NaN group in key order makes every later group's f_mean and
# f_variance NaN (ROADMAP Queue 3); pyarrow decides these two
FLOAT_SUM_AGGS = ("f_mean", "f_variance")


def test_sorted_path_matches_jax(jax_results):
    """A two-key (int32 and string, both with nulls) group-by with
    aggregates outside the dense set: the same rows in the same
    (first-appearance) order as the JAX package's sorted path. f_mean and
    f_variance are held against pyarrow's group_by of the same rows (to
    F64_RTOL), where the JAX package leaks NaN across groups."""
    got = pt.group_by(_port(_B), SORTED_KEYS, SORTED_AGGS)
    want = jax_results["group_by"]
    assert list(got.names) == list(want.names)
    for name in want.names:
        if name not in FLOAT_SUM_AGGS:
            _assert_same_column(got[name], want.column(name), name)
    table = pa.table(a1t.interop.record_batch_to_arrow(_B))
    ref = table.group_by(SORTED_KEYS, use_threads=False).aggregate(
        [("f", "mean"), ("f", "variance")])
    keys = list(zip(*(got[k].to_pylist() for k in SORTED_KEYS)))
    index = {key: i for i, key in enumerate(
        zip(*(ref.column(k).to_pylist() for k in SORTED_KEYS)))}
    rows = [index[key] for key in keys]
    leaked = 0
    for name in FLOAT_SUM_AGGS:
        pa_vals = [ref.column(name).to_pylist()[i] for i in rows]
        got_vals = got[name].to_pylist()
        assert [v is None for v in got_vals] == [v is None for v in pa_vals]
        pairs = [(g, w) for g, w in zip(got_vals, pa_vals) if w is not None]
        np.testing.assert_allclose([g for g, _ in pairs],
                                   [w for _, w in pairs], rtol=F64_RTOL,
                                   atol=0, equal_nan=True, err_msg=name)
        jax_col = want.column(name)
        jax_vals = np.asarray(jax_col.data)
        if jax_col.validity is not None:
            jax_vals = jax_vals[np.asarray(jax_col.validity)]
        leaked += int(np.isnan(jax_vals).sum() -
                      np.isnan([w for _, w in pairs]).sum())
    assert leaked > 0   # the JAX package's answer is the leak


def test_group_by_waits_for_the_nested_slice():
    """Since the nested slice, the list and distinct aggregates give each
    group's values (in row order) and distinct non-null values, as
    pyarrow's group_by does (whose distinct values come in an order of
    its hash table's: compared as sets)."""
    out = pt.group_by(_port(_B), ["k"], [("v", "list"), ("v", "distinct")])
    want = pa.Table.from_batches([_B.to_arrow()]).group_by(
        "k", use_threads=False).aggregate(
        [("v", "list"), ("v", "distinct")])

    def rows(t):
        return sorted(((r["k"], r["v_list"], sorted(r["v_distinct"]))
                       for r in t.to_pylist()), key=repr)

    assert rows(out.to_arrow()) == rows(want)
    assert {"hash_list", "hash_distinct"} <= set(pt.list_functions())


# ---- registry functions ---------------------------------------------------

REGISTRY_CASES = [
    ("count", ["v"], {"mode": "only_null"}), ("sum", ["u"], {}),
    ("product", ["p"], {}), ("mean", ["f"], {}), ("min_max", ["v"], {}),
    ("min", ["s"], {}), ("any", ["b"], {}), ("variance", ["v"], {"ddof": 1}),
    ("skew", ["v"], {}), ("kurtosis", ["v"], {"biased": False}),
    ("quantile", ["v"], {"q": (0.1, 0.5, 0.9)}),
    ("approximate_median", ["f"], {}), ("mode", ["f"], {"n": 3}),
    ("index", ["s"], {"value": "kiwi"}), ("first_last", ["f"], {}),
    ("count_all", ["v"], {}), ("count_distinct", ["k"], {}),
    ("winsorize", ["v"], {"lower_limit": 0.1, "upper_limit": 0.8}),
    ("unique", ["s"], {}), ("value_counts", ["f"], {}),
    ("dictionary_encode", ["s"], {}),
    ("hash_sum", ["v", "g"], {}), ("hash_min_max", ["u", "g"], {}),
    ("hash_mean", ["w", "g"], {}), ("hash_product", ["p", "g"], {}),
    ("hash_min", ["s", "g"], {}), ("hash_any", ["b", "g"], {}),
    ("hash_first_last", ["k", "g"], {}), ("hash_count_all", ["v", "g"], {}),
    ("hash_skew", ["v", "g"], {}), ("hash_variance", ["v", "g"], {}),
    ("count", ["v"], {}), ("min", ["v"], {}), ("max", ["w"], {}),
    ("all", ["b"], {}), ("stddev", ["f"], {}), ("first", ["v"], {}),
    ("last", ["s"], {}), ("hash_count", ["s", "g"], {}),
    ("hash_max", ["f", "g"], {}), ("hash_all", ["b", "g"], {}),
    ("hash_first", ["s", "g"], {}), ("hash_last", ["v", "g"], {}),
    ("hash_one", ["f", "g"], {}), ("hash_kurtosis", ["f", "g"], {}),
    ("hash_stddev", ["f", "g"], {}),
]


def _args(cols):
    return [_GIDS if c == "g" else _B.column(c) for c in cols]


def _case_id(case):
    return f"{case[0]}-{'-'.join(case[1])}"


def reference_answers():
    """The JAX package's answers to the sorted-path and registry tests,
    computed on a thread pool."""
    jobs = {repr(c): (lambda c=c: a1t.call_function(
        c[0], _args(c[1]), **c[2])) for c in REGISTRY_CASES}
    jobs["group_by"] = lambda: a1t.group_by(_B, SORTED_KEYS, SORTED_AGGS)
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(8) as ex:
        mp.setattr(jax_hash, "scan_blocked", _jitted_scan_blocked)
        futures = {name: ex.submit(job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


@pytest.mark.parametrize("name,cols,kwargs", REGISTRY_CASES,
                         ids=[_case_id(c) for c in REGISTRY_CASES])
def test_registry_function_matches_jax(name, cols, kwargs, jax_results):
    got = pt.call_function(name, [_port(a) for a in _args(cols)], **kwargs)
    if name == "mode" and cols == ["f"]:
        # the JAX package ranks NaN before the numbers and keeps 0.0 and
        # -0.0 apart; pyarrow decides (ROADMAP Queue 3)
        import pyarrow.compute as pc

        want = pc.mode(_B.column("f").to_arrow(), **kwargs).to_pylist()
        rows = got.to_arrow().to_pylist()
        assert [r["count"] for r in rows] == [r["count"] for r in want]
        # the zeros are one value, of either sign
        np.testing.assert_array_equal([r["mode"] for r in rows],
                                      [r["mode"] for r in want])
        return
    _assert_same(got, jax_results[repr((name, cols, kwargs))])


def _numpy_count_distinct(vals, gids):
    return [len({x for x, h in zip(vals, gids) if h == grp and x is not None})
            for grp in range(max(gids) + 1)]


def _numpy_median(vals, gids):
    out = []
    for grp in range(max(gids) + 1):
        xs = [x for x, h in zip(vals, gids) if h == grp and x is not None]
        out.append(float(np.median(xs)) if xs else None)
    return out


@pytest.mark.parametrize("name,col,oracle", [
    ("hash_count_distinct", "s", _numpy_count_distinct),
    ("hash_approximate_median", "v", _numpy_median)])
def test_hash_entries_of_group_by_code_match_numpy(name, col, oracle):
    """These entries run the code of the group-by's count_distinct and
    approximate_median, which test_sorted_path_matches_jax holds against
    JAX; here each registry entry is held against numpy."""
    vals, gids = _port(_B.column(col)), _port(_GIDS)
    got = pt.call_function(name, [vals, gids])
    assert got.to_pylist() == oracle(vals.to_pylist(), gids.to_pylist())


def test_grouped_aggregate_names_its_outputs():
    batch, gids = _port(_B), _port(_GIDS)
    out = pt_groupby.grouped_aggregate(batch, gids.data, 8,
                                       [("v", "sum"), ("f", "min_max")])
    assert [name for name, _ in out] == ["v_sum", "f_min", "f_max"]
    want = pt.call_function("hash_sum", [batch["v"], gids])
    assert out[0][1].to_pylist() == want.to_pylist()


def test_compute_facade_wraps_the_registry():
    import arrow1_tpu_torch.compute as pc

    col = _port(_B.column("v"))
    assert pc.sum(col).as_py() == pt.call_function("sum", [col]).as_py()
    assert pc.QuantileOptions is pt.ops.aggregate.QuantileOptions
    assert pc.hash_sum.__name__ == "hash_sum"
