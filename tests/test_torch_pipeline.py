"""The compiled pipeline through both packages on the same state.

The JAX package's RecordBatch is read out as numpy and handed to the port
with ``from_reference_arrays``, so both engines start from the same bits.
Integer columns, validity and row order must match exactly. f64
aggregates are held to a stated tolerance: both engines take each group's
sum as a difference of two running sums (cumsum-diff), but over rows in a
different order (the JAX group sort is unstable, the port's stable) and
with differently ordered cumsums, so the last bits differ. With |f| < 6
and at most a few thousand rows a prefix stays below ~1e4 in magnitude,
so an error above 1e-9 absolute would be a wrong result, not rounding.

The JAX answers are computed once, on a thread pool (fixture
``jax_results``): each compiled JAX pipeline is one XLA compile of a
few seconds, and the compiles of independent pipelines overlap.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pytest

import arrow1_tpu as a1t
from arrow1_tpu.exec.compiled import PipelineBuilder as JaxPipelineBuilder

import arrow1_tpu_torch as pt
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.kernels.compaction import compact
from test_torch_answers import answers_of

F64_ATOL = 1e-9


def _reference_arrays(batch):
    """A JAX RecordBatch as (data, validity, dictionary) numpy triples."""
    return [(np.asarray(c.data),
             None if c.validity is None else np.asarray(c.validity),
             None if c.dictionary is None else c.dictionary.values)
            for c in batch.columns]


def _port_batch(jbatch):
    return pt.from_reference_arrays(jbatch.names,
                                    _reference_arrays(jbatch), "cpu")


def _entry_batch(n, ngroups, seed=0):
    """__graft_entry__.entry's data recipe at size n."""
    rng = np.random.default_rng(seed)
    return a1t.record_batch(pa.record_batch({
        "k": pa.array(rng.integers(0, ngroups, n).astype(np.int64)),
        "v": pa.array(rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64)),
        "f": pa.array(rng.standard_normal(n)),
    }))


def _entry_ops(builder, max_groups):
    return (builder.filter(a1t.field("f") > 0.0 if builder_is_jax(builder)
                           else pt.field("f") > 0.0)
            .project([(a1t if builder_is_jax(builder) else pt).field("v")
                      * 2 + 1], ["proj"])
            .group_by(["k"], [("proj", "sum"), ("v", "count")],
                      max_groups=max_groups)
            .sort([("proj_sum", "descending")]))


def builder_is_jax(builder):
    return isinstance(builder, JaxPipelineBuilder)


def _assert_same(got, want, f64_cols=()):
    assert list(got.names) == list(want.names)
    for name in want.names:
        w, g = want.column(name), got.column(name)
        wd, gd = np.asarray(w.data), g.data.numpy()
        wv = None if w.validity is None else np.asarray(w.validity)
        gv = None if g.validity is None else g.validity.numpy()
        assert (wv is None) == (gv is None), name
        valid = np.ones(len(wd), bool) if wv is None else wv
        if gv is not None:
            np.testing.assert_array_equal(gv, wv, err_msg=name)
        assert gd.dtype == wd.dtype, name
        if name in f64_cols:
            np.testing.assert_allclose(gd[valid], wd[valid], rtol=0,
                                       atol=F64_ATOL, err_msg=name)
        else:
            np.testing.assert_array_equal(gd[valid], wd[valid],
                                          err_msg=name)


ENTRY_CASES = [
    (4096, 64, 65536),              # the entry's shape, cut to 4096 rows
    (1 << 18, 100_000, 1 << 17),    # large-G: segments through K2
]


def _jax_entry(n, ngroups, max_groups):
    jb = _entry_batch(n, ngroups)
    return jb, _entry_ops(JaxPipelineBuilder(), max_groups).compile()(jb)


def _nulls_batch():
    rng = np.random.default_rng(11)
    n = 3000

    def arr(x, p):
        return pa.array(x, mask=rng.random(n) < p)

    return a1t.record_batch(pa.record_batch({
        "k": arr(rng.integers(0, 40, n).astype(np.int64), 0.05),
        "h": arr(rng.integers(-9, 9, n).astype(np.int32), 0.1),
        "v": arr(rng.integers(-1000, 1000, n).astype(np.int64), 0.1),
        "f": arr(rng.standard_normal(n), 0.1),
        "b": arr(rng.random(n) < 0.3, 0.1),
    }))


NULLS_AGGS = [("proj", "sum"), ("f", "mean"), ("f", "min"), ("v", "max"),
              ("h", "min"), ("v", "count"), ("v", "mean"), ("b", "any"),
              ("b", "all"), ("f", "variance")]


def _nulls_pipeline(m, builder):
    return (builder
            .filter((m.field("v") > -500) & (m.field("f") < 1.5))
            .project([m.field("v") * 3 - m.field("h")], ["proj"])
            .group_by(["k", "h"], NULLS_AGGS, max_groups=4096)
            .sort([("v_max", "descending"), ("k", "ascending"),
                   ("h", "descending")])
            .limit(150)
            .compile())


def _dictionary_batch():
    rng = np.random.default_rng(5)
    n = 2000
    words = np.array(["pear", "fig", "apple", "kiwi", "date", "lime"])
    return a1t.record_batch(pa.record_batch({
        "s": pa.array(words[rng.integers(0, len(words), n)],
                      mask=rng.random(n) < 0.1),
        "v": pa.array(rng.integers(-100, 100, n).astype(np.int64)),
    }))


def _dictionary_pipeline(builder):
    return (builder.group_by(["s"], [("v", "sum"), ("v", "count")])
            .sort([("s", "descending")]).compile())


SORT_KEYS = [("b", "descending"), ("u16", "ascending"),
             ("f32", "descending"), ("i32", "ascending"),
             ("u8", "descending"), ("i8", "ascending")]
DECODE_KEYS = ["b", "u16", "f32", "i32", "u8"]
DECODE_AGGS = [("row", "count"), ("i8", "sum"), ("i8", "min")]


def _float_key_batch():
    f = np.array([0.0, -0.0, np.nan, 1.5, -2.0, np.nan, 0.0, -0.0, 3.0])
    k = np.arange(len(f), dtype=np.int64)
    valid = np.array([1, 1, 1, 1, 0, 1, 1, 1, 1], bool)
    return a1t.record_batch(pa.record_batch({
        "f": pa.array(f, mask=~valid), "k": pa.array(k)}))


def _run_jax(batch_fn, pipeline_fn):
    jb = batch_fn()
    return jb, pipeline_fn()(jb)


def reference_answers():
    """Every JAX pipeline's (input batch, output), computed once."""
    calls = {("entry",) + c: (_jax_entry, c) for c in ENTRY_CASES}
    calls["nulls"] = (_run_jax, (
        _nulls_batch, lambda: _nulls_pipeline(a1t, JaxPipelineBuilder())))
    calls["dictionary"] = (_run_jax, (
        _dictionary_batch, lambda: _dictionary_pipeline(JaxPipelineBuilder())))
    calls["sort"] = (_run_jax, (
        lambda: _narrow_typed_batch(3000, seed=8),
        lambda: JaxPipelineBuilder().sort(SORT_KEYS).compile()))
    calls["decode"] = (_run_jax, (
        lambda: _narrow_typed_batch(3000, seed=9),
        lambda: JaxPipelineBuilder().group_by(DECODE_KEYS,
                                              DECODE_AGGS).compile()))
    for order in ("ascending", "descending"):
        calls[("float", order)] = (_run_jax, (
            _float_key_batch,
            lambda order=order: JaxPipelineBuilder().sort(
                [("f", order)]).compile()))
    with ThreadPoolExecutor(len(calls)) as ex:
        futs = {k: ex.submit(fn, *args) for k, (fn, args) in calls.items()}
        return {k: f.result() for k, f in futs.items()}


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


@pytest.mark.parametrize("n,ngroups,max_groups", ENTRY_CASES)
def test_entry_pipeline_matches_jax(n, ngroups, max_groups, jax_results):
    jb, want = jax_results[("entry", n, ngroups, max_groups)]
    got = _entry_ops(pt.PipelineBuilder(), max_groups).compile()(
        _port_batch(jb))
    assert got.num_rows == want.num_rows
    if max_groups > 65536:
        assert got.num_rows > 65536
    _assert_same(got, want)


def test_pipeline_with_nulls_mean_min_max_limit(jax_results):
    jb, want = jax_results["nulls"]
    got = _nulls_pipeline(pt, pt.PipelineBuilder())(_port_batch(jb))
    assert got.num_rows == want.num_rows == 150
    _assert_same(got, want, f64_cols=("f_mean", "f_variance", "v_mean"))


def test_dictionary_string_group_key_and_sort(jax_results):
    jb, want = jax_results["dictionary"]
    got = _dictionary_pipeline(pt.PipelineBuilder())(_port_batch(jb))
    assert got.to_arrow().equals(want.to_arrow())


def _narrow_typed_batch(n, seed):
    """Keys of every fixed-width kind, few distinct values (many ties),
    NaN and -0.0 among the floats, and nulls."""
    rng = np.random.default_rng(seed)
    f32 = rng.integers(-3, 3, n).astype(np.float32)
    f32[rng.random(n) < 0.1] = np.nan
    f32[rng.random(n) < 0.1] = -0.0
    cols = {
        "i8": rng.integers(-128, 128, n).astype(np.int8),
        "u16": rng.integers(0, 4, n).astype(np.uint16) * 16000,
        "i32": rng.integers(-2, 2, n).astype(np.int32),
        "u8": rng.integers(250, 256, n).astype(np.uint8),
        "b": rng.random(n) < 0.5,
        "f32": f32,
        "row": np.arange(n, dtype=np.int64),
    }
    return a1t.record_batch(pa.record_batch({
        k: pa.array(v, mask=(rng.random(n) < 0.1) if k != "row" else None)
        for k, v in cols.items()}))


def test_multi_key_sort_of_every_fixed_width_kind(jax_results):
    jb, want = jax_results["sort"]
    got = pt.PipelineBuilder().sort(SORT_KEYS).compile()(_port_batch(jb))
    np.testing.assert_array_equal(got["row"].data.numpy(),
                                  np.asarray(want["row"].data))


def test_group_by_decodes_every_fixed_width_key_kind(jax_results):
    jb, want = jax_results["decode"]
    got = pt.PipelineBuilder().group_by(DECODE_KEYS, DECODE_AGGS).compile()(
        _port_batch(jb))
    assert got.num_rows == want.num_rows
    _assert_same(got, want)


def test_sort_on_float_key_with_nan_and_negative_zero(jax_results):
    for order in ("ascending", "descending"):
        jb, want = jax_results[("float", order)]
        got = pt.PipelineBuilder().sort([("f", order)]).compile()(
            _port_batch(jb))
        np.testing.assert_array_equal(got["k"].data.numpy(),
                                      np.asarray(want["k"].data))


def test_overflow_raises_and_join_rejects_full_outer():
    rng = np.random.default_rng(2)
    tb = pt.record_batch({"k": rng.integers(0, 100, 500).astype(np.int64),
                          "v": np.ones(500, np.int64)}, device="cpu")
    pipe = pt.PipelineBuilder().group_by(["k"], [("v", "sum")],
                                         max_groups=10).compile()
    with pytest.raises(Invalid, match="overflow"):
        pipe(tb)
    # the compiled join takes inner and left outer only, as the reference
    # does, and ~5 matches a row overflow a fanout of 1
    with pytest.raises(Invalid, match="join_type"):
        pt.PipelineBuilder().join(tb, ["k"], join_type="full outer")
    with pytest.raises(Invalid, match="overflow"):
        pt.PipelineBuilder().join(tb, ["k"], fanout=1).compile()(tb)


def test_materialize_false_returns_padded_state():
    tb = pt.record_batch({"k": np.array([3, 1, 3, 2], np.int64),
                          "v": np.array([1, 2, 3, 4], np.int64)},
                         device="cpu")
    out, live = (pt.PipelineBuilder()
                 .group_by(["k"], [("v", "sum")], max_groups=4)
                 .compile()(tb, materialize=False))
    assert out.num_rows == 4 and live.tolist() == [True, True, True, False]
    assert out["v_sum"].data[:3].tolist() == [2, 4, 4]
    assert out["k"].data[:3].tolist() == [1, 2, 3]


def test_cpu_pipeline_launches_no_kernel():
    before = compact.launches
    jb = _entry_batch(2000, 16, seed=3)
    _entry_ops(pt.PipelineBuilder(), 65536).compile()(_port_batch(jb))
    assert compact.launches == before
