"""The port's joins against the JAX package on the same state: every join
type, join_asof, the compiled pipeline's join, the static-capacity join
core, and TPC-H Q3 at the size of the JAX package's own test.

The JAX package's batches are read out as numpy and handed to the port
with ``from_reference_arrays``, so both engines start from the same bits
(string columns keep their value pools, which differ between the two
sides). Row order, validity, integer and string values must match
exactly, and so must float64 values the join only moves. Q3's float64
sums are cumulative sums in each engine's own summation order, so they
must agree to Q3_RTOL, relative.

The JAX answers are computed once, on a thread pool, in a worker process
(tests/test_torch_answers.py) while earlier files' tests run: the JAX
package compiles every operation on first use, and the compiles of
independent calls overlap. Its running max/min scans (``scan_blocked``, in the
sort-merge core, join_asof and the compiled group-by) run under
``jax.jit``, one compile per combine function, instead of one compile per
level of the eager associative scan; jit changes no result of an exact
max or min.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow1_tpu as a1t
import arrow1_tpu.compute as ac
import arrow1_tpu.ops.dictionary as jdict
import arrow1_tpu.ops.join as jjoin
import arrow1_tpu.ops.padded as jpadded
from arrow1_tpu.errors import Invalid as JInvalid
from arrow1_tpu.exec.compiled import PipelineBuilder as JPipelineBuilder
from arrow1_tpu.kernels.blockscan import scan_blocked
from test_torch_answers import answers_of
from test_tpch_pipeline import make_lineitem, make_orders

import arrow1_tpu_torch as pt
import arrow1_tpu_torch.compute as pc
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.interop import tensor_from_u64
from arrow1_tpu_torch.ops import dictionary as pdict
from arrow1_tpu_torch.ops.padded import join_padded, probe_ranges_sortmerge

Q3_RTOL = 1e-12

JOIN_TYPES = ["inner", "left outer", "right outer", "full outer",
              "left semi", "left anti", "right semi", "right anti"]


def _triple(c):
    return (np.asarray(c.data),
            None if c.validity is None else np.asarray(c.validity),
            None if c.dictionary is None else c.dictionary.values)


def _port(b):
    return pt.from_reference_arrays(b.names, [_triple(c) for c in b.columns],
                                    "cpu")


def _assert_same_batch(got, want, rtol=0.0):
    assert list(got.names) == list(want.names)
    for name in want.names:
        g, w = got[name], want.column(name)
        wv = np.ones(w.length, bool) if w.validity is None else \
            np.asarray(w.validity)
        np.testing.assert_array_equal(g.mask().numpy(), wv, err_msg=name)
        if w.dictionary is not None:
            gs = g.dictionary.values[g.data.numpy()][wv]
            ws = w.dictionary.values[np.asarray(w.data)][wv]
            assert gs.tolist() == ws.tolist(), name
            continue
        gd, wd = g.data.numpy()[wv], np.asarray(w.data)[wv]
        if wd.dtype.kind == "f" and rtol:
            np.testing.assert_allclose(gd, wd, rtol=rtol, atol=0,
                                       err_msg=name)
        elif wd.dtype.kind == "f":   # moved, not computed: bit for bit
            np.testing.assert_array_equal(gd.view(np.int64),
                                          wd.view(np.int64), err_msg=name)
        else:
            np.testing.assert_array_equal(gd, wd, err_msg=name)


def _sides():
    """One shared pair of batches: null keys on both sides, duplicate
    build keys, an int64 key ``k``, a string key ``s`` whose value pools
    differ between the sides, and a float64 key ``f`` holding NaN, -0.0
    and +0.0."""
    rng = np.random.default_rng(4)

    def side(n, words, p_null, payload):
        f = rng.choice([-0.0, 0.0, 1.5, -2.0, np.nan], n)
        return a1t.record_batch(pa.record_batch({
            "k": pa.array(rng.integers(0, 12, n), pa.int64(),
                          mask=rng.random(n) < p_null),
            "s": pa.array(rng.choice(words, n).tolist(),
                          mask=rng.random(n) < p_null),
            "f": pa.array(f, mask=rng.random(n) < p_null),
            payload: pa.array(rng.integers(-1000, 1000, n), pa.int64()),
        }))

    left = side(40, ["pear", "fig", "kiwi", "plum"], 0.1, "lv")
    right = side(30, ["kiwi", "date", "fig", "lime", "pear"], 0.15, "rv")
    return left, right


LEFT, RIGHT = _sides()
KEYSETS = {"int64": ["k"], "string": ["s"], "two_columns": ["f", "s"]}
# The two-column key (float64 and string) takes the dense-id sort-merge
# path, in all eight join types. The int64 key takes the hash-table path;
# its cases are the ones with code of their own on that path (the probe,
# the outer expansion, the build-side match of full outer and right
# anti); right outer (the swapped left outer), the left semi/anti masks
# and right semi (right anti's complement) share the rest with the
# two-column cases. A lone string key takes the hash path on its
# dictionary ranks.
JOIN_CASES = ([("two_columns", jt) for jt in JOIN_TYPES]
              + [("int64", jt) for jt in ("inner", "left outer",
                                          "full outer", "right anti")]
              + [("string", "inner")])


def _asof_sides():
    rng = np.random.default_rng(8)
    n, m = 30, 20
    left = a1t.record_batch(pa.record_batch({
        "t": pa.array(np.sort(rng.integers(0, 60, n)), pa.int64()),
        "g": pa.array(rng.choice(["a", "b"], n).tolist()),
        "lv": pa.array(np.arange(n), pa.int64())}))
    right = a1t.record_batch(pa.record_batch({
        "t": pa.array(rng.integers(0, 60, m), pa.int64()),
        "g": pa.array(rng.choice(["b", "a", "c"], m).tolist()),
        "rv": pa.array(rng.standard_normal(m),
                       mask=rng.random(m) < 0.2)}))
    return left, right


ASOF_L, ASOF_R = _asof_sides()
ASOF_CASES = {"backward": dict(tolerance=-5), "forward": dict(tolerance=4),
              "by": dict(by="g", tolerance=-8)}


def _compiled_sides():
    """Facts over keys [0, 24); dims cover [0, 16), four keys twice (so
    some facts match twice and some not at all); hot dims hold every key
    three times."""
    rng = np.random.default_rng(6)
    n = 64
    facts = a1t.record_batch(pa.record_batch({
        "k": pa.array(rng.integers(0, 24, n), pa.int64()),
        "v": pa.array(rng.integers(-100, 100, n), pa.int64()),
        "x": pa.array(rng.standard_normal(n))}))
    dims = a1t.record_batch(pa.record_batch({
        "k": pa.array(np.r_[np.arange(16), np.arange(4)], pa.int64()),
        "w": pa.array(np.arange(20) * 10, pa.int64())}))
    hot = a1t.record_batch(pa.record_batch({
        "k": pa.array(np.tile(np.arange(24), 3), pa.int64()),
        "w": pa.array(np.arange(72), pa.int64())}))
    return facts, dims, hot


FACTS, DIMS, HOT_DIMS = _compiled_sides()


def _compiled(builder, jt, fanout, dims=DIMS):
    jax_side = builder is JPipelineBuilder
    return (builder().filter((a1t if jax_side else pt).field("v") > -50)
            .join(dims if jax_side else _port(dims), keys=["k"],
                  fanout=fanout, join_type=jt).compile())


def _q3_reference(li, orders):
    joined = a1t.join(li, orders, keys=["l_orderkey"],
                      right_keys=["o_orderkey"])
    agg = a1t.group_by(joined, ["o_orderpriority"],
                       [("l_extendedprice", "sum"), ("l_orderkey", "count")])
    idx = ac.sort_indices(agg, sort_keys=[("l_extendedprice_sum",
                                           "descending")])
    return ac.take(agg, ac.cast(idx, a1t.int64))


_JITTED_SCANS = {}
_JITTED_SCANS_LOCK = threading.Lock()


def _jitted_scan(fn, elems, reverse=False):
    """The reference's scan_blocked under jit, one compile per combine
    function and direction."""
    key = (getattr(fn, "__code__", fn),
           tuple(c.cell_contents for c in getattr(fn, "__closure__", None)
                 or ()), reverse)
    with _JITTED_SCANS_LOCK:
        if key not in _JITTED_SCANS:
            _JITTED_SCANS[key] = jax.jit(
                lambda e: scan_blocked(fn, e, reverse=reverse))
        jitted = _JITTED_SCANS[key]
    return jitted(elems)


def reference_answers():
    """Every JAX answer the tests compare against, computed once."""
    li = a1t.record_batch(make_lineitem())
    orders = a1t.record_batch(make_orders())
    calls = {("q3",): (_q3_reference, (li, orders), {})}   # the longest
    calls.update({("join",) + c: (a1t.join, (LEFT, RIGHT, KEYSETS[c[0]]),
                                  dict(join_type=c[1])) for c in JOIN_CASES})
    for name, kw in ASOF_CASES.items():
        calls[("asof", name)] = (jjoin.join_asof, (ASOF_L, ASOF_R, "t"), kw)
    for case in CORE_CASES:
        calls[("core",) + case] = (_jax_join_padded, case, {})
    calls[("sortmerge",)] = (_jax_sortmerge, (), {})
    for jt in ("inner", "left outer"):
        calls[("compiled", jt)] = (lambda jt=jt: _compiled(
            JPipelineBuilder, jt, 4)(FACTS), (), {})
    with pytest.MonkeyPatch.context() as mp, ThreadPoolExecutor(16) as ex:
        for mod in (jpadded, jjoin):
            mp.setattr(mod, "scan_blocked", _jitted_scan)
        futs = {k: ex.submit(fn, *args, **kw)
                for k, (fn, args, kw) in calls.items()}
        out = {k: f.result() for k, f in futs.items()}
    out["q3_inputs"] = (li, orders)
    return out


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


@pytest.mark.parametrize("keyset,join_type", JOIN_CASES,
                         ids=[f"{k}-{j}" for k, j in JOIN_CASES])
def test_join_matches_jax(keyset, join_type, jax_results):
    got = pt.join(_port(LEFT), _port(RIGHT), KEYSETS[keyset],
                  join_type=join_type)
    want = jax_results[("join", keyset, join_type)]
    assert got.num_rows == want.num_rows
    _assert_same_batch(got, want)


def test_join_rejects_what_the_reference_rejects():
    with pytest.raises(Invalid):
        pt.join(_port(LEFT), _port(RIGHT), ["k"], join_type="bogus")
    with pytest.raises(Invalid):
        pt.join(_port(LEFT), _port(RIGHT), ["k", "s"], right_keys=["k"])
    with pytest.raises(TypeError):
        pt.join(LEFT, _port(RIGHT), ["k"])


@pytest.mark.parametrize("case", list(ASOF_CASES))
def test_join_asof_matches_jax(case, jax_results):
    got = pt.join_asof(_port(ASOF_L), _port(ASOF_R), "t",
                       **ASOF_CASES[case])
    _assert_same_batch(got, jax_results[("asof", case)])


@pytest.mark.parametrize("join_type", ["inner", "left outer"])
def test_compiled_join_matches_jax(join_type, jax_results):
    got = _compiled(pt.PipelineBuilder, join_type, 4)(_port(FACTS))
    _assert_same_batch(got, jax_results[("compiled", join_type)])


def test_compiled_join_overflow_raises_in_both():
    """Every live fact matches three hot dims: fanout 1 is too small."""
    with pytest.raises(JInvalid, match="overflow"):
        _compiled(JPipelineBuilder, "inner", 1, HOT_DIMS)(FACTS)
    with pytest.raises(Invalid, match="overflow"):
        _compiled(pt.PipelineBuilder, "inner", 1, HOT_DIMS)(_port(FACTS))
    with pytest.raises(Invalid, match="join_type"):
        pt.PipelineBuilder().join(_port(DIMS), "k", join_type="full outer")


def test_q3_matches_jax(jax_results):
    li, orders = jax_results["q3_inputs"]
    joined = pt.join(_port(li), _port(orders), keys=["l_orderkey"],
                     right_keys=["o_orderkey"])
    agg = pt.group_by(joined, ["o_orderpriority"],
                      [("l_extendedprice", "sum"), ("l_orderkey", "count")])
    idx = pc.sort_indices(agg, sort_keys=[("l_extendedprice_sum",
                                           "descending")])
    assert idx.data.dtype == torch.uint64
    _assert_same_batch(pc.take(agg, idx), jax_results[("q3",)],
                       rtol=Q3_RTOL)


def _join_core_inputs():
    """Probe and build keys for the static-capacity core: u64 keys on both
    sides of 2^63 with duplicates, null keys on both sides, and dead probe
    rows; a list-of-planes form of the same keys."""
    rng = np.random.default_rng(12)
    pool = np.array([3, 7, 1 << 63, (1 << 64) - 2, 42, 9], np.uint64)
    pk = rng.choice(pool, 50)
    bk = rng.choice(pool[:5], 20)
    pvalid = rng.random(50) >= 0.1
    bvalid = rng.random(20) >= 0.1
    live = rng.random(50) >= 0.2
    return pk, bk, pvalid, bvalid, live


CORE_CASES = [(outer, planes, cap) for outer in (False, True)
              for planes in (False, True) for cap in (30, 200)]


def _core_keys(planes, to):
    """The core's keys for one package: one u64 array, or a class plane
    and the value plane as a list."""
    pk, bk, pvalid, bvalid, live = _join_core_inputs()
    if to == "jax":
        u64, u8, mask = jnp.asarray, jnp.asarray, jnp.asarray
    else:
        u64 = lambda x: tensor_from_u64(x, "cpu")   # noqa: E731
        u8 = mask = torch.from_numpy
    if planes:
        keys = [[u8((k % 3).astype(np.uint8)), u64(k)] for k in (pk, bk)]
    else:
        keys = [u64(pk), u64(bk)]
    return keys + [mask(pvalid), mask(bvalid), mask(live)]


def _jax_join_padded(outer, planes, cap):
    pk, bk, pvalid, bvalid, live = _core_keys(planes, "jax")
    return jpadded.join_padded(pk, bk, pvalid, bvalid, cap, outer=outer,
                               probe_live=live)


def _jax_sortmerge():
    pk, bk, _, _, _ = _core_keys(False, "jax")
    return jpadded.probe_ranges_sortmerge(pk, bk, want_build_matched=True)


@pytest.mark.parametrize("outer,planes,cap", CORE_CASES)
def test_join_padded_matches_jax(outer, planes, cap, jax_results):
    """All seven outputs, slot for slot, also past the total and for
    probe rows that emit nothing; capacity 30 overflows."""
    pk, bk, pvalid, bvalid, live = _core_keys(planes, "torch")
    got = join_padded(pk, bk, pvalid, bvalid, cap, outer=outer,
                      probe_live=live)
    want = jax_results[("core", outer, planes, cap)]
    names = ("probe_idx", "build_idx", "pair_valid", "pair_has_match",
             "build_matched", "total", "overflowed")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w),
                                      err_msg=name)
    assert bool(got[-1]) == (cap == 30)


def test_probe_ranges_sortmerge_matches_jax(jax_results):
    pk, bk, _, _, _ = _core_keys(False, "torch")
    got = probe_ranges_sortmerge(pk, bk, want_build_matched=True)
    for g, w in zip(got, jax_results[("sortmerge",)]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dictionary_unify_and_reencode_match_jax():
    lc, rc = LEFT.column("s"), RIGHT.column("s")
    jcodes, jd = jdict.unify_dictionaries([lc, rc])
    codes, d = pdict.unify_dictionaries([_port(LEFT)["s"],
                                         _port(RIGHT)["s"]])
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    assert list(d.values) == list(jd.values)
    re = pdict.reencode_against(_port(LEFT)["s"], d)
    jre = jdict.reencode_against(lc, jd)
    np.testing.assert_array_equal(re.data.numpy(), np.asarray(jre.data))
    with pytest.raises(Invalid):
        pdict.reencode_against(_port(RIGHT)["s"], _port(LEFT)["s"].dictionary)


@pytest.mark.parametrize("join_type", ["left outer", "full outer"])
def test_join_with_an_empty_build_side_matches_pyarrow(join_type):
    """The JAX package raises here (a gather from an empty column); the
    port follows pyarrow: every probe row, with nulls on the build side."""
    left = pa.table({"k": pa.array([1, 2, None], pa.int64()),
                     "v": pa.array([1, 2, 3], pa.int64())})
    right = pa.table({"k": pa.array([], pa.int64()),
                      "w": pa.array([], pa.float64())})
    got = pt.join(pt.record_batch(left, device="cpu"),
                  pt.record_batch(right, device="cpu"), "k",
                  join_type=join_type)
    assert got.to_pydict() == left.join(right, "k",
                                        join_type=join_type).to_pydict()
