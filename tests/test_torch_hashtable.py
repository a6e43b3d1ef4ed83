"""The port's hash table and K4's plain version against the JAX package on
the same keys.

Keys are unsigned 64-bit values, made with numpy from seeds and handed to
both packages: to the JAX package as uint64 arrays, to the port as their
int64 bit patterns (``interop.tensor_from_u64``). Everything here is
integer arithmetic, so every result must match exactly: hashes, buckets,
build orders, tables, overflow counts and ``(lo, counts)``.

The JAX package's Pallas K4 runs once, in interpret mode, at its own
test's shape (T = 100, n = 16384); the other K4 cases hold the plain
version against numpy's ``searchsorted``. The JAX answers of the build
and probe tests are computed once, on a thread pool, so that the JAX
package's compiles of independent calls overlap.
"""

from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import arrow1_tpu.kernels.hashtable as jht

import arrow1_tpu_torch as pt
import arrow1_tpu_torch.kernels.hashtable as ht
from arrow1_tpu_torch.interop import tensor_from_u64
from arrow1_tpu_torch.ops.padded import probe_ranges_sortmerge
from test_torch_answers import answers_of

U64_MAX = np.iinfo(np.uint64).max


def _u64(x) -> np.ndarray:
    """A port result (int64 bit patterns) as uint64."""
    return x.numpy().astype(np.int64).view(np.uint64)


def _keys(seed, n, hi_share=0.5):
    """u64 keys, half of them at or above 2^63."""
    rng = np.random.default_rng(seed)
    hi = rng.random(n) < hi_share
    lo_keys = rng.integers(0, 1 << 63, n, dtype=np.uint64)
    return np.where(hi, lo_keys | np.uint64(1 << 63), lo_keys)


def test_splitmix64_and_buckets_are_bit_equal():
    keys = np.concatenate([_keys(0, 4000),
                           np.array([0, 1, U64_MAX, 1 << 63], np.uint64)])
    want = np.asarray(jht.splitmix64(jnp.asarray(keys)))
    got = _u64(ht.splitmix64(tensor_from_u64(keys, "cpu")))
    np.testing.assert_array_equal(got, want)
    for bits in (4, 13, 22, 28):
        np.testing.assert_array_equal(
            ht._bucket_of(tensor_from_u64(keys, "cpu"), bits).numpy(),
            np.asarray(jht._bucket_of(jnp.asarray(keys), bits)))


def test_table_bits_for_matches():
    for n in (0, 1, 7, 8, 100, 4096, 10_000_000, 1 << 40):
        for ways in (2, 8):
            assert ht.table_bits_for(n, ways) == jht.table_bits_for(n, ways)


def test_run_geometry_matches():
    rng = np.random.default_rng(1)
    first = rng.random(500) < 0.3
    first[0] = True
    bfirst = first & (rng.random(500) < 0.4)
    bfirst[0] = True
    want = jht._run_geometry(jnp.asarray(first), jnp.asarray(bfirst))
    got = ht._run_geometry(torch.from_numpy(first), torch.from_numpy(bfirst))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _build_keys(seed, m):
    """m keys drawn from m // 3 distinct ones on both sides of 2^63, so
    most keys repeat."""
    rng = np.random.default_rng(seed)
    return rng.choice(_keys(seed, m // 3), m)


# (case, m, bits, with dead rows): "overflow" forces 16 buckets of 8 ways
# for ~230 distinct keys, so the overflow count is nonzero
BUILD_CASES = [("dups", 700, None, False), ("dead_rows", 700, None, True),
               ("overflow", 700, 4, True)]


def _build_case(m, dead):
    rng = np.random.default_rng(m)
    keys = _build_keys(m, m)
    live = rng.random(m) >= 0.15 if dead else None
    probe = np.concatenate([rng.choice(keys, 300), _keys(m + 1, 300)])
    return keys, live, probe


def _jax_build_and_probe(m, bits, dead):
    keys, live, probe = _build_case(m, dead)
    jorder, jtab = jht.join_build(
        jnp.asarray(keys), bits=bits,
        live=None if live is None else jnp.asarray(live))
    return jorder, jtab, jht.join_probe(jtab, jnp.asarray(probe))


def _hash_table_case():
    rng = np.random.default_rng(7)
    keys = _keys(7, 300)
    pay = rng.integers(1, 1 << 62, 300).astype(np.uint64)
    live = rng.random(300) >= 0.2
    probe = np.concatenate([keys, _keys(8, 50)])
    return keys, pay, live, probe


def _jax_hash_table():
    keys, pay, live, probe = _hash_table_case()
    jt = jht.hash_table_build(jnp.asarray(keys), jnp.asarray(pay), bits=6,
                              ways=4, live=jnp.asarray(live))
    return jt, jht.hash_table_probe(jt, jnp.asarray(probe))


def reference_answers():
    calls = {case: (_jax_build_and_probe, (m, bits, dead))
             for case, m, bits, dead in BUILD_CASES}
    calls["hash_table"] = (_jax_hash_table, ())
    with ThreadPoolExecutor(4) as ex:
        futs = {k: ex.submit(fn, *args) for k, (fn, args) in calls.items()}
        return {k: f.result() for k, f in futs.items()}


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


@pytest.mark.parametrize("case,m,bits,dead", BUILD_CASES,
                         ids=[c[0] for c in BUILD_CASES])
def test_join_build_and_probe_match(case, m, bits, dead, jax_results):
    keys, live, probe = _build_case(m, dead)
    jorder, jtab, (jlo, jcnt) = jax_results[case]
    order, tab = ht.join_build(
        tensor_from_u64(keys, "cpu"), bits=bits,
        live=None if live is None else torch.from_numpy(live))
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    np.testing.assert_array_equal(_u64(tab.keys), np.asarray(jtab.keys))
    np.testing.assert_array_equal(_u64(tab.payload), np.asarray(jtab.payload))
    assert int(tab.overflow) == int(jtab.overflow)
    if case == "overflow":
        assert int(tab.overflow) > 0
    lo, cnt = ht.join_probe(tab, tensor_from_u64(probe, "cpu"))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_join_probe_chunks_agree(monkeypatch):
    keys = _build_keys(5, 300)
    probe = np.concatenate([keys, _keys(6, 101)])
    _, tab = ht.join_build(tensor_from_u64(keys, "cpu"))
    whole = ht.join_probe(tab, tensor_from_u64(probe, "cpu"))
    monkeypatch.setattr(ht, "PROBE_CHUNK", 64)
    chunked = ht.join_probe(tab, tensor_from_u64(probe, "cpu"))
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_hash_table_build_and_probe_match(jax_results):
    keys, pay, live, probe = _hash_table_case()
    jt, jpay = jax_results["hash_table"]
    t = ht.hash_table_build(tensor_from_u64(keys, "cpu"),
                            tensor_from_u64(pay, "cpu"), bits=6, ways=4,
                            live=torch.from_numpy(live))
    np.testing.assert_array_equal(_u64(t.keys), np.asarray(jt.keys))
    np.testing.assert_array_equal(_u64(t.payload), np.asarray(jt.payload))
    assert int(t.overflow) == int(jt.overflow) > 0
    np.testing.assert_array_equal(
        _u64(ht.hash_table_probe(t, tensor_from_u64(probe, "cpu"))),
        np.asarray(jpay))


def test_reference_table_probed_by_both(jax_results):
    """A table the JAX package built, converted to the port's, answers the
    same probes as in the JAX package."""
    _, _, probe = _build_case(700, False)
    _, jtab, (jlo, jcnt) = jax_results["dups"]
    tab = ht.HashTable(tensor_from_u64(np.asarray(jtab.keys), "cpu"),
                       tensor_from_u64(np.asarray(jtab.payload), "cpu"),
                       jtab.bits, jtab.ways, torch.tensor(0))
    lo, cnt = ht.join_probe(tab, tensor_from_u64(probe, "cpu"))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def test_broadcast_probe_plain_matches_reference_kernel():
    """The reference's own test shape (tests/test_kernels.py), its Pallas
    kernel run by the interpreter."""
    rng = np.random.default_rng(3)
    T = 100
    build = np.sort(rng.integers(0, 1 << 63, T).astype(np.uint64))
    n = 128 * 128
    probe = np.concatenate([rng.choice(build, n // 2),
                            rng.integers(0, 1 << 64, n // 2,
                                         dtype=np.uint64)])
    jlo, jcnt = jht.broadcast_probe(jnp.asarray(build), jnp.asarray(probe),
                                    interpret=True)
    lo, cnt = ht.broadcast_probe_plain(tensor_from_u64(build, "cpu"),
                                       tensor_from_u64(probe, "cpu"))
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(cnt.numpy(), np.asarray(jcnt))


def _k4_case(T, n, seed, kind="duplicates"):
    """A sorted build and probes half drawn from it. ``duplicates``: runs
    of equal keys, keys at and above 2^63 and the extremes of the unsigned
    range; ``clustered``: T - 1 keys in a window 2^12 wide and 2^64 - 1;
    ``all-equal``: one key T times; ``high``: every key above 2^63."""
    rng = np.random.default_rng(seed)
    window = None
    if kind == "duplicates":
        build = np.sort(rng.choice(_keys(seed, max(T // 2, 1)), T))
    elif kind == "clustered":
        base = np.uint64(rng.integers(0, 1 << 63))
        window = base + rng.integers(0, 1 << 12, n).astype(np.uint64)
        build = np.sort(np.append(window[:T - 1], U64_MAX))
    elif kind == "all-equal":
        build = np.full(T, _keys(seed, 1)[0])
    else:
        build = np.sort(_keys(seed, T, hi_share=1.0))
    other = _keys(seed + 1, n - n // 2) if window is None else window
    probe = np.concatenate([rng.choice(build, n // 2), other[:n - n // 2]])
    if kind == "duplicates" and T > 1:
        build[0], build[-1] = 0, U64_MAX
    probe[:4] = [0, U64_MAX, 1 << 63, (1 << 63) - 1]
    return build, probe


@pytest.mark.parametrize("T, kind", [
    pytest.param(1, "duplicates", id="1"),
    pytest.param(2048, "duplicates", id="2048"),
    pytest.param(2048, "clustered", id="clustered"),
    pytest.param(2047, "all-equal", id="all-equal"),
    pytest.param(2048, "high", id="high")])
def test_broadcast_probe_plain_matches_searchsorted(T, kind):
    build, probe = _k4_case(T, 5001, T, kind)
    lo, cnt = pt.broadcast_probe(tensor_from_u64(build, "cpu"),
                                 tensor_from_u64(probe, "cpu"))
    want_lo = np.searchsorted(build, probe, side="left")
    want_hi = np.searchsorted(build, probe, side="right")
    assert lo.dtype == cnt.dtype == torch.int32
    np.testing.assert_array_equal(lo.numpy(), want_lo)
    np.testing.assert_array_equal(cnt.numpy(), want_hi - want_lo)


def test_broadcast_probe_agrees_with_the_join_probes():
    """K4, the sort-merge probe and the hash probe give one (lo, counts)
    on a sorted build (the hash probe's lo indexes its own build order,
    so only its counts compare)."""
    build, probe = _k4_case(256, 3000, 11)
    b, p = tensor_from_u64(build, "cpu"), tensor_from_u64(probe, "cpu")
    lo, cnt = pt.broadcast_probe(b, p)
    order, slo, scnt = probe_ranges_sortmerge(p, b)
    assert torch.equal(order, torch.arange(256))
    assert torch.equal(lo.long(), slo)
    assert torch.equal(cnt, scnt)
    _, tab = ht.join_build(b)
    assert torch.equal(cnt, ht.join_probe(tab, p)[1])


def test_broadcast_probe_checks_its_inputs():
    p = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="2048"):
        pt.broadcast_probe(torch.zeros(2049, dtype=torch.int64), p)
    with pytest.raises(TypeError, match="int64"):
        pt.broadcast_probe(torch.zeros(4, dtype=torch.int32), p)
    lo, cnt = pt.broadcast_probe(torch.zeros(0, dtype=torch.int64), p)
    assert not lo.any() and not cnt.any()
    u = torch.tensor([1, 5], dtype=torch.int64).to(torch.uint64)
    lo, cnt = pt.broadcast_probe(u, torch.tensor([5, 9, 0]))
    assert lo.tolist() == [1, 2, 0] and cnt.tolist() == [1, 0, 0]
