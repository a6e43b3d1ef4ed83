"""The plain versions of the port's group-accumulator kernels against the
JAX package's XLA oracles, on the same inputs made with numpy.

K3 (``segment_sums_plain``) must equal ``segment_sums_oracle`` exactly,
int64 extremes and dead rows included: the oracle is given the raw 64-bit
values as eight 8-bit planes with no bias, so its sums are the raw values
mod 2^64, the port's contract.
segsum v1 (``segment_sum_count_plain``) must give the oracle's counts
exactly and its f32 sums to within 1e-5 of the group's sum of |v|: the
two add the same f32 values in orders that may differ.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow1_tpu.kernels.segsum import segment_sum_count_xla
from arrow1_tpu.kernels.segsum2 import ColPlanes, segment_sums_oracle

from arrow1_tpu_torch.kernels.segsum import (segment_sum_count,
                                             segment_sum_count_plain)
from arrow1_tpu_torch.kernels.segsum2 import segment_sums, \
    segment_sums_plain

I64 = np.iinfo(np.int64)


def _words(v: np.ndarray):
    u = v.view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (u >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return jnp.asarray(lo), jnp.asarray(hi)


def _case(G, n, seed, extremes=False):
    """gid in [0, G] (G is a dead row), a masked column, an unmasked
    summed column and a masked count-only column."""
    rng = np.random.default_rng(seed)
    gid = rng.integers(0, G + 1, n).astype(np.int32)
    if extremes:
        a = rng.choice([I64.max, I64.min, I64.max - 1, I64.min + 1, -1, 1],
                       n).astype(np.int64)
    else:
        a = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    b = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    live_a = rng.random(n) < 0.9
    live_c = rng.random(n) < 0.5
    return gid, [(a, live_a), (b, None), (None, live_c)]


@functools.partial(jax.jit, static_argnums=(3,))
def _oracle(gid, words, lives, G):
    """segment_sums_oracle under jit (one compile per shape instead of
    one per operation; integer scatters give the same result): each
    column with values is eight 8-bit planes, unbiased."""
    cols = [ColPlanes(w if w is not None else (), m,
                      8 if w is not None else 0)
            for w, m in zip(words, lives)]
    return segment_sums_oracle(gid, cols, G)


@pytest.mark.parametrize("G,n,extremes", [
    (128, 2000, True), (4096, 2000, False), (131072, 2000, False),
    (128, 0, False)])
def test_segment_sums_plain_matches_oracle(G, n, extremes):
    gid, cols = _case(G, n, seed=G + n, extremes=extremes)
    occ_o, res_o = _oracle(
        jnp.asarray(gid),
        [None if v is None else _words(v) for v, _ in cols],
        [None if m is None else jnp.asarray(m) for _, m in cols], G)
    tcols = [(None if v is None else torch.from_numpy(v),
              None if m is None else torch.from_numpy(m)) for v, m in cols]
    occ, res = segment_sums_plain(torch.from_numpy(gid), tcols, G)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_o))
    for (cnt, s), (cnt_o, s_o) in zip(res, res_o):
        np.testing.assert_array_equal(cnt.numpy(), np.asarray(cnt_o))
        assert (s is None) == (s_o is None)
        if s is not None:
            np.testing.assert_array_equal(s.numpy().view(np.uint64),
                                          np.asarray(s_o))
    # the wrapper takes the plain version for CPU tensors
    occ_w, res_w = segment_sums(torch.from_numpy(gid), tcols, G)
    assert torch.equal(occ_w, occ)
    assert all(torch.equal(a, b) for (a, _), (b, _) in zip(res_w, res))


def test_segment_sum_count_plain_matches_xla():
    rng = np.random.default_rng(1)
    n, G = 4096, 256
    gid = rng.integers(0, G + 1, n).astype(np.int32)   # G: dead rows
    val = rng.standard_normal(n).astype(np.float32)
    live = rng.random(n) < 0.9
    s_o, c_o = segment_sum_count_xla(jnp.asarray(gid), jnp.asarray(val),
                                     jnp.asarray(live), G)
    s, c = segment_sum_count_plain(torch.from_numpy(gid),
                                   torch.from_numpy(val),
                                   torch.from_numpy(live), G)
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_o))
    keep = live & (gid < G)
    abs_sum = np.bincount(gid[keep], np.abs(val[keep]), minlength=G)
    assert np.all(np.abs(s.numpy() - np.asarray(s_o)) <= 1e-5 * abs_sum)
    s_w, c_w = segment_sum_count(torch.from_numpy(gid),
                                 torch.from_numpy(val),
                                 torch.from_numpy(live), G)
    assert torch.equal(s_w, s) and torch.equal(c_w, c)


def test_wrappers_check_inputs_and_devices():
    gid = torch.zeros(4, dtype=torch.int32)
    v = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(TypeError, match="int32"):
        segment_sums(gid.long(), [(v, None)], 8)
    with pytest.raises(TypeError):
        segment_sums(gid, [(v.int(), None)], 8)
    with pytest.raises(ValueError, match="positive"):
        segment_sums(gid, [], 0)
    with pytest.raises(TypeError):
        segment_sum_count(gid, v.float(), torch.ones(3, dtype=torch.bool), 8)
    # a tensor on neither the CPU nor CUDA gets no silent plain version
    meta = gid.to("meta")
    with pytest.raises(TypeError, match="no kernel"):
        segment_sums(meta, [], 8)
    with pytest.raises(TypeError, match="no kernel"):
        segment_sum_count(meta, v.float().to("meta"),
                          torch.ones(4, dtype=torch.bool, device="meta"), 8)
    before = (segment_sums.launches, segment_sum_count.launches)
    segment_sums(gid, [(v, None)], 8)
    segment_sum_count(gid, v.float(), torch.ones(4, dtype=torch.bool), 8)
    assert (segment_sums.launches, segment_sum_count.launches) == before
