"""K1, the port's fused filter+project (arrow1_tpu_torch/kernels/
fused_ops.py), held against the JAX package on the same seeded inputs:

- against the JAX engine's own filter ``(f > t) & (v > vthr)`` and
  projection ``v * 2.0 + f`` on the CPU: bit-exact, both round once per
  IEEE f64 operation;
- against the JAX Pallas kernel ``compact_fused`` in interpret mode: keys
  and count exact, the projection within a relative 1e-13, because that
  kernel computes in float-float (two f32), not IEEE f64.

The JAX answers are computed once, on a thread pool (fixture
``jax_results``), so that the compiles of independent calls overlap.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

import arrow1_tpu as a1t
import arrow1_tpu.compute as ac
from arrow1_tpu.kernels.compaction_v15 import compact_fused
from arrow1_tpu.kernels.dd import np_dd_split
from arrow1_tpu.kernels.fused_ops import flagship_filter_project

import arrow1_tpu_torch as pt
from arrow1_tpu_torch.kernels.fused_ops import (filter_project_flagship,
                                                filter_project_plain)
from test_torch_answers import answers_of


def _data(n, seed=0):
    """bench.py's recipe: key in [0, 2^20), v in [-2^30, 2^30), f ~ N(0,1)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 20, n).astype(np.int64),
            rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
            rng.standard_normal(n))


def _vthr(sel):
    """bench.py's threshold: with f > 0 keeping half, P(v > vthr) = 2*sel
    gives the combined selectivity sel."""
    return int((1.0 - 2.0 * min(2.0 * sel, 1.0)) * (1 << 30))


# the last threshold has a negative low word, the packing trap of the
# TPU kernel's int32 parameters; the port passes it as one int64
ENGINE_CASES = [(0.0, _vthr(0.25)), (0.0, _vthr(0.5)),
                (-0.5, -(1 << 31) - 5), (0.3, 1 << 29)]
KERNEL_SELS = [0.25, 0.5]
ROWS = 8   # the Pallas kernel's tile rows


def _engine_data(vthr):
    return _data(3001, seed=abs(vthr) % 97)


def _jax_engine(thresh, vthr):
    key, v, f = _engine_data(vthr)
    jb = a1t.record_batch(pa.record_batch({"key": key, "v": v, "f": f}))
    mask = ((a1t.field("f") > thresh) & (a1t.field("v") > vthr)).execute(jb)
    kept = ac.filter(jb, mask)
    jproj = (a1t.field("v") * 2.0 + a1t.field("f")).execute(kept)
    return np.asarray(kept["key"].data), np.asarray(jproj.data)


def _kernel_data(sel):
    return _data(4 * ROWS * 128, seed=int(sel * 100))


def _jax_kernel(sel):
    key, v, f = _kernel_data(sel)
    fh, fl = np_dd_split(f)
    planes = tuple(jnp.asarray(x) for x in (
        (key & 0xFFFFFFFF).astype(np.uint32).view(np.int32).copy(),
        (key >> 32).astype(np.int32),
        (v & 0xFFFFFFFF).astype(np.uint32).view(np.int32).copy(),
        (v >> 32).astype(np.int32),
        fh.view(np.int32).copy(), fl.view(np.int32).copy()))
    (oklo, okhi, oph, opl), jcount, ovf = compact_fused(
        planes, flagship_filter_project, 4,
        params=_v15_params(_vthr(sel), 0.0), interpret=True, rows=ROWS,
        band=ROWS + 9)
    jk = int(jcount)
    jkey = (np.asarray(okhi[:jk]).astype(np.int64) << 32) | \
        np.asarray(oklo[:jk]).view(np.uint32).astype(np.int64)
    jproj = (np.asarray(oph[:jk]).view(np.float32).astype(np.float64)
             + np.asarray(opl[:jk]).view(np.float32).astype(np.float64))
    return bool(ovf), jkey, jproj


def reference_answers():
    """Every JAX answer the tests compare against, computed once."""
    calls = {("engine",) + c: (_jax_engine, c) for c in ENGINE_CASES}
    calls.update({("kernel", sel): (_jax_kernel, (sel,))
                  for sel in KERNEL_SELS})
    with ThreadPoolExecutor(len(calls)) as ex:
        futs = {k: ex.submit(fn, *args) for k, (fn, args) in calls.items()}
        return {k: f.result() for k, f in futs.items()}


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


@pytest.mark.parametrize("thresh,vthr", ENGINE_CASES)
def test_plain_matches_jax_engine_filter_project(thresh, vthr, jax_results):
    key, v, f = _engine_data(vthr)
    want_key, want_proj = jax_results[("engine", thresh, vthr)]
    kout, pout, count = filter_project_flagship(
        torch.from_numpy(key), torch.from_numpy(v), torch.from_numpy(f),
        thresh, vthr)
    k = int(count)
    assert k == len(want_key)
    np.testing.assert_array_equal(kout.numpy()[:k], want_key)
    np.testing.assert_array_equal(pout.numpy()[:k].view(np.int64),
                                  want_proj.view(np.int64))


def test_plain_matches_port_engine_filter_project():
    """The port's own engine path (expressions + filter) agrees bit for
    bit with the fused function."""
    key, v, f = _data(2048, seed=4)
    tb = pt.record_batch({"key": key, "v": v, "f": f}, device="cpu")
    vthr = _vthr(0.4)
    mask = ((pt.field("f") > 0.1) & (pt.field("v") > vthr)).execute(tb)
    kept = pt.filter(tb, mask)
    proj = (pt.field("v") * 2.0 + pt.field("f")).execute(kept)
    kout, pout, count = filter_project_plain(tb["key"].data, tb["v"].data,
                                             tb["f"].data, 0.1, vthr)
    k = int(count)
    assert torch.equal(kout[:k], kept["key"].data)
    assert torch.equal(pout[:k].view(torch.int64),
                       proj.data.view(torch.int64))


def _v15_params(vthr, thresh):
    th = np.float32(thresh)
    tl = np.float32(np.float64(thresh) - np.float64(th))
    return jnp.asarray(np.array(
        [vthr & 0xFFFFFFFF, (vthr >> 32) & 0xFFFFFFFF,
         th.view(np.int32), tl.view(np.int32), 0, 0],
        np.int64).astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("sel", KERNEL_SELS)
def test_plain_matches_jax_fused_kernel(sel, jax_results):
    key, v, f = _kernel_data(sel)
    ovf, jkey, jproj = jax_results[("kernel", sel)]
    assert not ovf
    kout, pout, count = filter_project_flagship(
        torch.from_numpy(key), torch.from_numpy(v), torch.from_numpy(f),
        0.0, _vthr(sel))
    k = int(count)
    assert k == len(jkey)
    np.testing.assert_array_equal(kout.numpy()[:k], jkey)
    np.testing.assert_allclose(pout.numpy()[:k], jproj, rtol=1e-13, atol=0)


def test_out_limit_and_empty():
    key, v, f = _data(1000, seed=9)
    kout, pout, count = filter_project_flagship(
        torch.from_numpy(key), torch.from_numpy(v), torch.from_numpy(f),
        0.0, 0, out_limit=10)
    assert kout.shape == pout.shape == (10,)
    full = (f > 0.0) & (v > 0)
    assert int(count) == int(full.sum())
    np.testing.assert_array_equal(kout.numpy(), key[full][:10])
    e = torch.zeros(0, dtype=torch.int64)
    kout, pout, count = filter_project_flagship(
        e, e, torch.zeros(0, dtype=torch.float64), 0.0, 0)
    assert kout.shape == (0,) and int(count) == 0


def test_rejects_wrong_dtypes():
    x = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        filter_project_flagship(x, x, x, 0.0, 0)
