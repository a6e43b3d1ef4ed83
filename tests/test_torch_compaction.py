"""K2, the port's order-preserving compaction (arrow1_tpu_torch/kernels/
compaction.py), and the port's ``filter`` held against the JAX package on
the same seeded inputs.

The JAX side runs its Pallas compaction in interpret mode, as its own
tests do on the CPU. Results are bit-exact: compaction moves bits. The
JAX answers are computed once, on a thread pool (fixture
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
from arrow1_tpu.kernels.compaction_v4 import compact as jax_compact

import arrow1_tpu_torch as pt
from arrow1_tpu_torch.kernels.compaction import compact
import test_torch_answers


def _columns(rng, n):
    """Mixed fixed-width columns: i64, f64 (raw normal draws), i32, f32,
    bool, and a validity stream."""
    return [rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64),
            rng.standard_normal(n),
            rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
            rng.standard_normal(n).astype(np.float32),
            rng.random(n) < 0.5,
            rng.random(n) < 0.9]


def _bits(a: np.ndarray) -> np.ndarray:
    """Bit pattern of a float array (exact comparison through NaN/-0.0)."""
    return a.view({8: np.int64, 4: np.int32}[a.itemsize]) \
        if a.dtype.kind == "f" else a


COMPACT_NS = [1, 1000, 5000]
COMPACT_SELS = [0.0, 0.3, 1.0]
FILTER_CASES = [(0.0, "drop"), (0.3, "drop"), (0.3, "emit_null"),
                (0.3, None), (1.0, "emit_null")]
PADDED_SELS = [0.0, 0.4, 1.0]


def _compact_inputs(n, sel):
    rng = np.random.default_rng(1000 * n + int(10 * sel))
    cols = _columns(rng, n)
    return rng.random(n) < sel, cols


def _jax_compact(n, sel):
    mask, cols = _compact_inputs(n, sel)
    # the JAX kernel takes f64 as its int64 bit view (TPU restriction)
    jcols = tuple(jnp.asarray(c.view(np.int64) if c.dtype == np.float64
                              else c) for c in cols)
    jouts, jcount = jax_compact(jnp.asarray(mask), jcols, interpret=True)
    return [np.asarray(o) for o in jouts], int(jcount)


def _filter_inputs(sel, nulls):
    rng = np.random.default_rng(int(sel * 10) + 3)
    n = 1237
    rb = _batch(rng, n)
    m = rng.random(n) < sel
    mnull = rng.random(n) < 0.2 if nulls else None
    return rb, pa.array(m, mask=mnull)


def _jax_filter(sel, nulls):
    rb, marr = _filter_inputs(sel, nulls)
    kw = {} if nulls is None else {"null_selection_behavior": nulls}
    return ac.filter(a1t.record_batch(rb),
                     a1t.record_batch(pa.record_batch({"m": marr}))["m"],
                     **kw).to_arrow()


def _padded_mask(sel):
    return np.random.default_rng(7).random(777) < sel


def _jax_padded(sel):
    from arrow1_tpu.ops.padded import filter_padded as jax_filter_padded

    jidx, jcount = jax_filter_padded(jnp.asarray(_padded_mask(sel)))
    return np.asarray(jidx), int(jcount)


@pytest.fixture(scope="module")
def jax_results():
    """Every JAX answer the tests compare against, computed once (after
    starting the workers that compute the later files' answers)."""
    test_torch_answers.start()
    calls = {("compact", n, sel): (_jax_compact, (n, sel))
             for n in COMPACT_NS for sel in COMPACT_SELS}
    calls.update({("filter",) + c: (_jax_filter, c) for c in FILTER_CASES})
    calls.update({("padded", sel): (_jax_padded, (sel,))
                  for sel in PADDED_SELS})
    with ThreadPoolExecutor(len(calls)) as ex:
        futs = {k: ex.submit(fn, *args) for k, (fn, args) in calls.items()}
        return {k: f.result() for k, f in futs.items()}


@pytest.mark.parametrize("n", COMPACT_NS)
@pytest.mark.parametrize("sel", COMPACT_SELS)
def test_compact_plain_matches_jax_kernel(n, sel, jax_results):
    mask, cols = _compact_inputs(n, sel)
    jouts, jcount = jax_results[("compact", n, sel)]
    outs, count = compact(torch.from_numpy(mask),
                          [torch.from_numpy(c) for c in cols])
    assert int(count) == jcount == int(mask.sum())
    k = int(count)
    for c, o, jo in zip(cols, outs, jouts):
        assert o.shape == (n,) and o.dtype == torch.from_numpy(c).dtype
        got = _bits(o.numpy()[:k])
        ref = jo[:k]
        np.testing.assert_array_equal(got, _bits(ref.view(c.dtype)
                                                  if c.dtype == np.float64
                                                  else ref))
        np.testing.assert_array_equal(got, _bits(c[mask]))


@pytest.mark.parametrize("out_limit", [0, 7, 10_000])
def test_compact_out_limit_truncates_but_counts_all(out_limit):
    rng = np.random.default_rng(5)
    n = 3000
    mask = rng.random(n) < 0.5
    x = rng.integers(0, 1 << 40, n).astype(np.int64)
    (out,), count = compact(torch.from_numpy(mask), [torch.from_numpy(x)],
                            out_limit=out_limit)
    assert int(count) == int(mask.sum())
    assert out.shape == (min(out_limit, n),)
    k = min(out_limit, int(count))
    np.testing.assert_array_equal(out.numpy()[:k], x[mask][:k])


def test_compact_empty_and_no_columns():
    (out,), count = compact(torch.zeros(0, dtype=torch.bool),
                            [torch.zeros(0, dtype=torch.int64)])
    assert out.shape == (0,) and int(count) == 0
    outs, count = compact(torch.tensor([True, False, True]), [])
    assert outs == () and int(count) == 2


def test_compact_rejects_bad_inputs():
    with pytest.raises(TypeError):
        compact(torch.ones(4, dtype=torch.int32), [])
    with pytest.raises(ValueError):
        compact(torch.ones(4, dtype=torch.bool),
                [torch.zeros(5, dtype=torch.int64)])
    with pytest.raises(TypeError):
        compact(torch.ones(2, dtype=torch.bool),
                [torch.zeros(2, dtype=torch.complex128)])


def _batch(rng, n):
    """The state both engines ingest: numeric columns with nulls."""
    data = {
        "i": rng.integers(-1000, 1000, n).astype(np.int64),
        "f": rng.standard_normal(n),
        "h": rng.integers(-5, 5, n).astype(np.int32),
        "b": rng.random(n) < 0.5,
    }
    nulls = {k: rng.random(n) < 0.1 for k in data}
    return pa.record_batch({k: pa.array(v, mask=nulls[k])
                            for k, v in data.items()})


@pytest.mark.parametrize("sel,nulls", FILTER_CASES)
def test_filter_matches_jax_filter(sel, nulls, jax_results):
    rb, marr = _filter_inputs(sel, nulls)
    kw = {} if nulls is None else {"null_selection_behavior": nulls}
    want = jax_results[("filter", sel, nulls)]
    mask = pt.record_batch(pa.record_batch({"m": marr}), device="cpu")["m"]
    got = pt.filter(pt.record_batch(rb, device="cpu"), mask, **kw).to_arrow()
    assert got.equals(want), (got.to_pydict(), want.to_pydict())


@pytest.mark.parametrize("sel", PADDED_SELS)
def test_filter_padded_matches_jax(sel, jax_results):
    from arrow1_tpu_torch.ops.padded import filter_padded

    jidx, jcount = jax_results[("padded", sel)]
    idx, count = filter_padded(torch.from_numpy(_padded_mask(sel)))
    assert int(count) == jcount
    np.testing.assert_array_equal(idx.numpy(), jidx)


def test_filter_column_and_registry_name():
    col = pt.record_batch({"x": np.arange(10)}, device="cpu")["x"]
    mask = pt.record_batch({"m": np.arange(10) % 3 == 0}, device="cpu")["m"]
    got = pt.call_function("filter", [col, mask])
    assert got.to_pylist() == [0, 3, 6, 9]
    idx = pt.record_batch({"i": np.array([9, 0, 4])}, device="cpu")["i"]
    assert pt.take(col, idx).to_pylist() == [9, 0, 4]
    with pytest.raises(IndexError):
        pt.take(col, pt.record_batch({"i": np.array([10])},
                                     device="cpu")["i"])
