"""The port's compact_u64 and compact_split (arrow1_tpu_torch/kernels/
compaction.py, compaction_split.py) held against the JAX package's own
oracle for both Pallas kernels, ``compact_u64_xla``
(arrow1_tpu/kernels/compaction.py), on the same seeded inputs.

On the CPU each entry point runs its plain version; no Pallas interpreter
runs here. Compaction moves bits, so the kept prefix must match exactly:
int64 extremes, uint64 keys at and above 2^63, and float64 bit views with
NaN payloads and -0.0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow1_tpu.kernels.compaction import compact_u64_xla

from arrow1_tpu_torch.kernels.compaction import TILE, compact_u64
from arrow1_tpu_torch.kernels.compaction_split import compact_split

FUNCTIONS = {"compact_u64": compact_u64, "compact_split": compact_split}
_ORACLE = jax.jit(compact_u64_xla)


def _inputs(n, sel, seed):
    rng = np.random.default_rng(seed)
    i64 = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                       dtype=np.int64, endpoint=True)
    i64[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    u64 = rng.integers(1 << 63, (1 << 64) - 1, n, dtype=np.uint64,
                       endpoint=True)
    u64[:2] = [1 << 63, (1 << 64) - 1]
    f64 = rng.standard_normal(n)
    f64[:2] = [-0.0, np.inf]
    bits = f64.view(np.int64).copy()
    bits[2] = np.int64(0x7FF0000000000BAD)             # a signalling NaN
    bits[3] = np.int64(np.uint64(0xFFF8000000C0FFEE))  # a negative qNaN
    mask = rng.random(n) < sel
    mask[:4] |= sel > 0   # the edge values are kept whenever any row is
    return mask, [i64, u64, bits]


@pytest.mark.parametrize("name", list(FUNCTIONS))
@pytest.mark.parametrize("n", [TILE, 4 * TILE])
@pytest.mark.parametrize("sel", [0.0, 0.25, 0.5, 1.0])
def test_plain_matches_jax_oracle(name, n, sel):
    mask, cols = _inputs(n, sel, seed=n + int(100 * sel))
    outs, count = FUNCTIONS[name](torch.from_numpy(mask),
                                  [torch.from_numpy(c) for c in cols])
    jouts, jcount = _ORACLE(jnp.asarray(mask),
                            tuple(jnp.asarray(c) for c in cols))
    k = int(jcount)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == k == int(mask.sum())
    for c, o, jo in zip(cols, outs, jouts):
        assert o.shape == (n + TILE,)
        assert o.dtype == torch.from_numpy(c).dtype
        got = o.numpy()[:k]
        np.testing.assert_array_equal(got.view(np.int64),
                                      np.asarray(jo)[:k].view(np.int64))
        np.testing.assert_array_equal(got, c[mask])


@pytest.mark.parametrize("name", list(FUNCTIONS))
def test_contract_errors(name):
    fn = FUNCTIONS[name]
    x = torch.zeros(TILE, dtype=torch.int64)
    with pytest.raises(ValueError, match="multiple of 1024"):
        fn(torch.ones(1000, dtype=torch.bool), [x[:1000]])
    with pytest.raises(TypeError, match="int64 or uint64"):
        fn(torch.ones(TILE, dtype=torch.bool), [x.double()])
    with pytest.raises(ValueError, match="does not match"):
        fn(torch.ones(TILE, dtype=torch.bool), [x[:-1]])
    outs, count = fn(torch.zeros(0, dtype=torch.bool),
                     [torch.zeros(0, dtype=torch.int64)])
    assert int(count) == 0 and outs[0].shape == (TILE,)
