"""The port's probe matrix (arrow1_tpu_torch/kernels/probes.py): each
probe's plain PyTorch version against the jnp form of the body of the
JAX package's probe (arrow1_tpu/kernels/tpu_probes.py), which returns
no values itself, on its inputs and on a seeded input with negative
values. int32 results must match exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from arrow1_tpu_torch.kernels import probes

R, L = probes.R, probes.L


def _dma_matmul(x):
    """tpu_probes.k_dma's body over every [R, L] tile: (x % 2) @ tri."""
    m = (x % 2).astype(jnp.float32)
    tri = (jax.lax.broadcasted_iota(jnp.int32, (L, L), 0) <=
           jax.lax.broadcasted_iota(jnp.int32, (L, L), 1)
           ).astype(jnp.float32)
    return jnp.dot(m, tri, preferred_element_type=jnp.float32,
                   precision=jax.lax.Precision.HIGHEST).astype(jnp.int32)


def _dma_in_when(x):
    """tpu_probes.k_when: even tiles are copied; the odd ones, never
    written there, are the port's zeros."""
    out = jnp.zeros_like(x)
    for i in range(0, x.shape[0] // R, 2):
        out = out.at[i * R:(i + 1) * R].set(x[i * R:(i + 1) * R])
    return out


JNP_BODIES = {
    "blocked-1d": lambda x: x * 2,
    "blocked-2d": lambda x: x * 2,
    "manual-dma-matmul": _dma_matmul,
    "cumsum-1d": jnp.cumsum,
    "smem-output": lambda x: jnp.sum(x).reshape(1),
    "dma-in-when": _dma_in_when,
}


def _inputs(kind, seed):
    if seed is None:   # the reference's own inputs
        return probes.probe_inputs("cpu")[kind].numpy()
    rng = np.random.default_rng(seed)
    shape = (4 * R * L,) if kind == "x1" else (4 * R, L)
    return rng.integers(-1000, 1000, shape).astype(np.int32)


@pytest.mark.parametrize("seed", [None, 5], ids=["reference", "seeded"])
@pytest.mark.parametrize("name", list(probes.PROBES))
def test_plain_probe_matches_jnp_body(name, seed):
    x = _inputs(probes.PROBES[name][1], seed)
    got = probes.run_probe(name, torch.from_numpy(x))
    want = np.asarray(JNP_BODIES[name](jnp.asarray(x)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


def test_run_probes_reports_the_reference_names():
    report = probes.run_probes("cpu")
    assert list(report) == list(probes.PROBES) + ["bitcast-i64-i32x2",
                                                  "bitcast-f64-i64"]
    assert all(v == "OK" for v in report.values()), report
    assert not any(probes.run_probe.launches.values())   # no kernel here
    i64 = np.array([1, -2], dtype=np.int64)
    np.testing.assert_array_equal(
        torch.from_numpy(i64).view(torch.int32).numpy(),
        np.asarray(jax.lax.bitcast_convert_type(jnp.asarray(i64),
                                                jnp.int32)).reshape(-1))


def test_probe_input_checks():
    with pytest.raises(TypeError, match="int32"):
        probes.run_probe("blocked-1d", torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError, match=r"\[8k, 128\]"):
        probes.run_probe("blocked-2d", torch.zeros(4, L, dtype=torch.int32))
