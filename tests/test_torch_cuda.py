"""The port's CUDA kernels against their plain PyTorch versions, and the
compiled pipeline on the card against the same pipeline on the CPU.

These need an NVIDIA GPU and skip elsewhere. The file imports neither JAX
nor the JAX package, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import arrow1_tpu_torch as pt
from arrow1_tpu_torch.kernels.compaction import compact, compact_plain
from arrow1_tpu_torch.kernels.fused_ops import (filter_project_flagship,
                                                filter_project_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return torch.device("cuda")


def _bits(t):
    """Integer view of a float tensor, so equality is bit equality."""
    views = {torch.float64: torch.int64, torch.float32: torch.int32}
    return t.view(views[t.dtype]) if t.dtype in views else t


@pytest.mark.parametrize("n", [1, 4097, 100_003])
@pytest.mark.parametrize("sel", [0.0, 0.5, 1.0])
def test_compact_kernel_matches_plain(cuda, n, sel):
    rng = np.random.default_rng(n)
    cols = [torch.from_numpy(c).to(cuda) for c in (
        rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64),
        rng.standard_normal(n),
        rng.integers(-(1 << 31), 1 << 31, n).astype(np.int32),
        rng.standard_normal(n).astype(np.float32),
        rng.random(n) < 0.5)]
    mask = torch.from_numpy(rng.random(n) < sel).to(cuda)
    before = compact.launches
    outs, count = compact(mask, cols)
    assert compact.launches == before + 1
    pouts, pcount = compact_plain(mask, cols)
    k = int(pcount)
    assert int(count) == k
    for o, p in zip(outs, pouts):
        assert torch.equal(_bits(o[:k]), _bits(p[:k]))


def _flagship(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 1 << 20, n).astype(np.int64),
            rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
            rng.standard_normal(n))


@pytest.mark.parametrize("n", [1, 4097, 1_000_003])
@pytest.mark.parametrize("vthr", [-(1 << 31) - 5, 0, 1 << 29])
def test_fused_kernel_matches_plain(cuda, n, vthr):
    key, v, f = (torch.from_numpy(a).to(cuda) for a in _flagship(n, n))
    before = filter_project_flagship.launches
    kout, pout, count = filter_project_flagship(key, v, f, 0.0, vthr)
    assert filter_project_flagship.launches == before + 1
    pk, pp, pc = filter_project_plain(key, v, f, 0.0, vthr)
    k = int(pc)
    assert int(count) == k
    assert torch.equal(kout[:k], pk[:k])
    assert torch.equal(_bits(pout[:k]), _bits(pp[:k]))


@pytest.mark.parametrize("ngroups,max_groups", [(64, 65536),
                                                (100_000, 1 << 17)])
def test_pipeline_on_card_matches_cpu(cuda, ngroups, max_groups):
    rng = np.random.default_rng(0)
    n = 1 << 18
    data = {"k": rng.integers(0, ngroups, n).astype(np.int64),
            "v": rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
            "f": rng.standard_normal(n)}
    pipe = (pt.PipelineBuilder()
            .filter(pt.field("f") > 0.0)
            .project([pt.field("v") * 2 + 1], ["proj"])
            .group_by(["k"], [("proj", "sum"), ("v", "count")],
                      max_groups=max_groups)
            .sort([("proj_sum", "descending")])
            .compile())
    before = compact.launches
    got = pipe(pt.record_batch(data, device=cuda))
    assert compact.launches > before
    want = pipe(pt.record_batch(data, device="cpu"))
    assert got.to_pydict() == want.to_pydict()
