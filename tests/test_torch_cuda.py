"""The port's CUDA kernels against their plain PyTorch versions, and the
compiled pipeline, the eager group_by and the joins on the card against
the same calls on the CPU.

These need an NVIDIA GPU and skip elsewhere. The file imports neither JAX
nor the JAX package, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import arrow1_tpu_torch as pt
from arrow1_tpu_torch.kernels.compaction import (compact, compact_plain,
                                                 compact_u64,
                                                 compact_u64_plain)
from arrow1_tpu_torch.kernels.compaction_split import (compact_split,
                                                       compact_split_plain)
from arrow1_tpu_torch.kernels.fused_ops import (filter_project_flagship,
                                                filter_project_plain)
from arrow1_tpu_torch.kernels.hashtable import (broadcast_probe,
                                                broadcast_probe_plain)
from arrow1_tpu_torch.kernels.probes import run_probe, run_probes
from arrow1_tpu_torch.kernels.segsum import (segment_sum_count,
                                             segment_sum_count_plain)
from arrow1_tpu_torch.kernels.segsum2 import segment_sums, \
    segment_sums_plain

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


def _segsum_cols(rng, n, ncols, dev):
    """Columns of every kind: masked sums, unmasked sums, masked counts
    and unmasked counts, round robin."""
    cols = []
    for i in range(ncols):
        vals = torch.from_numpy(rng.integers(
            np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
            dtype=np.int64)).to(dev) if i % 4 < 2 else None
        live = torch.from_numpy(rng.random(n) < 0.9).to(dev) \
            if i % 2 == 0 else None
        cols.append((vals, live))
    return cols


# G: one group, shared memory (1000, 4096), global atomics (20000 with many
# slots, 131072); 40 columns take two launches of the kernel's 32
@pytest.mark.parametrize("G,ncols", [(1, 3), (1000, 4), (4096, 2),
                                     (20000, 4), (131072, 4), (1000, 40)])
@pytest.mark.parametrize("n", [1, 100_003])
def test_segment_sums_kernel_matches_plain(cuda, G, ncols, n):
    rng = np.random.default_rng(G + n)
    gid = torch.from_numpy(rng.integers(-1, G + 2, n).astype(np.int32)).to(
        cuda)   # ids outside [0, G) count nowhere
    cols = _segsum_cols(rng, n, ncols, cuda)
    before = segment_sums.launches
    occ, res = segment_sums(gid, cols, G)
    assert segment_sums.launches == before + 1
    occ_p, res_p = segment_sums_plain(gid, cols, G)
    assert torch.equal(occ, occ_p)
    for (c, s), (cp, sp) in zip(res, res_p):
        assert torch.equal(c, cp)
        assert (s is None) == (sp is None)
        if s is not None:
            assert torch.equal(s, sp)


@pytest.mark.parametrize("G", [1, 256, 4096, 40_000])
def test_segment_sum_count_kernel_matches_plain(cuda, G):
    rng = np.random.default_rng(G)
    n = 200_003
    gid = torch.from_numpy(rng.integers(0, G + 1, n).astype(np.int32)).to(
        cuda)
    val = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        cuda)
    live = torch.from_numpy(rng.random(n) < 0.9).to(cuda)
    before = segment_sum_count.launches
    s, c = segment_sum_count(gid, val, live, G)
    assert segment_sum_count.launches == before + 1
    sp, cp = segment_sum_count_plain(gid, val, live, G)
    assert torch.equal(c, cp)   # counts are exact below 2^24
    keep = live & (gid < G)
    abs_sum = torch.zeros(G + 1, dtype=torch.float64, device=cuda)
    abs_sum.index_add_(0, gid.long(), torch.where(keep, val.abs(), 0.0)
                       .double())
    # the atomics add in another order: a stated 1e-5 of the group's sum
    # of |v|
    assert bool(((s.double() - sp.double()).abs()
                 <= 1e-5 * abs_sum[:G]).all())


@pytest.mark.parametrize("aggs", [
    [("v", "sum"), ("v", "mean"), ("w", "count"), ("w", "sum")],   # K3
    [("v", "sum"), ("v", "min"), ("w", "max"), ("v", "count")]])   # sorted
def test_group_by_on_card_matches_cpu(cuda, aggs):
    rng = np.random.default_rng(0)
    n = 1 << 18
    data = {"k": rng.integers(0, 5000, n).astype(np.int64),
            "v": rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
            "w": rng.integers(-100, 100, n).astype(np.int32)}
    valid = rng.random(n) >= 0.1
    batches = []
    for dev in (cuda, "cpu"):
        b = pt.record_batch(data, device=dev)
        w = pt.Column(b["w"].data, b["w"].dtype,
                      validity=torch.from_numpy(valid).to(dev))
        batches.append(pt.RecordBatch((b["k"], b["v"], w), b.names))
    before = segment_sums.launches
    got = pt.group_by(batches[0], ["k"], aggs)
    dense = aggs[1][1] == "mean"
    assert segment_sums.launches == before + int(dense)
    want = pt.group_by(batches[1], ["k"], aggs)
    assert got.to_pydict() == want.to_pydict()


def _k4_keys(T, n, seed):
    """A sorted u64 build with duplicate runs and keys at and above 2^63
    (int64 bit patterns), the extremes 0 and 2^64 - 1, and probes half
    drawn from the build."""
    rng = np.random.default_rng(seed)
    distinct = rng.integers(0, 1 << 64, max(T // 3, 1), dtype=np.uint64)
    build = np.sort(rng.choice(distinct, T))
    if T > 2:
        build[0], build[-1] = 0, np.iinfo(np.uint64).max
    probe = np.concatenate([rng.choice(build, n // 2),
                            rng.integers(0, 1 << 64, n - n // 2,
                                         dtype=np.uint64)])
    probe[:3] = [0, np.iinfo(np.uint64).max, 1 << 63]
    return (torch.from_numpy(build.view(np.int64)),
            torch.from_numpy(probe.view(np.int64)))


@pytest.mark.parametrize("T", [1, 2, 255, 2048])
@pytest.mark.parametrize("n", [3, 16384, 1_000_001])
def test_broadcast_probe_kernel_matches_plain(cuda, T, n):
    build, probe = (x.to(cuda) for x in _k4_keys(T, n, T + n))
    before = broadcast_probe.launches
    lo, cnt = broadcast_probe(build, probe)
    assert broadcast_probe.launches == before + 1
    plo, pcnt = broadcast_probe_plain(build, probe)
    assert torch.equal(lo, plo) and torch.equal(cnt, pcnt)
    # an odd offset into the probe (the wrapper realigns it)
    lo1, cnt1 = broadcast_probe(build, probe[1:])
    assert torch.equal(lo1, plo[1:]) and torch.equal(cnt1, pcnt[1:])


@pytest.mark.parametrize("join_type", ["inner", "left outer", "full outer",
                                       "right semi"])
def test_join_on_card_matches_cpu(cuda, join_type):
    rng = np.random.default_rng(1)
    n, m = 1 << 16, 1 << 12
    left = {"k": rng.integers(0, 5000, n).astype(np.int64),
            "v": rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64)}
    right = {"k": rng.integers(0, 5000, m).astype(np.int64),
             "w": rng.standard_normal(m)}
    got = pt.join(pt.record_batch(left, device=cuda),
                  pt.record_batch(right, device=cuda), "k",
                  join_type=join_type)
    want = pt.join(pt.record_batch(left, device="cpu"),
                   pt.record_batch(right, device="cpu"), "k",
                   join_type=join_type)
    assert got.to_pydict() == want.to_pydict()


def test_compiled_join_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(2)
    n = 1 << 16
    facts = {"k": rng.integers(0, 3000, n).astype(np.int64),
             "v": rng.integers(-100, 100, n).astype(np.int64)}
    dims = {"k": np.arange(2000, dtype=np.int64),
            "w": rng.integers(0, 1 << 20, 2000).astype(np.int64)}
    outs = []
    for dev in (cuda, "cpu"):
        pipe = (pt.PipelineBuilder().filter(pt.field("v") > 0)
                .join(pt.record_batch(dims, device=dev), "k", fanout=1,
                      join_type="left outer")
                .group_by(["k"], [("w", "sum"), ("v", "count")],
                          max_groups=4096)
                .compile())
        outs.append(pipe(pt.record_batch(facts, device=dev)).to_pydict())
    assert outs[0] == outs[1]


def _u64_inputs(n, sel, seed, dev):
    """i64 extremes, u64 keys at and above 2^63 and f64 bit views (NaN
    payloads, -0.0), with a mask of selectivity ``sel``."""
    rng = np.random.default_rng(seed)
    i64 = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64,
                       endpoint=True)
    i64[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max]
    u64 = rng.integers(1 << 63, (1 << 64) - 1, n, dtype=np.uint64,
                       endpoint=True)
    f64 = rng.standard_normal(n)
    f64[:2] = [-0.0, np.nan]
    bits = f64.view(np.int64).copy()
    bits[2 % n] = np.int64(0x7FF0000000000BAD)   # a NaN payload
    mask = rng.random(n) < sel
    return (torch.from_numpy(mask).to(dev),
            [torch.from_numpy(i64).to(dev),
             torch.from_numpy(u64).to(dev),
             torch.from_numpy(bits).to(dev)])


@pytest.mark.parametrize("fn,plain", [(compact_u64, compact_u64_plain),
                                      (compact_split, compact_split_plain)],
                         ids=["compact_u64", "compact_split"])
@pytest.mark.parametrize("n", [1024, 4096, 1 << 20, 4_097 * 1024])
@pytest.mark.parametrize("sel", [0.0, 0.25, 0.5, 1.0])
def test_u64_compaction_kernels_match_plain(cuda, fn, plain, n, sel):
    mask, cols = _u64_inputs(n, sel, n + int(sel * 100), cuda)
    before = fn.launches
    outs, count = fn(mask, cols)
    torch.cuda.synchronize()
    assert fn.launches > before
    pouts, pcount = plain(mask, cols)
    k = int(pcount)
    assert count.dtype == torch.int32 and count.dim() == 0
    assert int(count) == k
    ref, _ = compact(mask, [c.view(torch.int64) for c in cols])
    for o, p, c, r in zip(outs, pouts, cols, ref):
        assert o.shape == (n + 1024,) and o.dtype == c.dtype
        assert torch.equal(o.view(torch.int64)[:k], p.view(torch.int64)[:k])
        assert torch.equal(o.view(torch.int64)[:k], r[:k])


def test_probes_on_card_are_ok(cuda):
    before = dict(run_probe.launches)
    report = run_probes(cuda)
    assert report and all(v == "OK" for v in report.values()), report
    assert all(run_probe.launches[name] == before[name] + 1
               for name in before)
