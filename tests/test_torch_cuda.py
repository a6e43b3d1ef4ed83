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
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.kernels.compaction import (compact, compact_plain,
                                                 compact_u64,
                                                 compact_u64_plain)
from arrow1_tpu_torch.kernels.compaction_split import (compact_split,
                                                       compact_split_plain)
from arrow1_tpu_torch.kernels import fused_ops, segsum2
from arrow1_tpu_torch.kernels.fused_ops import (filter_project_flagship,
                                                filter_project_plain)
from arrow1_tpu_torch.kernels.hashtable import (broadcast_probe,
                                                broadcast_probe_plain)
from arrow1_tpu_torch.kernels import build
from arrow1_tpu_torch.kernels.probes import (OPERATORS, PROBES, SOURCE,
                                             plain, probe_inputs, run_probe,
                                             run_probes)
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


def _check_fused(got, want):
    (kout, pout, count), (pk, pp, pc) = got, want
    k = int(pc)
    assert int(count) == k
    m = min(k, kout.shape[0])
    assert kout.shape == pk.shape
    assert torch.equal(kout[:m], pk[:m])
    assert torch.equal(_bits(pout[:m]), _bits(pp[:m]))


def _fused_inputs(n, seed, dev):
    """key and v over the whole int64 range (both extremes present), f
    uniform in [0, 1) with 10% NaN."""
    rng = np.random.default_rng(seed)
    key = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64,
                       endpoint=True)
    v = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64,
                     endpoint=True)
    v[:2] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max][:n]
    f = rng.random(n)
    f[rng.random(n) < 0.1] = np.nan
    return [torch.from_numpy(x).to(dev) for x in (key, v, f)]


# rows around the kernel's tile (one tile - 1, one, one + 1) and many tiles
@pytest.mark.parametrize("size", ["1", "tile-1", "tile", "tile+1", "3M"])
@pytest.mark.parametrize("sel", [0.0, 0.01, 0.5, 1.0])
def test_fused_one_pass_matches_plain(cuda, size, sel):
    tile = fused_ops._kernel()[1]
    n = {"1": 1, "tile-1": tile - 1, "tile": tile, "tile+1": tile + 1,
         "3M": 3_000_017}[size]
    key, v, f = _fused_inputs(n, n, cuda)
    # f > 1 - sel keeps a share sel of the non-NaN rows; v > int64 min
    # all but the one row at the minimum
    args = (key, v, f, 1.0 - sel, -(1 << 63))
    before = filter_project_flagship.launches
    got = filter_project_flagship(*args)
    assert filter_project_flagship.launches == before + 1
    _check_fused(got, filter_project_plain(*args))


@pytest.mark.parametrize("vthr", [-(1 << 63), (1 << 63) - 1])
def test_fused_extreme_vthr_and_nan(cuda, vthr):
    key, v, f = _fused_inputs(100_003, 3, cuda)
    args = (key, v, f, float("-inf"), vthr)   # NaN rows fail f > -inf
    got = filter_project_flagship(*args)
    _check_fused(got, filter_project_plain(*args))
    assert int(got[2]) == (0 if vthr > 0 else
                           int((~torch.isnan(f) & (v > vthr)).sum()))


def test_fused_out_limit_below_count(cuda):
    key, v, f = _fused_inputs(1_000_003, 4, cuda)
    args = (key, v, f, 0.25, -(1 << 63))
    count = int(filter_project_plain(*args)[2])
    for limit in (0, 1, count // 3, count - 1):
        got = filter_project_flagship(*args, out_limit=limit)
        assert got[0].shape == (limit,)
        _check_fused(got, filter_project_plain(*args, out_limit=limit))


@pytest.mark.parametrize("which", ["all", "f"])
def test_fused_misaligned_view(cuda, which):
    """Views one row in: 8 bytes off 16-byte alignment, staged with 8-byte
    copies; all three columns, or only f."""
    key, v, f = _fused_inputs(200_001, 5, cuda)
    views = ([x[1:] for x in (key, v, f)] if which == "all"
             else [key[:-1], v[:-1], f[1:]])
    assert views[2].data_ptr() % 16 == 8
    args = (*views, 0.5, -(1 << 62))
    _check_fused(filter_project_flagship(*args), filter_project_plain(*args))


def test_fused_back_to_back_calls(cuda):
    """50 calls with no synchronise between them: each zeroes its own
    ticket and tile status words on the stream."""
    key, v, f = _fused_inputs(300_007, 6, cuda)
    sels = [0.1 + 0.8 * i / 49 for i in range(50)]
    outs = [filter_project_flagship(key, v, f, 1.0 - s, -(1 << 63))
            for s in sels]
    for s, got in zip(sels, outs):
        _check_fused(got, filter_project_plain(key, v, f, 1.0 - s,
                                               -(1 << 63)))


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


# G: one group, every CTA holding all groups (1000, 4096), a cluster
# sharing them out (20000 with 3 count and 2 sum slots, 131072); 40
# columns take two launches of the kernel's 32
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


def _check_segsum(gid, cols, G):
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


def _segsum_regime_G(where):
    """G on either side of a regime boundary for two columns (a masked
    sum, an unmasked sum: 2 count and 2 sum slots), from the planner and
    the card's shared memory, with the regime expected there."""
    smem = segsum2._kernel()[1]
    top = smem // 24                      # the most one CTA holds
    per_cta = 1 << ((smem // 8).bit_length() - 1)   # counts a CTA owns
    return {"private-top": (top, "private"),
            "owned-bottom": (top + 1, "owned"),
            "owned-2-top": (2 * per_cta, "owned"),
            "owned-4": (2 * per_cta + 1, "owned"),
            "owned-top": (segsum2.OWNED_MAX_CLUSTER * per_cta, "owned"),
            "global-bottom": (segsum2.OWNED_MAX_CLUSTER * per_cta + 1,
                              "global")}[where]


@pytest.mark.parametrize("where", ["private-top", "owned-bottom",
                                   "owned-2-top", "owned-4", "owned-top",
                                   "global-bottom"])
def test_segment_sums_regime_boundaries(cuda, where):
    G, mode = _segsum_regime_G(where)
    assert segsum2.plan(G, 2, 2, segsum2._kernel()[1]).mode == mode
    rng = np.random.default_rng(G)
    n = 1_000_003
    gid = torch.from_numpy(rng.integers(-1, G + 2, n).astype(np.int32))
    a = rng.integers(np.iinfo(np.int64).min, np.iinfo(np.int64).max, n,
                     dtype=np.int64)
    live = rng.random(n) < 0.9
    b = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    t = [torch.from_numpy(x).to(cuda) for x in (a, live, b)]
    _check_segsum(gid.to(cuda), [(t[0], t[1]), (t[2], None)], G)


@pytest.mark.parametrize("G", [1000, 100_096, 1 << 20])
@pytest.mark.parametrize("case", ["hot", "dead", "wrap", "misaligned",
                                  "cols40"])
def test_segment_sums_inputs(cuda, G, case):
    """One hot group holding every row; every row dead; values that wrap
    past +-2^63; views off 16-byte alignment; 40 columns (two launches),
    in each regime (two columns: private, owned, global)."""
    rng = np.random.default_rng(G + len(case))
    n = 400_003
    gid = rng.integers(0, G, n).astype(np.int32)
    if case == "hot":
        gid[:] = G // 2
    elif case == "dead":
        gid = np.where(rng.random(n) < 0.5, -5, G + 3).astype(np.int32)
    gid = torch.from_numpy(gid).to(cuda)
    if case == "cols40":
        cols = _segsum_cols(rng, n, 40, cuda)
    else:
        big = np.iinfo(np.int64).max - rng.integers(0, 1000, (2, n))
        big[1] = -big[1]     # near +2^63 and near -2^63: the sums wrap
        vals = (big if case == "wrap" else rng.integers(
            -(1 << 62), 1 << 62, (2, n))).astype(np.int64)
        live = rng.random(n) < 0.8
        t = [torch.from_numpy(x).to(cuda) for x in (vals[0], vals[1], live)]
        cols = [(t[0], t[2]), (t[1], None)]
    if case == "misaligned":
        gid = gid[1:]
        cols = [(v[1:], None if m is None else m[1:]) for v, m in cols]
        assert gid.data_ptr() % 16 and cols[0][0].data_ptr() % 16
    _check_segsum(gid, cols, G)


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


def _operator_inputs(name, cuda):
    """(label, input) pairs at the reference's shape and other legal
    sizes: smem-output and cumsum-1d with n not a multiple of 4 (cumsum-1d
    also across its 4096-value tiles) and views that start off 16-byte
    alignment; blocked-1d and blocked-2d with a misaligned and a strided
    view."""
    rng = np.random.default_rng(11)

    def ints(*shape):
        return torch.from_numpy(rng.integers(
            -(1 << 31), 1 << 31, shape).astype(np.int32)).to(cuda)

    ref = probe_inputs(cuda)[PROBES[name][1]]
    if name in ("smem-output", "cumsum-1d"):
        sizes = (1, 3, 4, 5, 4097, 1_000_003) if name == "smem-output" \
            else (1, 31, 4096, 4097, 100_000)
        flat = ints(1_000_003 if name == "smem-output" else 100_003)
        return [("reference", ref)] + [
            (f"n={n}", ints(n)) for n in sizes] + [
            (f"offset {k}", flat[k:]) for k in (1, 2, 3)] + [
            ("offset 1, n=2", flat[1:3]), ("strided", flat[::3])]
    if name == "blocked-1d":
        flat = ints(8 * 1024 + 1)
        return [("reference", ref), ("n=1024", ints(1024)),
                ("n=102400", ints(100 * 1024)),
                ("misaligned", flat[1:]), ("strided", ints(8192)[::2])]
    flat = ints(64 * 128 + 1)
    return [("reference", ref), ("8 rows", ints(8, 128)),
            ("1024 rows", ints(1024, 128)),
            ("misaligned", flat[1:].reshape(64, 128)),
            ("strided", ints(16, 256)[:, :128])]


@pytest.mark.parametrize("name", OPERATORS)
def test_operator_probes_match_plain(cuda, name):
    """int32 results bit-equal to the plain versions (sums wrap)."""
    for label, x in _operator_inputs(name, cuda):
        before = run_probe.launches[name]
        got = run_probe(name, x)
        torch.cuda.synchronize()
        assert run_probe.launches[name] == before + 1, label
        assert got.dtype == torch.int32 and got.device == x.device, label
        assert torch.equal(got, plain(name, x)), label


@pytest.mark.parametrize("name", OPERATORS)
def test_operator_probes_run_through_the_dispatcher(cuda, name):
    x = probe_inputs(cuda)[PROBES[name][1]]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = run_probe(name, x)
    torch.cuda.synchronize()
    op = f"a1t::{PROBES[name][0]}"
    assert any(e.key == op for e in prof.key_averages()), op
    assert torch.equal(got, getattr(torch.ops.a1t, PROBES[name][0])(x))
    # the ctypes library no longer has an entry for it
    assert not hasattr(build.load(SOURCE), f"a1t_{PROBES[name][0]}")


@pytest.mark.parametrize("name", OPERATORS)
def test_operator_probes_reject_bad_inputs(cuda, name):
    kind = PROBES[name][1]
    x = probe_inputs(cuda)[kind]
    before = run_probe.launches[name]
    with pytest.raises(TypeError, match="int32 input expected"):
        run_probe(name, x.float())
    bad = x.reshape(2, -1) if kind == "x1" else x.reshape(-1)[:7 * 128] \
        .reshape(7, 128)
    with pytest.raises(ValueError, match="input must be"):
        run_probe(name, bad)
    with pytest.raises(ValueError, match="empty input"):
        run_probe(name, x[:0])
    if name == "blocked-1d":
        with pytest.raises(ValueError, match="multiple of 1024"):
            run_probe(name, x[:1000])
    with pytest.raises(TypeError, match="no kernel for device cpu"):
        getattr(torch.ops.a1t, PROBES[name][0])(x.cpu())
    assert run_probe.launches[name] == before


@pytest.mark.parametrize("ty", ["uint16", "uint32", "uint64"])
def test_unsigned_arithmetic_on_card_matches_cpu(cuda, ty):
    """The int64 route of unsigned add, subtract, multiply, divide, the
    checked forms and the compares, on the card as on the CPU."""
    hi = int(np.iinfo(ty).max)
    vals = np.array([0, 1, 2, 3, 7, hi // 2, hi // 2 + 1, hi - 1, hi], ty)
    x, y = np.repeat(vals, len(vals)), np.tile(vals, len(vals))
    nz = y != 0
    for xs, ys, fns in ((x, y, ["add", "subtract", "multiply", "less",
                                "less_equal", "greater", "greater_equal",
                                "equal", "not_equal"]),
                        (x[nz], y[nz], ["divide"])):
        data = {"x": xs, "y": ys}
        tb, cb = (pt.record_batch(data, device=d) for d in (cuda, "cpu"))
        for fn in fns:
            got = pt.call_function(fn, [tb["x"], tb["y"]])
            assert got.data.device.type == "cuda"
            assert got.to_pylist() == \
                pt.call_function(fn, [cb["x"], cb["y"]]).to_pylist(), fn
    small = pt.record_batch({"x": np.array([3, 1], ty),
                             "y": np.array([1, 2], ty)}, device=cuda)
    assert pt.call_function("subtract", [small["x"], small["y"]]) \
        .to_pylist() == [2, hi]
    assert pt.call_function("divide", [small["x"], small["y"]]) \
        .to_pylist() == [3, 0]
    with pytest.raises(Invalid, match="overflow"):
        pt.call_function("subtract_checked", [small["x"], small["y"]])


def test_uint64_sort_indices_on_card(cuda):
    values = np.array([(1 << 63) + 5, 3, 0, (1 << 64) - 1], np.uint64)
    col = pt.record_batch({"u": values}, device=cuda)["u"]
    col = pt.Column(col.data, col.dtype,
                    validity=torch.tensor([True, True, False, True],
                                          device=cuda))
    assert pt.call_function("sort_indices", [col]).to_pylist() == \
        [1, 0, 3, 2]


NAN, INF = float("nan"), float("inf")
# The grouped-float fault input of tests/test_torch_port_faults.py, which
# holds FLOAT_WANT there to be pyarrow's answer (pyarrow is not needed
# here): groups 1-9 in key order.
FLOAT_K = [1, 2, 2, 1, 3, 4, 4, 3, 5, 6, 6, 5, 7, 8, 8, 7, 2, 9]
FLOAT_V = [1e20, 1.0, 2.0, 1e20, INF, 5.0, 5.0, INF, NAN, 3.0, 3.0, NAN,
           NAN, 7.0, 1.0, 4.0, None, None]
FLOAT_AGGS = [("v", "sum"), ("v", "mean"), ("v", "variance"),
              ("v", "stddev"), ("v", "min"), ("v", "max")]
FLOAT_WANT = {
    "v_sum": [2e20, 3.0, INF, 10.0, NAN, 6.0, NAN, 8.0, None],
    "v_mean": [1e20, 1.5, INF, 5.0, NAN, 3.0, NAN, 4.0, None],
    "v_variance": [0.0, 0.25, NAN, 0.0, NAN, 0.0, NAN, 9.0, None],
    "v_stddev": [0.0, 0.5, NAN, 0.0, NAN, 0.0, NAN, 3.0, None],
    "v_min": [1e20, 1.0, INF, 5.0, NAN, 3.0, 4.0, 1.0, None],
    "v_max": [1e20, 2.0, INF, 5.0, NAN, 3.0, 4.0, 7.0, None],
}


def _float_fault_batch(dev):
    v = np.array([NAN if x is None else x for x in FLOAT_V])
    valid = torch.tensor([x is not None for x in FLOAT_V], device=dev)
    b = pt.record_batch({"k": np.array(FLOAT_K, np.int64), "v": v,
                         "g": np.array(FLOAT_K, np.int32) - 1}, device=dev)
    return pt.RecordBatch((b["k"], pt.Column(b["v"].data, b["v"].dtype,
                                             validity=valid), b["g"]),
                          b.names)


def _same(got, want):
    """Equal lists of floats and None, NaN equal to NaN."""
    return len(got) == len(want) and all(
        a == b or (a is not None and b is not None and a != a and b != b)
        for a, b in zip(got, want))


def _in_key_order(out, names):
    order = np.argsort(np.array(out["k"].to_pylist()))
    return {n: [out[n].to_pylist()[i] for i in order] for n in names}


def test_grouped_float_faults_on_card_match_pyarrow(cuda):
    """The eager group_by, the hash_* entry points, the compiled pipeline
    and a two-batch query() on the card give pyarrow's answers: per-group
    float sums, min/max that skip NaN and give NaN for a group of NaNs."""
    b = _float_fault_batch(cuda)
    names = [f"v_{f}" for _, f in FLOAT_AGGS]
    eager = _in_key_order(pt.group_by(b, ["k"], FLOAT_AGGS), names)
    pipe = pt.PipelineBuilder().group_by(["k"], FLOAT_AGGS).compile()
    compiled = _in_key_order(pipe(b), names)
    for name in names:
        assert _same(eager[name], FLOAT_WANT[name]), (name, eager[name])
        assert _same(compiled[name], FLOAT_WANT[name]), name
    for _, fn in FLOAT_AGGS:
        got = pt.call_function(f"hash_{fn}", [b["v"], b["g"]])
        assert got.data.device == b["v"].data.device
        assert _same(got.to_pylist(), FLOAT_WANT[f"v_{fn}"]), fn
    aggs = [("v", "sum"), ("v", "mean"), ("v", "min"), ("v", "max")]
    table = pt.Table([b.slice(0, 9), b.slice(9, 9)])
    streamed = _in_key_order(pt.query(table).group_by(["k"], aggs)
                             .to_batch(), [f"v_{f}" for _, f in aggs])
    for name, values in streamed.items():
        assert _same(values, FLOAT_WANT[name]), name


def test_grouped_float_sums_are_deterministic_on_card(cuda):
    """Two runs give the same bits (no float atomics), and the card's sums
    are within the summation bound of the CPU's, which adds in row order:
    any order of n_g additions is within (n_g - 1) u sum|v| of the exact
    sum (u = 2^-53), so two orders differ by at most twice that."""
    rng = np.random.default_rng(5)
    n, G = 1 << 20, 1000
    k = rng.integers(0, G, n).astype(np.int64)
    v = rng.standard_normal(n) * 10.0 ** rng.integers(-8, 9, n)
    aggs = [("v", "sum"), ("v", "mean"), ("v", "variance")]
    names = [f"v_{f}" for _, f in aggs]
    b, c = (pt.record_batch({"k": k, "v": v, "g": k.astype(np.int32)},
                            device=d) for d in (cuda, "cpu"))
    pipe = pt.PipelineBuilder().group_by(["k"], aggs).compile()
    runs = {
        "eager": lambda x: [pt.group_by(x, ["k"], aggs)[n].data
                            for n in ["k"] + names],
        "compiled": lambda x: [pipe(x)[n].data for n in ["k"] + names],
        "hash_sum": lambda x: [torch.arange(G, device=x["k"].data.device),
                               pt.call_function("hash_sum",
                                                [x["v"], x["g"]]).data]}
    counts = np.bincount(k, minlength=G)
    abs_sum = np.bincount(k, np.abs(v), minlength=G)
    for label, run in runs.items():
        first, second = run(b), run(b)
        for x, y in zip(first, second):
            assert torch.equal(x.view(torch.int64), y.view(torch.int64)), \
                label
        keys = first[0].cpu().numpy()
        got = first[1].cpu().numpy()
        want = dict(zip(run(c)[0].numpy(), run(c)[1].numpy()))
        want = np.array([want[x] for x in keys])
        bound = 2 * (counts[keys] - 1) * 2.0 ** -53 * abs_sum[keys]
        assert np.all(np.abs(got - want) <= bound), label


def test_compiled_float_group_by_adds_no_host_sync(cuda):
    """The compiled pipeline's trace, float sums and NaN-skipping min/max
    included, makes no host synchronisation: torch's sync debug mode
    raises at each one it detects."""
    rng = np.random.default_rng(3)
    n = 1 << 16
    b = pt.record_batch({"k": rng.integers(0, 100, n).astype(np.int64),
                         "f": rng.standard_normal(n),
                         "i": rng.integers(-100, 100, n).astype(np.int64)},
                        device=cuda)
    aggs = [(c, f) for c in ("f", "i")
            for f in ("sum", "mean", "variance", "min", "max")]
    pipe = pt.PipelineBuilder().group_by(["k"], aggs).compile()
    pipe._trace(b)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        pipe._trace(b)
    finally:
        torch.cuda.set_sync_debug_mode("default")
