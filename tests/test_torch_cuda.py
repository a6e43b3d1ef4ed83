"""The port's CUDA kernels against their plain PyTorch versions, and the
compiled pipeline, the eager group_by, the joins, the compute tail, the
string functions and the temporal slice on the card against the same
calls on the CPU.

These need an NVIDIA GPU and skip elsewhere. The file imports neither JAX
nor the JAX package, so it also runs on a machine that has only torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import arrow1_tpu_torch as pt
from arrow1_tpu_torch.compute_strings import (CALLS as STRING_CALLS,
                                              call as string_call, on_device,
                                              same_result as string_same,
                                              tpch_string_columns)
from arrow1_tpu_torch.compute_tail import (CALLS as TAIL_CALLS,
                                           same_result, tail_columns)
from arrow1_tpu_torch import compute_decimal, compute_temporal
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.kernels.compaction import (compact, compact_plain,
                                                 compact_u64,
                                                 compact_u64_plain)
from arrow1_tpu_torch.kernels.compaction_split import (compact_split,
                                                       compact_split_plain)
from arrow1_tpu_torch.kernels import fused_ops, segsum, segsum2
from arrow1_tpu_torch.kernels.fused_ops import (filter_project_flagship,
                                                filter_project_plain)
from arrow1_tpu_torch.kernels.hashtable import (broadcast_probe,
                                                broadcast_probe_plain)
from arrow1_tpu_torch.kernels import build
from arrow1_tpu_torch.kernels.probes import (OPERATORS, PROBES, plain,
                                             probe_inputs, run_empty,
                                             run_probe, run_probes)
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


@pytest.mark.parametrize("G, case", [
    (1, "spread"), (256, "spread"), (4096, "spread"), (40_000, "spread"),
    (4096, "one hot group"), (4096, "all dead"), (4096, "view one row in"),
    (None, "largest private G"), (None, "first G past shared memory")])
def test_segment_sum_count_kernel_matches_plain(cuda, G, case):
    smem = segsum2.smem_bytes()
    if G is None:   # the regimes' boundary on this card
        G = smem // 8 + (case.startswith("first"))
    assert segsum.plan(G, smem).mode == ("private" if 8 * G <= smem
                                         else "global")
    rng = np.random.default_rng(G)
    n = 200_003
    ids = rng.integers(0, G + 1, n)
    if case == "one hot group":
        ids = np.where(ids < G, 0, G)
    gid = torch.from_numpy(ids.astype(np.int32)).to(cuda)
    val = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(
        cuda)
    live = torch.from_numpy(rng.random(n) < (0.0 if case == "all dead"
                                             else 0.9)).to(cuda)
    if case == "view one row in":
        gid, val, live = gid[1:], val[1:], live[1:]
        assert gid.data_ptr() % 16 and val.data_ptr() % 16
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


U64_MAX = np.iinfo(np.uint64).max


def _k4_keys(T, n, seed, kind):
    """A sorted u64 build and probes half drawn from it (int64 bit
    patterns). ``duplicates``: duplicate runs, keys at and above 2^63, and
    the extremes 0 and 2^64 - 1; ``clustered``: T - 1 keys in a window
    2^12 wide, and 2^64 - 1 (one bucket of the kernel's directory holds
    all but one), probes from the window; ``all-equal``: one key T times;
    ``high``: every key above 2^63. The first probes are 0, 2^64 - 1 and
    2^63, then the keys on either side of each bucket boundary of the
    kernel's directory (2^12 buckets over [build[0], build[-1]])."""
    rng = np.random.default_rng(seed)
    if kind == "duplicates":
        distinct = rng.integers(0, 1 << 64, max(T // 3, 1), dtype=np.uint64)
        build = np.sort(rng.choice(distinct, T))
        if T > 2:
            build[0], build[-1] = 0, U64_MAX
    elif kind == "clustered":
        base = np.uint64(rng.integers(0, 1 << 63))
        build = np.sort(np.append(
            base + rng.integers(0, 1 << 12, T - 1).astype(np.uint64),
            U64_MAX)[-T:])
    elif kind == "all-equal":
        build = np.full(T, rng.integers(0, 1 << 64, dtype=np.uint64))
    else:
        build = np.sort(rng.integers(1 << 63, 1 << 64, T, dtype=np.uint64))
    other = (build[0] + rng.integers(0, 1 << 12, n - n // 2).astype(
        np.uint64) if kind == "clustered" else
        rng.integers(0, 1 << 64, n - n // 2, dtype=np.uint64))
    probe = np.concatenate([rng.choice(build, n // 2), other])
    first, last = int(build[0]), int(build[-1])
    shift = max((last - first).bit_length() - 12, 0)
    edges = [e for b in range(1, 1 << 12)
             for e in (first + (b << shift) - 1, first + (b << shift))
             if e <= last]
    head = np.array([0, U64_MAX, 1 << 63] + edges, dtype=np.uint64)[:n]
    probe[:head.size] = head
    return (torch.from_numpy(build.view(np.int64)),
            torch.from_numpy(probe.view(np.int64)))


@pytest.mark.parametrize("kind", ["duplicates", "clustered", "all-equal",
                                  "high"])
@pytest.mark.parametrize("T", [1, 2, 3, 255, 2047, 2048])
@pytest.mark.parametrize("n", [3, 16384, 1_000_001])
def test_broadcast_probe_kernel_matches_plain(cuda, T, n, kind):
    build, probe = (x.to(cuda) for x in _k4_keys(T, n, T + n, kind))
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
    # one launch first: a fresh process's first launch (module load, the
    # profiler's CUPTI set-up) stays outside the sessions below
    run_probe(name, x)
    torch.cuda.synchronize()
    # and one profiled launch whose record is not read: a fresh process's
    # first CUDA-activity session has recorded no kernel event at times
    # (ROADMAP Queue 3); the sessions below are then not its first
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        run_probe(name, x)
        torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got = run_probe(name, x)
    torch.cuda.synchronize()
    op = f"a1t::{PROBES[name][0]}"
    assert any(e.key == op for e in prof.key_averages()), op
    assert torch.equal(got, getattr(torch.ops.a1t, PROBES[name][0])(x))
    # one kernel a call: no memset or copy runs beside it
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_probe(name, x)
        torch.cuda.synchronize()
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 1, [e.name for e in device]


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


def test_empty_probe_is_one_launch_of_the_operator_path(cuda):
    """probe_empty: the probes' checks, an output allocated like x, and one
    launch of a kernel that does nothing."""
    x = probe_inputs(cuda)["x2"]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU,
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
        out = run_empty(x)
        torch.cuda.synchronize()
    assert out.shape == x.shape and out.dtype == x.dtype and out.is_cuda
    assert any(e.key == "a1t::probe_empty" for e in prof.key_averages())
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(device) == 1, [e.name for e in device]
    with pytest.raises(TypeError, match="int32 input expected"):
        run_empty(x.float())


# ---- the numeric compute tail: the card against the CPU -------------------

TAIL_ROWS = 50_000


@pytest.fixture(scope="module")
def tail_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    return (tail_columns(TAIL_ROWS, "cuda", window=20_000),
            tail_columns(TAIL_ROWS, "cpu", window=20_000))


@pytest.mark.parametrize("name", sorted(TAIL_CALLS))
def test_compute_tail_on_card_matches_cpu(cuda, name, tail_inputs):
    """Each of the slice's 99 functions on card tensors against the same
    call on CPU tensors: integers, bools and null masks exactly, floats
    bit for bit or within the call's stated ulp bound (transcendental
    functions: libdevice against the CPU's libm). ``random`` is held to
    its properties: the same seed gives the same numbers, in [0, 1)."""
    call, kind, ulps = TAIL_CALLS[name]
    card, cpu = tail_inputs
    got = call(card)
    if kind == "random":
        again = call(card).data
        assert got.data.is_cuda and torch.equal(got.data, again)
        x = got.data.cpu().numpy()
        assert got.length == TAIL_ROWS and x.min() >= 0 and x.max() < 1
        assert abs(x.mean() - 0.5) < 0.01
        return
    problem = same_result(got, call(cpu), ulps)
    assert problem is None, (name, problem)


def test_compute_tail_checks_raise_on_card(cuda):
    """The checked forms raise on the card where they raise on the CPU
    (one host sync each)."""
    col = lambda v, t=np.int64: pt.interop.column_from_numpy(  # noqa: E731
        np.array(v, t), device=cuda)
    raising = [
        ("abs_checked", [col([-(2 ** 63), 1])], {}),
        ("power_checked", [col([10, 2]), col([30, 2])], {}),
        ("power", [col([2, 2]), col([-1, 2])], {}),
        ("shift_left_checked", [col([1, 2]), col([3, 64])], {}),
        ("cumulative_sum_checked", [col([2 ** 62, 2 ** 62])], {}),
        ("cumulative_prod_checked", [col([2 ** 40, 2 ** 30])], {}),
        ("pairwise_diff_checked", [col([-(2 ** 63), 1])], {"period": -1}),
        ("cast", [col([300, 1])], {"target_type": pt.uint8}),
        ("cast", [col([1.5, 2.0], np.float64)], {"target_type": pt.int64}),
        ("ln_checked", [col([1.0, -1.0], np.float64)], {}),
    ]
    for name, args, options in raising:
        with pytest.raises(Invalid):
            pt.call_function(name, args, **options)
        with pytest.raises(Invalid):
            pt.call_function(name, [pt.interop.column_from_numpy(
                a.data.cpu().numpy(), device="cpu") for a in args],
                **options)


def test_drop_null_launches_k2_on_card(cuda):
    v = pt.interop.column_from_numpy(np.arange(10_000, dtype=np.int64),
                                     np.arange(10_000) % 3 > 0, device=cuda)
    before = compact.launches
    out = pt.call_function("drop_null", [v])
    assert compact.launches == before + 1
    assert torch.equal(out.data.cpu(), torch.from_numpy(
        np.arange(10_000)[np.arange(10_000) % 3 > 0]))


# ---- strings and the repaired faults: the card against the CPU -----------

STRING_ROWS = 50_000


@pytest.fixture(scope="module")
def string_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    cpu = tpch_string_columns(STRING_ROWS, "cpu", customers=5_000)
    return on_device(cpu, "cuda", STRING_ROWS), cpu


@pytest.mark.parametrize("name", sorted(STRING_CALLS))
def test_strings_on_card_match_cpu(cuda, name, string_inputs):
    """Each of the 73 string names on card tensors against the same call
    on CPU tensors, exactly; its rows stay on the card."""
    card, cpu = string_inputs
    got = string_call(name, card)
    first = got.columns[0] if isinstance(got, pt.RecordBatch) else got
    assert first.device.type == "cuda", name   # a struct result too
    assert string_same(got, string_call(name, cpu)) is None, name


@pytest.mark.parametrize("op", ["equal", "not_equal", "less", "less_equal",
                                "greater", "greater_equal"])
def test_string_compares_on_card_match_cpu(cuda, op, string_inputs):
    card, cpu = string_inputs
    for args in (("s", "t"), ("s", "Customer#000001234"), ("t", "AIR"),
                 ("t", "B")):
        got = pt.call_function(op, [card.get(a, a) for a in args])
        want = pt.call_function(op, [cpu.get(a, a) for a in args])
        assert got.data.is_cuda
        assert string_same(got, want) is None, (op, args)


def test_device_transform_and_lut_stay_on_card(cuda, string_inputs):
    """ascii_lower runs over the pool's byte matrix on the card and seeds
    its result pool's matrix there; starts_with on that result builds
    none and gathers its table by the codes on the card."""
    card, cpu = string_inputs
    low = pt.call_function("ascii_lower", [card["t"]])
    assert low.data.is_cuda
    seeded = dict(low.dictionary._byte_matrix)
    assert [d.type for d in seeded] == ["cuda"]
    hit = pt.call_function("starts_with", [low], pattern="ai")
    assert list(low.dictionary._byte_matrix) == list(seeded)
    assert hit.data.is_cuda and hit.dtype == pt.bool_
    want = pt.call_function("starts_with", [
        pt.call_function("ascii_lower", [cpu["t"]])], pattern="ai")
    assert string_same(hit, want) is None


def test_string_casts_on_card_match_cpu(cuda):
    col = pt.interop.column_from_numpy(
        np.array(["12", "-3", None, "0x10"] * 100, dtype=object),
        device=cuda)
    got = pt.ops.cast.cast(col, pt.int64)
    assert got.data.is_cuda
    assert got.to_pylist() == [12, -3, None, 16] * 100
    nums = pt.interop.column_from_numpy(np.array([1.5, -0.0, 1e20] * 100),
                                        device=cuda)
    text = pt.ops.cast.cast(nums, pt.string)
    assert text.data.is_cuda
    assert text.to_pylist() == ["1.5", "-0", "1e+20"] * 100
    with pytest.raises(Invalid):
        pt.ops.cast.cast(pt.interop.column_from_numpy(
            np.array(["1", "x"], dtype=object), device=cuda), pt.int64)


def test_repaired_faults_on_card(cuda):
    """The faults of ROADMAP Queue 3 repaired since the strings slice, on
    the card: a dictionary array ingests to CUDA and groups on the dense
    path (one K3 launch), the dense mean is the exact sum's, the compiled
    group_by emits -0.0 for a group of -0.0 keys; a scalar aggregate with
    skip_nulls=False over a null is null, and a grouped variance of values
    near 1e9 does not cancel; then the distributed slice's P1-P3 and S8
    (``_distributed_slice_faults``)."""
    import pyarrow as pa

    rb = pa.record_batch({"k": pa.array(["a", "b", "a", None]
                                        ).dictionary_encode(),
                          "v": pa.array([1, 2, 3, 4])})
    before = segment_sums.launches
    out = pt.group_by(pt.interop.record_batch_from_arrow(rb, device=cuda),
                      ["k"], [("v", "sum")])
    assert segment_sums.launches == before + 1
    assert out["k"].to_pylist() == ["a", "b", None]
    assert out["v_sum"].to_pylist() == [4, 2, 4]
    wide = pt.record_batch({"k": np.array([1, 1]),
                            "v": np.array([2 ** 62, 2 ** 62 + 1])},
                           device=cuda)
    mean = pt.group_by(wide, ["k"], [("v", "mean"), ("v", "sum")])
    assert mean["v_mean"].to_pylist() == [4.611686018427388e18]
    assert mean["v_sum"].to_pylist() == [-(2 ** 63) + 1]
    piped = pt.PipelineBuilder().group_by(["k"], [("v", "mean")]).compile()(
        wide)
    assert piped["v_mean"].to_pylist() == [4.611686018427388e18]
    nz = pt.record_batch({"f": np.array([-0.0, 1.0, -0.0]),
                          "v": np.array([1, 2, 3])}, device=cuda)
    keys = pt.PipelineBuilder().group_by(["f"], [("v", "sum")]).compile()(
        nz)["f"].data.cpu().numpy()
    assert np.signbit(keys).tolist() == [True, False]
    # the two aggregate faults of the decimal slice: skip_nulls=False
    # gives null, and a grouped variance does not cancel (pyarrow's
    # answers)
    col = pt.interop.column_from_numpy(np.array([1.0, 0.0, 3.0]),
                                       validity=np.array([1, 0, 1], bool),
                                       device=cuda)
    for fn in ("sum", "mean", "min", "max", "product", "variance"):
        assert pt.call_function(fn, [col], skip_nulls=False).as_py() is None
    assert pt.call_function("mode", [col], skip_nulls=False).num_rows == 0
    big = pt.record_batch({"k": np.array([1, 1, 1]),
                           "v": np.array([1e9 + 1, 1e9 + 2, 1e9 + 3])},
                          device=cuda)
    for out in (pt.group_by(big, ["k"], [("v", "variance")]),
                pt.PipelineBuilder().group_by(["k"], [("v", "variance")])
                .compile()(big)):
        assert out["v_variance"].to_pylist() == [0.6666666666666666]
    _distributed_slice_faults(cuda)
    _null_type_on_card(cuda)


def _null_type_on_card(cuda):
    """P4 on the card: a null column (int8 zeros, all-false validity) from
    pyarrow, IPC, CSV and JSON, its calls, and the null scalar."""
    import io

    import pyarrow as pa

    from arrow1_tpu_torch.io import csv as pcsv, ipc_native, json as pjson
    from arrow1_tpu_torch.ops.cast import CastOptions

    col = pt.interop.column_from_arrow(pa.nulls(5), device=cuda)
    assert col.dtype == pt.null and col.data.device.type == "cuda"
    assert not col.validity.any() and col.data.dtype == torch.int8
    assert pt.call_function("is_null", [col]).to_pylist() == [True] * 5
    for target in (pt.int64, pt.string):
        got = pt.call_function("cast", [col],
                               options=CastOptions.safe(target))
        assert got.dtype == target and got.to_pylist() == [None] * 5
    keep = pt.interop.column_from_arrow(pa.array([True, False] * 2 + [True]),
                                        device=cuda)
    assert pt.call_function("filter", [col, keep]).length == 3
    batch = pt.RecordBatch((col,), ("n",))
    buf = io.BytesIO()
    ipc_native.write_file(buf, [batch, batch])
    back = ipc_native.read_file(buf.getvalue())
    assert [b["n"].dtype for b in back] == [pt.null, pt.null]
    for table in (pcsv.read_csv(b"a,n\n1,\n2,\n"),
                  pjson.read_json(b'{"a": 1, "n": null}\n{"a": 2}\n')):
        n = table.batches[0]["n"]
        assert n.dtype == pt.null and n.device.type == "cuda"
    x = pt.interop.column_from_numpy(np.array([1, 2]), device=cuda)
    assert pt.call_function("add", [x, pt.NA]).to_pylist() == [None, None]
    assert pt.scalar(None).dtype == pt.null


def _multiset(batch):
    return sorted(repr(sorted(r.items())) for r in
                  (dict(zip(batch.names, row)) for row in
                   zip(*[c.to_pylist() for c in batch.columns])))


def _distributed_slice_faults(cuda):
    """The faults repaired with the distributed slice, on the card
    (pyarrow's answers, hard-coded): a decimal column of zero rows leaves
    the port (P1); query()'s string group_by with a null key over two
    batches (P2); binary_join_element_wise and binary_repeat of zero rows
    (P3); query()'s right outer and right semi joins over two probe
    batches emit the build side once (S8)."""
    from arrow1_tpu_torch.ops.join import BuiltJoin

    for t, hi in ((pt.decimal128(15, 2), torch.tensor([0, -1])),
                  (pt.decimal256(60, 6), torch.tensor([[0, 0, 0],
                                                       [-1, -1, -1]]))):
        col = pt.Column(torch.tensor([100, -250], device=cuda), t,
                        data2=hi.to(cuda))
        none = pt.Column(torch.zeros(2, dtype=torch.bool, device=cuda),
                         pt.bool_)
        assert pt.filter(col, none).to_pylist() == []
        empty = col.slice(0, 0)
        mm = pt.call_function("min_max", [empty])
        assert mm["min"].to_pylist() == [None] == mm["max"].to_pylist()
        assert pt.call_function("negate", [empty]).to_pylist() == []
    s = pt.interop.column_from_numpy
    b1 = pt.RecordBatch((s(np.array(["x", "y", "x"], dtype=object),
                           device=cuda),
                         s(np.array([1, 2, 3]), device=cuda)), ("s", "v"))
    b2 = pt.RecordBatch((s(np.array(["y", "z", None], dtype=object),
                           device=cuda),
                         s(np.array([10, 20, 30]), device=cuda)), ("s", "v"))
    for batches in ([b1, b2], [b2, b1]):
        out = pt.query(pt.Table(batches)).group_by(
            ["s"], [("v", "sum")]).to_batch()
        assert sorted(zip(out["s"].to_pylist(), out["v_sum"].to_pylist()),
                      key=repr) == sorted([("x", 4), ("y", 12), ("z", 20),
                                           (None, 30)], key=repr)
    es = s(np.array([], dtype=object), device=cuda)
    assert pt.call_function("binary_join_element_wise",
                            [es, es, es]).to_pylist() == []
    assert pt.call_function("binary_repeat", [
        es, s(np.array([], dtype=np.int64), device=cuda)]).to_pylist() == []
    right = pt.RecordBatch((s(np.array(["z", "x", None], dtype=object),
                              device=cuda),
                            s(np.array([7, 8, 9]), device=cuda)), ("s", "w"))
    lb = [pt.RecordBatch((s(np.array(k, dtype=object), device=cuda),
                          s(np.array(v), device=cuda)), ("s", "v"))
          for k, v in ((["x", None, "x"], [1, 2, 3]),
                       (["y", "z", None], [4, 5, 6]))]
    got = pt.query(pt.Table(lb)).join(right, "s",
                                      join_type="right outer").to_batch()
    assert _multiset(got) == sorted(repr(sorted(r.items())) for r in [
        {"s": "x", "v": 1, "w": 8}, {"s": "x", "v": 3, "w": 8},
        {"s": "z", "v": 5, "w": 7}, {"s": None, "v": None, "w": 9}])
    semi = pt.query(pt.Table(lb)).join(right, "s",
                                       join_type="right semi").to_batch()
    assert sorted(semi["w"].to_pylist()) == [7, 8]
    joiner = BuiltJoin(right, "s", join_type="full outer")
    assert joiner.probe(lb[0]).num_rows == 3 and joiner.finish() is not None


def test_distributed_on_one_nccl_rank(cuda):
    """The distributed operators and pipeline on a one-rank NCCL group on
    the card, each equal to the single-card engine."""
    from arrow1_tpu_torch.exec import DistPipelineBuilder
    from arrow1_tpu_torch.exec.plan import sort_batch
    from arrow1_tpu_torch.parallel import (dist_filter, dist_group_by,
                                           dist_join, make_mesh, multihost)
    from arrow1_tpu_torch.parallel.distributed import dist_sort

    import torch.distributed as dist

    multihost.initialize(device=torch.device("cuda", 0))
    try:
        assert dist.get_backend() == "nccl"
        mesh = make_mesh()
        rng = np.random.default_rng(20)
        n = 100_000
        b = pt.record_batch({"k": rng.integers(0, 500, n),
                             "v": rng.integers(-100, 100, n),
                             "i": np.arange(n)}, device=cuda)
        dims = pt.record_batch({"k": np.arange(0, 500, 2),
                                "z": np.arange(250) * 3}, device=cuda)
        before = compact.launches
        e = pt.field("v") > 0
        assert _multiset(dist_filter(b, e, mesh)) == \
            _multiset(pt.filter(b, e.execute(b)))
        assert compact.launches > before
        aggs = [("v", "sum"), ("v", "count"), ("v", "min")]
        assert _multiset(dist_group_by(b, ["k"], aggs, mesh)) == \
            _multiset(pt.group_by(b, ["k"], aggs))
        for jt in ("inner", "left outer"):
            assert _multiset(dist_join(b, dims, ["k"], join_type=jt,
                                       mesh=mesh)) == \
                _multiset(pt.join(b, dims, ["k"], join_type=jt))
        keys = [("k", "ascending"), ("v", "descending")]
        assert dist_sort(b, keys, mesh)["i"].to_pylist() == \
            sort_batch(b, keys)["i"].to_pylist()
        got = (DistPipelineBuilder(mesh).filter(e).join(dims, "k", fanout=2)
               .group_by(["z"], [("v", "sum")]).sort([("z", "ascending")])
               .compile())(b)
        want = sort_batch(pt.group_by(pt.join(
            pt.filter(b, e.execute(b)), dims, ["k"]), ["z"], [("v", "sum")]),
            [("z", "ascending")])
        assert got["z"].to_pylist() == want["z"].to_pylist()
        assert got["v_sum"].to_pylist() == want["v_sum"].to_pylist()
    finally:
        multihost.shutdown()


# ---- the temporal slice: the card against the CPU ------------------------

TEMPORAL_ROWS = 50_000


@pytest.fixture(scope="module")
def temporal_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    cpu = compute_temporal.temporal_columns(TEMPORAL_ROWS, "cpu",
                                            distinct=2_000)
    return compute_temporal.on_device(cpu, "cuda", TEMPORAL_ROWS), cpu


@pytest.mark.parametrize("label", list(compute_temporal.CALLS))
def test_temporal_on_card_matches_cpu(cuda, label, temporal_inputs):
    """Each call of the 43 temporal names (components, *_between, the
    rounding, the time-zone lookup, strftime/strptime, tdigest) on card
    tensors against the same call on the CPU, exactly."""
    card, cpu = temporal_inputs
    got = compute_temporal.call(label, card)
    first = got.columns[0] if isinstance(got, pt.RecordBatch) else got
    assert first.data.device.type == "cuda", label
    assert compute_temporal.same_result(
        got, compute_temporal.call(label, cpu)) is None, label


def test_time_zone_lookup_on_card(cuda, temporal_inputs):
    """The zone's offset table is copied to the card once and the per-row
    lookup (searchsorted and a gather) runs there: is_dst, local time and
    assume_timezone's way back equal the CPU's."""
    from arrow1_tpu_torch.utils import tzif

    card, cpu = temporal_inputs
    for name in ("is_dst", "local_timestamp"):
        got = pt.call_function(name, [card["tsz"]])
        assert got.data.device.type == "cuda"
        assert compute_temporal.same_result(
            got, pt.call_function(name, [cpu["tsz"]])) is None, name
    assert any(d.startswith("cuda")
               for d in tzif.load_tz(compute_temporal.ZONE).devices)
    opts = dict(timezone=compute_temporal.ZONE, ambiguous="latest",
                nonexistent="latest")
    back = pt.call_function("assume_timezone", [card["wall"]], **opts)
    assert compute_temporal.same_result(back, pt.call_function(
        "assume_timezone", [cpu["wall"]], **opts)) is None


def test_date32_filter_launches_k2_on_card(cuda, temporal_inputs):
    """A date32 predicate against a typed scalar filters a batch through
    one K2 launch, and keeps the rows the CPU keeps."""
    from arrow1_tpu_torch import dtypes

    card, cpu = temporal_inputs
    cutoff = pt.scalar(9500, dtypes.date32)
    outs = []
    for cols in (card, cpu):
        rb = pt.RecordBatch((cols["d"], cols["ts"]), ("d", "ts"))
        mask = pt.call_function("less_equal", [cols["d"], cutoff])
        before = compact.launches
        outs.append(pt.call_function("filter", [rb, mask]))
        if cols is card:
            assert compact.launches == before + 1
    for g, w in zip(outs[0].columns, outs[1].columns):
        assert compute_temporal.same_result(g, w) is None


# ---- the decimal slice: the card against the CPU -------------------------

DECIMAL_ROWS = 50_000


@pytest.fixture(scope="module")
def decimal_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only on "
                    "the card")
    card = compute_decimal.decimal_columns(DECIMAL_ROWS, "cuda")
    return card, compute_decimal.on_device(card, "cpu", DECIMAL_ROWS)


@pytest.mark.parametrize("label", sorted(compute_decimal.CALLS))
def test_decimal_calls_on_card_match_cpu(cuda, label, decimal_inputs):
    """Every decimal dispatch point of compute_decimal.CALLS at 50K rows:
    limbs, masks and strings equal to the CPU's exactly, floats within
    the ulps that compute_decimal.ULPS states."""
    card, cpu = decimal_inputs
    got = compute_decimal.call(label, card)
    want = compute_decimal.call(label, cpu)
    problem = compute_decimal.same_result(
        got, want, ulps=compute_decimal.ULPS.get(label, 0))
    assert problem is None, (label, problem)


def test_decimal256_limbs_ride_k2_on_card(cuda, decimal_inputs):
    """A filter of a decimal256 and a decimal128 column is one K2 launch
    that moves every limb (three high-limb streams for the decimal256)."""
    card, cpu = decimal_inputs
    batch = pt.RecordBatch((card["big"], card["wide"]), ("big", "wide"))
    before = compact.launches
    got = pt.call_function("filter", [batch, card["m"]])
    assert compact.launches == before + 1
    want = pt.call_function("filter", [pt.RecordBatch(
        (cpu["big"], cpu["wide"]), ("big", "wide")), cpu["m"]])
    assert got["big"].data2.shape[1] == 3 and got["big"].data2.is_cuda
    assert compute_decimal.same_result(got, want) is None


def test_dense_decimal_sum_launches_k3_on_card(cuda, decimal_inputs):
    """A decimal sum and mean on an int64 key take the dense path: their
    32-bit digit planes ride one K3 launch; equal to the CPU's."""
    card, cpu = decimal_inputs
    aggs = [("price", "sum"), ("price", "mean"), ("big", "sum")]
    before = segment_sums.launches
    got = pt.group_by(card["batch"], ["k"], aggs)
    assert segment_sums.launches == before + 1
    want = pt.group_by(cpu["batch"], ["k"], aggs)
    assert compute_decimal.same_result(got, want) is None


def test_nested_calls_on_card_match_cpu(cuda):
    """The nested slice on the card at 200K line items grouped under 50K
    orders: hash_list, hash_distinct, the list functions, a map lookup, a
    filter of a batch with list columns (one K2 launch), a struct field,
    a split and its binary_join; each equal to the same calls on CPU
    tensors."""
    from arrow1_tpu_torch.compute_nested import move, same_nested

    rng = np.random.default_rng(15)
    n, orders = 200_000, 50_000
    key = rng.integers(0, orders, n).astype(np.int64)
    qty = rng.integers(1, 51, n).astype(np.int64)
    price = np.round(rng.uniform(1.0, 1000.0, n), 2)
    flags = np.array(["A", "N", "R"], dtype=object)
    flag = rng.integers(0, 3, n).astype(np.int32)
    names = np.array([f"Customer#{i:09d}" for i in range(5000)], object)
    cname = rng.integers(0, 5000, n).astype(np.int32)

    def run(dev):
        col = pt.interop.column_from_numpy
        k, q, p = (col(a, device=dev) for a in (key, qty, price))
        f = col(flag, device=dev, dictionary=flags)
        c = col(cname, device=dev, dictionary=names)
        ql = pt.call_function("hash_list", [q, k])
        fl = pt.call_function("hash_list", [f, k])
        orders_rb = pt.RecordBatch((ql, pt.call_function("hash_list",
                                                         [p, k])),
                                   ("q", "p"))
        before = compact.launches
        kept = pt.call_function("filter", [orders_rb, pt.call_function(
            "greater", [pt.call_function("list_value_length", [ql]),
                        pt.scalar(4, pt.int32)])])
        filter_launches = compact.launches - before
        m = pt.ListColumn(ql.offsets, pt.RecordBatch(
            (fl.values, ql.values), ("key", "value")),
            pt.map_(pt.string, pt.int64))
        split = pt.call_function("split_pattern", [c], pattern="#")
        out = {
            "hash_list": ql,
            "hash_distinct": pt.call_function("hash_distinct", [f, k]),
            "list_value_length": pt.call_function("list_value_length",
                                                  [ql]),
            "list_flatten": pt.call_function("list_flatten", [ql]),
            "list_parent_indices": pt.call_function("list_parent_indices",
                                                    [ql]),
            "list_slice": pt.call_function("list_slice", [ql], start=1,
                                           stop=3),
            "filter": kept,
            "list_element": pt.call_function("list_element", [kept["q"]],
                                             index=0),
            "map_lookup": pt.call_function("map_lookup", [m],
                                           query_key="R",
                                           occurrence="all"),
            "struct_field": pt.call_function(
                "struct_field", [pt.call_function(
                    "make_struct", [q, p], field_names=("q", "p")
                ).to_struct_array()], field="p"),
            "split_pattern": split,
            "binary_join": pt.call_function("binary_join",
                                            [split, pt.scalar("#")]),
            "hash_tdigest": pt.call_function("hash_tdigest", [p, pt.Column(
                f.data, pt.int32)], q=(0.5, 0.9)),
        }
        return out, filter_launches

    card, launches = run(cuda)
    cpu, _ = run(torch.device("cpu"))
    assert launches == 1
    for label, got in card.items():
        assert same_nested(move(got, "cpu"), cpu[label]) is None, label
    assert card["list_value_length"].data.sum().item() == n
    assert card["binary_join"].to_pylist() == \
        names[cname].tolist()


# ---- the host plane: an IPC file read straight onto the card ---------------

def test_ipc_file_read_onto_card_then_k2(cuda, tmp_path):
    """A seeded batch of many types goes through an Arrow IPC file (the
    port's own writer and reader, no pyarrow) onto the card by default,
    then through filter (one K2 launch), and equals the same filter of
    the batch built in memory; the float columns bit for bit."""
    from arrow1_tpu_torch import dtypes as dt
    from arrow1_tpu_torch.compute_nested import move, same_nested
    from arrow1_tpu_torch.io import ipc as pio

    rng = np.random.default_rng(21)
    n = 5000
    f = rng.standard_normal(n)
    f[::97] = np.nan
    f[::89] = -0.0
    valid = rng.random(n) > 0.1
    lens = np.where(valid, rng.integers(0, 4, n), 0)   # a null list: empty
    offsets = np.concatenate([[0], np.cumsum(lens)])
    batch = pt.from_reference_arrays(
        ["i", "f", "u", "b", "s", "d", "dec", "l"],
        [(rng.integers(-1 << 40, 1 << 40, n), valid, None), (f, None, None),
         (rng.integers(0, 1 << 63, n, dtype=np.uint64) * 2 + 1, None, None),
         (rng.random(n) < 0.5, None, None),
         (rng.integers(0, 3, n).astype(np.int32), rng.random(n) > 0.05,
          np.array(["AIR", "RAIL", "SHIP"], dtype=object)),
         (rng.integers(8000, 11000, n).astype(np.int32), None, None),
         (rng.integers(-10**12, 10**12, n), valid, None),
         {"type": pt.list_(pt.float32), "offsets": offsets,
          "values": (rng.standard_normal(offsets[-1]).astype(np.float32),
                     None, None), "validity": valid}], cuda)
    cols = list(batch.columns)
    cols[5] = pt.Column(cols[5].data, dt.date32)
    cols[6] = pt.Column(cols[6].data, dt.decimal128(15, 2),
                        validity=cols[6].validity,
                        data2=(cols[6].data < 0).to(torch.int64).neg())
    batch = pt.RecordBatch(tuple(cols), batch.names)
    path = tmp_path / "batch.arrow"
    pio.write_ipc(batch, path)
    back = pio.read_ipc(path)
    assert len(back.batches) == 1
    back = back.batches[0]
    assert all(c.device.type == "cuda" for c in back.columns)
    outs = []
    for b in (back, batch):
        mask = pt.call_function("greater", [b["d"],
                                            pt.scalar(9000, dt.date32)])
        before = compact.launches
        outs.append(pt.call_function("filter", [b, mask]))
        assert compact.launches > before
    got, want = outs
    assert same_nested(move(got, "cpu"), move(want, "cpu")) is None
    assert torch.equal(_bits(got["f"].data), _bits(want["f"].data))


def _format_batch(n=5000, seed=22):
    """A seeded CPU batch of the file formats' common types: int64 with
    nulls, float64 with NaN and -0.0, a string, a date32 and a bool."""
    from arrow1_tpu_torch import dtypes as dt

    rng = np.random.default_rng(seed)
    f = np.round(rng.uniform(-1000, 1000, n), 2)
    f[::89] = -0.0
    return pt.RecordBatch((
        pt.Column(torch.from_numpy(rng.integers(-1 << 40, 1 << 40, n)),
                  dt.int64, validity=torch.from_numpy(rng.random(n) > 0.1)),
        pt.Column(torch.from_numpy(f), dt.float64),
        pt.Column(torch.from_numpy(rng.integers(0, 3, n).astype(np.int32)),
                  dt.string, dictionary=pt.Dictionary(
                      np.array(["AIR", "RAIL", "SHIP"], dtype=object))),
        pt.Column(torch.from_numpy(rng.integers(8000, 11000, n)
                                   .astype(np.int32)), dt.date32),
        pt.Column(torch.from_numpy(rng.random(n) < 0.5), dt.bool_)),
        ("i", "f", "s", "d", "b"))


def _read_onto_card_then_k2(read):
    """``read(device)`` onto the card by default: every column there, then
    filter (K2 launched) equal to the same filter of the CPU read, which
    runs K2's plain version; floats bit for bit."""
    from arrow1_tpu_torch.compute_nested import move, same_nested
    from arrow1_tpu_torch.table import concat_batches

    outs = []
    for dev in (None, "cpu"):
        b = concat_batches(read(dev).batches)
        assert all(c.device.type == ("cuda" if dev is None else "cpu")
                   for c in b.columns)
        mask = pt.call_function("greater", [b["f"], pt.scalar(0.0)])
        before = compact.launches
        outs.append(pt.call_function("filter", [b, mask]))
        if dev is None:
            assert compact.launches > before
    got, want = outs
    assert same_nested(move(got, "cpu"), want) is None
    assert torch.equal(_bits(got["f"].data.cpu()), _bits(want["f"].data))


def test_csv_file_read_onto_card_then_k2(cuda, tmp_path):
    from arrow1_tpu_torch.io import csv as pcsv

    path = str(tmp_path / "t.csv")
    pcsv.write_csv(_format_batch(), path)
    _read_onto_card_then_k2(lambda dev: pcsv.read_csv(path, device=dev))


def test_json_file_read_onto_card_then_k2(cuda, tmp_path):
    import json

    from arrow1_tpu_torch.io import json as pjson

    batch = _format_batch()
    cols = {n: batch[n].to_pylist() for n in ("i", "f", "s")}
    path = tmp_path / "t.json"
    path.write_text("".join(json.dumps({n: cols[n][r] for n in cols}) + "\n"
                            for r in range(batch.num_rows)))
    _read_onto_card_then_k2(lambda dev: pjson.read_json(str(path),
                                                        device=dev))


def test_parquet_file_read_onto_card_then_k2(cuda, tmp_path):
    from arrow1_tpu_torch.io import parquet as ppq

    path = str(tmp_path / "t.parquet")
    ppq.write_parquet(_format_batch(), path, row_group_size=2048)
    _read_onto_card_then_k2(lambda dev: ppq.read_parquet(path, device=dev))
    _read_onto_card_then_k2(lambda dev: pt.Table(list(
        ppq.iter_parquet_batches(path, device=dev))))


def test_orc_file_read_onto_card_then_k2(cuda, tmp_path):
    from arrow1_tpu_torch.io import orc as porc

    path = str(tmp_path / "t.orc")
    b = _format_batch()
    porc.write_orc(pt.Table([b.slice(0, 3000), b.slice(3000)]), path)
    _read_onto_card_then_k2(lambda dev: porc.read_orc(path, device=dev))


def test_runtime_reports_the_card(cuda, tmp_path):
    """runtime.profile writes a Chrome trace of a card run; the memory
    reports read the caching allocator."""
    from arrow1_tpu_torch import runtime

    with runtime.profile(str(tmp_path)) as prof:
        x = torch.arange(1 << 20, device=cuda)
        (x * 2).sum().item()
    assert prof.trace_path.startswith(str(tmp_path))
    assert (tmp_path / prof.trace_path.rsplit("/", 1)[-1]).stat().st_size > 0
    stats = runtime.device_memory_stats()
    assert stats["bytes_in_use"] == torch.cuda.memory_allocated() == \
        pt.total_allocated_bytes()
    assert stats["bytes_limit"] > stats["peak_bytes_in_use"] > 0
    info = runtime.runtime_info()
    assert info.backend == "cuda" and info.device_kind == \
        torch.cuda.get_device_name(0)


def test_dataset_partition_columns_on_card(cuda, tmp_path):
    """A Hive dataset scanned onto the card by default: its partition
    columns are made on the batch's device, the pushed filter launches K2,
    and every column equals the CPU scan's, floats bit for bit."""
    from arrow1_tpu_torch import dataset as ds
    from arrow1_tpu_torch.compute_nested import move, same_nested
    from arrow1_tpu_torch.table import concat_batches

    rng = np.random.default_rng(23)
    n = 6000
    src = pt.record_batch({"year": rng.integers(2020, 2023, n),
                           "v": rng.standard_normal(n),
                           "s": rng.choice(np.array(["a", "b"], object), n)},
                          device="cpu")
    ds.write_dataset(src, str(tmp_path / "ds"), ["year"])
    d = ds.dataset(str(tmp_path / "ds"), partitioning="hive")
    pred = (pt.field("year") >= 2021) & (pt.field("v") > 0)
    before = compact.launches
    got = concat_batches(d.to_table(filter=pred).batches)
    assert compact.launches > before
    assert all(c.device.type == "cuda" for c in got.columns)
    assert got["year"].data.device.type == "cuda"
    want = concat_batches(d.to_table(filter=pred, device="cpu").batches)
    assert same_nested(move(got, "cpu"), want) is None
    assert torch.equal(_bits(got["v"].data.cpu()), _bits(want["v"].data))
    q = (pt.query(d).filter(pt.field("year") == 2022)
         .group_by(["s"], [("v", "sum")]).to_batch())
    assert q["v_sum"].data.device.type == "cuda"


def test_cabi_import_and_builders_on_card(cuda):
    """C data capsules (pyarrow's and the port's own stream) imported onto
    the card equal the CPU import; builders finish onto the card."""
    import pyarrow as pa

    from arrow1_tpu_torch import builders, cabi, cdata
    from arrow1_tpu_torch.compute_nested import move, same_nested

    rb = pa.record_batch({"i": pa.array([1, None, 3], pa.int64()),
                          "f": pa.array([1.5, float("nan"), None]),
                          "s": pa.array(["x", None, "yy"]),
                          "d": pa.array([1, 2, None], pa.decimal128(9, 2)),
                          "n": pa.nulls(3)})
    got = cdata.import_batch(pa.Table.from_batches([rb]))
    want = cdata.import_batch(pa.Table.from_batches([rb]), device="cpu")
    assert all(c.device.type == "cuda" for c in got.columns)
    assert same_nested(move(got, "cpu"), want) is None
    back = cabi.import_stream_capsule(cabi.export_stream_capsule([got]))
    assert same_nested(move(back[0], "cpu"), want) is None
    vals = np.arange(1000, dtype=np.int64)
    col = builders.Int64Builder().append_values(vals).finish()
    assert col.device.type == "cuda" and col.data.cpu().tolist() == \
        vals.tolist()
    s = builders.StringBuilder().append_values(["b", None, "a"]).finish()
    assert s.device.type == "cuda" and s.to_pylist() == ["b", None, "a"]


def test_tensor_on_card(cuda):
    """Dense, COO, CSR and matvec on the card against the CPU's."""
    from arrow1_tpu_torch import tensor

    rng = np.random.default_rng(29)
    x = rng.standard_normal((500, 4))
    x[rng.random(x.shape) < 0.6] = 0.0
    t = tensor.Tensor.from_numpy(x)
    assert t.device.type == "cuda"
    coo, coo_c = t.to_coo(), tensor.Tensor.from_numpy(
        x, device="cpu").to_coo()
    assert torch.equal(coo.coords.cpu(), coo_c.coords)
    csr, csr_c = coo.to_csr(), coo_c.to_csr()
    assert torch.equal(csr.indptr.cpu(), csr_c.indptr)
    assert torch.equal(csr.to_dense().data.cpu(), torch.from_numpy(x))
    v = torch.tensor([1.0, -2.0, 0.5, 3.0], dtype=torch.float64)
    y, y_c = csr.matvec(v.to(cuda)).cpu(), csr_c.matvec(v)
    assert torch.allclose(y, y_c, rtol=1e-12, atol=0)
