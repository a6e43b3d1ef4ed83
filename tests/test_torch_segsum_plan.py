"""The host-side planner of the dense group accumulators (K3,
arrow1_tpu_torch/kernels/segsum2.py): which regime a shape gets, how the
owned regime's CTAs cover the groups, how columns split into launches and
rows into chunks. Pure Python: no card, no JAX."""

import pytest

from arrow1_tpu_torch.kernels import segsum2
from arrow1_tpu_torch.kernels.segsum2 import (MAX_COLS, MAX_G,
                                              OWNED_MAX_CLUSTER, ROW_CHUNK,
                                              launches, plan)

H100 = 232_448   # the shared memory an H100 CTA may opt in to (227 KB)


def owned_ranges(G, p):
    """The groups [lo, hi) whose counts each CTA rank of the cluster
    holds, as csrc/segment_sums.cu maps them (rank r: [r << shift,
    (r + 1) << shift) within [0, G)); every rank holds all of [0, G)
    outside the owned regime."""
    if p.mode != "owned":
        return [(0, G)] * p.cluster
    return [(min(r << p.shift, G), min((r + 1) << p.shift, G))
            for r in range(p.cluster)]


@pytest.mark.parametrize("G,mode,cluster,groups", [
    (1, "private", segsum2.PRIVATE_CLUSTER, 1),
    (1024, "private", segsum2.PRIVATE_CLUSTER, 1024),
    (H100 // 24, "private", segsum2.PRIVATE_CLUSTER, 9685),   # the top
    (H100 // 24 + 1, "owned", 2, 8192),                       # one past it
    (32_768, "owned", 2, 16_384),   # a CTA owns at most 16384 x 2 counts
    (32_769, "owned", 4, 16_384),
    (100_096, "owned", 8, 16_384),  # the group_by phase's padded G
    (MAX_G, "owned", 8, 16_384),
    (MAX_G + 1, "global", 1, MAX_G + 1)])
def test_regime_by_shape(G, mode, cluster, groups):
    """Two count and two sum slots (24 bytes a group), as the eager
    group_by's sum/mean/count/sum: the regime, cluster and groups a CTA
    holds by G alone."""
    p = plan(G, 2, 2, H100)
    assert (p.mode, p.cluster, p.groups) == (mode, cluster, groups)
    assert p.groups == 1 << p.shift or mode != "owned"


@pytest.mark.parametrize("ncnt,nsum", [(1, 0), (2, 2), (3, 2), (33, 32),
                                       (1, 32), (0, 3)])
@pytest.mark.parametrize("G", [1, 7, 1000, 9686, 12_000, 20_000, 65_536,
                               65_537, MAX_G, 1 << 20])
def test_groups_are_covered_once_and_fit(G, ncnt, nsum):
    """Every group's counts land in exactly one CTA of an owned cluster,
    ranges in rank order (the last ranks may hold none: the cluster is a
    power of two); what a CTA holds fits its shared memory, and a cluster
    half the size would not hold them; a shape that fits one CTA is
    private; one that no cluster of OWNED_MAX_CLUSTER holds goes global."""
    p = plan(G, ncnt, nsum, H100)
    ranges = owned_ranges(G, p)
    assert len(ranges) == p.cluster
    if p.mode == "private":
        assert G * (4 * ncnt + 8 * nsum) <= H100
    else:
        assert G * (4 * ncnt + 8 * nsum) > H100
    if p.mode == "owned":
        assert p.cluster in (2, 4, 8) and p.cluster <= OWNED_MAX_CLUSTER
        assert p.groups * 4 * ncnt <= H100
        assert p.cluster == 2 or (p.cluster // 2) * p.groups < G
        assert ranges[0][0] == 0 and ranges[-1][1] == G
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
        assert all(hi - lo <= p.groups for lo, hi in ranges)
        assert ranges[0][1] - ranges[0][0] == min(p.groups, G)
    else:
        assert ranges == [(0, G)] * p.cluster
    if p.mode == "global":
        assert p.cluster == 1 and p.groups == G
        if ncnt:   # even the largest cluster cannot hold the counts
            most = 1 << ((H100 // (4 * ncnt)).bit_length() - 1)
            assert OWNED_MAX_CLUSTER * most < G


def test_launches_split_columns_and_keep_slot_order():
    """40 columns: two launches of at most MAX_COLS; the first counts the
    occupancy into output row 0; count slots follow in column order; every
    output row is written by exactly one slot."""
    cols = [(i % 4 < 2, i % 2 == 0) for i in range(40)]   # (vals, live)
    cnt_rows, sum_rows, nslots = [], [], 1
    for vals, live in cols:
        cnt_rows.append(nslots if live else -1)
        nslots += live
        sum_rows.append(nslots if vals else -1)
        nslots += vals
    got = launches(cnt_rows, sum_rows)
    assert [ln.cols for ln in got] == [range(0, MAX_COLS), range(MAX_COLS,
                                                                 40)]
    assert [ln.occ for ln in got] == [0, -1]
    rows = []
    for ln in got:
        first = 1 if ln.occ == 0 else 0
        assert [k for k in ln.cnt if k >= 0] == list(
            range(first, len(ln.cnt_out)))
        assert [k for k in ln.sum if k >= 0] == list(range(len(ln.sum_out)))
        for c, k, s in zip(ln.cols, ln.cnt, ln.sum):
            assert (k >= 0) == cols[c][1] and (s >= 0) == cols[c][0]
            if k >= 0:
                assert ln.cnt_out[k] == cnt_rows[c]
            if s >= 0:
                assert ln.sum_out[s] == sum_rows[c]
        rows += ln.cnt_out + ln.sum_out
    assert sorted(rows) == list(range(nslots))


def test_launches_skip_a_chunk_without_slots():
    """A chunk of count-only columns with no mask adds nothing: no launch;
    with no columns at all one launch still counts the occupancy."""
    occ_only = segsum2.Launch(range(0, 1), [-1], [-1], [0], [], 0)
    assert launches([-1], [-1]) == [occ_only]
    assert launches([], []) == [occ_only._replace(cols=range(0, 0), cnt=[],
                                                  sum=[])]
    only_counts = [-1] * (MAX_COLS + 3)
    got = launches(only_counts, only_counts)
    assert len(got) == 1 and got[0].cols == range(0, MAX_COLS)


def test_row_chunks_keep_alignment_and_32_bit_counts():
    """A launch sees fewer than 2^32 rows (its counts are 32-bit), and a
    chunk's start keeps the 16-byte alignment of the id and value
    columns."""
    assert ROW_CHUNK < 1 << 32
    assert (ROW_CHUNK * 4) % 16 == 0 and (ROW_CHUNK * 8) % 16 == 0
