"""Static-capacity building blocks of the compiled pipeline (counterpart
of the filter, group-by and join parts of arrow1_tpu/ops/padded.py).

Every function keeps its outputs at a capacity fixed by the plan, with a
valid-count or valid-mask on the device, so a pipeline runs without host
syncs between operators. Scans are ``torch.cumsum`` or a flagged scan;
the JAX package's blocked scans (kernels/blockscan.py) only capped TPU
compile time and are not carried over. A float group sum adds each
group's own rows (``segment_float_sums``): a cumsum differenced across
groups, as the JAX package takes it, lets one group's magnitude, inf or
NaN reach every group after it.

When the group capacity G exceeds 65536, segment starts and segment-end
values come out of the compaction kernel (kernels/compaction.py, K2), as
the JAX package does on the TPU; at smaller G they are binary searches
and gathers.

``grouping_padded`` is the sort-based grouping of the distributed
operators (parallel/distributed.py, exec/dist_compiled.py): dense ids in
first-appearance order, padded to the row count.

The join core (``probe_ranges_sortmerge``, ``join_padded``) matches keys
exactly over every key plane through one merged stable sort, and expands
the matches into a fixed capacity by count, scan and write: each probe
row marks its first output slot, and every slot takes the row of the
last mark at or before it (``last_marked``).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from ..kernels.compaction import compact
from ..kernels.hashtable import _run_geometry
from ..kernels.radix import pack_layout, pack_operands, sort_permutation

__all__ = ["filter_padded", "last_marked", "probe_ranges_sortmerge",
           "join_padded", "SortedGroups", "group_sort_padded", "gsp_sort",
           "gsp_flags", "gsp_segments", "gsp_positions_big", "seg_sum_plane",
           "segment_float_sums", "seg_float_sum", "seg_minmax_plane",
           "seg_values_at_ends", "seg_diff_lo", "PaddedGroups",
           "grouping_padded"]

BIG_G = 65536   # above this group capacity, segments come from K2


def filter_padded(selected: torch.Tensor):
    """mask -> (indices[n], count): the first ``count`` slots hold the
    selected row positions in order, the rest point at row 0."""
    n = selected.shape[0]
    positions = torch.cumsum(selected, 0) - 1
    scatter_to = torch.where(selected, positions, n)
    indices = torch.zeros(n + 1, dtype=torch.int64, device=selected.device)
    indices.scatter_(0, scatter_to, torch.arange(n, device=selected.device))
    return indices[:n], selected.sum(dtype=torch.int64)


def last_marked(mark: torch.Tensor) -> torch.Tensor:
    """For each position p, the last position q <= p where ``mark`` is set,
    or -1: a running max of the marked positions, as one cumsum, one
    scatter and one gather (torch.cummax is a generic scan with indices,
    some 20 ms at 7.5M rows on an H100)."""
    n = mark.shape[0]
    k = torch.cumsum(mark, 0)              # marks at or before p
    pos_of = torch.full((n + 2,), -1, dtype=torch.int64, device=mark.device)
    pos_of.scatter_(0, torch.where(mark, k, n + 1),
                    torch.arange(n, device=mark.device))
    return pos_of[k]


def _as_sort_planes(key) -> List[torch.Tensor]:
    """A join key as a list of equality planes, most significant first. A
    single tensor holds unsigned 64-bit keys as int64 bit patterns; a list
    or tuple is taken as it is (exact equality over every plane). Planes
    compare in unsigned order: a uint8 plane is 8 bits wide, any other 64
    bits wide."""
    if isinstance(key, (list, tuple)):
        return list(key)
    return [key]


def _plane_bits(plane: torch.Tensor) -> int:
    return 8 if plane.dtype == torch.uint8 else 64


def probe_ranges_sortmerge(probe_key, build_key,
                           want_build_matched: bool = False):
    """Per-probe build match ranges through one merged stable sort.

    Stable-sort concat(build, probe) by the key planes: within an
    equal-key run the build rows come first, in build order. A probe's
    matches are then the build rows of its run, and the builds before its
    run are its start in the build order; all of it is cumsum, the run
    geometry (kernels/hashtable._run_geometry: where each run starts and
    ends, by a cumsum, a scatter and gathers, in place of the reference's
    running max and min) and gathers.

    Returns (build_order int64[m], build rows sorted by key;
             lo int64[n], start of each probe's range in build_order;
             counts int32[n][, build_matched bool[m] when asked]).
    """
    pks = _as_sort_planes(probe_key)
    bks = _as_sort_planes(build_key)
    m = bks[0].shape[0]
    n = pks[0].shape[0]
    dev = bks[0].device
    planes = [torch.cat([b, p]) for b, p in zip(bks, pks)]
    nm = n + m
    pos = torch.arange(nm, device=dev)
    if nm:
        morder = sort_permutation(planes, [_plane_bits(p) for p in planes])
    else:
        morder = pos
    inv = torch.empty_like(morder)
    inv[morder] = pos
    is_build = morder < m
    first = torch.ones(nm, dtype=torch.bool, device=dev)
    if nm > 1:
        neq = torch.zeros(nm - 1, dtype=torch.bool, device=dev)
        for pl in planes:
            ps = pl[morder]
            neq |= ps[1:] != ps[:-1]
        first[1:] = neq
    b_incl = torch.cumsum(is_build, 0)
    b_excl = b_incl - is_build.long()        # builds strictly before p
    run_start_pos, next_start, _, _ = _run_geometry(first)
    run_base = b_excl[run_start_pos]         # builds before my run
    cnt_all = (b_excl - run_base).to(torch.int32)
    ppos = inv[m:]
    lo = run_base[ppos]
    counts = cnt_all[ppos]
    # the build rows in merged order are the build rows sorted by key,
    # stably: one scatter to their rank among the builds
    build_order = torch.empty(m + 1, dtype=torch.int64, device=dev)
    build_order.scatter_(0, torch.where(is_build, b_excl, m), morder)
    build_order = build_order[:m]
    if not want_build_matched:
        return build_order, lo, counts
    # a build row is matched iff its run holds a probe: probes through the
    # run's end minus probes before its start, from the same sort
    p_excl = pos - b_excl                    # probes strictly before p
    p_excl_ext = torch.cat([p_excl, p_excl.new_full((1,), n)])
    run_probe_cnt = p_excl_ext[next_start] - p_excl[run_start_pos]
    build_matched = (run_probe_cnt > 0)[inv[:m]]
    return build_order, lo, counts, build_matched


def join_padded(probe_key, build_key, probe_valid: Optional[torch.Tensor],
                build_valid: Optional[torch.Tensor], capacity: int,
                outer: bool = False,
                probe_live: Optional[torch.Tensor] = None):
    """Static-capacity equi-join core of the compiled pipeline.

    probe_valid/build_valid: key validity; a null-key probe row matches
    nothing but is emitted (with nulls) under ``outer``. probe_live: dead
    probe rows are never emitted. probe_key/build_key: one tensor of u64
    bit patterns, or a list of key planes matched exactly.

    Returns (probe_idx int64[capacity], build_idx int64[capacity],
    pair_valid bool[capacity], pair_has_match bool[capacity],
    build_matched bool[m], total int64 scalar, overflowed bool scalar).
    Matches beyond ``capacity`` are dropped and flagged by ``overflowed``.
    Slots past ``total`` repeat the last probe row, as the reference's
    binary search of each slot gives them.
    """
    if isinstance(probe_key, (list, tuple)):
        pks, bks = list(probe_key), list(build_key)
        nl, nr = pks[0].shape[0], bks[0].shape[0]
        if probe_valid is not None or build_valid is not None:
            # null-class plane: null build keys (1) and null probe keys
            # (2) never equal anything on the other side
            dev = pks[0].device
            bcls = torch.zeros(nr, dtype=torch.uint8, device=dev) \
                if build_valid is None else (~build_valid).to(torch.uint8)
            pcls = torch.zeros(nl, dtype=torch.uint8, device=dev) \
                if probe_valid is None else (~probe_valid).to(torch.uint8) * 2
            pks = [pcls] + pks
            bks = [bcls] + bks
        pk, bk = pks, bks
    else:
        nl, nr = probe_key.shape[0], build_key.shape[0]
        sent = -1   # 0xFFFF_FFFF_FFFF_FFFF as an int64 bit pattern
        bk = build_key if build_valid is None else \
            torch.where(build_valid, build_key, sent)
        pk = probe_key if probe_valid is None else \
            torch.where(probe_valid, probe_key, sent - 1)
    build_order, lo, counts, build_matched = probe_ranges_sortmerge(
        pk, bk, want_build_matched=True)
    dev = lo.device
    if probe_valid is not None:
        counts = torch.where(probe_valid, counts, 0)
    matched = counts > 0
    emit = counts.clamp(min=1) if outer else counts
    if probe_live is not None:
        emit = torch.where(probe_live, emit, 0)
    emit = emit.to(torch.int64)
    incl = torch.cumsum(emit, 0)
    offsets = incl - emit
    total = incl[-1] if nl else torch.zeros((), dtype=torch.int64,
                                             device=dev)
    overflowed = total > capacity

    # count -> scan -> write: each emitting row marks its first slot and
    # writes its index there; every slot reads the row of the last mark
    # at or before it. Slots past the total belong to the last row (the
    # reference's searchsorted 'right' of each slot)
    slots = torch.arange(capacity, device=dev)
    starts = torch.where((emit > 0) & (offsets < capacity), offsets,
                         capacity)
    marks = torch.zeros(capacity + 1, dtype=torch.bool, device=dev)
    marks.scatter_(0, starts, True)
    row_at = torch.zeros(capacity + 1, dtype=torch.int64, device=dev)
    row_at.scatter_(0, starts, torch.arange(nl, device=dev))
    owner = row_at[last_marked(marks[:capacity]).clamp(min=0)]
    pair_valid = slots < total
    if nl:
        probe_idx = torch.where(pair_valid, owner, nl - 1)
        within = slots - offsets[probe_idx]
        pos = lo[probe_idx] + torch.minimum(
            within, (counts[probe_idx].to(torch.int64) - 1).clamp(min=0))
    else:
        probe_idx = pos = torch.zeros_like(slots)
    if nr:
        build_idx = build_order[pos.clamp(0, nr - 1)]
    else:
        build_idx = torch.zeros(capacity, dtype=torch.int64, device=dev)
    if outer and nl:
        pair_has_match = matched[probe_idx]
    else:
        pair_has_match = torch.ones(capacity, dtype=torch.bool, device=dev)
    if build_valid is not None:
        build_matched = build_matched & build_valid
    return (probe_idx, build_idx, pair_valid, pair_has_match,
            build_matched, total, overflowed)


class SortedGroups(NamedTuple):
    """Sorted-space segments with a static group capacity G."""

    live_sorted: torch.Tensor   # bool[n]  rows in sorted order, dead last
    first: torch.Tensor         # bool[n]  segment-start flags
    startpos: torch.Tensor      # int64[G] sorted position of group start
    endpos: torch.Tensor        # int64[G] sorted position of group end
    group_valid: torch.Tensor   # bool[G]  slot < num_groups
    num_groups: torch.Tensor    # int64 scalar (live groups only)
    overflow: torch.Tensor      # bool scalar: num_groups > G


def group_sort_padded(key_pairs: Sequence[Tuple[torch.Tensor, int]],
                      live: Optional[torch.Tensor],
                      payloads: Sequence[torch.Tensor], G: int):
    """Scatter-free grouping with static capacity G: one stable sort of
    the packed key words (a dead-row bit leads, so dead rows sort last),
    payloads gathered into sorted order, then segment boundaries.

    Returns (SortedGroups, payloads in sorted order, key words in sorted
    order, placements, words_at_start): placements[i] = (word, shift,
    bits) locates key_pairs[i] in the words; words_at_start[w][g] is word
    w at group g's start when it rode the large-G compaction, else None
    (callers gather)."""
    sorted_words, sorted_payloads, used, placements = gsp_sort(
        key_pairs, live, payloads)
    sg, words_at_start = gsp_segments(sorted_words, used, live is not None,
                                      G)
    return sg, sorted_payloads, sorted_words, placements, words_at_start


def gsp_sort(key_pairs, live, payloads):
    """Pack the keys (with a leading dead-row bit when ``live`` is given),
    sort stably, and carry the payloads. Returns (sorted_words,
    sorted_payloads, used_bits, placements)."""
    pairs = list(key_pairs)
    if live is not None:
        pairs = [((~live).to(torch.int64), 1)] + pairs
    placements = pack_layout(pairs)
    if live is not None:
        placements = placements[1:]
    words, used = pack_operands(pairs)
    perm = sort_permutation(words, used)
    return ([w[perm] for w in words], [p[perm] for p in payloads], used,
            placements)


def gsp_flags(sorted_words, used, have_live):
    """Live mask, segment-start flags and live group count of the sorted
    key words."""
    n = sorted_words[0].shape[0]
    dev = sorted_words[0].device
    if have_live:   # the dead bit is the top used bit of word 0
        live_sorted = ((sorted_words[0] >> (used[0] - 1)) & 1) == 0
    else:
        live_sorted = torch.ones(n, dtype=torch.bool, device=dev)
    first = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        same = torch.ones(n - 1, dtype=torch.bool, device=dev)
        for w in sorted_words:
            same = same & (w[1:] == w[:-1])
        first[1:] = ~same
    num_groups = (first & live_sorted).sum(dtype=torch.int64)
    return live_sorted, first, num_groups


def gsp_segments(sorted_words, used, have_live, G):
    """Flags, then slot positions: binary search at G <= 65536, the
    compaction kernel above it. Returns (SortedGroups, words_at_start)."""
    n = sorted_words[0].shape[0]
    dev = sorted_words[0].device
    live_sorted, first, num_groups = gsp_flags(sorted_words, used, have_live)
    overflow = num_groups > G
    slots = torch.arange(G, device=dev)
    group_valid = slots < num_groups
    if G <= BIG_G:
        gid_sorted = torch.cumsum(first, 0) - 1
        right = torch.searchsorted(gid_sorted, slots, right=True)
        left = torch.cat([right.new_zeros(1), right[:-1]])
        endpos = torch.where(group_valid, (right - 1).clamp(min=0), 0)
        startpos = torch.where(group_valid, left, 0)
        return (SortedGroups(live_sorted, first, startpos, endpos,
                             group_valid, num_groups, overflow), None)
    # segment starts are the compaction of iota by the first-flags; the
    # sorted key words ride the same launch, so decoding the keys at the
    # group starts needs no G-sized gathers
    iota = torch.arange(n, dtype=torch.int32, device=dev)
    outs, total_segs = compact(first, (iota, *sorted_words))
    startpos, endpos, group_valid, words_at_start = gsp_positions_big(
        outs[0], total_segs, num_groups, G, n, list(outs[1:]))
    return (SortedGroups(live_sorted, first, startpos, endpos, group_valid,
                         num_groups, overflow), words_at_start)


def gsp_positions_big(pos_pad, total_segs, num_groups, G, n,
                      words_comp=None):
    """Slot positions from the compacted segment starts: a group ends one
    row before the next segment starts (a shifted slice, not a gather)."""
    dev = pos_pad.device
    slots = torch.arange(G, device=dev)
    group_valid = slots < num_groups
    pos_pad = pos_pad.to(torch.int64)
    startpos = torch.where(group_valid, pos_pad[:G], 0)
    words_at_start = None
    if words_comp is not None:
        words_at_start = [torch.where(group_valid, w[:G], 0)
                          for w in words_comp]
    nxt = torch.cat([pos_pad[1:G + 1],
                     pos_pad.new_zeros(max(G + 1 - pos_pad.shape[0], 0))])
    nxt = torch.where(slots + 1 < total_segs, nxt, n)
    endpos = torch.where(group_valid, (nxt - 1).clamp(min=0), 0)
    return startpos, endpos, group_valid, words_at_start


def seg_sum_plane(xs: torch.Tensor, mask_s: Optional[torch.Tensor],
                  sg: SortedGroups, acc_dtype) -> torch.Tensor:
    """Full-length inclusive cumsum plane of an integer segment sum (exact
    mod 2^64 across groups); read it at the segment ends
    (seg_values_at_ends) and difference (seg_diff_lo). Float sums take
    ``seg_float_sum``."""
    m = sg.live_sorted if mask_s is None else (mask_s & sg.live_sorted)
    return torch.cumsum(torch.where(m, xs.to(acc_dtype), 0), 0,
                        dtype=acc_dtype)


def segment_float_sums(xs: torch.Tensor, lengths: torch.Tensor
                       ) -> torch.Tensor:
    """Sums of consecutive segments of the float tensor ``xs``, the first
    starting at row 0 (``lengths`` may cover fewer rows than ``xs``
    holds); an empty segment sums to 0. Each sum adds its own segment's
    rows only, so one group's magnitude, inf or NaN never reaches another,
    as it would through a cumsum that crosses groups. The additions run in
    a fixed order (no atomics): a rerun gives the same bits. ``unsafe``
    skips the checks of the lengths, which would read them on the host."""
    return torch.segment_reduce(xs, "sum", lengths=lengths, unsafe=True)


def seg_float_sum(xs: torch.Tensor, mask_s: Optional[torch.Tensor],
                  sg: SortedGroups) -> torch.Tensor:
    """Per-slot float64 sums [G]: the valid slots' segments tile the
    sorted rows from row 0, masked rows add 0, and slots past num_groups
    are empty (0)."""
    m = sg.live_sorted if mask_s is None else (mask_s & sg.live_sorted)
    lengths = torch.where(sg.group_valid, sg.endpos - sg.startpos + 1, 0)
    return segment_float_sums(torch.where(m, xs.to(torch.float64), 0.0),
                              lengths)


def seg_diff_lo(hi: torch.Tensor, sg: SortedGroups) -> torch.Tensor:
    """Cumsum values at segment ends -> per-slot sums: segments tile the
    sorted rows, so the low side is the high side shifted by one slot."""
    lo = torch.cat([hi.new_zeros(1), hi[:-1]])
    return torch.where(sg.group_valid, hi - lo, 0)


def seg_values_at_ends(sg: SortedGroups, planes: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
    """Each full-length plane's values at the segment ends, slot-aligned
    to [G]; slots past num_groups hold garbage (callers mask with
    group_valid). At large G the integer and bool planes ride one
    last-flag compaction: the j-th segment's end value is the j-th kept
    element. Float planes, and every plane at small G, are gathered."""
    G = sg.startpos.shape[0]
    out: List[Optional[torch.Tensor]] = [None] * len(planes)
    compacted = [i for i, p in enumerate(planes)
                 if G > BIG_G and not p.is_floating_point()]
    for i, p in enumerate(planes):
        if i not in compacted:
            out[i] = p[sg.endpos]
    if compacted:
        last = torch.cat([sg.first[1:], sg.first.new_ones(1)])
        outs, _ = compact(last, [planes[i] for i in compacted])
        for j, i in enumerate(compacted):
            out[i] = outs[j][:G]
    return out


def _segmented_scan(vals: torch.Tensor, first: torch.Tensor, op):
    """Inclusive scan of ``op`` that restarts at every first-flag
    (Hillis-Steele doubling over the associative flagged operator)."""
    v, f = vals, first
    d = 1
    while d < v.shape[0]:
        nv = torch.where(f[d:], v[d:], op(v[:-d], v[d:]))
        v = torch.cat([v[:d], nv])
        f = torch.cat([f[:d], f[:-d] | f[d:]])
        d <<= 1
    return v


def seg_minmax_plane(xs: torch.Tensor, mask_s: Optional[torch.Tensor],
                     sg: SortedGroups, is_min: bool, init) -> torch.Tensor:
    """Full-length flagged-scan plane of a segment min/max; ``init`` is
    the identity that masked rows contribute. NaN is skipped, as masked
    rows are (a group whose valid values are all NaN reads ``init``; the
    caller puts NaN there)."""
    m = sg.live_sorted if mask_s is None else (mask_s & sg.live_sorted)
    if xs.is_floating_point():
        m = m & ~torch.isnan(xs)
    vals = torch.where(m, xs, init)
    if vals.dtype == torch.bool:
        op = torch.logical_and if is_min else torch.logical_or
    else:
        op = torch.minimum if is_min else torch.maximum
    return _segmented_scan(vals, sg.first, op)


class PaddedGroups(NamedTuple):
    """Groups padded to the row count n (counterpart of the reference's
    ``PaddedGroups``; ids are int64, torch's index type)."""

    group_ids: torch.Tensor    # int64[n] dense id per row, first-appearance
    rep_rows: torch.Tensor     # int64[n] first row of each group (padded)
    num_groups: torch.Tensor   # int64 scalar
    group_valid: torch.Tensor  # bool[n] slot < num_groups


def grouping_padded(keys: Sequence[torch.Tensor]) -> PaddedGroups:
    """Sort-based grouping with static shapes: one stable sort of the key
    planes (``probe_ranges_sortmerge``'s plane order: uint8 planes 8 bits,
    others unsigned 64-bit patterns), first-flags, a cumsum for the sorted
    group ids, then the groups ranked by their first row, so the ids are in
    first-appearance order with ``num_groups`` on the device."""
    keys = list(keys)
    n = keys[0].shape[0]
    dev = keys[0].device
    pos = torch.arange(n, device=dev)
    if n == 0:
        return PaddedGroups(pos, pos, torch.zeros((), dtype=torch.int64,
                                                  device=dev),
                            torch.zeros(0, dtype=torch.bool, device=dev))
    order = sort_permutation(keys, [_plane_bits(k) for k in keys])
    first = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        same = torch.ones(n - 1, dtype=torch.bool, device=dev)
        for k in keys:
            ks = k[order]
            same &= ks[1:] == ks[:-1]
        first[1:] = ~same
    gid_sorted = torch.cumsum(first, 0) - 1
    num_groups = gid_sorted[-1] + 1
    row_gid = torch.empty_like(gid_sorted)
    row_gid[order] = gid_sorted
    # each sorted group's first row (the stable sort keeps rows in order)
    rep_sorted = torch.full((n + 1,), n, dtype=torch.int64, device=dev)
    rep_sorted.scatter_(0, torch.where(first, gid_sorted, n), order)
    slot_valid = pos < num_groups
    rep_key = torch.where(slot_valid, rep_sorted[:n], n)
    appearance = torch.sort(rep_key, stable=True).indices
    rep_rows = torch.where(slot_valid, rep_key[appearance], 0)
    rank = torch.empty_like(appearance)
    rank[appearance] = pos
    return PaddedGroups(rank[row_gid], rep_rows, num_groups, slot_valid)
