"""Equi-join (inner, left/right/full outer, left/right semi and anti) and
the as-of join (counterpart of arrow1_tpu/ops/join.py).

Semantics follow SQL and pyarrow ``Table.join``: null keys match
nothing; every probe-side match pair is emitted; outer variants emit
unmatched rows with nulls on the other side. Row order is deterministic:
probe (left) order, and each probe's matches in build (right) order.

1. A single non-float key column joins on its raw normalized u64 key
   (``normalize_sort_key``'s total-order bits) through the bucketed hash
   table (kernels/hashtable.py): one build-side sort and a gather probe.
   Every other key (floats, decimals, several columns; a decimal key is
   its limbs, both sides at their common type) collapses to one dense id
   per row by grouping the union of both sides' key planes
   (``ops/hash.grouping_by_keys``), and the ids meet in the merged
   sort-merge probe (``ops/padded.probe_ranges_sortmerge``). In a join,
   -0.0 and +0.0 are different keys and all NaNs are one key.
2. The total match count is read on the host (it sizes the result, as
   filter does), then the matches expand: each probe row repeated by its
   count (``repeat_interleave``), each copy picking the next build row of
   its range.

The dispatch is the reference's ``auto`` mode; its environment switches
(``A1T_JOIN``, ``A1T_JOIN_PROBE_CHUNK``) are not carried over, and the
probe chunk is ``kernels/hashtable.PROBE_CHUNK``. Joins run on the
batches' device.
"""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..column import Column
from ..errors import Invalid
from ..kernels.hashtable import (MAX_BITS, join_build, join_probe,
                                 table_bits_for)
from ..kernels.radix import _SIGN, sort_permutation
from ..table import RecordBatch
from .common import collapse_validity
from .decimal import common_decimal_type, decimal_cast
from .dictionary import unify_pair
from .hash import grouping_by_keys
from .padded import last_marked, probe_ranges_sortmerge
from .selection import gather_batch
from .sort import normalize_sort_key

__all__ = ["join", "join_indices", "join_asof", "key_planes",
           "key_validity"]

_JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
               "left semi", "left anti", "right semi", "right anti")
_I32_MAX = (1 << 31) - 1
_I32_MIN = -(1 << 31)


def key_planes(lc: Column, rc: Column):
    """The normalized key planes (``normalize_sort_key``) of one pair of
    join key columns, most significant first: string columns are first
    re-encoded against one merged pool, and the side without a class
    plane (no null, no NaN) gets a zero one. Returns (lkeys, rkeys)."""
    if lc.dtype.is_binary != rc.dtype.is_binary:
        raise Invalid(f"join: key type mismatch {lc.dtype} vs {rc.dtype}")
    if lc.dtype.is_binary and lc.dictionary is not rc.dictionary:
        lc, rc = unify_pair(lc, rc)
    if lc.dtype.is_decimal and lc.dtype != rc.dtype:   # one scale, width
        t = common_decimal_type([lc.dtype, rc.dtype])
        lc, rc = (decimal_cast(c, t, allow_truncate=False, check_range=False)
                  for c in (lc, rc))
    lkeys = normalize_sort_key(lc)
    rkeys = normalize_sort_key(rc)
    if len(lkeys) < len(rkeys):
        lkeys = [torch.zeros_like(lkeys[0])] + lkeys
    elif len(rkeys) < len(lkeys):
        rkeys = [torch.zeros_like(rkeys[0])] + rkeys
    return lkeys, rkeys


def key_validity(batch: RecordBatch, names: Sequence[str]):
    """The AND of the key columns' validities (None when all are valid)."""
    v = None
    for k in names:
        c = batch.column(k)
        if c.validity is not None:
            v = c.validity if v is None else (v & c.validity)
    return v


def _key_ids(left: RecordBatch, right: RecordBatch,
             left_keys: Sequence[str], right_keys: Sequence[str],
             allow_raw: bool = False):
    """Join keys of both sides and each side's key validity.

    Returns (lkeys, rkeys, lvalid, rvalid, raw). With ``allow_raw`` and a
    single non-float key column the keys are its raw normalized u64 bits
    (``raw`` True; nullness lives in the validity masks only). Otherwise
    they are dense int32 ids from grouping the union of both sides."""
    if len(left_keys) != len(right_keys):
        raise Invalid("join: key count mismatch")
    pairs = []   # (plane over both sides, bits) for grouping_by_keys
    n_float = 0   # keys of more than one plane: floats, decimals
    for lk, rk in zip(left_keys, right_keys):
        lc = left.column(lk)
        n_float += lc.dtype.is_floating or lc.dtype.is_decimal
        lkeys, rkeys = key_planes(lc, right.column(rk))
        for i, (lp, rp) in enumerate(zip(lkeys, rkeys)):
            # a class plane holds 0 (value), 1 (NaN) or 2 (null)
            bits = 2 if len(lkeys) == 2 and i == 0 else 64
            pairs.append((torch.cat([lp, rp]), bits))
    n = left.num_rows
    lvalid = key_validity(left, left_keys)
    rvalid = key_validity(right, right_keys)
    if allow_raw and len(left_keys) == 1 and n_float == 0:
        u = pairs[-1][0]
        return u[:n], u[n:], lvalid, rvalid, True
    gids, _, _ = grouping_by_keys(pairs)
    return gids[:n], gids[n:], lvalid, rvalid, False


def _build_table(build_u64, live):
    """join_build, doubling the bucket count until every key fits (the
    overflow count is read on the host)."""
    bits = table_bits_for(build_u64.shape[0])
    while True:
        order, table = join_build(build_u64, bits=bits, live=live)
        if int(table.overflow) == 0:
            return order, table
        if bits >= MAX_BITS:
            raise Invalid("join: hash table overflow at maximum size")
        bits += 1


def _hash_probe_ranges(probe_u64, build_u64, build_valid):
    """(build_order, lo int64, counts int32) through the bucketed hash
    table on raw u64 keys; null build keys are dead rows."""
    order, table = _build_table(build_u64, build_valid)
    lo, counts = join_probe(table, probe_u64)
    return order, lo.to(torch.int64), counts


def _hash_matched(test_u64, table_u64, table_valid):
    """bool[n]: does each test key match at least one valid table key."""
    _, table = _build_table(table_u64, table_valid)
    _, counts = join_probe(table, test_u64)
    return counts > 0


def _sorted_matched(test_ids, table_ids, table_valid):
    """bool[n] of the id path: binary searches of each test id in the
    sorted table ids (null table keys painted with an id no test has)."""
    if table_valid is not None:
        table_ids = torch.where(table_valid, table_ids, _I32_MIN)
    table_sorted = torch.sort(table_ids.to(torch.int64)).values
    t = test_ids.to(torch.int64)
    lo = torch.searchsorted(table_sorted, t, side="left")
    hi = torch.searchsorted(table_sorted, t, side="right")
    return (hi - lo) > 0


def _nonzero(mask: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(mask).squeeze(1)


def join_indices(left: RecordBatch, right: RecordBatch,
                 left_keys: Sequence[str], right_keys: Sequence[str],
                 join_type: str = "inner"):
    """(left_idx, right_idx, left_valid, right_valid) row-index tensors
    describing the join result (int64 indices, bool validities, None where
    a side is absent or all valid)."""
    if join_type not in _JOIN_TYPES:
        raise Invalid(f"unsupported join type {join_type!r}")
    lids, rids, lvalid, rvalid, raw = _key_ids(
        left, right, left_keys, right_keys, allow_raw=True)
    nl, nr = left.num_rows, right.num_rows
    if raw:
        build_order, lo, counts = _hash_probe_ranges(lids, rids, rvalid)
    else:
        # null build keys can never match: paint them with an id no probe
        # has (ids are dense int32)
        if rvalid is not None:
            rids = torch.where(rvalid, rids, _I32_MAX)
        build_order, lo, counts = probe_ranges_sortmerge(
            lids.to(torch.int64), rids.to(torch.int64))
    counts = counts.to(torch.int32)
    if lvalid is not None:
        counts = torch.where(lvalid, counts, 0)   # null probes match nothing
    matched = counts > 0

    def right_matched():
        if raw:
            rm = _hash_matched(rids, lids, lvalid)
        else:
            rm = _sorted_matched(rids, lids, lvalid)
        return rm if rvalid is None else (rm & rvalid)

    if join_type in ("left semi", "left anti"):
        mask = matched if join_type == "left semi" else ~matched
        return _nonzero(mask), None, None, None
    if join_type in ("right semi", "right anti"):
        rm = right_matched()
        mask = rm if join_type == "right semi" else ~rm
        return None, _nonzero(mask), None, None

    outer_left = join_type in ("left outer", "full outer")
    emit = (counts.clamp(min=1) if outer_left else counts).to(torch.int64)
    total = int(emit.sum())   # the host sync that sizes the result
    dev = emit.device
    left_idx = torch.repeat_interleave(torch.arange(nl, device=dev), emit,
                                       output_size=total)
    offsets = torch.cumsum(emit, 0) - emit
    within = torch.arange(total, device=dev) - offsets[left_idx]
    has_match = matched[left_idx]
    pos = lo[left_idx] + torch.minimum(
        within, (counts[left_idx].to(torch.int64) - 1).clamp(min=0))
    if nr:
        right_idx = build_order[pos.clamp(0, nr - 1)]
    else:
        right_idx = torch.zeros(total, dtype=torch.int64, device=dev)
    right_valid = has_match if outer_left else None

    if join_type == "full outer":
        unmatched = _nonzero(~right_matched())
        n_un = unmatched.shape[0]
        left_idx = torch.cat([left_idx, left_idx.new_zeros(n_un)])
        right_idx = torch.cat([right_idx, unmatched])
        left_valid = torch.cat([
            torch.ones(total, dtype=torch.bool, device=dev),
            torch.zeros(n_un, dtype=torch.bool, device=dev)])
        right_valid = torch.cat([
            right_valid, torch.ones(n_un, dtype=torch.bool, device=dev)])
        return left_idx, right_idx, left_valid, right_valid
    return left_idx, right_idx, None, right_valid


def _coalesce(kcol: Column, rcol: Column) -> Column:
    """The full-outer key: the left value where it is valid, else the
    right's (dictionary keys re-encoded against one pool first)."""
    if kcol.dictionary is not None and kcol.dictionary is not rcol.dictionary:
        kcol, rcol = unify_pair(kcol, rcol)
    kmask = kcol.mask()
    data = torch.where(kmask, kcol.data, rcol.data)
    data2 = None
    if kcol.data2 is not None:   # every limb of a decimal key
        if rcol.dtype != kcol.dtype:
            rcol = decimal_cast(rcol, kcol.dtype, allow_truncate=False,
                                check_range=False)
            data = torch.where(kmask, kcol.data, rcol.data)
        data2 = torch.where(kmask if kcol.data2.dim() == 1 else
                            kmask[:, None], kcol.data2, rcol.data2)
    validity = kmask | rcol.mask()
    return Column(data, kcol.dtype, validity=collapse_validity(validity),
                  dictionary=kcol.dictionary, data2=data2)


def _take(col: Column, idx, validity) -> Column:
    """One column's gather, null rows when the column is empty."""
    return gather_batch(RecordBatch((col,), ("c",)), idx, validity)["c"]


def _payload(batch: RecordBatch, skip, idx, validity, suffix: str):
    cols = [(n, c) for n, c in zip(batch.names, batch.columns)
            if n not in skip]
    if not cols:
        return [], []
    sub = gather_batch(RecordBatch(tuple(c for _, c in cols),
                                   tuple(n for n, _ in cols)), idx, validity)
    return [n + suffix for n, _ in cols], list(sub.columns)


def join(left: RecordBatch, right: RecordBatch, keys, right_keys=None,
         join_type: str = "inner", left_suffix: str = "",
         right_suffix: str = "") -> RecordBatch:
    """Materialized equi-join (API shape: pyarrow Table.join).

    Output columns: the join keys (coalesced for full outer), then the
    left non-key columns, then the right non-key columns. Row order:
    probe (left) order, matches in build (right) order."""
    for side, which in ((left, "left"), (right, "right")):
        if not isinstance(side, RecordBatch):
            raise TypeError(f"join: {which} must be an arrow1_tpu_torch "
                            f"RecordBatch, got {type(side).__name__}")
    keys = [keys] if isinstance(keys, str) else list(keys)
    right_keys = list(right_keys or keys)
    if join_type == "right outer":
        # probe with the right side (left outer, sides swapped), then emit
        # the columns in the canonical order with the right side's keys
        flipped = join(right, left, right_keys, keys, "left outer",
                       right_suffix, left_suffix)
        names = list(keys)
        cols = [flipped.column(rk) for rk in right_keys]
        for n in left.names:
            if n not in set(keys):
                names.append(n + left_suffix)
                cols.append(flipped.column(n + left_suffix))
        for n in right.names:
            if n not in set(right_keys):
                names.append(n + right_suffix)
                cols.append(flipped.column(n + right_suffix))
        return RecordBatch(tuple(cols), tuple(names))
    li, ri, lv, rv = join_indices(left, right, keys, right_keys, join_type)
    if join_type in ("left semi", "left anti"):
        return gather_batch(left, li)
    if join_type in ("right semi", "right anti"):
        return gather_batch(right, ri)
    names: List[str] = []
    cols: List[Column] = []
    for lk, rk in zip(keys, right_keys):
        kcol = _take(left.column(lk), li, lv)
        if join_type == "full outer":
            kcol = _coalesce(kcol, _take(right.column(rk), ri, rv))
        names.append(lk)
        cols.append(kcol)
    for batch, skip, idx, validity, suffix in (
            (left, set(keys), li, lv, left_suffix),
            (right, set(right_keys), ri, rv, right_suffix)):
        n, c = _payload(batch, skip, idx, validity, suffix)
        names += n
        cols += c
    return RecordBatch(tuple(cols), tuple(names))


def join_asof(left: RecordBatch, right: RecordBatch, on: str, by=None,
              tolerance: int = 0) -> RecordBatch:
    """As-of join (API shape: pyarrow Table.join_asof).

    tolerance <= 0: for each left row, the latest right row with on_r in
    [on_l + tolerance, on_l] (backward). tolerance > 0: the earliest right
    row with on_r in [on_l, on_l + tolerance] (forward, the backward join
    on negated ``on``). Ties at equal ``on`` match. Every left row is
    kept; unmatched rows get nulls.

    One merged stable sort by (by-ids, on) with right rows before left
    rows at equal keys, then each row reads the latest right position at
    or before it (``last_marked``, the reference's running max)."""
    by = [by] if isinstance(by, str) else list(by or [])
    n, m = left.num_rows, right.num_rows
    lon = left.column(on).data.to(torch.int64)
    ron = right.column(on).data.to(torch.int64)
    dev = lon.device
    if tolerance > 0:
        lon, ron = -lon, -ron
        window = int(tolerance)
    else:
        window = -int(tolerance)
    if by:
        lids, rids, _, _, _ = _key_ids(left, right, by, by)
    else:
        lids = torch.zeros(n, dtype=torch.int32, device=dev)
        rids = torch.zeros(m, dtype=torch.int32, device=dev)
    # right rows first, so an equal (by, on) right row is visible to the
    # left row that follows it in the stable sort
    gid = torch.cat([rids, lids]).to(torch.int64)
    on_all = torch.cat([ron, lon])
    sort_keys = [gid, on_all ^ _SIGN]
    if tolerance > 0:
        # forward joins take the earliest duplicate right row at equal
        # (by, on): right rows in reverse order, left rows after them
        sort_keys.append(torch.cat([
            torch.arange(m - 1, -1, -1, device=dev),
            torch.full((n,), 1 << 40, dtype=torch.int64, device=dev)]))
    order = sort_permutation(sort_keys)
    pos = torch.arange(n + m, device=dev)
    carry = last_marked(order < m)   # latest right row at or before p
    g_sorted = gid[order]
    on_sorted = on_all[order]
    safe_carry = carry.clamp(0, max(n + m - 1, 0))
    ok = (carry >= 0) & (g_sorted[safe_carry] == g_sorted) & \
        ((on_sorted - on_sorted[safe_carry]) <= window)
    carried_row = order[safe_carry]   # a right row (< m) where ok
    inv = torch.empty_like(order)
    inv[order] = pos
    lslot = inv[m:]
    match = torch.where(ok[lslot], carried_row[lslot], m)
    has = match < m
    safe = match.clamp(0, max(m - 1, 0))
    cols, names = list(left.columns), list(left.names)
    skip = set(by) | {on}
    for cn in right.names:
        if cn in skip:
            continue
        got = _take(right.column(cn), safe, None)
        v = got.mask() & has
        cols.append(Column(got.data, got.dtype,
                           validity=collapse_validity(v),
                           dictionary=got.dictionary, data2=got.data2))
        names.append(cn)
    return RecordBatch(tuple(cols), tuple(names))
