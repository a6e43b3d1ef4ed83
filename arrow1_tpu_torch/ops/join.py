"""Equi-join (inner, left/right/full outer, left/right semi and anti) and
the as-of join (counterpart of arrow1_tpu/ops/join.py).

Semantics follow SQL and pyarrow ``Table.join``: null keys match
nothing; every probe-side match pair is emitted; outer variants emit
unmatched rows with nulls on the other side. Row order is deterministic:
probe (left) order, and each probe's matches in build (right) order.

1. The right (build) side is built once (``BuiltJoin``): its key
   columns become canonical planes (a string its code in the build's
   pool, a float its class and total-order bits, a decimal its limbs at
   the two sides' common type, any other key its normalized bits). One
   plane is the key of the bucketed hash table (kernels/hashtable.py: one
   build-side sort, a gather probe); several collapse to the id of the
   build's distinct key row, which a probe row finds through one merged
   sort (``ops/padded.probe_ranges_sortmerge``) against the distinct
   rows. In a join, -0.0 and +0.0 are different keys and all NaNs are one
   key. The query layer probes one build with every batch of a Table;
   ``join`` probes it with one batch.
2. The total match count is read on the host (it sizes the result, as
   filter does), then the matches expand: each probe row repeated by its
   count (``repeat_interleave``), each copy picking the next build row of
   its range. A build row's matched flag is the OR of the probe rows'
   ranges over the build order; the build side's own rows (right semi
   and anti, the unmatched rows of full outer) come after the probe's.

The dispatch is the reference's ``auto`` mode; its environment switches
(``A1T_JOIN``, ``A1T_JOIN_PROBE_CHUNK``) are not carried over, and the
probe chunk is ``kernels/hashtable.PROBE_CHUNK``. Joins run on the
batches' device.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..column import Column
from ..errors import Invalid
from ..kernels.hashtable import (MAX_BITS, join_build, join_probe,
                                 table_bits_for)
from ..kernels.radix import _SIGN, decimal_limb_keys, sort_permutation
from ..table import RecordBatch, concat_batches
from .common import collapse_validity
from .decimal import common_decimal_type, decimal_cast
from .dictionary import _remap, unify_pair
from .hash import grouping_by_keys
from .padded import last_marked, probe_ranges_sortmerge
from .selection import gather_batch
from .sort import normalize_sort_key

__all__ = ["join", "join_asof", "key_planes", "key_validity",
           "BuiltJoin"]

_JOIN_TYPES = ("inner", "left outer", "right outer", "full outer",
               "left semi", "left anti", "right semi", "right anti")


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
             left_keys: Sequence[str], right_keys: Sequence[str]):
    """Dense int32 ids of both sides' join keys, from grouping the union
    of their key planes (equal keys, equal ids), and each side's key
    validity: (lids, rids, lvalid, rvalid)."""
    if len(left_keys) != len(right_keys):
        raise Invalid("join: key count mismatch")
    pairs = []   # (plane over both sides, bits) for grouping_by_keys
    for lk, rk in zip(left_keys, right_keys):
        lkeys, rkeys = key_planes(left.column(lk), right.column(rk))
        for i, (lp, rp) in enumerate(zip(lkeys, rkeys)):
            # a class plane holds 0 (value), 1 (NaN) or 2 (null)
            bits = 2 if len(lkeys) == 2 and i == 0 else 64
            pairs.append((torch.cat([lp, rp]), bits))
    n = left.num_rows
    gids, _, _ = grouping_by_keys(pairs)
    return (gids[:n], gids[n:], key_validity(left, left_keys),
            key_validity(right, right_keys))


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


def _nonzero(mask: torch.Tensor) -> torch.Tensor:
    return torch.nonzero(mask).squeeze(1)


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
    joiner = BuiltJoin(right, keys, right_keys, join_type, left_suffix,
                       right_suffix)
    parts = [b for b in (joiner.probe(left), joiner.finish())
             if b is not None]
    return parts[0] if len(parts) == 1 else concat_batches(parts)


class BuiltJoin:
    """A join whose right (build) side is built once, then probed batch
    by batch: the query layer's join over a Table of batches.

    The build keys become canonical planes that no probe batch changes (a
    string key its code in the build's pool, a probe value missing there
    -1; a float key its class and total-order bits; a decimal key its
    limbs at the two sides' common type; any other key its normalized
    bits). One plane is the hash key; several collapse to the id of the
    build's distinct key row, which a probe row finds through one merged
    sort of its batch against the distinct rows. The hash table is built
    once, at the first probe.

    ``probe(batch)`` returns the batch's rows of the result (None for the
    right semi and anti joins): for inner, left outer and the left semi
    and anti joins the rows ``join`` gives for that batch; for right and
    full outer the batch's matches (and, for full outer, its unmatched
    probe rows). Each build row's matched flag is kept across the
    batches, and ``finish()`` returns the build side's rows once: matched
    (right semi), unmatched (right anti), or unmatched with null probe
    columns (right and full outer); None for the other types."""

    _RIGHT = ("right outer", "full outer", "right semi", "right anti")

    def __init__(self, right: RecordBatch, keys, right_keys=None,
                 join_type: str = "inner", left_suffix: str = "",
                 right_suffix: str = ""):
        if join_type not in _JOIN_TYPES:
            raise Invalid(f"unsupported join type {join_type!r}")
        self.right = right
        self.keys = [keys] if isinstance(keys, str) else list(keys)
        self.right_keys = list(right_keys or self.keys)
        if len(self.keys) != len(self.right_keys):
            raise Invalid("join: key count mismatch")
        self.join_type = join_type
        self.suffixes = (left_suffix, right_suffix)
        self.rvalid = key_validity(right, self.right_keys)
        self.matched = None   # bool[m], build rows matched so far
        self._built = None    # (canonical key kinds, order, table, uniq)
        self._template = None  # zero rows of the probe side

    # -- canonical key planes --
    def _planes(self, lc: Column, rc: Column, probe: bool):
        """One key pair's canonical planes on the probe (``probe``) or the
        build side."""
        if lc.dtype.is_binary != rc.dtype.is_binary:
            raise Invalid(f"join: key type mismatch {lc.dtype} vs "
                          f"{rc.dtype}")
        if lc.dtype.is_binary:
            index = rc.dictionary.index
            pool = (lc if probe else rc).dictionary.values.tolist()
            remap = np.array([index.get(v, -1) for v in pool],
                             dtype=np.int64)
            return [_remap(lc if probe else rc, remap).to(torch.int64)]
        col = lc if probe else rc
        if lc.dtype.is_decimal:
            t = common_decimal_type([lc.dtype, rc.dtype])
            if col.dtype != t:
                col = decimal_cast(col, t, allow_truncate=False,
                                   check_range=False)
            return decimal_limb_keys(col)
        planes = normalize_sort_key(col)
        return planes if col.dtype.is_floating else planes[-1:]

    def _side_planes(self, batch: RecordBatch, probe: bool):
        out = []
        for lk, rk in zip(self.keys, self.right_keys):
            out += self._planes(batch.column(lk), self.right.column(rk),
                                probe)
        return out

    def _build(self, left: RecordBatch):
        planes = self._side_planes(left, probe=False)
        m = self.right.num_rows
        uniq = None
        if len(planes) == 1:
            key = planes[0]
        elif m:
            uniq, key = torch.unique(torch.stack(planes, 1), dim=0,
                                     return_inverse=True)
        else:
            key = planes[0]
        order, table = _build_table(key, self.rvalid) if m else (None, None)
        self._built = (order, table, uniq)
        self.matched = torch.zeros(m, dtype=torch.bool,
                                   device=key.device)

    def _ranges(self, left: RecordBatch):
        """(lo int64, counts int32) of each probe row in the build order."""
        order, table, uniq = self._built
        n = left.num_rows
        dev = self.matched.device
        if table is None or n == 0:
            zeros = torch.zeros(n, dtype=torch.int64, device=dev)
            return zeros, zeros.to(torch.int32)
        planes = self._side_planes(left, probe=True)
        if uniq is None:
            key = planes[0]
        else:   # the id of the probe's row among the distinct build rows
            uorder, ulo, ucounts = probe_ranges_sortmerge(
                planes, list(uniq.unbind(1)))
            key = torch.where(ucounts > 0,
                              uorder[ulo.clamp(max=uniq.shape[0] - 1)], -1)
        lo, counts = join_probe(table, key)
        lvalid = key_validity(left, self.keys)
        if lvalid is not None:
            counts = torch.where(lvalid, counts, 0)
        return lo.to(torch.int64), counts

    def _mark(self, lo, counts):
        """OR each probe row's build range into ``matched``: +1 at its
        start, -1 past its end, a cumsum over the build order."""
        order = self._built[0]
        m = self.matched.shape[0]
        hit = counts > 0
        one = torch.ones_like(lo)
        d = torch.zeros(m + 1, dtype=torch.int64, device=lo.device)
        d.scatter_add_(0, torch.where(hit, lo, m), one)
        d.scatter_add_(0, torch.where(hit, lo + counts, m), -one)
        covered = torch.cumsum(d[:m], 0) > 0
        self.matched[order] |= covered

    def probe(self, left: RecordBatch):
        if self._built is None:
            self._build(left)
        if self._template is None:
            self._template = left.slice(0, 0)
        jt = self.join_type
        lo, counts = self._ranges(left)
        if jt in self._RIGHT and self._built[0] is not None:
            self._mark(lo, counts)
        matched = counts > 0
        if jt in ("left semi", "left anti"):
            return gather_batch(left, _nonzero(
                matched if jt == "left semi" else ~matched))
        if jt in ("right semi", "right anti"):
            return None
        outer_left = jt in ("left outer", "full outer")
        emit = (counts.clamp(min=1) if outer_left else counts).to(
            torch.int64)
        total = int(emit.sum())   # the host sync that sizes the result
        dev = emit.device
        li = torch.repeat_interleave(torch.arange(left.num_rows, device=dev),
                                     emit, output_size=total)
        within = torch.arange(total, device=dev) - \
            (torch.cumsum(emit, 0) - emit)[li]
        pos = lo[li] + torch.minimum(
            within, (counts[li].to(torch.int64) - 1).clamp(min=0))
        order = self._built[0]
        ri = order[pos.clamp(0, self.right.num_rows - 1)] \
            if order is not None else torch.zeros_like(li)
        return self._assemble(left, li, ri, None,
                              matched[li] if outer_left else None)

    def finish(self):
        """The build side's rows, once, after the last probe batch."""
        jt = self.join_type
        if jt not in self._RIGHT or self._template is None:
            return None
        keep = self.matched & self.rvalid if self.rvalid is not None \
            else self.matched
        if jt == "right semi":
            return gather_batch(self.right, _nonzero(keep))
        rows = _nonzero(~keep)
        if jt == "right anti":
            return gather_batch(self.right, rows)
        nulls = torch.zeros(rows.shape[0], dtype=torch.bool,
                            device=rows.device)
        return self._assemble(self._template, torch.zeros_like(rows), rows,
                              nulls, None)

    def _assemble(self, left, li, ri, lv, rv) -> RecordBatch:
        """The result's columns: the keys (the build's for right outer,
        coalesced for full outer), the probe's other columns, then the
        build's, with the suffixes."""
        jt = self.join_type
        ls, rs = self.suffixes
        names: List[str] = []
        cols: List[Column] = []
        for lk, rk in zip(self.keys, self.right_keys):
            if jt == "right outer":
                kcol = _take(self.right.column(rk), ri, None)
            else:
                kcol = _take(left.column(lk), li, lv)
                if jt == "full outer":
                    kcol = _coalesce(kcol, _take(self.right.column(rk), ri,
                                                 rv))
            names.append(lk)
            cols.append(kcol)
        for batch, skip, idx, validity, suffix in (
                (left, set(self.keys), li, lv, ls),
                (self.right, set(self.right_keys), ri, rv, rs)):
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
        lids, rids, _, _ = _key_ids(left, right, by, by)
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
