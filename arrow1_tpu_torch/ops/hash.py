"""Vector "hash" kernels (unique, value_counts, dictionary_encode) and the
sort-based grouping behind the eager group_by (counterpart of
arrow1_tpu/ops/hash.py).

Groups come out in first-appearance order, as the reference's MemoTable
assigns ids (vector_hash.cc:44-230): one stable sort of the packed key
words (kernels/radix.py ``pack_operands`` / ``sort_permutation``),
adjacent-difference segment flags, each group's first sorted row as its
representative (stability makes it the first occurrence), and the
representatives sorted by row to recover appearance order.

What the JAX package did to suit its TPU is left behind: payloads are
gathered once each instead of riding a variadic sort, scans are
``torch.cumsum`` and ``ops/padded._segmented_scan``, and an inverse
permutation is one scatter instead of a second sort. Float sums add each
group's own rows, where the JAX package differences a cumsum across
groups (its leak of one group's inf or NaN into the next is not kept).
Segment starts come from the compaction kernel (K2) at every group
count; the reference sorted again above 65536 groups because its TPU's
binary searches serialised.
The group count is the one host sync of a grouping: it sizes the output.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from .. import dtypes as dt
from ..column import Column, Dictionary
from ..errors import Invalid
from ..kernels.compaction import compact
from ..kernels.radix import (minimal_sort_keys, pack_operands,
                             sort_permutation)
from ..registry import register_function
from ..table import RecordBatch
from .common import minmax_domain
from .padded import _segmented_scan, segment_float_sums
from .selection import take_column
from .sort import normalize_sort_key

__all__ = ["DictionaryEncodeOptions", "grouping_key_pairs",
           "grouping_by_keys", "Grouping", "grouping_full", "group_ids_of",
           "segment_sum", "segment_count", "segment_minmax",
           "grouping_from_ids"]

KeyPairs = List[Tuple[torch.Tensor, int]]


@dataclasses.dataclass
class DictionaryEncodeOptions:
    """Reference: api_vector.h:67."""

    null_encoding: str = "mask"  # "mask" | "encode"


def grouping_key_pairs(col: Column) -> KeyPairs:
    """(key, bits) pairs, most significant first, that are equal exactly
    when two rows group together: the minimal sort keys, except that
    float64 keeps -0.0 apart from +0.0 and uint64 travels as its int64
    bits (normalize_sort_key), as the reference groups them."""
    if col.dtype.kind in ("float64", "uint64"):
        keys = normalize_sort_key(col)
        return [(keys[0], 64)] if len(keys) == 1 else \
            [(keys[0], 2), (keys[1], 64)]
    return minimal_sort_keys(col)


def grouping_by_keys(pairs: KeyPairs):
    """Dense group ids over key pairs (``grouping_key_pairs`` of each key
    column, concatenated). Returns (group_ids int32[n] in first-appearance
    order, rep_rows int64[G] the first row of each group, num_groups a
    host int). The eager counterpart of GrouperImpl (hash_aggregate.cc:
    313-404)."""
    group_ids, rep_rows, num_groups = _group_core(pairs, ())[:3]
    return group_ids, rep_rows, num_groups


def _group_core(pairs: KeyPairs, payloads: Sequence[torch.Tensor],
                need_ids: bool = True):
    """Shared grouping pipeline. Returns (group_ids, rep_rows, num_groups,
    order, seg_bounds, first, appearance, rank, sorted_payloads);
    group_ids is None unless ``need_ids``."""
    n = pairs[0][0].shape[0]
    dev = pairs[0][0].device
    words, used = pack_operands(pairs)
    order = sort_permutation(words, used) if n else \
        torch.zeros(0, dtype=torch.int64, device=dev)
    sorted_payloads = [p[order] for p in payloads]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        same = torch.ones(n - 1, dtype=torch.bool, device=dev)
        for w in words:
            ws = w[order]
            same &= ws[1:] == ws[:-1]
        first[1:] = ~same
    gid_sorted = torch.cumsum(first, 0) - 1
    num_groups = int(gid_sorted[-1]) + 1 if n else 0
    iota = torch.arange(n, device=dev)
    (first_pos,), _ = compact(first, [iota], out_limit=num_groups)
    rep_sorted = order[first_pos]
    # first-appearance order: groups sorted by their first row
    appearance = torch.sort(rep_sorted).indices
    rep_rows = rep_sorted[appearance]
    rank = torch.empty_like(appearance)
    rank[appearance] = torch.arange(num_groups, device=dev)
    group_ids = None
    if need_ids:
        group_ids = torch.empty(n, dtype=torch.int32, device=dev)
        group_ids[order] = rank[gid_sorted].to(torch.int32)
    seg_bounds = torch.cat([first_pos, first_pos.new_full((1,), n)])
    return (group_ids, rep_rows, num_groups, order, seg_bounds, first,
            appearance, rank, sorted_payloads)


class Grouping(NamedTuple):
    """Sorted-space grouping for aggregation: every aggregate is a scan
    over the rows in key order read at the segment ends.

      group_ids       int32[n]   appearance id per row (None until
                                 group_ids_of needs it)
      rep_rows        int64[G]   first row of each group, appearance order
      num_groups      int
      order           int64[n]   row indices in sorted-key order
      seg_bounds      int64[G+1] segment boundaries in sorted space
      appearance_rank int64[G]   sorted group -> appearance id
      seg_starts      bool[n]    segment-start flags in sorted space
      appearance      int64[G]   appearance id -> sorted group
    """

    group_ids: Optional[torch.Tensor]
    rep_rows: torch.Tensor
    num_groups: int
    order: torch.Tensor
    seg_bounds: torch.Tensor
    appearance_rank: torch.Tensor
    seg_starts: torch.Tensor
    appearance: torch.Tensor


def grouping_full(pairs: KeyPairs, payloads: Sequence[torch.Tensor] = ()
                  ) -> Tuple[Grouping, List[torch.Tensor]]:
    """The grouping plus its sorted-space segments; ``payloads`` come back
    in sorted-key order, each gathered once."""
    (group_ids, rep_rows, num_groups, order, seg_bounds, first, appearance,
     rank, sorted_payloads) = _group_core(pairs, payloads, need_ids=False)
    return (Grouping(group_ids, rep_rows, num_groups, order, seg_bounds,
                     rank, first, appearance), sorted_payloads)


def group_ids_of(g: Grouping) -> torch.Tensor:
    """Per-row appearance ids, materialized on demand (one G-table gather
    and one scatter)."""
    if g.group_ids is not None:
        return g.group_ids
    gid_sorted = torch.cumsum(g.seg_starts, 0) - 1
    ids = torch.empty(g.order.shape[0], dtype=torch.int32,
                      device=g.order.device)
    ids[g.order] = g.appearance_rank[gid_sorted].to(torch.int32)
    return ids


def segment_sum(x: torch.Tensor, g: Grouping, acc_dtype,
                sorted_: bool = False) -> torch.Tensor:
    """Per-group sum in appearance order. An integer sum is a cumsum in
    sorted space read at the segment ends and differenced (exact mod
    2^64); a float sum adds each segment's own rows (segment_float_sums),
    so no group's magnitude, inf or NaN reaches another. ``sorted_``
    means x is already in ``g.order``."""
    xs = (x if sorted_ else x[g.order]).to(acc_dtype)
    if xs.is_floating_point():
        return segment_float_sums(xs, torch.diff(g.seg_bounds))[
            g.appearance]
    c = torch.cumsum(xs, 0)
    hi = c[g.seg_bounds[1:] - 1]
    starts = g.seg_bounds[:-1]
    lo = torch.where(starts > 0, c[(starts - 1).clamp(min=0)], 0)
    return (hi - lo)[g.appearance]


def segment_count(live: torch.Tensor, g: Grouping,
                  sorted_: bool = False) -> torch.Tensor:
    return segment_sum(live, g, torch.int64, sorted_=sorted_)


def segment_minmax(x: torch.Tensor, g: Grouping, is_min: bool,
                   sorted_: bool = False) -> torch.Tensor:
    """Per-group min/max in appearance order: a flagged scan in sorted
    space read at the segment ends."""
    xs = x if sorted_ else x[g.order]
    if xs.dtype == torch.bool:
        op = torch.logical_and if is_min else torch.logical_or
        back = None
    else:
        op = torch.minimum if is_min else torch.maximum
        xs, back = minmax_domain(xs)
    vals = _segmented_scan(xs, g.seg_starts, op)
    out = vals[g.seg_bounds[1:] - 1][g.appearance]
    return out if back is None else back(out)


def grouping_from_ids(gids: torch.Tensor, num_groups: int) -> Grouping:
    """The sorted-space Grouping of precomputed dense ids, already in
    appearance order (the kernel-level hash_* entry points). An id that no
    row holds is an empty group (the reference maps it to its neighbour's
    segment; a dense id set, the only one its callers make, agrees)."""
    n = gids.shape[0]
    dev = gids.device
    g64 = gids.to(torch.int64)
    order = torch.sort(g64, stable=True).indices
    gs = g64[order]
    first = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        first[1:] = gs[1:] != gs[:-1]
    slots = torch.arange(num_groups, device=dev)
    first_pos = torch.searchsorted(gs, slots)
    seg_bounds = torch.cat([first_pos, first_pos.new_full((1,), n)])
    rep_rows = order[first_pos.clamp(max=max(n - 1, 0))] if n else \
        torch.zeros(num_groups, dtype=torch.int64, device=dev)
    return Grouping(gids.to(torch.int32), rep_rows, num_groups, order,
                    seg_bounds, slots, first, slots)


def _unique_exec(args, options, ctx):
    (col,) = args
    if not isinstance(col, Column):
        raise Invalid("unique expects an array")
    _, rep_rows, _ = grouping_by_keys(grouping_key_pairs(col))
    return take_column(col, rep_rows)


register_function("unique", "vector", 1)(_unique_exec)


def _value_counts_exec(args, options, ctx):
    """A RecordBatch{values, counts} (the reference returns the same data
    as a StructArray)."""
    (col,) = args
    group_ids, rep_rows, num_groups = grouping_by_keys(
        grouping_key_pairs(col))
    counts = torch.zeros(num_groups, dtype=torch.int64, device=col.device)
    counts.index_add_(0, group_ids.to(torch.int64),
                      torch.ones(col.length, dtype=torch.int64,
                                 device=col.device))
    return RecordBatch((take_column(col, rep_rows),
                        Column(counts, dt.int64)), ("values", "counts"))


register_function("value_counts", "vector", 1)(_value_counts_exec)


def _dictionary_encode_exec(args, options: DictionaryEncodeOptions, ctx):
    """A dictionary-typed Column: int32 codes on the device and the value
    pool on the host, in first-appearance order."""
    (col,) = args
    options = options or DictionaryEncodeOptions()
    group_ids, rep_rows, num_groups = grouping_by_keys(
        grouping_key_pairs(col))
    out_type = dt.dictionary(dt.int32, col.dtype)
    if col.validity is not None and options.null_encoding == "mask":
        # nulls form a group: strip it from the pool and null the codes
        rep_valid = col.validity[rep_rows]
        keep = torch.nonzero(rep_valid).squeeze(1)
        code_of_group = torch.zeros(num_groups, dtype=torch.int32,
                                    device=col.device)
        code_of_group[keep] = torch.arange(keep.shape[0], dtype=torch.int32,
                                           device=col.device)
        codes = code_of_group[group_ids.to(torch.int64)]
        values = take_column(col, rep_rows[keep])
        validity = col.validity
    else:
        values = take_column(col, rep_rows)
        codes = group_ids
        validity = None
    return Column(codes, out_type, validity=validity,
                  dictionary=Dictionary(values.to_numpy()))


register_function("dictionary_encode", "vector", 1, DictionaryEncodeOptions)(
    _dictionary_encode_exec)
