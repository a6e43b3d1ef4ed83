"""Sort-key normalization, the stable device argsort, and the eager
sort functions: ``sort_indices``, ``array_sort_indices``,
``partition_nth_indices``, ``select_k_unstable``, ``rank``,
``rank_quantile`` and ``rank_normal`` (counterpart of
arrow1_tpu/ops/sort.py).

Every sortable column maps to 1-2 unsigned 64-bit keys (held in int64
tensors), most significant first, whose lexicographic unsigned order is
the row order: sign flip for signed ints, total-order bits for floats,
host rank tables for dictionary strings, and a class key (value 0 < NaN 1
< null 2) when the column can hold NaN or null. Descending inverts the
value key only, so nulls stay last.

The eager sort functions use the minimal-width packed keys of
kernels/radix.py (``minimal_sort_keys``: stable, nulls last, NaN before
null) and return uint64 row indices, as the reference does.
``partition_nth_indices`` and ``select_k_unstable`` return (a prefix of)
the full stable sort permutation, as the reference does, so both are
bit-equal to it. The ranks find runs of equal keys in sorted order and
give each row its run's first and last position through a cumulative
count of run starts and one gather, where the reference runs blocked
max/min scans.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..kernels.radix import (_SIGN, decimal_limb_keys, minimal_sort_keys,
                             pack_operands, pack_split, sort_permutation)
from ..registry import register_function
from ..table import RecordBatch

__all__ = ["ArraySortOptions", "SortOptions", "PartitionNthOptions",
           "RankOptions", "RankQuantileOptions", "SelectKOptions",
           "normalize_sort_key", "sort_indices_device"]


@dataclasses.dataclass
class ArraySortOptions:
    """Reference: api_vector.h:85."""

    order: str = "ascending"


@dataclasses.dataclass
class SortOptions:
    """Reference: api_vector.h:99 (SortKey list)."""

    sort_keys: Sequence[Tuple[str, str]] = ()


@dataclasses.dataclass
class PartitionNthOptions:
    """Reference: api_vector.h:112."""

    pivot: int = 0


@dataclasses.dataclass
class RankOptions:
    """Reference: api_vector.h RankOptions (sort order, null placement,
    tiebreaker in {min, max, first, dense})."""

    sort_keys: object = "ascending"
    null_placement: str = "at_end"
    tiebreaker: str = "first"


@dataclasses.dataclass
class RankQuantileOptions:
    sort_keys: object = "ascending"
    null_placement: str = "at_end"


@dataclasses.dataclass
class SelectKOptions:
    k: int = 0
    sort_keys: tuple = ()


def _float_orderable_bits(x: torch.Tensor) -> torch.Tensor:
    """IEEE-754 -> total-order 64-bit key (ascending); 32-bit and smaller
    floats land in the high half, as in the JAX package."""
    if x.dtype == torch.float64:
        bits = x.view(torch.int64)
        return torch.where(bits < 0, ~bits, bits ^ _SIGN)
    bits = x.to(torch.float32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    flipped = torch.where(bits >= (1 << 31), bits ^ 0xFFFFFFFF,
                          bits | (1 << 31))
    return flipped << 32


def normalize_sort_key(col: Column, order: str = "ascending"
                       ) -> List[torch.Tensor]:
    """1-2 unsigned 64-bit keys, most significant first (a decimal: one a
    limb, after its null class)."""
    t = col.dtype
    has_nan = False
    if t.is_binary:
        if len(col.dictionary):
            rank = torch.from_numpy(col.dictionary.rank.astype(np.int64))
            key = rank.to(col.device)[
                col.data.long().clamp(0, len(col.dictionary) - 1)]
        else:
            key = torch.zeros_like(col.data, dtype=torch.int64)
    elif t.is_floating:
        key = _float_orderable_bits(col.data)
        has_nan = True
    elif t.is_unsigned_integer or t.is_boolean:
        key = col.data.to(torch.int64)
    elif t.is_signed_integer or t.is_temporal:   # signed storage
        key = col.data.to(torch.int64) ^ _SIGN
    elif t.is_decimal:   # one key a limb, most significant first
        keys = decimal_limb_keys(col)
        if order == "descending":
            keys = [~k for k in keys]
        if col.validity is None:
            return keys
        return [torch.where(col.validity, 0, 2).to(torch.int64)] + \
            [torch.where(col.validity, k, 0) for k in keys]
    else:
        raise Invalid(f"sort: unsupported type {t}")
    if order == "descending":
        key = ~key
    elif order != "ascending":
        raise Invalid(f"bad sort order {order!r}")
    if not (has_nan or col.validity is not None):
        return [key]
    cls = torch.zeros_like(key)
    if has_nan:
        nan = torch.isnan(col.data)
        cls = torch.where(nan, 1, cls)
        key = torch.where(nan, 0, key)   # all NaN equal (stable ties)
    if col.validity is not None:
        cls = torch.where(col.validity, cls, 2)
        key = torch.where(col.validity, key, 0)
    return [cls, key]


def sort_indices_device(keys: List[torch.Tensor]) -> torch.Tensor:
    """Stable lexicographic argsort over normalized keys (most significant
    first), by LSD composition of stable argsorts."""
    if not keys:
        raise Invalid("sort_indices_device: no keys")
    return sort_permutation(keys)


def _radix_perm(cols_orders, null_placement: str = "at_end"
                ) -> torch.Tensor:
    """Stable argsort over the minimal-width packed keys of the columns."""
    pairs = []
    for col, order in cols_orders:
        pairs.extend(minimal_sort_keys(col, order, null_placement))
    words, used, _ = pack_split(pairs)
    return sort_permutation(words, used)


def _as_indices(perm: torch.Tensor) -> Column:
    return Column(perm.view(torch.uint64), dt.uint64)   # perm >= 0


def _array_sort_indices_exec(args, options: ArraySortOptions, ctx):
    (col,) = args
    if not isinstance(col, Column):
        raise Invalid("array_sort_indices expects an array")
    options = options or ArraySortOptions()
    return _as_indices(_radix_perm([(col, options.order)]))


register_function("array_sort_indices", "vector", 1, ArraySortOptions)(
    _array_sort_indices_exec)


def _sort_indices_exec(args, options: SortOptions, ctx):
    (values,) = args
    if isinstance(values, Column):
        order = "ascending"
        if options and options.sort_keys:
            order = options.sort_keys[0][1]
        return _array_sort_indices_exec([values], ArraySortOptions(order),
                                        ctx)
    if not isinstance(values, RecordBatch):
        raise Invalid("sort_indices expects an array or a record batch")
    if not options or not options.sort_keys:
        raise Invalid("sort_indices: sort_keys required for record batches")
    return _as_indices(_radix_perm([(values.column(name), order)
                                    for name, order in options.sort_keys]))


register_function("sort_indices", "vector", 1, SortOptions)(
    _sort_indices_exec)


def _partition_nth_exec(args, options: PartitionNthOptions, ctx):
    """partition_nth_indices: the positions before the pivot hold the
    pivot-smallest rows (reference: vector_sort.cc:322). The full stable
    sort permutation meets that, as in the reference."""
    (col,) = args
    if options is None:
        raise Invalid("partition_nth_indices requires options.pivot")
    return _as_indices(_radix_perm([(col, "ascending")]))


register_function("partition_nth_indices", "vector", 1, PartitionNthOptions)(
    _partition_nth_exec)


def _rank_order(sort_keys) -> str:
    """RankOptions.sort_keys is an order string or a list of (name, order)
    sort keys; arrays use the first key's order."""
    if isinstance(sort_keys, str):
        return sort_keys
    if sort_keys:
        first = sort_keys[0]
        return first[1] if isinstance(first, (tuple, list)) else \
            getattr(first, "order", "ascending")
    return "ascending"


def _sorted_runs(col, order, null_placement):
    """(perm, first, run_start, run_end): the stable sort permutation, and
    in sorted order whether a row starts a run of equal keys, and the
    first and last position of its run. Nulls and NaN form runs of their
    own (vector_rank.cc). A row's run is the count of run starts up to it;
    the starts' positions (one host sync sizes them) give both ends."""
    pairs = minimal_sort_keys(col, order, null_placement)
    words, used, _ = pack_split(pairs)
    perm = sort_permutation(words, used)
    n = col.length
    dev = col.device
    first = torch.ones(n, dtype=torch.bool, device=dev)
    if n > 1:
        same = torch.ones(n - 1, dtype=torch.bool, device=dev)
        for k in pack_operands(pairs)[0]:
            ks = k[perm]
            same = same & (ks[1:] == ks[:-1])
        first[1:] = ~same
    starts = torch.nonzero(first).reshape(-1)
    run = torch.cumsum(first.to(torch.int64), 0) - 1
    ends = torch.cat([starts[1:], starts.new_full((1,), n)]) - 1
    return perm, first, starts[run], ends[run]


def _inverse(perm: torch.Tensor) -> torch.Tensor:
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(perm.shape[0], dtype=perm.dtype,
                             device=perm.device)
    return inv


def _rank_exec(args, options: RankOptions, ctx):
    """rank: 1-based uint64 ranks, ties broken by min, max, first or dense
    (reference: vector_rank.cc)."""
    (col,) = args
    options = options or RankOptions()
    order = _rank_order(options.sort_keys)
    tb = options.tiebreaker
    if tb == "first":
        perm = _radix_perm([(col, order)], options.null_placement)
        ranks = _inverse(perm) + 1
        return Column(ranks.view(torch.uint64), dt.uint64)
    perm, first, run_start, run_end = _sorted_runs(
        col, order, options.null_placement)
    if tb == "min":
        sorted_rank = run_start + 1
    elif tb == "max":
        sorted_rank = run_end + 1   # run_end is the run's last position
    elif tb == "dense":
        sorted_rank = torch.cumsum(first.to(torch.int64), 0)
    else:
        raise Invalid(f"rank: unknown tiebreaker {tb!r}")
    return Column(sorted_rank[_inverse(perm)].view(torch.uint64), dt.uint64)


register_function("rank", "vector", 1, RankOptions)(_rank_exec)


def _quantile_rank(col, options: RankQuantileOptions) -> torch.Tensor:
    """(2 * average rank - 1) / (2 n), ties averaged (reference:
    vector_rank.cc RankQuantile), in float64."""
    options = options or RankQuantileOptions()
    perm, _, run_start, run_end = _sorted_runs(
        col, _rank_order(options.sort_keys), options.null_placement)
    avg = (run_start.to(torch.float64) + run_end.to(torch.float64)) / 2.0 \
        + 1.0
    avg = avg[_inverse(perm)]
    # a tensor divisor: CUDA divides by a Python number as a product with
    # its reciprocal, which rounds differently from the CPU's division
    n2 = torch.full_like(avg, 2.0 * max(col.length, 1))
    return (2.0 * avg - 1.0) / n2


def _rank_quantile_exec(args, options: RankQuantileOptions, ctx):
    (col,) = args
    return Column(_quantile_rank(col, options), dt.float64)


register_function("rank_quantile", "vector", 1, RankQuantileOptions)(
    _rank_quantile_exec)


def _rank_normal_exec(args, options: RankQuantileOptions, ctx):
    """rank_normal: the inverse normal CDF of the quantile rank."""
    (col,) = args
    return Column(torch.special.ndtri(_quantile_rank(col, options)),
                  dt.float64)


register_function("rank_normal", "vector", 1, RankQuantileOptions)(
    _rank_normal_exec)


def _select_k_exec(args, options: SelectKOptions, ctx):
    """select_k_unstable: the first k rows of the stable sort order
    (reference: vector_select_k.cc; the reference takes a full sort too)."""
    (col,) = args
    if options is None or not options.sort_keys:
        raise Invalid("select_k_unstable requires sort_keys")
    perm = _radix_perm([(col, options.sort_keys[0][1])])
    k = max(0, min(int(options.k), col.length))
    return _as_indices(perm[:k])


register_function("select_k_unstable", "vector", 1, SelectKOptions)(
    _select_k_exec)
