"""Sort-key normalization, the stable device argsort, and the eager
``sort_indices`` / ``array_sort_indices`` functions (counterpart of
arrow1_tpu/ops/sort.py without partition_nth and rank).

Every sortable column maps to 1-2 unsigned 64-bit keys (held in int64
tensors), most significant first, whose lexicographic unsigned order is
the row order: sign flip for signed ints, total-order bits for floats,
host rank tables for dictionary strings, and a class key (value 0 < NaN 1
< null 2) when the column can hold NaN or null. Descending inverts the
value key only, so nulls stay last.

The eager sort functions use the minimal-width packed keys of
kernels/radix.py (``minimal_sort_keys``: stable, nulls last, NaN before
null) and return uint64 row indices, as the reference does.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..kernels.radix import (_SIGN, minimal_sort_keys, pack_split,
                             sort_permutation)
from ..registry import register_function
from ..table import RecordBatch

__all__ = ["ArraySortOptions", "SortOptions", "normalize_sort_key",
           "sort_indices_device"]


@dataclasses.dataclass
class ArraySortOptions:
    """Reference: api_vector.h:85."""

    order: str = "ascending"


@dataclasses.dataclass
class SortOptions:
    """Reference: api_vector.h:99 (SortKey list)."""

    sort_keys: Sequence[Tuple[str, str]] = ()


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
    """1-2 unsigned 64-bit keys, most significant first."""
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
    elif t.is_signed_integer:
        key = col.data.to(torch.int64) ^ _SIGN
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


def _radix_perm(cols_orders) -> torch.Tensor:
    """Stable argsort over the minimal-width packed keys of the columns."""
    pairs = []
    for col, order in cols_orders:
        pairs.extend(minimal_sort_keys(col, order))
    words, used, _ = pack_split(pairs)
    return sort_permutation(words, used)


def _as_indices(perm: torch.Tensor) -> Column:
    return Column(perm.to(torch.uint64), dt.uint64)


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
