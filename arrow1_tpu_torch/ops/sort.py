"""Sort-key normalization and the stable device argsort (counterpart of the
parts of arrow1_tpu/ops/sort.py that the compiled pipeline uses).

Every sortable column maps to 1-2 unsigned 64-bit keys (held in int64
tensors), most significant first, whose lexicographic unsigned order is
the row order: sign flip for signed ints, total-order bits for floats,
host rank tables for dictionary strings, and a class key (value 0 < NaN 1
< null 2) when the column can hold NaN or null. Descending inverts the
value key only, so nulls stay last.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..column import Column
from ..errors import Invalid
from ..kernels.radix import _SIGN, sort_permutation

__all__ = ["normalize_sort_key", "sort_indices_device"]


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
