"""Set lookup: is_in and index_in, and their two-argument forms
(counterpart of arrow1_tpu/ops/set_lookup.py).

Reference: cpp/src/arrow/compute/kernels/scalar_set_lookup.cc. The value
set is small and known on the host, so, as in the reference, it becomes
a sorted tensor of member keys that each row finds with one binary
search (``torch.searchsorted``); no hash table. A dictionary-string
column searches its codes, a temporal column its storage integers (a
member given as a Python date, datetime or timedelta, or a pyarrow
temporal value, converts through pyarrow to the column's storage). Keys
are int64: uint64 with its sign bit flipped, so that signed order is
unsigned order; floats as total-order bits, so that 0.0 and -0.0 are
different members as in pyarrow (the reference finds them equal:
ROADMAP Queue 3). A NaN member matches every NaN value.
SetLookupOptions (api_scalar.h:94): skip_nulls=False lets a null value
match a null member.
"""

from __future__ import annotations

import dataclasses
import decimal
from typing import Any

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column
from ..datum import Scalar
from ..errors import Invalid
from ..kernels.radix import _SIGN
from ..registry import register_function
from .common import as_int64

__all__ = ["SetLookupOptions"]


@dataclasses.dataclass
class SetLookupOptions:
    """Reference: api_scalar.h:94."""

    value_set: Any = None
    skip_nulls: bool = False


def _value_set_list(value_set) -> list:
    """A list, numpy array, pyarrow array or port Column as a list."""
    if hasattr(value_set, "to_pylist"):
        return value_set.to_pylist()
    return list(value_set)


def _keys(x: torch.Tensor) -> torch.Tensor:
    """int64 search keys whose signed order is the values' order (and
    whose equality is bit equality for floats)."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64) ^ _SIGN
    if x.is_floating_point():
        bits = x.to(torch.float64).view(torch.int64)
        return torch.where(bits < 0, ~bits ^ _SIGN, bits)
    return as_int64(x)


def _members(col: Column, value_set):
    """(row keys, sorted member keys, their positions in the value set,
    whether the set holds a null, the position of its first NaN or -1)."""
    vals = _value_set_list(value_set)
    has_null = any(v is None for v in vals)
    nan_pos = -1
    if col.dtype.is_floating:
        for i, v in enumerate(vals):
            if isinstance(v, float) and v != v:
                nan_pos = i
                break
        vals = [None if isinstance(v, float) and v != v else v
                for v in vals]
    positions = [i for i, v in enumerate(vals) if v is not None]
    nonnull = [v for v in vals if v is not None]
    dev = col.device
    if col.dtype.is_binary:
        index = col.dictionary.index if col.dictionary is not None else {}
        member = torch.tensor([index.get(v, -1 - i)
                               for i, v in enumerate(nonnull)],
                              dtype=torch.int64)
        x = col.data.to(torch.int64)
    elif col.dtype.is_temporal:
        member = torch.tensor([_temporal_storage(v, col.dtype)
                               for v in nonnull], dtype=torch.int64)
        x = col.data.to(torch.int64)
    else:
        member = _keys(torch.from_numpy(np.asarray(
            nonnull, dtype=col.dtype.numpy_dtype())))
        x = _keys(col.data)
    order = torch.sort(member, stable=True).indices
    pos = torch.tensor(positions, dtype=torch.int32)[order]
    return x, member[order].to(dev), pos.to(dev), has_null, nan_pos


def _temporal_storage(v, t: dt.DataType) -> int:
    """A value-set member as the storage integer of temporal type ``t``:
    an integer as it is, anything else through pyarrow."""
    if isinstance(v, (int, np.integer)):
        return int(v)
    import pyarrow as pa

    storage = pa.int32() if t.numpy_dtype().itemsize == 4 else pa.int64()
    return pa.array([v], type=dt.to_arrow(t)).view(storage)[0].as_py()


def _lookup_decimal(col: Column, options: SetLookupOptions):
    """A decimal column against each distinct member of the (host) value
    set, every limb compared; a member finer than the column's scale
    matches nothing (reference ``_lookup_decimal``)."""
    from .decimal import column_limbs
    from .decimal256 import const_limbs

    vals = _value_set_list(options.value_set)
    found = torch.zeros(col.length, dtype=torch.bool, device=col.device)
    set_index = torch.zeros(col.length, dtype=torch.int32,
                            device=col.device)
    limbs = column_limbs(col)
    ctx = decimal.Context(prec=100)
    seen = set()
    for i, v in enumerate(vals):
        if v is None or v in seen:
            continue
        seen.add(v)
        u = decimal.Decimal(v).scaleb(col.dtype.scale, ctx)
        if u != u.to_integral_value(context=ctx):
            continue
        eq = found.new_ones(())
        for x, w in zip(limbs, const_limbs(int(u), len(limbs))):
            eq = eq & (x == w)
        set_index = torch.where(eq & ~found, i, set_index)
        found = found | eq
    return found, set_index, any(v is None for v in vals)


def _lookup(col: Column, options: SetLookupOptions):
    """(found, position in the value set) per row."""
    if col.dtype.is_decimal:
        return _lookup_decimal(col, options)
    x, members, pos, has_null, nan_pos = _members(col, options.value_set)
    if members.shape[0]:
        loc = torch.searchsorted(members, x).clamp(max=members.shape[0] - 1)
        found = members[loc] == x
        set_index = pos[loc]
    else:
        found = torch.zeros(col.length, dtype=torch.bool, device=col.device)
        set_index = torch.zeros(col.length, dtype=torch.int32,
                                device=col.device)
    if nan_pos >= 0:
        isnan = torch.isnan(col.data)
        found = found | isnan
        set_index = torch.where(isnan, nan_pos, set_index)
    return found, set_index, has_null


def _first_null_index(value_set) -> int:
    for i, v in enumerate(_value_set_list(value_set)):
        if v is None:
            return i
    return -1


def _is_in_exec(args, options: SetLookupOptions, ctx):
    (col,) = args
    if options is None or options.value_set is None:
        raise Invalid("is_in requires value_set")
    if isinstance(col, Scalar):
        raise Invalid("is_in expects an array")
    found, _, has_null = _lookup(col, options)
    if col.validity is not None:
        if options.skip_nulls or not has_null:
            found = found & col.validity
        else:
            found = torch.where(col.validity, found, True)
    return Column(found, dt.bool_)


register_function("is_in", "scalar", 1, SetLookupOptions)(_is_in_exec)


def _index_in_exec(args, options: SetLookupOptions, ctx):
    (col,) = args
    if options is None or options.value_set is None:
        raise Invalid("index_in requires value_set")
    if isinstance(col, Scalar):
        raise Invalid("index_in expects an array")
    found, out, has_null = _lookup(col, options)
    validity = found
    if col.validity is not None:
        if options.skip_nulls or not has_null:
            validity = validity & col.validity
        else:
            out = torch.where(col.validity, out,
                              _first_null_index(options.value_set))
            validity = torch.where(col.validity, validity, True)
    return Column(torch.where(validity, out, 0).to(torch.int32), dt.int32,
                  validity=validity)


register_function("index_in", "scalar", 1, SetLookupOptions)(_index_in_exec)


def _meta_binary(inner):
    """The value set as the second argument instead of an option
    (reference: scalar_set_lookup.cc IsInMetaBinary/IndexInMetaBinary);
    nulls match a null member (skip_nulls=False)."""

    def exec_fn(args, options, ctx):
        col, value_set = args
        return inner([col], SetLookupOptions(value_set=value_set,
                                             skip_nulls=False), ctx)

    return exec_fn


register_function("is_in_meta_binary", "scalar", 2)(_meta_binary(_is_in_exec))
register_function("index_in_meta_binary", "scalar", 2)(
    _meta_binary(_index_in_exec))
