"""Shared kernel infrastructure: promotion, broadcasting and null
propagation (counterpart of arrow1_tpu/ops/common.py)."""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from .. import dtypes as dt
from ..column import Column
from ..datum import Scalar
from ..dtypes import as_int64, from_int64
from ..errors import Invalid
from ..kernels.radix import _SIGN

__all__ = ["collapse_validity", "promote_numeric", "common_type", "unpack",
           "intersect_validity", "result_column", "value_of",
           "broadcast_length", "column_device", "as_int64", "from_int64",
           "minmax_domain"]

_FLOAT_ORDER = {"float16": 0, "float32": 1, "float64": 2}
_INT_BITS = {"int8": 8, "int16": 16, "int32": 32, "int64": 64,
             "uint8": 8, "uint16": 16, "uint32": 32, "uint64": 64}


def promote_numeric(types: Sequence[dt.DataType]) -> dt.DataType:
    """Arrow-style common numeric type (DispatchBest / CommonNumeric).
    Null-typed operands (untyped null scalars) take the others' type."""
    types = [t for t in types if not t.is_null] or [dt.null]
    if types == [dt.null]:
        return dt.null
    if any(not t.is_numeric and not t.is_boolean for t in types):
        raise Invalid(f"non-numeric types in promotion: {list(types)}")
    ts = [t for t in types if not t.is_boolean]
    if not ts:
        return dt.bool_
    floats = [t for t in ts if t.is_floating]
    if floats:
        best = max(_FLOAT_ORDER[t.kind] for t in floats)
        return (dt.float16, dt.float32, dt.float64)[best]
    signed = [_INT_BITS[t.kind] for t in ts if t.is_signed_integer]
    unsigned = [_INT_BITS[t.kind] for t in ts if t.is_unsigned_integer]
    if not unsigned:
        return dt.DataType(f"int{max(signed)}")
    if not signed:
        return dt.DataType(f"uint{max(unsigned)}")
    # mixed: a signed type that holds the unsigned range
    return dt.DataType(f"int{max(max(signed), min(2 * max(unsigned), 64))}")


def common_type(args: Sequence) -> dt.DataType:
    return promote_numeric([a.dtype for a in args])


def broadcast_length(args: Sequence) -> Optional[int]:
    """Common column length, or None when every argument is a scalar."""
    n = None
    for a in args:
        if isinstance(a, Column):
            if n is not None and a.length != n:
                raise Invalid(f"length mismatch: {a.length} vs {n}")
            n = a.length
    return n


def column_device(args: Sequence) -> torch.device:
    """Device of the first Column argument (the CPU in all-scalar mode)."""
    for a in args:
        if isinstance(a, Column):
            return a.device
    return torch.device("cpu")


def value_of(a, target: Optional[dt.DataType] = None) -> torch.Tensor:
    """The tensor behind a Column, or a Scalar as a 0-d CPU tensor (torch
    passes 0-d CPU tensors into CUDA kernels as arguments, with no copy),
    cast to the target's physical type."""
    phys = (target or a.dtype).physical_dtype()
    if isinstance(a, Column):
        v = a.data
    elif isinstance(a.value, torch.Tensor):
        v = a.value
    else:
        v = torch.tensor(a.value, dtype=phys)
    return v if v.dtype == phys else v.to(phys)


def unpack(args: Sequence, target: Optional[dt.DataType] = None):
    """(values, validities, length). A null scalar is ``False`` in the
    validities and nulls the whole output."""
    n = broadcast_length(args)
    values = [value_of(a, target) for a in args]
    validities = [a.validity if isinstance(a, Column)
                  else (None if a.is_valid else False) for a in args]
    return values, validities, n


def intersect_validity(validities: List):
    """AND of the input masks (NullHandling::INTERSECTION). Entries: None
    (all valid), False (a null scalar) or a bool tensor. A null scalar
    gives False, which ``result_column`` turns into an all-null mask."""
    if any(v is False for v in validities):
        return False
    masks = [v for v in validities if v is not None]
    if not masks:
        return None
    out = masks[0]
    for m in masks[1:]:
        out = out & m
    return out


def result_column(data, out_type: dt.DataType, validity, n: Optional[int],
                  dictionary=None):
    """Column in array mode, Scalar when every input was a scalar."""
    if n is None:
        return Scalar(data, out_type, is_valid=validity is not False,
                      dictionary=dictionary)
    if validity is False:
        validity = torch.zeros(n, dtype=torch.bool, device=data.device)
    return Column(data, out_type, validity=validity, dictionary=dictionary)


def minmax_domain(x: torch.Tensor):
    """(y, back): y orders like x under torch's min/max and compares,
    back(y') restores x's dtype. torch on the CPU has no compare, min or
    max for uint16/32/64, so those go through int64 (uint64 with its sign
    bit flipped)."""
    if x.dtype == torch.uint64:
        return (x.view(torch.int64) ^ _SIGN,
                lambda y: (y ^ _SIGN).view(torch.uint64))
    if x.dtype in (torch.uint16, torch.uint32):
        return as_int64(x), lambda y, d=x.dtype: from_int64(y, d)
    return x, lambda y: y


def collapse_validity(mask):
    """Validity of a freshly computed mask, kept on the device: collapsing
    an all-True mask to None would need a host sync."""
    return mask
