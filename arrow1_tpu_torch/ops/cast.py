"""Numeric casts (counterpart of arrow1_tpu/ops/cast.py, its numeric part).

Covered: int, uint, float and bool between each other, and an explicit
dictionary column to its values. ``CastOptions`` keeps the reference's
safety toggles (cast.h:44): a safe cast raises on integer overflow, on a
float to integer cast that would drop a fraction, and on NaN or inf into
an integer, each from a device flag reduced on the host (one sync), as
the checked arithmetic does. Casts from or to strings, temporal and
decimal types are later slices of the port and raise
``NotImplementedError_``.

uint16, uint32 and uint64 move through int64 (``dtypes.as_int64``): torch
converts and compares little in them. An unsafe float to integer cast of
a value out of the target's range saturates and NaN gives 0, as XLA's
conversion does for the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column
from ..datum import as_datum
from ..errors import Invalid, NotImplementedError_
from ..kernels.radix import _SIGN
from ..registry import register_function
from .arithmetic import _raise_if
from .common import as_int64, from_int64, result_column, unpack

__all__ = ["CastOptions", "cast", "convert", "int_range"]

_LATER = ("casts from or to strings, temporal and decimal types are not "
          "ported yet (ROADMAP Queue 1 items 6-8)")


@dataclasses.dataclass
class CastOptions:
    """Reference: cast.h:44."""

    target_type: Optional[dt.DataType] = None
    allow_int_overflow: bool = False
    allow_time_truncate: bool = False
    allow_time_overflow: bool = False
    allow_decimal_truncate: bool = False
    allow_float_truncate: bool = False
    allow_invalid_utf8: bool = False

    @classmethod
    def safe(cls, target_type=None):
        return cls(target_type=target_type)

    @classmethod
    def unsafe(cls, target_type=None):
        return cls(target_type=target_type, allow_int_overflow=True,
                   allow_time_truncate=True, allow_time_overflow=True,
                   allow_decimal_truncate=True, allow_float_truncate=True,
                   allow_invalid_utf8=True)


def int_range(t: dt.DataType):
    """(least, greatest) value of an integer type."""
    info = np.iinfo(t.numpy_dtype())
    return int(info.min), int(info.max)


def _wrap_int64(x64: torch.Tensor, dst: torch.dtype) -> torch.Tensor:
    """int64 values (uint64: bit patterns) to an integer dtype, wrapping
    modulo its width as C's conversions do."""
    if dst == torch.uint64:
        return x64.view(torch.uint64)
    if dst in (torch.uint16, torch.uint32):
        return from_int64(x64 & ((1 << 8 * dst.itemsize) - 1), dst)
    return x64.to(dst)


def _float_to_int(x: torch.Tensor, dst: dt.DataType) -> torch.Tensor:
    """Float to integer, truncating toward zero; out of range saturates
    and NaN gives 0 (XLA's conversion)."""
    lo, hi = int_range(dst)
    x = torch.nan_to_num(x.to(torch.float64), nan=0.0)
    if dst.kind == "uint64":
        big = x >= 2.0 ** 63   # no int64 holds it: shift into range
        low = torch.clamp(torch.where(big, x - 2.0 ** 63, x), 0.0,
                          2.0 ** 63 - 1024)
        y = low.to(torch.int64)
        return torch.where(big & (x < 2.0 ** 64), y ^ _SIGN,
                           torch.where(x >= 2.0 ** 64, -1, y)
                           ).view(torch.uint64)
    y = torch.where(x >= 2.0 ** 63, hi,
                    torch.clamp(x, float(lo), 2.0 ** 63 - 1024
                                ).to(torch.int64))
    return _wrap_int64(torch.clamp(y, lo, hi), dst.physical_dtype())


def _u64_to_float(x64: torch.Tensor, dst: torch.dtype) -> torch.Tensor:
    """uint64 bit patterns to a float type, rounded once: a value past
    2^63 is halved with its low bit kept (sticky), converted, doubled."""
    halved = ((x64 >> 1) & ~_SIGN) | (x64 & 1)
    return torch.where(x64 < 0, halved.to(dst) * 2, x64.to(dst))


def convert(x: torch.Tensor, src: dt.DataType, dst: dt.DataType
            ) -> torch.Tensor:
    """``x`` (storage of ``src``) as ``dst``'s storage, with C's
    conversions (integers wrap; floats to integers as ``_float_to_int``);
    no checks. Both types numeric or bool."""
    tgt = dst.physical_dtype()
    if x.dtype == tgt:
        return x
    if dst.is_boolean:
        return (as_int64(x) if src.is_integer else x) != 0
    if src.is_floating:
        return x.to(tgt) if dst.is_floating else _float_to_int(x, dst)
    x64 = as_int64(x)
    if dst.is_floating:
        if src.kind == "uint64":
            return _u64_to_float(x64, tgt)
        return x64.to(tgt)
    return _wrap_int64(x64, tgt)


def _cast_numeric(x, src: dt.DataType, dst: dt.DataType,
                  options: CastOptions, validity):
    if src.is_boolean or dst.is_boolean:
        return convert(x, src, dst)
    if src.is_integer and dst.is_integer:
        if not options.allow_int_overflow:
            lo, hi = int_range(dst)
            slo, shi = int_range(src)
            if slo < lo or shi > hi:
                x64 = as_int64(x)
                if src.kind == "uint64":   # bit patterns past 2^63 are < 0
                    bad = (x64 < 0) | (x64 > hi) if hi < 1 << 63 else \
                        torch.zeros_like(x64, dtype=torch.bool)
                else:
                    bad = x64 < lo
                    if hi < 1 << 63:
                        bad = bad | (x64 > hi)
                _raise_if(bad, f"integer value out of bounds casting {src} "
                          f"-> {dst}", validity)
        return convert(x, src, dst)
    if src.is_floating and dst.is_integer:
        if not options.allow_float_truncate:
            _raise_if(torch.floor(x) != x, "float value was truncated "
                      f"converting to {dst}", validity)
        if not options.allow_int_overflow:
            lo, hi = int_range(dst)
            bad = (x < float(lo)) | (x > float(hi)) | torch.isnan(x)
            _raise_if(bad, f"float out of bounds casting to {dst}", validity)
        return convert(x, src, dst)
    if src.is_integer and dst.is_floating:
        return convert(x, src, dst)
    if src.is_floating and dst.is_floating:
        y = x.to(dst.physical_dtype())
        if (not options.allow_float_truncate
                and y.element_size() < x.element_size()):
            _raise_if((y.to(x.dtype) != x) & ~torch.isnan(x),
                      f"float truncation casting {src} -> {dst}", validity)
        return y
    raise Invalid(f"unsupported numeric cast {src} -> {dst}")


def cast(value, target_type: dt.DataType, safe: bool = True,
         options: Optional[CastOptions] = None):
    """Eager cast entry (reference: compute::Cast cast.cc)."""
    if options is None:
        options = CastOptions.safe(target_type) if safe else \
            CastOptions.unsafe(target_type)
    return _cast_exec([as_datum(value)], options, None)


def _cast_exec(args, options: CastOptions, ctx):
    (a,) = args
    dst = options.target_type if options is not None else None
    if dst is None:
        raise Invalid("cast requires target_type")
    if not isinstance(dst, dt.DataType):
        dst = dt.from_arrow(dst)
    src = a.dtype
    if src == dst:
        return a
    (x,), validities, n = unpack(args)
    validity = validities[0]

    # an explicit dictionary: its values through the codes (reference: a
    # cast from a dictionary unpacks, scalar_cast_nested.cc)
    if src.is_dictionary:
        d = a.dictionary
        vt = src.value_type
        if dst.is_binary:
            return result_column(x, dst, validity, n, dictionary=d)
        if vt.is_binary:
            raise NotImplementedError_(f"cast {src} -> {dst}: {_LATER}")
        lut = torch.from_numpy(np.asarray(d.values).astype(
            vt.numpy_dtype())).to(x.device)
        decoded = lut[x.long().clamp(0, max(len(d) - 1, 0))] if len(d) \
            else torch.zeros_like(x, dtype=vt.physical_dtype())
        if vt == dst:
            return result_column(decoded, dst, validity, n)
        inner = Column(decoded, vt, validity=None if validity is None
                       or validity is False else validity)
        return _cast_exec([inner], options, ctx)
    if src.is_binary:
        if dst.is_binary:
            return result_column(x, dst, validity, n,
                                 dictionary=a.dictionary)
        raise NotImplementedError_(f"cast {src} -> {dst}: {_LATER}")
    if dst.is_binary or dst.is_dictionary:
        raise NotImplementedError_(f"cast {src} -> {dst}: {_LATER}")
    return result_column(_cast_numeric(x, src, dst, options, validity),
                         dst, validity, n)


register_function("cast", "scalar", 1, CastOptions)(_cast_exec)
