"""Casts (counterpart of arrow1_tpu/ops/cast.py).

Covered: int, uint, float and bool between each other, an explicit
dictionary column to its values, numeric, bool and temporal to string
(each distinct value formatted once on the host, ops/formatting.py),
string to numeric, bool and temporal (the pool parsed on the host,
gathered by the codes on the device; a value that does not parse raises
only where a live row holds it), string to string and binary, integer to
temporal and back (the storage integers), and temporal to temporal with
the unit rescaled (``_cast_temporal``). ``CastOptions`` keeps the
reference's safety toggles (cast.h:44): a safe cast raises on integer
overflow, on a float to integer cast that would drop a fraction, on NaN
or inf into an integer, and on a temporal cast to a coarser unit that
would drop ticks (``allow_time_truncate``), each from a device flag
reduced on the host (one sync), as the checked arithmetic does. Decimals
cast to and from integers, floats, other decimals (``allow_decimal_
truncate``) and strings through ops/decimal.py: limb math on the device,
strings formatted or parsed per distinct value on the host.

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
from ..column import Column, Dictionary, unscaled_ints
from ..datum import Scalar, as_datum
from ..errors import Invalid
from ..kernels.radix import _SIGN
from ..registry import register_function
from .arithmetic import _raise_if
from .common import as_int64, from_int64, result_column, unpack
from .decimal import (cast_to_decimal, column_limbs, decimal_cast,
                      decimal_to_float, pack)
from .decimal256 import full
from .strings import with_pool

__all__ = ["CastOptions", "cast", "convert", "int_range",
           "temporal_to_common"]

_UNIT_NS = {"s": 1_000_000_000, "ms": 1_000_000, "us": 1_000, "ns": 1}


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


def temporal_unit_ns(t: dt.DataType) -> int:
    """Nanoseconds in one storage tick of a temporal type."""
    if t.kind == "date32":
        return 86_400 * _UNIT_NS["s"]
    if t.kind == "date64":
        return _UNIT_NS["ms"]
    return _UNIT_NS[t.unit]


def temporal_to_common(a, b):
    """The int64 storage of two temporal arguments in the finer unit."""
    from .common import value_of

    na, nb = temporal_unit_ns(a.dtype), temporal_unit_ns(b.dtype)
    x = value_of(a).to(torch.int64)
    y = value_of(b).to(torch.int64)
    if na > nb:
        x = x * (na // nb)
    elif nb > na:
        y = y * (nb // na)
    return x, y


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


def _parse_string_uniques(values, dst: dt.DataType):
    """Parse a pool's values on the host with the value parsers
    (ops/formatting.py; reference util/value_parsing.h): (table of
    ``dst``'s storage, ok flags, the first error message). A value that
    does not parse raises only if a live row holds it."""
    from . import formatting as F

    vals = [v.decode() if isinstance(v, (bytes, np.bytes_)) else str(v)
            for v in values]
    ok = [True] * len(vals)
    err = [""]

    def attempt(fn, i, default):
        try:
            return fn()
        except (Invalid, ValueError) as e:
            ok[i] = False
            if not err[0]:
                err[0] = str(e)
            return default

    if dst.is_integer:
        table = [attempt(lambda v=v: F.parse_int(v, dst.kind), i, 0)
                 for i, v in enumerate(vals)]
        if dst.kind == "uint64":   # its storage holds the bits
            table = [t - (1 << 64) if t >= 1 << 63 else t for t in table]
            return np.array(table, np.int64).view(np.uint64), ok, err[0]
    elif dst.is_floating:
        table = [attempt(lambda v=v: F.parse_float(v), i, 0.0)
                 for i, v in enumerate(vals)]
    elif dst.is_boolean:
        table = [attempt(lambda v=v: F.parse_bool(v), i, False)
                 for i, v in enumerate(vals)]
    elif dst.is_temporal:
        table = [attempt(lambda v=v: F.parse_temporal(v, dst), i, 0)
                 for i, v in enumerate(vals)]
    elif dst.is_decimal:   # one row of limbs per value
        from .decimal256 import const_limbs

        ints = [attempt(lambda v=v: F.parse_decimal(
            v, dst.precision, dst.scale), i, 0) for i, v in enumerate(vals)]
        return np.array([const_limbs(v, dst.limbs) for v in ints],
                        np.int64).reshape(-1, dst.limbs), ok, err[0]
    else:
        raise Invalid(f"unsupported cast string -> {dst}")
    return np.array(table, dst.numpy_dtype()), ok, err[0]


def _format_to_strings(x: torch.Tensor, src: dt.DataType):
    """Format the distinct values of ``x`` on the host (ops/formatting.py;
    reference util/formatting.h): (their strings, each row's index among
    them, int32 on ``x``'s device). The distinct values are found on the
    device; floats by their bits, so -0.0 and 0.0 format apart."""
    from . import formatting as F

    if src.is_boolean:
        return np.array(["false", "true"], object), x.to(torch.int32)
    if src.is_decimal:   # x: the column; its distinct limb rows
        rows = torch.stack(column_limbs(x), 1)
        uniq, inv = torch.unique(rows, dim=0, return_inverse=True)
        vals = unscaled_ints(pack(list(uniq.unbind(1)), src, None))
        return np.array([F.format_decimal(v, src.scale) for v in vals],
                        object), inv.to(torch.int32)
    if src.is_temporal:
        uniq, inv = torch.unique(x.to(torch.int64), return_inverse=True)
        return F.format_temporal_values(uniq, src), inv.to(torch.int32)
    if src.is_floating:
        if x.dtype == torch.float16:
            x = x.to(torch.float32)
        bits = x.view(torch.int32 if x.dtype == torch.float32
                      else torch.int64)
        uniq, inv = torch.unique(bits, return_inverse=True)
        f32 = src.kind != "float64"
        floats = uniq.cpu().numpy().view(np.float32 if f32 else np.float64)
        strs = [F.format_float(v, f32) for v in floats]
    else:
        uniq, inv = torch.unique(as_int64(x), return_inverse=True)
        ints = uniq.cpu().numpy()
        if src.kind == "uint64":
            ints = ints.view(np.uint64)
        strs = [str(int(v)) for v in ints]
    return np.array(strs, object), inv.to(torch.int32)


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
    if src.is_null:
        return _all_null(a, dst)
    if src.is_decimal:   # its limbs are read where they are needed
        x, n = None, (a.length if isinstance(a, Column) else None)
        validity = a.validity if isinstance(a, Column) else \
            (None if a.is_valid else False)
    else:
        (x,), validities, n = unpack(args)
        validity = validities[0]

    # an explicit dictionary: its values through the codes (reference: a
    # cast from a dictionary unpacks, scalar_cast_nested.cc)
    if src.is_dictionary:
        d = a.dictionary
        vt = src.value_type
        if dst.is_binary:
            return result_column(x, dst, validity, n, dictionary=d)
        if vt.is_binary:   # the codes as a string column of the pool
            inner = Column(x, vt, validity=None if validity is None
                           or validity is False else validity,
                           dictionary=d) if n is not None else \
                Scalar(x, vt, is_valid=validity is not False, dictionary=d)
            return _cast_exec([inner], options, ctx)
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
        d = a.dictionary
        if dst.is_binary:
            return result_column(x, dst, validity, n, dictionary=d)
        if dst.is_dictionary:
            raise Invalid(f"unsupported cast {src} -> {dst}")
        # parse the pool on the host, gather on the device (reference
        # scalar_cast_string.cc through util/value_parsing.h)
        table, ok, err = _parse_string_uniques(d.values, dst)
        codes = x.long().clamp(0, max(len(d) - 1, 0))
        if not all(ok):
            ok_t = torch.from_numpy(np.array(ok)).to(x.device)
            _raise_if(~ok_t[codes], err, validity)
        if dst.is_decimal:   # a table row per pool value: all its limbs
            rows = torch.from_numpy(table).to(x.device)
            rows = rows[codes] if len(d) else torch.zeros(
                (codes.shape[0], dst.limbs), dtype=torch.int64,
                device=x.device)
            out = pack(list(rows.unbind(1)), dst,
                       None if validity is False else validity)
            return _decimal_result(out, validity, n)
        data = torch.from_numpy(table).to(x.device)[codes] if len(d) else \
            torch.zeros_like(x, dtype=dst.physical_dtype())
        return result_column(data, dst, validity, n)
    if dst.is_binary:
        # numeric and bool -> string: each distinct value formatted once
        # (reference util/formatting.h), the rows keep its index as code
        strs, codes = _format_to_strings(
            _decimal_column(a) if src.is_decimal else x, src)
        if n is None:
            return Scalar(codes, dst, is_valid=validity is not False,
                          dictionary=Dictionary(strs))
        if validity is False:
            validity = torch.zeros(n, dtype=torch.bool, device=codes.device)
        return with_pool(codes, dst, validity, strs)
    if dst.is_dictionary:
        raise Invalid(f"unsupported cast {src} -> {dst}")
    if src.is_decimal or dst.is_decimal:
        return _cast_decimal(a, src, dst, options)
    if src.is_temporal or dst.is_temporal:
        return result_column(_cast_temporal(x, src, dst, options, validity),
                             dst, validity, n)
    return result_column(_cast_numeric(x, src, dst, options, validity),
                         dst, validity, n)


def _all_null(a, dst: dt.DataType):
    """A null-typed datum cast to ``dst``: every slot null, in ``dst``'s
    layout (pyarrow casts the null type to any flat type)."""
    if dst.is_nested or dst.is_dictionary or dst.is_interval:
        raise Invalid(f"unsupported cast {a.dtype} -> {dst}")
    pool = Dictionary(np.asarray([""], object)) if dst.is_binary else None
    if not isinstance(a, Column):
        return Scalar(0, dst, is_valid=False, dictionary=pool)
    n, dev = a.length, a.device
    data = torch.zeros(n, dtype=dst.physical_dtype(), device=dev)
    data2 = None if not dst.is_decimal else torch.zeros(
        (n,) if dst.limbs == 2 else (n, 3), dtype=torch.int64, device=dev)
    return Column(data, dst, validity=torch.zeros(n, dtype=torch.bool,
                                                  device=dev),
                  dictionary=pool, data2=data2)


def _decimal_column(a):
    """A decimal column, or a decimal scalar as a one-row column."""
    if isinstance(a, Column):
        return a
    return pack(full(int(a.value) if a.is_valid else 0, a.dtype.limbs, 1,
                     "cpu"), a.dtype, None)


def _decimal_result(out: Column, validity, n):
    """A decimal cast's column, or its one row as a Scalar when the input
    was a scalar."""
    if n is not None:
        if validity is False:
            return pack(column_limbs(out), out.dtype, torch.zeros(
                n, dtype=torch.bool, device=out.device))
        return out
    return Scalar(unscaled_ints(out)[0], out.dtype,
                  is_valid=validity is not False)


def _cast_decimal(a, src: dt.DataType, dst: dt.DataType,
                  options: CastOptions):
    """decimal -> float (limb-exact, then rounded once per limb as the
    JAX package does), decimal -> decimal or integer, and integer or
    float -> decimal (ops/decimal.py)."""
    col = _decimal_column(a) if src.is_decimal else a
    n = a.length if isinstance(a, Column) else None
    validity = a.validity if isinstance(a, Column) else \
        (None if a.is_valid else False)
    if src.is_decimal and dst.is_floating:
        f = decimal_to_float(col).data
        return result_column(f.to(dst.physical_dtype()) if n is not None
                             else f[0].to(dst.physical_dtype()), dst,
                             validity, n)
    if src.is_decimal and (dst.is_decimal or dst.is_integer):
        out = decimal_cast(col, dst, bool(options.allow_decimal_truncate))
        if dst.is_integer:
            return result_column(out.data if n is not None else out.data[0],
                                 dst, validity, n)
        return _decimal_result(out, validity, n)
    if dst.is_decimal and (src.is_integer or src.is_floating):
        if n is None:
            raise Invalid(f"cast of a {src} scalar to {dst}: use a column")
        return _decimal_result(cast_to_decimal(a, dst), validity, n)
    raise Invalid(f"unsupported cast {src} -> {dst}")


def _cast_temporal(x, src, dst, options: CastOptions, validity):
    """Integers to temporal storage and back (the storage integers), and
    temporal to temporal with the unit rescaled: to a finer unit by a
    product, to a coarser one by a division truncated toward zero, as
    pyarrow's (the JAX package floors: ROADMAP Queue 3), which a safe cast
    refuses where it drops ticks. A timestamp to a date or a time gives
    its calendar day (floored) or its time of day, in local time when it
    has a zone, as pyarrow's cast does (the JAX package rescales the
    instant)."""
    if src.is_numeric and dst.is_temporal:
        return convert(x, src, dt.int64).to(dst.physical_dtype())
    if src.is_temporal and dst.is_numeric:
        return _cast_numeric(x, dt.int64, dst, options, validity)
    if src.kind == "timestamp" and dst.kind in ("date32", "date64",
                                                "time32", "time64"):
        from .temporal import _wall

        per_day = 86400 * 10**9 // _UNIT_NS[src.unit]
        wall = _wall(Column(x, src))
        days = torch.div(wall, per_day, rounding_mode="floor")
        if dst.kind == "date32":
            return days.to(torch.int32)
        if dst.kind == "date64":
            return days * 86_400_000
        x, src = wall - days * per_day, dt.time64(src.unit) \
            if src.unit in ("us", "ns") else dt.time32(src.unit)
    if src.is_temporal and dst.is_temporal:
        ns_src, ns_dst = temporal_unit_ns(src), temporal_unit_ns(dst)
        v = x.to(torch.int64)
        if ns_src >= ns_dst:
            r = v * (ns_src // ns_dst)
        else:
            f = ns_dst // ns_src
            if not options.allow_time_truncate:
                _raise_if(v % f != 0, f"casting {src} -> {dst} would lose "
                          "data", validity)
            r = torch.div(v, f, rounding_mode="trunc")
        return r.to(dst.physical_dtype())
    raise Invalid(f"unsupported temporal cast {src} -> {dst}")


register_function("cast", "scalar", 1, CastOptions)(_cast_exec)
