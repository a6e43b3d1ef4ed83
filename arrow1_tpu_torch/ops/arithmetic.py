"""Scalar arithmetic: add/subtract/multiply/divide/negate/power/abs and
their ``_checked`` variants, and sign (counterpart of
arrow1_tpu/ops/arithmetic.py: numeric types, and the temporal matrix of
``_temporal_arith``).

Integer ops wrap (two's complement); integer division truncates toward
zero as in C and Arrow. The checked variants reduce an overflow flag on
the host and raise from it, skipping null slots.

uint16, uint32 and uint64 compute in int64 on every device, because
torch has no add, subtract, divide or order compare for them: uint16
and uint32 widen and are masked back to their width, and uint64 travels
as its int64 bit pattern, whose add, subtract and multiply wrap as the
unsigned ones do. Its order compares flip the sign bit first, and its
division is the unsigned quotient of ``_udiv64``.

``sign`` follows pyarrow where the reference does not (ROADMAP Queue 3):
the sign of 0.0 and -0.0 is 0.0, and of a decimal an int64. Decimal
arguments go to ops/decimal.py (``power`` of one computes in float64).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import dtypes as dt
from ..errors import Invalid, NotImplementedError_
from ..kernels.radix import _SIGN
from ..registry import register_function
from .common import (as_int64, column_device, common_type, from_int64,
                     intersect_validity, result_column, unpack)
from .decimal import (as_float_operand, decimal_abs, decimal_arith,
                      decimal_negate, decimal_sign)

__all__ = ["ArithmeticOptions"]

_INT64_MAX = (1 << 63) - 1
# the types computed in int64, each with the mask of its width
_WIDE = {"uint16": 0xFFFF, "uint32": 0xFFFFFFFF, "uint64": -1}


@dataclasses.dataclass
class ArithmeticOptions:
    """Reference: api_scalar.h:40."""

    check_overflow: bool = False


def _raise_if(flag, message: str, validity):
    """Raise when a valid (non-null) slot sets the flag (host sync)."""
    if validity is False:
        return
    if validity is not None:
        flag = flag & validity
    if bool(flag.any()):
        raise Invalid(message)


def _int_min(t) -> int:
    return torch.iinfo(t.physical_dtype()).min


def _check_numeric(name, args, out_t):
    if not out_t.is_numeric:
        raise Invalid(f"{name}: non-numeric inputs")


def _lt(a, b, t):
    """a < b in ``t``'s order; uint64 bit patterns compare unsigned."""
    if t.kind == "uint64":
        a, b = a ^ _SIGN, b ^ _SIGN
    return a < b


def _udiv64(a, b):
    """Unsigned quotient of uint64 bit patterns held in int64, b != 0.
    For b >= 2^63 it is a >= b. Otherwise a is halved by a logical
    shift, so that both operands lie below 2^63 where signed division is
    exact; the doubled quotient leaves a remainder below 2b, which one
    correction takes out."""
    big = b < 0
    a_ge_b = ~_lt(a, b, dt.uint64)
    b = torch.where(big, torch.ones_like(b), b)
    q = torch.div((a >> 1) & _INT64_MAX, b, rounding_mode="trunc") << 1
    q = q + (~_lt(a - q * b, b, dt.uint64)).to(torch.int64)
    return torch.where(big, a_ge_b.to(torch.int64), q)


def _div(a, b, t):
    """a / b truncated, b != 0, in ``t``'s arithmetic."""
    if t.kind == "uint64":
        return _udiv64(a, b)
    return torch.div(a, b, rounding_mode="trunc")


def _add_overflow(x, y, r, t):
    if t.is_unsigned_integer:
        return _lt(r, x, t)
    return ((x > 0) & (y > 0) & (r < x)) | ((x < 0) & (y < 0) & (r > x))


def _sub_overflow(x, y, r, t):
    if t.is_unsigned_integer:
        return _lt(x, y, t)
    return ((x >= 0) & (y < 0) & (r < x)) | ((x < 0) & (y > 0) & (r > x))


def _mul_overflow(x, y, r, t):
    # r / y != x detects wraparound; lo * -1 wraps in the division itself,
    # so it is flagged explicitly and kept out of the division
    x, y = x.to(r.device), y.to(r.device)
    bad = torch.zeros_like(r, dtype=torch.bool)
    safe = y != 0
    if t.is_signed_integer:
        lo = _int_min(t)
        bad = ((x == lo) & (y == -1)) | ((y == lo) & (x == -1))
        safe = safe & ~((r == lo) & (y == -1))
    y_safe = torch.where(safe, y, torch.ones_like(y))
    return bad | (safe & (_div(r, y_safe, t) != x))


_UNIT_RANK = {"s": 0, "ms": 1, "us": 2, "ns": 3}
_UNIT_MULT = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}


def _temporal_parts(a, x):
    """(int64 storage in a unit that scales, the unit, the kind): kind
    is "instant" (timestamp, date), "time" (time of day), "dur" or
    "num"."""
    t = a.dtype
    if not t.is_temporal:
        return x, None, "num"
    k = t.kind
    if k == "date32":
        return x.to(torch.int64) * 86400, "s", "instant"
    if k == "date64":
        return x.to(torch.int64), "ms", "instant"
    kind = {"timestamp": "instant", "time32": "time", "time64": "time",
            "duration": "dur"}[k]
    return x.to(torch.int64), t.unit, kind


def _temporal_arith(name, args):
    """The temporal arithmetic matrix (reference: scalar_arithmetic.cc
    timestamp and duration kernels):
    add:      dur+dur->dur, instant+dur->timestamp, time+dur->time
    subtract: instant-instant->dur, time-time->dur, dur-dur->dur,
              instant-dur->timestamp, time-dur->time
    multiply: dur*int->dur
    divide:   dur/dur->float64, dur/int->dur (truncated)
    Mixed units promote to the finer one. A timestamp result keeps its
    instant's time zone, as pyarrow's does (the JAX package drops it)."""
    a, b = args
    (x, y), validities, n = unpack(args)
    xa, ua, ka = _temporal_parts(a, x)
    yb, ub, kb = _temporal_parts(b, y)
    validity = intersect_validity(validities)
    cu = max((u for u in (ua, ub) if u), key=lambda u: _UNIT_RANK[u])
    if ua:
        xa = xa * (_UNIT_MULT[cu] // _UNIT_MULT[ua])
    if ub:
        yb = yb * (_UNIT_MULT[cu] // _UNIT_MULT[ub])

    def time_t(unit):
        return dt.time32(unit) if unit in ("s", "ms") else dt.time64(unit)

    tz = next((c.dtype.tz for c in args if c.dtype.kind == "timestamp"),
              None)

    def out(v, t):
        return result_column(v.to(t.physical_dtype()), t, validity, n)

    pair = (ka, kb)
    if name == "add":
        if pair == ("dur", "dur"):
            return out(xa + yb, dt.duration(cu))
        if "dur" in pair and "instant" in pair:
            return out(xa + yb, dt.timestamp(cu, tz))
        if "dur" in pair and "time" in pair:
            return out(xa + yb, time_t(cu))
    elif name == "subtract":
        if ka == kb and ka in ("instant", "time", "dur"):
            return out(xa - yb, dt.duration(cu))
        if pair == ("instant", "dur"):
            return out(xa - yb, dt.timestamp(cu, tz))
        if pair == ("time", "dur"):
            return out(xa - yb, time_t(cu))
    elif name == "multiply":
        if "dur" in pair and "num" in pair:
            num, other = (yb, xa) if ka == "dur" else (xa, yb)
            if num.is_floating_point():
                raise Invalid(f"{name}: a duration times a float")
            return out(other * as_int64(num), dt.duration(cu))
    elif name == "divide":
        if pair == ("dur", "dur"):
            dev = column_device(args)
            return result_column(xa.to(dev).to(torch.float64)
                                 / yb.to(dev).to(torch.float64),
                                 dt.float64, validity, n)
        if pair == ("dur", "num") and not y.is_floating_point():
            d = as_int64(y)
            _raise_if(d == 0, "divide by zero", validity)
            return out(torch.div(xa, torch.where(d == 0, 1, d),
                                 rounding_mode="trunc"), dt.duration(cu))
    raise Invalid(f"{name}: unsupported temporal combination "
                  f"{a.dtype} / {b.dtype}")


def _binary_arith(name, op, overflow_fn):
    def exec_fn(args, options, ctx):
        if any(a.dtype.is_decimal for a in args):
            return decimal_arith(name, args)
        if any(a.dtype.is_binary for a in args):
            raise Invalid(f"{name}: non-numeric inputs")
        if any(a.dtype.is_temporal for a in args):
            return _temporal_arith(name.replace("_checked", ""), args)
        out_t = common_type(args)
        _check_numeric(name, args, out_t)
        (x, y), validities, n = unpack(args, out_t)
        wide = out_t.kind in _WIDE
        if wide:
            x, y = as_int64(x), as_int64(y)
        r = op(x, y)
        if wide:   # wrap at the type's width
            r = r & _WIDE[out_t.kind]
        validity = intersect_validity(validities)
        if overflow_fn is not None and out_t.is_integer:
            _raise_if(overflow_fn(x, y, r, out_t), f"overflow in {name}",
                      validity)
        if wide:
            r = from_int64(r, out_t.physical_dtype())
        return result_column(r, out_t, validity, n)

    return exec_fn


for _base, _op, _ovf in (("add", torch.add, _add_overflow),
                         ("subtract", torch.sub, _sub_overflow),
                         ("multiply", torch.mul, _mul_overflow)):
    register_function(_base, "scalar", 2)(
        _binary_arith(_base, _op, None))
    register_function(f"{_base}_checked", "scalar", 2)(
        _binary_arith(f"{_base}_checked", _op, _ovf))


def _divide_exec(checked):
    def exec_fn(args, options, ctx):
        if any(a.dtype.is_decimal for a in args):
            return decimal_arith("divide", args)
        if any(a.dtype.is_temporal for a in args):
            return _temporal_arith("divide", args)
        out_t = common_type(args)
        _check_numeric("divide", args, out_t)
        (x, y), validities, n = unpack(args, out_t)
        validity = intersect_validity(validities)
        if out_t.is_integer:
            dev = column_device(args)
            x, y = x.to(dev), y.to(dev)
            wide = out_t.kind in _WIDE
            if wide:
                x, y = as_int64(x), as_int64(y)
            zero = y == 0
            # divide-by-zero raises in both variants, as in Arrow
            _raise_if(zero, "divide by zero", validity)
            keep = ~zero
            if out_t.is_signed_integer:
                wraps = (x == _int_min(out_t)) & (y == -1)
                if checked:
                    _raise_if(wraps, "overflow in divide", validity)
                keep = keep & ~wraps   # lo / -1 wraps to lo, = lo / 1
            y_safe = torch.where(keep, y, torch.ones_like(y))
            r = _div(x, y_safe, out_t)
            if wide:
                r = from_int64(r, out_t.physical_dtype())
        else:   # a divisor on the card: no product with a reciprocal
            dev = column_device(args)
            r = x.to(dev) / y.to(dev)
        return result_column(r, out_t, validity, n)

    return exec_fn


register_function("divide", "scalar", 2)(
    _divide_exec(False))
register_function("divide_checked", "scalar", 2)(_divide_exec(True))


def _negate_exec(checked):
    def exec_fn(args, options, ctx):
        (a,) = args
        out_t = a.dtype
        if out_t.is_decimal:
            return decimal_negate(a)
        if not out_t.is_numeric:
            raise NotImplementedError_(f"negate of {out_t} is not ported")
        (x,), validities, n = unpack(args, out_t)
        validity = intersect_validity(validities)
        if checked and out_t.is_unsigned_integer:
            _raise_if(x != 0, "overflow in negate of unsigned", validity)
        if checked and out_t.is_signed_integer:
            _raise_if(x == _int_min(out_t), "overflow in negate", validity)
        if out_t.kind in _WIDE:
            r = from_int64(-as_int64(x) & _WIDE[out_t.kind], x.dtype)
        elif out_t.is_unsigned_integer:
            r = (-x.to(torch.int64)).to(x.dtype)
        else:
            r = torch.neg(x)
        return result_column(r, out_t, validity, n)

    return exec_fn


register_function("negate", "scalar", 1)(
    _negate_exec(False))
register_function("negate_checked", "scalar", 1)(_negate_exec(True))


def _ipow(x, y):
    """x ** y for integers by squaring, wrapping (reference:
    scalar_arithmetic.cc Power). ``y`` holds int64 exponents >= 0, or
    uint64 bit patterns, shifted logically; one step per bit of the
    widest exponent (read on the host)."""
    result = torch.ones_like(x)
    base, exp = x, y
    steps = 64 if bool((y < 0).any()) else \
        (int(y.max()).bit_length() if y.numel() else 0)
    for _ in range(steps):
        result = torch.where((exp & 1) == 1, result * base, result)
        base = base * base
        exp = (exp >> 1) & _INT64_MAX
    return result


def _power_exec(checked):
    def exec_fn(args, options, ctx):
        if any(a.dtype.is_decimal for a in args):   # float64, as pyarrow
            args = [as_float_operand(a) for a in args]
        out_t = common_type(args)
        _check_numeric("power", args, out_t)
        (x, y), validities, n = unpack(args, out_t)
        validity = intersect_validity(validities)
        dev = column_device(args)
        x, y = x.to(dev), y.to(dev)
        if not out_t.is_integer:
            return result_column(torch.pow(x, y), out_t, validity, n)
        wide = out_t.kind in _WIDE
        x64, y64 = as_int64(x), as_int64(y)
        if out_t.is_signed_integer:
            _raise_if(y64 < 0, "integers to negative integer powers are "
                      "not allowed", validity)
        if out_t.is_signed_integer:
            y64 = torch.where(y64 < 0, 0, y64)
        if checked:
            approx = torch.abs(x64.to(torch.float64)
                               if out_t.kind != "uint64" else
                               _u64_float(x64)) ** (
                _u64_float(y64) if out_t.kind == "uint64"
                else y64.to(torch.float64))
            hi = float(_int_max(out_t))
            big = (_u64_float(x64) if out_t.kind == "uint64"
                   else torch.abs(x64.to(torch.float64))) > 1
            _raise_if(big & (approx > hi * 1.0000001), "overflow in power",
                      validity)
        if wide:
            r = from_int64(_ipow(x64, y64) & _WIDE[out_t.kind],
                           out_t.physical_dtype())
        else:
            r = _ipow(x, y64).to(x.dtype)
        return result_column(r, out_t, validity, n)

    return exec_fn


def _int_max(t) -> int:
    info = torch.iinfo(t.physical_dtype())
    return int(info.max)


def _u64_float(x64):
    """uint64 bit patterns as float64 magnitudes (for bounds only)."""
    return torch.where(x64 < 0, x64.to(torch.float64) + 2.0 ** 64,
                       x64.to(torch.float64))


register_function("power", "scalar", 2, ArithmeticOptions)(
    _power_exec(False))
register_function("power_checked", "scalar", 2)(_power_exec(True))


def _abs_exec(checked):
    def exec_fn(args, options, ctx):
        (a,) = args
        out_t = a.dtype
        if out_t.is_decimal:
            return decimal_abs(a)
        if not out_t.is_numeric:
            raise NotImplementedError_(f"abs of {out_t} is not ported")
        (x,), validities, n = unpack(args, out_t)
        validity = intersect_validity(validities)
        if checked and out_t.is_signed_integer:
            _raise_if(x == _int_min(out_t), "overflow in abs", validity)
        r = x if out_t.is_unsigned_integer else torch.abs(x)
        return result_column(r, out_t, validity, n)

    return exec_fn


register_function("abs", "scalar", 1)(_abs_exec(False))
register_function("abs_checked", "scalar", 1)(_abs_exec(True))


def _sign_exec(args, options, ctx):
    """-1, 0 or 1 (int8 for integers, the input's type for floats; NaN
    stays NaN, and either zero gives 0.0 as in pyarrow)."""
    (a,) = args
    if a.dtype.is_decimal:
        return decimal_sign(a)
    if not a.dtype.is_numeric:
        raise NotImplementedError_(f"sign of {a.dtype} is not ported")
    out_t = a.dtype if a.dtype.is_floating else dt.int8
    (x,), validities, n = unpack(args)
    if a.dtype.is_floating:
        r = torch.where(torch.isnan(x), x, torch.sign(x) + 0.0)
    elif a.dtype.is_unsigned_integer:
        r = (as_int64(x) != 0).to(torch.int8)
    else:
        r = torch.sign(x).to(torch.int8)
    return result_column(r, out_t, intersect_validity(validities), n)


register_function("sign", "scalar", 1)(_sign_exec)
