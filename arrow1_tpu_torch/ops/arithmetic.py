"""Scalar arithmetic: add/subtract/multiply/divide/negate and their
``_checked`` variants (counterpart of arrow1_tpu/ops/arithmetic.py,
numeric types only).

Integer ops wrap (two's complement); integer division truncates toward
zero as in C and Arrow. The checked variants reduce an overflow flag on
the host and raise from it, skipping null slots.

uint16, uint32 and uint64 compute in int64 on every device, because
torch has no add, subtract, divide or order compare for them: uint16
and uint32 widen and are masked back to their width, and uint64 travels
as its int64 bit pattern, whose add, subtract and multiply wrap as the
unsigned ones do. Its order compares flip the sign bit first, and its
division is the unsigned quotient of ``_udiv64``.
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..errors import Invalid, NotImplementedError_
from ..kernels.radix import _SIGN
from ..registry import register_function
from .common import (as_int64, column_device, common_type, from_int64,
                     intersect_validity, result_column, unpack)

_INT64_MAX = (1 << 63) - 1
# the types computed in int64, each with the mask of its width
_WIDE = {"uint16": 0xFFFF, "uint32": 0xFFFFFFFF, "uint64": -1}


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


def _binary_arith(name, op, overflow_fn):
    def exec_fn(args, options, ctx):
        if any(a.dtype.is_binary for a in args):
            raise Invalid(f"{name}: non-numeric inputs")
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
        else:
            r = x / y
        return result_column(r, out_t, validity, n)

    return exec_fn


register_function("divide", "scalar", 2)(
    _divide_exec(False))
register_function("divide_checked", "scalar", 2)(_divide_exec(True))


def _negate_exec(checked):
    def exec_fn(args, options, ctx):
        (a,) = args
        out_t = a.dtype
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
