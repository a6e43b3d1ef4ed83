"""Bitwise kernels: bit_wise_and/or/xor/not and shift_left/shift_right
with their ``_checked`` variants (counterpart of
arrow1_tpu/ops/bitwise.py).

Reference: compute/kernels/scalar_arithmetic.cc, the bitwise section. An
out-of-range shift amount (< 0, or at least the type's value bits) leaves
the operand unchanged in the unchecked variant and raises in the checked
one, the check reduced on the host. uint16, uint32 and uint64 compute in
int64 (``dtypes.as_int64``), where torch has their bit operations: a
right shift of them is logical, of a signed type arithmetic.
"""

from __future__ import annotations

import torch

from ..errors import Invalid
from ..registry import register_function
from .arithmetic import _WIDE
from .common import (as_int64, column_device, common_type, from_int64,
                     intersect_validity, result_column, unpack)


def _to_wide(x, t):
    return as_int64(x) if t.kind in _WIDE else x


def _from_wide(r, t):
    if t.kind not in _WIDE:
        return r
    return from_int64(r & _WIDE[t.kind], t.physical_dtype())


def _no_decimal(name, args):
    """A decimal has no bitwise form: TypeError, as the JAX package's
    numeric promotion raises for one."""
    if any(a.dtype.is_decimal for a in args):
        raise TypeError(f"{name}: expects integers, not a decimal")


def _bitwise_binary(name, fn):
    def exec_fn(args, options, ctx):
        _no_decimal(name, args)
        out_t = common_type(args)
        if not out_t.is_integer:
            raise Invalid(f"{name}: expects integers")
        (x, y), validities, n = unpack(args, out_t)
        r = fn(_to_wide(x, out_t), _to_wide(y, out_t))
        return result_column(_from_wide(r, out_t), out_t,
                             intersect_validity(validities), n)

    return exec_fn


register_function("bit_wise_and", "scalar", 2)(
    _bitwise_binary("bit_wise_and", torch.bitwise_and))
register_function("bit_wise_or", "scalar", 2)(
    _bitwise_binary("bit_wise_or", torch.bitwise_or))
register_function("bit_wise_xor", "scalar", 2)(
    _bitwise_binary("bit_wise_xor", torch.bitwise_xor))


def _bit_wise_not_exec(args, options, ctx):
    (a,) = args
    if not a.dtype.is_integer:
        raise Invalid("bit_wise_not: expects integers")
    (x,), validities, n = unpack(args)
    r = _from_wide(torch.bitwise_not(_to_wide(x, a.dtype)), a.dtype)
    return result_column(r, a.dtype, intersect_validity(validities), n)


register_function("bit_wise_not", "scalar", 1)(_bit_wise_not_exec)


def _shift(name, left: bool, checked: bool):
    def exec_fn(args, options, ctx):
        _no_decimal(name, args)
        out_t = common_type(args)
        if not out_t.is_integer:
            raise Invalid(f"{name}: expects integers")
        (x, y), validities, n = unpack(args, out_t)
        validity = intersect_validity(validities)
        dev = column_device(args)
        x, y = _to_wide(x, out_t).to(dev), _to_wide(y, out_t).to(dev)
        width = 8 * out_t.physical_dtype().itemsize
        # numeric_limits<T>::digits: the value bits, sign bit excluded
        bits = width - (1 if out_t.is_signed_integer else 0)
        ys = y.to(torch.int64)   # uint64 amounts past 2^63 read < 0
        oob = (ys < 0) | (ys >= bits)
        if checked:
            live = oob if validity is None or validity is False else \
                oob & validity
            if validity is not False and bool(live.any()):
                raise Invalid(f"{name}: shift amount must be >= 0 and less "
                              "than precision of type")
        s = torch.where(oob, 0, ys).to(x.dtype)
        if left:
            r = x << s
        elif out_t.kind == "uint64":
            # logical: the int64 arithmetic shift with its sign copies
            # masked off (uint16 and uint32 are non-negative in int64)
            keep = torch.bitwise_left_shift(
                torch.ones_like(s), (64 - s).clamp(max=63)) - 1
            r = (x >> s) & torch.where(s == 0, -1, keep)
        else:
            r = x >> s
        r = torch.where(oob, x, r)
        return result_column(_from_wide(r, out_t), out_t, validity, n)

    return exec_fn


register_function("shift_left", "scalar", 2)(
    _shift("shift_left", True, False))
register_function("shift_left_checked", "scalar", 2)(
    _shift("shift_left_checked", True, True))
register_function("shift_right", "scalar", 2)(
    _shift("shift_right", False, False))
register_function("shift_right_checked", "scalar", 2)(
    _shift("shift_right_checked", False, True))
