"""Elementwise math: logarithms, exp, sqrt, trigonometric and hyperbolic
functions with their ``_checked`` variants, atan2, hypot, logb,
floor/ceil/trunc and the rounding family (counterpart of
arrow1_tpu/ops/math.py).

Reference: the scalar_arithmetic.cc math kernels and scalar_round.cc.
Every function is one torch elementwise op (or a few) with intersection
nulls; integers promote to float64 for the float functions, as the
reference's generated float kernels do. A ``_checked`` variant raises on
a domain error of a valid slot instead of giving inf or NaN (one host
sync). Integer rounding to a negative number of digits stays in int64,
so values past 2^53 stay exact. Every divisor is a tensor on the
dividend's device: CUDA divides by a Python number (or a CPU scalar) as a
product with its reciprocal, which rounds differently. Transcendental results may differ from
the reference's by a few ulps (different libm); the tests state the
bound. A decimal goes to float64 for the float functions
(``decimal_to_float``), and rounds exactly in its own type
(ops/decimal.py).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import dtypes as dt
from ..errors import Invalid
from ..registry import register_function
from .arithmetic import _raise_if
from .cast import convert
from .decimal import (as_float_operand, decimal_round,
                      decimal_round_to_multiple)
from .common import column_device, intersect_validity, result_column, \
    unpack

__all__ = ["RoundOptions", "RoundToMultipleOptions", "RoundBinaryOptions"]


@dataclasses.dataclass
class RoundOptions:
    ndigits: int = 0
    round_mode: str = "half_to_even"


@dataclasses.dataclass
class RoundToMultipleOptions:
    multiple: float = 1.0
    round_mode: str = "half_to_even"


@dataclasses.dataclass
class RoundBinaryOptions:
    """Reference: api_scalar.h RoundBinaryOptions (round_mode only;
    ndigits comes from the second argument)."""

    round_mode: str = "half_to_even"


def _float_unary(name, fn, bad=None, message=""):
    def exec_fn(args, options, ctx):
        (a,) = args = [as_float_operand(x) for x in args]
        t = a.dtype
        if not t.is_numeric:
            raise Invalid(f"{name}: expects numeric")
        out_t = t if t.is_floating else dt.float64
        (x,), validities, n = unpack(args, out_t)
        validity = intersect_validity(validities)
        if bad is not None:
            _raise_if(bad(x), f"{name}: {message}", validity)
        return result_column(fn(x), out_t, validity, n)

    return exec_fn


_UNARY = [
    ("ln", torch.log), ("log2", torch.log2), ("log10", torch.log10),
    ("log1p", torch.log1p), ("exp", torch.exp), ("expm1", torch.expm1),
    ("sqrt", torch.sqrt), ("sin", torch.sin), ("cos", torch.cos),
    ("tan", torch.tan), ("asin", torch.asin), ("acos", torch.acos),
    ("atan", torch.atan), ("sinh", torch.sinh), ("cosh", torch.cosh),
    ("tanh", torch.tanh), ("asinh", torch.asinh), ("acosh", torch.acosh),
    ("atanh", torch.atanh),
]
for _name, _fn in _UNARY:
    register_function(_name, "scalar", 1)(_float_unary(_name, _fn))

_NONPOSITIVE = "logarithm of non-positive"
for _name, _fn, _bad, _msg in [
    ("ln_checked", torch.log, lambda x: x <= 0, _NONPOSITIVE),
    ("log2_checked", torch.log2, lambda x: x <= 0, _NONPOSITIVE),
    ("log10_checked", torch.log10, lambda x: x <= 0, _NONPOSITIVE),
    ("log1p_checked", torch.log1p, lambda x: x <= -1, _NONPOSITIVE),
    ("sqrt_checked", torch.sqrt, lambda x: x < 0, "square root of negative"),
    ("asin_checked", torch.asin, lambda x: torch.abs(x) > 1,
     "domain error"),
    ("acos_checked", torch.acos, lambda x: torch.abs(x) > 1,
     "domain error"),
    ("acosh_checked", torch.acosh, lambda x: x < 1, "domain error"),
    ("atanh_checked", torch.atanh, lambda x: torch.abs(x) >= 1,
     "domain error"),
    ("sin_checked", torch.sin, None, ""),
    ("cos_checked", torch.cos, None, ""),
    ("tan_checked", torch.tan, None, ""),
]:
    register_function(_name, "scalar", 1)(
        _float_unary(_name, _fn, _bad, _msg))


def _float_out(args):
    return dt.float32 if all(a.dtype.kind == "float32" for a in args) \
        else dt.float64


def _float_binary(name, fn):
    def exec_fn(args, options, ctx):
        args = [as_float_operand(x) for x in args]
        out_t = _float_out(args)
        (x, y), validities, n = unpack(args, out_t)
        return result_column(fn(x, y), out_t, intersect_validity(validities),
                             n)

    return exec_fn


register_function("atan2", "scalar", 2)(_float_binary("atan2", torch.atan2))
register_function("hypot", "scalar", 2)(_float_binary("hypot", torch.hypot))


def _logb_exec(checked):
    def exec_fn(args, options, ctx):
        args = [as_float_operand(x) for x in args]
        (x, b), validities, n = unpack(args, dt.float64)
        dev = column_device(args)
        x, b = x.to(dev), b.to(dev)
        validity = intersect_validity(validities)
        if checked:
            _raise_if((x <= 0) | (b <= 0), f"logb: {_NONPOSITIVE}", validity)
        return result_column(torch.log(x) / torch.log(b), dt.float64,
                             validity, n)

    return exec_fn


register_function("logb", "scalar", 2)(_logb_exec(False))
register_function("logb_checked", "scalar", 2)(_logb_exec(True))


def _int_preserving(name, fn):
    """floor/ceil/trunc: the input's type; integers pass through, a
    decimal rounds exactly to an integer."""
    def exec_fn(args, options, ctx):
        (a,) = args
        t = a.dtype
        if t.is_decimal:
            return decimal_round(a, 0, {"floor": "down", "ceil": "up",
                                        "trunc": "towards_zero"}[name])
        if not t.is_numeric:
            raise Invalid(f"{name}: expects numeric")
        (x,), validities, n = unpack(args)
        r = fn(x) if t.is_floating else x
        return result_column(r, t, intersect_validity(validities), n)

    return exec_fn


register_function("floor", "scalar", 1)(_int_preserving("floor", torch.floor))
register_function("ceil", "scalar", 1)(_int_preserving("ceil", torch.ceil))
register_function("trunc", "scalar", 1)(_int_preserving("trunc", torch.trunc))


def _apply_round_mode(xs, mode):
    """Integral rounding of ``xs`` under one of the reference's ten round
    modes (scalar_round.cc RoundMode)."""
    fl = torch.floor(xs)
    if mode == "half_to_even":
        return torch.round(xs)   # half to even, arrow's default
    if mode == "half_to_odd":
        tie = (xs - fl) == 0.5
        odd = torch.where(torch.remainder(fl, 2) != 0, fl, fl + 1)
        return torch.where(tie, odd, torch.round(xs))
    if mode == "down":
        return fl
    if mode == "up":
        return torch.ceil(xs)
    if mode == "towards_zero":
        return torch.trunc(xs)
    if mode == "towards_infinity":
        return torch.where(xs >= 0, torch.ceil(xs), fl)
    if mode in ("half_away_from_zero", "half_towards_infinity"):
        return torch.trunc(xs + torch.where(xs >= 0, 0.5, -0.5))
    if mode == "half_towards_zero":
        return torch.where(xs >= 0, torch.ceil(xs - 0.5),
                           torch.floor(xs + 0.5))
    if mode == "half_up":
        return fl + torch.where((xs - fl) >= 0.5, 1.0, 0.0)
    if mode == "half_down":
        c = torch.ceil(xs)
        return c - torch.where((c - xs) >= 0.5, 1.0, 0.0)
    raise Invalid(f"round: unsupported mode {mode!r}")


def _round_int(x, d, mode):
    """Exact integer rounding to a power-of-ten boundary where ``d`` < 0
    (others unchanged), in int64 (reference: scalar_round.cc integer
    kernels). ``d`` may be one per row."""
    xi = x.to(torch.int64)
    d = torch.as_tensor(d, dtype=torch.int64, device=xi.device
                        ).expand(xi.shape)
    k = torch.clamp(-d, 0, 18)
    s = torch.pow(torch.full_like(k, 10), k)   # 10^18 fits int64
    q = torch.div(xi, s, rounding_mode="floor")
    r = xi - q * s                              # 0 <= r < s
    half = s // 2
    neg = xi < 0
    if mode == "down":
        add = torch.zeros_like(q, dtype=torch.bool)
    elif mode == "up":
        add = r > 0
    elif mode == "towards_zero":
        add = neg & (r > 0)
    elif mode == "towards_infinity":
        add = ~neg & (r > 0)
    elif mode == "half_to_even":
        add = (r > half) | ((r == half) & (torch.remainder(q, 2) != 0))
    elif mode == "half_to_odd":
        add = (r > half) | ((r == half) & (torch.remainder(q, 2) == 0))
    elif mode in ("half_away_from_zero", "half_towards_infinity"):
        add = torch.where(neg, r > half, r >= half)
    elif mode == "half_towards_zero":
        add = torch.where(neg, r >= half, r > half)
    elif mode == "half_up":
        add = r >= half
    elif mode == "half_down":
        add = r > half
    else:
        raise Invalid(f"round: unsupported mode {mode!r}")
    out = (q + add.to(torch.int64)) * s
    return torch.where(d < 0, out, xi).to(x.dtype)


def _round_exec(args, options: RoundOptions, ctx):
    (a,) = args
    options = options or RoundOptions()
    t = a.dtype
    if t.is_decimal:
        return decimal_round(a, options.ndigits, options.round_mode)
    if not t.is_numeric:
        raise Invalid("round: expects numeric")
    (x,), validities, n = unpack(args)
    validity = intersect_validity(validities)
    if not t.is_floating:
        r = _round_int(x, options.ndigits, options.round_mode) \
            if options.ndigits < 0 else x
        return result_column(r, t, validity, n)
    scale = torch.full((), 10.0 ** options.ndigits, dtype=x.dtype,
                       device=x.device)
    r = _apply_round_mode(x * scale, options.round_mode)
    return result_column(r / scale, t, validity, n)


register_function("round", "scalar", 1, RoundOptions)(_round_exec)


def _round_int_multiple(xi, s: int, mode):
    """int64 values rounded to a multiple ``s`` > 0 of an integer, exactly
    (the comparisons with s / 2 are made as 2 r against s)."""
    q = torch.div(xi, s, rounding_mode="floor")
    r2 = 2 * (xi - q * s)                       # 0 <= r < s
    neg = xi < 0
    pos = r2 > 0
    if mode == "down":
        add = torch.zeros_like(pos)
    elif mode == "up":
        add = pos
    elif mode == "towards_zero":
        add = neg & pos
    elif mode == "towards_infinity":
        add = ~neg & pos
    elif mode == "half_to_even":
        add = (r2 > s) | ((r2 == s) & (torch.remainder(q, 2) != 0))
    elif mode == "half_to_odd":
        add = (r2 > s) | ((r2 == s) & (torch.remainder(q, 2) == 0))
    elif mode in ("half_away_from_zero", "half_towards_infinity"):
        add = torch.where(neg, r2 > s, r2 >= s)
    elif mode == "half_towards_zero":
        add = torch.where(neg, r2 >= s, r2 > s)
    elif mode == "half_up":
        add = r2 >= s
    elif mode == "half_down":
        add = r2 > s
    else:
        raise Invalid(f"round: unsupported mode {mode!r}")
    return (q + add.to(torch.int64)) * s


def _round_to_multiple_exec(args, options: RoundToMultipleOptions, ctx):
    """Round to the nearest multiple of ``multiple`` (reference:
    RoundToMultiple, scalar_round.cc). Integers round exactly in int64 to
    an integral multiple, as pyarrow does (the reference goes through
    float64: ROADMAP Queue 3); a uint64 value past 2^63 does so only for
    a multiple of 1."""
    (a,) = args
    options = options or RoundToMultipleOptions()
    t = a.dtype
    if t.is_decimal:
        return decimal_round_to_multiple(a, options.multiple,
                                         options.round_mode)
    if not t.is_numeric:
        raise Invalid("round_to_multiple: expects numeric")
    m = float(options.multiple)
    if m <= 0:
        raise Invalid("round_to_multiple: multiple must be positive")
    (x,), validities, n = unpack(args)
    validity = intersect_validity(validities)
    if not t.is_floating and m == int(m):
        if m == 1:
            return result_column(x, t, validity, n)
        if t.kind != "uint64":
            out = _round_int_multiple(x.to(torch.int64), int(m),
                                      options.round_mode)
            return result_column(convert(out, dt.int64, t), t, validity, n)
    xf = x if t.is_floating else convert(x, t, dt.float64)
    mt = torch.full((), m, dtype=xf.dtype, device=xf.device)
    out = _apply_round_mode(xf / mt, options.round_mode) * mt
    if not t.is_floating:   # saturating, as the reference's conversion
        out = convert(out, dt.float64, t)
    return result_column(out, t, validity, n)


register_function("round_to_multiple", "scalar", 1, RoundToMultipleOptions)(
    _round_to_multiple_exec)


def _round_binary_exec(args, options: RoundBinaryOptions, ctx):
    """round(x, ndigits per row) (reference: round_binary,
    scalar_round.cc)."""
    a, _ = args
    options = options or RoundBinaryOptions()
    t = a.dtype
    if not t.is_numeric:
        raise Invalid("round_binary: expects numeric")
    (x, d), validities, n = unpack(args)
    dev = column_device(args)
    x, d = x.to(dev), d.to(dev)
    validity = intersect_validity(validities)
    if not t.is_floating:
        return result_column(_round_int(x, d, options.round_mode), t,
                             validity, n)
    scale = torch.pow(10.0, d.to(torch.float64))
    r = _apply_round_mode(x * scale, options.round_mode) / scale
    return result_column(r.to(x.dtype), t, validity, n)


register_function("round_binary", "scalar", 2, RoundBinaryOptions)(
    _round_binary_exec)
