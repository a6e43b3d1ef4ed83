"""Decimal arithmetic, compares, rounding and casts for decimal128 and
decimal256 (counterpart of arrow1_tpu/ops/decimal.py).

A decimal column holds its unscaled integer as 64-bit limbs (``data`` the
lowest, ``data2`` the rest: dtypes.py); the math is limb arithmetic of
ops/decimal256.py, element-wise torch operations on the column's device.
A decimal128 result is computed in two limbs, a decimal256 one in four
(a decimal128 operand is sign-extended).

Result types follow pyarrow (reference: compute/kernels/
scalar_arithmetic.cc decimal promotion): add and subtract give precision
max(p1 - s1, p2 - s2) + max(s1, s2) + 1 at the larger scale; multiply
(p1 + p2 + 1, s1 + s2); divide scale max(4, s1 + p2 - s2 + 1) and
precision p1 - s1 + s2 + that scale, the quotient truncated toward zero.
A precision past 38 (76 for decimal256) raises ``Invalid`` "Decimal
precision out of range", as pyarrow does (the JAX package caps it at 38).
An integer operand is the decimal of its type's digits at scale 0, a
float operand turns the decision over to float64 arithmetic, and a
``Scalar`` operand broadcasts (the JAX package fails on one: ROADMAP
Queue 3).
"""

from __future__ import annotations

import decimal as pydecimal
from typing import List, Optional

import torch

from .. import dtypes as dt
from ..column import Column, unscaled_ints
from ..datum import Scalar
from ..errors import Invalid
from . import decimal256 as L

__all__ = ["decimal_add", "decimal_subtract", "decimal_negate",
           "decimal_multiply", "decimal_divide", "decimal_compare",
           "decimal_to_float", "decimal_round", "decimal_round_to_multiple",
           "decimal_cast", "cast_to_decimal", "decimal_planes",
           "decimal_where", "column_limbs", "pack", "decimal_arith",
           "decimal_abs", "decimal_sign", "as_float_operand",
           "decimal_minmax_element_wise", "common_decimal_type",
           "limbs_from_digit_sums", "digit_planes", "mean_limbs",
           "group_extreme", "scalar_to_decimal", "INT_DIGITS"]

# digits of each integer type: its decimal operand is (digits, 0)
INT_DIGITS = {"int8": 3, "int16": 5, "int32": 10, "int64": 19,
              "uint8": 3, "uint16": 5, "uint32": 10, "uint64": 20}


def column_limbs(col: Column) -> List[torch.Tensor]:
    """A decimal column's limbs, least significant first."""
    if col.data2.dim() == 2:
        return [col.data] + list(col.data2.unbind(1))
    return [col.data, col.data2]


def pack(limbs: List[torch.Tensor], t: dt.DataType, validity) -> Column:
    """Limbs (at least ``t.limbs``; the extra sign limbs dropped) as a
    column of decimal type ``t``."""
    if t.kind == "decimal128":
        return Column(limbs[0], t, validity=validity, data2=limbs[1])
    return Column(limbs[0], t, validity=validity,
                  data2=torch.stack(limbs[1:4], 1))


def _decimal_type(wide: bool, precision: int, scale: int) -> dt.DataType:
    """decimal128 unless ``wide``; the constructor raises past its
    maximum precision, as pyarrow does."""
    return (dt.decimal256 if wide else dt.decimal128)(precision, scale)


def _as_decimal(x):
    """An integer column or scalar as the decimal of its type's digits at
    scale 0 (pyarrow's implicit cast); a decimal as it is."""
    t = x.dtype
    if t.is_decimal:
        return x
    if not t.is_integer:
        raise Invalid(f"decimal arithmetic with {t}")
    dtype = dt.decimal128(INT_DIGITS[t.kind], 0)
    if isinstance(x, Scalar):
        return Scalar(int(x.value) if x.is_valid else 0, dtype,
                      is_valid=x.is_valid)
    v = dt.as_int64(x.data)
    hi = torch.zeros_like(v) if t.kind == "uint64" else v >> 63
    return Column(v, dtype, validity=x.validity, data2=hi)


def _operand(x, n: int, nlimbs: int, scale: int, device):
    """(limbs at ``nlimbs`` and ``scale``, validity: None, False for a
    null scalar, or a bool tensor) of a decimal column or scalar."""
    if isinstance(x, Scalar):
        if not x.is_valid:
            return L.full(0, nlimbs, n, device), False
        return L.full(int(x.value) * 10 ** (scale - x.dtype.scale), nlimbs,
                      n, device), None
    limbs = L.widen(column_limbs(x), nlimbs)
    if scale > x.dtype.scale:
        limbs = L.mul_pow10(limbs, scale - x.dtype.scale)
    return limbs, x.validity


def _validity(*vs):
    if any(v is False for v in vs):
        return False
    vs = [v for v in vs if v is not None]
    if not vs:
        return None
    out = vs[0]
    for v in vs[1:]:
        out = out & v
    return out


def _length_device(args):
    for a in args:
        if isinstance(a, Column):
            return a.length, a.device
    return None, torch.device("cpu")


def _finish(limbs, t: dt.DataType, validity, n):
    """A Column, or a Scalar when every argument was a scalar."""
    if n is None:
        col = pack(limbs, t, None)
        v = unscaled_ints(col)[0]
        ok = validity is None or (validity is not False
                                  and bool(validity[0]))
        return Scalar(v, t, is_valid=ok)
    if validity is False:
        validity = torch.zeros(n, dtype=torch.bool, device=limbs[0].device)
    return pack(limbs, t, validity)


def as_float_operand(x):
    """A decimal column or scalar as float64 (pyarrow computes a decimal
    with a float, and the float functions of one, in float64)."""
    if isinstance(x, Scalar):
        if x.dtype.is_decimal:
            return Scalar(float(x.as_py()) if x.is_valid else 0.0,
                          dt.float64, is_valid=x.is_valid)
        return x
    return decimal_to_float(x) if x.dtype.is_decimal else x


def decimal_arith(name: str, args):
    """add, subtract, multiply, divide (and their ``_checked`` forms,
    which compute the same: a result within its precision cannot
    overflow) with a decimal argument."""
    base = name.replace("_checked", "")
    if any(a.dtype.is_floating for a in args):
        from ..registry import call_function

        return call_function(name, [as_float_operand(a) for a in args])
    a, b = (_as_decimal(x) for x in args)
    fn = {"add": decimal_add, "subtract": decimal_subtract,
          "multiply": decimal_multiply, "divide": decimal_divide}.get(base)
    if fn is None:
        raise Invalid(f"{name}: unsupported for decimal")
    return fn(a, b)


def _add_sub(a, b, subtract: bool):
    (p1, s1), (p2, s2) = (a.dtype.precision, a.dtype.scale), \
        (b.dtype.precision, b.dtype.scale)
    s = max(s1, s2)
    wide = "decimal256" in (a.dtype.kind, b.dtype.kind)
    t = _decimal_type(wide, max(p1 - s1, p2 - s2) + s + 1, s)
    n, dev = _length_device((a, b))
    m = 1 if n is None else n
    x, va = _operand(a, m, t.limbs, s, dev)
    y, vb = _operand(b, m, t.limbs, s, dev)
    r = L.sub(x, y) if subtract else L.add(x, y)
    return _finish(r, t, _validity(va, vb), n)


def decimal_add(a, b):
    return _add_sub(a, b, False)


def decimal_subtract(a, b):
    return _add_sub(a, b, True)


def decimal_negate(a):
    if isinstance(a, Scalar):
        return Scalar(-int(a.value), a.dtype, is_valid=a.is_valid)
    return pack(L.neg(column_limbs(a)), a.dtype, a.validity)


def decimal_abs(a):
    if isinstance(a, Scalar):
        return Scalar(abs(int(a.value)), a.dtype, is_valid=a.is_valid)
    return pack(L.abs_(column_limbs(a))[0], a.dtype, a.validity)


def decimal_sign(a) -> Column:
    """-1, 0 or 1 as int64, as pyarrow gives (the JAX package: int8)."""
    limbs = column_limbs(a)
    nonzero = limbs[0] != 0
    for x in limbs[1:]:
        nonzero = nonzero | (x != 0)
    r = torch.where(L.is_neg(limbs), -1, nonzero.to(torch.int64))
    return Column(r.to(torch.int64), dt.int64, validity=a.validity)


def decimal_multiply(a, b):
    wide = "decimal256" in (a.dtype.kind, b.dtype.kind)
    t = _decimal_type(wide, a.dtype.precision + b.dtype.precision + 1,
                      a.dtype.scale + b.dtype.scale)
    n, dev = _length_device((a, b))
    m = 1 if n is None else n
    x, va = _operand(a, m, t.limbs, a.dtype.scale, dev)
    y, vb = _operand(b, m, t.limbs, b.dtype.scale, dev)
    return _finish(L.mul(x, y), t, _validity(va, vb), n)


def decimal_divide(a, b):
    """The quotient truncated toward zero at pyarrow's scale; a zero
    divisor in a valid row raises "Divide by zero"."""
    (p1, s1), (p2, s2) = (a.dtype.precision, a.dtype.scale), \
        (b.dtype.precision, b.dtype.scale)
    s = max(4, s1 + p2 - s2 + 1)
    wide = "decimal256" in (a.dtype.kind, b.dtype.kind)
    t = _decimal_type(wide, p1 - s1 + s2 + s, s)
    n, dev = _length_device((a, b))
    m = 1 if n is None else n
    x, va = _operand(a, m, t.limbs, a.dtype.scale, dev)
    y, vb = _operand(b, m, t.limbs, b.dtype.scale, dev)
    validity = _validity(va, vb)
    zero = y[0] == 0
    for w in y[1:]:
        zero = zero & (w == 0)
    if validity is not False:
        live = zero if validity is None else zero & validity
        if bool(live.any()):
            raise Invalid("Divide by zero")
    ux, xneg = L.abs_(x)
    uy, yneg = L.abs_(y)
    ux = L.mul_pow10(ux, s - s1 + s2)   # the quotient lands at scale s
    uy[0] = torch.where(zero, 1, uy[0])   # dead rows: no zero divisor
    q = L.udiv(ux, uy)
    q = L.select(xneg != yneg, L.neg(q), q)
    return _finish(q, t, validity, n)


_OPS = ("equal", "not_equal", "less", "less_equal", "greater",
        "greater_equal")


def decimal_compare(a, b, op: str):
    """Compare at the common scale (and width); an integer operand is
    compared as a decimal, a float one in float64."""
    if op not in _OPS:
        raise Invalid(f"decimal compare: bad op {op}")
    if a.dtype.is_floating or b.dtype.is_floating:
        from ..registry import call_function

        return call_function(op, [as_float_operand(a),
                                  as_float_operand(b)])
    a, b = _as_decimal(a), _as_decimal(b)
    s = max(a.dtype.scale, b.dtype.scale)
    # the common type pyarrow casts both sides to, which raises past its
    # width's precision
    t = _decimal_type("decimal256" in (a.dtype.kind, b.dtype.kind),
                      max(a.dtype.precision - a.dtype.scale,
                          b.dtype.precision - b.dtype.scale) + s, s)
    nl = t.limbs
    n, dev = _length_device((a, b))
    m = 1 if n is None else n
    x, va = _operand(a, m, nl, s, dev)
    y, vb = _operand(b, m, nl, s, dev)
    lt, eq = L.cmp(x, y)
    r = {"equal": eq, "not_equal": ~eq, "less": lt, "less_equal": lt | eq,
         "greater": ~(lt | eq), "greater_equal": ~lt}[op]
    validity = _validity(va, vb)
    if n is None:
        return Scalar(bool(r[0]), dt.bool_, is_valid=validity is not False)
    if validity is False:
        validity = torch.zeros(n, dtype=torch.bool, device=dev)
    return Column(r, dt.bool_, validity=validity)


def decimal_minmax_element_wise(args, is_min: bool, skip_nulls: bool):
    """Element-wise min or max of decimal columns of one type (scalars
    rescale to it; pyarrow refuses two types), nulls skipped unless
    ``skip_nulls`` is false, the earlier argument kept on a tie."""
    types = {a.dtype for a in args if isinstance(a, Column)} or \
        {args[0].dtype}
    if len(types) != 1 or not all(a.dtype.is_decimal for a in args):
        raise Invalid("Different input types not supported for "
                      "{min, max}_element_wise")
    (t,) = types
    n, dev = _length_device(args)
    m = 1 if n is None else n
    acc, av = None, None
    for a in args:
        if isinstance(a, Scalar):
            x = L.full(scalar_to_decimal(a, t) or 0, t.limbs, m, dev)
            v = torch.full((m,), a.is_valid, dtype=torch.bool, device=dev)
        else:
            x, v = column_limbs(a), a.mask()
        if acc is None:
            acc, av = x, v
            continue
        lt, eq = L.cmp(x, acc)
        better = lt if is_min else ~(lt | eq)
        if skip_nulls:   # a null loses; a valid value beats a null
            take = v & (~av | better)
            av = av | v
        else:
            take = better
            av = av & v
        acc = L.select(take, x, acc)
    return _finish(acc, t, av, n)


def decimal_to_float(a: Column) -> Column:
    """float64 values (the JAX package's limb combination, bit for bit)."""
    return Column(L.to_float(column_limbs(a), a.dtype.scale), dt.float64,
                  validity=a.validity)


# ---- grouped sums and means ----------------------------------------------

def limbs_from_digit_sums(sums: List[torch.Tensor]) -> List[torch.Tensor]:
    """Per-group sums of each 32-bit digit (least significant first; each
    below 2^63) carried into the limbs of the exact sum (mod the width,
    which two's complement makes the signed sum)."""
    carry, digits = None, []
    for d in sums:
        tot = d if carry is None else d + carry
        digits.append(tot & L.M32)
        carry = tot >> 32
    return L.from_digits(digits)


def digit_planes(col: Column) -> List[torch.Tensor]:
    """A decimal column's 32-bit digits (``L.to_digits`` of its limbs),
    each an int64 plane that a group sum adds without wrapping."""
    return L.to_digits(column_limbs(col))


def mean_limbs(total: List[torch.Tensor], count: torch.Tensor):
    """total / count rounded half away from zero (0 < count < 2^31), as
    pyarrow's grouped decimal mean."""
    mag, negative = L.abs_(total)
    q, r = L.divmod_small(mag, count)
    up = (2 * r >= count).to(torch.int64)
    q = L.add(q, [up] + [torch.zeros_like(up)] * (len(q) - 1))
    return L.select(negative, L.neg(q), q)


def group_extreme(col: Column, gids: torch.Tensor, ngroups: int,
                  is_min: bool) -> List[torch.Tensor]:
    """Per-group min or max limbs (groups of no valid row read garbage):
    limb by limb from the top (its sign kept, the lower limbs unsigned
    through a flipped sign bit), each among the rows that tie on the limbs
    above (reference: groupby.py's lexicographic passes)."""
    limbs = column_limbs(col)
    gids = gids.to(torch.int64)
    sel = col.mask()
    how = "amin" if is_min else "amax"
    fill = torch.iinfo(torch.int64).max if is_min else \
        torch.iinfo(torch.int64).min
    out = [None] * len(limbs)
    for i in range(len(limbs) - 1, -1, -1):
        k = limbs[i] if i == len(limbs) - 1 else limbs[i] ^ L.SIGN
        acc = torch.full((ngroups,), fill, dtype=torch.int64,
                         device=k.device)
        acc.scatter_reduce_(0, gids, torch.where(sel, k, fill), how)
        sel = sel & (k == acc[gids])
        out[i] = acc if i == len(limbs) - 1 else acc ^ L.SIGN
    return out


# ---- rounding (reference: scalar_round.cc decimal kernels) ----------------

_ROUND_MODES = ("down", "up", "towards_zero", "towards_infinity",
                "half_down", "half_up", "half_towards_zero",
                "half_towards_infinity", "half_to_even", "half_to_odd",
                "half_away_from_zero")


def decimal_round(a: Column, ndigits: int, mode: str) -> Column:
    """Round to ``ndigits`` fractional digits; the type stays. As in
    pyarrow, ``ndigits`` must leave a digit of the type's whole part, and
    a rounded value past the precision raises."""
    t = a.dtype
    if ndigits <= -(t.precision - t.scale):
        raise Invalid(f"Rounding to {ndigits} digits will not fit in "
                      f"precision of {t}")
    k = t.scale - ndigits
    if k <= 0:
        return a
    return _round_to_divisor(a, 10 ** k, mode)


def decimal_round_to_multiple(a: Column, multiple, mode: str) -> Column:
    """Round each value to a multiple of ``multiple`` (a positive number
    representable at the column's scale); the type stays."""
    m = multiple.as_py() if isinstance(multiple, Scalar) else multiple
    m = m if isinstance(m, pydecimal.Decimal) else pydecimal.Decimal(str(m))
    if m <= 0:
        raise Invalid("round_to_multiple: multiple must be positive")
    scaled = m.scaleb(a.dtype.scale, pydecimal.Context(prec=100))
    if scaled != scaled.to_integral_value():
        raise Invalid("round_to_multiple: multiple must be representable "
                      f"at scale {a.dtype.scale}")
    if scaled >= 10 ** a.dtype.precision:
        raise Invalid(f"Decimal value does not fit in precision "
                      f"{a.dtype.precision}")
    return _round_to_divisor(a, int(scaled), mode)


def _udivmod_const(mag, d: int):
    """Unsigned (mag // d, mag % d) for a positive Python int d."""
    if d < 1 << 31:
        q, r = L.divmod_small(mag, d)
        return q, [r] + [torch.zeros_like(r)] * (len(mag) - 1)
    k = len(str(d)) - 1
    if d == 10 ** k:
        q, _ = L.div_pow10(mag, k)
    else:
        q = L.udiv(mag, L.full(d, len(mag), mag[0].shape[0],
                               mag[0].device))
    prod = L.mul(q, L.full(d, len(mag), mag[0].shape[0], mag[0].device))
    return q, L.sub(mag, prod)


def _round_to_divisor(a: Column, d: int, mode: str) -> Column:
    """|x| = q*d + r exactly; q moves up by one as the mode says; the
    result is sign * q * d."""
    if mode not in _ROUND_MODES:
        raise Invalid(f"round: unsupported mode {mode!r} for decimal")
    limbs = column_limbs(a)
    mag, negative = L.abs_(limbs)
    q, r = _udivmod_const(mag, d)
    frac = r[0] != 0
    for w in r[1:]:
        frac = frac | (w != 0)
    lt2, eq2 = L.ucmp(L.add(r, r), L.full(d, len(mag), a.length, a.device))
    gt, eq = ~(lt2 | eq2), eq2
    odd = (q[0] & 1) == 1
    inc = {"half_to_even": gt | (eq & odd),
           "half_to_odd": gt | (eq & ~odd),
           "half_away_from_zero": gt | eq,
           "half_towards_infinity": gt | eq,   # of the magnitude
           "half_towards_zero": gt,
           "half_up": gt | (eq & ~negative),
           "half_down": gt | (eq & negative),
           "towards_zero": torch.zeros_like(frac),
           "towards_infinity": frac,
           "up": frac & ~negative,
           "down": frac & negative}[mode]
    one = [inc.to(torch.int64)] + [torch.zeros_like(q[0])] * (len(q) - 1)
    q = L.add(q, one)
    out = L.mul(q, L.full(d, len(mag), a.length, a.device))
    if bool((~L.below_pow10(out, a.dtype.precision) & a.mask()).any()):
        raise Invalid(f"Rounded value does not fit in precision of "
                      f"{a.dtype}")
    out = L.select(negative, L.neg(out), out)
    return pack(out, a.dtype, a.validity)


# ---- planes and selection ------------------------------------------------

def decimal_planes(x, t: dt.DataType, n: int, device=None):
    """A decimal column or scalar as (data, data2) of type ``t`` (its
    scale and width), broadcast to n rows; rescaling down must be exact."""
    if isinstance(x, Column):
        if x.dtype != t:
            x = decimal_cast(x, t, allow_truncate=False, check_range=False)
        return x.data, x.data2
    v = int(x.value) if x.is_valid else 0
    ds = t.scale - x.dtype.scale
    if ds >= 0:
        v *= 10 ** ds
    else:
        v, r = divmod(v, 10 ** -ds)
        if r:
            raise Invalid(f"decimal scalar {x.as_py()} does not fit scale "
                          f"{t.scale}")
    limbs = L.full(v, t.limbs, n, device or torch.device("cpu"))
    col = pack(limbs, t, None)
    return col.data, col.data2


def decimal_where(c: torch.Tensor, l_planes, r_planes, t: dt.DataType):
    """Per-row select across every limb plane."""
    (llo, lhi), (rlo, rhi) = l_planes, r_planes
    c2 = c if lhi.dim() == 1 else c[:, None]
    return torch.where(c, llo, rlo), torch.where(c2, lhi, rhi)


def common_decimal_type(types) -> dt.DataType:
    """The type that holds every decimal (and integer) type of ``types``
    exactly: the largest whole digits plus the largest scale, decimal256
    when any is one or the precision passes 38."""
    decs = [t if t.is_decimal else dt.decimal128(INT_DIGITS[t.kind], 0)
            for t in types]
    s = max(t.scale for t in decs)
    p = max(t.precision - t.scale for t in decs) + s
    wide = any(t.kind == "decimal256" for t in decs) or p > 38
    return _decimal_type(wide, min(p, 76), s)


# ---- casts (reference: scalar_cast_numeric.cc decimal paths) --------------

def decimal_cast(a: Column, dst: dt.DataType, allow_truncate: bool,
                 check_range: bool = True) -> Column:
    """decimal -> decimal (rescale; lost digits raise unless
    ``allow_truncate``; a value past the target's precision raises, as
    pyarrow does) and decimal -> integer (past the type's range raises).
    An unsafe cast (``allow_truncate``) checks nothing and keeps the low
    limbs, as pyarrow's does."""
    src = a.dtype
    live = a.mask()
    mag, negative = L.abs_(L.widen(column_limbs(a), 4))
    if dst.is_decimal:
        if dst.scale > src.scale:
            mag = L.mul_pow10(mag, dst.scale - src.scale)
        elif dst.scale < src.scale:
            mag, lost = L.div_pow10(mag, src.scale - dst.scale)
            if not allow_truncate and bool((lost & live).any()):
                raise Invalid("Rescaling Decimal value would cause data "
                              "loss")
        if check_range and not allow_truncate and \
                bool((~L.below_pow10(mag, dst.precision) & live).any()):
            raise Invalid(f"Decimal value does not fit in precision "
                          f"{dst.precision}")
        out = L.select(negative, L.neg(mag), mag)
        if dst.kind == "decimal128" and not allow_truncate and \
                bool((~L.fits(out, 2) & live).any()):
            raise Invalid(f"value out of range for {dst}")
        return pack(out, dst, a.validity)
    if dst.is_integer:
        mag, lost = L.div_pow10(mag, src.scale)
        if not allow_truncate and bool((lost & live).any()):
            raise Invalid(f"Rescaling Decimal value would cause data loss "
                          f"casting to {dst}")
        out = L.select(negative, L.neg(mag), mag)
        v = out[0]
        if dst.kind == "uint64":
            ok = (out[1] == 0) & (out[2] == 0) & (out[3] == 0)
        else:
            info = torch.iinfo(dst.physical_dtype()) \
                if not dst.is_unsigned_integer else None
            lo, hi = (0, (1 << 8 * dst.numpy_dtype().itemsize) - 1) \
                if info is None else (info.min, info.max)
            ok = L.fits(out, 1) & (v >= lo) & (v <= hi)
        if not allow_truncate and bool((~ok & live).any()):
            raise Invalid(f"decimal value out of range for {dst}")
        if dst.kind in ("uint16", "uint32", "uint64"):   # the low bits
            bits = 8 * dst.numpy_dtype().itemsize
            v = v if bits == 64 else v & ((1 << bits) - 1)
            data = dt.from_int64(torch.where(live, v, 0),
                                 dst.physical_dtype())
        else:
            data = v.to(dst.physical_dtype())
        return Column(data, dst, validity=a.validity)
    raise Invalid(f"unsupported decimal cast {src} -> {dst}")


def cast_to_decimal(a: Column, dst: dt.DataType) -> Column:
    """integer -> decimal (the type's digits must fit the whole digits,
    as pyarrow's static check) and float -> decimal (rounded half to even
    at the target scale, as the JAX package does)."""
    src = a.dtype
    if src.is_integer:
        need = INT_DIGITS[src.kind]
        if dst.precision - dst.scale < need:
            raise Invalid(f"Precision is not great enough for the result. "
                          f"It should be at least {need + dst.scale}")
        col = _as_decimal(a)
        limbs = L.mul_pow10(L.widen(column_limbs(col), dst.limbs),
                            dst.scale)
        return pack(limbs, dst, a.validity)
    if src.is_floating:
        x = a.data.to(torch.float64)
        live = a.mask()
        scaled = torch.round(x * (10.0 ** dst.scale))
        bad = ~torch.isfinite(scaled) | (scaled.abs() >= 2.0 ** 63)
        if bool((bad & live).any()):
            raise Invalid(f"float value not representable as {dst}")
        v = torch.where(live, scaled, 0.0).to(torch.int64)
        limbs = L.widen([v], dst.limbs)
        if bool((~L.below_pow10(L.abs_(limbs)[0], dst.precision)
                 & live).any()):
            raise Invalid(f"Decimal value does not fit in precision "
                          f"{dst.precision}")
        return pack(limbs, dst, a.validity)
    raise Invalid(f"unsupported cast {src} -> {dst}")


def scalar_to_decimal(x: Scalar, t: dt.DataType) -> Optional[int]:
    """A scalar's unscaled integer at ``t``'s scale (None for null)."""
    if not x.is_valid:
        return None
    if x.dtype.is_decimal:
        v = x.as_py()
    else:
        v = pydecimal.Decimal(int(x.value))
    scaled = v.scaleb(t.scale, pydecimal.Context(prec=100))
    if scaled != scaled.to_integral_value():
        raise Invalid(f"decimal scalar {v} does not fit scale {t.scale}")
    return int(scaled)
