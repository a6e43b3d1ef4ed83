"""Limb arithmetic for both decimal widths (counterpart of
arrow1_tpu/ops/decimal256.py, whose four-limb add, subtract, multiply,
divide, compare and float conversion it holds, and of the two-limb
helpers the JAX package keeps in ops/decimal.py): one width-generic set,
which ops/decimal.py calls with two limbs for decimal128 and four for
decimal256.

A decimal's unscaled integer is a list of int64 tensors, its 64-bit limbs
least significant first, in two's complement: two limbs for decimal128,
four for decimal256 (reference: util/basic_decimal.h). torch has no
unsigned add, compare or shift for uint64 on the CPU (ROADMAP, u64 rules),
so a limb is an int64 holding the unsigned bits: an unsigned compare flips
the sign bit of both sides first, a logical right shift masks the bits
that the arithmetic shift brings in, carries come from those compares,
and a 64 x 64 product is built from 32-bit halves (int64 products wrap as
the unsigned ones do). Every function is a short, fixed sequence of
element-wise torch operations on the column's device, except the general
division (``udiv``), whose loop runs one step per quotient bit.
"""

from __future__ import annotations

from typing import List, Tuple

import torch

__all__ = ["ult", "shr", "const_limbs", "full", "widen", "add", "neg", "sub",
           "select", "is_neg", "abs_", "cmp", "ucmp", "mul64", "mul",
           "to_digits", "from_digits", "mul_small", "mul_pow10",
           "divmod_small", "div_pow10", "udiv", "to_float", "fits",
           "below_pow10"]

Limbs = List[torch.Tensor]
SIGN = -(1 << 63)
M32 = 0xFFFFFFFF
_TWO32 = float(1 << 32)
_TWO64 = float(1 << 64)


def ult(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a < b as unsigned 64-bit values."""
    return (a ^ SIGN) < (b ^ SIGN)


def shr(a: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift by 0 < k < 64."""
    return (a >> k) & ((1 << (64 - k)) - 1)


def const_limbs(v: int, n: int) -> List[int]:
    """A Python int as n limbs of int64 values (two's complement)."""
    out = []
    for _ in range(n):
        w = v & 0xFFFFFFFFFFFFFFFF
        out.append(w - (1 << 64) if w >> 63 else w)
        v >>= 64
    return out


def full(v: int, n: int, length: int, device) -> Limbs:
    return [torch.full((length,), w, dtype=torch.int64, device=device)
            for w in const_limbs(v, n)]


def widen(a: Limbs, n: int) -> Limbs:
    """Sign-extend to n limbs."""
    if len(a) >= n:
        return list(a)
    sign = a[-1] >> 63
    return list(a) + [sign] * (n - len(a))


def add(a: Limbs, b: Limbs) -> Limbs:
    out, carry = [], None
    for x, y in zip(a, b):
        s = x + y
        c = ult(s, x)
        if carry is not None:
            s2 = s + carry
            c = c | ult(s2, s)
            s = s2
        out.append(s)
        carry = c.to(torch.int64)
    return out


def neg(a: Limbs) -> Limbs:
    """-a: every bit inverted, then one added with its carry."""
    out, carry = [], None
    for x in a:
        if carry is None:
            y = ~x + 1
            carry = (y == 0).to(torch.int64)
        else:
            y = ~x + carry
            carry = ((y == 0) & (carry == 1)).to(torch.int64)
        out.append(y)
    return out


def sub(a: Limbs, b: Limbs) -> Limbs:
    return add(a, neg(b))


def select(cond: torch.Tensor, a: Limbs, b: Limbs) -> Limbs:
    return [torch.where(cond, x, y) for x, y in zip(a, b)]


def is_neg(a: Limbs) -> torch.Tensor:
    return a[-1] < 0


def abs_(a: Limbs) -> Tuple[Limbs, torch.Tensor]:
    """(|a| as unsigned limbs, a < 0)."""
    n = is_neg(a)
    return select(n, neg(a), a), n


def cmp(a: Limbs, b: Limbs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a < b, a == b) as signed integers."""
    lt = a[-1] < b[-1]
    eq = a[-1] == b[-1]
    for i in range(len(a) - 2, -1, -1):
        lt = lt | (eq & ult(a[i], b[i]))
        eq = eq & (a[i] == b[i])
    return lt, eq


def ucmp(a: Limbs, b: Limbs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a < b, a == b) as unsigned integers."""
    lt = ult(a[-1], b[-1])
    eq = a[-1] == b[-1]
    for i in range(len(a) - 2, -1, -1):
        lt = lt | (eq & ult(a[i], b[i]))
        eq = eq & (a[i] == b[i])
    return lt, eq


def mul64(a: torch.Tensor, b: torch.Tensor):
    """Unsigned 64 x 64 -> (hi, lo) through 32-bit halves."""
    a0, a1 = a & M32, shr(a, 32)
    b0, b1 = b & M32, shr(b, 32)
    ll = a0 * b0
    mid = a0 * b1 + shr(ll, 32) + ((a1 * b0) & M32)   # fits 64 bits
    lo = (mid << 32) | (ll & M32)
    hi = a1 * b1 + shr(mid, 32) + shr(a1 * b0, 32)
    return hi, lo


def _add_at(out: Limbs, k: int, v: torch.Tensor) -> None:
    """out += v * 2^(64k), the carry rippling up (mod 2^(64 len))."""
    carry = v
    for i in range(k, len(out)):
        s = out[i] + carry
        nxt = ult(s, carry).to(torch.int64)
        out[i] = s
        carry = nxt


def mul(a: Limbs, b: Limbs) -> Limbs:
    """a * b mod 2^(64n): two's complement makes the signed product
    exact whenever it fits."""
    n = len(a)
    if n == 2:
        hi, lo = mul64(a[0], b[0])
        return [lo, hi + a[0] * b[1] + a[1] * b[0]]
    out = [torch.zeros_like(a[0]) for _ in range(n)]
    for i in range(n):
        for j in range(n - i):
            hi, lo = mul64(a[i], b[j])
            _add_at(out, i + j, lo)
            if i + j + 1 < n:
                _add_at(out, i + j + 1, hi)
    return out


def to_digits(a: Limbs) -> Limbs:
    """Unsigned limbs -> 32-bit digits, least significant first."""
    out = []
    for x in a:
        out += [x & M32, shr(x, 32)]
    return out


def from_digits(d: Limbs) -> Limbs:
    return [d[i] | (d[i + 1] << 32) for i in range(0, len(d), 2)]


def mul_small(a: Limbs, k: int) -> Limbs:
    """a * k mod 2^(64n) for 0 <= k < 2^31 (any sign of a)."""
    out, carry = [], None
    for d in to_digits(a):
        t = d * k if carry is None else d * k + carry
        out.append(t & M32)
        carry = t >> 32
    return from_digits(out)


def mul_pow10(a: Limbs, k: int) -> Limbs:
    while k > 0:
        step = min(k, 9)
        a = mul_small(a, 10 ** step)
        k -= step
    return a


def divmod_small(a: Limbs, d):
    """Unsigned a // d and a % d for 0 < d < 2^31 (a Python int or an
    int64 tensor per row): long division by 32-bit digits, most
    significant first; each partial stays below d * 2^32 < 2^63."""
    digits = to_digits(a)
    q = [None] * len(digits)
    rem = torch.zeros_like(a[0])
    for i in range(len(digits) - 1, -1, -1):
        cur = (rem << 32) | digits[i]
        q[i] = torch.div(cur, d, rounding_mode="trunc")
        rem = cur - q[i] * d
    return from_digits(q), rem


def div_pow10(a: Limbs, k: int):
    """Unsigned (a // 10^k, a % 10^k != 0)."""
    lost = torch.zeros(a[0].shape, dtype=torch.bool, device=a[0].device)
    while k > 0:
        step = min(k, 9)
        a, rem = divmod_small(a, 10 ** step)
        lost = lost | (rem != 0)
        k -= step
    return a, lost


def udiv(n: Limbs, d: Limbs) -> Limbs:
    """Unsigned truncated quotient n // d (d != 0). Every divisor below
    2^31 (one host read) takes the digit long division; any other takes
    restoring division, one step per bit of the widest n (the JAX
    package's ``_div128``/``_div4`` loop runs every bit of the width;
    the quotient is the same)."""
    small = (d[0] >= 0) & (d[0] < 1 << 31)
    for x in d[1:]:
        small = small & (x == 0)
    # one host read: whether every divisor is small, and each limb's
    # largest unsigned value of n and of d (the steps start at n's widest
    # bit; the remainder, below 2d, needs only d's widest limbs and one
    # bit)
    flags = torch.stack([small.all().to(torch.int64)] +
                        [(x ^ SIGN).max() if x.numel() else
                         x.new_tensor(SIGN) for x in n + d]).tolist()
    if flags[0]:
        return divmod_small(n, d[0])[0]
    w = len(n)

    def bit_width(maxima):
        return max([64 * i + ((m ^ SIGN) & 0xFFFFFFFFFFFFFFFF).bit_length()
                    for i, m in enumerate(maxima) if m != SIGN] + [0])

    width = bit_width(flags[1:1 + w])
    rl = min(w, bit_width(flags[1 + w:]) // 64 + 1)
    d = d[:rl]
    r = [torch.zeros_like(n[0]) for _ in range(rl)]
    q = [torch.zeros_like(n[0]) for _ in range(w)]
    for bit in range(width - 1, -1, -1):
        li, off = divmod(bit, 64)
        for i in range(rl - 1, 0, -1):
            r[i] = (r[i] << 1) | shr(r[i - 1], 63)
        r[0] = (r[0] << 1) | (shr(n[li], off) & 1 if off else n[li] & 1)
        lt, _ = ucmp(r, d)
        r = select(lt, r, sub(r, d))
        q[li] = q[li] | ((~lt).to(torch.int64) << off)
    return q


def _u64_to_float(x: torch.Tensor) -> torch.Tensor:
    """An unsigned limb as float64, rounded once (as numpy's uint64
    conversion): its two 32-bit halves are exact."""
    return shr(x, 32).to(torch.float64) * _TWO32 + (x & M32).to(
        torch.float64)


def to_float(a: Limbs, scale: int) -> torch.Tensor:
    """The value as float64: the magnitude's limbs as the JAX package
    combines them (each limb rounded, then m * 2^64 + limb from the top),
    the sign, then one division by 10^scale (a tensor divisor: the card
    divides by a Python number as a product with its reciprocal)."""
    mag, negative = abs_(a)
    val = _u64_to_float(mag[-1])
    for x in reversed(mag[:-1]):
        val = val * _TWO64 + _u64_to_float(x)
    val = torch.where(negative, -val, val)
    return val / torch.tensor(10.0 ** scale, dtype=torch.float64,
                              device=val.device)


def fits(a: Limbs, n: int) -> torch.Tensor:
    """Whether the value fits n limbs (the rest is its sign extension)."""
    sign = a[n - 1] >> 63
    ok = torch.ones_like(a[0], dtype=torch.bool)
    for x in a[n:]:
        ok = ok & (x == sign)
    return ok


def below_pow10(mag: Limbs, p: int) -> torch.Tensor:
    """Unsigned mag < 10^p."""
    lt, _ = ucmp(mag, [torch.full_like(mag[0], w)
                       for w in const_limbs(10 ** p, len(mag))])
    return lt
