"""Boolean kernels: and/or/xor/and_not/invert and the Kleene variants
(counterpart of arrow1_tpu/ops/boolean.py).

  and_kleene:  false AND null -> false (valid);  true AND null -> null
  or_kleene:   true  OR  null -> true  (valid);  false OR null -> null
"""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..errors import Invalid
from ..registry import register_function
from .common import intersect_validity, result_column, unpack


def _check_bool(args, name):
    for a in args:
        if not a.dtype.is_boolean:
            raise Invalid(f"{name}: arguments must be boolean, got {a.dtype}")


def _binary_bool(name, op):
    def exec_fn(args, options, ctx):
        _check_bool(args, name)
        (x, y), validities, n = unpack(args)
        return result_column(op(x, y), dt.bool_,
                             intersect_validity(validities), n)

    return exec_fn


register_function("and", "scalar", 2, aliases=["and_"])(
    _binary_bool("and", torch.logical_and))
register_function("or", "scalar", 2, aliases=["or_"])(
    _binary_bool("or", torch.logical_or))
register_function("xor", "scalar", 2)(_binary_bool("xor", torch.logical_xor))
register_function("and_not", "scalar", 2)(
    _binary_bool("and_not", lambda x, y: x & ~y))


def _invert_exec(args, options, ctx):
    _check_bool(args, "invert")
    (x,), validities, n = unpack(args)
    return result_column(~x, dt.bool_, intersect_validity(validities), n)


register_function("invert", "scalar", 1)(_invert_exec)


def _mask_of(v, x):
    """Validity entry -> bool tensor broadcastable against x."""
    if v is None or v is False:
        return torch.tensor(v is None)
    return v


def _kleene(name, dominant: bool, negate_y: bool = False):
    """dominant=False for AND (false dominates), True for OR."""

    def exec_fn(args, options, ctx):
        _check_bool(args, name)
        (x, y), validities, n = unpack(args)
        if negate_y:
            y = ~y
        vx = _mask_of(validities[0], x)
        vy = _mask_of(validities[1], y)
        if dominant:
            r = (x & vx) | (y & vy)
            # valid iff either side is the dominant value, or both valid
            validity = (vx & x) | (vy & y) | (vx & vy)
        else:
            r = (x | ~vx) & (y | ~vy)
            validity = (vx & ~x) | (vy & ~y) | (vx & vy)
        if validities[0] is None and validities[1] is None:
            validity = None
        elif n is None:
            validity = bool(validity)
        return result_column(r, dt.bool_, validity, n)

    return exec_fn


register_function("and_kleene", "scalar", 2)(
    _kleene("and_kleene", dominant=False))
register_function("or_kleene", "scalar", 2)(
    _kleene("or_kleene", dominant=True))
register_function("and_not_kleene", "scalar", 2)(
    _kleene("and_not_kleene", dominant=False, negate_y=True))
