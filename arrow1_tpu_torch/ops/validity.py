"""Validity kernels: is_valid/is_null/is_nan/is_finite/is_inf,
true_unless_null, fill_null, coalesce and if_else (counterpart of
arrow1_tpu/ops/validity.py).

Reference: cpp/src/arrow/compute/kernels/scalar_validity.cc,
scalar_fill_null.cc and scalar_if_else.cc. is_valid and is_null carry no
validity (NullHandling::OUTPUT_NOT_NULL): a null slot reports
is_null=true. is_nan, is_finite and is_inf keep the input's nulls.
Dictionary-encoded strings with different pools are unified before their
codes are mixed. Decimal columns come with a later slice (their type
raises at construction).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column, Dictionary
from ..datum import Scalar
from ..errors import Invalid
from ..registry import register_function
from .cast import convert
from .common import broadcast_length, column_device, result_column, \
    unpack, value_of
from .decimal import common_decimal_type, decimal_planes, decimal_where
from .dictionary import one_pool

__all__ = ["NullOptions"]


@dataclasses.dataclass
class NullOptions:
    """Reference: api_scalar.h NullOptions (nan_is_null)."""

    nan_is_null: bool = False


def _is_valid_exec(args, options, ctx):
    (a,) = args
    if isinstance(a, Scalar):
        return Scalar(a.is_valid, dt.bool_)
    if a.validity is None:
        return Column(torch.ones(a.length, dtype=torch.bool,
                                 device=a.device), dt.bool_)
    return Column(a.validity, dt.bool_)


def _is_null_exec(args, options: NullOptions, ctx):
    (a,) = args
    nan_too = bool(options and options.nan_is_null)
    if isinstance(a, Scalar):
        null = not a.is_valid or (nan_too and a.dtype.is_floating
                                  and bool(np.isnan(a.as_py())))
        return Scalar(null, dt.bool_)
    r = torch.zeros(a.length, dtype=torch.bool, device=a.device) \
        if a.validity is None else ~a.validity
    if nan_too and a.dtype.is_floating:
        r = r | torch.isnan(a.data)
    return Column(r, dt.bool_)


def _float_pred(name, fn):
    def exec_fn(args, options, ctx):
        (a,) = args
        (x,), validities, n = unpack(args)
        if a.dtype.is_floating:
            r = fn(x)
        elif n is None:
            r = torch.tensor(name == "is_finite")
        else:
            r = torch.full(x.shape, name == "is_finite", dtype=torch.bool,
                           device=x.device)
        return result_column(r, dt.bool_, validities[0], n)

    return exec_fn


register_function("is_valid", "scalar", 1)(_is_valid_exec)
register_function("is_null", "scalar", 1, NullOptions)(_is_null_exec)
register_function("is_nan", "scalar", 1)(_float_pred("is_nan", torch.isnan))
register_function("is_finite", "scalar", 1)(
    _float_pred("is_finite", torch.isfinite))
register_function("is_inf", "scalar", 1)(_float_pred("is_inf", torch.isinf))


def _string_value(s: Scalar):
    return s.dictionary.values[int(s.value)] if s.dictionary is not None \
        else s.value


def _fill_null_exec(args, options, ctx):
    """fill_null(values, fill_value): reference scalar_fill_null.cc."""
    values, fill = args
    if isinstance(values, Scalar):
        return values if values.is_valid else fill
    if values.validity is None:
        return values
    keep = values.validity
    if values.dtype.is_decimal:   # every limb, the fill rescaled
        if isinstance(fill, Scalar) and not fill.is_valid:
            return values
        lo, hi = decimal_planes(fill, values.dtype, values.length,
                                values.device)
        data, data2 = decimal_where(keep, (values.data, values.data2),
                                    (lo, hi), values.dtype)
        validity = keep | fill.validity if isinstance(fill, Column) and \
            fill.validity is not None else None
        return Column(data, values.dtype, validity=validity, data2=data2)
    if isinstance(fill, Column):
        if values.dtype.is_binary:
            vc, fc = one_pool([values, fill], values.length, values.device)
            validity = None if fill.validity is None else \
                keep | fill.validity
            return Column(torch.where(keep, vc.data, fc.data), values.dtype,
                          validity=validity, dictionary=vc.dictionary)
        fv = convert(fill.data, fill.dtype, values.dtype)
        out = torch.where(keep, values.data, fv)
        if fill.validity is not None:
            return Column(out, values.dtype, validity=keep | fill.validity)
        return Column(out, values.dtype)
    if not fill.is_valid:
        return values
    if values.dtype.is_binary:
        # the fill value joins the pool when it is not in it
        d = values.dictionary
        sval = _string_value(fill)
        if sval in d.index:
            code, pool = d.index[sval], d
        else:
            pool = Dictionary(np.concatenate(
                [d.values, np.array([sval], dtype=object)]))
            code = len(d)
        return Column(torch.where(keep, values.data,
                                  torch.tensor(code, dtype=values.data.dtype,
                                               device=values.device)),
                      values.dtype, dictionary=pool)
    fv = value_of(fill, values.dtype).to(values.device)
    return Column(torch.where(keep, values.data, fv), values.dtype)


register_function("fill_null", "scalar", 2)(_fill_null_exec)


def _coalesce_exec(args, options, ctx):
    """coalesce(*args): the first non-null value of each slot."""
    out = args[0]
    for nxt in args[1:]:
        out = _fill_null_exec([out, nxt], None, ctx)
    return out


register_function("coalesce", "scalar", -1)(_coalesce_exec)


def _validity_of(a):
    if isinstance(a, Column):
        return a.validity
    return None if a.is_valid else False


def _as_mask(v, like):
    """A validity entry (None, False or a mask) as a bool tensor."""
    if v is None or v is False:
        return torch.full(like.shape, v is None, dtype=torch.bool,
                          device=like.device)
    return v


def _if_else_exec(args, options, ctx):
    """if_else(cond, left, right): reference scalar_if_else.cc (5.0.0). A
    null condition gives null; otherwise the chosen side's value and
    validity."""
    cond, left, right = args
    if not cond.dtype.is_boolean:
        raise Invalid("if_else: condition must be boolean")
    out_t = left.dtype if not isinstance(left, Scalar) or left.is_valid \
        else right.dtype
    n = broadcast_length(args)
    dev = column_device(args)
    c = value_of(cond).to(dev)
    dictionary = data2 = None
    if out_t.is_decimal:
        out_t = common_decimal_type([left.dtype, right.dtype])
        c = c.expand(n or 1)
        lv, l2 = decimal_planes(left, out_t, n or 1, dev)
        rv, r2 = decimal_planes(right, out_t, n or 1, dev)
        data, data2 = decimal_where(c, (lv, l2), (rv, r2), out_t)
        if n is None:
            raise Invalid("if_else: decimal scalars need an array argument")
    elif out_t.is_binary:
        lc, rc = one_pool([left, right], n or 1, dev)
        lv, rv, dictionary = lc.data, rc.data, lc.dictionary
    else:
        lv = value_of(left, out_t).to(dev)
        rv = value_of(right, out_t).to(dev)
    if data2 is None:
        data = torch.where(c, lv, rv)
    vc, vl, vr = (_validity_of(a) for a in args)
    validity = None
    if vl is not None or vr is not None:
        validity = torch.where(c, _as_mask(vl, data), _as_mask(vr, data))
    if vc is not None:
        validity = _as_mask(vc, data) if validity is None else \
            validity & _as_mask(vc, data)
    if n is None:
        validity = None if validity is None else bool(validity)
        return Scalar(data, out_t, is_valid=validity is not False,
                      dictionary=dictionary)
    out = result_column(data, out_t, validity, n, dictionary=dictionary)
    if data2 is not None:
        out.data2 = data2
    return out


register_function("if_else", "scalar", 3)(_if_else_exec)


def _true_unless_null_exec(args, options, ctx):
    """true for valid rows, null for nulls (reference: scalar_validity.cc
    TrueUnlessNull)."""
    (col,) = args
    return Column(torch.ones(col.length, dtype=torch.bool, device=col.device),
                  dt.bool_, validity=col.validity)


register_function("true_unless_null", "scalar", 1)(_true_unless_null_exec)
