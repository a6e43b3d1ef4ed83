"""Cumulative vector kernels: cumulative_sum/prod/min/max/mean with the
``_checked`` sums and products, pairwise_diff(_checked) and
fill_null_forward/backward (counterpart of arrow1_tpu/ops/cumulative.py).

Reference: compute/kernels/vector_cumulative_ops.cc, vector_pairwise.cc
and vector_replace.cc. Each is a scan: ``torch.cumsum``,
``torch.cumprod`` or ``torch.cummin``/``cummax``; the null fills count
the valid rows with ``torch.cumsum`` and gather from the valid rows'
positions (``torch.cummax`` of positions is many times slower on the
card). Nulls: with skip_nulls=False (the
default) the first null nulls every later slot; with skip_nulls=True a
null slot stays null and does not interrupt the scan.

Integers scan in int64 and wrap to their type (uint64 as its bit
pattern; its min and max with the sign bit flipped). Where the reference
and pyarrow disagree the port follows pyarrow (ROADMAP Queue 3): the
``_checked`` forms raise on overflow; a float min or max skips NaN, and
starts from pyarrow's identities, the largest finite value for the min
and the smallest positive normal one for the max (the reference keeps
the latter).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..registry import register_function
from .arithmetic import _mul_overflow, _raise_if, _sub_overflow
from .cast import convert, int_range
from .common import as_int64, minmax_domain
from .decimal import decimal_subtract
from .selection import take_column

__all__ = ["CumulativeOptions", "CumulativeSumOptions", "PairwiseOptions"]


@dataclasses.dataclass
class CumulativeOptions:
    start: object = None
    skip_nulls: bool = False


# pyarrow's older name for the same options
CumulativeSumOptions = CumulativeOptions


@dataclasses.dataclass
class PairwiseOptions:
    period: int = 1


def _wrap(r64: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """int64 results back to ``t``'s storage, wrapping at its width."""
    return convert(r64, dt.int64, t) if t.kind != "uint64" \
        else r64.view(torch.uint64)


def _sum_overflow(prev, x, r, t):
    """Per step of an int64 running sum r = prev + x (wrapped): did the
    step leave ``t``'s range?"""
    if t.kind == "uint64":   # unsigned: the sum wrapped below prev
        return (r ^ (-(1 << 63))) < (prev ^ (-(1 << 63)))
    if t.kind == "int64":
        return ((x > 0) & (prev > 0) & (r < 0)) | \
            ((x < 0) & (prev < 0) & (r >= 0))
    lo, hi = int_range(t)
    return (r < lo) | (r > hi)


def _prod_overflow(prev, x, r, t):
    """Per step of an int64 running product r = prev * x (wrapped): did
    the step leave ``t``'s range?"""
    if t.kind not in ("int64", "uint64"):   # no int64 product wraps
        lo, hi = int_range(t)
        return (r < lo) | (r > hi)
    return _mul_overflow(prev, x, r, t)


def _live(valid, skip_nulls: bool):
    """The output's validity: the input's with skip_nulls, else valid only
    before the first null (no null up to the row)."""
    if valid is None or skip_nulls:
        return valid
    return torch.cumsum((~valid).to(torch.int32), 0) == 0


def _steps(r, init):
    """The running value before each step: init, then r[:-1]."""
    return torch.cat([init.reshape(1), r[:-1]])


def _scan_float_extreme(x, init, is_min):
    """Running min or max from ``init`` that skips NaN (pyarrow: a NaN is
    never less or greater)."""
    y = torch.where(torch.isnan(x), init, x)
    if is_min:
        return torch.minimum(torch.cummin(y, 0).values, init)
    return torch.maximum(torch.cummax(y, 0).values, init)


def _cumulative(name):
    base = name.replace("_checked", "")
    checked = name.endswith("_checked")

    def exec_fn(args, options: CumulativeOptions, ctx):
        (a,) = args
        options = options or CumulativeOptions()
        t = a.dtype
        if not t.is_numeric:
            raise Invalid(f"{name}: expects numeric")
        valid = a.validity
        dev = a.device
        start = options.start
        if base == "cumulative_mean":
            x = convert(a.data, t, dt.float64) if not t.is_floating \
                else a.data
            xin = x if valid is None else torch.where(valid, x, 0.0)
            cnt = torch.arange(1, a.length + 1, dtype=xin.dtype,
                               device=dev) if valid is None else \
                torch.cumsum(valid.to(xin.dtype), 0)
            r = torch.cumsum(xin, 0) / torch.clamp(cnt, min=1)
            out_t = t if t.is_floating else dt.float64
        elif t.is_floating:
            x = a.data
            if base in ("cumulative_sum", "cumulative_prod"):
                neutral = 0.0 if base == "cumulative_sum" else 1.0
                xin = x if valid is None else torch.where(valid, x, neutral)
                r = torch.cumsum(xin, 0) if base == "cumulative_sum" \
                    else torch.cumprod(xin, 0)
                if start is not None:
                    r = r + start if base == "cumulative_sum" else r * start
            else:
                info = torch.finfo(x.dtype)
                is_min = base == "cumulative_min"
                ident = info.max if is_min else info.tiny
                init = torch.tensor(ident if start is None else start,
                                    dtype=x.dtype, device=dev)
                xin = x if valid is None else torch.where(valid, x, init)
                r = _scan_float_extreme(xin, init, is_min)
            out_t = t
        else:
            x64 = as_int64(a.data)
            if base in ("cumulative_sum", "cumulative_prod"):
                is_sum = base == "cumulative_sum"
                neutral = 0 if is_sum else 1
                init = torch.tensor(neutral if start is None else int(start),
                                    dtype=torch.int64, device=dev)
                xin = x64 if valid is None else torch.where(valid, x64,
                                                            neutral)
                if is_sum:
                    r = torch.cumsum(xin, 0) + init
                else:
                    r = torch.cumprod(xin, 0) * init
                if checked and a.length:
                    prev = _steps(r, init)
                    bad = (_sum_overflow if is_sum else _prod_overflow)(
                        prev, xin, r, t)
                    _raise_if(bad, f"{name}: overflow",
                              _live(valid, options.skip_nulls))
                r = _wrap(r, t)
            else:
                is_min = base == "cumulative_min"
                dom, back = minmax_domain(a.data)
                info = np.iinfo(t.numpy_dtype())
                first = (info.max if is_min else info.min) if start is None \
                    else int(start)
                init = minmax_domain(torch.tensor(
                    [first], dtype=t.physical_dtype(), device=dev))[0]
                xin = dom if valid is None else torch.where(valid, dom, init)
                if is_min:
                    r = torch.minimum(torch.cummin(xin, 0).values, init)
                else:
                    r = torch.maximum(torch.cummax(xin, 0).values, init)
                r = back(r)
            out_t = t
        if valid is None:
            return Column(r, out_t)
        return Column(r, out_t, validity=_live(valid, options.skip_nulls))

    return exec_fn


for _n in ("cumulative_sum", "cumulative_sum_checked", "cumulative_prod",
           "cumulative_prod_checked", "cumulative_min", "cumulative_max",
           "cumulative_mean"):
    register_function(_n, "vector", 1, CumulativeOptions)(_cumulative(_n))


def _pairwise_diff(checked):
    def exec_fn(args, options: PairwiseOptions, ctx):
        """x[i] - x[i - period]; null where either is null or i - period
        is out of range (reference: vector_pairwise.cc). A temporal
        column gives durations: date32 duration[s] (its days scaled),
        date64 duration[ms], the others a duration of their unit."""
        (a,) = args
        options = options or PairwiseOptions()
        p = int(options.period)
        t = a.dtype
        if not t.is_numeric and not t.is_temporal and not t.is_decimal:
            raise Invalid("pairwise_diff: expects numeric")
        n = a.length
        dev = a.device
        src = torch.arange(n, device=dev) - p
        in_range = (src >= 0) & (src < n)
        src_c = src.clamp(0, max(n - 1, 0))
        valid = in_range
        if a.validity is not None:
            valid = valid & a.validity & a.validity[src_c]
        if t.is_decimal:   # exact, the decimal subtract's type
            d = decimal_subtract(Column(a.data, t, data2=a.data2),
                                 take_column(a, src_c))
            return Column(d.data, d.dtype, validity=valid, data2=d.data2)
        x64 = None if t.is_floating else as_int64(a.data)
        if t.is_temporal:
            if t.kind == "date32":
                x64, t = x64 * 86400, dt.duration("s")
            else:
                t = dt.duration("ms" if t.kind == "date64" else t.unit)
        if t.is_floating:
            r = a.data - a.data[src_c]
        else:
            y64 = x64[src_c]
            r64 = x64 - y64
            if checked:
                bad = _sub_overflow(x64, y64, r64, t) if t.kind in (
                    "int64", "uint64", "duration") else _sum_overflow(
                        x64, -y64, r64, t)
                _raise_if(bad, "pairwise_diff_checked: overflow", valid)
            r = _wrap(r64, t)
        return Column(r, t, validity=valid)

    return exec_fn


register_function("pairwise_diff", "vector", 1, PairwiseOptions)(
    _pairwise_diff(False))
register_function("pairwise_diff_checked", "vector", 1, PairwiseOptions)(
    _pairwise_diff(True))


def _fill_null_directional(backward: bool):
    def exec_fn(args, options, ctx):
        """Each null takes the last (forward) or next (backward) valid
        value; leading (trailing) nulls stay null (reference:
        vector_replace.cc FillNullForward/Backward)."""
        (a,) = args
        if a.validity is None:
            return a
        valid = a.validity
        # the valid rows' positions, and for each row the count of valid
        # rows up to it (before it, looking backward): the last (next)
        # valid row is one gather away
        pos = torch.nonzero(valid).reshape(-1)
        seen = torch.cumsum(valid.to(torch.int64), 0)
        if backward:
            k = seen - valid.to(torch.int64)   # valid rows before the row
            has = k < pos.shape[0]
        else:
            k = seen - 1
            has = k >= 0
        src = pos[k.clamp(0, max(pos.shape[0] - 1, 0))] if pos.numel() \
            else torch.zeros_like(k)
        data = torch.where(has, a.data[src], a.data)
        data2 = None if a.data2 is None else torch.where(
            has if a.data2.dim() == 1 else has[:, None], a.data2[src],
            a.data2)
        return Column(data, a.dtype, validity=valid | has,
                      dictionary=a.dictionary, data2=data2)

    return exec_fn


register_function("fill_null_forward", "vector", 1)(
    _fill_null_directional(False))
register_function("fill_null_backward", "vector", 1)(
    _fill_null_directional(True))
