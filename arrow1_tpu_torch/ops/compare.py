"""Comparison kernels: equal/not_equal/greater/greater_equal/less/less_equal
and min_element_wise/max_element_wise (counterpart of
arrow1_tpu/ops/compare.py; numeric, bool, temporal and dictionary
strings). Inputs promote to a common type; compare
outputs are bool with intersection nulls. uint16, uint32 and uint64
compare in int64 (``minmax_domain``): torch has no order compare for
them. Temporal values compare their storage integers, rescaled to the
finer unit where the units differ (a date32 against a timestamp).
Dictionary strings compare their codes (equality) or ranks (order)
on the column's device; only the pool's rank table is made on the host.

The element-wise min and max follow pyarrow where the reference does not
(ROADMAP Queue 3): a NaN loses to any number (NaN only where every input
is NaN or null), and of two equal values (0.0 and -0.0) the earlier
argument's is kept, as pyarrow does for float64. Decimals compare at the
common scale (ops/decimal.py); their element-wise min and max take one
decimal type (scalars rescale to it), as pyarrow does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column
from ..datum import Scalar
from ..errors import Invalid
from ..registry import register_function
from .cast import temporal_to_common
from .common import (broadcast_length, column_device, common_type,
                     intersect_validity, minmax_domain, result_column,
                     unpack)
from .decimal import decimal_compare, decimal_minmax_element_wise
from .dictionary import one_pool

__all__ = ["ElementWiseAggregateOptions"]

_OPS = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "less": torch.lt,
    "less_equal": torch.le,
}


_ORDERED = ("greater", "greater_equal", "less", "less_equal")


def _rank_table(d, device, scale: int = 1) -> torch.Tensor:
    """``scale`` * rank of each code, on ``device`` (one copy)."""
    return torch.from_numpy(d.rank.astype(np.int64) * scale).to(device)


def _string_operands(name, args):
    """(x, y, validities, n) for a compare of dictionary strings: device
    integers that compare as the values do (reference
    ``_dict_compare_values``). Against a scalar, equality compares the
    codes with the scalar's code and an order compare gathers twice the
    rank of each code, the scalar placed at an even rank when the pool
    holds it and between two ranks otherwise; two columns go through one
    pool (``one_pool``), then codes or gathered ranks. Two scalars give
    the sign of their comparison against 0."""
    ordered = name in _ORDERED
    a, b = args
    if isinstance(a, Scalar) and isinstance(b, Scalar):
        x, y = a.as_py(), b.as_py()
        valid = x is not None and y is not None
        return (torch.tensor(valid and (x > y) - (x < y)), torch.tensor(0),
                [None if valid else False], None)
    if isinstance(a, Scalar) or isinstance(b, Scalar):
        flipped = isinstance(a, Scalar)
        col, s = (b, a) if flipped else (a, b)
        d = col.dictionary
        sval = s.as_py() if s.is_valid else None
        if sval is None:
            x, y = col.data, -1
        elif ordered:
            sorted_vals = np.empty(len(d), dtype=object)
            sorted_vals[d.rank] = d.values
            below = int(np.searchsorted(sorted_vals, sval, side="left"))
            x = torch.index_select(_rank_table(d, col.device, 2), 0,
                                   col.data.clamp(0, max(len(d) - 1, 0))) \
                if len(d) else col.data.to(torch.int64)
            y = 2 * below - (0 if sval in d.index else 1)
        else:
            x, y = col.data, d.index.get(sval, -1)
        y = torch.tensor(y, dtype=x.dtype)
        validities = [col.validity, None if s.is_valid else False]
        if flipped:
            x, y = y, x
            validities.reverse()
        return x, y, validities, col.length
    n = a.length
    cols = one_pool(args, n, a.device)
    if ordered and len(cols[0].dictionary):
        rank = _rank_table(cols[0].dictionary, a.device)
        x, y = (torch.index_select(rank, 0, c.data) for c in cols)
    else:
        x, y = (c.data for c in cols)
    return x, y, [c.validity for c in cols], n


def _compare_exec(name):
    op = _OPS[name]

    def exec_fn(args, options, ctx):
        if any(a.dtype.is_decimal for a in args):
            return decimal_compare(args[0], args[1], name)
        if any(a.dtype.is_binary for a in args):
            if not all(a.dtype.is_binary for a in args):
                raise Invalid(f"{name}: cannot compare string with "
                              "non-string")
            x, y, validities, n = _string_operands(name, args)
            return result_column(op(x, y), dt.bool_,
                                 intersect_validity(validities), n)
        if any(a.dtype.is_temporal for a in args):
            # storage integers, rescaled to the finer unit if they differ
            if not all(a.dtype.is_temporal for a in args):
                raise Invalid(f"{name}: cannot compare {args[0].dtype} "
                              f"with {args[1].dtype}")
            (x, y), validities, n = unpack(args)
            if args[0].dtype != args[1].dtype:
                x, y = temporal_to_common(*args)
            return result_column(op(x, y), dt.bool_,
                                 intersect_validity(validities), n)
        (x, y), validities, n = unpack(args, common_type(args))
        x, y = minmax_domain(x)[0], minmax_domain(y)[0]
        return result_column(op(x, y), dt.bool_,
                             intersect_validity(validities), n)

    return exec_fn


for _name in _OPS:
    register_function(_name, "scalar", 2)(_compare_exec(_name))


@dataclasses.dataclass
class ElementWiseAggregateOptions:
    """Reference: api_scalar.h ElementWiseAggregateOptions."""

    skip_nulls: bool = True


def _pick_first(r, v, is_min: bool):
    """Per slot, whether the running value ``r`` stays against ``v``: it
    does unless ``v`` is strictly better, or ``r`` is NaN and ``v`` not."""
    better = v < r if is_min else v > r
    if r.is_floating_point():
        better = better | (torch.isnan(r) & ~torch.isnan(v))
    return ~better


def _fold(values, validities, is_min: bool, payloads=None):
    """Null-skipping fold of the arguments' values, left to right: a slot
    keeps the running value unless the next argument's is valid and
    better there, or the running one is null. Returns (values, validity,
    payload), the payloads (one tensor per argument) carried alike."""
    r, rv = values[0], validities[0]
    p = None if payloads is None else payloads[0]
    for i in range(1, len(values)):
        v, m = values[i], validities[i]
        if rv is False:
            r, rv = v, m
            p = None if payloads is None else payloads[i]
            continue
        if m is False:
            continue
        keep = _pick_first(r, v, is_min)
        if m is not None:
            keep = keep | ~m
        if rv is not None:
            keep = torch.where(rv, keep, False)
        r = torch.where(keep, r, v)
        if payloads is not None:
            p = torch.where(keep, p, payloads[i])
        rv = None if rv is None or m is None else (rv | m)
    return r, rv, p


def _minmax_element_wise(name):
    is_min = name.startswith("min")

    def exec_fn(args, options, ctx):
        n = broadcast_length(args)
        dev = column_device(args)
        if any(a.dtype.is_decimal for a in args):
            return decimal_minmax_element_wise(
                args, is_min, options is None or options.skip_nulls)
        if any(a.dtype.is_binary for a in args):
            cols = one_pool(args, n or 1, dev)
            d = cols[0].dictionary
            rank = torch.from_numpy(d.rank.astype(np.int64)).to(dev)
            _, validity, code = _fold(
                [rank[c.data.long()] for c in cols],
                [c.validity for c in cols], is_min,
                payloads=[c.data for c in cols])
            out = Column(code, cols[0].dtype, validity=validity,
                         dictionary=d)
        else:
            out_t = common_type(args)
            values, validities, n = unpack(args, out_t)
            values = [v.to(dev).expand(n) if n is not None and v.dim() == 0
                      else v.to(dev) for v in values]
            doms = [minmax_domain(v) for v in values]
            r, validity, _ = _fold([y for y, _ in doms], validities, is_min)
            out = result_column(doms[0][1](r), out_t, validity, n)
        if options is not None and not options.skip_nulls:
            strict = intersect_validity([a.validity if isinstance(a, Column)
                                         else (None if a.is_valid else False)
                                         for a in args])
            if isinstance(out, Scalar):
                out.is_valid = out.is_valid and strict is not False
            elif strict is not None:
                mask = torch.zeros(n, dtype=torch.bool, device=dev) \
                    if strict is False else strict
                out = Column(out.data, out.dtype, validity=mask,
                             dictionary=out.dictionary)
        return out

    return exec_fn


for _name in ("min_element_wise", "max_element_wise"):
    register_function(_name, "scalar", -1, ElementWiseAggregateOptions)(
        _minmax_element_wise(_name))
