"""Conditional and permutation kernels: case_when, choose,
replace_with_mask and inverse_permutation (counterpart of
arrow1_tpu/ops/conditional.py).

Reference: compute/kernels/scalar_if_else.cc (CaseWhen, Choose),
vector_replace.cc (ReplaceWithMask) and vector_swizzle.cc
(InversePermutation). Each is a few elementwise selects and gathers.
Dictionary-encoded string cases with different pools are unified first;
decimal cases are rescaled to their common type and select every limb.
``inverse_permutation`` takes, for each output slot, the largest input
position that names it (``scatter_reduce`` amax: the same answer on every
device, where a plain scatter of duplicates is not).
"""

from __future__ import annotations

import dataclasses

import torch

from .. import dtypes as dt
from ..column import Column
from ..datum import Scalar
from ..errors import IndexError_, Invalid
from ..registry import register_function
from ..table import RecordBatch
from .decimal import common_decimal_type, decimal_planes
from .dictionary import one_pool

__all__ = ["InversePermutationOptions"]


def _where2(c: torch.Tensor, a, b):
    """torch.where over a column's data2 (a decimal256's [n, 3] too)."""
    if a is None:
        return None
    return torch.where(c if a.dim() == 1 else c[:, None], a, b)


def _as_decimal(cols, n: int, dev):
    """Decimal cases at their common type (ops/decimal.py)."""
    if not cols or not cols[0].dtype.is_decimal:
        return cols
    t = common_decimal_type([c.dtype for c in cols])
    out = []
    for c in cols:
        lo, hi = decimal_planes(c, t, n, dev)
        out.append(Column(lo, t, validity=c.validity, data2=hi))
    return out


def _as_len(col, n: int, dev):
    """A Scalar, or a length-1 Column, broadcast to n rows (a string
    Scalar as a one-value pool, ``one_pool``)."""
    if isinstance(col, Scalar):
        t = col.dtype
        if t.is_binary:
            return one_pool([col], n, dev)[0]
        if t.is_decimal:
            lo, hi = decimal_planes(col, t, n, dev)
            return Column(lo, t, data2=hi, validity=None if col.is_valid
                          else torch.zeros(n, dtype=torch.bool, device=dev))
        return Column(torch.full((n,), col.as_py() if col.is_valid else 0,
                                 dtype=t.physical_dtype(), device=dev), t,
                      validity=None if col.is_valid else
                      torch.zeros(n, dtype=torch.bool, device=dev))
    if col.length == 1 and n != 1:
        return Column(col.data.expand(n), col.dtype,
                      validity=None if col.validity is None
                      else col.validity.expand(n),
                      dictionary=col.dictionary,
                      data2=None if col.data2 is None
                      else col.data2.expand(n, *col.data2.shape[1:]))
    return col


def _unify_if_binary(cols):
    """String columns re-encoded onto one pool when their pools differ."""
    if not cols or not cols[0].dtype.is_binary:
        return cols
    return one_pool(cols, 0, None)


def _case_when_exec(args, options, ctx):
    """case_when(conditions, *cases): a row takes the first case whose
    condition is true; a trailing extra case is the else, otherwise such
    a row is null. ``conditions`` is a RecordBatch of bool columns (the
    reference's struct)."""
    cond = args[0]
    if not isinstance(cond, RecordBatch):
        raise Invalid("case_when: first argument must be a struct of bools")
    nconds = len(cond.columns)
    if len(args) - 1 not in (nconds, nconds + 1):
        raise Invalid("case_when: need one case per condition "
                      "(+ optional else)")
    n = cond.num_rows
    dev = cond.columns[0].device if cond.columns else torch.device("cpu")
    cases = _as_decimal(_unify_if_binary(
        [_as_len(c, n, dev) for c in args[1:]]), n, dev)
    if len(cases) == nconds + 1:
        out, out2 = cases[-1].data, cases[-1].data2
        out_valid = cases[-1].mask()
    else:
        out = torch.zeros_like(cases[0].data)
        out2 = None if cases[0].data2 is None else \
            torch.zeros_like(cases[0].data2)
        out_valid = torch.zeros(n, dtype=torch.bool, device=dev)
    for j in reversed(range(nconds)):
        cj = cond.columns[j]
        fire = cj.data & cj.mask()
        out = torch.where(fire, cases[j].data, out)
        out2 = _where2(fire, cases[j].data2, out2)
        out_valid = torch.where(fire, cases[j].mask(), out_valid)
    return Column(out, cases[0].dtype, validity=out_valid,
                  dictionary=cases[0].dictionary, data2=out2)


register_function("case_when", "scalar", -1)(_case_when_exec)


def _choose_exec(args, options, ctx):
    """choose(indices, *values): each row takes the value column its index
    names."""
    idx, vals = args[0], list(args[1:])
    if not vals:
        raise Invalid("choose: need at least one value")
    n, dev = idx.length, idx.device
    vals = _as_decimal(_unify_if_binary(
        [_as_len(v, n, dev) for v in vals]), n, dev)
    stacked = torch.stack([v.data for v in vals])          # [k, n]
    vmask = torch.stack([v.mask() for v in vals])
    i = idx.data.to(torch.int64).clamp(0, len(vals) - 1)
    rows = torch.arange(n, device=dev)
    data2 = None if vals[0].data2 is None else \
        torch.stack([v.data2 for v in vals])[i, rows]
    return Column(stacked[i, rows], vals[0].dtype,
                  validity=vmask[i, rows] & idx.mask(),
                  dictionary=vals[0].dictionary, data2=data2)


register_function("choose", "scalar", -1)(_choose_exec)


def _replace_with_mask_exec(args, options, ctx):
    """Rows where the mask is true take the replacements in turn; a null
    mask slot nulls the row (reference: vector_replace.cc)."""
    a, mask, repl = args
    if not isinstance(mask, Column) or not mask.dtype.is_boolean:
        raise Invalid("replace_with_mask: the mask must be a boolean array")
    a, repl = _unify_if_binary([a, repl])
    fire = mask.data & mask.mask()
    ri = (torch.cumsum(fire.to(torch.int64), 0) - 1).clamp(
        0, max(repl.length - 1, 0))
    if a.dtype.is_decimal:
        a, repl = _as_decimal([a, repl], a.length, a.device)[0], \
            _as_decimal([a, repl], repl.length, a.device)[1]
    out = torch.where(fire, repl.data[ri], a.data)
    out2 = None if a.data2 is None else \
        _where2(fire, repl.data2[ri], a.data2)
    out_valid = torch.where(fire, repl.mask()[ri], a.mask()) & mask.mask()
    return Column(out, a.dtype, validity=out_valid, dictionary=a.dictionary,
                  data2=out2)


register_function("replace_with_mask", "scalar", 3)(_replace_with_mask_exec)


@dataclasses.dataclass
class InversePermutationOptions:
    """Reference: api_vector.h InversePermutationOptions."""

    max_index: object = None
    output_type: object = None


def _inverse_permutation_exec(args, options: InversePermutationOptions,
                              ctx):
    """out[input[i]] = i; of repeated values the last wins, null inputs
    claim no slot, and unclaimed slots are null (reference:
    vector_swizzle.cc InversePermutation)."""
    (a,) = args
    options = options or InversePermutationOptions()
    if not a.dtype.is_integer:
        raise Invalid("inverse_permutation: expects integer indices")
    n, dev = a.length, a.device
    m = n if options.max_index is None else int(options.max_index) + 1
    vals = a.data.to(torch.int64)
    valid = a.mask()
    if bool((valid & ((vals < 0) | (vals >= m))).any()):
        raise IndexError_("inverse_permutation: index out of bounds "
                          f"(valid range [0, {m}))")
    slot = torch.where(valid, vals, m)   # nulls land past the end
    last = torch.full((m + 1,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, slot, torch.arange(n, device=dev),
                               "amax")[:m]
    hit = last >= 0
    out_t = options.output_type
    out_t = a.dtype if out_t is None else (
        out_t if isinstance(out_t, dt.DataType) else dt.from_arrow(out_t))
    out = torch.where(hit, last, 0).to(out_t.physical_dtype())
    return Column(out, out_t, validity=None if bool(hit.all()) else hit)


register_function("inverse_permutation", "vector", 1,
                  InversePermutationOptions)(_inverse_permutation_exec)
