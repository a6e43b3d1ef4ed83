"""Comparison kernels: equal/not_equal/greater/greater_equal/less/less_equal
(counterpart of arrow1_tpu/ops/compare.py, numeric and bool only). Inputs
promote to a common type; outputs are bool with intersection nulls."""

from __future__ import annotations

import torch

from .. import dtypes as dt
from ..errors import NotImplementedError_
from ..registry import register_function
from .common import common_type, intersect_validity, result_column, unpack

_OPS = {
    "equal": torch.eq,
    "not_equal": torch.ne,
    "greater": torch.gt,
    "greater_equal": torch.ge,
    "less": torch.lt,
    "less_equal": torch.le,
}


def _compare_exec(name):
    op = _OPS[name]

    def exec_fn(args, options, ctx):
        if any(a.dtype.is_binary for a in args):
            raise NotImplementedError_(
                f"{name} over dictionary-encoded strings is not ported yet "
                "(registry slice, ROADMAP Queue 1 item 10)")
        (x, y), validities, n = unpack(args, common_type(args))
        return result_column(op(x, y), dt.bool_,
                             intersect_validity(validities), n)

    return exec_fn


for _name in _OPS:
    register_function(_name, "scalar", 2)(_compare_exec(_name))
