"""One call of every function of the numeric compute tail (validity,
selection, numeric cast, the sort tail, element-wise min/max,
power/abs/sign, bitwise, math, cumulative, conditional, set lookup,
run-end encoding, ``random``: 99 names) over BASELINE config 1's columns,
for the on-card checks (``chip_smoke.py`` and tests/test_torch_cuda.py):

    cols = tail_columns(10_000_000, "cuda")
    for name, (call, kind, ulps) in CALLS.items():
        out = call(cols)

``tail_columns`` builds config 1's key (int64 in [0, 2^20)), v (int64)
and f (float64) from a seed, with 10% nulls in v and f, NaN and -0.0 in
f, a uint64 view of key, a dictionary-string column and a few columns
derived from them (masks, small exponents, a permutation). ``kind`` says
how a call at n rows relates to the same call on the first ``window``
rows: ``map`` (row i of the output depends on row i of the input: the
first ``window`` rows agree), ``prefix`` (the window's output is the first
rows of the whole output), ``whole`` (no relation: the window is called
on its own) or ``random`` (held to its properties). ``ulps`` bounds the
float difference between the card and the CPU (different libm, a
parallel scan); 0 means bit for bit.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from . import dtypes as dt
from .column import Column
from .datum import scalar
from .interop import column_from_numpy
from .registry import call_function
from .table import RecordBatch

__all__ = ["tail_columns", "CALLS", "same_result", "window_of",
           "on_device"]

WORDS = np.array(["apple", "fig", "kiwi", "lime", "pear", "plum", "date",
                  "sloe", "yuzu", "acai", "guava", "mango", "olive", "quince",
                  "feijoa", ""], dtype=object)


def tail_columns(n: int, device, seed: int = 0,
                 window: int = 1_000_000) -> Dict[str, Column]:
    """The columns the calls take, ``n`` rows on ``device``; ``perm`` is a
    permutation of [0, n) whose first ``min(window, n)`` rows permute
    [0, window) (a shuffle within each block of ``window`` rows)."""
    rng = np.random.default_rng(seed)
    key = rng.integers(0, 1 << 20, n).astype(np.int64)
    v = rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64)
    f = rng.standard_normal(n)
    f[rng.random(n) < 0.01] = np.nan
    f[rng.random(n) < 0.001] = -0.0
    v_ok = rng.random(n) >= 0.1
    f_ok = rng.random(n) >= 0.1
    w = min(window, n)
    perm = np.concatenate([lo + rng.permutation(min(w, n - lo))
                           for lo in range(0, n, w)]).astype(np.int64)
    codes = rng.integers(0, len(WORDS), n).astype(np.int32)
    s_ok = rng.random(n) >= 0.1

    def col(values, ok=None):
        return column_from_numpy(values, ok, device=device)

    cols = {
        "key": col(key), "v": col(v, v_ok), "f": col(f, f_ok),
        "u": col(key.view(np.uint64)), "perm": col(perm),
        "s": column_from_numpy(codes, s_ok, device=device, dictionary=WORDS),
    }
    fd, vd, kd = cols["f"].data, cols["v"].data, cols["key"].data

    def derived(data, like, dtype=None):
        return Column(data, dtype or like.dtype, validity=like.validity)

    cols.update(
        m=derived(fd > 0, cols["f"], dt.bool_),
        m2=derived(vd > 0, cols["v"], dt.bool_),
        e=Column(kd % 8, dt.int64),                # exponents, shifts
        nd=Column(kd % 4 - 1, dt.int64),           # digits: -1 to 2
        choice=Column(kd % 3, dt.int64),
        sgn=Column(torch.where(kd % 2 == 1, 1, -1), dt.int64),
        g=derived(vd.to(torch.float64) / (1 << 30), cols["v"], dt.float64),
        fp=derived(fd.abs() + 0.5, cols["f"]),     # > 0: logs, sqrt
        fb=derived(fd.abs() + 1.0, cols["f"]),     # >= 1: acosh
        unit=derived(fd / (fd.abs() + 1.0), cols["f"]),   # in (-1, 1)
    )
    cols["d"] = call_function("dictionary_encode", [cols["s"]])
    cols["s_set"] = col(np.array(["fig", "lime", "plum", "", None,
                                  "absent"], dtype=object))
    cols["f_set"] = col(np.array([np.nan, 0.5, -0.0]))
    cols["n"] = n
    return cols


def window_of(cols: dict, window: int) -> dict:
    """The first ``window`` rows of every column (the value sets whole)."""
    out = {}
    for name, c in cols.items():
        if name == "n":
            out[name] = min(window, c)
        elif name.endswith("_set"):
            out[name] = c
        else:
            out[name] = c.slice(0, window)
    return out


def on_device(cols: dict, device) -> dict:
    """A copy of every column on ``device``."""
    return {name: c if not isinstance(c, Column) else Column(
        c.data.to(device), c.dtype, validity=None if c.validity is None
        else c.validity.to(device), dictionary=c.dictionary,
        data2=None if c.data2 is None else c.data2.to(device))
        for name, c in cols.items()}


def _f(name, *args, **options):
    """A call of ``name`` on the named columns (others pass as they are)."""
    def call(c):
        return call_function(name, [c[a] if isinstance(a, str) else a
                                    for a in args], **options)
    return call


_MATH_UNARY = ("ln", "log2", "log10", "log1p", "exp", "expm1", "sqrt",
               "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
               "tanh", "asinh", "acosh", "atanh")
# the argument of each checked function: inside its domain
_CHECKED = {"ln_checked": "fp", "log2_checked": "fp", "log10_checked": "fp",
            "log1p_checked": "fp", "sqrt_checked": "fp",
            "asin_checked": "unit", "acos_checked": "unit",
            "acosh_checked": "fb", "atanh_checked": "unit",
            "sin_checked": "f", "cos_checked": "f", "tan_checked": "f"}
_TRANSCENDENTAL_ULPS = 8   # libdevice against the CPU's libm

# name -> (call, kind, ulps)
CALLS: Dict[str, Tuple[Callable, str, int]] = {
    # validity
    "is_valid": (_f("is_valid", "v"), "map", 0),
    "is_null": (_f("is_null", "f", nan_is_null=True), "map", 0),
    "is_nan": (_f("is_nan", "f"), "map", 0),
    "is_finite": (_f("is_finite", "f"), "map", 0),
    "is_inf": (_f("is_inf", "f"), "map", 0),
    "true_unless_null": (_f("true_unless_null", "v"), "map", 0),
    "fill_null": (_f("fill_null", "v", scalar(0)), "map", 0),
    "coalesce": (_f("coalesce", "v", "key", scalar(0)), "map", 0),
    "if_else": (_f("if_else", "m", "v", "key"), "map", 0),
    # selection and dictionaries
    "drop_null": (_f("drop_null", "v"), "prefix", 0),
    "indices_nonzero": (_f("indices_nonzero", "f"), "prefix", 0),
    "array_take": (_f("array_take", "v", "perm"), "whole", 0),
    "array_filter": (_f("array_filter", "v", "m"), "prefix", 0),
    "scatter": (lambda c: call_function("scatter", [c["v"], c["perm"]],
                                        max_index=c["n"] - 1), "whole", 0),
    "dictionary_decode": (_f("dictionary_decode", "d"), "map", 0),
    "cast": (_f("cast", "v", target_type=dt.float64), "map", 0),
    # the sort tail
    "partition_nth_indices": (lambda c: call_function(
        "partition_nth_indices", [c["f"]], pivot=c["n"] // 2), "whole", 0),
    "rank": (_f("rank", "v", tiebreaker="min"), "whole", 0),
    "rank_quantile": (_f("rank_quantile", "key"), "whole", 0),
    "rank_normal": (_f("rank_normal", "f"), "whole", 16),
    "select_k_unstable": (_f("select_k_unstable", "v", k=1000,
                             sort_keys=[("v", "descending")]), "whole", 0),
    # element-wise min and max
    "min_element_wise": (_f("min_element_wise", "v", "key"), "map", 0),
    "max_element_wise": (_f("max_element_wise", "f", "g", scalar(0.5)),
                         "map", 0),
    # power, abs, sign
    "power": (_f("power", "e", "e"), "map", 0),
    "power_checked": (_f("power_checked", "e", scalar(3)), "map", 0),
    "abs": (_f("abs", "v"), "map", 0),
    "abs_checked": (_f("abs_checked", "v"), "map", 0),
    "sign": (_f("sign", "f"), "map", 0),
    # bitwise
    "bit_wise_and": (_f("bit_wise_and", "key", "v"), "map", 0),
    "bit_wise_or": (_f("bit_wise_or", "key", "v"), "map", 0),
    "bit_wise_xor": (_f("bit_wise_xor", "key", "v"), "map", 0),
    "bit_wise_not": (_f("bit_wise_not", "u"), "map", 0),
    "shift_left": (_f("shift_left", "v", "e"), "map", 0),
    "shift_left_checked": (_f("shift_left_checked", "key", "e"), "map", 0),
    "shift_right": (_f("shift_right", "u", "e"), "map", 0),
    "shift_right_checked": (_f("shift_right_checked", "v", "e"), "map", 0),
    # math
    **{name: (_f(name, "f"), "map", _TRANSCENDENTAL_ULPS)
       for name in _MATH_UNARY},
    **{name: (_f(name, arg), "map", _TRANSCENDENTAL_ULPS)
       for name, arg in _CHECKED.items()},
    "atan2": (_f("atan2", "f", "g"), "map", _TRANSCENDENTAL_ULPS),
    "hypot": (_f("hypot", "f", "g"), "map", _TRANSCENDENTAL_ULPS),
    "logb": (_f("logb", "fp", scalar(2.0)), "map", _TRANSCENDENTAL_ULPS),
    "logb_checked": (_f("logb_checked", "fp", scalar(10.0)), "map",
                     _TRANSCENDENTAL_ULPS),
    "floor": (_f("floor", "f"), "map", 0),
    "ceil": (_f("ceil", "f"), "map", 0),
    "trunc": (_f("trunc", "f"), "map", 0),
    "round": (_f("round", "f", ndigits=2), "map", 0),
    "round_to_multiple": (_f("round_to_multiple", "f", multiple=0.25),
                          "map", 0),
    "round_binary": (_f("round_binary", "f", "nd"), "map",
                     _TRANSCENDENTAL_ULPS),
    # cumulative (the integer sums are exact; the float scans compare
    # exactly: min and max, and a mean of integers, whose sums float64
    # holds exactly)
    "cumulative_sum": (_f("cumulative_sum", "v", skip_nulls=True),
                       "prefix", 0),
    "cumulative_sum_checked": (_f("cumulative_sum_checked", "v"), "prefix",
                               0),
    "cumulative_prod": (_f("cumulative_prod", "e"), "prefix", 0),
    "cumulative_prod_checked": (_f("cumulative_prod_checked", "sgn"),
                                "prefix", 0),
    "cumulative_min": (_f("cumulative_min", "v", skip_nulls=True),
                       "prefix", 0),
    "cumulative_max": (_f("cumulative_max", "f", skip_nulls=True),
                       "prefix", 0),
    "cumulative_mean": (_f("cumulative_mean", "v", skip_nulls=True),
                        "prefix", 0),
    "pairwise_diff": (_f("pairwise_diff", "v", period=3), "prefix", 0),
    "pairwise_diff_checked": (_f("pairwise_diff_checked", "v"), "prefix",
                              0),
    "fill_null_forward": (_f("fill_null_forward", "v"), "prefix", 0),
    "fill_null_backward": (_f("fill_null_backward", "f"), "whole", 0),
    # conditional
    "case_when": (lambda c: call_function("case_when", [
        RecordBatch((c["m"], c["m2"]), ("m", "m2")), c["v"], c["key"],
        scalar(0)]), "map", 0),
    "choose": (_f("choose", "choice", "v", "key", "e"), "map", 0),
    "replace_with_mask": (_f("replace_with_mask", "v", "m", "key"),
                          "prefix", 0),
    "inverse_permutation": (_f("inverse_permutation", "perm"), "whole", 0),
    # set lookup
    "is_in": (_f("is_in", "key", value_set=list(range(0, 1 << 20, 977))),
              "map", 0),
    "index_in": (_f("index_in", "u",
                    value_set=[2 ** 64 - 1, 5, 77, 1 << 19]), "map", 0),
    "is_in_meta_binary": (_f("is_in_meta_binary", "s", "s_set"), "map", 0),
    "index_in_meta_binary": (_f("index_in_meta_binary", "f", "f_set"),
                             "map", 0),
    # run ends and random
    "run_end_encode": (_f("run_end_encode", "e"), "whole", 0),
    "run_end_decode": (lambda c: call_function(
        "run_end_decode", [call_function("run_end_encode", [c["e"]])]),
        "map", 0),
    "random": (lambda c: call_function(
        "random", [], length=c["n"], initializer=7,
        device=c["v"].device), "random", 0),
}


def _columns_of(x):
    if isinstance(x, RecordBatch):
        return list(zip(x.names, x.columns))
    return [("", x)]


def _ulp_distance(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ints = {8: np.int64, 4: np.int32, 2: np.int16}[a.itemsize]
    ia, ib = a.view(ints).astype(np.int64), b.view(ints).astype(np.int64)
    low = np.int64(2 ** (8 * a.itemsize - 1) - 1)
    ia = np.where(ia < 0, -(ia & low), ia)   # a monotonic line
    ib = np.where(ib < 0, -(ib & low), ib)
    return np.abs(ia - ib)


def same_result(got, want, ulps: int = 0, rows: Optional[int] = None
                ) -> Optional[str]:
    """None when ``got`` (of a call on one device) equals ``want`` (the
    same call on another), over its first ``rows`` rows when given: the
    same types and null masks, integers and bools exactly, floats bit for
    bit or within ``ulps`` (NaN equal to NaN), else what differs."""
    if not isinstance(got, (Column, RecordBatch)):
        same = got.as_py() == want.as_py() or (got.as_py() != got.as_py()
                                               and want.as_py() !=
                                               want.as_py())
        return None if same else f"scalar {got.as_py()} != {want.as_py()}"
    for (name, g), (_, w) in zip(_columns_of(got), _columns_of(want)):
        label = f"column {name!r}: " if name else ""
        if g.dtype != w.dtype:
            return f"{label}type {g.dtype} != {w.dtype}"
        k = w.length if rows is None else rows
        if g.length < k or (rows is None and g.length != w.length):
            return f"{label}length {g.length} != {w.length}"
        gv, wv = g.mask()[:k].cpu().numpy(), w.mask()[:k].cpu().numpy()
        if not np.array_equal(gv, wv):
            return f"{label}null masks differ at {np.flatnonzero(gv != wv)[:5]}"
        gd, wd = g.data[:k].cpu().numpy()[wv], w.data[:k].cpu().numpy()[wv]
        if gd.dtype.kind != "f":
            bad = gd != wd
        else:
            nan = np.isnan(gd) | np.isnan(wd)
            bad = np.where(nan, np.isnan(gd) != np.isnan(wd),
                           _ulp_distance(gd, wd) > ulps)
        if bad.any():
            i = np.flatnonzero(bad)[:3]
            return f"{label}values differ: {gd[i]} != {wd[i]}"
    return None
