"""One call of each decimal dispatch point of the port, for the on-card
checks (``chip_smoke.py``, tests/test_torch_cuda.py):

    cols = decimal_columns(10_000_000, "cuda")
    for label in CALLS:
        out = call(label, cols)

The columns come from a seed, 1% of each null: ``price`` decimal128(15,
2) over TPC-H's l_extendedprice range (900.00-104949.50), ``disc`` its
l_discount (0.00-0.10) and ``disc1`` that plus 1, ``wide`` decimal128(38,
10) whose values cross the 2^64 limb boundary (negatives included: a high
limb of -1 or 0 for a quarter of the rows, up to 2^40 in magnitude for
the rest), ``wide256`` the same values as decimal256(40, 10), ``big``
decimal256(60, 6) (three random limbs below a small signed top limb),
and beside them an int64 ``k`` (16 group keys), a float64 ``f``, a bool
``m``, an int8 ``pick``, ``s``, strings of 100 distinct decimals, and a
batch of ``k``, ``disc``, ``price``, ``wide`` and ``big`` for the grouped
calls.

A call is (function, argument keys, options, kind): ``map`` calls give
one row per input row, so a call's first rows equal the call over the
first rows; ``aggregate`` calls are compared on a window. A Scalar in the
argument keys passes as it is.
"""

from __future__ import annotations

from decimal import Decimal
from typing import Dict, Optional

import numpy as np
import torch

from . import compute_tail
from . import dtypes as dt
from .column import Column, Dictionary
from .datum import Scalar, scalar
from .ops.cast import CastOptions
from .ops.decimal import column_limbs, pack
from .ops.groupby import group_by
from .ops.join import join
from .registry import call_function
from .table import RecordBatch

__all__ = ["CALLS", "ULPS", "call", "decimal_columns", "on_device",
           "same_result"]

PRICE = dt.decimal128(15, 2)
_ONE = scalar(Decimal("1.00"), PRICE)
_BATCH = ("k", "disc", "price", "wide", "big")

# label -> (function, argument keys or scalars, options, kind)
CALLS = {
    "add": ("add", ("price", "disc"), {}, "map"),
    "add/mixed": ("add", ("big", "wide"), {}, "map"),
    "subtract/scalar": ("subtract", (_ONE, "disc"), {}, "map"),
    "add/int": ("add", ("price", "k"), {}, "map"),
    "multiply": ("multiply", ("price", "disc"), {}, "map"),
    "multiply/256": ("multiply", ("big", "price"), {}, "map"),
    "divide": ("divide", ("price", "disc1"), {}, "map"),
    "divide/wide-divisor": ("divide", ("price", "wide256"), {}, "map"),
    "negate": ("negate", ("wide",), {}, "map"),
    "abs": ("abs", ("big",), {}, "map"),
    "sign": ("sign", ("wide",), {}, "map"),
    "less": ("less", ("price", "disc1"), {}, "map"),
    "greater_equal/scalar": ("greater_equal", (
        "disc", scalar(Decimal("0.05"), PRICE)), {}, "map"),
    "equal/mixed": ("equal", ("wide", "big"), {}, "map"),
    "max_element_wise": ("max_element_wise", ("disc", "disc1"), {}, "map"),
    "cast/float64": ("cast", ("wide",), {"target_type": dt.float64},
                     "map"),
    "cast/rescale": ("cast", ("price",),
                     {"target_type": dt.decimal128(20, 4)}, "map"),
    "cast/truncate": ("cast", ("wide",), {"options": CastOptions.unsafe(
        dt.decimal128(38, 2))}, "map"),
    "cast/decimal256": ("cast", ("price",),
                        {"target_type": dt.decimal256(40, 2)}, "map"),
    "cast/int64": ("cast", ("price",),
                   {"options": CastOptions.unsafe(dt.int64)}, "map"),
    "cast/string": ("cast", ("disc",), {"target_type": dt.string}, "map"),
    "cast/from-int": ("cast", ("k",), {"target_type": dt.decimal128(25, 2)},
                      "map"),
    "cast/from-float": ("cast", ("f",),
                        {"target_type": dt.decimal128(20, 4)}, "map"),
    "cast/from-string": ("cast", ("s",), {"target_type": PRICE}, "map"),
    "round": ("round", ("price",), {"ndigits": -2}, "map"),
    "round/256": ("round", ("big",), {"ndigits": 2,
                                      "round_mode": "half_up"}, "map"),
    "round_to_multiple": ("round_to_multiple", ("price",),
                          {"multiple": Decimal("0.25")}, "map"),
    "floor": ("floor", ("wide",), {}, "map"),
    "ceil": ("ceil", ("price",), {}, "map"),
    "trunc": ("trunc", ("big",), {}, "map"),
    "sqrt": ("sqrt", ("price",), {}, "map"),
    "is_in": ("is_in", ("disc",), {"value_set": [
        Decimal("0.05"), Decimal("0.06"), Decimal("0.07")]}, "map"),
    "fill_null": ("fill_null", ("price", _ONE), {}, "map"),
    "if_else": ("if_else", ("m", "price", "disc"), {}, "map"),
    "coalesce": ("coalesce", ("wide", "wide"), {}, "map"),
    "case_when": ("case_when", ("conds", "price", "disc"), {}, "map"),
    "choose": ("choose", ("pick", "price", "disc"), {}, "map"),
    "pairwise_diff": ("pairwise_diff", ("price",), {}, "map"),
    "fill_null_forward": ("fill_null_forward", ("big",), {}, "map"),
    "array_sort_indices": ("array_sort_indices", ("wide",), {},
                           "aggregate"),
    "rank": ("rank", ("big",), {}, "aggregate"),
    "unique": ("unique", ("disc",), {}, "aggregate"),
    "value_counts": ("value_counts", ("disc",), {}, "aggregate"),
    "dictionary_encode": ("dictionary_encode", ("disc",), {}, "aggregate"),
    "filter": ("filter", ("big", "m"), {}, "aggregate"),
    "drop_null": ("drop_null", ("wide",), {}, "aggregate"),
    "sum": ("sum", ("price",), {}, "aggregate"),
    "sum/256": ("sum", ("big",), {}, "aggregate"),
    "mean": ("mean", ("price",), {}, "aggregate"),
    "min_max": ("min_max", ("wide",), {}, "aggregate"),
    "max/256": ("max", ("big",), {}, "aggregate"),
    "variance": ("variance", ("price",), {}, "aggregate"),
    "quantile": ("quantile", ("wide",), {"q": [0.1, 0.5]}, "aggregate"),
    "mode": ("mode", ("disc",), {}, "aggregate"),
    "count_distinct": ("count_distinct", ("disc",), {}, "aggregate"),
    "index": ("index", ("disc",), {"value": scalar(Decimal("0.07"),
                                                   PRICE)}, "aggregate"),
    "group_by/dense": ("group_by", ("batch",), {
        "keys": ["k"], "aggregates": [("price", "sum"), ("price", "mean"),
                                      ("big", "sum")]}, "aggregate"),
    "group_by/decimal-key": ("group_by", ("batch",), {
        "keys": ["disc"], "aggregates": [("price", "sum"), ("wide", "min"),
                                         ("big", "max"),
                                         ("price", "variance")]},
        "aggregate"),
    "hash_mean": ("hash_mean", ("wide", "k"), {}, "aggregate"),
    "join": ("join", ("batch", "rates"), {"keys": "disc"}, "aggregate"),
}


# float results that the card computes otherwise than the CPU, in ulps:
# sqrt (libdevice's is correctly rounded; the CPU's torch.sqrt can be an
# ulp off, ROADMAP Queue 3 fault 7), and the variances, whose sums of
# squares over ~1M rows (~90K a group) the card's reductions add in
# another order: 4096 ulps is a relative 1e-12
ULPS = {"sqrt": 1, "variance": 4096, "group_by/decimal-key": 4096}


def call(label: str, cols: Dict[str, Column]):
    """CALLS[label] over ``cols``."""
    name, args, options, _ = CALLS[label]
    args = [cols[a] if isinstance(a, str) else a for a in args]
    if name == "group_by":
        return group_by(*args, **options)
    if name == "join":
        return join(*args, **options)
    return call_function(name, args, **options)


def _decimal(limbs, valid: np.ndarray, t: dt.DataType, device) -> Column:
    """Limb arrays (int64, least significant first) as a decimal column,
    null slots 0."""
    planes = [torch.from_numpy(np.where(valid, x, 0)).to(device)
              for x in limbs]
    return pack(planes, t, torch.from_numpy(valid).to(device))


def _plain(data: np.ndarray, valid, t: dt.DataType, device) -> Column:
    return Column(torch.from_numpy(data.astype(t.numpy_dtype())).to(device),
                  t, validity=None if valid is None
                  else torch.from_numpy(valid).to(device))


def decimal_columns(n: int, device, seed: int = 0) -> Dict[str, Column]:
    """``n`` rows of each of the module docstring's columns on
    ``device``."""
    rng = np.random.default_rng(seed)

    def valid():
        return rng.random(n) >= 0.01

    def small(v):   # one signed limb, sign-extended
        return [v, v >> 63]

    price = rng.integers(90_000, 10_494_951, n)
    disc = rng.integers(0, 11, n)
    lo = rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
    hi = np.where(rng.random(n) < 0.25, rng.integers(-1, 1, n),
                  rng.integers(-(1 << 40), 1 << 40, n))
    top = rng.integers(-64, 64, n)
    big = [rng.integers(-(1 << 63), (1 << 63) - 1, n, dtype=np.int64)
           for _ in range(3)] + [top]
    disc_ok, wide_ok = valid(), valid()
    strs = np.array([f"{v / 100:.2f}" for v in range(-50, 50)], object)
    cols = {
        "price": _decimal(small(price), valid(), PRICE, device),
        "disc": _decimal(small(disc), disc_ok, PRICE, device),
        "disc1": _decimal(small(disc + 100), disc_ok, PRICE, device),
        "wide": _decimal([lo, hi], wide_ok, dt.decimal128(38, 10), device),
        "wide256": _decimal([lo, hi, hi >> 63, hi >> 63], wide_ok,
                            dt.decimal256(40, 10), device),
        "big": _decimal(big, valid(), dt.decimal256(60, 6), device),
        "k": _plain(rng.integers(0, 16, n), valid(), dt.int64, device),
        "f": _plain(np.round(rng.uniform(-1e6, 1e6, n), 3), valid(),
                    dt.float64, device),
        "m": _plain(rng.random(n) < 0.5, valid(), dt.bool_, device),
        "pick": _plain(rng.integers(0, 2, n), None, dt.int8, device),
    }
    cols["s"] = Column(torch.from_numpy(rng.integers(0, 100, n).astype(
        np.int32)).to(device), dt.string,
        validity=torch.from_numpy(valid()).to(device),
        dictionary=Dictionary(strs))
    cols["conds"] = RecordBatch((cols["m"], _plain(
        rng.random(n) < 0.5, None, dt.bool_, device)), ("c0", "c1"))
    cols["batch"] = RecordBatch(tuple(cols[k] for k in _BATCH), _BATCH)
    rates = np.arange(0, 11, 2)
    cols["rates"] = RecordBatch((
        _decimal(small(rates), np.ones(len(rates), bool), PRICE, device),
        _plain(rates * 10, None, dt.int64, device)), ("disc", "rate"))
    return cols


def on_device(cols: Dict[str, Column], device, rows: int
              ) -> Dict[str, Column]:
    """The first ``rows`` rows of each column (a batch's too; the small
    ``rates`` table whole), on ``device``."""
    def move(c: Column, k: Optional[int]) -> Column:
        s = c if k is None else c.slice(0, k)
        return Column(s.data.to(device), s.dtype,
                      validity=None if s.validity is None
                      else s.validity.to(device), dictionary=s.dictionary,
                      data2=None if s.data2 is None else s.data2.to(device))

    out = {}
    for key, c in cols.items():
        k = None if key == "rates" else rows
        if isinstance(c, RecordBatch):
            out[key] = RecordBatch(tuple(move(x, k) for x in c.columns),
                                   c.names)
        else:
            out[key] = move(c, k)
    return out


def _limb_columns(c: Column):
    """A decimal column as int64 columns: each limb plane with its
    validity, so that the plain comparison reads every limb."""
    return [Column(x, dt.int64, validity=c.validity)
            for x in column_limbs(c)]


def same_result(got, want, rows: Optional[int] = None, ulps: int = 0
                ) -> Optional[str]:
    """None when ``got``'s first ``rows`` rows (all by default) equal
    ``want``'s exactly: the types, null masks and every limb of a decimal,
    strings by their values, floats bit for bit or within ``ulps``; else
    the first difference."""
    if isinstance(want, Scalar):
        if got.dtype != want.dtype:
            return f"scalar {got!r} != {want!r}"
        if want.dtype.is_floating:   # as one-row columns, within ulps
            return compute_tail.same_result(*(Column(
                torch.tensor([float(x.as_py() if x.is_valid else 0.0)]),
                dt.float64, validity=torch.tensor([x.is_valid]))
                for x in (got, want)), ulps)
        if got.as_py() != want.as_py():
            return f"scalar {got!r} != {want!r}"
        return None
    gcols = list(got.columns) if isinstance(got, RecordBatch) else [got]
    wcols = list(want.columns) if isinstance(want, RecordBatch) else [want]
    if len(gcols) != len(wcols):
        return f"{len(gcols)} columns != {len(wcols)}"
    for g, w in zip(gcols, wcols):
        if g.dtype != w.dtype:
            return f"type {g.dtype} != {w.dtype}"
        if w.dtype.is_decimal:
            pairs = zip(_limb_columns(g), _limb_columns(w))
        elif w.dtype.is_dictionary:   # codes, and the pools' exact values
            if list(g.dictionary.values) != list(w.dictionary.values):
                return "dictionary pools differ"
            pairs = [(Column(g.data, dt.int32, validity=g.validity),
                      Column(w.data, dt.int32, validity=w.validity))]
        elif w.dictionary is not None:
            from . import compute_strings

            problem = compute_strings.same_result(g, w, rows)
            if problem:
                return problem
            continue
        else:
            pairs = [(g, w)]
        for a, b in pairs:
            problem = compute_tail.same_result(a, b, ulps, rows)
            if problem:
                return problem
    return None
