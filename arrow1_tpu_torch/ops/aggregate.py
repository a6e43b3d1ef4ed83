"""Scalar aggregate kernels (counterpart of arrow1_tpu/ops/aggregate.py):
count, sum, product, mean, min_max/min/max, any/all, variance/stddev,
skew/kurtosis, quantile, approximate_median, mode, index, first/last,
count_all, count_distinct and the winsorize vector kernel.

Reference: cpp/src/arrow/compute/kernels/aggregate_basic.cc,
aggregate_var_std.cc, aggregate_mode.cc, aggregate_quantile.cc. A whole
column on the card reduces with one torch reduction; these functions have
no kernel of their own. Null handling follows pyarrow's reading of the
options (api_aggregate.h:36): with ``skip_nulls=False`` a null among the
values makes the result null (``mode`` empty; ``any``/``all`` follow
Kleene logic), and fewer than ``min_count`` valid values give a null; a
sum or product of no value is its identity, a float mean of none NaN.
The JAX package reads neither option so (ROADMAP Queue 3, repaired here).

Integer sums and products accumulate in int64 and wrap mod 2^64; the
uint64 results of unsigned inputs are the same bits viewed as uint64.
A decimal sum is exact: the 32-bit digits of its limbs are summed on the
device (each digit sum stays below 2^63 for fewer than 2^31 rows) and
read back in one transfer, then carried on the host. The decimal mean
(sum / count rounded half away from zero) and product (rounded to the
scale at each step) keep the input type, as pyarrow's do; min and max
compare the limbs, and the float statistics read ``decimal_to_float``.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column
from ..datum import Scalar
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch
from .common import as_int64, minmax_domain, value_of

__all__ = ["ScalarAggregateOptions", "CountOptions", "VarianceOptions",
           "ModeOptions", "QuantileOptions", "TDigestOptions", "IndexOptions",
           "SkewOptions", "WinsorizeOptions"]


@dataclasses.dataclass
class ScalarAggregateOptions:
    """Reference: api_aggregate.h:36."""

    skip_nulls: bool = True
    min_count: int = 1


@dataclasses.dataclass
class CountOptions:
    """Reference: api_aggregate.h:46 (COUNT_NON_NULL vs COUNT_NULL)."""

    mode: str = "only_valid"  # "only_valid" | "only_null" | "all"


@dataclasses.dataclass
class VarianceOptions:
    """Reference: api_aggregate.h:120."""

    ddof: int = 0
    skip_nulls: bool = True
    min_count: int = 0


@dataclasses.dataclass
class ModeOptions:
    """Reference: api_aggregate.h:100."""

    n: int = 1
    skip_nulls: bool = True
    min_count: int = 0


@dataclasses.dataclass
class QuantileOptions:
    """Reference: api_aggregate.h:140."""

    q: Sequence[float] = (0.5,)
    interpolation: str = "linear"  # linear|lower|higher|nearest|midpoint
    skip_nulls: bool = True
    min_count: int = 0

    def __post_init__(self):
        if isinstance(self.q, (int, float)):
            self.q = (float(self.q),)


@dataclasses.dataclass
class TDigestOptions:
    """Reference: api_aggregate.h:160. ``delta`` and ``buffer_size`` are
    kept for the signature: the quantiles are exact (one sort), which a
    t-digest approximates."""

    q: Sequence[float] = (0.5,)
    delta: int = 100
    buffer_size: int = 500
    skip_nulls: bool = True
    min_count: int = 0

    def __post_init__(self):
        if isinstance(self.q, (int, float)):
            self.q = (float(self.q),)


def _valid_count(col: Column) -> int:
    if col.validity is None:
        return col.length
    return int(col.validity.sum())


def _null_result(col: Column, options) -> bool:
    """pyarrow's null result: a null among the values with
    ``skip_nulls=False``, or fewer valid values than ``min_count``."""
    nvalid = _valid_count(col)
    if options is not None and not getattr(options, "skip_nulls", True) \
            and nvalid < col.length:
        return True
    return nvalid < getattr(options, "min_count", 0)


def _as_float_if_decimal(col: Column) -> Column:
    if col.dtype.is_decimal:
        from .decimal import decimal_to_float

        return decimal_to_float(col)
    return col


def decimal_exact_sum(col: Column) -> int:
    """The exact unscaled sum of a decimal column: each 32-bit digit of
    its limbs summed over the valid rows on the column's device (below
    2^63 for fewer than 2^31 rows), one host read, then carried in a
    Python int mod the type's width."""
    from .decimal import digit_planes

    digits = torch.stack(digit_planes(col))
    if col.validity is not None:
        digits = torch.where(col.validity, digits, 0)
    bits = 64 * col.dtype.limbs
    total = sum(d << (32 * i) for i, d in enumerate(digits.sum(1).tolist()))
    total &= (1 << bits) - 1
    return total - (1 << bits) if total >> (bits - 1) else total


def decimal_sum_type(t: dt.DataType) -> dt.DataType:
    """pyarrow's sum type: the widest precision at the input's scale."""
    return dt.decimal128(38, t.scale) if t.kind == "decimal128" else \
        dt.decimal256(76, t.scale)


def round_half_away(num: int, den: int) -> int:
    """num / den rounded half away from zero (den > 0)."""
    q, r = divmod(abs(num), den)
    q += 2 * r >= den
    return -q if num < 0 else q


def _sum_output_type(t: dt.DataType) -> dt.DataType:
    """Reference: aggregate_basic.cc SumImpl -- accumulates in the 64-bit
    type of the input's class; floats accumulate in float64."""
    if t.is_signed_integer:
        return dt.int64
    if t.is_unsigned_integer or t.is_boolean:
        return dt.uint64
    if t.is_floating:
        return dt.float64
    raise Invalid(f"sum: unsupported type {t}")


def _as_type(acc: torch.Tensor, t: dt.DataType) -> torch.Tensor:
    """An int64 or float64 accumulator in the output type's storage:
    uint64 outputs keep the int64 bits (mod 2^64)."""
    phys = t.physical_dtype()
    if phys == torch.uint64 and acc.dtype == torch.int64:
        return acc.view(torch.uint64)
    return acc.to(phys)


def high_words(x: torch.Tensor, unsigned64: bool = False) -> torch.Tensor:
    """The high 32 bits of an integer column's int64 values (uint64 bit
    patterns when ``unsigned64``), as int64. Their sum cannot wrap over
    fewer than 2^31 rows, and with the wrapping int64 sum it gives the
    exact sum: ``mean_from_words``."""
    hi = x >> 32
    return hi & 0xFFFFFFFF if unsigned64 else hi


def mean_from_words(hi: torch.Tensor, wrapped: torch.Tensor,
                    count: torch.Tensor) -> torch.Tensor:
    """float64 mean of the exact sum of values whose int64 sum wraps to
    ``wrapped`` and whose high words sum to ``hi`` (``high_words``), over
    ``count`` (1 where it is 0). The exact sum is ``hi * 2^32 + lo`` with
    lo the sum of the low words, in [0, count * 2^32): lo is ``wrapped -
    hi * 2^32`` mod 2^64. A sum within 2^53 is one float64 division, as
    sum / count; a larger one takes its integer quotient exactly and
    rounds only the fraction, within an ulp of the exact mean."""
    lo = wrapped - (hi << 32)
    n = count.clamp(min=1).to(torch.int64)
    nf = n.to(torch.float64)
    small = (hi.abs() < 1 << 20) & (lo < 1 << 52)
    direct = (hi * (1 << 32) + lo).to(torch.float64) / nf
    qh = torch.div(hi, n, rounding_mode="floor")
    rest = (hi - qh * n) * (1 << 32) + lo   # in [0, n * 2^33)
    qr = torch.div(rest, n, rounding_mode="floor")
    frac = (rest - qr * n).to(torch.float64) / nf
    split = qh.to(torch.float64) * float(1 << 32) + (qr.to(torch.float64)
                                                     + frac)
    return torch.where(small, direct, split)


def _float_values(col: Column) -> torch.Tensor:
    """The values as float64, 0.0 at nulls."""
    x = col.data.to(torch.float64)
    return x if col.validity is None else torch.where(col.validity, x, 0.0)


def _accumulator(col: Column, fill: int) -> torch.Tensor:
    """The valid values (``fill`` elsewhere) in the sum's accumulator:
    int64 for integers and bools, float64 for floats."""
    x = col.data.to(torch.float64) if col.dtype.is_floating else \
        as_int64(col.data)
    return x if col.validity is None else torch.where(col.validity, x, fill)


def _count_exec(args, options: CountOptions, ctx):
    (col,) = args
    options = options or CountOptions()
    if options.mode == "only_valid":
        v = _valid_count(col)
    elif options.mode == "only_null":
        v = col.length - _valid_count(col)
    elif options.mode == "all":
        v = col.length
    else:
        raise Invalid(f"bad count mode {options.mode!r}")
    return Scalar(v, dt.int64)


register_function("count", "aggregate", 1, CountOptions)(_count_exec)


def _sum_exec(args, options: ScalarAggregateOptions, ctx):
    (col,) = args
    options = options or ScalarAggregateOptions()
    if col.dtype.is_decimal:
        out_t = decimal_sum_type(col.dtype)
        if _null_result(col, options):
            return Scalar(0, out_t, is_valid=False)
        return Scalar(decimal_exact_sum(col), out_t)
    out_t = _sum_output_type(col.dtype)
    if _null_result(col, options):
        return Scalar(0, out_t, is_valid=False)
    return Scalar(_as_type(_accumulator(col, 0).sum(), out_t), out_t)


register_function("sum", "aggregate", 1, ScalarAggregateOptions)(_sum_exec)


def _decimal_product(col: Column) -> int:
    """The valid values multiplied in row order on the host, rounded half
    away from zero to the scale after each step (the JAX package's fold,
    which matches pyarrow); past the precision raises."""
    from ..column import unscaled_ints

    s, t = col.dtype.scale, col.dtype
    acc = 1 if not s else None
    valid = col.mask().tolist()
    for v, ok in zip(unscaled_ints(col), valid):
        if ok:
            acc = v if acc is None else round_half_away(acc * v, 10 ** s)
    acc = 10 ** s if acc is None else acc
    if abs(acc) >= 10 ** t.precision:
        raise Invalid("decimal product overflow")
    return acc


def _product_exec(args, options: ScalarAggregateOptions, ctx):
    (col,) = args
    options = options or ScalarAggregateOptions()
    if col.dtype.is_decimal:   # pyarrow keeps the input type
        if _null_result(col, options):
            return Scalar(0, col.dtype, is_valid=False)
        return Scalar(_decimal_product(col), col.dtype)
    out_t = _sum_output_type(col.dtype)
    if _null_result(col, options):
        return Scalar(0, out_t, is_valid=False)
    return Scalar(_as_type(_accumulator(col, 1).prod(), out_t), out_t)


register_function("product", "aggregate", 1, ScalarAggregateOptions)(
    _product_exec)


def _mean_exec(args, options: ScalarAggregateOptions, ctx):
    (col,) = args
    options = options or ScalarAggregateOptions()
    nvalid = _valid_count(col)
    if col.dtype.is_decimal:   # pyarrow: the input type, rounded
        if _null_result(col, options) or nvalid == 0:
            return Scalar(0, col.dtype, is_valid=False)
        return Scalar(round_half_away(decimal_exact_sum(col), nvalid),
                      col.dtype)
    if _null_result(col, options):
        return Scalar(0.0, dt.float64, is_valid=False)
    return Scalar(_float_values(col).sum() / nvalid if nvalid else
                  float("nan"), dt.float64)


register_function("mean", "aggregate", 1, ScalarAggregateOptions)(_mean_exec)


def _one(x: torch.Tensor, t: dt.DataType, col: Column) -> Column:
    return Column(x.reshape(1).to(t.physical_dtype()), t,
                  dictionary=col.dictionary)


def _min_max_exec(args, options: ScalarAggregateOptions, ctx):
    """A one-row RecordBatch{min, max} (the reference returns a
    StructScalar, api_aggregate.h MinMax)."""
    (col,) = args
    options = options or ScalarAggregateOptions()
    t = col.dtype
    if _null_result(col, options) or _valid_count(col) == 0:
        def null():
            return Column(torch.zeros(1, dtype=t.physical_dtype(),
                                      device=col.device), t,
                          validity=torch.zeros(1, dtype=torch.bool,
                                               device=col.device),
                          dictionary=col.dictionary,
                          data2=None if col.data2 is None else
                          col.data2.new_zeros((1,) + col.data2.shape[1:]))

        return RecordBatch((null(), null()), ("min", "max"))
    m = col.mask()
    if t.is_decimal:
        return RecordBatch((_decimal_extreme(col, True),
                            _decimal_extreme(col, False)), ("min", "max"))
    if t.is_binary:
        rank = torch.from_numpy(col.dictionary.rank.astype(np.int64)).to(
            col.device)
        r = rank[col.data.to(torch.int64)]
        big = torch.iinfo(torch.int64).max
        inv = torch.argsort(rank)
        lo = inv[torch.where(m, r, big).min()]
        hi = inv[torch.where(m, r, -1).max()]
    elif t.is_floating:
        # NaN is skipped unless every valid value is NaN (numpy nanmin).
        # Of values that tie (-0.0 and +0.0) the first is taken, as
        # pyarrow does
        x = col.data
        ok = m & ~torch.isnan(x)
        nan = torch.tensor(float("nan"), dtype=x.dtype, device=col.device)

        def first_of(extreme):
            first = torch.argmax((ok & (x == extreme)).to(torch.uint8))
            return torch.where(ok.any(), x[first], nan)

        lo = first_of(torch.where(ok, x, float("inf")).min())
        hi = first_of(torch.where(ok, x, float("-inf")).max())
    elif t.is_boolean:
        lo = torch.where(m, col.data, True).all()
        hi = torch.where(m, col.data, False).any()
    else:
        y, back = minmax_domain(col.data)
        info = torch.iinfo(y.dtype)
        lo = back(torch.where(m, y, info.max).min())
        hi = back(torch.where(m, y, info.min).max())
    return RecordBatch((_one(lo, t, col), _one(hi, t, col)), ("min", "max"))


register_function("min_max", "aggregate", 1, ScalarAggregateOptions)(
    _min_max_exec)


def _decimal_extreme(col: Column, is_min: bool) -> Column:
    """The min or max of a decimal column, one row: limb by limb from the
    top (sign bit flipped), each limb's extreme among the rows that tie on
    the limbs above it (reference: aggregate.py's lexicographic pass)."""
    from .decimal import column_limbs, pack
    from .decimal256 import SIGN

    limbs = column_limbs(col)
    sel = col.mask()
    out = [None] * len(limbs)
    for i in range(len(limbs) - 1, -1, -1):
        k = limbs[i] if i == len(limbs) - 1 else limbs[i] ^ SIGN
        fill = torch.iinfo(torch.int64).max if is_min else \
            torch.iinfo(torch.int64).min
        v = torch.where(sel, k, fill)
        e = v.min() if is_min else v.max()
        sel = sel & (k == e)
        out[i] = (e if i == len(limbs) - 1 else e ^ SIGN).reshape(1)
    return pack(out, col.dtype, None)


def _mm_scalar(c: Column) -> Scalar:
    valid = c.validity is None or bool(c.validity[0])
    if c.dtype.is_decimal:
        from ..column import unscaled_ints

        return Scalar(unscaled_ints(c)[0], c.dtype, is_valid=valid)
    return Scalar(c.data[0], c.dtype, is_valid=valid,
                  dictionary=c.dictionary)


def _min_exec(args, options, ctx):
    return _mm_scalar(_min_max_exec(args, options, ctx)["min"])


def _max_exec(args, options, ctx):
    return _mm_scalar(_min_max_exec(args, options, ctx)["max"])


register_function("min", "aggregate", 1, ScalarAggregateOptions)(_min_exec)
register_function("max", "aggregate", 1, ScalarAggregateOptions)(_max_exec)


def _any_all(name: str, is_any: bool):
    def exec_fn(args, options: ScalarAggregateOptions, ctx):
        (col,) = args
        options = options or ScalarAggregateOptions()
        if not col.dtype.is_boolean:
            raise Invalid(f"{name}: expects boolean")
        if _valid_count(col) < options.min_count:
            return Scalar(False, dt.bool_, is_valid=False)
        x = col.data if col.validity is None else \
            torch.where(col.validity, col.data, not is_any)
        r = bool(x.any() if is_any else x.all())
        if not options.skip_nulls and r != is_any and \
                _valid_count(col) < col.length:
            # Kleene: a null decides unless a valid value already did
            return Scalar(False, dt.bool_, is_valid=False)
        return Scalar(r, dt.bool_)

    return exec_fn


register_function("any", "aggregate", 1, ScalarAggregateOptions)(
    _any_all("any", True))
register_function("all", "aggregate", 1, ScalarAggregateOptions)(
    _any_all("all", False))


def _drop_nan(col: Column) -> Column:
    """NaN counts as missing for order statistics (reference:
    aggregate_quantile.cc treats NaN like null)."""
    if not col.dtype.is_floating:
        return col
    ok = ~torch.isnan(col.data)
    return Column(col.data, col.dtype,
                  validity=ok if col.validity is None else
                  (col.validity & ok))


def _var_std(is_std: bool):
    def exec_fn(args, options: VarianceOptions, ctx):
        (col,) = args
        col = _as_float_if_decimal(col)
        options = options or VarianceOptions()
        nvalid = _valid_count(col)
        if nvalid <= options.ddof or nvalid == 0 or \
                _null_result(col, options):
            return Scalar(0.0, dt.float64, is_valid=False)
        x = _float_values(col)
        mean = x.sum() / nvalid
        sq = torch.where(col.mask(), (x - mean) ** 2, 0.0)
        var = sq.sum() / (nvalid - options.ddof)
        return Scalar(torch.sqrt(var) if is_std else var, dt.float64)

    return exec_fn


register_function("variance", "aggregate", 1, VarianceOptions)(
    _var_std(False))
register_function("stddev", "aggregate", 1, VarianceOptions)(_var_std(True))


def _sorted_valid(col: Column):
    """The column's values in ascending order as float64 (valid values
    first, then NaN, then nulls) and the valid count."""
    from .sort import normalize_sort_key, sort_indices_device

    perm = sort_indices_device(normalize_sort_key(col))
    return col.data[perm].to(torch.float64), _valid_count(col)


def _quantile_values(col: Column, qs, interpolation: str):
    data, nvalid = _sorted_valid(col)
    out = []
    for q in qs:
        if not 0.0 <= q <= 1.0:
            raise Invalid(f"quantile q out of range: {q}")
        pos = q * (nvalid - 1)
        lo_i = int(np.floor(pos))
        hi_i = int(np.ceil(pos))
        lo, hi = data[lo_i], data[hi_i]
        if interpolation == "linear":
            frac = pos - lo_i
            v = lo * (1 - frac) + hi * frac
        elif interpolation == "lower":
            v = lo
        elif interpolation == "higher":
            v = hi
        elif interpolation == "midpoint":
            v = (lo + hi) / 2
        elif interpolation == "nearest":
            v = lo if (pos - lo_i) <= 0.5 else hi
        else:
            raise Invalid(f"bad interpolation {interpolation!r}")
        out.append(v)
    return out


def _quantile_exec(args, options: QuantileOptions, ctx):
    (col,) = args
    options = options or QuantileOptions()
    spoilt = _null_result(col, options)
    col = _drop_nan(_as_float_if_decimal(col))
    nvalid = _valid_count(col)
    if nvalid == 0 or nvalid < options.min_count or spoilt:
        k = len(options.q)
        return Column(torch.zeros(k, dtype=torch.float64, device=col.device),
                      dt.float64, validity=torch.zeros(
                          k, dtype=torch.bool, device=col.device))
    vals = torch.stack(_quantile_values(col, options.q,
                                        options.interpolation))
    # lower/higher/nearest keep an integer input's type (reference:
    # aggregate_quantile.cc output type logic); the rest are float64
    if options.interpolation in ("lower", "higher", "nearest") and \
            not col.dtype.is_floating:
        return Column(vals.to(col.dtype.physical_dtype()), col.dtype)
    return Column(vals, dt.float64)


register_function("quantile", "aggregate", 1, QuantileOptions)(_quantile_exec)


def _tdigest_exec(args, options: TDigestOptions, ctx):
    """The exact linear-interpolated quantiles, float64 (reference
    ``_tdigest_exec``). With no valid value each quantile is null, as in
    pyarrow (the JAX package gives an empty column: ROADMAP Queue 3)."""
    (col,) = args
    options = options or TDigestOptions()
    spoilt = _null_result(col, options)
    col = _drop_nan(_as_float_if_decimal(col))
    if _valid_count(col) == 0 or spoilt:
        k = len(options.q)
        return Column(torch.zeros(k, dtype=torch.float64, device=col.device),
                      dt.float64, validity=torch.zeros(
                          k, dtype=torch.bool, device=col.device))
    return Column(torch.stack(_quantile_values(col, options.q, "linear")),
                  dt.float64)


register_function("tdigest", "aggregate", 1, TDigestOptions)(_tdigest_exec)


def _mode_exec(args, options: ModeOptions, ctx):
    """RecordBatch{mode, count}: the n most frequent values, ties to the
    smaller value (reference: aggregate_mode.cc)."""
    from .hash import grouping_by_keys, grouping_key_pairs
    from .selection import take_column
    from .sort import normalize_sort_key, sort_indices_device

    (col,) = args
    options = options or ModeOptions()
    if _valid_count(col) == 0 or _null_result(col, options):
        t = col.dtype
        return RecordBatch(
            (Column(torch.zeros(0, dtype=t.physical_dtype(),
                                device=col.device), t,
                    dictionary=col.dictionary,
                    data2=None if col.data2 is None else
                    col.data2[:0]),
             Column(torch.zeros(0, dtype=torch.int64, device=col.device),
                    dt.int64)), ("mode", "count"))
    keys = col
    if col.dtype.is_floating:   # 0.0 and -0.0 are one value, as in pyarrow
        keys = Column(torch.where(col.data == 0, 0.0, col.data).to(
            col.data.dtype), col.dtype, validity=col.validity)
    gids, reps, ngroups = grouping_by_keys(grouping_key_pairs(keys))
    counts = torch.zeros(ngroups, dtype=torch.int64, device=col.device)
    counts.index_add_(0, gids.to(torch.int64),
                      torch.ones(col.length, dtype=torch.int64,
                                 device=col.device))
    rep_valid = col.mask()[reps]
    order = sort_indices_device([
        (~rep_valid).to(torch.int64),         # nulls last
        ~counts,                              # count descending
        # value ascending, NaN after every number (its class key)
        *[k[reps] for k in normalize_sort_key(col)],
    ])
    top = order[:min(options.n, int(rep_valid.sum()))]
    return RecordBatch((take_column(col, reps[top]),
                        Column(counts[top], dt.int64)), ("mode", "count"))


register_function("mode", "aggregate", 1, ModeOptions)(_mode_exec)


@dataclasses.dataclass
class IndexOptions:
    """Reference: api_aggregate.h IndexOptions (target value)."""

    value: object = None


def _index_exec(args, options, ctx):
    """index(values, value) or index(values, options=IndexOptions(value)):
    the first position holding the value, or -1."""
    from ..datum import as_datum

    if len(args) == 2:
        values, target = args
    elif len(args) == 1 and options is not None and \
            options.value is not None:
        values, target = args[0], as_datum(options.value)
    else:
        raise Invalid("index: needs a value argument or IndexOptions.value")
    if not isinstance(target, Scalar):
        raise Invalid("index: the value to find must be a scalar")
    if values.dtype.is_decimal:
        from .decimal import decimal_compare

        hit = decimal_compare(values, target, "equal")
        hit = hit.data & hit.mask()
    elif values.dtype.is_binary:
        sval = target.as_py()
        codes = np.flatnonzero(values.dictionary.values == sval)
        hit = values.data == (int(codes[0]) if len(codes) else -1)
    else:
        x, _ = minmax_domain(values.data)
        t, _ = minmax_domain(value_of(target, values.dtype).to(
            values.device))
        hit = x == t
    if values.validity is not None:
        hit = hit & values.validity
    pos = torch.nonzero(hit)
    return Scalar(int(pos[0, 0]) if len(pos) else -1, dt.int64)


register_function("index", "aggregate", -1, IndexOptions)(_index_exec)


def _first_last_idx(col: Column):
    """Positions of the first and last valid rows (-1 when none)."""
    if col.validity is None:
        return (0, col.length - 1) if col.length else (-1, -1)
    idx = torch.nonzero(col.validity).squeeze(1)
    if not len(idx):
        return -1, -1
    return int(idx[0]), int(idx[-1])


def _value_scalar(col: Column, i: int) -> Scalar:
    if i < 0:
        return Scalar(0, col.dtype, is_valid=False)
    if col.dtype.is_decimal:
        from ..column import unscaled_ints

        return Scalar(unscaled_ints(col.slice(i, 1))[0], col.dtype)
    if col.dictionary is not None:
        return Scalar(col.dictionary.values[int(col.data[i])], col.dtype)
    return Scalar(col.data[i], col.dtype)


def _first_exec(args, options: ScalarAggregateOptions, ctx):
    """Reference: "first" scalar aggregate (aggregate_basic.cc FirstLast)."""
    (col,) = args
    return _value_scalar(col, _first_last_idx(col)[0])


def _last_exec(args, options: ScalarAggregateOptions, ctx):
    (col,) = args
    return _value_scalar(col, _first_last_idx(col)[1])


def _first_last_exec(args, options: ScalarAggregateOptions, ctx):
    """A one-row RecordBatch{first, last} (the reference returns a
    StructScalar)."""
    (col,) = args

    def one_row(k):
        if k >= 0:
            return col.slice(k, 1)
        return Column(torch.zeros(1, dtype=col.dtype.physical_dtype(),
                                  device=col.device), col.dtype,
                      validity=torch.zeros(1, dtype=torch.bool,
                                           device=col.device),
                      dictionary=col.dictionary,
                      data2=None if col.data2 is None else
                      torch.zeros_like(col.data2[:1]))

    i, j = _first_last_idx(col)
    return RecordBatch((one_row(i), one_row(j)), ("first", "last"))


register_function("first", "aggregate", 1, ScalarAggregateOptions)(
    _first_exec)
register_function("last", "aggregate", 1, ScalarAggregateOptions)(
    _last_exec)
register_function("first_last", "aggregate", 1, ScalarAggregateOptions)(
    _first_last_exec)


def _count_all_exec(args, options, ctx):
    """Row count (reference: "count_all")."""
    return Scalar(args[0].length if args else 0, dt.int64)


register_function("count_all", "aggregate", -1)(_count_all_exec)


def _count_distinct_exec(args, options: CountOptions, ctx):
    from .hash import grouping_by_keys, grouping_key_pairs

    (col,) = args
    options = options or CountOptions()
    _, _, ng = grouping_by_keys(grouping_key_pairs(col))
    if options.mode == "all" or col.validity is None:
        return Scalar(ng, dt.int64)
    # only_valid: the nulls, if any, formed one group
    return Scalar(ng - int(bool((~col.validity).any())), dt.int64)


register_function("count_distinct", "aggregate", 1, CountOptions)(
    _count_distinct_exec)


@dataclasses.dataclass
class SkewOptions:
    skip_nulls: bool = True
    biased: bool = True
    min_count: int = 0


def _central_moments(col: Column):
    col = _as_float_if_decimal(col)
    x = _float_values(col)
    nv = _valid_count(col)
    if nv == 0:
        return 0, None, None, None
    mean = x.sum() / nv
    d = torch.where(col.mask(), x - mean, 0.0)
    return nv, (d * d).sum() / nv, (d * d * d).sum() / nv, \
        (d * d * d * d).sum() / nv


def _skew_exec(args, options: SkewOptions, ctx):
    """Reference: "skew" -- biased g1 = m3 / m2^1.5; unbiased multiplies
    by sqrt(n(n-1))/(n-2)."""
    (col,) = args
    options = options or SkewOptions()
    nv, m2, m3, _ = _central_moments(col)
    if nv < (2 if options.biased else 3) or _null_result(col, options):
        return Scalar(0.0, dt.float64, is_valid=False)
    g1 = m3 / torch.clamp(m2, min=1e-300) ** 1.5
    if not options.biased:
        g1 = g1 * np.sqrt(float(nv * (nv - 1))) / (nv - 2)
    return Scalar(g1, dt.float64)


def _kurtosis_exec(args, options: SkewOptions, ctx):
    """Biased g2 = m4/m2^2 - 3; unbiased with Fisher's correction."""
    (col,) = args
    options = options or SkewOptions()
    nv, m2, _, m4 = _central_moments(col)
    if nv < (2 if options.biased else 4) or _null_result(col, options):
        return Scalar(0.0, dt.float64, is_valid=False)
    g2 = m4 / torch.clamp(m2 * m2, min=1e-300) - 3.0
    if not options.biased:
        n = float(nv)
        g2 = ((n + 1) * g2 + 6) * (n - 1) / ((n - 2) * (n - 3))
    return Scalar(g2, dt.float64)


register_function("skew", "aggregate", 1, SkewOptions)(_skew_exec)
register_function("kurtosis", "aggregate", 1, SkewOptions)(_kurtosis_exec)


def _approximate_median_exec(args, options: ScalarAggregateOptions, ctx):
    """Reference: approximate_median (t-digest backed); the exact median
    is within its contract."""
    (col,) = args
    options = options or ScalarAggregateOptions()
    spoilt = _null_result(col, options)
    col = _drop_nan(_as_float_if_decimal(col))
    if _valid_count(col) == 0 or spoilt:
        return Scalar(0.0, dt.float64, is_valid=False)
    (q,) = _quantile_values(col, [0.5], "linear")
    return Scalar(q, dt.float64)


register_function("approximate_median", "aggregate", 1,
                  ScalarAggregateOptions)(_approximate_median_exec)


@dataclasses.dataclass
class WinsorizeOptions:
    lower_limit: float = 0.0
    upper_limit: float = 1.0


def _winsorize_exec(args, options: WinsorizeOptions, ctx):
    """Clamp values to the [lower_limit, upper_limit] quantiles
    (reference: vector "winsorize" kernel). The bounds are nearest-rank:
    the lower rounds half up, the upper half down, both toward the
    interior."""
    (col,) = args
    options = options or WinsorizeOptions()
    data, nvalid = _sorted_valid(col)
    lo = data[int(np.floor(options.lower_limit * (nvalid - 1) + 0.5))]
    hi = data[int(np.ceil(options.upper_limit * (nvalid - 1) - 0.5))]
    x = col.data if col.dtype.is_floating else col.data.to(torch.float64)
    return Column(torch.clamp(x, lo, hi).to(col.data.dtype), col.dtype,
                  validity=col.validity)


register_function("winsorize", "vector", 1, WinsorizeOptions)(
    _winsorize_exec)
