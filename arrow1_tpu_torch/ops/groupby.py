"""Hash aggregate: the eager group_by and the kernel-level hash_*
functions (counterpart of arrow1_tpu/ops/groupby.py).

Reference: cpp/src/arrow/compute/kernels/hash_aggregate.cc -- GrouperImpl
assigns dense group ids (:313-404), GroupedAggregators update per-group
state (:466-700), driven by the eager GroupBy loop (:890-966). Output
columns are "{column}_{fn}" followed by the key columns (pyarrow
TableGroupBy naming).

Two paths, chosen from the input exactly as the reference chooses them:

- ``_dense_key_group_by``: one integer or dictionary key whose range spans
  at most ``MAX_G`` slots and only sum/count/mean of integer columns. The
  group id is key - min(key); counts and exact mod-2^64 sums come from one
  call of the K3 kernel (kernels/segsum2.py). Groups come out in key
  order.
- the sorted path (``_grouped_seg``): a grouping sort (ops/hash.py), then
  every aggregate as a scan over the rows in key order read at the
  segment ends. Groups come out in first-appearance order.

Both orders are the reference's: callers treat group-by output as a set
of rows. The reference takes the dense path only on a TPU (its
``A1T_SEGSUM`` switch); the port takes it on every device, with K3's plain
version on the CPU.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column, ListColumn
from ..errors import Invalid
from ..kernels.segsum2 import MAX_G, segment_sums
from ..registry import register_function
from ..table import RecordBatch
from .aggregate import (TDigestOptions, _as_type, _sum_output_type,
                        decimal_sum_type, high_words, mean_from_words)
from .common import as_int64, minmax_domain
from .decimal import (decimal_to_float, digit_planes, group_extreme,
                      limbs_from_digit_sums, mean_limbs, pack)
from .hash import (group_ids_of, grouping_by_keys, grouping_from_ids,
                   grouping_full, grouping_key_pairs, segment_count,
                   segment_minmax, segment_sum)
from .selection import take_column
from .sort import normalize_sort_key, sort_indices_device

__all__ = ["group_by", "grouped_aggregate", "PivotWiderOptions"]


def _segment_count(valid, gids: torch.Tensor, ngroups: int) -> torch.Tensor:
    ones = torch.ones(gids.shape[0], dtype=torch.int64, device=gids.device) \
        if valid is None else valid.to(torch.int64)
    return torch.zeros(ngroups, dtype=torch.int64,
                       device=gids.device).index_add_(0, gids, ones)


def _minmax_fills(t: dt.DataType, y: torch.Tensor):
    """(identity of min, identity of max) in y's dtype."""
    if t.is_floating:
        return float("inf"), float("-inf")
    info = torch.iinfo(y.dtype)
    return info.max, info.min


def _all_nan(non_nan_count: torch.Tensor, has_valid: torch.Tensor):
    """The groups whose valid values are all NaN: their min and max are
    NaN, as pyarrow gives (NaN is otherwise skipped)."""
    return (non_nan_count == 0) & has_valid


def _grouped(col: Column, fn: str, gids: torch.Tensor, ngroups: int):
    """One grouped aggregate by scatters -> list of (suffix, Column).
    Float sums add each group's rows in a fixed order (a sort of the ids,
    then per-segment sums), not by float atomics."""
    t = col.dtype
    valid = col.validity
    gids = gids.to(torch.int64)
    dev = gids.device
    vcount = _segment_count(valid, gids, ngroups)

    def masked(x, fill):
        return x if valid is None else torch.where(valid, x, fill)

    sorted_ids = functools.cache(lambda: grouping_from_ids(gids, ngroups))

    def float_sum(x):
        return segment_sum(x, sorted_ids(), torch.float64)

    if t.is_decimal and fn in _DECIMAL_FLOAT_AGGS:
        return _grouped(decimal_to_float(col), fn, gids, ngroups)
    if t.is_decimal and fn in _DECIMAL_EXACT_AGGS:
        masked_digits = torch.stack(digit_planes(col))
        if valid is not None:
            masked_digits = torch.where(valid, masked_digits, 0)
        sums = torch.zeros((masked_digits.shape[0], ngroups),
                           dtype=torch.int64, device=dev).index_add_(
                               1, gids, masked_digits)
        return _decimal_results(col, fn, list(sums), vcount, gids, ngroups)
    if t.is_decimal and fn == "product":
        raise Invalid("group product: unsupported for decimal inputs")
    if fn == "count":
        return [("count", Column(vcount, dt.int64))]
    if fn == "count_all":
        return [("count_all", Column(_segment_count(None, gids, ngroups),
                                     dt.int64))]
    if fn in ("sum", "mean", "product"):
        if fn == "mean":
            out_t = dt.float64
            x = col.data.to(torch.float64)
        else:
            out_t = _sum_output_type(t)
            x = col.data.to(torch.float64) if t.is_floating else \
                as_int64(col.data)
        if fn == "product":
            acc = torch.ones(ngroups, dtype=x.dtype, device=dev)
            acc.scatter_reduce_(0, gids, masked(x, 1), "prod")
        elif x.is_floating_point():
            acc = float_sum(masked(x, 0.0))
        else:
            acc = torch.zeros(ngroups, dtype=x.dtype, device=dev)
            acc.index_add_(0, gids, masked(x, 0))
        if fn == "mean":
            acc = acc / vcount.clamp(min=1)
        return [(fn, Column(_as_type(acc, out_t), out_t,
                            validity=vcount > 0))]
    if fn in ("min", "max", "min_max"):
        if t.is_binary:
            rank = torch.from_numpy(col.dictionary.rank.astype(np.int64))
            y = rank.to(dev)[col.data.to(torch.int64)]
            big, small = torch.iinfo(torch.int64).max, -1
            back = None
        else:
            y, back = minmax_domain(col.data)
            big, small = _minmax_fills(t, y)
        y_min, y_max = masked(y, big), masked(y, small)
        gv = vcount > 0
        all_nan = None
        if t.is_floating:   # NaN-ignoring, as the scalar min_max
            nan = torch.isnan(y)
            y_min = torch.where(nan, big, y_min)
            y_max = torch.where(nan, small, y_max)
            all_nan = _all_nan(_segment_count(
                ~nan if valid is None else valid & ~nan, gids, ngroups), gv)

        def reduce(vals, fill, how):
            acc = torch.full((ngroups,), fill, dtype=y.dtype, device=dev)
            acc.scatter_reduce_(0, gids, vals, how)
            if all_nan is not None:
                acc = torch.where(all_nan, float("nan"), acc)
            if back is not None:
                return Column(back(acc), t, validity=gv)
            inv = torch.argsort(rank.to(dev))
            codes = inv[acc.clamp(0, max(len(col.dictionary) - 1, 0))]
            return Column(codes.to(col.data.dtype), t, validity=gv,
                          dictionary=col.dictionary)

        out = []
        if fn in ("min", "min_max"):
            out.append(("min", reduce(y_min, big, "amin")))
        if fn in ("max", "min_max"):
            out.append(("max", reduce(y_max, small, "amax")))
        return out
    if fn in ("variance", "stddev"):
        # two passes: the group's mean, then its squared deviations
        x = masked(col.data.to(torch.float64), 0.0)
        nvalid = vcount.to(torch.float64).clamp(min=1)
        mean = float_sum(x) / nvalid
        d = masked(x - mean[gids], 0.0)
        var = float_sum(d * d) / nvalid
        out = torch.sqrt(var) if fn == "stddev" else var
        return [(fn, Column(out, dt.float64, validity=vcount > 0))]
    if fn in ("any", "all"):
        if not t.is_boolean:
            raise Invalid(f"hash_{fn}: expects boolean")
        x = masked(col.data, fn == "all").to(torch.uint8)
        acc = torch.full((ngroups,), int(fn == "all"), dtype=torch.uint8,
                         device=dev)
        acc.scatter_reduce_(0, gids, x, "amax" if fn == "any" else "amin")
        return [(fn, Column(acc.to(torch.bool), dt.bool_,
                            validity=vcount > 0))]
    if fn == "count_distinct":
        # group by (group, value) pairs, then count the valid pairs per group
        _, reps2, _ = grouping_by_keys([(gids, 64)] +
                                       grouping_key_pairs(col))
        cnt = torch.zeros(ngroups, dtype=torch.int64, device=dev)
        cnt.index_add_(0, gids[reps2], col.mask()[reps2].to(torch.int64))
        return [("count_distinct", Column(cnt, dt.int64))]
    raise Invalid(f"unsupported grouped aggregate {fn!r}")


def grouped_aggregate(batch: RecordBatch, gids: torch.Tensor, ngroups: int,
                      aggregates: Sequence[Tuple[str, str]]) -> List:
    """Aggregates against precomputed group ids -> [(out_name, Column)]."""
    out = []
    for col_name, fn in aggregates:
        for suffix, res in _grouped(batch.column(col_name), fn, gids,
                                    ngroups):
            out.append((f"{col_name}_{suffix}", res))
    return out


def _hash_result(results):
    if len(results) == 1:
        return results[0][1]
    return RecordBatch(tuple(c for _, c in results),
                       tuple(s for s, _ in results))


def _num_groups(gids: Column) -> int:
    return max(int(gids.data.max()) + 1 if gids.length else 0, 1)


def _dense_ids(gids: Column, name: str) -> torch.Tensor:
    """The group ids of the nested-result hash kernels, int64: valid,
    integer and at least 0 (the JAX package reads any column's data)."""
    if not isinstance(gids, Column) or not gids.dtype.is_integer or \
            gids.validity is not None and not bool(gids.validity.all()):
        raise Invalid(f"{name}: group ids must be a non-null integer array")
    ids = dt.as_int64(gids.data)
    if gids.length and int(ids.min()) < 0:
        raise Invalid(f"{name}: group ids must be >= 0")
    return ids


def _register_hash_kernels():
    """The kernel-level hash-aggregate entry points over precomputed group
    ids (reference: hash_aggregate.cc:1039-1062)."""

    def make(fn_name):
        def exec_fn(args, options, ctx):
            values, gids = args
            return _hash_result(_grouped(values, fn_name, gids.data,
                                         _num_groups(gids)))

        return exec_fn

    for name, fn in [("hash_count", "count"), ("hash_sum", "sum"),
                     ("hash_min_max", "min_max"), ("hash_mean", "mean"),
                     ("hash_product", "product"), ("hash_min", "min"),
                     ("hash_max", "max"), ("hash_any", "any"),
                     ("hash_all", "all"),
                     ("hash_count_distinct", "count_distinct")]:
        register_function(name, "hash_aggregate", 2)(make(fn))

    def make_seg(fn_name):
        def exec_fn(args, options, ctx):
            values, gids = args
            g = grouping_from_ids(gids.data, _num_groups(gids))
            return _hash_result(_grouped_seg(values, fn_name, g))

        return exec_fn

    def make_list(fn_name):
        def exec_fn(args, options, ctx):
            values, gids = args
            return _grouped_list(values, _dense_ids(gids, f"hash_{fn_name}"),
                                 _num_groups(gids),
                                 distinct=fn_name == "distinct")

        return exec_fn

    for fn in ("list", "distinct"):
        register_function(f"hash_{fn}", "hash_aggregate", 2)(make_list(fn))

    for name, fn in [("hash_first", "first"), ("hash_last", "last"),
                     ("hash_one", "one"), ("hash_first_last", "first_last"),
                     ("hash_count_all", "count_all"),
                     ("hash_skew", "skew"), ("hash_kurtosis", "kurtosis"),
                     ("hash_variance", "variance"),
                     ("hash_stddev", "stddev"),
                     ("hash_approximate_median", "approximate_median")]:
        register_function(name, "hash_aggregate", 2)(make_seg(fn))


_register_hash_kernels()


def _grouped_seg(col: Column, fn: str, g, sorted_planes=None):
    """Sorted-space grouped aggregate: scans over the rows in key order
    read at the segment ends. ``sorted_planes=(data, validity or None)``
    are the column's planes already in ``g.order`` (they rode the grouping
    sort). Aggregates without a segment form take the scatter form."""
    t = col.dtype
    srt = sorted_planes is not None
    sdata, valid = sorted_planes if srt else (col.data, col.validity)
    ones = torch.ones(col.length, dtype=torch.bool, device=col.device)
    vcount = segment_count(ones if valid is None else valid, g,
                           sorted_=True if valid is None else srt)
    gv = vcount > 0

    def masked(x, fill):
        return x if valid is None else torch.where(valid, x, fill)

    if t.is_decimal and fn in _DECIMAL_FLOAT_AGGS:
        return _grouped_seg(decimal_to_float(col), fn, g)
    if t.is_decimal and fn in _DECIMAL_EXACT_AGGS:
        # one cumsum over every 32-bit digit plane, in key order
        digits = torch.stack(digit_planes(col))
        if col.validity is not None:
            digits = torch.where(col.validity, digits, 0)
        c = torch.cumsum(digits[:, g.order], 1)
        hi = c[:, g.seg_bounds[1:] - 1]
        starts = g.seg_bounds[:-1]
        lo = torch.where(starts > 0, c[:, (starts - 1).clamp(min=0)], 0)
        sums = (hi - lo)[:, g.appearance]
        return _decimal_results(col, fn, list(sums), vcount,
                                functools.cache(lambda: group_ids_of(g)),
                                g.num_groups)
    if fn == "count":
        return [("count", Column(vcount, dt.int64))]
    if fn == "count_all":
        return [("count_all", Column(segment_count(ones, g, sorted_=True),
                                     dt.int64))]
    if fn in ("sum", "mean"):
        if fn == "mean" or t.is_floating:
            x, acc_dt = sdata.to(torch.float64), torch.float64
        else:
            x, acc_dt = as_int64(sdata), torch.int64
        acc = segment_sum(masked(x, 0), g, acc_dt, sorted_=srt)
        if fn == "mean":
            return [("mean", Column(acc / vcount.clamp(min=1), dt.float64,
                                    validity=gv))]
        out_t = _sum_output_type(t)
        return [("sum", Column(_as_type(acc, out_t), out_t, validity=gv))]
    if fn in ("min", "max", "min_max") and not t.is_binary:
        y, back = minmax_domain(sdata)
        big, small = _minmax_fills(t, y)
        y_min = y_max = y
        finish = back
        if t.is_floating:   # NaN-skipping, as the scalar min_max
            nan = torch.isnan(y)
            y_min = torch.where(nan, big, y)
            y_max = torch.where(nan, small, y)
            all_nan = _all_nan(segment_count(
                ~nan if valid is None else valid & ~nan, g, sorted_=srt), gv)
            finish = (lambda r: torch.where(all_nan, float("nan"), r))
        out = []
        if fn in ("min", "min_max"):
            out.append(("min", Column(finish(segment_minmax(
                masked(y_min, big), g, True, sorted_=srt)), t, validity=gv)))
        if fn in ("max", "min_max"):
            out.append(("max", Column(finish(segment_minmax(
                masked(y_max, small), g, False, sorted_=srt)), t,
                validity=gv)))
        return out
    if fn in ("variance", "stddev"):
        # two passes: the group's mean, then its squared deviations
        nv = vcount.to(torch.float64).clamp(min=1)
        d = _deviations(sdata, valid, srt, g, nv)
        var = segment_sum(d * d, g, torch.float64, sorted_=True) / nv
        out = torch.sqrt(var) if fn == "stddev" else var
        return [(fn, Column(out, dt.float64, validity=gv))]
    if fn in ("first", "last", "one", "first_last"):
        # the first/last valid row of a group: segment min/max of the row
        n = col.length
        rowid = g.order if srt else torch.arange(n, device=col.device)

        def pick(is_first):
            x = masked(rowid, n if is_first else -1)
            idx = segment_minmax(x, g, is_first, sorted_=srt)
            got = take_column(col, idx.clamp(0, max(n - 1, 0)))
            return Column(got.data, t, validity=gv,
                          dictionary=got.dictionary, data2=got.data2)

        out = []
        if fn in ("first", "one", "first_last"):
            out.append(("one" if fn == "one" else "first", pick(True)))
        if fn in ("last", "first_last"):
            out.append(("last", pick(False)))
        return out
    if fn in ("skew", "kurtosis"):
        # central moments from each row's deviation from its group's mean
        nv = vcount.to(torch.float64).clamp(min=1)
        d = _deviations(sdata, valid, srt, g, nv)
        d2 = d * d
        m2 = segment_sum(d2, g, torch.float64, sorted_=True) / nv
        if fn == "skew":
            m3 = segment_sum(d2 * d, g, torch.float64, sorted_=True) / nv
            out = m3 / m2.clamp(min=1e-300) ** 1.5
        else:
            m4 = segment_sum(d2 * d2, g, torch.float64, sorted_=True) / nv
            out = m4 / (m2 * m2).clamp(min=1e-300) - 3.0
        return [(fn, Column(out, dt.float64, validity=vcount >= 2))]
    if fn == "approximate_median":
        return [("approximate_median", _grouped_median(col, g))]
    if fn in ("list", "distinct"):
        return [(fn, _grouped_list(col, group_ids_of(g), g.num_groups,
                                   distinct=fn == "distinct"))]
    # binary min/max, any/all, count_distinct, product: scatter form
    return _grouped(col, fn, group_ids_of(g), g.num_groups)


def _deviations(data, valid, srt: bool, g, nv: torch.Tensor):
    """Each row's float64 value less its group's mean, in key order (0.0
    at nulls): the first of the two passes of a grouped variance, skew or
    kurtosis, which therefore do not cancel (ROADMAP Queue 3, repaired)."""
    xs = (data if srt else data[g.order]).to(torch.float64)
    vs = valid if valid is None or srt else valid[g.order]
    if vs is not None:
        xs = torch.where(vs, xs, 0.0)
    mean = segment_sum(xs, g, torch.float64, sorted_=True) / nv
    # each sorted row's segment (a group of no row is an empty segment)
    seg = torch.searchsorted(g.seg_bounds[1:], torch.arange(
        xs.shape[0], device=xs.device), right=True)
    d = xs - mean[g.appearance_rank[seg]]
    return d if vs is None else torch.where(vs, d, 0.0)


_DECIMAL_FLOAT_AGGS = frozenset(["variance", "stddev", "approximate_median",
                                 "skew", "kurtosis"])
_DECIMAL_EXACT_AGGS = frozenset(["sum", "mean", "min", "max", "min_max"])


def _decimal_results(col: Column, fn: str, digit_sums, vcount, gids,
                     ngroups: int):
    """A grouped decimal sum (decimal128(38, s) or decimal256(76, s), as
    pyarrow's), mean (the input type, rounded half away from zero, as
    pyarrow's; the JAX package gives decimal128(38, s)), min or max, from
    the per-group digit sums (sum, mean) or group ids (a tensor or a
    function that makes one: min, max)."""
    t = col.dtype
    gv = vcount > 0
    if fn == "sum":
        return [("sum", pack(limbs_from_digit_sums(digit_sums),
                             decimal_sum_type(t), gv))]
    if fn == "mean":
        total = limbs_from_digit_sums(digit_sums)
        return [("mean", pack(mean_limbs(total, vcount.clamp(min=1)), t,
                              gv))]
    ids = gids() if callable(gids) else gids
    out = []
    for name, is_min in (("min", True), ("max", False)):
        if fn in (name, "min_max"):
            out.append((name, pack(group_extreme(col, ids, ngroups, is_min),
                                   t, gv)))
    return out


def _grouped_median(col: Column, g) -> Column:
    """Exact per-group median (the reference's approximate_median is
    t-digest backed; exact is within its contract)."""
    n = col.length
    gids0 = group_ids_of(g).to(torch.int64)
    ord2 = sort_indices_device([gids0] + normalize_sort_key(col))
    gid2 = gids0[ord2]
    # valid rows sort before nulls within a group (null class key), so
    # the valid prefix of each segment is contiguous
    bounds = torch.searchsorted(gid2, torch.arange(g.num_groups + 1,
                                                   device=col.device))
    nv = segment_count(col.mask(), g)
    data2 = col.data[ord2].to(torch.float64)
    mid = bounds[:-1].to(torch.float64) + (nv.to(torch.float64) - 1) / 2.0
    lo = torch.floor(mid).to(torch.int64).clamp(0, max(n - 1, 0))
    hi = torch.ceil(mid).to(torch.int64).clamp(0, max(n - 1, 0))
    return Column((data2[lo] + data2[hi]) / 2.0, dt.float64,
                  validity=nv > 0)


def _grouped_list(col, gids: torch.Tensor, ngroups: int,
                  distinct: bool) -> ListColumn:
    """Each group's values as a list, in row order (reference: hash_list);
    ``distinct`` keeps each group's first row of every distinct non-null
    value (hash_distinct, as pyarrow's default only_valid). The
    distinct pairs (group, value) are a grouping of their own: its
    segment starts come from K2. The rows then go to their groups by one
    stable sort of their group ids; the offsets count each group's rows."""
    gids = gids.to(torch.int64)
    if distinct:
        _, rows, _ = grouping_by_keys([(gids, 64)] +
                                      grouping_key_pairs(col))
        if col.validity is not None:
            rows = rows[col.validity[rows]]
        # first rows come out in row order: the sort below keeps it
    else:
        rows = torch.arange(col.length, device=col.device)
    rg = gids[rows]
    order = torch.sort(rg, stable=True).indices
    counts = torch.zeros(ngroups, dtype=torch.int64,
                         device=col.device).index_add_(
                             0, rg, torch.ones_like(rg))
    offsets = torch.zeros(ngroups + 1, dtype=torch.int64,
                          device=col.device)
    torch.cumsum(counts, 0, out=offsets[1:])
    return ListColumn(offsets, take_column(col, rows[order]),
                      dt.list_(col.dtype))


def _hash_tdigest_exec(args, options: TDigestOptions, ctx):
    """Each group's exact quantiles at ``q`` (linear interpolation), as a
    list of float64 (reference: hash_tdigest, which a t-digest
    approximates); a group with no valid value gives nulls, as pyarrow's
    (the JAX package reads past its segment: ROADMAP Queue 3). The list
    type is the JAX package's (pyarrow's is fixed_size_list)."""
    values, gids = args
    options = options or TDigestOptions()
    qs = [options.q] if isinstance(options.q, (int, float)) \
        else list(options.q)
    ids = _dense_ids(gids, "hash_tdigest")
    ngroups = _num_groups(gids)
    g = grouping_from_ids(ids, ngroups)
    dev = values.device
    n = values.length
    order = sort_indices_device([ids] + normalize_sort_key(values))
    bounds = torch.searchsorted(ids[order],
                                torch.arange(ngroups + 1, device=dev))
    nv = segment_count(values.mask(), g)
    data = values.data[order].to(torch.float64)
    outs = []
    for q in qs:
        pos = bounds[:-1].to(torch.float64) + (nv.to(torch.float64) - 1) * q
        lo = torch.floor(pos).to(torch.int64).clamp(0, max(n - 1, 0))
        hi = torch.ceil(pos).to(torch.int64).clamp(0, max(n - 1, 0))
        frac = pos - torch.floor(pos)
        outs.append(data[lo] * (1 - frac) + data[hi] * frac)
    has = (nv > 0).repeat_interleave(len(qs))
    child = torch.stack(outs, 1).reshape(-1) if n else \
        torch.zeros(ngroups * len(qs), dtype=torch.float64, device=dev)
    offsets = torch.arange(ngroups + 1, device=dev) * len(qs)
    return ListColumn(offsets, Column(torch.where(has, child, 0.0),
                                      dt.float64, validity=has),
                      dt.list_(dt.float64))


register_function("hash_tdigest", "hash_aggregate", 2, TDigestOptions)(
    _hash_tdigest_exec)


@dataclasses.dataclass
class PivotWiderOptions:
    key_names: tuple = ()
    unexpected_key_behavior: str = "ignore"


def _pivot_pairs(keys_col: Column, values_col: Column, key_names,
                 gids: torch.Tensor, ngroups: int):
    """One column per key name: each group's value where the key is that
    name (at most one non-null value for a (group, key), else Invalid);
    null where there is none."""
    if keys_col.dictionary is None:
        raise Invalid("pivot_wider: keys must be strings")
    dev = values_col.device
    rows = torch.arange(values_col.length, device=dev)
    out = []
    for name in key_names:
        code = keys_col.dictionary.index.get(name, -1)
        hit = (keys_col.data == code) & keys_col.mask() & values_col.mask()
        dup = torch.zeros(ngroups, dtype=torch.int64, device=dev).index_add_(
            0, gids, hit.to(torch.int64))
        if bool((dup > 1).any()):
            raise Invalid("Encountered more than one non-null value for "
                          "the same pivot key")
        row = torch.full((ngroups + 1,), -1, dtype=torch.int64, device=dev
                         ).scatter_reduce(0, torch.where(hit, gids, ngroups),
                                          rows, "amax")[:ngroups]
        filled = dup > 0
        if values_col.length:
            got = take_column(values_col, row.clamp(min=0), filled)
        else:
            got = Column(values_col.data.new_zeros(ngroups),
                         values_col.dtype, validity=filled,
                         dictionary=values_col.dictionary)
        out.append((name, got))
    return RecordBatch(tuple(c for _, c in out), tuple(n for n, _ in out))


def _pivot_wider_exec(args, options: PivotWiderOptions, ctx):
    """The values as one row of one column per key name (reference:
    scalar pivot_wider)."""
    keys_col, values_col = args
    if options is None or not options.key_names:
        raise Invalid("pivot_wider requires key_names")
    return _pivot_pairs(keys_col, values_col, options.key_names,
                        torch.zeros(keys_col.length, dtype=torch.int64,
                                    device=keys_col.device), 1)


register_function("pivot_wider", "scalar", 2, PivotWiderOptions)(
    _pivot_wider_exec)


def _hash_pivot_wider_exec(args, options: PivotWiderOptions, ctx):
    """pivot_wider per group of precomputed ids: one row a group."""
    keys_col, values_col, gids = args
    if options is None or not options.key_names:
        raise Invalid("hash_pivot_wider requires key_names")
    ids = _dense_ids(gids, "hash_pivot_wider")
    return _pivot_pairs(keys_col, values_col, options.key_names, ids,
                        _num_groups(gids))


register_function("hash_pivot_wider", "hash_aggregate", 3,
                  PivotWiderOptions)(_hash_pivot_wider_exec)


_DENSE_AGGS = frozenset(["sum", "count", "mean"])


def _dense_key_group_by(batch: RecordBatch, keys: Sequence[str],
                        aggregates: Sequence[Tuple[str, str]]):
    """Sort-free group-by for one dense-range integer or dictionary key
    and sum/count/mean of integer columns (counterpart of
    arrow1_tpu/ops/groupby.py:_mxu_group_by): group id = key - min(key),
    with one more slot for the null key, and per-group counts and exact
    mod-2^64 sums from one K3 call (kernels/segsum2.py). Groups come out
    in key order.

    Returns a RecordBatch, or None on exactly the inputs where the
    reference declines (the caller then takes the sorted path)."""
    if len(keys) != 1:
        return None
    kc = batch.column(keys[0])
    if kc.data2 is not None:
        return None
    if kc.dictionary is None and not kc.dtype.is_integer:
        return None
    vals_needed = []   # distinct value columns that need sums
    for col_name, fn in aggregates:
        if fn not in _DENSE_AGGS:
            return None
        c = batch.column(col_name)
        if c.dictionary is not None or (c.data2 is not None and
                                        not c.dtype.is_decimal):
            return None
        if fn in ("sum", "mean"):
            if not (c.dtype.is_integer or c.dtype.is_decimal):
                return None
            if col_name not in vals_needed:
                vals_needed.append(col_name)
    n = kc.length
    if n == 0:
        return None
    if kc.data.dtype == torch.uint64 or any(
            batch.column(nm).data.dtype == torch.uint64
            for nm in vals_needed):
        return None   # int64-domain key ranges would mangle large u64
    kd = kc.data.to(torch.int64)
    kvalid = kc.validity
    if kvalid is None:
        red = [*torch.aminmax(kd), kd.new_ones(())]
    else:
        red = [torch.where(kvalid, kd, 1 << 62).min(),
               torch.where(kvalid, kd, -(1 << 62)).max(),
               kvalid.any().to(torch.int64)]
    # a mean's column range says whether its int64 sum can wrap
    mean_cols = list(dict.fromkeys(
        c for c, fn in aggregates
        if fn == "mean" and not batch.column(c).dtype.is_decimal))
    for nm in mean_cols:
        red.extend(torch.aminmax(as_int64(batch.column(nm).data)))
    kmin, kmax, any_valid_key, *ranges = torch.stack(red).tolist()
    if not any_valid_key:
        kmin = kmax = 0
    has_null_key = kvalid is not None
    R = kmax - kmin + 1
    G = -((R + (1 if has_null_key else 0)) // -128) * 128
    if G > MAX_G:
        return None
    gid = (kd - kmin).to(torch.int32)
    if kvalid is not None:
        gid = torch.where(kvalid, gid, R)

    # an integer column rides K3 as itself, a decimal as the 32-bit digit
    # planes of its limbs, whose sums cannot wrap (``digit_planes``)
    decimals = [nm for nm in vals_needed
                if batch.column(nm).dtype.is_decimal]
    vals_needed = [nm for nm in vals_needed if nm not in decimals]
    cols = [(as_int64(batch.column(nm).data), batch.column(nm).validity)
            for nm in vals_needed]
    # a mean whose sum can wrap adds its column's high words (their sum
    # cannot): the exact sum for its mean (``mean_from_words``)
    wide = [nm for nm, lo, hi in zip(mean_cols, ranges[::2], ranges[1::2])
            if max(-lo, hi) * n >= 1 << 63]
    for nm in wide:
        x, valid = cols[vals_needed.index(nm)]
        cols.append((high_words(x), valid))
    cnt_only = []   # count-only columns not already carried
    for col_name, fn in aggregates:
        if fn == "count" and col_name not in vals_needed and \
                col_name not in cnt_only and col_name not in decimals:
            cnt_only.append(col_name)
            cols.append((None, batch.column(col_name).validity))
    for nm in decimals:
        c = batch.column(nm)
        cols.extend((d, c.validity) for d in digit_planes(c))
    # a decimal's count is its first digit plane's
    names = vals_needed + [f"{nm}#hi" for nm in wide] + cnt_only + \
        [nm if j == 0 else f"{nm}#d{j}" for nm in decimals
         for j in range(2 * batch.column(nm).dtype.limbs)]
    col_index = {nm: i for i, nm in enumerate(names)}

    occ, results = segment_sums(gid, cols, G)
    idx = torch.nonzero(occ > 0).squeeze(1)   # sizes the output: a sync

    out_cols, out_names = [], []
    for col_name, fn in aggregates:
        cnt, s = results[col_index[col_name]]
        cnt_g = cnt[idx]
        c = batch.column(col_name)
        if fn == "count":
            out_cols.append(Column(cnt_g, dt.int64))
        elif c.dtype.is_decimal:
            sums = [results[col_index[col_name if j == 0 else
                                      f"{col_name}#d{j}"]][1][idx]
                    for j in range(2 * c.dtype.limbs)]
            out_cols.append(_decimal_results(c, fn, sums, cnt_g, None,
                                             0)[0][1])
        elif fn == "sum":
            out_t = _sum_output_type(batch.column(col_name).dtype)
            out_cols.append(Column(_as_type(s[idx], out_t), out_t,
                                   validity=cnt_g > 0))
        else:   # mean of the exact sum
            mean = s[idx].to(torch.float64) / \
                cnt_g.clamp(min=1).to(torch.float64) \
                if col_name not in wide else mean_from_words(
                    results[col_index[f"{col_name}#hi"]][1][idx], s[idx],
                    cnt_g)
            out_cols.append(Column(mean, dt.float64, validity=cnt_g > 0))
        out_names.append(f"{col_name}_{fn}")
    out_names.append(keys[0])
    out_cols.append(Column((kmin + idx).to(kc.data.dtype), kc.dtype,
                           validity=(idx != R) if has_null_key else None,
                           dictionary=kc.dictionary))
    return RecordBatch(tuple(out_cols), tuple(out_names))


def group_by(batch: RecordBatch, keys: Sequence[str],
             aggregates: Sequence[Tuple[str, str]]) -> RecordBatch:
    """Eager group-by (reference: internal::GroupBy hash_aggregate.cc:890;
    API shape: pyarrow TableGroupBy.aggregate).

    Output: aggregate columns named "{col}_{fn}", then the key columns.
    A single dense-range integer or dictionary key with sum/count/mean of
    integer columns runs sort-free through the K3 kernel, groups in key
    order (``_dense_key_group_by``); everything else runs in sorted space,
    groups in first-appearance order (``_grouped_seg``). Runs on the
    batch's device.
    """
    if not keys:
        raise Invalid("group_by requires at least one key")
    fast = _dense_key_group_by(batch, keys, aggregates)
    if fast is not None:
        return fast
    pairs = []
    for k in keys:
        pairs.extend(grouping_key_pairs(batch.column(k)))
    # plain aggregate inputs ride the grouping sort: one gather each
    plain = []
    for col_name, _ in aggregates:
        c = batch.column(col_name)
        if col_name not in plain and isinstance(c, Column) and \
                c.data2 is None and c.dictionary is None:
            plain.append(col_name)
    payloads = []
    for col_name in plain:
        c = batch.column(col_name)
        payloads.append(c.data)
        if c.validity is not None:
            payloads.append(c.validity)
    g, sorted_payloads = grouping_full(pairs, payloads)
    planes = {}
    it = iter(sorted_payloads)
    for col_name in plain:
        data_s = next(it)
        planes[col_name] = (data_s, next(it) if batch.column(
            col_name).validity is not None else None)
    cols, names = [], []
    for col_name, fn in aggregates:
        for suffix, res in _grouped_seg(batch.column(col_name), fn, g,
                                        sorted_planes=planes.get(col_name)):
            names.append(f"{col_name}_{suffix}")
            cols.append(res)
    for k in keys:
        names.append(k)
        cols.append(take_column(batch.column(k), g.rep_rows))
    return RecordBatch(tuple(cols), tuple(names))
