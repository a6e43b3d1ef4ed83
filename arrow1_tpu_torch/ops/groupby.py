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

import functools
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid, NotImplementedError_
from ..kernels.segsum2 import MAX_G, segment_sums
from ..registry import register_function
from ..table import RecordBatch
from .aggregate import (_as_type, _sum_output_type, high_words,
                        mean_from_words)
from .common import as_int64, minmax_domain
from .hash import (group_ids_of, grouping_by_keys, grouping_from_ids,
                   grouping_full, grouping_key_pairs, segment_count,
                   segment_minmax, segment_sum)
from .selection import take_column
from .sort import normalize_sort_key, sort_indices_device

__all__ = ["group_by", "grouped_aggregate"]

_NESTED = "is not ported yet: list results come with the nested slice " \
    "(ROADMAP Queue 1 item 9)"


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
        x = masked(col.data.to(torch.float64), 0.0)
        s1, s2 = float_sum(x), float_sum(x * x)
        nvalid = vcount.to(torch.float64).clamp(min=1)
        mean = s1 / nvalid
        var = (s2 / nvalid - mean * mean).clamp(min=0.0)
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
        x = masked(sdata.to(torch.float64), 0.0)
        s1 = segment_sum(x, g, torch.float64, sorted_=srt)
        s2 = segment_sum(x * x, g, torch.float64, sorted_=srt)
        nv = vcount.to(torch.float64).clamp(min=1)
        mean = s1 / nv
        var = (s2 / nv - mean * mean).clamp(min=0.0)
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
                          dictionary=got.dictionary)

        out = []
        if fn in ("first", "one", "first_last"):
            out.append(("one" if fn == "one" else "first", pick(True)))
        if fn in ("last", "first_last"):
            out.append(("last", pick(False)))
        return out
    if fn in ("skew", "kurtosis"):
        x = masked(sdata.to(torch.float64), 0.0)
        nv = vcount.to(torch.float64).clamp(min=1)
        s1 = segment_sum(x, g, torch.float64, sorted_=srt)
        s2 = segment_sum(x * x, g, torch.float64, sorted_=srt)
        s3 = segment_sum(x * x * x, g, torch.float64, sorted_=srt)
        mean = s1 / nv
        m2 = (s2 / nv - mean * mean).clamp(min=0.0)
        if fn == "skew":
            m3 = s3 / nv - 3 * mean * s2 / nv + 2 * mean ** 3
            out = m3 / m2.clamp(min=1e-300) ** 1.5
        else:
            s4 = segment_sum(x ** 4, g, torch.float64, sorted_=srt)
            m4 = (s4 / nv - 4 * mean * s3 / nv + 6 * mean * mean * s2 / nv
                  - 3 * mean ** 4)
            out = m4 / (m2 * m2).clamp(min=1e-300) - 3.0
        return [(fn, Column(out, dt.float64, validity=vcount >= 2))]
    if fn == "approximate_median":
        return [("approximate_median", _grouped_median(col, g))]
    if fn in ("list", "distinct"):
        raise NotImplementedError_(f"group {fn} {_NESTED}")
    # binary min/max, any/all, count_distinct, product: scatter form
    return _grouped(col, fn, group_ids_of(g), g.num_groups)


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
        if c.data2 is not None or c.dictionary is not None:
            return None
        if fn in ("sum", "mean"):
            if not c.dtype.is_integer:
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
    mean_cols = list(dict.fromkeys(c for c, fn in aggregates
                                   if fn == "mean"))
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
                col_name not in cnt_only:
            cnt_only.append(col_name)
            cols.append((None, batch.column(col_name).validity))
    names = vals_needed + [f"{nm}#hi" for nm in wide] + cnt_only
    col_index = {nm: i for i, nm in enumerate(names)}

    occ, results = segment_sums(gid, cols, G)
    idx = torch.nonzero(occ > 0).squeeze(1)   # sizes the output: a sync

    out_cols, out_names = [], []
    for col_name, fn in aggregates:
        cnt, s = results[col_index[col_name]]
        cnt_g = cnt[idx]
        if fn == "count":
            out_cols.append(Column(cnt_g, dt.int64))
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
        if col_name not in plain and c.data2 is None and \
                c.dictionary is None:
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
