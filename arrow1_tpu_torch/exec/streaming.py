"""Streaming (chunked) aggregation: consume per batch, finalize once
(counterpart of arrow1_tpu/exec/streaming.py).

Reference: the ScalarAggregator state machine (aggregate_internal.h:52)
and HashAggregateKernel consume/merge/finalize (kernel.h:637-676). Each
consume() reduces one device batch to small partials, left on the device;
finalize() merges them:

    sum:     total of the partial sums: exact in int64 (wrapping mod 2^64,
             as pyarrow's sum does) for integer columns, float64 for
             floating ones
    count:   total of the partial counts
    min/max: reduce over the partials
    mean:    float64 sum / count over the partials (StreamingGroupBy:
             of an integer column, the exact sum, from the wrapping sum
             and the sum of the values' high words; of a decimal, the
             exact sum over the count rounded half away from zero, in the
             input's type, as pyarrow gives it)
    var:     Chan et al. pairwise merge of (sum, count, M2)
    group_by: concat the partial group tables -> re-group (exact, since
             each partial table is keyed)

A decimal's partial sums are exact decimal sums (limbs, from the digit
sums of ops/aggregate.py), and the merge adds them exactly again: no
float touches a decimal sum or mean. The JAX package sums an integer
column through float64 in ``StreamingAggregator`` (its partial sums and
their total), so its sum differs from pyarrow's once a sum passes 2^53,
and its ``StreamingGroupBy`` divides a decimal sum's low limb for the
mean (ROADMAP Queue 3); the port's are exact.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from .. import dtypes as dt
from ..column import Column
from ..datum import Scalar
from ..errors import Invalid
from ..ops.aggregate import (_accumulator, _as_float_if_decimal,
                             _float_values, _min_max_exec, _mm_scalar,
                             _sum_output_type, decimal_exact_sum,
                             decimal_sum_type, high_words, mean_from_words,
                             round_half_away)
from ..ops.decimal import column_limbs, mean_limbs, pack
from ..ops.common import as_int64
from ..table import RecordBatch, concat_batches

__all__ = ["StreamingAggregator", "StreamingGroupBy",
           "run_streaming_aggregate"]

_U64 = (1 << 64) - 1


def _wrap_int(total: int, t: dt.DataType) -> int:
    """A Python integer total as the value of the 64-bit sum type ``t``,
    wrapped mod 2^64 (signed for int64, unsigned for uint64)."""
    total &= _U64
    if t.is_signed_integer and total >= 1 << 63:
        total -= 1 << 64
    return total


class StreamingAggregator:
    """Chunked scalar aggregates: consume(batch) per chunk, finalize() once.

    aggregates: [(column, fn)] with fn in {sum, count, min, max, mean,
    variance, stddev}."""

    def __init__(self, aggregates: Sequence[Tuple[str, str]]):
        self.aggregates = list(aggregates)
        self._partials: List[List] = [[] for _ in self.aggregates]
        self._dtypes: List = [None] * len(self.aggregates)

    def consume(self, batch: RecordBatch):
        for i, (cname, fn) in enumerate(self.aggregates):
            col = batch.column(cname)
            self._dtypes[i] = col.dtype
            n = col.mask().sum()
            if col.dtype.is_decimal and fn in ("min", "max"):
                mm = _min_max_exec([col], None, None)
                self._partials[i].append(_mm_scalar(mm[fn]))
                continue
            if col.dtype.is_decimal and fn in ("sum", "mean"):
                self._partials[i].append((decimal_exact_sum(col), n))
                continue
            col = _as_float_if_decimal(col)
            if fn in ("min", "max"):
                mm = _min_max_exec([col], None, None)
                self._partials[i].append(
                    (mm["min"].data[0], mm["max"].data[0], n,
                     mm["min"].validity))
            elif fn in ("variance", "stddev"):
                s = _float_values(col).sum()
                mean = s / n.clamp(min=1)
                m2 = torch.where(col.mask(),
                                 (col.data.to(torch.float64) - mean) ** 2,
                                 0.0).sum()
                self._partials[i].append((s, n, m2))
            elif fn == "sum" and not col.dtype.is_floating:
                # exact: int64 accumulator, wrapping mod 2^64
                self._partials[i].append((_accumulator(col, 0).sum(), n))
            else:
                self._partials[i].append((_float_values(col).sum(), n))

    def finalize(self) -> Dict[str, Scalar]:
        out = {}
        for i, (cname, fn) in enumerate(self.aggregates):
            parts = self._partials[i]
            name = f"{cname}_{fn}"
            if not parts:
                out[name] = Scalar(0, dt.int64, is_valid=False)
                continue
            t = self._dtypes[i]
            if t.is_decimal and fn in ("min", "max"):
                vals = [p.value for p in parts if p.is_valid]
                v = (min if fn == "min" else max)(vals) if vals else 0
                out[name] = Scalar(v, t, is_valid=bool(vals))
                continue
            if t.is_decimal and fn in ("sum", "mean"):
                total = sum(p[0] for p in parts)
                N = sum(int(p[1]) for p in parts)
                if fn == "sum":
                    out[name] = Scalar(total, decimal_sum_type(t),
                                       is_valid=N > 0)
                else:
                    out[name] = Scalar(round_half_away(total, N) if N
                                       else 0, t, is_valid=N > 0)
                continue
            if fn in ("min", "max"):
                total_n = sum(int(p[2]) for p in parts)
                vals = [p[0] if fn == "min" else p[1] for p in parts
                        if p[3] is None or bool(p[3][0])]
                if total_n == 0 or not vals:
                    out[name] = Scalar(0, self._dtypes[i], is_valid=False)
                else:
                    arr = torch.stack(vals)
                    v = arr.min() if fn == "min" else arr.max()
                    out[name] = Scalar(v, self._dtypes[i])
            elif fn in ("variance", "stddev"):
                # Chan/parallel merge of (sum, n, M2) partials
                S = sum(float(p[0]) for p in parts)
                N = sum(int(p[1]) for p in parts)
                if N == 0:
                    out[name] = Scalar(0.0, dt.float64, is_valid=False)
                    continue
                mean = S / N
                m2 = 0.0
                for s_i, n_i, m2_i in parts:
                    n_i = int(n_i)
                    if n_i:
                        d = float(s_i) / n_i - mean
                        m2 += float(m2_i) + n_i * d * d
                var = m2 / N
                out[name] = Scalar(var ** 0.5 if fn == "stddev" else var,
                                   dt.float64)
            elif fn == "count":
                out[name] = Scalar(sum(int(p[1]) for p in parts), dt.int64)
            elif fn == "mean":
                N = sum(int(p[1]) for p in parts)
                S = sum(float(p[0]) for p in parts)
                out[name] = (Scalar(S / N, dt.float64) if N
                             else Scalar(0.0, dt.float64, is_valid=False))
            elif fn == "sum":
                t = _sum_output_type(self._dtypes[i])
                if sum(int(p[1]) for p in parts) == 0:
                    out[name] = Scalar(0, t, is_valid=False)
                elif t.is_floating:
                    out[name] = Scalar(sum(float(p[0]) for p in parts), t)
                else:
                    out[name] = Scalar(
                        _wrap_int(sum(int(p[0]) for p in parts), t), t)
            else:
                raise Invalid(f"streaming aggregate {fn!r} unsupported")
        return out


class StreamingGroupBy:
    """Chunked hash aggregate: per-chunk partial group tables merged by
    re-grouping (exact because partials are keyed; the merge algebra per
    aggregate matches GroupedAggregator::Merge, hash_aggregate.cc:606)."""

    MERGEABLE = {"sum", "count", "min", "max", "count_all"}

    def __init__(self, keys: Sequence[str],
                 aggregates: Sequence[Tuple[str, str]]):
        self.keys = list(keys)
        self.aggregates = list(aggregates)
        self._partials: List[RecordBatch] = []
        self._mean_requested = [(c, f) for c, f in self.aggregates
                                if f == "mean"]
        for c, f in self.aggregates:
            if f != "mean" and f not in self.MERGEABLE:
                raise Invalid(f"streaming group_by: {f!r} not mergeable")
        self._expanded = None   # set from the first batch's types
        self._int_means = set()
        self._decimal_means = {}   # column -> its decimal type

    @staticmethod
    def _merge_fn(f: str) -> str:
        return "sum" if f in ("sum", "count", "count_all") else f

    def _expand(self, batch: RecordBatch):
        """Mean decomposes to sum and count partials; an integer column's
        also to the sum of its high words (``c#hi``, ``high_words``),
        which does not wrap: with the wrapping sum it gives the exact
        sum, whose mean this is."""
        expanded = []
        for c, f in self.aggregates:
            if f != "mean":
                expanded.append((c, f))
                continue
            expanded += [(c, "sum"), (c, "count")]
            if batch.column(c).dtype.is_decimal:
                self._decimal_means[c] = batch.column(c).dtype
            elif not batch.column(c).dtype.is_floating:
                self._int_means.add(c)
                expanded.append((f"{c}#hi", "sum"))
        self._expanded = list(dict.fromkeys(expanded))

    def consume(self, batch: RecordBatch):
        from ..ops.groupby import group_by

        if self._expanded is None:
            self._expand(batch)
        for c in self._int_means:
            col = batch.column(c)
            batch = batch.set_column(f"{c}#hi", Column(high_words(
                as_int64(col.data), col.dtype.kind == "uint64"), dt.int64,
                validity=col.validity))
        self._partials.append(group_by(batch, self.keys, self._expanded))

    def finalize(self) -> RecordBatch:
        from ..ops.groupby import group_by

        if not self._partials:
            raise Invalid("no input batches")
        merged = concat_batches(self._partials)
        # merge: sum->sum, count->sum, min->min, max->max over partial rows
        merge_aggs = [(f"{c}_{f}", self._merge_fn(f))
                      for c, f in self._expanded]
        result = group_by(merged, self.keys, merge_aggs)
        # rename "{c}_{f}_{merge_fn}" back to "{c}_{f}"
        result = result.rename({f"{c}_{f}_{self._merge_fn(f)}": f"{c}_{f}"
                                for c, f in self._expanded})
        for c, f in self._mean_requested:
            n = result.column(f"{c}_count")
            s = result.column(f"{c}_sum")
            if c in self._decimal_means:   # exact sum / count, rounded
                mean = pack(mean_limbs(column_limbs(s), n.data.clamp(min=1)),
                            self._decimal_means[c], n.data > 0)
                result = result.set_column(f"{c}_mean", mean)
                continue
            if c in self._int_means:
                mean = mean_from_words(result.column(f"{c}#hi_sum").data,
                                       as_int64(s.data), n.data)
            else:
                mean = s.data.to(torch.float64) / n.data.clamp(min=1)
            validity = None
            if s.validity is not None or bool((n.data == 0).any()):
                validity = n.data > 0
            result = result.set_column(f"{c}_mean",
                                       Column(mean, dt.float64,
                                              validity=validity))
        # drop helper columns not requested
        requested = {f"{c}_{f}" for c, f in self.aggregates} | set(self.keys)
        result = result.drop([n for n in result.names if n not in requested])
        # order: aggregates then keys (group_by convention)
        names = [f"{c}_{f}" for c, f in self.aggregates] + self.keys
        return result.select(names)


def run_streaming_aggregate(batches, keys, aggregates) -> RecordBatch:
    """Convenience: stream a batch iterable through StreamingGroupBy."""
    gb = StreamingGroupBy(keys, aggregates)
    for b in batches:
        gb.consume(b)
    return gb.finalize()
