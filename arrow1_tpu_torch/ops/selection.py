"""Selection kernels: filter, take, drop_null, indices_nonzero, scatter
and the array_filter/array_take functions (counterpart of
arrow1_tpu/ops/selection.py).

``filter`` moves every column of the batch, each column's validity and
the mask's own validity through ONE call of the compaction kernel
(kernels/compaction.py, K2), then reads the kept-row count on the host to
size the result: the counterpart of the JAX package's ``_filter_pallas``,
without its f64 bit views (Hopper moves f64 as it is). A batch that holds
nested columns adds the row numbers to that launch as one more stream:
the kept rows' numbers come out with the flat columns, and each nested
column is gathered by them (``take_column``). The JAX package sends such
a batch to a plain gather (its ``_compactable``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import dtypes as dt
from ..column import Column, ListColumn, StructColumn, UnionColumn
from ..datum import Scalar
from ..errors import IndexError_, Invalid
from ..kernels.compaction import compact
from ..registry import register_function
from ..table import RecordBatch

__all__ = ["FilterOptions", "TakeOptions", "ScatterOptions", "filter", "take",
           "take_column", "gather_batch"]


@dataclasses.dataclass
class FilterOptions:
    null_selection_behavior: str = "drop"   # "drop" | "emit_null"


@dataclasses.dataclass
class TakeOptions:
    boundscheck: bool = True


def take_column(values, indices: torch.Tensor, out_validity=None):
    """Typed gather; ``out_validity`` is ANDed into the result's. A list
    column gathers its child by indices composed from the parents'
    ranges, a struct or a map's child batch field by field, a union its
    type ids (and a dense union's offsets; a sparse union's children row
    by row)."""
    if isinstance(values, ListColumn):
        return _take_list(values, indices, out_validity)
    if isinstance(values, RecordBatch):   # a map's key/value child batch
        return RecordBatch(tuple(take_column(c, indices, out_validity)
                                 for c in values.columns), values.names)
    if isinstance(values, StructColumn):
        return StructColumn(tuple(take_column(c, indices)
                                  for c in values.children), values.names,
                            values.dtype, validity=_and_validity(
                                values.validity, indices, out_validity))
    if isinstance(values, UnionColumn):
        if values.is_dense:
            return UnionColumn(values.type_ids[indices], values.children,
                               values.dtype, offsets=values.offsets[indices])
        return UnionColumn(values.type_ids[indices],
                           tuple(take_column(c, indices)
                                 for c in values.children), values.dtype)
    validity = _and_validity(values.validity, indices, out_validity)
    return Column(values.data[indices], values.dtype, validity=validity,
                  dictionary=values.dictionary,
                  data2=None if values.data2 is None
                  else values.data2[indices])


def _and_validity(validity, indices, out_validity):
    got = None if validity is None else validity[indices]
    if out_validity is not None:
        got = out_validity if got is None else (got & out_validity)
    return got


def expand_ranges(starts: torch.Tensor, lengths: torch.Tensor,
                  total: Optional[int] = None):
    """(child row of each output item, its parent slot) for slots whose
    items are rows [starts[i], starts[i] + lengths[i]): the parents by one
    ``repeat_interleave`` (``total`` items, read on the host when not
    given) and the offsets of the new slots, int64[n + 1] from 0."""
    dev = lengths.device
    offsets = torch.zeros(lengths.shape[0] + 1, dtype=torch.int64,
                          device=dev)
    torch.cumsum(lengths, 0, out=offsets[1:])
    if total is None:
        total = int(offsets[-1])
    parent = torch.repeat_interleave(
        torch.arange(lengths.shape[0], device=dev), lengths,
        output_size=total)
    within = torch.arange(total, dtype=torch.int64, device=dev) - \
        offsets[parent]
    return starts[parent] + within, parent, offsets


def _take_list(values: ListColumn, indices, out_validity=None):
    """List gather (reference: vector_selection.cc ListImpl): the child
    rows of the taken slots, their ranges one after another."""
    rows, _, offsets = expand_ranges(values.offsets[:-1][indices],
                                     values.value_lengths()[indices])
    return ListColumn(offsets, take_column(values.values, rows),
                      values.dtype, validity=_and_validity(
                          values.validity, indices, out_validity))


def gather_batch(batch: RecordBatch, idx: torch.Tensor,
                 extra_validity=None) -> RecordBatch:
    """Row gather of every column of ``batch`` at ``idx`` (``take_column``
    per column), with ``extra_validity`` ANDed into each column's. It
    stands in for the JAX package's ``gather_batch_packed``, whose packed
    [n, W] int32 row matrix is a TPU gather layout. An empty batch gives
    null rows (its data reads 0)."""
    if batch.num_rows == 0 and idx.numel():
        null = torch.zeros(idx.shape[0], dtype=torch.bool, device=idx.device)
        return RecordBatch(tuple(
            Column(torch.zeros(idx.shape[0], dtype=c.data.dtype,
                               device=idx.device), c.dtype, validity=null,
                   dictionary=c.dictionary,
                   data2=None if c.data2 is None else c.data2.new_zeros(
                       (idx.shape[0],) + c.data2.shape[1:]))
            for c in batch.columns), batch.names)
    return RecordBatch(tuple(take_column(c, idx, extra_validity)
                             for c in batch.columns), batch.names)


def _take_exec(args, options: TakeOptions, ctx):
    values, indices = args
    if not isinstance(indices, Column) or not indices.dtype.is_integer:
        raise Invalid("take: indices must be an integer array")
    n = values.num_rows if isinstance(values, RecordBatch) else values.length
    idx = indices.data.to(torch.int64)
    if options is None:
        options = TakeOptions()
    if options.boundscheck:
        bad = (idx < 0) | (idx >= n)
        if indices.validity is not None:
            bad = bad & indices.validity
        if bool(bad.any()):
            raise IndexError_(f"take index out of bounds (length {n})")
    extra = indices.validity
    if extra is not None:   # null indices give null rows
        idx = torch.where(extra, idx, 0)
    idx = idx.clamp(0, max(n - 1, 0))
    if isinstance(values, RecordBatch):
        return RecordBatch(tuple(take_column(c, idx, extra)
                                 for c in values.columns), values.names)
    return take_column(values, idx, extra)


register_function("take", "vector", 2, TakeOptions)(_take_exec)


def _effective_mask(mask: Column, null_selection: str):
    """DROP: a null mask slot drops the row. EMIT_NULL: it keeps the row
    and nulls it (the mask validity becomes the rows' validity)."""
    if mask.validity is None:
        return mask.data, None
    if null_selection == "drop":
        return mask.data & mask.validity, None
    if null_selection == "emit_null":
        return mask.data | ~mask.validity, mask.validity
    raise Invalid(f"bad null_selection_behavior {null_selection!r}")


def _filter_exec(args, options: FilterOptions, ctx):
    values, mask = args
    if not isinstance(mask, Column) or not mask.dtype.is_boolean:
        raise Invalid("filter: mask must be a boolean array")
    if isinstance(values, Scalar):
        raise Invalid("filter: values must be an array or record batch")
    cols = list(values.columns) if isinstance(values, RecordBatch) \
        else [values]
    n = values.num_rows if isinstance(values, RecordBatch) else values.length
    if n != mask.length:
        raise Invalid(f"filter: length mismatch {n} vs {mask.length}")
    if options is None:
        options = FilterOptions()
    selected, mask_validity = _effective_mask(
        mask, options.null_selection_behavior)
    flat = [i for i, c in enumerate(cols) if isinstance(c, Column)]
    nested = len(flat) < len(cols)
    # layout: (column index, "data" | "data2" | "validity"); a decimal256's
    # three high limbs ([n, 3]) ride as three 1-D streams; (-1, "rows")
    # the row numbers, when a nested column is gathered by them
    streams, layout = [], []
    for i in flat:
        c = cols[i]
        streams.append(c.data)
        layout.append((i, "data"))
        if c.data2 is not None and c.data2.dim() == 2:
            streams.extend(c.data2.t().contiguous().unbind(0))
            layout.extend([(i, "data2")] * c.data2.shape[1])
        elif c.data2 is not None:   # an interval's ns, a decimal's limb
            streams.append(c.data2)
            layout.append((i, "data2"))
        if c.validity is not None:
            streams.append(c.validity)
            layout.append((i, "validity"))
    if mask_validity is not None:
        streams.append(mask_validity)
        layout.append((-1, "validity"))
    if nested:
        streams.append(torch.arange(n, dtype=torch.int64,
                                    device=selected.device))
        layout.append((-1, "rows"))
    outs, count = compact(selected, streams)
    count = int(count)   # the one host sync: it sizes the result
    moved = {"data": {}, "data2": {}, "validity": {}, "rows": {}}
    limbs = {}
    for (ci, kind), out in zip(layout, outs):
        if kind == "data2" and cols[ci].data2.dim() == 2:
            limbs.setdefault(ci, []).append(out[:count])
        else:
            moved[kind][ci] = out[:count]
    for ci, planes in limbs.items():
        moved["data2"][ci] = torch.stack(planes, 1)
    data, valid = moved["data"], moved["validity"]
    out_cols = []
    for i, c in enumerate(cols):
        if not isinstance(c, Column):
            out_cols.append(take_column(c, moved["rows"][-1],
                                        valid.get(-1)))
            continue
        validity = valid.get(i)
        if -1 in valid:
            validity = valid[-1] if validity is None else \
                (validity & valid[-1])
        out_cols.append(Column(data[i], c.dtype, validity=validity,
                               dictionary=c.dictionary,
                               data2=moved["data2"].get(i)))
    if isinstance(values, RecordBatch):
        return RecordBatch(tuple(out_cols), values.names)
    return out_cols[0]


register_function("filter", "vector", 2, FilterOptions)(_filter_exec)


def _indices_nonzero_exec(args, options, ctx):
    """uint64 indices of the valid non-zero values; NaN counts as
    non-zero (reference: GetTakeIndices, vector_selection.cc:223)."""
    (mask,) = args
    nz = mask.data != 0
    if mask.validity is not None:
        nz = nz & mask.validity
    idx = torch.nonzero(nz).reshape(-1)   # sizes the output: a host sync
    return Column(idx.view(torch.uint64), dt.uint64)


register_function("indices_nonzero", "vector", 1)(_indices_nonzero_exec)


def _drop_null_exec(args, options, ctx):
    """The rows with no null (every column valid), through ``filter``:
    one K2 launch on the card."""
    (values,) = args
    if isinstance(values, RecordBatch):
        m = None
        for c in values.columns:
            if c.validity is not None:
                m = c.validity if m is None else (m & c.validity)
        if m is None:
            return values
        return _filter_exec([values, Column(m, dt.bool_)], FilterOptions(),
                            ctx)
    if values.validity is None:
        return values
    return _filter_exec([values, Column(values.validity, dt.bool_)],
                        FilterOptions(), ctx)


register_function("drop_null", "vector", 1)(_drop_null_exec)


def _array_take_exec(args, options, ctx):
    return _take_exec(args, TakeOptions(
        getattr(options, "boundscheck", True)), ctx)


def _array_filter_exec(args, options, ctx):
    return _filter_exec(args, FilterOptions(
        getattr(options, "null_selection_behavior", None) or "drop"), ctx)


register_function("array_take", "vector", 2, TakeOptions)(_array_take_exec)
register_function("array_filter", "vector", 2, FilterOptions)(
    _array_filter_exec)


@dataclasses.dataclass
class ScatterOptions:
    max_index: int = 0


def _scatter_exec(args, options: ScatterOptions, ctx):
    """out[indices[i]] = values[i] for valid indices; slots that nothing
    lands on, or that take a null value, are null (reference:
    vector_swizzle.cc Scatter). Where indices repeat the last wins, on
    every device: each slot takes the largest row that names it
    (``scatter_reduce`` amax), then one gather. A valid index outside
    [0, max_index] raises, as in pyarrow (the reference drops it, and
    counts a negative one from the end: ROADMAP Queue 3)."""
    values, indices = args
    if options is None:
        raise Invalid("scatter requires max_index")
    if not isinstance(indices, Column) or not indices.dtype.is_integer:
        raise Invalid("scatter: indices must be an integer array")
    size = int(options.max_index) + 1
    dev = values.device
    idx = indices.data.to(torch.int64)
    named = indices.mask()
    if bool((named & ((idx < 0) | (idx >= size))).any()):
        raise IndexError_(f"scatter: index out of bounds [0, {size})")
    slot = torch.where(named, idx, size)
    rows = torch.arange(values.length, dtype=torch.int64, device=dev)
    last = torch.full((size + 1,), -1, dtype=torch.int64, device=dev)
    last = last.scatter_reduce(0, slot, rows, "amax")[:size]
    pick = last.clamp(min=0)
    filled = (last >= 0) & values.mask()[pick] if values.length else \
        last >= 0
    zero = torch.zeros((), dtype=values.data.dtype, device=dev)
    data = torch.where(filled, values.data[pick], zero) if values.length \
        else torch.zeros(size, dtype=values.data.dtype, device=dev)
    data2 = None
    if values.data2 is not None:   # a decimal's limbs, an interval's ns
        d2 = values.data2[pick] if values.length else torch.zeros(
            (size, *values.data2.shape[1:]), dtype=torch.int64, device=dev)
        data2 = torch.where(filled if d2.dim() == 1 else filled[:, None],
                            d2, 0)
    return Column(data, values.dtype, validity=filled,
                  dictionary=values.dictionary, data2=data2)


register_function("scatter", "vector", 2, ScatterOptions)(_scatter_exec)


def filter(values, mask, null_selection_behavior: str = "drop"):
    """Rows of ``values`` (Column or RecordBatch) where ``mask`` is true."""
    return _filter_exec([values, mask],
                        FilterOptions(null_selection_behavior), None)


def take(values, indices, boundscheck: bool = True):
    """Rows of ``values`` at ``indices`` (an integer Column)."""
    return _take_exec([values, indices], TakeOptions(boundscheck), None)
