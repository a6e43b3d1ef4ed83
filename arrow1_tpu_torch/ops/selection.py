"""Selection kernels: filter and take (counterpart of
arrow1_tpu/ops/selection.py).

``filter`` moves every column of the batch, each column's validity and
the mask's own validity through ONE call of the compaction kernel
(kernels/compaction.py, K2), then reads the kept-row count on the host to
size the result: the counterpart of the JAX package's ``_filter_pallas``,
without its f64 bit views (Hopper moves f64 as it is).
"""

from __future__ import annotations

import dataclasses

import torch

from ..column import Column
from ..datum import Scalar
from ..errors import IndexError_, Invalid
from ..kernels.compaction import compact
from ..registry import register_function
from ..table import RecordBatch

__all__ = ["FilterOptions", "TakeOptions", "filter", "take", "take_column",
           "gather_batch"]


@dataclasses.dataclass
class FilterOptions:
    null_selection_behavior: str = "drop"   # "drop" | "emit_null"


@dataclasses.dataclass
class TakeOptions:
    boundscheck: bool = True


def take_column(values: Column, indices: torch.Tensor,
                out_validity=None) -> Column:
    """Typed gather; ``out_validity`` is ANDed into the result's."""
    validity = None if values.validity is None else values.validity[indices]
    if out_validity is not None:
        validity = out_validity if validity is None else \
            (validity & out_validity)
    return Column(values.data[indices], values.dtype, validity=validity,
                  dictionary=values.dictionary,
                  data2=None if values.data2 is None
                  else values.data2[indices])


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
                   dictionary=c.dictionary)
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


register_function("take", "vector", 2, TakeOptions,
                  aliases=["array_take"])(_take_exec)


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
    if any(c.data2 is not None for c in cols):
        raise Invalid("filter: two-limb columns are not ported yet")
    if options is None:
        options = FilterOptions()
    selected, mask_validity = _effective_mask(
        mask, options.null_selection_behavior)
    streams, layout = [], []   # layout: (column index, "data"|"validity")
    for i, c in enumerate(cols):
        streams.append(c.data)
        layout.append((i, "data"))
        if c.validity is not None:
            streams.append(c.validity)
            layout.append((i, "validity"))
    if mask_validity is not None:
        streams.append(mask_validity)
        layout.append((-1, "validity"))
    outs, count = compact(selected, streams)
    count = int(count)   # the one host sync: it sizes the result
    data, valid = {}, {}
    for (ci, kind), out in zip(layout, outs):
        (data if kind == "data" else valid)[ci] = out[:count]
    out_cols = []
    for i, c in enumerate(cols):
        validity = valid.get(i)
        if -1 in valid:
            validity = valid[-1] if validity is None else \
                (validity & valid[-1])
        out_cols.append(Column(data[i], c.dtype, validity=validity,
                               dictionary=c.dictionary))
    if isinstance(values, RecordBatch):
        return RecordBatch(tuple(out_cols), values.names)
    return out_cols[0]


register_function("filter", "vector", 2, FilterOptions,
                  aliases=["array_filter"])(_filter_exec)


def filter(values, mask, null_selection_behavior: str = "drop"):
    """Rows of ``values`` (Column or RecordBatch) where ``mask`` is true."""
    return _filter_exec([values, mask],
                        FilterOptions(null_selection_behavior), None)


def take(values, indices, boundscheck: bool = True):
    """Rows of ``values`` at ``indices`` (an integer Column)."""
    return _take_exec([values, indices], TakeOptions(boundscheck), None)
