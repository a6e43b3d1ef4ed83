"""Structural checks of columns and batches (counterpart of
arrow1_tpu/validate.py).

Reference: cpp/src/arrow/array/validate.cc, ValidateArray (the layout)
and ValidateFull (the data too). The port's layouts have fewer
invariants than Arrow's (no packed bitmaps, no offsets into shared
buffers); what is left: tensor shapes and dtypes, one device a column,
dictionary codes inside their pool, list offsets from 0 and
non-decreasing, union type ids among the type's codes. The full checks
run on the column's device and read back one flag a check.
"""

from __future__ import annotations

import torch

from .column import Column, ListColumn, StructColumn, UnionColumn
from .errors import Invalid
from .table import RecordBatch

__all__ = ["validate_column", "validate_batch"]


def _list(col: ListColumn, full: bool) -> None:
    if col.offsets.ndim != 1 or col.offsets.shape[0] < 1:
        raise Invalid("list offsets must be 1-D with at least one entry")
    if col.offsets.dtype != torch.int64:
        raise Invalid("list offsets must be int64")
    if col.validity is not None and col.validity.shape[0] != col.length:
        raise Invalid("list validity length mismatch")
    if full:
        child_len = col.values.num_rows if isinstance(
            col.values, RecordBatch) else col.values.length
        o = col.offsets
        if bool((o[1:] < o[:-1]).any()) or int(o[0]) != 0:
            raise Invalid("list offsets must start at 0 and not decrease")
        if int(o[-1]) > child_len:
            raise Invalid("list offsets exceed child length")
    validate_column(col.values, full=full)


def _union(col: UnionColumn, full: bool) -> None:
    if col.type_ids.ndim != 1:
        raise Invalid("union type_ids must be 1-D")
    n = col.length
    if col.is_dense:
        if col.offsets is None or col.offsets.shape[0] != n:
            raise Invalid("dense union offsets length mismatch")
    elif any(c.length != n for c in col.children):
        raise Invalid("sparse union child length mismatch")
    if full and n:
        codes = torch.tensor(col.dtype.type_codes, dtype=col.type_ids.dtype,
                             device=col.type_ids.device)
        if not bool(torch.isin(col.type_ids, codes).all()):
            raise Invalid("union type_ids outside declared type_codes")
    for c in col.children:
        validate_column(c, full=full)


def validate_column(col, full: bool = False) -> None:
    """The layout's checks; ``full=True`` adds those that read the data
    (reference: ValidateFull)."""
    if isinstance(col, ListColumn):
        return _list(col, full)
    if isinstance(col, StructColumn):
        n = col.length
        if any(c.length != n for c in col.children):
            raise Invalid("struct child length mismatch")
        if col.validity is not None and col.validity.shape[0] != n:
            raise Invalid("struct validity length mismatch")
        for c in col.children:
            validate_column(c, full=full)
        return
    if isinstance(col, UnionColumn):
        return _union(col, full)
    if isinstance(col, RecordBatch):
        for c in col.columns:
            validate_column(c, full=full)
        return
    if not isinstance(col, Column):
        raise Invalid(f"not a column: {type(col).__name__}")
    t = col.dtype
    if col.data.ndim != 1:
        raise Invalid("column data must be 1-D")
    if not t.is_nested and col.data.dtype != t.physical_dtype():
        raise Invalid(f"{t} column holds {col.data.dtype} data")
    if col.validity is not None:
        if col.validity.dtype != torch.bool:
            raise Invalid("validity must be boolean")
        if col.validity.shape[0] != col.data.shape[0]:
            raise Invalid("validity length mismatch")
        if col.validity.device != col.data.device:
            raise Invalid("validity and data on different devices")
    if t.is_null and full and col.validity is not None and \
            bool(col.validity.any()):
        raise Invalid("a null-typed column with a valid slot")
    if t.is_binary or t.is_dictionary:
        if col.dictionary is None:
            raise Invalid(f"{t} column requires a dictionary")
        if full and col.length:
            codes = col.data if col.validity is None else \
                col.data[col.validity]
            if codes.numel() and (int(codes.min()) < 0 or
                                  int(codes.max()) >= len(col.dictionary)):
                raise Invalid(f"dictionary codes out of range for a "
                              f"dictionary of {len(col.dictionary)}")
    if t.is_decimal:
        if col.data2 is None:
            raise Invalid(f"{t} column requires its high limbs")
        want = (col.length,) if t.limbs == 2 else (col.length, 3)
        if tuple(col.data2.shape) != want:
            raise Invalid(f"{t} high limbs of shape "
                          f"{tuple(col.data2.shape)}, not {want}")


def validate_batch(batch: RecordBatch, full: bool = False) -> None:
    n = batch.num_rows
    for name, col in zip(batch.names, batch.columns):
        if col.length != n:
            raise Invalid(f"column {name!r} length {col.length} != {n}")
        try:
            validate_column(col, full=full)
        except Invalid as e:
            raise Invalid(f"column {name!r}: {e}") from None
