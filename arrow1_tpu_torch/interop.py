"""Host boundary: numpy and pyarrow <-> device columns (counterpart of
arrow1_tpu/interop.py).

Ingest normalizes every array to the engine's physical form: one
fixed-width tensor, a bool validity tensor (None when nothing is null),
and for strings int32 dictionary codes with the values kept on the host.
pyarrow is imported only inside the functions that take or return pyarrow
objects.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import dtypes as dt
from .column import Column, Dictionary
from .device import resolve_device
from .table import RecordBatch, Table

__all__ = ["column_from_numpy", "column_from_arrow", "column_to_arrow",
           "record_batch_from_arrow", "record_batch_to_arrow",
           "table_from_arrow", "table_to_arrow", "from_reference_arrays",
           "tensor_from_u64"]


def _to_device(arr: np.ndarray, device) -> torch.Tensor:
    # torch wants writable memory; read-only views (pyarrow's) are copied
    return torch.from_numpy(np.require(arr, requirements=("C", "W"))).to(
        device)


def _dictionary_encode(values: np.ndarray, valid: np.ndarray):
    """Codes in first-appearance order (pyarrow.compute.dictionary_encode
    order); null slots get code 0 and add nothing to the pool."""
    codes = np.zeros(len(values), dtype=np.int32)
    present = values[valid]
    if not len(present):
        return codes, np.array([], dtype=object)
    uniq, first, inv = np.unique(present, return_index=True,
                                 return_inverse=True)
    order = np.argsort(first, kind="stable")
    remap = np.empty(len(order), dtype=np.int32)
    remap[order] = np.arange(len(order), dtype=np.int32)
    codes[valid] = remap[inv.reshape(-1)]
    return codes, uniq[order].astype(object)


def column_from_numpy(values, validity: Optional[np.ndarray] = None,
                      device=None, dictionary=None) -> Column:
    """A numpy array (or list, or pyarrow array) -> Column on ``device``
    (CUDA unless the caller names another).

    Object/str arrays are dictionary-encoded, with None as null. With
    ``dictionary`` given, ``values`` are already codes into it."""
    device = resolve_device(device)
    if not isinstance(values, (np.ndarray, list, tuple)):
        return column_from_arrow(values, device=device)
    arr = np.asarray(values)
    valid = None if validity is None else np.asarray(validity, dtype=bool)
    if dictionary is not None:
        return Column(_to_device(arr.astype(np.int32), device), dt.string,
                      validity=None if valid is None
                      else _to_device(valid, device),
                      dictionary=Dictionary(dictionary))
    if arr.dtype.kind in "OUS":
        isnull = np.array([v is None for v in arr.tolist()], dtype=bool)
        if isnull.any():
            valid = ~isnull if valid is None else (valid & ~isnull)
        codes, pool = _dictionary_encode(
            arr, np.ones(len(arr), bool) if valid is None else valid)
        return Column(_to_device(codes, device),
                      dt.from_numpy_dtype(arr.dtype),
                      validity=None if valid is None
                      else _to_device(valid, device),
                      dictionary=Dictionary(pool))
    t = dt.from_numpy_dtype(arr.dtype)
    return Column(_to_device(arr, device), t,
                  validity=None if valid is None
                  else _to_device(valid, device))


def column_from_arrow(arr, device=None) -> Column:
    """pyarrow Array/ChunkedArray -> Column on ``device`` (CUDA unless the
    caller names another)."""
    import pyarrow as pa
    import pyarrow.compute as pc

    device = resolve_device(device)
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    t = dt.from_arrow(arr.type)
    valid = None
    if arr.null_count:
        valid = np.asarray(pc.is_valid(arr), dtype=bool)
    if t.is_binary:
        enc = pc.dictionary_encode(arr)
        codes = np.asarray(enc.indices.fill_null(0)).astype(np.int32)
        pool = enc.dictionary.to_numpy(zero_copy_only=False)
        return Column(_to_device(codes, device), t,
                      validity=None if valid is None
                      else _to_device(valid, device),
                      dictionary=Dictionary(pool))
    if arr.null_count:
        arr = arr.fill_null(False if t.is_boolean else 0)
    data = np.asarray(arr.to_numpy(zero_copy_only=False)).astype(
        t.numpy_dtype(), copy=False)
    return Column(_to_device(data, device), t,
                  validity=None if valid is None
                  else _to_device(valid, device))


def column_to_arrow(col: Column):
    import pyarrow as pa

    mask = None
    if col.validity is not None:
        mask = ~col.validity.cpu().numpy()
    if col.dtype.is_binary:
        # a null slot's code is not read: it need not index the pool
        codes = col.data.cpu().numpy()
        vals = np.full(len(codes), None, dtype=object)
        keep = slice(None) if mask is None else ~mask
        vals[keep] = col.dictionary.values[codes[keep]]
        return pa.array(vals.tolist(), type=dt.to_arrow(col.dtype),
                        mask=mask)
    if col.dtype.is_dictionary:
        t = col.dtype
        return pa.DictionaryArray.from_arrays(
            pa.array(col.data.cpu().numpy(), type=dt.to_arrow(t.index_type),
                     mask=mask),
            pa.array(col.dictionary.values.tolist(),
                     type=dt.to_arrow(t.value_type)))
    return pa.array(col.data.cpu().numpy(), type=dt.to_arrow(col.dtype),
                    mask=mask)


def record_batch_from_arrow(batch, device=None) -> RecordBatch:
    """pyarrow RecordBatch/Table -> RecordBatch on ``device`` (CUDA unless
    the caller names another)."""
    import pyarrow as pa

    device = resolve_device(device)
    if isinstance(batch, pa.Table):
        batch = batch.combine_chunks()
    cols = tuple(column_from_arrow(batch.column(i), device=device)
                 for i in range(batch.num_columns))
    return RecordBatch(cols, tuple(batch.schema.names))


def record_batch_to_arrow(rb: RecordBatch):
    import pyarrow as pa

    return pa.record_batch([column_to_arrow(c) for c in rb.columns],
                           names=list(rb.names))


def table_from_arrow(table, device=None) -> Table:
    """pyarrow Table -> port Table on ``device`` (CUDA unless the caller
    names another), one RecordBatch per pyarrow record batch (each string
    column gets its own value pool)."""
    import pyarrow as pa

    device = resolve_device(device)
    batches = table.to_batches()
    if not batches:   # a Table holds at least one, possibly empty, batch
        batches = [pa.record_batch([pa.array([], type=f.type)
                                    for f in table.schema],
                                   schema=table.schema)]
    return Table([record_batch_from_arrow(b, device=device)
                  for b in batches])


def table_to_arrow(t: Table):
    """Port Table -> pyarrow Table, batch for batch."""
    import pyarrow as pa

    return pa.Table.from_batches([record_batch_to_arrow(b)
                                  for b in t.batches])


def from_reference_arrays(names: Sequence[str], arrays, device):
    """Build the port's state from another engine's read out as numpy.

    ``arrays`` is one ``(data, validity, dictionary)`` triple per column,
    where ``validity`` is a bool array or None and ``dictionary`` the value
    pool of a dictionary-encoded column (``data`` then holds its codes) or
    None: that gives a RecordBatch. A list of such lists, one per batch
    (each with its own value pools, as an engine ingests them), gives a
    Table. Null slots keep the data values they had, so both engines see
    the same state bit for bit."""
    arrays = list(arrays)
    if arrays and isinstance(arrays[0], list):
        return Table([from_reference_arrays(names, batch, device)
                      for batch in arrays])
    cols = tuple(column_from_numpy(data, validity=validity, device=device,
                                   dictionary=dictionary)
                 for data, validity, dictionary in arrays)
    return RecordBatch(cols, tuple(names))


def tensor_from_u64(values, device) -> torch.Tensor:
    """Unsigned 64-bit keys (a numpy uint64 array, or anything numpy reads
    as one) as the int64 bit patterns the port's hash table and probes
    take."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    return _to_device(arr.view(np.int64), device)
