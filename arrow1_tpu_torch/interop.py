"""Host boundary: numpy and pyarrow <-> device columns (counterpart of
arrow1_tpu/interop.py).

Ingest normalizes every array to the engine's physical form: one
fixed-width tensor, a bool validity tensor (None when nothing is null),
and for strings int32 dictionary codes with the values kept on the host.
Nested arrays become column.ListColumn, StructColumn and UnionColumn over
children ingested the same way: a sliced array's offset is honoured, a
variable list's offsets are rebased to 0 with a null slot's range made
empty (its values are dropped, as ``list_flatten`` drops them), and a
fixed_size_list keeps the child slots of its null parents. pyarrow is
imported only inside the functions that take or return pyarrow objects.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from . import dtypes as dt
from .column import Column, Dictionary, ListColumn, StructColumn, UnionColumn
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
        arr = arr.combine_chunks()   # dictionary chunks: pools unified
    t = dt.from_arrow(arr.type)
    if t.is_null:   # int8 zeros under an all-false validity
        return Column(torch.zeros(len(arr), dtype=torch.int8, device=device),
                      t, validity=torch.zeros(len(arr), dtype=torch.bool,
                                              device=device))
    if t.is_nested:
        return _from_nested(arr, t, device)
    if pa.types.is_dictionary(arr.type):
        return _from_dictionary_array(arr, t, device)
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
    if t.kind == "month_day_nano_interval":
        return _from_month_day_nano(arr, t, valid, device)
    if t.is_decimal:
        return _from_decimal(arr, t, valid, device)
    if t.is_temporal:
        # the storage integers through a zero-copy view, nulls as 0
        storage = arr.view(pa.int32() if t.numpy_dtype().itemsize == 4
                           else pa.int64())
        data = np.asarray(storage.fill_null(0).to_numpy(
            zero_copy_only=False)).astype(t.numpy_dtype(), copy=False)
        return Column(_to_device(data, device), t,
                      validity=None if valid is None
                      else _to_device(valid, device))
    if arr.null_count:
        arr = arr.fill_null(False if t.is_boolean else 0)
    data = np.asarray(arr.to_numpy(zero_copy_only=False)).astype(
        t.numpy_dtype(), copy=False)
    return Column(_to_device(data, device), t,
                  validity=None if valid is None
                  else _to_device(valid, device))


def _validity(arr, device):
    import pyarrow.compute as pc

    if not arr.null_count:
        return None
    return _to_device(np.asarray(pc.is_valid(arr), dtype=bool), device)


def _from_nested(arr, t: dt.DataType, device):
    """A list, large_list, fixed_size_list, map, struct or union array
    (the JAX package's ingest, ``interop.py:74-132``, with its reading of
    a sliced map's keys and items and a sliced union's type codes and
    offsets fixed: ROADMAP Queue 3)."""
    import pyarrow as pa

    n = len(arr)
    if t.kind == "struct":   # field(i) honours the array's offset
        kids = [column_from_arrow(arr.field(i), device=device)
                for i in range(arr.type.num_fields)]
        return StructColumn(kids, [f.name for f in arr.type], t,
                            validity=_validity(arr, device))
    if t.kind in ("sparse_union", "dense_union"):
        # .type_codes and .offsets ignore the slice: read the buffers
        ids = np.frombuffer(arr.buffers()[1], dtype=np.int8,
                            count=arr.offset + n)[arr.offset:]
        kids = [column_from_arrow(arr.field(i), device=device)
                for i in range(arr.type.num_fields)]
        offsets = None
        if t.kind == "dense_union":
            offsets = _to_device(np.frombuffer(
                arr.buffers()[2], dtype=np.int32,
                count=arr.offset + n)[arr.offset:], device)
        return UnionColumn(_to_device(ids, device), kids, t,
                           offsets=offsets)
    validity = _validity(arr, device)
    if t.kind == "fixed_size_list":
        k = t.list_size   # .values ignores the slice: take its rows' slots
        child = column_from_arrow(arr.values.slice(arr.offset * k, n * k),
                                  device=device)
        offsets = np.arange(n + 1, dtype=np.int64) * k
        return ListColumn(_to_device(offsets, device), child, t,
                          validity=validity)
    # variable lists and maps: offsets rebased to 0, a null slot's range
    # empty; the child rows are those of the valid slots' ranges
    raw = np.asarray(arr.offsets, dtype=np.int64)
    lengths = raw[1:] - raw[:-1]
    if arr.null_count:
        import pyarrow.compute as pc

        lengths = np.where(np.asarray(pc.is_valid(arr), dtype=bool),
                           lengths, 0)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    parent = np.repeat(np.arange(n), lengths)
    rows = pa.array(raw[:-1][parent] + np.arange(offsets[-1]) -
                    offsets[:-1][parent], type=pa.int64())
    if t.kind == "map":   # .keys/.items ignore the slice: rows are absolute
        child = RecordBatch(
            (column_from_arrow(arr.keys.take(rows), device=device),
             column_from_arrow(arr.items.take(rows), device=device)),
            ("key", "value"))
    else:
        child = column_from_arrow(arr.values.take(rows), device=device)
    return ListColumn(_to_device(offsets, device), child, t,
                      validity=validity)


def _nested_to_arrow(col):
    import pyarrow as pa

    t = dt.to_arrow(col.dtype)
    if isinstance(col, UnionColumn):
        kids = [column_to_arrow(c) for c in col.children]
        names = [name for name, _ in col.dtype.fields]
        ids = pa.array(col.type_ids.cpu().numpy(), type=pa.int8())
        codes = list(col.dtype.type_codes)
        if col.is_dense:
            offs = pa.array(col.offsets.cpu().numpy().astype(np.int32),
                            type=pa.int32())
            return pa.UnionArray.from_dense(ids, offs, kids, names, codes)
        return pa.UnionArray.from_sparse(ids, kids, names, codes)
    mask = None if col.validity is None else \
        pa.array(~col.validity.cpu().numpy())
    if isinstance(col, StructColumn):
        return pa.StructArray.from_arrays(
            [column_to_arrow(c) for c in col.children], fields=list(t),
            mask=mask)
    if col.dtype.kind == "fixed_size_list":
        return pa.FixedSizeListArray.from_arrays(
            column_to_arrow(col.values), type=t, mask=mask)
    offsets = col.offsets.cpu().numpy()
    if col.dtype.kind == "map":
        return pa.MapArray.from_arrays(
            pa.array(offsets.astype(np.int32)),
            column_to_arrow(col.values.column("key")),
            column_to_arrow(col.values.column("value")), type=t, mask=mask)
    cls = pa.LargeListArray if col.dtype.kind == "large_list" \
        else pa.ListArray
    return cls.from_arrays(
        pa.array(offsets.astype(np.int64 if col.dtype.kind == "large_list"
                                else np.int32)),
        column_to_arrow(col.values), type=t, mask=mask)


_MDN = np.dtype([("m", "<i4"), ("d", "<i4"), ("n", "<i8")])


def _from_month_day_nano(arr, t: dt.DataType, valid, device) -> Column:
    """A month_day_nano_interval array's 16-byte entries (months i32,
    days i32, nanoseconds i64): months << 32 | days into ``data``,
    nanoseconds into ``data2``, as the JAX package packs them."""
    rec = np.frombuffer(arr.buffers()[1], dtype=_MDN,
                        count=len(arr) + arr.offset)[arr.offset:]
    data = (rec["m"].astype(np.int64) << 32) | \
        (rec["d"].astype(np.int64) & 0xFFFFFFFF)
    nanos = rec["n"].copy()
    if valid is not None:   # null slots read 0
        data[~valid] = 0
        nanos[~valid] = 0
    return Column(_to_device(data, device), t,
                  validity=None if valid is None
                  else _to_device(valid, device),
                  data2=_to_device(nanos, device))


def _from_decimal(arr, t: dt.DataType, valid, device) -> Column:
    """A decimal array's 16- or 32-byte little-endian words read straight
    from its buffer (a zero-copy view, the array's offset honoured): limb
    0 into ``data``, the rest into ``data2`` (a decimal128's high limb
    int64[n], a decimal256's limbs 1-3 int64[n, 3]). Null slots read 0.
    The JAX package goes value by value through Python Decimals."""
    nl = t.limbs
    words = np.frombuffer(arr.buffers()[1], dtype="<i8",
                          count=(len(arr) + arr.offset) * nl).reshape(
                              -1, nl)[arr.offset:]
    if valid is not None:
        words = np.where(valid[:, None], words, 0)
    lo = np.ascontiguousarray(words[:, 0])
    hi = np.ascontiguousarray(words[:, 1] if nl == 2 else words[:, 1:])
    return Column(_to_device(lo, device), t,
                  validity=None if valid is None
                  else _to_device(valid, device),
                  data2=_to_device(hi, device))


def _from_dictionary_array(arr, t: dt.DataType, device) -> Column:
    """A pyarrow DictionaryArray as a column of its value type (reference
    ``_from_dictionary_array``): the indices become int32 codes, null
    slots code 0, and the pool stays on the host. A slot whose pool value
    is null is null. A numeric pool is gathered through the codes, as
    pyarrow reads such an array (the JAX package keeps the codes as the
    values; ROADMAP Queue 3)."""
    import pyarrow.compute as pc

    codes = np.asarray(arr.indices.fill_null(0)).astype(np.int32)
    pool_arr = arr.dictionary
    valid = np.asarray(pc.is_valid(arr.indices), dtype=bool) \
        if arr.indices.null_count else None
    if pool_arr.null_count and len(codes):
        pool_ok = np.asarray(pc.is_valid(pool_arr), dtype=bool)
        valid = pool_ok[codes] if valid is None else valid & pool_ok[codes]
    if t.is_binary:
        pool = pool_arr.to_numpy(zero_copy_only=False)
        if len(set(pool.tolist())) != len(pool):   # one code per value
            pool, inv = np.unique(pool.astype(object), return_inverse=True)
            codes = inv.reshape(-1).astype(np.int32)[codes]
        return Column(_to_device(codes, device), t,
                      validity=None if valid is None
                      else _to_device(valid, device),
                      dictionary=Dictionary(pool))
    pool = np.asarray(pool_arr.fill_null(False if t.is_boolean else 0)
                      .to_numpy(zero_copy_only=False)).astype(t.numpy_dtype())
    data = pool[codes] if len(pool) else np.zeros(len(codes),
                                                  t.numpy_dtype())
    return Column(_to_device(data, device), t,
                  validity=None if valid is None
                  else _to_device(valid, device))


def column_to_arrow(col: Column):
    import pyarrow as pa

    if not isinstance(col, Column):
        return _nested_to_arrow(col)
    if col.dtype.is_null:
        return pa.nulls(col.length)
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
    if col.dtype.kind == "month_day_nano_interval":
        n = col.length
        packed = col.data.cpu().numpy()
        rec = np.empty(n, dtype=_MDN)
        rec["m"] = (packed >> 32).astype(np.int32)
        rec["d"] = (packed & 0xFFFFFFFF).astype(np.uint32).astype(np.int32)
        rec["n"] = col.data2.cpu().numpy()
        bufs = [None, pa.py_buffer(rec.tobytes())]
        if mask is not None:
            bufs[0] = pa.py_buffer(
                np.packbits(~mask, bitorder="little").tobytes())
        return pa.Array.from_buffers(dt.to_arrow(col.dtype), n, bufs)
    if col.dtype.is_decimal:   # the limbs as 16/32-byte words
        n = col.length
        hi = col.data2.cpu().numpy().reshape(n, col.dtype.limbs - 1)
        words = np.empty((n, 1 + hi.shape[1]), dtype="<i8")
        words[:, 0] = col.data.cpu().numpy()
        words[:, 1:] = hi
        bufs = [None, pa.py_buffer(words.tobytes())]
        if mask is not None:
            bufs[0] = pa.py_buffer(
                np.packbits(~mask, bitorder="little").tobytes())
        return pa.Array.from_buffers(dt.to_arrow(col.dtype), n, bufs)
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

    ``arrays`` is one entry per column: a ``(data, validity, dictionary)``
    triple for a flat column, where ``validity`` is a bool array or None
    and ``dictionary`` the value pool of a dictionary-encoded column
    (``data`` then holds its codes) or None; or, for a nested column, a
    dict with its port ``type`` and its buffers as numpy arrays:
    ``offsets`` (int64, from 0), ``values`` (the child's entry; a map's
    is a list of the key and value entries) and ``validity`` for a list
    type, ``children`` (entries) and ``validity`` for a struct,
    ``type_ids`` (int8), ``children`` and, for a dense union,
    ``offsets`` (int32) for a union. That gives a RecordBatch. A list of
    such lists, one per batch (each with its own value pools, as an
    engine ingests them), gives a Table. Null slots keep the data values
    they had, so both engines see the same state bit for bit. ``device``
    None means CUDA."""
    device = resolve_device(device)
    arrays = list(arrays)
    if arrays and isinstance(arrays[0], list):
        return Table([from_reference_arrays(names, batch, device)
                      for batch in arrays])
    cols = tuple(_reference_column(entry, device) for entry in arrays)
    return RecordBatch(cols, tuple(names))


def _reference_column(entry, device):
    if not isinstance(entry, dict):
        data, validity, dictionary = entry
        return column_from_numpy(data, validity=validity, device=device,
                                 dictionary=dictionary)
    t = entry["type"]

    def mask(key="validity"):
        v = entry.get(key)
        return None if v is None else _to_device(np.asarray(v, bool),
                                                 device)

    if t.kind == "struct":
        return StructColumn([_reference_column(c, device)
                             for c in entry["children"]],
                            [n for n, _ in t.fields], t, validity=mask())
    if t.kind in ("sparse_union", "dense_union"):
        offsets = entry.get("offsets")
        return UnionColumn(
            _to_device(np.asarray(entry["type_ids"], np.int8), device),
            [_reference_column(c, device) for c in entry["children"]], t,
            offsets=None if offsets is None else
            _to_device(np.asarray(offsets, np.int32), device))
    values = entry["values"]
    child = RecordBatch(tuple(_reference_column(c, device)
                              for c in values), ("key", "value")) \
        if t.kind == "map" else _reference_column(values, device)
    return ListColumn(_to_device(np.asarray(entry["offsets"], np.int64),
                                 device), child, t, validity=mask())


def tensor_from_u64(values, device) -> torch.Tensor:
    """Unsigned 64-bit keys (a numpy uint64 array, or anything numpy reads
    as one) as the int64 bit patterns the port's hash table and probes
    take."""
    arr = np.ascontiguousarray(np.asarray(values, dtype=np.uint64))
    return _to_device(arr.view(np.int64), device)
