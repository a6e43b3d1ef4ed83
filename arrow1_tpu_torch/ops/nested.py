"""Nested kernels: list_value_length, list_flatten, list_parent_indices,
list_element, list_slice, make_struct (alias project), struct_field and
map_lookup (counterpart of arrow1_tpu/ops/nested.py; reference:
cpp/src/arrow/compute/kernels/scalar_nested.cc, vector_nested.cc).

A list column is int64 offsets (from 0) into a flattened child, on the
column's device (column.ListColumn). Per-item work runs over the
exploded view: each child row's parent slot, one ``repeat_interleave``
of the slot numbers by the slots' lengths (with ``output_size``, the item
count, read once on the host where the offsets do not already give it).
Where the JAX package scans with ``cumsum_blocked`` the port calls
``torch.cumsum``, and its ``.at[].min/max`` scatters are
``scatter_reduce``. make_struct gives a RecordBatch, as the JAX package's
does; struct columns come from ingest, ``RecordBatch.to_struct_array``
and extract_regex.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from .. import dtypes as dt
from ..column import Column, ListColumn, StructColumn
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch, with_parent_validity
from .selection import expand_ranges, take_column

__all__ = ["ListFlattenOptions", "MakeStructOptions", "StructFieldOptions",
           "ListElementOptions", "ListSliceOptions", "MapLookupOptions"]


def _require_list(col, name):
    if not isinstance(col, ListColumn):
        raise Invalid(f"{name}: expected a list column")


def _parent_indices(col: ListColumn) -> torch.Tensor:
    """int64: each child row's parent slot (the child's length is the
    item count, so no host read)."""
    return torch.repeat_interleave(
        torch.arange(col.length, device=col.device), col.value_lengths(),
        output_size=_total(col))


def _total(col: ListColumn) -> int:
    """The item count without a host read where the child's length gives
    it (offsets start at 0 and end at the child's length)."""
    values = col.values
    return values.num_rows if isinstance(values, RecordBatch) \
        else values.length


def _list_value_length_exec(args, options, ctx):
    """Items per slot, null at a null slot: int32, int64 for a
    large_list (pyarrow's; the JAX package gives int32 for both)."""
    (col,) = args
    _require_list(col, "list_value_length")
    out_t = dt.int64 if col.dtype.kind == "large_list" else dt.int32
    return Column(col.value_lengths().to(out_t.physical_dtype()), out_t,
                  validity=col.validity)


register_function("list_value_length", "scalar", 1)(_list_value_length_exec)


@dataclasses.dataclass
class ListFlattenOptions:
    """Reference: api_vector.h ListFlattenOptions."""

    recursive: bool = False


def _flatten_once(col: ListColumn):
    """The child rows of the non-null slots: the child itself, but for a
    fixed_size_list with nulls, whose null slots keep child rows."""
    if col.validity is not None and col.dtype.kind == "fixed_size_list":
        keep = torch.nonzero(col.validity[_parent_indices(col)]).reshape(-1)
        return take_column(col.values, keep)
    return col.values


def _list_flatten_exec(args, options: ListFlattenOptions, ctx):
    """Concatenated child values of the non-null slots; ``recursive``
    flattens nested list levels down to the leaf values."""
    (col,) = args
    _require_list(col, "list_flatten")
    out = _flatten_once(col)
    if options is not None and options.recursive:
        while isinstance(out, ListColumn):
            out = _flatten_once(out)
    return out


register_function("list_flatten", "vector", 1, ListFlattenOptions)(
    _list_flatten_exec)


def _list_parent_indices_exec(args, options, ctx):
    """For each child value (of a non-null slot), the row of its list."""
    (col,) = args
    _require_list(col, "list_parent_indices")
    parent = _parent_indices(col)
    if col.validity is not None and col.dtype.kind == "fixed_size_list":
        parent = parent[col.validity[parent]]
    return Column(parent, dt.int64)


register_function("list_parent_indices", "vector", 1)(
    _list_parent_indices_exec)


@dataclasses.dataclass
class MakeStructOptions:
    """Reference: ProjectOptions api_scalar.h:139 (field names)."""

    field_names: tuple = ()


def _make_struct_exec(args, options: MakeStructOptions, ctx):
    """The columns as the fields of a struct, a RecordBatch (the JAX
    package's struct result), named by ``field_names`` or "0", "1", ..."""
    names = list(options.field_names) if options and options.field_names \
        else [str(i) for i in range(len(args))]
    return RecordBatch(tuple(args), tuple(names))


register_function("make_struct", "scalar", -1, MakeStructOptions,
                  aliases=["project"])(_make_struct_exec)


@dataclasses.dataclass
class StructFieldOptions:
    field: object = None


def _struct_field_exec(args, options: StructFieldOptions, ctx):
    """A field of a struct column (null where the struct slot is null) or
    a column of a RecordBatch, by name or index."""
    (s,) = args
    field = getattr(options, "field", None) if options else None
    if field is None:
        raise Invalid("struct_field requires a field name/index")
    if isinstance(s, StructColumn):
        return with_parent_validity(s.field(field), s.validity)
    if not isinstance(s, RecordBatch):
        raise Invalid("struct_field expects a struct (RecordBatch)")
    return s.column(field)


register_function("struct_field", "scalar", 1, StructFieldOptions)(
    _struct_field_exec)


@dataclasses.dataclass
class ListElementOptions:
    index: int = 0


def _list_element_exec(args, options: ListElementOptions, ctx):
    """The i-th child value of each slot: null at a null slot; a non-null
    list shorter than i + 1 raises (pyarrow's out of bounds)."""
    (col,) = args
    _require_list(col, "list_element")
    i = options.index if options else 0
    lengths = col.value_lengths()
    valid = lengths > i
    if col.validity is not None:
        valid = valid & col.validity
    if bool((col.mask() & ~valid).any()):
        raise Invalid(f"Index {i} is out of bounds for some list slots")
    idx = (col.offsets[:-1] + i).clamp(0, max(_total(col) - 1, 0))
    return _take_valid(col.values, idx, valid)


def _take_valid(values, idx: torch.Tensor, valid: torch.Tensor):
    """``take_column`` of ``values`` at ``idx`` where ``valid``; a child
    with no row gives nulls (there is nothing to gather)."""
    if values.length or not isinstance(values, Column):
        return take_column(values, idx, valid)
    n = idx.shape[0]
    data2 = None if values.data2 is None else values.data2.new_zeros(
        (n, *values.data2.shape[1:]))
    return Column(values.data.new_zeros(n), values.dtype,
                  validity=torch.zeros_like(valid),
                  dictionary=values.dictionary, data2=data2)


register_function("list_element", "scalar", 1, ListElementOptions)(
    _list_element_exec)


@dataclasses.dataclass
class ListSliceOptions:
    start: int = 0
    stop: Optional[int] = None
    step: int = 1
    return_fixed_size_list: object = None


def _list_slice_exec(args, options: ListSliceOptions, ctx):
    """Items [start, stop) by step of every slot. A fixed_size_list gives
    a fixed_size_list (as pyarrow; the JAX package gives a list) of the
    slice's size, padded with nulls past a list's end, as does any list
    with ``return_fixed_size_list``; otherwise a list."""
    (col,) = args
    _require_list(col, "list_slice")
    options = options or ListSliceOptions()
    start, stop, step = options.start, options.stop, options.step
    if step < 1:
        raise Invalid("list_slice: step must be >= 1")
    if start < 0 or stop is not None and start > stop:
        raise Invalid(f"list_slice: `start`({start}) should be greater than "
                      f"or equal to 0 and not greater than `stop`({stop})")
    fixed = options.return_fixed_size_list
    if fixed is None:
        fixed = col.dtype.kind == "fixed_size_list"
    lengths = col.value_lengths()
    item_t = col.dtype.value_field if col.dtype.kind != "map" else None
    if fixed:
        if stop is None and col.dtype.kind != "fixed_size_list":
            raise Invalid("list_slice: a fixed_size_list result needs "
                          "`stop`")
        stop = col.dtype.list_size if stop is None else stop
        size = max(-(-(stop - start) // step), 0)
        at = start + torch.arange(size, device=col.device) * step
        rows = (col.offsets[:-1, None] + at).reshape(-1)
        inside = (at < lengths[:, None]).reshape(-1)
        child = _take_valid(col.values, rows.clamp(
            max=max(_total(col) - 1, 0)), inside) if rows.numel() else \
            take_column(col.values, rows)
        offsets = torch.arange(col.length + 1, device=col.device) * size
        return ListColumn(offsets, child, dt.fixed_size_list(item_t, size),
                          validity=col.validity)
    end = lengths if stop is None else lengths.clamp(max=stop)
    new_len = torch.div(end - start + step - 1, step,
                        rounding_mode="floor").clamp(min=0)
    if col.validity is not None:   # a null slot's range stays empty
        new_len = torch.where(col.validity, new_len, 0)
    starts = col.offsets[:-1] + start
    rows, parent, offsets = expand_ranges(starts, new_len)
    if step != 1:   # the items' steps from their slot's first
        rows = rows + (rows - starts[parent]) * (step - 1)
    out_t = col.dtype if col.dtype.kind != "fixed_size_list" else \
        dt.list_(item_t)
    return ListColumn(offsets, take_column(col.values, rows), out_t,
                      validity=col.validity)


register_function("list_slice", "scalar", 1, ListSliceOptions)(
    _list_slice_exec)


@dataclasses.dataclass
class MapLookupOptions:
    query_key: object = None
    occurrence: str = "first"


def _map_lookup_exec(args, options: MapLookupOptions, ctx):
    """The value of ``query_key`` in each map slot: its ``first`` or
    ``last`` occurrence (null where the key is absent), or ``all`` of
    them as a list (null where there is none)."""
    (col,) = args
    if not isinstance(col, ListColumn) or col.dtype.kind != "map":
        raise Invalid("map_lookup: expects a map column")
    if options is None or options.query_key is None:
        raise Invalid("map_lookup requires query_key")
    keys, items = col.values.column("key"), col.values.column("value")
    q = options.query_key
    if keys.dictionary is not None:
        hit = keys.data == keys.dictionary.index.get(q, -1)
    else:
        hit = keys.data == q
    hit = hit & keys.mask()
    total, n = _total(col), col.length
    parent = _parent_indices(col)
    occ = options.occurrence
    if occ == "all":
        idx = torch.nonzero(hit).reshape(-1)   # in parent order already
        offsets = torch.searchsorted(
            parent[idx], torch.arange(n + 1, device=col.device))
        validity = offsets[1:] > offsets[:-1]
        if col.validity is not None:
            validity = validity & col.validity
        return ListColumn(offsets, take_column(items, idx),
                          dt.list_(items.dtype), validity=validity)
    pos = torch.arange(total, dtype=torch.int64, device=col.device)
    if occ == "first":
        best = torch.full((n,), total, dtype=torch.int64, device=col.device
                          ).scatter_reduce(0, parent,
                                           torch.where(hit, pos, total),
                                           "amin")
        has = best < total
    elif occ == "last":
        best = torch.full((n,), -1, dtype=torch.int64, device=col.device
                          ).scatter_reduce(0, parent,
                                           torch.where(hit, pos, -1), "amax")
        has = best >= 0
    else:
        raise Invalid(f"map_lookup: bad occurrence {occ!r}")
    if col.validity is not None:
        has = has & col.validity
    return _take_valid(items, best.clamp(0, max(total - 1, 0)), has)


register_function("map_lookup", "scalar", 1, MapLookupOptions)(
    _map_lookup_exec)
