"""Tabular containers (counterpart of arrow1_tpu/table.py): RecordBatch,
named equal-length Columns on one device, the unit every kernel runs on;
Table, a host-side sequence of same-schema RecordBatches that the query
layer streams batch by batch; ChunkedColumn, one column of a Table.

``concat_columns`` carries ``data2`` (an interval's nanoseconds, a
decimal's high limbs) along, and joins list, struct and union columns
and a map's child batches part by part.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from . import dtypes as dt
from .column import Column, ListColumn, StructColumn, UnionColumn
from .errors import Invalid, KeyError_

__all__ = ["RecordBatch", "Table", "ChunkedColumn", "record_batch", "table",
           "concat_batches", "concat_columns", "with_parent_validity",
           "map_tensors"]


class RecordBatch:
    """An ordered set of named, equal-length columns on one device."""

    __slots__ = ("columns", "names")

    def __init__(self, columns: Tuple[Column, ...], names: Tuple[str, ...]):
        if len(columns) != len(names):
            raise ValueError(f"{len(columns)} columns but {len(names)} names")
        lengths = {c.length for c in columns}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")
        self.columns = tuple(columns)
        self.names = tuple(names)

    @property
    def num_rows(self) -> int:
        return self.columns[0].length if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, key) -> Column:
        if isinstance(key, int):
            return self.columns[key]
        try:
            return self.columns[self.names.index(key)]
        except ValueError:
            raise KeyError_(f"no column named {key!r}") from None

    def __getitem__(self, key) -> Column:
        return self.column(key)

    def select(self, names: Sequence[str]) -> "RecordBatch":
        return RecordBatch(tuple(self.column(n) for n in names), tuple(names))

    def set_column(self, name: str, col: Column) -> "RecordBatch":
        """Replace the column ``name``, or append it when there is none."""
        if name in self.names:
            cols = list(self.columns)
            cols[self.names.index(name)] = col
            return RecordBatch(tuple(cols), self.names)
        return RecordBatch(self.columns + (col,), self.names + (name,))

    def drop(self, names: Sequence[str]) -> "RecordBatch":
        keep = [(n, c) for n, c in zip(self.names, self.columns)
                if n not in names]
        return RecordBatch(tuple(c for _, c in keep),
                           tuple(n for n, _ in keep))

    def rename(self, mapping: dict) -> "RecordBatch":
        return RecordBatch(self.columns,
                           tuple(mapping.get(n, n) for n in self.names))

    def slice(self, offset: int,
              length: Optional[int] = None) -> "RecordBatch":
        return RecordBatch(tuple(c.slice(offset, length)
                                 for c in self.columns), self.names)

    def to_pydict(self) -> dict:
        return {n: c.to_pylist() for n, c in zip(self.names, self.columns)}

    def to_struct_array(self) -> StructColumn:
        """The batch as one struct column of its columns (no validity)."""
        return StructColumn(self.columns, self.names, dt.struct(
            (n, c.dtype) for n, c in zip(self.names, self.columns)))

    @classmethod
    def from_struct_array(cls, struct_col: StructColumn) -> "RecordBatch":
        return cls(struct_col.children, struct_col.names)

    def to_arrow(self):
        from .interop import record_batch_to_arrow

        return record_batch_to_arrow(self)

    def __repr__(self):
        cols = ", ".join(f"{n}: {c.dtype!r}"
                         for n, c in zip(self.names, self.columns))
        return f"RecordBatch[{self.num_rows} rows]({cols})"


def concat_columns(cols: Sequence[Column]) -> Column:
    """Same-type Columns end to end (reference: array/concatenate.cc).
    Validity is materialized when any part has one; dictionary columns
    whose parts hold different value pools are re-encoded against one
    merged pool (``ops.dictionary.unify_dictionaries``). List columns
    join their children and rebase their offsets; struct columns, a
    map's child batches and sparse unions join child by child; a dense
    union's offsets are rebased by the lengths of its earlier parts'
    children."""
    if not cols:
        raise Invalid("concat_columns: no columns")
    if len(cols) == 1:
        return cols[0]
    first = cols[0]
    if isinstance(first, RecordBatch):   # a map's key/value child batch
        return RecordBatch(tuple(concat_columns([c.columns[i] for c in cols])
                                 for i in range(first.num_columns)),
                           first.names)
    if any(c.dtype != first.dtype for c in cols):
        raise Invalid("concat_columns: the columns differ in type: "
                      f"{sorted({repr(c.dtype) for c in cols})}")
    if isinstance(first, ListColumn):
        return _concat_list_columns(cols)
    if isinstance(first, StructColumn):
        return StructColumn(
            tuple(concat_columns([c.children[i] for c in cols])
                  for i in range(len(first.children))), first.names,
            first.dtype, validity=_concat_validity(cols))
    if isinstance(first, UnionColumn):
        return _concat_union_columns(cols)
    data = torch.cat([c.data for c in cols])
    data2 = None if first.data2 is None else \
        torch.cat([c.data2 for c in cols])
    dictionary = first.dictionary
    if dictionary is not None and any(c.dictionary is not dictionary
                                      for c in cols):
        from .ops.dictionary import unify_dictionaries

        data, dictionary = unify_dictionaries(cols)
    return Column(data, first.dtype, validity=_concat_validity(cols),
                  dictionary=dictionary, data2=data2)


def _concat_validity(cols):
    if any(c.validity is not None for c in cols):
        return torch.cat([c.mask() for c in cols])
    return None


def _concat_list_columns(cols) -> ListColumn:
    """List columns end to end: the children joined, each part's offsets
    (from 0) moved up by the child rows before it."""
    parts, base = [], 0
    for c in cols:
        parts.append(c.offsets[:-1] + base)
        base += int(c.offsets[-1])
    parts.append(cols[0].offsets.new_full((1,), base))
    return ListColumn(torch.cat(parts),
                      concat_columns([c.values for c in cols]),
                      cols[0].dtype, validity=_concat_validity(cols))


def _concat_union_columns(cols) -> UnionColumn:
    first = cols[0]
    type_ids = torch.cat([c.type_ids for c in cols])
    kids = tuple(concat_columns([c.children[i] for c in cols])
                 for i in range(len(first.children)))
    if not first.is_dense:
        return UnionColumn(type_ids, kids, first.dtype)
    codes = list(first.dtype.type_codes)
    bases = [0] * len(codes)
    parts = []
    for c in cols:   # each slot moves up by its child's earlier rows
        shift = torch.zeros(c.length, dtype=torch.int32, device=c.device)
        for k, code in enumerate(codes):
            shift = torch.where(c.type_ids == code, bases[k], shift)
        parts.append(c.offsets + shift)
        bases = [b + kid.length for b, kid in zip(bases, c.children)]
    return UnionColumn(type_ids, kids, first.dtype,
                       offsets=torch.cat(parts))


def concat_batches(batches: Sequence[RecordBatch]) -> RecordBatch:
    """Same-schema batches end to end, column by column
    (``concat_columns``; reference: Table::CombineChunks)."""
    if not batches:
        raise Invalid("concat_batches: no batches")
    if len(batches) == 1:
        return batches[0]
    names = batches[0].names
    for b in batches[1:]:
        if b.names != names:
            raise Invalid(f"concat_batches: schemas differ: {list(names)} "
                          f"vs {list(b.names)}")
    return RecordBatch(tuple(concat_columns([b.columns[i] for b in batches])
                             for i in range(len(names))), names)


def with_parent_validity(col, validity):
    """``col`` with ``validity`` (a parent's, or None) ANDed into its own:
    a struct field read through a null struct slot is null."""
    if validity is None:
        return col
    if isinstance(col, Column):
        return Column(col.data, col.dtype, validity=col.mask() & validity,
                      dictionary=col.dictionary, data2=col.data2)
    if isinstance(col, ListColumn):
        return ListColumn(col.offsets, col.values, col.dtype,
                          validity=col.mask() & validity)
    if isinstance(col, StructColumn):
        return StructColumn(col.children, col.names, col.dtype,
                            validity=col.mask() & validity)
    return col   # a union has no validity of its own


def map_tensors(x, fn):
    """``x`` (a Column, nested column or RecordBatch) rebuilt with ``fn``
    applied to each of its tensors, in one fixed pre-order (so that two
    walks of one structure meet its tensors in the same order); string
    pools are shared."""
    def opt(t):
        return None if t is None else fn(t)

    if isinstance(x, RecordBatch):
        return RecordBatch(tuple(map_tensors(c, fn) for c in x.columns),
                           x.names)
    if isinstance(x, ListColumn):
        return ListColumn(fn(x.offsets), map_tensors(x.values, fn), x.dtype,
                          validity=opt(x.validity))
    if isinstance(x, StructColumn):
        return StructColumn(tuple(map_tensors(c, fn) for c in x.children),
                            x.names, x.dtype, validity=opt(x.validity))
    if isinstance(x, UnionColumn):
        return UnionColumn(fn(x.type_ids),
                           tuple(map_tensors(c, fn) for c in x.children),
                           x.dtype, offsets=opt(x.offsets))
    return Column(fn(x.data), x.dtype, validity=opt(x.validity),
                  dictionary=x.dictionary, data2=opt(x.data2))


class ChunkedColumn:
    """One column of a Table: a sequence of same-type Columns (reference:
    chunked_array.h:67)."""

    __slots__ = ("chunks",)

    def __init__(self, chunks: Sequence[Column]):
        if not chunks:
            raise Invalid("ChunkedColumn requires at least one chunk")
        if any(c.dtype != chunks[0].dtype for c in chunks):
            raise Invalid("ChunkedColumn: the chunks differ in type")
        self.chunks = list(chunks)

    @property
    def dtype(self):
        return self.chunks[0].dtype

    @property
    def num_chunks(self) -> int:
        return len(self.chunks)

    @property
    def length(self) -> int:
        return sum(c.length for c in self.chunks)

    def __len__(self):
        return self.length

    def chunk(self, i: int) -> Column:
        return self.chunks[i]

    def combine_chunks(self) -> Column:
        return concat_columns(self.chunks)

    def to_numpy(self):
        return self.combine_chunks().to_numpy()

    def to_pylist(self) -> list:
        return [v for c in self.chunks for v in c.to_pylist()]

    def to_arrow(self):
        import pyarrow as pa

        return pa.chunked_array([c.to_arrow() for c in self.chunks])

    def __repr__(self):
        return (f"ChunkedColumn<{self.dtype!r}>[{self.length} rows, "
                f"{self.num_chunks} chunks]")


class Table:
    """A sequence of same-schema RecordBatches (reference: table.h:42).

    A host-side container: device work runs per batch, as the query layer
    streams it (``query``, ``exec.plan``), or on ``combine_chunks()``."""

    __slots__ = ("batches", "names")

    def __init__(self, batches: Sequence[RecordBatch]):
        if not batches:
            raise Invalid("Table requires at least one batch (possibly "
                          "empty)")
        names = batches[0].names
        for b in batches[1:]:
            if b.names != names:
                raise Invalid(f"Table: schemas differ: {list(names)} vs "
                              f"{list(b.names)}")
        self.batches = list(batches)
        self.names = names

    @classmethod
    def from_batches(cls, batches: Sequence[RecordBatch]) -> "Table":
        return cls(list(batches))

    @property
    def num_rows(self) -> int:
        return sum(b.num_rows for b in self.batches)

    @property
    def num_columns(self) -> int:
        return len(self.names)

    def combine_chunks(self) -> RecordBatch:
        return concat_batches(self.batches)

    def column(self, key) -> ChunkedColumn:
        return ChunkedColumn([b.column(key) for b in self.batches])

    def __getitem__(self, key) -> ChunkedColumn:
        return self.column(key)

    def flatten(self) -> "Table":
        """Each struct column replaced by its fields, named
        "{column}.{field}" (pyarrow.Table.flatten); a null struct slot
        nulls its fields. Batch by batch."""
        out = []
        for b in self.batches:
            cols, names = [], []
            for n, c in zip(b.names, b.columns):
                if not isinstance(c, StructColumn):
                    cols.append(c)
                    names.append(n)
                    continue
                for cn, cc in zip(c.names, c.children):
                    cols.append(with_parent_validity(cc, c.validity))
                    names.append(f"{n}.{cn}")
            out.append(RecordBatch(tuple(cols), tuple(names)))
        return Table(out)

    def to_arrow(self):
        from .interop import table_to_arrow

        return table_to_arrow(self)

    def __repr__(self):
        return f"Table[{self.num_rows} rows, {len(self.batches)} batches]"


def record_batch(data, names: Optional[Sequence[str]] = None,
                 device=None) -> RecordBatch:
    """Build a RecordBatch on ``device`` (CUDA unless the caller names
    another) from a dict of name -> numpy array, a sequence of arrays with
    ``names``, or a pyarrow RecordBatch/Table."""
    from .device import resolve_device
    from .interop import column_from_numpy, record_batch_from_arrow

    dev = resolve_device(device)
    if isinstance(data, dict):
        return RecordBatch(tuple(column_from_numpy(v, device=dev)
                                 for v in data.values()),
                           tuple(data.keys()))
    if names is not None:
        return RecordBatch(tuple(column_from_numpy(v, device=dev)
                                 for v in data), tuple(names))
    return record_batch_from_arrow(data, device=dev)


def table(data, names: Optional[Sequence[str]] = None,
          device=None) -> Table:
    """A one-batch Table on ``device`` (CUDA unless the caller names
    another), from what ``record_batch`` takes. ``interop.table_from_arrow``
    keeps a pyarrow Table's record batches as the Table's batches."""
    return Table([record_batch(data, names, device=device)])
