"""Column: one typed tensor plus an optional validity mask (counterpart of
arrow1_tpu/column.py).

- ``data``: a 1-D fixed-width tensor. For string/binary columns it holds
  int32 dictionary codes and the values live host-side in a ``Dictionary``.
- ``validity``: a bool tensor, or None when every slot is valid.
- ``data2``: a second tensor for wide types: a month_day_nano_interval's
  nanoseconds (its ``data`` packs months << 32 | days), a decimal128's
  signed high limb (int64[n]; ``data`` is its low limb's bits) or a
  decimal256's limbs 1-3 (int64[n, 3]). Slices, gathers, filters and
  concatenations carry it.

Nested columns hold no tensor of their own type: ``ListColumn`` (list,
large_list, fixed_size_list, map) is int64 offsets on the column's
device, starting at 0, and a child column (a map's is a RecordBatch of
its keys and values); ``StructColumn`` is its children and a validity;
``UnionColumn`` its type ids (int8), a dense union's int32 offsets into
its children, and the children.

The JAX package also carries ``bits``, an int64 view of f64 data taken at
ingest, because its TPU could not bit-cast f64 on the device. Hopper moves
f64 natively, so the port has no such field.
"""

from __future__ import annotations

import threading
from typing import Optional

import numpy as np
import torch

from . import dtypes as dt

__all__ = ["Column", "Dictionary", "ListColumn", "StructColumn",
           "UnionColumn", "fixed_size_list_column"]


class Dictionary:
    """Host-side value pool of a dictionary-encoded column. Equality is
    identity: a pool is created once, at ingest. ``_byte_matrix`` caches
    the values as a padded byte matrix per device
    (ops/strings_device.py)."""

    __slots__ = ("values", "_rank", "_index", "_lock", "_byte_matrix")

    def __init__(self, values):
        self.values = np.asarray(values)
        self._rank = None
        self._index = None
        self._lock = threading.Lock()
        self._byte_matrix = {}   # torch.device -> (uint8[u, L], int32[u])

    def __len__(self):
        return len(self.values)

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    @property
    def rank(self) -> np.ndarray:
        """int32 array: rank[code] = position of values[code] in sorted
        order."""
        with self._lock:
            if self._rank is None:
                order = np.argsort(self.values, kind="stable")
                rank = np.empty(len(self.values), dtype=np.int32)
                rank[order] = np.arange(len(self.values), dtype=np.int32)
                self._rank = rank
        return self._rank

    @property
    def rank_is_identity(self) -> bool:
        """True when the pool is already sorted (codes are ranks)."""
        r = self.rank
        return bool(np.array_equal(r, np.arange(len(r), dtype=r.dtype)))

    @property
    def index(self) -> dict:
        """value -> code lookup."""
        with self._lock:
            if self._index is None:
                self._index = {v: i for i, v in
                               enumerate(self.values.tolist())}
        return self._index

    def __repr__(self):
        return f"Dictionary({len(self.values)} values)"


def unscaled_ints(col: "Column") -> list:
    """A decimal column's unscaled integers as Python ints (host copy):
    the limbs, least significant first, the top one signed."""
    lo = col.data.cpu().numpy().view(np.uint64).tolist()
    hi = col.data2.cpu().numpy().reshape(col.length, col.dtype.limbs - 1)
    upper = [r.tolist() for r in hi.view(np.uint64).T]
    top = hi[:, -1].tolist()   # signed
    out = []
    for i, v in enumerate(lo):
        for j, limb in enumerate(upper[:-1]):
            v |= limb[i] << (64 * (j + 1))
        out.append(v | (top[i] << (64 * len(upper))))
    return out


def decimal_values(col: "Column") -> np.ndarray:
    """A decimal column as an object array of exact ``decimal.Decimal``
    values (None at nulls)."""
    from decimal import Context, Decimal

    ctx = Context(prec=80)
    out = np.full(col.length, None, dtype=object)
    valid = col.mask().cpu().numpy()
    for i, v in enumerate(unscaled_ints(col)):
        if valid[i]:
            out[i] = Decimal(v).scaleb(-col.dtype.scale, ctx)
    return out


class Column:
    """One typed device tensor plus optional validity (and dictionary)."""

    __slots__ = ("data", "validity", "data2", "dtype", "dictionary")

    def __init__(self, data: torch.Tensor, dtype: dt.DataType,
                 validity: Optional[torch.Tensor] = None,
                 dictionary: Optional[Dictionary] = None, data2=None):
        self.data = data
        self.validity = validity
        self.data2 = data2
        self.dtype = dtype
        self.dictionary = dictionary

    def __len__(self):
        return int(self.data.shape[0])

    @property
    def length(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    def slice(self, offset: int, length: Optional[int] = None) -> "Column":
        """Rows [offset, offset + length) (to the end when length is None),
        as views of this column's tensors."""
        end = self.length if length is None else \
            min(offset + length, self.length)
        return Column(self.data[offset:end], self.dtype,
                      validity=None if self.validity is None
                      else self.validity[offset:end],
                      dictionary=self.dictionary,
                      data2=None if self.data2 is None
                      else self.data2[offset:end])

    def mask(self) -> torch.Tensor:
        """The validity as a bool tensor (all True when there is none)."""
        if self.validity is None:
            return torch.ones(self.length, dtype=torch.bool,
                              device=self.device)
        return self.validity

    def to_numpy(self) -> np.ndarray:
        """Host copy of the values: decoded strings (None for nulls), NaN
        for null floats, raw storage otherwise."""
        data = self.data.cpu().numpy()
        valid = None if self.validity is None else \
            self.validity.cpu().numpy()
        if self.dtype.is_binary or self.dtype.is_dictionary:
            # a null slot's code is not read: it need not index the pool
            out = np.full(len(data), None, dtype=object)
            keep = slice(None) if valid is None else valid
            out[keep] = self.dictionary.values[data[keep]]
            return out
        if self.dtype.is_decimal:
            return decimal_values(self)
        if valid is not None and self.dtype.is_floating:
            data = data.copy()
            data[~valid] = np.nan
        return data

    def to_pylist(self) -> list:
        out = self.to_numpy().tolist()
        if self.validity is not None:
            valid = self.validity.cpu().numpy()
            out = [x if ok else None for x, ok in zip(out, valid)]
        return out

    def to_arrow(self):
        """pyarrow Array (host boundary; imports pyarrow lazily)."""
        from .interop import column_to_arrow

        return column_to_arrow(self)

    def __repr__(self):
        return (f"Column<{self.dtype!r}>[{self.length}]"
                + ("" if self.validity is None else " +mask")
                + ("" if self.dictionary is None
                   else f" dict={len(self.dictionary)}"))


class ListColumn:
    """A list, large_list, fixed_size_list or map column: ``offsets``
    (int64[n + 1] on the column's device, offsets[0] == 0) into the
    flattened child ``values`` (a Column or nested column; a map's is a
    RecordBatch of "key" and "value"), and ``validity``. A null slot's
    range is empty but in a fixed_size_list, whose offsets are affine (k
    child slots a row, null parents' included), as Arrow lays it out."""

    __slots__ = ("offsets", "values", "validity", "dtype")

    def __init__(self, offsets: torch.Tensor, values, dtype: dt.DataType,
                 validity: Optional[torch.Tensor] = None):
        self.offsets = offsets
        self.values = values
        self.validity = validity
        self.dtype = dtype

    @property
    def length(self) -> int:
        return int(self.offsets.shape[0]) - 1

    def __len__(self):
        return self.length

    @property
    def device(self) -> torch.device:
        return self.offsets.device

    def mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.length, dtype=torch.bool,
                              device=self.device)
        return self.validity

    def value_lengths(self) -> torch.Tensor:
        """int64[n]: each slot's item count (0 at a null list slot)."""
        return self.offsets[1:] - self.offsets[:-1]

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "ListColumn":
        """Rows [offset, offset + length): the offsets rebased to 0 and
        the child sliced to their range (one host read of the bounds)."""
        end = self.length if length is None else \
            min(offset + length, self.length)
        lo, hi = (int(x) for x in self.offsets[[offset, end]].tolist())
        return ListColumn(self.offsets[offset:end + 1] - lo,
                          self.values.slice(lo, hi - lo), self.dtype,
                          validity=None if self.validity is None
                          else self.validity[offset:end])

    def to_2d(self) -> torch.Tensor:
        """A fixed_size_list of a flat type as its [n, k] tensor."""
        if self.dtype.kind != "fixed_size_list":
            raise TypeError(f"to_2d requires fixed_size_list, got "
                            f"{self.dtype!r}")
        if not isinstance(self.values, Column):
            raise TypeError("to_2d requires a fixed-width child")
        return self.values.data.reshape(self.length, self.dtype.list_size)

    def to_arrow(self):
        from .interop import column_to_arrow

        return column_to_arrow(self)

    def to_pylist(self) -> list:
        return self.to_arrow().to_pylist()

    def __repr__(self):
        return (f"ListColumn<{self.dtype!r}>[{self.length}]"
                + ("" if self.validity is None else " +mask"))


def fixed_size_list_column(values_2d, validity=None, device=None
                           ) -> ListColumn:
    """A fixed_size_list column from an [n, k] array or tensor, on
    ``device`` (CUDA unless the caller names another; a tensor stays on
    its own device when none is named): a ListColumn with affine offsets,
    so every list function takes it; ``to_2d()`` gives the [n, k] view
    back."""
    from .device import resolve_device

    if isinstance(values_2d, torch.Tensor):
        dev = values_2d.device if device is None else resolve_device(device)
        arr = values_2d.to(dev)
    else:
        dev = resolve_device(device)
        arr = torch.from_numpy(np.array(values_2d)).to(dev)
    if arr.dim() != 2:
        raise ValueError(f"expected an [n, k] array, got shape "
                         f"{tuple(arr.shape)}")
    n, k = arr.shape
    child_t = dt.from_numpy_dtype(torch.empty(0, dtype=arr.dtype)
                                  .numpy().dtype)
    child = Column(arr.reshape(n * k), child_t)
    offsets = torch.arange(n + 1, dtype=torch.int64, device=dev) * k
    return ListColumn(offsets, child, dt.fixed_size_list(child_t, k),
                      validity=None if validity is None else
                      torch.as_tensor(np.asarray(validity, dtype=bool)
                                      ).to(dev))


class StructColumn:
    """A struct column: named children (at least one) of equal length and
    a validity. A child keeps its own validity; a null struct slot nulls
    its fields when they are read (``struct_field``, ``Table.flatten``)."""

    __slots__ = ("children", "names", "validity", "dtype")

    def __init__(self, children, names, dtype: dt.DataType,
                 validity: Optional[torch.Tensor] = None):
        self.children = tuple(children)
        self.names = tuple(names)
        self.validity = validity
        self.dtype = dtype

    @property
    def length(self) -> int:
        return self.children[0].length

    def __len__(self):
        return self.length

    @property
    def device(self) -> torch.device:
        return self.children[0].device

    def mask(self) -> torch.Tensor:
        if self.validity is None:
            return torch.ones(self.length, dtype=torch.bool,
                              device=self.device)
        return self.validity

    def field(self, key):
        if isinstance(key, int):
            return self.children[key]
        try:
            return self.children[self.names.index(key)]
        except ValueError:
            from .errors import KeyError_

            raise KeyError_(f"no struct field named {key!r}") from None

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "StructColumn":
        end = self.length if length is None else \
            min(offset + length, self.length)
        return StructColumn(tuple(c.slice(offset, end - offset)
                                  for c in self.children), self.names,
                            self.dtype, validity=None if self.validity is
                            None else self.validity[offset:end])

    def to_arrow(self):
        from .interop import column_to_arrow

        return column_to_arrow(self)

    def to_pylist(self) -> list:
        return self.to_arrow().to_pylist()

    def __repr__(self):
        return f"StructColumn<{self.dtype!r}>[{self.length}]"


class UnionColumn:
    """A sparse or dense union column: ``type_ids`` (int8[n], the type
    code of each slot's child) and the children; a dense union's
    ``offsets`` (int32[n]) index each slot's child, a sparse union's
    children are all n long and read at the slot. A union has no validity
    of its own: a slot is null where its child's value is (``mask()``)."""

    __slots__ = ("type_ids", "offsets", "children", "dtype")

    def __init__(self, type_ids: torch.Tensor, children, dtype: dt.DataType,
                 offsets: Optional[torch.Tensor] = None):
        self.type_ids = type_ids
        self.offsets = offsets
        self.children = tuple(children)
        self.dtype = dtype

    @property
    def length(self) -> int:
        return int(self.type_ids.shape[0])

    def __len__(self):
        return self.length

    @property
    def device(self) -> torch.device:
        return self.type_ids.device

    @property
    def is_dense(self) -> bool:
        return self.dtype.kind == "dense_union"

    @property
    def validity(self):
        return None

    def mask(self) -> torch.Tensor:
        """A slot is valid where its child's value is: one gather of each
        child's mask, selected by type id, on the column's device."""
        valid = torch.ones(self.length, dtype=torch.bool, device=self.device)
        at = self.offsets.to(torch.int64) if self.is_dense else \
            torch.arange(self.length, device=self.device)
        for code, child in zip(self.dtype.type_codes, self.children):
            if child.length == 0:
                continue
            got = child.mask()[at.clamp(0, child.length - 1)]
            valid = torch.where(self.type_ids == code, got, valid)
        return valid

    def slice(self, offset: int, length: Optional[int] = None
              ) -> "UnionColumn":
        """Rows [offset, offset + length): a sparse union's children are
        sliced with it, a dense union's stay whole (its offsets index
        them)."""
        end = self.length if length is None else \
            min(offset + length, self.length)
        if self.is_dense:
            return UnionColumn(self.type_ids[offset:end], self.children,
                               self.dtype, offsets=self.offsets[offset:end])
        return UnionColumn(self.type_ids[offset:end],
                           tuple(c.slice(offset, end - offset)
                                 for c in self.children), self.dtype)

    def to_arrow(self):
        from .interop import column_to_arrow

        return column_to_arrow(self)

    def to_pylist(self) -> list:
        return self.to_arrow().to_pylist()

    def __repr__(self):
        return f"UnionColumn<{self.dtype!r}>[{self.length}]"
