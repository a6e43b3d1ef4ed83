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

__all__ = ["Column", "Dictionary"]


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
    hi = col.data2.cpu().numpy().reshape(col.length, -1)
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
