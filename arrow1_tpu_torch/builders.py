"""Incremental array builders: appends on the host, one transfer to the
device at ``finish`` (counterpart of arrow1_tpu/builders.py).

Reference: cpp/src/arrow/array/builder_base.h:49 (ArrayBuilder: Append,
AppendNull, AppendValues, Finish, Reset, Reserve) and the typed builders
(builder_primitive.h, builder_binary.h, builder_decimal.h,
builder_nested.h, builder_dict.h).

A builder accumulates in host buffers (a doubling numpy buffer for the
fixed-width types, whose bytes the memory pool counts); ``finish(device)``
turns them into the port's layout and puts the whole column, a nested
one's children included, on ``device`` (CUDA unless the caller names the
CPU) with the IPC reader's one staging copy (``io.ipc_native._stage``).
Strings finish dictionary-encoded, their codes in the pool's sorted
order, through the native MemoTable.
"""

from __future__ import annotations

from decimal import Context, Decimal
from typing import List, Optional

import numpy as np

from . import dtypes as dt
from .column import Column, Dictionary, ListColumn, StructColumn
from .device import resolve_device
from .errors import Invalid

__all__ = [
    "ArrayBuilder", "BooleanBuilder", "Int8Builder", "Int16Builder",
    "Int32Builder", "Int64Builder", "UInt8Builder", "UInt16Builder",
    "UInt32Builder", "UInt64Builder", "Float32Builder", "Float64Builder",
    "StringBuilder", "BinaryBuilder", "Decimal128Builder",
    "Decimal256Builder", "ListBuilder", "StructBuilder",
    "DictionaryBuilder", "builder_for",
]

_MIN_CAP = 32


def _mask(valid: List[bool], nulls: int) -> Optional[np.ndarray]:
    return np.array(valid, dtype=bool) if nulls else None


class ArrayBuilder:
    """The common surface (builder_base.h:49)."""

    def __len__(self) -> int:
        return self._length

    @property
    def null_count(self) -> int:
        return self._null_count

    def append(self, value) -> "ArrayBuilder":
        raise NotImplementedError

    def append_null(self) -> "ArrayBuilder":
        raise NotImplementedError

    def append_values(self, values, valid=None) -> "ArrayBuilder":
        """Bulk append; ``valid`` is an optional bool sequence (a None
        value is a null too)."""
        if valid is None:
            for v in values:
                self.append_null() if v is None else self.append(v)
        else:
            for v, ok in zip(values, valid):
                self.append(v) if ok else self.append_null()
        return self

    def extend(self, values):
        return self.append_values(values)

    def _host(self):
        """The built column with numpy arrays in its tensor slots; resets
        the builder."""
        raise NotImplementedError

    def finish(self, device=None):
        """The built column on ``device``; the builder starts over."""
        from .io.ipc_native import _stage

        return _stage(self._host(), resolve_device(device))

    def reset(self):
        raise NotImplementedError


class _PrimitiveBuilder(ArrayBuilder):
    """A doubling numpy buffer and a validity allocated at the first
    null."""

    _np_dtype: np.dtype
    _dtype: dt.DataType
    _sentinel = 0

    def __init__(self):
        self._pool = None
        self._buf = None
        self.reset()

    def reset(self):
        if self._pool is None:
            # one pool for the builder's life: frees land where the
            # allocations were counted
            from .memory import default_memory_pool

            self._pool = default_memory_pool()
        if self._buf is not None:
            self._pool.free(self._buf.nbytes)
        self._buf = np.empty(_MIN_CAP, dtype=self._np_dtype)
        self._pool.allocate(self._buf.nbytes)
        self._valid: Optional[np.ndarray] = None
        self._length = 0
        self._null_count = 0

    def __del__(self):
        if getattr(self, "_buf", None) is not None and self._pool is not None:
            self._pool.free(self._buf.nbytes)

    def reserve(self, n: int):
        need = self._length + n
        if need > len(self._buf):
            cap = max(len(self._buf) * 2, need)
            old = self._buf.nbytes
            self._buf = np.resize(self._buf, cap)
            self._pool.allocate(self._buf.nbytes - old)
            if self._valid is not None:
                v = np.ones(cap, dtype=bool)
                v[:self._length] = self._valid[:self._length]
                self._valid = v
        return self

    def append(self, value):
        self.reserve(1)
        self._buf[self._length] = value
        if self._valid is not None:
            self._valid[self._length] = True
        self._length += 1
        return self

    def append_null(self):
        self.reserve(1)
        if self._valid is None:
            self._valid = np.ones(len(self._buf), dtype=bool)
        self._buf[self._length] = self._sentinel
        self._valid[self._length] = False
        self._length += 1
        self._null_count += 1
        return self

    def append_values(self, values, valid=None):
        """A numpy array is copied in one assignment; ``valid`` (a bool
        array) marks its nulls."""
        if not isinstance(values, np.ndarray) or values.dtype == object:
            return super().append_values(values, valid)
        n = len(values)
        self.reserve(n)
        lo, hi = self._length, self._length + n
        self._buf[lo:hi] = values
        if valid is not None:
            valid = np.asarray(valid, dtype=bool)
            nulls = int(n - np.count_nonzero(valid))
            if nulls and self._valid is None:
                self._valid = np.ones(len(self._buf), dtype=bool)
            self._buf[lo:hi][~valid] = self._sentinel
            self._null_count += nulls
        if self._valid is not None:
            self._valid[lo:hi] = True if valid is None else valid
        self._length = hi
        return self

    def _host(self) -> Column:
        col = Column(self._buf[:self._length].copy(), self._dtype,
                     validity=self._valid[:self._length].copy()
                     if self._null_count else None)
        self.reset()
        return col


def _make_primitive(name, np_dtype, a1t_dtype, sentinel=0):
    return type(name, (_PrimitiveBuilder,), {
        "_np_dtype": np.dtype(np_dtype), "_dtype": a1t_dtype,
        "_sentinel": sentinel})


BooleanBuilder = _make_primitive("BooleanBuilder", np.bool_, dt.bool_,
                                 False)
Int8Builder = _make_primitive("Int8Builder", np.int8, dt.int8)
Int16Builder = _make_primitive("Int16Builder", np.int16, dt.int16)
Int32Builder = _make_primitive("Int32Builder", np.int32, dt.int32)
Int64Builder = _make_primitive("Int64Builder", np.int64, dt.int64)
UInt8Builder = _make_primitive("UInt8Builder", np.uint8, dt.uint8)
UInt16Builder = _make_primitive("UInt16Builder", np.uint16, dt.uint16)
UInt32Builder = _make_primitive("UInt32Builder", np.uint32, dt.uint32)
UInt64Builder = _make_primitive("UInt64Builder", np.uint64, dt.uint64)
Float32Builder = _make_primitive("Float32Builder", np.float32,
                                 dt.float32, 0.0)
Float64Builder = _make_primitive("Float64Builder", np.float64,
                                 dt.float64, 0.0)


class StringBuilder(ArrayBuilder):
    """builder_binary.h StringBuilder, finished into the port's
    dictionary-encoded string column (codes on the device, the sorted
    distinct values on the host)."""

    _coerce = staticmethod(str)
    _dtype = dt.string

    def __init__(self):
        self.reset()

    def reset(self):
        self._values: List[object] = []
        self._length = 0
        self._null_count = 0

    def append(self, value):
        self._values.append(self._coerce(value))
        self._length += 1
        return self

    def append_null(self):
        self._values.append(None)
        self._length += 1
        self._null_count += 1
        return self

    def append_values(self, values, valid=None):
        """A sequence of values (None for a null), taken in one extend
        when ``valid`` is None."""
        if valid is not None:
            return super().append_values(values, valid)
        vals = values.tolist() if isinstance(values, np.ndarray) \
            else list(values)
        nulls = vals.count(None)
        self._values.extend(v if v is None else self._coerce(v)
                            for v in vals)
        self._length += len(vals)
        self._null_count += nulls
        return self

    def _encoded(self, vals: List[object]) -> List[bytes]:
        return [b"" if v is None else v.encode("utf8") for v in vals]

    def _host(self) -> Column:
        from .native import MemoTable

        raw = self._encoded(self._values)
        n = len(raw)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(np.fromiter(map(len, raw), np.int64, n), out=offsets[1:])
        memo = MemoTable(max(64, n // 4))
        first = memo.encode_array(np.frombuffer(b"".join(raw), np.uint8),
                                  offsets) if n else np.zeros(0, np.int32)
        pool = memo.values()
        order = np.argsort(np.asarray(pool, dtype=object), kind="stable")
        rank = np.empty(len(pool), dtype=np.int32)
        rank[order] = np.arange(len(pool), dtype=np.int32)
        uniq = np.empty(len(pool), dtype=object)
        uniq[:] = [self._decoded(pool[i]) for i in order]
        valid = _mask([v is not None for v in self._values],
                      self._null_count)
        col = Column(rank[first] if n else np.zeros(0, np.int32),
                     self._dtype, validity=valid,
                     dictionary=Dictionary(uniq))
        self.reset()
        return col

    @staticmethod
    def _decoded(b: bytes):
        return b.decode("utf8")


class BinaryBuilder(StringBuilder):
    _coerce = staticmethod(bytes)
    _dtype = dt.binary

    def _encoded(self, vals):
        return [b"" if v is None else v for v in vals]

    @staticmethod
    def _decoded(b: bytes):
        return b


def _unscaled(value, scale: int, digits: int) -> int:
    if isinstance(value, Decimal):
        ctx = Context(prec=digits)
        return int(value.scaleb(scale, context=ctx)
                   .to_integral_exact(context=ctx))
    return int(value)


class _DecimalBuilder(ArrayBuilder):
    """builder_decimal.h: unscaled integers kept as Python ints, split
    into the port's int64 limbs at ``finish``."""

    _kind: str

    def __init__(self, dtype: dt.DataType):
        if dtype.kind != self._kind:
            raise Invalid(f"{type(self).__name__} needs a {self._kind} "
                          f"dtype, got {dtype}")
        self._dtype = dtype
        self.reset()

    def reset(self):
        self._ints: List[int] = []
        self._valid: List[bool] = []
        self._length = 0
        self._null_count = 0

    def append(self, value):
        self._ints.append(_unscaled(value, self._dtype.scale,
                                    2 * self._dtype.precision + 2))
        self._valid.append(True)
        self._length += 1
        return self

    def append_null(self):
        self._ints.append(0)
        self._valid.append(False)
        self._length += 1
        self._null_count += 1
        return self

    def _host(self) -> Column:
        nl = self._dtype.limbs
        limbs = np.array([[((v >> (64 * j)) & ((1 << 64) - 1))
                           for j in range(nl)] for v in self._ints],
                         dtype=np.uint64).reshape(-1, nl).view(np.int64)
        col = Column(limbs[:, 0].copy(), self._dtype,
                     validity=_mask(self._valid, self._null_count),
                     data2=limbs[:, 1].copy() if nl == 2
                     else limbs[:, 1:].copy())
        self.reset()
        return col


class Decimal128Builder(_DecimalBuilder):
    """Two int64 limbs: the low one in ``data``, the high in ``data2``."""
    _kind = "decimal128"


class Decimal256Builder(_DecimalBuilder):
    """Four int64 limbs: limb 0 in ``data``, limbs 1-3 in ``data2[n, 3]``."""
    _kind = "decimal256"


class ListBuilder(ArrayBuilder):
    """builder_nested.h ListBuilder: offsets and a child builder."""

    def __init__(self, value_builder: ArrayBuilder):
        self._child = value_builder
        self.reset()

    def reset(self):
        self._offsets = [0]
        self._valid: List[bool] = []
        self._length = 0
        self._null_count = 0

    @property
    def values(self) -> ArrayBuilder:
        return self._child

    def append(self, value):
        """Append one row's items; or feed ``values`` and ``close_row``."""
        for v in value:
            self._child.append_null() if v is None else self._child.append(v)
        return self.close_row()

    def close_row(self):
        """Seal the current row after feeding ``values`` directly."""
        self._offsets.append(len(self._child))
        self._valid.append(True)
        self._length += 1
        return self

    def append_null(self):
        self._offsets.append(len(self._child))
        self._valid.append(False)
        self._length += 1
        self._null_count += 1
        return self

    def _host(self) -> ListColumn:
        child = self._child._host()
        col = ListColumn(np.array(self._offsets, dtype=np.int64), child,
                         dt.list_(child.dtype),
                         validity=_mask(self._valid, self._null_count))
        self.reset()
        return col


class StructBuilder(ArrayBuilder):
    """builder_nested.h StructBuilder: a child builder a field."""

    def __init__(self, names: List[str], builders: List[ArrayBuilder]):
        if len(names) != len(builders):
            raise Invalid("StructBuilder: names/builders length mismatch")
        self._names = list(names)
        self._children = list(builders)
        self.reset()

    def reset(self):
        for b in self._children:
            b.reset()
        self._valid: List[bool] = []
        self._length = 0
        self._null_count = 0

    def append(self, value: dict):
        for name, b in zip(self._names, self._children):
            v = value.get(name)
            b.append_null() if v is None else b.append(v)
        self._valid.append(True)
        self._length += 1
        return self

    def append_null(self):
        for b in self._children:
            b.append_null()
        self._valid.append(False)
        self._length += 1
        self._null_count += 1
        return self

    def _host(self) -> StructColumn:
        children = [b._host() for b in self._children]
        col = StructColumn(children, self._names, dt.struct(
            [(n, c.dtype) for n, c in zip(self._names, children)]),
            validity=_mask(self._valid, self._null_count))
        self.reset()
        return col


class DictionaryBuilder(ArrayBuilder):
    """builder_dict.h: a memoizing builder of strings or bytes, whose codes
    follow the values' first appearance."""

    def __init__(self):
        self.reset()

    def reset(self):
        self._index = {}
        self._uniques: List[object] = []
        self._codes: List[int] = []
        self._valid: List[bool] = []
        self._length = 0
        self._null_count = 0

    def append(self, value):
        if not isinstance(value, (str, bytes, bytearray)):
            raise Invalid("DictionaryBuilder: values must be str or bytes")
        code = self._index.get(value)
        if code is None:
            code = self._index[value] = len(self._uniques)
            self._uniques.append(value)
        self._codes.append(code)
        self._valid.append(True)
        self._length += 1
        return self

    def append_null(self):
        self._codes.append(0)
        self._valid.append(False)
        self._length += 1
        self._null_count += 1
        return self

    @property
    def dictionary_length(self) -> int:
        return len(self._uniques)

    def _host(self) -> Column:
        is_bytes = any(isinstance(u, (bytes, bytearray))
                       for u in self._uniques)
        pool = np.empty(max(len(self._uniques), 1), dtype=object)
        pool[:] = self._uniques or [b"" if is_bytes else ""]
        col = Column(np.array(self._codes, dtype=np.int32),
                     dt.binary if is_bytes else dt.string,
                     validity=_mask(self._valid, self._null_count),
                     dictionary=Dictionary(pool))
        self.reset()
        return col


_BY_DTYPE = {
    dt.bool_: BooleanBuilder, dt.int8: Int8Builder, dt.int16: Int16Builder,
    dt.int32: Int32Builder, dt.int64: Int64Builder, dt.uint8: UInt8Builder,
    dt.uint16: UInt16Builder, dt.uint32: UInt32Builder,
    dt.uint64: UInt64Builder, dt.float32: Float32Builder,
    dt.float64: Float64Builder, dt.string: StringBuilder,
    dt.binary: BinaryBuilder,
}


def builder_for(dtype: dt.DataType) -> ArrayBuilder:
    """MakeBuilder (builder_base.cc): a builder of ``dtype``."""
    if dtype.kind == "decimal128":
        return Decimal128Builder(dtype)
    if dtype.kind == "decimal256":
        return Decimal256Builder(dtype)
    if dtype.kind == "list":
        return ListBuilder(builder_for(dtype.value_field))
    b = _BY_DTYPE.get(dtype)
    if b is None:
        raise Invalid(f"no builder for dtype {dtype}")
    return b()
