"""Logical types and their torch physical storage (counterpart of
arrow1_tpu/dtypes.py: the null, numeric, bool, string, temporal and
interval types).

Every column is one fixed-width tensor (a null-typed column: int8 zeros
under an all-false validity). Strings and binaries are
dictionary-encoded at ingest and travel as int32 codes; their values stay
on the host. Temporal types are their storage integers with a unit tag
(and a time zone for a timestamp): int32 for date32, time32 and
month_interval, int64 for the rest; a month_day_nano_interval packs
(months << 32 | days) into its data and carries nanoseconds in the
column's ``data2``. A decimal is its unscaled integer in 64-bit limbs,
least significant first: ``data`` holds limb 0 (int64 bits) and ``data2``
the rest, the signed high limb of a decimal128 as int64[n], limbs 1-3 of
a decimal256 as int64[n, 3] (the top one signed). Validity is an unpacked
bool tensor. A nested type names its children in ``fields`` ((name,
type) pairs; a list type's one child is "item", a map's two are "key" and
"value"), a fixed_size_list its ``list_size`` and a union its
``type_codes``; its columns are column.ListColumn, StructColumn and
UnionColumn, which hold no tensor of their own type.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from .errors import Invalid

__all__ = ["DataType", "null", "bool_", "int8", "int16", "int32", "int64",
           "uint8", "uint16", "uint32", "uint64", "float16", "float32", "float64",
           "string", "large_string", "binary", "large_binary", "dictionary",
           "date32", "date64", "timestamp", "time32", "time64", "duration",
           "month_interval", "day_time_interval", "month_day_nano_interval",
           "decimal128", "decimal256", "list_", "large_list", "fixed_size_list",
           "struct", "map_", "sparse_union", "dense_union",
           "from_numpy_dtype", "from_arrow", "to_arrow", "as_int64",
           "from_int64"]

_PHYS = {
    "bool": torch.bool,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "uint16": torch.uint16,
    "uint32": torch.uint32,
    "uint64": torch.uint64,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
}
_DICT_KINDS = ("string", "large_string", "binary", "large_binary")
_TEMPORAL_KINDS = ("date32", "date64", "timestamp", "time32", "time64",
                   "duration")
_INTERVAL_KINDS = ("month_interval", "day_time_interval",
                   "month_day_nano_interval")
_INT32_KINDS = ("date32", "time32", "month_interval")
_UNITS = {"timestamp": ("s", "ms", "us", "ns"), "time32": ("s", "ms"),
          "time64": ("us", "ns"), "duration": ("s", "ms", "us", "ns")}
_DECIMAL_KINDS = ("decimal128", "decimal256")
_MAX_PRECISION = {"decimal128": 38, "decimal256": 76}
_NESTED_KINDS = ("list", "large_list", "fixed_size_list", "map", "struct",
                 "sparse_union", "dense_union")


@dataclasses.dataclass(frozen=True)
class DataType:
    """A logical column type, identified by its ``kind``; a
    ``dictionary`` type (the result of dictionary_encode) also names its
    index and value types, a timestamp, time or duration its ``unit``
    ("s", "ms", "us" or "ns"), a timestamp its time zone ``tz`` and a
    decimal its ``precision`` and ``scale``, a nested type its
    ``fields`` (and ``list_size`` or ``type_codes``)."""

    kind: str
    index_type: Optional["DataType"] = None
    value_type: Optional["DataType"] = None
    unit: Optional[str] = None
    tz: Optional[str] = None
    precision: int = 0
    scale: int = 0
    fields: Tuple = ()
    list_size: int = 0
    type_codes: Tuple = ()

    def __post_init__(self):
        if self.kind not in _PHYS and self.kind not in _DICT_KINDS and \
                self.kind not in _TEMPORAL_KINDS and \
                self.kind not in _INTERVAL_KINDS and \
                self.kind not in _DECIMAL_KINDS and \
                self.kind not in _NESTED_KINDS and \
                self.kind not in ("dictionary", "null"):
            raise TypeError(f"unknown type kind {self.kind!r}")
        if self.kind in _UNITS and self.unit not in _UNITS[self.kind]:
            raise ValueError(f"{self.kind}: bad unit {self.unit!r}")
        if self.kind in _DECIMAL_KINDS and not \
                1 <= self.precision <= _MAX_PRECISION[self.kind]:
            raise Invalid(f"Decimal precision out of range [1, "
                          f"{_MAX_PRECISION[self.kind]}]: {self.precision}")

    @property
    def is_null(self) -> bool:
        """The null type: every slot null, stored as int8 zeros under an
        all-false validity."""
        return self.kind == "null"

    @property
    def is_boolean(self) -> bool:
        return self.kind == "bool"

    @property
    def is_signed_integer(self) -> bool:
        return self.kind in ("int8", "int16", "int32", "int64")

    @property
    def is_unsigned_integer(self) -> bool:
        return self.kind in ("uint8", "uint16", "uint32", "uint64")

    @property
    def is_integer(self) -> bool:
        return self.is_signed_integer or self.is_unsigned_integer

    @property
    def is_floating(self) -> bool:
        return self.kind in ("float16", "float32", "float64")

    @property
    def is_numeric(self) -> bool:
        return self.is_integer or self.is_floating

    @property
    def is_temporal(self) -> bool:
        """Dates, times, timestamps and durations (not the intervals)."""
        return self.kind in _TEMPORAL_KINDS

    @property
    def is_interval(self) -> bool:
        return self.kind in _INTERVAL_KINDS

    @property
    def is_decimal(self) -> bool:
        return self.kind in _DECIMAL_KINDS

    @property
    def limbs(self) -> int:
        """64-bit limbs of a decimal's unscaled integer (2 or 4)."""
        return 2 if self.kind == "decimal128" else 4

    @property
    def is_binary(self) -> bool:
        """Dictionary-encoded string or binary."""
        return self.kind in _DICT_KINDS

    @property
    def is_dictionary(self) -> bool:
        """An explicit dictionary type: codes into a host value pool."""
        return self.kind == "dictionary"

    @property
    def is_nested(self) -> bool:
        return self.kind in _NESTED_KINDS

    @property
    def value_field(self) -> "DataType":
        """A list type's item type."""
        return self.fields[0][1]

    def physical_dtype(self) -> torch.dtype:
        """The torch dtype of the column's data tensor (int32 codes for
        dictionary-encoded strings, the index type's for dictionaries)."""
        if self.is_nested:
            raise TypeError(f"{self!r} has no single physical dtype")
        if self.is_dictionary:
            return self.index_type.physical_dtype()
        if self.is_null:
            return torch.int8
        if self.is_temporal or self.is_interval or self.is_decimal:
            return torch.int32 if self.kind in _INT32_KINDS else torch.int64
        return _PHYS.get(self.kind, torch.int32)

    def numpy_dtype(self) -> np.dtype:
        """The numpy dtype of the host copy of ``physical_dtype()``."""
        if self.is_nested:
            raise TypeError(f"{self!r} has no single physical dtype")
        if self.is_dictionary:
            return self.index_type.numpy_dtype()
        if self.is_null:
            return np.dtype(np.int8)
        if self.is_temporal or self.is_interval or self.is_decimal:
            return np.dtype(np.int32 if self.kind in _INT32_KINDS
                            else np.int64)
        return np.dtype(self.kind if self.kind in _PHYS else np.int32)

    def __repr__(self) -> str:
        if self.is_dictionary:
            return f"dictionary<{self.value_type!r}, {self.index_type!r}>"
        if self.kind == "timestamp":
            return f"timestamp[{self.unit}]" + \
                (f", tz={self.tz}" if self.tz else "")
        if self.unit is not None:
            return f"{self.kind}[{self.unit}]"
        if self.is_decimal:
            return f"{self.kind}({self.precision}, {self.scale})"
        if self.kind in ("list", "large_list"):
            return f"{self.kind}<{self.fields[0][1]!r}>"
        if self.kind == "fixed_size_list":
            return f"fixed_size_list<{self.fields[0][1]!r}>[{self.list_size}]"
        if self.kind == "map":
            return f"map<{self.fields[0][1]!r}, {self.fields[1][1]!r}>"
        if self.kind == "struct":
            return "struct<" + ", ".join(f"{n}: {t!r}"
                                         for n, t in self.fields) + ">"
        if self.is_nested:
            return f"{self.kind}<" + ", ".join(
                f"{n}: {t!r}={c}" for (n, t), c in
                zip(self.fields, self.type_codes)) + ">"
        return self.kind


null = DataType("null")
bool_ = DataType("bool")
int8 = DataType("int8")
int16 = DataType("int16")
int32 = DataType("int32")
int64 = DataType("int64")
uint8 = DataType("uint8")
uint16 = DataType("uint16")
uint32 = DataType("uint32")
uint64 = DataType("uint64")
float16 = DataType("float16")
float32 = DataType("float32")
float64 = DataType("float64")
string = DataType("string")
large_string = DataType("large_string")
binary = DataType("binary")
large_binary = DataType("large_binary")
date32 = DataType("date32")
date64 = DataType("date64")


def timestamp(unit: str = "us", tz: Optional[str] = None) -> DataType:
    return DataType("timestamp", unit=unit, tz=tz)


def time32(unit: str = "s") -> DataType:
    return DataType("time32", unit=unit)


def time64(unit: str = "us") -> DataType:
    return DataType("time64", unit=unit)


def duration(unit: str = "us") -> DataType:
    return DataType("duration", unit=unit)


def month_interval() -> DataType:
    return DataType("month_interval")


def day_time_interval() -> DataType:
    return DataType("day_time_interval")


def month_day_nano_interval() -> DataType:
    return DataType("month_day_nano_interval")


def decimal128(precision: int, scale: int = 0) -> DataType:
    """Reference: util/basic_decimal.h Decimal128 (precision 1-38)."""
    return DataType("decimal128", precision=precision, scale=scale)


def decimal256(precision: int, scale: int = 0) -> DataType:
    """Reference: util/basic_decimal.h Decimal256 (precision 1-76)."""
    return DataType("decimal256", precision=precision, scale=scale)


def list_(value_type: DataType) -> DataType:
    return DataType("list", fields=(("item", value_type),))


def large_list(value_type: DataType) -> DataType:
    return DataType("large_list", fields=(("item", value_type),))


def fixed_size_list(value_type: DataType, list_size: int) -> DataType:
    return DataType("fixed_size_list", fields=(("item", value_type),),
                    list_size=list_size)


def struct(fields) -> DataType:
    """``fields``: (name, type) pairs."""
    return DataType("struct", fields=tuple((n, t) for n, t in fields))


def map_(key_type: DataType, item_type: DataType) -> DataType:
    return DataType("map", fields=(("key", key_type), ("value", item_type)))


def _union(kind, fields, type_codes) -> DataType:
    fields = tuple((n, t) for n, t in fields)
    codes = tuple(type_codes) if type_codes else tuple(range(len(fields)))
    return DataType(kind, fields=fields, type_codes=codes)


def sparse_union(fields, type_codes=None) -> DataType:
    return _union("sparse_union", fields, type_codes)


def dense_union(fields, type_codes=None) -> DataType:
    return _union("dense_union", fields, type_codes)


def dictionary(index_type: DataType, value_type: DataType) -> DataType:
    return DataType("dictionary", index_type=index_type,
                    value_type=value_type)


def from_numpy_dtype(np_dtype) -> DataType:
    d = np.dtype(np_dtype)
    if d.kind == "b":
        return bool_
    if d.kind in "iuf":
        prefix = {"i": "int", "u": "uint", "f": "float"}[d.kind]
        return DataType(f"{prefix}{8 * d.itemsize}")
    if d.kind in "OUS":
        return string if d.kind != "S" else binary
    raise TypeError(f"unsupported numpy dtype {d}")


def from_arrow(pa_type) -> DataType:
    """Map a pyarrow type (host ingest boundary; imports pyarrow lazily)."""
    import pyarrow as pa

    if pa.types.is_null(pa_type):
        return null
    if pa.types.is_boolean(pa_type):
        return bool_
    if pa.types.is_integer(pa_type) or pa.types.is_floating(pa_type):
        return from_numpy_dtype(pa_type.to_pandas_dtype())
    if pa.types.is_dictionary(pa_type):
        # ingest keeps a string pool as codes and decodes a numeric one:
        # either way the column has the value type
        return from_arrow(pa_type.value_type)
    for kind in _DICT_KINDS:
        if pa_type == getattr(pa, kind)():
            return DataType(kind)
    if pa.types.is_date32(pa_type):
        return date32
    if pa.types.is_date64(pa_type):
        return date64
    if pa.types.is_timestamp(pa_type):
        return timestamp(pa_type.unit, pa_type.tz)
    if pa.types.is_time32(pa_type):
        return time32(pa_type.unit)
    if pa.types.is_time64(pa_type):
        return time64(pa_type.unit)
    if pa.types.is_duration(pa_type):
        return duration(pa_type.unit)
    if pa.types.is_decimal128(pa_type):
        return decimal128(pa_type.precision, pa_type.scale)
    if pa.types.is_decimal256(pa_type):
        return decimal256(pa_type.precision, pa_type.scale)
    if pa_type == pa.month_day_nano_interval():
        return month_day_nano_interval()
    if str(pa_type) in ("month_interval", "day_time_interval"):
        return DataType(str(pa_type))   # no Python constructor in pyarrow
    if pa.types.is_list(pa_type):
        return list_(from_arrow(pa_type.value_type))
    if pa.types.is_large_list(pa_type):
        return large_list(from_arrow(pa_type.value_type))
    if pa.types.is_fixed_size_list(pa_type):
        return fixed_size_list(from_arrow(pa_type.value_type),
                               pa_type.list_size)
    if pa.types.is_struct(pa_type):
        return struct((f.name, from_arrow(f.type)) for f in pa_type)
    if pa.types.is_map(pa_type):
        return map_(from_arrow(pa_type.key_type),
                    from_arrow(pa_type.item_type))
    if pa.types.is_union(pa_type):
        make = sparse_union if pa_type.mode == "sparse" else dense_union
        return make([(f.name, from_arrow(f.type)) for f in pa_type],
                    list(pa_type.type_codes))
    raise TypeError(f"unsupported arrow type {pa_type}")


def to_arrow(t: DataType):
    import pyarrow as pa

    if t.is_null:
        return pa.null()
    if t.is_dictionary:
        return pa.dictionary(to_arrow(t.index_type), to_arrow(t.value_type))
    if t.kind == "timestamp":
        return pa.timestamp(t.unit, t.tz)
    if t.kind in _UNITS:
        return getattr(pa, t.kind)(t.unit)
    if t.is_decimal:
        return getattr(pa, t.kind)(t.precision, t.scale)
    if t.kind in ("month_interval", "day_time_interval"):
        # pyarrow has no Python constructor for these two (nor has the
        # JAX package's export)
        raise TypeError(f"pyarrow exposes no Python {t.kind} type")
    if t.kind in ("list", "large_list"):
        return getattr(pa, t.kind if t.kind == "large_list" else "list_")(
            to_arrow(t.value_field))
    if t.kind == "fixed_size_list":
        return pa.list_(to_arrow(t.value_field), t.list_size)
    if t.kind == "map":
        return pa.map_(to_arrow(t.fields[0][1]), to_arrow(t.fields[1][1]))
    if t.kind == "struct":
        return pa.struct([pa.field(n, to_arrow(c)) for n, c in t.fields])
    if t.is_nested:
        return pa.union([pa.field(n, to_arrow(c)) for n, c in t.fields],
                        mode="sparse" if t.kind == "sparse_union"
                        else "dense", type_codes=list(t.type_codes))
    return getattr(pa, "bool_" if t.kind == "bool" else t.kind)()


# uint16/32/64 -> the signed type of their width, for bit views: torch
# converts and computes little in the unsigned ones, on either device
_SIGNED_OF = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}


def as_int64(x: torch.Tensor) -> torch.Tensor:
    """Integers and bools widened to int64: signed types sign-extend,
    unsigned ones zero-extend, and uint64 keeps its bits."""
    signed = _SIGNED_OF.get(x.dtype)
    if signed is None:
        return x.to(torch.int64)
    if signed == torch.int64:
        return x.view(torch.int64)
    return x.view(signed).to(torch.int64) & ((1 << 8 * x.element_size()) - 1)


def from_int64(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Inverse of ``as_int64`` for an unsigned ``dtype``: int64 values in
    its range (uint64: any bit pattern) back to its storage."""
    signed = _SIGNED_OF[dtype]
    if signed != torch.int64:
        bits = 8 * dtype.itemsize
        x = torch.where(x >= 1 << (bits - 1), x - (1 << bits), x)
    return x.to(signed).view(dtype)
