"""Logical types and their torch physical storage (counterpart of
arrow1_tpu/dtypes.py, fixed-width numeric and bool types only).

Every column is one fixed-width tensor. Strings and binaries are
dictionary-encoded at ingest and travel as int32 codes; their values stay
on the host. Validity is an unpacked bool tensor. Temporal, decimal and
nested types come with later slices of the port and raise
``NotImplementedError_`` here.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .errors import NotImplementedError_

__all__ = ["DataType", "bool_", "int8", "int16", "int32", "int64", "uint8",
           "uint16", "uint32", "uint64", "float16", "float32", "float64",
           "string", "large_string", "binary", "large_binary", "dictionary",
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
_LATER = "is not ported yet: temporal, decimal and nested types come with " \
    "the registry slice (ROADMAP Queue 1 item 10)"


@dataclasses.dataclass(frozen=True)
class DataType:
    """A logical column type, identified by its ``kind``; a
    ``dictionary`` type (the result of dictionary_encode) also names its
    index and value types."""

    kind: str
    index_type: Optional["DataType"] = None
    value_type: Optional["DataType"] = None

    def __post_init__(self):
        if self.kind not in _PHYS and self.kind not in _DICT_KINDS and \
                self.kind != "dictionary":
            raise NotImplementedError_(f"type {self.kind!r} {_LATER}")

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
    def is_binary(self) -> bool:
        """Dictionary-encoded string or binary."""
        return self.kind in _DICT_KINDS

    @property
    def is_dictionary(self) -> bool:
        """An explicit dictionary type: codes into a host value pool."""
        return self.kind == "dictionary"

    def physical_dtype(self) -> torch.dtype:
        """The torch dtype of the column's data tensor (int32 codes for
        dictionary-encoded strings, the index type's for dictionaries)."""
        if self.is_dictionary:
            return self.index_type.physical_dtype()
        return _PHYS.get(self.kind, torch.int32)

    def numpy_dtype(self) -> np.dtype:
        """The numpy dtype of the host copy of ``physical_dtype()``."""
        if self.is_dictionary:
            return self.index_type.numpy_dtype()
        return np.dtype(self.kind if self.kind in _PHYS else np.int32)

    def __repr__(self) -> str:
        if self.is_dictionary:
            return f"dictionary<{self.value_type!r}, {self.index_type!r}>"
        return self.kind


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
    raise NotImplementedError_(f"numpy dtype {d} {_LATER}")


def from_arrow(pa_type) -> DataType:
    """Map a pyarrow type (host ingest boundary; imports pyarrow lazily)."""
    import pyarrow as pa

    if pa.types.is_boolean(pa_type):
        return bool_
    if pa.types.is_integer(pa_type) or pa.types.is_floating(pa_type):
        return from_numpy_dtype(pa_type.to_pandas_dtype())
    for kind in _DICT_KINDS:
        if pa_type == getattr(pa, kind)():
            return DataType(kind)
    raise NotImplementedError_(f"arrow type {pa_type} {_LATER}")


def to_arrow(t: DataType):
    import pyarrow as pa

    if t.is_dictionary:
        return pa.dictionary(to_arrow(t.index_type), to_arrow(t.value_type))
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
