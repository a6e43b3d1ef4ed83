"""Scalar and Datum, the universal kernel argument types (counterpart of
arrow1_tpu/datum.py)."""

from __future__ import annotations

import decimal
from typing import Optional, Union

import numpy as np
import torch

from . import dtypes as dt
from .column import (Column, Dictionary, ListColumn, StructColumn,
                     UnionColumn)
from .errors import Invalid
from .table import RecordBatch

__all__ = ["Scalar", "Datum", "scalar", "as_datum"]


class Scalar:
    """A typed single value, possibly null. ``value`` is a Python number,
    a 0-d tensor, or a dictionary code when ``dictionary`` is set."""

    __slots__ = ("value", "dtype", "is_valid", "dictionary")

    def __init__(self, value, dtype: dt.DataType, is_valid: bool = True,
                 dictionary: Optional[Dictionary] = None):
        self.value = value
        self.dtype = dtype
        self.is_valid = is_valid
        self.dictionary = dictionary

    @property
    def type(self):
        return self.dtype

    def as_py(self):
        if not self.is_valid:
            return None
        v = self.value
        if self.dictionary is not None:
            return self.dictionary.values[int(v)]
        if isinstance(v, torch.Tensor):
            v = v.item()
        if self.dtype.is_decimal:   # the unscaled integer, exactly
            from decimal import Context, Decimal

            return Decimal(int(v)).scaleb(-self.dtype.scale,
                                          Context(prec=80))
        if self.dtype.is_temporal:   # a date, datetime, time or timedelta
            import pyarrow as pa

            return pa.scalar(int(v), type=dt.to_arrow(self.dtype)).as_py()
        return bool(v) if self.dtype.is_boolean else v

    def __repr__(self):
        shown = "null" if not self.is_valid else self.as_py()
        return f"Scalar<{self.dtype!r}>({shown})"


def scalar(value, type: Optional[dt.DataType] = None) -> Scalar:
    """Build a Scalar with arrow-style type inference. A temporal scalar
    is its storage integer with its type, ``scalar(10471, date32)``: as in
    the JAX package, a Python date or datetime is not taken. A decimal
    scalar holds its unscaled integer; ``scalar(Decimal("0.05"))`` infers
    pyarrow's type, decimal128(2, 2) (decimal256 past 38 digits).
    ``scalar(None)`` is a null of the null type, as pyarrow's."""
    if isinstance(value, Scalar):
        return value
    if value is None:
        return Scalar(0, type or dt.null, is_valid=False)
    if isinstance(value, (str, bytes)):
        pool = Dictionary(np.array([value], dtype=object))
        default = dt.string if isinstance(value, str) else dt.binary
        return Scalar(0, type or default, dictionary=pool)
    if isinstance(value, (bool, np.bool_)):
        return Scalar(bool(value), type or dt.bool_)
    if isinstance(value, (int, np.integer)):
        return Scalar(int(value), type or dt.int64)
    if isinstance(value, (float, np.floating)):
        return Scalar(float(value), type or dt.float64)
    if isinstance(value, decimal.Decimal):
        return _decimal_scalar(value, type)
    raise TypeError(f"cannot build Scalar from {value.__class__.__name__}")


def _decimal_scalar(value: decimal.Decimal, type) -> Scalar:
    if not value.is_finite():
        raise Invalid(f"decimal scalar {value} is not finite")
    sign, digits, exp = value.as_tuple()
    if type is None:   # pyarrow's inference
        scale = max(0, -exp)
        precision = max(len(digits) + max(0, exp), scale, 1)
        type = (dt.decimal128 if precision <= 38 else dt.decimal256)(
            precision, scale)
    elif not type.is_decimal:
        raise TypeError(f"a Decimal does not make a {type} scalar")
    unscaled = value.scaleb(type.scale, decimal.Context(prec=100))
    if unscaled != unscaled.to_integral_value():
        raise Invalid(f"decimal scalar {value} does not fit {type}")
    return Scalar(int(unscaled), type)


Datum = Union[Scalar, Column, ListColumn, StructColumn, UnionColumn,
              RecordBatch]


def as_datum(x) -> Datum:
    if isinstance(x, (Scalar, Column, ListColumn, StructColumn, UnionColumn,
                      RecordBatch)):
        return x
    return scalar(x)
