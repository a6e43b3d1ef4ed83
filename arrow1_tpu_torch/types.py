"""pyarrow.types-compatible type predicates (counterpart of
arrow1_tpu/types.py).

Reference: python/pyarrow/types.py: one is_*() predicate per logical
type family, so ``import arrow1_tpu_torch.types as types`` ports 1:1 from
``import pyarrow.types as types``. Predicates take the port's DataType
(and, for convenience, a pyarrow DataType, converted on the fly; only
that conversion imports pyarrow). The port has no null, bfloat16 or
extension type: their predicates are False for every port type.
"""

from __future__ import annotations

from . import dtypes as dt


def _t(t) -> dt.DataType:
    if isinstance(t, dt.DataType):
        return t
    import pyarrow as pa

    if pa.types.is_dictionary(t):   # the type itself, not its values'
        return dt.dictionary(dt.from_arrow(t.index_type),
                             dt.from_arrow(t.value_type))
    return dt.from_arrow(t)


def _kind_pred(*kinds):
    def pred(t) -> bool:
        return _t(t).kind in kinds
    return pred


is_null = _kind_pred("null")
is_boolean = _kind_pred("bool")
is_int8 = _kind_pred("int8")
is_int16 = _kind_pred("int16")
is_int32 = _kind_pred("int32")
is_int64 = _kind_pred("int64")
is_uint8 = _kind_pred("uint8")
is_uint16 = _kind_pred("uint16")
is_uint32 = _kind_pred("uint32")
is_uint64 = _kind_pred("uint64")
is_float16 = _kind_pred("float16")
is_float32 = _kind_pred("float32")
is_float64 = _kind_pred("float64")
is_date32 = _kind_pred("date32")
is_date64 = _kind_pred("date64")
is_date = _kind_pred("date32", "date64")
is_time32 = _kind_pred("time32")
is_time64 = _kind_pred("time64")
is_time = _kind_pred("time32", "time64")
is_timestamp = _kind_pred("timestamp")
is_duration = _kind_pred("duration")
is_decimal128 = _kind_pred("decimal128")
is_decimal256 = _kind_pred("decimal256")
is_decimal = _kind_pred("decimal128", "decimal256")
is_list = _kind_pred("list")
is_large_list = _kind_pred("large_list")
is_fixed_size_list = _kind_pred("fixed_size_list")
is_struct = _kind_pred("struct")
is_map = _kind_pred("map")
is_union = _kind_pred("sparse_union", "dense_union")
is_dictionary = _kind_pred("dictionary")
is_string = _kind_pred("string")
is_large_string = _kind_pred("large_string")
is_unicode = is_string
is_large_unicode = is_large_string
is_binary = _kind_pred("binary")
is_large_binary = _kind_pred("large_binary")
is_fixed_size_binary = _kind_pred("fixed_size_binary")
is_run_end_encoded = _kind_pred("run_end_encoded")

# pyarrow >=13 additions with no storage here: always False
is_binary_view = _kind_pred("binary_view")
is_string_view = _kind_pred("string_view")
is_list_view = _kind_pred("list_view")
is_large_list_view = _kind_pred("large_list_view")
is_decimal32 = _kind_pred("decimal32")
is_decimal64 = _kind_pred("decimal64")


def is_integer(t) -> bool:
    return _t(t).is_integer


def is_signed_integer(t) -> bool:
    return _t(t).is_signed_integer


def is_unsigned_integer(t) -> bool:
    return _t(t).is_unsigned_integer


def is_floating(t) -> bool:
    return _t(t).is_floating


def is_temporal(t) -> bool:
    tt = _t(t)
    return tt.is_temporal or tt.is_interval


def is_interval(t) -> bool:
    return _t(t).is_interval


def is_nested(t) -> bool:
    return _t(t).is_nested


def is_primitive(t) -> bool:
    """A fixed-width primitive type, as pyarrow counts them: the numbers,
    bool, the temporals and the intervals."""
    tt = _t(t)
    return tt.kind in dt._PHYS or tt.is_temporal or tt.is_interval


def is_boolean_value(v) -> bool:
    import numpy as np
    return isinstance(v, (bool, np.bool_))


def is_integer_value(v) -> bool:
    import numpy as np
    return isinstance(v, (int, np.integer)) and not isinstance(
        v, (bool, np.bool_))


def is_float_value(v) -> bool:
    import numpy as np
    return isinstance(v, (float, np.floating))
