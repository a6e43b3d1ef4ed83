"""The C data interface's entry points (counterpart of
arrow1_tpu/cdata.py).

Reference: cpp/src/arrow/c/abi.h:30,46 and c/bridge.{h,cc}. ``cabi``
lays out the structs and walks them for the flat types; nested and
dictionary-encoded arrays go through pyarrow's bridge, which only the
functions here import, and only for those arrays. Imports put their
columns on ``device`` (CUDA unless the caller names the CPU).
"""

from __future__ import annotations

from .column import Column
from .errors import Invalid
from .table import RecordBatch, Table

__all__ = ["export_column", "import_column", "export_batch", "import_batch"]


def _walked(col) -> bool:
    """Whether ``cabi`` lays out ``col`` itself (a flat column of a type
    with a C format string)."""
    from .cabi import _format_for

    if not isinstance(col, Column):
        return False
    try:
        _format_for(col.dtype)
    except Invalid:
        return False
    return True


def export_column(col, name: str = ""):
    """A column as an ``__arrow_c_array__`` provider: the port's own
    structs for a flat type, a pyarrow array for a nested one."""
    from .cabi import CArrayExportable

    return CArrayExportable(col, name) if _walked(col) else col.to_arrow()


def import_column(obj, device=None) -> Column:
    """Any ``__arrow_c_array__`` provider -> a column on ``device``."""
    if not hasattr(obj, "__arrow_c_array__"):
        raise TypeError(f"{type(obj)} does not implement __arrow_c_array__")
    from .cabi import import_array_capsules

    sc, ac = obj.__arrow_c_array__()
    try:
        return import_array_capsules(sc, ac, device=device)
    except Invalid:
        import pyarrow as pa

        from .interop import column_from_arrow

        return column_from_arrow(pa.array(obj), device=device)


def export_batch(batch: RecordBatch):
    """A RecordBatch as an ``__arrow_c_stream__`` provider of one batch
    (the port's own structs where every column is flat)."""
    from .cabi import CStreamExportable

    if all(_walked(c) for c in batch.columns):
        return CStreamExportable([batch])
    return batch.to_arrow()


def import_batch(obj, device=None) -> RecordBatch:
    """Any ``__arrow_c_stream__`` or ``__arrow_c_array__`` provider -> one
    RecordBatch on ``device``."""
    from .interop import record_batch_from_arrow

    if hasattr(obj, "__arrow_c_stream__"):
        from .cabi import import_stream_capsule

        try:
            batches = import_stream_capsule(obj.__arrow_c_stream__(),
                                            device=device)
        except Invalid:
            batches = None   # a type cabi does not walk: pyarrow reads it
        if batches:
            return batches[0] if len(batches) == 1 else \
                Table(batches).combine_chunks()
        import pyarrow as pa

        reader = pa.RecordBatchReader.from_stream(obj)
        return record_batch_from_arrow(reader.read_all(), device=device)
    if hasattr(obj, "__arrow_c_array__"):
        import pyarrow as pa

        return record_batch_from_arrow(pa.record_batch(obj), device=device)
    raise TypeError(f"{type(obj)} does not implement the arrow capsule "
                    "protocol")
