"""pyarrow.feather-compatible module shape (counterpart of
arrow1_tpu/feather.py).

Reference: python/pyarrow/feather.py + ipc/feather.h: the reference reads
BOTH Feather versions. V2 IS the Arrow IPC file format, so it rides the
native IPC reader/writer; V1 (the legacy flatbuffer layout) has its own
reader (io/feather1.py, ReaderV1 parity). Tables land on ``device`` (CUDA
unless the caller names the CPU).
"""

from __future__ import annotations

import io as _io

from .io.ipc import read_feather as _read_table, write_feather
from .table import Table

__all__ = ["read_table", "read_feather", "write_table", "write_feather"]


def read_table(source, columns=None, device=None) -> Table:
    """Feather file (V1 or V2; a path, bytes or a file object) -> Table."""
    from .io.feather1 import is_feather_v1, read_feather_v1

    buf = None
    if hasattr(source, "read"):
        buf = source.read()
    elif isinstance(source, (bytes, bytearray)):
        buf = bytes(source)
    else:
        with open(source, "rb") as f:
            head = f.read(4)
        if head == b"FEA1":
            with open(source, "rb") as f:
                buf = f.read()
    if buf is not None and is_feather_v1(buf):
        return Table([read_feather_v1(
            buf, list(columns) if columns else None, device=device)])
    if buf is not None:
        source = _io.BytesIO(buf)
    t = _read_table(source, device=device)
    if columns:
        t = Table([b.select(list(columns)) for b in t.batches])
    return t


def read_feather(source, columns=None):
    """Feather file -> pandas DataFrame (pyarrow.feather shape; pyarrow
    and pandas are imported for the conversion only)."""
    return read_table(source, columns, device="cpu").to_arrow().to_pandas()


def write_table(table, dest, **kwargs):
    return write_feather(table, dest, **kwargs)
