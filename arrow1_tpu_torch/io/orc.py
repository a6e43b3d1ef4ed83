"""ORC adapter (counterpart of arrow1_tpu/io/orc.py).

Reads and writes are native (io/orc_native.py and io/orc_writer.py: the
ORC v1 format itself; the reference wraps the Apache ORC C++ library,
cpp/src/arrow/adapters/orc/adapter.cc), across the type matrix with
unions (sparse on read, both layouts on write) and char/varchar (read as
string, as the adapter does). pyarrow.orc reads or writes only what the
native path declines before it reads or writes (``UnsupportedLayout``:
LZO, a type kind it does not know; on write, a type
without an ORC form here). A corrupt file raises ``Invalid``; a missing
path raises ``FileNotFoundError``. Readers take ``device=`` (CUDA unless
the caller names the CPU).
"""

from __future__ import annotations

import importlib.util
import io as _io
from typing import Optional, Sequence, Union

from ..device import resolve_device
from ..table import RecordBatch, Table
from .ipc_native import UnsupportedLayout

__all__ = ["read_orc", "write_orc", "orc_available"]


def orc_available() -> bool:
    """Whether pyarrow.orc, the fallback, is installed."""
    return importlib.util.find_spec("pyarrow") is not None and \
        importlib.util.find_spec("pyarrow.orc") is not None


def read_orc(path, columns: Optional[Sequence[str]] = None,
             device=None) -> Table:
    """An ORC file (a path, bytes or a file object) as a Table of one
    RecordBatch a stripe on ``device``."""
    from .csv import _as_bytes
    from .orc_native import read_orc_native

    dev = resolve_device(device)
    buf = _as_bytes(path)
    try:
        return read_orc_native(buf, columns=columns, device=dev)
    except UnsupportedLayout:
        import pyarrow.orc as orc

        from ..interop import record_batch_from_arrow

        tbl = orc.read_table(_io.BytesIO(buf),
                             columns=list(columns) if columns else None)
        return Table([record_batch_from_arrow(tbl, device=dev)])


def write_orc(data: Union[RecordBatch, Table], path):
    """Write a RecordBatch or Table to an ORC file (a path or a binary
    file object), one stripe a RecordBatch."""
    from .orc_writer import write_orc_native

    try:
        buf = write_orc_native(data)
    except UnsupportedLayout:
        import pyarrow as pa
        import pyarrow.orc as orc

        from ..interop import record_batch_to_arrow

        batches = data.batches if isinstance(data, Table) else [data]
        orc.write_table(pa.Table.from_batches(
            [record_batch_to_arrow(b) for b in batches]), path)
        return
    if hasattr(path, "write"):
        path.write(buf)
    else:
        with open(path, "wb") as f:
            f.write(buf)
