"""Arrow IPC stream/file + Feather read/write (counterpart of
arrow1_tpu/io/ipc.py).

Reference: cpp/src/arrow/ipc/ (encapsulated message format, stream/file
readers+writers, ipc/reader.h:67,102, writer.h:82-150) and ipc/feather.h.
The wire format is produced and consumed NATIVELY by io/ipc_native.py
(no pyarrow, no flatbuffers package): fixed-width, temporal, decimal,
string, dictionary and nested columns, uncompressed, LZ4_FRAME or ZSTD.
pyarrow is imported only in its own fallbacks: reading a layout the
native reader raises ``UnsupportedLayout`` for, and writing interval
columns. Any other error of the native path propagates. Readers place
the batches on ``device`` (CUDA unless the caller names the CPU).

IPC files double as the engine's spill/persist format.
"""

from __future__ import annotations

import importlib.util
import io as _io
import os
from typing import Iterator, Optional, Union

from ..device import resolve_device
from ..table import RecordBatch, Table
from . import ipc_native
from .ipc_native import UnsupportedLayout

__all__ = ["read_ipc", "write_ipc", "read_feather", "write_feather",
           "IpcStreamReader", "IpcStreamWriter"]


def _native_supported(batch: RecordBatch) -> bool:
    return all(ipc_native.supported_type(c.dtype) for c in batch.columns)


def _pyarrow_batches(src, device):
    """pyarrow's reading of an IPC file (the fallback)."""
    import pyarrow as pa

    from ..interop import record_batch_from_arrow

    if isinstance(src, (str, os.PathLike)):
        src = pa.memory_map(str(src))
    elif isinstance(src, _io.BytesIO):
        src = src.getvalue()
    reader = pa.ipc.open_file(src)
    for i in range(reader.num_record_batches):
        yield record_batch_from_arrow(reader.get_batch(i), device)


def read_ipc(path, batched: bool = False, device=None):
    """Read an Arrow IPC file (a path, bytes or a file object) -> Table
    (or an iterator of batches, each decoded when it is asked for, if
    ``batched``) on ``device``. The native reader reads it unless it
    raises ``UnsupportedLayout``; then pyarrow does."""
    dev = resolve_device(device)
    it = ipc_native.iter_file(path, dev)
    try:
        first = next(it)
    except UnsupportedLayout:
        if importlib.util.find_spec("pyarrow") is None:
            raise   # no fallback here
        batches = _pyarrow_batches(path, dev)
    else:
        def rest():
            yield first
            yield from it

        batches = rest()
    return batches if batched else Table(list(batches))


def write_ipc(data: Union[RecordBatch, Table], path,
              compression: Optional[str] = None):
    """Write to an Arrow IPC file (optionally lz4 or zstd: the reference's
    IpcWriteOptions codec, ipc/options.h:41). The native writer writes
    every type but the intervals, which go through pyarrow."""
    batches = data.batches if isinstance(data, Table) else [data]
    if all(_native_supported(b) for b in batches):
        with open(path, "wb") as f:
            ipc_native.write_file(f, batches, compression=compression)
        return
    import pyarrow as pa

    from ..interop import record_batch_to_arrow

    pa_batches = [record_batch_to_arrow(b) for b in batches]
    options = pa.ipc.IpcWriteOptions(compression=compression)
    with pa.OSFile(str(path), "wb") as f:
        with pa.ipc.new_file(f, pa_batches[0].schema, options=options) as w:
            for b in pa_batches:
                w.write_batch(b)


class IpcStreamReader:
    """Streaming-format reader yielding the batches on ``device``
    (reference: ipc/reader.h:67 RecordBatchStreamReader)."""

    def __init__(self, source, device=None):
        self._batches = ipc_native.read_stream(source, device)

    @property
    def schema(self):
        """(name, type) of each column."""
        b = self._batches[0]
        return tuple((n, c.dtype) for n, c in zip(b.names, b.columns))

    def __iter__(self) -> Iterator[RecordBatch]:
        return iter(self._batches)


class IpcStreamWriter:
    """Streaming-format writer (reference: ipc/writer.h:82): each batch
    is written as it comes, the schema message before the first."""

    def __init__(self, sink, compression: Optional[str] = None):
        self._sink = sink
        self._compression = compression
        self._pools = None   # set by the first batch

    def write_batch(self, batch: RecordBatch):
        if self._pools is None:
            self._pools = ipc_native.write_stream_start(self._sink, batch)
        ipc_native.write_stream_batch(self._sink, batch, self._compression,
                                      self._pools)

    def close(self):
        if self._pools is not None:
            ipc_native.write_stream_end(self._sink)
            self._pools = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_feather(path, device=None) -> Table:
    """Feather V2 == the IPC file format (reference: ipc/feather.h; V1 is
    the legacy pre-IPC framing, read by io/feather1.py)."""
    return read_ipc(path, device=device)


def write_feather(data: Union[RecordBatch, Table], path,
                  compression: Optional[str] = "lz4", version: int = 2):
    """version=2 (default) is the Arrow IPC file format; version=1
    writes the legacy Feather V1 flatbuffer layout
    (io/feather1.write_feather_v1, reference ipc/feather.h:105)."""
    if version == 1:
        from .feather1 import write_feather_v1

        batch = (data.combine_chunks()
                 if isinstance(data, Table) else data)
        with open(path, "wb") as f:
            write_feather_v1(batch, f)
        return
    write_ipc(data, path, compression=compression)
