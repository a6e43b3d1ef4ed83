"""pyarrow.ipc-compatible module shape over the native wire format
(counterpart of arrow1_tpu/ipc.py).

Reference: python/pyarrow/ipc.py (new_file/open_file/new_stream/
open_stream + RecordBatch{File,Stream}{Reader,Writer}); the wire format
itself is implemented natively in io/ipc_native.py (ipc/message.h:238
framing), so ``import arrow1_tpu_torch.ipc as ipc`` ports 1:1. Readers
place the batches on ``device`` (CUDA unless the caller names the CPU).
"""

from __future__ import annotations

import io as _io
import os

import torch

from .io import ipc_native
from .table import RecordBatch, Table

__all__ = ["RecordBatchStreamWriter", "RecordBatchFileWriter",
           "RecordBatchStreamReader", "RecordBatchFileReader", "new_stream",
           "open_stream", "new_file", "open_file", "serialize_pandas",
           "deserialize_pandas"]


def _sink(where):
    return open(where, "wb") if isinstance(where, (str, os.PathLike)) \
        else where


def _source(where):
    if isinstance(where, (bytes, bytearray, memoryview)):
        return _io.BytesIO(bytes(where))
    return open(where, "rb") if isinstance(where, (str, os.PathLike)) \
        else where


class RecordBatchStreamWriter:
    """ipc/writer.h:82 RecordBatchStreamWriter over the native encoder.
    ``schema`` (a sequence of (name, type) pairs, or a pyarrow schema)
    gives a schema-only stream its schema when no batch is written."""

    _write = staticmethod(ipc_native.write_stream)

    def __init__(self, sink, schema=None, *, compression=None):
        self._raw = _sink(sink)
        self._own = sink is not self._raw
        self._compression = compression
        self._schema = schema
        self._batches = []

    def write_batch(self, batch: RecordBatch):
        self._batches.append(batch)

    def write_table(self, table: Table):
        self._batches.extend(table.batches)

    write = write_batch

    def close(self):
        if self._batches is not None:
            self._write(self._raw, self._batches,
                        compression=self._compression,
                        schema_batch=self._schema_batch())
            self._batches = None
        if self._own:
            self._raw.close()

    def _schema_batch(self):
        """Zero-row CPU batch carrying the declared schema, for
        schema-only (empty) streams/files."""
        if self._schema is None:
            return None
        from . import dtypes as dt
        from .io.ipc_native import _empty_host, _stage

        pairs = [(f.name, dt.from_arrow(f.type)) if hasattr(f, "type")
                 else f for f in self._schema]
        return _stage(RecordBatch(tuple(_empty_host(t) for _, t in pairs),
                                  tuple(n for n, _ in pairs)),
                      torch.device("cpu"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class RecordBatchFileWriter(RecordBatchStreamWriter):
    """ipc/writer.h RecordBatchFileWriter (file format = stream +
    footer, ipc/writer.cc:216)."""

    _write = staticmethod(ipc_native.write_file)


class _ReaderBase:
    def __init__(self, batches):
        self._batches = batches

    @property
    def schema(self):
        """(name, type) of each column."""
        if not self._batches:
            return None
        b = self._batches[0]
        return tuple((n, c.dtype) for n, c in zip(b.names, b.columns))

    def read_all(self) -> Table:
        return Table(list(self._batches))

    def read_pandas(self, **kwargs):
        return self.read_all().to_arrow().to_pandas(**kwargs)

    def __iter__(self):
        return iter(self._batches)


class RecordBatchStreamReader(_ReaderBase):
    """ipc/reader.h:67 RecordBatchStreamReader over the native decoder."""

    def __init__(self, source, device=None):
        src = _source(source)
        try:
            super().__init__(ipc_native.read_stream(src, device))
        finally:
            if src is not source:
                src.close()


class RecordBatchFileReader(_ReaderBase):
    """ipc/reader.h RecordBatchFileReader (random access by batch)."""

    def __init__(self, source, device=None):
        src = _source(source)
        try:
            super().__init__(ipc_native.read_file(src, device))
        finally:
            if src is not source:
                src.close()

    @property
    def num_record_batches(self) -> int:
        return len(self._batches)

    def get_batch(self, i: int) -> RecordBatch:
        return self._batches[i]

    get_record_batch = get_batch


def new_stream(sink, schema=None, **kw) -> RecordBatchStreamWriter:
    return RecordBatchStreamWriter(sink, schema, **kw)


def open_stream(source, device=None) -> RecordBatchStreamReader:
    return RecordBatchStreamReader(source, device)


def new_file(sink, schema=None, **kw) -> RecordBatchFileWriter:
    return RecordBatchFileWriter(sink, schema, **kw)


def open_file(source, device=None) -> RecordBatchFileReader:
    return RecordBatchFileReader(source, device)


def serialize_pandas(df, *, nthreads=None, preserve_index=None) -> bytes:
    """DataFrame -> IPC stream bytes (pyarrow.serialize_pandas shape;
    pyarrow, and through it pandas, are imported here only)."""
    import pyarrow as pa

    from .interop import record_batch_from_arrow

    pa_batch = pa.RecordBatch.from_pandas(df,
                                          preserve_index=preserve_index)
    buf = _io.BytesIO()
    ipc_native.write_stream(buf, [record_batch_from_arrow(pa_batch,
                                                          device="cpu")])
    return buf.getvalue()


def deserialize_pandas(buf, *, use_threads=True):
    """IPC stream bytes -> DataFrame."""
    batches = ipc_native.read_stream(_io.BytesIO(bytes(buf)), device="cpu")
    return Table(batches).to_arrow().to_pandas()
