"""IO streams: memory-mapped files, buffered streams, in-memory IO,
read-coalescing cache (counterpart of arrow1_tpu/io/streams.py).

Reference: cpp/src/arrow/io/ — file.h:146 MemoryMappedFile,
buffered.h BufferedInputStream/BufferedOutputStream, memory.h:145
BufferReader/BufferOutputStream, caching.h ReadRangeCache (coalesces
small nearby reads into large fetches — the S3/parquet footer pattern).
"""

from __future__ import annotations

import io
import mmap
import os
from typing import List, Optional, Tuple

from ..errors import Invalid

__all__ = ["MemoryMappedFile", "BufferedInputStream",
           "BufferedOutputStream", "BufferReader", "BufferOutputStream",
           "ReadRangeCache", "Buffer", "py_buffer", "allocate_buffer",
           "foreign_buffer", "input_stream", "output_stream", "OSFile",
           "memory_map", "create_memory_map"]


class Buffer:
    """Contiguous host memory region (reference: buffer.h:52 Buffer).

    Wraps a memoryview; zero-copy slicing, pyarrow-shaped accessors.
    Device buffers live in torch tensors: this is the HOST half of the
    buffer API (ingest/IPC/IO staging)."""

    __slots__ = ("_mv",)

    def __init__(self, data):
        self._mv = data if isinstance(data, memoryview) else \
            memoryview(data)

    @property
    def size(self) -> int:
        return self._mv.nbytes

    @property
    def is_mutable(self) -> bool:
        return not self._mv.readonly

    @property
    def address(self) -> int:
        import numpy as _np

        return _np.frombuffer(self._mv, dtype=_np.uint8).ctypes.data \
            if self._mv.nbytes else 0

    def to_pybytes(self) -> bytes:
        return bytes(self._mv)

    def slice(self, offset: int = 0, length: Optional[int] = None
              ) -> "Buffer":
        end = self._mv.nbytes if length is None else offset + length
        return Buffer(self._mv[offset:end])

    def equals(self, other) -> bool:
        return bytes(self._mv) == bytes(other._mv if isinstance(
            other, Buffer) else other)

    def __len__(self) -> int:
        return self._mv.nbytes

    def __buffer__(self, flags):
        return self._mv.__buffer__(flags)

    def __eq__(self, other):
        return isinstance(other, (Buffer, bytes, bytearray, memoryview)) \
            and self.equals(other)

    def __repr__(self):
        return f"Buffer[{self.size}]"


def py_buffer(obj) -> Buffer:
    """Zero-copy Buffer over any python buffer-protocol object
    (reference: pyarrow.py_buffer)."""
    return Buffer(obj)


def allocate_buffer(size: int, resizable: bool = False) -> Buffer:
    """Mutable zeroed host buffer (reference: AllocateBuffer buffer.h)."""
    return Buffer(memoryview(bytearray(size)))


def foreign_buffer(address: int, size: int, base=None) -> Buffer:
    """Buffer over memory owned elsewhere (reference:
    pyarrow.foreign_buffer); `base` is kept alive via the closure."""
    import ctypes

    raw = (ctypes.c_char * size).from_address(address)
    raw._keepalive = base
    return Buffer(memoryview(raw))


class OSFile(io.FileIO):
    """Plain OS file handle (reference: io/file.h ReadableFile/
    FileOutputStream)."""

    def __init__(self, path, mode: str = "r"):
        super().__init__(path, {"r": "rb", "rb": "rb", "w": "wb",
                                "wb": "wb", "ab": "ab"}.get(mode, mode))


def input_stream(source, compression: Optional[str] = None):
    """pyarrow.input_stream: path/bytes/file-like -> readable stream;
    compression wraps in the codec's decompressing reader."""
    if isinstance(source, (bytes, bytearray, memoryview)):
        raw = BufferReader(source)
    elif isinstance(source, Buffer):
        raw = BufferReader(source.to_pybytes())
    elif isinstance(source, (str, os.PathLike)):
        raw = open(source, "rb")
    else:
        raw = source
    if compression and compression != "none":
        from .compression import CompressedInputStream

        return CompressedInputStream(raw, compression)
    return raw


def output_stream(sink, compression: Optional[str] = None):
    """pyarrow.output_stream: path/file-like -> writable stream."""
    raw = open(sink, "wb") if isinstance(sink, (str, os.PathLike)) else sink
    if compression and compression != "none":
        from .compression import CompressedOutputStream

        return CompressedOutputStream(raw, compression)
    return raw


def memory_map(path: str, mode: str = "r") -> "MemoryMappedFile":
    return MemoryMappedFile(path, "r" if mode in ("r", "rb") else "r+")


def create_memory_map(path: str, size: int) -> "MemoryMappedFile":
    return MemoryMappedFile.create(path, size)


class MemoryMappedFile:
    """Zero-copy reads out of an OS memory mapping (io/file.h:146)."""

    def __init__(self, path: str, mode: str = "r"):
        if mode not in ("r", "r+"):
            raise Invalid(f"MemoryMappedFile mode must be r or r+, "
                          f"got {mode!r}")
        self._f = open(path, "rb" if mode == "r" else "r+b")
        prot = mmap.ACCESS_READ if mode == "r" else mmap.ACCESS_WRITE
        self._mm = mmap.mmap(self._f.fileno(), 0, access=prot)
        self._pos = 0

    @classmethod
    def create(cls, path: str, size: int) -> "MemoryMappedFile":
        with open(path, "wb") as f:
            f.truncate(size)
        return cls(path, "r+")

    def size(self) -> int:
        return len(self._mm)

    def tell(self) -> int:
        return self._pos

    def seek(self, pos: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            self._pos = pos
        elif whence == io.SEEK_CUR:
            self._pos += pos
        else:
            self._pos = len(self._mm) + pos
        return self._pos

    def read(self, n: int = -1) -> bytes:
        end = len(self._mm) if n is None or n < 0 else \
            min(self._pos + n, len(self._mm))
        out = self._mm[self._pos:end]
        self._pos = end
        return out

    def read_at(self, offset: int, n: int) -> memoryview:
        """Zero-copy positional read."""
        return memoryview(self._mm)[offset:offset + n]

    def write(self, data: bytes) -> int:
        self._mm[self._pos:self._pos + len(data)] = data
        self._pos += len(data)
        return len(data)

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class BufferedInputStream(io.BufferedReader):
    """io/buffered.h BufferedInputStream over any raw readable."""

    def __init__(self, raw, buffer_size: int = 1 << 16):
        if isinstance(raw, (str, os.PathLike)):
            raw = open(raw, "rb")
        super().__init__(raw, buffer_size=buffer_size)


class BufferedOutputStream(io.BufferedWriter):
    """io/buffered.h BufferedOutputStream over any raw writable."""

    def __init__(self, raw, buffer_size: int = 1 << 16):
        if isinstance(raw, (str, os.PathLike)):
            raw = open(raw, "wb")
        super().__init__(raw, buffer_size=buffer_size)


class BufferReader(io.BytesIO):
    """io/memory.h:145 BufferReader: read-only view of host bytes."""

    def __init__(self, data):
        super().__init__(bytes(data))

    def write(self, *a):
        raise Invalid("BufferReader is read-only")


class BufferOutputStream(io.BytesIO):
    """io/memory.h BufferOutputStream; .getvalue() finishes."""


class ReadRangeCache:
    """Coalescing range cache (io/caching.h ReadRangeCache): declare the
    ranges you will need, nearby ones merge into single large reads —
    parquet/S3 footer+column-chunk access pattern."""

    def __init__(self, file, hole_size_limit: int = 8192,
                 range_size_limit: int = 32 << 20):
        self._file = file
        self._hole = hole_size_limit
        self._limit = range_size_limit
        self._blocks: List[Tuple[int, bytes]] = []

    def cache(self, ranges: List[Tuple[int, int]]) -> None:
        """ranges: [(offset, length)] — fetched coalesced, now."""
        todo = sorted((off, ln) for off, ln in ranges if ln > 0)
        merged: List[Tuple[int, int]] = []
        for off, ln in todo:
            if merged:
                moff, mln = merged[-1]
                if off <= moff + mln + self._hole and \
                        (off + ln) - moff <= self._limit:
                    merged[-1] = (moff, max(mln, off + ln - moff))
                    continue
            merged.append((off, ln))
        for off, ln in merged:
            self._file.seek(off)
            self._blocks.append((off, self._file.read(ln)))
        self._blocks.sort()

    def read(self, offset: int, length: int) -> bytes:
        """Serve a declared range from cache (reads through on miss)."""
        for off, data in self._blocks:
            if off <= offset and offset + length <= off + len(data):
                lo = offset - off
                return data[lo:lo + length]
        self._file.seek(offset)
        return self._file.read(length)

    @property
    def num_fetches(self) -> int:
        return len(self._blocks)
