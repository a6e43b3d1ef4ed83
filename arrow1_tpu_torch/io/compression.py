"""Compression codecs + compressed stream wrappers (counterpart of
arrow1_tpu/io/compression.py).

Reference: cpp/src/arrow/util/compression*.{h,cc} (zlib/lz4/zstd/snappy/
brotli/bz2 codec registry) and io/compressed.h (stream wrappers). LZ4
(the frame format) rides the native codec (native/src/lz4.cpp) and ZSTD
the ``zstandard`` module; each raises ``Invalid`` naming what is missing
where it cannot run. The other codecs and the stream wrappers delegate to
pyarrow's (the same C++ libraries the reference links), imported only
for them.
"""

from __future__ import annotations

import struct
from typing import List, Optional

from ..errors import Invalid

__all__ = ["Codec", "compress", "decompress", "supported_codecs",
           "CompressedOutputStream", "CompressedInputStream"]


def _zstandard():
    try:
        import zstandard
    except ImportError:
        raise Invalid("codec 'zstd' needs the zstandard module, which is "
                      "not installed") from None
    return zstandard


def supported_codecs() -> List[str]:
    from ..native import native_available

    out = []
    if native_available():
        out.append("lz4")
    try:
        _zstandard()
        out.append("zstd")
    except Invalid:
        pass
    try:
        import pyarrow as pa
    except ImportError:
        return out
    for name in ("gzip", "snappy", "brotli", "bz2"):
        if pa.Codec.is_available(name):
            out.append(name)
    return out


class Codec:
    """Reference: util/compression.h Codec::Create."""

    def __init__(self, name: str, compression_level: Optional[int] = None):
        self.name = name
        self.compression_level = compression_level
        if name == "lz4":
            from ..native import native_available

            if not native_available():
                raise Invalid("codec 'lz4' needs the native library (no "
                              "C++ compiler, or its build failed)")
        elif name == "zstd":
            _zstandard()
        else:
            try:
                import pyarrow as pa
            except ImportError:
                raise Invalid(f"codec {name!r} needs pyarrow, which is not "
                              "installed") from None
            if not pa.Codec.is_available(name):
                raise Invalid(f"codec {name!r} not available")
            self._codec = pa.Codec(name,
                                   compression_level=compression_level)

    def compress(self, data) -> bytes:
        if self.name == "lz4":
            from ..native import lz4_frame_compress

            return lz4_frame_compress(bytes(data))
        if self.name == "zstd":
            level = self.compression_level
            return _zstandard().ZstdCompressor(
                **({} if level is None else {"level": level})).compress(
                    bytes(data))
        return self._codec.compress(data, asbytes=True)

    def decompress(self, data,
                   decompressed_size: Optional[int] = None) -> bytes:
        if self.name == "lz4":
            from ..native import lz4_frame_decompress

            data = bytes(data)
            if decompressed_size is None:
                # the frame carries its content size when this codec wrote
                # it; otherwise grow and retry
                if len(data) > 13 and data[4] & 0x08:
                    (decompressed_size,) = struct.unpack_from("<Q", data, 6)
                else:
                    cap = max(4 * len(data), 1 << 16)
                    while True:
                        try:
                            return lz4_frame_decompress(data, cap)
                        except RuntimeError:
                            if cap > (1 << 31):
                                raise
                            cap *= 4
            return lz4_frame_decompress(data, int(decompressed_size))
        if self.name == "zstd":
            d = _zstandard().ZstdDecompressor()
            if decompressed_size is None:
                return d.decompressobj().decompress(bytes(data))
            return d.decompress(bytes(data),
                                max_output_size=int(decompressed_size))
        return self._codec.decompress(
            data, decompressed_size=decompressed_size, asbytes=True)


def compress(data: bytes, codec: str = "zstd") -> bytes:
    return Codec(codec).compress(data)


def decompress(data: bytes, codec: str = "zstd",
               decompressed_size: Optional[int] = None) -> bytes:
    return Codec(codec).decompress(data, decompressed_size)


def CompressedOutputStream(sink, codec: str = "zstd"):
    """Reference: io/compressed.h CompressedOutputStream (pyarrow's)."""
    import pyarrow as pa

    return pa.CompressedOutputStream(sink, codec)


def CompressedInputStream(source, codec: str = "zstd"):
    """Reference: io/compressed.h CompressedInputStream (pyarrow's)."""
    import pyarrow as pa

    return pa.CompressedInputStream(source, codec)
