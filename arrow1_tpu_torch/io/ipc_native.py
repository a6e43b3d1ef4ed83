"""Native Arrow IPC wire format, with no pyarrow and no flatbuffers package
(counterpart of arrow1_tpu/io/ipc_native.py).

Implements the encapsulated-message format from scratch (the tables are
built with the port's own small builder, ``io/_flatbuf.py``, and read with
a hand-built vtable reader):

  message   = 0xFFFFFFFF continuation + int32 metadata_len
              + Message flatbuffer (padded to 8) + aligned body
              (reference: cpp/src/arrow/ipc/message.h:238-260)
  stream    = Schema msg, DictionaryBatch msgs, RecordBatch msgs, EOS
  file      = "ARROW1\\0\\0" + stream + Footer flatbuffer
              + int32 footer_len + "ARROW1"
              (reference: cpp/src/arrow/ipc/writer.cc:128,216 /
               reader.cc:138,525 ArrayLoader)

The writer flattens the port's columns into the columnar buffer layout
(validity bitmaps LSB-packed, bools bit-packed, 8-byte buffer alignment):
strings as plain var-binary from their dictionary form, a decimal's
int64 limbs as its 16- or 32-byte little-endian words, the nested
columns in pre-order. The reader takes zero-copy numpy views of the body,
validates every length against its buffer (a corrupt or hostile file
raises ``Invalid``), and builds the port's layouts on the target device
(CUDA unless the caller names the CPU): strings become a ``Dictionary``
pool plus int32 codes through the native ``MemoTable`` (first-appearance
order), decimals their int64 limbs, uint64 its own storage (the bits
unchanged), nested data ListColumn, StructColumn and UnionColumn.
Bitmaps and bools are unpacked on the host. Every buffer of a batch that
goes to the device is copied once from its view into one staging buffer
(pinned host memory when the target is CUDA, then one host-to-device
copy; for the CPU that host copy is the batch's storage), and the
batch's tensors are views of the copy.

Compressed bodies (Message.fbs BodyCompression) follow the spec's buffer
framing: each buffer is an int64 uncompressed-length prefix (-1 = stored
raw) + codec frame. LZ4_FRAME rides the native codec
(native/src/lz4.cpp), ZSTD the ``zstandard`` module where it is
installed. A layout this reader does not take (an interval or null
column, a non-string dictionary, an unknown codec) raises
``UnsupportedLayout``, the one error ``io.ipc`` answers with pyarrow.
Schema metadata is neither written nor read: the port's batches carry
none.
"""

from __future__ import annotations

import io as _io
import mmap
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..column import (Column, Dictionary, ListColumn, StructColumn,
                      UnionColumn)
from ..device import resolve_device
from ..errors import Invalid
from ..table import RecordBatch, map_tensors
from ._flatbuf import Builder

__all__ = ["write_stream", "write_stream_start", "write_stream_batch",
           "write_stream_end", "read_stream", "write_file", "read_file",
           "iter_file", "serialize_batch", "deserialize_batch",
           "supported_type", "UnsupportedLayout"]


class UnsupportedLayout(Invalid):
    """A well-formed IPC layout that the native reader or writer does not
    take (pyarrow does)."""


COMP_LZ4, COMP_ZSTD = 0, 1
# the most one compressed byte can expand to: LZ4 255 (a match length's
# extension bytes), ZSTD's RLE blocks 2^15; a larger claimed length is
# corrupt input, refused before anything is allocated for it
_MAX_RATIO = {COMP_LZ4: 255, COMP_ZSTD: 1 << 15}


def _codec(comp_id: int):
    if comp_id == COMP_ZSTD:
        try:
            import zstandard
        except ImportError:
            raise Invalid("ipc_native: the ZSTD codec needs the zstandard "
                          "module, which is not installed") from None
        return (lambda b: zstandard.ZstdCompressor().compress(bytes(b)),
                lambda b, n: zstandard.ZstdDecompressor().decompress(
                    bytes(b), max_output_size=n))
    if comp_id == COMP_LZ4:
        from ..native import (lz4_frame_compress, lz4_frame_decompress,
                              native_available)

        if not native_available():
            raise Invalid("ipc_native: the LZ4_FRAME codec needs the native "
                          "library (no C++ compiler, or its build failed)")
        return lz4_frame_compress, lz4_frame_decompress
    raise UnsupportedLayout(f"ipc_native: unknown compression codec "
                            f"{comp_id}")


CONTINUATION = 0xFFFFFFFF
MAGIC = b"ARROW1"
ALIGN = 8

# ---- flatbuffer union/member indices (from format/*.fbs declarations) ----
TYPE_NULL, TYPE_INT, TYPE_FP, TYPE_BINARY, TYPE_UTF8, TYPE_BOOL, \
    TYPE_DECIMAL, TYPE_DATE, TYPE_TIME, TYPE_TIMESTAMP, TYPE_INTERVAL, \
    TYPE_LIST, TYPE_STRUCT, TYPE_UNION, TYPE_FSB, TYPE_FSL, TYPE_MAP, \
    TYPE_DURATION, TYPE_LARGEBIN, TYPE_LARGEUTF8, TYPE_LARGELIST = \
    range(1, 22)

HDR_SCHEMA, HDR_DICTBATCH, HDR_RECORDBATCH = 1, 2, 3
TIME_UNITS = ["s", "ms", "us", "ns"]
V5 = 4  # MetadataVersion.V5


# ====================================================================
# minimal flatbuffer table reader (vtable navigation, no generated code)
# ====================================================================

class _T:
    """A positioned flatbuffer table. Slot s = vtable entry 4 + 2*s."""

    def __init__(self, buf, pos: int):
        self.buf = buf
        self.pos = pos

    def _field(self, slot: int) -> int:
        """Byte offset of field (0 if absent)."""
        vtab = self.pos - self._i32(self.pos)
        vsize = self._u16(vtab)
        fo = 4 + 2 * slot
        if fo >= vsize:
            return 0
        off = self._u16(vtab + fo)
        return self.pos + off if off else 0

    def _i32(self, p):
        return struct.unpack_from("<i", self.buf, p)[0]

    def _u16(self, p):
        return struct.unpack_from("<H", self.buf, p)[0]

    def _scalar(self, fmt, slot, default):
        p = self._field(slot)
        return struct.unpack_from(fmt, self.buf, p)[0] if p else default

    def i8(self, slot, default=0):
        return self._scalar("<b", slot, default)

    def u8(self, slot, default=0):
        return self._scalar("<B", slot, default)

    def i16(self, slot, default=0):
        return self._scalar("<h", slot, default)

    def i32(self, slot, default=0):
        return self._scalar("<i", slot, default)

    def i64(self, slot, default=0):
        return self._scalar("<q", slot, default)

    def bool_(self, slot, default=False):
        return bool(self._scalar("<B", slot, default))

    def string(self, slot) -> Optional[str]:
        p = self._field(slot)
        if not p:
            return None
        p += self._i32(p)
        n = self._i32(p)
        if n < 0 or p + 4 + n > len(self.buf):
            raise Invalid("ipc_native: string past the end of its buffer")
        return bytes(self.buf[p + 4: p + 4 + n]).decode("utf8")

    def table(self, slot) -> Optional["_T"]:
        p = self._field(slot)
        if not p:
            return None
        return _T(self.buf, p + self._i32(p))

    def vector(self, slot) -> Tuple[int, int]:
        """(element-0 position, length); (0, 0) if absent."""
        p = self._field(slot)
        if not p:
            return 0, 0
        p += self._i32(p)
        n = self._i32(p)
        if n < 0 or p + 4 + n > len(self.buf):
            raise Invalid("ipc_native: vector past the end of its buffer")
        return p + 4, n

    def vtable_at(self, pos) -> "_T":
        return _T(self.buf, pos + self._i32(pos))


def _root(buf) -> _T:
    return _T(buf, struct.unpack_from("<i", buf, 0)[0])


# ====================================================================
# schema: port types <-> flatbuffer
# ====================================================================

def _build_type(b: Builder, t: dt.DataType) -> Tuple[int, int]:
    """Returns (union_type_index, table_offset)."""
    k = t.kind
    if k == "null":
        b.StartObject(0)
        return TYPE_NULL, b.EndObject()
    if t.is_integer:
        width = np.dtype(t.numpy_dtype()).itemsize * 8
        b.StartObject(2)
        b.PrependInt32Slot(0, width, 0)
        b.PrependBoolSlot(1, t.is_signed_integer, False)
        return TYPE_INT, b.EndObject()
    if k in ("float16", "float32", "float64"):
        prec = {"float16": 0, "float32": 1, "float64": 2}[k]
        b.StartObject(1)
        b.PrependInt16Slot(0, prec, 0)
        return TYPE_FP, b.EndObject()
    if k == "bool":
        b.StartObject(0)
        return TYPE_BOOL, b.EndObject()
    if k in ("string", "large_string", "binary", "large_binary"):
        b.StartObject(0)
        idx = {"string": TYPE_UTF8, "large_string": TYPE_LARGEUTF8,
               "binary": TYPE_BINARY, "large_binary": TYPE_LARGEBIN}[k]
        return idx, b.EndObject()
    if k in ("decimal128", "decimal256"):
        b.StartObject(3)
        b.PrependInt32Slot(0, t.precision, 0)
        b.PrependInt32Slot(1, t.scale, 0)
        b.PrependInt32Slot(2, 128 if k == "decimal128" else 256, 128)
        return TYPE_DECIMAL, b.EndObject()
    if k in ("date32", "date64"):
        b.StartObject(1)
        b.PrependInt16Slot(0, 0 if k == "date32" else 1, 1)
        return TYPE_DATE, b.EndObject()
    if k in ("time32", "time64"):
        b.StartObject(2)
        b.PrependInt16Slot(0, TIME_UNITS.index(t.unit), 1)
        b.PrependInt32Slot(1, 32 if k == "time32" else 64, 32)
        return TYPE_TIME, b.EndObject()
    if k == "timestamp":
        tz_off = b.CreateString(t.tz) if t.tz else None
        b.StartObject(2)
        b.PrependInt16Slot(0, TIME_UNITS.index(t.unit), 0)
        if tz_off is not None:
            b.PrependUOffsetTRelativeSlot(1, tz_off, 0)
        return TYPE_TIMESTAMP, b.EndObject()
    if k == "duration":
        b.StartObject(1)
        b.PrependInt16Slot(0, TIME_UNITS.index(t.unit), 1)
        return TYPE_DURATION, b.EndObject()
    if k in ("list", "large_list"):
        b.StartObject(0)
        return (TYPE_LIST if k == "list" else TYPE_LARGELIST), b.EndObject()
    if k == "fixed_size_list":
        b.StartObject(1)
        b.PrependInt32Slot(0, t.list_size, 0)
        return TYPE_FSL, b.EndObject()
    if k == "struct":
        b.StartObject(0)
        return TYPE_STRUCT, b.EndObject()
    if k == "map":
        b.StartObject(1)
        b.PrependBoolSlot(0, False, False)  # keysSorted
        return TYPE_MAP, b.EndObject()
    if k in ("sparse_union", "dense_union"):
        codes = list(t.type_codes)
        b.StartVector(4, len(codes), 4)
        for c in reversed(codes):
            b.PrependInt32(c)
        cvec = b.EndVector()
        b.StartObject(2)
        b.PrependInt16Slot(0, 0 if k == "sparse_union" else 1, 0)
        b.PrependUOffsetTRelativeSlot(1, cvec, 0)
        return TYPE_UNION, b.EndObject()
    raise UnsupportedLayout(f"ipc_native: unsupported type {t}")


def supported_type(t: dt.DataType) -> bool:
    """Whether the native writer takes columns of type ``t``."""
    if t.is_interval:
        return False
    if t.is_nested:
        return all(supported_type(ct) for _, ct in t.fields)
    return True


def _child_fields(t: dt.DataType, in_map: bool = False):
    """Child (name, type, nullable, in_map) tuples in wire layout order.
    Map entries structs and their keys are non-nullable per the spec."""
    if t.kind == "map":
        return [("entries", dt.struct(t.fields), False, True)]
    if t.kind == "struct" and in_map:
        (kn, kt), (vn, vt) = t.fields
        return [("key", kt, False, False), ("value", vt, True, False)]
    if t.is_nested:
        return [(n, ct, True, False) for n, ct in t.fields]
    return []


def _build_field(b: Builder, name: str, t: dt.DataType, nullable: bool,
                 dict_id: Optional[int], in_map: bool = False) -> int:
    name_off = b.CreateString(name)
    kids = [_build_field(b, cn, ct, cnull, None, in_map=cmap)
            for cn, ct, cnull, cmap in _child_fields(t, in_map)]
    kids_off = None
    if kids:
        b.StartVector(4, len(kids), 4)
        for k in reversed(kids):
            b.PrependUOffsetTRelative(k)
        kids_off = b.EndVector()
    tidx, toff = _build_type(b, t)
    dict_off = None
    if dict_id is not None:
        # DictionaryEncoding: id(0), indexType(1), isOrdered(2), kind(3)
        it_off = _int_table(b, 32, True)  # built before StartObject
        b.StartObject(4)
        b.PrependUOffsetTRelativeSlot(1, it_off, 0)
        b.PrependInt64Slot(0, dict_id, 0)
        dict_off = b.EndObject()
    # Field: name(0) nullable(1) type_type(2) type(3) dictionary(4)
    #        children(5) custom_metadata(6)
    b.StartObject(7)
    b.PrependUOffsetTRelativeSlot(0, name_off, 0)
    b.PrependBoolSlot(1, nullable, False)
    b.PrependUint8Slot(2, tidx, 0)
    b.PrependUOffsetTRelativeSlot(3, toff, 0)
    if dict_off is not None:
        b.PrependUOffsetTRelativeSlot(4, dict_off, 0)
    if kids_off is not None:
        b.PrependUOffsetTRelativeSlot(5, kids_off, 0)
    return b.EndObject()


def _int_table(b: Builder, width: int, signed: bool) -> int:
    b.StartObject(2)
    b.PrependInt32Slot(0, width, 0)
    b.PrependBoolSlot(1, signed, False)
    return b.EndObject()


def _build_schema(b: Builder, batch: RecordBatch,
                  dict_ids: Dict[str, int]) -> int:
    fields = []
    for name, c in zip(batch.names, batch.columns):
        t = c.dtype
        if isinstance(c, Column) and t.is_dictionary:
            fields.append(_build_field(b, name, t.value_type, True,
                                       dict_ids[name]))
        else:
            fields.append(_build_field(b, name, t, True, None))
    b.StartVector(4, len(fields), 4)
    for f in reversed(fields):
        b.PrependUOffsetTRelative(f)
    fvec = b.EndVector()
    # Schema: endianness(0) fields(1) custom_metadata(2) features(3)
    b.StartObject(4)
    b.PrependInt16Slot(0, 0, 0)  # little-endian
    b.PrependUOffsetTRelativeSlot(1, fvec, 0)
    return b.EndObject()


def _finish_message(b: Builder, header_type: int, header_off: int,
                    body_len: int) -> bytes:
    # Message: version(0) header_type(1) header(2) bodyLength(3) meta(4)
    b.StartObject(5)
    b.PrependInt16Slot(0, V5, 0)
    b.PrependUint8Slot(1, header_type, 0)
    b.PrependUOffsetTRelativeSlot(2, header_off, 0)
    b.PrependInt64Slot(3, body_len, 0)
    b.Finish(b.EndObject())
    return b.Output()


def _pad(n: int, align: int = ALIGN) -> int:
    return (-n) % align


# ====================================================================
# column -> buffers (writer)
# ====================================================================

def _host(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy (or view, for a CPU tensor) of a tensor."""
    return t.detach().cpu().numpy()


def _validity_buffer(col) -> Tuple[Optional[bytes], int]:
    if col.validity is None:
        return None, 0
    mask = _host(col.validity)
    nulls = int((~mask).sum())
    if nulls == 0:
        return None, 0
    return np.packbits(mask, bitorder="little").tobytes(), nulls


def _as_u8(arr: np.ndarray) -> np.ndarray:
    """Zero-copy byte view of a contiguous array (len == nbytes)."""
    return np.ascontiguousarray(arr).reshape(-1).view(np.uint8)


def _string_buffers(col: Column) -> List:
    """A dictionary string column's plain var-binary (offsets, data): a
    native per-row gather out of the pool's bytes (native/src/ragged.cpp),
    or a numpy one where the library is unavailable."""
    t = col.dtype
    codes = _host(col.data).astype(np.int64)
    enc = [v.encode("utf8") if isinstance(v, str) else bytes(v)
           for v in col.dictionary.values]
    lens = np.array([len(e) for e in enc], dtype=np.int64)
    u_starts = np.zeros(len(enc) + 1, dtype=np.int64)
    np.cumsum(lens, out=u_starts[1:])
    valid = None if col.validity is None else _host(col.validity)
    row_lens = lens[codes] if len(enc) else np.zeros(len(codes), np.int64)
    if valid is not None:
        row_lens = np.where(valid, row_lens, 0)
    large = t.kind.startswith("large")
    offsets = np.zeros(col.length + 1,
                       dtype=np.int64 if large else np.int32)
    np.cumsum(row_lens, out=offsets[1:])
    total = int(offsets[-1])
    if not total:
        return [_as_u8(offsets), b""]
    pool = np.frombuffer(b"".join(enc), np.uint8)
    from ..native import ragged_gather

    got = ragged_gather(codes, u_starts, pool, valid, total, large=large)
    if got is not None:
        return [_as_u8(got[0]), got[1]]
    rows = np.repeat(np.arange(col.length), row_lens)
    within = np.arange(total, dtype=np.int64) - np.repeat(
        offsets[:-1].astype(np.int64), row_lens)
    return [_as_u8(offsets), pool[u_starts[codes][rows] + within]]


def _column_buffers(col: Column) -> Tuple[List, int, int]:
    """-> (buffers, length, null_count). Buffer 0 = validity ('' when
    all-valid), then the type's data buffers."""
    vbuf, nulls = _validity_buffer(col)
    bufs = [vbuf or b""]
    t = col.dtype
    if t.kind == "bool":
        bufs.append(np.packbits(_host(col.data),
                                bitorder="little").tobytes())
    elif t.is_decimal:   # the int64 limbs as little-endian words
        n = col.length
        words = np.empty((n, t.limbs), dtype="<i8")
        words[:, 0] = _host(col.data)
        words[:, 1:] = _host(col.data2).reshape(n, t.limbs - 1)
        bufs.append(_as_u8(words))
    elif t.is_binary:
        bufs.extend(_string_buffers(col))
    else:
        bufs.append(_as_u8(_host(col.data)))
    return bufs, col.length, nulls


def _flatten_array(col, nodes: List[Tuple[int, int]], bufs: List):
    """Pre-order (node, buffer) flattening of one array, nested included
    (reference writer: ipc/writer.cc:216 RecordBatchSerializer visits)."""
    if isinstance(col, ListColumn):
        k = col.dtype.kind
        vbuf, nulls = _validity_buffer(col)
        nodes.append((col.length, nulls))
        bufs.append(vbuf or b"")
        offs = _host(col.offsets)   # from 0, a null slot's range empty
        if k in ("list", "map"):
            bufs.append(offs.astype(np.int32).tobytes())
        elif k == "large_list":
            bufs.append(offs.astype(np.int64).tobytes())
        child = col.values
        if k == "map":
            # the port's maps hold entries as a {key, value} RecordBatch:
            # serialize as the wire's struct<key, value> entries array
            nodes.append((child.num_rows, 0))
            bufs.append(b"")
            for cc in child.columns:
                _flatten_array(cc, nodes, bufs)
            return
        _flatten_array(child, nodes, bufs)
        return
    if isinstance(col, StructColumn):
        vbuf, nulls = _validity_buffer(col)
        nodes.append((col.length, nulls))
        bufs.append(vbuf or b"")
        for c in col.children:
            _flatten_array(c, nodes, bufs)
        return
    if isinstance(col, UnionColumn):
        nodes.append((col.length, 0))  # unions carry no top validity
        bufs.append(_host(col.type_ids).astype(np.int8).tobytes())
        if col.is_dense:
            bufs.append(_host(col.offsets).astype(np.int32).tobytes())
        for c in col.children:
            _flatten_array(c, nodes, bufs)
        return
    if col.dtype.is_dictionary:
        raise UnsupportedLayout("ipc_native: a dictionary column nested "
                                "in another column")
    if col.dtype.is_null:   # a node and no buffer (Columnar.rst, Null)
        nodes.append((col.length, col.length))
        return
    cb, length, nulls = _column_buffers(col)
    nodes.append((length, nulls))
    bufs.extend(cb)


def _body_chunks(all_bufs: List, compression=None):
    """Aligned body as a CHUNK LIST (no concatenation: the writers stream
    chunks straight to the sink). Returns (chunks, Buffer structs,
    body_len). With compression, each buffer gets the spec's int64
    uncompressed-length prefix (-1 = stored raw when not smaller)."""
    chunks, descs = [], []
    off = 0
    comp = _codec(compression)[0] if compression is not None else None
    for buf in all_bufs:
        if isinstance(buf, np.ndarray):
            buf = memoryview(buf)
        if comp is not None and len(buf):
            c = comp(buf)
            if len(c) < len(buf):
                buf = struct.pack("<q", len(buf)) + c
            else:
                buf = struct.pack("<q", -1) + bytes(buf)
        n = len(buf)
        descs.append((off, n))
        if n:
            chunks.append(buf)
        pad = _pad(n)
        if pad:
            chunks.append(b"\0" * pad)
        off += n + pad
    return chunks, descs, off


def _build_recordbatch_header(b: Builder, length: int,
                              nodes: List[Tuple[int, int]],
                              buffers: List[Tuple[int, int]],
                              compression=None) -> int:
    comp_off = None
    if compression is not None:
        # BodyCompression: codec(0) int8, method(1) int8 (0 = BUFFER)
        b.StartObject(2)
        b.PrependInt8Slot(0, compression, 0)
        comp_off = b.EndObject()
    # struct vectors are built inline, in reverse
    b.StartVector(16, len(buffers), 8)
    for off, ln in reversed(buffers):
        b.PrependInt64(ln)
        b.PrependInt64(off)
    bvec = b.EndVector()
    b.StartVector(16, len(nodes), 8)
    for ln, nc in reversed(nodes):
        b.PrependInt64(nc)
        b.PrependInt64(ln)
    nvec = b.EndVector()
    # RecordBatch: length(0) nodes(1) buffers(2) compression(3)
    b.StartObject(4)
    b.PrependInt64Slot(0, length, 0)
    b.PrependUOffsetTRelativeSlot(1, nvec, 0)
    b.PrependUOffsetTRelativeSlot(2, bvec, 0)
    if comp_off is not None:
        b.PrependUOffsetTRelativeSlot(3, comp_off, 0)
    return b.EndObject()


def _comp_id(compression) -> Optional[int]:
    if compression is None:
        return None
    if compression not in ("zstd", "lz4"):
        raise Invalid(f"ipc_native: unknown compression {compression!r} "
                      "(lz4 or zstd)")
    return COMP_ZSTD if compression == "zstd" else COMP_LZ4


def serialize_batch_parts(batch: RecordBatch, compression=None):
    """-> (metadata flatbuffer, body chunk list, body_len) for one
    RecordBatch message; the writers stream chunks without a body
    concatenation."""
    cid = _comp_id(compression)
    nodes, all_bufs = [], []
    for c in batch.columns:
        if isinstance(c, Column) and c.dtype.is_dictionary:
            # indices only, as the schema's int32; the dictionary travels
            # as a DictionaryBatch
            vbuf, nulls = _validity_buffer(c)
            nodes.append((c.length, nulls))
            all_bufs.append(vbuf or b"")
            all_bufs.append(_as_u8(_host(c.data).astype(np.int32)))
        else:
            _flatten_array(c, nodes, all_bufs)
    chunks, descs, blen = _body_chunks(all_bufs, cid)
    b = Builder(1024)
    hdr = _build_recordbatch_header(b, batch.num_rows, nodes, descs, cid)
    meta = _finish_message(b, HDR_RECORDBATCH, hdr, blen)
    return meta, chunks, blen


def _join(chunks) -> bytes:
    return b"".join(bytes(c) if isinstance(c, memoryview) else c
                    for c in chunks)


def serialize_batch(batch: RecordBatch,
                    compression=None) -> Tuple[bytes, bytes]:
    """-> (metadata flatbuffer, body) for one RecordBatch message."""
    meta, chunks, _ = serialize_batch_parts(batch, compression)
    return meta, _join(chunks)


def _serialize_dictionary(dict_id: int, values: np.ndarray
                          ) -> Tuple[bytes, bytes]:
    """Dictionary payload as a one-column utf8 batch."""
    enc = [v.encode("utf8") if isinstance(v, str) else bytes(v)
           for v in values]
    offsets = np.zeros(len(enc) + 1, dtype=np.int32)
    np.cumsum([len(e) for e in enc], out=offsets[1:])
    chunks, descs, _ = _body_chunks([b"", offsets.tobytes(), b"".join(enc)])
    body = _join(chunks)
    b = Builder(256)
    rb = _build_recordbatch_header(b, len(enc), [(len(enc), 0)], descs)
    # DictionaryBatch: id(0) data(1) isDelta(2)
    b.StartObject(3)
    b.PrependInt64Slot(0, dict_id, 0)
    b.PrependUOffsetTRelativeSlot(1, rb, 0)
    hdr = b.EndObject()
    meta = _finish_message(b, HDR_DICTBATCH, hdr, len(body))
    return meta, body


def _write_encapsulated(sink, meta: bytes, body=b"") -> int:
    """Write one encapsulated message as parts (no full-copy join);
    ``body`` may be bytes or a chunk list. Returns total bytes written."""
    mlen = len(meta)
    pad = _pad(4 + 4 + mlen)
    sink.write(struct.pack("<II", CONTINUATION, mlen + pad))
    sink.write(meta)
    if pad:
        sink.write(b"\0" * pad)
    blen = 0
    for part in (body if isinstance(body, list) else [body]):
        if len(part):
            sink.write(part)
            blen += len(part)
    return 8 + mlen + pad + blen


# ====================================================================
# writer API
# ====================================================================

def _dict_columns(batches: List[RecordBatch]) -> Dict[str, int]:
    """Ids of the top-level dictionary-typed columns. One dictionary per
    column goes into the stream, so every batch must hold the same pool
    (the file format has no dictionary replacement; pyarrow refuses one
    too)."""
    ids = {}
    first = batches[0]
    for name, c in zip(first.names, first.columns):
        if isinstance(c, Column) and c.dtype.is_dictionary:
            if any(b.column(name).dictionary is not c.dictionary
                   for b in batches[1:]):
                raise Invalid(f"ipc_native: the batches' dictionaries of "
                              f"column {name!r} differ (dictionary "
                              "replacement is not written)")
            ids[name] = len(ids)
    return ids


def _batches(batch_or_batches, schema_batch, what):
    batches = list(batch_or_batches) if isinstance(
        batch_or_batches, (list, tuple)) else [batch_or_batches]
    first = batches[0] if batches else schema_batch
    if first is None:
        raise Invalid(f"{what}: no batches and no schema")
    return batches, first


def write_stream_start(sink, first: RecordBatch, batches=()) -> dict:
    """A stream's Schema message and the dictionaries of ``first``'s
    dictionary-typed columns; returns {column: its pool}, which every
    later batch must hold (``write_stream_batch`` checks)."""
    dict_ids = _dict_columns([first, *batches])
    b = Builder(1024)
    schema_off = _build_schema(b, first, dict_ids)
    _write_encapsulated(sink, _finish_message(b, HDR_SCHEMA, schema_off, 0))
    for name, did in dict_ids.items():
        meta, body = _serialize_dictionary(
            did, first.column(name).dictionary.values)
        _write_encapsulated(sink, meta, body)
    return {name: first.column(name).dictionary for name in dict_ids}


def write_stream_batch(sink, batch: RecordBatch, compression=None,
                       pools: Optional[dict] = None) -> None:
    """One RecordBatch message of a stream."""
    for name, pool in (pools or {}).items():
        if batch.column(name).dictionary is not pool:
            raise Invalid(f"ipc_native: the batches' dictionaries of "
                          f"column {name!r} differ (dictionary "
                          "replacement is not written)")
    meta, chunks, _ = serialize_batch_parts(batch, compression=compression)
    _write_encapsulated(sink, meta, chunks)


def write_stream_end(sink) -> None:
    sink.write(struct.pack("<II", CONTINUATION, 0))  # EOS


def write_stream(sink, batch_or_batches, compression=None,
                 schema_batch=None) -> None:
    """Write the port's batches as a native Arrow IPC stream. With zero
    batches, ``schema_batch`` supplies the schema for a schema-only
    stream (writer.cc: schema message + EOS, no batch messages)."""
    batches, first = _batches(batch_or_batches, schema_batch, "write_stream")
    write_stream_start(sink, first, batches)
    for batch in batches:
        write_stream_batch(sink, batch, compression)
    write_stream_end(sink)


def write_file(sink, batch_or_batches, compression=None,
               schema_batch=None) -> None:
    """Arrow IPC *file* format: magic + stream + Footer."""
    batches, first = _batches(batch_or_batches, schema_batch, "write_file")
    dict_ids = _dict_columns(batches or [first])
    start = sink.tell()
    sink.write(MAGIC + b"\0\0")
    dict_blocks, batch_blocks = [], []

    def emit(meta, body):
        off = sink.tell() - start
        blen = sum(len(c) for c in body) if isinstance(body, list) \
            else len(body)
        total = _write_encapsulated(sink, meta, body)
        return (off, total - blen, blen)

    b = Builder(1024)
    schema_off = _build_schema(b, first, dict_ids)
    emit(_finish_message(b, HDR_SCHEMA, schema_off, 0), b"")
    for name, did in dict_ids.items():
        meta, body = _serialize_dictionary(
            did, first.column(name).dictionary.values)
        dict_blocks.append(emit(meta, body))
    for batch in batches:
        meta, chunks, _ = serialize_batch_parts(batch,
                                                compression=compression)
        batch_blocks.append(emit(meta, chunks))
    sink.write(struct.pack("<II", CONTINUATION, 0))

    fb = Builder(1024)
    fschema = _build_schema(fb, first, dict_ids)

    def blocks_vec(blocks):
        fb.StartVector(24, len(blocks), 8)
        for off, mlen, blen in reversed(blocks):
            fb.PrependInt64(blen)
            fb.Pad(4)
            fb.PrependInt32(mlen)
            fb.PrependInt64(off)
        return fb.EndVector()

    bvec = blocks_vec(batch_blocks)
    dvec = blocks_vec(dict_blocks)
    # Footer: version(0) schema(1) dictionaries(2) recordBatches(3)
    fb.StartObject(5)
    fb.PrependInt16Slot(0, V5, 0)
    fb.PrependUOffsetTRelativeSlot(1, fschema, 0)
    fb.PrependUOffsetTRelativeSlot(2, dvec, 0)
    fb.PrependUOffsetTRelativeSlot(3, bvec, 0)
    fb.Finish(fb.EndObject())
    footer = fb.Output()
    sink.write(footer)
    sink.write(struct.pack("<i", len(footer)))
    sink.write(MAGIC)


# ====================================================================
# reader
# ====================================================================

def _type_from_fb(ttype: int, tt: Optional[_T],
                  children: List["_FieldInfo"]) -> dt.DataType:
    def need(k):
        if len(children) != k:
            raise Invalid(f"ipc_native: type index {ttype} with "
                          f"{len(children)} children")

    if tt is None:
        raise Invalid(f"ipc_native: type index {ttype} without its table")
    if ttype in (TYPE_LIST, TYPE_LARGELIST, TYPE_FSL, TYPE_MAP):
        need(1)
    if ttype == TYPE_LIST:
        return dt.list_(children[0].dtype)
    if ttype == TYPE_LARGELIST:
        return dt.large_list(children[0].dtype)
    if ttype == TYPE_FSL:
        size = tt.i32(0)
        if size <= 0:
            raise Invalid(f"ipc_native: fixed_size_list of size {size}")
        return dt.fixed_size_list(children[0].dtype, size)
    if ttype == TYPE_STRUCT:
        if not children:
            raise UnsupportedLayout("ipc_native: a struct of no fields")
        return dt.struct(tuple((c.name, c.dtype) for c in children))
    if ttype == TYPE_MAP:
        kv = children[0].children
        if len(kv) != 2:
            raise Invalid("ipc_native: map entries without key and value")
        return dt.map_(kv[0].dtype, kv[1].dtype)
    if ttype == TYPE_UNION:
        mode = tt.i16(0, 0)
        cpos, cn = tt.vector(1)
        codes = tuple(struct.unpack_from("<i", tt.buf, cpos + 4 * i)[0]
                      for i in range(cn)) or None
        if codes is not None and len(codes) != len(children):
            raise Invalid("ipc_native: union type codes and children differ")
        fields = tuple((c.name, c.dtype) for c in children)
        mk = dt.sparse_union if mode == 0 else dt.dense_union
        return mk(fields, codes)
    if ttype == TYPE_NULL:
        return dt.null
    if ttype == TYPE_INT:
        width, signed = tt.i32(0), tt.bool_(1)
        if width not in (8, 16, 32, 64):
            raise Invalid(f"ipc_native: integer of width {width}")
        return dt.DataType(("int" if signed else "uint") + str(width))
    if ttype == TYPE_FP:
        prec = tt.i16(0)
        if prec not in (0, 1, 2):
            raise Invalid(f"ipc_native: floating precision {prec}")
        return [dt.float16, dt.float32, dt.float64][prec]
    if ttype == TYPE_BOOL:
        return dt.bool_
    if ttype == TYPE_UTF8:
        return dt.string
    if ttype == TYPE_LARGEUTF8:
        return dt.large_string
    if ttype == TYPE_BINARY:
        return dt.binary
    if ttype == TYPE_LARGEBIN:
        return dt.large_binary
    if ttype == TYPE_DECIMAL:
        width = tt.i32(2, 128)
        if width not in (128, 256):
            raise UnsupportedLayout(f"ipc_native: decimal of width {width}")
        mk = dt.decimal128 if width == 128 else dt.decimal256
        return mk(tt.i32(0), tt.i32(1))
    if ttype == TYPE_DATE:
        return dt.date32 if tt.i16(0, 1) == 0 else dt.date64
    if ttype in (TYPE_TIME, TYPE_TIMESTAMP, TYPE_DURATION):
        unit = tt.i16(0, 0 if ttype == TYPE_TIMESTAMP else 1)
        if not 0 <= unit < 4:
            raise Invalid(f"ipc_native: time unit {unit}")
        unit = TIME_UNITS[unit]
        if ttype == TYPE_TIMESTAMP:
            return dt.timestamp(unit, tt.string(1))
        if ttype == TYPE_DURATION:
            return dt.duration(unit)
        return dt.time32(unit) if tt.i32(1, 32) == 32 else dt.time64(unit)
    raise UnsupportedLayout(f"ipc_native reader: unsupported Type index "
                            f"{ttype}")


class _FieldInfo:
    def __init__(self, name, dtype, dict_id, index_type, children=()):
        self.name, self.dtype = name, dtype
        self.dict_id, self.index_type = dict_id, index_type
        self.children = list(children)


def _field_from_fb(f: _T) -> _FieldInfo:
    name = f.string(0) or ""
    ttype = f.u8(2)
    tt = f.table(3)
    cpos, cn = f.vector(5)
    children = [_field_from_fb(f.vtable_at(cpos + 4 * i))
                for i in range(cn)]
    try:
        dtype = _type_from_fb(ttype, tt, children)
    except (TypeError, ValueError) as e:   # a parameter out of range
        if isinstance(e, Invalid):
            raise
        raise Invalid(f"ipc_native: field {name!r}: {e}") from None
    denc = f.table(4)
    dict_id = index_type = None
    if denc is not None:
        if not dtype.is_binary:
            raise UnsupportedLayout(f"ipc_native: a dictionary of {dtype!r} "
                                    "values")
        dict_id = denc.i64(0)
        it = denc.table(1)
        width, signed = (it.i32(0, 32), it.bool_(1, True)) \
            if it is not None else (32, True)
        if width not in (8, 16, 32, 64):
            raise Invalid(f"ipc_native: dictionary index of width {width}")
        index_type = dt.DataType(("int" if signed else "uint") + str(width))
    return _FieldInfo(name, dtype, dict_id, index_type, children)


def _schema_from_fb(s: Optional[_T]) -> List[_FieldInfo]:
    if s is None:
        raise Invalid("ipc_native: no schema")
    pos, n = s.vector(1)
    return [_field_from_fb(s.vtable_at(pos + 4 * i)) for i in range(n)]


class _Source:
    """Sequential and positional reads over one buffer (an mmap, bytes or
    a memoryview), without copying."""

    def __init__(self, buf):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0

    def read(self, n: int) -> memoryview:
        if n < 0 or self.pos + n > len(self.buf):
            raise Invalid("ipc_native: truncated input")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out


def _read_message(src: _Source):
    """-> (Message table, header_type, body view) or None at EOS/EOF."""
    if src.pos + 4 > len(src.buf):
        return None
    (w,) = struct.unpack("<I", src.read(4))
    ln = struct.unpack("<i", src.read(4))[0] if w == CONTINUATION \
        else struct.unpack("<i", struct.pack("<I", w))[0]
    if ln == 0:
        return None
    meta = bytes(src.read(ln))
    msg = _root(meta)
    # Message: version(0) header_type(1) header(2) bodyLength(3)
    htype = msg.u8(1)
    body = src.read(msg.i64(3))
    return msg, htype, body


class _BodyCursor:
    """Sequential node/buffer consumer over a RecordBatch body, with
    per-buffer decompression when BodyCompression is set."""

    def __init__(self, rb: Optional[_T], body: memoryview):
        if rb is None:
            raise Invalid("ipc_native: a batch message without its header")
        npos, nn = rb.vector(1)
        bpos, nb = rb.vector(2)
        self.nodes = [struct.unpack_from("<qq", rb.buf, npos + 16 * i)
                      for i in range(nn)]
        self.buffers = [struct.unpack_from("<qq", rb.buf, bpos + 16 * i)
                        for i in range(nb)]
        self.raw = np.frombuffer(body, np.uint8)
        comp = rb.table(3)
        self.comp_id = None if comp is None else comp.i8(0, 0)
        self.decomp = None if comp is None else _codec(self.comp_id)[1]
        self.ni = self.bi = 0

    def node(self) -> Tuple[int, int]:
        if self.ni >= len(self.nodes):
            raise Invalid("ipc_native: fewer field nodes than fields")
        length, nulls = self.nodes[self.ni]
        self.ni += 1
        if length < 0 or not 0 <= nulls <= length:
            raise Invalid(f"ipc_native: field node ({length}, {nulls})")
        return length, nulls

    def buf(self) -> np.ndarray:
        if self.bi >= len(self.buffers):
            raise Invalid("ipc_native: fewer buffers than the layout needs")
        off, sz = self.buffers[self.bi]
        self.bi += 1
        if off < 0 or sz < 0 or off + sz > len(self.raw):
            raise Invalid("ipc_native: buffer past the end of its body")
        view = self.raw[off: off + sz]
        if self.decomp is None or sz == 0:
            return view
        if sz < 8:
            raise Invalid("ipc_native: compressed buffer without its length")
        (ulen,) = struct.unpack_from("<q", view, 0)
        payload = view[8:]
        if ulen == -1:
            return payload
        if ulen < 0 or ulen > _MAX_RATIO[self.comp_id] * len(payload) + 64:
            raise Invalid(f"ipc_native: compressed buffer claims {ulen} "
                          f"bytes from {len(payload)}")
        try:
            out = self.decomp(payload, ulen)
        except RuntimeError as e:   # the native codec's malformed input
            raise Invalid(f"ipc_native: {e}") from None
        except Exception as e:      # zstandard's errors
            if type(e).__module__.startswith("zstandard"):
                raise Invalid(f"ipc_native: {e}") from None
            raise
        if len(out) != ulen:
            raise Invalid("ipc_native: decompressed length differs from "
                          "its prefix")
        return np.frombuffer(out, np.uint8)


def _need(buf: np.ndarray, nbytes: int, what: str) -> np.ndarray:
    if len(buf) < nbytes:
        raise Invalid(f"ipc_native: truncated {what} buffer ({len(buf)} "
                      f"bytes, {nbytes} needed)")
    return buf[:nbytes]


def _bits(buf: np.ndarray, length: int, what: str) -> np.ndarray:
    return np.unpackbits(_need(buf, (length + 7) // 8, what),
                         bitorder="little", count=length).astype(bool)


def _validity_from(vraw, length, null_count):
    if null_count > 0:
        return _bits(vraw, length, "validity")
    return None


def _view(buf: np.ndarray, length: int, npdt, what: str) -> np.ndarray:
    npdt = np.dtype(npdt)
    return _need(buf, length * npdt.itemsize, what).view(npdt)


def _offsets(buf, length, large, limit, what):
    """A list's or string's offsets, checked: monotone, within ``limit``
    child rows (or bytes)."""
    offs = _view(buf, length + 1, np.int64 if large else np.int32, what)
    if length and (int(offs[0]) < 0 or bool(np.any(np.diff(offs) < 0))
                   or int(offs[-1]) > limit):
        raise Invalid(f"ipc_native: corrupt {what} offsets")
    return offs


def _load_strings(fi: _FieldInfo, length, validity, bufs) -> Column:
    """Var-binary -> dictionary pool + int32 codes (first-appearance
    order) through the native MemoTable; a null slot's empty value is
    encoded like any other."""
    from ..native import MemoTable

    t = fi.dtype
    data = bufs[2]
    offsets = _offsets(bufs[1], length, t.kind.startswith("large"),
                       len(data), "var-binary")
    memo = MemoTable(max(64, length // 4))
    codes = memo.encode_array(data, offsets.astype(np.int64)) \
        if length else np.zeros(0, np.int32)
    raw = memo.values()
    uniq = np.empty(len(raw), dtype=object)
    uniq[:] = [b.decode("utf8") for b in raw] \
        if t.kind in ("string", "large_string") else raw
    return Column(codes, t, validity=validity, dictionary=Dictionary(uniq))


def _load_column(fi: _FieldInfo, length: int, null_count: int,
                 bufs: List[np.ndarray], dictionaries) -> Column:
    validity = _validity_from(bufs[0], length, null_count)
    t = fi.dtype
    if fi.dict_id is not None:
        if fi.dict_id not in dictionaries:
            raise Invalid(f"ipc_native: no dictionary with id {fi.dict_id}")
        codes = _view(bufs[1], length, fi.index_type.numpy_dtype(),
                      "dictionary index").astype(np.int64)
        values = dictionaries[fi.dict_id]
        keep = codes if validity is None else codes[validity]
        if len(keep) and (keep.min() < 0 or keep.max() >= len(values)):
            raise Invalid("ipc_native: dictionary index out of range")
        if validity is not None:
            codes = np.where(validity, codes, 0)
        if len(set(values.tolist())) != len(values):
            # one code per value, as the port's ingest keeps a pool
            values, inv = np.unique(values, return_inverse=True)
            codes = inv.reshape(-1)[codes] if len(values) else codes
        return Column(codes.astype(np.int32), t, validity=validity,
                      dictionary=Dictionary(values))
    if t.kind == "bool":
        return Column(_bits(bufs[1], length, "bool"), t, validity=validity)
    if t.is_decimal:   # the words' limbs: limb 0 and the rest
        words = _view(bufs[1], length * t.limbs, np.int64,
                      "decimal").reshape(length, t.limbs)
        return Column(words[:, 0], t, validity=validity,
                      data2=words[:, 1] if t.limbs == 2 else words[:, 1:])
    if t.is_binary:
        return _load_strings(fi, length, validity, bufs)
    return Column(_view(bufs[1], length, t.numpy_dtype(), t.kind), t,
                  validity=validity)


def _load_array(fi: _FieldInfo, cur: _BodyCursor, dictionaries):
    """Recursive pre-order array loader (reference ArrayLoader,
    ipc/reader.cc:138)."""
    t = fi.dtype
    k = t.kind
    if k in ("list", "large_list", "map"):
        length, nulls = cur.node()
        validity = _validity_from(cur.buf(), length, nulls)
        obuf = cur.buf()
        child = _load_array(fi.children[0], cur, dictionaries)
        offsets = _offsets(obuf, length, k == "large_list", child.length,
                           "list").astype(np.int64)
        child, offsets = _compact_list_child(child, offsets, validity)
        if k == "map":
            # the port's maps hold entries as a {key, value} RecordBatch
            if not isinstance(child, StructColumn) or \
                    len(child.children) != 2:
                raise Invalid("ipc_native: map entries are not a struct "
                              "of key and value")
            child = RecordBatch(child.children, ("key", "value"))
        return ListColumn(offsets, child, t, validity=validity)
    if k == "fixed_size_list":
        length, nulls = cur.node()
        validity = _validity_from(cur.buf(), length, nulls)
        child = _load_array(fi.children[0], cur, dictionaries)
        if child.length < length * t.list_size:
            raise Invalid("ipc_native: fixed_size_list child too short")
        child = _slice(child, 0, length * t.list_size)
        offsets = np.arange(length + 1, dtype=np.int64) * t.list_size
        return ListColumn(offsets, child, t, validity=validity)
    if k == "struct":
        length, nulls = cur.node()
        validity = _validity_from(cur.buf(), length, nulls)
        children = [_load_array(c, cur, dictionaries) for c in fi.children]
        if any(c.length < length for c in children):
            raise Invalid("ipc_native: struct child too short")
        children = [_slice(c, 0, length) for c in children]
        return StructColumn(children, tuple(c.name for c in fi.children),
                            t, validity=validity)
    if k in ("sparse_union", "dense_union"):
        length, _ = cur.node()
        type_ids = _view(cur.buf(), length, np.int8, "union type id")
        offsets = None
        if k == "dense_union":
            offsets = _view(cur.buf(), length, np.int32, "union offset")
        children = [_load_array(c, cur, dictionaries) for c in fi.children]
        for code, child in zip(t.type_codes, children):
            at = type_ids == code
            if k == "sparse_union":
                if child.length < length:
                    raise Invalid("ipc_native: sparse union child too short")
            elif at.any() and (offsets[at].min() < 0
                               or offsets[at].max() >= child.length):
                raise Invalid("ipc_native: dense union offset out of range")
        if length and not np.isin(type_ids, t.type_codes).all():
            raise Invalid("ipc_native: union type id not in the type")
        if k == "sparse_union":
            children = [_slice(c, 0, length) for c in children]
        return UnionColumn(type_ids, children, t, offsets=offsets)
    # flat
    length, nulls = cur.node()
    if k == "null":
        return Column(np.zeros(length, np.int8), t,
                      validity=np.zeros(length, bool))
    bufs = [cur.buf() for _ in range(_nbuffers(fi))]
    return _load_column(fi, length, nulls, bufs, dictionaries)


def _slice(col, offset: int, length: int):
    """A host-side column's rows [offset, offset + length)."""
    if col.length == length and offset == 0:
        return col
    return _take(col, np.arange(offset, offset + length))


def _take(col, rows: np.ndarray):
    """A host-side column's rows at ``rows`` (numpy gathers)."""
    if isinstance(col, RecordBatch):
        return RecordBatch(tuple(_take(c, rows) for c in col.columns),
                           col.names)
    if isinstance(col, ListColumn):
        offs = col.offsets
        lens = offs[1:][rows] - offs[:-1][rows]
        new = np.zeros(len(rows) + 1, np.int64)
        np.cumsum(lens, out=new[1:])
        parent = np.repeat(np.arange(len(rows)), lens)
        child_rows = offs[:-1][rows][parent] + np.arange(new[-1]) - \
            new[:-1][parent]
        return ListColumn(new, _take(col.values, child_rows), col.dtype,
                          validity=None if col.validity is None
                          else col.validity[rows])
    if isinstance(col, StructColumn):
        return StructColumn(tuple(_take(c, rows) for c in col.children),
                            col.names, col.dtype,
                            validity=None if col.validity is None
                            else col.validity[rows])
    if isinstance(col, UnionColumn):
        if col.is_dense:
            return UnionColumn(col.type_ids[rows], col.children, col.dtype,
                               offsets=col.offsets[rows])
        return UnionColumn(col.type_ids[rows],
                           tuple(_take(c, rows) for c in col.children),
                           col.dtype)
    return Column(col.data[rows], col.dtype,
                  validity=None if col.validity is None
                  else col.validity[rows], dictionary=col.dictionary,
                  data2=None if col.data2 is None else col.data2[rows])


def _compact_list_child(child, offsets, validity):
    """Offsets rebased to 0 with a null slot's range empty, as the port's
    list columns hold them; the child keeps the rows of the valid slots'
    ranges (a copy only where the file's ranges differ from that)."""
    lens = offsets[1:] - offsets[:-1]
    if validity is not None:
        lens = np.where(validity, lens, 0)
    new = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=new[1:])
    if np.array_equal(new, offsets - offsets[0]):
        if offsets[0] == 0 and new[-1] == child.length:
            return child, offsets
        return _take(child, np.arange(offsets[0], offsets[0] + new[-1])), \
            new
    parent = np.repeat(np.arange(len(lens)), lens)
    rows = offsets[:-1][parent] + np.arange(new[-1]) - new[:-1][parent]
    return _take(child, rows), new


def _nbuffers(fi: _FieldInfo) -> int:
    if fi.dict_id is None and fi.dtype.is_binary:
        return 3
    return 2


def _torch_dtype(a: np.ndarray) -> torch.dtype:
    return torch.from_numpy(np.zeros(0, a.dtype)).dtype


def _stage(col, device: torch.device):
    """The host-side column ``col`` (numpy arrays, views of the body or
    decoded, in its tensor slots) on ``device``: every array copied once,
    strided or not, into one staging buffer at 8-byte aligned offsets
    (pinned memory for a CUDA target, then one host-to-device copy), and
    each tensor a contiguous view of the copy."""
    arrays = []
    map_tensors(col, lambda a: arrays.append(a) or a)
    starts, total = [], 0
    for a in arrays:
        starts.append(total)
        total += a.nbytes + _pad(a.nbytes)
    cuda = device.type == "cuda"
    host = torch.empty(max(total, ALIGN), dtype=torch.uint8, pin_memory=cuda)
    flat = host.numpy()
    for a, s in zip(arrays, starts):
        flat[s:s + a.nbytes].view(a.dtype).reshape(a.shape)[...] = a
    dev = host.to(device, non_blocking=True) if cuda else host
    views = iter([dev[s:s + a.nbytes].view(_torch_dtype(a)).view(a.shape)
                  for a, s in zip(arrays, starts)])
    return map_tensors(col, lambda a: next(views))


def deserialize_batch(msg: _T, body, fields: List[_FieldInfo],
                      dictionaries, device=None) -> RecordBatch:
    """One RecordBatch message -> a RecordBatch on ``device`` (CUDA
    unless the caller names the CPU)."""
    dev = resolve_device(device)
    rb = msg.table(2)
    cur = _BodyCursor(rb, memoryview(body))
    length = rb.i64(0)
    cols = [_load_array(fi, cur, dictionaries) for fi in fields]
    if any(c.length != length for c in cols):
        raise Invalid("ipc_native: a column's length differs from its "
                      "batch's")
    return _stage(RecordBatch(tuple(cols), tuple(f.name for f in fields)),
                  dev)


def _read_dictionary(msg: _T, body):
    db = msg.table(2)
    if db is None:
        raise Invalid("ipc_native: a dictionary message without its header")
    dict_id = db.i64(0)
    rb = db.table(1)
    if rb is None:
        raise Invalid("ipc_native: a dictionary without its batch")
    length = rb.i64(0)
    cur = _BodyCursor(rb, memoryview(body))
    cur.node()
    cur.buf()  # validity (dictionaries are written all-valid)
    obuf = cur.buf()
    data = cur.buf()
    offsets = _offsets(obuf, length, False, len(data), "dictionary")
    vals = [bytes(data[offsets[i]: offsets[i + 1]]).decode("utf8")
            for i in range(length)]
    return dict_id, np.array(vals, dtype=object)


def _buffer_of(src):
    """A zero-copy buffer over ``src``: bytes-like as is, a BytesIO's
    buffer, a path or a real file mapped read-only (an empty file as
    b"")."""
    if isinstance(src, (bytes, bytearray, memoryview, mmap.mmap)):
        return src
    if isinstance(src, _io.BytesIO):
        return src.getbuffer()
    if isinstance(src, (str, os.PathLike)):
        with open(src, "rb") as f:
            return _map(f)
    if hasattr(src, "fileno"):
        try:
            return _map(src)
        except (OSError, _io.UnsupportedOperation):
            pass
    return src.read()


def _map(f):
    if os.fstat(f.fileno()).st_size == 0:
        return b""
    return mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)


_CORRUPT = (struct.error, IndexError, ValueError, UnicodeDecodeError,
            OverflowError, RecursionError)


def _invalid(e: Exception) -> Invalid:
    """A decoding error of corrupt input, as the reader's ``Invalid``."""
    return e if isinstance(e, Invalid) else \
        Invalid(f"ipc_native: corrupt input ({type(e).__name__}: {e})")


def read_stream(src, device=None) -> List[RecordBatch]:
    """Read a native or pyarrow-written IPC stream into RecordBatches on
    ``device`` (CUDA unless the caller names the CPU). Corrupt input
    raises ``Invalid``."""
    dev = resolve_device(device)
    try:
        return _read_stream(src, dev)
    except _CORRUPT as e:
        raise _invalid(e) from None


def _read_stream(src, dev) -> List[RecordBatch]:
    source = _Source(_buffer_of(src))
    if hasattr(src, "tell") and not isinstance(src, mmap.mmap):
        source.pos = src.tell()   # a file object: from where it stands
    first = _read_message(source)
    if first is None:
        raise Invalid("ipc_native: empty stream")
    msg, htype, _ = first
    if htype != HDR_SCHEMA:
        raise Invalid("ipc_native: stream must start with a Schema message")
    fields = _schema_from_fb(msg.table(2))
    dictionaries = {}
    batches = []
    while True:
        item = _read_message(source)
        if item is None:
            break
        msg, htype, body = item
        if htype == HDR_DICTBATCH:
            did, vals = _read_dictionary(msg, body)
            dictionaries[did] = vals
        elif htype == HDR_RECORDBATCH:
            batches.append(deserialize_batch(msg, body, fields,
                                             dictionaries, dev))
        else:
            raise Invalid(f"ipc_native: unexpected message type {htype}")
    if not batches:
        # schema-only stream: surface the schema as one zero-row batch
        batches = [_empty_batch(fields, dev)]
    return batches


def _empty_host(t: dt.DataType):
    """A zero-row host-side column of type ``t``."""
    if t.kind in ("sparse_union", "dense_union"):
        return UnionColumn(np.zeros(0, np.int8),
                           [_empty_host(ct) for _, ct in t.fields], t,
                           offsets=np.zeros(0, np.int32)
                           if t.kind == "dense_union" else None)
    if t.kind == "struct":
        return StructColumn([_empty_host(ct) for _, ct in t.fields],
                            [n for n, _ in t.fields], t)
    if t.kind == "map":
        return ListColumn(np.zeros(1, np.int64), RecordBatch(
            tuple(_empty_host(ct) for _, ct in t.fields), ("key", "value")),
            t)
    if t.is_nested:
        return ListColumn(np.zeros(1, np.int64), _empty_host(t.value_field),
                          t)
    if t.is_decimal:
        return Column(np.zeros(0, np.int64), t,
                      data2=np.zeros((0,) if t.limbs == 2 else (0, 3),
                                     np.int64))
    if t.is_null:
        return Column(np.zeros(0, np.int8), t, validity=np.zeros(0, bool))
    return Column(np.zeros(0, t.numpy_dtype()), t,
                  dictionary=Dictionary(np.zeros(0, object))
                  if t.is_binary else None)


def _empty_batch(fields: List[_FieldInfo], dev) -> RecordBatch:
    """A schema-only stream or file as one zero-row batch."""
    return _stage(RecordBatch(tuple(_empty_host(fi.dtype) for fi in fields),
                              tuple(f.name for f in fields)), dev)


def iter_file(src, device=None):
    """The batches of an IPC *file*, one at a time, on ``device`` (CUDA
    unless the caller names the CPU), through its Footer (random access,
    reference ipc/reader.h:102). A path is mapped read-only, and each
    batch is decoded when it is asked for. Corrupt input raises
    ``Invalid``."""
    dev = resolve_device(device)
    try:
        yield from _iter_file(src, dev)
    except _CORRUPT as e:
        raise _invalid(e) from None


def _iter_file(src, dev):
    buf = memoryview(_buffer_of(src)).cast("B")
    end = len(buf)
    if end < 18 or bytes(buf[:6]) != MAGIC:
        raise Invalid("ipc_native: bad file magic")
    if bytes(buf[end - 6:]) != MAGIC:
        raise Invalid("ipc_native: bad trailing magic")
    (flen,) = struct.unpack_from("<i", buf, end - 10)
    if not 0 < flen <= end - 18:
        raise Invalid("ipc_native: bad footer length")
    footer = _root(bytes(buf[end - 10 - flen: end - 10]))
    fields = _schema_from_fb(footer.table(1))
    dictionaries = {}

    def read_block(pos, i):
        off = struct.unpack_from("<q", footer.buf, pos + 24 * i)[0]
        if not 0 <= off < end:
            raise Invalid("ipc_native: block offset out of range")
        source = _Source(buf)
        source.pos = off
        item = _read_message(source)
        if item is None:
            raise Invalid("ipc_native: empty block")
        return item

    dpos, nd = footer.vector(2)
    for i in range(nd):
        msg, htype, body = read_block(dpos, i)
        if htype != HDR_DICTBATCH:
            raise Invalid("ipc_native: a dictionary block holds another "
                          "message")
        did, vals = _read_dictionary(msg, body)
        dictionaries[did] = vals
    bpos, nbk = footer.vector(3)
    if not nbk:
        yield _empty_batch(fields, dev)
    for i in range(nbk):
        msg, htype, body = read_block(bpos, i)
        if htype != HDR_RECORDBATCH:
            raise Invalid("ipc_native: a batch block holds another message")
        yield deserialize_batch(msg, body, fields, dictionaries, dev)


def read_file(src, device=None) -> List[RecordBatch]:
    """Read the IPC *file* format into RecordBatches on ``device``."""
    return list(iter_file(src, device))
