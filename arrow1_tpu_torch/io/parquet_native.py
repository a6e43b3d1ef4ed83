"""Native Parquet reader and writer, with no parquet-cpp on the path
(counterpart of arrow1_tpu/io/parquet_native.py).

Reference: cpp/src/parquet/ — file layout (file_reader.cc), Thrift
metadata (parquet.thrift via metadata.cc), page codecs
(column_reader.cc), encodings (encoding.cc). This is an original
implementation of the subset that covers pyarrow's default output:

  format    PAR1 magic, row groups, column chunks, footer FileMetaData
            in the Thrift COMPACT protocol (hand-rolled decoder/encoder,
            same spirit as the hand-built flatbuffers in ipc_native.py)
  pages     v1 + v2 data pages, dictionary pages
  encodings PLAIN (all physical types), RLE/bit-packed hybrid
            (definition levels, dictionary indices, PLAIN boolean),
            PLAIN_DICTIONARY / RLE_DICTIONARY, DELTA_BINARY_PACKED,
            DELTA_LENGTH_BYTE_ARRAY, DELTA_BYTE_ARRAY,
            BYTE_STREAM_SPLIT (read side)
  codecs    UNCOMPRESSED, SNAPPY (native/src/snappy.cpp — original
            block-format decoder), GZIP (zlib), ZSTD (zstandard)
  types     int32/int64/float/double/boolean/byte_array leaves
            (+ converted types: UTF8, DATE, TIMESTAMP_*, DECIMAL over
            int64/FLBA) at ARBITRARY nesting depth: LIST (standard
            3-level + both legacy layouts), STRUCT, MAP groups and bare
            repeated fields, reconstructed by the vectorized Dremel
            assembler (_assemble_node)

Deliberate de-scopes (VERDICT r4 #9 — documented contract, not gaps
to grow into): BROTLI and LZO codecs route to the pyarrow fallback in
io/parquet.py (reference: util/compression_brotli.cc — a vendored
third-party codec, not engine machinery); the KMS/CryptoFactory
key-material envelope likewise (parquet/encryption/crypto_factory.h,
key_toolkit.h — key-management *policy* around the AES modules this
file already implements natively); and the writer emits v1 data pages
only (the READER handles v2; v2's only write-side win is optional
page-level uncompressed levels, which no default pyarrow pipeline
requires).

The writer emits v1 data pages at ARBITRARY nesting depth (recursive
Dremel level writer) with PLAIN / DELTA_BINARY_PACKED /
BYTE_STREAM_SPLIT values + RLE levels (readable by any parquet
implementation), one or more row groups, optional split-block bloom
filters, and optional AES_GCM_V1 modular encryption in
encrypted-footer mode with direct keys (PARE magic; page headers,
pages, and footer are GCM modules with the spec AAD discipline —
reference parquet/encryption/encryption_internal.h:46). The KMS
key-material envelope (pyarrow CryptoFactory interop) stays on the
pyarrow fallback path in io/parquet.py.

The port's reader builds host-side columns of its own layouts (strings
as int32 codes into a pool of distinct values, decimals as int64 limbs,
no f64 bit view) and puts each read on its device in one staging copy
(``ipc_native._stage``; CUDA unless the caller names the CPU). A file
whose codec (BROTLI, LZO, LZ4), encoding (BIT_PACKED levels, a delta
encoding of fixed-length byte arrays) or column type (INT96, FLOAT16, a
decimal wider than 16 bytes) it does not take raises
``UnsupportedLayout`` from the footer, before any page is read; a
corrupt or truncated file raises ``Invalid``. ZSTD needs the
``zstandard`` package and AES-GCM the ``cryptography`` package, each
imported only on its path.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from ..column import Column, Dictionary, ListColumn, StructColumn
from ..device import resolve_device
from ..errors import A1TError, Invalid, KeyError_
from ..table import RecordBatch, map_tensors
from .ipc_native import UnsupportedLayout, _stage

__all__ = ["read_parquet_native", "write_parquet_native"]

MAGIC = b"PAR1"

# physical types (parquet.thrift Type)
T_BOOLEAN, T_INT32, T_INT64, T_INT96, T_FLOAT, T_DOUBLE, T_BYTE_ARRAY, \
    T_FLBA = range(8)
# codecs
C_UNCOMPRESSED, C_SNAPPY, C_GZIP = 0, 1, 2
C_ZSTD = 6
# encodings
E_PLAIN, E_PLAIN_DICT, E_RLE, E_BIT_PACKED = 0, 2, 3, 4
E_DELTA_BINARY_PACKED, E_DELTA_LENGTH_BA, E_DELTA_BA = 5, 6, 7
E_RLE_DICT = 8
E_BYTE_STREAM_SPLIT = 9
# the encodings the reader decodes, each on the physical types it names
# (None: any); RLE also encodes the levels of every type
_DECODED = {
    E_PLAIN: None, E_PLAIN_DICT: None, E_RLE_DICT: None, E_RLE: None,
    E_DELTA_BINARY_PACKED: (T_INT32, T_INT64),
    E_DELTA_LENGTH_BA: (T_BYTE_ARRAY,), E_DELTA_BA: (T_BYTE_ARRAY,),
    E_BYTE_STREAM_SPLIT: (T_INT32, T_INT64, T_FLOAT, T_DOUBLE, T_FLBA)}
# page types
P_DATA, P_INDEX, P_DICT, P_DATA_V2 = 0, 1, 2, 3
# converted types (parquet.thrift ConvertedType)
CT_UTF8, CT_DECIMAL, CT_DATE, CT_TIME_MILLIS, CT_TIME_MICROS, \
    CT_TS_MILLIS, CT_TS_MICROS = 0, 5, 6, 7, 8, 9, 10
CT_INT8, CT_INT16, CT_INT32, CT_INT64 = 15, 16, 17, 18
CT_UINT8, CT_UINT16, CT_UINT32, CT_UINT64 = 11, 12, 13, 14


# ====================================================================
# Thrift compact protocol (decoder + encoder)
# ====================================================================

CT_STOP = 0
CT_TRUE, CT_FALSE, CT_BYTE, CT_I16, CT_I32, CT_I64, CT_DOUBLE, \
    CT_BINARY, CT_LIST, CT_SET, CT_MAP, CT_STRUCT = range(1, 13)


class TRead:
    """Thrift compact-protocol reader producing {field_id: value} dicts
    (struct fields keep raw nested dicts; lists keep python lists)."""

    def __init__(self, buf: bytes, pos: int = 0):
        self.buf = buf
        self.pos = pos

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.buf[self.pos]
            self.pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                return v
            shift += 7

    def zigzag(self) -> int:
        v = self.varint()
        return (v >> 1) ^ -(v & 1)

    def read_value(self, ftype: int):
        if ftype == CT_TRUE:
            return True
        if ftype == CT_FALSE:
            return False
        if ftype in (CT_BYTE,):
            v = self.buf[self.pos]
            self.pos += 1
            return v - 256 if v >= 128 else v
        if ftype in (CT_I16, CT_I32, CT_I64):
            return self.zigzag()
        if ftype == CT_DOUBLE:
            v = struct.unpack_from("<d", self.buf, self.pos)[0]
            self.pos += 8
            return v
        if ftype == CT_BINARY:
            n = self.varint()
            v = self.buf[self.pos: self.pos + n]
            self.pos += n
            return v
        if ftype in (CT_LIST, CT_SET):
            head = self.buf[self.pos]
            self.pos += 1
            size = head >> 4
            etype = head & 0x0F
            if size == 15:
                size = self.varint()
            return [self.read_value(etype) for _ in range(size)]
        if ftype == CT_STRUCT:
            return self.read_struct()
        if ftype == CT_MAP:
            size = self.varint()
            if size == 0:
                return {}
            kv = self.buf[self.pos]
            self.pos += 1
            kt, vt = kv >> 4, kv & 0x0F
            return {self.read_value(kt): self.read_value(vt)
                    for _ in range(size)}
        raise Invalid(f"thrift: unknown type {ftype}")

    def read_struct(self) -> Dict[int, object]:
        out: Dict[int, object] = {}
        fid = 0
        while True:
            head = self.buf[self.pos]
            self.pos += 1
            if head == CT_STOP:
                return out
            delta = head >> 4
            ftype = head & 0x0F
            if delta:
                fid += delta
            else:
                fid = self.zigzag()
            if ftype in (CT_TRUE, CT_FALSE):
                out[fid] = ftype == CT_TRUE
            else:
                out[fid] = self.read_value(ftype)


class TWrite:
    """Thrift compact-protocol writer (field-id-ordered emit)."""

    def __init__(self):
        self.out = bytearray()

    def varint(self, v: int):
        while True:
            b = v & 0x7F
            v >>= 7
            if v:
                self.out.append(b | 0x80)
            else:
                self.out.append(b)
                return

    def zigzag(self, v: int):
        self.varint((v << 1) ^ (v >> 63) if v < 0 else v << 1)

    def field(self, last_fid: int, fid: int, ftype: int) -> int:
        delta = fid - last_fid
        if 0 < delta <= 15:
            self.out.append((delta << 4) | ftype)
        else:
            self.out.append(ftype)
            self.zigzag(fid)
        return fid

    def write_struct(self, fields: List[Tuple[int, int, object]]):
        """fields: (fid, ftype, value) sorted by fid."""
        last = 0
        for fid, ftype, val in fields:
            if ftype in (CT_TRUE, CT_FALSE):
                last = self.field(last, fid,
                                  CT_TRUE if val else CT_FALSE)
                continue
            last = self.field(last, fid, ftype)
            self.write_value(ftype, val)
        self.out.append(CT_STOP)

    def write_value(self, ftype: int, val):
        if ftype in (CT_I16, CT_I32, CT_I64):
            self.zigzag(val)
        elif ftype == CT_BYTE:
            self.out.append(val & 0xFF)
        elif ftype == CT_DOUBLE:
            self.out += struct.pack("<d", val)
        elif ftype == CT_BINARY:
            data = val.encode() if isinstance(val, str) else bytes(val)
            self.varint(len(data))
            self.out += data
        elif ftype == CT_LIST:
            etype, items = val
            n = len(items)
            if n < 15:
                self.out.append((n << 4) | etype)
            else:
                self.out.append(0xF0 | etype)
                self.varint(n)
            for it in items:
                if etype in (CT_TRUE, CT_FALSE):
                    self.out.append(1 if it else 2)
                else:
                    self.write_value(etype, it)
        elif ftype == CT_STRUCT:
            self.write_struct(val)
        else:
            raise Invalid(f"thrift write: type {ftype}")


# ====================================================================
# codecs
# ====================================================================

_CODECS = (C_UNCOMPRESSED, C_SNAPPY, C_GZIP, C_ZSTD)


def _zstandard():
    try:
        import zstandard
    except ImportError:
        raise Invalid("parquet_native: the ZSTD codec needs the zstandard "
                      "package, which is not installed") from None
    return zstandard


def _decompress(codec: int, data: bytes, usize: int) -> bytes:
    if codec == C_UNCOMPRESSED:
        return data
    if codec == C_SNAPPY:
        from ..native import snappy_decompress

        try:
            return snappy_decompress(data, usize)
        except ValueError as e:
            raise Invalid(f"parquet_native: {e}") from None
    if codec == C_GZIP:
        try:
            return zlib.decompress(data, 31)
        except zlib.error as e:
            raise Invalid(f"parquet_native: gzip: {e}") from None
    if codec == C_ZSTD:
        return _zstandard().ZstdDecompressor().decompress(
            data, max_output_size=usize)
    raise UnsupportedLayout(f"parquet_native: codec {codec}")


# ====================================================================
# byte-array values: int64 codes into a pool of distinct byte strings
# ====================================================================

class _Strs:
    """BYTE_ARRAY values as ``codes`` into ``pool`` (a list of distinct
    bytes): a dictionary page's indices stay codes, PLAIN values are
    encoded through the native MemoTable, and no per-value object list is
    built on the common paths."""

    __slots__ = ("pool", "codes")

    def __init__(self, pool: List[bytes], codes: np.ndarray):
        self.pool = pool
        self.codes = codes

    def __len__(self):
        return len(self.codes)

    def take(self, idx: np.ndarray) -> "_Strs":
        return _Strs(self.pool, self.codes[idx])

    @staticmethod
    def encode(data, offsets: np.ndarray) -> "_Strs":
        from ..native import MemoTable

        memo = MemoTable(max(64, len(offsets) // 4))
        data = data if isinstance(data, np.ndarray) else \
            np.frombuffer(data, np.uint8)
        codes = memo.encode_array(data, offsets).astype(np.int64)
        return _Strs(memo.values(), codes)

    @staticmethod
    def of_list(values: List[bytes]) -> "_Strs":
        lens = np.fromiter((len(v) for v in values), np.int64, len(values))
        offsets = np.zeros(len(values) + 1, np.int64)
        np.cumsum(lens, out=offsets[1:])
        return _Strs.encode(b"".join(values), offsets)

    @staticmethod
    def concat(parts: List["_Strs"]) -> "_Strs":
        """One sequence of the parts' values (their pools merged)."""
        if not parts:
            return _Strs([], np.zeros(0, np.int64))
        if all(p.pool is parts[0].pool for p in parts):
            return _Strs(parts[0].pool, np.concatenate(
                [p.codes for p in parts]))
        from ..native import MemoTable

        memo = MemoTable()
        codes = []
        for p in parts:
            remap = np.array([memo.get_or_insert(v) for v in p.pool] or [0],
                             np.int64)
            codes.append(remap[p.codes])
        return _Strs(memo.values(), np.concatenate(codes))


def _concat_values(parts, phys: int):
    """Decoded value chunks of a ``phys`` leaf end to end."""
    if phys == T_BYTE_ARRAY:
        return _Strs.concat(parts)
    return np.concatenate(parts) if parts else np.zeros(0)


def _plain_byte_arrays(data, count: int, pos: int) -> Tuple[_Strs, int]:
    """``count`` PLAIN byte arrays (<u32 length><bytes>) from ``pos``.
    Values of one length (a flag column) are found with one strided read;
    others walk the length prefixes."""
    buf = np.frombuffer(data, np.uint8)
    if count and pos + 4 <= len(buf):
        (n0,) = struct.unpack_from("<I", data, pos)
        stride = 4 + n0
        end = pos + stride * count
        if end <= len(buf):
            rows = buf[pos:end].reshape(count, stride)
            if (rows[:, :4].copy().view("<u4").reshape(count) == n0).all():
                return _Strs.encode(
                    rows[:, 4:].reshape(-1),
                    n0 * np.arange(count + 1, dtype=np.int64)), end
    start = pos
    offsets = np.zeros(count + 1, np.int64)
    prefixes = np.empty(count, np.int64)
    for i in range(count):
        (n,) = struct.unpack_from("<I", data, pos)
        prefixes[i] = pos
        pos += 4 + n
        offsets[i + 1] = offsets[i] + n
    if pos > len(buf):
        raise Invalid("parquet_native: byte arrays run past their page")
    keep = np.ones(pos - start, bool)
    keep[(prefixes - start)[:, None] + np.arange(4)] = False
    return _Strs.encode(buf[start:pos][keep], offsets), pos


# ====================================================================
# RLE / bit-packed hybrid (levels + dictionary indices)
# ====================================================================

def decode_rle_hybrid(data: bytes, bit_width: int, count: int
                      ) -> np.ndarray:
    """parquet encoding.md RLE hybrid: runs of (rle | bit-packed)."""
    out = np.empty(count, np.int32)
    pos = 0
    filled = 0
    byw = (bit_width + 7) // 8
    while filled < count:
        # varint header
        v = shift = 0
        while True:
            b = data[pos]
            pos += 1
            v |= (b & 0x7F) << shift
            if not b & 0x80:
                break
            shift += 7
        if v & 1:  # bit-packed: (v>>1) groups of 8
            ngroups = v >> 1
            nvals = ngroups * 8
            nbytes = ngroups * bit_width
            raw = np.frombuffer(data, np.uint8, nbytes, pos)
            pos += nbytes
            bits = np.unpackbits(raw, bitorder="little").reshape(
                -1, bit_width)
            weights = (1 << np.arange(bit_width)).astype(np.int64)
            vals = (bits.astype(np.int64) * weights).sum(1)
            take = min(nvals, count - filled)
            out[filled: filled + take] = vals[:take]
            filled += take
        else:  # rle run: value in byw little-endian bytes
            run = v >> 1
            val = int.from_bytes(data[pos: pos + byw], "little")
            pos += byw
            take = min(run, count - filled)
            out[filled: filled + take] = val
            filled += take
    return out


def encode_rle_hybrid(values: np.ndarray, bit_width: int) -> bytes:
    """Single bit-packed run (padded to groups of 8) — valid for any
    input, which is all the writer needs."""
    n = len(values)
    if n == 0:
        return b""
    ngroups = (n + 7) // 8
    padded = np.zeros(ngroups * 8, np.int64)
    padded[:n] = values
    bits = ((padded[:, None] >> np.arange(bit_width)[None, :]) & 1
            ).astype(np.uint8)
    by = np.packbits(bits.reshape(-1), bitorder="little")
    header = bytearray()
    v = (ngroups << 1) | 1
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            header.append(b | 0x80)
        else:
            header.append(b)
            break
    return bytes(header) + by.tobytes()


# ====================================================================
# DELTA_* / BYTE_STREAM_SPLIT encodings (reference: parquet/encoding.cc
# DeltaBitPackDecoder / DeltaLengthByteArrayDecoder / DeltaByteArrayDecoder
# / ByteStreamSplitDecoder; spec Encodings.md)
# ====================================================================

def _read_uleb(data: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _read_zigzag(data: bytes, pos: int) -> Tuple[int, int]:
    v, pos = _read_uleb(data, pos)
    return (v >> 1) ^ -(v & 1), pos


def _unpack_le(data: bytes, pos: int, bit_width: int, nvals: int
               ) -> Tuple[np.ndarray, int]:
    """LSB-first bit unpack (Encodings.md bit-packing, same order as the
    RLE hybrid's packed runs). Returns (uint64 values, new pos)."""
    nbytes = (nvals * bit_width + 7) // 8
    if bit_width == 0:
        return np.zeros(nvals, np.uint64), pos
    raw = np.frombuffer(data, np.uint8, nbytes, pos)
    bits = np.unpackbits(raw, bitorder="little", count=nvals * bit_width
                         ).reshape(-1, bit_width)
    weights = (np.uint64(1) << np.arange(bit_width, dtype=np.uint64))
    return (bits.astype(np.uint64) * weights).sum(1, dtype=np.uint64), \
        pos + nbytes


def decode_delta_binary_packed(data: bytes, pos: int, phys: int
                               ) -> Tuple[np.ndarray, int]:
    """DELTA_BINARY_PACKED: <block size><miniblocks/block><total count>
    <first value> then per block: <min delta><bit widths><miniblocks>.
    Deltas are unsigned offsets from the block's min delta; arithmetic
    wraps mod 2^64 (the reference decodes with unsigned overflow)."""
    block_size, pos = _read_uleb(data, pos)
    n_mini, pos = _read_uleb(data, pos)
    total, pos = _read_uleb(data, pos)
    first, pos = _read_zigzag(data, pos)
    vpm = block_size // n_mini
    out = np.empty(total, np.uint64)
    if total:
        out[0] = np.uint64(first % (1 << 64))
    remaining = total - 1 if total else 0
    filled = 1 if total else 0
    while remaining > 0:
        min_delta, pos = _read_zigzag(data, pos)
        widths = np.frombuffer(data, np.uint8, n_mini, pos)
        pos += n_mini
        md = np.uint64(min_delta % (1 << 64))
        for m in range(n_mini):
            if remaining <= 0:
                break
            vals, pos = _unpack_le(data, pos, int(widths[m]), vpm)
            take = min(vpm, remaining)
            out[filled: filled + take] = vals[:take] + md
            filled += take
            remaining -= take
    # prefix sum of deltas (mod 2^64), then reinterpret at physical width
    deltas = out
    acc = np.cumsum(deltas.view(np.int64))  # wraps like the reference
    if phys == T_INT32:
        return acc.astype(np.int64).astype(np.int32), pos
    return acc.astype(np.int64), pos


def decode_delta_length_byte_array(data: bytes, pos: int
                                   ) -> Tuple[List[bytes], int]:
    lens, pos = decode_delta_binary_packed(data, pos, T_INT32)
    out: List[bytes] = []
    for ln in lens:
        ln = int(ln)
        out.append(data[pos: pos + ln])
        pos += ln
    return out, pos


def decode_delta_byte_array(data: bytes, pos: int
                            ) -> Tuple[List[bytes], int]:
    """DELTA_BYTE_ARRAY: shared-prefix lengths + suffix stream."""
    prefix, pos = decode_delta_binary_packed(data, pos, T_INT32)
    suffix_len, pos = decode_delta_binary_packed(data, pos, T_INT32)
    out: List[bytes] = []
    prev = b""
    for pl, sl in zip(prefix, suffix_len):
        pl, sl = int(pl), int(sl)
        prev = prev[:pl] + data[pos: pos + sl]
        pos += sl
        out.append(prev)
    return out, pos


def decode_byte_stream_split(data: bytes, pos: int, count: int,
                             phys: int, type_length: int) -> np.ndarray:
    """BYTE_STREAM_SPLIT: k byte streams of n bytes each, value i =
    bytes [stream0[i], stream1[i], ...]."""
    width = {T_FLOAT: 4, T_DOUBLE: 8, T_INT32: 4, T_INT64: 8,
             T_FLBA: type_length}.get(phys)
    if not width:
        raise Invalid(f"parquet_native: BYTE_STREAM_SPLIT on phys {phys}")
    raw = np.frombuffer(data, np.uint8, count * width, pos)
    interleaved = raw.reshape(width, count).T.copy()
    npdt = {T_FLOAT: np.float32, T_DOUBLE: np.float64,
            T_INT32: np.int32, T_INT64: np.int64}.get(phys)
    if npdt is not None:
        return interleaved.reshape(-1).view(npdt)
    return interleaved  # FLBA: [count, width] uint8


# ====================================================================
# reader
# ====================================================================

class _ColInfo:
    def __init__(self, name, phys, converted, optional, type_length,
                 scale, precision, max_def=None, max_rep=0,
                 logical=None):
        self.name = name
        self.phys = phys
        self.converted = converted
        self.optional = optional
        self.type_length = type_length
        self.scale = scale
        self.precision = precision
        self.max_def = (1 if optional else 0) if max_def is None \
            else max_def
        self.max_rep = max_rep
        self.logical = logical  # decoded SchemaElement.logicalType dict


class _Node:
    """Schema tree node for arbitrary-depth nested reconstruction.

    Reference: parquet/schema.cc FromParquet (tree build + level
    assignment) and parquet/arrow/path_internal.cc (the def/rep →
    offsets/validity reconstruction contract this assembler
    re-implements with numpy scans instead of the reference's
    per-path state machine).

    Level semantics (Dremel): `d` is the definition level at which the
    node itself is *present* (leaf value / struct defined / list
    non-null); for list/map nodes elements exist where dlv >= d + 1 and
    element boundaries are entries with rlv <= `r` (this node's
    repetition depth).
    """

    __slots__ = ("kind", "name", "d", "r", "optional", "children",
                 "ci", "chunk")

    def __init__(self, kind, name, d, r, optional, children=(),
                 ci=None, chunk=None):
        self.kind = kind          # "leaf" | "struct" | "list" | "map"
        self.name = name
        self.d = d
        self.r = r
        self.optional = optional
        self.children = list(children)
        self.ci = ci              # leaf only
        self.chunk = chunk        # leaf only: column-chunk index

    def first_chunk(self) -> int:
        n = self
        while n.kind != "leaf":
            n = n.children[0]
        return n.chunk

    def leaves(self):
        if self.kind == "leaf":
            yield self
        else:
            for c in self.children:
                yield from c.leaves()



def _leaf(e, max_def, max_rep):
    name = e[4].decode() if isinstance(e.get(4), bytes) else e.get(4)
    return _ColInfo(name, e.get(1), e.get(6), e.get(3, 0) == 1,
                    e.get(2, 0), e.get(7, 0), e.get(8, 0),
                    max_def=max_def, max_rep=max_rep,
                    logical=e.get(10))


def _name_of(e) -> str:
    return e[4].decode() if isinstance(e.get(4), bytes) else e.get(4)


# parquet.thrift ConvertedType group annotations
_CT_MAP, _CT_MAP_KEY_VALUE, _CT_LIST = 1, 2, 3


def _parse_node(elems, i, chunk, d, r):
    """Parse element `i` and its subtree, with `d`/`r` the cumulative
    def/rep level of all ancestors. Returns (node, i', chunk').

    Handles the LogicalTypes.md backward-compat rules: bare repeated
    fields/groups are one-level lists, a repeated LIST-mid group that is
    itself the element (multi-field, or named "array"/"*_tuple"), and
    legacy 2-level lists whose repeated mid is the element leaf."""
    e = elems[i]
    rep = e.get(3, 0)
    if rep == 2:
        # bare repeated field/group = list of its content; repeated
        # contributes one def and one rep level
        content, i2, c2 = _parse_content(elems, i, chunk, d + 1, r + 1,
                                         False)
        return (_Node("list", _name_of(e), d, r + 1, False, [content]),
                i2, c2)
    opt = rep == 1
    return _parse_content(elems, i, chunk, d + (1 if opt else 0), r, opt)


def _parse_content(elems, i, chunk, d, r, opt):
    """Parse element `i` ignoring its repetition (already applied by the
    caller); `d` includes this node's optional bit."""
    e = elems[i]
    nchild = e.get(5, 0)
    name = _name_of(e)
    ct = e.get(6)
    if nchild == 0:
        ci = _leaf(e, max_def=d, max_rep=r)
        return (_Node("leaf", name, d, r, opt, ci=ci, chunk=chunk),
                i + 1, chunk + 1)
    if ct == _CT_LIST:
        mid = elems[i + 1]
        if mid.get(3, 0) != 2:
            raise Invalid("parquet_native: LIST mid not repeated")
        mid_name = _name_of(mid) or ""
        mid_nchild = mid.get(5, 0)
        if mid_nchild == 0:
            # legacy 2-level: repeated mid IS the element leaf
            ci = _leaf(mid, max_def=d + 1, max_rep=r + 1)
            elem = _Node("leaf", mid_name, d + 1, r + 1, False, ci=ci,
                         chunk=chunk)
            i2, c2 = i + 2, chunk + 1
        elif (mid_nchild > 1 or mid_name == "array"
              or mid_name.endswith("_tuple")):
            # repeated group IS the element (a struct)
            children = []
            j, c2 = i + 2, chunk
            for _ in range(mid_nchild):
                ch, j, c2 = _parse_node(elems, j, c2, d + 1, r + 1)
                children.append(ch)
            elem = _Node("struct", mid_name, d + 1, r + 1, False,
                         children)
            i2 = j
        else:
            # standard 3-level encoding
            elem, i2, c2 = _parse_node(elems, i + 2, chunk, d + 1, r + 1)
        return _Node("list", name, d, r + 1, opt, [elem]), i2, c2
    if ct in (_CT_MAP, _CT_MAP_KEY_VALUE) and e.get(5, 0) == 1:
        kv = elems[i + 1]
        if kv.get(3, 0) != 2 or kv.get(5, 0) != 2:
            raise Invalid("parquet_native: non-standard MAP")
        key, j, c2 = _parse_node(elems, i + 2, chunk, d + 1, r + 1)
        val, j, c2 = _parse_node(elems, j, c2, d + 1, r + 1)
        entry = _Node("struct", _name_of(kv), d + 1, r + 1, False,
                      [key, val])
        return _Node("map", name, d, r + 1, opt, [entry]), j, c2
    # plain struct group
    children = []
    j = i + 1
    for _ in range(nchild):
        ch, j, chunk = _parse_node(elems, j, chunk, d, r)
        children.append(ch)
    return _Node("struct", name, d, r, opt, children), j, chunk


def _parse_schema(elems: List[Dict]) -> List[_Node]:
    """Schema tree walk (reference: parquet/schema.cc FromParquet)."""
    root = elems[0]
    out: List[_Node] = []
    i, chunk = 1, 0
    for _ in range(root.get(5, 0)):
        node, i, chunk = _parse_node(elems, i, chunk, 0, 0)
        out.append(node)
    return out


def _logical_dtype(ci: _ColInfo) -> dt.DataType:
    ct = ci.converted
    lt = ci.logical
    if lt:  # LogicalType union (parquet.thrift:320-366)
        if 8 in lt:  # TIMESTAMP
            ts = lt[8]
            unit_key = next(iter(ts.get(2, {2: {}})))  # TimeUnit tag
            unit = {1: "ms", 2: "us", 3: "ns"}.get(unit_key, "us")
            return dt.timestamp(unit, "UTC" if ts.get(1) else None)
        if 7 in lt:  # TIME
            unit_key = next(iter(lt[7].get(2, {2: {}})))
            if unit_key == 1:
                return dt.time32("ms")
            return dt.time64({2: "us", 3: "ns"}.get(unit_key, "us"))
        if 5 in lt:  # DECIMAL {1: scale, 2: precision}
            return dt.decimal128(lt[5].get(2, 38), lt[5].get(1, 0))
        if 6 in lt:  # DATE
            return dt.date32
        if 10 in lt:  # INTEGER {1: bitWidth, 2: isSigned}
            bw, signed = lt[10].get(1, 32), lt[10].get(2, True)
            return getattr(dt, ("int" if signed else "uint") + str(bw))
    if ci.phys == T_BOOLEAN:
        return dt.bool_
    if ci.phys == T_INT32:
        if ct == CT_DATE:
            return dt.date32
        if ct == CT_INT8:
            return dt.int8
        if ct == CT_INT16:
            return dt.int16
        if ct == CT_UINT8:
            return dt.uint8
        if ct == CT_UINT16:
            return dt.uint16
        if ct == CT_UINT32:
            return dt.uint32
        if ct == CT_TIME_MILLIS:
            return dt.time32("ms")
        return dt.int32
    if ci.phys == T_INT64:
        if ct == CT_TS_MILLIS:
            return dt.timestamp("ms")
        if ct == CT_TS_MICROS:
            return dt.timestamp("us")
        if ct == CT_TIME_MICROS:
            return dt.time64("us")
        if ct == CT_UINT64:
            return dt.uint64
        if ct == CT_DECIMAL:
            return dt.decimal128(ci.precision, ci.scale)
        return dt.int64
    if ci.phys == T_FLOAT:
        return dt.float32
    if ci.phys == T_DOUBLE:
        return dt.float64
    if ci.phys == T_BYTE_ARRAY:
        return dt.string if ct == CT_UTF8 else dt.binary
    raise Invalid(f"parquet_native: unsupported physical {ci.phys}")


def _plain_values(phys: int, data: bytes, count: int, pos: int = 0,
                  type_length: int = 0):
    """PLAIN decode -> (numpy values | list for byte_array | [count, w]
    uint8 for FLBA, new pos)."""
    if phys == T_BOOLEAN:
        raw = np.frombuffer(data, np.uint8, (count + 7) // 8, pos)
        return np.unpackbits(raw, bitorder="little", count=count
                             ).astype(bool), pos + (count + 7) // 8
    npdt = {T_INT32: np.int32, T_INT64: np.int64, T_FLOAT: np.float32,
            T_DOUBLE: np.float64}.get(phys)
    if npdt is not None:
        w = np.dtype(npdt).itemsize
        return np.frombuffer(data, npdt, count, pos), pos + count * w
    if phys == T_BYTE_ARRAY:
        return _plain_byte_arrays(data, count, pos)
    if phys == T_FLBA:
        w = type_length
        raw = np.frombuffer(data, np.uint8, count * w, pos)
        return raw.reshape(count, w).copy(), pos + count * w
    raise Invalid(f"parquet_native: PLAIN decode of physical {phys}")


def _bits_for(maxval: int) -> int:
    return max((maxval).bit_length(), 1) if maxval > 0 else 0


def _read_chunk_raw(buf: bytes, meta: Dict, ci: _ColInfo):
    """Page walk (reference column_reader.cc ColumnReader) ->
    (def_levels, rep_levels|None, compact values ndarray|list).
    Values carry only entries with def == max_def."""
    cm = meta[3]
    phys = cm[1]
    codec = cm[4]
    nvalues_total = cm[5]
    start = min(x for x in (cm.get(9), cm.get(11)) if x is not None)
    pos = start
    max_def, max_rep = ci.max_def, ci.max_rep
    dbw, rbw = _bits_for(max_def), _bits_for(max_rep)
    dictionary = None
    defs: List[np.ndarray] = []
    reps: List[np.ndarray] = []
    chunks: List = []
    seen = 0

    def decode_values(body, p, enc, ndef):
        if enc in (E_PLAIN_DICT, E_RLE_DICT):
            bw = body[p]
            idx = decode_rle_hybrid(body[p + 1:], bw, ndef)
            if dictionary is None:
                raise Invalid("parquet_native: dictionary-encoded page "
                              "without a dictionary page")
            if len(idx) and (idx.min() < 0 or idx.max() >= len(dictionary)):
                raise Invalid("parquet_native: dictionary index out of "
                              "range")
            return dictionary.take(idx) if isinstance(dictionary, _Strs) \
                else dictionary[idx]
        if enc == E_PLAIN:
            vals, _ = _plain_values(phys, body, ndef, p,
                                    type_length=ci.type_length)
            return vals
        if enc == E_RLE and phys == T_BOOLEAN:
            (lsize,) = struct.unpack_from("<I", body, p)
            return decode_rle_hybrid(body[p + 4: p + 4 + lsize], 1,
                                     ndef).astype(bool)
        if enc == E_DELTA_BINARY_PACKED and phys in (T_INT32, T_INT64):
            vals, _ = decode_delta_binary_packed(body, p, phys)
            return vals[:ndef]
        if enc == E_DELTA_LENGTH_BA and phys == T_BYTE_ARRAY:
            vals, _ = decode_delta_length_byte_array(body, p)
            return _Strs.of_list(vals[:ndef])
        if enc == E_DELTA_BA and phys == T_BYTE_ARRAY:
            vals, _ = decode_delta_byte_array(body, p)
            return _Strs.of_list(vals[:ndef])
        if enc == E_BYTE_STREAM_SPLIT:
            return decode_byte_stream_split(body, p, ndef, phys,
                                            ci.type_length)
        raise Invalid(f"parquet_native: a page encoded {enc} in a chunk "
                      f"of physical type {phys} whose footer lists "
                      f"{cm.get(2)}")

    while seen < nvalues_total:
        tr = TRead(buf, pos)
        ph = tr.read_struct()
        body_start = tr.pos
        ptype = ph[1]
        usize, csize = ph[2], ph[3]
        raw = buf[body_start: body_start + csize]
        pos = body_start + csize
        if ptype == P_DICT:
            page = _decompress(codec, raw, usize)
            dph = ph[7]
            dictionary, _ = _plain_values(phys, page, dph[1],
                                          type_length=ci.type_length)
            continue
        if ptype == P_DATA:
            page = _decompress(codec, raw, usize)
            dph = ph[5]
            nvals = dph[1]
            enc = dph[2]
            p = 0
            rlv = None
            if max_rep:  # v1 layout: rep levels first, then def levels
                (lsize,) = struct.unpack_from("<I", page, p)
                p += 4
                rlv = decode_rle_hybrid(page[p: p + lsize], rbw, nvals)
                p += lsize
            if max_def:
                (lsize,) = struct.unpack_from("<I", page, p)
                p += 4
                dlv = decode_rle_hybrid(page[p: p + lsize], dbw, nvals)
                p += lsize
            else:
                dlv = np.full(nvals, max_def, np.int32)
            ndef = int((dlv == max_def).sum())
            vals = decode_values(page, p, enc, ndef)
        elif ptype == P_DATA_V2:
            dph = ph[8]
            nvals, nnulls = dph[1], dph[2]
            enc = dph[4]
            dlen = dph[5]
            rlen = dph.get(6, 0)
            rlv = None
            if max_rep and rlen:
                rlv = decode_rle_hybrid(raw[:rlen], rbw, nvals)
            body = raw[rlen + dlen:]
            if dph.get(7, True):
                body = _decompress(codec, body, usize - rlen - dlen)
            if max_def and dlen:
                dlv = decode_rle_hybrid(raw[rlen: rlen + dlen], dbw,
                                        nvals)
            else:
                dlv = np.full(nvals, max_def, np.int32)
            ndef = int((dlv == max_def).sum())
            vals = decode_values(body, 0, enc, ndef)
        else:
            continue  # index page etc.
        defs.append(dlv)
        if max_rep:
            reps.append(rlv if rlv is not None
                        else np.zeros(len(dlv), np.int32))
        chunks.append(vals)
        seen += len(dlv)

    dlv = np.concatenate(defs) if defs else np.zeros(0, np.int32)
    rlv = (np.concatenate(reps) if reps else
           np.zeros(0, np.int32)) if max_rep else None
    return dlv, rlv, _concat_values(chunks, phys)


def _read_column_chunk(buf: bytes, meta: Dict, ci: _ColInfo,
                       num_rows: int):
    """Flat leaf -> (values aligned to rows, validity|None)."""
    dlv, _, vals = _read_chunk_raw(buf, meta, ci)
    valid = dlv == ci.max_def
    if valid.all():
        return vals, None
    if isinstance(vals, _Strs):
        codes = np.zeros(len(dlv), np.int64)
        codes[valid] = vals.codes
        return _Strs(vals.pool, codes), valid
    out = np.zeros((len(dlv),) + vals.shape[1:], vals.dtype)
    out[valid] = vals
    return out, valid


def _column_from_aligned(ci: _ColInfo, vals, valid: np.ndarray) -> Column:
    """Aligned values (and validity) -> a host-side Column for one
    leaf."""
    t = _logical_dtype(ci)
    validity = None if valid.all() else valid
    if ci.phys == T_BYTE_ARRAY:
        pool = vals.pool or [b""]
        uniq = np.empty(len(pool), object)
        try:
            uniq[:] = [v.decode("utf8") for v in pool] if t.kind in ("string", "large_string") \
                else pool
        except UnicodeDecodeError:
            raise Invalid("parquet_native: a UTF8 column holds invalid "
                          "UTF-8") from None
        return Column(vals.codes.astype(np.int32), t, validity=validity,
                      dictionary=Dictionary(uniq))
    if t.kind in ("uint32", "uint64"):
        # stored as same-width signed physical: reinterpret the bits
        vals = np.ascontiguousarray(vals).view(
            np.uint32 if t.kind == "uint32" else np.uint64)
    elif t.kind in ("uint8", "uint16"):
        vals = np.asarray(vals).astype(t.numpy_dtype())
    if t.kind == "decimal128":
        if vals.ndim == 2:  # FLBA: big-endian two's complement
            n, w = vals.shape
            sign = vals[:, 0] >= 128 if w else np.zeros(n, bool)
            full = np.where(sign[:, None], np.uint8(0xFF),
                            np.uint8(0)) * np.ones((n, 16), np.uint8)
            full[:, 16 - w:] = vals
            lo = full[:, 8:][:, ::-1].copy().view("<u8").reshape(n)
            hi = full[:, :8][:, ::-1].copy().view("<u8").reshape(n)
            return Column(lo.view(np.int64), t, validity=validity,
                          data2=hi.view(np.int64))
        return Column(vals.astype(np.int64), t, validity=validity,
                      data2=vals.astype(np.int64) >> 63)
    return Column(np.ascontiguousarray(vals).astype(t.numpy_dtype(),
                                                    copy=False), t,
                  validity=validity)


def _assemble_node(node: _Node, raw: Dict, slots: Dict):
    """Dremel record assembly: (def, rep) levels -> nested Columns.

    `raw` maps chunk index -> (dlv, rlv|None, compact values). `slots`
    maps chunk index -> entry positions holding this node's value slots
    in THAT leaf's entry space (record starts at the root, element
    starts below each repeated level). Entry spaces differ per leaf —
    a leaf under two lists has one entry per innermost element/marker
    while a repetition-free sibling has one per record — but the j-th
    slot refers to the same logical position in every leaf, so slot
    arrays under one node all have equal length.

    Reconstruction rules (Dremel; reference
    parquet/arrow/path_internal.cc, re-implemented with numpy scans
    instead of the per-path state machine):
      - leaf value present at a slot       <=> dlv[slot] == max_def
      - optional struct/list non-null      <=> dlv[slot] >= node.d
      - list element boundaries            <=> rlv <= k (k = node.r)
        and dlv >= node.d + 1; boundary entries failing the dlv test
        are this level's empty/null markers, not elements.
    """
    if node.kind == "leaf":
        dlv, _, vals = raw[node.chunk]
        sl = slots[node.chunk]
        present_e = dlv == node.ci.max_def
        present = present_e[sl]
        vidx = np.cumsum(present_e) - 1  # entry -> compact value index
        if isinstance(vals, _Strs):
            codes = np.zeros(len(sl), np.int64)
            codes[present] = vals.codes[vidx[sl[present]]]
            aligned = _Strs(vals.pool, codes)
        else:
            aligned = np.zeros(
                (len(sl),) + (vals.shape[1:] if len(vals) else ()),
                vals.dtype if len(vals) else np.int64)
            if present.any():
                aligned[present] = np.asarray(vals)[vidx[sl[present]]]
        return _column_from_aligned(node.ci, aligned, present)

    c0 = node.first_chunk()
    dlv0 = raw[c0][0]
    sl0 = slots[c0]

    if node.kind == "struct":
        children = [_assemble_node(c, raw, slots) for c in node.children]
        validity = None
        if node.optional:
            valid = dlv0[sl0] >= node.d
            if not valid.all():
                validity = valid
        names = tuple(c.name for c in node.children)
        fields = [(n, ch.dtype) for n, ch in zip(names, children)]
        return StructColumn(tuple(children), names, dt.struct(fields),
                            validity=validity)

    # list / map: k = repetition depth of elements, d+1 = non-empty
    k = node.r
    sub = {}
    for lf in node.leaves():
        dlv, rlv, _ = raw[lf.chunk]
        sub[lf.chunk] = np.flatnonzero((rlv <= k) & (dlv >= node.d + 1))
    elem0 = sub[c0]
    slot_id = np.searchsorted(sl0, elem0, side="right") - 1
    lengths = np.bincount(slot_id, minlength=len(sl0))
    offsets = np.zeros(len(sl0) + 1, np.int64)
    np.cumsum(lengths, out=offsets[1:])
    validity = None
    if node.optional:
        valid = dlv0[sl0] >= node.d
        if not valid.all():
            validity = valid
    if node.kind == "map":
        entry = node.children[0]
        key = _assemble_node(entry.children[0], raw, sub)
        val = _assemble_node(entry.children[1], raw, sub)
        child = RecordBatch((key, val), ("key", "value"))
        return ListColumn(offsets, child, dt.map_(key.dtype, val.dtype),
                          validity=validity)
    child = _assemble_node(node.children[0], raw, sub)
    return ListColumn(offsets, child, dt.list_(child.dtype),
                      validity=validity)


def parquet_row_group_count(buf: bytes) -> int:
    """Row-group count from the footer (streaming-read granularity)."""
    try:
        return len(_footer(buf)[4])
    except _CORRUPT as e:
        raise Invalid(f"parquet_native: corrupt footer ({e})") from None


def _bloom_hash_value(phys: int, value) -> Optional[int]:
    if phys == T_INT32:
        return _xxh64_bytes(struct.pack("<i", int(value)))
    if phys == T_INT64:
        return _xxh64_bytes(struct.pack("<q", int(value)))
    if phys == T_FLOAT:
        return _xxh64_bytes(struct.pack("<f", float(value)))
    if phys == T_DOUBLE:
        return _xxh64_bytes(struct.pack("<d", float(value)))
    if phys == T_BYTE_ARRAY:
        b = value.encode("utf8") if isinstance(value, str) \
            else bytes(value)
        return _xxh64_bytes(b)
    return None


def read_bloom_filters(buf: bytes):
    """-> {(row_group_idx, top_level_name): (phys, uint32 words)} for
    every column chunk carrying a bloom_filter_offset (field 14)."""
    fmeta = _footer(buf)
    out = {}
    for gi, rg in enumerate(fmeta[4]):
        for ch in rg[1]:
            cm = ch[3]
            off = cm.get(14)
            if off is None:
                continue
            tr = TRead(buf, off)
            hdr = tr.read_struct()
            nbytes = hdr[1]
            words = np.frombuffer(
                buf[tr.pos: tr.pos + nbytes], "<u4")
            path = cm[3]
            name = path[0].decode() if isinstance(path[0], bytes) \
                else path[0]
            out[(gi, name)] = (cm[1], words)
    return out


def bloom_prune_row_groups(buf: bytes, filters) -> Optional[List[int]]:
    """Row groups that can be SKIPPED-checked via bloom filters for a
    pyarrow-style DNF `filters` (list of (col, op, val) conjuncts, or a
    list of such lists OR-ed). Returns the surviving row-group index
    list, or None when no bloom applies (read everything). Reference:
    parquet/bloom_filter.h + row-group pruning in the arrow dataset
    scanner."""
    blooms = read_bloom_filters(buf)
    if not blooms:
        return None
    if filters and isinstance(filters[0], tuple):
        dnf = [list(filters)]
    else:
        dnf = [list(c) for c in filters]
    n_rg = parquet_row_group_count(buf)
    keep = []
    for gi in range(n_rg):
        branch_alive = False
        for conj in dnf:
            dead = False
            for (col, op, val) in conj:
                if op not in ("=", "=="):
                    continue
                ent = blooms.get((gi, col))
                if ent is None:
                    continue
                phys, words = ent
                h = _bloom_hash_value(phys, val)
                if h is not None and not _bloom_check(words, h):
                    dead = True
                    break
            if not dead:
                branch_alive = True
                break
        if branch_alive:
            keep.append(gi)
    return keep


def _decrypt_footer(buf: bytes, key: bytes):
    """PARE tail -> (plaintext FileMetaData dict, file_aad)."""
    (flen,) = struct.unpack_from("<I", buf, len(buf) - 8)
    start = len(buf) - 8 - flen
    tr = TRead(buf, start)
    fcm = tr.read_struct()
    algo = fcm.get(1, {}).get(1)
    if algo is None:
        raise Invalid("parquet_native: unsupported encryption "
                      "algorithm (only AES_GCM_V1)")
    file_aad = algo.get(1, b"") + algo.get(2, b"")
    plain, _ = _gcm_decrypt(key, _module_aad(file_aad, _MOD_FOOTER),
                            buf, tr.pos)
    return TRead(plain).read_struct(), file_aad


def _decrypt_chunk(buf: bytes, cm: Dict, key: bytes, file_aad: bytes,
                   rg: int, col: int) -> Tuple[bytes, Dict]:
    """Decrypt a column chunk's (header, page) module stream into a
    plaintext pseudo-chunk; -> (plain bytes, patched ColumnMetaData)."""
    pos = min(x for x in (cm.get(9), cm.get(11)) if x is not None)
    end = pos + cm[7]
    out = bytearray()
    page = 0
    while pos < end:
        hdr, pos = _gcm_decrypt(
            key, _module_aad(file_aad, _MOD_PAGE_HDR, rg, col, page),
            buf, pos)
        body, pos = _gcm_decrypt(
            key, _module_aad(file_aad, _MOD_PAGE, rg, col, page),
            buf, pos)
        out += hdr
        out += body
        page += 1
    cm2 = dict(cm)
    cm2[9] = 0
    cm2.pop(11, None)
    cm2[7] = len(out)
    return bytes(out), cm2


_CORRUPT = (struct.error, IndexError, ValueError, KeyError, TypeError,
            OverflowError, RecursionError, UnicodeDecodeError)


def read_parquet_native(buf: bytes, columns=None, row_groups=None,
                        decryption=None, device=None) -> RecordBatch:
    """A Parquet file's bytes as one RecordBatch on ``device`` (CUDA unless
    the caller names the CPU). `row_groups`: optional row-group index
    list, the streaming reader's unit (reference GetRecordBatchReader,
    parquet/arrow/reader.cc:257). decryption={"footer_key": bytes} reads
    AES_GCM_V1 encrypted-footer files (PARE magic). A layout the reader
    does not take raises ``UnsupportedLayout`` before any page is read;
    corrupt input raises ``Invalid``."""
    dev = resolve_device(device)
    try:
        batch = _read_host(buf, columns, row_groups, decryption)
    except A1TError:
        raise
    except _CORRUPT as e:
        raise Invalid(f"parquet_native: corrupt input ({type(e).__name__}:"
                      f" {e})") from None
    return _stage(batch, dev)


def _footer(buf) -> Dict:
    if len(buf) < 12 or buf[:4] != MAGIC or buf[-4:] != MAGIC:
        raise Invalid("parquet_native: bad magic")
    (flen,) = struct.unpack_from("<I", buf, len(buf) - 8)
    if flen > len(buf) - 12:
        raise Invalid("parquet_native: bad footer length")
    return TRead(buf[len(buf) - 8 - flen: len(buf) - 8]).read_struct()


def _check_supported(schema: List["_Node"], row_groups) -> None:
    """``UnsupportedLayout`` for what the reader does not take, from the
    footer alone: a codec other than none, snappy, gzip and zstd, an
    encoding outside ``_DECODED`` for its physical type, and a column
    type without a port type."""
    for rg in row_groups:
        for ch in rg[1]:
            cm = ch[3]
            if cm[4] not in _CODECS:
                raise UnsupportedLayout(f"parquet_native: codec {cm[4]}")
            for enc in cm.get(2, ()):
                if enc not in _DECODED or (_DECODED[enc] is not None and
                                           cm[1] not in _DECODED[enc]):
                    raise UnsupportedLayout(
                        f"parquet_native: encoding {enc} of physical "
                        f"type {cm[1]}")
    for node in schema:
        for lf in node.leaves():
            try:
                t = _logical_dtype(lf.ci)
            except Invalid as e:
                raise UnsupportedLayout(str(e)) from None
            if lf.ci.phys == T_FLBA and not (t.kind == "decimal128" and
                                              lf.ci.type_length <= 16):
                raise UnsupportedLayout("parquet_native: a fixed-length "
                                        f"byte array of {t!r}")


def _file_meta(buf, columns, row_groups, decryption):
    """The footer's schema and the row groups and columns to read, after
    ``_check_supported`` over them."""
    crypt = None
    if buf[:4] == MAGIC_E or buf[-4:] == MAGIC_E:
        key = (decryption or {}).get("footer_key")
        if not key:
            raise Invalid("parquet_native: encrypted file (PARE) "
                          "requires decryption={'footer_key': ...}")
        fmeta, file_aad = _decrypt_footer(buf, key)
        crypt = (key, file_aad)
    else:
        fmeta = _footer(buf)
    schema = _parse_schema(fmeta[2])
    rg_indices = (range(len(fmeta[4])) if row_groups is None
                  else list(row_groups))
    row_groups = [fmeta[4][i] for i in rg_indices]
    num_rows = sum(rg.get(3, 0) for rg in row_groups)
    by_name = {oc.name: oc for oc in schema}
    want = columns if columns is not None else [oc.name for oc in schema]
    missing = [c for c in want if c not in by_name]
    if missing:
        raise KeyError_(f"parquet_native: no column named "
                        f"{missing[0]!r}")
    _check_supported([by_name[c] for c in want], row_groups)
    return crypt, rg_indices, row_groups, num_rows, by_name, want


def native_row_groups(buf: bytes, columns=None) -> int:
    """The file's row-group count, after the footer check that
    ``read_parquet_native`` makes: ``UnsupportedLayout`` where it would
    decline any row group, ``Invalid`` for a corrupt footer."""
    try:
        return len(_file_meta(buf, columns, None, None)[1])
    except A1TError:
        raise
    except _CORRUPT as e:
        raise Invalid(f"parquet_native: corrupt footer ({e})") from None


def _read_host(buf, columns, row_groups, decryption) -> RecordBatch:
    crypt, rg_indices, row_groups, num_rows, by_name, want = _file_meta(
        buf, columns, row_groups, decryption)
    cols_out, names = [], []

    def chunk_view(rg_pos, chunk_idx):
        """-> (buffer, chunk meta) — decrypted pseudo-chunk when the
        file is encrypted (reference: per-module AAD discipline)."""
        ch = row_groups[rg_pos][1][chunk_idx]
        if crypt is None:
            return buf, ch
        key, file_aad = crypt
        plain, cm2 = _decrypt_chunk(buf, ch[3], key, file_aad,
                                    rg_indices[rg_pos], chunk_idx)
        ch2 = dict(ch)
        ch2[3] = cm2
        return plain, ch2

    def read_leaf_raw(chunk_idx, ci):
        ds, rs, vs = [], [], []
        for gi in range(len(row_groups)):
            dlv, rlv, vals = _read_chunk_raw(*chunk_view(gi, chunk_idx), ci)
            ds.append(dlv)
            if rlv is not None:
                rs.append(rlv)
            vs.append(vals)
        dlv = np.concatenate(ds) if ds else np.zeros(0, np.int32)
        rlv = np.concatenate(rs) if rs else (
            np.zeros(0, np.int32) if ci.max_rep else None)
        return dlv, rlv, _concat_values(vs, ci.phys)

    for name in want:
        node = by_name[name]
        if node.kind == "leaf" and node.ci.max_rep == 0:
            # flat fast path: values are already slot-aligned
            ci = node.ci
            parts, validparts = [], []
            for gi, rg in enumerate(row_groups):
                vals, valid = _read_column_chunk(
                    *chunk_view(gi, node.chunk), ci, rg.get(3, 0))
                parts.append(vals)
                validparts.append(valid if valid is not None
                                  else np.ones(len(vals), bool))
            col = _column_from_aligned(
                ci, _concat_values(parts, ci.phys),
                np.concatenate(validparts) if validparts
                else np.zeros(0, bool))
        else:
            raw = {lf.chunk: read_leaf_raw(lf.chunk, lf.ci)
                   for lf in node.leaves()}
            slots = {}
            for lf in node.leaves():
                rlv = raw[lf.chunk][1]
                slots[lf.chunk] = (
                    np.flatnonzero(rlv == 0) if rlv is not None
                    else np.arange(num_rows, dtype=np.int64))
            col = _assemble_node(node, raw, slots)
        cols_out.append(col)
        names.append(name)
    return RecordBatch(tuple(cols_out), tuple(names))


# ====================================================================
# writer
# ====================================================================

def _snappy_literal(data: bytes) -> bytes:
    """Valid snappy framing with literal elements only (no matching) —
    format-conformant output any snappy reader accepts."""
    out = bytearray()
    v = len(data)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            break
    pos = 0
    while pos < len(data):
        n = min(len(data) - pos, 1 << 16)
        out.append(61 << 2)  # literal tag, 2 extra length bytes
        out += struct.pack("<H", n - 1)
        out += data[pos: pos + n]
        pos += n
    return bytes(out)


def _compress(codec: int, data: bytes) -> bytes:
    if codec == C_UNCOMPRESSED:
        return data
    if codec == C_SNAPPY:
        return _snappy_literal(data)
    if codec == C_GZIP:
        co = zlib.compressobj(6, zlib.DEFLATED, 31)
        return co.compress(data) + co.flush()
    if codec == C_ZSTD:
        return _zstandard().ZstdCompressor().compress(data)
    raise UnsupportedLayout(f"parquet_native write: codec {codec}")


def _ts_logical(t: dt.DataType):
    """SchemaElement.logicalType thrift fields for a timestamp
    (parquet.thrift TimestampType; isAdjustedToUTC=false for naive —
    converted TIMESTAMP_* alone would read back as UTC-adjusted)."""
    unit_tag = {"ms": 1, "us": 2, "ns": 3}[t.unit]
    return (10, CT_STRUCT, [
        (8, CT_STRUCT, [(1, CT_TRUE, bool(t.tz)),
                        (2, CT_STRUCT, [(unit_tag, CT_STRUCT, [])])])])


def _phys_for(t: dt.DataType):
    """-> (physical, converted_or_None, logical_field_or_None)."""
    k = t.kind
    if k == "bool":
        return T_BOOLEAN, None, None
    if k in ("int8", "int16"):
        return T_INT32, CT_INT8 if k == "int8" else CT_INT16, None
    if k == "int32":
        return T_INT32, None, None
    if k in ("uint8", "uint16", "uint32"):
        return T_INT32, {"uint8": CT_UINT8, "uint16": CT_UINT16,
                         "uint32": CT_UINT32}[k], None
    if k == "int64":
        return T_INT64, None, None
    if k == "uint64":
        return T_INT64, CT_UINT64, None
    if k == "float32":
        return T_FLOAT, None, None
    if k == "float64":
        return T_DOUBLE, None, None
    if k == "date32":
        return T_INT32, CT_DATE, None
    if k == "timestamp" and t.unit in ("ms", "us", "ns"):
        # converted only when UTC-adjusted (the legacy tags imply it)
        ct = (None if not t.tz or t.unit == "ns" else
              CT_TS_MILLIS if t.unit == "ms" else CT_TS_MICROS)
        return T_INT64, ct, _ts_logical(t)
    if k in ("string", "large_string"):
        return T_BYTE_ARRAY, CT_UTF8, None
    if k in ("binary", "large_binary"):
        return T_BYTE_ARRAY, None, None
    raise UnsupportedLayout(f"parquet_native write: unsupported type {t}")


# ---------------------------------------------------------------------
# modular encryption (reference: parquet/encryption/
# encryption_internal.h:46 AesEncryptor + encryption_internal.cc
# CreateModuleAad; format spec Encryption.md). AES_GCM_V1, encrypted
# footer mode, footer key for all modules. Module framing:
# [u32 LE size=12+ct+16][nonce 12][ciphertext||tag 16]. AAD =
# file_aad + type byte (+ rg/col/page i16 LE ordinals per type).
# ---------------------------------------------------------------------

MAGIC_E = b"PARE"
_MOD_FOOTER, _MOD_CMETA, _MOD_PAGE, _MOD_DICT_PAGE, _MOD_PAGE_HDR, \
    _MOD_DICT_HDR = 0, 1, 2, 3, 4, 5


def _module_aad(file_aad: bytes, mtype: int, rg: int = -1,
                col: int = -1, page: int = -1) -> bytes:
    out = file_aad + bytes([mtype])
    if mtype == _MOD_FOOTER:
        return out
    out += struct.pack("<hh", rg, col)
    if mtype in (_MOD_PAGE, _MOD_PAGE_HDR):
        out += struct.pack("<h", page)
    return out


def _gcm_encrypt(key: bytes, aad: bytes, plain: bytes) -> bytes:
    import os as _os

    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    nonce = _os.urandom(12)
    ct = AESGCM(key).encrypt(nonce, plain, aad)  # ciphertext || tag
    return struct.pack("<I", 12 + len(ct)) + nonce + ct


def _gcm_decrypt(key: bytes, aad: bytes, buf: bytes, pos: int
                 ) -> Tuple[bytes, int]:
    """Decrypt the module at `pos`; -> (plaintext, end position)."""
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    (size,) = struct.unpack_from("<I", buf, pos)
    nonce = buf[pos + 4: pos + 16]
    ct = buf[pos + 16: pos + 4 + size]
    try:
        plain = AESGCM(key).decrypt(nonce, ct, aad)
    except Exception as e:
        raise Invalid(f"parquet_native: module decryption failed "
                      f"(wrong key or tampered file): {e}") from e
    return plain, pos + 4 + size


# ---------------------------------------------------------------------
# split-block bloom filters (reference: parquet/bloom_filter.h:35,120
# BlockSplitBloomFilter; format spec BloomFilter.md). Hash = XXH64 of
# the PLAIN-encoded value, seed 0; 32-byte blocks of 8 words; word i
# checks bit (key * SALT[i]) >> 27.
# ---------------------------------------------------------------------

_BLOOM_SALT = np.array([0x47b6137b, 0x44974d91, 0x8824ad5b, 0xa2b7289d,
                        0x705495c7, 0x2df1424b, 0x9efc4947, 0x5c6bfb31],
                       np.uint64)
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl64(x, r):
    return ((x << np.uint64(r)) | (x >> np.uint64(64 - r)))


def _xxh64_fixed(vals: np.ndarray, nbytes: int) -> np.ndarray:
    """Vectorized XXH64(seed=0) of little-endian fixed-width values
    (4 or 8 bytes) — the short-input path (len < 32)."""
    with np.errstate(over="ignore"):
        h = np.full(len(vals), (_P5 + nbytes) & _M64, np.uint64)
        if nbytes == 8:
            v = vals.astype(np.uint64)
            k = _rotl64(v * np.uint64(_P2), 31) * np.uint64(_P1)
            h ^= k
            h = _rotl64(h, 27) * np.uint64(_P1) + np.uint64(_P4)
        else:
            v = vals.astype(np.uint64) & np.uint64(0xFFFFFFFF)
            h ^= v * np.uint64(_P1)
            h = _rotl64(h, 23) * np.uint64(_P2) + np.uint64(_P3)
        h ^= h >> np.uint64(33)
        h *= np.uint64(_P2)
        h ^= h >> np.uint64(29)
        h *= np.uint64(_P3)
        h ^= h >> np.uint64(32)
        return h


def _xxh64_bytes(data: bytes) -> int:
    """Scalar XXH64(seed=0) for arbitrary-length input (strings)."""
    n = len(data)
    i = 0
    if n >= 32:
        v1 = (_P1 + _P2) & _M64
        v2 = _P2
        v3 = 0
        v4 = (-_P1) & _M64

        def rnd(acc, lane):
            acc = (acc + lane * _P2) & _M64
            acc = ((acc << 31) | (acc >> 33)) & _M64
            return (acc * _P1) & _M64

        while i + 32 <= n:
            v1 = rnd(v1, int.from_bytes(data[i:i + 8], "little"))
            v2 = rnd(v2, int.from_bytes(data[i + 8:i + 16], "little"))
            v3 = rnd(v3, int.from_bytes(data[i + 16:i + 24], "little"))
            v4 = rnd(v4, int.from_bytes(data[i + 24:i + 32], "little"))
            i += 32
        h = (((v1 << 1) | (v1 >> 63)) + ((v2 << 7) | (v2 >> 57))
             + ((v3 << 12) | (v3 >> 52)) + ((v4 << 18) | (v4 >> 46))) \
            & _M64
        for v in (v1, v2, v3, v4):
            h = (h ^ rnd(0, v)) & _M64
            h = (h * _P1 + _P4) & _M64
    else:
        h = _P5
    h = (h + n) & _M64
    while i + 8 <= n:
        k = (int.from_bytes(data[i:i + 8], "little") * _P2) & _M64
        k = ((k << 31) | (k >> 33)) & _M64
        k = (k * _P1) & _M64
        h ^= k
        h = ((((h << 27) | (h >> 37)) & _M64) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i:i + 4], "little") * _P1) & _M64
        h = ((((h << 23) | (h >> 41)) * _P2) + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = ((((h << 11) | (h >> 53)) * _P1)) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


def _bloom_build(hashes: np.ndarray, ndv: int) -> np.ndarray:
    """-> uint32 word array (num_blocks * 8), sized for ~1% fpp."""
    bits = max(int(ndv) * 11, 256)
    nbytes = 1 << max(5, (bits // 8 - 1).bit_length())
    nblocks = nbytes // 32
    words = np.zeros(nblocks * 8, np.uint32)
    with np.errstate(over="ignore"):
        block = ((hashes >> np.uint64(32))
                 * np.uint64(nblocks)) >> np.uint64(32)
        key = (hashes & np.uint64(0xFFFFFFFF))
        for j in range(8):
            bit = ((key * _BLOOM_SALT[j]) & np.uint64(0xFFFFFFFF)) \
                >> np.uint64(27)
            np.bitwise_or.at(words, block.astype(np.int64) * 8 + j,
                             np.uint32(1) << bit.astype(np.uint32))
    return words


def _bloom_check(words: np.ndarray, h: int) -> bool:
    nblocks = len(words) // 8
    block = ((h >> 32) * nblocks) >> 32
    key = h & 0xFFFFFFFF
    for j in range(8):
        bit = ((key * int(_BLOOM_SALT[j])) & 0xFFFFFFFF) >> 27
        if not (int(words[block * 8 + j]) >> bit) & 1:
            return False
    return True


def _bloom_hash_column(phys: int, col: Column, sel: np.ndarray):
    """Hashes of the selected values, or None if unsupported."""
    data = np.asarray(col.data)[sel]
    if phys == T_INT32:
        return _xxh64_fixed(data.astype(np.int64).astype(np.uint64)
                            & np.uint64(0xFFFFFFFF), 4)
    if phys == T_INT64:
        return _xxh64_fixed(data.astype(np.int64).view(np.uint64), 8)
    if phys == T_FLOAT:
        return _xxh64_fixed(
            data.astype("<f4").view(np.uint32).astype(np.uint64), 4)
    if phys == T_DOUBLE:
        return _xxh64_fixed(data.astype("<f8").view(np.uint64), 8)
    if phys == T_BYTE_ARRAY and col.dictionary is not None:
        used = np.unique(data)
        vals = col.dictionary.values
        out = []
        for u in used:
            v = vals[int(u)]
            b = v.encode("utf8") if isinstance(v, str) else bytes(v)
            out.append(_xxh64_bytes(b))
        return np.array(out, np.uint64)
    return None


def _uvarint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _zigzag(v: int) -> int:
    return (v << 1) ^ (v >> 63)


def _bitpack_le(vals: np.ndarray, w: int) -> bytes:
    """Pack uint64 values LE at bit-width w (parquet bit-packing
    convention, encoding.md): value i occupies bits [i*w, (i+1)*w)."""
    if w == 0:
        return b""
    bits = ((vals[:, None] >> np.arange(w, dtype=np.uint64)) & 1
            ).astype(np.uint8).reshape(-1)
    return np.packbits(bits, bitorder="little").tobytes()


def _delta_bp_encode(vals: np.ndarray, width: int = 64) -> bytes:
    """DELTA_BINARY_PACKED encoder (parquet/encoding.cc DeltaBitPack,
    format spec encodings.md): header <block=128><miniblocks=4>
    <count><first zigzag>, then per block a zigzag min-delta, 4
    miniblock bit-widths, and 32-value LE-bitpacked miniblocks.
    width=32 computes deltas with 32-bit wraparound (INT32 physical —
    miniblock widths must stay <= 32)."""
    v = np.asarray(vals, np.int64)
    n = len(v)
    out = bytearray()
    out += _uvarint(128) + _uvarint(4) + _uvarint(n)
    out += _uvarint(_zigzag(int(v[0])) & ((1 << 64) - 1)
                    ) if n else _uvarint(0)
    if n <= 1:
        return bytes(out)
    sdt = np.int32 if width == 32 else np.int64
    udt = np.uint32 if width == 32 else np.uint64
    with np.errstate(over="ignore"):
        deltas = (v[1:].astype(udt) - v[:-1].astype(udt)).astype(sdt)
    pos = 0
    while pos < len(deltas):
        blk = deltas[pos:pos + 128]
        pos += 128
        mind = int(blk.min())
        out += _uvarint(_zigzag(mind) & ((1 << 64) - 1))
        with np.errstate(over="ignore"):
            rel = (blk.astype(udt)
                   - udt(mind & ((1 << width) - 1))).astype(np.uint64)
        if len(rel) < 128:
            rel = np.concatenate(
                [rel, np.zeros(128 - len(rel), np.uint64)])
        widths = []
        packed = []
        for m in range(4):
            mb = rel[m * 32:(m + 1) * 32]
            mx = int(mb.max())
            w = 0 if mx == 0 else int(mx).bit_length()
            widths.append(w)
            packed.append(_bitpack_le(mb, w))
        out += bytes(widths)
        for p in packed:
            out += p
    return bytes(out)


def _plain_encode(phys: int, col: Column, valid: np.ndarray) -> Tuple[
        bytes, int]:
    """PLAIN-encode the valid values; -> (bytes, num_valid)."""
    if phys == T_BYTE_ARRAY:
        codes = np.asarray(col.data)[valid]
        values = col.dictionary.values
        enc = [v.encode("utf8") if isinstance(v, str) else bytes(v)
               for v in values]
        lens = np.array([len(e) for e in enc], np.int64)
        u_starts = np.zeros(len(enc) + 1, np.int64)
        np.cumsum(lens, out=u_starts[1:])
        cap = int(lens[codes].sum()) + 4 * len(codes)
        from ..native import plain_byte_array

        return plain_byte_array(codes.astype(np.int64), u_starts,
                                np.frombuffer(b"".join(enc), np.uint8),
                                None, cap), len(codes)
    data = np.asarray(col.data)[valid]
    if phys == T_BOOLEAN:
        return np.packbits(np.asarray(data, bool),
                           bitorder="little").tobytes(), len(data)
    npdt = {T_INT32: "<i4", T_INT64: "<i8", T_FLOAT: "<f4",
            T_DOUBLE: "<f8"}[phys]
    return np.ascontiguousarray(data).astype(npdt).tobytes(), len(data)


def _dremel_leaves(col, name: str, idx, rep, defl, present,
                   max_def: int, max_rep: int, depth: int):
    """Recursive Dremel level computation — the write-side inverse of
    the reader's _assemble_node (reference: write path of
    parquet/arrow/path_internal.cc). Walks a column tree carrying one
    ENTRY per (rep, def) pair to emit:

      idx      int64[e]  row index into this column (valid only where
                         `present`)
      rep      int64[e]  repetition level of the entry
      defl     int64[e]  definition level accumulated so far
      present  bool[e]   entry still carries a live value (False once
                         an ancestor was null / an empty list)

    Returns (schema_elems, leaves) where each leaf is a dict with the
    page inputs: path, phys/ct/lt, rep/def arrays, the leaf Column,
    its value-selection index array, and the level bit-widths."""
    if isinstance(col, ListColumn):
        if col.dtype.kind != "list":
            raise UnsupportedLayout(f"parquet_native write: {col.dtype!r}")
        offsets = np.asarray(col.offsets)
        lengths = np.diff(offsets)
        row_valid = (np.ones(len(lengths), bool) if col.validity is None
                     else np.asarray(col.validity))
        e = len(idx)
        safe_idx = np.where(present, idx, 0)
        lv = row_valid[safe_idx] & present
        ln = np.where(lv, lengths[safe_idx], 0)
        entries = np.maximum(ln, 1)
        total = int(entries.sum())
        starts = np.zeros(e, np.int64)
        np.cumsum(entries[:-1], out=starts[1:])
        src = np.repeat(np.arange(e), entries)
        within = np.arange(total, dtype=np.int64) - starts[src]
        first = within == 0
        new_rep = np.where(first, rep[src], max_rep + 1)
        has_elems = np.repeat(ln > 0, entries)
        new_present = has_elems  # null/empty lists terminate here
        new_defl = np.where(
            has_elems, defl[src] + 2,
            np.where(lv[src], defl[src] + 1, defl[src]))
        new_idx = np.where(has_elems,
                           offsets[safe_idx[src]] + within, 0)
        sub_schema, leaves = _dremel_leaves(
            col.values, "element", new_idx, new_rep, new_defl,
            new_present, max_def + 2, max_rep + 1, depth + 1)
        e_list = [(3, CT_I32, 1), (4, CT_BINARY, name),
                  (5, CT_I32, 1), (6, CT_I32, 3)]
        e_mid = [(3, CT_I32, 2), (4, CT_BINARY, "list"), (5, CT_I32, 1)]
        for lf in leaves:
            lf["path"] = [name, "list"] + lf["path"]
        return [e_list, e_mid] + sub_schema, leaves

    if isinstance(col, StructColumn):
        sv = (np.ones(col.length, bool) if col.validity is None
              else np.asarray(col.validity))
        safe_idx = np.where(present, idx, 0)
        ok = sv[safe_idx] & present
        new_defl = defl + ok
        e_grp = [(3, CT_I32, 1), (4, CT_BINARY, name),
                 (5, CT_I32, len(col.names))]
        schema = [e_grp]
        leaves = []
        for fname, child in zip(col.names, col.children):
            sub_schema, sub_leaves = _dremel_leaves(
                child, fname, idx, rep, new_defl, ok,
                max_def + 1, max_rep, depth + 1)
            for lf in sub_leaves:
                lf["path"] = [name] + lf["path"]
            schema += sub_schema
            leaves += sub_leaves
        return schema, leaves

    if not isinstance(col, Column):
        raise UnsupportedLayout("parquet_native write: unsupported column "
                                f"{name!r}")
    phys, ct, lt = _phys_for(col.dtype)
    optional = depth > 0 or col.validity is not None
    lvalid = (np.ones(col.length, bool) if col.validity is None
              else np.asarray(col.validity))
    safe_idx = np.where(present, idx, 0)
    vmask = lvalid[safe_idx] & present
    dlv = defl + (vmask if optional else 0)
    keep_idx = idx[vmask]
    if len(keep_idx) > 1 and not np.all(np.diff(keep_idx) > 0):
        raise UnsupportedLayout("parquet_native write: non-monotone "
                                "child storage")
    e_leaf = [(1, CT_I32, phys), (3, CT_I32, 1 if optional else 0),
              (4, CT_BINARY, name)]
    if ct is not None:
        e_leaf.append((6, CT_I32, ct))
    if lt is not None:
        e_leaf.append(lt)
    leaf = {"path": [name], "phys": phys, "col": col,
            "keep_idx": keep_idx, "rep": rep, "def": dlv,
            "max_def": max_def + (1 if optional else 0),
            "max_rep": max_rep}
    return [e_leaf], [leaf]


def write_parquet_native(batch: RecordBatch, sink,
                         compression: str = "snappy",
                         use_byte_stream_split: bool = False,
                         use_delta_binary_packed: bool = False,
                         row_group_size: Optional[int] = None,
                         bloom_filter_columns=None,
                         encryption: Optional[Dict] = None) -> None:
    """v1 data pages, ARBITRARY nesting depth (recursive Dremel level
    writer, _dremel_leaves), one or more row groups (row_group_size).
    Value encodings: PLAIN everywhere, plus opt-in BYTE_STREAM_SPLIT
    (float/double) and DELTA_BINARY_PACKED (int32/int64) — reference
    write side: parquet/encoding.cc ByteStreamSplitEncoder /
    DeltaBitPackEncoder. bloom_filter_columns (True or a list of
    top-level names) writes split-block bloom filters per chunk
    (parquet/bloom_filter.h:120). encryption={"footer_key": 16/24/32
    bytes} writes AES_GCM_V1 modular encryption in encrypted-footer
    mode (parquet/encryption/encryption_internal.h:46): page headers,
    pages, and the footer each become GCM modules with the spec's AAD
    discipline; the file magic becomes PARE."""
    import os as _os

    codecs = {"none": C_UNCOMPRESSED, None: C_UNCOMPRESSED,
              "snappy": C_SNAPPY, "gzip": C_GZIP, "zstd": C_ZSTD}
    if compression not in codecs:
        raise UnsupportedLayout(f"parquet_native write: codec "
                                f"{compression!r}")
    codec = codecs[compression]
    batch = map_tensors(batch, lambda t: t.cpu().numpy())
    fkey = encryption.get("footer_key") if encryption else None
    file_aad = _os.urandom(8) if fkey else b""
    if fkey and bloom_filter_columns:
        raise Invalid("parquet_native write: bloom filters with "
                      "encryption not supported (pyarrow fallback)")
    n = batch.num_rows
    sink.write(MAGIC_E if fkey else MAGIC)
    state = {"offset": 4, "rg": 0, "col": 0}
    col_metas = []

    def emit_leaf(path, phys, body_len: int, page: bytes, nlevels,
                  enc=E_PLAIN):
        tw = TWrite()
        dph = [(1, CT_I32, nlevels), (2, CT_I32, enc),
               (3, CT_I32, E_RLE), (4, CT_I32, E_RLE)]
        tw.write_struct([(1, CT_I32, P_DATA), (2, CT_I32, body_len),
                         (3, CT_I32, len(page)), (5, CT_STRUCT, dph)])
        header = bytes(tw.out)
        page_off = state["offset"]
        if fkey:
            rg, col = state["rg"], state["col"]
            header = _gcm_encrypt(
                fkey, _module_aad(file_aad, _MOD_PAGE_HDR, rg, col, 0),
                header)
            page = _gcm_encrypt(
                fkey, _module_aad(file_aad, _MOD_PAGE, rg, col, 0),
                page)
        sink.write(header)
        sink.write(page)
        state["offset"] += len(header) + len(page)
        state["col"] += 1
        cm = [(1, CT_I32, phys),
              (2, CT_LIST, (CT_I32, [enc, E_RLE])),
              (3, CT_LIST, (CT_BINARY, list(path))),
              (4, CT_I32, codec),
              (5, CT_I64, nlevels),
              (6, CT_I64, len(header) + len(page) if fkey
               else len(header) + body_len),
              (7, CT_I64, len(header) + len(page)),
              (9, CT_I64, page_off)]
        col_metas.append((path, phys, cm))

    def rle_block(levels, bw):
        lv = encode_rle_hybrid(np.asarray(levels, np.int64), bw)
        return struct.pack("<I", len(lv)) + lv

    def encode_leaf(lf) -> dict:
        """One leaf's page body (levels and values), compressed, and its
        bloom filter's bitset."""
        leaf_col = lf["col"]
        body = bytearray()
        if lf["max_rep"]:
            body += rle_block(lf["rep"], _bits_for(lf["max_rep"]))
        if lf["max_def"]:
            body += rle_block(lf["def"], _bits_for(lf["max_def"]))
        sel = np.zeros(leaf_col.length, bool)
        sel[lf["keep_idx"]] = True
        enc = E_PLAIN
        if use_byte_stream_split and lf["phys"] in (T_FLOAT, T_DOUBLE):
            w = 4 if lf["phys"] == T_FLOAT else 8
            npdt = "<f4" if lf["phys"] == T_FLOAT else "<f8"
            vals = np.ascontiguousarray(
                np.asarray(leaf_col.data)[sel]).astype(npdt)
            values = vals.view(np.uint8).reshape(-1, w).T.tobytes()
            enc = E_BYTE_STREAM_SPLIT
        elif use_delta_binary_packed and lf["phys"] in (T_INT32, T_INT64):
            vals = np.asarray(leaf_col.data)[sel]
            values = _delta_bp_encode(
                vals, 32 if lf["phys"] == T_INT32 else 64)
            enc = E_DELTA_BINARY_PACKED
        else:
            values, _ = _plain_encode(lf["phys"], leaf_col, sel)
        body += values
        bitset = None
        # split-block bloom filter (BloomFilter.md): header + bitset
        # written after the pages, offset in field 14
        if bloom_filter_columns and (bloom_filter_columns is True
                                     or lf["path"][0] in
                                     bloom_filter_columns):
            hashes = _bloom_hash_column(lf["phys"], leaf_col, sel)
            if hashes is not None and len(hashes):
                bitset = _bloom_build(hashes, len(hashes)).astype(
                    "<u4").tobytes()
        return dict(path=lf["path"], phys=lf["phys"], body_len=len(body),
                    page=_compress(codec, bytes(body)),
                    nlevels=len(lf["def"]), enc=enc, bitset=bitset)

    def encode_group(rg_start):
        """A row group's schema elements and encoded leaves."""
        chunk = batch.slice(rg_start, min(rg_size, n - rg_start)) \
            if (rg_start or rg_size < n) else batch
        rn = chunk.num_rows
        elems = [None]  # root patched at the end
        base_idx = np.arange(rn, dtype=np.int64)
        base_rep = np.zeros(rn, np.int64)
        base_def = np.zeros(rn, np.int64)
        base_present = np.ones(rn, bool)
        encoded = []
        for name in chunk.names:
            sub_schema, leaves = _dremel_leaves(
                chunk.column(name), name, base_idx, base_rep, base_def,
                base_present, 0, 0, 0)
            elems += sub_schema
            encoded += [encode_leaf(lf) for lf in leaves]
        return rn, elems, encoded

    rgs = []
    schema_elems = None
    rg_size = max(row_group_size or n, 1)
    for rn, elems, encoded in map(encode_group,
                                  range(0, max(n, 1), rg_size)):
        col_metas.clear()
        state["rg"] = len(rgs)
        state["col"] = 0
        rg_start_off = state["offset"]
        for leaf in encoded:
            emit_leaf(leaf["path"], leaf["phys"], leaf["body_len"],
                      leaf["page"], leaf["nlevels"], leaf["enc"])
            if leaf["bitset"] is not None:
                tw = TWrite()
                tw.write_struct([
                    (1, CT_I32, len(leaf["bitset"])),
                    (2, CT_STRUCT, [(1, CT_STRUCT, [])]),
                    (3, CT_STRUCT, [(1, CT_STRUCT, [])]),
                    (4, CT_STRUCT, [(1, CT_STRUCT, [])])])
                hdr = bytes(tw.out)
                col_metas[-1][2].append((14, CT_I64, state["offset"]))
                sink.write(hdr)
                sink.write(leaf["bitset"])
                state["offset"] += len(hdr) + len(leaf["bitset"])
        if schema_elems is None:
            elems[0] = [(4, CT_BINARY, "schema"),
                        (5, CT_I32, len(batch.names))]
            schema_elems = elems
        chunks = []
        for _path, phys, cm in col_metas:
            chunks.append([(2, CT_I64, 0), (3, CT_STRUCT, cm)])
        rgs.append([(1, CT_LIST, (CT_STRUCT, chunks)),
                    (2, CT_I64, state["offset"] - rg_start_off),
                    (3, CT_I64, rn)])
    fmeta = [(1, CT_I32, 2),
             (2, CT_LIST, (CT_STRUCT, schema_elems)),
             (3, CT_I64, n),
             (4, CT_LIST, (CT_STRUCT, rgs)),
             (6, CT_BINARY, "arrow1_tpu_torch parquet_native")]
    tw = TWrite()
    tw.write_struct(fmeta)
    footer = bytes(tw.out)
    if fkey:
        # FileCryptoMetaData (plaintext) + encrypted FileMetaData
        # module + u32 combined length + PARE (file_writer.cc
        # CloseEncryptedFile layout)
        tc = TWrite()
        tc.write_struct([
            (1, CT_STRUCT, [(1, CT_STRUCT, [
                (2, CT_BINARY, file_aad),
                (3, CT_TRUE, False)])]),
            (2, CT_BINARY, encryption.get("key_metadata", b"kf"))])
        crypto_meta = bytes(tc.out)
        enc_footer = _gcm_encrypt(
            fkey, _module_aad(file_aad, _MOD_FOOTER), footer)
        sink.write(crypto_meta)
        sink.write(enc_footer)
        sink.write(struct.pack("<I", len(crypto_meta)
                               + len(enc_footer)))
        sink.write(MAGIC_E)
        return
    sink.write(footer)
    sink.write(struct.pack("<I", len(footer)))
    sink.write(MAGIC)
