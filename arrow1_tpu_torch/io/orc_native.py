"""Native ORC reader, with no liborc or pyarrow.orc on the path
(counterpart of arrow1_tpu/io/orc_native.py).

Reference: the reference wraps the ORC C++ library
(cpp/src/arrow/adapters/orc/adapter.cc); this is an original
implementation of the format itself (orc-specification v1):

  layout    PostScript (protobuf, tail) -> Footer -> per-stripe
            StripeFooter -> PRESENT/DATA/LENGTH/DICTIONARY/SECONDARY
            streams. Protobuf decoding is a small hand-built wire
            reader (``_fields``, the port's copy of the reference's
            flight_proto._fields).
  codecs    NONE, ZLIB (raw deflate chunks), SNAPPY (native/src),
            ZSTD, LZ4 — ORC chunked framing (3-byte header,
            isOriginal bit)
  encodings Byte-RLE + bit-packed booleans (MSB-first), integer
            RLEv1 and RLEv2 (SHORT_REPEAT / DIRECT / PATCHED_BASE /
            DELTA, big-endian bit packing, FixedBitSizes widths),
            IEEE float/double streams, string DIRECT_V2 and
            DICTIONARY_V2, DATE days, DECIMAL base-128 + scale,
            TIMESTAMP seconds-from-2015 + scaled-nanos SECONDARY
  types     boolean/byte/short/int/long/float/double/string/binary/
            date/decimal/timestamp at arbitrary STRUCT/LIST/MAP
            nesting depth (same recursive assembly idea as the
            Parquet Dremel assembler, but ORC's PRESENT streams make
            it offsets-per-level instead of def/rep reconstruction)

The writer is io/orc_writer.py. The port's reader builds host-side
columns of its own layouts (strings as int32 codes into a pool of
distinct values through the native MemoTable, decimals as int64 limbs,
no f64 bit view) and puts each stripe on its device in one staging copy
(``ipc_native._stage``; CUDA unless the caller names the CPU), one
RecordBatch a stripe. A type or compression kind it does not take (LZO,
a type kind it does not know) raises
``UnsupportedLayout`` from the file's tail, before any stripe is read;
corrupt input raises ``Invalid``. ZSTD needs the ``zstandard`` package.
A file of no stripe reads as one batch of no rows.
"""

from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from .. import dtypes as dt
from ..column import Column, Dictionary, ListColumn, StructColumn, \
    UnionColumn
from ..device import resolve_device
from ..errors import A1TError, Invalid
from ..table import RecordBatch
from .ipc_native import UnsupportedLayout, _stage

__all__ = ["read_orc_native"]


# ---------------------------------------------------------------------
# protobuf wire format (the fields the ORC tail and stripes use)
# ---------------------------------------------------------------------

def _varint(n: int) -> bytes:
    """Unsigned LEB128. int64 fields encode negatives as 2^64 + n."""
    if n < 0:
        n += 1 << 64
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    shift = 0
    val = 0
    while True:
        b = buf[pos]
        pos += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, pos
        shift += 7
        if shift > 70:
            raise ValueError("protobuf: varint too long")


def _ld(fieldno: int, payload: bytes) -> bytes:
    """Length-delimited field (wire type 2)."""
    return _varint(fieldno << 3 | 2) + _varint(len(payload)) + payload


def _vi(fieldno: int, value: int) -> bytes:
    """Varint field (wire type 0); a zero value is omitted."""
    if not value:
        return b""
    return _varint(fieldno << 3) + _varint(value)


def _iter_fields(buf: bytes):
    """Yield (field_number, wire_type, value): an int for varint and
    fixed types, bytes for length-delimited ones."""
    pos = 0
    n = len(buf)
    while pos < n:
        tag, pos = _read_varint(buf, pos)
        fno, wt = tag >> 3, tag & 7
        if wt == 0:
            v, pos = _read_varint(buf, pos)
            yield fno, wt, v
        elif wt == 2:
            ln, pos = _read_varint(buf, pos)
            if pos + ln > n:
                raise ValueError("protobuf: field runs past its message")
            yield fno, wt, buf[pos:pos + ln]
            pos += ln
        elif wt == 5:
            yield fno, wt, struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        elif wt == 1:
            yield fno, wt, struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        else:
            raise ValueError(f"protobuf: unsupported wire type {wt}")

# orc_proto.proto CompressionKind
K_NONE, K_ZLIB, K_SNAPPY, K_LZO, K_LZ4, K_ZSTD = range(6)
# Type.Kind
(T_BOOLEAN, T_BYTE, T_SHORT, T_INT, T_LONG, T_FLOAT, T_DOUBLE, T_STRING,
 T_BINARY, T_TIMESTAMP, T_LIST, T_MAP, T_STRUCT, T_UNION, T_DECIMAL,
 T_DATE, T_VARCHAR, T_CHAR, T_TIMESTAMP_INSTANT) = range(19)
# Stream.Kind
(S_PRESENT, S_DATA, S_LENGTH, S_DICTIONARY_DATA, S_DICTIONARY_COUNT,
 S_SECONDARY, S_ROW_INDEX, S_BLOOM_FILTER, S_BLOOM_FILTER_UTF8) = range(9)
# ColumnEncoding.Kind
E_DIRECT, E_DICTIONARY, E_DIRECT_V2, E_DICTIONARY_V2 = range(4)

_ORC_EPOCH_S = 1420070400  # 2015-01-01 UTC (orc spec: timestamp base)


def _msg(buf: bytes) -> Dict[int, list]:
    """Protobuf bytes -> {field: [values]} (repeated-aware)."""
    out: Dict[int, list] = {}
    for fn, wt, val in _iter_fields(buf):
        out.setdefault(fn, []).append(val)
    return out


def _packed_varints(vals: list) -> List[int]:
    """A repeated varint field arrives either as ints (unpacked) or as
    length-delimited packed bytes."""
    out: List[int] = []
    for v in vals:
        if isinstance(v, int):
            out.append(v)
        else:
            pos = 0
            while pos < len(v):
                x = shift = 0
                while True:
                    b = v[pos]
                    pos += 1
                    x |= (b & 0x7F) << shift
                    if not b & 0x80:
                        break
                    shift += 7
                out.append(x)
    return out


def _decompress(kind: int, data: bytes) -> bytes:
    """ORC stream framing: NONE = raw; else 3-byte chunk headers
    (length << 1 | isOriginal), each chunk independently compressed."""
    if kind == K_NONE:
        return data
    out = bytearray()
    pos = 0
    while pos + 3 <= len(data):
        h = data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16)
        pos += 3
        ln = h >> 1
        chunk = data[pos: pos + ln]
        pos += ln
        if h & 1:
            out += chunk
        elif kind == K_ZLIB:
            out += zlib.decompress(chunk, -15)
        elif kind == K_ZSTD:
            out += _zstandard().ZstdDecompressor().decompress(
                chunk, max_output_size=1 << 26)
        elif kind == K_SNAPPY:
            from ..native import snappy_decompress

            out += snappy_decompress(chunk)
        elif kind == K_LZ4:
            from ..native import lz4_block_decompress

            try:
                out += lz4_block_decompress(chunk, 1 << 26)
            except RuntimeError as e:
                raise Invalid(f"orc_native: {e}") from None
        else:
            raise UnsupportedLayout(f"orc_native: compression kind {kind}")
    return bytes(out)


def _zstandard():
    try:
        import zstandard
    except ImportError:
        raise Invalid("orc_native: the ZSTD codec needs the zstandard "
                      "package, which is not installed") from None
    return zstandard


# ---------------------------------------------------------------------
# primitive decoders
# ---------------------------------------------------------------------

def _byte_rle(data: bytes, n: int) -> np.ndarray:
    """ORC Byte-RLE: control 0..127 = run of c+3 copies of next byte;
    128..255 = 256-c literal bytes."""
    out = np.empty(n, np.uint8)
    pos = filled = 0
    while filled < n:
        c = data[pos]
        pos += 1
        if c < 128:
            run = c + 3
            out[filled: filled + run] = data[pos]
            pos += 1
        else:
            run = 256 - c
            out[filled: filled + run] = np.frombuffer(
                data, np.uint8, run, pos)
            pos += run
        filled += run
    return out


def _bool_rle(data: bytes, n: int) -> np.ndarray:
    """Booleans: byte-RLE over MSB-first bit-packed bytes."""
    nbytes = (n + 7) // 8
    by = _byte_rle(data, nbytes)
    return np.unpackbits(by, bitorder="big")[:n].astype(bool)


_FBS = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18,
        19, 20, 21, 22, 23, 24, 26, 28, 30, 32, 40, 48, 56, 64]


def _unpack_be(data: bytes, pos: int, width: int, n: int
               ) -> Tuple[np.ndarray, int]:
    """Big-endian MSB-first bit unpack -> (uint64[n], new pos)."""
    if width == 0:
        return np.zeros(n, np.uint64), pos
    nbytes = (n * width + 7) // 8
    raw = np.frombuffer(data, np.uint8, nbytes, pos)
    bits = np.unpackbits(raw, bitorder="big")[: n * width]
    bits = bits.reshape(n, width).astype(np.uint64)
    weights = np.uint64(1) << np.arange(width - 1, -1, -1, dtype=np.uint64)
    return (bits * weights).sum(axis=1, dtype=np.uint64), pos + nbytes


def _varint_u(data: bytes, pos: int) -> Tuple[int, int]:
    v = shift = 0
    while True:
        b = data[pos]
        pos += 1
        v |= (b & 0x7F) << shift
        if not b & 0x80:
            return v, pos
        shift += 7


def _zz(v: int) -> int:
    return (v >> 1) ^ -(v & 1)


def _rle_v2(data: bytes, n: int, signed: bool) -> np.ndarray:
    """Integer RLEv2 (orc spec 'Run Length Encoding version 2')."""
    out = np.empty(n, np.int64)
    pos = filled = 0
    while filled < n:
        b0 = data[pos]
        mode = b0 >> 6
        if mode == 0:  # SHORT_REPEAT
            w = ((b0 >> 3) & 0x7) + 1
            run = (b0 & 0x7) + 3
            pos += 1
            v = int.from_bytes(data[pos: pos + w], "big")
            pos += w
            if signed:
                v = _zz(v)
            out[filled: filled + run] = np.int64(
                (v + 2**64) % 2**64 - 2**63 if v >= 2**63 else v)
            filled += run
        elif mode == 1:  # DIRECT
            w = _FBS[(b0 >> 1) & 0x1F]
            ln = ((b0 & 1) << 8 | data[pos + 1]) + 1
            pos += 2
            vals, pos = _unpack_be(data, pos, w, ln)
            iv = vals.view(np.int64)
            if signed:
                iv = ((vals >> np.uint64(1)).view(np.int64)
                      ^ -(vals & np.uint64(1)).view(np.int64))
            out[filled: filled + ln] = iv
            filled += ln
        elif mode == 2:  # PATCHED_BASE
            w = _FBS[(b0 >> 1) & 0x1F]
            ln = ((b0 & 1) << 8 | data[pos + 1]) + 1
            b2, b3 = data[pos + 2], data[pos + 3]
            bw = ((b2 >> 5) & 0x7) + 1
            pw = _FBS[b2 & 0x1F]
            pgw = ((b3 >> 5) & 0x7) + 1
            pll = b3 & 0x1F
            pos += 4
            base = int.from_bytes(data[pos: pos + bw], "big")
            sign_bit = 1 << (bw * 8 - 1)
            if base & sign_bit:  # sign-magnitude
                base = -(base & (sign_bit - 1))
            pos += bw
            vals, pos = _unpack_be(data, pos, w, ln)
            patch_total = pgw * 8 + pw  # hmm: gap+patch packed together
            pwidth = ((pgw * 8 + pw + 7) // 8) * 8
            patches, pos = _unpack_be(data, pos, pwidth, pll)
            vals = vals.copy()
            gap_acc = 0
            for p in patches:
                p = int(p)
                gap = p >> pw
                patch = p & ((1 << pw) - 1)
                gap_acc += gap
                vals[gap_acc] |= np.uint64(patch << w)
            out[filled: filled + ln] = base + vals.view(np.int64)
            filled += ln
        else:  # DELTA
            code = (b0 >> 1) & 0x1F
            w = 0 if code == 0 else _FBS[code]
            ln = ((b0 & 1) << 8 | data[pos + 1]) + 1
            pos += 2
            base, pos = _varint_u(data, pos)
            base = _zz(base) if signed else base
            delta0, pos = _varint_u(data, pos)
            delta0 = _zz(delta0)
            seq = np.empty(ln, np.int64)
            seq[0] = base
            if ln > 1:
                seq[1] = base + delta0
                if ln > 2:
                    if w:
                        deltas, pos = _unpack_be(data, pos, w, ln - 2)
                        d = deltas.view(np.int64) * (1 if delta0 >= 0
                                                     else -1)
                    else:
                        d = np.full(ln - 2, delta0, np.int64)
                    seq[2:] = (base + delta0) + np.cumsum(d)
            out[filled: filled + ln] = seq
            filled += ln
    return out


def _rle_v1(data: bytes, n: int, signed: bool) -> np.ndarray:
    """Integer RLEv1: control 0..127 = run of c+3 with signed-byte delta;
    128..255 = 256-c literal varints. The controls are walked one by one;
    the literals' varints (their ends are the bytes below 128 after each
    control) are decoded together at the end."""
    out = np.empty(n, np.int64)
    buf = np.frombuffer(data, np.uint8)
    term = np.flatnonzero(buf < 128)
    lit_fill, lit_k0, lit_run, lit_pos = [], [], [], []
    pos = filled = 0
    while filled < n:
        c = data[pos]
        pos += 1
        if c < 128:
            run = c + 3
            delta = data[pos]
            delta = delta - 256 if delta >= 128 else delta
            pos += 1
            v, pos = _varint_u(data, pos)
            if signed:
                v = _zz(v)
            elif v >= (1 << 63):
                v -= 1 << 64       # two's-complement wrap
            out[filled: filled + run] = v + delta * np.arange(
                min(run, n - filled))
        else:
            run = 256 - c
            k0 = int(np.searchsorted(term, pos))
            if k0 + run > len(term):
                raise Invalid("orc_native: a varint runs past its stream")
            lit_fill.append(filled)
            lit_k0.append(k0)
            lit_run.append(run)
            lit_pos.append(pos)
            pos = int(term[k0 + run - 1]) + 1
        filled += run
    if lit_run:
        runs = np.array(lit_run, np.int64)
        within = np.arange(int(runs.sum())) - np.repeat(
            np.cumsum(runs) - runs, runs)
        ends = term[np.repeat(np.array(lit_k0), runs) + within]
        starts = np.empty(len(ends), np.int64)
        starts[1:] = ends[:-1] + 1
        starts[within == 0] = lit_pos
        u = _varints_at(buf, starts, ends)
        # unsigned values wrap to int64 (liborc casts int64 nanos
        # through uint64)
        v = (u >> np.uint64(1)) ^ (np.uint64(0) - (u & np.uint64(1))) \
            if signed else u
        dest = np.repeat(np.array(lit_fill), runs) + within
        keep = dest < n
        out[dest[keep]] = v.view(np.int64)[keep]
    return out


def _varints_at(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray
                ) -> np.ndarray:
    """The base-128 varints buf[starts[i]:ends[i] + 1] as uint64."""
    lens = ends - starts + 1
    if len(lens) and (lens.max() > 10 or lens.min() < 1):
        raise Invalid("orc_native: a malformed varint")
    first = np.cumsum(lens) - lens
    idx = np.repeat(starts - first, lens) + np.arange(int(lens.sum()))
    shift = (idx - np.repeat(starts, lens)).astype(np.uint64) * \
        np.uint64(7)
    contrib = (buf[idx] & np.uint8(0x7F)).astype(np.uint64) << shift
    return np.bitwise_or.reduceat(contrib, first) if len(lens) else \
        np.zeros(0, np.uint64)


def _decimal_data(data: bytes, n: int) -> np.ndarray:
    """DECIMAL DATA stream: n signed base-128 varints -> object ints."""
    out = np.empty(n, object)
    pos = 0
    for i in range(n):
        v, pos = _varint_u(data, pos)
        out[i] = _zz(v)
    return out


# ---------------------------------------------------------------------
# schema + column assembly
# ---------------------------------------------------------------------

class _Type:
    __slots__ = ("kind", "subtypes", "names", "precision", "scale")

    def __init__(self, kind, subtypes, names, precision, scale):
        self.kind = kind
        self.subtypes = subtypes
        self.names = names
        self.precision = precision
        self.scale = scale


def _parse_types(footer: Dict) -> List[_Type]:
    types = []
    for raw in footer.get(4, []):
        m = _msg(raw)
        types.append(_Type(
            m.get(1, [0])[0], _packed_varints(m.get(2, [])),
            [x.decode() for x in m.get(3, [])],
            m.get(5, [38])[0], m.get(6, [0])[0]))
    return types


class _Stripe:
    def __init__(self, buf, comp, info, types):
        m = _msg(info)
        self.offset = m.get(1, [0])[0]
        self.index_len = m.get(2, [0])[0]
        self.data_len = m.get(3, [0])[0]
        self.footer_len = m.get(4, [0])[0]
        self.num_rows = m.get(5, [0])[0]
        sf_raw = _decompress(comp, buf[
            self.offset + self.index_len + self.data_len:
            self.offset + self.index_len + self.data_len
            + self.footer_len])
        sf = _msg(sf_raw)
        self.encodings = []
        for raw in sf.get(2, []):
            em = _msg(raw)
            self.encodings.append((em.get(1, [0])[0], em.get(2, [0])[0]))
        # stream layout: sequential from offset, index streams first
        self.streams: Dict[Tuple[int, int], bytes] = {}
        pos = self.offset
        for raw in sf.get(1, []):
            sm = _msg(raw)
            kind = sm.get(1, [0])[0]
            col = sm.get(2, [0])[0]
            ln = sm.get(3, [0])[0]
            self.streams[(col, kind)] = buf[pos: pos + ln]
            pos += ln

    def stream(self, col: int, kind: int, comp: int) -> Optional[bytes]:
        raw = self.streams.get((col, kind))
        return None if raw is None else _decompress(comp, raw)


class _NoStripe:
    """The stripe of a file that has none: no rows and no streams."""

    num_rows = 0

    def __init__(self, n_types: int):
        self.encodings = [(E_DIRECT, 0)] * n_types

    def stream(self, col: int, kind: int, comp: int):
        return None


def _present(stripe: _Stripe, col: int, comp: int, n: int
             ) -> Optional[np.ndarray]:
    raw = stripe.stream(col, S_PRESENT, comp)
    if raw is None:
        return None
    return _bool_rle(raw, n)


def _expand(vals, present: Optional[np.ndarray], n: int):
    """Non-null-compacted values -> slot-aligned (zeros where null)."""
    if present is None:
        return vals
    if isinstance(vals, np.ndarray) and vals.dtype == object:
        out = np.zeros(n, object)
    else:
        out = np.zeros(n, vals.dtype)
    out[present] = vals
    return out


def _expand_column(col, present: Optional[np.ndarray], n: int):
    """Expand a column decoded at parent-non-null granularity back to
    the parent's n slots (absent slots: zero/null)."""
    if present is None:
        return col
    validity = np.zeros(n, bool)
    validity[present] = True if col.validity is None else col.validity
    if isinstance(col, StructColumn):
        kids = tuple(_expand_column(c, present, n) for c in col.children)
        return StructColumn(kids, col.names, col.dtype, validity=validity)
    if isinstance(col, ListColumn):
        lengths = np.zeros(n, np.int64)
        lengths[present] = col.offsets[1:] - col.offsets[:-1]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        return ListColumn(offsets, col.values, col.dtype, validity=validity)
    data = np.zeros((n,) + col.data.shape[1:], col.data.dtype)
    data[present] = col.data
    data2 = None
    if col.data2 is not None:
        data2 = np.zeros((n,) + col.data2.shape[1:], col.data2.dtype)
        data2[present] = col.data2
    return Column(data, col.dtype, validity=validity,
                  dictionary=col.dictionary, data2=data2)


def _strings(blob: bytes, lengths: np.ndarray, typ) -> Column:
    """Values laid end to end in ``blob`` as int32 codes into a pool of
    the distinct values (the native MemoTable, first-appearance
    order)."""
    from ..native import MemoTable

    offs = np.zeros(len(lengths) + 1, np.int64)
    np.cumsum(lengths, out=offs[1:])
    if offs[-1] > len(blob):
        raise Invalid("orc_native: string lengths run past their stream")
    memo = MemoTable(max(64, len(lengths) // 4))
    codes = memo.encode_array(np.frombuffer(blob, np.uint8), offs) \
        if len(lengths) else np.zeros(0, np.int32)
    raw = memo.values() or [b""]
    pool = np.empty(len(raw), object)
    pool[:] = [v.decode("utf8") for v in raw] if typ.is_binary and \
        typ.kind == "string" else raw
    return Column(codes, typ, dictionary=Dictionary(pool))


def _decode_column(stripe: _Stripe, types: List[_Type], col: int,
                   comp: int, n: int):
    """-> a host-side column for `col` with n value slots."""
    t = types[col]
    enc, dict_size = stripe.encodings[col]
    present = _present(stripe, col, comp, n)
    nv = int(present.sum()) if present is not None else n
    validity = present

    def data(kind=S_DATA):
        return stripe.stream(col, kind, comp)

    def ints(signed=True, kind=S_DATA, count=nv):
        raw = data(kind)
        if raw is None or count == 0:
            return np.zeros(count, np.int64)
        if enc in (E_DIRECT_V2, E_DICTIONARY_V2):
            return _rle_v2(raw, count, signed)
        return _rle_v1(raw, count, signed)

    if t.kind == T_STRUCT:
        # child streams cover only the parent's NON-NULL slots — decode
        # at nv, then expand back to the parent's n slots
        children, names = [], []
        for sub, name in zip(t.subtypes, t.names):
            child = _decode_column(stripe, types, sub, comp, nv)
            children.append(_expand_column(child, present, n))
            names.append(name)
        fields = [(nm, c.dtype) for nm, c in zip(names, children)]
        return StructColumn(tuple(children), tuple(names),
                            dt.struct(fields), validity=validity)
    if t.kind in (T_LIST, T_MAP):
        lengths = _expand(ints(signed=False, kind=S_LENGTH), present, n)
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum(lengths, out=offsets[1:])
        total = int(offsets[-1])
        if t.kind == T_LIST:
            child = _decode_column(stripe, types, t.subtypes[0], comp,
                                   total)
            return ListColumn((offsets), child,
                              dt.list_(child.dtype), validity=validity)
        key = _decode_column(stripe, types, t.subtypes[0], comp, total)
        val = _decode_column(stripe, types, t.subtypes[1], comp, total)
        child = RecordBatch((key, val), ("key", "value"))
        return ListColumn((offsets), child,
                          dt.map_(key.dtype, val.dtype),
                          validity=validity)
    if t.kind == T_BOOLEAN:
        raw = data()
        vals = _bool_rle(raw, nv) if raw is not None else np.zeros(
            nv, bool)
        return Column((_expand(vals, present, n)), dt.bool_,
                      validity=validity)
    if t.kind == T_BYTE:
        vals = _byte_rle(data(), nv).view(np.int8) if nv else np.zeros(
            0, np.int8)
        return Column((_expand(vals, present, n)), dt.int8,
                      validity=validity)
    if t.kind in (T_SHORT, T_INT, T_LONG):
        vals = ints()
        typ = {T_SHORT: dt.int16, T_INT: dt.int32, T_LONG: dt.int64}[
            t.kind]
        vals = vals.astype(typ.numpy_dtype())
        return Column((_expand(vals, present, n)), typ,
                      validity=validity)
    if t.kind in (T_FLOAT, T_DOUBLE):
        npdt = np.float32 if t.kind == T_FLOAT else np.float64
        raw = data() or b""
        vals = np.frombuffer(raw, npdt, nv)
        out = _expand(vals, present, n)
        typ = dt.float32 if t.kind == T_FLOAT else dt.float64
        return Column(out, typ, validity=validity)
    if t.kind == T_DATE:
        vals = ints().astype(np.int32)
        return Column((_expand(vals, present, n)), dt.date32,
                      validity=validity)
    if t.kind in (T_TIMESTAMP, T_TIMESTAMP_INSTANT):
        secs = ints()
        nanos_enc = ints(signed=False, kind=S_SECONDARY)
        code = nanos_enc & 0x7  # trailing-zero count code (spec)
        base = nanos_enc >> 3
        nanos = np.where(code == 0, base, base * 10 ** (code + 1))
        # nanos may be NEGATIVE pre-1970: liborc splits trunc-toward-
        # zero seconds + signed remainder (cast through uint64), not
        # the spec's floor + [0, 1e9) nanos; // floors both exactly
        us = (secs + _ORC_EPOCH_S) * 10**6 + nanos // 1000
        return Column((_expand(us, present, n)),
                      dt.timestamp("us"), validity=validity)
    if t.kind == T_DECIMAL:
        ints_o = _decimal_data(data() or b"", nv)
        scale = ints(signed=True, kind=S_SECONDARY)
        # scale stream repeats the column scale per value; the column's
        # declared scale governs the logical type
        unscaled = np.zeros(n, object)
        unscaled[present if present is not None
                 else np.ones(n, bool)] = [
            int(v) * 10 ** int(t.scale - s)
            for v, s in zip(ints_o, scale)]
        lo = np.array([int(v) & (2**64 - 1) for v in unscaled],
                      np.uint64).view(np.int64)
        hi = np.array([int(v) >> 64 for v in unscaled], np.int64)
        return Column((lo),
                      dt.decimal128(t.precision, t.scale),
                      validity=validity, data2=(hi))
    if t.kind == T_UNION:
        # DATA = byte-RLE tags over the parent's non-null rows; child i
        # covers exactly the rows tagged i, in row order. The reference
        # adapter surfaces ORC unions as SPARSE unions with children
        # named _union_<i> (verified against pyarrow.orc read-back), so
        # children expand to full length with nulls off-tag. Parent
        # PRESENT nulls (only foreign writers emit them — arrow unions
        # carry no top-level validity) land as tag-0 rows whose child
        # slot is null.
        raw = data()
        tags = (_byte_rle(raw, nv) if raw is not None
                else np.zeros(nv, np.uint8))
        pres = present if present is not None else np.ones(n, bool)
        tags_full = np.zeros(n, np.uint8)
        tags_full[pres] = tags
        kids = []
        fields = []
        for i, sub in enumerate(t.subtypes):
            mask_i = np.zeros(n, bool)
            mask_i[pres] = tags == i
            cnt = int(mask_i.sum())
            child = _decode_column(stripe, types, sub, comp, cnt)
            kids.append(_expand_column(
                child, None if cnt == n else mask_i, n))
            fields.append((f"_union_{i}", kids[-1].dtype))
        return UnionColumn((tags_full.astype(np.int8)),
                           tuple(kids), dt.sparse_union(fields))
    if t.kind in (T_STRING, T_VARCHAR, T_CHAR, T_BINARY):
        typ = dt.binary if t.kind == T_BINARY else dt.string
        if enc in (E_DICTIONARY, E_DICTIONARY_V2):
            codes = ints(signed=False, kind=S_DATA).astype(np.int64)
            lens = stripe.stream(col, S_LENGTH, comp)
            lengths = ((_rle_v2(lens, dict_size, False)
                        if enc == E_DICTIONARY_V2
                        else _rle_v1(lens, dict_size, False))
                       if dict_size else np.zeros(0, np.int64))
            pool = _strings(stripe.stream(col, S_DICTIONARY_DATA, comp)
                            or b"", lengths, typ)
            if len(codes) and (codes.min() < 0 or codes.max() >= dict_size):
                raise Invalid("orc_native: dictionary index out of range")
            codes = pool.data.astype(np.int64)[codes] if len(codes) \
                else codes
        else:
            pool = _strings(data() or b"", ints(signed=False,
                                                kind=S_LENGTH), typ)
            codes = pool.data
        return Column(_expand(codes, present, n).astype(np.int32), typ,
                      validity=validity, dictionary=pool.dictionary)
    raise Invalid(f"orc_native: type kind {t.kind}")


_CORRUPT = (struct.error, IndexError, ValueError, KeyError, TypeError,
            OverflowError, RecursionError, UnicodeDecodeError, zlib.error)
_CODECS = (K_NONE, K_ZLIB, K_SNAPPY, K_LZ4, K_ZSTD)


def read_orc_native(buf: bytes, columns=None, device=None):
    """An ORC file's bytes as a Table of one RecordBatch a stripe on
    ``device`` (CUDA unless the caller names the CPU)."""
    from ..table import Table

    dev = resolve_device(device)
    try:
        want, stripes = _read_tail(buf, columns)
        return Table([_stage(RecordBatch(tuple(_decode_column(
            stripe, types, sub, comp, stripe.num_rows) for sub in subs),
            tuple(want)), dev) for stripe, types, subs, comp in stripes()])
    except A1TError:
        raise
    except _CORRUPT as e:
        raise Invalid(f"orc_native: corrupt input ({type(e).__name__}: "
                      f"{e})") from None


def _read_tail(buf: bytes, columns):
    """The wanted column names and a generator of the stripes to decode,
    from the PostScript and Footer; ``UnsupportedLayout`` for a
    compression kind or a type kind the reader does not take."""
    if len(buf) < 4:
        raise Invalid("orc_native: too short for an ORC file")
    ps_len = buf[-1]
    if ps_len + 1 > len(buf):
        raise Invalid("orc_native: bad postscript length")
    # neither magic is read, as liborc reads neither
    ps = _msg(buf[-1 - ps_len: -1])
    footer_len = ps.get(1, [0])[0]
    comp = ps.get(2, [K_NONE])[0]
    if comp == K_LZO:
        raise UnsupportedLayout("orc_native: the LZO compression kind")
    if comp not in _CODECS:
        raise Invalid(f"orc_native: unknown compression kind {comp}")
    if footer_len + ps_len + 1 > len(buf):
        raise Invalid("orc_native: bad footer length")
    footer = _msg(_decompress(
        comp, buf[-1 - ps_len - footer_len: -1 - ps_len]))
    types = _parse_types(footer)
    if not types or types[0].kind != T_STRUCT:
        raise Invalid("orc_native: root is not a struct")
    bad = [t.kind for t in types if not 0 <= t.kind <= T_TIMESTAMP_INSTANT]
    if bad:
        raise UnsupportedLayout(f"orc_native: type kind {bad[0]}")
    root = types[0]
    want = list(columns) if columns is not None else root.names
    missing = [c for c in want if c not in root.names]
    if missing:
        from ..errors import KeyError_

        raise KeyError_(f"orc_native: no column named {missing[0]!r}")
    subs = [root.subtypes[root.names.index(name)] for name in want]

    def stripes():
        for raw in footer.get(3, []):
            yield _Stripe(buf, comp, raw, types), types, subs, comp
        if not footer.get(3):   # a file of no rows: one empty batch
            yield _NoStripe(len(types)), types, subs, comp

    return want, stripes
