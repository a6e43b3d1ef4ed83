"""Feather V1 reader and writer (legacy pre-IPC format; counterpart of
arrow1_tpu/io/feather1.py).

Reference: cpp/src/arrow/ipc/feather.{h,cc} ReaderV1 — the reference
reads both Feather versions; V2 is the Arrow IPC file format (which
io/ipc_native.py already speaks), V1 is this older flatbuffer layout:

  "FEA1" | column data blocks ... | CTable flatbuffer | <u32 meta len>
  | "FEA1"

CTable/Column/PrimitiveArray tables are navigated with the same
hand-built vtable reader the IPC path uses (ipc_native._T) and written
with the port's own builder (io/_flatbuf.py). Per
column: optional null bitmap (LSB bit order, 8-byte padded) then
values; UTF8/BINARY carry an int32 offsets vector (8-byte padded)
before the byte blob. CATEGORY columns carry the codes in the primary
array and the dictionary values in the metadata's `levels`. The reader
places the batch on ``device`` (CUDA unless the caller names the CPU),
through the IPC reader's staging copy.
"""

from __future__ import annotations

import struct
from typing import List, Optional

import numpy as np

from .. import dtypes as dt
from ..column import Column, Dictionary
from ..device import resolve_device
from ..errors import Invalid
from ..table import RecordBatch
from ._flatbuf import Builder
from .ipc_native import _T, _host, _stage

__all__ = ["is_feather_v1", "read_feather_v1", "write_feather_v1"]

# feather.fbs Type enum (ReaderV1's column types)
_PRIM = {
    0: (dt.bool_, None), 1: (dt.int8, np.int8), 2: (dt.int16, np.int16),
    3: (dt.int32, np.int32), 4: (dt.int64, np.int64),
    5: (dt.uint8, np.uint8), 6: (dt.uint16, np.uint16),
    7: (dt.uint32, np.uint32), 8: (dt.uint64, np.uint64),
    9: (dt.float32, np.float32), 10: (dt.float64, np.float64),
}
T_UTF8, T_BINARY = 11, 12
# TypeMetadata union tags
M_CATEGORY, M_TIMESTAMP, M_DATE, M_TIME = 1, 2, 3, 4
_UNITS = {0: "s", 1: "ms", 2: "us", 3: "ns"}


def is_feather_v1(buf: bytes) -> bool:
    return len(buf) > 8 and buf[:4] == b"FEA1" and buf[-4:] == b"FEA1"


def _pad8(n: int) -> int:
    return (n + 7) & ~7


class _PrimArray:
    """feather.fbs PrimitiveArray: type(0) encoding(1) offset(2)
    length(3) null_count(4) total_bytes(5)."""

    def __init__(self, t: _T):
        self.type = t.i8(0)
        self.encoding = t.i8(1)
        self.offset = t.i64(2)
        self.length = t.i64(3)
        self.null_count = t.i64(4)
        self.total_bytes = t.i64(5)


def _read_values(buf: bytes, pa_: _PrimArray):
    """-> (values ndarray | list of bytes, validity bool[n] | None)."""
    pos = pa_.offset
    n = pa_.length
    validity = None
    if pa_.null_count > 0:
        nbytes = _pad8((n + 7) // 8)
        bits = np.frombuffer(buf, np.uint8, (n + 7) // 8, pos)
        validity = np.unpackbits(bits, bitorder="little",
                                 count=n).astype(bool)
        pos += nbytes
    if pa_.type in _PRIM:
        typ, npdt = _PRIM[pa_.type]
        if pa_.type == 0:  # bool: bit-packed
            bits = np.frombuffer(buf, np.uint8, (n + 7) // 8, pos)
            vals = np.unpackbits(bits, bitorder="little",
                                 count=n).astype(bool)
        else:
            vals = np.frombuffer(buf, npdt, n, pos)
        return vals, validity
    if pa_.type in (T_UTF8, T_BINARY):
        offs = np.frombuffer(buf, np.int32, n + 1, pos)
        blob_pos = pos + _pad8(4 * (n + 1))
        vals = [buf[blob_pos + offs[i]: blob_pos + offs[i + 1]]
                for i in range(n)]
        return vals, validity
    raise Invalid(f"feather v1: column type {pa_.type}")


def _column(buf: bytes, name: str, col_t: _T) -> Column:
    """A host-side column (numpy arrays in its tensor slots)."""
    arr = _PrimArray(col_t.table(1))
    meta_type = col_t.i8(2)
    meta = col_t.table(3)
    vals, validity = _read_values(buf, arr)
    vj = validity

    if meta_type == M_CATEGORY and meta is not None:
        levels = _PrimArray(meta.table(0))
        lvals, _ = _read_values(buf, levels)
        uniq = np.asarray([v.decode("utf8") for v in lvals] or [""],
                          object)
        return Column(np.asarray(vals).astype(np.int32), dt.string,
                      validity=vj, dictionary=Dictionary(uniq))
    if arr.type in (T_UTF8, T_BINARY):
        typ = dt.string if arr.type == T_UTF8 else dt.binary
        dec = [v.decode("utf8") for v in vals] if arr.type == T_UTF8 \
            else vals
        uniq, codes = (np.unique(np.asarray(dec, object),
                                 return_inverse=True)
                       if dec else (np.asarray([""], object),
                                    np.zeros(0, np.int64)))
        return Column(codes.reshape(-1).astype(np.int32), typ,
                      validity=vj, dictionary=Dictionary(uniq))
    typ = _PRIM[arr.type][0]
    if meta_type == M_TIMESTAMP and meta is not None:
        unit = _UNITS.get(meta.i8(0), "us")
        tz = meta.string(1)
        typ = dt.timestamp(unit, tz)
    elif meta_type == M_DATE:
        typ = dt.date32
        vals = np.asarray(vals).astype(np.int32)
    elif meta_type == M_TIME and meta is not None:
        unit = _UNITS.get(meta.i8(0), "s")
        typ = dt.time32(unit) if unit in ("s", "ms") else dt.time64(unit)
    return Column(np.asarray(vals), typ, validity=vj)


def read_feather_v1(buf: bytes, columns: Optional[List[str]] = None,
                    device=None) -> RecordBatch:
    """A Feather V1 file's bytes -> RecordBatch on ``device``."""
    dev = resolve_device(device)
    if not is_feather_v1(buf):
        raise Invalid("feather v1: bad magic")
    (meta_len,) = struct.unpack_from("<I", buf, len(buf) - 8)
    meta = buf[len(buf) - 8 - meta_len: len(buf) - 8]
    root = _T(meta, struct.unpack_from("<i", meta, 0)[0])
    # CTable: description(0) num_rows(1) columns(2) version(3)
    vec_pos, vec_len = root.vector(2)
    cols, names = [], []
    for i in range(vec_len):
        off = struct.unpack_from("<i", meta, vec_pos + 4 * i)[0]
        col_t = _T(meta, vec_pos + 4 * i + off)
        name = col_t.string(0)
        if columns is not None and name not in columns:
            continue
        cols.append(_column(buf, name, col_t))
        names.append(name)
    if columns is not None:
        order = {n: i for i, n in enumerate(names)}
        cols = [cols[order[n]] for n in columns if n in order]
        names = [n for n in columns if n in order]
    return _stage(RecordBatch(tuple(cols), tuple(names)), dev)


# ---------------------------------------------------------------------
# Feather V1 writer (reference: ipc/feather.h:105 kFeatherV1Version +
# WriterV1 in ipc/feather.cc; layout per format feather.fbs CTable).
# ---------------------------------------------------------------------

_PRIM_OF_KIND = {
    "bool": 0, "int8": 1, "int16": 2, "int32": 3, "int64": 4,
    "uint8": 5, "uint16": 6, "uint32": 7, "uint64": 8,
    "float32": 9, "float64": 10,
}
_UNIT_CODE = {"s": 0, "ms": 1, "us": 2, "ns": 3}


def write_feather_v1(batch: RecordBatch, sink,
                     description: Optional[str] = None) -> None:
    """Write a flat RecordBatch as a Feather V1 file.

    Strings write as CATEGORY (codes + levels — the engine's native
    dictionary form); numerics/bools/date32/timestamps as PLAIN
    primitive arrays with LSB null bitmaps."""
    sink.write(b"FEA1")
    pos = [4]

    def emit(block: bytes) -> int:
        off = pos[0]
        sink.write(block)
        pad = (-len(block)) % 8
        if pad:
            sink.write(b"\x00" * pad)
        pos[0] += len(block) + pad
        return off

    def prim_block(type_code: int, values: np.ndarray,
                   validity: Optional[np.ndarray],
                   utf8_blobs: Optional[list] = None):
        """-> dict for the PrimitiveArray table (data emitted here)."""
        parts = []
        null_count = 0
        n = (len(values) if utf8_blobs is None else len(utf8_blobs))
        if validity is not None and not validity.all():
            null_count = int((~validity).sum())
            parts.append(np.packbits(validity, bitorder="little")
                         .tobytes())
        if utf8_blobs is not None:
            lens = np.array([len(x) for x in utf8_blobs], np.int64)
            offs = np.zeros(n + 1, np.int32)
            offs[1:] = np.cumsum(lens)
            parts.append(offs.astype("<i4").tobytes())
            parts.append(b"".join(utf8_blobs))
        else:
            if type_code == 0:  # BOOL packs to bits
                parts.append(np.packbits(values.astype(bool),
                                         bitorder="little").tobytes())
            else:
                parts.append(np.ascontiguousarray(values).tobytes())
        block = b"".join(
            p + b"\x00" * ((-len(p)) % 8) for p in parts[:-1]
        ) + parts[-1]
        off = emit(block)
        return {"type": type_code, "offset": off, "length": n,
                "null_count": null_count, "total_bytes": len(block)}

    def build_prim(b: Builder, d: dict) -> int:
        b.StartObject(6)
        b.PrependInt8Slot(0, d["type"], 0)
        b.PrependInt8Slot(1, 0, 0)            # PLAIN
        b.PrependInt64Slot(2, d["offset"], 0)
        b.PrependInt64Slot(3, d["length"], 0)
        b.PrependInt64Slot(4, d["null_count"], 0)
        b.PrependInt64Slot(5, d["total_bytes"], 0)
        return b.EndObject()

    col_descs = []
    for name, col in zip(batch.names, batch.columns):
        if not isinstance(col, Column):
            raise Invalid(f"feather v1 write: nested column {name!r}")
        t = col.dtype
        validity = (None if col.validity is None
                    else _host(col.validity))
        meta_type = 0
        meta_desc = None
        if t.kind == "string" and col.dictionary is not None:
            levels = [str(v).encode("utf8")
                      for v in col.dictionary.values]
            lev = prim_block(11, None, None, utf8_blobs=levels)
            codes = _host(col.data).astype(np.int32)
            arr = prim_block(3, codes, validity)
            meta_type, meta_desc = 1, ("category", lev)   # CATEGORY
        elif t.kind in ("string", "binary"):
            raise Invalid("feather v1 write: non-dictionary string")
        elif t.kind == "date32":
            arr = prim_block(3, _host(col.data).astype("<i4"),
                             validity)
            meta_type, meta_desc = 3, ("date", None)
        elif t.kind == "timestamp":
            arr = prim_block(4, _host(col.data).astype("<i8"),
                             validity)
            meta_type, meta_desc = 2, ("timestamp",
                                       (_UNIT_CODE[t.unit], t.tz))
        elif t.kind in _PRIM_OF_KIND:
            code = _PRIM_OF_KIND[t.kind]
            arr = prim_block(code, _host(col.data), validity)
        else:
            raise Invalid(f"feather v1 write: unsupported type {t}")
        col_descs.append((name, arr, meta_type, meta_desc))

    b = Builder(1024)
    col_offs = []
    for name, arr, meta_type, meta_desc in col_descs:
        name_off = b.CreateString(name)
        arr_off = build_prim(b, arr)
        meta_off = None
        if meta_type == 1:      # CategoryMetadata
            lev_off = build_prim(b, meta_desc[1])
            b.StartObject(2)
            b.PrependUOffsetTRelativeSlot(0, lev_off, 0)
            b.PrependBoolSlot(1, False, False)
            meta_off = b.EndObject()
        elif meta_type == 2:    # TimestampMetadata
            unit_code, tz = meta_desc[1]
            tz_off = b.CreateString(tz) if tz else None
            b.StartObject(2)
            if tz_off is not None:
                b.PrependUOffsetTRelativeSlot(1, tz_off, 0)
            b.PrependInt8Slot(0, unit_code, 0)
            meta_off = b.EndObject()
        elif meta_type == 3:    # DateMetadata
            b.StartObject(0)
            meta_off = b.EndObject()
        # Column: name(0) values(1) metadata_type(2) metadata(3)
        b.StartObject(5)
        b.PrependUOffsetTRelativeSlot(0, name_off, 0)
        b.PrependUOffsetTRelativeSlot(1, arr_off, 0)
        if meta_off is not None:
            b.PrependInt8Slot(2, meta_type, 0)
            b.PrependUOffsetTRelativeSlot(3, meta_off, 0)
        col_offs.append(b.EndObject())
    b.StartVector(4, len(col_offs), 4)
    for off in reversed(col_offs):
        b.PrependUOffsetTRelative(off)
    vec = b.EndVector()
    desc_off = b.CreateString(description) if description else None
    # CTable: description(0) num_rows(1) columns(2) version(3)
    b.StartObject(5)
    if desc_off is not None:
        b.PrependUOffsetTRelativeSlot(0, desc_off, 0)
    b.PrependInt64Slot(1, batch.num_rows, 0)
    b.PrependUOffsetTRelativeSlot(2, vec, 0)
    b.PrependInt32Slot(3, 2, 0)   # kFeatherV1Version == 2
    b.Finish(b.EndObject())
    meta = b.Output()
    sink.write(meta)
    sink.write(struct.pack("<I", len(meta)))
    sink.write(b"FEA1")
