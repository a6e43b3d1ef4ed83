"""Native ORC writer, with no liborc or pyarrow.orc on the path
(counterpart of arrow1_tpu/io/orc_writer.py).

Reference: the reference delegates writing to the ORC C++ library
(cpp/src/arrow/adapters/orc/adapter.cc ORCFileWriter); this emits the
format directly (orc-specification v1), the mirror of io/orc_native.py:

  layout     "ORC" magic -> per-stripe [data streams, StripeFooter] ->
             Footer -> PostScript -> postscript length byte. Row
             indexes are omitted (rowIndexStride = 0) and streams are
             uncompressed (CompressionKind NONE) — both spec-legal and
             accepted by liborc and by the native reader.
  encodings  integer RLEv1 (runs + literals), Byte-RLE, bit-packed
             boolean RLE, IEEE float/double streams, string/binary
             DIRECT (LENGTH RLEv1 + concatenated DATA), DATE days,
             TIMESTAMP seconds-from-2015 + SECONDARY nanos (shifted,
             zero trailing-zero code), DECIMAL zigzag base-128 +
             SECONDARY scale, PRESENT bool-RLE for nulls, and
             STRUCT/LIST/MAP nesting (children encode the parent's
             non-null slots, per spec).

Protobuf messages are built with the hand-rolled wire helpers of
io/orc_native.py. The run-length encoders are vectorized with numpy
(maximal runs of equal values split as the reference's greedy scan
splits them, then every run and literal written in one pass) and their
bytes equal the reference's per-value encoders'. Each RecordBatch is one
stripe; its columns are copied to the host first. A type the writer does
not take raises ``UnsupportedLayout``.
"""

from __future__ import annotations

from typing import List, Tuple, Union

import numpy as np

from .. import dtypes as dt
from ..column import Column, ListColumn, StructColumn, UnionColumn
from ..table import RecordBatch, Table, map_tensors
from .ipc_native import UnsupportedLayout
from .orc_native import (_ORC_EPOCH_S, E_DIRECT, K_NONE, S_DATA,
                         S_LENGTH, S_PRESENT, S_SECONDARY, T_BINARY,
                         T_BOOLEAN, T_BYTE, T_DATE, T_DECIMAL, T_DOUBLE,
                         T_FLOAT, T_INT, T_LIST, T_LONG, T_MAP, T_SHORT,
                         T_STRING, T_STRUCT, T_TIMESTAMP, T_UNION, _ld,
                         _varint, _vi)

__all__ = ["write_orc_native"]


def _vi0(fieldno: int, value: int) -> bytes:
    """Varint field with EXPLICIT zero (liborc requires e.g. the
    PostScript compression field to be present even when NONE=0)."""
    return _varint(fieldno << 3 | 0) + _varint(value)


# ---------------------------------------------------------------------
# primitive encoders (inverses of orc_native's decoders)
# ---------------------------------------------------------------------

def _enc_varint_u(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _enc_zz(v: int) -> int:
    return (v << 1) ^ (v >> 63) if v < 0 else (v << 1)


def _varint_bytes(u: np.ndarray):
    """Base-128 varints of uint64 ``u``: a byte matrix (rows x the
    longest's bytes) and the mask of each row's bytes."""
    nbytes = np.ones(len(u), np.int64)
    for j in range(1, 10):
        nbytes += u >= (np.uint64(1) << np.uint64(7 * j))
    w = int(nbytes.max()) if len(u) else 1
    shifts = np.arange(w, dtype=np.uint64) * np.uint64(7)
    j = np.arange(w)[None, :]
    mat = ((u[:, None] >> shifts[None, :]) & np.uint64(0x7F)).astype(
        np.uint8)
    mat |= np.where(j < nbytes[:, None] - 1, 0x80, 0).astype(np.uint8)
    return mat, j < nbytes[:, None]


def _rle_write(vals: np.ndarray, payload, int_runs: bool) -> bytes:
    """The reference's greedy run-length scan, vectorized: a maximal run
    of equal values is written as runs of 130 and a last run of its
    remainder where that is 3 or more, else as 1 or 2 literals; literals
    between runs go out in groups of at most 128 behind a header byte.
    ``payload`` gives each value's bytes (matrix, mask); an integer run
    (``int_runs``) carries a zero delta byte."""
    n = len(vals)
    if n == 0:
        return b""
    change = np.ones(n, bool)
    change[1:] = vals[1:] != vals[:-1]
    starts = np.flatnonzero(change)
    lens = np.diff(np.append(starts, n))
    full, rest = lens // 130, lens % 130
    tail_run = rest >= 3
    ntok = full + np.where(tail_run, 1, rest)
    run_of = np.repeat(np.arange(len(starts)), ntok)       # token -> run
    k = np.arange(len(run_of)) - np.repeat(np.cumsum(ntok) - ntok, ntok)
    is_run = (k < full[run_of]) | tail_run[run_of]
    count = np.where(k < full[run_of], 130, rest[run_of])
    # each literal's place in its block of consecutive literals
    lit = ~is_run
    new_block = lit & np.append(True, is_run[:-1])
    bid = np.maximum(np.cumsum(new_block) - 1, 0)
    bstart = np.flatnonzero(new_block)
    blen = np.bincount(bid[lit], minlength=len(bstart))
    p = np.arange(len(lit)) - (bstart[bid] if len(bstart) else 0)
    header = lit & (p % 128 == 0)
    hval = 256 - np.minimum(128, (blen[bid] if len(blen) else 0) - p)
    pmat, pmask = payload(starts[run_of])
    nt = len(run_of)
    mat = np.zeros((nt, 2 + pmat.shape[1]), np.uint8)
    mask = np.zeros((nt, 2 + pmat.shape[1]), bool)
    mat[:, 0] = np.where(is_run, count - 3, np.where(header, hval, 0))
    mask[:, 0] = is_run | header
    mask[:, 1] = is_run & int_runs
    mat[:, 2:] = pmat
    mask[:, 2:] = pmask
    return mat[mask].tobytes()


def _byte_rle_write(data: bytes) -> bytes:
    """Byte-RLE: runs of 3..130 equal bytes, literal chunks of <=128."""
    vals = np.frombuffer(bytes(data), np.uint8)
    return _rle_write(vals, lambda idx: (vals[idx, None],
                                         np.ones((len(idx), 1), bool)),
                      False)


def _bool_rle_write(bits: np.ndarray) -> bytes:
    by = np.packbits(bits.astype(bool), bitorder="big")
    return _byte_rle_write(by.tobytes())


def _rle_v1_write(vals, signed: bool) -> bytes:
    """Integer RLEv1: constant runs of 3..130 (delta 0), else literal
    groups of <=128 varints (zigzag where ``signed``; an unsigned
    value's two's complement otherwise, as liborc casts e.g. negative
    timestamp nanos through uint64)."""
    arr = np.asarray(vals).astype(np.int64)
    u = arr.view(np.uint64)
    if signed:
        u = (u << np.uint64(1)) ^ (arr >> 63).view(np.uint64)
    return _rle_write(arr, lambda idx: _varint_bytes(u[idx]), True)


# ---------------------------------------------------------------------
# schema flattening (column ids in pre-order, root struct = 0)
# ---------------------------------------------------------------------

def _flatten_types(batch: RecordBatch):
    """-> (types, col_of): ORC Type protobuf payloads in pre-order and
    the per-column root child ids."""
    types: List[bytes] = []

    def visit(t: dt.DataType, col) -> int:
        my = len(types)
        types.append(b"")    # placeholder; filled after children
        k = t.kind
        if k == "bool":
            body = _vi(1, T_BOOLEAN)
        elif k == "int8":
            body = _vi(1, T_BYTE)
        elif k in ("int16", "uint8"):
            body = _vi(1, T_SHORT)
        elif k in ("int32", "uint16"):
            body = _vi(1, T_INT)
        elif k in ("int64", "uint32"):
            body = _vi(1, T_LONG)
        elif k == "float32":
            body = _vi(1, T_FLOAT)
        elif k == "float64":
            body = _vi(1, T_DOUBLE)
        elif k == "string":
            body = _vi(1, T_STRING)
        elif k == "binary":
            body = _vi(1, T_BINARY)
        elif k == "date32":
            body = _vi(1, T_DATE)
        elif k == "timestamp" and t.unit == "us" and not t.tz:
            body = _vi(1, T_TIMESTAMP)
        elif k == "decimal128":
            body = (_vi(1, T_DECIMAL) + _vi(5, t.precision)
                    + _vi(6, t.scale))
        elif k == "list":
            sub = visit(t.fields[0][1], None)
            body = _vi(1, T_LIST) + _vi(2, sub)
        elif k == "map":
            ks = visit(t.fields[0][1], None)
            vs = visit(t.fields[1][1], None)
            body = _vi(1, T_MAP) + _vi(2, ks) + _vi(2, vs)
        elif k == "struct":
            body = _vi(1, T_STRUCT)
            subs = []
            for name, ft in t.fields:
                subs.append(visit(ft, None))
            for s in subs:
                body += _vi(2, s)
            for name, _ in t.fields:
                body += _ld(3, name.encode())
        elif k in ("sparse_union", "dense_union"):
            # ORC unions are tagged (dense on the wire); child type
            # nodes are unnamed (fieldNames is struct-only)
            body = _vi(1, T_UNION)
            subs = [visit(ft, None) for _, ft in t.fields]
            for s in subs:
                body += _vi(2, s)
        else:
            raise UnsupportedLayout(f"orc write: unsupported type {t}")
        types[my] = body
        return my

    root = _vi(1, T_STRUCT)
    types.append(b"")
    col_of = []
    subs = []
    for name, c in zip(batch.names, batch.columns):
        cid = visit(c.dtype, c)
        col_of.append(cid)
        subs.append(cid)
    for s in subs:
        root += _vi(2, s)
    for name in batch.names:
        root += _ld(3, name.encode())
    types[0] = root
    return types, col_of


# ---------------------------------------------------------------------
# column encoding
# ---------------------------------------------------------------------

class _StripeBuild:
    def __init__(self, n_types: int):
        self.streams: List[Tuple[int, int, bytes]] = []  # (col, kind, raw)
        self.encodings: List[bytes] = [b""] * n_types
        self.counts = [0] * n_types
        self.has_null = [False] * n_types

    def add(self, col: int, kind: int, raw: bytes):
        # an empty stream is written too: liborc refuses a column whose
        # DATA stream is missing (the reference writer omits it)
        self.streams.append((col, kind, raw))


def _host_validity(col) -> np.ndarray:
    if col.validity is None:
        return None
    v = col.validity.astype(bool)
    return None if v.all() else v


def _encode_column(col, cid: int, sb: _StripeBuild, n: int,
                   next_id: List[int]):
    """Encode column `col` (n slots) as ORC streams for type node cid.
    Children get ids cid+1.. in pre-order via next_id bookkeeping."""
    t = col.dtype
    sb.encodings[cid] = _vi0(1, E_DIRECT)
    # unions carry no top-level validity (column.py UnionColumn)
    present = (None if isinstance(col, UnionColumn)
               else _host_validity(col))
    sb.counts[cid] = n if present is None else int(present.sum())
    sb.has_null[cid] = present is not None
    if present is not None:
        sb.add(cid, S_PRESENT, _bool_rle_write(present))
        sel = present
    else:
        sel = slice(None)

    if isinstance(col, StructColumn):
        for child in col.children:
            sub = _take_child(child, sel, n, present)
            ccid = next_id[0]
            _encode_column(sub, ccid, sb, sb.counts[cid], [ccid + 1])
            next_id[0] = ccid + _n_nodes(child.dtype)
        return
    if isinstance(col, UnionColumn):
        # DATA = byte-RLE tags (unions carry no top-level validity);
        # child i gets the rows tagged i, in row order
        tags = np.asarray(col.type_ids).astype(np.uint8)
        sb.add(cid, S_DATA, _byte_rle_write(tags.tobytes()))
        offsets = (None if col.offsets is None
                   else np.asarray(col.offsets).astype(np.int64))
        for i, child in enumerate(col.children):
            mask_i = tags == i
            if offsets is None:              # sparse: filter rows
                sub = _take_child(child, None, n, mask_i)
            else:                            # dense: gather child slots
                idx = offsets[mask_i]
                if not isinstance(child, Column):
                    raise UnsupportedLayout("orc write: dense union with "
                                            "nested children")
                take = np.zeros(len(child), bool)
                monotone = (np.all(np.diff(idx) > 0)
                            if len(idx) > 1 else True)
                if monotone:
                    take[idx] = True
                    sub = _take_child(child, None, len(child), take)
                else:
                    sub = Column(
                        child.data[idx], child.dtype,
                        validity=None if child.validity is None
                        else child.validity[idx],
                        dictionary=child.dictionary,
                        data2=None if child.data2 is None
                        else child.data2[idx])
            ccid = next_id[0]
            _encode_column(sub, ccid, sb, int(mask_i.sum()), [ccid + 1])
            next_id[0] = ccid + _n_nodes(child.dtype)
        return
    if isinstance(col, ListColumn):
        offs = np.asarray(col.offsets).astype(np.int64)
        lengths = (offs[1:] - offs[:-1])[sel]
        sb.add(cid, S_LENGTH, _rle_v1_write(lengths, signed=False))
        # child carries ALL values (offsets select); per spec the child
        # stream covers exactly the elements of non-null lists — rebuild
        values = col.values
        if present is not None:
            keep = np.zeros(int(offs[-1]), bool)
            for i in np.flatnonzero(present):
                keep[offs[i]: offs[i + 1]] = True
            values = _take_values(values, keep)
        total = int(lengths.sum())
        if t.kind == "map":
            kv = values   # RecordBatch(key, value)
            kcid = next_id[0]
            _encode_column(kv.columns[0], kcid, sb, total, [kcid + 1])
            vcid = kcid + _n_nodes(kv.columns[0].dtype)
            _encode_column(kv.columns[1], vcid, sb, total, [vcid + 1])
        else:
            ccid = next_id[0]
            _encode_column(values, ccid, sb, total, [ccid + 1])
        return

    data = np.asarray(col.data)
    k = t.kind
    if k == "bool":
        sb.add(cid, S_DATA, _bool_rle_write(data[sel]))
    elif k in ("int8", "uint8"):
        sb.add(cid, S_DATA, _byte_rle_write(
            data[sel].astype(np.uint8).tobytes()))
    elif k in ("int16", "int32", "int64", "uint16", "uint32",
               "date32", "time32", "time64"):
        sb.add(cid, S_DATA, _rle_v1_write(
            data[sel].astype(np.int64), signed=True))
    elif k == "timestamp":
        us = data[sel].astype(np.int64)
        # liborc convention (NOT the spec's floor + [0,1e9) nanos):
        # trunc-toward-zero seconds, SIGNED remainder nanos cast
        # through uint64 -- what liborc itself writes and reads back
        # for pre-1970 values
        secs = (us // 10**6) + ((us % 10**6 != 0) & (us < 0))
        secs = secs - _ORC_EPOCH_S
        rem = us - (secs + _ORC_EPOCH_S) * 10**6
        nanos = rem.astype(np.int64) * 1000
        sb.add(cid, S_DATA, _rle_v1_write(secs, signed=True))
        sb.add(cid, S_SECONDARY, _rle_v1_write(nanos << 3, signed=False))
    elif k == "float32":
        sb.add(cid, S_DATA, data[sel].astype("<f4").tobytes())
    elif k == "float64":
        sb.add(cid, S_DATA, data[sel].astype("<f8").tobytes())
    elif k == "decimal128":
        lo = data[sel].astype(np.int64)
        hi = (np.zeros(len(lo), np.int64) if col.data2 is None
              else np.asarray(col.data2)[sel].astype(np.int64))
        body = bytearray()
        scales = np.full(len(lo), t.scale, np.int64)
        for l_, h_ in zip(lo, hi):
            v = (int(h_) << 64) | (int(l_) & ((1 << 64) - 1))
            body += _enc_varint_u(_enc_zz(v))
        sb.add(cid, S_DATA, bytes(body))
        sb.add(cid, S_SECONDARY, _rle_v1_write(scales, signed=True))
    elif k in ("string", "binary"):
        pool = [v.encode("utf8") if isinstance(v, str) else bytes(v)
                for v in col.dictionary.values.tolist()]
        codes = data[sel].astype(np.int64)
        plens = np.array([len(v) for v in pool] or [0], np.int64)
        u_starts = np.zeros(len(plens) + 1, np.int64)
        np.cumsum(plens, out=u_starts[1:])
        lengths = plens[codes]
        flat = np.frombuffer(b"".join(pool) or b"\0", np.uint8)
        starts = u_starts[codes]
        within = np.arange(int(lengths.sum())) - np.repeat(
            np.cumsum(lengths) - lengths, lengths)
        body = flat[np.repeat(starts, lengths) + within]
        sb.add(cid, S_LENGTH, _rle_v1_write(lengths, signed=False))
        sb.add(cid, S_DATA, body.tobytes())
    else:
        raise UnsupportedLayout(f"orc write: unsupported type {t}")


def _n_nodes(t: dt.DataType) -> int:
    """Type nodes this dtype occupies in pre-order."""
    k = t.kind
    if k in ("list", "map", "struct", "sparse_union", "dense_union"):
        return 1 + sum(_n_nodes(ft) for _, ft in t.fields)
    return 1


def _take_child(child, sel, n: int, present) -> "Column":
    """Child column restricted to the parent's non-null slots."""
    if present is None:
        return child
    if isinstance(child, UnionColumn):
        raise UnsupportedLayout("orc write: a union under a nullable "
                                "parent")
    if isinstance(child, StructColumn):
        kids = tuple(_take_child(c, sel, n, present)
                     for c in child.children)
        validity = child.validity
        if validity is not None:
            validity = np.asarray(validity)[present]
        return StructColumn(kids, child.names, child.dtype,
                            validity=None if validity is None
                            else (validity))
    if isinstance(child, ListColumn):
        offs = np.asarray(child.offsets).astype(np.int64)
        lens = (offs[1:] - offs[:-1])[present]
        no = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=no[1:])
        keep = np.zeros(int(offs[-1]), bool)
        for i in np.flatnonzero(present):
            keep[offs[i]: offs[i + 1]] = True
        validity = child.validity
        if validity is not None:
            validity = np.asarray(validity)[present]
        return ListColumn((no),
                          _take_values(child.values, keep),
                          child.dtype, validity=validity)
    data = np.asarray(child.data)[present]
    kw = {}
    if child.validity is not None:
        kw["validity"] = np.asarray(child.validity)[present]
    if child.data2 is not None:
        kw["data2"] = (np.asarray(child.data2)[present])
    return Column((data), child.dtype,
                  dictionary=child.dictionary, **kw)


def _take_values(values, keep: np.ndarray):
    """List child values restricted to kept flat positions."""
    if isinstance(values, RecordBatch):
        return RecordBatch(tuple(_take_values(c, keep)
                                 for c in values.columns), values.names)
    if isinstance(values, ListColumn):
        offs = np.asarray(values.offsets).astype(np.int64)
        lens = (offs[1:] - offs[:-1])[keep]
        no = np.zeros(len(lens) + 1, np.int64)
        np.cumsum(lens, out=no[1:])
        inner = np.zeros(int(offs[-1]), bool)
        for i in np.flatnonzero(keep):
            inner[offs[i]: offs[i + 1]] = True
        validity = values.validity
        if validity is not None:
            validity = np.asarray(validity)[keep]
        return ListColumn((no),
                          _take_values(values.values, inner),
                          values.dtype, validity=validity)
    if isinstance(values, StructColumn):
        kids = tuple(_take_values(c, keep) for c in values.children)
        validity = values.validity
        if validity is not None:
            validity = np.asarray(validity)[keep]
        return StructColumn(kids, values.names, values.dtype,
                            validity=validity)
    kw = {}
    if values.validity is not None:
        kw["validity"] = np.asarray(values.validity)[keep]
    if values.data2 is not None:
        kw["data2"] = (np.asarray(values.data2)[keep])
    return Column(np.asarray(values.data)[keep],
                  values.dtype, dictionary=values.dictionary, **kw)


# ---------------------------------------------------------------------
# file assembly
# ---------------------------------------------------------------------

def write_orc_native(data: Union[RecordBatch, Table]) -> bytes:
    """The ORC file of ``data``, one stripe a RecordBatch. The stripes'
    streams are encoded on the CPU thread pool, then laid out in order."""
    from ..thread_pool import parallel_map

    batches = data.batches if isinstance(data, Table) else [data]
    types, col_of = _flatten_types(batches[0])
    n_types = len(types)

    def encode(batch) -> _StripeBuild:
        batch = map_tensors(batch, lambda t: t.cpu().numpy())
        n = batch.num_rows
        sb = _StripeBuild(n_types)
        sb.encodings[0] = _vi0(1, E_DIRECT)
        sb.counts[0] = n
        for c, cid in zip(batch.columns, col_of):
            _encode_column(c, cid, sb, n, [cid + 1])
        return sb

    # a stripe of no rows is not written (liborc refuses one)
    batches = [b for b in batches if b.num_rows]
    out = bytearray(b"ORC")
    stripe_infos: List[bytes] = []
    total_rows = 0
    agg_counts = [0] * n_types
    agg_nulls = [False] * n_types
    for batch, sb in zip(batches, parallel_map(encode, batches)):
        n = batch.num_rows
        total_rows += n
        offset = len(out)
        data_len = 0
        sf = b""
        for col, kind, raw in sb.streams:
            out += raw
            data_len += len(raw)
            sf += _ld(1, _vi0(1, kind) + _vi0(2, col)
                      + _vi0(3, len(raw)))
        for enc in sb.encodings:
            sf += _ld(2, enc or _vi0(1, E_DIRECT))
        sf += _ld(3, b"UTC")
        out += sf
        stripe_infos.append(
            _vi0(1, offset) + _vi0(2, 0) + _vi0(3, data_len)
            + _vi0(4, len(sf)) + _vi0(5, n))
        for i in range(n_types):
            agg_counts[i] += sb.counts[i]
            agg_nulls[i] = agg_nulls[i] or sb.has_null[i]

    footer = _vi(1, 3) + _vi(2, len(out))
    for si in stripe_infos:
        footer += _ld(3, si)
    for tp in types:
        footer += _ld(4, tp)
    footer += _vi(6, total_rows)
    for cnt, hn in zip(agg_counts, agg_nulls):
        footer += _ld(7, _vi(1, cnt) + (b"\x50\x01" if hn else b"\x50\x00"))
    footer += _vi(8, 0)          # rowIndexStride 0: no row indexes
    out += footer
    ps = (_vi0(1, len(footer)) + _vi0(2, K_NONE) + _vi0(3, 1 << 18)
          + _ld(4, _varint(0) + _varint(12))
          + _vi0(5, 0) + _vi0(6, 1) + _ld(8000, b"ORC"))
    out += ps
    out.append(len(ps))
    return bytes(out)
