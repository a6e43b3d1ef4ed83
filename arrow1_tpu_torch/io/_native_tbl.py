"""Shared ctypes surface of the native columnar text readers, CSV and JSON
(counterpart of arrow1_tpu/io/_native_tbl.py).

The C side (native/src/table_result.h) fills one Result per parse: typed
per-column vectors, strings dictionary-encoded at parse time.
``result_to_batch`` copies a handle's buffers into host-side columns of
the port's layouts and puts the batch on its device through the IPC
reader's one staging copy (``ipc_native._stage``):

- strings: int32 codes into a ``Dictionary`` pool of the distinct values;
- dates: date32 (int32 days), timestamps: int64 in their unit;
- lists: ``ListColumn`` (int64 offsets and one element child), objects:
  ``StructColumn``;
- a column with no value at all (the parsers' null type): a null-typed
  column, int8 zeros under an all-false validity.
"""

from __future__ import annotations

import ctypes

import numpy as np

from .. import dtypes as dt
from ..column import Column, Dictionary, ListColumn, StructColumn
from ..errors import Invalid
from ..table import RecordBatch
from .ipc_native import _stage

(_NULL, _INT64, _BOOL, _FLOAT64, _STRING, _LIST,
 _DATE32, _TS_S, _TS_NS) = range(9)
_sigs_done = False


def tbl_lib():
    """The native library with the parsers' signatures declared; raises
    when it cannot be built (the readers have no pure-Python parser)."""
    global _sigs_done
    from ..native import _require

    lib = _require()
    if not _sigs_done:
        c = ctypes
        lib.a1t_csv_parse.restype = c.c_void_p
        lib.a1t_csv_parse.argtypes = [
            c.c_char_p, c.c_int64, c.c_char, c.c_char, c.c_int, c.c_int64,
            c.c_int]
        lib.a1t_json_parse.restype = c.c_void_p
        lib.a1t_json_parse.argtypes = [c.c_char_p, c.c_int64, c.c_int]
        lib.a1t_tbl_error.restype = c.c_char_p
        lib.a1t_tbl_error.argtypes = [c.c_void_p]
        for fn, res in [("a1t_tbl_nrows", c.c_int64),
                        ("a1t_tbl_ncols", c.c_int32)]:
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = [c.c_void_p]
        for fn, res in [("a1t_tbl_col_name", c.c_char_p),
                        ("a1t_tbl_col_type", c.c_int32),
                        ("a1t_tbl_col_i64", c.POINTER(c.c_int64)),
                        ("a1t_tbl_col_f64", c.POINTER(c.c_double)),
                        ("a1t_tbl_col_bool", c.POINTER(c.c_uint8)),
                        ("a1t_tbl_col_codes", c.POINTER(c.c_int32)),
                        ("a1t_tbl_col_nuniq", c.c_int32),
                        ("a1t_tbl_col_offsets", c.POINTER(c.c_int32)),
                        ("a1t_tbl_col_bytes", c.POINTER(c.c_char)),
                        ("a1t_tbl_col_nbytes", c.c_int64),
                        ("a1t_tbl_col_valid", c.POINTER(c.c_uint8)),
                        ("a1t_tbl_col_noffsets", c.c_int64),
                        ("a1t_tbl_col_list_offsets",
                         c.POINTER(c.c_int64)),
                        ("a1t_tbl_col_elem_valid", c.POINTER(c.c_uint8)),
                        ("a1t_tbl_col_parent", c.c_char_p)]:
            getattr(lib, fn).restype = res
            getattr(lib, fn).argtypes = [c.c_void_p, c.c_int32]
        lib.a1t_tbl_free.argtypes = [c.c_void_p]
        _sigs_done = True
    return lib


def error_of(lib, h):
    """The parse's error message, or None."""
    err = lib.a1t_tbl_error(h)
    return err.decode() if err else None


def result_to_batch(lib, h, column_names=None, device=None) -> RecordBatch:
    """A native Result handle as a RecordBatch on ``device`` (a
    torch.device). The caller owns the handle and frees it afterwards.

    Columns form a tree through their parent links (any depth): list nodes
    carry offsets and one "<name>.$" element child; null-typed presence
    nodes with children are structs."""
    err = error_of(lib, h)
    if err:
        raise Invalid(err)
    nrows = lib.a1t_tbl_nrows(h)
    ncols = lib.a1t_tbl_ncols(h)
    meta = []
    children = {}   # parent name -> [column indices]
    for c in range(ncols):
        name = lib.a1t_tbl_col_name(h, c).decode()
        parent = (lib.a1t_tbl_col_parent(h, c) or b"").decode()
        meta.append((name, parent, lib.a1t_tbl_col_type(h, c)))
        if parent:
            children.setdefault(parent, []).append(c)

    def valid_of(c, count):
        if not count:
            return np.ones(0, bool)
        return np.ctypeslib.as_array(
            lib.a1t_tbl_col_valid(h, c), (count,)).astype(bool)

    def build(c, count):
        name, _, ty = meta[c]
        kids = children.get(name)
        if ty == _LIST:
            noffs = lib.a1t_tbl_col_noffsets(h, c)
            offs = np.ctypeslib.as_array(
                lib.a1t_tbl_col_list_offsets(h, c), (noffs,)).copy() \
                if noffs else np.zeros(1, np.int64)
            child = build(kids[0], int(offs[-1]))
            rv = valid_of(c, count)
            return ListColumn(offs, child, dt.list_(child.dtype),
                              validity=None if rv.all() else rv)
        if ty == _NULL and kids:
            presence = valid_of(c, count)
            pairs = []
            for k in kids:
                kname = meta[k][0]
                short = kname[len(name) + 1:] \
                    if kname.startswith(name + ".") else kname
                pairs.append((short, build(k, count)))
            return StructColumn(
                tuple(kc for _, kc in pairs), tuple(kn for kn, _ in pairs),
                dt.struct([(kn, kc.dtype) for kn, kc in pairs]),
                validity=None if presence.all() else presence)
        return _flat_column(lib, h, c, count, valid_of(c, count), ty)

    cols, names = [], []
    for c in range(ncols):
        name, parent, _ = meta[c]
        if parent:
            continue
        if column_names and len(names) < len(column_names):
            name = column_names[len(names)]
        cols.append(build(c, nrows))
        names.append(name)
    return _stage(RecordBatch(tuple(cols), tuple(names)), device)


def _flat_column(lib, h, c, nrows, valid, ty) -> Column:
    validity = None if valid.all() else valid

    def arr(getter, ctype=None):
        if not nrows:
            return np.zeros(0, ctype)
        return np.ctypeslib.as_array(getter(h, c), (nrows,)).copy()

    if ty == _INT64:
        return Column(arr(lib.a1t_tbl_col_i64, np.int64), dt.int64,
                      validity=validity)
    if ty == _DATE32:   # the CSV parser's promotions ride the i64 buffer
        return Column(arr(lib.a1t_tbl_col_i64, np.int64).astype(np.int32),
                      dt.date32, validity=validity)
    if ty in (_TS_S, _TS_NS):
        return Column(arr(lib.a1t_tbl_col_i64, np.int64),
                      dt.timestamp("s" if ty == _TS_S else "ns"),
                      validity=validity)
    if ty == _FLOAT64:
        return Column(arr(lib.a1t_tbl_col_f64, np.float64), dt.float64,
                      validity=validity)
    if ty == _BOOL:
        return Column(arr(lib.a1t_tbl_col_bool, np.uint8).astype(bool),
                      dt.bool_, validity=validity)
    if ty == _NULL:   # no value in any row
        return Column(np.zeros(nrows, np.int8), dt.null,
                      validity=np.zeros(nrows, bool))
    # strings, dictionary-encoded by the parser
    nuniq = lib.a1t_tbl_col_nuniq(h, c)
    nb = lib.a1t_tbl_col_nbytes(h, c)
    raw = ctypes.string_at(lib.a1t_tbl_col_bytes(h, c), nb) if nb else b""
    offs = np.ctypeslib.as_array(lib.a1t_tbl_col_offsets(h, c),
                                 (nuniq + 1,)).tolist() if nuniq else [0]
    uniq = np.empty(max(nuniq, 1), object)
    uniq[:] = [raw[offs[i]:offs[i + 1]].decode("utf8")
               for i in range(nuniq)] if nuniq else [""]
    return Column(arr(lib.a1t_tbl_col_codes, np.int32), dt.string,
                  validity=validity, dictionary=Dictionary(uniq))
