"""C++-side Arrow IPC reader and writer bindings (native/src/ipc_file.cpp
and native/src/ipc_write.cpp; counterpart of arrow1_tpu/io/ipc_cpp.py).
Numpy in, numpy out: nothing here touches the device.

This is the cross-language path for the wire format: a C/C++ program
(or any FFI-capable runtime) links libarrow1_tpu_native and walks —
or now PRODUCES — IPC files without Python on the path, the two-way
counterpart of the C-ABI consumer (native/src/cabi.cpp). Reference
surface: the multi-language IPC implementations the reference ships
(e.g. go/arrow/ipc, js/src/ipc) over the same framing
(cpp/src/arrow/ipc/message.h:238).

`read_ipc_cpp(path)` / `write_ipc_cpp(path, ...)` drive the pair from
Python via ctypes for flat primitive and var-binary schemas; other
schemas raise so that callers use the full Python implementation
(io/ipc_native.py). The library is the port's own build of native/src
(``arrow1_tpu_torch.native``).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from ..native import load_library

__all__ = ["read_ipc_cpp", "write_ipc_cpp", "ipc_cpp_available"]

_TYPES = {
    1: np.int8, 2: np.int16, 3: np.int32, 4: np.int64,
    5: np.uint8, 6: np.uint16, 7: np.uint32, 8: np.uint64,
    9: np.float32, 10: np.float64, 11: np.bool_,
}
# var-binary value types (validity, offsets, data — Columnar.rst:104)
T_STR, T_BIN, T_LSTR, T_LBIN = 12, 13, 14, 15

_configured = False


def _lib():
    global _configured
    lib = load_library()
    if lib is None:
        return None
    if not _configured:
        lib.a1t_ipc_open.restype = ctypes.c_void_p
        lib.a1t_ipc_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.a1t_ipc_err.restype = ctypes.c_int32
        lib.a1t_ipc_err.argtypes = [ctypes.c_void_p]
        lib.a1t_ipc_close.argtypes = [ctypes.c_void_p]
        lib.a1t_ipc_ncols.restype = ctypes.c_int32
        lib.a1t_ipc_ncols.argtypes = [ctypes.c_void_p]
        lib.a1t_ipc_nbatches.restype = ctypes.c_int32
        lib.a1t_ipc_nbatches.argtypes = [ctypes.c_void_p]
        lib.a1t_ipc_col_name.restype = ctypes.c_char_p
        lib.a1t_ipc_col_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.a1t_ipc_col_type.restype = ctypes.c_int32
        lib.a1t_ipc_col_type.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.a1t_ipc_batch_rows.restype = ctypes.c_int64
        lib.a1t_ipc_batch_rows.argtypes = [ctypes.c_void_p,
                                           ctypes.c_int32]
        lib.a1t_ipc_col_data.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.a1t_ipc_col_data.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64)]
        lib.a1t_ipc_col_validity.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.a1t_ipc_col_validity.argtypes = lib.a1t_ipc_col_data.argtypes
        lib.a1t_ipc_col_nulls.restype = ctypes.c_int64
        lib.a1t_ipc_col_nulls.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int32]
        lib.a1t_ipc_col_offsets.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.a1t_ipc_col_offsets.argtypes = lib.a1t_ipc_col_data.argtypes
        lib.a1t_ipc_col_dict_index_type.restype = ctypes.c_int32
        lib.a1t_ipc_col_dict_index_type.argtypes = [
            ctypes.c_void_p, ctypes.c_int32]
        lib.a1t_ipc_dict_rows.restype = ctypes.c_int64
        lib.a1t_ipc_dict_rows.argtypes = [ctypes.c_void_p,
                                          ctypes.c_int32]
        for fn in (lib.a1t_ipc_dict_data, lib.a1t_ipc_dict_offsets,
                   lib.a1t_ipc_dict_validity):
            fn.restype = ctypes.POINTER(ctypes.c_uint8)
            fn.argtypes = [ctypes.c_void_p, ctypes.c_int32,
                           ctypes.POINTER(ctypes.c_uint64)]
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.a1t_ipcw_new.restype = ctypes.c_void_p
        lib.a1t_ipcw_close.argtypes = [ctypes.c_void_p]
        lib.a1t_ipcw_err.restype = ctypes.c_int32
        lib.a1t_ipcw_err.argtypes = [ctypes.c_void_p]
        lib.a1t_ipcw_add_col.restype = ctypes.c_int32
        lib.a1t_ipcw_add_col.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32]
        lib.a1t_ipcw_add_batch.restype = ctypes.c_int32
        lib.a1t_ipcw_add_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(u8p),
            ctypes.POINTER(u8p), ctypes.POINTER(ctypes.c_int64)]
        lib.a1t_ipcw_add_batch2.restype = ctypes.c_int32
        lib.a1t_ipcw_add_batch2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(u8p),
            ctypes.POINTER(u8p), ctypes.POINTER(u8p),
            ctypes.POINTER(ctypes.c_int64)]
        lib.a1t_ipcw_add_dict_col.restype = ctypes.c_int32
        lib.a1t_ipcw_add_dict_col.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32]
        lib.a1t_ipcw_set_dict.restype = ctypes.c_int32
        lib.a1t_ipcw_set_dict.argtypes = [
            ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), u8p]
        lib.a1t_ipcw_finish.restype = u8p
        lib.a1t_ipcw_finish.argtypes = [
            ctypes.c_void_p, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_uint64)]
        lib.a1t_ipcw_free_buf.argtypes = [u8p]
        _configured = True
    return lib


def ipc_cpp_available() -> bool:
    return _lib() is not None


_CODES = {np.dtype(v): k for k, v in _TYPES.items()}


def write_ipc_cpp(path: str, names, columns, validities=None,
                  stream: bool = False) -> None:
    """Write an Arrow IPC file (or stream) through the C++ writer.

    `columns`: list of 1-D numpy arrays (flat primitive dtypes only);
    `validities`: optional list of bool ndarrays (True = valid) or
    None entries for all-valid columns. Raises ValueError for dtypes
    outside the writer's scope so callers use io/ipc_native.py.
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    if len(names) != len(columns):
        raise ValueError("names/columns length mismatch")
    if validities is not None and len(validities) != len(columns):
        raise ValueError("validities must have one entry per column "
                         f"({len(validities)} != {len(columns)})")
    def _rows_of(col):
        return len(col[0]) if isinstance(col, tuple) else len(col)

    rows = _rows_of(columns[0]) if columns else 0
    h = lib.a1t_ipcw_new()
    try:
        u8p = ctypes.POINTER(ctypes.c_uint8)
        keep = []  # packed buffers must outlive the add_batch call

        def _var_kind(col):
            """-> T_STR/T_BIN for string-like columns, else None."""
            if isinstance(col, np.ndarray):
                if col.dtype.kind == "U":
                    return T_STR
                if col.dtype.kind == "S":
                    return T_BIN
                if col.dtype == object and len(col):
                    if all(isinstance(x, (str, type(None)))
                           for x in col):
                        return T_STR
                    if all(isinstance(x, (bytes, type(None)))
                           for x in col):
                        return T_BIN
            return None

        def _pack_var(col, kind):
            enc = [(b"" if x is None else
                    (x.encode() if kind == T_STR else bytes(x)))
                   for x in col]
            offs = np.zeros(len(enc) + 1, np.int32)
            np.cumsum([len(e) for e in enc], out=offs[1:])
            data = b"".join(enc)
            buf = np.frombuffer(data, np.uint8).copy() if data else \
                np.zeros(1, np.uint8)
            return offs, buf

        for name, col in zip(names, columns):
            if isinstance(col, tuple):         # (indices, values) dict
                idx, values = col
                idx = np.ascontiguousarray(idx)
                icode = _CODES.get(idx.dtype)
                vk = T_STR if all(
                    isinstance(x, str) for x in values) else T_BIN
                if icode is None or icode > 8:
                    raise ValueError("ipc_cpp: bad dict index dtype")
                ci = lib.a1t_ipcw_add_dict_col(h, name.encode(), vk,
                                               icode, 1)
                if ci < 0:
                    raise ValueError(f"ipc_cpp: add_dict_col err "
                                     f"{lib.a1t_ipcw_err(h)}")
                offs, buf = _pack_var(np.asarray(values, object), vk)
                keep += [offs, buf]
                if lib.a1t_ipcw_set_dict(
                        h, ci, len(values),
                        offs.ctypes.data_as(
                            ctypes.POINTER(ctypes.c_int32)),
                        buf.ctypes.data_as(u8p)) < 0:
                    raise ValueError(f"ipc_cpp: set_dict err "
                                     f"{lib.a1t_ipcw_err(h)}")
                continue
            vk = _var_kind(col)
            if vk is not None:
                code = vk
            else:
                col = np.ascontiguousarray(col)
                code = _CODES.get(col.dtype)
                if code is None:
                    raise ValueError(
                        f"ipc_cpp: unsupported dtype {col.dtype} (use "
                        "the Python writer)")
            if lib.a1t_ipcw_add_col(h, name.encode(), code, 1) < 0:
                raise ValueError(f"ipc_cpp: add_col err "
                                 f"{lib.a1t_ipcw_err(h)}")
        n = len(columns)
        data_arr = (u8p * n)()
        offs_arr = (u8p * n)()
        val_arr = (u8p * n)()
        nulls_arr = (ctypes.c_int64 * n)()
        for i, col in enumerate(columns):
            if isinstance(col, tuple):
                col = np.ascontiguousarray(col[0])   # dict indices
            vk = _var_kind(col)
            if vk is not None:
                offs, buf = _pack_var(col, vk)
                keep += [offs, buf]
                data_arr[i] = buf.ctypes.data_as(u8p)
                offs_arr[i] = offs.view(np.uint8).ctypes.data_as(u8p)
                if len(col) != rows:
                    raise ValueError("ragged batch")
            else:
                col = np.ascontiguousarray(col)
                if len(col) != rows:
                    raise ValueError("ragged batch")
                if col.dtype == np.bool_:
                    col = np.packbits(col.astype(np.uint8),
                                      bitorder="little")
                keep.append(col)
                data_arr[i] = col.ctypes.data_as(u8p)
                offs_arr[i] = None
            v = validities[i] if validities else None
            if v is None:
                val_arr[i] = None
                nulls_arr[i] = 0
            else:
                v = np.asarray(v, np.bool_)
                packed = np.packbits(v.astype(np.uint8),
                                     bitorder="little")
                keep.append(packed)
                val_arr[i] = packed.ctypes.data_as(u8p)
                nulls_arr[i] = int(rows - int(v.sum()))
        if lib.a1t_ipcw_add_batch2(h, rows, data_arr, offs_arr,
                                   val_arr, nulls_arr) < 0:
            raise ValueError(f"ipc_cpp: add_batch err "
                             f"{lib.a1t_ipcw_err(h)}")
        out_len = ctypes.c_uint64()
        buf = lib.a1t_ipcw_finish(h, 1 if stream else 0,
                                  ctypes.byref(out_len))
        if not buf:
            raise ValueError(f"ipc_cpp: finish err {lib.a1t_ipcw_err(h)}")
        try:
            blob = bytes(ctypes.cast(
                buf, ctypes.POINTER(ctypes.c_uint8 * out_len.value)
            ).contents)
        finally:
            lib.a1t_ipcw_free_buf(buf)
        with open(path, "wb") as fh:
            fh.write(blob)
    finally:
        lib.a1t_ipcw_close(h)


def read_ipc_cpp(path: str, materialize_dicts: bool = True):
    """Read an IPC file/stream through the C++ reader.

    Returns (names, batches) where each batch is a list of
    (values, validity bool ndarray or None) per column. Fixed-width
    columns come back as typed ndarrays; utf8/binary columns (plain or
    dictionary-encoded) as object ndarrays — with
    materialize_dicts=False a dictionary column is returned as
    ("dict", indices ndarray, values object ndarray) instead, the
    engine's native string form. Raises ValueError for schemas outside
    the C++ reader's scope (nested columns, compressed bodies,
    dictionary deltas).
    """
    lib = _lib()
    if lib is None:
        raise RuntimeError("native library unavailable")
    with open(path, "rb") as fh:
        buf = fh.read()
    h = lib.a1t_ipc_open(buf, len(buf))
    if not h:
        raise ValueError("ipc_cpp: open failed")
    try:
        err = lib.a1t_ipc_err(h)
        if err == 2:
            raise ValueError("ipc_cpp: compressed body unsupported")
        if err:
            raise ValueError(f"ipc_cpp: parse error {err}")
        ncols = lib.a1t_ipc_ncols(h)
        names: List[str] = []
        kinds = []   # ("fixed", dtype) | ("var", code) | ("dict", idx_dt)
        for c in range(ncols):
            t = lib.a1t_ipc_col_type(h, c)
            it = lib.a1t_ipc_col_dict_index_type(h, c)
            if it:
                if it not in _TYPES or t not in (T_STR, T_BIN,
                                                 T_LSTR, T_LBIN):
                    raise ValueError(
                        "ipc_cpp: unsupported dictionary column")
                kinds.append(("dict", (np.dtype(_TYPES[it]), t)))
            elif t in _TYPES:
                kinds.append(("fixed", np.dtype(_TYPES[t])))
            elif t in (T_STR, T_BIN, T_LSTR, T_LBIN):
                kinds.append(("var", t))
            else:
                raise ValueError(
                    "ipc_cpp: unsupported column type (use the Python "
                    "reader)")
            names.append(lib.a1t_ipc_col_name(h, c).decode())

        def _bytes_at(ptr, nbytes):
            return bytes(ctypes.cast(
                ptr, ctypes.POINTER(ctypes.c_uint8 * nbytes)
            ).contents) if nbytes else b""

        def _var_values(code, offs_raw, data_raw, count):
            odt = np.int64 if code in (T_LSTR, T_LBIN) else np.int32
            offs = np.frombuffer(offs_raw, odt)[:count + 1]
            out = np.empty(count, object)
            text = code in (T_STR, T_LSTR)
            for i in range(count):
                chunk = data_raw[offs[i]:offs[i + 1]]
                out[i] = chunk.decode() if text else chunk
            return out

        def _dict_values(c, code):
            count = lib.a1t_ipc_dict_rows(h, c)
            if count < 0:
                raise ValueError("ipc_cpp: missing dictionary batch")
            n = ctypes.c_uint64()
            optr = lib.a1t_ipc_dict_offsets(h, c, ctypes.byref(n))
            offs_raw = _bytes_at(optr, n.value)
            dptr = lib.a1t_ipc_dict_data(h, c, ctypes.byref(n))
            data_raw = _bytes_at(dptr, n.value)
            return _var_values(code, offs_raw, data_raw, count)

        batches = []
        for b in range(lib.a1t_ipc_nbatches(h)):
            rows = lib.a1t_ipc_batch_rows(h, b)
            cols: List[Tuple[np.ndarray, np.ndarray]] = []
            for c in range(ncols):
                kind, meta = kinds[c]
                n = ctypes.c_uint64()
                ptr = lib.a1t_ipc_col_data(h, b, c, ctypes.byref(n))
                raw = _bytes_at(ptr, n.value)
                if kind == "var":
                    no = ctypes.c_uint64()
                    optr = lib.a1t_ipc_col_offsets(h, b, c,
                                                   ctypes.byref(no))
                    vals = _var_values(meta, _bytes_at(optr, no.value),
                                       raw, rows)
                elif kind == "dict":
                    idx_dt, vcode = meta
                    idx = np.frombuffer(raw, idx_dt)[:rows]
                    dvals = _dict_values(c, vcode)
                    if materialize_dicts:
                        vals = np.empty(rows, object)
                        ii = np.clip(idx.astype(np.int64), 0,
                                     max(len(dvals) - 1, 0))
                        for i in range(rows):
                            vals[i] = dvals[ii[i]] if len(dvals) \
                                else None
                    else:
                        vals = ("dict", idx, dvals)
                elif meta == np.bool_:
                    bits = np.frombuffer(raw, np.uint8)
                    vals = np.unpackbits(bits, bitorder="little")[:rows] \
                        .astype(np.bool_)
                else:
                    vals = np.frombuffer(raw, meta)[:rows]
                vptr = lib.a1t_ipc_col_validity(h, b, c, ctypes.byref(n))
                valid = None
                if lib.a1t_ipc_col_nulls(h, b, c) > 0 and n.value:
                    vraw = _bytes_at(vptr, n.value)
                    valid = np.unpackbits(
                        np.frombuffer(vraw, np.uint8),
                        bitorder="little")[:rows].astype(np.bool_)
                cols.append((vals, valid))
            batches.append(cols)
        return names, batches
    finally:
        lib.a1t_ipc_close(h)
