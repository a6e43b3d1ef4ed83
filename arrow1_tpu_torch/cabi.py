"""The Arrow C data interface, with the structs laid out here (counterpart
of arrow1_tpu/cabi.py).

Reference: cpp/src/arrow/c/abi.h:30 (ArrowSchema), :46 (ArrowArray), :85
(ArrowArrayStream) and c/bridge.cc's import and export. The structs are
ctypes structures, handed over as PyCapsules ("arrow_schema",
"arrow_array", "arrow_array_stream"), so any consumer of the ABI
(pyarrow, polars, duckdb, nanoarrow) exchanges columns with the port
without pyarrow on this side.

- Export copies each of a column's tensors to the host once (the card's
  columns included), packs its validity (and a bool column's values) into
  LSB-first bits and turns a string column's codes into Arrow's offsets
  and bytes with the IPC writer's native gather. The release callbacks
  live in the native library (native/src/cabi.cpp), so they outlive the
  Python runtime; a released export's buffers are freed at the next
  export.
- Import reads the foreign buffers in place, dictionary-encodes strings
  through the native MemoTable, and puts the column on ``device`` (CUDA
  unless the caller names the CPU) with the IPC reader's one staging copy
  (``io.ipc_native._stage``).

Layout (Columnar.rst): buffers are [validity, data] for a fixed-width
type, [validity, offsets, data] for a var-binary one, none for the null
type; validity is NULL when every slot is valid. Nested and dictionary
types are not walked here: ``cdata`` hands them to pyarrow's bridge.
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from . import dtypes as dt
from .column import Column
from .device import resolve_device
from .errors import Invalid
from .table import RecordBatch

__all__ = ["ArrowSchema", "ArrowArray", "ArrowArrayStream",
           "export_array_capsules", "import_array_capsules",
           "export_stream_capsule", "import_stream_capsule",
           "CArrayExportable", "CStreamExportable"]


class ArrowSchema(ctypes.Structure):
    pass


_SchemaReleaseFn = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowSchema))

ArrowSchema._fields_ = [
    ("format", ctypes.c_char_p),
    ("name", ctypes.c_char_p),
    ("metadata", ctypes.c_char_p),
    ("flags", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowSchema))),
    ("dictionary", ctypes.POINTER(ArrowSchema)),
    ("release", _SchemaReleaseFn),
    ("private_data", ctypes.c_void_p),
]


class ArrowArray(ctypes.Structure):
    pass


_ArrayReleaseFn = ctypes.CFUNCTYPE(None, ctypes.POINTER(ArrowArray))

ArrowArray._fields_ = [
    ("length", ctypes.c_int64),
    ("null_count", ctypes.c_int64),
    ("offset", ctypes.c_int64),
    ("n_buffers", ctypes.c_int64),
    ("n_children", ctypes.c_int64),
    ("buffers", ctypes.POINTER(ctypes.c_void_p)),
    ("children", ctypes.POINTER(ctypes.POINTER(ArrowArray))),
    ("dictionary", ctypes.POINTER(ArrowArray)),
    ("release", _ArrayReleaseFn),
    ("private_data", ctypes.c_void_p),
]

ARROW_FLAG_NULLABLE = 2

# format strings (abi.h, c/bridge.cc)
_FMT = {
    "null": "n", "bool": "b", "int8": "c", "uint8": "C", "int16": "s",
    "uint16": "S", "int32": "i", "uint32": "I", "int64": "l", "uint64": "L",
    "float16": "e", "float32": "f", "float64": "g",
    "string": "u", "large_string": "U", "binary": "z", "large_binary": "Z",
    "date32": "tdD", "date64": "tdm",
}
_FMT_REV = {v: k for k, v in _FMT.items()}
_TIME_FMT = {"s": "s", "ms": "m", "us": "u", "ns": "n"}
_TIME_REV = {v: k for k, v in _TIME_FMT.items()}


def _format_for(t: dt.DataType) -> str:
    if t.kind in _FMT:
        return _FMT[t.kind]
    if t.kind == "timestamp":
        return f"ts{_TIME_FMT[t.unit]}:{t.tz or ''}"
    if t.kind in ("time32", "time64"):
        return f"tt{_TIME_FMT[t.unit]}"
    if t.kind == "duration":
        return f"tD{_TIME_FMT[t.unit]}"
    if t.kind == "decimal128":
        return f"d:{t.precision},{t.scale}"
    if t.kind == "decimal256":
        return f"d:{t.precision},{t.scale},256"
    raise Invalid(f"cabi: unsupported export type {t}")


def _type_from_format(fmt: str) -> dt.DataType:
    if fmt in _FMT_REV:
        return dt.DataType(_FMT_REV[fmt])
    if fmt.startswith("ts") and fmt[2:3] in _TIME_REV:
        return dt.timestamp(_TIME_REV[fmt[2]], fmt[4:] or None)
    if fmt.startswith("tt") and fmt[2:3] in _TIME_REV:
        unit = _TIME_REV[fmt[2]]
        return dt.time32(unit) if unit in ("s", "ms") else dt.time64(unit)
    if fmt.startswith("tD") and fmt[2:3] in _TIME_REV:
        return dt.duration(_TIME_REV[fmt[2]])
    if fmt.startswith("d:"):
        parts = fmt[2:].split(",")
        if len(parts) == 3 and parts[2] == "256":
            return dt.decimal256(int(parts[0]), int(parts[1]))
        if len(parts) == 2 or (len(parts) == 3 and parts[2] == "128"):
            return dt.decimal128(int(parts[0]), int(parts[1]))
    raise Invalid(f"cabi: unsupported import format {fmt!r}")


class _Exports:
    """The exported structs and their buffers, kept alive until the
    consumer calls their release callbacks (c/bridge.cc producer rules).
    Release runs in the native library, which records the export's id;
    each export drains those ids first and frees what they hold, a
    released parent's children with it."""

    def __init__(self):
        self.live = {}   # id -> (kept objects, the children's ids)
        self.seq = 0

    def callbacks(self):
        from .native import load_library

        lib = load_library()
        if lib is None:
            raise Invalid("cabi export needs the native library (release "
                          "callbacks must outlive the Python runtime); no "
                          "C++ compiler, or its build failed")
        buf = (ctypes.c_int64 * 256)()
        while True:
            n = lib.a1t_cabi_drain(buf, 256)
            for i in range(n):
                self.drop(int(buf[i]))
            if n < 256:
                break
        return (ctypes.cast(lib.a1t_cabi_release_schema, _SchemaReleaseFn),
                ctypes.cast(lib.a1t_cabi_release_array, _ArrayReleaseFn))

    def keep(self, objs, children=()) -> int:
        self.seq += 1
        self.live[self.seq] = (objs, [int(k.private_data) for k in children])
        return self.seq

    def drop(self, sid: int) -> None:
        _, kids = self.live.pop(sid, (None, ()))
        for k in kids:
            self.drop(k)


_EXPORTS = _Exports()


def _schema(fmt: bytes, name: bytes, children=()) -> ArrowSchema:
    rel_s, _ = _EXPORTS.callbacks()
    s = ArrowSchema()
    s.format = fmt
    s.name = name
    s.metadata = None
    s.flags = 0 if children else ARROW_FLAG_NULLABLE
    s.n_children = len(children)
    kids = (ctypes.POINTER(ArrowSchema) * max(len(children), 1))()
    for i, k in enumerate(children):
        kids[i] = ctypes.pointer(k)
    s.children = kids if children else None
    s.dictionary = None
    s.release = rel_s
    s.private_data = _EXPORTS.keep((s, fmt, name, kids), children)
    return s


def _array(length: int, nulls: int, bufs: List, children=()) -> ArrowArray:
    _, rel_a = _EXPORTS.callbacks()
    a = ArrowArray()
    a.length = length
    a.null_count = nulls
    a.offset = 0
    a.n_buffers = len(bufs)
    ptrs = (ctypes.c_void_p * max(len(bufs), 1))()
    for i, b in enumerate(bufs):
        ptrs[i] = None if b is None else b.ctypes.data
    a.buffers = ptrs
    a.n_children = len(children)
    kids = (ctypes.POINTER(ArrowArray) * max(len(children), 1))()
    for i, k in enumerate(children):
        kids[i] = ctypes.pointer(k)
    a.children = kids if children else None
    a.dictionary = None
    a.release = rel_a
    a.private_data = _EXPORTS.keep((a, bufs, ptrs, kids), children)
    return a


def _host_buffers(col: Column) -> Tuple[List, int]:
    """(the column's ABI buffers as host numpy arrays, null count): each
    tensor copied to the host once."""
    from .io.ipc_native import _string_buffers

    n = col.length
    t = col.dtype
    if t.is_null:
        return [], n
    vbuf, nulls = None, 0
    if col.validity is not None:
        mask = col.validity.cpu().numpy()
        nulls = int(n - np.count_nonzero(mask))
        if nulls:
            vbuf = np.packbits(mask, bitorder="little")
    if t.is_boolean:
        return [vbuf, np.packbits(col.data.cpu().numpy(),
                                  bitorder="little")], nulls
    if t.is_decimal:
        words = np.empty((n, t.limbs), dtype="<i8")
        words[:, 0] = col.data.cpu().numpy()
        words[:, 1:] = col.data2.cpu().numpy().reshape(n, t.limbs - 1)
        return [vbuf, words], nulls
    if t.is_binary:
        offsets, data = _string_buffers(col)
        data = np.frombuffer(data, np.uint8) if isinstance(
            data, (bytes, bytearray)) else np.ascontiguousarray(data)
        return [vbuf, np.ascontiguousarray(offsets), data], nulls
    return [vbuf, np.ascontiguousarray(col.data.cpu().numpy())], nulls


def _export_pair(col: Column, name: str) -> Tuple[ArrowSchema, ArrowArray]:
    fmt = _format_for(col.dtype).encode()
    bufs, nulls = _host_buffers(col)
    return (_schema(fmt, name.encode()),
            _array(col.length, nulls, bufs))


_PyCapsule_New = ctypes.pythonapi.PyCapsule_New
_PyCapsule_New.restype = ctypes.py_object
_PyCapsule_New.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_void_p]
_PyCapsule_GetPointer = ctypes.pythonapi.PyCapsule_GetPointer
_PyCapsule_GetPointer.restype = ctypes.c_void_p
_PyCapsule_GetPointer.argtypes = [ctypes.py_object, ctypes.c_char_p]


def export_array_capsules(col: Column, name: str = ""):
    """("arrow_schema", "arrow_array") PyCapsules of one flat column. The
    structs live until the consumer calls their release callbacks."""
    s, a = _export_pair(col, name)
    return (_PyCapsule_New(ctypes.addressof(s), b"arrow_schema", None),
            _PyCapsule_New(ctypes.addressof(a), b"arrow_array", None))


def _np_from(ptr, count: int, dtype) -> np.ndarray:
    """A view of ``count`` items of foreign memory (zeros for none)."""
    if not ptr or count == 0:
        return np.zeros(count, dtype)
    raw = (ctypes.c_char * (count * np.dtype(dtype).itemsize)
           ).from_address(ptr)
    return np.frombuffer(raw, dtype=dtype, count=count)


def _bits_from(ptr, off: int, n: int) -> np.ndarray:
    bits = _np_from(ptr, (off + n + 7) // 8, np.uint8)
    return np.unpackbits(bits, bitorder="little", count=off + n)[off:] \
        .astype(bool)


def _host_column(s: ArrowSchema, a: ArrowArray) -> Column:
    """A foreign flat array as a host-side column of the port's layout
    (numpy arrays in its tensor slots)."""
    from .io.ipc_native import _FieldInfo, _load_strings

    if s.dictionary:
        raise Invalid("cabi import: a dictionary-encoded array; cdata "
                      "hands it to pyarrow's bridge")
    t = _type_from_format((s.format or b"").decode())
    n, off = a.length, a.offset
    bufs = [a.buffers[i] if a.buffers else None
            for i in range(a.n_buffers)]
    if t.is_null:
        return Column(np.zeros(n, np.int8), t, validity=np.zeros(n, bool))
    validity = _bits_from(bufs[0], off, n) \
        if a.null_count != 0 and bufs[0] else None
    if t.is_boolean:
        return Column(_bits_from(bufs[1], off, n), t, validity=validity)
    if t.is_decimal:
        words = _np_from(bufs[1], (off + n) * t.limbs, "<i8").reshape(
            -1, t.limbs)[off:]
        return Column(words[:, 0], t, validity=validity,
                      data2=words[:, 1] if t.limbs == 2 else words[:, 1:])
    if t.is_binary:
        odt = np.int64 if t.kind.startswith("large") else np.int32
        offsets = _np_from(bufs[1], off + n + 1, odt)[off:]
        data = _np_from(bufs[2], int(offsets[-1]) if len(offsets) else 0,
                        np.uint8)
        return _load_strings(_FieldInfo(s.name, t, None, None), n, validity,
                             [None, offsets.view(np.uint8), data])
    return Column(_np_from(bufs[1], off + n, t.numpy_dtype())[off:], t,
                  validity=validity)


def import_array_capsules(schema_capsule, array_capsule,
                          device=None) -> Column:
    """("arrow_schema", "arrow_array") capsules -> a Column on ``device``
    (CUDA unless the caller names the CPU), walking the C structs
    (c/bridge.cc's import side)."""
    from .io.ipc_native import _stage

    dev = resolve_device(device)
    s = ArrowSchema.from_address(
        _PyCapsule_GetPointer(schema_capsule, b"arrow_schema"))
    a = ArrowArray.from_address(
        _PyCapsule_GetPointer(array_capsule, b"arrow_array"))
    return _stage(_host_column(s, a), dev)


class CArrayExportable:
    """A Column behind the ``__arrow_c_array__`` protocol, so that any
    consumer of the ABI can take it."""

    def __init__(self, col: Column, name: str = ""):
        self._col = col
        self._name = name

    def __arrow_c_array__(self, requested_schema=None):
        return export_array_capsules(self._col, self._name)


# ====================================================================
# ArrowArrayStream (reference: c/abi.h:85, c/stream.cc): the struct and
# its callbacks are built here; pyarrow's RecordBatchReader.from_stream
# takes the capsule over the raw ABI.
# ====================================================================

class ArrowArrayStream(ctypes.Structure):
    pass


_StreamGetSchemaFn = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.POINTER(ArrowArrayStream),
    ctypes.POINTER(ArrowSchema))
_StreamGetNextFn = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.POINTER(ArrowArrayStream),
    ctypes.POINTER(ArrowArray))
_StreamGetErrFn = ctypes.CFUNCTYPE(
    ctypes.c_char_p, ctypes.POINTER(ArrowArrayStream))
_StreamReleaseFn = ctypes.CFUNCTYPE(
    None, ctypes.POINTER(ArrowArrayStream))

ArrowArrayStream._fields_ = [
    ("get_schema", _StreamGetSchemaFn),
    ("get_next", _StreamGetNextFn),
    ("get_last_error", _StreamGetErrFn),
    ("release", _StreamReleaseFn),
    ("private_data", ctypes.c_void_p),
]

_EINVAL = 22


def _struct_schema(batch: RecordBatch) -> ArrowSchema:
    """The stream's batch type: a struct ('+s') of one child a column."""
    return _schema(b"+s", b"", [
        _schema(_format_for(c.dtype).encode(), name.encode())
        for name, c in zip(batch.names, batch.columns)])


def _struct_array(batch: RecordBatch) -> ArrowArray:
    """A struct array of no validity, one child a column."""
    kids = []
    for c in batch.columns:
        bufs, nulls = _host_buffers(c)
        kids.append(_array(c.length, nulls, bufs))
    return _array(batch.num_rows, 0, [None], kids)


def export_stream_capsule(batches: Sequence[RecordBatch]):
    """An "arrow_array_stream" PyCapsule over ``batches``. Its callbacks
    move freshly exported structs into the consumer's (the ABI's move
    semantics); their buffers live until each struct's own release."""
    batches = list(batches)
    if not batches:
        raise Invalid("export_stream_capsule: need at least one batch")
    it = iter(batches)
    first = batches[0]

    def get_schema(stream_ptr, out_ptr):
        try:
            s = _struct_schema(first)
            ctypes.memmove(out_ptr, ctypes.addressof(s),
                           ctypes.sizeof(ArrowSchema))
            return 0
        except Exception:   # a C callback reports the failure by its code
            return _EINVAL

    def get_next(stream_ptr, out_ptr):
        try:
            batch = next(it, None)
            if batch is None:   # the end: a released (zeroed) array
                ctypes.memset(out_ptr, 0, ctypes.sizeof(ArrowArray))
                return 0
            a = _struct_array(batch)
            ctypes.memmove(out_ptr, ctypes.addressof(a),
                           ctypes.sizeof(ArrowArray))
            return 0
        except Exception:   # a C callback reports the failure by its code
            return _EINVAL

    def get_last_error(stream_ptr):
        return None

    st = ArrowArrayStream()
    st.get_schema = _StreamGetSchemaFn(get_schema)
    st.get_next = _StreamGetNextFn(get_next)
    st.get_last_error = _StreamGetErrFn(get_last_error)
    sid = _EXPORTS.keep(None)

    def release(stream_ptr):
        stream_ptr.contents.release = _StreamReleaseFn()
        _EXPORTS.drop(sid)

    st.release = _StreamReleaseFn(release)
    st.private_data = sid
    _EXPORTS.live[sid] = ((st, st.get_schema, st.get_next,
                           st.get_last_error, st.release, it), [])
    return _PyCapsule_New(ctypes.addressof(st), b"arrow_array_stream", None)


class CStreamExportable:
    """An ``__arrow_c_stream__`` provider over the port's batches (what
    pa.RecordBatchReader.from_stream and duckdb-style consumers take)."""

    def __init__(self, batches: Sequence[RecordBatch]):
        self._batches = list(batches)

    def __arrow_c_stream__(self, requested_schema=None):
        return export_stream_capsule(self._batches)


def import_stream_capsule(capsule, device=None) -> List[RecordBatch]:
    """An "arrow_array_stream" capsule -> its RecordBatches on ``device``
    (CUDA unless the caller names the CPU): the foreign stream's callbacks
    are called here and each struct batch imported child by child over
    the ABI (c/stream.cc's import side), each batch staged in one copy."""
    from .io.ipc_native import _stage

    dev = resolve_device(device)
    st = ArrowArrayStream.from_address(
        _PyCapsule_GetPointer(capsule, b"arrow_array_stream"))
    schema = ArrowSchema()
    if st.get_schema(ctypes.byref(st), ctypes.byref(schema)):
        raise Invalid("stream get_schema failed")
    try:
        if (schema.format or b"") != b"+s":
            raise Invalid(f"stream import: batch format "
                          f"{schema.format!r} (want a struct)")
        kids = [schema.children[i].contents
                for i in range(schema.n_children)]
        names = tuple((k.name or b"").decode() for k in kids)
        out = []
        while True:
            arr = ArrowArray()
            if st.get_next(ctypes.byref(st), ctypes.byref(arr)):
                raise Invalid("stream get_next failed")
            if not arr.release:
                return out
            try:
                if arr.n_children != len(kids):
                    raise Invalid("stream import: a batch's children differ "
                                  "from the schema's")
                cols = tuple(_host_column(k, arr.children[i].contents)
                             for i, k in enumerate(kids))
                out.append(_stage(RecordBatch(cols, names), dev))
            finally:
                arr.release(ctypes.byref(arr))
    finally:
        if schema.release:
            schema.release(ctypes.byref(schema))
        if st.release:
            st.release(ctypes.byref(st))
