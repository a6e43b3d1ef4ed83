"""Newline-delimited JSON reader (counterpart of arrow1_tpu/io/json.py).

Reference: cpp/src/arrow/json/ (parallel block parse, json/reader.cc;
per-key column assembly and inference, json/converter.cc). The parser
is the repository's C++ one (native/src/json.cpp): lines parse to
(key, token) maps in parallel, the union of the keys in first-appearance
order makes the columns, inference follows null -> int64 -> bool ->
float64 -> string, strings are unescaped (\\uXXXX with surrogate pairs)
and dictionary-encoded as they are parsed. Arrays and objects nest to
any depth and become ``ListColumn`` and ``StructColumn``
(``_native_tbl``), on the device in one staging copy.

pyarrow.json reads only what the native parser declines
(``UnsupportedLayout``): an explicit schema or any other read or parse
option, and a column that holds both scalars and arrays or objects,
which the parser reports before it builds any column. A malformed line
raises ``Invalid``; a missing path raises ``FileNotFoundError``.
"""

from __future__ import annotations

import io as _io

from ..device import resolve_device
from ..errors import Invalid
from ..table import Table
from .csv import _as_bytes, _to_pa
from .ipc_native import UnsupportedLayout

__all__ = ["read_json"]

_MIXED = "json: mixed nested/scalar column"


def _native_read(data: bytes, dev):
    from ._native_tbl import error_of, result_to_batch, tbl_lib

    lib = tbl_lib()
    h = lib.a1t_json_parse(data, len(data), 0)
    try:
        err = error_of(lib, h)
        if err and err.startswith(_MIXED):
            raise UnsupportedLayout(err)
        if err:
            raise Invalid(err)
        return result_to_batch(lib, h, None, dev)
    finally:
        lib.a1t_tbl_free(h)


def read_json(path_or_buf, read_options=None, parse_options=None,
              device=None) -> Table:
    """Newline-delimited JSON (a path, bytes or a file object) as a
    one-batch Table on ``device`` (CUDA unless the caller names the
    CPU)."""
    dev = resolve_device(device)
    data = _as_bytes(path_or_buf)
    try:
        if read_options is not None or parse_options is not None:
            raise UnsupportedLayout("json: read or parse options")
        return Table([_native_read(data, dev)])
    except UnsupportedLayout:
        from pyarrow import json as pajson

        from ..interop import record_batch_from_arrow

        tbl = pajson.read_json(
            _io.BytesIO(data),
            read_options=_to_pa(read_options, pajson.ReadOptions),
            parse_options=_to_pa(parse_options, pajson.ParseOptions))
        return Table([record_batch_from_arrow(tbl, device=dev)])
