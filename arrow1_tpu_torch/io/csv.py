"""CSV reader and writer (counterpart of arrow1_tpu/io/csv.py).

Reference: cpp/src/arrow/csv/ (parallel chunker, parser and converter:
csv/reader.cc:697,882, parser.cc BlockParser, converter.cc type
inference). The reader is the repository's C++ parser
(native/src/csv.cpp): a parallel quote-parity prescan finds the record
boundaries, rows split into fields in parallel, and each column's type
is inferred along the reference's promotion chain (null -> int64 -> bool
-> date32 -> timestamp[s] -> timestamp[ns] -> float64 -> string,
csv/inference_internal.h:34-65). Its typed buffers become the port's
columns on the device in one staging copy (``_native_tbl``).

pyarrow.csv reads only what the native parser declines before it reads
(``UnsupportedLayout``): ``convert_options``, an ``escape_char``, quoting
turned off, or an encoding other than UTF-8. A malformed file raises
``Invalid``; a missing path raises ``FileNotFoundError``.

The writer formats column by column into byte matrices with numpy
(integers, floats, booleans, strings, date32 and naive second-to-
microsecond timestamps; the other types through their Python values)
and its bytes equal the reference writer's: RFC-4180 quoting, a null as
a bare empty field, an empty string as ``""``, ``true``/``false``, each
float as Python's ``repr``.
"""

from __future__ import annotations

import dataclasses
import io as _io
import os
from typing import Iterator, List, Union

import numpy as np

from ..device import resolve_device
from ..table import RecordBatch, Table
from .ipc_native import UnsupportedLayout

__all__ = ["read_csv", "write_csv", "open_csv_stream"]


def _as_bytes(path_or_buf) -> bytes:
    """The whole input: bytes as is, a path's contents, a file object read
    to its end."""
    if isinstance(path_or_buf, (bytes, bytearray, memoryview)):
        return bytes(path_or_buf)
    if isinstance(path_or_buf, (str, os.PathLike)):
        with open(path_or_buf, "rb") as f:
            return f.read()
    data = path_or_buf.read()
    return data.encode() if isinstance(data, str) else bytes(data)


def _native_options(read_options, parse_options, convert_options):
    """The native parser's (delimiter, quote, column names, header, skip
    rows, skip rows after names); ``UnsupportedLayout`` for the options it
    does not take."""
    if convert_options is not None:
        raise UnsupportedLayout("csv: convert_options")
    quote = getattr(parse_options, "quote_char", '"')
    if quote in (False, None):
        raise UnsupportedLayout("csv: quoting turned off")
    if getattr(parse_options, "escape_char", False) not in (False, None):
        raise UnsupportedLayout("csv: an escape character")
    if getattr(read_options, "encoding", "utf8") not in ("utf8", "utf-8",
                                                          None):
        raise UnsupportedLayout("csv: an encoding other than UTF-8")
    delimiter = getattr(parse_options, "delimiter", ",") or ","
    names = getattr(read_options, "column_names", None)
    autogen = getattr(read_options, "autogenerate_column_names", False)
    return (delimiter, quote, list(names) if names else None,
            not (names or autogen),
            getattr(read_options, "skip_rows", 0) or 0,
            getattr(read_options, "skip_rows_after_names", 0) or 0)


def _native_read(data: bytes, opts, dev) -> RecordBatch:
    from ._native_tbl import result_to_batch, tbl_lib

    delimiter, quote, names, header, skip, skip_after = opts
    lib = tbl_lib()
    h = lib.a1t_csv_parse(data, len(data), delimiter.encode(),
                          quote.encode(), 1 if header else 0, skip, 0)
    try:
        batch = result_to_batch(lib, h, names, dev)
    finally:
        lib.a1t_tbl_free(h)
    return batch.slice(skip_after) if skip_after else batch


def _to_pa(opts, pa_cls):
    """An options dataclass of the facades as the pyarrow class (pyarrow
    takes no other); a pyarrow object or None passes through."""
    if opts is None or not dataclasses.is_dataclass(opts):
        return opts
    return pa_cls(**{f.name: getattr(opts, f.name)
                     for f in dataclasses.fields(opts)
                     if getattr(opts, f.name) != f.default})


def _pyarrow_read(data: bytes, read_options, parse_options,
                  convert_options, dev) -> RecordBatch:
    from pyarrow import csv as pacsv

    from ..interop import record_batch_from_arrow

    tbl = pacsv.read_csv(
        _io.BytesIO(data),
        read_options=_to_pa(read_options, pacsv.ReadOptions),
        parse_options=_to_pa(parse_options, pacsv.ParseOptions),
        convert_options=_to_pa(convert_options, pacsv.ConvertOptions))
    return record_batch_from_arrow(tbl, device=dev)


def read_csv(path_or_buf, read_options=None, parse_options=None,
             convert_options=None, device=None) -> Table:
    """A CSV file (a path, bytes or a file object) as a one-batch Table on
    ``device`` (CUDA unless the caller names the CPU)."""
    dev = resolve_device(device)
    data = _as_bytes(path_or_buf)
    try:
        opts = _native_options(read_options, parse_options,
                               convert_options)
    except UnsupportedLayout:
        return Table([_pyarrow_read(data, read_options, parse_options,
                                    convert_options, dev)])
    return Table([_native_read(data, opts, dev)])


def open_csv_stream(path_or_buf, batch_rows: int = 1 << 16, device=None,
                    **kwargs) -> Iterator[RecordBatch]:
    """Streaming CSV reader (reference: csv/reader.cc's streaming reader):
    the file's batches of ``batch_rows`` rows on ``device``. The native
    parser reads the whole input once and the batches are views of its
    columns; keyword options go to pyarrow.csv.open_csv."""
    dev = resolve_device(device)
    data = _as_bytes(path_or_buf)
    if kwargs:
        from pyarrow import csv as pacsv

        from ..interop import record_batch_from_arrow

        for batch in pacsv.open_csv(_io.BytesIO(data), **kwargs):
            yield record_batch_from_arrow(batch, device=dev)
        return
    batch = _native_read(data, _native_options(None, None, None), dev)
    for lo in range(0, max(batch.num_rows, 1), batch_rows):
        yield batch.slice(lo, batch_rows)


# ====================================================================
# writer: each column of a chunk of rows as a field, a byte matrix (rows x
# width) and a mask of the bytes that belong to each row's value; fields
# and literals are joined side by side and the rows read out in one pass
# ====================================================================

_POW10 = np.array([10 ** i for i in range(20)], np.uint64)
_CHUNK = 1 << 17   # rows a task formats (bounds its matrices)


def _quote_text(s: str, special: frozenset) -> str:
    """The reference writer's quoting of one formatted value."""
    if s == "" or any(c in special for c in s):
        return '"' + s.replace('"', '""') + '"'
    return s


def _lit(b: bytes, n: int):
    """The literal ``b`` in each of ``n`` rows."""
    mat = np.broadcast_to(np.frombuffer(b, np.uint8), (n, len(b)))
    return mat, np.ones((n, len(b)), bool)


def _join(*fields):
    """Fields side by side: one field of their values concatenated."""
    return (np.hstack([f[0] for f in fields]),
            np.hstack([f[1] for f in fields]))


def _pool_field(pool: List[bytes], codes: np.ndarray):
    """A field whose values are ``pool[codes]``."""
    w = max([len(p) for p in pool] + [1])
    mat = np.zeros((len(pool), w), np.uint8)
    mask = np.zeros((len(pool), w), bool)
    for i, p in enumerate(pool):
        mat[i, :len(p)] = np.frombuffer(p, np.uint8)
        mask[i, :len(p)] = True
    return mat[codes], mask[codes]


def _text_field(texts: np.ndarray):
    """A field from an array of ASCII bytes ('S' dtype, NUL-padded)."""
    w = max(texts.dtype.itemsize, 1)
    mat = np.frombuffer(np.ascontiguousarray(texts).tobytes(),
                        np.uint8).reshape(len(texts), w)
    return mat, mat != 0


def _digits(u: np.ndarray, width: int = 1):
    """Decimal digits of uint64 ``u``, at least ``width`` of them
    (zero-padded), right-aligned in as many columns as the largest needs."""
    n = len(u)
    top = int(u.max()) if n else 0
    w = max(width, len(str(top)))
    x = u.astype(np.int64) if top < 1 << 63 else u.copy()
    mat = np.empty((n, w), np.uint8)
    for j in range(w - 1, -1, -1):
        x, r = np.divmod(x, 10)
        mat[:, j] = r
    mat += 48
    ndig = np.full(n, width, np.int64)
    for i in range(width, w):
        ndig += u >= _POW10[i]
    return mat, np.arange(w - 1, -1, -1)[None, :] < ndig[:, None]


def _int_field(x: np.ndarray, signed: bool = True):
    """Python's str() of each integer."""
    if not signed:
        return _digits(x.astype(np.uint64))
    x = x.astype(np.int64)
    neg = x < 0
    if not neg.any():
        return _digits(x.view(np.uint64))
    u = x.view(np.uint64).copy()
    u[neg] = ~u[neg] + np.uint64(1)
    sign = (np.full((len(x), 1), ord("-"), np.uint8), neg[:, None])
    return _join(sign, _digits(u))


def _float_field(v: np.ndarray):
    """Python's repr() of each float64. A value that is a whole number of
    hundredths below 1e13 in magnitude is that decimal with its trailing
    zeros dropped (no shorter decimal lies within half an ulp of it), and
    is formatted with integer digits; the rest go through numpy's shortest
    round-trip formatting, which equals repr()."""
    v = v.astype(np.float64)
    n = len(v)
    with np.errstate(invalid="ignore", over="ignore"):
        k = np.rint(v * 100.0)
        fast = np.isfinite(v) & (np.abs(v) < 1e13) & (k / 100.0 == v)
    ak = np.where(fast, np.abs(k), 0).astype(np.uint64)
    cents = (ak % np.uint64(100)).astype(np.int64)
    neg = np.signbit(v)
    sign = (np.full((n, 1), ord("-"), np.uint8), neg[:, None])
    tens = cents // 10
    frac = np.stack([tens, cents % 10], 1).astype(np.uint8) + 48
    fmask = np.stack([np.ones(n, bool), cents % 10 != 0], 1)
    mat, mask = _join(sign, _digits(ak // np.uint64(100)), _lit(b".", n),
                      (frac, fmask))
    if not fast.all():
        slow = ~fast
        smat, smask = _text_field(v[slow].astype("S32"))
        w = max(mat.shape[1], smat.shape[1])
        mat, mask = (np.pad(a, ((0, 0), (0, w - a.shape[1])))
                     for a in (mat, mask))
        mat[slow], mask[slow] = 0, False
        mat[slow, :smat.shape[1]] = smat
        mask[slow, :smat.shape[1]] = smask
    return mat, mask


def _civil(days: np.ndarray):
    """(year, month, day) of days since 1970-01-01 (proleptic Gregorian)."""
    z = days.astype(np.int64) + 719468
    era = np.floor_divide(z, 146097)
    doe = z - era * 146097
    yoe = (doe - doe // 1460 + doe // 36524 - doe // 146096) // 365
    doy = doe - (365 * yoe + yoe // 4 - yoe // 100)
    mp = (5 * doy + 2) // 153
    d = doy - (153 * mp + 2) // 5 + 1
    m = np.where(mp < 10, mp + 3, mp - 9)
    return yoe + era * 400 + (m <= 2), m, d


def _date_field(days: np.ndarray):
    """str() of each date: "YYYY-MM-DD" (formatted once for each day of
    the values' range where that range is shorter than the values)."""
    days = days.astype(np.int64)
    n = len(days)
    if n and 2 * (int(days.max()) - int(days.min()) + 1) <= n:
        lo = int(days.min())
        mat, mask = _date_field(np.arange(lo, int(days.max()) + 1))
        return mat[days - lo], mask[days - lo]
    y, m, d = (a.astype(np.uint64) for a in _civil(days))
    return _join(_digits(y, 4), _lit(b"-", n), _digits(m, 2), _lit(b"-", n),
                 _digits(d, 2))


def _timestamp_field(x: np.ndarray, unit: str):
    """str() of each naive datetime: "YYYY-MM-DD HH:MM:SS[.ffffff]"."""
    n = len(x)
    us = x.astype(np.int64) * {"s": 10 ** 6, "ms": 1000, "us": 1}[unit]
    days = np.floor_divide(us, 86400 * 10 ** 6)
    rem = us - days * 86400 * 10 ** 6
    secs = (rem // 10 ** 6).astype(np.uint64)
    micro = (rem % 10 ** 6).astype(np.uint64)
    frac, fmask = _join(_lit(b".", n), _digits(micro, 6))
    fmask = fmask & (micro != 0)[:, None]
    return _join(_date_field(days), _lit(b" ", n),
                 _digits(secs // np.uint64(3600), 2), _lit(b":", n),
                 _digits(secs // np.uint64(60) % np.uint64(60), 2),
                 _lit(b":", n), _digits(secs % np.uint64(60), 2),
                 (frac, fmask))


def _python_field(values: list, special):
    """The reference writer's formatting of Python values, one by one
    (the types without a vectorized form)."""
    out = []
    for v in values:
        if v is None:
            out.append(b"")
            continue
        if isinstance(v, bool):
            s = "true" if v else "false"
        elif isinstance(v, float):
            s = repr(v)
        elif isinstance(v, bytes):
            s = v.decode("utf8", errors="replace")
        else:
            s = str(v)
        out.append(_quote_text(s, special).encode("utf8"))
    return _pool_field(out, np.arange(len(out)))


def _texts(field) -> List[str]:
    return [bytes(r[m]).decode("utf8") for r, m in zip(*field)]


def _column_field(col, lo: int, hi: int, special, pools: dict):
    """One column's rows [lo, hi) as a field (a null slot empty);
    ``pools`` keeps each string pool's formatted values across chunks."""
    from ..column import Column

    t = col.dtype
    k = t.kind
    vectorized = isinstance(col, Column) and (
        t.is_integer or t.is_floating or t.is_binary or k in ("bool",
                                                              "date32")
        or (k == "timestamp" and t.unit != "ns" and not t.tz))
    if not vectorized:
        return _python_field(col.slice(lo, hi - lo).to_arrow().to_pylist(),
                             special)
    data = col.data[lo:hi].cpu().numpy()
    if t.is_binary:
        key = id(col.dictionary)
        if key not in pools:
            pools[key] = (col.dictionary, _pool_field([
                _quote_text(v if isinstance(v, str) else
                            bytes(v).decode("utf8", errors="replace"),
                            special).encode("utf8")
                for v in col.dictionary.values.tolist()] or [b""],
                np.arange(max(len(col.dictionary), 1))))
        mat, mask = pools[key][1]
        codes = data.astype(np.int64)
        field = mat[codes], mask[codes]
    else:
        if k == "bool":
            field = _pool_field([b"false", b"true"], data.astype(np.int64))
        elif t.is_floating:
            field = _float_field(data)
        elif t.is_integer:
            field = _int_field(data, t.is_signed_integer)
        elif k == "date32":
            field = _date_field(data)
        else:
            field = _timestamp_field(data, t.unit)
        if special - frozenset('"\n\r') & frozenset(
                "-.:0123456789aefilnrstu+ "):
            # a delimiter that can occur in a formatted value quotes it
            texts = [_quote_text(s, special).encode("utf8")
                     for s in _texts(field)]
            field = _pool_field(texts, np.arange(len(texts)))
    if col.validity is not None:
        valid = col.validity[lo:hi].cpu().numpy()
        field = (field[0], field[1] & valid[:, None])
    return field


def _rows(fields, delimiter: bytes) -> bytes:
    """Fields joined by the delimiter, each row ended by a newline."""
    n = len(fields[0][0])
    parts = []
    for i, f in enumerate(fields):
        parts.append(f)
        parts.append(_lit(b"\n" if i == len(fields) - 1 else delimiter, n))
    mat, mask = _join(*parts)
    return mat[mask].tobytes()


def write_csv(data: Union[RecordBatch, Table], path,
              delimiter: str = ",", include_header: bool = True):
    """Write a RecordBatch or Table as CSV to a path or a (text or binary)
    file object (reference: csv/writer.cc). Chunks of rows are formatted
    on the CPU thread pool (numpy releases the interpreter lock), as many
    at once as the pool has threads, and written in order."""
    from ..column import Column
    from ..thread_pool import cpu_count, parallel_map

    batches = data.batches if isinstance(data, Table) else [data]
    special = frozenset(delimiter + '"\n\r')
    close = isinstance(path, (str, bytes, os.PathLike))
    sink = open(path, "wb") if close else path
    text = isinstance(sink, _io.TextIOBase)

    def emit(b: bytes):
        sink.write(b.decode("utf8") if text else b)

    try:
        if include_header and batches:
            emit((delimiter.join(_quote_text(n, special)
                                 for n in batches[0].names) + "\n")
                 .encode("utf8"))
        delim = delimiter.encode("utf8")
        pools = {}
        for b in batches:   # the pools first: the tasks only read them
            for c in b.columns:
                if isinstance(c, Column) and c.dtype.is_binary:
                    _column_field(c, 0, 0, special, pools)

        def chunk(job):
            b, lo, hi = job
            if not b.columns:
                return b"\n" * (hi - lo)
            return _rows([_column_field(c, lo, hi, special, pools)
                          for c in b.columns], delim)

        jobs = [(b, lo, min(lo + _CHUNK, b.num_rows)) for b in batches
                for lo in range(0, b.num_rows, _CHUNK)]
        step = cpu_count()
        for i in range(0, len(jobs), step):
            for out in parallel_map(chunk, jobs[i:i + step]):
                emit(out)
    finally:
        if close:
            sink.close()
