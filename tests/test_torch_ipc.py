"""The port's Arrow IPC and Feather layer (arrow1_tpu_torch/io/ipc_native.py,
io/ipc.py, ipc.py, io/feather1.py, feather.py, io/prefetch.py) against the
JAX package and pyarrow, on ``device="cpu"``.

One batch per type family (integers with uint64 above 2^63, floats with
NaN, -0.0 and infinities, bools, strings, large strings, binaries and
dictionaries with nulls, dates, times, timestamps and durations,
decimal128 and decimal256, list, large_list, fixed_size_list, struct,
map and both unions), zero rows and all-null columns, in the stream and
file formats, uncompressed, LZ4 and ZSTD:

- the port reads pyarrow's files and the JAX package's, and gets what the
  JAX package reads from the same bytes (integers, bools, masks and
  strings exactly, floats bit for bit) and the source;
- pyarrow and the JAX package read the port's files back to the source.

Then a multi-batch Table, the twins of tests/test_ipc_fuzz.py (corrupt
bytes raise ``Invalid``), tests/test_feather_v1.py and the prefetch tests
that need no parquet. Where the JAX package is wrong against pyarrow,
pyarrow decides (``REFERENCE_FAULTS``, ROADMAP Queue 3).
"""

import builtins
import io
import struct
import time
import warnings
from decimal import Context, Decimal

import numpy as np
import pyarrow as pa
import pyarrow.feather as paf
import pyarrow.ipc as pi
import pytest
import torch

import arrow1_tpu as a1t
from arrow1_tpu.io import ipc_native as ref_ipc

import arrow1_tpu_torch as pt
from arrow1_tpu_torch import feather, ipc
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.interop import record_batch_from_arrow
from arrow1_tpu_torch.io import ipc as pio
from arrow1_tpu_torch.io import ipc_native
from arrow1_tpu_torch.io.feather1 import read_feather_v1
from arrow1_tpu_torch.io.prefetch import MergedIterator, prefetch_batches

CPU = "cpu"


def families(n=40, seed=0):
    rng = np.random.default_rng(seed)
    nulls = rng.random(n) < 0.2

    def m(vals):
        return [None if nulls[i] else v for i, v in enumerate(vals)]

    f64 = rng.standard_normal(n)
    f64[:4] = [np.nan, -0.0, np.inf, -np.inf]
    ctx = Context(prec=100)
    lens = rng.integers(0, 4, n)
    lst = [rng.integers(-5, 5, k).tolist() for k in lens]
    ids = (np.arange(n) % 2).astype(np.int8)
    out = {
        "ints": pa.record_batch({
            "i8": pa.array(m(rng.integers(-128, 128, n).tolist()), pa.int8()),
            "i16": pa.array(m(rng.integers(-2**15, 2**15, n).tolist()),
                            pa.int16()),
            "i32": pa.array(m(rng.integers(-2**31, 2**31, n).tolist()),
                            pa.int32()),
            "i64": pa.array(m(rng.integers(-2**62, 2**62, n).tolist()),
                            pa.int64()),
            "u8": pa.array(rng.integers(0, 256, n).astype(np.uint8)),
            "u16": pa.array(m(rng.integers(0, 2**16, n).tolist()),
                            pa.uint16()),
            "u32": pa.array(rng.integers(0, 2**32, n).astype(np.uint32)),
            "u64": pa.array(m((rng.integers(0, 2**63, n).astype(np.uint64)
                               * 2 + 1).tolist()), pa.uint64()),
        }),
        "floats": pa.record_batch({
            "f64": pa.array(f64), "f32": pa.array(f64.astype(np.float32)),
            "f64n": pa.array(m(f64.tolist()), pa.float64()),
        }),
        "bools": pa.record_batch({
            "b": pa.array(rng.random(n) < 0.5),
            "bn": pa.array(m((rng.random(n) < 0.5).tolist()), pa.bool_()),
        }),
        "strings": pa.record_batch({
            "s": pa.array(m([f"v{i % 7}é" for i in range(n)])),
            "ls": pa.array(m([f"w{i % 5}" for i in range(n)]),
                           pa.large_string()),
            "bin": pa.array(m([bytes([i % 3, 0, 255]) for i in range(n)]),
                            pa.binary()),
            "dict": pa.array(m([f"d{i % 4}" for i in range(n)]))
            .dictionary_encode(),
        }),
        "temporal": pa.record_batch({
            "d32": pa.array(m(rng.integers(-1000, 20000, n).tolist()),
                            pa.date32()),
            "d64": pa.array((rng.integers(-1000, 20000, n)
                             * 86_400_000).tolist(), pa.date64()),
            "ts_s": pa.array(rng.integers(-10**9, 10**9, n).tolist(),
                             pa.timestamp("s")),
            "ts_ns": pa.array(m(rng.integers(-10**18, 10**18, n).tolist()),
                              pa.timestamp("ns", "UTC")),
            "ts_ms": pa.array(rng.integers(-10**12, 10**12, n).tolist(),
                              pa.timestamp("ms", "America/New_York")),
            "t32": pa.array(rng.integers(0, 86400, n).astype(np.int32),
                            pa.time32("s")),
            "t64": pa.array(m(rng.integers(0, 86400 * 10**6, n).tolist()),
                            pa.time64("us")),
            "dur": pa.array(m(rng.integers(-10**9, 10**9, n).tolist()),
                            pa.duration("ms")),
        }),
        "decimals": pa.record_batch({
            "dec": pa.array(m([Decimal(int(v)).scaleb(-10, ctx) for v in
                               rng.integers(-2**62, 2**62, n) * 37]),
                            pa.decimal128(38, 10)),
            "dec256": pa.array(m([Decimal(int(v) * 10**50 + 7) for v in
                                  rng.integers(-2**62, 2**62, n)]),
                               pa.decimal256(76, 0)),
        }),
        "nested": pa.record_batch({
            "l": pa.array(m(lst), pa.list_(pa.int64())),
            "ll": pa.array(m([[float(x) for x in v] for v in lst]),
                           pa.large_list(pa.float64())),
            "fsl": pa.array(m([[i, i + 1] for i in range(n)]),
                            pa.list_(pa.int32(), 2)),
            "st": pa.array(m([{"a": i, "b": f"x{i % 3}"} for i in range(n)]),
                           pa.struct([("a", pa.int64()), ("b", pa.string())])),
            "m": pa.array(m([[(f"k{j}", j) for j in range(k)] for k in lens]),
                          pa.map_(pa.string(), pa.int64())),
            "su": pa.UnionArray.from_sparse(
                pa.array(ids), [pa.array(m(list(range(n))), pa.int64()),
                                pa.array([f"s{i}" for i in range(n)])]),
            "du": pa.UnionArray.from_dense(
                pa.array(ids), pa.array((np.arange(n) // 2).astype(np.int32)),
                [pa.array(list(range((n + 1) // 2)), pa.int64()),
                 pa.array([f"u{i}" for i in range(n // 2)])]),
        }),
    }
    out["empty"] = pa.record_batch(
        {k: v[:0] for k, v in zip(out["ints"].schema.names,
                                  out["ints"].columns)}
        | {"s": out["strings"]["s"][:0], "l": out["nested"]["l"][:0]})
    out["all_null"] = pa.record_batch({
        "i": pa.nulls(n, pa.int64()), "f": pa.nulls(n, pa.float64()),
        "s": pa.nulls(n, pa.string()), "b": pa.nulls(n, pa.bool_()),
        "l": pa.nulls(n, pa.list_(pa.int64()))})
    return out


FAMILIES = families()
WAYS = [("stream", None), ("file", None), ("file", "lz4"), ("stream", "zstd")]
CASES = [(f, fmt, codec) for f in FAMILIES for fmt, codec in WAYS]
REF_WAYS = [("stream", None), ("file", "lz4")]
# the JAX package's writer fails on an all-null string column (an empty
# value pool; ROADMAP Queue 3): pyarrow decides, the port writes it
REFERENCE_FAULTS = {"all_null"}


def _case_id(case):
    return "-".join(str(x) for x in case)


def _pa_bytes(rb, fmt, codec) -> bytes:
    sink = io.BytesIO()
    opts = pi.IpcWriteOptions(compression=codec)
    new = pi.new_stream if fmt == "stream" else pi.new_file
    with new(sink, rb.schema, options=opts) as w:
        w.write_batch(rb)
    return sink.getvalue()


def _write(mod, batch, fmt, codec) -> bytes:
    sink = io.BytesIO()
    (mod.write_stream if fmt == "stream" else mod.write_file)(
        sink, batch, compression=codec)
    return sink.getvalue()


def _ref_read(data, fmt):
    read = ref_ipc.read_stream if fmt == "stream" else ref_ipc.read_file
    return read(io.BytesIO(data))


def _port_read(data, fmt):
    read = ipc_native.read_stream if fmt == "stream" else \
        ipc_native.read_file
    return read(io.BytesIO(data), device=CPU)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def canon(col):
    """A column (the port's or the JAX package's) as comparable lists: the
    null mask, then the valid slots' values (strings decoded, floats as
    their bits, a decimal's limbs); nested columns through pyarrow."""
    if not hasattr(col, "data") or getattr(col, "offsets", None) is not None:
        return col.to_arrow().to_pylist()
    data = _np(col.data)
    n = len(data)
    valid = np.ones(n, bool) if col.validity is None else \
        _np(col.validity).astype(bool)
    if col.dictionary is not None:
        pool = np.asarray(col.dictionary.values, dtype=object)
        vals = pool[data[valid]].tolist() if len(pool) else []
        return valid.tolist(), vals
    if data.dtype.kind == "f":
        data = data.view({8: np.int64, 4: np.int32, 2: np.int16}[
            data.dtype.itemsize])
    out = [valid.tolist(), data[valid].tolist()]
    if getattr(col, "data2", None) is not None:
        out.append(_np(col.data2)[valid].tolist())
    return out


def canon_batch(batch):
    return {n: canon(c) for n, c in zip(batch.names, batch.columns)}


def same_arrow(got, want):
    """Two pyarrow arrays equal, floats bit for bit (NaN, -0.0); a
    dictionary array as its decoded values."""
    got, want = (a.combine_chunks() if isinstance(a, pa.ChunkedArray)
                 else a for a in (got, want))
    want = want.dictionary_decode() if pa.types.is_dictionary(want.type) \
        else want
    got = got.dictionary_decode() if pa.types.is_dictionary(got.type) \
        else got
    if got.type != want.type or len(got) != len(want):
        return False
    if pa.types.is_floating(want.type):
        bits = {64: np.int64, 32: np.int32, 16: np.int16}[
            want.type.bit_width]
        return got.is_null().equals(want.is_null()) and np.array_equal(
            got.fill_null(0).to_numpy(zero_copy_only=False).view(bits),
            want.fill_null(0).to_numpy(zero_copy_only=False).view(bits))
    return got.to_pylist() == want.to_pylist()


def same_as_source(batch_arrow, rb):
    for name in rb.schema.names:
        assert same_arrow(batch_arrow.column(name), rb.column(name)), name


@pytest.fixture(scope="module")
def jax_results():
    """The JAX package's side, computed once: its reading of pyarrow's
    and of the port's files, and its own files (with its reading of
    them)."""
    out = {"pa": {}, "port": {}, "ref": {}}
    for fam, fmt, codec in CASES:
        rb = FAMILIES[fam]
        data = _pa_bytes(rb, fmt, codec)
        out["pa"][fam, fmt, codec] = (data, canon_batch(
            _ref_read(data, fmt)[0]))
        data = _write(ipc_native, record_batch_from_arrow(rb, CPU), fmt,
                      codec)
        out["port"][fam, fmt, codec] = (data, canon_batch(
            _ref_read(data, fmt)[0]))
    for fam in FAMILIES:
        for fmt, codec in REF_WAYS:
            try:
                data = _write(ref_ipc, a1t.record_batch(FAMILIES[fam]), fmt,
                              codec)
            except Exception as e:   # a reference fault, asserted below
                out["ref"][fam, fmt, codec] = e
                continue
            out["ref"][fam, fmt, codec] = (data, canon_batch(
                _ref_read(data, fmt)[0]))
    return out


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_port_reads_pyarrow_files(jax_results, case):
    fam, fmt, _ = case
    data, ref_canon = jax_results["pa"][case]
    (batch,) = _port_read(data, fmt)
    assert all(getattr(c, "device", torch.device(CPU)).type == CPU
               for c in batch.columns)
    assert canon_batch(batch) == ref_canon
    same_as_source(batch.to_arrow(), FAMILIES[fam])


@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_pyarrow_and_reference_read_port_files(jax_results, case):
    fam, fmt, _ = case
    data, ref_canon = jax_results["port"][case]
    rb = FAMILIES[fam]
    read = pi.open_stream if fmt == "stream" else pi.open_file
    got = read(data).read_all()
    same_as_source(got, rb)
    assert ref_canon == canon_batch(record_batch_from_arrow(rb, CPU))


@pytest.mark.parametrize("case", [(f, fmt, c) for f in FAMILIES
                                  for fmt, c in REF_WAYS], ids=_case_id)
def test_port_reads_reference_files(jax_results, case):
    fam, fmt, _ = case
    got = jax_results["ref"][case]
    if fam in REFERENCE_FAULTS:
        assert isinstance(got, Exception)
        return
    data, ref_canon = got
    (batch,) = _port_read(data, fmt)
    assert canon_batch(batch) == ref_canon
    same_as_source(batch.to_arrow(), FAMILIES[fam])


def test_multi_batch_table_through_files(tmp_path):
    """A Table of three batches with their own string pools through
    write_ipc/read_ipc, the stream writer, and pyarrow both ways."""
    rbs = [families(n=30, seed=s)["strings"] for s in (1, 2, 3)]
    rbs = [rb.drop_columns(["dict"]) for rb in rbs]
    table = pt.Table([record_batch_from_arrow(rb, CPU) for rb in rbs])
    path = tmp_path / "t.arrow"
    pio.write_ipc(table, path, compression="lz4")
    want = pa.Table.from_batches(rbs)
    assert pi.open_file(path).read_all().equals(want)
    back = pio.read_ipc(path, device=CPU)
    assert len(back.batches) == 3
    assert back.to_arrow().equals(want)
    assert [b.num_rows for b in pio.read_ipc(path, batched=True,
                                             device=CPU)] == [30, 30, 30]
    sink = io.BytesIO()
    with pio.IpcStreamWriter(sink) as w:
        for b in table.batches:
            w.write_batch(b)
    assert pi.open_stream(sink.getvalue()).read_all().equals(want)
    assert pt.Table(list(pio.IpcStreamReader(sink.getvalue(), device=CPU))
                    ).to_arrow().equals(want)
    sink = io.BytesIO()
    with pi.new_file(sink, want.schema) as w:
        w.write_table(want)
    assert ipc.open_file(sink.getvalue(), device=CPU).read_all() \
        .to_arrow().equals(want)


def test_stream_read_from_where_a_file_object_stands(tmp_path):
    """A stream after other bytes in a file object is read from the
    object's position, as the JAX package and pyarrow read it."""
    rb = FAMILIES["ints"]
    data = _write(ipc_native, record_batch_from_arrow(rb, CPU), "stream",
                  None)
    path = tmp_path / "s.bin"
    path.write_bytes(b"header!!" + data)
    with open(path, "rb") as f:
        f.seek(8)
        (batch,) = ipc_native.read_stream(f, device=CPU)
    same_as_source(batch.to_arrow(), rb)
    buf = io.BytesIO(b"xyz" + data)
    buf.seek(3)
    (batch,) = ipc.open_stream(buf, device=CPU)
    same_as_source(batch.to_arrow(), rb)


def test_schema_only_and_dictionary_typed_columns():
    rb = FAMILIES["nested"]
    sink = io.BytesIO()
    with ipc.new_stream(sink, rb.schema):
        pass
    assert pi.open_stream(sink.getvalue()).read_all().schema == rb.schema
    (empty,) = _port_read(sink.getvalue(), "stream")
    assert empty.num_rows == 0 and empty.to_arrow().schema == rb.schema
    # a dictionary-typed column travels as a dictionary with its pool;
    # two batches with different pools cannot share one (pyarrow's file
    # writer refuses the same)
    col = pt.call_function("dictionary_encode", [pt.interop.column_from_numpy(
        np.array(["x", "y", "x", None], dtype=object), device=CPU)])
    assert col.dtype.is_dictionary
    batch = pt.RecordBatch((col,), ("d",))
    data = _write(ipc_native, [batch, batch], "file", None)
    got = pi.open_file(data).read_all().column("d")
    assert pa.types.is_dictionary(got.type)
    assert got.to_pylist() == ["x", "y", "x", None] * 2
    other = pt.RecordBatch((pt.call_function("dictionary_encode", [
        pt.interop.column_from_numpy(np.array(["z"] * 4, dtype=object),
                                     device=CPU)]),), ("d",))
    with pytest.raises(Invalid, match="dictionaries"):
        _write(ipc_native, [batch, other], "file", None)


def test_flatbuffers_equal_the_flatbuffers_package(monkeypatch):
    """The port's builder gives the bytes the flatbuffers package gives
    for the same schemas, batches and footers."""
    import flatbuffers

    batch = record_batch_from_arrow(FAMILIES["nested"], CPU)
    mine = _write(ipc_native, [batch, batch], "file", "lz4")
    monkeypatch.setattr(ipc_native, "Builder", flatbuffers.Builder)
    assert _write(ipc_native, [batch, batch], "file", "lz4") == mine


def test_native_path_imports_no_pyarrow_jax_or_flatbuffers(monkeypatch):
    batch = record_batch_from_arrow(FAMILIES["temporal"], CPU)
    real_import = builtins.__import__

    def guarded(name, *a, **k):
        if name.split(".")[0] in ("pyarrow", "flatbuffers", "jax",
                                  "zstandard", "pandas"):
            raise AssertionError(f"the native IPC path imported {name}")
        return real_import(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", guarded)
    data = _write(ipc_native, batch, "file", "lz4")
    (back,) = _port_read(data, "file")
    monkeypatch.setattr(builtins, "__import__", real_import)
    assert canon_batch(back) == canon_batch(batch)


def test_read_ipc_wants_cuda_and_falls_back_only_when_unsupported(
        tmp_path, monkeypatch):
    path = tmp_path / "x.arrow"
    rb = pa.record_batch({"iv": pa.array([pa.MonthDayNano([1, 2, 3])]),
                          "i": pa.array([1])})
    with pi.new_file(path, rb.schema) as w:
        w.write_batch(rb)
    with pytest.raises(RuntimeError, match="CUDA"):
        pio.read_ipc(path)
    # an interval: the native reader's UnsupportedLayout, read by pyarrow
    got = pio.read_ipc(path, device=CPU).batches[0]
    assert got["iv"].dtype.kind == "month_day_nano_interval"
    assert got.to_arrow().equals(rb)
    # corrupt bytes: Invalid, never a pyarrow fallback
    data = bytearray(_pa_bytes(FAMILIES["ints"], "file", None))
    data[-12:-10] = b"\xff\x7f"
    monkeypatch.setattr(pio, "_pyarrow_batches", None)
    with pytest.raises(Invalid):
        pio.read_ipc(io.BytesIO(bytes(data)), device=CPU)


# ---- fuzz (twins of tests/test_ipc_fuzz.py): corrupt bytes raise Invalid --

def _valid_stream() -> bytes:
    rb = pa.record_batch({"x": pa.array([1, 2, None, 4]),
                          "f": pa.array([0.5, None, 2.5, -1.0]),
                          "s": pa.array(["aa", "bb", None, "aa"])})
    return _write(ipc_native, record_batch_from_arrow(rb, CPU), "stream",
                  None)


def _try(data: bytes, fmt="stream"):
    try:
        _port_read(data, fmt)
    except Invalid:
        pass   # the clean refusal


def test_fuzz_bit_flips_and_truncations():
    base = _valid_stream()
    rng = np.random.default_rng(0)
    for _ in range(200):
        data = bytearray(base)
        for _ in range(rng.integers(1, 4)):
            data[int(rng.integers(0, len(data)))] ^= \
                1 << int(rng.integers(0, 8))
        _try(bytes(data))
    for cut in range(0, len(base), max(1, len(base) // 64)):
        _try(base[:cut])


def test_fuzz_lengths_garbage_and_footers():
    base = bytearray(_valid_stream())
    for huge in (0x7FFFFFFF, -1, len(base) * 2):
        data = bytearray(base)
        struct.pack_into("<i", data, 4, huge)
        _try(bytes(data))
    rng = np.random.default_rng(1)
    for n in (0, 1, 7, 64, 4096):
        _try(bytes(rng.integers(0, 256, n, dtype=np.uint8)))
    _try(b"\xff\xff\xff\xff" + b"\x00" * 64)
    base = _write(ipc_native, record_batch_from_arrow(
        pa.record_batch({"x": pa.array([1, 2])}), CPU), "file", "lz4")
    rng = np.random.default_rng(2)
    for _ in range(100):
        data = bytearray(base)
        data[len(data) - 1 - int(rng.integers(0, min(64, len(data))))] ^= \
            0xFF
        _try(bytes(data), "file")


# ---- Feather (twins of tests/test_feather_v1.py) ---------------------------

def _feather_table(n=400, seed=0):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.15

    def m(vals):
        return [None if mask[i] else v for i, v in enumerate(vals)]

    return pa.table({
        "i64": pa.array(m(rng.integers(-2**40, 2**40, n).tolist())),
        "i8": pa.array(m(rng.integers(-100, 100, n).tolist()), pa.int8()),
        "u32": pa.array(m(rng.integers(0, 2**31, n).tolist()), pa.uint32()),
        "f64": pa.array(m(rng.normal(size=n).tolist())),
        "f32": pa.array(m(rng.normal(size=n).astype(np.float32).tolist()),
                        pa.float32()),
        "b": pa.array(m((rng.random(n) < 0.5).tolist())),
        "s": pa.array(m([f"val{i % 37}" for i in range(n)])),
        "bin": pa.array(m([bytes([i % 250]) for i in range(n)]),
                        pa.binary()),
        "cat": pa.array(m([f"c{i % 5}" for i in range(n)]))
        .dictionary_encode(),
        "ts": pa.array(m(rng.integers(0, 2 * 10**15, n).tolist()),
                       pa.timestamp("us")),
        "d32": pa.array(m(rng.integers(0, 20000, n).tolist()), pa.date32()),
    })


@pytest.mark.parametrize("seed", range(3))
def test_feather_v1_differential(tmp_path, seed):
    t = _feather_table(seed=seed)
    p = str(tmp_path / "t.feather")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        paf.write_feather(t, p, version=1)
        oracle = paf.read_table(p)
    with open(p, "rb") as f:
        got = read_feather_v1(f.read(), device=CPU).to_arrow()
    for name in oracle.column_names:
        assert same_arrow(got[name], oracle[name]), name


def test_feather_facade_reads_both_versions(tmp_path):
    t = _feather_table(n=50)
    for version in (1, 2):
        p = str(tmp_path / f"v{version}.feather")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            paf.write_feather(t, p, version=version)
            oracle = paf.read_table(p)
        got = feather.read_table(p, columns=["i64", "s"],
                                 device=CPU).to_arrow()
        assert got.column_names == ["i64", "s"]
        for name in ("i64", "s"):
            assert same_arrow(got[name], oracle[name]), (version, name)


def test_feather_writers_pyarrow_reads(tmp_path):
    t = _feather_table(n=300, seed=4).drop_columns(["bin"])
    batch = record_batch_from_arrow(t.to_batches()[0], CPU)
    for version in (1, 2):
        p = str(tmp_path / f"w{version}.feather")
        feather.write_table(batch, p, version=version)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got = paf.read_table(p)
        for name in t.column_names:
            assert same_arrow(got[name], t[name]), (version, name)
        back = feather.read_table(p, device=CPU).to_arrow()
        for name in t.column_names:
            assert same_arrow(back[name], t[name]), (version, name)


# ---- readahead (the twins of tests/test_prefetch_merged.py without parquet)

def _gen(i, k):
    def gen():
        for j in range(k):
            yield (i, j)
    return gen


def test_merged_ordered_unordered_and_errors():
    out = list(MergedIterator([_gen(i, 3) for i in range(5)], readahead=2,
                              ordered=True))
    assert out == [(i, j) for i in range(5) for j in range(3)]

    def slow(i):
        def gen():
            time.sleep(0.005 * (5 - i))
            yield from _gen(i, 2)()
        return gen

    out = list(MergedIterator([slow(i) for i in range(5)], readahead=3,
                              ordered=False))
    assert sorted(out) == [(i, j) for i in range(5) for j in range(2)]

    def bad():
        yield 2
        raise ValueError("decode failed")

    with pytest.raises(ValueError, match="decode failed"):
        list(MergedIterator([_gen(0, 1), bad], readahead=2, ordered=True))
    seen = []
    out = list(MergedIterator([lambda: iter([1, 2])],
                              transfer=lambda x: seen.append(x) or x * 10))
    assert out == [10, 20] and seen == [1, 2]


def test_merged_bounded_concurrency():
    import threading

    live, peak = [0], [0]
    lock = threading.Lock()

    def make(i):
        def gen():
            with lock:
                live[0] += 1
                peak[0] = max(peak[0], live[0])
            time.sleep(0.01)
            yield i
            with lock:
                live[0] -= 1
        return gen

    out = list(MergedIterator([make(i) for i in range(8)], readahead=2,
                              ordered=True, depth=1))
    assert sorted(out) == list(range(8)) and peak[0] <= 3


def test_prefetch_batches_read_from_a_file(tmp_path):
    rbs = [FAMILIES["nested"], FAMILIES["nested"].slice(3, 20)]
    path = tmp_path / "n.arrow"
    pio.write_ipc(pt.Table([record_batch_from_arrow(rb, CPU) for rb in rbs]),
                  path)
    got = list(prefetch_batches(pio.read_ipc(path, batched=True, device=CPU),
                                readahead=1, device=CPU))
    want = pio.read_ipc(path, device=CPU).batches
    assert [canon_batch(b) for b in got] == [canon_batch(b) for b in want]
    for g, rb in zip(got, rbs):
        same_as_source(g.to_arrow(), rb)
    with pytest.raises(RuntimeError, match="CUDA"):
        prefetch_batches(iter(want))
