"""The port's Parquet reader and writer (arrow1_tpu_torch/io/parquet.py,
parquet_native.py, parquet.py) against the JAX package's
(arrow1_tpu/io/parquet_native.py) and pyarrow.parquet, on the CPU: twins
of tests/test_parquet_native.py and the Parquet part of
tests/test_pyarrow_facade.py. The same file bytes go through both
packages' native readers and pyarrow; files each package writes are read
by the other and by pyarrow. Floats are compared bit for bit."""

import io

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

import arrow1_tpu as a1t
from arrow1_tpu.io import parquet_native as ref_pn
import arrow1_tpu_torch as pt
import arrow1_tpu_torch.parquet as ppq
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.interop import record_batch_from_arrow
from arrow1_tpu_torch.io import parquet as port_pq
from arrow1_tpu_torch.io import parquet_native as port_pn
from arrow1_tpu_torch.io.ipc_native import UnsupportedLayout
from test_torch_csv import column_values


def _mixed_table(n=257, seed=0, nulls=True):
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.15 if nulls else np.zeros(n, bool)

    def m(vals):
        return [None if mask[i] else v for i, v in enumerate(vals)]

    return pa.table({
        "i64": pa.array(m(rng.integers(-2**40, 2**40, n)), pa.int64()),
        "i32": pa.array(m(rng.integers(-2**20, 2**20, n)), pa.int32()),
        "f64": pa.array(m(rng.normal(size=n)), pa.float64()),
        "f32": pa.array(m(rng.normal(size=n).astype(np.float32)),
                        pa.float32()),
        "b": pa.array(m(rng.random(n) < 0.5), pa.bool_()),
        "s": pa.array(m([f"val{int(x) % 37}" for x in
                         rng.integers(0, 1000, n)]), pa.string()),
    })


def same(got, want, label=""):
    """Two pyarrow tables column for column (floats as bits)."""
    assert got.column_names == want.column_names, label
    for name in want.column_names:
        g, w = got[name], want[name]
        if pa.types.is_nested(w.type):
            assert g.to_pylist() == w.to_pylist(), (label, name)
        else:
            assert column_values(g) == column_values(w), (label, name)


def port_native(data, **kw):
    return pt.Table([port_pn.read_parquet_native(
        data, device="cpu", **kw)]).to_arrow()


def read_both(data, want, **kw):
    """The port's native reader against ``want`` and the reference's."""
    got = port_native(data, **kw)
    same(got, want)
    same(got, ref_pn.read_parquet_native(data, **kw).to_arrow())
    return got


def _pyarrow_file(t, **kw):
    buf = io.BytesIO()
    pq.write_table(t, buf, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("use_dictionary", [True, False])
@pytest.mark.parametrize("version", ["1.0", "2.4", "2.6"])
def test_read_pyarrow_grid(use_dictionary, version):
    t = _mixed_table()
    read_both(_pyarrow_file(t, use_dictionary=use_dictionary,
                            version=version), t)


@pytest.mark.parametrize("codec", ["none", "snappy", "gzip", "zstd"])
def test_read_codecs(codec):
    t = _mixed_table()
    read_both(_pyarrow_file(t, compression=codec), t)


def test_read_data_page_v2():
    t = _mixed_table()
    read_both(_pyarrow_file(t, data_page_version="2.0"), t)


def test_read_multi_row_group():
    t = _mixed_table(n=1000)
    read_both(_pyarrow_file(t, row_group_size=123), t)


@pytest.mark.parametrize("n,nulls", [(257, False), (0, True)],
                         ids=["no_nulls", "zero_rows"])
def test_read_no_nulls_and_empty(n, nulls):
    t = _mixed_table(n=n, nulls=nulls)
    read_both(_pyarrow_file(t, compression="none"), t)


def test_read_all_null_columns():
    t = pa.table({"i": pa.array([None] * 5, pa.int64()),
                  "s": pa.array([None] * 5, pa.string()),
                  "f": pa.array([None] * 5, pa.float64())})
    read_both(_pyarrow_file(t), t)


def test_read_temporal_types():
    t = pa.table({
        "d": pa.array([0, 1, None, 20000], pa.date32()),
        "ts_us": pa.array([0, 10**15, None, 7], pa.timestamp("us")),
        "ts_ms": pa.array([0, 10**12, None, 7], pa.timestamp("ms")),
    })
    read_both(_pyarrow_file(t, compression="none"), t)


def test_read_decimals_as_int64_limbs():
    from decimal import Decimal

    t = pa.table({"d": pa.array([Decimal("1.50"), None, Decimal("-3.25"),
                                 Decimal("99999999999.99")],
                                pa.decimal128(15, 2)),
                  "w": pa.array([Decimal(2**100), Decimal(-2**90), None,
                                 Decimal(0)], pa.decimal128(38, 0))})
    got = port_pn.read_parquet_native(_pyarrow_file(t), device="cpu")
    for name in ("d", "w"):
        col = got[name]
        assert col.data.dtype == pt.dtypes.int64.physical_dtype()
        assert col.data2 is not None
        assert col.to_arrow().to_pylist() == t[name].to_pylist()


def test_read_column_projection():
    t = _mixed_table()
    data = _pyarrow_file(t, compression="none")
    got = read_both(data, t.select(["f64", "s"]), columns=["f64", "s"])
    assert got.column_names == ["f64", "s"]


NESTED = {
    "one_level": pa.table({
        "l": pa.array([[1, 2], [], None, [3, None]], pa.list_(pa.int64())),
        "s": pa.array([{"a": 1, "b": "x"}, None, {"a": None, "b": "y"},
                       {"a": 4, "b": None}]),
        "ls": pa.array([["u"], None, [], ["v", "w"]]),
    }),
    "list_of_list": pa.table({"x": pa.array(
        [[[1]], None, [[2, 3], []], [None]],
        pa.list_(pa.list_(pa.int64())))}),
    "list_of_struct": pa.table({"x": pa.array(
        [[{"a": 1, "b": "x"}], None,
         [{"a": None, "b": "y"}, {"a": 3, "b": None}], []],
        pa.list_(pa.struct([("a", pa.int64()), ("b", pa.string())])))}),
    "struct_of_struct": pa.table({"x": pa.array(
        [{"s": {"a": 1}}, {"s": None}, None, {"s": {"a": None}}],
        pa.struct([("s", pa.struct([("a", pa.int64())]))]))}),
    "map": pa.table({"x": pa.array(
        [[("k1", 1), ("k2", 2)], None, [], [("k3", None)]],
        pa.map_(pa.string(), pa.int64()))}),
    "struct_of_map_of_list": pa.table({"x": pa.array(
        [{"m": [("a", [1, 2])]}, {"m": None}, {"m": [("b", []), ("c", [3])]}],
        pa.struct([("m", pa.map_(pa.string(), pa.list_(pa.int64())))]))}),
    "three_lists": pa.table({"x": pa.array(
        [[[[1, 2], [3]], [[4]]], [], [[[5]]]],
        pa.list_(pa.list_(pa.list_(pa.int64()))))}),
}


@pytest.mark.parametrize("name", list(NESTED))
def test_nested_reads_natively(name):
    t = NESTED[name]
    read_both(_pyarrow_file(t), t)


@pytest.mark.parametrize("seed", range(4))
def test_deep_nested_differential_fuzz(seed):
    rng = np.random.default_rng(100 + seed)

    def rand_type(depth):
        if depth == 0:
            return rng.choice([pa.int64(), pa.float64(), pa.string()])
        k = rng.integers(0, 4)
        if k == 0:
            return pa.list_(rand_type(depth - 1))
        if k == 1:
            return pa.struct([("f0", rand_type(depth - 1)),
                              ("f1", pa.int32())])
        if k == 2:
            return pa.map_(pa.string(), rand_type(depth - 1))
        return rand_type(depth - 1)

    def rand_value(t):
        if rng.random() < 0.15:
            return None
        if pa.types.is_list(t):
            return [rand_value(t.value_type)
                    for _ in range(rng.integers(0, 4))]
        if pa.types.is_map(t):
            return [(f"k{j}", rand_value(t.item_type))
                    for j in range(rng.integers(0, 3))]
        if pa.types.is_struct(t):
            return {f.name: rand_value(f.type) for f in t}
        if t == pa.int64() or t == pa.int32():
            return int(rng.integers(-1000, 1000))
        if t == pa.float64():
            return float(np.round(rng.standard_normal(), 6))
        return str(rng.choice(["a", "bb", "ccc", ""]))

    t = rand_type(int(rng.integers(2, 5)))
    table = pa.table({"x": pa.array(
        [rand_value(t) for _ in range(int(rng.integers(1, 50)))], t)})
    read_both(_pyarrow_file(table), table)


def _write(rb, **kw):
    buf = io.BytesIO()
    port_pn.write_parquet_native(record_batch_from_arrow(rb, device="cpu"),
                                 buf, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("codec", ["snappy", "none", "gzip", "zstd"])
def test_write_native_read_by_pyarrow_and_the_reference(codec):
    t = _mixed_table()
    data = _write(t.to_batches()[0], compression=codec)
    same(pq.read_table(io.BytesIO(data)), t)
    same(ref_pn.read_parquet_native(data).to_arrow(), t)
    same(port_native(data), t)


def test_reference_written_file_reads_in_the_port():
    t = _mixed_table(n=500, seed=4)
    buf = io.BytesIO()
    ref_pn.write_parquet_native(a1t.record_batch(t.to_batches()[0]), buf,
                                row_group_size=100)
    same(port_native(buf.getvalue()), t)


@pytest.mark.parametrize("seed", range(6))
def test_nested_write_differential_fuzz(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 60))

    def rand_scalar(kind):
        if kind == "i":
            return int(rng.integers(-1000, 1000))
        if kind == "f":
            return float(np.round(rng.standard_normal(), 6))
        return str(rng.choice(["a", "bb", "ccc", ""]))

    def rand_list(kind):
        if rng.random() < 0.15:
            return None
        return [None if rng.random() < 0.2 else rand_scalar(kind)
                for _ in range(int(rng.integers(0, 5)))]

    def rand_struct():
        if rng.random() < 0.15:
            return None
        return {"x": None if rng.random() < 0.2 else rand_scalar("i"),
                "y": None if rng.random() < 0.2 else rand_scalar("f")}

    kind = ["i", "f", "s"][seed % 3]
    patype = {"i": pa.int64(), "f": pa.float64(), "s": pa.string()}[kind]
    t = pa.table({
        "flat": pa.array([None if rng.random() < 0.2 else rand_scalar(kind)
                          for _ in range(n)], type=patype),
        "l": pa.array([rand_list(kind) for _ in range(n)],
                      type=pa.list_(patype)),
        "st": pa.array([rand_struct() for _ in range(n)]),
    })
    read_both(_pyarrow_file(t, version="2.6"), t)
    data = _write(t.to_batches()[0], compression="none")
    back = pq.read_table(io.BytesIO(data))
    for name in t.column_names:
        assert back[name].to_pylist() == t[name].to_pylist(), (seed, name)
    same(port_native(data), t)


def _enc_case(kind, rng, n):
    if kind == "i32":
        return (pa.array(rng.integers(-2**30, 2**30, n), pa.int32()),
                "DELTA_BINARY_PACKED")
    if kind == "i64":
        return (pa.array(rng.integers(-2**60, 2**60, n), pa.int64()),
                "DELTA_BINARY_PACKED")
    if kind == "i64_seq":
        return (pa.array(np.arange(n, dtype=np.int64) * 3 +
                         rng.integers(0, 2, n), pa.int64()),
                "DELTA_BINARY_PACKED")
    if kind == "f32":
        return (pa.array(rng.normal(size=n).astype(np.float32)),
                "BYTE_STREAM_SPLIT")
    if kind == "f64":
        return pa.array(rng.normal(size=n)), "BYTE_STREAM_SPLIT"
    if kind == "str_dlba":
        return (pa.array([f"val{i % 97}x{i}" for i in range(n)]),
                "DELTA_LENGTH_BYTE_ARRAY")
    return (pa.array(sorted(f"prefix{i % 31}/suffix{i}" for i in range(n))),
            "DELTA_BYTE_ARRAY")


@pytest.mark.parametrize("withnull", [False, True])
@pytest.mark.parametrize("kind", ["i32", "i64", "i64_seq", "f32", "f64",
                                  "str_dlba", "str_dba"])
def test_read_delta_and_bss_encodings(kind, withnull):
    rng = np.random.default_rng(7)
    n = 3001
    arr, enc = _enc_case(kind, rng, n)
    if withnull:
        m = rng.random(n) < 0.1
        arr = pa.array([None if mm else v.as_py() for mm, v in zip(m, arr)],
                       type=arr.type)
    t = pa.table({"x": arr})
    read_both(_pyarrow_file(t, use_dictionary=False,
                            column_encoding={"x": enc}, compression="NONE"),
              t)


def test_read_delta_binary_packed_edge_values():
    t = pa.table({"x": pa.array([0, 2**63 - 1, -2**63, -1, 1, 2**62, -2**62,
                                 0], pa.int64())})
    read_both(_pyarrow_file(t, use_dictionary=False,
                            column_encoding={"x": "DELTA_BINARY_PACKED"},
                            compression="NONE"), t)


@pytest.mark.parametrize("enc", ["split", "delta"])
def test_write_opt_in_encodings(enc):
    t = _mixed_table(seed=2).select(["i64", "i32", "f64", "f32"])
    kw = {"use_byte_stream_split": True} if enc == "split" else \
        {"use_delta_binary_packed": True}
    data = _write(t.to_batches()[0], **kw)
    same(pq.read_table(io.BytesIO(data)), t)
    same(port_native(data), t)


def test_high_level_roundtrip_and_multi_batch_table(tmp_path):
    t = _mixed_table(n=300, seed=5)
    port = record_batch_from_arrow(t.to_batches()[0], device="cpu")
    table = pt.Table([port.slice(0, 100), port.slice(100, 0),
                      port.slice(100, 200)])
    p = str(tmp_path / "t.parquet")
    port_pq.write_parquet(table, p, compression="gzip", row_group_size=100)
    assert pq.ParquetFile(p).num_row_groups == 3
    same(port_pq.read_parquet(p, device="cpu").to_arrow(), t)
    same(a1t.io.parquet.read_parquet(p).to_arrow(), t)
    got = list(port_pq.iter_parquet_batches(p, batch_rows=64, device="cpu"))
    assert [b.num_rows for b in got] == [64, 36] * 3
    same(pt.Table(got).to_arrow(), t)


def test_iter_parquet_batches_native(tmp_path):
    rng = np.random.default_rng(0)
    t = pa.table({"a": rng.integers(0, 100, 5000),
                  "s": [f"v{i % 9}" for i in range(5000)]})
    p = str(tmp_path / "t.parquet")
    pq.write_table(t, p, row_group_size=1200)
    rows = []
    for rb in port_pq.iter_parquet_batches(p, batch_rows=500, device="cpu"):
        assert rb.num_rows <= 500
        rows.extend(rb.column("a").to_pylist())
    assert rows == t["a"].to_pylist()
    got = [v for rb in port_pq.iter_parquet_batches(p, columns=["s"],
                                                    device="cpu")
           for v in rb.column("s").to_pylist()]
    assert got == t["s"].to_pylist()


@pytest.mark.parametrize("filters", [
    [("a", "<", 50)],
    [("a", ">=", 20), ("c", "in", ["x", "y"])],
    [[("a", "=", 3)], [("a", "=", 7), ("c", "!=", "x")]],
], ids=["lt", "and_in", "or"])
def test_read_parquet_filters_native(tmp_path, filters):
    rng = np.random.default_rng(0)
    n = 3000
    t = pa.table({"a": rng.integers(0, 100, n),
                  "b": rng.standard_normal(n),
                  "c": rng.choice(["x", "y", "z"], n)})
    p = str(tmp_path / "f.parquet")
    pq.write_table(t, p)
    got = port_pq.read_parquet(p, filters=filters, device="cpu").to_arrow()
    same(got, pq.read_table(p, filters=filters))
    proj = port_pq.read_parquet(p, columns=["b"], filters=filters,
                                device="cpu").to_arrow()
    same(proj, pq.read_table(p, columns=["b"], filters=filters))


def test_bloom_filters_prune_row_groups(tmp_path):
    t = pa.table({"k": pa.array(np.arange(400, dtype=np.int64)),
                  "s": pa.array([f"s{i}" for i in range(400)])})
    p = str(tmp_path / "b.parquet")
    port_pq.write_parquet(record_batch_from_arrow(t.to_batches()[0],
                                                  device="cpu"),
                          p, row_group_size=100, bloom_filter_columns=True)
    with open(p, "rb") as f:
        data = f.read()
    assert port_pn.bloom_prune_row_groups(data, [("k", "=", 250)]) == \
        ref_pn.bloom_prune_row_groups(data, [("k", "=", 250)]) == [2]
    assert port_pn.bloom_prune_row_groups(data, [("s", "=", "s7")]) == [0]
    got = port_pq.read_parquet(p, filters=[("k", "=", 10**6)], device="cpu")
    assert got.num_rows == 0 and got.names == ("k", "s")


def test_native_encryption_roundtrip():
    key = bytes(range(16))
    t = _mixed_table(n=100, seed=8)
    data = _write(t.to_batches()[0], encryption={"footer_key": key})
    assert data[:4] == b"PARE"
    same(port_native(data, decryption={"footer_key": key}), t)
    same(ref_pn.read_parquet_native(
        data, decryption={"footer_key": key}).to_arrow(), t)
    with pytest.raises(Invalid, match="decryption"):
        port_native(data, decryption={"footer_key": bytes(16)})


def test_kms_encryption_goes_through_pyarrow(tmp_path):
    keys = {"kf": b"0123456789012345", "kc": b"1234567890123450"}
    t = _mixed_table(n=50, seed=9)
    p = str(tmp_path / "e.parquet")
    port_pq.write_parquet(
        record_batch_from_arrow(t.to_batches()[0], device="cpu"), p,
        encryption=port_pq.encryption_properties("kf", {"kc": ["i64"]},
                                                 keys))
    got = port_pq.read_parquet(p, decryption=port_pq.decryption_properties(
        keys), device="cpu")
    same(got.to_arrow(), t)


def test_declined_codec_reads_through_pyarrow():
    t = _mixed_table()
    data = _pyarrow_file(t, compression="brotli")
    with pytest.raises(UnsupportedLayout):
        port_pn.read_parquet_native(data, device="cpu")
    same(port_pq.read_parquet(io.BytesIO(data), device="cpu").to_arrow(), t)
    same(pt.Table(list(port_pq.iter_parquet_batches(
        data, device="cpu"))).to_arrow(), t)


def _port_file_int64(n=300, row_group_size=None):
    """The port's uncompressed Parquet file of one int64 column, and the
    table it holds. Its footer lists each chunk's encodings as the bytes
    ``_CHUNK_ENCODINGS`` (type INT64, then the list [PLAIN, RLE])."""
    t = pa.table({"x": pa.array(np.arange(n, dtype=np.int64) * 7 - 5)})
    sink = io.BytesIO()
    port_pq.write_parquet(record_batch_from_arrow(
        t.to_batches()[0], device="cpu"), sink, compression="none",
        row_group_size=row_group_size)
    return sink.getvalue(), t


_CHUNK_ENCODINGS = b"\x15\x04\x19\x25\x00\x06"


def _footer_lists_bit_packed(data, chunk):
    """``data`` with the ``chunk``-th column chunk's footer listing
    BIT_PACKED (4) where it lists PLAIN; its pages are unchanged."""
    start = len(data) - 8 - int.from_bytes(data[-8:-4], "little")
    at = start - 1
    for _ in range(chunk + 1):
        at = data.index(_CHUNK_ENCODINGS, at + 1)
    at += len(_CHUNK_ENCODINGS) - 2
    return data[:at] + b"\x08" + data[at + 1:]


def test_declined_encoding_reads_through_pyarrow():
    """A footer that lists an encoding the port does not decode declines
    before any page is read; read_parquet answers through pyarrow."""
    data, t = _port_file_int64()
    bad = _footer_lists_bit_packed(data, 0)
    with pytest.raises(UnsupportedLayout, match="encoding 4"):
        port_pn.read_parquet_native(bad, device="cpu")
    same(pq.read_table(io.BytesIO(bad)), t)
    same(port_pq.read_parquet(io.BytesIO(bad), device="cpu").to_arrow(), t)


def test_declined_later_row_group_streams_through_pyarrow_whole(
        monkeypatch):
    """A decline in row group 1 is seen in the footer before row group 0
    is read: iter_parquet_batches yields pyarrow's batches from the
    start and decodes no row group natively."""
    data, t = _port_file_int64(n=300, row_group_size=100)
    bad = _footer_lists_bit_packed(data, 1)
    port_pn.read_parquet_native(bad, row_groups=[0], device="cpu")
    calls = []
    real = port_pn.read_parquet_native
    monkeypatch.setattr(port_pn, "read_parquet_native",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = list(port_pq.iter_parquet_batches(bad, batch_rows=64,
                                            device="cpu"))
    assert calls == []
    same(pt.Table(got).to_arrow(), t)
    same(pt.Table(list(port_pq.iter_parquet_batches(
        data, batch_rows=64, device="cpu"))).to_arrow(), t)


def test_page_encoding_outside_the_footer_raises():
    """A page whose encoding (1, GROUP_VAR_INT) the reader does not decode
    while the footer lists only PLAIN and RLE is corrupt: Invalid, no
    fallback."""
    data, _ = _port_file_int64()
    page_tail = b"\x15\x00\x15\x06\x15\x06\x00\x00"   # enc PLAIN, RLE, RLE
    at = data.index(page_tail, 4)
    assert at < 32
    bad = data[:at + 1] + b"\x02" + data[at + 2:]
    with pytest.raises(Invalid, match="encoded 1"):
        port_pq.read_parquet(bad, device="cpu")
    with pytest.raises(Invalid):
        list(port_pq.iter_parquet_batches(bad, device="cpu"))


def test_plain_byte_array_needs_the_native_library(monkeypatch):
    """The writer's PLAIN byte arrays come from the native encoder, equal
    to the reference's; without the library the write raises."""
    from arrow1_tpu import native as ref_native
    from arrow1_tpu_torch import native

    rng = np.random.default_rng(18)
    pool = [b"", b"a", b"xyz", "\u00e9t\u00e9".encode()]
    codes = rng.integers(0, len(pool), 200)
    u_starts = np.zeros(len(pool) + 1, np.int64)
    np.cumsum([len(v) for v in pool], out=u_starts[1:])
    flat = np.frombuffer(b"".join(pool), np.uint8)
    cap = int(4 * len(codes) + sum(len(pool[c]) for c in codes))
    got = native.plain_byte_array(codes, u_starts, flat, None, cap)
    assert got == ref_native.plain_byte_array(codes, u_starts, flat, None,
                                              cap)
    assert got == b"".join(len(pool[c]).to_bytes(4, "little") + pool[c]
                           for c in codes)
    with pytest.raises(ValueError, match="too few"):
        native.plain_byte_array(codes, u_starts, flat, None, cap - 1)
    monkeypatch.setattr(native, "load_library", lambda: None)
    t = _mixed_table(n=20).select(["s"])
    with pytest.raises(RuntimeError, match="native library unavailable"):
        port_pq.write_parquet(record_batch_from_arrow(
            t.to_batches()[0], device="cpu"), io.BytesIO())


@pytest.mark.parametrize("cut", ["truncated_footer", "bad_magic",
                                 "garbage_footer"])
def test_corrupt_file_raises_and_does_not_fall_back(cut):
    """The reference answers a native error with pyarrow; the port raises
    its own Invalid where pyarrow raises (ROADMAP Queue 3)."""
    data = _pyarrow_file(_mixed_table())
    start = len(data) - 8 - int.from_bytes(data[-8:-4], "little")
    bad = {"truncated_footer": data[:-40] + data[-8:],
           "bad_magic": data[:-4] + b"PARX",
           "garbage_footer": data[:start] + b"\xff" * 64 +
           data[start + 64:]}[cut]
    with pytest.raises(Invalid):
        port_pq.read_parquet(bad, device="cpu")
    with pytest.raises((pa.ArrowInvalid, OSError)):
        pq.read_table(io.BytesIO(bad))


def test_missing_path_and_column_raise(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_pq.read_parquet(str(tmp_path / "missing.parquet"), device="cpu")
    data = _pyarrow_file(_mixed_table())
    with pytest.raises(KeyError):
        port_pq.read_parquet(data, columns=["nope"], device="cpu")


def test_pyarrow_facade_twin(tmp_path):
    tbl = pt.table({"x": np.array([1, 2, 3])}, device="cpu")
    p = str(tmp_path / "t.parquet")
    ppq.write_table(tbl, p)
    assert ppq.read_table(p, device="cpu").num_rows == 3
    assert ppq.read_schema(p) == (("x", pt.int64),)
    pf = ppq.ParquetFile(p, device="cpu")
    assert pf.num_row_groups == 1
    assert sum(b.num_rows for b in pf.iter_batches(2)) == 3
    assert pf.read_row_group(0, columns=["x"]).num_rows == 3
    with ppq.ParquetWriter(str(tmp_path / "w.parquet")) as w:
        w.write_table(tbl)
    assert ppq.read_table(str(tmp_path / "w.parquet"),
                          device="cpu").num_rows == 3
    assert ppq.ParquetDataset(p).to_table(device="cpu").num_rows == 3
