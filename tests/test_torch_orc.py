"""The port's ORC reader and writer (arrow1_tpu_torch/io/orc.py,
orc_native.py, orc_writer.py, orc.py) against the JAX package's
(arrow1_tpu/io/orc_native.py, orc_writer.py) and pyarrow.orc (liborc),
on the CPU: twins of tests/test_orc_native.py. The same file bytes go
through both packages' native readers and liborc; the port's writer must
write the reference writer's bytes, and liborc must read them."""

import io

import numpy as np
import pyarrow as pa
import pyarrow.orc as orc
import pytest
import torch

import arrow1_tpu as a1t
from arrow1_tpu.io import orc_native as ref_on
from arrow1_tpu.io import orc_writer as ref_ow
from arrow1_tpu.interop import record_batch_to_arrow as ref_to_arrow
import arrow1_tpu_torch as pt
import arrow1_tpu_torch.orc as porc
from arrow1_tpu_torch import dtypes as dt
from arrow1_tpu_torch.column import Column, UnionColumn
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.interop import record_batch_from_arrow
from arrow1_tpu_torch.io import orc as port_orc
from arrow1_tpu_torch.io import orc_native as port_on
from arrow1_tpu_torch.io import orc_writer as port_ow
from arrow1_tpu_torch.io.ipc_native import UnsupportedLayout
from test_torch_parquet import same


def _mixed_table(n=500, seed=0):
    from decimal import Decimal

    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.12

    def m(vals):
        return [None if mask[i] else v for i, v in enumerate(vals)]

    ts_raw = rng.integers(-2 * 10**15, 2 * 10**15, n)
    return pa.table({
        "i64": pa.array(m(rng.integers(-2**40, 2**40, n))),
        "i32": pa.array(m(rng.integers(-2**20, 2**20, n)), pa.int32()),
        "i16": pa.array(m(rng.integers(-2**10, 2**10, n)), pa.int16()),
        "i8": pa.array(m(rng.integers(-100, 100, n)), pa.int8()),
        "f64": pa.array(m(rng.normal(size=n))),
        "f32": pa.array(m(rng.normal(size=n).astype(np.float32))),
        "b": pa.array(m(rng.random(n) < 0.5)),
        "s": pa.array(m([f"val{i % 37}" for i in range(n)])),
        "s_uniq": pa.array(m([f"u{i}" for i in range(n)])),
        "bin": pa.array(m([bytes([i % 250]) for i in range(n)]),
                        pa.binary()),
        "d32": pa.array(m(rng.integers(-10000, 20000, n).tolist()),
                        pa.date32()),
        "ts": pa.array(pa.array(m(ts_raw.tolist()), pa.int64()).cast(
            pa.timestamp("us"))),
        "dec": pa.array(m([Decimal(int(x)).scaleb(-2) for x in
                           rng.integers(-10**10, 10**10, n)]),
                        pa.decimal128(18, 2)),
        "l": pa.array(m([[int(x) for x in rng.integers(
            0, 100, rng.integers(0, 4))] for _ in range(n)]),
            pa.list_(pa.int64())),
        "st": pa.array(m([{"a": int(rng.integers(0, 100)),
                           "b": f"x{i % 5}"} for i in range(n)]),
                       pa.struct([("a", pa.int64()), ("b", pa.string())])),
        "mp": pa.array(m([[(f"k{j}", int(rng.integers(0, 50)))
                           for j in range(rng.integers(0, 3))]
                          for _ in range(n)]),
                       pa.map_(pa.string(), pa.int64())),
    })


def port_read(data, **kw):
    return port_orc.read_orc(data, device="cpu", **kw).to_arrow()


def ref_read(data, **kw):
    out = ref_on.read_orc_native(data, **kw)
    return out.to_arrow() if hasattr(out, "batches") else \
        pa.Table.from_batches([ref_to_arrow(out)])


def read_both(data, want):
    got = port_read(data)
    same(got, want)
    same(got, ref_read(data))
    return got


def _liborc_file(t, **kw):
    buf = io.BytesIO()
    orc.write_table(t, buf, **kw)
    return buf.getvalue()


@pytest.mark.parametrize("codec", ["uncompressed", "zlib", "snappy",
                                   "zstd", "lz4"])
def test_read_codecs(codec):
    t = _mixed_table()
    read_both(_liborc_file(t, compression=codec), t)


def test_rlev2_submodes_and_multistripe():
    """DELTA, SHORT_REPEAT, PATCHED_BASE (a negative base too) and DIRECT
    runs across several stripes."""
    rng = np.random.default_rng(1)
    n = 40_000
    pb = np.full(n, 1000, np.int64)
    idx = rng.integers(0, n, n // 50)
    pb[idx] = rng.integers(2**33, 2**40, len(idx))
    t = pa.table({
        "mono": pa.array(np.arange(n, dtype=np.int64) * 3),
        "pb": pa.array(pb),
        "pbn": pa.array(-pb),
        "rand": pa.array(rng.integers(-2**50, 2**50, n)),
        "const": pa.array(np.full(n, 42, np.int64)),
        "s": pa.array([f"v{i % 97}" for i in range(n)]),
    })
    data = _liborc_file(t, compression="zlib", stripe_size=64 * 1024)
    assert orc.ORCFile(io.BytesIO(data)).nstripes > 2
    got = port_orc.read_orc(data, device="cpu")
    assert len(got.batches) == orc.ORCFile(io.BytesIO(data)).nstripes
    same(got.to_arrow(), t)


def test_deep_nesting():
    t = pa.table({"x": pa.array(
        [[{"x": [1, 2], "y": "a"}], None,
         [{"x": [], "y": None}, {"x": [3], "y": "b"}]],
        pa.list_(pa.struct([("x", pa.list_(pa.int64())),
                            ("y", pa.string())])))})
    read_both(_liborc_file(t), t)


def test_column_projection_and_facade(tmp_path):
    t = _mixed_table(n=100)
    p = str(tmp_path / "t.orc")
    orc.write_table(t, p)
    got = port_read(p, columns=["i64", "s"])
    assert got.column_names == ["i64", "s"]
    same(got, t.select(["i64", "s"]))
    f = porc.ORCFile(p, device="cpu")
    assert f.nrows == 100 and f.nstripes == 1
    assert [n for n, _ in f.schema] == t.column_names
    same(porc.read_table(p, device="cpu").to_arrow(), t)


@pytest.mark.parametrize("seed", range(4))
def test_differential_fuzz(seed):
    t = _mixed_table(n=int(np.random.default_rng(seed).integers(1, 400)),
                     seed=seed)
    read_both(_liborc_file(t, compression="zstd"), t)


FLAT = ["i64", "i32", "i16", "i8", "f64", "f32", "b", "s", "s_uniq", "bin",
        "d32", "ts", "dec"]


def test_writer_bytes_equal_the_reference():
    t = _mixed_table(n=300, seed=7).select(FLAT + ["l", "st", "mp"])
    rb = t.to_batches()[0]
    want = ref_ow.write_orc_native(a1t.record_batch(rb))
    got = port_ow.write_orc_native(record_batch_from_arrow(rb,
                                                           device="cpu"))
    assert got == want


def test_write_native_liborc_and_the_reference_read(tmp_path):
    t = _mixed_table(n=300, seed=7)
    data = port_ow.write_orc_native(record_batch_from_arrow(
        t.to_batches()[0], device="cpu"))
    got = orc.read_table(io.BytesIO(data))
    for name in t.schema.names:
        a, b = got.column(name), t.column(name)
        assert a.equals(b.cast(a.type)), name
    same(ref_read(data), t)
    same(port_read(data), t)


def test_multi_batch_table_is_one_stripe_a_batch():
    t = _mixed_table(n=250, seed=3).select(FLAT)
    port = record_batch_from_arrow(t.to_batches()[0], device="cpu")
    table = pt.Table([port.slice(0, 100), port.slice(100, 0),
                      port.slice(100, 150)])
    buf = io.BytesIO()
    port_orc.write_orc(table, buf)
    data = buf.getvalue()
    assert orc.ORCFile(io.BytesIO(data)).nstripes == 2
    got = port_orc.read_orc(data, device="cpu")
    assert [b.num_rows for b in got.batches] == [100, 150]
    same(got.to_arrow(), t)
    same(orc.read_table(io.BytesIO(data)), t)


def test_zero_rows_and_all_null():
    """The reference writer omits a column's empty streams and writes a
    stripe of no rows; liborc refuses both files, and the port writes
    neither (ROADMAP Queue 3)."""
    t = pa.table({"i": pa.array([None] * 4, pa.int64()),
                  "s": pa.array([None] * 4, pa.string())})
    data = port_ow.write_orc_native(record_batch_from_arrow(
        t.to_batches()[0], device="cpu"))
    same(port_read(data), t)
    same(orc.read_table(io.BytesIO(data)), t)
    with pytest.raises(OSError, match="DATA stream not found"):
        orc.read_table(io.BytesIO(ref_ow.write_orc_native(
            a1t.record_batch(t.to_batches()[0]))))
    empty = port_ow.write_orc_native(record_batch_from_arrow(
        t.to_batches()[0].slice(0, 0), device="cpu"))
    same(port_read(empty), t.slice(0, 0))
    same(orc.read_table(io.BytesIO(empty)), t.slice(0, 0))


def test_write_native_roundtrip_negative_ts():
    ts = pa.array([-1, -1_000_001, 0, 1, -2_500_000, 1_500_000, None],
                  type=pa.timestamp("us"))
    rb = pa.record_batch({"t": ts})
    data = port_ow.write_orc_native(record_batch_from_arrow(rb,
                                                            device="cpu"))
    assert data == ref_ow.write_orc_native(a1t.record_batch(rb))
    assert port_read(data).column("t").to_pylist() == ts.to_pylist()
    got = orc.read_table(io.BytesIO(data))
    assert got.column("t").to_pylist() == ts.to_pylist()


def test_write_orc_facade_native_path(tmp_path):
    b = pt.record_batch({"x": np.array([1, 2, 3]),
                         "s": np.array(["a", "bb", None], object)},
                        device="cpu")
    p = str(tmp_path / "w.orc")
    porc.write_table(b, p)
    with open(p, "rb") as f:
        assert f.read(3) == b"ORC"
    t2 = porc.read_table(p, device="cpu")
    assert t2.column("x").to_pylist() == [1, 2, 3]
    assert t2.column("s").to_pylist() == ["a", "bb", None]


def _union_table(n=200, seed=3):
    rng = np.random.default_rng(seed)
    tags = rng.integers(0, 2, n).astype(np.int8)
    n0, n1 = int((tags == 0).sum()), int((tags == 1).sum())
    offs = np.zeros(n, np.int32)
    offs[tags == 0] = np.arange(n0)
    offs[tags == 1] = np.arange(n1)
    m0 = rng.random(n0) < 0.15
    m1 = rng.random(n1) < 0.15
    c0 = pa.array([None if m0[i] else int(v) for i, v in
                   enumerate(rng.integers(-1000, 1000, n0))], pa.int64())
    c1 = pa.array([None if m1[i] else f"s{v}" for i, v in
                   enumerate(rng.integers(0, 50, n1))], pa.string())
    arr = pa.UnionArray.from_dense(
        pa.array(tags, pa.int8()), pa.array(offs, pa.int32()), [c0, c1])
    return pa.table({"u": arr, "k": pa.array(range(n), pa.int64())})


def test_union_read_vs_liborc():
    t = _union_table()
    data = _liborc_file(t)
    oracle = orc.ORCFile(io.BytesIO(data)).read()
    got = port_read(data)
    assert got.column("u").to_pylist() == oracle.column("u").to_pylist()
    assert got.schema.field("u").type == oracle.schema.field("u").type
    assert got.column("k").to_pylist() == oracle.column("k").to_pylist()
    assert got.column("u").to_pylist() == ref_read(data)["u"].to_pylist()


@pytest.mark.parametrize("mode", ["dense", "sparse"])
def test_union_write_native_liborc_reads(mode):
    t = _union_table(seed=4)
    b = record_batch_from_arrow(pa.record_batch(
        {"u": t["u"].combine_chunks(), "k": t["k"].combine_chunks()}),
        device="cpu")
    if mode == "sparse":
        u = b.column("u")
        n = len(u.type_ids)
        tags = u.type_ids.numpy()
        offs = u.offsets.numpy()
        kids = []
        for i, ch in enumerate(u.children):
            sel = tags == i
            data = np.zeros(n, ch.data.numpy().dtype)
            data[sel] = ch.data.numpy()[offs[sel]]
            valid = np.zeros(n, bool)
            valid[sel] = ch.mask().numpy()[offs[sel]]
            kids.append(Column(torch.from_numpy(data), ch.dtype,
                               validity=torch.from_numpy(valid),
                               dictionary=ch.dictionary))
        u2 = UnionColumn(u.type_ids, tuple(kids), dt.sparse_union(
            [(f"_union_{i}", c.dtype) for i, c in enumerate(kids)]))
        b = pt.RecordBatch((u2, b.column("k")), ("u", "k"))
    data = port_ow.write_orc_native(b)
    exp = t.column("u").to_pylist()
    assert orc.ORCFile(io.BytesIO(data)).read().column("u").to_pylist() == \
        exp
    assert port_read(data).column("u").to_pylist() == exp


def test_declined_layouts_go_to_pyarrow(monkeypatch):
    t = _mixed_table(n=50).select(["i64", "s"])
    data = _liborc_file(t)
    monkeypatch.setattr(port_on, "K_LZO", port_on.K_NONE)
    with pytest.raises(UnsupportedLayout):
        port_on.read_orc_native(data, device="cpu")
    same(port_read(data), t)
    ts = pa.array([1, None, 3], pa.timestamp("ns"))
    b = record_batch_from_arrow(pa.record_batch({"t": ts}), device="cpu")
    with pytest.raises(UnsupportedLayout):
        port_ow.write_orc_native(b)
    buf = io.BytesIO()
    port_orc.write_orc(b, buf)
    assert orc.read_table(io.BytesIO(buf.getvalue()))["t"].to_pylist() == \
        ts.to_pylist()


@pytest.mark.parametrize("cut", ["truncated_tail", "postscript_length",
                                 "zeroed_postscript", "garbage_stripe"])
def test_corrupt_file_raises_and_does_not_fall_back(cut):
    """The reference answers a native error with liborc; the port raises
    its own Invalid where liborc raises (ROADMAP Queue 3)."""
    data = _liborc_file(pa.table({"i": pa.array(np.arange(50)), "s": pa.array(
        [f"v{i}" for i in range(50)])}))
    ps = data[-1]
    bad = {"truncated_tail": data[:-3],
           "postscript_length": data[:-1] + bytes([250]),
           "zeroed_postscript": data[:-1 - ps] + bytes(ps) + data[-1:],
           "garbage_stripe": data[:40] + b"\xff" * 80 + data[120:]}[cut]
    with pytest.raises(Invalid):
        port_orc.read_orc(bad, device="cpu")
    with pytest.raises((pa.ArrowInvalid, OSError)):
        orc.read_table(io.BytesIO(bad))


def test_header_magic_is_not_read():
    """liborc reads a file whose leading "ORC" is damaged (it checks the
    PostScript's); the reference refuses it natively and then reads it
    through liborc; the port reads it natively (ROADMAP Queue 3)."""
    t = _mixed_table(n=20).select(["i64", "s"])
    data = b"XRC" + _liborc_file(t)[3:]
    same(orc.read_table(io.BytesIO(data)), t)
    same(port_read(data), t)


def test_missing_path_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        port_orc.read_orc(str(tmp_path / "missing.orc"), device="cpu")
