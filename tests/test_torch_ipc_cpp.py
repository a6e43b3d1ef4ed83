"""The port's binding of the C++ IPC reader and writer
(arrow1_tpu_torch/io/ipc_cpp.py over native/src/ipc_file.cpp and
ipc_write.cpp, built by the port's own native.py) on the CPU: twins of
tests/test_ipc_cpp.py, against pyarrow, the port's Python IPC reader and
writer, the C++ pair itself and the JAX package's binding
(arrow1_tpu/io/ipc_cpp.py), whose results must be equal."""

import numpy as np
import pyarrow as pa
import pyarrow.ipc
import pytest

from arrow1_tpu.io import ipc_cpp as ref_cpp
from arrow1_tpu_torch.io.ipc_cpp import read_ipc_cpp, write_ipc_cpp


def _table(rng):
    return pa.table({
        "i64": pa.array(rng.integers(-(1 << 60), 1 << 60, 1000)),
        "i32": pa.array(rng.integers(-(1 << 30), 1 << 30, 1000)
                        .astype(np.int32)),
        "u16": pa.array(rng.integers(0, 1 << 16, 1000)
                        .astype(np.uint16)),
        "f64": pa.array(rng.standard_normal(1000)),
        "f32": pa.array(rng.standard_normal(1000).astype(np.float32)),
        "b": pa.array(rng.random(1000) < 0.5),
    })


def _same_as_reference(path, **kw):
    """The port's read_ipc_cpp of ``path`` equals the JAX package's."""
    got, want = read_ipc_cpp(path, **kw), ref_cpp.read_ipc_cpp(path, **kw)
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])
    for gb, wb in zip(got[1], want[1]):
        for g, w in zip(gb, wb):
            for x, y in zip(g, w):
                if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
                    np.testing.assert_array_equal(x, y)
                else:
                    assert x == y


def _check(names, batches, tbl):
    assert names == tbl.column_names
    got = {n: np.concatenate([b[i][0] for b in batches])
           for i, n in enumerate(names)}
    for n in names:
        np.testing.assert_array_equal(got[n],
                                      tbl.column(n).to_numpy())


def test_read_pyarrow_file(tmp_path, rng):
    tbl = _table(rng)
    p = tmp_path / "t.arrow"
    with pa.ipc.new_file(str(p), tbl.schema) as w:
        w.write_table(tbl, max_chunksize=300)
    names, batches = read_ipc_cpp(str(p))
    assert len(batches) == 4  # 1000 rows / 300 chunk
    _check(names, batches, tbl)
    _same_as_reference(str(p))


def test_read_pyarrow_stream(tmp_path, rng):
    tbl = _table(rng)
    p = tmp_path / "t.arrows"
    with pa.ipc.new_stream(str(p), tbl.schema) as w:
        w.write_table(tbl)
    names, batches = read_ipc_cpp(str(p))
    _check(names, batches, tbl)


def test_read_native_writer_file(tmp_path, rng):
    from arrow1_tpu_torch.interop import record_batch_from_arrow
    from arrow1_tpu_torch.io.ipc import write_ipc

    tbl = _table(rng)
    batch = record_batch_from_arrow(tbl.to_batches()[0], device="cpu")
    p = tmp_path / "n.arrow"
    write_ipc(batch, str(p))
    _same_as_reference(str(p))
    names, batches = read_ipc_cpp(str(p))
    _check(names, batches, tbl)


def test_nulls_surface_in_validity(tmp_path, rng):
    vals = rng.integers(0, 100, 64).astype(np.int64)
    mask = rng.random(64) < 0.3
    arr = pa.array(np.ma.masked_array(vals, mask=mask))
    tbl = pa.table({"x": arr})
    p = tmp_path / "nulls.arrow"
    with pa.ipc.new_file(str(p), tbl.schema) as w:
        w.write_table(tbl)
    names, batches = read_ipc_cpp(str(p))
    v, valid = batches[0][0]
    assert valid is not None
    np.testing.assert_array_equal(valid, ~mask)
    np.testing.assert_array_equal(v[valid], vals[~mask])


def test_nested_schema_rejected(tmp_path):
    # strings became supported in r5; NESTED columns remain out of the
    # C++ binding's scope and must still raise cleanly
    tbl = pa.table({"l": pa.array([[1, 2], [3]],
                                  pa.list_(pa.int64()))})
    p = tmp_path / "l.arrow"
    with pa.ipc.new_file(str(p), tbl.schema) as w:
        w.write_table(tbl)
    with pytest.raises(ValueError):
        read_ipc_cpp(str(p))


# ---- writer ---------------------------------------------------------

def _wcols(rng, n=512):
    names = ["i64", "i16", "u32", "f64", "f32", "b"]
    cols = [rng.integers(-(1 << 50), 1 << 50, n).astype(np.int64),
            rng.integers(-100, 100, n).astype(np.int16),
            rng.integers(0, 1 << 31, n).astype(np.uint32),
            rng.standard_normal(n),
            rng.standard_normal(n).astype(np.float32),
            rng.random(n) < 0.5]
    return names, cols


@pytest.mark.parametrize("stream", [False, True])
def test_write_cpp_pyarrow_reads(tmp_path, rng, stream):
    names, cols = _wcols(rng)
    p = tmp_path / ("w.arrows" if stream else "w.arrow")
    write_ipc_cpp(str(p), names, cols, stream=stream)
    opener = pa.ipc.open_stream if stream else pa.ipc.open_file
    tbl = opener(str(p)).read_all()
    assert tbl.column_names == names
    for n, c in zip(names, cols):
        np.testing.assert_array_equal(tbl.column(n).to_numpy(), c)


def test_write_cpp_validity_roundtrip(tmp_path, rng):
    names, cols = _wcols(rng, 300)
    vals = [None if i % 2 else rng.random(300) < 0.7
            for i in range(len(cols))]
    p = tmp_path / "v.arrow"
    write_ipc_cpp(str(p), names, cols, vals)
    tbl = pa.ipc.open_file(str(p)).read_all()
    for i, (n, c) in enumerate(zip(names, cols)):
        col = tbl.column(n)
        if vals[i] is None:
            assert col.null_count == 0
            continue
        assert col.null_count == int((~vals[i]).sum())
        got = np.asarray(col.to_numpy(zero_copy_only=False))
        np.testing.assert_array_equal(got[vals[i]], c[vals[i]])


def test_write_cpp_read_cpp_roundtrip(tmp_path, rng):
    names, cols = _wcols(rng)
    p = tmp_path / "rt.arrow"
    write_ipc_cpp(str(p), names, cols)
    rnames, batches = read_ipc_cpp(str(p))
    assert rnames == names
    for i, c in enumerate(cols):
        np.testing.assert_array_equal(batches[0][i][0], c)


def test_write_cpp_python_reader_reads(tmp_path, rng):
    from arrow1_tpu_torch.io.ipc import read_ipc

    names, cols = _wcols(rng)
    p = tmp_path / "py.arrow"
    write_ipc_cpp(str(p), names, cols)
    t = read_ipc(str(p), device="cpu")
    assert list(t.names) == names
    for n, c in zip(names, cols):
        np.testing.assert_array_equal(t.column(n).to_numpy(), c)


def test_write_cpp_file_bytes_equal_the_reference(tmp_path, rng):
    names, cols = _wcols(rng)
    vals = [None, rng.random(512) < 0.7] * 3
    a, b = tmp_path / "a.arrow", tmp_path / "b.arrow"
    write_ipc_cpp(str(a), names, cols, vals)
    ref_cpp.write_ipc_cpp(str(b), names, cols, vals)
    assert a.read_bytes() == b.read_bytes()


def test_write_cpp_rejects_datetimes(tmp_path):
    # strings became supported in r5; dtypes still outside the scope
    # (e.g. datetime64) must raise cleanly
    with pytest.raises(ValueError):
        write_ipc_cpp(str(tmp_path / "x.arrow"), ["t"],
                      [np.array(["2021-01-01"], np.datetime64)])


class TestIpcCppStrings:
    """r5: var-binary + dictionary columns across the C++ boundary
    (VERDICT r4 #6 — the engine's string form is dict-encoded, so the
    C++ side must speak it; coverage per ipc/reader.cc:138 ArrayLoader
    for these types)."""

    def test_cpp_writes_strings_pyarrow_reads(self, tmp_path):
        pa = pytest.importorskip("pyarrow")
        p = str(tmp_path / "s.arrow")
        write_ipc_cpp(
            p, ["s", "bts"],
            [np.array(["alpha", "", "c"], object),
             np.array([b"x", b"yy", b""], object)],
            validities=[np.array([1, 0, 1], bool), None])
        t = pa.ipc.open_file(p).read_all()
        assert t.column("s").to_pylist() == ["alpha", None, "c"]
        assert t.column("bts").to_pylist() == [b"x", b"yy", b""]

    def test_cpp_writes_dict_pyarrow_reads(self, tmp_path):
        pa = pytest.importorskip("pyarrow")
        p = str(tmp_path / "d.arrow")
        idx = np.array([2, 0, 1, 0], np.int32)
        write_ipc_cpp(p, ["d"], [(idx, ["lo", "mid", "hi"])],
                      validities=[np.array([1, 1, 1, 0], bool)])
        t = pa.ipc.open_file(p).read_all()
        assert pa.types.is_dictionary(t.schema.field("d").type)
        assert t.column("d").to_pylist() == ["hi", "lo", "mid", None]

    def test_pyarrow_writes_strings_dict_cpp_reads(self, tmp_path):
        pa = pytest.importorskip("pyarrow")
        p = str(tmp_path / "p.arrow")
        t = pa.table({
            "s": pa.array(["foo", None, "bar"]),
            "d": pa.array(["aa", "bb", "aa"]).dictionary_encode(),
            "b": pa.array([b"", b"qq", None], pa.binary()),
        })
        with pa.ipc.new_file(p, t.schema) as w:
            w.write_table(t)
        _same_as_reference(p)
        names, batches = read_ipc_cpp(p)
        assert names == ["s", "d", "b"]
        (vs, ms), (vd, md), (vb, mb) = batches[0]
        assert list(vs) == ["foo", "", "bar"]
        assert list(ms) == [True, False, True]
        assert list(vd) == ["aa", "bb", "aa"] and md is None
        assert list(vb) == ["" .encode(), b"qq", b""]
        assert list(mb) == [True, True, False]

    def test_raw_dict_form(self, tmp_path):
        pa = pytest.importorskip("pyarrow")
        p = str(tmp_path / "d2.arrow")
        t = pa.table({"d": pa.array(["x", "y", "x", "z"]
                                    ).dictionary_encode()})
        with pa.ipc.new_file(p, t.schema) as w:
            w.write_table(t)
        _, batches = read_ipc_cpp(p, materialize_dicts=False)
        kind, idx, vals = batches[0][0][0]
        assert kind == "dict"
        assert list(vals) == ["x", "y", "z"]
        assert list(vals[idx]) == ["x", "y", "x", "z"]

    def test_large_utf8_read(self, tmp_path):
        pa = pytest.importorskip("pyarrow")
        p = str(tmp_path / "l.arrow")
        t = pa.table({"s": pa.array(["big", "off"], pa.large_utf8())})
        with pa.ipc.new_file(p, t.schema) as w:
            w.write_table(t)
        names, batches = read_ipc_cpp(p)
        assert list(batches[0][0][0]) == ["big", "off"]

    def test_roundtrip_cpp_to_cpp(self, tmp_path):
        p = str(tmp_path / "rt.arrow")
        idx = np.array([0, 1, 1, 0], np.int16)
        write_ipc_cpp(
            p, ["i", "s", "d"],
            [np.array([9, 8, 7, 6], np.int32),
             np.array(["a", "bb", "ccc", ""], object),
             (idx, ["v0", "v1"])])
        names, batches = read_ipc_cpp(p, materialize_dicts=False)
        assert names == ["i", "s", "d"]
        (vi, _), (vs, _), (vd, _) = batches[0]
        assert list(vi) == [9, 8, 7, 6]
        assert list(vs) == ["a", "bb", "ccc", ""]
        kind, gidx, gvals = vd
        assert kind == "dict"
        np.testing.assert_array_equal(gidx, idx)
        assert list(gvals) == ["v0", "v1"]
