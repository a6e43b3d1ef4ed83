"""The port's bridges (arrow1_tpu_torch/cdata.py, cabi.py, builders.py,
validate.py, tensor.py, gandiva.py, plasma.py, testing.py) against the
JAX package's and pyarrow on the same inputs, on the CPU: twins of
tests/test_cabi.py, tests/test_builders.py, the validation part of
tests/test_fs_compression_validate.py, the tensor and C-data parts of
tests/test_misc_components.py and tests/test_gandiva_plasma_native.py.

Columns cross the C data interface both ways between the port, the JAX
package and pyarrow (each producer's capsules, each consumer), sliced,
of zero rows and all null; streams go to and from pyarrow's reader. The
plasma store's segment is named for this process and destroyed in a
``finally``.
"""

import os
from decimal import Decimal

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow1_tpu as a1t
from arrow1_tpu import builders as rb_
from arrow1_tpu import cdata as ref_cdata
from arrow1_tpu import gandiva as ref_gandiva
from arrow1_tpu import tensor as ref_tensor
from arrow1_tpu import testing as ref_testing
from arrow1_tpu import validate as ref_validate

import arrow1_tpu_torch as pt
from arrow1_tpu_torch import (builders, cabi, cdata, gandiva, plasma, tensor,
                              testing, validate)
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.interop import column_from_arrow, record_batch_from_arrow

# each flat type the C data interface walks, with nulls
ARRAYS = {
    "int64": pa.array([1, None, -3, 4], pa.int64()),
    "uint8": pa.array([1, 2, None, 255], pa.uint8()),
    "float64": pa.array([1.5, None, float("nan"), -0.0]),
    "float32": pa.array([1.5, 2.25, None, 3.0], pa.float32()),
    "bool": pa.array([True, None, False, True]),
    "string": pa.array(["x", None, "yy", "x"]),
    "large_string": pa.array(["a", "b", None, ""], pa.large_string()),
    "binary": pa.array([b"\x00", None, b"ab", b""], pa.binary()),
    "date32": pa.array([1, None, 3, 19000], pa.date32()),
    "timestamp": pa.array([1, 2, None, 4], pa.timestamp("us", "UTC")),
    "time32": pa.array([1, 2, None, 4], pa.time32("ms")),
    "duration": pa.array([1, -2, None, 4], pa.duration("ns")),
    "decimal128": pa.array([Decimal("1.25"), None, Decimal("-3.50"),
                            Decimal("0")], pa.decimal128(10, 2)),
    "decimal256": pa.array([Decimal("1.5"), Decimal("-2"), None,
                            Decimal("3")], pa.decimal256(50, 1)),
    "null": pa.nulls(4),
    "all_null": pa.array([None] * 4, pa.int64()),
    "zero_rows": pa.array([], pa.float64()),
}
# the JAX package walks these through its own structs (no null type)
REF_KINDS = [k for k in ARRAYS if k not in ("null", "large_string",
                                            "binary")]


class _Capsules:
    """An object with only the array capsule protocol."""

    def __init__(self, obj):
        self._obj = obj

    def __arrow_c_array__(self, requested_schema=None):
        return self._obj.__arrow_c_array__()


def same(got: pa.Array, want: pa.Array):
    assert got.type == want.type
    assert got.is_null().to_pylist() == want.is_null().to_pylist()
    if pa.types.is_floating(want.type):
        g = got.fill_null(0).to_numpy(zero_copy_only=False)
        w = want.fill_null(0).to_numpy(zero_copy_only=False)
        assert g.tobytes() == w.tobytes()
    else:
        assert got.to_pylist() == want.to_pylist()


@pytest.mark.parametrize("kind", list(ARRAYS))
def test_cdata_round_trips_with_pyarrow(kind):
    arr = ARRAYS[kind]
    col = cdata.import_column(_Capsules(arr), device="cpu")
    same(col.to_arrow(), arr)
    same(pa.array(cdata.export_column(col)), arr)
    sliced = arr.slice(1, 2)
    same(cdata.import_column(_Capsules(sliced), device="cpu").to_arrow(),
         sliced)


@pytest.mark.parametrize("kind", REF_KINDS)
def test_cdata_exchanges_with_the_reference(kind):
    arr = ARRAYS[kind]
    port_col = column_from_arrow(arr, device="cpu")
    ref_col = a1t.column(arr)
    from_port = ref_cdata.import_column(cdata.export_column(port_col))
    from_ref = cdata.import_column(ref_cdata.export_column(ref_col),
                                   device="cpu")
    want = ref_col.to_arrow()
    same(from_port.to_arrow(), want)
    same(from_ref.to_arrow(), want)


def test_streams_with_pyarrow_and_the_reference():
    rb = pa.record_batch({k: ARRAYS[k] for k in (
        "int64", "float64", "string", "bool", "date32", "decimal128")})
    port = record_batch_from_arrow(rb, device="cpu")
    back = pa.RecordBatchReader.from_stream(cdata.export_batch(port))
    table = back.read_all()
    assert table.schema == rb.schema
    for name in rb.schema.names:
        same(table[name].combine_chunks(), rb[name])
    two = pa.Table.from_batches([rb, rb.slice(1, 3)])
    got = cdata.import_batch(two, device="cpu").to_arrow()
    for name in rb.schema.names:
        same(got[name], two[name].combine_chunks())
    capsule = cabi.export_stream_capsule([port, port.slice(0, 0), port])
    batches = cabi.import_stream_capsule(capsule, device="cpu")
    assert [b.num_rows for b in batches] == [4, 0, 4]
    ref = ref_cdata.import_batch(cdata.export_batch(port)).to_arrow()
    for name in rb.schema.names:
        same(ref[name], rb[name])
    nested = record_batch_from_arrow(pa.record_batch(
        {"l": pa.array([[1], None, [2, 3], []])}), device="cpu")
    assert cdata.import_batch(cdata.export_batch(nested),
                              device="cpu").to_arrow().equals(
        nested.to_arrow())


def test_cabi_c_consumer_and_release():
    """The native C consumer walks the port's structs by the spec, and a
    released export's buffers leave the registry."""
    import ctypes

    from arrow1_tpu_torch.native import load_library

    lib = load_library()
    col = column_from_arrow(pa.array([5, None, 7, 9], pa.int64()),
                            device="cpu")
    s, a = cabi._export_pair(col, "x")
    out = (ctypes.c_int64 * 2)()
    assert lib.a1t_cabi_consume(ctypes.addressof(s), ctypes.addressof(a),
                                out) == 0
    assert list(out) == [3, 21]
    ids = (int(s.private_data), int(a.private_data))
    s.release(ctypes.byref(s))
    a.release(ctypes.byref(a))
    cabi._EXPORTS.callbacks()   # drains the released ids
    assert not any(i in cabi._EXPORTS.live for i in ids)
    with pytest.raises(Invalid):
        cabi._type_from_format("+w:4")


BUILDER_CASES = {
    "int64": (builders.Int64Builder, rb_.Int64Builder,
              [1, None, 3, -(1 << 62)]),
    "float64": (builders.Float64Builder, rb_.Float64Builder,
                [1.5, None, float("-inf"), 0.25]),
    "bool": (builders.BooleanBuilder, rb_.BooleanBuilder,
             [True, None, False]),
    "uint64": (builders.UInt64Builder, rb_.UInt64Builder,
               [1, (1 << 64) - 1, None]),
    "string": (builders.StringBuilder, rb_.StringBuilder,
               ["b", None, "a", "b", "ü"]),
    "binary": (builders.BinaryBuilder, rb_.BinaryBuilder,
               [b"b", None, b"\x00a"]),
    "dictionary": (builders.DictionaryBuilder, rb_.DictionaryBuilder,
                   ["z", "y", None, "z"]),
    "empty": (builders.Int64Builder, rb_.Int64Builder, []),
    "all_null": (builders.StringBuilder, rb_.StringBuilder, [None, None]),
}


@pytest.mark.parametrize("case", list(BUILDER_CASES))
def test_builders_match_the_reference(case):
    port_cls, ref_cls, vals = BUILDER_CASES[case]
    got = port_cls().append_values(vals).finish(device="cpu")
    ref = ref_cls().append_values(vals).finish()
    assert got.to_arrow().to_pylist() == ref.to_arrow().to_pylist() == vals
    assert got.dtype.kind == ref.dtype.kind


def test_builders_bulk_nested_and_decimal():
    arr = np.arange(100, dtype=np.int64)
    valid = arr % 7 != 0
    b = builders.Int64Builder().append_values(arr, valid)
    b.append(5).append_null()
    got = b.finish(device="cpu")
    ref = rb_.Int64Builder().append_values(arr, valid).append(5) \
        .append_null().finish()
    assert got.to_pylist() == ref.to_arrow().to_pylist()
    assert len(b) == 0 and b.null_count == 0   # finish starts over
    lb = builders.ListBuilder(builders.Int64Builder())
    lb.append([1, 2]).append_null().append([])
    lb.values.append(7)
    lb.close_row()
    ref_lb = rb_.ListBuilder(rb_.Int64Builder())
    ref_lb.append([1, 2]).append_null().append([])
    ref_lb.values.append(7)
    ref_lb.close_row()
    assert lb.finish(device="cpu").to_arrow().to_pylist() == \
        ref_lb.finish().to_arrow().to_pylist()
    sb = builders.StructBuilder(["a", "s"], [builders.Int64Builder(),
                                             builders.StringBuilder()])
    sb.append({"a": 1, "s": "x"}).append_null().append({"a": None,
                                                         "s": "y"})
    assert sb.finish(device="cpu").to_arrow().to_pylist() == [
        {"a": 1, "s": "x"}, None, {"a": None, "s": "y"}]
    for t, vals in ((pt.decimal128(20, 3), [Decimal("1.005"), -3, None,
                                            Decimal("-99999.999")]),
                    (pt.decimal256(60, 2), [Decimal("1" * 50 + ".25"),
                                            None, Decimal("-0.01")])):
        got = builders.builder_for(t).append_values(vals).finish(
            device="cpu")
        ref_t = getattr(a1t, t.kind)(t.precision, t.scale)
        ref = rb_.builder_for(ref_t).append_values(vals).finish()
        assert got.to_arrow().to_pylist() == ref.to_arrow().to_pylist()
    with pytest.raises(Invalid):
        builders.Decimal128Builder(pt.decimal256(40, 0))
    with pytest.raises(Invalid):
        builders.builder_for(pt.date32)


def _bad(kind):
    """A batch broken in one way, in each package's layout."""
    codes = np.array([0, 5, 1], np.int32)
    if kind == "codes":
        port = pt.Column(torch.from_numpy(codes), pt.string,
                         dictionary=pt.Dictionary(np.array(["a", "b"],
                                                           object)))
        from arrow1_tpu.column import Column, Dictionary

        import jax.numpy as jnp

        ref = Column(jnp.asarray(codes), a1t.string,
                     dictionary=Dictionary(np.array(["a", "b"], object)))
        return port, ref
    if kind == "offsets":
        lst = pa.array([[1], [2, 3], []])
        port = column_from_arrow(lst, device="cpu")
        port.offsets = torch.tensor([0, 2, 1, 3])
        ref = a1t.column(lst)
        import jax.numpy as jnp

        ref.offsets = jnp.asarray(np.array([0, 2, 1, 3], np.int64))
        return port, ref
    port = column_from_arrow(pa.array([1, 2, 3]), device="cpu")
    port.validity = torch.ones(2, dtype=torch.bool)
    ref = a1t.column(pa.array([1, 2, 3]))
    import jax.numpy as jnp

    ref.validity = jnp.ones(2, bool)
    return port, ref


@pytest.mark.parametrize("kind", ["codes", "offsets", "validity"])
def test_validate_raises_where_the_reference_does(kind):
    port, ref = _bad(kind)
    full = kind != "validity"
    with pytest.raises(Invalid):
        validate.validate_column(port, full=full)
    with pytest.raises(Exception):
        ref_validate.validate_column(ref, full=full)
    if full:   # the cheap checks pass, as the reference's do
        validate.validate_column(port)
        ref_validate.validate_column(ref)


def test_validate_accepts_good_batches():
    rb = pa.record_batch({k: ARRAYS[k] for k in ARRAYS if k != "zero_rows"})
    validate.validate_batch(record_batch_from_arrow(rb, device="cpu"),
                            full=True)
    nested = pa.record_batch({
        "l": pa.array([[1], None, []]),
        "st": pa.array([{"a": 1}, None, {"a": 2}]),
        "u": pa.UnionArray.from_sparse(pa.array([0, 1, 0], pa.int8()),
                                       [pa.array([1, 2, 3]),
                                        pa.array(["a", "b", "c"])])})
    validate.validate_batch(record_batch_from_arrow(nested, device="cpu"),
                            full=True)
    short = record_batch_from_arrow(pa.record_batch({"x": [1, 2]}),
                                    device="cpu")
    short.columns[0].validity = torch.ones(1, dtype=torch.bool)
    with pytest.raises(Invalid, match="column 'x'"):
        validate.validate_batch(short)


TENSORS = {
    "2d": np.array([[0, 1.5, 0], [2.0, 0, -3.0], [0, 0, 0]]),
    "3d": np.array([[[0, 1], [2, 0]], [[0, 0], [0, 4]]], np.int64),
    "empty": np.zeros((2, 3)),
}


@pytest.mark.parametrize("name", list(TENSORS))
def test_tensors_match_the_reference_and_pyarrow(name):
    """Each shape against pyarrow; the 2-D one (and the empty one's
    export) against the JAX package too, whose conversions compile for
    seconds a shape."""
    x = TENSORS[name]
    import jax.numpy as jnp

    t = tensor.Tensor.from_numpy(x, ["a", "b", "c"][:x.ndim], device="cpu")
    coo = t.to_coo()
    want = pa.SparseCOOTensor.from_tensor(pa.Tensor.from_numpy(x))
    if len(coo.values):
        w_values, w_coords = want.to_numpy()
        assert np.array_equal(coo.coords.numpy(), w_coords)
        assert np.array_equal(coo.values.numpy(), w_values.ravel())
    assert np.array_equal(coo.to_dense().to_numpy(), x)
    csf = coo.to_csf()
    assert np.array_equal(csf.to_dense().to_numpy(), x)
    assert np.array_equal(tensor.SparseCSFTensor.from_arrow(
        csf.to_arrow(), device="cpu").to_dense().to_numpy(), x)
    back = tensor.SparseCOOTensor.from_arrow(coo.to_arrow(), device="cpu")
    assert np.array_equal(back.to_dense().to_numpy(), x)
    assert np.array_equal(tensor.Tensor.from_arrow(
        t.to_arrow(), device="cpu").to_numpy(), x)
    assert list(t.to_arrow().dim_names) == ["a", "b", "c"][:x.ndim]
    if name == "empty":   # pyarrow decides (ROADMAP Queue 3)
        with pytest.raises(pa.ArrowInvalid):
            ref_tensor.SparseCOOTensor(
                jnp.zeros((0, 2), jnp.int64), jnp.zeros(0), x.shape
            ).to_arrow()
    if name == "2d":
        ref_coo = ref_tensor.Tensor(jnp.asarray(x)).to_coo()
        assert np.array_equal(coo.coords.numpy(), np.asarray(ref_coo.coords))
        csr, ref_csr = coo.to_csr(), ref_coo.to_csr()
        for a, b in ((csr.indptr, ref_csr.indptr),
                     (csr.indices, ref_csr.indices)):
            assert np.array_equal(a.numpy(), np.asarray(b))
        v = np.array([1.0, -2.0, 0.5])   # every product and sum exact
        assert np.array_equal(csr.matvec(torch.from_numpy(v)).numpy(),
                              x @ v)
        assert np.array_equal(csr.to_dense().to_numpy(), x)
        pa_csr = csr.to_arrow().to_tensor().to_numpy()
        assert np.array_equal(pa_csr, x)


def _gandiva_batch():
    return pa.record_batch({
        "a": pa.array([1, 2, None, 4, 5], type=pa.int64()),
        "b": pa.array([10.0, 20.0, 30.0, 40.0, None]),
    })


def test_gandiva_matches_the_reference():
    rb = _gandiva_batch()
    port = record_batch_from_arrow(rb, device="cpu")
    ref = a1t.record_batch(rb)
    pred = (pt.field("a") > 1, a1t.field("a") > 1)
    filt = gandiva.make_filter(port, pred[0])
    ref_filt = ref_gandiva.make_filter(ref.schema, pred[1])
    sel, ref_sel = filt.evaluate(port), ref_filt.evaluate(ref)
    assert len(sel) == len(ref_sel) == 3
    assert sel.to_column().to_pylist() == \
        ref_sel.to_column().to_numpy().tolist() == [1, 3, 4]
    proj = gandiva.make_projector(port, [(pt.field("a") * 2 + 1, "a2"),
                                         (pt.field("b") / 10.0, "b10")])
    ref_proj = ref_gandiva.make_projector(ref.schema, [
        (a1t.field("a") * 2 + 1, "a2"), (a1t.field("b") / 10.0, "b10")])
    for s, rs in ((None, None), (sel, ref_sel)):
        got = proj.evaluate(port, s)
        want = ref_proj.evaluate(ref, rs)
        assert got.names == want.names == ("a2", "b10")
        for n in got.names:
            assert got[n].to_pylist() == want[n].to_arrow().to_pylist()
    with pytest.raises(KeyError):
        gandiva.make_filter(port, pt.field("missing") > 1)
    with pytest.raises(Invalid):
        gandiva.make_filter(["a", "b"], pt.field("a") + 1).evaluate(port)


@pytest.fixture(scope="module", autouse=True)
def answer_workers():
    """Start the answer workers (tests/test_torch_answers.py) of the files
    that follow: this file runs first of the port's and has no answers of
    its own."""
    from test_torch_answers import start

    start()


@pytest.fixture()
def store_name():
    return f"/a1t-test-{os.getpid()}"


def test_plasma_round_trip_and_lifecycle(store_name):
    st = plasma.PlasmaStore(store_name, capacity=1 << 20, max_objects=32)
    try:
        rb = pa.record_batch({"x": [1, 2, 3], "s": ["a", None, "b"],
                              "n": pa.nulls(3)})
        port = record_batch_from_arrow(rb, device="cpu")
        oid = st.put(port)
        assert st.contains(oid)
        back = st.get(oid, device="cpu")
        assert back.to_arrow().equals(pa.Table.from_batches([rb]))
        named = plasma.ObjectID.of("my-table")
        st.put(pt.Table([port, port.slice(0, 0), port]), named)
        assert st.get(named, device="cpu").num_rows == 6
        assert set(st.list()) == {oid, named}
        st.delete(named)
        assert not st.contains(named) and st.bytes_used > 0
        with pytest.raises(KeyError):
            st.get_buffer(named)
        other = plasma.connect(store_name, create=False)
        try:
            assert other.get(oid, device="cpu").num_rows == 3
        finally:
            other.close()
        with pytest.raises(Invalid):
            plasma.ObjectID(b"short")
    finally:
        st.destroy()


def test_plasma_eviction_and_pins_as_the_reference(store_name):
    """The same puts and pins on the port's store and the JAX package's
    give the same survivors."""
    from arrow1_tpu import plasma as ref_plasma

    seen = []
    for mod, name in ((plasma, store_name), (ref_plasma,
                                             store_name + "-ref")):
        st = mod.PlasmaStore(name, capacity=16 << 10, max_objects=32)
        try:
            first = mod.ObjectID.of("first")
            st.put_bytes(first, b"a" * 4096)
            buf = st.get_buffer(first)   # pinned
            for i in range(10):
                st.put_bytes(mod.ObjectID.of(f"fill{i}"), b"z" * 4096)
            seen.append((st.evictions > 0, st.contains(first),
                         bytes(buf[:4]), sorted(o.binary for o in st.list())))
            st.release(first)
        finally:
            st.destroy()
    assert seen[0] == seen[1]
    assert seen[0][:3] == (True, True, b"aaaa")


def test_testing_helpers_match_the_reference():
    spec = [("i", pt.int64), ("f", pt.float32), ("s", pt.string),
            ("b", pt.bool_)]
    ref_spec = [("i", a1t.int64), ("f", a1t.float32), ("s", a1t.string),
                ("b", a1t.bool_)]
    got = testing.RandomDataGenerator(3).batch(50, spec, 0.2)
    want = ref_testing.RandomDataGenerator(3).batch(50, ref_spec, 0.2)
    assert got.equals(want)
    col = testing.array_from_json(pt.int64, "[1, null, 3]", device="cpu")
    testing.assert_column_equal(col, [1, None, 3])
    with pytest.raises(AssertionError):
        testing.assert_column_equal(col, [1, 2, 3])
    batch = testing.batch_from_json([("x", pt.float64), ("s", pt.string)],
                                    '[{"x": 1.5, "s": "a"}, {"x": null}]',
                                    device="cpu")
    testing.assert_batch_equal(batch, pa.record_batch(
        {"x": [1.5, None], "s": ["a", None]}))
    testing.assert_equals_arrow(pt.scalar(3), pa.scalar(3))
    testing.assert_column_equal(
        column_from_arrow(pa.array([1.0, 2.0 + 1e-14]), device="cpu"),
        [1.0, 2.0], approx=True, rtol=1e-12)
