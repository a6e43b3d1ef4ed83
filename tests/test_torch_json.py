"""The port's NDJSON reader (arrow1_tpu_torch/io/json.py, json.py)
against the JAX package's (arrow1_tpu/io/json.py) and pyarrow.json, on
the CPU: twins of tests/test_json_native.py and the JSON part of
tests/test_pyarrow_facade.py. The same bytes go through both packages'
native parser (native/src/json.cpp) and pyarrow."""

import io
import json as pyjson

import numpy as np
import pyarrow as pa
import pytest
from pyarrow import json as pajson

from arrow1_tpu.io import json as ref_json
import arrow1_tpu_torch.json as pjson
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.io import json as port_json
from arrow1_tpu_torch.io._native_tbl import tbl_lib
from test_torch_csv import column_values


def port_read(data, **kw):
    return port_json.read_json(io.BytesIO(data), device="cpu",
                               **kw).to_arrow()


def check_all(data: bytes, label=""):
    """The port against pyarrow and the reference, column by column, the
    types included (an all-null column is null-typed in all three)."""
    got = port_read(data)
    oracle = pajson.read_json(io.BytesIO(data))
    ref = ref_json.read_json(data).combine_chunks().to_arrow()
    assert got.column_names == oracle.column_names == ref.column_names
    for name in oracle.column_names:
        g, o = got[name], oracle[name]
        if pa.types.is_nested(o.type):
            assert g.cast(o.type).to_pylist() == o.to_pylist(), (label, name)
            assert g.to_pylist() == ref[name].to_pylist(), (label, name)
            continue
        assert column_values(g) == column_values(o), (label, name)
        assert column_values(g) == column_values(ref[name]), (label, name)
        assert g.type == o.type or pa.types.is_dictionary(g.type), \
            (label, name)
        if pa.types.is_null(o.type):
            assert pa.types.is_null(ref[name].type), (label, name)
    return got


CASES = {
    "basic_types": b'{"a": 1, "b": 2.5, "c": "x", "d": true}\n'
                   b'{"a": 2, "b": 3.5, "c": "y", "d": false}\n',
    "missing_keys_are_null":
        b'{"a": 1}\n{"a": null, "b": "only-here"}\n{"b": "again"}\n',
    "string_escapes_incl_surrogate_pairs":
        b'{"s": "esc \\"q\\" \\n tab\\t u\\u00e9 pair\\ud83d\\ude00"}\n',
    "int_to_float_promotion": b'{"x": 1}\n{"x": 2.5}\n',
    "all_null_column": b'{"n": null}\n{"n": null}\n',
    "nested": b'{"o": {"k": 1}, "a": [1, 2]}\n{"o": {"k": 2}, "a": []}\n',
    "negative_and_big_ints":
        b'{"i": -9223372036854775808}\n{"i": 9223372036854775807}\n',
    "big_floats": b'{"i": 1e308}\n{"i": -2.5e-10}\n',
    "list_and_struct_columns":
        b'{"a": 1, "l": [1, 2], "s": {"x": 1, "y": "u"}}\n'
        b'{"a": 2, "l": [], "s": null}\n'
        b'{"a": null, "l": null, "s": {"x": null, "y": "v"}}\n'
        b'{"a": 4, "l": [3, null, 5], "s": {"x": 7}}\n',
    "string_and_float_lists":
        b'{"t": ["x", "y"], "f": [1.5]}\n{"t": [], "f": [2.5, null]}\n',
    "list_of_list": b'{"ll": [[1], [2, 3]]}\n{"ll": [[4]]}\n',
    "list_of_struct": b'{"tags": [{"k": "a", "v": 1}, {"k": "b", "v": 2}]}\n'
                      b'{"tags": []}\n{"tags": null}\n{"tags": [{"k": "c"}]}\n',
    "struct_of_struct_of_list":
        b'{"a": {"b": {"c": [1.5, 2.5], "d": "x"}}}\n{"a": {"b": null}}\n'
        b'{"a": null}\n{"a": {"b": {"c": [], "d": null}}}\n',
    "one_row": b'{"z": 7}\n',
}


@pytest.mark.parametrize("name", list(CASES))
def test_cases_match_reference_and_pyarrow(name):
    check_all(CASES[name], name)


def test_zero_rows():
    assert port_json.read_json(b"", device="cpu").num_rows == 0
    assert port_json.read_json(b"\n\n", device="cpu").num_rows == 0


@pytest.mark.parametrize("seed", range(4))
def test_nested_json_differential_fuzz(seed):
    rng = np.random.default_rng(seed + 10)
    lines = []
    for _ in range(int(rng.integers(1, 50))):
        row = {}
        if rng.random() > 0.1:
            row["a"] = int(rng.integers(-100, 100))
        if rng.random() > 0.1:
            row["l"] = (None if rng.random() < 0.15 else
                        [None if rng.random() < 0.2
                         else float(np.round(rng.standard_normal(), 4))
                         for _ in range(int(rng.integers(0, 4)))])
        if rng.random() > 0.1:
            row["s"] = (None if rng.random() < 0.15 else
                        {"x": int(rng.integers(0, 9)),
                         "y": str(rng.choice(["u", "vv", ""]))})
        lines.append(pyjson.dumps(row))
    data = ("\n".join(lines) + "\n").encode()
    got = port_read(data)
    oracle = pajson.read_json(io.BytesIO(data))
    ref = ref_json.read_json(data).combine_chunks().to_arrow()
    for name in oracle.column_names:
        assert got[name].to_pylist() == oracle[name].to_pylist() == \
            ref[name].to_pylist(), (seed, name)


def test_native_parse_is_a_column_tree():
    lib = tbl_lib()
    data = b'{"a": [[{"x": [1]}]]}\n'
    h = lib.a1t_json_parse(data, len(data), 0)
    try:
        assert not lib.a1t_tbl_error(h)
        # a (list), a.$ (list), a.$.$ (struct), a.$.$.x (list), its ints
        assert lib.a1t_tbl_ncols(h) == 5
    finally:
        lib.a1t_tbl_free(h)


def test_mixed_scalar_and_array_is_declined_to_pyarrow():
    """The parser reports a column of scalars and arrays before it builds
    any column; pyarrow, which then reads it, rejects it too."""
    with pytest.raises(pa.ArrowInvalid):
        port_json.read_json(b'{"m": 1}\n{"m": [2]}\n', device="cpu")


def test_explicit_schema_reads_through_pyarrow():
    data = b'{"a": 1, "b": "x"}\n{"a": 2, "b": "y"}\n'
    po = pajson.ParseOptions(explicit_schema=pa.schema([("a", pa.int32())]),
                             unexpected_field_behavior="ignore")
    got = port_read(data, parse_options=po)
    want = pajson.read_json(io.BytesIO(data), parse_options=po)
    assert got.column_names == ["a"]
    assert got["a"].to_pylist() == want["a"].to_pylist() == [1, 2]
    got = pjson.read_json(io.BytesIO(data), parse_options=pjson.ParseOptions(
        explicit_schema=pa.schema([("a", pa.int32())]),
        unexpected_field_behavior="ignore"), device="cpu")
    assert got.column("a").to_pylist() == [1, 2]


def test_malformed_line_raises_and_does_not_fall_back(tmp_path):
    """The reference answers a native parse error with pyarrow; the port
    raises, as pyarrow does on the same bytes (ROADMAP Queue 3)."""
    data = b'{"a": 1}\n{"a": \n'
    with pytest.raises(Invalid, match="malformed"):
        port_json.read_json(data, device="cpu")
    with pytest.raises(pa.ArrowInvalid):
        pajson.read_json(io.BytesIO(data))
    with pytest.raises(FileNotFoundError):
        port_json.read_json(str(tmp_path / "missing.json"), device="cpu")


def test_facade(tmp_path):
    j = tmp_path / "t.ndjson"
    j.write_text('{"a": 1}\n{"a": 2}\n')
    t = pjson.read_json(str(j), read_options=pjson.ReadOptions(),
                        parse_options=pjson.ParseOptions(), device="cpu")
    assert t.num_rows == 2 and t.column("a").to_pylist() == [1, 2]
