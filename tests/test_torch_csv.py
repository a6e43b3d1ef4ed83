"""The port's CSV reader and writer (arrow1_tpu_torch/io/csv.py, csv.py)
against the JAX package's (arrow1_tpu/io/csv.py) and pyarrow.csv, on the
CPU: twins of tests/test_csv_native.py and the CSV part of
tests/test_pyarrow_facade.py. The same bytes go through both packages'
native parser (native/src/csv.cpp) and pyarrow; integers, strings and
null masks must be equal and floats equal bit for bit. The writer's
bytes must equal the reference writer's."""

import io

import numpy as np
import pyarrow as pa
import pytest
from pyarrow import csv as pacsv

import arrow1_tpu as a1t
from arrow1_tpu.io import csv as ref_csv
import arrow1_tpu_torch as pt
import arrow1_tpu_torch.csv as pcsv
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.interop import record_batch_from_arrow
from arrow1_tpu_torch.io import csv as port_csv


def column_values(arr):
    """A column as comparable values: floats as their bits (None at
    nulls), dictionaries decoded, anything else as Python values."""
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = arr.cast(arr.type.value_type)
    if pa.types.is_floating(arr.type):
        bits = arr.fill_null(0).to_numpy(zero_copy_only=False).astype(
            np.float64).view(np.int64)
        return [int(b) if v else None
                for b, v in zip(bits, arr.is_valid().to_pylist())]
    return arr.to_pylist()


def same_tables(got, want, label=""):
    assert got.column_names == want.column_names, label
    for name in want.column_names:
        assert column_values(got[name]) == column_values(want[name]), \
            (label, name)


def port_read(data, **kw):
    return port_csv.read_csv(data, device="cpu", **kw).to_arrow()


def check_all(data: bytes, label=""):
    """The port against the reference and pyarrow on the same bytes, the
    column types included (an all-null column is null-typed in all
    three)."""
    got = port_read(data)
    ref = ref_csv.read_csv(data).to_arrow()
    oracle = pacsv.read_csv(io.BytesIO(data))
    same_tables(got, oracle, label)
    same_tables(got, ref, label)
    for f, o, r in zip(got.schema, oracle.schema, ref.schema):
        assert f.type == o.type, (label, f.name, f.type, o.type)
        if pa.types.is_null(o.type):
            assert pa.types.is_null(r.type), (label, f.name, r.type)


CASES = {
    "basic_types":
        b"a,b,c,d\n1,2.5,true,hello\n2,3.5,false,world\n-3,nan,true,x\n",
    "quoted_fields":
        b'x,y,s\n1,NULL,"a,b"\n,2,"line1\nline2"\n3,NA,"said ""hi"""\n',
    "crlf_and_empty_lines": b"p,q\r\n1,2\r\n\r\n3,4\r\n",
    "null_column_and_bool": b"n,b\nNULL,true\n,false\nNA,true\n",
    "strings_never_null": b'a\nxyz\n"NULL"\nNULL\n""\n"NA"\nplain\n',
    "quoted_null_in_int_column": b'a\n1\n"NULL"\n"3"\n',
    "int64_overflow_promotes_to_float":
        b"a\n1\n99999999999999999999999999\n",
    "zero_rows": b"a,b\n",
    "dates": b"d\n2021-01-05\n1999-12-31\n\n2024-02-29\n",
    "invalid_date_is_string": b"d\n2021-02-30\n2021-01-01\n",
    "seconds_timestamps": b"t\n2021-01-05 10:30:00\n2021-01-05T23:59:59\n",
    "minutes_timestamps": b"t\n2021-01-05 10:30\n2021-01-06 11:00\n",
    "fraction_promotes_to_ns":
        b"t\n2021-01-05 10:30:00.123\n2021-01-05 10:30:00.000000001\n",
    "date_promoted_to_timestamp": b"t\n2021-01-05\n2021-01-05 10:30:00\n",
    "zone_suffix_is_string":
        b"t\n2021-01-05 10:30:00\n2021-01-05T23:59:59Z\n",
    "date_and_int_is_string": b"x\n2021-01-05\n42\n",
    "date_and_text_is_string": b"x\n2021-01-05\nhello\n",
}


@pytest.mark.parametrize("name", list(CASES))
def test_cases_match_reference_and_pyarrow(name):
    check_all(CASES[name], name)


def test_fuzz_against_reference_and_pyarrow():
    rng = np.random.default_rng(0)
    rows = ["i,f,s,m"]
    for _ in range(500):
        s = rng.choice(["plain", "with,comma", 'with "quote"',
                        "nl\nin", ""])
        s = '"' + s.replace('"', '""') + '"'
        m = rng.choice(["1", "2.5", "xyz"])
        rows.append(f"{rng.integers(-10**12, 10**12)},"
                    f"{rng.standard_normal():.17g},{s},{m}")
    check_all(("\n".join(rows) + "\n").encode(), "fuzz")


def test_date_timestamp_inference_fuzz():
    rng = np.random.default_rng(11)
    dates = (np.datetime64("1970-01-01")
             + rng.integers(0, 40000, 200)).astype(str)
    tss = np.char.replace((np.datetime64("1970-01-01T00:00:00")
                           + rng.integers(0, 3_000_000_000, 200)
                           .astype("timedelta64[s]")).astype(str), "T", " ")
    text = "d,t\n" + "\n".join(
        f"{d},{t}" for d, t in zip(dates, tss)) + "\n,\n"
    check_all(text.encode(), "fuzz dates+ts")


def test_skip_rows_and_column_names():
    data = b"junk line\na,b\n1,2\n3,4\n"
    ro = pacsv.ReadOptions(skip_rows=1)
    same_tables(port_read(data, read_options=ro),
                pacsv.read_csv(io.BytesIO(data), read_options=ro))
    ro = pacsv.ReadOptions(column_names=["x", "y"])
    got = port_read(b"1,2\n3,4\n", read_options=ro)
    same_tables(got, ref_csv.read_csv(b"1,2\n3,4\n",
                                      read_options=ro).to_arrow())
    assert got.column("x").to_pylist() == [1, 3]


def test_semicolon_delimiter():
    po = pacsv.ParseOptions(delimiter=";")
    got = port_read(b"a;b\n1;x\n2;y\n", parse_options=po)
    same_tables(got, ref_csv.read_csv(b"a;b\n1;x\n2;y\n",
                                      parse_options=po).to_arrow())


def test_stream_batches():
    data = b"a\n" + b"".join(b"%d\n" % i for i in range(1000))
    got, ref = [], []
    for b in port_csv.open_csv_stream(data, batch_rows=300, device="cpu"):
        assert b.num_rows <= 300
        got.extend(b.column("a").to_pylist())
    for b in ref_csv.open_csv_stream(data, batch_rows=300):
        ref.extend(b.column("a").to_arrow().to_pylist())
    assert got == ref == list(range(1000))


def _write_batch(n=200, seed=3):
    """A batch of every type the writer vectorizes, nulls in every other
    column, an all-null column and strings that need quoting."""
    rng = np.random.default_rng(seed)
    mask = rng.random(n) < 0.2
    f = rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)
    f[:6] = [0.0, -0.0, np.nan, np.inf, 12.5, -0.07]
    cols = {
        "i": pa.array(rng.integers(-2**63, 2**63 - 1, n, dtype=np.int64)),
        "u": pa.array(rng.integers(0, 2**64 - 1, n, dtype=np.uint64),
                      mask=mask),
        "f": pa.array(f),
        "cents": pa.array(np.round(rng.uniform(-1e3, 1e3, n), 2),
                          mask=mask),
        "f32": pa.array(f.astype(np.float32)),
        "b": pa.array(rng.random(n) < 0.5, mask=mask),
        "s": pa.array(rng.choice(["", "a,b", 'q"x', "x\ny", "plain", "ü"],
                                 n)),
        "d": pa.array(rng.integers(-700000, 2900000, n).astype(np.int32),
                      pa.date32(), mask=mask),
        "ts": pa.array(rng.integers(-2**40, 2**40, n), pa.timestamp("us")),
        "tss": pa.array(rng.integers(-2**35, 2**37, n), pa.timestamp("s"),
                        mask=mask),
        "bin": pa.array([b"a\xff", b"", b"zz", b"q"] * (n // 4)),
        "nulls": pa.array([None] * n, pa.int64()),
    }
    return pa.record_batch(cols)


@pytest.mark.parametrize("delimiter", [",", ";", " ", "\t", "|"])
def test_write_csv_bytes_equal_the_reference(delimiter):
    rb = _write_batch()
    want = io.StringIO()
    ref_csv.write_csv(a1t.record_batch(rb), want, delimiter=delimiter)
    got = io.StringIO()
    port_csv.write_csv(record_batch_from_arrow(rb, device="cpu"), got,
                       delimiter=delimiter)
    assert got.getvalue() == want.getvalue()


def test_write_csv_multi_batch_and_zero_rows(tmp_path):
    rb = _write_batch(64, seed=5)
    port = record_batch_from_arrow(rb, device="cpu")
    table = pt.Table([port.slice(0, 10), port.slice(10, 0),
                      port.slice(10, 54)])
    ref_table = a1t.Table([a1t.record_batch(rb.slice(0, 10)),
                           a1t.record_batch(rb.slice(10, 0)),
                           a1t.record_batch(rb.slice(10, 54))])
    want = io.StringIO()
    ref_csv.write_csv(ref_table, want)
    path = tmp_path / "t.csv"
    port_csv.write_csv(table, str(path))
    assert path.read_bytes() == want.getvalue().encode()
    empty = io.StringIO()
    port_csv.write_csv(port.slice(0, 0), empty)
    ref_empty = io.StringIO()
    ref_csv.write_csv(a1t.record_batch(rb.slice(0, 0)), ref_empty)
    assert empty.getvalue() == ref_empty.getvalue()


def test_write_then_read_by_all_three():
    rng = np.random.default_rng(9)
    n = 300
    rb = pa.record_batch({
        "k": pa.array(rng.integers(0, 10**8, n)),
        "p": pa.array(np.round(rng.uniform(1, 1000, n), 2)),
        "f": pa.array(rng.standard_normal(n)),
        "flag": pa.array(rng.choice(["A", "N", "R"], n)),
        "d": pa.array(rng.integers(8000, 11000, n).astype(np.int32),
                      pa.date32()),
    })
    buf = io.BytesIO()
    port_csv.write_csv(record_batch_from_arrow(rb, device="cpu"), buf)
    data = buf.getvalue()
    got = port_read(data)
    same_tables(got, pa.Table.from_batches([rb]))
    same_tables(got, ref_csv.read_csv(data).to_arrow())
    same_tables(got, pacsv.read_csv(io.BytesIO(data)))


def test_write_csv_null_vs_empty_string():
    rb = pt.record_batch({"s": np.array(["", "a", None], object),
                          "x": np.array([1, 2, 3])}, device="cpu")
    buf = io.StringIO()
    port_csv.write_csv(rb, buf)
    back = pacsv.read_csv(
        io.BytesIO(buf.getvalue().encode()),
        convert_options=pacsv.ConvertOptions(
            strings_can_be_null=True, quoted_strings_can_be_null=False))
    assert back["s"].to_pylist() == ["", "a", None]


@pytest.mark.parametrize("kw", [
    {"convert_options": pacsv.ConvertOptions(column_types={"x": pa.int32()})},
    {"parse_options": pacsv.ParseOptions(escape_char="\\")},
    {"read_options": pacsv.ReadOptions(encoding="latin1")},
    {"parse_options": pacsv.ParseOptions(quote_char=False)},
], ids=["convert_options", "escape_char", "encoding", "no_quoting"])
def test_declined_options_read_through_pyarrow(kw):
    data = b"x,y\n1,2\n3,4\n"
    got = port_csv.read_csv(io.BytesIO(data), device="cpu", **kw)
    same_tables(got.to_arrow(), pacsv.read_csv(io.BytesIO(data), **kw))


def test_malformed_input_raises_and_does_not_fall_back(tmp_path):
    data = b"a,b\n1,2\n3,4,5\n"
    with pytest.raises(Invalid, match="wrong number of columns"):
        port_csv.read_csv(data, device="cpu")
    with pytest.raises(pa.ArrowInvalid):
        pacsv.read_csv(io.BytesIO(data))
    with pytest.raises(FileNotFoundError):
        port_csv.read_csv(str(tmp_path / "missing.csv"), device="cpu")


def test_facade_options_and_open_csv():
    data = b"junk\na;b\n1;x\n2;y\n"
    got = pcsv.read_csv(io.BytesIO(data),
                        read_options=pcsv.ReadOptions(skip_rows=1),
                        parse_options=pcsv.ParseOptions(delimiter=";"),
                        convert_options=pcsv.ConvertOptions(),
                        device="cpu")
    assert got.combine_chunks().to_pydict() == {"a": [1, 2],
                                                "b": ["x", "y"]}
    got = pcsv.read_csv(io.BytesIO(b"a,b\n1,2\n"), parse_options=pcsv
                        .ParseOptions(escape_char="\\"), device="cpu")
    assert got.combine_chunks().to_pydict() == {"a": [1], "b": [2]}
    rows = [v for b in pcsv.open_csv(io.BytesIO(b"a\n1\n2\n"), device="cpu")
            for v in b.column("a").to_pylist()]
    assert rows == [1, 2]


def test_facade_twins_of_the_pyarrow_facade_tests(tmp_path):
    import arrow1_tpu.csv as acsv

    p = tmp_path / "x.csv"
    p.write_text("a;b\n1;x\n2;y\n")
    batches = list(pcsv.open_csv(
        str(p), parse_options=pcsv.ParseOptions(delimiter=";"),
        device="cpu"))
    assert batches[0].num_rows == 2 and "a" in batches[0].names
    q = tmp_path / "y.csv"
    q.write_text("a,b\n1,NA\n2,z\n")
    co = dict(null_values=["NA"], strings_can_be_null=True)
    t = pcsv.read_csv(str(q), convert_options=pcsv.ConvertOptions(**co),
                      device="cpu")
    ref = acsv.read_csv(str(q), convert_options=acsv.ConvertOptions(**co))
    same_tables(t.to_arrow(), ref.to_arrow())
    assert t.column("b").to_pylist() == [None, "z"]
    t2 = pcsv.read_csv(str(q), read_options=pcsv.ReadOptions(
        skip_rows_after_names=1), device="cpu")
    assert t2.column("a").to_pylist() == [2]
