"""The port's datasets (arrow1_tpu_torch/dataset.py) and the dataset hooks
of query(), acero and the parquet facade, against the JAX package's
(arrow1_tpu/dataset.py) and pyarrow.dataset, on the CPU: twins of the
dataset parts of tests/test_exec_io_dataset.py and tests/test_query.py.

Hive-partitioned datasets of a few thousand rows (several batches, NaNs,
nulls, an all-null column) are written by each of the three and read by
the other two: equal values in equal order. The JAX package's writes,
reads and query come from an answer worker (``reference_answers``). pyarrow infers int32 for an
integer partition key where both packages infer int64 (ROADMAP Queue 3),
so that one column is compared by value. Pruning, filter pushdown,
projection, head, count_rows and the empty scan are held to pyarrow.
"""

import os

import numpy as np
import pyarrow as pa
import pyarrow.compute as pc
import pyarrow.dataset as pads
import pytest

import arrow1_tpu as a1t
from arrow1_tpu import dataset as ref_ds

import arrow1_tpu_torch as pt
from arrow1_tpu_torch import acero
from arrow1_tpu_torch import dataset as pds
from arrow1_tpu_torch import parquet as ppq
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.fs import FileSelector
from arrow1_tpu_torch.interop import table_from_arrow
from test_torch_answers import answers_of

N = 3000


def source(n=N, seed=5, years=4):
    """Three batches: a partition key of ``years`` values from 2019, an
    int, a float with NaN and nulls, a string with nulls, an all-null
    float column."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    v[rng.random(n) < 0.05] = np.nan
    t = pa.table({
        "year": pa.array(rng.integers(2019, 2019 + years, n), pa.int64()),
        "k": pa.array(rng.integers(0, 10, n), pa.int64()),
        "v": pa.array(v, mask=rng.random(n) < 0.05),
        "s": pa.array(rng.choice(["x", "yy", "zzz"], n),
                      mask=rng.random(n) < 0.1),
        "gone": pa.nulls(n, pa.float64()),
    })
    return pa.Table.from_batches(t.to_batches(max_chunksize=n // 3 + 1))


def values(t: pa.Table):
    """Comparable columns: floats as bits (None at nulls), the others as
    Python values (an integer partition key whatever its width)."""
    out = {}
    for name in t.column_names:
        c = t[name].combine_chunks()
        if pa.types.is_floating(c.type):
            bits = c.fill_null(0).to_numpy(zero_copy_only=False).view(
                np.int64).tolist()
            out[name] = [b if ok else None for b, ok in
                         zip(bits, c.is_valid().to_pylist())]
        else:
            out[name] = c.to_pylist()
    return out


def year_order(t: pa.Table) -> pa.Table:
    """The rows year by year, in source order within a year: the order
    a Hive dataset of ``t`` scans in."""
    years = t["year"].to_numpy()
    order = np.argsort(years, kind="stable")
    return t.take(pa.array(order))


def port_table(t: pa.Table):
    return table_from_arrow(t, device="cpu")


def write_with(writer, t, root):
    if writer == "port":
        pds.write_dataset(port_table(t), root, ["year"])
    elif writer == "reference":
        ref_ds.write_dataset(a1t.table(t), root, ["year"])
    else:
        pads.write_dataset(t, root, format="parquet", partitioning=["year"],
                           partitioning_flavor="hive", use_threads=False,
                           preserve_order=True)


def read_with(reader, root):
    if reader == "port":
        return pds.dataset(root, partitioning="hive").to_table(
            device="cpu").to_arrow()
    if reader == "reference":
        return ref_ds.dataset(root, partitioning="hive").to_table() \
            .to_arrow()
    return pads.dataset(root, partitioning="hive").to_table()


PAIRS = [(w, r) for w in ("port", "reference", "pyarrow")
         for r in ("port", "reference", "pyarrow") if w != r]


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def reference_answers(part):
    """The JAX package's side, computed in two answer workers (its first
    dataset write and its first group_by each compile for seconds): part
    0 the dataset it writes (its files' bytes) and its reads of the
    port's and pyarrow's datasets, part 1 its query and head over a
    port-written one."""
    import tempfile

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        if part == 0:
            src = source(years=2)
            for writer in ("port", "reference", "pyarrow"):
                write_with(writer, src, os.path.join(tmp, writer))
            ref_root = os.path.join(tmp, "reference")
            out["files"] = {rel: open(os.path.join(ref_root, rel),
                                      "rb").read()
                            for rel in files(ref_root)}
            out["reads"] = {w: read_with("reference", os.path.join(tmp, w))
                            for w in ("port", "pyarrow")}
            return out
        root = os.path.join(tmp, "hive")
        pds.write_dataset(port_table(source()), root, ["year"])
        d = ref_ds.dataset(root, partitioning=ref_ds.HivePartitioning())
        out["query"] = (a1t.query(d).filter(a1t.field("year") == 2021)
                        .group_by(["k"], [("v", "count")])
                        .order_by([("k", "ascending")]).to_batch()
                        .to_arrow())
        out["head"] = d.head(5).to_arrow()
    return out


@pytest.fixture(scope="module")
def answers():
    return answers_of(__name__)


@pytest.fixture(scope="module")
def written(tmp_path_factory, answers):
    """The same two-partition source written by each of the three (the
    JAX package's files come from its answers)."""
    src = source(years=2)
    roots = {}
    for writer in ("port", "reference", "pyarrow"):
        roots[writer] = str(tmp_path_factory.mktemp(writer) / "ds")
        if writer != "reference":
            write_with(writer, src, roots[writer])
            continue
        for rel, data in answers["files"].items():
            os.makedirs(os.path.dirname(os.path.join(roots[writer], rel)),
                        exist_ok=True)
            with open(os.path.join(roots[writer], rel), "wb") as f:
                f.write(data)
    return src, roots


@pytest.mark.parametrize("writer,reader", PAIRS)
def test_partitioned_datasets_cross_read(writer, reader, written, answers):
    src, roots = written
    got = answers["reads"][writer] if reader == "reference" else \
        read_with(reader, roots[writer])
    want = year_order(src)
    assert got.column_names == ["k", "v", "s", "gone", "year"]
    g, w = values(got), values(want.select(got.column_names))
    for name in got.column_names:
        if name == "gone" and reader == "reference":
            # the JAX package reads an all-null float column as NaNs
            assert all(x is None or np.isnan(np.int64(x).view(np.float64))
                       for x in g[name]), name
            continue
        assert g[name] == w[name], (writer, reader, name)
    if reader == "port":
        assert got["year"].type == pa.int64()


def test_port_layout_and_names_match_the_reference(written, tmp_path):
    _, roots = written
    assert files(roots["port"]) == files(roots["reference"]) == [
        "year=2019/part-0.parquet", "year=2020/part-1.parquet"]
    src = source(40, years=2)
    pds.write_dataset(port_table(src), str(tmp_path / "two"), ["year", "k"])
    combos = sorted({(y, k) for y, k in zip(src["year"].to_pylist(),
                                            src["k"].to_pylist())}, key=repr)
    assert files(str(tmp_path / "two")) == sorted(
        f"year={y}/k={k}/part-{i}.parquet" for i, (y, k) in enumerate(combos))


@pytest.mark.parametrize("fmt", ["parquet", "ipc", "csv", "orc"])
def test_write_dataset_formats_round_trip(fmt, tmp_path):
    src = source(600).drop(["gone"])   # csv and orc write no null type
    root = str(tmp_path / fmt)
    pds.write_dataset(port_table(src), root, ["year"], format=fmt)
    d = pds.dataset(root, partitioning="hive", format=fmt)
    got = d.to_table(device="cpu").to_arrow()
    want = year_order(src).select(got.column_names)
    if fmt == "csv":   # the writer leaves a NaN and a null empty: a
        # float reads back null, a string ""
        want = want.set_column(2, "s", pc.fill_null(want["s"], ""))
        want = want.set_column(1, "v", pc.if_else(
            pc.is_nan(want["v"]), pa.scalar(None, pa.float64()), want["v"]))
    assert values(got) == values(want)
    if fmt != "csv":   # pyarrow reads what the port wrote
        pa_fmt = {"ipc": "arrow"}.get(fmt, fmt)
        back = pads.dataset(root, partitioning="hive",
                            format=pa_fmt).to_table()
        assert values(back)["v"] == values(want)["v"]


def test_zero_rows_and_no_partition_keys(tmp_path):
    empty = source().slice(0, 0)
    pds.write_dataset(port_table(empty), str(tmp_path / "e"))
    d = pds.dataset(str(tmp_path / "e"))
    assert d.count_rows(device="cpu") == 0
    got = d.to_table(device="cpu").to_arrow()
    assert got.num_rows == 0 and got.column_names == empty.column_names
    assert pads.dataset(str(tmp_path / "e")).to_table().num_rows == 0
    pds.write_dataset(port_table(empty), str(tmp_path / "p"), ["year"])
    assert not os.listdir(str(tmp_path / "p"))   # no partition, no file


@pytest.fixture(scope="module")
def hive(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("hive") / "ds")
    src = source()
    pds.write_dataset(port_table(src), root, ["year"])
    return root, src


SCANS = {
    "pruned": (pt.field("year") == 2020, pc.field("year") == 2020),
    "pushed": (pt.field("k") > 6, pc.field("k") > 6),
    "both": ((pt.field("year") >= 2021) & (pt.field("v") > 0),
             (pc.field("year") >= 2021) & (pc.field("v") > 0)),
    "empty": (pt.field("k") > 100, pc.field("k") > 100),
    "all_pruned": (pt.field("year") == 1900, pc.field("year") == 1900),
}


@pytest.mark.parametrize("case", list(SCANS))
def test_scans_match_pyarrow(case, hive):
    root, _ = hive
    port_f, pa_f = SCANS[case]
    d = pds.dataset(root, partitioning="hive")
    want = pads.dataset(root, partitioning="hive").to_table(
        filter=pa_f, columns=["k", "v", "year"])
    got = d.to_table(filter=port_f, columns=["k", "v", "year"],
                     device="cpu").to_arrow()
    assert got.column_names == want.column_names
    assert values(got) == values(want)
    assert d.count_rows(filter=port_f, device="cpu") == want.num_rows
    kept = {"pruned": 1, "all_pruned": 0, "both": 2}.get(case, 4)
    assert len(d.get_fragments(port_f)) == kept


def test_projection_head_and_scanner_builder(hive, answers):
    root, src = hive
    d = pds.dataset(root, partitioning="hive")
    want = year_order(src)
    sc = (pds.ScannerBuilder(d).filter(pt.field("k") < 3)
          .project([pt.field("v") * 2.0, pt.field("year")], ["v2", "year"])
          .finish(device="cpu").to_table().to_arrow())
    keep = want.filter(pc.less(want["k"], 3))
    assert values(sc)["v2"] == values(pa.table(
        {"v2": pc.multiply(keep["v"], 2.0)}))["v2"]
    assert sc["year"].to_pylist() == keep["year"].to_pylist()
    for n in (0, 5, 1500, N + 10):
        head = d.head(n, device="cpu").to_arrow()
        assert values(head) == values(want.slice(0, n).select(
            head.column_names))
    assert answers["head"]["k"].to_pylist() == d.head(
        5, device="cpu").to_arrow()["k"].to_pylist()
    assert d.count_rows(device="cpu") == N
    assert [os.path.basename(f) for f in d.files] == \
        [f"part-{i}.parquet" for i in range(4)]


def test_query_over_a_partitioned_dataset_matches_the_reference(hive,
                                                               answers):
    """tests/test_query.py's model: a pruned group_by over the dataset."""
    root, src = hive
    d = pds.dataset(root, partitioning="hive")
    got = (pt.query(d, device="cpu").filter(pt.field("year") == 2021)
           .group_by(["k"], [("v", "count")])
           .order_by([("k", "ascending")]).to_batch().to_arrow())
    ref = answers["query"]
    sub = src.filter(pc.equal(src["year"], 2021))
    want = sub.group_by(["k"]).aggregate([("v", "count")]).sort_by("k")
    for name in ("v_count", "k"):
        assert got[name].to_pylist() == want[name].to_pylist() == \
            ref[name].to_pylist()
    sel = (pt.query(d, device="cpu").filter(pt.field("k") == 3)
           .select(["v", "year"]).to_table().to_arrow())
    keep = year_order(src).filter(pc.equal(year_order(src)["k"], 3))
    assert values(sel) == values(keep.select(["v", "year"]))


def test_partitionings_and_factories(tmp_path):
    src = source(300)
    t = port_table(src)
    for kind, part in (("dir", pds.DirectoryPartitioning(["year"])),
                       ("file", pds.FilenamePartitioning(["year"]))):
        root = str(tmp_path / kind)
        pds.write_dataset(t, root, ["year"], partitioning=part)
        d = pds.dataset(root, partitioning=part)
        assert len(d.fragments) == 4
        got = d.to_table(filter=pt.field("year") == 2022,
                         device="cpu").to_arrow()
        want = src.filter(pc.equal(src["year"], 2022))
        assert values(got)["v"] == values(want)["v"]
        assert got["year"].to_pylist() == want["year"].to_pylist()
    assert sorted(os.listdir(str(tmp_path / "file"))) == [
        f"{y}_part-{i}.parquet" for i, y in enumerate(range(2019, 2023))]
    typed = pds.partitioning(pa.schema([("year", pa.int16())]),
                             flavor="hive")
    root = str(tmp_path / "hive")
    pds.write_dataset(t, root, ["year"])
    d = pds.dataset(root, partitioning=typed)
    assert d.to_table(device="cpu").to_arrow()["year"].type == pa.int16()
    assert pds.get_partition_keys(d.fragments[0].partition_expression) == \
        {"year": 2019}
    fac = pds.PartitioningFactory("hive").finish()
    assert isinstance(fac, pds.HivePartitioning)
    with pytest.raises(Invalid):
        pds.partitioning()
    factory = pds.FileSystemDatasetFactory(
        None, FileSelector(root), pds.ParquetFileFormat(),
        pds.FileSystemFactoryOptions(
            partitioning=pds.PartitioningFactory("hive")))
    assert factory.finish().count_rows(device="cpu") == 300
    assert ("year", pt.int64) in factory.inspect(device="cpu")


def test_memory_union_acero_and_parquet_facade(hive, tmp_path):
    root, src = hive
    t = port_table(src)
    mem = pds.dataset(t)
    assert isinstance(mem, pds.InMemoryDataset)
    assert mem.count_rows(filter=pt.field("k") == 1, device="cpu") == \
        int(pc.sum(pc.equal(src["k"], 1)).as_py())
    d = pds.dataset(root, partitioning="hive")
    u = pds.dataset([d, d])
    assert isinstance(u, pds.UnionDataset)
    assert u.count_rows(device="cpu") == 2 * N
    opts = acero.ScanNodeOptions(d, filter=pt.field("k") > 1)
    assert opts.dataset is d and "filter" in opts.scan_kwargs
    assert acero.ds is pds
    pqd = ppq.ParquetDataset(root, partitioning="hive")
    assert values(pqd.to_table(device="cpu").to_arrow()) == values(
        d.to_table(device="cpu").to_arrow())
    paths = [f.path for f in d.fragments]
    listed = pds.dataset(paths, format=pds.ParquetFileFormat())
    assert listed.count_rows(device="cpu") == N
    with pytest.raises(Invalid):
        pds.write_dataset(port_table(pa.table({"y": pa.array(
            [1, None], pa.int64())})), str(tmp_path / "n"), ["y"])


def test_scan_options_and_threads(hive):
    root, src = hive
    d = pds.dataset(root, partitioning="hive")
    unordered = d.to_table(ordered=False, fragment_readahead=2,
                           readahead=1, device="cpu").to_arrow()
    assert sorted(unordered["k"].to_pylist()) == sorted(
        src["k"].to_pylist())
    with pytest.raises(TypeError):
        d.scanner(no_such_option=1)
    from arrow1_tpu_torch.cancel import StopSource

    stop = StopSource()
    stop.request_stop()
    with pytest.raises(Exception):
        d.to_table(stop_token=stop.token, device="cpu")
