"""The port stands alone: it imports without JAX, never imports the JAX
package or pyarrow at module level, runs on CUDA unless asked for the
CPU, and builds its kernels only when they are first called."""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pyarrow as pa
import pytest
import torch

import arrow1_tpu_torch as pt
from arrow1_tpu_torch import dtypes as dt
from arrow1_tpu_torch.kernels import (build, compaction, compaction_split,
                                     probes)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "arrow1_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


# one interpreter for both blocked-import checks: each section reports
# on its own line, so one failing does not hide the other
_BLOCKED = ("import sys, traceback\n"
            "for m in ('jax', 'pyarrow', 'flatbuffers', 'zstandard',"
            " 'pandas', 'cryptography', 'grpc'):\n"
            "    sys.modules[m] = None\n"
            "def section(name, code):\n"
            "    try:\n"
            "        exec(code, {})\n"
            "        print('SECTION', name, 'OK')\n"
            "    except BaseException:\n"
            "        print('SECTION', name, 'FAILED')\n"
            "        traceback.print_exc(file=sys.stdout)\n")

PORT_IMPORTS = ("import sys\n"
               "import arrow1_tpu_torch\n"
               "import arrow1_tpu_torch.exec.compiled\n"
               "import arrow1_tpu_torch.kernels.compaction\n"
               "import arrow1_tpu_torch.kernels.fused_ops\n"
               "import arrow1_tpu_torch.ops.padded\n"
               "import arrow1_tpu_torch.ops.hash\n"
               "import arrow1_tpu_torch.ops.aggregate\n"
               "import arrow1_tpu_torch.ops.groupby\n"
               "import arrow1_tpu_torch.kernels.segsum2\n"
               "import arrow1_tpu_torch.kernels.segsum\n"
               "import arrow1_tpu_torch.compute\n"
               "import arrow1_tpu_torch.kernels.hashtable\n"
               "import arrow1_tpu_torch.ops.dictionary\n"
               "import arrow1_tpu_torch.ops.join\n"
               "import arrow1_tpu_torch.ops.sort\n"
               "import arrow1_tpu_torch.acero\n"
               "import arrow1_tpu_torch.query\n"
               "import arrow1_tpu_torch.exec.plan\n"
               "import arrow1_tpu_torch.exec.streaming\n"
               "import arrow1_tpu_torch.models\n"
               "import arrow1_tpu_torch.kernels.compaction_split\n"
               "import arrow1_tpu_torch.kernels.probes\n"
               "import arrow1_tpu_torch.config\n"
               "import arrow1_tpu_torch.ops.validity\n"
               "import arrow1_tpu_torch.ops.cast\n"
               "import arrow1_tpu_torch.ops.bitwise\n"
               "import arrow1_tpu_torch.ops.math\n"
               "import arrow1_tpu_torch.ops.cumulative\n"
               "import arrow1_tpu_torch.ops.conditional\n"
               "import arrow1_tpu_torch.ops.set_lookup\n"
               "import arrow1_tpu_torch.ops.ree\n"
               "import arrow1_tpu_torch.ops.strings\n"
               "import arrow1_tpu_torch.ops.strings_device\n"
               "import arrow1_tpu_torch.ops.strings_host\n"
               "import arrow1_tpu_torch.ops.formatting\n"
               "import arrow1_tpu_torch.compute_strings\n"
               "import arrow1_tpu_torch.ops.temporal\n"
               "import arrow1_tpu_torch.utils.tzif\n"
               "import arrow1_tpu_torch.compute_temporal\n"
               "import arrow1_tpu_torch.ops.nested\n"
               "import arrow1_tpu_torch.compute_nested\n"
               "import arrow1_tpu_torch.parallel\n"
               "import arrow1_tpu_torch.parallel.mesh\n"
               "import arrow1_tpu_torch.parallel.shuffle\n"
               "import arrow1_tpu_torch.parallel.distributed\n"
               "import arrow1_tpu_torch.parallel.multihost\n"
               "import arrow1_tpu_torch.exec.dist_compiled\n"
               "import torch.distributed as dist\n"
               "assert not dist.is_initialized()\n"
               "assert len(arrow1_tpu_torch.list_functions()) == 307\n"
               "assert not any(m == 'arrow1_tpu' or m.startswith('arrow1_tpu.')"
               " for m in sys.modules)\n")

HOST_PLANE = ("native", "types", "cancel", "thread_pool", "memory", "runtime",
              "utils.timing", "profiler", "io", "io.streams",
              "io.compression", "io._flatbuf", "io.ipc_native", "io.ipc",
              "ipc", "io.feather1", "feather", "io.prefetch")

HOST_PLANE_RUN = ("import sys, io, importlib\n"
                  f"for m in {HOST_PLANE!r}:\n"
                  "    importlib.import_module('arrow1_tpu_torch.' + m)\n"
                  "import numpy as np\n"
                  "import arrow1_tpu_torch as pt\n"
                  "from arrow1_tpu_torch.io import ipc_native, feather1\n"
                  "b = pt.record_batch({'x': np.arange(5), 's': np.array("
                  "['a', None, 'b', 'a', 'c'], dtype=object)}, device='cpu')\n"
                  "buf = io.BytesIO()\n"
                  "ipc_native.write_file(buf, [b, b], compression='lz4')\n"
                  "back = ipc_native.read_file(buf.getvalue(), device='cpu')\n"
                  "assert back[1]['s'].to_pylist() == "
                  "['a', None, 'b', 'a', 'c']\n"
                  "v1 = io.BytesIO()\n"
                  "feather1.write_feather_v1(b, v1)\n"
                  "got = feather1.read_feather_v1(v1.getvalue(), "
                  "device='cpu')\n"
                  "assert got['x'].to_pylist() == list(range(5))\n"
                  "assert pt.build_info().native_library\n"
                  "assert not any(m == 'arrow1_tpu' or "
                  "m.startswith('arrow1_tpu.') for m in sys.modules)\n")


FILE_FORMATS_RUN = (
    "import io, sys\n"
    "import numpy as np\n"
    "import arrow1_tpu_torch as pt\n"
    "from arrow1_tpu_torch.io import (csv, json, orc, parquet,"
    " parquet_native, ipc_cpp)\n"
    "b = pt.record_batch({'x': np.arange(6), 'f': np.linspace(-1, 1, 6),"
    " 's': np.array(['a', None, 'b,c', 'a', '', 'q'], dtype=object)},"
    " device='cpu')\n"
    "t = pt.Table([b.slice(0, 4), b.slice(4)])\n"
    "want = b.to_pydict()\n"
    "buf = io.BytesIO()\n"
    "csv.write_csv(t, buf)\n"
    "got = csv.read_csv(buf.getvalue(), device='cpu').combine_chunks()\n"
    "assert got['x'].to_pylist() == want['x'], got\n"
    "assert got['f'].to_pylist() == want['f'], got\n"
    "assert got['s'].to_pylist() == ['a', '', 'b,c', 'a', '', 'q']\n"
    "got = json.read_json(b'{\"x\": 1, \"l\": [1, 2]}\\n{\"x\": null}\\n',"
    " device='cpu').combine_chunks()\n"
    "assert got['x'].to_pylist() == [1, None]\n"
    "assert got['l'].offsets.tolist() == [0, 2, 2]\n"
    "assert got['l'].values.to_pylist() == [1, 2]\n"
    "for codec in ('snappy', 'gzip', 'none'):\n"
    "    buf = io.BytesIO()\n"
    "    parquet.write_parquet(t, buf, compression=codec,"
    " row_group_size=4)\n"
    "    got = parquet.read_parquet(buf.getvalue(), device='cpu')\n"
    "    assert got.combine_chunks().to_pydict() == want\n"
    "buf = io.BytesIO()\n"
    "orc.write_orc(t, buf)\n"
    "assert orc.read_orc(buf.getvalue(), device='cpu').combine_chunks()"
    ".to_pydict() == want\n"
    "for blocked, codec in (('zstandard', 'zstd'),):\n"
    "    try:\n"
    "        parquet.write_parquet(b, io.BytesIO(), compression=codec)\n"
    "    except Exception as e:\n"
    "        assert blocked in str(e), e\n"
    "    else:\n"
    "        raise AssertionError('zstd without zstandard')\n"
    "assert not any(m == 'arrow1_tpu' or m.startswith('arrow1_tpu.')"
    " for m in sys.modules)\n")


DATASETS_BRIDGES = ("dataset", "fs", "fs_s3", "fs_hdfs", "cdata", "cabi",
                    "builders", "validate", "tensor", "gandiva", "plasma",
                    "testing")

DATASETS_BRIDGES_RUN = (
    "import os, sys, tempfile, importlib\n"
    f"for m in {DATASETS_BRIDGES!r}:\n"
    "    importlib.import_module('arrow1_tpu_torch.' + m)\n"
    "import numpy as np\n"
    "import arrow1_tpu_torch as pt\n"
    "from arrow1_tpu_torch import (builders, cabi, dataset, gandiva,"
    " plasma, tensor, validate)\n"
    "b = pt.record_batch({'y': np.array([1, 2, 1, 2]), 'v': np.arange(4.0),"
    " 's': np.array(['a', None, 'b', 'a'], dtype=object)}, device='cpu')\n"
    "with tempfile.TemporaryDirectory() as d:\n"
    "    dataset.write_dataset(pt.Table([b, b]), d, ['y'])\n"
    "    ds = dataset.dataset(d, partitioning='hive')\n"
    "    got = ds.to_table(filter=pt.field('y') == 2, device='cpu')\n"
    "    assert got.combine_chunks()['v'].to_pylist() == [1.0, 3.0] * 2\n"
    "back = cabi.import_stream_capsule(cabi.export_stream_capsule([b]),"
    " device='cpu')\n"
    "assert back[0]['s'].to_pylist() == ['a', None, 'b', 'a']\n"
    "validate.validate_batch(back[0], full=True)\n"
    "c = builders.StringBuilder().append_values(['x', None]).finish("
    "device='cpu')\n"
    "assert c.to_pylist() == ['x', None]\n"
    "t = tensor.Tensor.from_numpy(np.eye(3), device='cpu')\n"
    "assert t.to_coo().to_csr().to_dense().to_numpy().tolist() == "
    "np.eye(3).tolist()\n"
    "sel = gandiva.make_filter(b, pt.field('v') > 1).evaluate(b)\n"
    "assert sel.to_column().to_pylist() == [2, 3]\n"
    "st = plasma.PlasmaStore(f'/a1t-import-{os.getpid()}',"
    " capacity=1 << 20, max_objects=4)\n"
    "try:\n"
    "    oid = st.put(b)\n"
    "    assert st.get(oid, device='cpu').num_rows == 4\n"
    "finally:\n"
    "    st.destroy()\n"
    "assert not any(m == 'arrow1_tpu' or m.startswith('arrow1_tpu.')"
    " for m in sys.modules)\n")


@pytest.fixture(scope="module")
def blocked_run():
    """stdout of one interpreter with jax, pyarrow, flatbuffers,
    zstandard, pandas, cryptography and grpc blocked that imports the port
    and drives its host plane, its file formats, its datasets and its
    bridges."""
    code = (_BLOCKED + f"section('port', {PORT_IMPORTS!r})\n"
            f"section('host plane', {HOST_PLANE_RUN!r})\n"
            f"section('file formats', {FILE_FORMATS_RUN!r})\n"
            f"section('datasets and bridges', {DATASETS_BRIDGES_RUN!r})\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    return proc.stdout


def test_imports_with_jax_and_pyarrow_blocked(blocked_run):
    assert "SECTION port OK" in blocked_run, blocked_run


def test_host_plane_imports_and_runs_without_its_optional_packages(
        blocked_run):
    """The host plane imports, and writes and reads an LZ4 IPC file and a
    Feather V1 file, with jax, pyarrow, flatbuffers, zstandard and pandas
    blocked; nothing imports the JAX package."""
    assert "SECTION host plane OK" in blocked_run, blocked_run


def test_file_formats_run_without_their_optional_packages(blocked_run):
    """write_csv, read_csv, read_json, write_parquet, read_parquet,
    write_orc and read_orc run natively with jax, pyarrow, zstandard and
    cryptography blocked; ZSTD without zstandard names the package."""
    assert "SECTION file formats OK" in blocked_run, blocked_run


def test_datasets_and_bridges_run_without_their_optional_packages(
        blocked_run):
    """dataset, fs, fs_s3, fs_hdfs, cdata, cabi, builders, validate,
    tensor, gandiva, plasma and testing import, and a partitioned dataset,
    a C stream, a builder, a tensor, a gandiva filter and the plasma store
    run, with jax, pyarrow and grpc blocked."""
    assert "SECTION datasets and bridges OK" in blocked_run, blocked_run


@pytest.mark.parametrize("read", ["csv", "json", "parquet", "orc",
                                  "csv_stream", "parquet_batches"])
def test_file_readers_default_to_cuda(monkeypatch, read):
    from arrow1_tpu_torch.io import csv, json, orc, parquet

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"csv": lambda: csv.read_csv(b"a\n1\n"),
            "json": lambda: json.read_json(b'{"a": 1}\n'),
            "parquet": lambda: parquet.read_parquet(b"PAR1"),
            "orc": lambda: orc.read_orc(b"ORC"),
            "csv_stream": lambda: next(csv.open_csv_stream(b"a\n1\n")),
            "parquet_batches": lambda: next(
                parquet.iter_parquet_batches(b"PAR1"))}[read]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


def _imports(path):
    """(module name, at module level?) of every import in a file."""
    tree = ast.parse(path.read_text(), filename=str(path))
    top = set(map(id, tree.body))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name, id(node) in top
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or "", id(node) in top


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_reference_or_module_level_pyarrow(path):
    for name, top in _imports(path):
        root = name.split(".")[0]
        assert root not in ("jax", "jaxlib", "arrow1_tpu"), (path, name)
        assert not (top and root == "pyarrow"), (path, name)
        assert not (top and root == "triton"), (path, name)


def test_entry_points_default_to_cuda(monkeypatch, tmp_path):
    data = {"k": np.arange(4, dtype=np.int64)}
    pt.dataset.write_dataset(pt.record_batch(data, device="cpu"),
                             str(tmp_path / "ds"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.record_batch(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.PipelineBuilder().sort([("k", "ascending")]).compile()(data)
    x = np.zeros(4, np.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.filter_project_flagship(x, x, np.zeros(4), 0.0, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.group_by(pt.record_batch(data), ["k"], [("k", "count")])
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.join(pt.record_batch(data), pt.record_batch(data), "k")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.join_asof(pt.record_batch(data), pt.record_batch(data), "k")
    build = pt.record_batch(data, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.PipelineBuilder().join(build, "k").compile()(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.broadcast_probe(x, x)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.table(data)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.interop.table_from_arrow(pa.table(data))
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.interop.column_from_numpy(data["k"])
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.interop.column_from_arrow(pa.array(data["k"]))
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.interop.record_batch_from_arrow(pa.record_batch(data))
    # the nested ingest and constructors
    for arr in (pa.array([[1, 2], None]), pa.array([{"a": 1}]),
                pa.array([[1, 2]], pa.list_(pa.int64(), 2)),
                pa.array([[("k", 1)]], pa.map_(pa.string(), pa.int64())),
                pa.UnionArray.from_sparse(pa.array([0], pa.int8()),
                                          [pa.array([1])])):
        with pytest.raises(RuntimeError, match="CUDA"):
            pt.interop.column_from_arrow(arr)
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.fixed_size_list_column(np.zeros((2, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.from_reference_arrays(["l"], [{
            "type": pt.list_(pt.int64), "offsets": np.array([0, 1]),
            "values": (np.array([1]), None, None), "validity": None}], None)
    # the query layer runs where its source's tensors are: a source made
    # without naming the CPU wants CUDA
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.query(pt.table(data)).to_table()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.acero.Declaration("table_source", pt.acero.TableSourceNodeOptions(
            pt.table(data))).to_table()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.exec.plan.source_node(pt.exec.ExecPlan(),
                                 pt.table(data).batches)
    mask = np.ones(1024, bool)
    with pytest.raises(RuntimeError, match="CUDA"):
        compaction.compact_u64(mask, [np.zeros(1024, np.int64)])
    with pytest.raises(RuntimeError, match="CUDA"):
        compaction_split.compact_split(mask, [np.zeros(1024, np.int64)])
    with pytest.raises(RuntimeError, match="CUDA"):
        probes.run_probes()
    # datasets, the C data interface, builders and tensors
    ds = pt.dataset.dataset(str(tmp_path / "ds"))
    with pytest.raises(RuntimeError, match="CUDA"):
        ds.to_table()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.query(ds).to_table()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.cdata.import_column(pa.array([1, 2]))
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.builders.Int64Builder().append(1).finish()
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.tensor.Tensor.from_numpy(np.eye(2))
    assert ds.to_table(device="cpu").num_rows == 4
    # random makes data: on the card unless the caller names the CPU
    with pytest.raises(RuntimeError, match="CUDA"):
        pt.call_function("random", [], length=4, initializer=1)
    assert pt.call_function("random", [], length=4, initializer=1,
                            device="cpu").device.type == "cpu"
    assert pt.record_batch(data, device="cpu")["k"].device.type == "cpu"
    assert pt.interop.column_from_numpy(
        data["k"], device="cpu").device.type == "cpu"
    assert pt.interop.column_from_arrow(
        pa.array(data["k"]), device="cpu").device.type == "cpu"
    assert pt.interop.record_batch_from_arrow(
        pa.record_batch(data), device="cpu")["k"].device.type == "cpu"
    t = pt.table(data, device="cpu")
    assert pt.query(t).to_table().batches[0]["k"].device.type == "cpu"


def test_later_slice_types_raise():
    # every type of the JAX package is a type of the port since the nested
    # slice: nested types construct and map to arrow both ways
    for t in (pa.list_(pa.int64()), pa.large_list(pa.string()),
              pa.list_(pa.float64(), 3), pa.map_(pa.string(), pa.int64()),
              pa.struct([("a", pa.int64()), ("b", pa.list_(pa.string()))]),
              pa.union([pa.field("i", pa.int64()),
                        pa.field("s", pa.string())], "sparse"),
              pa.union([pa.field("i", pa.int64())], "dense", [3])):
        assert dt.to_arrow(dt.from_arrow(t)) == t
        assert dt.from_arrow(t).is_nested
        with pytest.raises(TypeError):
            dt.from_arrow(t).physical_dtype()
    assert pt.list_(pt.int64) == dt.DataType("list", fields=(("item",
                                                               dt.int64),))
    with pytest.raises(TypeError):
        dt.DataType("no such kind")
    # decimals are types of the port since the decimal slice
    assert pt.decimal128(15, 2) == dt.from_arrow(pa.decimal128(15, 2))
    assert dt.to_arrow(pt.decimal256(76, 0)) == pa.decimal256(76, 0)
    assert pt.decimal128(15, 2).physical_dtype() == torch.int64
    assert dt.timestamp("us", "UTC").physical_dtype() == torch.int64
    assert dt.date32.physical_dtype() == torch.int32
    assert dt.from_numpy_dtype(np.float32) == dt.float32
    assert dt.int64.physical_dtype() == torch.int64
    assert dt.string.physical_dtype() == torch.int32


def test_build_is_keyed_on_sources_and_needs_nvcc(monkeypatch, tmp_path):
    for src in build.TARGETS:
        path = build.library_path(src)
        assert path.parent == build.BUILD_DIR
        assert path == build.library_path(src)   # deterministic
    assert build.library_path(build.SOURCES[0]) != \
        build.library_path(build.SOURCES[1])
    # the operator library is keyed on each of its two sources
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for p in build.CSRC.iterdir():
        (csrc / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(build, "CSRC", csrc)
    keys = {build.library_path(build.OPS)}
    for src in build.OPS_SOURCES:
        with open(csrc / src, "a") as f:
            f.write("\n// changed\n")
        keys.add(build.library_path(build.OPS))
    assert len(keys) == 1 + len(build.OPS_SOURCES)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setattr(build, "library_path",
                        lambda s: tmp_path / "out" / f"{s}.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()


def test_operator_library_is_built_against_torch(monkeypatch):
    """The command line of the dispatcher library (made here, nvcc is not
    run): sm_90a, torch's headers and C++ ABI, torch's libraries, both of
    its sources; the ctypes libraries see no torch header. The library is
    keyed on torch's version."""
    from torch.utils import cpp_extension

    out = build.BUILD_DIR / "x.so"
    cmd = build.command("nvcc", build.OPS, out)
    assert cmd[0] == "nvcc" and "arch=compute_90a,code=sm_90a" in cmd
    for path in cpp_extension.include_paths():
        assert f"-I{path}" in cmd
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    assert f"-D_GLIBCXX_USE_CXX11_ABI={abi}" in cmd
    for lib in ("c10", "c10_cuda", "torch", "torch_cpu", "torch_cuda"):
        assert f"-l{lib}" in cmd
    for src in build.OPS_SOURCES:
        assert str(build.CSRC / src) in cmd
    assert cmd[cmd.index("-o") + 1] == str(out)
    plain = build.command("nvcc", "compaction.cu", out)
    assert not any(a.startswith(("-I", "-l", "-D")) for a in plain)
    # the library registers every probe and the empty kernel's operator;
    # no ctypes library holds a probe
    host = (build.CSRC / "probe_ops.cpp").read_text()
    assert sorted(re.findall(r'm\.def\("(\w+)\(', host)) == sorted(
        [probes.PROBES[name][0] for name in probes.OPERATORS] +
        [probes.EMPTY])
    assert probes.OPERATORS == tuple(probes.PROBES)
    assert "probes.cu" not in build.SOURCES
    assert not (build.CSRC / "probes.cu").exists()
    before = build.library_path(build.OPS)
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    assert build.library_path(build.OPS) != before


def test_strings_are_dictionary_encoded_at_ingest():
    col = pt.record_batch({"s": np.array(["b", "a", None, "b"],
                                         dtype=object)}, device="cpu")["s"]
    assert col.dtype == dt.string and col.data.dtype == torch.int32
    assert list(col.dictionary.values) == ["b", "a"]
    assert col.to_pylist() == ["b", "a", None, "b"]
