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
from arrow1_tpu_torch.errors import NotImplementedError_
from arrow1_tpu_torch.kernels import (build, compaction, compaction_split,
                                     probes)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "arrow1_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def test_imports_with_jax_and_pyarrow_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['pyarrow'] = None\n"
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
            "assert not any(m == 'arrow1_tpu' or m.startswith('arrow1_tpu.')"
            " for m in sys.modules)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


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


def test_entry_points_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = {"k": np.arange(4, dtype=np.int64)}
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
    for kind in ("timestamp", "decimal128", "list"):
        with pytest.raises(NotImplementedError_):
            dt.DataType(kind)
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
    plain = build.command("nvcc", "probes.cu", out)
    assert not any(a.startswith(("-I", "-l", "-D")) for a in plain)
    # the library registers the four operator probes; probes.cu keeps a C
    # entry for each of the other two only
    host = (build.CSRC / "probe_ops.cpp").read_text()
    assert sorted(re.findall(r'm\.def\("(\w+)\(', host)) == sorted(
        probes.PROBES[name][0] for name in probes.OPERATORS)
    ctypes_entries = re.findall(r"^int (a1t_\w+)\(",
                                (build.CSRC / "probes.cu").read_text(),
                                re.MULTILINE)
    assert ctypes_entries == [entry for name, (entry, _) in
                              probes.PROBES.items()
                              if name not in probes.OPERATORS]
    before = build.library_path(build.OPS)
    monkeypatch.setattr(torch, "__version__", "0.0.0")
    assert build.library_path(build.OPS) != before


def test_strings_are_dictionary_encoded_at_ingest():
    col = pt.record_batch({"s": np.array(["b", "a", None, "b"],
                                         dtype=object)}, device="cpu")["s"]
    assert col.dtype == dt.string and col.data.dtype == torch.int32
    assert list(col.dictionary.values) == ["b", "a"]
    assert col.to_pylist() == ["b", "a", None, "b"]
