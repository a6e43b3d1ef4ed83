"""Builds the port's CUDA sources (``arrow1_tpu_torch/csrc``) with nvcc
and loads them.

Each source of ``SOURCES`` becomes a shared library with a plain C
interface, ``build/arrow1_tpu_torch/<stem>-<hash>.so`` at the root of the
checkout, loaded with ctypes. ``OPS`` is the one library that registers
operators with PyTorch's dispatcher (``torch.ops.a1t``): its host code,
the only source that includes PyTorch's headers, is built against the
installed torch with the kernels it launches, and loaded with
``torch.ops.load_library``. Every library is keyed on a hash of its
sources and flags (and, for ``OPS``, torch's version), and built at first
use; ``build()`` starts one nvcc per library, all at once, and waits for
them. Nothing here runs at import time: the CPU tests import every module
on machines without nvcc.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "OPS",
           "OPS_SOURCES", "TARGETS", "library_path", "command", "build",
           "load", "load_ops", "aligned"]

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "arrow1_tpu_torch"
SOURCES = ("compaction.cu", "fused_filter_project.cu", "segment_sums.cu",
           "broadcast_probe.cu", "compact_u64.cu", "compaction_split.cu",
           "probes.cu")
# sm_90a: Hopper with its architecture-specific features. -Xptxas=-v puts
# each kernel's registers, shared memory and spills into the build log.
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
# the dispatcher library: its kernels and the host code that registers them
OPS = "probe_ops"
OPS_SOURCES = ("probe_ops.cu", "probe_ops.cpp")
TARGETS = SOURCES + (OPS,)


def _torch_flags():
    """Compile and link flags against the installed torch: its headers,
    its C++ ABI, and the libraries an operator library needs. nvcc adds
    its own toolkit's headers and runtime."""
    import torch
    from torch.utils import cpp_extension

    libs = cpp_extension.library_paths()
    return ([f"-I{p}" for p in cpp_extension.include_paths()] +
            [f"-D_GLIBCXX_USE_CXX11_ABI="
             f"{int(torch._C._GLIBCXX_USE_CXX11_ABI)}"],
            [f"-L{p}" for p in libs] +
            [a for p in libs for a in ("-Xlinker", "-rpath", "-Xlinker", p)] +
            ["-lc10", "-lc10_cuda", "-ltorch", "-ltorch_cpu",
             "-ltorch_cuda"])


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin); the CUDA kernels cannot be built")


def _sources(target: str):
    return OPS_SOURCES if target == OPS else (target,)


def library_path(target: str) -> Path:
    """Where ``target``'s library lives (a source of ``SOURCES``, or
    ``OPS``), keyed on its sources and flags; ``OPS`` also on torch's
    version, whose headers and ABI it is built against."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    if target == OPS:
        import torch

        h.update(torch.__version__.encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / s for s in
                                           _sources(target)]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{Path(target).stem}-{h.hexdigest()[:16]}.so"


def command(nvcc: str, target: str, out: Path) -> list:
    """The nvcc command line that builds ``target``'s library at ``out``."""
    cflags, ldflags = _torch_flags() if target == OPS else ([], [])
    return [nvcc, *NVCC_FLAGS, *cflags, "-o", str(out),
            *(str(CSRC / s) for s in _sources(target)), *ldflags]


def build(targets: Iterable[str] = TARGETS) -> None:
    """Compile every target whose library is missing: one nvcc process per
    target, all started together. Raises with nvcc's output if any fails.
    Each build log is kept beside its library as ``.log``."""
    todo = [(s, library_path(s)) for s in targets]
    todo = [(s, out) for s, out in todo if not out.exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    failures = []
    try:
        for src, out in todo:
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = command(nvcc, src, tmp)
            procs.append((src, out, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        for src, out, tmp, proc in procs:
            text, _ = proc.communicate()
            out.with_suffix(".log").write_text(text)
            if proc.returncode:
                failures.append(f"{src}: nvcc exited {proc.returncode}\n"
                                f"{text}")
            else:
                os.replace(tmp, out)  # atomic: no half-written library
    finally:
        for *_, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failures))


@functools.cache
def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    build([source])
    return ctypes.CDLL(str(library_path(source)))


@functools.cache
def load_ops() -> None:
    """Build ``OPS`` if needed and register its operators in
    ``torch.ops.a1t``; raises with nvcc's or the loader's message."""
    import torch

    build([OPS])
    torch.ops.load_library(str(library_path(OPS)))


def aligned(t, nbytes: int):
    """``t`` contiguous, copied to a fresh allocation only where its
    address is not a multiple of ``nbytes`` (a view at an odd offset):
    the kernels' vector loads need the alignment."""
    t = t.contiguous()
    return t if t.data_ptr() % nbytes == 0 else t.clone()
