"""Builds the port's CUDA sources (``arrow1_tpu_torch/csrc/*.cu``) with
nvcc into shared libraries with a plain C interface, and loads them with
ctypes.

Each source becomes ``build/arrow1_tpu_torch/<stem>-<hash>.so`` at the
root of the checkout, keyed on a hash of the sources and the flags, at
first use; ``build()`` starts one nvcc per source, all at once, and waits
for them. Nothing here runs at import time: the CPU tests import every
module on machines without nvcc.
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

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "SOURCES", "library_path",
           "build", "load"]

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


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (looked on PATH and in "
                       f"{home}/bin); the CUDA kernels cannot be built")


def library_path(source: str) -> Path:
    """Where ``source``'s library lives, keyed on the sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build(sources: Iterable[str] = SOURCES) -> None:
    """Compile every source whose library is missing: one nvcc process per
    source, all started together. Raises with nvcc's output if any fails.
    Each build log is kept beside its library as ``.log``."""
    todo = [(s, library_path(s)) for s in sources]
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
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)]
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
