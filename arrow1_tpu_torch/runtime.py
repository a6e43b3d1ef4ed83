"""Runtime/build info + memory observability (counterpart of
arrow1_tpu/runtime.py).

Reference: cpp/src/arrow/config.{h,cc} (GetBuildInfo/GetRuntimeInfo:
version + active SIMD level) and memory_pool.h:114,138 (bytes_allocated /
max_memory counters). Mapping: the "SIMD level" becomes the device the
port runs on (``cuda`` or ``cpu``) and its name; the pool counters come
from PyTorch's CUDA caching allocator (``torch.cuda.memory_stats``),
under the names the JAX package reads from its allocator.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch

from .device import resolve_device

__all__ = ["build_info", "runtime_info", "device_memory_stats", "profile",
           "MemoryLog"]


@dataclasses.dataclass(frozen=True)
class BuildInfo:
    version: str
    torch_version: str
    cuda_version: Optional[str]      # None for a CPU-only torch
    pyarrow_version: Optional[str]   # None where pyarrow is not installed
    native_library: bool


def _installed_version(dist: str) -> Optional[str]:
    """A distribution's version from its metadata, without importing it."""
    from importlib import metadata

    try:
        return metadata.version(dist)
    except metadata.PackageNotFoundError:
        return None


def build_info() -> BuildInfo:
    """Reference: GetBuildInfo (config.h)."""
    from . import __version__
    from .native import native_available

    return BuildInfo(__version__, torch.__version__, torch.version.cuda,
                     _installed_version("pyarrow"), native_available())


@dataclasses.dataclass(frozen=True)
class RuntimeInfo:
    backend: str          # the "SIMD level" analogue: cuda | cpu
    device_kind: str
    device_count: int
    x64_enabled: bool     # torch computes in 64 bits natively: always True


def runtime_info(device=None) -> RuntimeInfo:
    """Reference: GetRuntimeInfo (config.h): the device the entry points
    run on (CUDA unless the caller names the CPU)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return RuntimeInfo("cuda", torch.cuda.get_device_name(dev),
                           torch.cuda.device_count(), True)
    return RuntimeInfo(dev.type, dev.type, 1, True)


def device_memory_stats(device=None) -> Dict[str, int]:
    """Allocator counters (reference: MemoryPool::bytes_allocated /
    max_memory) of a CUDA device under the JAX package's names:
    ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit`` (the card's
    memory), ``bytes_reserved`` (held by the caching allocator) and
    ``num_allocs``. An empty dict for the CPU, which has no device
    allocator."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return {}
    s = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(s.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(s.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(dev)
                               .total_memory),
            "bytes_reserved": int(s.get("reserved_bytes.all.current", 0)),
            "num_allocs": int(s.get("allocation.all.allocated", 0))}


class profile:
    """torch.profiler trace context (the JAX package's writes an XProf
    trace): CPU activity, and CUDA activity where a card is present. On
    exit the trace is written to ``log_dir`` as a Chrome trace
    (chrome://tracing, Perfetto); ``profiler`` keeps the session for
    ``key_averages()``.

        with runtime.profile("traces"):
            pipe(batch)
    """

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.profiler = None
        self.trace_path = None

    def __enter__(self):
        from torch import profiler as tp

        acts = [tp.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(tp.ProfilerActivity.CUDA)
        self.profiler = tp.profile(activities=acts)
        self.profiler.__enter__()
        return self

    def __exit__(self, *exc):
        self.profiler.__exit__(*exc)
        os.makedirs(self.log_dir, exist_ok=True)
        self.trace_path = os.path.join(self.log_dir,
                                       f"a1t-trace-{os.getpid()}.json")
        self.profiler.export_chrome_trace(self.trace_path)


class MemoryLog:
    """LoggingMemoryPool analogue (memory_pool.h:114): snapshot allocator
    stats around a code region and report the delta."""

    def __init__(self, device=None, label: str = ""):
        self.device = device
        self.label = label
        self.before: Dict[str, int] = {}
        self.after: Dict[str, int] = {}

    def __enter__(self):
        self.before = device_memory_stats(self.device)
        return self

    def __exit__(self, *exc):
        self.after = device_memory_stats(self.device)

    @property
    def delta(self) -> Dict[str, int]:
        return {k: self.after.get(k, 0) - self.before.get(k, 0)
                for k in set(self.before) | set(self.after)}
