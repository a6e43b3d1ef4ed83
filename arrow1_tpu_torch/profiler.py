"""Per-kernel roofline profiler for the eager compute path (counterpart of
arrow1_tpu/profiler.py).

Reference: the tracing/metrics subsystem (the reference's
util/tracing_internal.h spans + benchmark counters). For a memory-bound
columnar engine the number that matters is each call's achieved memory
bandwidth as a fraction of the device's peak; this module records it for
every ``call_function`` dispatch inside the context:

    import arrow1_tpu_torch.compute as pc

    with KernelProfiler() as prof:
        pc.add(a, b)
        pc.filter(batch, mask)
    prof.report()        # per function: calls, ms, MB moved, roofline %

Bytes are the ``nbytes`` of every tensor of the input and output datums:
a Column's data, validity and data2, a nested column's offsets, type ids,
validity and children, a RecordBatch's columns. Each call is timed on the
host clock between two synchronizes of the device its tensors are on, so
profiled runs serialize dispatch (the reference's benchmark counters have
the same caveat).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

__all__ = ["KernelProfiler", "KernelRecord", "hbm_peak_bytes_per_sec",
           "HBM_PEAK", "tensors_of"]

# Peak HBM bandwidth from NVIDIA's data sheets, by device name (first match:
# the H100's PCIe and NVL parts before the plain name, which is the SXM's)
HBM_PEAK = (("H100 PCIe", 2.0e12), ("H100 NVL", 3.9e12), ("H200", 4.8e12),
            ("H100", 3.35e12))
_CPU_NOMINAL = 50e9


def hbm_peak_bytes_per_sec(device=None) -> float:
    """Roofline denominator for a device (CUDA unless the caller names the
    CPU): a card's data-sheet HBM bandwidth by its name, 50 GB/s nominal
    for the CPU. Raises for a card the table does not know."""
    from .device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return _CPU_NOMINAL
    name = torch.cuda.get_device_name(dev)
    for key, rate in HBM_PEAK:
        if key in name:
            return rate
    raise RuntimeError(f"no HBM bandwidth on record for {name!r}")


def tensors_of(x):
    """Every tensor a datum holds, in ``table.map_tensors``' order (a
    shared tensor once for each place it is held)."""
    from .column import Column, ListColumn, StructColumn, UnionColumn
    from .datum import Scalar
    from .table import RecordBatch, map_tensors

    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (Column, ListColumn, StructColumn, UnionColumn,
                      RecordBatch)):
        found = []
        map_tensors(x, lambda t: found.append(t) or t)
        return found
    if isinstance(x, Scalar):
        return [x.value] if isinstance(x.value, torch.Tensor) else []
    if isinstance(x, (list, tuple)):
        return [t for item in x for t in tensors_of(item)]
    return []


def _nbytes(x) -> int:
    return sum(t.numel() * t.element_size() for t in tensors_of(x))


def _synchronize(x) -> None:
    for dev in {t.device for t in tensors_of(x) if t.is_cuda}:
        torch.cuda.synchronize(dev)


@dataclass
class KernelRecord:
    name: str
    wall_s: float
    bytes_in: int
    bytes_out: int

    @property
    def bytes_moved(self) -> int:
        return self.bytes_in + self.bytes_out

    def roofline_frac(self, peak: float) -> float:
        if self.wall_s <= 0:
            return 0.0
        return (self.bytes_moved / self.wall_s) / peak


@dataclass
class _Agg:
    calls: int = 0
    wall_s: float = 0.0
    bytes_moved: int = 0
    best_frac: float = 0.0


_active = threading.local()


def _current() -> Optional["KernelProfiler"]:
    return getattr(_active, "profiler", None)


class KernelProfiler:
    """Context manager collecting one KernelRecord per eager dispatch. The
    roofline's peak is ``device``'s (CUDA unless the caller names the
    CPU), looked up when a report first needs it."""

    def __init__(self, device=None):
        self.records: List[KernelRecord] = []
        self._device = device
        self._peak: Optional[float] = None
        self._prev = None

    @property
    def peak(self) -> float:
        if self._peak is None:
            self._peak = hbm_peak_bytes_per_sec(self._device)
        return self._peak

    def __enter__(self):
        self._prev = _current()
        _active.profiler = self
        return self

    def __exit__(self, *exc):
        _active.profiler = self._prev
        return False

    # called from registry.call_function
    def _measure(self, name: str, runner, datums):
        bytes_in = _nbytes(datums)
        _synchronize(datums)
        t0 = time.perf_counter()
        out = runner()
        _synchronize(out)
        wall = time.perf_counter() - t0
        self.records.append(KernelRecord(name, wall, bytes_in,
                                         _nbytes(out)))
        return out

    # -- reporting --
    def by_kernel(self) -> Dict[str, _Agg]:
        out: Dict[str, _Agg] = {}
        for r in self.records:
            agg = out.setdefault(r.name, _Agg())
            agg.calls += 1
            agg.wall_s += r.wall_s
            agg.bytes_moved += r.bytes_moved
            agg.best_frac = max(agg.best_frac,
                                r.roofline_frac(self.peak))
        return out

    def summary(self) -> List[dict]:
        rows = []
        for name, a in sorted(self.by_kernel().items(),
                              key=lambda kv: -kv[1].wall_s):
            rows.append({
                "kernel": name,
                "calls": a.calls,
                "total_ms": round(a.wall_s * 1e3, 3),
                "mb_moved": round(a.bytes_moved / 1e6, 3),
                "avg_gbps": round(
                    a.bytes_moved / a.wall_s / 1e9, 2) if a.wall_s else 0.0,
                "best_roofline_frac": round(a.best_frac, 4),
            })
        return rows

    def report(self) -> str:
        lines = [f"{'kernel':<24}{'calls':>6}{'ms':>10}{'MB':>10}"
                 f"{'GB/s':>8}{'roof%':>7}"]
        for row in self.summary():
            lines.append(
                f"{row['kernel']:<24}{row['calls']:>6}"
                f"{row['total_ms']:>10.3f}{row['mb_moved']:>10.3f}"
                f"{row['avg_gbps']:>8.2f}"
                f"{100 * row['best_roofline_frac']:>6.1f}%")
        return "\n".join(lines)
