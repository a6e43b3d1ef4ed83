"""Per-group f32 sums and counts of live rows (segsum v1).

``segment_sum_count(gid, values, live, G) -> (sums, counts)`` is the
contract of arrow1_tpu/kernels/segsum.py:segment_sum_count without its
1024-row tiles and 128-multiple group count: ``gid`` int32[n], ``values``
float32[n], ``live`` bool[n]; rows that are not live, or whose id lies
outside ``[0, G)``, count nowhere. ``sums`` and ``counts`` are float32[G].
Counts are exact below 2^24 per group; sums are taken in an order that
the kernel's atomics choose, so they agree with any other order only to
float32 rounding.

On a CUDA tensor it launches the kernel in ``csrc/segment_sums.cu``; on a
CPU tensor it runs ``segment_sum_count_plain``. Any other device raises.
``plan`` chooses the kernel's regime from the shape alone: every CTA of a
cluster holds partials of all G groups in shared memory and the cluster
adds them up (``private``), or rows add straight into the output
(``global``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build, segsum2
from .segsum2 import MODES, SOURCE, Plan

__all__ = ["segment_sum_count", "segment_sum_count_plain", "plan"]

# CTAs that add up their private partials together: at G = 4096 a
# cluster of 2 was faster than one of 4 or 8 (PERF.md)
CLUSTER = 2


@functools.cache
def _kernel():
    fn = build.load(SOURCE).a1t_segment_sum_count
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4 +
                   [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def plan(G: int, smem_bytes: int) -> Plan:
    """The regime of a launch over G groups where a CTA may use
    ``smem_bytes`` of shared memory: ``private`` while one CTA holds an
    f32 sum and a u32 count of every group, else ``global``."""
    if 8 * G <= smem_bytes:
        return Plan("private", CLUSTER, G)
    return Plan("global", 1, G)


def _check(gid, values, live, G) -> None:
    for t, dtype in ((gid, torch.int32), (values, torch.float32),
                     (live, torch.bool)):
        if t.dtype != dtype or t.dim() != 1 or t.shape != gid.shape:
            raise TypeError(f"segment_sum_count: expected 1-D {dtype} of "
                            f"length {gid.shape[0]}, got {t.dtype} of shape "
                            f"{tuple(t.shape)}")
        if t.device != gid.device:
            raise ValueError(f"segment_sum_count: tensor on {t.device}, gid "
                             f"on {gid.device}")
    if G < 1:
        raise ValueError(f"segment_sum_count: G must be positive, got {G}")


def segment_sum_count_plain(gid: torch.Tensor, values: torch.Tensor,
                            live: torch.Tensor, G: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: two ``index_add_`` over the
    live in-range rows (the rest go to a dropped bin G)."""
    _check(gid, values, live, G)
    keep = live & (gid >= 0) & (gid < G)
    idx = torch.where(keep, gid, G).to(torch.int64)
    zeros = torch.zeros(G + 1, dtype=torch.float32, device=gid.device)
    sums = zeros.clone().index_add_(0, idx, torch.where(keep, values, 0.0))
    counts = zeros.index_add_(0, idx, keep.to(torch.float32))
    return sums[:G], counts[:G]


def segment_sum_count(gid: torch.Tensor, values: torch.Tensor,
                      live: torch.Tensor, G: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 sum and count per group in one kernel call (see module
    docstring). Counts its launches in ``segment_sum_count.launches``."""
    _check(gid, values, live, G)
    if gid.device.type == "cpu":
        return segment_sum_count_plain(gid, values, live, G)
    if gid.device.type != "cuda":
        raise TypeError(f"segment_sum_count: no kernel for device "
                        f"{gid.device}")
    n = gid.shape[0]
    if not n:   # an empty grid is an invalid launch
        out = torch.zeros((2, G), dtype=torch.float32, device=gid.device)
        return out[0], out[1]
    p = plan(G, segsum2.smem_bytes())
    # 16-byte loads of ids and values, 4-byte loads of live bytes
    g, v = build.aligned(gid, 16), build.aligned(values, 16)
    m = build.aligned(live, 4)
    # sums then counts; the C entry point zeroes it on the stream
    out = torch.empty((2, G), dtype=torch.float32, device=gid.device)
    err = _kernel()(g.data_ptr(), v.data_ptr(), m.data_ptr(), n, G,
                    MODES[p.mode], p.cluster, out.data_ptr(),
                    torch.cuda.current_stream(gid.device).cuda_stream)
    if err:
        raise RuntimeError(f"segment_sum_count kernel launch failed: CUDA "
                           f"error {err}")
    segment_sum_count.launches += 1
    return out[0], out[1]


segment_sum_count.launches = 0
