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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import build
from .segsum2 import SOURCE

__all__ = ["segment_sum_count", "segment_sum_count_plain"]


@functools.cache
def _kernel():
    fn = build.load(SOURCE).a1t_segment_sum_count
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    sums = torch.zeros(G, dtype=torch.float32, device=gid.device)
    counts = torch.zeros(G, dtype=torch.float32, device=gid.device)
    n = gid.shape[0]
    if n:   # an empty grid is an invalid launch
        g, v, m = (t.contiguous() for t in (gid, values, live))
        err = _kernel()(g.data_ptr(), v.data_ptr(), m.data_ptr(), n, G,
                        sums.data_ptr(), counts.data_ptr(),
                        torch.cuda.current_stream(gid.device).cuda_stream)
        if err:
            raise RuntimeError(f"segment_sum_count kernel launch failed: "
                               f"CUDA error {err}")
        segment_sum_count.launches += 1
    return sums, counts


segment_sum_count.launches = 0
