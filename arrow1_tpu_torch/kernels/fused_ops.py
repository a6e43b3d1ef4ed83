"""Fused filter+project (K1): the flagship of BASELINE config 1.

``filter_project_flagship(key, v, f, thresh, vthr, out_limit=None)``
keeps the rows where ``f > thresh`` and ``v > vthr`` and returns
``(key_out, proj_out, count)`` with ``proj = v * 2.0 + f``: the kept rows
in row order in the first ``min(count, len)`` slots of tensors of ``n``
slots (``out_limit`` if given), and ``count`` as a device int64 scalar.

It is the counterpart of arrow1_tpu/kernels/compaction_v15.py:compact_fused
driven with arrow1_tpu/kernels/fused_ops.py:flagship_filter_project and
bench.py's ``one_v15`` (the return shape of ``compact_fused_auto``). The
TPU kernel took i64 as i32 word planes and f64 as float-float pairs; here
key and v are int64, f is float64, ``thresh`` goes to the kernel as a C
double and ``vthr`` as a 64-bit integer, so no parameter packing can
overflow.

On CUDA tensors it launches ``csrc/fused_filter_project.cu`` (one pass
over tiles staged in shared memory, placed by a decoupled look-back); on
CPU tensors it runs ``filter_project_plain``. Inputs that are not tensors are
placed on CUDA, which must then be present.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from ..device import resolve_device
from . import build

__all__ = ["filter_project_flagship", "filter_project_plain", "SOURCE"]

SOURCE = "fused_filter_project.cu"


@functools.cache
def _kernel():
    lib = build.load(SOURCE)
    fn = lib.a1t_filter_project
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_double, ctypes.c_longlong,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.a1t_filter_project_tile_rows.restype = ctypes.c_int64
    return fn, lib.a1t_filter_project_tile_rows()


def _inputs(key, v, f):
    dev = next((x.device for x in (key, v, f)
                if isinstance(x, torch.Tensor)), None) or resolve_device()
    key, v, f = (torch.as_tensor(x, device=dev) for x in (key, v, f))
    for name, x, want in (("key", key, torch.int64), ("v", v, torch.int64),
                          ("f", f, torch.float64)):
        if x.dtype != want or x.dim() != 1:
            raise TypeError(f"filter_project_flagship: {name} must be 1-D "
                            f"{want}, got {x.dtype} {tuple(x.shape)}")
        if x.shape != key.shape or x.device != key.device:
            raise ValueError("filter_project_flagship: key, v and f must "
                             "have one length and one device")
    return key, v, f


def _out_len(n: int, out_limit: Optional[int]) -> int:
    return n if out_limit is None else max(0, min(int(out_limit), n))


def filter_project_plain(key, v, f, thresh: float, vthr: int,
                         out_limit: Optional[int] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]:
    """The same function in plain PyTorch: the predicate, the projection
    (one rounding per operation), then boolean-mask indexing."""
    key, v, f = _inputs(key, v, f)
    mask = (f > float(thresh)) & (v > int(vthr))
    proj = v.to(torch.float64) * 2.0 + f
    out_len = _out_len(key.shape[0], out_limit)
    outs = []
    for x in (key, proj):
        kept = x[mask][:out_len]
        out = torch.zeros(out_len, dtype=x.dtype, device=x.device)
        out[:kept.shape[0]] = kept
        outs.append(out)
    return outs[0], outs[1], mask.sum(dtype=torch.int64)


def filter_project_flagship(key, v, f, thresh: float, vthr: int,
                            out_limit: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Fused filter+project (see module docstring). Counts its kernel
    launches in ``filter_project_flagship.launches``."""
    key, v, f = _inputs(key, v, f)
    if key.device.type == "cpu":
        return filter_project_plain(key, v, f, thresh, vthr, out_limit)
    if key.device.type != "cuda":
        raise TypeError(f"filter_project_flagship: no kernel for device "
                        f"{key.device}")
    n = key.shape[0]
    dev = key.device
    out_len = _out_len(n, out_limit)
    key_out = torch.empty(out_len, dtype=torch.int64, device=dev)
    proj_out = torch.empty(out_len, dtype=torch.float64, device=dev)
    if n == 0:  # an empty grid is an invalid launch
        return key_out, proj_out, torch.zeros((), dtype=torch.int64,
                                              device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    fn, tile_rows = _kernel()
    # the tile status words and the ticket, zeroed by the kernel's launcher
    status = torch.empty(-(-n // tile_rows) + 1, dtype=torch.int64,
                         device=dev)
    # the kernel stages any 8-byte-aligned column (16-byte copies where
    # the address allows, 8-byte ones elsewhere)
    key, v, f = (build.aligned(x, 8) for x in (key, v, f))
    err = fn(key.data_ptr(), v.data_ptr(), f.data_ptr(), n, float(thresh),
             int(vthr), key_out.data_ptr(), proj_out.data_ptr(), out_len,
             status.data_ptr(), count.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"filter+project kernel launch failed: CUDA "
                           f"error {err}")
    filter_project_flagship.launches += 1
    return key_out, proj_out, count


filter_project_flagship.launches = 0
