"""Order-preserving stream compaction by a bool mask (K2).

``compact(mask, cols, out_limit=None) -> (outs, count)`` moves the rows of
every column where ``mask`` is True to the front of a new tensor, in row
order. It is the contract of arrow1_tpu/kernels/compaction_v4.py:compact
(the compact_v14 / compact_v7 / compact_v4 / compact_v12 Pallas family):
each output has ``n`` slots (``out_limit`` if given), the first
``min(count, len)`` hold the kept rows and the rest are unspecified;
``count`` is the number of kept rows as a device int64 scalar, never read
on the host here.

On a CUDA tensor it launches the kernel in ``csrc/compaction.cu``; on a
CPU tensor it runs ``compact_plain``, the same function in plain PyTorch.
Any other device raises. See the source for the bound and the design.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import build

__all__ = ["compact", "compact_plain", "SOURCE"]

SOURCE = "compaction.cu"
_WIDTHS = (1, 2, 4, 8)


@functools.cache
def _kernel():
    lib = build.load(SOURCE)
    fn = lib.a1t_compact
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.a1t_compact_rows_per_block.restype = ctypes.c_int64
    return fn, lib.a1t_compact_rows_per_block()


def _out_len(n: int, out_limit: Optional[int]) -> int:
    return n if out_limit is None else max(0, min(int(out_limit), n))


def _check(mask: torch.Tensor, cols: Sequence[torch.Tensor]) -> None:
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError(f"compact: mask must be a 1-D bool tensor, got "
                        f"{mask.dtype} of shape {tuple(mask.shape)}")
    for c in cols:
        if c.dim() != 1 or c.shape[0] != mask.shape[0]:
            raise ValueError(f"compact: column of shape {tuple(c.shape)} "
                             f"does not match the mask's {mask.shape[0]}")
        if c.device != mask.device:
            raise ValueError(f"compact: column on {c.device}, mask on "
                             f"{mask.device}")
        if c.element_size() not in _WIDTHS:
            raise TypeError(f"compact: {c.dtype} is not 1, 2, 4 or 8 bytes")


def compact_plain(mask: torch.Tensor, cols: Sequence[torch.Tensor],
                  out_limit: Optional[int] = None
                  ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """The same function in plain PyTorch: boolean-mask indexing per
    column (unspecified tail slots are zero)."""
    out_len = _out_len(mask.shape[0], out_limit)
    outs = []
    for c in cols:
        kept = c[mask][:out_len]
        out = torch.zeros(out_len, dtype=c.dtype, device=c.device)
        out[:kept.shape[0]] = kept
        outs.append(out)
    return tuple(outs), mask.sum(dtype=torch.int64)


def compact(mask: torch.Tensor, cols: Sequence[torch.Tensor],
            out_limit: Optional[int] = None
            ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Compact every column by ``mask`` in one kernel call (see module
    docstring). Counts its kernel launches in ``compact.launches``."""
    cols = tuple(cols)
    _check(mask, cols)
    if mask.device.type == "cpu":
        return compact_plain(mask, cols, out_limit)
    if mask.device.type != "cuda":
        raise TypeError(f"compact: no kernel for device {mask.device}")
    n = mask.shape[0]
    dev = mask.device
    out_len = _out_len(n, out_limit)
    outs = tuple(torch.empty(out_len, dtype=c.dtype, device=dev)
                 for c in cols)
    if n == 0:  # an empty grid is an invalid launch
        return outs, torch.zeros((), dtype=torch.int64, device=dev)
    count = torch.empty((), dtype=torch.int64, device=dev)
    fn, rows_per_block = _kernel()
    nblocks = -(-n // rows_per_block)
    scratch = torch.empty(2 * nblocks, dtype=torch.int64, device=dev)
    srcs = [c.contiguous() for c in cols]
    k = len(cols)
    src_ptrs = (ctypes.c_void_p * max(k, 1))(*[c.data_ptr() for c in srcs])
    dst_ptrs = (ctypes.c_void_p * max(k, 1))(*[o.data_ptr() for o in outs])
    widths = (ctypes.c_int64 * max(k, 1))(*[c.element_size() for c in srcs])
    err = fn(mask.contiguous().data_ptr(), n, src_ptrs, dst_ptrs, widths, k,
             out_len, scratch.data_ptr(), scratch[nblocks:].data_ptr(),
             count.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"compaction kernel launch failed: CUDA error "
                           f"{err}")
    compact.launches += 1
    return outs, count


compact.launches = 0
