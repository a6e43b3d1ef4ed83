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

``compact_u64(mask, cols) -> (outs, count)`` is the contract of
arrow1_tpu/kernels/compaction.py:compact_u64: n % 1024 == 0, int64 or
uint64 columns (f64 payloads as int64 bit views), each output
``n + 1024`` long with the kept rows in ``[0, count)``, and ``count`` a
0-d int32 device tensor. It launches ``csrc/compact_u64.cu`` (a one-pass
decoupled look-back) on CUDA and runs ``compact_u64_plain`` on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence, Tuple

import torch

from . import build

__all__ = ["compact", "compact_plain", "compact_u64", "compact_u64_plain",
           "SOURCE", "SOURCE_U64", "TILE"]

SOURCE = "compaction.cu"
SOURCE_U64 = "compact_u64.cu"
TILE = 1024   # compact_u64's row padding (the contract, not the kernel's tile)
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


@functools.cache
def _kernel_u64():
    lib = build.load(SOURCE_U64)
    fn = lib.a1t_compact_u64
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for name in ("a1t_compact_u64_tile_rows", "a1t_compact_u64_max_cols"):
        getattr(lib, name).restype = ctypes.c_int64
    return (fn, lib.a1t_compact_u64_tile_rows(),
            lib.a1t_compact_u64_max_cols())


def u64_inputs(name: str, mask, cols
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The inputs of compact_u64 and compact_split, checked against their
    contract: a 1-D bool mask of n % TILE == 0 rows and int64/uint64
    columns of n rows beside it. Inputs that are not tensors go to the
    device of those that are, or to CUDA."""
    from ..device import resolve_device

    cols = tuple(cols)
    dev = next((x.device for x in (mask, *cols)
                if isinstance(x, torch.Tensor)), None) or resolve_device()
    mask, *cols = (x if isinstance(x, torch.Tensor)
                   else torch.as_tensor(x, device=dev) for x in (mask, *cols))
    if mask.dtype != torch.bool or mask.dim() != 1:
        raise TypeError(f"{name}: mask must be a 1-D bool tensor, got "
                        f"{mask.dtype} of shape {tuple(mask.shape)}")
    if mask.shape[0] % TILE:
        raise ValueError(f"{name}: {mask.shape[0]} rows; pad the rows to a "
                         f"multiple of {TILE}")
    for c in cols:
        if c.dtype not in (torch.int64, torch.uint64):
            raise TypeError(f"{name}: columns must be int64 or uint64 (f64 "
                            f"payloads as int64 bit views), got {c.dtype}")
        if c.dim() != 1 or c.shape[0] != mask.shape[0]:
            raise ValueError(f"{name}: column of shape {tuple(c.shape)} "
                             f"does not match the mask's {mask.shape[0]}")
        if c.device != mask.device:
            raise ValueError(f"{name}: column on {c.device}, mask on "
                             f"{mask.device}")
    return mask, tuple(cols)


def compact_u64_plain(mask: torch.Tensor, cols: Sequence[torch.Tensor]
                      ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """The function of compact_u64 in plain PyTorch: boolean-mask indexing
    of each column's int64 view into n + TILE slots (the tail is zero)."""
    mask, cols = u64_inputs("compact_u64", mask, cols)
    n = mask.shape[0]
    outs = []
    for c in cols:
        kept = c.view(torch.int64)[mask]
        out = torch.zeros(n + TILE, dtype=torch.int64, device=c.device)
        out[:kept.shape[0]] = kept
        outs.append(out.view(c.dtype))
    return tuple(outs), mask.sum(dtype=torch.int32)


def compact_u64(mask: torch.Tensor, cols: Sequence[torch.Tensor]
                ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Compact 64-bit columns by ``mask`` (see module docstring). Counts
    its kernel launches in ``compact_u64.launches``."""
    mask, cols = u64_inputs("compact_u64", mask, cols)
    if mask.device.type == "cpu":
        return compact_u64_plain(mask, cols)
    if mask.device.type != "cuda":
        raise TypeError(f"compact_u64: no kernel for device {mask.device}")
    n = mask.shape[0]
    dev = mask.device
    outs = tuple(torch.empty(n + TILE, dtype=c.dtype, device=dev)
                 for c in cols)
    if n == 0:   # an empty grid is an invalid launch
        return outs, torch.zeros((), dtype=torch.int32, device=dev)
    count = torch.empty((), dtype=torch.int32, device=dev)
    fn, tile_rows, max_cols = _kernel_u64()
    ntiles = -(-n // tile_rows)
    srcs = [c.contiguous() for c in cols]
    m = mask.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0 in range(0, max(len(cols), 1), max_cols):
        src, dst = srcs[c0:c0 + max_cols], outs[c0:c0 + max_cols]
        k = len(src)
        # the tile status words and the ticket: read before they are
        # written, so they start at zero
        status = torch.zeros(ntiles + 1, dtype=torch.int64, device=dev)
        src_ptrs = (ctypes.c_void_p * max(k, 1))(*[c.data_ptr() for c in src])
        dst_ptrs = (ctypes.c_void_p * max(k, 1))(*[o.data_ptr() for o in dst])
        err = fn(m.data_ptr(), n, src_ptrs, dst_ptrs, k, status.data_ptr(),
                 count.data_ptr(), stream)
        if err:
            raise RuntimeError(f"compact_u64 kernel launch failed: CUDA "
                               f"error {err}")
        compact_u64.launches += 1
    return outs, count


compact_u64.launches = 0
