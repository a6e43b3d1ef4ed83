"""Split compaction of 64-bit columns: within-tile positions, then
placement (counterpart of arrow1_tpu/kernels/compaction_split.py).

``compact_split(mask, cols) -> (outs, count)`` has the contract of
``compaction.compact_u64``: n % 1024 == 0, int64 or uint64 columns (f64
payloads as int64 bit views), outputs ``n + 1024`` long with the kept rows
in ``[0, count)``, ``count`` a 0-d int32 device tensor. On CUDA it runs
kernel A of ``csrc/compaction_split.cu`` (pos[j] = inclusive count - 1
within j's 1024-row tile), the per-tile bases in torch (the reference's
XLA glue; nothing syncs with the host), then kernel B (each kept row to
bases[tile] + pos). On the CPU it runs ``compact_split_plain``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from . import build
from .compaction import TILE, u64_inputs

__all__ = ["compact_split", "compact_split_plain", "positions", "place",
           "positions_plain", "tile_bases", "SOURCE", "TILE"]

SOURCE = "compaction_split.cu"


@functools.cache
def _kernels():
    lib = build.load(SOURCE)
    pos = lib.a1t_compaction_split_positions
    pos.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                    ctypes.c_void_p]
    pos.restype = ctypes.c_int
    place = lib.a1t_compaction_split_place
    place.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                      ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int64, ctypes.c_void_p]
    place.restype = ctypes.c_int
    for name in ("a1t_compaction_split_tile",
                 "a1t_compaction_split_max_cols"):
        getattr(lib, name).restype = ctypes.c_int64
    if lib.a1t_compaction_split_tile() != TILE:
        raise RuntimeError("compaction_split.cu's tile is not "
                           f"{TILE} rows")
    return pos, place, lib.a1t_compaction_split_max_cols()


def tile_bases(pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The glue between the kernels: each tile's exclusive output base
    (int32, one per tile, then the total) from the within-tile positions,
    and the count as a 0-d int32 tensor."""
    counts = pos[TILE - 1::TILE] + 1
    bases = torch.cat([torch.zeros(1, dtype=torch.int32, device=pos.device),
                       torch.cumsum(counts, 0, dtype=torch.int32)])
    return bases, bases[-1]


def positions_plain(mask: torch.Tensor) -> torch.Tensor:
    """Kernel A in plain PyTorch."""
    tiles = mask.view(-1, TILE).to(torch.int32)
    return (torch.cumsum(tiles, 1, dtype=torch.int32) - 1).reshape(-1)


def compact_split_plain(mask: torch.Tensor, cols: Sequence[torch.Tensor]
                        ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """The same function in plain PyTorch: positions, bases, then each
    kept row scattered to its base + position (the tail is zero)."""
    mask, cols = u64_inputs("compact_split", mask, cols)
    n = mask.shape[0]
    pos = positions_plain(mask)
    bases, count = tile_bases(pos)
    tile = torch.arange(n, device=mask.device) // TILE
    dest = (bases[:-1][tile] + pos).long()[mask]
    outs = []
    for c in cols:
        out = torch.zeros(n + TILE, dtype=torch.int64, device=c.device)
        out[dest] = c.view(torch.int64)[mask]
        outs.append(out.view(c.dtype))
    return tuple(outs), count


def positions(mask: torch.Tensor) -> torch.Tensor:
    """Kernel A on a CUDA mask of n % TILE == 0 rows: int32 pos[n]."""
    n = mask.shape[0]
    pos = torch.empty(n, dtype=torch.int32, device=mask.device)
    err = _kernels()[0](mask.contiguous().data_ptr(), n, pos.data_ptr(),
                        torch.cuda.current_stream(mask.device).cuda_stream)
    if err:
        raise RuntimeError(f"compact_split positions kernel launch failed: "
                           f"CUDA error {err}")
    compact_split.launches += 1
    return pos


def place(mask: torch.Tensor, pos: torch.Tensor, bases: torch.Tensor,
          cols: Sequence[torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """Kernel B on CUDA tensors: every column's kept rows at their base +
    position, in outputs of n + TILE slots; one launch per max_cols
    columns."""
    n = mask.shape[0]
    dev = mask.device
    _, place_fn, max_cols = _kernels()
    outs = tuple(torch.empty(n + TILE, dtype=c.dtype, device=dev)
                 for c in cols)
    srcs = [c.contiguous() for c in cols]
    m = mask.contiguous()
    stream = torch.cuda.current_stream(dev).cuda_stream
    for c0 in range(0, len(srcs), max_cols):
        src, dst = srcs[c0:c0 + max_cols], outs[c0:c0 + max_cols]
        k = len(src)
        src_ptrs = (ctypes.c_void_p * k)(*[c.data_ptr() for c in src])
        dst_ptrs = (ctypes.c_void_p * k)(*[o.data_ptr() for o in dst])
        err = place_fn(m.data_ptr(), n, pos.data_ptr(), bases.data_ptr(),
                       src_ptrs, dst_ptrs, k, stream)
        if err:
            raise RuntimeError(f"compact_split place kernel launch failed: "
                               f"CUDA error {err}")
        compact_split.launches += 1
    return outs


def compact_split(mask: torch.Tensor, cols: Sequence[torch.Tensor]
                  ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Compact 64-bit columns by ``mask`` (see module docstring). Counts
    its launches in ``compact_split.launches`` (kernel A and kernel B
    each count one)."""
    mask, cols = u64_inputs("compact_split", mask, cols)
    if mask.device.type == "cpu":
        return compact_split_plain(mask, cols)
    if mask.device.type != "cuda":
        raise TypeError(f"compact_split: no kernel for device {mask.device}")
    if mask.shape[0] == 0:   # an empty grid is an invalid launch
        return (tuple(torch.empty(TILE, dtype=c.dtype, device=mask.device)
                      for c in cols),
                torch.zeros((), dtype=torch.int32, device=mask.device))
    pos = positions(mask)
    bases, count = tile_bases(pos)
    return place(mask, pos, bases, cols), count


compact_split.launches = 0
