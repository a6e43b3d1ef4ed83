"""Hash-partitioned shuffle across the ranks: the engine's exchange
operator (counterpart of arrow1_tpu/parallel/shuffle.py).

Every rank buckets its live rows by destination into ``[D, capacity]``
slots and one ``all_to_all_single`` per array swaps the buckets (NCCL on
the card, gloo on the CPU); the data stays on the device. The buckets
have a static capacity so that every split is equal; rows past it are
counted in an overflow flag, all-reduced so that every rank raises
together. Skewed keys are split across destinations by the salted join
(distributed.dist_join).
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import torch

__all__ = ["partition_ids", "shuffle_shard", "any_rank", "FNV_MIX",
           "SALT_MIX", "EXCHANGED"]


def _signed(u: int) -> int:
    """An unsigned 64-bit constant as its int64 bit pattern."""
    return u - (1 << 64) if u >= 1 << 63 else u


# golden-ratio multiplicative mixing, the reference's constants as int64
# bit patterns: int64 multiplies wrap as uint64 ones do
FNV_MIX = _signed(0x9E3779B97F4A7C15)
SALT_MIX = _signed(0xD1B54A32D192ED03)
_LOW31 = (1 << 31) - 1

# bytes and calls of all_to_all_single, for measurement (reset by callers)
EXCHANGED = collections.Counter()


def partition_ids(key_u64: torch.Tensor, n_parts: int,
                  salt: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Destination per row of a normalized unsigned 64-bit key (an int64
    bit pattern): the high 31 bits of the golden-ratio mix, modulo the
    partition count, bit for bit the reference's. ``salt`` spreads hot
    keys. torch's int64 shift is arithmetic, so the logical ``>> 33``
    masks the sign's copies off."""
    h = key_u64.to(torch.int64) * FNV_MIX
    if salt is not None:
        h = h + salt.to(torch.int64) * SALT_MIX
    return (((h >> 33) & _LOW31) % n_parts).to(torch.int32)


def any_rank(flag: torch.Tensor, mesh) -> torch.Tensor:
    """A bool scalar ORed over the ranks (all-reduced on the device)."""
    import torch.distributed as dist

    x = flag.reshape(1).to(torch.int32)
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.group)
    return x[0] > 0


def _exchange(x: torch.Tensor, mesh) -> torch.Tensor:
    """One ``all_to_all_single`` of ``[D * capacity, ...]`` rows in equal
    splits (bool travels as uint8)."""
    import torch.distributed as dist

    is_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if is_bool else x).contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=mesh.group)
    EXCHANGED["bytes"] += src.numel() * src.element_size()
    EXCHANGED["calls"] += 1
    return out.bool() if is_bool else out


def shuffle_shard(arrays: Dict[str, torch.Tensor], part: torch.Tensor,
                  row_valid: torch.Tensor, mesh, capacity: int):
    """Exchange this rank's rows by destination.

    arrays: name -> local tensor [R, ...]; part: int32[R] destination rank
    per row; row_valid: bool[R] live rows (padding rows are never sent);
    capacity: static slots per (source, destination) pair.

    Returns (name -> [D * capacity, ...] received rows, bool[D * capacity]
    live slots, overflow bool scalar ORed over every rank). Rows keep
    their order within each (source, destination) bucket: one stable sort
    by destination, no host read."""
    D = mesh.size
    R = part.shape[0]
    dev = part.device
    dest = torch.where(row_valid, part.to(torch.int64), D)   # dead: past all
    order = torch.sort(dest, stable=True).indices
    ds = dest[order]
    counts = torch.zeros(D + 1, dtype=torch.int64, device=dev)
    counts.scatter_add_(0, dest, torch.ones_like(dest))
    starts = torch.cumsum(counts, 0) - counts
    within = torch.arange(R, device=dev) - starts[ds]
    keep = (ds < D) & (within < capacity)
    slot = torch.where(keep, ds * capacity + within, D * capacity)
    send_rows = torch.zeros(D * capacity + 1, dtype=torch.int64, device=dev)
    send_rows.scatter_(0, slot, order)
    send_live = torch.zeros(D * capacity + 1, dtype=torch.bool, device=dev)
    send_live.scatter_(0, slot, keep)
    send_rows, send_live = send_rows[:-1], send_live[:-1]
    overflow = any_rank((counts[:D] > capacity).any(), mesh)
    def bucketed(arr):
        if R == 0:
            return arr.new_zeros((D * capacity,) + tuple(arr.shape[1:]))
        return arr[send_rows]

    out = {name: _exchange(bucketed(arr), mesh)
           for name, arr in arrays.items()}
    return out, _exchange(send_live, mesh), overflow
