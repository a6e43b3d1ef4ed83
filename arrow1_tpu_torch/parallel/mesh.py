"""The process group as a one-axis mesh, and a batch's rows per rank
(counterpart of arrow1_tpu/parallel/mesh.py).

Each rank of a ``torch.distributed`` process group runs the same torch
program on its own device, where the JAX package shards arrays over a
``jax.sharding.Mesh`` of local devices. A batch is distributed by range:
rank r holds rows [r * R, (r + 1) * R) of the batch padded with null rows
to a multiple of the world size. Hash partitioning comes from the shuffle
(shuffle.py), not from ingest.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch

from ..column import Column
from ..errors import Invalid
from ..table import RecordBatch

__all__ = ["Mesh", "make_mesh", "shard_batch", "unshard_batch",
           "pad_to_multiple", "local_device", "all_gather_rows",
           "gather_varlen"]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One data axis over the ranks of a process group: ``shape[axis]`` is
    the world size, ``rank`` this process's place on it, ``device`` its
    device. ``group`` None is the default group."""

    group: object
    axis: str
    size: int
    rank: int
    device: torch.device

    @property
    def shape(self) -> dict:
        return {self.axis: self.size}


def local_device(device=None) -> torch.device:
    """This rank's device: ``cuda:<local rank>`` (``LOCAL_RANK``, as
    torchrun sets it, else the rank modulo the visible cards) unless the
    caller asks for the CPU."""
    from ..device import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    import torch.distributed as dist

    local = os.environ.get("LOCAL_RANK")
    if local is None:
        rank = dist.get_rank() if dist.is_initialized() else \
            int(os.environ.get("RANK", "0"))
        local = rank % torch.cuda.device_count()
    return torch.device("cuda", int(local))


def make_mesh(n_devices: Optional[int] = None, axis: str = "x",
              device=None) -> Mesh:
    """The default process group as a mesh of its world size. With no
    group yet, a one-rank group is made (``multihost.initialize``).
    ``n_devices``, when given, must be the world size: each rank runs one
    device."""
    import torch.distributed as dist

    from .multihost import initialize

    if not dist.is_initialized():
        initialize(device=device)
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise Invalid(f"make_mesh: {n_devices} devices asked of a process "
                      f"group of {size} ranks (one device a rank)")
    if device is None:
        device = "cpu" if dist.get_backend() == "gloo" else None
    return Mesh(None, axis, size, rank, local_device(device))


def _pad(x: Optional[torch.Tensor], pad: int, fill=0):
    if x is None:
        return None
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def pad_to_multiple(batch: RecordBatch, multiple: int) -> RecordBatch:
    """The batch with null rows appended up to a multiple of ``multiple``
    (their validity False; callers track the true row count)."""
    n = batch.num_rows
    pad = -n % multiple
    if pad == 0:
        return batch
    cols = tuple(
        Column(_pad(c.data, pad), c.dtype,
               validity=_pad(c.mask(), pad, False),
               dictionary=c.dictionary, data2=_pad(c.data2, pad))
        for c in batch.columns)
    return RecordBatch(cols, batch.names)


def _rows(x: Optional[torch.Tensor], lo: int, hi: int, dev):
    return None if x is None else x[lo:hi].to(dev)


def shard_batch(batch: RecordBatch, mesh: Mesh,
                axis: str = "x") -> RecordBatch:
    """This rank's rows of ``batch`` (every rank passes the same batch),
    padded to a multiple of the world size, on the rank's device."""
    padded = pad_to_multiple(batch, mesh.shape[axis])
    per = padded.num_rows // mesh.shape[axis]
    lo, hi = mesh.rank * per, (mesh.rank + 1) * per
    cols = tuple(
        Column(_rows(c.data, lo, hi, mesh.device), c.dtype,
               validity=_rows(c.validity, lo, hi, mesh.device),
               dictionary=c.dictionary,
               data2=_rows(c.data2, lo, hi, mesh.device))
        for c in padded.columns)
    return RecordBatch(cols, padded.names)


def all_gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's equal-length tensor, concatenated in rank order, on
    every rank (one ``all_gather_into_tensor``; bool travels as uint8)."""
    import torch.distributed as dist

    is_bool = x.dtype == torch.bool
    src = (x.to(torch.uint8) if is_bool else x).contiguous()
    out = src.new_empty((mesh.size * src.shape[0],) + tuple(src.shape[1:]))
    # all_gather_single is all_gather_into_tensor's newer name
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, src, group=mesh.group)
    return out.bool() if is_bool else out


def gather_varlen(x: torch.Tensor, sizes, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (``sizes[r]`` rows on rank r), concatenated in
    rank order on every rank: padded to the largest, one all_gather."""
    top = max(sizes)
    pad = x.new_zeros((top - x.shape[0],) + tuple(x.shape[1:]))
    full = all_gather_rows(torch.cat([x, pad]), mesh)
    return torch.cat([full[r * top:r * top + s]
                      for r, s in enumerate(sizes)])


def unshard_batch(batch: RecordBatch, mesh: Mesh) -> RecordBatch:
    """Every rank's shard of a sharded batch, gathered to every rank (the
    padding rows included, as the reference's ``device_get`` gives
    them)."""
    def pull(x):
        return None if x is None else all_gather_rows(x, mesh)

    cols = tuple(Column(pull(c.data), c.dtype, validity=pull(c.validity),
                        dictionary=c.dictionary, data2=pull(c.data2))
                 for c in batch.columns)
    return RecordBatch(cols, batch.names)
