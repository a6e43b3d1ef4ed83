"""Process-group bring-up and multi-rank helpers (counterpart of
arrow1_tpu/parallel/multihost.py).

One process a device: torchrun (or the caller) gives every process its
``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, and

    initialize()          # once per process: NCCL on a card, gloo on the CPU
    mesh = global_mesh()  # every rank, axis "x"

Each rank may ingest its own rows (``local_row_range``) and assemble the
global batch with ``global_batch_from_local``; the distributed operators
then take that batch on every rank. With nothing set, ``initialize``
makes a one-rank group over an in-process ``HashStore``, so a single
process needs no port.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..column import Column, Dictionary
from ..table import RecordBatch

__all__ = ["initialize", "global_mesh", "process_info",
           "local_row_range", "global_batch_from_local", "barrier",
           "broadcast_from_host0", "allgather_to_hosts", "shutdown"]


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None,
               timeout: Optional[float] = None) -> None:
    """``torch.distributed.init_process_group`` from the arguments or the
    environment (``MASTER_ADDR``:``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); a one-rank group over a ``HashStore`` when neither names a
    coordinator. The backend is NCCL for a CUDA device (the default) and
    gloo only for a device asked as ``cpu``; NCCL never falls back to
    gloo. ``timeout`` (seconds) bounds every collective's wait. A no-op
    when a group exists."""
    import torch.distributed as dist

    from .mesh import local_device

    if dist.is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = \
            f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = num_processes if num_processes is not None else \
        int(env.get("WORLD_SIZE", "1"))
    rank = process_id if process_id is not None else \
        int(env.get("RANK", "0"))
    if coordinator_address is None:
        world, rank = 1, 0
    dev = local_device(device)
    kwargs = {}
    if timeout is not None:
        import datetime

        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    if dev.type == "cuda":
        backend = "nccl"
        torch.cuda.set_device(dev)
        kwargs["device_id"] = dev
    else:
        backend = "gloo"
    if coordinator_address is None:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, **kwargs)
    else:
        dist.init_process_group(backend,
                                init_method=f"tcp://{coordinator_address}",
                                world_size=world, rank=rank, **kwargs)


def shutdown() -> None:
    """Destroy the process group (a group left behind holds the next)."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def global_mesh(axis: str = "x", device=None):
    """One data axis over every rank of the default group."""
    from .mesh import make_mesh

    return make_mesh(axis=axis, device=device)


def process_info() -> dict:
    import torch.distributed as dist

    n = dist.get_world_size() if dist.is_initialized() else 1
    return {"process_index": dist.get_rank() if dist.is_initialized()
            else 0, "process_count": n, "local_devices": 1,
            "global_devices": n}


def local_row_range(total_rows: int) -> range:
    """The rows this rank ingests of an evenly split table (range
    partitioning by rank; hash affinity comes from the shuffle)."""
    info = process_info()
    p, n = info["process_index"], info["process_count"]
    per = (total_rows + n - 1) // n
    start = min(p * per, total_rows)
    return range(start, min(start + per, total_rows))


def global_batch_from_local(batch: RecordBatch, mesh,
                            axis: str = "x") -> RecordBatch:
    """The global batch, on every rank, from each rank's own rows (rank
    order). String pools differ between ranks: they are gathered
    (``all_gather_object``), unified in rank order, and each rank's codes
    remapped before the rows are gathered. Row counts may differ."""
    import torch.distributed as dist

    from .mesh import gather_varlen

    sizes = [None] * mesh.size
    dist.all_gather_object(sizes, batch.num_rows, group=mesh.group)
    cols = []
    for c in batch.columns:
        data = c.data.to(mesh.device)
        dictionary = c.dictionary
        if dictionary is not None:
            pools = [None] * mesh.size
            dist.all_gather_object(pools, list(dictionary.values),
                                   group=mesh.group)
            index, values, remap = {}, [], None
            for r, pool in enumerate(pools):
                codes = [index.setdefault(v, len(index)) for v in pool]
                if r == mesh.rank:
                    remap = codes
            values = list(index)
            dictionary = Dictionary(np.array(values, dtype=object))
            if remap:
                table = torch.tensor(remap, dtype=data.dtype,
                                     device=data.device)
                codes = data.long()
                if c.validity is not None:
                    codes = torch.where(c.validity.to(data.device), codes, 0)
                data = table[codes]
        validity = c.mask().to(mesh.device)
        data2 = None if c.data2 is None else c.data2.to(mesh.device)
        v = gather_varlen(validity, sizes, mesh)
        cols.append(Column(
            gather_varlen(data, sizes, mesh), c.dtype,
            validity=None if bool(v.all()) else v, dictionary=dictionary,
            data2=None if data2 is None else
            gather_varlen(data2, sizes, mesh)))
    return RecordBatch(tuple(cols), batch.names)


def barrier(name: str = "arrow1_tpu_barrier") -> None:
    """Block until every rank reaches this point."""
    import torch.distributed as dist

    dist.barrier()


def broadcast_from_host0(tree):
    """Rank 0's Python value (numpy arrays, dicts, a small build table's
    buffers) on every rank."""
    import torch.distributed as dist

    box = [tree]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def allgather_to_hosts(tree):
    """Every rank's tensor or numpy array concatenated along rows in rank
    order, on every rank (result egress; the inverse of splitting a
    batch by ``local_row_range``)."""
    import torch.distributed as dist

    if isinstance(tree, torch.Tensor):
        from .mesh import make_mesh

        from .mesh import gather_varlen

        mesh = make_mesh(device=tree.device.type if
                         tree.device.type == "cpu" else None)
        sizes = [None] * mesh.size
        dist.all_gather_object(sizes, int(tree.shape[0]))
        return gather_varlen(tree.to(mesh.device), sizes, mesh)
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, tree)
    if isinstance(tree, dict):
        return {k: np.concatenate([np.asarray(p[k]) for p in parts])
                for k in tree}
    return np.concatenate([np.asarray(p) for p in parts])
