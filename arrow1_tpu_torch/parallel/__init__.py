"""Distribution layer: the process group as a mesh, the hash-partitioned
shuffle and the distributed operators (counterpart of
arrow1_tpu/parallel).

Each rank of a ``torch.distributed`` process group runs the same torch
program on its own device; repartitioning is ``all_to_all_single`` (NCCL
on the card, gloo on the CPU), and the operators compose the padded
device primitives of ops/padded.py. Importing the package initializes no
process group.
"""

from .mesh import make_mesh, shard_batch, unshard_batch  # noqa: F401
from .distributed import (dist_filter, dist_filter_padded,  # noqa: F401
                          dist_group_by, dist_join, dist_sort_indices)
