"""The port's multi-rank helpers (``arrow1_tpu_torch.parallel.multihost``)
on four gloo ranks that join their group from the environment variables
torchrun sets (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT).

Each rank ingests its own rows, of unequal counts and with string pools
that differ between ranks, and ``global_batch_from_local`` must give every
rank the concatenation of all ranks' rows, as pyarrow concatenates them.
``local_row_range`` must equal the JAX package's range for each rank and
cover the rows once; ``broadcast_from_host0``, ``allgather_to_hosts`` and
``barrier`` run across the ranks; a one-rank group needs no port.
"""

import numpy as np
import pyarrow as pa
import pytest

import test_torch_ranks

WORLD = 4
RANKS = dict(world=WORLD, from_env=True)   # test_torch_ranks.start_imported
TOTAL = 101


def local_rows(rank):
    """Rank ``rank``'s own rows: rank + 2 of them, strings from a pool of
    its own (one shared value, one null)."""
    n = rank + 2
    s = [f"r{rank}v{i % 3}" if i else "shared" for i in range(n)]
    s[-1] = None
    return pa.record_batch({
        "s": pa.array(s),
        "x": pa.array(np.arange(n, dtype=np.int64) + 100 * rank),
        "f": pa.array(np.linspace(0.0, 1.0, n) + rank,
                      mask=np.arange(n) % 2 == 1)})


def rank_cases(mesh):
    import torch

    import arrow1_tpu_torch as pt
    from arrow1_tpu_torch.parallel import multihost

    out = {"info": multihost.process_info(),
           "rows": list(multihost.local_row_range(TOTAL))}
    local = pt.interop.record_batch_from_arrow(local_rows(mesh.rank),
                                               device="cpu")
    g = multihost.global_batch_from_local(local, mesh)
    out["global"] = g.to_arrow().to_pylist()
    out["pool"] = list(g.column("s").dictionary.values)
    multihost.barrier()
    out["broadcast"] = multihost.broadcast_from_host0(
        {"t": np.array([7, 8]) if mesh.rank == 0 else np.array([0])})
    out["allgather"] = multihost.allgather_to_hosts(
        torch.arange(mesh.rank + 1) + 10 * mesh.rank).tolist()
    out["allgather_np"] = multihost.allgather_to_hosts(
        np.full(2, mesh.rank)).tolist()
    return out


@pytest.fixture(scope="module")
def ranks():
    test_torch_ranks.start(__name__, **RANKS)
    return test_torch_ranks.results(__name__)


def _reference_row_range(rank):
    """The JAX package's local_row_range for ``rank`` of WORLD processes."""
    import arrow1_tpu.parallel.multihost as mh

    idx, cnt = mh.jax.process_index, mh.jax.process_count
    try:
        mh.jax.process_index = lambda: rank
        mh.jax.process_count = lambda: WORLD
        return list(mh.local_row_range(TOTAL))
    finally:
        mh.jax.process_index, mh.jax.process_count = idx, cnt


def test_initialize_from_the_environment(ranks):
    for r, out in enumerate(ranks):
        assert out["info"] == {"process_index": r, "process_count": WORLD,
                               "local_devices": 1, "global_devices": WORLD}


def test_local_row_range_is_the_reference_and_covers_the_rows(ranks):
    seen = []
    for r, out in enumerate(ranks):
        assert out["rows"] == _reference_row_range(r)
        seen += out["rows"]
    assert seen == list(range(TOTAL))


def test_global_batch_from_local_unifies_the_pools(ranks):
    want = pa.Table.from_batches(
        [local_rows(r) for r in range(WORLD)]).to_pylist()
    pool = list(dict.fromkeys(
        v for r in range(WORLD) for v in local_rows(r).column("s").to_pylist()
        if v is not None))
    for out in ranks:
        assert out["global"] == want
        assert out["pool"] == pool


def test_broadcast_allgather_and_barrier(ranks):
    for out in ranks:
        assert out["broadcast"]["t"].tolist() == [7, 8]
        assert out["allgather"] == [0, 10, 11, 20, 21, 22, 30, 31, 32, 33]
        assert out["allgather_np"] == [0, 0, 1, 1, 2, 2, 3, 3]


def test_one_rank_group_needs_no_port():
    from arrow1_tpu_torch.parallel import multihost

    multihost.initialize(device="cpu")
    try:
        assert multihost.process_info()["process_count"] == 1
        assert list(multihost.local_row_range(5)) == [0, 1, 2, 3, 4]
        mesh = multihost.global_mesh(device="cpu")
        local = __import__("arrow1_tpu_torch").interop \
            .record_batch_from_arrow(local_rows(2), device="cpu")
        g = multihost.global_batch_from_local(local, mesh)
        assert g.to_arrow().to_pylist() == local_rows(2).to_pylist()
    finally:
        multihost.shutdown()
