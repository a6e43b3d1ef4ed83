"""A pool of gloo ranks for the port's distributed tests.

``start(module, world)`` spawns ``world`` processes; each joins one gloo
process group through ``multihost.initialize`` (a free localhost port,
from its arguments or from the environment variables torchrun sets),
imports the test module ``module`` and calls its ``rank_cases(mesh)``,
which returns a dict of case -> result (an exception comes back as
``("raises", class name, message)``), and sends it back pickled.
``results(module)`` waits for every rank's dict. A test file that sets
``RANKS`` has its pool started with the answer workers
(``start_imported``, from ``test_torch_answers.start``); its module
fixture starts it if it has not started, waits for the JAX package's
answers, then collects the ranks. The test module must import neither
jax nor the JAX package at module level, so that a rank starts in about
two seconds. This file holds no tests.
"""

import multiprocessing
import socket
import time

TIMEOUT_S = 120.0   # a rank that has not answered by then has hung
MIN_WAIT_S = 30.0   # the least wait of a pool collected late
_pools = {}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def outcome(fn):
    """fn()'s value, or the exception it raised as a triple."""
    try:
        return fn()
    except Exception as e:   # noqa: BLE001 (the raise is the answer)
        return ("raises", type(e).__name__, str(e))


def _rank(module: str, rank: int, world: int, port: int, from_env: bool,
          queue) -> None:
    import importlib
    import os

    from arrow1_tpu_torch.parallel import make_mesh, multihost

    try:
        if from_env:   # as torchrun gives them
            os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                              MASTER_ADDR="localhost", MASTER_PORT=str(port))
            multihost.initialize(device="cpu", timeout=60)
        else:
            multihost.initialize(f"localhost:{port}", world, rank,
                                 device="cpu", timeout=60)
        try:
            out = importlib.import_module(module).rank_cases(
                make_mesh(world))
        finally:
            multihost.shutdown()
        queue.put((rank, out))
    except BaseException as e:   # noqa: BLE001 (reported to the parent)
        queue.put((rank, ("rank failed", repr(e))))


def start_imported() -> None:
    """Start the pool of every imported test module that names its ranks
    (``RANKS = dict(world=..., from_env=...)``): the first port test's
    fixture calls this, so the ranks run while the files before theirs
    do."""
    import sys

    for name, module in list(sys.modules.items()):
        ranks = getattr(module, "RANKS", None)
        if name.startswith("test_torch_") and isinstance(ranks, dict):
            start(name, **ranks)


def start(module: str, world: int = 4, from_env: bool = False) -> None:
    """Spawn the ranks of ``module``; with ``from_env`` each rank joins
    the group from ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` alone."""
    if module in _pools:
        return
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(module, r, world, port, from_env,
                                               queue),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    _pools[module] = (procs, queue, time.monotonic())


def results(module: str) -> list:
    """Every rank's result dict, in rank order."""
    procs, queue, t0 = _pools.pop(module)
    got = {}
    try:
        while len(got) < len(procs):
            rank, out = queue.get(timeout=max(
                MIN_WAIT_S, TIMEOUT_S - (time.monotonic() - t0)))
            if isinstance(out, tuple) and out[0] == "rank failed":
                raise RuntimeError(f"rank {rank} failed: {out[1]}")
            got[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.terminate()
    return [got[r] for r in range(len(procs))]
