"""The JAX package's answers for the port's test files, computed in worker
processes while other tests run.

The JAX package compiles every operation on first use and shape, so a
file's answers cost seconds of compiling, most of it under the interpreter
lock. Each file of ``MODULES`` defines ``reference_answers()`` (no
arguments, the answers as a dict) and takes them in its module fixture
with ``answers_of(__name__)``; a file whose answers take long may split
them into parts (``reference_answers(part)``, listed as ``module:part``),
which run in workers of their own. The first fixture that asks (the first
port test file's, ``test_torch_bridges``, calls ``start`` itself)
starts a pool of spawned processes that computes the answers of every
file of ``MODULES`` this test run has imported, in ``MODULES`` order,
while the tests run; each file then waits only for its own. A worker imports the
test module to compute; the results come back pickled (the JAX package's
dictionary pools, which hold a lock, pickle as their values). Without a
pool, or if a worker fails, a file's answers are computed in the test
process, as before. The waits share one deadline for the whole run
(``DEADLINE_S`` from the pool's start): past it the workers are stopped
and every file left computes its answers in the test process, so a
stalled worker costs the run minutes once, not a wait per file. An idle
worker exits with the test process. This file holds no tests.
"""

import copyreg
import importlib
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor, TimeoutError

_jax_column = importlib.import_module("arrow1_tpu.column")
copyreg.pickle(_jax_column.Dictionary,
               lambda d: (_jax_column.Dictionary, (d.values,)))

# the files whose answers the workers compute, in the order they start:
# run order (the datasets' first: their file runs early and waits), but the distributed pipeline's first (the file after
# decimal, and its answers compile a program a case), the sweep's (about
# 30 s of one core, for a file that runs late) right after the decimal
# parts and the distributed operators' before nested's, so that no file
# waits long
MODULES = ("test_torch_dataset:0", "test_torch_dataset:1",
           "test_torch_dist_compiled:0", "test_torch_dist_compiled:1",
           "test_torch_decimal:0", "test_torch_decimal:1",
           "test_torch_decimal:2", "test_torch_registry_sweep",
           "test_torch_fused", "test_torch_groupby", "test_torch_hashtable",
           "test_torch_parallel:0", "test_torch_parallel:1",
           "test_torch_join", "test_torch_nested:0", "test_torch_nested:1",
           "test_torch_nested:2", "test_torch_pipeline",
           "test_torch_port_faults", "test_torch_query",
           "test_torch_strings", "test_torch_tail", "test_torch_temporal")
# workers beside the test process, leaving it and one more core free:
# the answers of all files take about five minutes of one core
WORKERS = max(1, min(6, (os.cpu_count() or 3) - 2))
# one deadline for the whole run, counted from the pool's start: past it
# no file waits for a worker (a stalled one is stopped), and the files
# left compute their answers in the test process
DEADLINE_S = 240.0
_futures = {}
_pool = {}


def _answers(key: str) -> dict:
    """A key's answers: a module's, or of ``module:part`` the part's
    (``reference_answers(part)``)."""
    name, _, part = key.partition(":")
    module = importlib.import_module(name)
    return module.reference_answers(int(part)) if part else \
        module.reference_answers()


def _keys(module_name: str):
    return [k for k in MODULES if k.partition(":")[0] == module_name]


def start() -> None:
    """Start computing, in worker processes, the answers of every file of
    MODULES that this test run imported (once), and the gloo rank pools
    of the distributed files (``test_torch_ranks.start_imported``)."""
    if _futures or multiprocessing.parent_process() is not None:
        return
    import test_torch_ranks

    test_torch_ranks.start_imported()
    names = [m for m in MODULES if m.partition(":")[0] in sys.modules]
    try:
        pool = ProcessPoolExecutor(
            WORKERS, mp_context=multiprocessing.get_context("spawn"))
        for name in names:
            _futures[name] = pool.submit(_answers, name)
        _pool["pool"] = pool
        _pool["deadline"] = time.monotonic() + DEADLINE_S
    except Exception:   # noqa: BLE001 (no worker: answers_of computes here)
        _futures.clear()


def _stop_workers() -> None:
    """Past the deadline: drop the queued work and stop the workers, so
    that none holds the test process at its exit."""
    pool = _pool.pop("pool", None)
    if pool is None:
        return
    for future in _futures.values():
        future.cancel()
    for proc in list(getattr(pool, "_processes", {}).values()):
        proc.terminate()
    pool.shutdown(wait=False, cancel_futures=True)


def answers_of(module_name: str) -> dict:
    """``module_name``'s answers (all its parts') from the workers where
    they come before the run's deadline, or computed here."""
    start()
    out = {}
    for key in _keys(module_name) or [module_name]:
        out.update(_answer(key))
    return out


def _answer(key: str) -> dict:
    future = _futures.get(key)
    if future is not None and "pool" in _pool:
        try:
            return future.result(
                timeout=max(0.0, _pool["deadline"] - time.monotonic()))
        except TimeoutError:
            _stop_workers()
        except Exception:   # noqa: BLE001 (computed here instead)
            pass
    return _answers(key)
