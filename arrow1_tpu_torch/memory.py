"""Memory pool surface: allocation tracking + logging/proxy pools
(counterpart of arrow1_tpu/memory.py).

Reference: cpp/src/arrow/memory_pool.h — MemoryPool (bytes_allocated /
max_memory), LoggingMemoryPool (:114), ProxyMemoryPool (:138), pluggable
default via ARROW_DEFAULT_MEMORY_POOL (memory_pool.cc:103).

DEVICE memory belongs to PyTorch's CUDA caching allocator
(``runtime.device_memory_stats`` reads its counters,
``total_allocated_bytes()`` its bytes in use). What this module owns is
the HOST plane: pools that host-side code accounts its buffers to, so
the reference's observability surface (track, log, proxy) exists on the
host side too.
"""

from __future__ import annotations

import os
import threading
from typing import Optional

from .errors import Invalid

__all__ = ["MemoryPool", "LoggingMemoryPool", "ProxyMemoryPool",
           "default_memory_pool", "set_memory_pool",
           "host_allocated_bytes"]


class MemoryPool:
    """Counting pool: the host-plane analogue of memory_pool.h's
    MemoryPool stats (bytes_allocated / max_memory / num_allocations)."""

    def __init__(self, name: str = "system"):
        self.name = name
        self._lock = threading.Lock()
        self._allocated = 0
        self._max = 0
        self._nallocs = 0

    # -- accounting hooks (called by engine host-allocation sites) --
    def allocate(self, nbytes: int) -> None:
        with self._lock:
            self._allocated += nbytes
            self._max = max(self._max, self._allocated)
            self._nallocs += 1

    def free(self, nbytes: int) -> None:
        with self._lock:
            self._allocated -= nbytes

    # -- stats (reference names) --
    @property
    def bytes_allocated(self) -> int:
        return self._allocated

    @property
    def max_memory(self) -> int:
        return self._max

    @property
    def num_allocations(self) -> int:
        return self._nallocs

    def release_unused(self) -> None:
        """malloc_trim analogue — a no-op for Python host buffers."""

    def __repr__(self):
        return (f"MemoryPool({self.name!r}, allocated="
                f"{self.bytes_allocated}, max={self.max_memory})")


class LoggingMemoryPool(MemoryPool):
    """memory_pool.h:114 — print every allocation (debugging aid)."""

    def __init__(self, wrapped: MemoryPool, sink=None):
        super().__init__(f"logging({wrapped.name})")
        self._wrapped = wrapped
        import sys

        self._sink = sink or sys.stderr

    def allocate(self, nbytes: int) -> None:
        self._sink.write(f"Allocate: size = {nbytes}\n")
        self._wrapped.allocate(nbytes)
        super().allocate(nbytes)

    def free(self, nbytes: int) -> None:
        self._sink.write(f"Free: size = {nbytes}\n")
        self._wrapped.free(nbytes)
        super().free(nbytes)


class ProxyMemoryPool(MemoryPool):
    """memory_pool.h:138 — independent stats over a shared backing pool
    (per-subsystem accounting)."""

    def __init__(self, wrapped: MemoryPool):
        super().__init__(f"proxy({wrapped.name})")
        self._wrapped = wrapped

    def allocate(self, nbytes: int) -> None:
        self._wrapped.allocate(nbytes)
        super().allocate(nbytes)

    def free(self, nbytes: int) -> None:
        self._wrapped.free(nbytes)
        super().free(nbytes)


_default: Optional[MemoryPool] = None
_default_lock = threading.Lock()


def default_memory_pool() -> MemoryPool:
    """Process default (A1T_DEFAULT_MEMORY_POOL=system|logging mirrors
    the reference's ARROW_DEFAULT_MEMORY_POOL env selection)."""
    global _default
    with _default_lock:
        if _default is None:
            pool = MemoryPool("system")
            kind = os.environ.get("A1T_DEFAULT_MEMORY_POOL", "system")
            if kind == "logging":
                pool = LoggingMemoryPool(pool)
            elif kind != "system":
                raise Invalid(f"unknown memory pool {kind!r}")
            _default = pool
        return _default


def set_memory_pool(pool: MemoryPool) -> None:
    global _default
    with _default_lock:
        _default = pool


def host_allocated_bytes() -> int:
    return default_memory_pool().bytes_allocated
