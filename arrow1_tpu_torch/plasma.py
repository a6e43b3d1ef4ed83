"""A shared-memory object store for handing tables between processes
(counterpart of arrow1_tpu/plasma.py).

Reference: cpp/src/plasma/ (a store daemon and clients over unix sockets,
plasma/client.h:46, store.h:56). Here the store has no daemon
(native/src/shm_store.cpp): it is a named POSIX shared-memory segment
that any process opens. A table is stored as Arrow IPC stream bytes from
the port's own writer (``io.ipc_native``) and read back straight out of
the mapped segment by the port's reader, which puts the batches on
``device`` (CUDA unless the caller names the CPU) with one staging copy.
The segment outlives its processes until ``destroy``: give each user a
name of its own and destroy it in a ``finally``.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
from typing import List, Optional, Union

import numpy as np

from .errors import Invalid
from .native import load_library
from .table import RecordBatch, Table

__all__ = ["ObjectID", "PlasmaStore", "connect"]

ID_LEN = 20


class ObjectID:
    """A 20-byte object id (reference: plasma/common.h UniqueID<20>)."""

    __slots__ = ("binary",)

    def __init__(self, binary: bytes):
        if len(binary) != ID_LEN:
            raise Invalid(f"ObjectID must be {ID_LEN} bytes")
        self.binary = binary

    @classmethod
    def from_random(cls) -> "ObjectID":
        return cls(os.urandom(ID_LEN))

    @classmethod
    def of(cls, name: Union[str, bytes]) -> "ObjectID":
        if isinstance(name, str):
            name = name.encode()
        return cls(hashlib.sha1(name).digest())

    def __eq__(self, other):
        return isinstance(other, ObjectID) and other.binary == self.binary

    def __hash__(self):
        return hash(self.binary)

    def __repr__(self):
        return f"ObjectID({self.binary.hex()[:12]}...)"


class PlasmaStore:
    """Open the named store, or create it with ``create`` (``capacity``
    bytes, ``max_objects`` slots)."""

    def __init__(self, name: str = "/a1t-plasma",
                 capacity: int = 1 << 30, max_objects: int = 4096,
                 create: bool = True):
        self._lib = load_library()
        if self._lib is None:
            raise Invalid("the plasma store needs the native library: no "
                          "C++ compiler, or its build failed")
        self.name = name
        enc = name.encode()
        handle = self._lib.a1t_store_open(enc)
        if not handle and create:
            handle = self._lib.a1t_store_create(enc, capacity, max_objects)
        if not handle:
            raise Invalid(f"cannot open or create store {name!r}")
        self._handle = handle

    # ---- bytes ----
    def put_bytes(self, oid: ObjectID, data) -> None:
        src = np.frombuffer(data, dtype=np.uint8)
        ptr = self._lib.a1t_create(self._handle, oid.binary, src.nbytes)
        if not ptr:
            raise Invalid("store full or object exists")
        ctypes.memmove(ptr, src.ctypes.data, src.nbytes)
        self._lib.a1t_seal(self._handle, oid.binary)

    def get_buffer(self, oid: ObjectID) -> memoryview:
        """A view into the shared segment; it pins the object until
        ``release`` (plasma's Release)."""
        size = ctypes.c_uint64()
        ptr = self._lib.a1t_get(self._handle, oid.binary, ctypes.byref(size))
        if not ptr:
            raise KeyError(oid)
        return memoryview((ctypes.c_char * size.value).from_address(ptr)) \
            .cast("B")

    def release(self, oid: ObjectID) -> None:
        self._lib.a1t_release(self._handle, oid.binary)

    def delete(self, oid: ObjectID) -> None:
        self._lib.a1t_delete(self._handle, oid.binary)

    def contains(self, oid: ObjectID) -> bool:
        return bool(self._lib.a1t_contains(self._handle, oid.binary))

    def list(self) -> List[ObjectID]:
        buf = np.zeros(4096 * ID_LEN, dtype=np.uint8)
        n = self._lib.a1t_list(self._handle,
                               buf.ctypes.data_as(ctypes.c_void_p), 4096)
        return [ObjectID(bytes(buf[i * ID_LEN:(i + 1) * ID_LEN]))
                for i in range(n)]

    @property
    def bytes_used(self) -> int:
        return int(self._lib.a1t_store_bytes_used(self._handle))

    @property
    def evictions(self) -> int:
        return int(self._lib.a1t_store_evictions(self._handle))

    # ---- tables, as IPC streams ----
    def put(self, data: Union[RecordBatch, Table],
            oid: Optional[ObjectID] = None) -> ObjectID:
        """Store a batch or a table (its columns copied to the host once)
        under ``oid`` (a random one by default)."""
        from .io.ipc_native import write_stream

        oid = oid or ObjectID.from_random()
        sink = io.BytesIO()
        write_stream(sink, data.batches if isinstance(data, Table)
                     else [data])
        self.put_bytes(oid, sink.getbuffer())
        return oid

    def get(self, oid: ObjectID, device=None) -> Table:
        """The stored table on ``device``, read out of the segment."""
        from .io.ipc_native import read_stream

        buf = self.get_buffer(oid)
        try:
            return Table(read_stream(buf, device=device))
        finally:
            self.release(oid)

    def close(self):
        if self._handle:
            self._lib.a1t_store_close(self._handle)
            self._handle = None

    def destroy(self):
        """Close and unlink the segment."""
        self.close()
        self._lib.a1t_store_destroy(self.name.encode())

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def connect(name: str = "/a1t-plasma", **kwargs) -> PlasmaStore:
    """Reference: plasma::PlasmaClient::Connect."""
    return PlasmaStore(name, **kwargs)
