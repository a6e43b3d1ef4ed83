"""IO (counterpart of arrow1_tpu/io): the Arrow IPC stream and file
formats and Feather V1/V2 (``ipc``, ``ipc_native``, ``feather1``, with
the port's own flatbuffers builder ``_flatbuf``), host buffers and
streams (``streams``), codecs (``compression``) and readahead pipelining
(``prefetch``: a background thread that decodes and moves batches to the
device while the caller computes). CSV, JSON, Parquet and ORC are later
slices of the port.
"""

from .ipc import (read_feather, read_ipc, write_feather, write_ipc,  # noqa: F401
                  IpcStreamReader, IpcStreamWriter)
from .prefetch import ReadaheadIterator, MergedIterator, prefetch_batches  # noqa: F401
