"""IO (counterpart of arrow1_tpu/io): the Arrow IPC stream and file
formats and Feather V1/V2 (``ipc``, ``ipc_native``, ``feather1``, with
the port's own flatbuffers builder ``_flatbuf``), the C++ IPC reader and
writer (``ipc_cpp``), CSV and newline-delimited JSON over the native
parsers (``csv``, ``json``, ``_native_tbl``), Parquet and ORC
(``parquet``, ``parquet_native``, ``orc``, ``orc_native``,
``orc_writer``), host buffers and streams (``streams``), codecs
(``compression``) and readahead pipelining (``prefetch``: a background
thread that decodes and moves batches to the device while the caller
computes). Readers take ``device=`` (CUDA unless the caller names the
CPU).
"""

from .ipc import (read_feather, read_ipc, write_feather, write_ipc,  # noqa: F401
                  IpcStreamReader, IpcStreamWriter)
from .csv import read_csv, write_csv  # noqa: F401
from .orc import read_orc, write_orc  # noqa: F401
from .parquet import read_parquet, write_parquet  # noqa: F401
from .json import read_json  # noqa: F401
from .prefetch import ReadaheadIterator, MergedIterator, prefetch_batches  # noqa: F401
