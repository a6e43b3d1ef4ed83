"""arrow1_tpu_torch: the PyTorch/CUDA port of arrow1_tpu for NVIDIA Hopper.

A columnar query engine over RecordBatches of fixed-width tensors. Every
entry point runs on CUDA unless the caller passes ``device="cpu"``; the
CUDA kernels (``csrc/``) build with nvcc at first use. This slice holds
the data model, expressions over numeric and bool columns, filter and
take, the compiled filter -> project -> group_by -> sort -> limit
pipeline (with ``join``), the fused filter+project flagship, the eager
``group_by`` (K3 for dense integer keys), the eager hash ``join`` (all
eight types) and ``join_asof``, the small sorted-build probe
``broadcast_probe`` (K4), the hash-aggregate, scalar-aggregate and sort
registry functions, the numeric compute tail (validity, selection,
numeric cast, the sort tail, element-wise min/max, power/abs/sign,
bitwise, math, cumulative, conditional, set lookup, run ends, random),
the strings, the temporal and interval types with the 42 temporal
functions (a time zone's offsets looked up on the column's device) and
``tdigest``, the decimals, the nested types (list, large_list,
fixed_size_list, map, struct, sparse and dense union columns, the list,
struct and map functions, the split family, ``binary_join`` and the
grouped lists, distinct values, quantiles and pivots), a
pyarrow.compute-shaped facade (``compute``), and
the query layer: ``Table`` (a sequence of batches), the streaming
``ExecPlan`` (``exec``), pyarrow.acero-shaped ``Declaration``s
(``acero``), ``query()`` and the TPC-H and BASELINE templates
(``models``). ``kernels.compaction.compact_u64``,
``kernels.compaction_split.compact_split`` and ``kernels.probes`` hold
the kernels of the JAX package's remaining Pallas entry points. The host
plane: ``native`` (the C++ runtime in ``native/src``, built with g++ at
first use), ``runtime``, ``memory``, ``thread_pool``, ``cancel``,
``types``, ``profiler``, and the Arrow IPC stream/file and Feather
formats (``io``, ``ipc``, ``feather``) with their streams, codecs and
readahead; CSV, JSON, Parquet and ORC (``io`` and the pyarrow-named
facades ``csv``, ``json``, ``parquet`` and ``orc``), whose readers put
their columns on CUDA unless the caller names the CPU; datasets over
local, S3 and WebHDFS file systems (``dataset``, ``fs``, ``fs_s3``,
``fs_hdfs``); and the bridges: the C data interface (``cdata``,
``cabi``), ``builders``, ``validate``, sparse and dense ``tensor``s,
Gandiva's projector and filter (``gandiva``), the shared-memory store
(``plasma``) and ``testing``.
"""

__version__ = "0.1.0"

from . import acero, dtypes, errors
from .column import (Column, Dictionary, ListColumn, StructColumn,
                     UnionColumn, fixed_size_list_column)
from .datum import Scalar, scalar
from .dtypes import (DataType, binary, bool_, date32, date64, decimal128,
                     decimal256, dense_union, duration, fixed_size_list,
                     float16, float32, float64, int8, int16, int32, int64,
                     large_binary, large_list, large_string, list_, map_,
                     month_day_nano_interval, null, sparse_union, string,
                     struct, time32, time64, timestamp, uint8, uint16,
                     uint32, uint64)
from .device import resolve_device
from .exec.compiled import CompiledPipeline, PipelineBuilder
from .expr import Expression, call, field, literal
from .interop import from_reference_arrays
from .kernels.fused_ops import filter_project_flagship
from .kernels.hashtable import broadcast_probe
from .ops.groupby import group_by
from .ops.join import join, join_asof
from .ops.selection import filter, take
from .registry import call_function, list_functions
from .query import Query, query
from .table import (ChunkedColumn, RecordBatch, Table, concat_batches,
                    concat_columns, record_batch, table)

from .io.compression import (Codec, CompressedInputStream,  # noqa: E402
                             CompressedOutputStream, compress, decompress)
from .io.streams import (Buffer, BufferOutputStream,  # noqa: E402
                         BufferReader, BufferedInputStream,
                         BufferedOutputStream, MemoryMappedFile, OSFile,
                         allocate_buffer, create_memory_map, foreign_buffer,
                         input_stream, memory_map, output_stream, py_buffer)
from .memory import (LoggingMemoryPool, MemoryPool,  # noqa: E402
                     ProxyMemoryPool, default_memory_pool, set_memory_pool)
from .runtime import build_info, runtime_info  # noqa: E402
from .thread_pool import cpu_count  # noqa: E402
from .thread_pool import cpu_thread_pool as _cpu_pool  # noqa: E402

# pyarrow-named io facades (import arrow1_tpu_torch.parquet as pq, ...)
from . import csv, json, orc, parquet  # noqa: E402,F401
# datasets, file systems and bridges, as the reference's package imports
# them (fs_s3, fs_hdfs, cabi, plasma, validate and testing on first use)
from . import builders, cdata, dataset, fs, gandiva, tensor  # noqa: E402,F401


def total_allocated_bytes(device=None) -> int:
    """Bytes in use on ``device`` (CUDA unless the caller names the CPU):
    ``torch.cuda.memory_allocated`` for a card (reference:
    default_memory_pool()->bytes_allocated); 0 for the CPU, which has no
    device allocator."""
    import torch

    dev = resolve_device(device)
    return int(torch.cuda.memory_allocated(dev)) if dev.type == "cuda" \
        else 0


def system_memory_pool() -> MemoryPool:
    return default_memory_pool()


def logging_memory_pool(parent=None) -> LoggingMemoryPool:
    return LoggingMemoryPool(parent or default_memory_pool())


def proxy_memory_pool(parent=None) -> ProxyMemoryPool:
    return ProxyMemoryPool(parent or default_memory_pool())


def jemalloc_memory_pool() -> MemoryPool:
    raise errors.NotImplementedError_(
        "jemalloc is not used here: device memory is managed by PyTorch's "
        "CUDA caching allocator, host staging by the CPython allocator")


def mimalloc_memory_pool() -> MemoryPool:
    raise errors.NotImplementedError_(
        "mimalloc is not used here: device memory is managed by PyTorch's "
        "CUDA caching allocator, host staging by the CPython allocator")


def jemalloc_set_decay_ms(ms: int) -> None:
    raise errors.NotImplementedError_("jemalloc is not used here")


def supported_memory_backends():
    return ["system"]


_BASE_POOL = [None]  # pool before logging was enabled


def log_memory_allocations(enable: bool = True) -> None:
    cur = default_memory_pool()
    if enable:
        if not isinstance(cur, LoggingMemoryPool):
            _BASE_POOL[0] = cur
            set_memory_pool(LoggingMemoryPool(cur))
    elif isinstance(cur, LoggingMemoryPool):
        set_memory_pool(_BASE_POOL[0] or MemoryPool())


_io_thread_count = [8]


def set_cpu_count(n: int) -> None:
    _cpu_pool().set_capacity(int(n))


def io_thread_count() -> int:
    return _io_thread_count[0]


def set_io_thread_count(n: int) -> None:
    _io_thread_count[0] = int(n)


def show_versions() -> None:
    import sys as _s

    import numpy as _np
    import torch as _t

    print(f"arrow1_tpu_torch : {__version__}")
    print(f"torch            : {_t.__version__} (CUDA {_t.version.cuda})")
    print(f"numpy            : {_np.__version__}")
    print(f"python           : {_s.version.split()[0]}")


show_info = show_versions

NA = Scalar(0, null, is_valid=False)   # pyarrow.NA

__all__ = ["acero", "dtypes", "Column", "Dictionary", "ListColumn",
           "StructColumn", "UnionColumn", "fixed_size_list_column", "Scalar",
           "scalar", "NA", "null", "DataType", "list_", "large_list", "fixed_size_list",
           "struct", "map_", "sparse_union", "dense_union",
           "binary", "bool_", "float16", "float32", "float64", "int8",
           "int16", "int32", "int64", "large_binary", "large_string",
           "string", "uint8", "uint16", "uint32", "uint64", "date32",
           "date64", "timestamp", "time32", "time64", "duration",
           "month_day_nano_interval", "decimal128", "decimal256",
           "resolve_device",
           "CompiledPipeline", "PipelineBuilder", "Expression", "call",
           "field", "literal", "from_reference_arrays",
           "filter_project_flagship", "broadcast_probe", "group_by",
           "join", "join_asof", "filter", "take",
           "call_function",
           "list_functions", "RecordBatch", "record_batch", "Query",
           "query", "ChunkedColumn", "Table", "concat_batches",
           "concat_columns", "table", "total_allocated_bytes", "Codec",
           "CompressedInputStream", "CompressedOutputStream", "compress",
           "decompress", "Buffer", "BufferOutputStream", "BufferReader",
           "BufferedInputStream", "BufferedOutputStream",
           "MemoryMappedFile", "OSFile", "allocate_buffer",
           "create_memory_map", "foreign_buffer", "input_stream",
           "memory_map", "output_stream", "py_buffer", "LoggingMemoryPool",
           "MemoryPool", "ProxyMemoryPool", "default_memory_pool",
           "set_memory_pool", "system_memory_pool", "logging_memory_pool",
           "proxy_memory_pool", "jemalloc_memory_pool",
           "mimalloc_memory_pool", "jemalloc_set_decay_ms",
           "supported_memory_backends", "log_memory_allocations",
           "cpu_count", "set_cpu_count", "io_thread_count",
           "set_io_thread_count", "build_info", "runtime_info",
           "show_versions", "show_info"]
