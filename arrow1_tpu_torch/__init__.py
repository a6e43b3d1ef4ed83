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
the kernels of the JAX package's remaining Pallas entry points.
"""

from . import acero, dtypes
from .column import (Column, Dictionary, ListColumn, StructColumn,
                     UnionColumn, fixed_size_list_column)
from .datum import Scalar, scalar
from .dtypes import (DataType, binary, bool_, date32, date64, decimal128,
                     decimal256, dense_union, duration, fixed_size_list,
                     float16, float32, float64, int8, int16, int32, int64,
                     large_binary, large_list, large_string, list_, map_,
                     month_day_nano_interval, sparse_union, string, struct,
                     time32, time64, timestamp, uint8, uint16, uint32,
                     uint64)
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

__all__ = ["acero", "dtypes", "Column", "Dictionary", "ListColumn",
           "StructColumn", "UnionColumn", "fixed_size_list_column", "Scalar",
           "scalar", "DataType", "list_", "large_list", "fixed_size_list",
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
           "concat_columns", "table"]
