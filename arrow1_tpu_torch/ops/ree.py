"""Run-end encoding and ``random`` (counterpart of arrow1_tpu/ops/ree.py).

Reference: vector_run_end_encode.cc and vector_random.cc. Run-end-encoded
data is a RecordBatch{run_ends, values}, the reference's REE array
without a wrapper type; compute runs on the decoded form. Float values
are equal when their bits are, as in pyarrow.

``random`` makes data, so it is an entry point: it runs on CUDA unless
``RandomOptions.device`` names the CPU, and raises without a card. Its
numbers come from a ``torch.Generator`` seeded with
``RandomOptions.initializer``: the same seed gives the same numbers on the
same device, but not the JAX package's (threefry) numbers.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import dtypes as dt
from ..column import Column
from ..device import resolve_device
from ..errors import Invalid
from ..registry import register_function
from ..table import RecordBatch
from .common import as_int64
from .selection import take_column

__all__ = ["RunEndEncodeOptions", "RandomOptions"]


@dataclasses.dataclass
class RunEndEncodeOptions:
    """Reference: api_vector.h RunEndEncodeOptions (run_end_type in
    {int16, int32, int64})."""

    run_end_type: object = None


def _run_end_dtype(options) -> dt.DataType:
    t = options.run_end_type if options is not None else None
    if t is None:
        return dt.int32
    t = t if isinstance(t, dt.DataType) else dt.from_arrow(t)
    if t.kind not in ("int16", "int32", "int64"):
        raise Invalid(f"run_end_type must be int16/int32/int64, got {t}")
    return t


def _run_end_encode_exec(args, options: RunEndEncodeOptions, ctx):
    """Runs of equal values (two nulls are equal whatever their payload)
    become one value each and the end of the run."""
    (col,) = args
    end_t = _run_end_dtype(options)
    n = col.length
    if n == 0:
        return RecordBatch((Column(torch.zeros(0, dtype=end_t.physical_dtype(),
                                               device=col.device), end_t),
                            col), ("run_ends", "values"))
    # floats compare by their bits, as in pyarrow: NaN runs merge and 0.0
    # and -0.0 are different values (ROADMAP Queue 3)
    x = col.data
    if x.is_floating_point():
        x = x.view({8: torch.int64, 4: torch.int32,
                    2: torch.int16}[x.element_size()])
    elif col.dtype.is_integer:
        x = as_int64(x)
    valid = col.mask()
    first = torch.ones(n, dtype=torch.bool, device=col.device)
    if n > 1:
        same = (x[1:] == x[:-1]) & (valid[1:] == valid[:-1])
        first[1:] = ~(same | (~valid[1:] & ~valid[:-1]))
    starts = torch.nonzero(first).reshape(-1)   # sizes the output: a sync
    ends = torch.cat([starts[1:], torch.tensor([n], device=col.device)])
    return RecordBatch((Column(ends.to(end_t.physical_dtype()), end_t),
                        take_column(col, starts)), ("run_ends", "values"))


def _run_end_decode_exec(args, options, ctx):
    (ree,) = args
    if not isinstance(ree, RecordBatch) or \
            "run_ends" not in ree.names or "values" not in ree.names:
        raise Invalid("run_end_decode: expects {run_ends, values}")
    ends = ree.column("run_ends").data.to(torch.int64)
    vals = ree.column("values")
    lengths = torch.diff(ends, prepend=ends.new_zeros(1))
    parent = torch.repeat_interleave(
        torch.arange(ends.shape[0], device=ends.device), lengths)
    return take_column(vals, parent)


register_function("run_end_encode", "vector", 1, RunEndEncodeOptions)(
    _run_end_encode_exec)
register_function("run_end_decode", "vector", 1)(_run_end_decode_exec)


@dataclasses.dataclass
class RandomOptions:
    """Reference: RandomOptions (length, initializer: an integer seed or
    "system"); ``device`` is the port's: where the numbers are made (CUDA
    when None)."""

    length: int = 0
    initializer: object = "system"
    device: object = None


def _random_exec(args, options: RandomOptions, ctx):
    """``length`` uniform float64 numbers in [0, 1) (reference:
    vector_random.cc)."""
    options = options or RandomOptions()
    dev = resolve_device(options.device)
    seed = options.initializer
    gen = torch.Generator(device=dev)
    if seed == "system" or seed is None:
        gen.seed()
    else:
        gen.manual_seed(int(seed))
    return Column(torch.rand(int(options.length), dtype=torch.float64,
                             generator=gen, device=dev), dt.float64)


register_function("random", "vector", -1, RandomOptions)(_random_exec)
