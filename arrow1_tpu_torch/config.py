"""Engine configuration (counterpart of arrow1_tpu/config.py): per-call
option structs and an explicit execution context, no globals (reference
model: cpp/src/arrow/compute/exec.h:58 ExecContext and the
FunctionOptions hierarchy).

The function options live beside their functions, as in the reference
(``ops/validity.NullOptions``, ``ops/cast.CastOptions``,
``ops/set_lookup.SetLookupOptions``, ...), and ``compute`` exports each
registered one by name. Honoured environment variable:
``A1T_TARGET_BATCH_ROWS``, the streaming batch target (default 2^21
rows). The reference's ``interpret`` switch (Pallas interpreter mode) has
no counterpart: the port's kernels run on the card, and a CPU tensor
takes each kernel's plain version.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

__all__ = ["ExecContext", "default_context", "TARGET_BATCH_ROWS"]

TARGET_BATCH_ROWS = int(os.environ.get("A1T_TARGET_BATCH_ROWS", 1 << 21))


@dataclasses.dataclass
class ExecContext:
    """Execution context threaded through the kernels (reference:
    exec.h:58); ``device`` is where ingested data goes (CUDA when
    None)."""

    exec_chunksize: int = TARGET_BATCH_ROWS
    use_threads: bool = True
    device: Optional[str] = None


_default_context = ExecContext()


def default_context() -> ExecContext:
    return _default_context
