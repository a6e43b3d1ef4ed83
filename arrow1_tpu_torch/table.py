"""RecordBatch: named, equal-length Columns (counterpart of
arrow1_tpu/table.py)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

from .column import Column
from .errors import KeyError_

__all__ = ["RecordBatch", "record_batch"]


class RecordBatch:
    """An ordered set of named, equal-length columns on one device."""

    __slots__ = ("columns", "names")

    def __init__(self, columns: Tuple[Column, ...], names: Tuple[str, ...]):
        if len(columns) != len(names):
            raise ValueError(f"{len(columns)} columns but {len(names)} names")
        lengths = {c.length for c in columns}
        if len(lengths) > 1:
            raise ValueError(f"columns of unequal lengths {sorted(lengths)}")
        self.columns = tuple(columns)
        self.names = tuple(names)

    @property
    def num_rows(self) -> int:
        return self.columns[0].length if self.columns else 0

    @property
    def num_columns(self) -> int:
        return len(self.columns)

    def column(self, key) -> Column:
        if isinstance(key, int):
            return self.columns[key]
        try:
            return self.columns[self.names.index(key)]
        except ValueError:
            raise KeyError_(f"no column named {key!r}") from None

    def __getitem__(self, key) -> Column:
        return self.column(key)

    def to_pydict(self) -> dict:
        return {n: c.to_pylist() for n, c in zip(self.names, self.columns)}

    def to_arrow(self):
        from .interop import record_batch_to_arrow

        return record_batch_to_arrow(self)

    def __repr__(self):
        cols = ", ".join(f"{n}: {c.dtype!r}"
                         for n, c in zip(self.names, self.columns))
        return f"RecordBatch[{self.num_rows} rows]({cols})"


def record_batch(data, names: Optional[Sequence[str]] = None,
                 device=None) -> RecordBatch:
    """Build a RecordBatch on ``device`` (CUDA unless the caller names
    another) from a dict of name -> numpy array, a sequence of arrays with
    ``names``, or a pyarrow RecordBatch/Table."""
    from .device import resolve_device
    from .interop import column_from_numpy, record_batch_from_arrow

    dev = resolve_device(device)
    if isinstance(data, dict):
        return RecordBatch(tuple(column_from_numpy(v, device=dev)
                                 for v in data.values()),
                           tuple(data.keys()))
    if names is not None:
        return RecordBatch(tuple(column_from_numpy(v, device=dev)
                                 for v in data), tuple(names))
    return record_batch_from_arrow(data, device=dev)
