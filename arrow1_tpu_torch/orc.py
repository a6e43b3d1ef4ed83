"""pyarrow.orc-shaped module (counterpart of arrow1_tpu/orc.py;
reference: python/pyarrow/orc.py, ORCFile, read_table and write_table).
Reads and writes are native (io/orc.py). Readers take ``device=`` (CUDA
unless the caller names the CPU); a schema is each column's (name,
type), as the ipc facade gives it."""

from __future__ import annotations

from .io.orc import orc_available, read_orc, write_orc
from .table import Table

__all__ = ["ORCFile", "read_table", "write_table", "orc_available",
           "read_orc", "write_orc"]


class ORCFile:
    """pyarrow.orc.ORCFile's shape (the file read once, on ``device``)."""

    def __init__(self, source, device=None):
        self._source = source
        self._device = device
        self._table = None

    def _load(self) -> Table:
        if self._table is None:
            self._table = read_orc(self._source, device=self._device)
        return self._table

    @property
    def schema(self):
        b = self._load().batches[0]
        return tuple((n, c.dtype) for n, c in zip(b.names, b.columns))

    @property
    def nrows(self) -> int:
        return self._load().num_rows

    @property
    def nstripes(self) -> int:
        return len(self._load().batches)

    def read(self, columns=None):
        t = self._load()
        return Table([b.select(list(columns)) for b in t.batches]) \
            if columns else t


def read_table(source, columns=None, device=None):
    return read_orc(source, columns=columns, device=device)


def write_table(table, where):
    return write_orc(table, where)
