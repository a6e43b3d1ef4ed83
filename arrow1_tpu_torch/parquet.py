"""pyarrow.parquet-shaped module (counterpart of arrow1_tpu/parquet.py;
reference: python/pyarrow/parquet/__init__.py: read_table, write_table,
ParquetFile, ParquetWriter, read_schema, ParquetDataset), so
``import arrow1_tpu_torch.parquet as pq`` ports 1:1. Backed by the native
reader and writer (io/parquet.py). Readers take ``device=`` (CUDA unless
the caller names the CPU); a schema is each column's (name, type), as
the ipc facade gives it."""

from __future__ import annotations

from typing import Optional, Sequence

from .io.parquet import (  # noqa: F401
    decryption_properties, encryption_properties, iter_parquet_batches,
    read_parquet, write_parquet,
)
from .table import Table

__all__ = ["read_table", "write_table", "read_schema", "ParquetFile",
           "ParquetWriter", "ParquetDataset", "read_parquet",
           "write_parquet", "iter_parquet_batches",
           "encryption_properties", "decryption_properties"]


def _schema(table: Table):
    b = table.batches[0]
    return tuple((n, c.dtype) for n, c in zip(b.names, b.columns))


def _select(table: Table, columns) -> Table:
    return Table([b.select(list(columns)) for b in table.batches]) \
        if columns else table


def read_table(source, columns: Optional[Sequence[str]] = None, **kwargs):
    """pyarrow.parquet.read_table's shape."""
    return read_parquet(source, columns=columns, **kwargs)


def write_table(table, where, **kwargs):
    """pyarrow.parquet.write_table's shape."""
    return write_parquet(table, where, **kwargs)


def read_schema(where):
    """The (name, type) of each column of a Parquet file, from a read of
    no row group on the CPU."""
    from .io.csv import _as_bytes
    from .io.parquet_native import read_parquet_native

    batch = read_parquet_native(_as_bytes(where), row_groups=[],
                                device="cpu")
    return tuple((n, c.dtype) for n, c in zip(batch.names, batch.columns))


class ParquetFile:
    """pyarrow.parquet.ParquetFile's shape: the schema and per-row-group
    and batched reads of one file (read once, on ``device``)."""

    def __init__(self, source, device=None):
        self._source = source
        self._device = device
        self._table = None

    def _load(self) -> Table:
        """One batch a row group (one empty batch for a file of none)."""
        if self._table is None:
            batches = list(iter_parquet_batches(
                self._source, batch_rows=1 << 62, device=self._device))
            self._table = Table(batches) if batches else read_parquet(
                self._source, device=self._device)
        return self._table

    @property
    def schema_arrow(self):
        return _schema(self._load())

    @property
    def schema(self):
        return _schema(self._load())

    @property
    def num_row_groups(self) -> int:
        return len(self._load().batches)

    def read(self, columns: Optional[Sequence[str]] = None):
        return _select(self._load(), columns)

    def read_row_group(self, i: int,
                       columns: Optional[Sequence[str]] = None):
        return _select(Table([self._load().batches[i]]), columns)

    def iter_batches(self, batch_size: int = 1 << 16,
                     columns: Optional[Sequence[str]] = None):
        combined = self.read(columns).combine_chunks()
        for lo in range(0, combined.num_rows, batch_size):
            yield combined.slice(lo, batch_size)


class ParquetWriter:
    """pyarrow.parquet.ParquetWriter's shape: batches are buffered and
    written on close (the native writer emits one file)."""

    def __init__(self, where, schema=None, **kwargs):
        self._where = where
        self._kwargs = kwargs
        self._batches = []

    def write_table(self, table):
        self._batches.extend(table.batches)

    def write_batch(self, batch):
        self._batches.append(batch)

    def close(self):
        if self._batches:
            write_parquet(Table(self._batches), self._where, **self._kwargs)
            self._batches = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def ParquetDataset(path_or_paths, **kwargs):
    """pyarrow.parquet.ParquetDataset's shape: ``dataset.dataset`` of
    Parquet files (as modern pyarrow does)."""
    from .dataset import dataset

    return dataset(path_or_paths, format="parquet", **kwargs)
