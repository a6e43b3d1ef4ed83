"""Datasets: multi-file discovery, partition pruning and scanning
(counterpart of arrow1_tpu/dataset.py).

Reference: cpp/src/arrow/dataset/ — Dataset and Fragment (dataset.h:152,
49), Scanner and ScannerBuilder (scanner.h:241, 313), the Hive, directory
and filename partitionings with expression pruning (partition.h:59), and
filter and projection pushed into the scan (scanner_internal.h:41-151).

A fragment is a file. Pruning runs on the host through
``simplify_with_guarantee`` (the reference's SimplifyWithGuarantee,
expression.cc:963): a fragment whose partition guarantee makes the filter
false is never opened. The fragments left decode on worker threads
(``io.prefetch.MergedIterator``) through the format readers, which put
each batch on the scan's ``device`` (CUDA unless the caller names the
CPU) with one staging copy; the filter (K2 on the card), the projection
and the partition columns then run on that device. ``write_dataset``
finds the distinct partition keys with one ``torch.unique`` a batch and
takes each partition's rows with the engine's ``filter``.
"""

from __future__ import annotations

import dataclasses
import os
import posixpath
import re
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from . import dtypes as dt
from .column import Column, Dictionary
from .datum import scalar as make_scalar
from .device import resolve_device
from .errors import Invalid
from .expr import (Call, Expression, FieldRef, Literal, field, literal,
                   simplify_with_guarantee)
from .table import RecordBatch, Table, concat_batches

__all__ = ["Fragment", "FileSystemDataset", "Scanner", "ScannerBuilder",
           "ScanOptions", "Partitioning", "HivePartitioning",
           "DirectoryPartitioning", "FilenamePartitioning",
           "PartitioningFactory", "partitioning", "dataset",
           "write_dataset", "InMemoryDataset", "UnionDataset",
           "get_partition_keys"]


@dataclasses.dataclass
class Fragment:
    """One scannable unit (reference: dataset.h:49): a file and its
    partition guarantee. A fragment with a ``filesystem`` is remote: its
    bytes come through the FileSystem API (the native S3 and WebHDFS
    clients, for example) into a local spool file, which the format
    readers then read as they read any file."""

    path: str
    format: str  # "parquet" | "ipc" | "csv" | "json" | "orc"
    partition_expression: Optional[Expression] = None
    filesystem: Optional[object] = None

    def scan_batches(self, columns=None, device=None
                     ) -> Iterator[RecordBatch]:
        """The fragment's batches on ``device`` (CUDA unless the caller
        names the CPU), holding ``columns`` (all when None)."""
        from . import io as aio

        dev = resolve_device(device)
        if self.filesystem is not None:
            import tempfile

            with self.filesystem.open_input(self.path) as src:
                data = src.read()
            suffix = os.path.splitext(self.path)[1]
            with tempfile.NamedTemporaryFile(suffix=suffix) as tmp:
                tmp.write(data)
                tmp.flush()
                del data
                local = dataclasses.replace(self, path=tmp.name,
                                            filesystem=None)
                yield from local.scan_batches(columns, dev)
            return

        def chosen(batches):
            for b in batches:
                yield b.select(list(columns)) if columns else b

        if self.format == "parquet":
            empty = True
            for b in aio.parquet.iter_parquet_batches(
                    self.path, columns=columns, device=dev):
                empty = False
                yield b
            if empty:   # a file of no row group: its schema as one empty
                # batch, as pyarrow's scan gives it
                yield aio.read_parquet(self.path, columns=columns,
                                       device=dev).batches[0].slice(0, 0)
        elif self.format in ("ipc", "feather", "arrow"):
            yield from chosen(aio.read_ipc(self.path, batched=True,
                                           device=dev))
        elif self.format == "csv":
            yield from chosen(aio.csv.open_csv_stream(self.path,
                                                      device=dev))
        elif self.format == "json":
            yield from chosen(aio.read_json(self.path, device=dev).batches)
        elif self.format == "orc":
            yield from aio.read_orc(self.path, columns=list(columns)
                                    if columns else None,
                                    device=dev).batches
        else:
            raise Invalid(f"unknown fragment format {self.format!r}")


def _field_types(schema) -> dict:
    """{name: DataType} of a partitioning schema: (name, DataType) pairs,
    a dict of them, or a pyarrow schema."""
    if schema is None:
        return {}
    if hasattr(schema, "names") and hasattr(schema, "types"):
        return {n: dt.from_arrow(t) for n, t in
                zip(schema.names, schema.types)}
    items = schema.items() if isinstance(schema, dict) else schema
    return {n: t for n, t in items}


def _inferred(value: str):
    """A path segment's value: an int where it reads as one."""
    return int(value) if re.fullmatch(r"-?\d+", value) else value


def _conjunction(pairs) -> Optional[Expression]:
    """``field == value`` over (name, Literal) pairs, ANDed."""
    expr = None
    for name, lit in pairs:
        cond = field(name) == lit
        expr = cond if expr is None else (expr & cond)
    return expr


class Partitioning:
    """Reference: partition.h:59."""

    def parse(self, relpath: str) -> Optional[Expression]:
        raise NotImplementedError

    def format(self, values: dict) -> str:
        raise NotImplementedError


class HivePartitioning(Partitioning):
    """key=value path segments (reference: HivePartitioning). A key the
    ``schema`` names takes its type; another is an int64 where its value
    reads as an integer and a string otherwise."""

    def __init__(self, schema=None):
        self.schema = schema
        self._types = _field_types(schema)

    def _literal(self, key: str, value: str) -> Literal:
        t = self._types.get(key)
        if t is None:
            return literal(_inferred(value))
        if t.is_integer:
            return Literal(make_scalar(int(value), t))
        if t.is_floating:
            return Literal(make_scalar(float(value), t))
        return Literal(make_scalar(value, t))

    def parse(self, relpath):
        pairs = []
        for seg in relpath.replace(os.sep, "/").split("/")[:-1]:
            if "=" in seg:
                k, v = seg.split("=", 1)
                pairs.append((k, self._literal(k, v)))
        return _conjunction(pairs)

    def format(self, values: dict) -> str:
        return os.sep.join(f"{k}={v}" for k, v in values.items())


class DirectoryPartitioning(Partitioning):
    """Positional path segments mapped to named fields."""

    def __init__(self, field_names: Sequence[str], schema=None):
        self.field_names = list(field_names)
        self.schema = schema

    def parse(self, relpath):
        segs = relpath.replace(os.sep, "/").split("/")[:-1]
        return _conjunction((name, literal(_inferred(seg)))
                            for name, seg in zip(self.field_names, segs))

    def format(self, values: dict) -> str:
        return os.sep.join(str(values[k]) for k in self.field_names)


class FilenamePartitioning(Partitioning):
    """Underscore-separated values before the file's name (reference:
    partition.h FilenamePartitioning, '<val>_<val>_<rest>')."""

    def __init__(self, field_names: Sequence[str] = (), schema=None):
        self.field_names = list(field_names) if field_names else \
            list(_field_types(schema))
        self.schema = schema

    def parse(self, relpath):
        segs = posixpath.basename(relpath.replace(os.sep, "/")).split(
            "_")[:len(self.field_names)]
        return _conjunction((name, literal(_inferred(seg)))
                            for name, seg in zip(self.field_names, segs))

    def format(self, values: dict) -> str:
        return "_".join(str(values[k]) for k in self.field_names) + "_"


class PartitioningFactory:
    """A partitioning whose value types are found at discovery
    (reference: partition.h PartitioningFactory)."""

    def __init__(self, kind: str, field_names=()):
        self.kind = kind
        self.field_names = list(field_names)

    def finish(self, schema=None) -> Partitioning:
        if self.kind == "hive":
            return HivePartitioning(schema)
        if self.kind == "filename":
            return FilenamePartitioning(self.field_names, schema)
        return DirectoryPartitioning(self.field_names, schema)


def partitioning(schema=None, field_names=None, flavor=None,
                 dictionaries=None) -> Partitioning:
    """pyarrow.dataset.partitioning: flavor None gives a directory
    partitioning, 'hive' a Hive one, 'filename' a filename one."""
    if flavor == "hive":
        return HivePartitioning(schema)
    names = field_names or list(_field_types(schema))
    if flavor == "filename":
        return FilenamePartitioning(names, schema)
    if not names:
        raise Invalid("partitioning needs schema or field_names")
    return DirectoryPartitioning(names, schema)


def get_partition_keys(partition_expression) -> dict:
    """{field: value} of a conjunction of equalities (reference:
    partition.cc GetPartitionKeys)."""
    return {name: lit.value.as_py()
            for name, lit in _equalities(partition_expression)}


def _equalities(expr):
    """(name, Literal) of each ``field == literal`` in a conjunction."""
    if isinstance(expr, Call):
        if expr.function in ("and", "and_kleene"):
            for a in expr.args:
                yield from _equalities(a)
        elif expr.function == "equal" and len(expr.args) == 2:
            a, b = expr.args
            if isinstance(a, FieldRef) and isinstance(b, Literal):
                yield a.name, b
            elif isinstance(b, FieldRef) and isinstance(a, Literal):
                yield b.name, a


_EXT_FORMAT = {".parquet": "parquet", ".arrow": "ipc", ".ipc": "ipc",
               ".feather": "ipc", ".csv": "csv", ".json": "json",
               ".ndjson": "json", ".orc": "orc"}


def _format_of(path: str, format: Optional[str]) -> Optional[str]:
    return format or _EXT_FORMAT.get(os.path.splitext(path)[1])


class FileSystemDataset:
    """Reference: dataset.h:152 and discovery.h FileSystemDatasetFactory."""

    def __init__(self, fragments: List[Fragment],
                 partitioning: Optional[Partitioning] = None):
        self.fragments = fragments
        self.partitioning = partitioning

    @property
    def files(self) -> List[str]:
        return [f.path for f in self.fragments]

    @classmethod
    def discover(cls, root: str, format: Optional[str] = None,
                 partitioning: Optional[Partitioning] = None,
                 filesystem=None) -> "FileSystemDataset":
        """Every file under ``root`` whose extension names a format (or
        every file, given ``format``), in path order, each with the
        guarantee its path gives under ``partitioning``."""
        def fragment(path, rel, fs):
            return Fragment(path, _format_of(path, format),
                            partitioning.parse(rel) if partitioning
                            else None, fs)

        if filesystem is not None:
            # remote discovery through the FileSystem API (reference:
            # discovery.h FileSystemDatasetFactory over a FileSystem)
            if filesystem.get_file_info(root).is_file:
                return cls([Fragment(root, _format_of(root, format), None,
                                     filesystem)], partitioning)
            base = root.rstrip("/")
            fragments = []

            def walk(d):
                for info in filesystem.ls(d):
                    if not info.is_file:
                        walk(info.path)
                    elif _format_of(info.path, format) is not None:
                        fragments.append(fragment(
                            info.path, posixpath.relpath(info.path, base),
                            filesystem))

            walk(base)
            fragments.sort(key=lambda f: f.path)
            return cls(fragments, partitioning)
        root = os.path.abspath(root)
        if os.path.isfile(root):
            return cls([Fragment(root, _format_of(root, format))],
                       partitioning)
        fragments = []
        for dirpath, dirs, files in os.walk(root):
            dirs.sort()
            for fname in sorted(files):
                full = os.path.join(dirpath, fname)
                if _format_of(full, format) is not None:
                    fragments.append(fragment(
                        full, os.path.relpath(full, root), None))
        return cls(fragments, partitioning)

    def get_fragments(self, predicate: Optional[Expression] = None
                      ) -> List[Fragment]:
        """Partition pruning (reference: dataset.h GetFragments and
        SimplifyWithGuarantee, expression.cc:963): a fragment is left out
        when the filter simplifies to false under its guarantee."""
        if predicate is None:
            return list(self.fragments)
        return [f for f in self.fragments
                if f.partition_expression is None
                or not _is_false(simplify_with_guarantee(
                    predicate, f.partition_expression))]

    def scanner(self, **kwargs) -> "Scanner":
        return ScannerBuilder(self).finish(**kwargs)

    def to_table(self, **kwargs) -> Table:
        return self.scanner(**kwargs).to_table()

    def to_batches(self, **kwargs) -> Iterator[RecordBatch]:
        return self.scanner(**kwargs).scan_batches()

    def count_rows(self, **kwargs) -> int:
        return self.scanner(**kwargs).count_rows()

    def head(self, n: int, **kwargs) -> Table:
        return self.scanner(**kwargs).head(n)


def _is_false(e: Expression) -> bool:
    return isinstance(e, Literal) and e.value.is_valid and \
        e.value.as_py() is False


def _is_true(e: Expression) -> bool:
    return isinstance(e, Literal) and e.value.is_valid and \
        e.value.as_py() is True


@dataclasses.dataclass
class ScanOptions:
    """Reference: scanner.h:56 (and the StopToken of util/cancel.h).

    ``device`` is where the scan's batches live (CUDA unless the caller
    names the CPU). ``to_device`` keeps the reference's field, whose
    workers moved each decoded batch onto the device; here the readers
    already decode onto ``device``, so it changes nothing."""

    filter: Optional[Expression] = None
    columns: Optional[Sequence[str]] = None
    projection: Optional[Sequence] = None  # [(Expression, name)]
    readahead: int = 2
    fragment_readahead: int = 4  # fragments decoded at once (scanner.cc:426)
    ordered: bool = True   # sequenced merge, or first-ready delivery
    to_device: bool = False
    stop_token: Optional[object] = None  # cancel.StopToken
    device: Optional[object] = None


class Scanner:
    """Reference: scanner.h:241: fragments streamed through the filter and
    the projection (scanner_internal.h:102 FilterAndProjectScanTask) with
    readahead."""

    def __init__(self, dataset: FileSystemDataset, options: ScanOptions):
        self.dataset = dataset
        self.options = options

    def _needed_columns(self) -> Optional[List[str]]:
        opts = self.options
        if opts.projection is None and opts.columns is None:
            return None
        needed = set(opts.columns or [])
        for e, _ in opts.projection or ():
            needed |= e.fields()
        if opts.filter is not None:
            needed |= opts.filter.fields()
        return sorted(needed)

    def _process_fragment(self, frag: Fragment, columns, dev):
        """Decode, filter and project one fragment's batches as they come
        (the FilterAndProjectScanTask unit, scanner_internal.h:102)."""
        from .registry import call_function

        opts = self.options
        filt = opts.filter
        keys = dict(_equalities(frag.partition_expression))
        if filt is not None and keys:
            filt = simplify_with_guarantee(filt, frag.partition_expression)
        if filt is not None and _is_true(filt):
            filt = None
        for batch in frag.scan_batches(columns=_file_columns(columns, keys),
                                       device=dev):
            if opts.stop_token is not None:
                opts.stop_token.poll()
            batch = _with_partition_columns(batch, keys, dev)
            if filt is not None:
                batch = call_function("filter", [batch,
                                                 filt.execute(batch)])
            yield self._project(batch)

    def _project(self, batch: RecordBatch) -> RecordBatch:
        opts = self.options
        if opts.projection:
            return RecordBatch(tuple(e.execute(batch)
                                     for e, _ in opts.projection),
                               tuple(n for _, n in opts.projection))
        if opts.columns:
            return batch.select(list(opts.columns))
        return batch

    def scan_batches(self) -> Iterator[RecordBatch]:
        """Up to ``fragment_readahead`` fragments decode at once, each
        through its own bounded queue (reference: the async scanner's
        merged generator, dataset/scanner.cc:426-650); ``ordered`` picks
        the sequenced merge (the default) or first-ready delivery."""
        from .io.prefetch import MergedIterator, ReadaheadIterator

        opts = self.options
        dev = resolve_device(opts.device)
        fragments = self.dataset.get_fragments(opts.filter)
        if not fragments:
            return iter(())
        columns = self._needed_columns()
        merged = MergedIterator(
            [(lambda f=f: self._process_fragment(f, columns, dev))
             for f in fragments],
            readahead=max(1, opts.fragment_readahead),
            ordered=opts.ordered, depth=max(1, opts.readahead))

        def polled():
            for batch in merged:
                if opts.stop_token is not None:
                    opts.stop_token.poll()
                yield batch

        return ReadaheadIterator(polled(), opts.readahead)

    def _empty(self) -> RecordBatch:
        """A zero-row batch of the scan's schema, from the dataset's first
        fragment (a scan that pruned every fragment has none of its own)."""
        if not self.dataset.fragments:
            raise Invalid("the dataset has no fragments, so no schema")
        dev = resolve_device(self.options.device)
        frag = self.dataset.fragments[0]
        keys = dict(_equalities(frag.partition_expression))
        for batch in frag.scan_batches(
                columns=_file_columns(self._needed_columns(), keys),
                device=dev):
            return self._project(_with_partition_columns(
                batch.slice(0, 0), keys, dev))
        raise Invalid(f"{frag.path} holds no batch, so no schema")

    def to_table(self) -> Table:
        """The scan's batches as a Table; an empty scan gives a zero-row
        Table of the scan's schema, as pyarrow's does."""
        batches = list(self.scan_batches())
        kept = [b for b in batches if b.num_rows > 0]
        return Table(kept or batches[:1] or [self._empty()])

    def to_batches(self) -> Iterator[RecordBatch]:
        return self.scan_batches()

    def count_rows(self) -> int:
        return sum(b.num_rows for b in self.scan_batches())

    def head(self, n: int) -> Table:
        got, total = [], 0
        for b in self.scan_batches():
            if total + b.num_rows >= n:
                got.append(b.slice(0, n - total))
                break
            got.append(b)
            total += b.num_rows
        return Table(got or [self._empty()])


def _file_columns(columns, keys):
    """The columns to read from a file: the scan's but the partition keys,
    which no file holds (all when the scan names none)."""
    return None if columns is None else [c for c in columns if c not in keys]


def _partition_column(lit: Literal, n: int, dev) -> Optional[Column]:
    """A partition key's value repeated ``n`` times on ``dev``, in the
    literal's type (a string: one code into a one-value pool)."""
    v = lit.value
    t = v.dtype
    if t.is_binary:
        return Column(torch.zeros(n, dtype=torch.int32, device=dev), t,
                      dictionary=Dictionary(np.asarray([v.as_py()],
                                                       object)))
    if t.is_integer or t.is_floating or t.is_boolean:
        return Column(torch.full((n,), v.as_py(),
                                 dtype=t.physical_dtype(), device=dev), t)
    return None


def _with_partition_columns(batch: RecordBatch, keys: dict, dev
                            ) -> RecordBatch:
    """The fragment's partition keys as columns of ``batch``, on its
    device (reference: partition fields become columns at scan)."""
    if batch.columns:
        dev = batch.columns[0].device
    for name, lit in keys.items():
        if name not in batch.names:
            col = _partition_column(lit, batch.num_rows, dev)
            if col is not None:
                batch = batch.set_column(name, col)
    return batch


class ScannerBuilder:
    """Reference: scanner.h:313."""

    def __init__(self, dataset: FileSystemDataset):
        self.dataset = dataset
        self._options = ScanOptions()

    def filter(self, expr: Expression) -> "ScannerBuilder":
        self._options.filter = expr
        return self

    def project(self, exprs, names=None) -> "ScannerBuilder":
        """Column names, or expressions and the names of their results."""
        if names is None:
            self._options.columns = list(exprs)
        else:
            self._options.projection = list(zip(exprs, names))
        return self

    def readahead(self, n: int) -> "ScannerBuilder":
        self._options.readahead = n
        return self

    def device(self, device) -> "ScannerBuilder":
        self._options.device = device
        return self

    def finish(self, **kwargs) -> Scanner:
        for k, v in kwargs.items():
            if not hasattr(self._options, k):
                raise TypeError(f"unknown scan option {k!r}")
            setattr(self._options, k, v)
        return Scanner(self.dataset, dataclasses.replace(self._options))


def dataset(source, format=None, partitioning=None, filesystem=None,
            **kwargs) -> FileSystemDataset:
    """pyarrow.dataset.dataset: a path, a list of paths, a Table, batches
    or datasets; ``format`` a name or a FileFormat; ``partitioning`` a
    flavor name ("hive"), a Partitioning or a PartitioningFactory. A URI
    root (``s3://``, ``hdfs://``, ``webhdfs://``, ``mock://``) or an
    explicit ``filesystem`` is read through the FileSystem API."""
    if partitioning == "hive":
        partitioning = HivePartitioning()
    elif isinstance(partitioning, PartitioningFactory):
        partitioning = partitioning.finish()
    fmt = _format_name(format)
    if isinstance(source, str) and "://" in source \
            and not source.startswith("file://"):
        from .fs import filesystem_from_uri

        fs, base = filesystem_from_uri(source)
        return FileSystemDataset.discover(base, fmt, partitioning,
                                          filesystem=fs)
    if isinstance(source, str) and source.startswith("file://"):
        source = source[len("file://"):]
    if filesystem is not None and isinstance(source, str):
        return FileSystemDataset.discover(source, fmt, partitioning,
                                          filesystem=filesystem)
    if isinstance(source, (Table, RecordBatch)) or (
            isinstance(source, (list, tuple)) and source
            and isinstance(source[0], (Table, RecordBatch))):
        return InMemoryDataset(source)
    if isinstance(source, FileSystemDataset):
        return source
    if isinstance(source, (list, tuple)):
        if source and isinstance(source[0], FileSystemDataset):
            return UnionDataset(children=source)
        return FileSystemDataset([Fragment(os.path.abspath(p),
                                           _format_of(p, fmt))
                                  for p in source], None)
    return FileSystemDataset.discover(source, fmt, partitioning)


def _key_plane(col: Column) -> torch.Tensor:
    """int64 values whose distinct entries are the column's distinct
    values: string codes, float bits, integers widened."""
    x = col.data
    if col.dtype.is_binary:
        return x.to(torch.int64)
    if x.dtype == torch.float64:
        return x.view(torch.int64)
    if x.dtype == torch.float32:
        return x.view(torch.int32).to(torch.int64)
    return dt.as_int64(x)


def _key_value(col: Column, v: int):
    """The Python value of one entry of ``_key_plane(col)``."""
    t = col.dtype
    if t.is_binary:
        return col.dictionary.values[v]
    if col.data.dtype == torch.float64:
        return float(np.int64(v).view(np.float64))
    if col.data.dtype == torch.float32:
        return float(np.int32(v).view(np.float32))
    if t.is_boolean:
        return bool(v)
    if t.kind == "uint64":
        return int(np.int64(v).view(np.uint64))
    return int(v)


def _distinct_keys(batches: Sequence[RecordBatch], keys: Sequence[str]):
    """The distinct tuples of the key columns' values over ``batches``,
    sorted by their repr (the reference's order, and so its part
    numbers): one ``torch.unique`` over the stacked key planes a batch."""
    combos = set()
    for b in batches:
        if not b.num_rows:
            continue
        cols = [b.column(k) for k in keys]
        for k, c in zip(keys, cols):
            if not isinstance(c, Column) or c.dtype.is_nested or \
                    c.dtype.is_dictionary or c.dtype.is_decimal:
                raise Invalid(f"write_dataset: partition key {k!r} of type "
                              f"{c.dtype} is not a flat primitive or "
                              f"string column")
            if c.validity is not None and not bool(c.validity.all()):
                raise Invalid(f"write_dataset: partition key {k!r} holds "
                              f"nulls")
        rows = torch.unique(torch.stack([_key_plane(c) for c in cols], 1),
                            dim=0).cpu().numpy()
        combos.update(tuple(_key_value(c, int(v)) for c, v in zip(cols, r))
                      for r in rows)
    return sorted(combos, key=repr)


def write_dataset(data, root: str, partitioning_keys: Sequence[str] = (),
                  format: str = "parquet",
                  partitioning: Optional[Partitioning] = None):
    """Partitioned dataset write (reference: dataset/file_base.h:283
    FileSystemDataset::Write): one file a partition, the rows of each
    taken from every batch by the engine's ``filter`` in source order,
    concatenated and written as one batch without the key columns, at ``key=value/part-<i>.<ext>`` (a
    Hive partitioning, the default) with ``i`` the partition's place in
    the keys' sorted order. The files are written on the CPU thread pool
    while the next partition is filtered."""
    from . import io as aio
    from .registry import call_function
    from .thread_pool import TaskGroup

    fmt = _format_name(format)
    batches = list(data.batches) if isinstance(data, Table) else [data]
    writer = {"parquet": aio.write_parquet, "ipc": aio.write_ipc,
              "csv": aio.write_csv, "orc": aio.write_orc}[fmt]
    ext = {"parquet": ".parquet", "ipc": ".arrow", "csv": ".csv",
           "orc": ".orc"}[fmt]
    os.makedirs(root, exist_ok=True)
    if not partitioning_keys:
        writer(Table(batches), os.path.join(root, f"part-0{ext}"))
        return
    part = partitioning or HivePartitioning()
    keys = list(partitioning_keys)
    combos = _distinct_keys(batches, keys)
    tg = TaskGroup(threaded=len(combos) > 1)
    for i, combo in enumerate(combos):
        values = dict(zip(keys, combo))
        pred = _conjunction((k, literal(v)) for k, v in values.items())
        subs = [call_function("filter", [b, pred.execute(b)])
                for b in batches if b.num_rows]
        # one compact batch a partition, as the reference writes: the
        # filter's outputs are released before the write is queued
        part_rows = concat_batches([s for s in subs if s.num_rows]
                                   ).drop(keys)
        del subs
        if isinstance(part, FilenamePartitioning):
            path = os.path.join(root, f"{part.format(values)}part-{i}{ext}")
        else:
            subdir = os.path.join(root, part.format(values))
            os.makedirs(subdir, exist_ok=True)
            path = os.path.join(subdir, f"part-{i}{ext}")
        tg.append(writer, part_rows, path)
    tg.finish()


# ====================================================================
# pyarrow.dataset's names
# ====================================================================

Dataset = FileSystemDataset
FileFragment = Fragment
ParquetFileFragment = Fragment
FileStats = None  # gone from pyarrow too; kept for dir() parity


class FileFormat:
    """Reference: file_base.h FileFormat: a format's name and the
    extension discovery looks for; fragments dispatch on the name."""

    name = ""
    default_extname = ""

    def __eq__(self, other):
        return isinstance(other, FileFormat) and self.name == other.name

    def __hash__(self):
        return hash(self.name)

    def __repr__(self):
        return f"<{type(self).__name__}>"


class ParquetFileFormat(FileFormat):
    name = "parquet"
    default_extname = "parquet"

    def __init__(self, read_options=None, default_fragment_scan_options=None,
                 **kwargs):
        self.read_options = read_options
        self.default_fragment_scan_options = default_fragment_scan_options


class IpcFileFormat(FileFormat):
    name = "ipc"
    default_extname = "arrow"


class FeatherFileFormat(IpcFileFormat):
    default_extname = "feather"


class CsvFileFormat(FileFormat):
    name = "csv"
    default_extname = "csv"

    def __init__(self, parse_options=None, convert_options=None,
                 read_options=None, default_fragment_scan_options=None):
        self.parse_options = parse_options
        self.convert_options = convert_options
        self.read_options = read_options
        self.default_fragment_scan_options = default_fragment_scan_options


class JsonFileFormat(FileFormat):
    name = "json"
    default_extname = "json"

    def __init__(self, parse_options=None, read_options=None,
                 default_fragment_scan_options=None):
        self.parse_options = parse_options
        self.read_options = read_options
        self.default_fragment_scan_options = default_fragment_scan_options


class OrcFileFormat(FileFormat):
    name = "orc"
    default_extname = "orc"


def _format_name(format) -> Optional[str]:
    """A format name, from a string or a FileFormat."""
    if format is None:
        return None
    return format.name if isinstance(format, FileFormat) else str(format)


def scalar(value):
    """pyarrow.dataset.scalar: an expression literal."""
    return literal(value)


class _MemoryFragment(Fragment):
    """A fragment of batches already in memory, on their own device."""

    def __init__(self, batches, partition_expression=None):
        super().__init__(path="<memory>", format="memory",
                         partition_expression=partition_expression)
        self._batches = list(batches)

    def scan_batches(self, columns=None, device=None):
        for b in self._batches:
            yield b.select(list(columns)) if columns else b


class InMemoryDataset(FileSystemDataset):
    """A dataset over resident tables or batches (reference: dataset.h
    InMemoryDataset)."""

    def __init__(self, source, schema=None):
        batches = []
        for item in source if isinstance(source, (list, tuple)) \
                else [source]:
            batches.extend(item.batches if isinstance(item, Table)
                           else [item])
        super().__init__([_MemoryFragment(batches)], None)


class UnionDataset(FileSystemDataset):
    """The fragments of child datasets, in order (reference:
    UnionDataset)."""

    def __init__(self, schema=None, children=()):
        self.children = list(children)
        super().__init__([f for ch in self.children for f in ch.fragments],
                         None)


class TaggedRecordBatch:
    """(record_batch, fragment) (reference: scanner.h TaggedRecordBatch)."""

    __slots__ = ("record_batch", "fragment")

    def __init__(self, record_batch, fragment):
        self.record_batch = record_batch
        self.fragment = fragment


@dataclasses.dataclass
class FileSystemFactoryOptions:
    """Reference: discovery.h FileSystemFactoryOptions."""
    partition_base_dir: str = ""
    partitioning: Optional[object] = None
    exclude_invalid_files: bool = False
    selector_ignore_prefixes: Sequence[str] = (".", "_")


class DatasetFactory:
    """Deferred dataset construction (reference: discovery.h)."""

    def __init__(self, finish_fn):
        self._finish = finish_fn

    def finish(self, schema=None):
        return self._finish()

    def inspect(self, device=None):
        """The dataset's column names and types (one batch of its first
        file read onto ``device``)."""
        b = self.finish().scanner(device=device)._empty()
        return [(n, c.dtype) for n, c in zip(b.names, b.columns)]


class FileSystemDatasetFactory(DatasetFactory):
    def __init__(self, filesystem, paths_or_selector, format,
                 options: Optional[FileSystemFactoryOptions] = None):
        fmt = _format_name(format)
        part = (options or FileSystemFactoryOptions()).partitioning

        def finish():
            if isinstance(paths_or_selector, (list, tuple)):
                return FileSystemDataset([Fragment(p, _format_of(p, fmt))
                                          for p in paths_or_selector])
            base = getattr(paths_or_selector, "base_dir",
                           paths_or_selector)
            p = part.finish() if isinstance(part, PartitioningFactory) \
                else part
            return FileSystemDataset.discover(base, fmt, p)

        super().__init__(finish)


class UnionDatasetFactory(DatasetFactory):
    def __init__(self, factories):
        super().__init__(
            lambda: UnionDataset(children=[f.finish() for f in factories]))


def parquet_dataset(metadata_path, schema=None, filesystem=None,
                    format=None, partitioning=None):
    """pyarrow.dataset.parquet_dataset: the dataset of a _metadata file's
    directory (its row-group metadata collapses to a scan of the files)."""
    return dataset(os.path.dirname(os.path.abspath(metadata_path)),
                   format="parquet", partitioning=partitioning)


# ---- scan and write option classes (pyarrow's shapes; the scanner reads
# ScanOptions) ----

@dataclasses.dataclass
class FragmentScanOptions:
    pass


@dataclasses.dataclass
class CsvFragmentScanOptions(FragmentScanOptions):
    convert_options: Optional[object] = None
    read_options: Optional[object] = None


@dataclasses.dataclass
class JsonFragmentScanOptions(FragmentScanOptions):
    parse_options: Optional[object] = None
    read_options: Optional[object] = None


@dataclasses.dataclass
class ParquetFragmentScanOptions(FragmentScanOptions):
    use_buffered_stream: bool = False
    buffer_size: int = 8192
    pre_buffer: bool = True


@dataclasses.dataclass
class ParquetReadOptions:
    dictionary_columns: Sequence[str] = ()
    coerce_int96_timestamp_unit: Optional[str] = None


@dataclasses.dataclass
class FileWriteOptions:
    format: Optional[object] = None


@dataclasses.dataclass
class ParquetFileWriteOptions(FileWriteOptions):
    compression: str = "snappy"


@dataclasses.dataclass
class IpcFileWriteOptions(FileWriteOptions):
    compression: Optional[str] = None


@dataclasses.dataclass
class WrittenFile:
    """Reference: file_base.h FileWriter's metadata callback payload."""
    path: str
    metadata: Optional[object] = None
    size: int = 0


@dataclasses.dataclass
class RowGroupInfo:
    id: int = 0
    metadata: Optional[object] = None
    schema: Optional[object] = None
    num_rows: int = 0
    total_byte_size: int = 0


@dataclasses.dataclass
class ParquetEncryptionConfig:
    crypto_factory: Optional[object] = None
    kms_connection_config: Optional[object] = None
    encryption_config: Optional[object] = None


@dataclasses.dataclass
class ParquetDecryptionConfig:
    crypto_factory: Optional[object] = None
    kms_connection_config: Optional[object] = None
    decryption_config: Optional[object] = None


@dataclasses.dataclass
class ParquetFactoryOptions:
    partition_base_dir: str = ""
    partitioning: Optional[object] = None
    validate_column_chunk_paths: bool = False


class ParquetDatasetFactory(DatasetFactory):
    """A dataset from a Parquet _metadata file (reference: discovery.h
    ParquetDatasetFactory)."""

    def __init__(self, metadata_path, filesystem=None, format=None,
                 options: Optional[ParquetFactoryOptions] = None):
        super().__init__(lambda: parquet_dataset(metadata_path))
