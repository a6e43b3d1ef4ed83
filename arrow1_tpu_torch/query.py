"""Fluent query API over tables (counterpart of arrow1_tpu/query.py).

The user-facing composition layer: a Table's batches stream through
filter (K2 per batch), join, projection and a streaming group_by, then one
sort and limit:

    pt.query(table).filter(pt.field("year") == 2021)
                   .select(["k", "v"])
                   .group_by(["k"], [("v", "sum")])
                   .order_by([("v_sum", "descending")])
                   .to_table()

It runs on the device of the source's tensors. A dataset source
(``dataset.FileSystemDataset``) is scanned onto ``device`` (CUDA unless
the caller names the CPU) with the filter pushed into the scan and into
partition pruning, and a plain column selection into the readers, as the
reference does. A join builds the right side's hash table once and
probes it batch by batch (``ops.join.BuiltJoin``); the build side's rows
of a right or full outer, right semi or right anti join come once, after
the last batch.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

from .errors import Invalid
from .expr import Expression
from .table import RecordBatch, Table, concat_batches

__all__ = ["Query", "query"]


class Query:
    def __init__(self, source, device=None):
        self._source = source
        self._device = device
        self._filter: Optional[Expression] = None
        self._columns: Optional[List[str]] = None
        self._projection: Optional[List[Tuple[Expression, str]]] = None
        self._group: Optional[Tuple[List[str], List[Tuple[str, str]]]] = None
        self._order: Optional[List[Tuple[str, str]]] = None
        self._join: Optional[Tuple] = None
        self._limit: Optional[int] = None

    # -- builders --
    def filter(self, expr: Expression) -> "Query":
        self._filter = expr if self._filter is None else \
            (self._filter & expr)
        return self

    def select(self, columns: Sequence[str]) -> "Query":
        self._columns = list(columns)
        return self

    def project(self, exprs: Sequence[Expression],
                names: Sequence[str]) -> "Query":
        self._projection = list(zip(exprs, names))
        return self

    def join(self, right, keys, right_keys=None,
             join_type: str = "inner") -> "Query":
        self._join = (right, keys, right_keys, join_type)
        return self

    def group_by(self, keys: Sequence[str],
                 aggregates: Sequence[Tuple[str, str]]) -> "Query":
        self._group = (list(keys), list(aggregates))
        return self

    def order_by(self, sort_keys) -> "Query":
        self._order = [(k, "ascending") if isinstance(k, str) else k
                       for k in sort_keys]
        return self

    def limit(self, n: int) -> "Query":
        self._limit = n
        return self

    # -- execution --
    def _source_batches(self) -> Tuple[List[RecordBatch], bool]:
        """The source's batches, and whether the filter already ran."""
        from .dataset import FileSystemDataset, ScannerBuilder

        src = self._source
        if isinstance(src, FileSystemDataset):
            b = ScannerBuilder(src).device(self._device)
            if self._filter is not None:
                b = b.filter(self._filter)   # pushdown, pruning included
            if self._columns and self._join is None and \
                    self._group is None and self._projection is None:
                b = b.project(self._columns)
            return list(b.finish().scan_batches()), True
        if isinstance(src, Table):
            return list(src.batches), False
        if isinstance(src, RecordBatch):
            return [src], False
        raise Invalid(f"unsupported query source {type(src).__name__}: a "
                      "Table, a RecordBatch or a dataset")

    def to_table(self) -> Table:
        from .registry import call_function

        batches, filtered = self._source_batches()
        if not batches:
            raise Invalid("query produced no batches")
        joiner = None
        if self._join is not None:
            from .ops.join import BuiltJoin

            right, keys, right_keys, join_type = self._join
            rb = right.combine_chunks() if isinstance(right, Table) \
                else right
            joiner = BuiltJoin(rb, keys, right_keys, join_type)
        joined: List[RecordBatch] = []
        for batch in batches:
            if self._filter is not None and not filtered:
                mask = self._filter.execute(batch)
                batch = call_function("filter", [batch, mask])
            if joiner is not None:
                batch = joiner.probe(batch)
            if batch is not None:
                joined.append(batch)
        tail = joiner.finish() if joiner is not None else None
        if tail is not None:
            joined.append(tail)
        out = [self._shape(b) for b in joined]

        if self._group is not None:
            from .exec.streaming import StreamingGroupBy

            keys, aggs = self._group
            gb = StreamingGroupBy(keys, aggs)
            for b in out:
                gb.consume(b)
            out = [gb.finalize()]

        result = concat_batches(out) if len(out) > 1 else out[0]
        if self._order is not None:
            from .exec.plan import sort_batch

            result = sort_batch(result, self._order)
        if self._limit is not None:
            result = result.slice(0, self._limit)
        return Table([result])

    def _shape(self, batch: RecordBatch) -> RecordBatch:
        """The projection, or the selected columns, of one batch."""
        if self._projection is not None:
            cols = tuple(e.execute(batch) for e, _ in self._projection)
            return RecordBatch(cols, tuple(n for _, n in self._projection))
        if self._columns is not None and \
                set(self._columns) <= set(batch.names):
            return batch.select(self._columns)
        return batch

    def to_batch(self) -> RecordBatch:
        return self.to_table().combine_chunks()

    def count_rows(self) -> int:
        return self.to_table().num_rows


def query(source, device=None) -> Query:
    """Start a query over a Table, a RecordBatch or a dataset; a dataset
    is scanned onto ``device`` (CUDA unless the caller names the CPU)."""
    return Query(source, device)
