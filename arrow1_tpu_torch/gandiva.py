"""Gandiva's projector and filter API (counterpart of
arrow1_tpu/gandiva.py).

Reference: cpp/src/gandiva/ compiles an expression tree with LLVM into
one loop a batch: a Projector materializes its outputs (projector.h:41)
and a Filter gives a SelectionVector of the rows that pass (filter.h:66,
selection_vector.h:32). The JAX package traces the same trees with
``jax.jit``. Here an expression runs eagerly through the registered
kernels on the batch's device, as ``query()``'s do; what this module
keeps is Gandiva's shape: bind once against a schema, then evaluate
batch after batch. The selection is ``ops.padded.filter_padded``'s
padded positions and their count, left on the device until a caller
needs the count.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import dtypes as dt
from .column import Column
from .errors import Invalid
from .expr import Expression
from .table import RecordBatch

__all__ = ["Projector", "Filter", "SelectionVector", "make_projector",
           "make_filter"]


def _schema_names(schema) -> Sequence[str]:
    """Column names of a schema: a RecordBatch or anything with
    ``names``, (name, type) pairs, or names."""
    if hasattr(schema, "names"):
        return list(schema.names)
    return [s if isinstance(s, str) else s[0] for s in schema]


class SelectionVector:
    """The positions of the rows that passed (reference:
    gandiva/selection_vector.h:32): ``indices`` padded to the batch's
    length and ``count``, a 0-d tensor on their device."""

    def __init__(self, indices: torch.Tensor, count: torch.Tensor):
        self.indices = indices
        self.count = count

    def __len__(self):
        return int(self.count)

    def to_column(self) -> Column:
        """The positions as a uint64 column (Gandiva's UINT64 mode)."""
        return Column(self.indices[:len(self)].view(torch.uint64),
                      dt.uint64)


class Projector:
    """A multi-expression projector (reference: projector.h:41)."""

    def __init__(self, schema, exprs: Sequence[Expression],
                 names: Sequence[str]):
        self.schema = schema
        bound = _schema_names(schema)
        self.exprs = [e.bind(bound) for e in exprs]
        self.names = list(names)

    def evaluate(self, batch: RecordBatch,
                 selection: Optional[SelectionVector] = None
                 ) -> RecordBatch:
        if selection is not None:
            batch = _apply_selection(batch, selection)
        return RecordBatch(tuple(e.execute(batch) for e in self.exprs),
                           tuple(self.names))


class Filter:
    """A predicate to a SelectionVector (reference: filter.h:66)."""

    def __init__(self, schema, predicate: Expression):
        self.schema = schema
        self.predicate = predicate.bind(_schema_names(schema))

    def evaluate(self, batch: RecordBatch) -> SelectionVector:
        from .ops.padded import filter_padded

        mask = self.predicate.execute(batch)
        if not isinstance(mask, Column) or not mask.dtype.is_boolean:
            raise Invalid("filter expression must yield booleans")
        selected = mask.data if mask.validity is None else \
            mask.data & mask.validity
        return SelectionVector(*filter_padded(selected))


def _apply_selection(batch: RecordBatch, sel: SelectionVector
                     ) -> RecordBatch:
    """The selected rows (one host read of the count)."""
    from .ops.selection import take_column

    idx = sel.indices[:len(sel)]
    return RecordBatch(tuple(take_column(c, idx) for c in batch.columns),
                       batch.names)


def make_projector(schema, exprs_and_names) -> Projector:
    """Reference: Projector::Make (projector.h)."""
    return Projector(schema, [e for e, _ in exprs_and_names],
                     [n for _, n in exprs_and_names])


def make_filter(schema, predicate: Expression) -> Filter:
    """Reference: Filter::Make (filter.h:66)."""
    return Filter(schema, predicate)
