"""pyarrow.acero-shaped Declaration API (counterpart of
arrow1_tpu/acero.py).

Reference: the streaming exec engine's declarative layer
(cpp/src/arrow/compute/exec/exec_plan.h Declaration and the options
classes pyarrow surfaces as pyarrow.acero). Names and shapes match
pyarrow.acero so that plans port verbatim; a Declaration runs on the
device of its source's tensors. ``ScanNodeOptions`` holds a dataset and
its scan options, as the reference's does; like the reference,
``Declaration`` has no ``scan`` factory.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

from .column import Column
from .datum import Scalar
from .errors import Invalid
from .expr import Expression, field  # noqa: F401  (pyarrow.acero's tail)
from .table import RecordBatch, Table, concat_batches

__all__ = ["Declaration", "ExecNodeOptions", "TableSourceNodeOptions",
           "FilterNodeOptions", "ProjectNodeOptions",
           "AggregateNodeOptions", "HashJoinNodeOptions",
           "OrderByNodeOptions", "AsofJoinNodeOptions", "ScanNodeOptions",
           "ds"]


class ExecNodeOptions:
    pass


@dataclasses.dataclass
class TableSourceNodeOptions(ExecNodeOptions):
    table: object = None


@dataclasses.dataclass
class FilterNodeOptions(ExecNodeOptions):
    filter_expression: object = None


@dataclasses.dataclass
class ProjectNodeOptions(ExecNodeOptions):
    expressions: Sequence = ()
    names: Optional[Sequence[str]] = None


@dataclasses.dataclass
class AggregateNodeOptions(ExecNodeOptions):
    aggregates: Sequence = ()
    keys: Optional[Sequence[str]] = None


@dataclasses.dataclass
class HashJoinNodeOptions(ExecNodeOptions):
    join_type: str = "inner"
    left_keys: Sequence[str] = ()
    right_keys: Sequence[str] = ()
    left_output: Optional[Sequence[str]] = None
    right_output: Optional[Sequence[str]] = None
    output_suffix_for_left: str = ""
    output_suffix_for_right: str = ""


@dataclasses.dataclass
class OrderByNodeOptions(ExecNodeOptions):
    sort_keys: Sequence = ()


@dataclasses.dataclass
class AsofJoinNodeOptions(ExecNodeOptions):
    left_on: str = ""
    left_by: Sequence[str] = ()
    right_on: str = ""
    right_by: Sequence[str] = ()
    tolerance: int = 0


def _scalar_column(s: Scalar, device) -> Column:
    """A scalar aggregate's result as a one-row column (a null one when
    the scalar is null)."""
    if s.dtype.is_decimal:
        from .ops.decimal import decimal_planes

        lo, hi = decimal_planes(s, s.dtype, 1, device)
        return Column(lo, s.dtype, data2=hi, validity=None if s.is_valid
                      else torch.zeros(1, dtype=torch.bool, device=device))
    phys = s.dtype.physical_dtype()
    if not s.is_valid:
        return Column(torch.zeros(1, dtype=phys, device=device), s.dtype,
                      validity=torch.zeros(1, dtype=torch.bool,
                                           device=device))
    v = s.value
    data = v.to(device, phys).reshape(1) if isinstance(v, torch.Tensor) \
        else torch.tensor([v], dtype=phys, device=device)
    return Column(data, s.dtype, dictionary=s.dictionary)


class Declaration:
    """pyarrow.acero.Declaration shape: (factory_name, options, inputs);
    chain with from_sequence; materialize with to_table()."""

    def __init__(self, factory_name: str, options: ExecNodeOptions,
                 inputs: Optional[Sequence["Declaration"]] = None):
        self.factory_name = factory_name
        self.options = options
        self.inputs = list(inputs or [])

    @staticmethod
    def from_sequence(decls: Sequence["Declaration"]) -> "Declaration":
        decls = list(decls)
        head = decls[0]
        for d in decls[1:]:
            d.inputs = [head] + list(d.inputs)
            head = d
        return head

    def to_table(self) -> Table:
        return Table([self.to_batch()])

    def to_batch(self) -> RecordBatch:
        return self._run()

    def to_reader(self):
        return iter([self._run()])

    def _run(self) -> RecordBatch:
        from .exec.plan import broadcast_scalar, sort_batch
        from .registry import call_function

        f, o = self.factory_name, self.options
        if f == "table_source":
            t = o.table
            return t.combine_chunks() if isinstance(t, Table) else t
        if f == "filter":
            src = self.inputs[0]._run()
            mask = o.filter_expression.bind(src.names).execute(src)
            return call_function("filter", [src, mask])
        if f == "project":
            src = self.inputs[0]._run()
            names = list(o.names) if o.names else \
                [repr(e) for e in o.expressions]
            cols = []
            for e in o.expressions:
                v = e.bind(src.names).execute(src)
                cols.append(v if isinstance(v, Column)
                            else broadcast_scalar(v, src))
            return RecordBatch(tuple(cols), tuple(names))
        if f == "aggregate":
            src = self.inputs[0]._run()
            aggs = [(a[0], a[1]) for a in o.aggregates]
            if o.keys:
                from .ops.groupby import group_by

                return group_by(src, list(o.keys), aggs)
            dev = src.columns[0].device if src.columns else \
                torch.device("cpu")
            cols = [_scalar_column(call_function(fn, [src.column(c)]), dev)
                    for c, fn in aggs]
            return RecordBatch(tuple(cols),
                               tuple(f"{c}_{fn}" for c, fn in aggs))
        if f == "hashjoin":
            from .ops.join import join

            left = self.inputs[0]._run()
            right = self.inputs[1]._run()
            return join(left, right, keys=list(o.left_keys),
                        right_keys=list(o.right_keys) or None,
                        join_type=o.join_type,
                        left_suffix=o.output_suffix_for_left,
                        right_suffix=o.output_suffix_for_right)
        if f == "asofjoin":
            from .ops.join import join_asof

            left = self.inputs[0]._run()
            right = self.inputs[1]._run()
            return join_asof(left, right, on=o.left_on,
                             by=list(o.left_by) or None,
                             tolerance=o.tolerance)
        if f == "order_by":
            return sort_batch(self.inputs[0]._run(), o.sort_keys)
        if f == "union":
            return concat_batches([d._run() for d in self.inputs])
        raise Invalid(f"unknown acero factory {self.factory_name!r}")

    def __repr__(self):
        return f"Declaration({self.factory_name!r})"


# ---- pyarrow.acero's module tail ----
from . import dataset as ds  # noqa: E402,F401


class ScanNodeOptions(ExecNodeOptions):
    """pyarrow.acero.ScanNodeOptions: a dataset and its scan options."""

    def __init__(self, dataset, **kwargs):
        self.dataset = dataset
        self.scan_kwargs = kwargs
