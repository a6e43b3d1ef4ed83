"""Push-model execution plan (counterpart of arrow1_tpu/exec/plan.py).

Reference: cpp/src/arrow/compute/exec/exec_plan.h:142-225 -- ExecNode's
InputReceived/InputFinished/StartProducing protocol with topo-sorted
startup (exec_plan.cc:62-79):

    source -> [filter] -> [project] -> [aggregate|join|order_by] -> sink

Batches flow eagerly as device-resident RecordBatches; pipeline breakers
(aggregate, order_by, the join's build side) accumulate state and flush on
input_finished, the consume/merge/finalize shape of kernel.h:637-676.

The join concatenates its build batches and builds them once
(``ops.join.BuiltJoin``); each probe batch is probed against that one
hash table.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..errors import Invalid
from ..expr import Expression
from ..table import RecordBatch, Table, concat_batches

__all__ = ["ExecPlan", "ExecNode", "Declaration", "source_node",
           "filter_node", "project_node", "aggregate_node", "join_node",
           "order_by_node", "union_node", "sink_node"]


class ExecNode:
    """Reference: exec_plan.h:84."""

    def __init__(self, plan: "ExecPlan", label: str,
                 inputs: Sequence["ExecNode"]):
        self.plan = plan
        self.label = label
        self.inputs = list(inputs)
        self.outputs: List[ExecNode] = []
        for i in inputs:
            i.outputs.append(self)
        plan.nodes.append(self)

    # push protocol
    def start_producing(self):
        pass

    def input_received(self, input_node: "ExecNode", batch: RecordBatch,
                       seq: int):
        raise NotImplementedError

    def input_finished(self, input_node: "ExecNode", total_batches: int):
        raise NotImplementedError

    def _emit(self, batch: RecordBatch, seq: int):
        for out in self.outputs:
            out.input_received(self, batch, seq)

    def _finish(self, total: int):
        for out in self.outputs:
            out.input_finished(self, total)


class ExecPlan:
    """Reference: exec_plan.h:39. run() starts every inner node first and
    the sources last (exec_plan.cc:62-79 starts producers after their
    consumers are ready)."""

    def __init__(self):
        self.nodes: List[ExecNode] = []

    def run(self) -> None:
        sinks = [n for n in self.nodes if not n.outputs]
        if not sinks:
            raise Invalid("plan has no sink")
        for n in self.nodes:
            if n.inputs:
                n.start_producing()
        for n in self.nodes:
            if not n.inputs:
                n.start_producing()


class SourceNode(ExecNode):
    """Emits batches from an iterable (a Table's batches, a list, ...)."""

    def __init__(self, plan, batches, label="source"):
        super().__init__(plan, label, [])
        self.batches = batches

    def start_producing(self):
        count = 0
        for i, b in enumerate(self.batches):
            self._emit(b, i)
            count += 1
        self._finish(count)


class FilterNode(ExecNode):
    """Reference protocol + FilterSingleBatch semantics
    (dataset/scanner_internal.h:41-70): one K2 compaction per batch."""

    def __init__(self, plan, input_node, predicate: Expression,
                 label="filter"):
        super().__init__(plan, label, [input_node])
        self.predicate = predicate

    def input_received(self, _, batch, seq):
        from ..registry import call_function

        mask = self.predicate.execute(batch)
        self._emit(call_function("filter", [batch, mask]), seq)

    def input_finished(self, _, total):
        self._finish(total)


def broadcast_scalar(v, batch: RecordBatch):
    """A Scalar as a column of the batch's length on the batch's device
    (the data of a null scalar included, as in the reference)."""
    from ..column import Column

    dev = batch.columns[0].device if batch.columns else torch.device("cpu")
    if v.dtype.is_decimal:   # every limb, the null scalar's as 0
        from ..ops.decimal import decimal_planes

        lo, hi = decimal_planes(v, v.dtype, batch.num_rows, dev)
        return Column(lo, v.dtype, data2=hi)
    fill = v.value
    if isinstance(fill, torch.Tensor):
        data = fill.to(dev, v.dtype.physical_dtype()).reshape(1).expand(
            batch.num_rows).clone()
    else:
        data = torch.full((batch.num_rows,), fill,
                          dtype=v.dtype.physical_dtype(), device=dev)
    return Column(data, v.dtype, dictionary=v.dictionary)


class ProjectNode(ExecNode):
    """Reference: ProjectSingleBatch (scanner_internal.h:72-97)."""

    def __init__(self, plan, input_node, exprs: Sequence[Expression],
                 names: Sequence[str], label="project"):
        super().__init__(plan, label, [input_node])
        self.exprs = list(exprs)
        self.names = list(names)

    def input_received(self, _, batch, seq):
        from ..datum import Scalar

        cols = []
        for e in self.exprs:
            v = e.execute(batch)
            if isinstance(v, Scalar):  # broadcast literal column
                v = broadcast_scalar(v, batch)
            cols.append(v)
        self._emit(RecordBatch(tuple(cols), tuple(self.names)), seq)

    def input_finished(self, _, total):
        self._finish(total)


class AggregateNode(ExecNode):
    """Pipeline breaker: streams batches into consume-state, finalizes on
    input_finished (kernel.h:655 HashAggregateKernel shape)."""

    def __init__(self, plan, input_node, keys, aggregates, label="aggregate"):
        super().__init__(plan, label, [input_node])
        self.keys = list(keys)
        self.aggregates = list(aggregates)
        from .streaming import StreamingGroupBy

        self._state = StreamingGroupBy(self.keys, self.aggregates)

    def input_received(self, _, batch, seq):
        self._state.consume(batch)

    def input_finished(self, _, total):
        result = self._state.finalize()
        self._emit(result, 0)
        self._finish(1)


class JoinNode(ExecNode):
    """Hash join: the build side (input 1) accumulates and is built once
    (``ops.join.BuiltJoin``) when it has finished; probe batches that
    arrive before that wait, and are joined in order once it has. The
    build side's rows of a right or full outer, right semi or right anti
    join follow the last probe batch."""

    def __init__(self, plan, probe, build, keys, right_keys=None,
                 join_type="inner", label="join"):
        super().__init__(plan, label, [probe, build])
        self.keys = keys
        self.right_keys = right_keys
        self.join_type = join_type
        self._build: List[RecordBatch] = []
        self._joiner = None
        self._probe_pending: List[Tuple[RecordBatch, int]] = []
        self._probe_total: Optional[int] = None

    def input_received(self, node, batch, seq):
        if node is self.inputs[1]:
            self._build.append(batch)
            return
        if self._joiner is None:
            self._probe_pending.append((batch, seq))
            return
        self._probe(batch, seq)

    def _probe(self, batch, seq):
        out = self._joiner.probe(batch)
        if out is not None:
            self._emit(out, seq)

    def _done(self):
        tail = self._joiner.finish()
        if tail is not None:
            self._emit(tail, self._probe_total)
        self._finish(self._probe_total + (tail is not None))

    def input_finished(self, node, total):
        if node is self.inputs[1]:
            from ..ops.join import BuiltJoin

            if not self._build:
                raise Invalid("join: empty build side")
            self._joiner = BuiltJoin(concat_batches(self._build), self.keys,
                                     self.right_keys, self.join_type)
            for batch, seq in self._probe_pending:
                self._probe(batch, seq)
            self._probe_pending.clear()
            if self._probe_total is not None:
                self._done()
            return
        self._probe_total = total
        if self._joiner is not None:
            self._done()


def sort_batch(batch: RecordBatch, sort_keys) -> RecordBatch:
    """The batch's rows in ``sort_indices`` order (stable, nulls last)."""
    from ..ops.selection import take_column
    from ..registry import call_function

    idx = call_function("sort_indices", [batch], sort_keys=list(sort_keys))
    perm = idx.data.view(torch.int64)
    return RecordBatch(tuple(take_column(c, perm) for c in batch.columns),
                       batch.names)


class OrderByNode(ExecNode):
    """Pipeline breaker: accumulate, sort on finish (Table sort semantics,
    vector_sort.cc:1417)."""

    def __init__(self, plan, input_node, sort_keys, label="order_by"):
        super().__init__(plan, label, [input_node])
        self.sort_keys = list(sort_keys)
        self._batches: List[RecordBatch] = []

    def input_received(self, _, batch, seq):
        self._batches.append(batch)

    def input_finished(self, _, total):
        self._emit(sort_batch(concat_batches(self._batches),
                              self.sort_keys), 0)
        self._finish(1)


class SinkNode(ExecNode):
    """Collects output batches (ordered by seq) into a Table."""

    def __init__(self, plan, input_node, label="sink"):
        super().__init__(plan, label, [input_node])
        self._batches: Dict[int, RecordBatch] = {}
        self.result: Optional[Table] = None

    def input_received(self, _, batch, seq):
        self._batches[seq] = batch

    def input_finished(self, _, total):
        ordered = [self._batches[k] for k in sorted(self._batches)]
        self.result = Table(ordered) if ordered else None


class UnionNode(ExecNode):
    """Multi-input stream merge (reference: exec/union_node.cc): emits
    every input's batches; finishes when ALL inputs finish. Output order
    = input order (sequenced), matching the reference's ordered union."""

    def __init__(self, plan, input_nodes, label="union"):
        super().__init__(plan, label, list(input_nodes))
        self._pending = {id(n): None for n in input_nodes}
        self._buffers: Dict[int, List[RecordBatch]] = {
            id(n): [] for n in input_nodes}

    def input_received(self, node, batch, seq):
        self._buffers[id(node)].append(batch)

    def input_finished(self, node, total):
        self._pending[id(node)] = total
        if any(v is None for v in self._pending.values()):
            return
        seq = 0
        for n in self.inputs:
            for b in self._buffers[id(n)]:
                self._emit(b, seq)
                seq += 1
        self._finish(seq)


# ---- factory helpers (reference: ExecNode registry MakeExecNode) ----

def source_node(plan, batches):
    return SourceNode(plan, batches)


def filter_node(plan, input_node, predicate):
    return FilterNode(plan, input_node, predicate)


def project_node(plan, input_node, exprs, names):
    return ProjectNode(plan, input_node, exprs, names)


def aggregate_node(plan, input_node, keys, aggregates):
    return AggregateNode(plan, input_node, keys, aggregates)


def join_node(plan, probe, build, keys, right_keys=None, join_type="inner"):
    return JoinNode(plan, probe, build, keys, right_keys, join_type)


def order_by_node(plan, input_node, sort_keys):
    return OrderByNode(plan, input_node, sort_keys)


def union_node(plan, input_nodes):
    return UnionNode(plan, input_nodes)


def sink_node(plan, input_node):
    return SinkNode(plan, input_node)


@dataclasses.dataclass
class Declaration:
    """Composable plan fragment (factory name + options, chained into a
    plan; the convenience layer later Arrow calls Declaration)."""

    factory: str
    options: dict
    inputs: Sequence["Declaration"] = ()

    def to_table(self) -> Table:
        plan = ExecPlan()
        node = self._build(plan)
        sink = sink_node(plan, node)
        plan.run()
        return sink.result

    def _build(self, plan) -> ExecNode:
        ins = [d._build(plan) for d in self.inputs]
        f = self.factory
        if f == "source":
            return source_node(plan, **self.options)
        if f == "filter":
            return filter_node(plan, ins[0], **self.options)
        if f == "project":
            return project_node(plan, ins[0], **self.options)
        if f == "aggregate":
            return aggregate_node(plan, ins[0], **self.options)
        if f == "join":
            return join_node(plan, ins[0], ins[1], **self.options)
        if f == "order_by":
            return order_by_node(plan, ins[0], **self.options)
        raise Invalid(f"unknown node factory {f!r}")
