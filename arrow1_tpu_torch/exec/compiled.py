"""Compiled pipeline: a whole query as one static-capacity plan
(counterpart of arrow1_tpu/exec/compiled.py).

Every operator works on capacity-padded columns and a live-row mask, so a
chain filter -> project -> join -> group_by -> sort -> limit runs with no
host round-trip between operators. PyTorch runs eagerly, so "compiled" means
exactly that plan: the only host sync is the overflow check at the end,
before the live rows are materialized through the compaction kernel
(kernels/compaction.py, K2). Capturing the plan in a CUDA graph is later
work.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..expr import Expression
from ..kernels.radix import (decode_packed_key, field_of, minimal_sort_keys,
                             sort_key_decodable, sort_rows)
from ..ops import selection
from ..ops.aggregate import _as_type, _sum_output_type
from ..ops.join import key_planes, key_validity
from ..ops.padded import (group_sort_padded, join_padded, seg_diff_lo,
                          seg_float_sum, seg_minmax_plane, seg_sum_plane,
                          seg_values_at_ends)
from ..table import RecordBatch, record_batch

__all__ = ["PipelineBuilder", "CompiledPipeline"]


@dataclasses.dataclass
class _State:
    batch: RecordBatch       # capacity-padded columns
    live: torch.Tensor       # bool[capacity]
    overflow: torch.Tensor   # bool scalar accumulator
    all_live: bool = False   # no op so far creates dead rows

    @property
    def capacity(self) -> int:
        return self.batch.num_rows


def _masked_batch(batch: RecordBatch, live) -> RecordBatch:
    """Fold the live mask into column validities (for expression eval)."""
    cols = tuple(
        Column(c.data, c.dtype,
               validity=live if c.validity is None else (c.validity & live),
               dictionary=c.dictionary, data2=c.data2)
        for c in batch.columns)
    return RecordBatch(cols, batch.names)


def _minmax_init(t: dt.DataType, is_min: bool):
    if t.is_floating:
        return float("inf") if is_min else float("-inf")
    if t.is_boolean:
        return is_min
    info = torch.iinfo(t.physical_dtype())
    return info.max if is_min else info.min


class PipelineBuilder:
    """Chainable builder; ``.compile()`` returns a CompiledPipeline."""

    def __init__(self):
        self._ops: List[Tuple] = []

    def filter(self, predicate: Expression) -> "PipelineBuilder":
        self._ops.append(("filter", predicate))
        return self

    def project(self, exprs: Sequence[Expression], names: Sequence[str],
                keep_existing: bool = True) -> "PipelineBuilder":
        self._ops.append(("project", list(exprs), list(names),
                          keep_existing))
        return self

    def join(self, build: RecordBatch, keys, right_keys=None,
             fanout: int = 4, join_type: str = "inner"
             ) -> "PipelineBuilder":
        """Equi-join against a pre-built build side. join_type: "inner" or
        "left outer". Output capacity = probe capacity * fanout; more
        matches set the overflow flag."""
        if join_type not in ("inner", "left outer"):
            raise Invalid(f"compiled join: unsupported join_type "
                          f"{join_type!r} (inner / left outer)")
        self._ops.append(("join", build,
                          [keys] if isinstance(keys, str) else list(keys),
                          right_keys, fanout, join_type))
        return self

    def group_by(self, keys: Sequence[str],
                 aggregates: Sequence[Tuple[str, str]],
                 max_groups: int = 65536) -> "PipelineBuilder":
        """Hash aggregate. ``max_groups`` is the static output capacity;
        more distinct groups set the overflow flag."""
        self._ops.append(("group_by", list(keys), list(aggregates),
                          int(max_groups)))
        return self

    def sort(self, sort_keys: Sequence[Tuple[str, str]]
             ) -> "PipelineBuilder":
        self._ops.append(("sort", list(sort_keys)))
        return self

    def limit(self, n: int) -> "PipelineBuilder":
        self._ops.append(("limit", n))
        return self

    def compile(self) -> "CompiledPipeline":
        return CompiledPipeline(self._ops)


class CompiledPipeline:
    def __init__(self, ops: List[Tuple]):
        self._ops = ops

    def _trace(self, batch: RecordBatch):
        """Run the plan; returns (padded batch, live mask, overflow flag)
        with no host sync."""
        n = batch.num_rows
        dev = batch.columns[0].device
        state = _State(batch, torch.ones(n, dtype=torch.bool, device=dev),
                       torch.zeros((), dtype=torch.bool, device=dev),
                       all_live=True)
        for op in self._ops:
            state = getattr(self, "_op_" + op[0])(state, *op[1:])
        return state.batch, state.live, state.overflow

    def _op_filter(self, state: _State, predicate: Expression) -> _State:
        mask = predicate.execute(_masked_batch(state.batch, state.live))
        sel = mask.data if mask.validity is None else \
            (mask.data & mask.validity)
        return _State(state.batch, state.live & sel, state.overflow,
                      all_live=False)

    def _op_project(self, state: _State, exprs, names, keep) -> _State:
        src = _masked_batch(state.batch, state.live)
        cols, out_names = ([], [])
        if keep:
            cols = list(state.batch.columns)
            out_names = list(state.batch.names)
        for e, name in zip(exprs, names):
            v = e.execute(src)
            if name in out_names:
                cols[out_names.index(name)] = v
            else:
                cols.append(v)
                out_names.append(name)
        return _State(RecordBatch(tuple(cols), tuple(out_names)),
                      state.live, state.overflow, all_live=state.all_live)

    def _op_join(self, state: _State, build: RecordBatch, keys, right_keys,
                 fanout, join_type="inner") -> _State:
        """Static-capacity join (ops/padded.join_padded): the probe rows
        are the live rows of the state; the output's live mask is the
        valid pairs."""
        right_keys = list(right_keys or keys)
        probe = state.batch
        pk_parts, bk_parts = [], []
        for lk, rk in zip(keys, right_keys):
            lkeys, rkeys = key_planes(probe.column(lk), build.column(rk))
            if len(lkeys) == 2:   # class planes (0, NaN 1, null 2) as uint8
                lkeys[0] = lkeys[0].to(torch.uint8)
                rkeys[0] = rkeys[0].to(torch.uint8)
            pk_parts.append(lkeys)
            bk_parts.append(rkeys)
        # exact matching over every normalized plane; a lone u64 key rides
        # join_padded's single-plane form
        if len(keys) == 1 and len(pk_parts[0]) == 1:
            pk, bk = pk_parts[0][0], bk_parts[0][0]
        else:
            pk = [c for comps in pk_parts for c in comps]
            bk = [c for comps in bk_parts for c in comps]
        outer = join_type == "left outer"
        pidx, bidx, pair_valid, pair_has_match, _, _, ovf = join_padded(
            pk, bk, key_validity(probe, keys),
            key_validity(build, right_keys), state.capacity * fanout,
            outer=outer, probe_live=state.live)
        left = selection.gather_batch(probe, pidx)
        cols, names = list(left.columns), list(left.names)
        rkeyset = set(right_keys)
        rpay = [(n, c) for n, c in zip(build.names, build.columns)
                if n not in rkeyset]
        if rpay:
            right = selection.gather_batch(
                RecordBatch(tuple(c for _, c in rpay),
                            tuple(n for n, _ in rpay)), bidx,
                pair_has_match if outer else None)
            cols += list(right.columns)
            names += list(right.names)
        return _State(RecordBatch(tuple(cols), tuple(names)), pair_valid,
                      state.overflow | ovf, all_live=False)

    def _op_group_by(self, state: _State, keys, aggregates,
                     max_groups: int = 65536) -> _State:
        """Sorted-space hash aggregate with static output capacity: one
        stable sort of the packed keys (aggregate inputs ride as
        payloads), cumsum-diff (integers) and flagged-scan segment
        reductions read at the segment ends, per-segment float sums, and
        key columns decoded from the sorted words at the group starts.
        Groups come out in key order."""
        n = state.capacity
        dev = state.live.device
        G = max(min(int(max_groups), n), 1)
        key_pairs: List = []
        key_spans: List[Tuple[int, int]] = []   # (first pair idx, count)
        for k in keys:
            prs = minimal_sort_keys(state.batch.column(k))
            key_spans.append((len(key_pairs), len(prs)))
            key_pairs.extend(prs)

        payloads: List[torch.Tensor] = []

        def add(x) -> int:
            payloads.append(x)
            return len(payloads) - 1

        agg_slots = []   # (data_i, valid_i or None)
        seen: Dict[str, Tuple] = {}
        for cname, fn in aggregates:
            col = state.batch.column(cname)
            if cname not in seen:
                seen[cname] = (add(col.data), None if col.validity is None
                               else add(col.validity))
            agg_slots.append(seen[cname])
        for k in keys:
            if not sort_key_decodable(state.batch.column(k)):
                raise Invalid(f"compiled group_by: key {k!r} is not "
                              "decodable from its sort key")

        sg, sorted_p, swords, places, words_at_start = group_sort_padded(
            key_pairs, None if state.all_live else state.live, payloads, G)

        # aggregate tails in two phases: full-length cumsum / scan planes
        # (integer sums and counts, min/max/any/all), then ONE batched read
        # at the segment ends, then G-sized arithmetic. Float sums are [G]
        # results at once: each group adds its own rows (seg_float_sum)
        end_planes: List[torch.Tensor] = []

        def want(p) -> Tuple[str, int]:
            end_planes.append(p)
            return ("plane", len(end_planes) - 1)

        def sum_ref(x, mask_s, acc_dt) -> Tuple:
            if acc_dt == torch.float64:
                return ("direct", seg_float_sum(x, mask_s, sg))
            return want(seg_sum_plane(x, mask_s, sg, acc_dt))

        arith_vcount = None
        if state.all_live:   # no dead rows: count = segment length
            arith_vcount = torch.where(sg.group_valid,
                                       sg.endpos - sg.startpos + 1, 0)
        vcount_plane: Dict = {}

        def count_ref(mask_s):
            return want(seg_sum_plane(
                torch.ones(n, dtype=torch.int64, device=dev), mask_s, sg,
                torch.int64))

        def vcount_ref(vi, mask_s):
            if mask_s is None and arith_vcount is not None:
                return ("direct", arith_vcount)
            if vi not in vcount_plane:
                vcount_plane[vi] = count_ref(mask_s)
            return vcount_plane[vi]

        recipes = []
        for (cname, fn), (di, vi) in zip(aggregates, agg_slots):
            col = state.batch.column(cname)
            if col.dtype.is_binary and fn != "count":
                raise Invalid(f"compiled group_by: {fn} over string column "
                              f"{cname!r} is not ported yet")
            xs = sorted_p[di]
            mask_s = None if vi is None else sorted_p[vi]
            if fn == "count":
                out_t = dt.int64
            elif fn in ("mean", "variance", "stddev"):
                out_t = dt.float64
            elif fn in ("any", "all"):
                out_t = dt.bool_
            elif fn in ("min", "max"):
                out_t = col.dtype
            elif fn == "sum":
                out_t = _sum_output_type(col.dtype)
            else:
                raise Invalid(f"compiled group_by: unsupported aggregate "
                              f"{fn!r}")
            vc = vcount_ref(vi, mask_s)
            acc_dt = torch.float64 if col.dtype.is_floating else torch.int64
            if fn == "count":
                extra = ()
            elif fn in ("sum", "mean"):
                extra = (sum_ref(xs, mask_s, acc_dt),)
            elif fn in ("min", "max"):
                init = _minmax_init(col.dtype, fn == "min")
                # NaN is skipped; a group of valid NaNs only gives NaN
                non_nan = None
                if col.dtype.is_floating:
                    ok = ~torch.isnan(xs)
                    non_nan = count_ref(ok if mask_s is None
                                        else ok & mask_s)
                extra = (want(seg_minmax_plane(xs, mask_s, sg, fn == "min",
                                               init)), init, non_nan)
            elif fn in ("variance", "stddev"):
                x = xs.to(torch.float64)
                extra = (sum_ref(x, mask_s, torch.float64),
                         sum_ref(x * x, mask_s, torch.float64))
            else:   # any / all
                extra = (want(seg_minmax_plane(xs != 0, mask_s, sg,
                                               fn == "all", fn == "all")),)
            recipes.append((cname, fn, out_t, vc, extra))

        ends = seg_values_at_ends(sg, end_planes) if end_planes else []

        def at_ends(ref):
            return ends[ref[1]]

        def value(ref):
            """A sum or count: a [G] result, or a plane's ends differenced."""
            kind, x = ref
            return x if kind == "direct" else seg_diff_lo(ends[x], sg)

        cols, names = [], []
        for cname, fn, out_t, vc, extra in recipes:
            vcount = value(vc)
            if fn == "count":
                acc = vcount
            elif fn == "sum":
                acc = value(extra[0])
            elif fn == "mean":
                acc = value(extra[0]).to(torch.float64) / vcount.clamp(
                    min=1).to(torch.float64)
            elif fn in ("min", "max"):
                acc = torch.where(sg.group_valid, at_ends(extra[0]),
                                  extra[1])
                if extra[2] is not None:
                    acc = torch.where((value(extra[2]) == 0) & (vcount > 0),
                                      float("nan"), acc)
            elif fn in ("variance", "stddev"):
                s1, s2 = value(extra[0]), value(extra[1])
                nv = vcount.clamp(min=1).to(torch.float64)
                mean = s1 / nv
                acc = (s2 / nv - mean * mean).clamp(min=0.0)
                if fn == "stddev":
                    acc = torch.sqrt(acc)
            else:   # any / all
                acc = torch.where(sg.group_valid, at_ends(extra[0]),
                                  fn == "all")
            validity = None if fn == "count" else \
                ((vcount > 0) & sg.group_valid)
            cols.append(Column(_as_type(acc, out_t), out_t,
                               validity=validity))
            names.append(f"{cname}_{fn}")
        for k, (p0, pcnt) in zip(keys, key_spans):
            col = state.batch.column(k)
            vals = []
            for pi in range(p0, p0 + pcnt):
                wi, shift, bits = places[pi]
                w = words_at_start[wi] if words_at_start is not None \
                    else swords[wi][sg.startpos]
                vals.append(field_of(w, shift, bits))
            data, validity = decode_packed_key(col, vals)
            cols.append(Column(data, col.dtype,
                               validity=None if validity is None
                               else (validity & sg.group_valid),
                               dictionary=col.dictionary))
            names.append(k)
        return _State(RecordBatch(tuple(cols), tuple(names)),
                      sg.group_valid, state.overflow | sg.overflow)

    def _op_sort(self, state: _State, sort_keys) -> _State:
        # the dead-row bit leads the packed key; rows are materialized in
        # sorted order, every column plane riding as a payload
        pairs = [((~state.live).to(torch.int64), 1)]
        for name, order in sort_keys:
            pairs.extend(minimal_sort_keys(state.batch.column(name), order))
        payloads = [state.live]
        layout = []   # has_validity per column
        for c in state.batch.columns:
            payloads.append(c.data)
            if c.validity is not None:
                payloads.append(c.validity)
            layout.append(c.validity is not None)
        sorted_ = sort_rows(pairs, payloads)
        live = sorted_[0]
        cols = []
        i = 1
        for c, has_v in zip(state.batch.columns, layout):
            data = sorted_[i]
            i += 1
            validity = None
            if has_v:
                validity = sorted_[i]
                i += 1
            cols.append(Column(data, c.dtype, validity=validity,
                               dictionary=c.dictionary))
        return _State(RecordBatch(tuple(cols), state.batch.names), live,
                      state.overflow, all_live=state.all_live)

    def _op_limit(self, state: _State, n: int) -> _State:
        live_rank = torch.cumsum(state.live, 0) - 1   # keep the first n live
        return _State(state.batch, state.live & (live_rank < n),
                      state.overflow, all_live=False)

    def __call__(self, batch, materialize: bool = True):
        """Run the pipeline on a RecordBatch (anything else is ingested
        with ``record_batch``, on CUDA). With ``materialize`` the live rows
        come back compacted through the K2 kernel; otherwise the padded
        batch and its live mask."""
        if not isinstance(batch, RecordBatch):
            batch = record_batch(batch)
        out_batch, live, overflow = self._trace(batch)
        if bool(overflow):
            raise Invalid("compiled pipeline: capacity overflow: raise "
                          "max_groups or the join fanout")
        if not materialize:
            return out_batch, live
        return selection.filter(out_batch, Column(live, dt.bool_))
