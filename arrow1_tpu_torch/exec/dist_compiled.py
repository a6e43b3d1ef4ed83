"""Distributed compiled pipeline: filter -> project -> join -> group_by ->
sort -> limit as one torch program per rank (counterpart of
arrow1_tpu/exec/dist_compiled.py).

The eager distributed operators (parallel/distributed.py) materialize
between operators. Here the shuffles and the per-rank padded operators
run back to back on each rank's state (padded arrays and a live mask)
with no host read between them: the overflow flags of every stage are
ORed on the device, and the host reads the all-reduced flag once, then
gathers the result (each rank's live rows compacted through K2). The
reference's one jitted ``shard_map`` program becomes this one program a
rank; its cache of jitted programs by input signature is not carried
over (there is nothing to compile).

Key matching is exact: the full normalized plane list rides join_padded's
merged sort-merge. The planes folded into 64 bits pick shuffle
destinations only, where a collision merely puts two keys on one rank.
Group-by groups on the full plane list too.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ..column import Column
from ..errors import Invalid
from ..expr import Expression
from ..ops.padded import grouping_padded, join_padded
from ..ops.sort import normalize_sort_key, sort_indices_device
from ..table import RecordBatch
from ..parallel.distributed import (_agg_type, _grouped_padded, _sharded,
                                    gather_live, read_flag)
from ..parallel.mesh import Mesh, all_gather_rows, make_mesh
from ..parallel.shuffle import FNV_MIX, any_rank, partition_ids, shuffle_shard

__all__ = ["DistPipelineBuilder", "DistCompiledPipeline"]


@dataclasses.dataclass
class _ColTemplate:
    dtype: object
    dictionary: object


def _flatten_batch(batch: RecordBatch):
    """RecordBatch -> (name -> tensor, name -> template); the decimal limbs
    above the lowest ride as ``e:name``."""
    arrays: Dict[str, torch.Tensor] = {}
    templates: Dict[str, _ColTemplate] = {}
    for name in batch.names:
        c = batch.column(name)
        arrays[f"d:{name}"] = c.data
        arrays[f"m:{name}"] = c.mask()
        if c.data2 is not None:
            arrays[f"e:{name}"] = c.data2
        templates[name] = _ColTemplate(c.dtype, c.dictionary)
    return arrays, templates


def _rebuild(arrays, templates, names, live=None) -> RecordBatch:
    """This rank's Columns from the flat dict (``live`` ANDed into the
    validity)."""
    cols = []
    for name in names:
        t = templates[name]
        validity = arrays[f"m:{name}"]
        if live is not None:
            validity = validity & live
        cols.append(Column(arrays[f"d:{name}"], t.dtype, validity=validity,
                           dictionary=t.dictionary,
                           data2=arrays.get(f"e:{name}")))
    return RecordBatch(tuple(cols), tuple(names))


def _norm_components(arrays, templates, name, order="ascending"):
    t = templates[name]
    col = Column(arrays[f"d:{name}"], t.dtype, validity=arrays[f"m:{name}"],
                 dictionary=t.dictionary, data2=arrays.get(f"e:{name}"))
    return normalize_sort_key(col, order)


def _fold_u64(components: List[torch.Tensor]) -> torch.Tensor:
    h = None
    for comp in components:
        c = comp.to(torch.int64)
        h = c if h is None else (h * FNV_MIX) ^ c
    return h


def _payload(arrays) -> Dict[str, torch.Tensor]:
    return {k: v for k, v in arrays.items() if k[:2] in ("d:", "m:", "e:")}


def _no_overflow(live):
    return torch.zeros((), dtype=torch.bool, device=live.device)


class DistPipelineBuilder:
    """Chainable builder of a distributed pipeline.

    Capacities are static: ``shuffle_cap`` bounds the rows one rank sends
    another in a shuffle (default: the rank's whole row count, safe and
    memory-heavy), ``fanout`` multiplies the probe capacity for the join's
    output. Overflow is flagged on the device and raised after the run."""

    def __init__(self, mesh: Optional[Mesh] = None):
        self.mesh = mesh or make_mesh()
        self._ops: List[Tuple] = []

    def filter(self, predicate: Expression) -> "DistPipelineBuilder":
        self._ops.append(("filter", predicate))
        return self

    def project(self, exprs: Sequence[Expression], names: Sequence[str],
                keep_existing: bool = True) -> "DistPipelineBuilder":
        self._ops.append(("project", list(exprs), list(names),
                          keep_existing))
        return self

    def join(self, build: RecordBatch, keys, right_keys=None,
             join_type: str = "inner", fanout: int = 2,
             shuffle_cap: Optional[int] = None) -> "DistPipelineBuilder":
        if join_type not in ("inner", "left outer"):
            raise Invalid("dist pipeline join: inner/'left outer' only")
        self._ops.append(("join", build,
                          [keys] if isinstance(keys, str) else list(keys),
                          right_keys, join_type, fanout, shuffle_cap))
        return self

    def group_by(self, keys: Sequence[str],
                 aggregates: Sequence[Tuple[str, str]],
                 shuffle_cap: Optional[int] = None) -> "DistPipelineBuilder":
        self._ops.append(("group_by", list(keys), list(aggregates),
                          shuffle_cap))
        return self

    def sort(self, sort_keys: Sequence[Tuple[str, str]]
             ) -> "DistPipelineBuilder":
        self._ops.append(("sort", list(sort_keys)))
        return self

    def limit(self, n: int) -> "DistPipelineBuilder":
        self._ops.append(("limit", n))
        return self

    def compile(self) -> "DistCompiledPipeline":
        return DistCompiledPipeline(self._ops, self.mesh)


class DistCompiledPipeline:
    def __init__(self, ops: List[Tuple], mesh: Mesh):
        self._ops = ops
        self.mesh = mesh
        self.D = mesh.size

    # ---------------- per-rank operators ------------------------------

    def _op_filter(self, st, predicate):
        arrays, templates, names, live = st
        mask = predicate.execute(_rebuild(arrays, templates, names, live))
        sel = mask.data if mask.validity is None else \
            (mask.data & mask.validity)
        return (arrays, templates, names, live & sel), _no_overflow(live)

    def _op_project(self, st, exprs, out_names, keep):
        arrays, templates, names, live = st
        batch = _rebuild(arrays, templates, names, live)
        arrays = dict(arrays) if keep else {}
        templates = dict(templates)
        names = list(names) if keep else []
        for e, name in zip(exprs, out_names):
            v = e.execute(batch)
            arrays[f"d:{name}"] = v.data
            arrays[f"m:{name}"] = v.mask()
            if v.data2 is not None:
                arrays[f"e:{name}"] = v.data2
            templates[name] = _ColTemplate(v.dtype, v.dictionary)
            if name not in names:
                names.append(name)
        return (arrays, templates, names, live), _no_overflow(live)

    def _op_join(self, st, build, keys, right_keys, join_type, fanout,
                 shuffle_cap):
        arrays, templates, names, live = st
        build_arrays, build_templates, build_names, build_live = build
        D = self.D
        right_keys = list(right_keys or keys)
        # the full plane lists match exactly; their 64-bit fold only picks
        # the destination rank
        pk_planes, bk_planes = [], []
        for lk, rk in zip(keys, right_keys):
            lkeys = _norm_components(arrays, templates, lk)
            rkeys = _norm_components(build_arrays, build_templates, rk)
            # a missing class plane means class 0 for every row
            if len(lkeys) < len(rkeys):
                lkeys = [torch.zeros_like(lkeys[0])] * \
                    (len(rkeys) - len(lkeys)) + lkeys
            elif len(rkeys) < len(lkeys):
                rkeys = [torch.zeros_like(rkeys[0])] * \
                    (len(lkeys) - len(rkeys)) + rkeys
            pk_planes.extend(lkeys)
            bk_planes.extend(rkeys)
        pvalid = torch.ones_like(live)
        for k in keys:
            pvalid = pvalid & arrays[f"m:{k}"]
        bvalid = torch.ones_like(build_live)
        for k in right_keys:
            bvalid = bvalid & build_arrays[f"m:{k}"]
        cap_p = shuffle_cap or live.shape[0]
        cap_b = shuffle_cap or build_live.shape[0]
        larr = _payload(arrays)
        rarr = _payload(build_arrays)
        for i, (p, b) in enumerate(zip(pk_planes, bk_planes)):
            larr[f"__key{i}__"] = p
            rarr[f"__key{i}__"] = b
        larr["__keyvalid__"] = pvalid
        rarr["__keyvalid__"] = bvalid
        ls, llive, lovf = shuffle_shard(
            larr, partition_ids(_fold_u64(pk_planes), D), live, self.mesh,
            cap_p)
        rs, rlive, rovf = shuffle_shard(
            rarr, partition_ids(_fold_u64(bk_planes), D), build_live,
            self.mesh, cap_b)
        outer = join_type == "left outer"
        nk = len(pk_planes)
        pidx, bidx, pair_valid, pair_match, _, _, jovf = join_padded(
            [ls[f"__key{i}__"] for i in range(nk)],
            [rs[f"__key{i}__"] for i in range(nk)],
            ls["__keyvalid__"], rlive & rs["__keyvalid__"],
            fanout * cap_p * D, outer=outer, probe_live=llive)

        out_arrays: Dict[str, torch.Tensor] = {}
        out_templates: Dict[str, _ColTemplate] = {}
        out_names: List[str] = []
        for name in names:
            for p in ("d", "m", "e"):
                if f"{p}:{name}" in ls:
                    out_arrays[f"{p}:{name}"] = ls[f"{p}:{name}"][pidx]
            out_templates[name] = templates[name]
            out_names.append(name)
        rkeyset = set(right_keys)
        for name in build_names:
            if name in rkeyset:
                continue
            if name in out_templates:
                raise Invalid(f"dist pipeline join: duplicate column "
                              f"{name!r}")
            out_arrays[f"d:{name}"] = rs[f"d:{name}"][bidx]
            rmask = rs[f"m:{name}"][bidx]
            out_arrays[f"m:{name}"] = rmask & pair_match if outer else rmask
            if f"e:{name}" in rs:
                out_arrays[f"e:{name}"] = rs[f"e:{name}"][bidx]
            out_templates[name] = build_templates[name]
            out_names.append(name)
        return ((out_arrays, out_templates, out_names, pair_valid),
                lovf | rovf | jovf)

    _DECOMPOSABLE = ("sum", "count", "min", "max", "mean",
                     "variance", "stddev", "any", "all")

    def _op_group_by(self, st, keys, aggregates, shuffle_cap):
        """Hash aggregate. When every aggregate decomposes and the shuffle
        capacity is below the rank's rows, each rank first aggregates its
        own rows into at most ``cap`` partial groups and ships those
        (combine before shuffle: the exchange moves group-scale data);
        else the rows are shuffled."""
        arrays, templates, names, live = st
        R = live.shape[0]
        cap = shuffle_cap or R
        norm: List[torch.Tensor] = []
        for k in keys:
            norm.extend(_norm_components(arrays, templates, k))
        if cap < R and all(fn in self._DECOMPOSABLE for _, fn in aggregates):
            return self._op_group_by_partial(st, keys, aggregates, norm, cap)
        return self._op_group_by_rows(st, keys, aggregates, norm, cap)

    def _finish_groups(self, shuffled, slive, keys, templates, n_norm):
        """The final grouping of shuffled rows or partials, and the keys'
        output arrays at each group's first row."""
        groups = grouping_padded(
            [(~slive).to(torch.uint8)]
            + [shuffled[f"k:{i}"] for i in range(n_norm)])
        gvalid = groups.group_valid & slive[groups.rep_rows]
        out_arrays: Dict[str, torch.Tensor] = {}
        for k in keys:
            for p in ("d", "m", "e"):
                if f"{p}:{k}" in shuffled:
                    out_arrays[f"{p}:{k}"] = \
                        shuffled[f"{p}:{k}"][groups.rep_rows]
        return groups, gvalid, out_arrays

    def _op_group_by_partial(self, st, keys, aggregates, norm, cap):
        arrays, templates, names, live = st
        D = self.D
        R = live.shape[0]
        # phase A: each rank's partial groups, at most cap of them. Dead
        # rows' key bits are zeroed so that they make one group
        norm_l = [torch.where(live, nk, 0) for nk in norm]
        lg = grouping_padded([(~live).to(torch.uint8)] + norm_l)
        slot_live = lg.group_valid & live[lg.rep_rows]
        # every slot must fit (the dead group too), else a live group past
        # cap would be dropped
        ovf = lg.num_groups > cap
        parr: Dict[str, torch.Tensor] = {}
        for cname in sorted({c for c, _ in aggregates}):
            d = arrays[f"d:{cname}"]
            m = arrays[f"m:{cname}"]
            for fn in sorted({f for c, f in aggregates if c == cname}):
                if fn in ("variance", "stddev"):
                    # (s1, s2, n) partials merge by plain sums
                    x = torch.where(m & live, d, 0).to(torch.float64)
                    s1, vcount = _grouped_padded(x, m, live, "sum",
                                                 lg.group_ids, R)
                    s2, _ = _grouped_padded(x * x, m, live, "sum",
                                            lg.group_ids, R)
                    parr[f"p:{cname}:{fn}"] = s1[:cap]
                    parr[f"q:{cname}:{fn}"] = s2[:cap]
                    parr[f"n:{cname}:{fn}"] = vcount[:cap]
                    continue
                if fn in ("any", "all"):
                    acc, vcount = _grouped_padded(
                        (d != 0).to(torch.int64), m, live,
                        "max" if fn == "any" else "min", lg.group_ids, R)
                else:
                    acc, vcount = _grouped_padded(
                        d, m, live, "sum" if fn == "mean" else fn,
                        lg.group_ids, R)
                parr[f"p:{cname}:{fn}"] = acc[:cap]
                parr[f"n:{cname}:{fn}"] = vcount[:cap]
        rep = lg.rep_rows[:cap]
        for k in keys:
            for p in ("d", "m", "e"):
                if f"{p}:{k}" in arrays:
                    parr[f"{p}:{k}"] = arrays[f"{p}:{k}"][rep]
        for i, nk in enumerate(norm):
            parr[f"k:{i}"] = nk[rep]
        mixed = _fold_u64([parr[f"k:{i}"] for i in range(len(norm))])
        # every one of the cap slots may go to one rank
        shuffled, slive, sovf = shuffle_shard(
            parr, partition_ids(mixed, D), slot_live[:cap], self.mesh, cap)
        # phase B: merge the D * cap partials
        G = D * cap
        groups, gvalid, out_arrays = self._finish_groups(
            shuffled, slive, keys, templates, len(norm))
        gids = groups.group_ids
        out_templates: Dict[str, _ColTemplate] = {}
        out_names: List[str] = []
        for cname, fn in aggregates:
            col_t = templates[cname]
            p = shuffled[f"p:{cname}:{fn}"]
            cnts = shuffled[f"n:{cname}:{fn}"]
            cnt_valid = (cnts > 0) & slive
            merged_n, _ = _grouped_padded(cnts, slive, slive, "sum", gids, G)
            if fn == "count":
                acc = merged_n
            elif fn in ("sum", "mean"):
                acc, _ = _grouped_padded(p, cnt_valid, slive, "sum", gids, G)
                if fn == "mean":
                    acc = acc.to(torch.float64) / \
                        merged_n.clamp(min=1).to(torch.float64)
            elif fn in ("variance", "stddev"):
                S, _ = _grouped_padded(p, cnt_valid, slive, "sum", gids, G)
                Q, _ = _grouped_padded(shuffled[f"q:{cname}:{fn}"],
                                       cnt_valid, slive, "sum", gids, G)
                nf = merged_n.clamp(min=1).to(torch.float64)
                mean = S / nf
                acc = (Q / nf - mean * mean).clamp(min=0.0)
                if fn == "stddev":
                    acc = torch.sqrt(acc)
            elif fn in ("any", "all"):
                acc, _ = _grouped_padded(p, cnt_valid, slive,
                                         "max" if fn == "any" else "min",
                                         gids, G)
                acc = acc > 0
            else:   # min / max of the partials; empty partials masked out
                acc, _ = _grouped_padded(p, cnt_valid, slive, fn, gids, G)
            self._agg_output(out_arrays, out_templates, out_names, cname, fn,
                             col_t, acc, merged_n, G)
        for k in keys:
            out_templates[k] = templates[k]
            out_names.append(k)
        return (out_arrays, out_templates, out_names, gvalid), ovf | sovf

    @staticmethod
    def _agg_output(out_arrays, out_templates, out_names, cname, fn, col_t,
                    acc, vcount, G):
        out_t = _agg_type(fn, col_t.dtype)
        oname = f"{cname}_{fn}"
        out_arrays[f"d:{oname}"] = acc.to(out_t.physical_dtype())
        out_arrays[f"m:{oname}"] = torch.ones(
            G, dtype=torch.bool, device=acc.device) if fn == "count" \
            else vcount > 0
        out_templates[oname] = _ColTemplate(
            out_t, col_t.dictionary if out_t.is_binary else None)
        out_names.append(oname)

    def _op_group_by_rows(self, st, keys, aggregates, norm, cap):
        arrays, templates, names, live = st
        D = self.D
        need = list(dict.fromkeys([*keys, *sorted({c for c, _ in
                                                   aggregates})]))
        sarr = {}
        for name in need:
            for p in ("d", "m", "e"):
                if f"{p}:{name}" in arrays:
                    sarr[f"{p}:{name}"] = arrays[f"{p}:{name}"]
        for i, nk in enumerate(norm):
            sarr[f"k:{i}"] = nk
        shuffled, slive, ovf = shuffle_shard(
            sarr, partition_ids(_fold_u64(norm), D), live, self.mesh, cap)
        G = D * cap
        groups, gvalid, out_arrays = self._finish_groups(
            shuffled, slive, keys, templates, len(norm))
        out_templates: Dict[str, _ColTemplate] = {}
        out_names: List[str] = []
        for cname, fn in aggregates:
            acc, vcount = _grouped_padded(
                shuffled[f"d:{cname}"], shuffled[f"m:{cname}"], slive, fn,
                groups.group_ids, G)
            self._agg_output(out_arrays, out_templates, out_names, cname, fn,
                             templates[cname], acc, vcount, G)
        for k in keys:
            out_templates[k] = templates[k]
            out_names.append(k)
        return (out_arrays, out_templates, out_names, gvalid), ovf

    def _op_sort(self, st, sort_keys):
        """Global sort: every rank's rows gathered (the state after an
        aggregation is small), sorted, and this rank's range kept, so the
        ranks hold the sorted order in rank order."""
        arrays, templates, names, live = st
        g = {k: all_gather_rows(v, self.mesh) for k, v in arrays.items()}
        glive = all_gather_rows(live, self.mesh)
        skeys: List[torch.Tensor] = [(~glive).to(torch.int64)]
        for name, order in sort_keys:
            skeys.extend(_norm_components(g, templates, name, order))
        perm = sort_indices_device(skeys)
        R = live.shape[0]
        local = perm[self.mesh.rank * R:(self.mesh.rank + 1) * R]
        out = {k: v[local] for k, v in g.items()}
        return (out, templates, names, glive[local]), _no_overflow(live)

    def _op_limit(self, st, n):
        arrays, templates, names, live = st
        local = torch.cumsum(live.to(torch.int64), 0)
        mine = local[-1:] if live.shape[0] else \
            torch.zeros(1, dtype=torch.int64, device=live.device)
        totals = all_gather_rows(mine, self.mesh)
        before = totals[:self.mesh.rank].sum()
        rank = before + local - 1
        return (arrays, templates, names, live & (rank < n)), \
            _no_overflow(live)

    # ---------------- the program ----------------------------------

    def _run(self, batch: RecordBatch):
        """Every stage on this rank's state; returns (arrays, templates,
        names, live, overflow) with overflow ORed over the ranks, not yet
        read."""
        local, live = _sharded(batch, self.mesh)
        arrays, templates = _flatten_batch(local)
        st = (arrays, templates, list(local.names), live)
        overflow = _no_overflow(live)
        for op in self._ops:
            if op[0] == "join":
                _, build, keys, right_keys, join_type, fanout, cap = op
                blocal, blive = _sharded(build, self.mesh)
                barr, btmpl = _flatten_batch(blocal)
                st, ovf = self._op_join(
                    st, (barr, btmpl, list(blocal.names), blive), keys,
                    right_keys, join_type, fanout, cap)
            else:
                st, ovf = getattr(self, "_op_" + op[0])(st, *op[1:])
            overflow = overflow | ovf
        return (*st, any_rank(overflow, self.mesh))

    def __call__(self, batch: RecordBatch, materialize: bool = True):
        arrays, templates, names, live, overflow = self._run(batch)
        if read_flag(overflow):
            raise Invalid("distributed pipeline: capacity overflow — raise "
                          "shuffle_cap/fanout")
        if not materialize:
            out = dict(arrays)
            out["__live__"] = live
            return out, names, templates
        got = gather_live(_payload(arrays), live, self.mesh)
        cols = []
        for name in names:
            t = templates[name]
            mask = got[f"m:{name}"]
            cols.append(Column(got[f"d:{name}"], t.dtype,
                               validity=None if bool(mask.all()) else mask,
                               dictionary=t.dictionary,
                               data2=got.get(f"e:{name}")))
        return RecordBatch(tuple(cols), tuple(names))
