"""Distributed operators: filter, group_by, join and sort across the ranks
of a process group (counterpart of arrow1_tpu/parallel/distributed.py).

Every rank calls an operator with the same global batch and takes its own
rows (mesh.shard_batch); each operator is one torch program per rank:

    local prep -> all_to_all shuffle (shuffle.py) -> local padded kernel
    (ops/padded.py) -> padded per-rank outputs -> one host read of the
    overflow flag -> per-rank compaction through K2 -> all-gather

and every rank gets the whole result back, in rank order (the reference's
shard order). Capacities are static, as the reference's XLA shapes are,
and an overflow raises ``Invalid`` on every rank at once.

Stability: dist_sort appends the global row id as the last sort key, so
the distributed sort is as stable as the single-device one.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column
from ..errors import Invalid
from ..kernels.compaction import compact
from ..kernels.radix import _SIGN
from ..ops.padded import grouping_padded, join_padded
from ..ops.sort import normalize_sort_key, sort_indices_device
from ..table import RecordBatch
from .mesh import (Mesh, all_gather_rows, gather_varlen, make_mesh,
                   pad_to_multiple, shard_batch)
from .shuffle import FNV_MIX, any_rank, partition_ids, shuffle_shard

__all__ = ["dist_filter", "dist_filter_padded", "dist_group_by", "dist_join",
           "dist_sort_indices", "dist_sort", "gather_live", "read_flag"]

def _mix_keys(norm: List[torch.Tensor]) -> torch.Tensor:
    """Normalized key planes folded into one 64-bit hash for partitioning
    (equal keys, equal hash; int64 multiplies wrap as uint64 ones)."""
    h = torch.zeros(norm[0].shape[0], dtype=torch.int64,
                    device=norm[0].device)
    for k in norm:
        h = (h ^ k.to(torch.int64)) * FNV_MIX
    return h


def _rank_rows(n: int, mesh: Mesh) -> Tuple[int, int, int]:
    """(padded rows per rank, this rank's first row, global rows)."""
    per = -(-n // mesh.size)
    return per, mesh.rank * per, n


def _sharded(batch: RecordBatch, mesh: Mesh):
    """This rank's rows and their live mask (padding rows are dead)."""
    per, lo, n = _rank_rows(batch.num_rows, mesh)
    local = shard_batch(batch, mesh)
    row_valid = torch.arange(lo, lo + per, device=mesh.device) < n
    return local, row_valid


def _shard_vec(x: torch.Tensor, n: int, mesh: Mesh, fill=0):
    """This rank's slice of a global per-row tensor, padded like the
    batch."""
    per, lo, _ = _rank_rows(n, mesh)
    x = x.to(mesh.device)
    if x.shape[0] < per * mesh.size:
        x = torch.cat([x, x.new_full((per * mesh.size - x.shape[0],), fill)])
    return x[lo:lo + per]


def _col_arrays(batch: RecordBatch, names) -> Dict[str, torch.Tensor]:
    """The needed columns as name -> tensor (data, validity and the
    decimal limbs above the lowest as ``e:name``)."""
    out = {}
    for name in names:
        c = batch.column(name)
        out[f"d:{name}"] = c.data
        out[f"m:{name}"] = c.mask()
        if c.data2 is not None:
            out[f"e:{name}"] = c.data2
    return out


def read_flag(flag: torch.Tensor) -> bool:
    """The one host read of an operator's (all-reduced) overflow flag."""
    return bool(flag)


def _compact_rows(arrays: Dict[str, torch.Tensor], live: torch.Tensor):
    """Every array's ``live`` rows in one K2 launch (kernels/compaction.py;
    a 2-D array rides as its columns): (name -> tensor of the input's
    length whose first ``count`` rows are the kept ones, count)."""
    flat, spans = [], {}
    for name, a in arrays.items():
        parts = [a] if a.dim() == 1 else list(a.unbind(1))
        spans[name] = (len(flat), len(parts), a.dim())
        flat.extend(parts)
    outs, count = compact(live, flat)
    return {name: outs[at] if dim == 1 else torch.stack(outs[at:at + k], 1)
            for name, (at, k, dim) in spans.items()}, count


def gather_live(arrays: Dict[str, torch.Tensor], live: torch.Tensor,
                mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's live rows of every array, compacted on the device
    (``_compact_rows``), then every rank's gathered to every rank in rank
    order. The ranks' counts are the one host read."""
    compacted, count = _compact_rows(arrays, live)
    counts = all_gather_rows(count.reshape(1), mesh).tolist()
    mine = counts[mesh.rank]
    return {name: gather_varlen(x[:mine], counts, mesh)
            for name, x in compacted.items()}


def _rebuild_column(template: Column, data, mask, data2=None) -> Column:
    validity = None if bool(mask.all()) else mask
    return Column(data, template.dtype, validity=validity,
                  dictionary=template.dictionary, data2=data2)


def _columns(batch: RecordBatch, names, got: Dict[str, torch.Tensor],
             prefix: str = "") -> List[Column]:
    return [_rebuild_column(batch.column(n), got[f"{prefix}d:{n}"],
                            got[f"{prefix}m:{n}"],
                            got.get(f"{prefix}e:{n}")) for n in names]


# ---------------------------------------------------------------- filter

def dist_filter_padded(batch: RecordBatch, mask_expr,
                       mesh: Optional[Mesh] = None):
    """Distributed filter, padded form: the predicate and the compaction
    (one K2 launch) run on each rank's rows, with no communication but the
    counts. Returns (result, counts, names): ``result`` holds this rank's
    ``d:name``/``m:name`` (and ``e:name``) tensors, whose first
    ``counts[rank]`` rows live, and ``__count__``; ``counts`` is every
    rank's (numpy)."""
    from ..expr import Expression

    mesh = mesh or make_mesh()
    local, row_valid = _sharded(batch, mesh)
    if isinstance(mask_expr, Expression):
        mask = mask_expr.execute(local)
        selected = mask.data if mask.validity is None else \
            (mask.data & mask.validity)
    else:   # a bool Column over the global batch
        selected = mask_expr.data if mask_expr.validity is None else \
            (mask_expr.data & mask_expr.validity)
        selected = _shard_vec(selected, batch.num_rows, mesh, False)
    result, count = _compact_rows(_col_arrays(local, batch.names),
                                  selected & row_valid)
    result["__count__"] = count.reshape(1)
    counts = np.asarray(all_gather_rows(count.reshape(1), mesh).cpu())
    return result, counts, batch.names


def dist_filter(batch: RecordBatch, mask_expr,
                mesh: Optional[Mesh] = None) -> RecordBatch:
    """Distributed filter: the predicate and the compaction run on each
    rank's rows with no communication; only the compacted rows are
    gathered, never the input. ``mask_expr`` is an Expression or a bool
    Column over the batch."""
    mesh = mesh or make_mesh()
    result, counts, names = dist_filter_padded(batch, mask_expr, mesh)
    counts = counts.tolist()
    mine = counts[mesh.rank]
    got = {k: gather_varlen(v[:mine], counts, mesh)
           for k, v in result.items() if k != "__count__"}
    return RecordBatch(tuple(_columns(batch, names, got)), tuple(names))


# ---------------------------------------------------------------- group_by

def _grouped_padded(value, mask, row_valid, fn: str, gids, cap: int):
    """Grouped aggregate over padded groups, on the device.

    Returns (acc, valid_count); acc's dtype depends on fn."""
    live = mask & row_valid
    dev = gids.device
    vcount = torch.zeros(cap, dtype=torch.int64, device=dev).scatter_add_(
        0, gids, live.to(torch.int64))
    if fn == "count":
        return vcount, vcount
    if fn in ("sum", "mean"):
        acc_dt = torch.float64 if (fn == "mean" or value.is_floating_point()) \
            else torch.int64
        x = torch.where(live, value, 0).to(acc_dt)
        acc = torch.zeros(cap, dtype=acc_dt, device=dev).scatter_add_(
            0, gids, x)
        if fn == "mean":
            acc = acc / vcount.clamp(min=1)
        return acc, vcount
    if fn in ("min", "max"):
        if value.is_floating_point():
            big, small = float("inf"), float("-inf")
        else:
            info = torch.iinfo(value.dtype)
            big, small = info.max, info.min
        init = big if fn == "min" else small
        x = torch.where(live, value, init)
        acc = torch.full((cap,), init, dtype=value.dtype, device=dev)
        return acc.scatter_reduce_(0, gids, x, "amin" if fn == "min"
                                   else "amax"), vcount
    if fn in ("variance", "stddev"):
        x = torch.where(live, value, 0).to(torch.float64)
        s1 = torch.zeros(cap, dtype=torch.float64, device=dev).scatter_add_(
            0, gids, x)
        s2 = torch.zeros(cap, dtype=torch.float64, device=dev).scatter_add_(
            0, gids, x * x)
        nv = vcount.to(torch.float64).clamp(min=1)
        mean = s1 / nv
        var = (s2 / nv - mean * mean).clamp(min=0.0)
        return (torch.sqrt(var) if fn == "stddev" else var), vcount
    if fn in ("any", "all"):
        b = value != 0
        if fn == "any":
            x, init, how = (b & live), 0, "amax"
        else:
            x, init, how = (b | ~live), 1, "amin"
        acc = torch.full((cap,), init, dtype=torch.uint8, device=dev)
        return acc.scatter_reduce_(0, gids, x.to(torch.uint8),
                                   how).bool(), vcount
    raise Invalid(f"dist_group_by: unsupported aggregate {fn!r}")


def _agg_type(fn: str, src: dt.DataType) -> dt.DataType:
    if fn == "count":
        return dt.int64
    if fn in ("mean", "variance", "stddev"):
        return dt.float64
    if fn in ("any", "all"):
        return dt.bool_
    if fn in ("min", "max"):
        return src
    from ..ops.aggregate import _sum_output_type

    return _sum_output_type(src)


def _agg_column(acc, vcount, fn: str, src: Column) -> Column:
    out_t = _agg_type(fn, src.dtype)
    validity = None
    if fn != "count" and not bool((vcount > 0).all()):
        validity = vcount > 0
    return Column(acc.to(out_t.physical_dtype()), out_t, validity=validity,
                  dictionary=src.dictionary if out_t.is_binary else None)


def dist_group_by(batch: RecordBatch, keys: Sequence[str],
                  aggregates: Sequence[Tuple[str, str]],
                  mesh: Optional[Mesh] = None,
                  capacity_per_dest: Optional[int] = None) -> RecordBatch:
    """Distributed hash aggregate: rows are shuffled by key hash so that
    each rank owns a disjoint key subset, then aggregated locally (no
    merge step)."""
    for cname, fn in aggregates:
        if batch.column(cname).dtype.is_decimal and fn != "count":
            raise Invalid(f"dist_group_by: {fn} over decimal column "
                          f"{cname!r} is not supported — the grouped "
                          "reduction covers one limb plane")
    mesh = mesh or make_mesh()
    D = mesh.size
    local, row_valid = _sharded(batch, mesh)
    cap = capacity_per_dest or local.num_rows   # all rows to one rank
    agg_cols = sorted({c for c, _ in aggregates})
    norm: List[torch.Tensor] = []
    for k in keys:
        norm.extend(normalize_sort_key(local.column(k)))
    arrays = _col_arrays(local, list(dict.fromkeys([*keys, *agg_cols])))
    for i, nk in enumerate(norm):
        arrays[f"k:{i}"] = nk
    shuffled, live, overflow = shuffle_shard(
        arrays, partition_ids(_mix_keys(norm), D), row_valid, mesh, cap)
    G = D * cap
    gkeys = [torch.where(live, shuffled[f"k:{i}"], -1)
             for i in range(len(norm))]
    # dead rows group under the sentinel keys; their groups are dropped
    groups = grouping_padded([(~live).to(torch.uint8)] + gkeys)
    out = {}
    for cname, fn in aggregates:
        acc, vcount = _grouped_padded(
            shuffled[f"d:{cname}"], shuffled[f"m:{cname}"], live, fn,
            groups.group_ids, G)
        out[f"a:{cname}:{fn}"] = acc
        out[f"n:{cname}:{fn}"] = vcount
    for k in keys:
        for p in ("d", "m", "e"):
            if f"{p}:{k}" in shuffled:
                out[f"{p}:{k}"] = shuffled[f"{p}:{k}"][groups.rep_rows]
    if read_flag(overflow):
        raise Invalid("dist_group_by: shuffle capacity overflow — raise "
                      "capacity_per_dest")
    got = gather_live(out, groups.group_valid & live[groups.rep_rows], mesh)
    cols, names = [], []
    for cname, fn in aggregates:
        cols.append(_agg_column(got[f"a:{cname}:{fn}"],
                                got[f"n:{cname}:{fn}"], fn,
                                batch.column(cname)))
        names.append(f"{cname}_{fn}")
    cols += _columns(batch, keys, got)
    return RecordBatch(tuple(cols), tuple(names) + tuple(keys))


# ---------------------------------------------------------------- join

def _plan_salting(lids, nl: int, D: int, max_salt: int):
    """Skew detection and the salting plan (host, numpy).

    A key whose probe-row count nears the per-rank average puts its whole
    load on one rank. Keys above ``nl / D / 2`` probe rows are hot; their
    probe rows spread over S salted sub-partitions (salt = row % S), and
    their build rows are replicated into all S, so every probe row still
    meets every matching build row once."""
    l = np.asarray(lids)
    counts = np.bincount(l, minlength=int(l.max()) + 1 if l.size else 1)
    threshold = max(nl // D // 2, 8)
    hot = np.flatnonzero(counts > threshold)
    if hot.size == 0:
        return None, 1
    worst = int(counts[hot].max())
    S = min(max(2, (worst + threshold - 1) // threshold), max_salt)
    is_hot = np.zeros(len(counts), dtype=bool)
    is_hot[hot] = True
    return is_hot, S


def dist_join(left: RecordBatch, right: RecordBatch, keys,
              right_keys=None, join_type: str = "inner",
              mesh: Optional[Mesh] = None,
              capacity_per_dest: Optional[int] = None,
              output_capacity: Optional[int] = None,
              salt: bool = True) -> RecordBatch:
    """Distributed equi-join: both sides shuffled by key hash, a padded
    join per rank, the pairs compacted and gathered. Skewed keys are found
    from the probe histogram and salted (the build side replicated);
    ``salt=False`` turns that off. Inner and left outer are distributed;
    the other types run the eager join."""
    from ..ops.join import _key_ids
    from ..ops.join import join as eager_join
    from ..ops.selection import take_column
    from ..table import concat_batches

    if join_type not in ("inner", "left outer"):
        return eager_join(left, right, keys, right_keys, join_type)
    keys = [keys] if isinstance(keys, str) else list(keys)
    right_keys = list(right_keys or keys)
    mesh = mesh or make_mesh()
    D = mesh.size

    # dense key ids over both sides (equal keys, equal ids), then the ids
    # are the shuffle keys
    lids, rids, lkv, rkv = _key_ids(left, right, keys, right_keys)
    lids, rids = lids.to(torch.int64), rids.to(torch.int64)
    if salt:   # the salt folds into the id: key' = key * S + salt
        is_hot, S = _plan_salting(lids.cpu().numpy(), left.num_rows, D,
                                  max_salt=D)
        if is_hot is not None:
            hot = torch.from_numpy(is_hot).to(lids.device)
            lsalt = torch.where(hot[lids], torch.arange(
                left.num_rows, device=lids.device) % S, 0)
            lids = lids * S + lsalt
            rbase = rids * S
            # an id past the probe's largest reads the last flag, as the
            # reference's clamped gather does
            hot_rows = torch.nonzero(
                hot[rids.clamp(max=hot.shape[0] - 1)]).squeeze(1)
            if hot_rows.numel():   # hot build rows into salts 1..S-1
                extra = RecordBatch(tuple(take_column(c, hot_rows)
                                          for c in right.columns),
                                    right.names)
                rkv0 = torch.ones(right.num_rows, dtype=torch.bool,
                                  device=rids.device) if rkv is None else rkv
                right = concat_batches([right] + [extra] * (S - 1))
                rids = torch.cat([rbase] + [rbase[hot_rows] + s
                                            for s in range(1, S)])
                rkv = torch.cat([rkv0] + [rkv0[hot_rows]] * (S - 1))
            else:
                rids = rbase

    lsh, lrow = _sharded(left, mesh)
    rsh, rrow = _sharded(right, mesh)
    cap_l = capacity_per_dest or lsh.num_rows
    cap_r = capacity_per_dest or rsh.num_rows
    out_cap = output_capacity or max(4 * cap_l * D, 1024)
    larr = _col_arrays(lsh, lsh.names)
    rarr = _col_arrays(rsh, rsh.names)
    larr["__key__"] = _shard_vec(lids, left.num_rows, mesh)
    rarr["__key__"] = _shard_vec(rids, right.num_rows, mesh)
    ones = torch.ones(1, dtype=torch.bool, device=mesh.device)
    larr["__keyvalid__"] = _shard_vec(
        ones.expand(left.num_rows) if lkv is None else lkv,
        left.num_rows, mesh, False)
    rarr["__keyvalid__"] = _shard_vec(
        ones.expand(right.num_rows) if rkv is None else rkv,
        right.num_rows, mesh, False)
    outer = join_type == "left outer"

    ls, llive, lovf = shuffle_shard(
        larr, partition_ids(larr["__key__"], D), lrow, mesh, cap_l)
    rs, rlive, rovf = shuffle_shard(
        rarr, partition_ids(rarr["__key__"], D), rrow, mesh, cap_r)
    pidx, bidx, pair_valid, pair_match, _, _, jovf = join_padded(
        ls["__key__"], rs["__key__"], ls["__keyvalid__"],
        rlive & rs["__keyvalid__"], out_cap, outer=outer, probe_live=llive)
    res = {"__match__": pair_match}
    for side, arrs, idx in (("L", ls, pidx), ("R", rs, bidx)):
        for name, arr in arrs.items():
            if name[:2] in ("d:", "m:", "e:"):
                res[side + name] = arr[idx]
    if read_flag(lovf | rovf | any_rank(jovf, mesh)):
        raise Invalid("dist_join: capacity overflow — raise capacities")
    got = gather_live(res, pair_valid, mesh)
    match = got.pop("__match__")
    cols, names = [], []
    lkeyset, rkeyset = set(keys), set(right_keys)
    lnames = keys + [n for n in left.names if n not in lkeyset]
    cols += _columns(left, lnames, got, "L")
    names += lnames
    for n in right.names:
        if n in rkeyset:
            continue
        cols.append(_rebuild_column(right.column(n), got[f"Rd:{n}"],
                                    got[f"Rm:{n}"] & match,
                                    got.get(f"Re:{n}")))
        names.append(n)
    return RecordBatch(tuple(cols), tuple(names))


# ---------------------------------------------------------------- sort

def _primary(col: Column, norm: List[torch.Tensor]) -> torch.Tensor:
    """The first sort key's planes folded into one unsigned 64-bit range
    key (int64 bit pattern): a class plane (nulls, NaN) takes the top two
    bits over the value's upper 62."""
    has_class = col.validity is not None if col.dtype.is_decimal \
        else len(norm) == 2
    if not has_class:
        return norm[0]
    return (norm[0] << 62) | ((norm[1] >> 2) & ((1 << 62) - 1))


def dist_sort(batch: RecordBatch, sort_keys: Sequence[Tuple[str, str]],
              mesh: Optional[Mesh] = None,
              capacity_per_dest: Optional[int] = None,
              sample_per_shard: int = 256) -> RecordBatch:
    """Distributed sort: splitter-based range partition, then a local sort.

    1. sample the normalized primary keys -> D-1 splitters (host, small)
    2. shuffle each row to its key range's rank
    3. a stable multi-key sort per rank, the global row id last
    4. the ranks' runs in rank order are the total order
    """
    mesh = mesh or make_mesh()
    D = mesh.size
    n = batch.num_rows
    local, row_valid = _sharded(batch, mesh)
    per, lo, _ = _rank_rows(n, mesh)
    cap = capacity_per_dest or per * D   # all rows to one rank
    if n == 0:
        return batch.slice(0, 0)
    # the primary over the padded batch, as every rank's shard has it
    first = sort_keys[0]
    pcol = pad_to_multiple(batch, D).column(first[0])
    gnorm = normalize_sort_key(pcol, first[1])
    host = _primary(pcol, gnorm)[:n].cpu().numpy().view(np.uint64)
    host = np.sort(np.random.default_rng(0).choice(
        host, size=min(n, sample_per_shard * D)))
    splitters = torch.from_numpy(
        host[[int(len(host) * i / D) for i in range(1, D)]].view(
            np.int64).copy()).to(mesh.device)

    norm: List[torch.Tensor] = []
    for name, order in sort_keys:
        norm.extend(normalize_sort_key(local.column(name), order))
    primary = _primary(local.column(first[0]), norm[:len(gnorm)])
    arrays = _col_arrays(local, local.names)
    for i, nk in enumerate(norm):
        arrays[f"k:{i}"] = nk
    arrays["__rowid__"] = torch.arange(lo, lo + per, device=mesh.device)
    # unsigned order: the sign bit flipped on both sides
    part = torch.searchsorted(splitters ^ _SIGN, primary ^ _SIGN,
                              right=True).to(torch.int32)
    shuffled, live, ovf = shuffle_shard(arrays, part, row_valid, mesh, cap)
    skeys = [(~live).to(torch.int64)]   # dead rows sort last
    skeys += [shuffled[f"k:{i}"] for i in range(len(norm))]
    skeys.append(shuffled["__rowid__"])   # the stability tiebreak
    perm = sort_indices_device(skeys)
    res = {name: arr[perm] for name, arr in shuffled.items()
           if name[:2] in ("d:", "m:", "e:")}
    if read_flag(ovf):
        raise Invalid("dist_sort: capacity overflow — raise "
                      "capacity_per_dest")
    got = gather_live(res, live[perm], mesh)
    return RecordBatch(tuple(_columns(batch, batch.names, got)),
                       batch.names)


def dist_sort_indices(batch: RecordBatch, sort_keys, mesh=None, **kw):
    """The sorted order's source rows, as a uint64 column: a row-id column
    sorted along with the data."""
    dev = batch.columns[0].device if batch.columns else None
    rb = batch.set_column("__rowid__", Column(
        torch.arange(batch.num_rows, device=dev), dt.uint64))
    return dist_sort(rb, sort_keys, mesh=mesh, **kw).column("__rowid__")
