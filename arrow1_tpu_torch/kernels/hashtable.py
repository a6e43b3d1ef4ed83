"""Hash-table build and probe of the join, and the small sorted-build probe
(K4) (counterpart of arrow1_tpu/kernels/hashtable.py).

1. **Bucketed table** (``hash_table_build`` / ``hash_table_probe``, and
   the join adapter ``join_build`` / ``join_probe``): 2^bits buckets of
   ``ways`` slots; a key lives in the bucket its SplitMix64 hash names.
   Build is one stable sort by bucket, run geometry from a cumsum, one
   scatter and gathers, and one scatter into the table; keys whose bucket
   overflows are counted and the caller doubles ``bits``. Probe gathers
   the probe's ``[ways]`` key and payload rows and compares every way.
   These are torch ops: the JAX package wrote them in XLA, not Pallas.
2. **Broadcast probe** (``broadcast_probe``, K4): per probe key, the
   number of keys of a small sorted build array (at most
   ``BROADCAST_T_MAX``) that are smaller, and the number that are equal
   (the ``(lo, counts)`` contract of ``ops/padded.probe_ranges_sortmerge``).
   On a CUDA tensor it launches ``csrc/broadcast_probe.cu``; on a CPU
   tensor it runs ``broadcast_probe_plain``. No engine path calls it, as in
   the JAX package; it is its own entry point.

Keys are unsigned 64-bit values held as int64 bit patterns: shifts mask
after the arithmetic shift, multiplication wraps mod 2^64, and order
comparisons flip the sign bit first.

Join payloads pack ``(lo + 1) << 32 | count`` (0 is an empty slot), where
``lo`` and ``count`` index the build order the build returns.

Not carried over, because they work around the TPU's tiling or its
compiler: the flat ``PackedTable`` and its lane-window probe
(``pack_table``, ``probe_packed``), and the staged build
(``join_build_staged``, ``_jb_*``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from ..device import resolve_device
from .build import aligned, load
from .radix import _SIGN, sort_permutation

__all__ = ["splitmix64", "table_bits_for", "HashTable", "hash_table_build",
           "hash_table_probe", "join_build", "join_probe", "PROBE_CHUNK",
           "BROADCAST_T_MAX", "broadcast_probe", "broadcast_probe_plain",
           "SOURCE"]

SOURCE = "broadcast_probe.cu"
BROADCAST_T_MAX = 2048
# Probe rows per chunk: the [chunk, ways] key and payload gathers of a
# 100M-row probe then stay near 0.5 GB.
PROBE_CHUNK = 4_000_000
MAX_BITS = 28

_M1 = 0xBF58476D1CE4E5B9 - (1 << 64)   # SplitMix64 multipliers, as int64
_M2 = 0x94D049BB133111EB - (1 << 64)


def _u64_bits(x: torch.Tensor) -> torch.Tensor:
    """The 64-bit pattern of integer keys as int64."""
    if x.dtype == torch.uint64:
        return x.view(torch.int64)
    return x.to(torch.int64)


def _shr(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns by 0 < s < 64."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def splitmix64(x: torch.Tensor) -> torch.Tensor:
    """SplitMix64 finalizer on 64-bit patterns (int64 in, int64 out)."""
    x = _u64_bits(x)
    x = (x ^ _shr(x, 30)) * _M1
    x = (x ^ _shr(x, 27)) * _M2
    return x ^ _shr(x, 31)


def _bucket_of(keys: torch.Tensor, bits: int) -> torch.Tensor:
    """The top ``bits`` bits of the key's hash, as int32."""
    return _shr(splitmix64(keys), 64 - bits).to(torch.int32)


def table_bits_for(n_distinct: int, ways: int = 8) -> int:
    """Bucket count for an expected load of ways/2 per bucket."""
    target = max(2 * n_distinct // ways, 1)
    bits = max(int(target - 1).bit_length(), 4)
    return min(bits, MAX_BITS)


class HashTable(NamedTuple):
    keys: torch.Tensor       # int64[2^bits, ways] (u64 bit patterns)
    payload: torch.Tensor    # int64[2^bits, ways], 0 = empty
    bits: int
    ways: int
    overflow: torch.Tensor   # scalar on the device: keys that did not fit


def _run_geometry(first: torch.Tensor, bfirst: torch.Tensor = None):
    """Run geometry of a sorted sequence from its run-start flags: per row
    (run_start, run_end, kcum, way), where run_end is the next run's start
    (or n), kcum the 1-based run index and ``way`` the rank of the row's
    run within its bucket (None without bucket-start flags). One cumsum,
    one scatter of the start positions, gathers back."""
    n = first.shape[0]
    dev = first.device
    pos = torch.arange(n, device=dev)
    kcum = torch.cumsum(first, 0)
    seg = kcum - 1
    # starts[j] = first row of run j; untouched slots stay n, so the run
    # after the last reads n; non-first rows write the junk slot n + 1
    starts = torch.full((n + 2,), n, dtype=torch.int64, device=dev)
    starts.scatter_(0, torch.where(first, seg, n + 1), pos)
    run_start = starts[seg]
    run_end = starts[seg + 1]
    way = None
    if bfirst is not None:
        bseg = torch.cumsum(bfirst, 0) - 1
        btab = torch.zeros(n + 1, dtype=torch.int64, device=dev)
        btab.scatter_(0, torch.where(bfirst, bseg, n), kcum)
        way = kcum - btab[bseg]
    return run_start, run_end, kcum, way


def _scatter_table(bs, ks, pay, way, fits, bits, ways):
    """The [2^bits, ways] key and payload tables: one scatter each of the
    fitting rows into their slots; the rest go to a junk slot that is cut
    off."""
    nb = 1 << bits
    dev = ks.device
    slot = torch.where(fits, bs.to(torch.int64) * ways + way, nb * ways)
    tk = torch.zeros(nb * ways + 1, dtype=torch.int64, device=dev)
    tp = torch.zeros(nb * ways + 1, dtype=torch.int64, device=dev)
    tk.scatter_(0, slot, ks)
    tp.scatter_(0, slot, pay)
    return tk[:-1].view(nb, ways), tp[:-1].view(nb, ways)


def _flags(bs: torch.Tensor, ks: torch.Tensor):
    """Run-start flags (a key or bucket change) and bucket-start flags."""
    m = ks.shape[0]
    first = torch.ones(m, dtype=torch.bool, device=ks.device)
    bfirst = torch.ones(m, dtype=torch.bool, device=ks.device)
    if m > 1:
        bchange = bs[1:] != bs[:-1]
        first[1:] = (ks[1:] != ks[:-1]) | bchange
        bfirst[1:] = bchange
    return first, bfirst


def hash_table_build(keys: torch.Tensor, payload: torch.Tensor, bits: int,
                     ways: int = 8, live: Optional[torch.Tensor] = None
                     ) -> HashTable:
    """Batched build of distinct (among live rows) keys with nonzero
    payloads; dead rows are routed past every real bucket. Keys whose
    within-bucket rank reaches ``ways`` are dropped and counted."""
    nb = 1 << bits
    keys = _u64_bits(keys)
    payload = _u64_bits(payload)
    bucket = _bucket_of(keys, bits)
    if live is not None:
        bucket = torch.where(live, bucket, nb)
    order = torch.sort(bucket, stable=True).indices
    bs, ks, ps = bucket[order], keys[order], payload[order]
    _, first = _flags(bs, ks)   # bucket starts
    run_start, _, _, _ = _run_geometry(first)
    way = torch.arange(ks.shape[0], device=ks.device) - run_start
    is_live = bs < nb
    fits = (way < ways) & is_live
    tk, tp = _scatter_table(bs, ks, ps, way, fits, bits, ways)
    overflow = (~fits & is_live).sum(dtype=torch.int32)
    return HashTable(tk, tp, bits, ways, overflow)


def hash_table_probe(table: HashTable, probe: torch.Tensor) -> torch.Tensor:
    """Payload of each probe key (0 where absent): one gather of the
    bucket's key row and one of its payload row, and a compare of every
    way. Keys are distinct, so at most one way hits."""
    probe = _u64_bits(probe)
    b = _bucket_of(probe, table.bits).long()
    hit = table.keys[b] == probe[:, None]
    prows = table.payload[b]
    prows.masked_fill_(~hit, 0)   # a fresh gather; empty slots hold 0
    return prows.sum(1)


def join_build(build_key: torch.Tensor, ways: int = 8,
               bits: Optional[int] = None,
               live: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, HashTable]:
    """Build from a (possibly duplicated) u64 build-key column.

    One stable sort by (bucket, key) serves the run detection and the
    placement. Each distinct key enters the table once, with payload
    ``(run_start + 1) << 32 | count`` into the returned build order
    (bucket-major, key-minor, build-row order within a key). Dead rows
    (``live`` False: null join keys) sort into bucket 2^bits, past every
    real bucket, and are never inserted.

    Returns (build_order int64[m], table)."""
    build_key = _u64_bits(build_key)
    m = build_key.shape[0]
    if bits is None:
        bits = table_bits_for(m, ways)
    nb = 1 << bits
    bucket = _bucket_of(build_key, bits)
    if live is not None:
        bucket = torch.where(live, bucket, nb)
    # the reference's sort keys are (bucket, key, dead flag, row); the
    # dead flag is constant within a bucket (dead rows are bucket nb
    # alone), so a stable sort on (bucket, key) gives the same order
    order = sort_permutation([bucket.to(torch.int64), build_key],
                             [bits + 1, 64])
    bs, ks = bucket[order], build_key[order]
    first, bfirst = _flags(bs, ks)
    run_start, run_end, _, way = _run_geometry(first, bfirst)
    if live is None:
        cnt = run_end - run_start
        ins = first
    else:
        live_sorted = live[order]
        lcum = torch.cat([torch.zeros(1, dtype=torch.int64,
                                      device=ks.device),
                          torch.cumsum(live_sorted, 0)])
        cnt = lcum[run_end] - lcum[run_start]
        ins = first & live_sorted
    pay = ((run_start + 1) << 32) | cnt
    is_live = bs < nb
    fits = ins & (way < ways) & is_live
    tk, tp = _scatter_table(bs, ks, pay, way, fits, bits, ways)
    overflow = (ins & is_live & (way >= ways)).sum(dtype=torch.int32)
    return order, HashTable(tk, tp, bits, ways, overflow)


def join_probe(table: HashTable, probe_key: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo int32, counts int32) of each probe key against the build order
    of ``join_build``; a miss reads (0, 0). Probes PROBE_CHUNK rows at a
    time."""
    n = probe_key.shape[0]
    if n <= PROBE_CHUNK:
        pay = hash_table_probe(table, probe_key)
    else:
        pay = torch.cat([hash_table_probe(table, probe_key[i:i + PROBE_CHUNK])
                         for i in range(0, n, PROBE_CHUNK)])
    counts = (pay & 0xFFFFFFFF).to(torch.int32)
    lo = (_shr(pay, 32) - 1).clamp(min=0).to(torch.int32)
    return lo, counts


# ---- K4: the small sorted-build probe ------------------------------------

@functools.cache
def _kernel():
    fn = load(SOURCE).a1t_broadcast_probe
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _probe_inputs(build_sorted, probe):
    dev = next((x.device for x in (build_sorted, probe)
                if isinstance(x, torch.Tensor)), None) or resolve_device()
    out = []
    for name, x in (("build_sorted", build_sorted), ("probe", probe)):
        x = torch.as_tensor(x, device=dev)
        if x.dtype not in (torch.int64, torch.uint64) or x.dim() != 1:
            raise TypeError(f"broadcast_probe: {name} must be a 1-D int64 "
                            f"or uint64 tensor, got {x.dtype} "
                            f"{tuple(x.shape)}")
        if x.device != dev:
            raise ValueError("broadcast_probe: build and probe on different "
                             "devices")
        out.append(_u64_bits(x))
    if out[0].shape[0] > BROADCAST_T_MAX:
        raise ValueError(f"broadcast_probe: build has {out[0].shape[0]} "
                         f"keys, more than {BROADCAST_T_MAX}")
    return out


def broadcast_probe_plain(build_sorted, probe
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch: every probe key compared with
    every build key (sign bits flipped, so signed order is unsigned
    order), chunked over the probe."""
    build, probe = _probe_inputs(build_sorted, probe)
    b = build ^ _SIGN
    p = probe ^ _SIGN
    n, T = p.shape[0], b.shape[0]
    lo = torch.zeros(n, dtype=torch.int32, device=p.device)
    cnt = torch.zeros(n, dtype=torch.int32, device=p.device)
    step = max(1, (1 << 25) // max(T, 1))
    for i in range(0, n, step):
        pc = p[i:i + step, None]
        lo[i:i + step] = (b[None, :] < pc).sum(1, dtype=torch.int32)
        cnt[i:i + step] = (b[None, :] == pc).sum(1, dtype=torch.int32)
    return lo, cnt


def broadcast_probe(build_sorted, probe) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo int32[n], counts int32[n]) of each u64 probe key against a
    sorted u64 build array of at most BROADCAST_T_MAX keys: the number of
    build keys unsigned-smaller than it, and the number equal to it. Keys
    are int64 bit patterns (or uint64). Inputs that are not tensors are
    placed on CUDA. Counts its kernel launches in
    ``broadcast_probe.launches``."""
    build, probe = _probe_inputs(build_sorted, probe)
    if probe.device.type == "cpu":
        return broadcast_probe_plain(build, probe)
    if probe.device.type != "cuda":
        raise TypeError(f"broadcast_probe: no kernel for device "
                        f"{probe.device}")
    n, T = probe.shape[0], build.shape[0]
    if n == 0 or T == 0:   # nothing to launch: every count is 0
        return (torch.zeros(n, dtype=torch.int32, device=probe.device),
                torch.zeros(n, dtype=torch.int32, device=probe.device))
    # the kernel writes every element, with 16-byte stores into these
    # fresh allocations; its 16-byte loads want the inputs aligned too
    lo = torch.empty(n, dtype=torch.int32, device=probe.device)
    cnt = torch.empty(n, dtype=torch.int32, device=probe.device)
    build, probe = aligned(build, 16), aligned(probe, 16)
    err = _kernel()(build.data_ptr(), T, probe.data_ptr(), n, lo.data_ptr(),
                    cnt.data_ptr(),
                    torch.cuda.current_stream(probe.device).cuda_stream)
    if err:
        raise RuntimeError(f"broadcast_probe kernel launch failed: CUDA "
                           f"error {err}")
    broadcast_probe.launches += 1
    return lo, cnt


broadcast_probe.launches = 0
