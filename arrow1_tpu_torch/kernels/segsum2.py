"""Per-group occupancy, live counts and exact 64-bit sums over dense group
ids (K3).

``segment_sums(gid, cols, G) -> (occ, [(cnt, sum), ...])`` is the contract
of arrow1_tpu/kernels/segsum2.py:segment_sums_mxu without the TPU's 8-bit
planes, bias and 128-multiple padding:

- ``gid``: int32[n]; rows whose id lies outside ``[0, G)`` (the
  reference's dead/pad id ``G``) count nowhere;
- ``cols``: one ``(values, live)`` pair per column, ``values`` int64[n] or
  None (count only), ``live`` bool[n] or None (every row live);
- ``occ``: int64[G], the rows of each group;
- per column ``cnt``: int64[G], the live rows of each group (``occ``
  itself when ``live`` is None), and ``sum``: int64[G], the sum of the
  live values mod 2^64 as an int64 bit pattern (None without values).

Callers widen narrower integers to int64 first: sign-extended for signed
types, zero-extended for unsigned ones.

On a CUDA tensor it launches the kernel in ``csrc/segment_sums.cu``; on a
CPU tensor it runs ``segment_sums_plain``, the same function in plain
PyTorch. Any other device raises. See the source for the bound and the
design. ``plan`` chooses the kernel's regime from the shape alone: every
CTA holds all G groups in shared memory (``private``); the CTAs of a
cluster share the groups' counts out and the sums go straight to the
output (``owned``); or rows add straight into the output (``global``).
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import build

__all__ = ["segment_sums", "segment_sums_plain", "plan", "Plan",
           "launches", "MAX_G", "SOURCE"]

SOURCE = "segment_sums.cu"
# The dense-key group-by takes this path up to MAX_G groups, as the
# reference does (its sorted path takes larger key ranges).
MAX_G = 1 << 17
MAX_COLS = 32          # columns a launch takes (csrc/segment_sums.cu)
PRIVATE_CLUSTER = 4    # CTAs that add up their private partials together
OWNED_MAX_CLUSTER = 8  # the largest portable cluster
ROW_CHUNK = 1 << 31    # rows a launch takes: its 32-bit counts cannot wrap
MODES = {"private": 0, "owned": 1, "global": 2}

Cols = Sequence[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]
Result = Tuple[torch.Tensor,
               List[Tuple[torch.Tensor, Optional[torch.Tensor]]]]


@functools.cache
def _kernel():
    """The launcher and the shared memory a CTA may opt in to."""
    lib = build.load(SOURCE)
    fn = lib.a1t_segment_sums
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 6 +
                   [ctypes.c_void_p] * 4 + [ctypes.c_int64] +
                   [ctypes.c_void_p, ctypes.c_int64] * 2 +
                   [ctypes.c_int64] + [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    optin = ctypes.c_int64()
    err = lib.a1t_segment_sums_smem_optin(ctypes.byref(optin))
    if err:
        raise RuntimeError(f"segment_sums: CUDA error {err} reading the "
                           "shared-memory limit")
    return fn, optin.value


class Plan(NamedTuple):
    """A launch's regime: ``mode`` (see module docstring), the CTAs of a
    cluster, the groups each CTA holds in shared memory and, for
    ``owned``, log2 of that (CTA r owns groups [r << shift, (r + 1) <<
    shift))."""
    mode: str
    cluster: int
    groups: int
    shift: int = 0


def plan(G: int, ncnt: int, nsum: int, smem_bytes: int) -> Plan:
    """The regime of a launch with ``ncnt`` 32-bit count slots and
    ``nsum`` 64-bit sum slots per group, where a CTA may use
    ``smem_bytes`` of shared memory: by shape alone. ``private`` while
    one CTA holds every slot of every group; else ``owned`` while a
    cluster of at most OWNED_MAX_CLUSTER CTAs (a power of two, at least
    2) holds the counts, 2^shift groups a CTA; else ``global``."""
    if G * (4 * ncnt + 8 * nsum) <= smem_bytes:
        return Plan("private", PRIVATE_CLUSTER, G)
    most = (smem_bytes // (4 * ncnt)).bit_length() - 1 if ncnt else -1
    if most >= 0:
        cluster = 2
        while cluster << most < G:
            cluster *= 2
        if cluster <= OWNED_MAX_CLUSTER:
            shift = (-(-G // cluster) - 1).bit_length()
            return Plan("owned", cluster, 1 << shift, shift)
    return Plan("global", 1, G)


class Launch(NamedTuple):
    """One kernel launch: its columns, and per column its count and sum
    slot (-1: none); the output rows of its count and sum slots; the count
    slot of the occupancy (-1: none)."""
    cols: range
    cnt: List[int]
    sum: List[int]
    cnt_out: List[int]
    sum_out: List[int]
    occ: int


def launches(cnt_rows: Sequence[int], sum_rows: Sequence[int]
             ) -> List[Launch]:
    """The columns taken ``MAX_COLS`` at a time, each launch with its own
    slots; the first also counts the occupancy into output row 0. A launch
    with no slot is left out."""
    out = []
    for c0 in range(0, max(len(cnt_rows), 1), MAX_COLS):
        cols = range(c0, min(c0 + MAX_COLS, len(cnt_rows)))
        cnt_out, sum_out = ([0] if c0 == 0 else []), []
        cnt, sums = [], []
        for c in cols:
            cnt.append(len(cnt_out) if cnt_rows[c] >= 0 else -1)
            cnt_out += [cnt_rows[c]] if cnt_rows[c] >= 0 else []
            sums.append(len(sum_out) if sum_rows[c] >= 0 else -1)
            sum_out += [sum_rows[c]] if sum_rows[c] >= 0 else []
        if cnt_out or sum_out:
            out.append(Launch(cols, cnt, sums, cnt_out, sum_out,
                              0 if c0 == 0 else -1))
    return out


def _check(gid: torch.Tensor, cols: Cols, G: int) -> None:
    if gid.dtype != torch.int32 or gid.dim() != 1:
        raise TypeError(f"segment_sums: gid must be a 1-D int32 tensor, got "
                        f"{gid.dtype} of shape {tuple(gid.shape)}")
    if G < 1:
        raise ValueError(f"segment_sums: G must be positive, got {G}")
    for vals, live in cols:
        for t, dtype in ((vals, torch.int64), (live, torch.bool)):
            if t is None:
                continue
            if t.dtype != dtype or t.shape != gid.shape:
                raise TypeError(f"segment_sums: expected {dtype} of shape "
                                f"{tuple(gid.shape)}, got {t.dtype} of "
                                f"shape {tuple(t.shape)}")
            if t.device != gid.device:
                raise ValueError(f"segment_sums: column on {t.device}, gid "
                                 f"on {gid.device}")


def _slots(cols: Cols) -> Tuple[List[int], List[int], int]:
    """Rows of the [slots, G] output: 0 is the occupancy, then each
    column's live count (if it has a mask) and sum (if it has values)."""
    cnt, sums, nslots = [], [], 1
    for vals, live in cols:
        cnt.append(nslots if live is not None else -1)
        nslots += live is not None
        sums.append(nslots if vals is not None else -1)
        nslots += vals is not None
    return cnt, sums, nslots


def segment_sums_plain(gid: torch.Tensor, cols: Cols, G: int) -> Result:
    """The same function in plain PyTorch: ``bincount`` and ``index_add_``
    over the in-range rows (out-of-range rows go to a dropped bin G)."""
    cols = list(cols)
    _check(gid, cols, G)
    idx = torch.where((gid >= 0) & (gid < G), gid, G).to(torch.int64)
    occ = torch.bincount(idx, minlength=G + 1)[:G]
    results = []
    for vals, live in cols:
        cnt = occ
        if live is not None:
            cnt = torch.zeros(G + 1, dtype=torch.int64, device=gid.device)
            cnt = cnt.index_add_(0, idx, live.to(torch.int64))[:G]
        s = None
        if vals is not None:
            v = vals if live is None else torch.where(live, vals, 0)
            s = torch.zeros(G + 1, dtype=torch.int64, device=gid.device)
            s = s.index_add_(0, idx, v)[:G]
        results.append((cnt, s))
    return occ, results


def segment_sums(gid: torch.Tensor, cols: Cols, G: int) -> Result:
    """Occupancy, live counts and mod-2^64 sums per group in one kernel
    call (see module docstring). Counts its launches in
    ``segment_sums.launches``."""
    cols = list(cols)
    _check(gid, cols, G)
    if gid.device.type == "cpu":
        return segment_sums_plain(gid, cols, G)
    if gid.device.type != "cuda":
        raise TypeError(f"segment_sums: no kernel for device {gid.device}")
    cnt_slots, sum_slots, nslots = _slots(cols)
    out = torch.zeros((nslots, G), dtype=torch.int64, device=gid.device)
    n = gid.shape[0]
    if n:   # an empty grid is an invalid launch
        fn, smem = _kernel()
        # 16-byte loads of ids and values, 4-byte loads of live bytes
        g = build.aligned(gid, 16)
        vals = [None if v is None else build.aligned(v, 16) for v, _ in cols]
        live = [None if m is None else build.aligned(m, 4) for _, m in cols]
        stream = torch.cuda.current_stream(gid.device).cuda_stream
        for ln in launches(cnt_slots, sum_slots):
            p = plan(G, len(ln.cnt_out), len(ln.sum_out), smem)
            k = max(len(ln.cols), 1)
            tables = [(ctypes.c_int64 * max(len(x), 1))(*x)
                      for x in (ln.cnt, ln.sum, ln.cnt_out, ln.sum_out)]
            for r0 in range(0, n, ROW_CHUNK):   # each from row r0's address
                rows = min(ROW_CHUNK, n - r0)
                err = fn(
                    g.data_ptr() + 4 * r0, rows, G, MODES[p.mode],
                    p.cluster, p.groups, p.shift,
                    (ctypes.c_void_p * k)(*[0 if vals[c] is None else
                                            vals[c].data_ptr() + 8 * r0
                                            for c in ln.cols]),
                    (ctypes.c_void_p * k)(*[0 if live[c] is None else
                                            live[c].data_ptr() + r0
                                            for c in ln.cols]),
                    tables[0], tables[1], len(ln.cols), tables[2],
                    len(ln.cnt_out), tables[3], len(ln.sum_out), ln.occ,
                    out.data_ptr(), stream)
                if err:
                    raise RuntimeError(f"segment_sums kernel launch failed: "
                                       f"CUDA error {err}")
        segment_sums.launches += 1
    results = [(out[c] if c >= 0 else out[0], out[s] if s >= 0 else None)
               for c, s in zip(cnt_slots, sum_slots)]
    return out[0], results


segment_sums.launches = 0
