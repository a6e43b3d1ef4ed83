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
design.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

from . import build

__all__ = ["segment_sums", "segment_sums_plain", "MAX_G", "SOURCE"]

SOURCE = "segment_sums.cu"
# The dense-key group-by takes this path up to MAX_G groups, as the
# reference does (its sorted path takes larger key ranges).
MAX_G = 1 << 17

Cols = Sequence[Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]]
Result = Tuple[torch.Tensor,
               List[Tuple[torch.Tensor, Optional[torch.Tensor]]]]


@functools.cache
def _kernel():
    fn = build.load(SOURCE).a1t_segment_sums
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
        g = gid.contiguous()
        vals = [None if v is None else v.contiguous() for v, _ in cols]
        live = [None if m is None else m.contiguous() for _, m in cols]
        k = max(len(cols), 1)
        err = _kernel()(
            g.data_ptr(), n, G,
            (ctypes.c_void_p * k)(*[0 if v is None else v.data_ptr()
                                    for v in vals]),
            (ctypes.c_void_p * k)(*[0 if m is None else m.data_ptr()
                                    for m in live]),
            (ctypes.c_int64 * k)(*cnt_slots), (ctypes.c_int64 * k)(*sum_slots),
            len(cols), out.data_ptr(),
            torch.cuda.current_stream(gid.device).cuda_stream)
        if err:
            raise RuntimeError(f"segment_sums kernel launch failed: CUDA "
                               f"error {err}")
        segment_sums.launches += 1
    results = [(out[c] if c >= 0 else out[0], out[s] if s >= 0 else None)
               for c, s in zip(cnt_slots, sum_slots)]
    return out[0], results


segment_sums.launches = 0
