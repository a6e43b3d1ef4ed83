"""Helpers for holding nested results of one device against another's:
``move`` copies a column, nested or flat, to a device; ``same_nested``
compares two results over their first rows, child by child. chip_smoke.py's
nested phase holds every call on the card against the same call on CPU
tensors with them; compute_strings.same_result hands its struct results
(extract_regex, extract_regex_span) to ``same_nested``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .column import Column, ListColumn, StructColumn, UnionColumn
from .table import RecordBatch, map_tensors

__all__ = ["move", "same_nested"]


def move(col, device):
    """``col`` (a Column, nested column or RecordBatch) with every tensor
    on ``device``; string pools are shared."""
    return map_tensors(col, lambda t: t.to(device))


def _host(t, k: int) -> np.ndarray:
    return t[:k].cpu().numpy()


def same_nested(got, want, rows: Optional[int] = None, ulps: int = 0
                ) -> Optional[str]:
    """None when ``got``'s first ``rows`` rows (all by default) equal
    ``want``'s: the same types, null masks, offsets and type ids exactly,
    each child over the rows those first rows reach, integers, bools and
    strings exactly (strings by value where the pools differ), floats
    within ``ulps`` units in the last place (NaN equal to NaN); else what
    differs first."""
    if isinstance(want, RecordBatch):
        if not isinstance(got, RecordBatch) or got.names != want.names:
            return f"names {getattr(got, 'names', None)} != {want.names}"
        for name, g, w in zip(want.names, got.columns, want.columns):
            problem = same_nested(g, w, rows, ulps)
            if problem:
                return f"{name}: {problem}"
        return None
    if type(got) is not type(want) or got.dtype != want.dtype:
        return f"{type(got).__name__}<{got.dtype!r}> != " \
            f"{type(want).__name__}<{want.dtype!r}>"
    k = want.length if rows is None else rows
    if got.length < k or (rows is None and got.length != want.length):
        return f"length {got.length} != {want.length}"
    if isinstance(want, UnionColumn):
        if not np.array_equal(_host(got.type_ids, k),
                              _host(want.type_ids, k)):
            return "type ids differ"
        if want.is_dense:
            if not np.array_equal(_host(got.offsets, k),
                                  _host(want.offsets, k)):
                return "union offsets differ"
            k = None   # the children are compared whole
        for i, (g, w) in enumerate(zip(got.children, want.children)):
            problem = same_nested(g, w, k, ulps)
            if problem:
                return f"union child {i}: {problem}"
        return None
    gm, wm = _host(got.mask(), k), _host(want.mask(), k)
    if not np.array_equal(gm, wm):
        return f"null masks differ at {np.flatnonzero(gm != wm)[:5]}"
    if isinstance(want, StructColumn):
        for name, g, w in zip(want.names, got.children, want.children):
            problem = same_nested(g, w, k, ulps)
            if problem:
                return f"field {name}: {problem}"
        return None
    if isinstance(want, ListColumn):
        go, wo = _host(got.offsets, k + 1), _host(want.offsets, k + 1)
        if not np.array_equal(go, wo):
            return f"offsets differ at {np.flatnonzero(go != wo)[:5]}"
        problem = same_nested(got.values, want.values, int(wo[-1]), ulps)
        return None if problem is None else f"items: {problem}"
    return _same_column(got, want, k, wm, ulps)


def _same_column(g: Column, w: Column, k: int, valid: np.ndarray,
                 ulps: int) -> Optional[str]:
    from .compute_tail import _ulp_distance

    if w.dictionary is not None:
        pools = (g.dictionary.values, w.dictionary.values)
        gd = pools[0][_host(g.data, k)[valid]] if len(pools[0]) else \
            np.array([], object)
        wd = pools[1][_host(w.data, k)[valid]] if len(pools[1]) else \
            np.array([], object)
        bad = gd != wd
    else:
        gd, wd = _host(g.data, k)[valid], _host(w.data, k)[valid]
        if gd.dtype.kind == "f":
            nan = np.isnan(gd) | np.isnan(wd)
            bad = np.where(nan, np.isnan(gd) != np.isnan(wd),
                           _ulp_distance(gd, wd) > ulps)
        else:
            bad = gd != wd
        if w.data2 is not None:
            bad = bad | (_host(g.data2, k)[valid] !=
                         _host(w.data2, k)[valid]).reshape(len(bad), -1
                                                          ).any(1)
    if bool(np.any(bad)):
        i = np.flatnonzero(bad)[:3]
        return f"values differ: {gd[i]} != {wd[i]}"
    return None
