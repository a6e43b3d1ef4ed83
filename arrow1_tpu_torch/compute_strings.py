"""One call of every string function of the port (73 names: the ASCII and
byte family on the column's device, the Unicode and regex tail on the
host), for the on-card checks (``chip_smoke.py``,
tests/test_torch_cuda.py) and the CPU tests against the JAX package
(tests/test_torch_strings.py):

    cols = tpch_string_columns(10_000_000, "cuda", customers=1_500_000)
    for name in CALLS:
        out = call(name, cols)

A call names its arguments by key: ``s`` the column under test, ``a`` an
ASCII column (the byte transforms that reject or break multi-byte UTF-8;
the same column when it is ASCII), ``t`` a second string column, ``n`` an
int64 column of repeat counts; any other argument is a literal. The
options pick patterns that hit TPC-H's ``l_shipmode`` and ``c_name``
values. ``route(name)`` says where a name computes its per-value table:
``device`` (the byte matrix, ops/strings_device.py) or ``host``
(ops/strings_host.py, or a host join of distinct rows).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from .column import Column
from .interop import column_from_numpy
from .ops.strings_device import NATIVE_PREDICATES, NATIVE_TRANSFORMS
from .registry import call_function
from .table import RecordBatch

__all__ = ["SHIPMODES", "CALLS", "route", "call", "tpch_string_columns",
           "same_result", "on_device"]

# TPC-H l_shipmode (spec 4.2.2.13)
SHIPMODES = np.array(["REG AIR", "AIR", "RAIL", "SHIP", "TRUCK", "MAIL",
                      "FOB"], dtype=object)

_TRIM = {"characters": "AIR"}
_PAD = {"width": 20, "padding": "*"}
_SLICE = {"start": 1, "stop": 9}
_REPLACE_SLICE = {"start": 2, "stop": 5, "replacement": "xy"}
_GROUPS = {"pattern": "(?P<word>[A-Za-z]+)#?(?P<num>[0-9]*)"}

# name -> (arguments, options)
CALLS = {
    **{name: (("s",), {}) for name in (
        "ascii_upper", "ascii_lower", "ascii_swapcase", "ascii_capitalize",
        "ascii_title", "utf8_upper", "utf8_lower", "utf8_swapcase",
        "utf8_capitalize", "utf8_title", "utf8_reverse",
        "ascii_ltrim_whitespace", "ascii_rtrim_whitespace",
        "ascii_trim_whitespace", "utf8_ltrim_whitespace",
        "utf8_rtrim_whitespace", "utf8_trim_whitespace",
        "ascii_is_alnum", "ascii_is_alpha", "ascii_is_decimal",
        "ascii_is_lower", "ascii_is_printable", "ascii_is_space",
        "ascii_is_title", "ascii_is_upper", "utf8_is_alnum",
        "utf8_is_alpha", "utf8_is_decimal", "utf8_is_digit",
        "utf8_is_lower", "utf8_is_numeric", "utf8_is_printable",
        "utf8_is_space", "utf8_is_title", "utf8_is_upper",
        "string_is_ascii", "binary_length", "utf8_length")},
    "ascii_reverse": (("a",), {}),
    "binary_reverse": (("a",), {}),
    "ascii_trim": (("s",), _TRIM),
    "ascii_ltrim": (("s",), _TRIM),
    "ascii_rtrim": (("s",), _TRIM),
    "utf8_trim": (("s",), {"characters": "Cr0"}),
    "utf8_ltrim": (("s",), {"characters": "Cr0"}),
    "utf8_rtrim": (("s",), {"characters": "Cr0"}),
    "replace_substring": (("s",), {"pattern": "AI", "replacement": "ai"}),
    "replace_substring_regex": (("s",), {"pattern": "0+",
                                         "replacement": "-"}),
    "utf8_slice_codeunits": (("s",), _SLICE),
    "binary_slice": (("a",), _SLICE),
    "utf8_replace_slice": (("s",), _REPLACE_SLICE),
    "binary_replace_slice": (("a",), _REPLACE_SLICE),
    "utf8_normalize": (("s",), {"form": "NFD"}),
    "utf8_zero_fill": (("s",), {"width": 12}),
    "utf8_lpad": (("s",), _PAD),
    "utf8_rpad": (("s",), _PAD),
    "utf8_center": (("s",), _PAD),
    "ascii_lpad": (("s",), _PAD),
    "ascii_rpad": (("s",), _PAD),
    "ascii_center": (("s",), _PAD),
    "match_substring": (("s",), {"pattern": "AI"}),
    "match_substring_regex": (("s",), {"pattern": "^[A-Z][a-z]*#0+1"}),
    "starts_with": (("s",), {"pattern": "Customer#0000"}),
    "ends_with": (("s",), {"pattern": "IL"}),
    "match_like": (("s",), {"pattern": "%r#%1_"}),
    "count_substring": (("s",), {"pattern": "0"}),
    "find_substring": (("s",), {"pattern": "A"}),
    "count_substring_regex": (("s",), {"pattern": "[0-4]"}),
    "find_substring_regex": (("s",), {"pattern": "[5-9]"}),
    "extract_regex": (("s",), _GROUPS),
    "extract_regex_span": (("s",), _GROUPS),
    "binary_join_element_wise": (("s", "t", "/"), {}),
    "binary_repeat": (("a", "n"), {}),
}


def route(name: str) -> str:
    """Where ``name`` computes its per-value table with CALLS' options."""
    native = name in NATIVE_TRANSFORMS or name in NATIVE_PREDICATES
    return "device" if native else "host"


def call(name: str, cols: Dict[str, Column]):
    """CALLS[name] over ``cols``."""
    args, options = CALLS[name]
    return call_function(name, [cols[a] if a in cols else a for a in args],
                         **options)


def tpch_string_columns(n: int, device, customers: int, seed: int = 0
                        ) -> Dict[str, Column]:
    """``n`` rows of TPC-H's ``l_shipmode`` (its seven values) and
    ``c_name`` (``Customer#%09d`` over ``customers`` keys, 1% null), from
    ``seed``, on ``device``, keyed as CALLS' arguments: ``s`` and ``a``
    are ``c_name``, ``t`` is ``l_shipmode``, ``n`` repeat counts in
    [0, 3)."""
    rng = np.random.default_rng(seed)
    names = np.array([f"Customer#{i:09d}" for i in range(1, customers + 1)],
                     dtype=object)
    c_codes = rng.integers(0, customers, n).astype(np.int32)
    c_ok = rng.random(n) >= 0.01
    m_codes = rng.integers(0, len(SHIPMODES), n).astype(np.int32)
    c_name = column_from_numpy(c_codes, c_ok, device=device,
                               dictionary=names)
    return {"s": c_name, "a": c_name,
            "t": column_from_numpy(m_codes, device=device,
                                   dictionary=SHIPMODES),
            "n": column_from_numpy(rng.integers(0, 3, n).astype(np.int64),
                                   device=device)}


def _columns_of(x):
    return list(x.columns) if isinstance(x, RecordBatch) else [x]


def _mask(col: Column, rows: int):
    return col.validity[:rows].cpu().numpy() if col.validity is not None \
        else np.ones(min(rows, col.length), dtype=bool)


def _decoded(col: Column, rows: int) -> np.ndarray:
    """The first ``rows`` values, decoded, as an object array."""
    data = col.data[:rows].cpu().numpy()
    return col.dictionary.values[data].astype(object) \
        if len(col.dictionary) else np.full(len(data), None, object)


def _same_pool(g: Column, w: Column) -> bool:
    return g.dictionary is w.dictionary or (
        len(g.dictionary) == len(w.dictionary)
        and bool(np.all(g.dictionary.values == w.dictionary.values)))


def same_result(got, want, rows: Optional[int] = None) -> Optional[str]:
    """None when ``got``'s first ``rows`` rows (all by default) equal
    ``want``'s: type, names, nulls and values exactly (strings compare
    their codes when the two pools hold the same values in the same
    order, else their decoded values); else the first difference.
    Struct and list results are compared by ``compute_nested``."""
    if not isinstance(want, (Column, RecordBatch)):
        from .compute_nested import same_nested

        return same_nested(got, want, rows)
    gcols, wcols = _columns_of(got), _columns_of(want)
    if len(gcols) != len(wcols):
        return f"{len(gcols)} columns, want {len(wcols)}"
    if isinstance(want, RecordBatch) and got.names != want.names:
        return f"names {got.names}, want {want.names}"
    for g, w in zip(gcols, wcols):
        n = w.length if rows is None else rows
        if g.dtype != w.dtype:
            return f"type {g.dtype!r}, want {w.dtype!r}"
        gm, wm = _mask(g, n), _mask(w, n)
        if len(gm) != len(wm) or not np.array_equal(gm, wm):
            return "null masks differ"
        if g.dictionary is not None and not _same_pool(g, w):
            gv, wv = _decoded(g, n), _decoded(w, n)
        else:
            gv, wv = g.data[:n].cpu().numpy(), w.data[:n].cpu().numpy()
        diff = np.flatnonzero((gv != wv) & gm)
        if len(diff):
            i = int(diff[0])
            return f"row {i}: {gv[i]!r}, want {wv[i]!r}"
    return None


def on_device(cols: Dict[str, Column], device, rows: int
              ) -> Dict[str, Column]:
    """The first ``rows`` rows of each column, on ``device`` (the pools
    are shared)."""
    out = {}
    for key, c in cols.items():
        s = c.slice(0, rows)
        out[key] = Column(s.data.to(device), s.dtype,
                          validity=None if s.validity is None
                          else s.validity.to(device),
                          dictionary=s.dictionary)
    return out

