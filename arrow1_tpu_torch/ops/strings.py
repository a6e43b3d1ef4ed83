"""String kernels (counterpart of arrow1_tpu/ops/strings.py; reference:
cpp/src/arrow/compute/kernels/scalar_string.cc).

Every string column is dictionary-encoded, so a string kernel computes
its function once per value of the pool and the rows see one gather by
their codes on the column's device:

  transforms (upper, trim, replace, pad, ...): a new pool, codes kept
  predicates (utf8_is_*, match_*, ...):        a bool table, gathered
  measures (binary_length, utf8_length, ...):  an int32 table, gathered

The ASCII and byte family runs over the pool's byte matrix on the
column's device (ops/strings_device.py); the Unicode, regex, pad, slice,
normalize and replace tail runs on the host over the values alone
(ops/strings_host.py). A pool the port makes holds each value once: a
transform that maps two values to one merges their codes (one gather),
so grouping, compares and joins on the result see equal strings as one.
The JAX package keeps the codes, and its two codes of one string group
and compare as two.

``extract_regex`` gives a StructColumn of one string field per named
group and ``extract_regex_span`` a StructColumn of one
fixed_size_list<int32>[2] ([byte offset, byte length]) per group, as the
JAX package's do. The split family splits each pool value once on the
host (a pool of the pieces, each once) and builds the rows' lists on the
device: offsets from the values' piece counts, the pieces' codes by one
gather of the expanded ranges. ``binary_join`` joins each distinct list
of codes (and separator) once on the host; the rows take their string by
one gather.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .. import dtypes as dt
from ..column import Column, Dictionary, ListColumn, StructColumn
from ..datum import Scalar
from ..errors import Invalid
from ..registry import register_function
from .common import intersect_validity
from .selection import expand_ranges

__all__ = ["MatchSubstringOptions", "SplitOptions", "SplitPatternOptions",
           "ReplaceSubstringOptions",
           "ExtractRegexOptions", "TrimOptions", "PadOptions",
           "SliceOptions", "JoinOptions", "ReplaceSliceOptions",
           "NormalizeOptions", "ZeroFillOptions", "with_pool"]


@dataclasses.dataclass
class MatchSubstringOptions:
    """Reference: api_scalar.h:45."""

    pattern: str = ""
    ignore_case: bool = False


@dataclasses.dataclass
class SplitOptions:
    """Reference: api_scalar.h SplitOptions."""

    max_splits: Optional[int] = None
    reverse: bool = False


@dataclasses.dataclass
class SplitPatternOptions:
    pattern: str = ""
    max_splits: Optional[int] = None
    reverse: bool = False


@dataclasses.dataclass
class ReplaceSubstringOptions:
    pattern: str = ""
    replacement: str = ""
    max_replacements: Optional[int] = None


@dataclasses.dataclass
class ExtractRegexOptions:
    pattern: str = ""


@dataclasses.dataclass
class TrimOptions:
    characters: str = ""


@dataclasses.dataclass
class PadOptions:
    width: int = 0
    padding: str = " "


@dataclasses.dataclass
class SliceOptions:
    start: int = 0
    stop: Optional[int] = None
    step: int = 1


@dataclasses.dataclass
class JoinOptions:
    """Reference: api_scalar.h JoinOptions (null_handling in emit_null,
    skip, replace)."""

    null_handling: str = "emit_null"
    null_replacement: str = ""


@dataclasses.dataclass
class ReplaceSliceOptions:
    start: int = 0
    stop: int = 0
    replacement: str = ""


@dataclasses.dataclass
class NormalizeOptions:
    form: str = "NFC"


@dataclasses.dataclass
class ZeroFillOptions:
    width: int = 0
    padding: str = "0"


def _require_string(col, name):
    if isinstance(col, Scalar) or not col.dtype.is_binary:
        raise Invalid(f"{name}: expected a string/binary array")


def _codes(col: Column) -> torch.Tensor:
    """The codes, clamped into the pool (a null slot may hold any)."""
    return col.data.clamp(0, max(len(col.dictionary) - 1, 0))


def _gather(table: torch.Tensor, col: Column) -> torch.Tensor:
    """Per-value ``table`` (on the column's device) to rows: one gather."""
    return torch.index_select(table, 0, _codes(col))


def with_pool(codes: torch.Tensor, dtype: dt.DataType, validity,
              values: np.ndarray, matrix=None) -> Column:
    """A string column of ``codes`` into ``values``, with each value once
    in the pool: codes of repeated values are merged by one gather.
    ``matrix`` seeds the pool's byte-matrix cache (device -> (bytes,
    lengths)) when the values are already distinct."""
    values = np.asarray(values, dtype=object)
    if len(set(values.tolist())) == len(values):
        d = Dictionary(values)
        if matrix is not None:
            d._byte_matrix.update(matrix)
        return Column(codes, dtype, validity=validity, dictionary=d)
    uniq, inv = np.unique(values, return_inverse=True)
    remap = torch.from_numpy(inv.reshape(-1).astype(np.int32)).to(
        codes.device)
    merged = torch.index_select(remap, 0, codes.clamp(0, len(values) - 1))
    return Column(merged, dtype, validity=validity,
                  dictionary=Dictionary(uniq.astype(object)))


def _is_string(t: dt.DataType) -> bool:
    return t.kind in ("string", "large_string")


def _dict_transform(name):
    """A transform of the pool's values: a new pool, codes kept (or
    merged, ``with_pool``). The ASCII family runs over the byte matrix on
    the column's device; the rest on the host."""

    def exec_fn(args, options, ctx):
        from .strings_device import native_transform
        from .strings_host import host_transform

        (col,) = args
        _require_string(col, name)
        d = native_transform(name, col.dictionary, options,
                             _is_string(col.dtype), col.device)
        if d is not None:
            return with_pool(col.data, col.dtype, col.validity, d.values,
                             d._byte_matrix)
        values = host_transform(name, list(col.dictionary.values), options)
        return with_pool(col.data, col.dtype, col.validity, values)

    return exec_fn


def _dict_lut(name, out_type: dt.DataType):
    """A predicate or measure of the pool's values as a table on the
    column's device (the byte matrix for the ASCII family, the host tail
    otherwise), gathered to the rows."""

    def exec_fn(args, options, ctx):
        from .strings_device import native_predicate_lut
        from .strings_host import host_measure

        (col,) = args
        _require_string(col, name)
        phys = out_type.physical_dtype()
        d = col.dictionary
        if not len(d):
            return Column(torch.zeros(col.length, dtype=phys,
                                      device=col.device), out_type,
                          validity=col.validity)
        lut = native_predicate_lut(name, d, options, col.device)
        if lut is None:
            lut = torch.from_numpy(np.asarray(
                host_measure(name, list(d.values), options)).astype(
                    out_type.numpy_dtype())).to(col.device)
        return Column(_gather(lut.to(phys), col), out_type,
                      validity=col.validity)

    return exec_fn


# ---- transforms (reference: case mapping and trim kernels) ----
for _name in ["ascii_upper", "ascii_lower", "ascii_swapcase",
              "ascii_capitalize", "ascii_title", "ascii_reverse",
              "utf8_upper", "utf8_lower", "utf8_swapcase",
              "utf8_capitalize", "utf8_title", "utf8_reverse",
              "ascii_ltrim_whitespace", "ascii_rtrim_whitespace",
              "ascii_trim_whitespace", "utf8_ltrim_whitespace",
              "utf8_rtrim_whitespace", "utf8_trim_whitespace",
              "binary_reverse"]:
    register_function(_name, "scalar", 1)(_dict_transform(_name))

for _name, _opts in [("ascii_trim", TrimOptions), ("ascii_ltrim", TrimOptions),
                     ("ascii_rtrim", TrimOptions), ("utf8_trim", TrimOptions),
                     ("utf8_ltrim", TrimOptions), ("utf8_rtrim", TrimOptions),
                     ("replace_substring", ReplaceSubstringOptions),
                     ("replace_substring_regex", ReplaceSubstringOptions),
                     ("utf8_slice_codeunits", SliceOptions),
                     ("binary_slice", SliceOptions),
                     ("binary_replace_slice", ReplaceSliceOptions),
                     ("utf8_replace_slice", ReplaceSliceOptions),
                     ("utf8_normalize", NormalizeOptions),
                     ("utf8_zero_fill", ZeroFillOptions),
                     ("utf8_lpad", PadOptions), ("utf8_rpad", PadOptions),
                     ("utf8_center", PadOptions), ("ascii_lpad", PadOptions),
                     ("ascii_rpad", PadOptions), ("ascii_center", PadOptions)]:
    register_function(_name, "scalar", 1, _opts)(_dict_transform(_name))


# ---- predicates and measures ----
for _name in ["ascii_is_alnum", "ascii_is_alpha", "ascii_is_decimal",
              "ascii_is_lower", "ascii_is_printable", "ascii_is_space",
              "ascii_is_title", "ascii_is_upper",
              "utf8_is_alnum", "utf8_is_alpha", "utf8_is_decimal",
              "utf8_is_digit", "utf8_is_lower", "utf8_is_numeric",
              "utf8_is_printable", "utf8_is_space", "utf8_is_title",
              "utf8_is_upper", "string_is_ascii"]:
    register_function(_name, "scalar", 1)(_dict_lut(_name, dt.bool_))

for _name in ["match_substring", "match_substring_regex", "starts_with",
              "ends_with", "match_like"]:
    register_function(_name, "scalar", 1, MatchSubstringOptions)(
        _dict_lut(_name, dt.bool_))

for _name in ["binary_length", "utf8_length"]:
    register_function(_name, "scalar", 1)(_dict_lut(_name, dt.int32))

for _name in ["count_substring", "find_substring", "count_substring_regex",
              "find_substring_regex"]:
    register_function(_name, "scalar", 1, MatchSubstringOptions)(
        _dict_lut(_name, dt.int32))


# ---- extract_regex and extract_regex_span: struct results ----

def _extract_validity(col: Column, matched) -> torch.Tensor:
    """Rows whose value matched (and is not null)."""
    lut = torch.from_numpy(np.asarray(matched, dtype=bool)).to(col.device)
    valid = _gather(lut, col) if len(matched) else \
        torch.zeros(col.length, dtype=torch.bool, device=col.device)
    return valid if col.validity is None else valid & col.validity


def _extract_regex_exec(args, options: ExtractRegexOptions, ctx):
    """A struct of one string field per named group; a row whose value
    does not match is a null struct, and null in every field."""
    from .strings_host import host_extract

    (col,) = args
    _require_string(col, "extract_regex")
    if not options or not options.pattern:
        raise Invalid("extract_regex requires pattern")
    names, rows = host_extract(options.pattern, list(col.dictionary.values))
    valid = _extract_validity(col, [r is not None for r in rows])
    empty = "" if _is_string(col.dtype) else b""
    cols = [with_pool(_codes(col), col.dtype, valid,
                      [empty if r is None else r[g] for r in rows])
            for g in names]
    return StructColumn(cols, names, dt.struct([(g, col.dtype)
                                                for g in names]),
                        validity=valid)


def _extract_regex_span_exec(args, options: ExtractRegexOptions, ctx):
    """A struct of one fixed_size_list<int32>[2] per named group: the
    group's [byte offset, byte length] ([-1, 0] for a group that took no
    part in the match); a row whose value does not match is null, in the
    struct and every field."""
    from .strings_host import host_extract_span

    (col,) = args
    _require_string(col, "extract_regex_span")
    if not options or not options.pattern:
        raise Invalid("extract_regex_span requires pattern")
    names, rows = host_extract_span(options.pattern,
                                    list(col.dictionary.values))
    valid = _extract_validity(col, [r is not None for r in rows])
    n, dev = col.length, col.device
    pair_t = dt.fixed_size_list(dt.int32, 2)
    offsets = torch.arange(n + 1, dtype=torch.int64, device=dev) * 2
    item_valid = valid.repeat_interleave(2)
    cols = []
    for g in names:
        table = torch.tensor([[0, 0] if r is None else r[g] for r in rows],
                             dtype=torch.int32).reshape(-1, 2).to(dev)
        pairs = torch.index_select(table, 0, _codes(col)) if len(rows) \
            else torch.zeros((n, 2), dtype=torch.int32, device=dev)
        cols.append(ListColumn(offsets, Column(pairs.reshape(-1), dt.int32,
                                               validity=item_valid),
                               pair_t, validity=valid))
    return StructColumn(cols, names, dt.struct([(g, pair_t)
                                                for g in names]),
                        validity=valid)


register_function("extract_regex", "scalar", 1, ExtractRegexOptions)(
    _extract_regex_exec)
register_function("extract_regex_span", "scalar", 1, ExtractRegexOptions)(
    _extract_regex_span_exec)


# ---- the split family: a pool of pieces, lists built on the device ----

def _split_exec(name):
    def exec_fn(args, options, ctx):
        from .strings_host import host_split

        (col,) = args
        _require_string(col, name)
        dev = col.device
        if options is None:
            if name.startswith("split_pattern"):
                raise Invalid(f"{name} requires a pattern")
            options = SplitOptions()
        pieces = host_split(name, list(col.dictionary.values), options)
        counts = np.fromiter(map(len, pieces), np.int64, len(pieces))
        starts = np.zeros(len(pieces) + 1, dtype=np.int64)
        np.cumsum(counts, out=starts[1:])
        pool = {}   # each piece once, in first-appearance order
        piece_codes = np.fromiter(
            (pool.setdefault(p, len(pool)) for parts in pieces
             for p in parts), np.int32, int(starts[-1]))
        code_len = torch.from_numpy(counts).to(dev)
        lengths = _gather(code_len, col) if len(pieces) else \
            torch.zeros(col.length, dtype=torch.int64, device=dev)
        if col.validity is not None:
            lengths = torch.where(col.validity, lengths, 0)
        first = torch.from_numpy(starts[:-1]).to(dev)
        rows, _, offsets = expand_ranges(
            _gather(first, col) if len(pieces) else lengths, lengths)
        table = torch.from_numpy(piece_codes).to(dev)
        child = Column(torch.index_select(table, 0, rows) if len(table)
                       else torch.zeros(0, dtype=torch.int32, device=dev),
                       col.dtype, dictionary=Dictionary(
                           np.array(list(pool), dtype=object)))
        return ListColumn(offsets, child, dt.list_(col.dtype),
                          validity=col.validity)

    return exec_fn


register_function("split_pattern", "scalar", 1, SplitPatternOptions)(
    _split_exec("split_pattern"))
register_function("split_pattern_regex", "scalar", 1, SplitPatternOptions)(
    _split_exec("split_pattern_regex"))
register_function("ascii_split_whitespace", "scalar", 1, SplitOptions)(
    _split_exec("ascii_split_whitespace"))
register_function("utf8_split_whitespace", "scalar", 1, SplitOptions)(
    _split_exec("utf8_split_whitespace"))


# ---- row-wise: binary_join_element_wise and binary_repeat ----

def _distinct_rows(parts):
    """(distinct rows of the int64 columns ``parts``, as a host array
    [k, len(parts)], and each row's index among them, int32): one sort
    on the device, of one mixed-radix key when the parts' ranges fit in
    62 bits (one sync reads them), else of the rows."""
    stacked = torch.stack(parts, dim=1)
    if stacked.shape[0] == 0:   # no row: nothing to reduce
        return (np.empty((0, len(parts)), dtype=np.int64),
                torch.zeros(0, dtype=torch.int32, device=stacked.device))
    lo, hi = (r.cpu().tolist() for r in torch.aminmax(stacked, dim=0))
    spans = [h - l + 1 for l, h in zip(lo, hi)]
    if np.prod([float(s) for s in spans]) >= 2.0 ** 62:
        uniq, inv = torch.unique(stacked, dim=0, return_inverse=True)
        return uniq.cpu().numpy(), inv.to(torch.int32)
    key = torch.zeros_like(parts[0])
    for p, l, s in zip(parts, lo, spans):
        key = key * s + (p - l)
    uniq, inv = torch.unique(key, return_inverse=True)
    rows = np.empty((len(uniq), len(parts)), dtype=np.int64)
    rest = uniq.cpu().numpy()
    for j in range(len(parts) - 1, -1, -1):
        rest, rows[:, j] = np.divmod(rest, spans[j])
        rows[:, j] += lo[j]
    return rows, inv.to(torch.int32)


def _binary_join_element_wise_exec(args, options: JoinOptions, ctx):
    """Row-wise concatenation of string columns, the last argument being
    the separator (a column or a scalar). Each distinct tuple of codes
    (a null as code -1) is joined once on the host; the rows take their
    tuple's string by one gather. A null separator nulls the row; a null
    value follows ``null_handling``."""
    options = options or JoinOptions()
    nh = options.null_handling
    if nh not in ("emit_null", "skip", "replace"):
        raise Invalid(f"bad null_handling {nh!r}")
    cols, sep = list(args[:-1]), args[-1]
    for c in cols:
        _require_string(c, "binary_join_element_wise")
    if not cols:
        raise Invalid("binary_join_element_wise needs a value column")
    if not isinstance(sep, Scalar):
        _require_string(sep, "binary_join_element_wise")
        cols.append(sep)
    n = cols[0].length
    dev = cols[0].device
    parts = []
    for c in cols:
        if c.length != n:
            raise Invalid(f"length mismatch: {c.length} vs {n}")
        code = c.data.to(torch.int64)
        parts.append(code if c.validity is None else
                     torch.where(c.validity, code, -1))
    uniq, inv = _distinct_rows(parts)
    pools = [c.dictionary.values for c in cols]
    sep_value = None if not isinstance(sep, Scalar) else sep.as_py()
    empty = "" if _is_string(cols[0].dtype) else b""
    values, ok = [], []
    for row in uniq.tolist():
        vals = [None if code < 0 else pools[i][code]
                for i, code in enumerate(row)]
        s = vals.pop() if sep_value is None and not isinstance(sep, Scalar) \
            else sep_value
        if s is None or (nh == "emit_null" and None in vals):
            values.append(empty)
            ok.append(False)
            continue
        if nh == "skip":
            vals = [v for v in vals if v is not None]
        elif nh == "replace":
            vals = [options.null_replacement if v is None else v
                    for v in vals]
        values.append(s.join(vals))
        ok.append(True)
    valid = torch.index_select(torch.tensor(ok, dtype=torch.bool).to(dev),
                               0, inv) if len(ok) else \
        torch.zeros(n, dtype=torch.bool, device=dev)
    return with_pool(inv, cols[0].dtype, valid, values)


def _binary_repeat_exec(args, options, ctx):
    """binary_repeat(strings, n): each value repeated n times. A scalar n
    transforms the pool; a column n joins each distinct (code, n) pair
    once on the host, gathered by the rows. A null n nulls the row, as in
    pyarrow."""
    col, count = args
    _require_string(col, "binary_repeat")
    if count.dtype.is_binary or not (count.dtype.is_integer):
        raise Invalid("binary_repeat: the count must be an integer")
    if isinstance(count, Scalar):
        if not count.is_valid:
            return Column(col.data, col.dtype, validity=torch.zeros(
                col.length, dtype=torch.bool, device=col.device),
                dictionary=col.dictionary)
        k = int(count.as_py())
        return with_pool(col.data, col.dtype, col.validity,
                         [v * k for v in col.dictionary.values])
    uniq, inv = _distinct_rows([_codes(col).to(torch.int64),
                                count.data.to(torch.int64)])
    pool = col.dictionary.values
    values = [pool[code] * int(k) for code, k in uniq.tolist()]
    return with_pool(inv, col.dtype, intersect_validity(
        [col.validity, count.validity]), values)


register_function("binary_join_element_wise", "scalar", -1, JoinOptions)(
    _binary_join_element_wise_exec)
register_function("binary_repeat", "scalar", 2)(_binary_repeat_exec)


def _binary_join_exec(args, options, ctx):
    """binary_join(list<string>, separator): each slot's items joined by
    the separator (a scalar or a string column); a null list, a null
    separator or a null item gives null (reference: scalar_string.cc
    BinaryJoin). Each distinct (items' codes, separator's code) tuple is
    joined once on the host; the rows take their string by one gather."""
    lists, sep = args
    if not isinstance(lists, ListColumn) or \
            not isinstance(lists.values, Column) or \
            not lists.values.dtype.is_binary:
        raise TypeError("binary_join: expected a list of strings")
    items = lists.values
    n, dev = lists.length, lists.device
    lengths = lists.value_lengths()
    width = int(lengths.max()) if n else 0
    code = items.data.to(torch.int64)
    if items.validity is not None:   # a null item: code -2
        code = torch.where(items.validity, code, -2)
    parts = []
    for j in range(width):   # -1 past a slot's end
        at = (lists.offsets[:-1] + j).clamp(max=max(items.length - 1, 0))
        parts.append(torch.where(lengths > j, code[at], -1))
    valid = lists.mask()
    if isinstance(sep, Scalar):
        sep_values = [sep.as_py()] if sep.is_valid else []
        parts.append(torch.zeros(n, dtype=torch.int64, device=dev))
    else:
        _require_string(sep, "binary_join")
        sep_values = sep.dictionary.values
        parts.append(_codes(sep).to(torch.int64))
        if sep.validity is not None:
            valid = valid & sep.validity
    uniq, inv = _distinct_rows(parts) if n else \
        (np.zeros((0, len(parts)), np.int64),
         torch.zeros(0, dtype=torch.int32, device=dev))
    pool = items.dictionary.values
    empty = "" if _is_string(items.dtype) else b""
    values, ok = [], []
    for row in uniq.tolist():
        *codes, s = row
        if -2 in codes or not len(sep_values):
            values.append(empty)
            ok.append(False)
            continue
        values.append(sep_values[s].join(pool[c] for c in codes if c >= 0))
        ok.append(True)
    if ok:
        valid = valid & torch.index_select(
            torch.tensor(ok, dtype=torch.bool).to(dev), 0, inv)
    return with_pool(inv, items.dtype, valid, values)


register_function("binary_join", "scalar", 2)(_binary_join_exec)
