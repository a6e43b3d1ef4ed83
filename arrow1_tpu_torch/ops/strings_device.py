"""Device string byte kernels: the ASCII and byte family (counterpart of
arrow1_tpu/ops/strings_device.py).

Reference: cpp/src/arrow/compute/kernels/scalar_string.cc, per-row byte
loops. Here a dictionary's values become one padded uint8 matrix
[n_unique, max_len] and an int32 length vector on the column's device,
and every transform, predicate and measure of the family is a handful of
torch operations over the whole matrix. Rows never see bytes: the
callers (ops/strings.py) gather a per-value table by the codes. The
unicode and regex tail runs on the host (ops/strings_host.py).

The matrix is built once per dictionary and device and cached on the
``Dictionary``; a transform's result pool is seeded with its output
matrix, so the next device operation on it builds nothing.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..column import Dictionary
from ..errors import Invalid

__all__ = ["byte_matrix", "NATIVE_TRANSFORMS", "NATIVE_PREDICATES",
           "native_transform", "native_predicate_lut"]

_WS = b" \t\n\r\x0b\x0c"
_LOWER = (ord("a"), ord("z"))
_UPPER = (ord("A"), ord("Z"))
_DIGIT = (ord("0"), ord("9"))


def encode_values(values) -> Tuple[np.ndarray, np.ndarray]:
    """(uint8[u, L] zero-padded, int32[u] byte lengths) of str or bytes
    values, on the host; L >= 1."""
    enc = [v.encode("utf8") if isinstance(v, str) else bytes(v)
           for v in values]
    lens = np.fromiter(map(len, enc), dtype=np.int32, count=len(enc))
    width = max(1, int(lens.max()) if len(enc) else 1)
    mat = np.array(enc, dtype=f"S{width}").view(np.uint8).reshape(
        len(enc), width) if enc else np.zeros((0, width), np.uint8)
    return mat, lens


def byte_matrix(d: Dictionary, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """(bytes uint8[u, L], lengths int32[u]) of the dictionary's values on
    ``device``, built once per dictionary and device."""
    device = torch.device(device)
    cached = d._byte_matrix.get(device)
    if cached is not None:
        return cached
    with d._lock:
        cached = d._byte_matrix.get(device)
        if cached is None:
            mat, lens = encode_values(d.values)
            cached = (torch.from_numpy(mat).to(device),
                      torch.from_numpy(lens).to(device))
            d._byte_matrix[device] = cached
    return cached


def decode_matrix(mat: torch.Tensor, lens: torch.Tensor,
                  is_string: bool) -> np.ndarray:
    """Object array of the rows' first ``lens`` bytes (str when
    ``is_string``, else bytes): one copy of the matrix to the host."""
    m = np.ascontiguousarray(mat.cpu().numpy())
    ln = lens.cpu().numpy()
    out = np.empty(len(ln), dtype=object)
    if not len(ln):
        return out
    rows = m.view(f"S{m.shape[1]}").reshape(-1)   # drops trailing NULs
    raw = rows.tolist()
    short = np.fromiter(map(len, raw), dtype=np.int64, count=len(raw)) != ln
    for i in np.flatnonzero(short):   # a value that ends in NUL bytes
        raw[i] = m[i, :ln[i]].tobytes()
    out[:] = [r.decode("utf8") for r in raw] if is_string else raw
    return out


def _valid(mat, lens):
    """Mask of real (non-padding) byte positions."""
    pos = torch.arange(mat.shape[1], dtype=torch.int32,
                       device=mat.device)[None, :]
    return pos < lens[:, None]


def _in(mat, lo_hi):
    return (mat >= lo_hi[0]) & (mat <= lo_hi[1])


def _is_ws(mat):
    w = torch.zeros(mat.shape, dtype=torch.bool, device=mat.device)
    for c in _WS:
        w = w | (mat == c)
    return w


def _to_upper(mat):
    return torch.where(_in(mat, _LOWER), mat - 32, mat)


def _to_lower(mat):
    return torch.where(_in(mat, _UPPER), mat + 32, mat)


def _positions(mat):
    return torch.arange(mat.shape[1], dtype=torch.int32,
                        device=mat.device)[None, :]


def _shift_left(mat, lens, shift):
    """Per-row left shift by shift[r] (drops the leading prefix)."""
    width = mat.shape[1]
    pos = _positions(mat)
    src = torch.clamp(pos + shift[:, None], max=width - 1).long()
    out = torch.gather(mat, 1, src)
    newlen = torch.clamp(lens - shift, min=0)
    return torch.where(pos < newlen[:, None], out, 0), newlen


def _first_true(mask):
    """(any, index of the first True) per row."""
    return mask.any(dim=1), mask.to(torch.uint8).argmax(dim=1).to(
        torch.int32)


# ---------------------------------------------------------------- transforms

def _t_upper(mat, lens, opts):
    return _to_upper(mat), lens


def _t_lower(mat, lens, opts):
    return _to_lower(mat), lens


def _t_swapcase(mat, lens, opts):
    up, lo = _in(mat, _UPPER), _in(mat, _LOWER)
    return torch.where(up, mat + 32, torch.where(lo, mat - 32, mat)), lens


def _t_capitalize(mat, lens, opts):
    return torch.where(_positions(mat) == 0, _to_upper(mat),
                       _to_lower(mat)), lens


def _prev(mask):
    """mask shifted one position right (False enters at position 0)."""
    return torch.nn.functional.pad(mask[:, :-1], (1, 0), value=False)


def _t_title(mat, lens, opts):
    """Upper-case every letter that follows a non-letter, lower-case the
    rest (pyarrow's ascii_title)."""
    alpha = _in(mat, _LOWER) | _in(mat, _UPPER)
    start = alpha & ~_prev(alpha)
    return torch.where(start, _to_upper(mat),
                       torch.where(alpha, _to_lower(mat), mat)), lens


def _t_reverse(mat, lens, opts):
    width = mat.shape[1]
    pos = _positions(mat)
    src = torch.clamp(lens[:, None] - 1 - pos, 0, width - 1).long()
    out = torch.gather(mat, 1, src)
    return torch.where(pos < lens[:, None], out, 0), lens


def _charset_mask(mat, chars: Optional[str]):
    if chars is None:
        return _is_ws(mat)
    m = torch.zeros(mat.shape, dtype=torch.bool, device=mat.device)
    for c in chars.encode("utf8"):
        m = m | (mat == c)
    return m


def _t_ltrim(mat, lens, opts):
    keep = ~_charset_mask(mat, getattr(opts, "characters", None)) \
        & _valid(mat, lens)
    has, first_keep = _first_true(keep)
    return _shift_left(mat, lens, torch.where(has, first_keep, lens))


def _t_rtrim(mat, lens, opts):
    keep = ~_charset_mask(mat, getattr(opts, "characters", None)) \
        & _valid(mat, lens)
    has, last_from_end = _first_true(keep.flip(1))
    newlen = torch.where(has, mat.shape[1] - last_from_end, 0)
    return torch.where(_positions(mat) < newlen[:, None], mat, 0), newlen


def _t_trim(mat, lens, opts):
    mat, lens = _t_rtrim(mat, lens, opts)
    return _t_ltrim(mat, lens, opts)


NATIVE_TRANSFORMS = {
    "ascii_upper": _t_upper,
    "ascii_lower": _t_lower,
    "ascii_swapcase": _t_swapcase,
    "ascii_capitalize": _t_capitalize,
    "ascii_title": _t_title,
    "ascii_reverse": _t_reverse,
    "ascii_ltrim_whitespace": _t_ltrim,
    "ascii_rtrim_whitespace": _t_rtrim,
    "ascii_trim_whitespace": _t_trim,
    "ascii_ltrim": _t_ltrim,
    "ascii_rtrim": _t_rtrim,
    "ascii_trim": _t_trim,
}


def native_transform(name: str, d: Dictionary, options, is_string: bool,
                     device) -> Optional[Dictionary]:
    """The transformed pool, computed over the byte matrix on ``device``
    (its matrix cached for that device), or None when ``name`` is not of
    the device family or the pool is empty."""
    fn = NATIVE_TRANSFORMS.get(name)
    if fn is None or len(d.values) == 0:
        return None
    mat, lens = byte_matrix(d, device)
    if name == "ascii_reverse" and bool((mat >= 128).any()):
        # byte reversal breaks multi-byte UTF-8: the reference kernel
        # rejects it (scalar_string.cc AsciiReverse)
        raise Invalid("Non-ASCII sequence in input")
    out_mat, out_lens = fn(mat, lens, options)
    width = max(1, int(out_lens.max()))
    out_mat = out_mat[:, :width].contiguous()
    out = Dictionary(decode_matrix(out_mat, out_lens, is_string))
    out._byte_matrix[torch.device(device)] = (out_mat, out_lens)
    return out


# ---------------------------------------------------------------- predicates

def _all_valid(mat, lens, pred):
    """True where every real byte satisfies pred and the value is not
    empty (scalar_string.cc is_* semantics)."""
    return torch.where(_valid(mat, lens), pred, True).all(dim=1) & (lens > 0)


def _p_is_alpha(mat, lens, opts):
    return _all_valid(mat, lens, _in(mat, _LOWER) | _in(mat, _UPPER))


def _p_is_alnum(mat, lens, opts):
    return _all_valid(mat, lens,
                      _in(mat, _LOWER) | _in(mat, _UPPER) | _in(mat, _DIGIT))


def _p_is_decimal(mat, lens, opts):
    return _all_valid(mat, lens, _in(mat, _DIGIT))


def _p_is_space(mat, lens, opts):
    return _all_valid(mat, lens, _is_ws(mat))


def _p_is_printable(mat, lens, opts):
    # unlike the other is_* predicates, "" is printable
    printable = (mat >= 32) & (mat < 127)
    return torch.where(_valid(mat, lens), printable, True).all(dim=1)


def _p_is_lower(mat, lens, opts):
    """At least one cased character and no upper-case one."""
    v = _valid(mat, lens)
    cased = (_in(mat, _LOWER) | _in(mat, _UPPER)) & v
    return cased.any(dim=1) & ~(_in(mat, _UPPER) & v).any(dim=1)


def _p_is_upper(mat, lens, opts):
    v = _valid(mat, lens)
    cased = (_in(mat, _LOWER) | _in(mat, _UPPER)) & v
    return cased.any(dim=1) & ~(_in(mat, _LOWER) & v).any(dim=1)


def _p_is_title(mat, lens, opts):
    """Cased runs start upper-case and go on lower-case; at least one
    cased character."""
    v = _valid(mat, lens)
    up, lo = _in(mat, _UPPER) & v, _in(mat, _LOWER) & v
    alpha = up | lo
    start = alpha & ~_prev(alpha)
    ok = torch.where(start, up, True).all(dim=1) \
        & torch.where(alpha & ~start, lo, True).all(dim=1)
    return ok & alpha.any(dim=1)


def _p_is_ascii(mat, lens, opts):
    return torch.where(_valid(mat, lens), mat < 128, True).all(dim=1)


def _match_positions(mat, lens, pattern: bytes, ignore_case: bool):
    """bool[u, L]: the window starting at each position equals the
    pattern (none when the pattern is longer than every value)."""
    if len(pattern) > mat.shape[1]:
        return torch.zeros(mat.shape, dtype=torch.bool, device=mat.device)
    if ignore_case:
        mat, pattern = _to_lower(mat), pattern.lower()
    hit = torch.ones(mat.shape, dtype=torch.bool, device=mat.device)
    for j, c in enumerate(pattern):
        shifted = torch.nn.functional.pad(mat[:, j:], (0, j)) if j else mat
        hit = hit & (shifted == c)
    return hit & (_positions(mat) + len(pattern) <= lens[:, None])


def _pattern(opts):
    return (opts.pattern or "").encode("utf8"), \
        bool(getattr(opts, "ignore_case", False))


def _p_match_substring(mat, lens, opts):
    pat, ic = _pattern(opts)
    if not pat:
        return torch.ones(mat.shape[0], dtype=torch.bool, device=mat.device)
    return _match_positions(mat, lens, pat, ic).any(dim=1)


def _p_starts_with(mat, lens, opts):
    pat, ic = _pattern(opts)
    if not pat:
        return torch.ones(mat.shape[0], dtype=torch.bool, device=mat.device)
    return _match_positions(mat, lens, pat, ic)[:, 0]


def _p_ends_with(mat, lens, opts):
    pat, ic = _pattern(opts)
    if not pat:
        return torch.ones(mat.shape[0], dtype=torch.bool, device=mat.device)
    hits = _match_positions(mat, lens, pat, ic)
    start = lens - len(pat)
    idx = torch.clamp(start, 0, mat.shape[1] - 1).long()
    return torch.gather(hits, 1, idx[:, None])[:, 0] & (start >= 0)


def _m_binary_length(mat, lens, opts):
    return lens


def _m_utf8_length(mat, lens, opts):
    """Code points: the bytes that are not UTF-8 continuations."""
    cont = (mat & 0xC0) == 0x80
    return (_valid(mat, lens) & ~cont).sum(dim=1, dtype=torch.int32)


def _m_count_substring(mat, lens, opts):
    """Non-overlapping matches, left to right (pyarrow's count): one
    pass over the positions, each a vector operation over the pool."""
    pat, ic = _pattern(opts)
    hits = _match_positions(mat, lens, pat, ic)
    count = torch.zeros(mat.shape[0], dtype=torch.int32, device=mat.device)
    free = torch.zeros_like(count)   # first position a match may start
    for j in range(mat.shape[1] - len(pat) + 1):
        take = hits[:, j] & (free <= j)
        count += take.to(torch.int32)
        free = torch.where(take, j + len(pat), free)
    return count


def _m_find_substring(mat, lens, opts):
    pat, ic = _pattern(opts)
    has, first = _first_true(_match_positions(mat, lens, pat, ic))
    return torch.where(has, first, -1)


NATIVE_PREDICATES = {
    "ascii_is_alpha": _p_is_alpha,
    "ascii_is_alnum": _p_is_alnum,
    "ascii_is_decimal": _p_is_decimal,
    "ascii_is_space": _p_is_space,
    "ascii_is_printable": _p_is_printable,
    "ascii_is_lower": _p_is_lower,
    "ascii_is_upper": _p_is_upper,
    "ascii_is_title": _p_is_title,
    "string_is_ascii": _p_is_ascii,
    "match_substring": _p_match_substring,
    "starts_with": _p_starts_with,
    "ends_with": _p_ends_with,
    "binary_length": _m_binary_length,
    "utf8_length": _m_utf8_length,
    "count_substring": _m_count_substring,
    "find_substring": _m_find_substring,
}


def native_predicate_lut(name: str, d: Dictionary, options, device):
    """The per-value table (bool or int32 [u]) from the byte matrix on
    ``device``, or None: the name is not of the device family, the pool
    is empty, ``ignore_case`` asks for Unicode case folding, or count and
    find have an empty pattern (the host tail's edge semantics)."""
    fn = NATIVE_PREDICATES.get(name)
    if fn is None or len(d.values) == 0:
        return None
    if options is not None and getattr(options, "ignore_case", False):
        return None
    if name in ("count_substring", "find_substring") and \
            not getattr(options, "pattern", ""):
        return None
    mat, lens = byte_matrix(d, device)
    return fn(mat, lens, options)
