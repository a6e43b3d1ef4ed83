"""Host string kernels over a dictionary's values: the Unicode, regex,
pad, slice, normalize and replace tail (counterpart of
arrow1_tpu/ops/strings_host.py).

The ASCII and byte family runs on the column's device
(ops/strings_device.py). This module is pure Python (str, re,
unicodedata), with no pyarrow in the compute path, and runs over the
unique values only; rows see one gather on the device. Semantics follow
the reference's utf8proc and RE2 kernels
(cpp/src/arrow/compute/kernels/scalar_string.cc):

- case mapping is code point by code point, the simple mapping ('ß' ->
  'ẞ', 'İ' -> 'i', 'ﬁ' unchanged), not Python's full mapping
  ('ß'.upper() == 'SS');
- title case upper-cases word starts with the upper-case mapping;
- find, count and span offsets and lengths count bytes; UTF-8 slices and
  pads count code points, ASCII pads bytes;
- centering puts the smaller half of the padding on the left;
- regex kernels use UTF-8 semantics throughout. pyarrow's
  find_substring_regex and count_substring_regex compile RE2 in Latin-1
  mode, so their offsets differ on non-ASCII input: matched behaviour of
  the JAX package, not a fault (ROADMAP).

- splits keep boundary empties (' a ' -> ['', 'a', '']); a regex split
  skips empty matches; utf8_split_whitespace keeps the reference's
  quirk at a string's end (below).
"""

from __future__ import annotations

import functools
import operator
import re
import unicodedata

import numpy as np

from ..errors import Invalid

# utf8proc simple case mappings that Python's str full-mapping misses
_SP_UPPER = {"ß": "ẞ"}          # ß -> ẞ
_SP_LOWER = {"İ": "i"}               # İ -> i (simple, no combining dot)


def _cp_upper(c):
    u = _SP_UPPER.get(c)
    if u is not None:
        return u
    u = c.upper()
    return u if len(u) == 1 else c


def _cp_lower(c):
    l = _SP_LOWER.get(c)
    if l is not None:
        return l
    l = c.lower()
    return l if len(l) == 1 else c


def _upper(s):
    return "".join(map(_cp_upper, s))


def _lower(s):
    return "".join(map(_cp_lower, s))


def _swapcase(s):
    return "".join(_cp_lower(c) if c.isupper() else
                   _cp_upper(c) if c.islower() else c for c in s)


def _capitalize(s):
    return (_cp_upper(s[0]) + _lower(s[1:])) if s else s


def _is_cased(c):
    """utf8proc cased: category L{u,l,t} or a case mapping exists
    (scalar_string.cc IsCasedCharacterUnicode) — 'Ⅷ' (Nl) is cased via
    its lowercase mapping; digits/punct are not and reset title words."""
    return c.upper() != c or c.lower() != c or \
        unicodedata.category(c) == "Lt"


def _title(s):
    out = []
    prev_cased = False
    for c in s:
        cased = _is_cased(c)
        out.append((_cp_lower(c) if prev_cased else _cp_upper(c))
                   if cased else c)
        prev_cased = cased
    return "".join(out)


# RE2 character-class sets (re2/parse.cc perl classes): \w\d\s\b are
# ASCII-ONLY, unlike Python's unicode-aware defaults. \s is [\t\n\f\r ]
# (no \v). Backreferences and lookaround are rejected by RE2.
_RE2_CLASS_OUT = {"w": "[0-9A-Za-z_]", "W": "[^0-9A-Za-z_]",
                  "d": "[0-9]", "D": "[^0-9]",
                  "s": "[\\t\\n\\f\\r ]", "S": "[^\\t\\n\\f\\r ]",
                  "b": "(?a:\\b)", "B": "(?a:\\B)"}
_RE2_CLASS_IN = {"w": "0-9A-Za-z_", "d": "0-9", "s": "\\t\\n\\f\\r "}


def _re2_compat(pattern):
    """Rewrite a pattern so Python `re` matches RE2 semantics: ASCII
    perl classes, RE2's exact \\s set, errors on backrefs/lookaround."""
    out = []
    i, n = 0, len(pattern)
    class_start = -1          # index of the opening '[', -1 when outside
    while i < n:
        c = pattern[i]
        in_class = class_start >= 0
        if c == "\\" and i + 1 < n:
            nxt = pattern[i + 1]
            if not in_class and nxt in _RE2_CLASS_OUT:
                out.append(_RE2_CLASS_OUT[nxt])
            elif in_class and nxt in _RE2_CLASS_IN:
                out.append(_RE2_CLASS_IN[nxt])
            elif not in_class and nxt.isdigit() and nxt != "0":
                raise Invalid(
                    f"Invalid regular expression: invalid escape sequence: "
                    f"\\{nxt}")
            else:
                out.append(c + nxt)
            i += 2
            continue
        if not in_class and (pattern[i:i + 3] in ("(?=", "(?!")
                             or pattern[i:i + 4] in ("(?<=", "(?<!")):
            raise Invalid("Invalid regular expression: missing ): "
                          "look-ahead and look-behind are not supported")
        if c == "[" and not in_class:
            class_start = i
        elif c == "]" and in_class:
            first = class_start + (2 if pattern[class_start + 1:
                                               class_start + 2] == "^" else 1)
            if i > first:     # ']' right after '[' or '[^' is literal
                class_start = -1
        out.append(c)
        i += 1
    return "".join(out)


@functools.lru_cache(maxsize=512)
def _compile(pattern, flags, as_bytes, literal):
    """Compile an RE2-semantics regex; bytes mode when matching binary
    dictionary values (RE2 byte mode = Python bytes regex: per-byte
    classes, ASCII-only case folding)."""
    p = re.escape(pattern or "") if literal else _re2_compat(pattern or "")
    if as_bytes:
        p = p.encode("utf8")
    try:
        return re.compile(p, flags)
    except re.error as e:
        raise Invalid(f"Invalid regular expression: {e}")


def _rx(options, extra_flags=0, sample=""):
    flags = extra_flags
    if getattr(options, "ignore_case", False):
        flags |= re.IGNORECASE
    return _compile(options.pattern or "", flags,
                    isinstance(sample, bytes), False)


def _lit_rx(pattern, ignore_case, sample=""):
    return _compile(pattern or "", re.IGNORECASE if ignore_case else 0,
                    isinstance(sample, bytes), True)


def _byte_off(s, cp_off):
    """Codepoint offset -> byte offset (find/span results are byte-based)."""
    return len(s[:cp_off].encode("utf8")) if isinstance(s, str) else cp_off


def _pad(s, options, side, in_bytes):
    pad = options.padding
    if (len(pad.encode("utf8")) if in_bytes else len(pad)) != 1:
        raise Invalid(f"Padding must be one codepoint, got '{pad}'")
    n = len(s.encode("utf8")) if in_bytes and isinstance(s, str) else len(s)
    d = options.width - n
    if d <= 0:
        return s
    if side == "l":
        return pad * d + s
    if side == "r":
        return s + pad * d
    left = d // 2                         # left-light, unlike str.center
    return pad * left + s + pad * (d - left)


def _zero_fill(s, options):
    pad = getattr(options, "padding", "0") or "0"
    if len(pad) != 1:
        raise Invalid(f"Padding must be one codepoint, got '{pad}'")
    d = options.width - len(s)
    if d <= 0:
        return s
    sign = s[0] if s[:1] in ("+", "-") else ""
    return sign + pad * d + s[len(sign):]


def _slice(s, options):
    step = options.step if options.step is not None else 1
    if step == 0:
        raise Invalid("Slice step cannot be zero")
    return s[slice(options.start, options.stop, step)]


def _replace_slice(s, options):
    empty = "" if isinstance(s, str) else b""
    repl = options.replacement
    if isinstance(s, bytes) and isinstance(repl, str):
        repl = repl.encode("utf8")
    return (s[:options.start] if options.start != 0 else empty) + repl + \
        s[options.stop:]


def _normalize(s, options):
    form = (options.form or "NFC").upper()
    if form not in ("NFC", "NFKC", "NFD", "NFKD"):
        raise Invalid(f"Invalid Unicode normalization form: {form}")
    return unicodedata.normalize(form, s)


def _replace_sub(s, options):
    m = options.max_replacements
    if isinstance(s, bytes):
        pat = options.pattern.encode("utf8") if isinstance(
            options.pattern, str) else options.pattern
        rep = options.replacement.encode("utf8") if isinstance(
            options.replacement, str) else options.replacement
    else:
        pat, rep = options.pattern, options.replacement
    return s.replace(pat, rep) if m is None or m < 0 else \
        s.replace(pat, rep, m)


def _replace_sub_regex(s, options):
    rx = _rx(options)
    m = options.max_replacements
    return rx.sub(options.replacement, s, count=0 if m is None or m < 0
                  else m)


_TRANSFORMS = {
    "utf8_upper": lambda s, o: _upper(s),
    "utf8_lower": lambda s, o: _lower(s),
    "utf8_swapcase": lambda s, o: _swapcase(s),
    "utf8_capitalize": lambda s, o: _capitalize(s),
    "utf8_title": lambda s, o: _title(s),
    "utf8_reverse": lambda s, o: s[::-1],
    "binary_reverse": lambda s, o: (s if isinstance(s, bytes)
                                    else s.encode("utf8"))[::-1],
    "utf8_ltrim_whitespace": lambda s, o: s.lstrip(),
    "utf8_rtrim_whitespace": lambda s, o: s.rstrip(),
    "utf8_trim_whitespace": lambda s, o: s.strip(),
    "utf8_ltrim": lambda s, o: s.lstrip(o.characters),
    "utf8_rtrim": lambda s, o: s.rstrip(o.characters),
    "utf8_trim": lambda s, o: s.strip(o.characters),
    "ascii_ltrim": lambda s, o: s.lstrip(o.characters),
    "ascii_rtrim": lambda s, o: s.rstrip(o.characters),
    "ascii_trim": lambda s, o: s.strip(o.characters),
    "replace_substring": _replace_sub,
    "replace_substring_regex": _replace_sub_regex,
    "utf8_slice_codeunits": _slice,
    "binary_slice": lambda s, o: _slice(
        s if isinstance(s, bytes) else s.encode("utf8"), o),
    "utf8_replace_slice": _replace_slice,
    "binary_replace_slice": lambda s, o: _replace_slice(
        s if isinstance(s, bytes) else s.encode("utf8"), o),
    "utf8_normalize": _normalize,
    "utf8_zero_fill": _zero_fill,
    "utf8_lpad": lambda s, o: _pad(s, o, "l", False),
    "utf8_rpad": lambda s, o: _pad(s, o, "r", False),
    "utf8_center": lambda s, o: _pad(s, o, "c", False),
    "ascii_lpad": lambda s, o: _pad(s, o, "l", True),
    "ascii_rpad": lambda s, o: _pad(s, o, "r", True),
    "ascii_center": lambda s, o: _pad(s, o, "c", True),
    # ascii byte kernels land here only on the (rare) non-device path
    "ascii_upper": lambda s, o: "".join(
        c.upper() if c.isascii() else c for c in s),
    "ascii_lower": lambda s, o: "".join(
        c.lower() if c.isascii() else c for c in s),
}


def host_transform(name, values, options):
    """str->str kernel over the unique values; returns an object ndarray."""
    fn = _TRANSFORMS.get(name)
    if fn is None:
        raise Invalid(f"no host string transform for {name}")
    return np.asarray([None if v is None else fn(v, options)
                       for v in values], dtype=object)


# ---------------------------------------------------------------- measures

def _count_sub(s, options):
    pat = options.pattern or ""
    if getattr(options, "ignore_case", False):
        if not pat:
            return (len(s.encode("utf8")) if isinstance(s, str)
                    else len(s)) + 1
        return len(_lit_rx(pat, True, s).findall(s))
    if isinstance(s, str):
        s = s.encode("utf8")
    pat = pat.encode("utf8") if isinstance(pat, str) else pat
    return s.count(pat) if pat else len(s) + 1


def _find_sub(s, options):
    pat = options.pattern or ""
    if getattr(options, "ignore_case", False):
        m = _lit_rx(pat, True, s).search(s)
        return -1 if m is None else _byte_off(s, m.start())
    if isinstance(s, str):
        s = s.encode("utf8")
    pat = pat.encode("utf8") if isinstance(pat, str) else pat
    return s.find(pat)


def _like_to_regex(p):
    out = []
    i = 0
    while i < len(p):
        c = p[i]
        if c == "\\" and i + 1 < len(p) and p[i + 1] in "%_\\":
            out.append(re.escape(p[i + 1]))
            i += 2
            continue
        out.append("(?s:.*)" if c == "%" else
                   "(?s:.)" if c == "_" else re.escape(c))
        i += 1
    return "".join(out)


def _coerce_pat(s, pat):
    """Match the pattern's type to the subject's (binary dict values)."""
    if isinstance(s, bytes) and isinstance(pat, str):
        return pat.encode("utf8")
    return pat


def _ends_with(s, o):
    if o.ignore_case:
        p = "(?s:.*)" + re.escape(o.pattern or "")
        if isinstance(s, bytes):
            p = p.encode("utf8")
        return re.compile(p, re.IGNORECASE).fullmatch(s) is not None
    return s.endswith(_coerce_pat(s, o.pattern))


_MEASURES = {
    "match_substring": lambda s, o: _lit_rx(
        o.pattern, o.ignore_case, s).search(s) is not None,
    "starts_with": lambda s, o: _lit_rx(
        o.pattern, o.ignore_case, s).match(s) is not None,
    "ends_with": _ends_with,
    "match_substring_regex": lambda s, o: _rx(
        o, sample=s).search(s) is not None,
    "match_like": lambda s, o: re.compile(
        _like_to_regex(o.pattern or "") if isinstance(s, str) else
        _like_to_regex(o.pattern or "").encode("utf8"),
        re.IGNORECASE if o.ignore_case else 0).fullmatch(s) is not None,
    "count_substring": _count_sub,
    "find_substring": _find_sub,
    "count_substring_regex": lambda s, o: sum(
        1 for _ in _rx(o, sample=s).finditer(s)),
    "find_substring_regex": lambda s, o: (lambda m: -1 if m is None else
                                          _byte_off(s, m.start()))(
                                              _rx(o, sample=s).search(s)),
    "utf8_is_alnum": lambda s, o: s.isalnum(),
    "utf8_is_alpha": lambda s, o: s.isalpha(),
    "utf8_is_decimal": lambda s, o: s.isdecimal(),
    "utf8_is_digit": lambda s, o: s.isdigit(),
    "utf8_is_numeric": lambda s, o: s.isnumeric(),
    "utf8_is_lower": lambda s, o: s.islower(),
    "utf8_is_upper": lambda s, o: s.isupper(),
    "utf8_is_space": lambda s, o: s.isspace(),
    "utf8_is_printable": lambda s, o: s.isprintable(),
    "utf8_is_title": lambda s, o: s.istitle(),
    "utf8_length": lambda s, o: len(s),
    "binary_length": lambda s, o: len(s.encode("utf8")
                                      if isinstance(s, str) else s),
}


def host_measure(name, values, options):
    """str->bool/int kernel over the unique values; returns a list."""
    fn = _MEASURES.get(name)
    if fn is None:
        raise Invalid(f"no host string measure for {name}")
    return [False if v is None else fn(v, options) for v in values]


# ------------------------------------------------------------------ splits

def _split_spans(s, spans, max_splits, reverse):
    if max_splits is not None and max_splits >= 0 and len(spans) > max_splits:
        spans = spans[-max_splits:] if reverse else spans[:max_splits]
    out, pos = [], 0
    for a, b in spans:
        out.append(s[pos:a])
        pos = b
    out.append(s[pos:])
    return out


def _lit_spans(s, pat):
    spans, pos = [], 0
    if not pat:
        raise Invalid("Empty separator")
    while True:
        i = s.find(pat, pos)
        if i < 0:
            return spans
        spans.append((i, i + len(pat)))
        pos = i + len(pat)


def host_split(name, values, options):
    """str->list[str] kernel; returns a list of piece-lists (None rows
    stay None)."""
    max_splits = getattr(options, "max_splits", None)
    reverse = bool(getattr(options, "reverse", False))
    if name == "split_pattern":
        pat = options.pattern
        if not pat:
            raise Invalid("Empty separator")
        if not reverse and None not in values:
            # str.split: the same left-to-right spans (a pool holds str
            # values or bytes values, never both)
            limit = -1 if max_splits is None or max_splits < 0 \
                else max_splits
            sep = _coerce_pat(values[0], pat) if values else pat
            return list(map(operator.methodcaller("split", sep, limit),
                            values))

        def spans(s):
            return _lit_spans(s, _coerce_pat(s, pat))
    elif name == "split_pattern_regex":
        if reverse:
            raise Invalid("Cannot split in reverse with regex")

        def spans(s):
            rx = _rx(options, sample=s)
            return [m.span() for m in rx.finditer(s) if m.end() > m.start()]
    elif name == "ascii_split_whitespace":
        def spans(s):
            rx = re.compile(r"[ \t\r\n\v\f]+" if isinstance(s, str)
                            else rb"[ \t\r\n\v\f]+")
            return [m.span() for m in rx.finditer(s)]
    elif name == "utf8_split_whitespace":
        # Reference quirk (scalar_string.cc SplitWhitespaceUtf8Finder):
        # the do-while requires i < end AFTER decoding the next codepoint,
        # so a whitespace run of >=2 codepoints touching the string end
        # (forward) / start (reverse) splits into run[:-1] + run[-1:]
        # separators ('  ' -> ['', '', ''] while ascii gives ['', '']).
        rx = re.compile(r"\s+")

        def spans(s):
            out = []
            for a, b in (m.span() for m in rx.finditer(s)):
                if b - a >= 2 and (b == len(s) if not reverse else a == 0):
                    cut = b - 1 if not reverse else a + 1
                    out.append((a, cut))
                    out.append((cut, b))
                else:
                    out.append((a, b))
            return out
    else:
        raise Invalid(f"no host split for {name}")
    return [None if v is None
            else _split_spans(v, spans(v), max_splits, reverse)
            for v in values]


# ----------------------------------------------------------------- extract

def _named_groups(rx):
    names = sorted(rx.groupindex.items(), key=lambda kv: kv[1])
    if not names:
        raise Invalid("Regular expression contains no named groups")
    return [k for k, _ in names]


def host_extract(pattern, values):
    """extract_regex: returns (group_names, per-value dict|None) — an
    unmatched optional group inside a match yields '' (RE2 behavior)."""
    as_bytes = any(isinstance(v, bytes) for v in values)
    rx = _compile(pattern, 0, as_bytes, False)
    names = _named_groups(rx)
    empty = b"" if as_bytes else ""
    out = []
    for v in values:
        m = None if v is None else rx.search(v)
        out.append(None if m is None
                   else {g: m.group(g) or empty for g in names})
    return names, out


def host_extract_span(pattern, values):
    """extract_regex_span: per group [byte_offset, byte_length]; an
    unmatched group yields [-1, 0]."""
    rx = _compile(pattern, 0,
                  any(isinstance(v, bytes) for v in values), False)
    names = _named_groups(rx)
    out = []
    for v in values:
        m = None if v is None else rx.search(v)
        if m is None:
            out.append(None)
            continue
        row = {}
        for g in names:
            if m.start(g) < 0:
                row[g] = [-1, 0]
            else:
                off = _byte_off(v, m.start(g))
                row[g] = [off, _byte_off(v, m.end(g)) - off]
        out.append(row)
    return names, out
