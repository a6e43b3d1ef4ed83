"""Value formatting and parsing for the numeric <-> string casts
(counterpart of arrow1_tpu/ops/formatting.py, its numeric part).

Reference: cpp/src/arrow/util/formatting.{h,cc} (floats through
double_conversion with EMIT_POSITIVE_EXPONENT_SIGN, 'e',
decimal_in_shortest_low=-6 and decimal_in_shortest_high=10,
formatting.cc:43-44) and cpp/src/arrow/util/value_parsing.{h,cc} (the
integer, float and bool parsers of scalar_cast_string.cc).

Both directions run on the host over the unique values of a column:
string columns are dictionary-encoded, so a numeric -> string cast
lands in dictionary form and a string -> numeric cast reads the pool;
the device moves only codes and the per-value table. The temporal and
decimal forms come with ROADMAP Queue 1 items 7 and 8.
"""

from __future__ import annotations

import re
from typing import Tuple

import numpy as np

from ..errors import Invalid

# ---------------------------------------------------------------------
# formatting (numeric -> string)
# ---------------------------------------------------------------------

_FIXED_LOW = -6    # decimal_in_shortest_low (formatting.cc:44)
_FIXED_HIGH = 10   # decimal_in_shortest_high


def _shortest_digits(v, f32: bool) -> Tuple[str, int]:
    """Shortest round-trip significant digits + decimal exponent:
    value == 0.<digits> * 10**dp (double_conversion's decimal_point)."""
    s = np.format_float_scientific(
        np.float32(v) if f32 else np.float64(v), unique=True, trim="-")
    mant, _, exp = s.partition("e")
    neg = mant.startswith("-")
    digits = mant.lstrip("-").replace(".", "").rstrip("0") or "0"
    dp = int(exp) + 1
    return ("-" if neg else "") + digits, dp


def format_float(v, f32: bool = False) -> str:
    v = float(v)
    if np.isnan(v):
        return "nan"
    if np.isinf(v):
        return "-inf" if v < 0 else "inf"
    if v == 0:
        return "-0" if np.signbit(v) else "0"
    sdigits, dp = _shortest_digits(v, f32)
    sign = "-" if sdigits.startswith("-") else ""
    digits = sdigits.lstrip("-")
    if _FIXED_LOW < dp <= _FIXED_HIGH:
        if dp <= 0:
            return sign + "0." + "0" * -dp + digits
        if dp >= len(digits):
            return sign + digits + "0" * (dp - len(digits))
        return sign + digits[:dp] + "." + digits[dp:]
    e = dp - 1
    mant = digits[0] + ("." + digits[1:] if len(digits) > 1 else "")
    return f"{sign}{mant}e{'+' if e >= 0 else '-'}{abs(e)}"


# ---------------------------------------------------------------------
# parsing (string -> numeric); reference util/value_parsing.h
# ---------------------------------------------------------------------

_INT_RE = re.compile(r"-?[0-9]+\Z")
_HEX_RE = re.compile(r"-?0[xX][0-9a-fA-F]+\Z")
_FLOAT_RE = re.compile(
    r"[+-]?(?:(?:[0-9]+\.?[0-9]*|\.[0-9]+)(?:[eE][+-]?[0-9]+)?"
    r"|inf(?:inity)?|nan)\Z", re.IGNORECASE)
_BOOL = {"true": True, "1": True, "false": False, "0": False}

_INT_BOUNDS = {
    "int8": (-2**7, 2**7 - 1), "int16": (-2**15, 2**15 - 1),
    "int32": (-2**31, 2**31 - 1), "int64": (-2**63, 2**63 - 1),
    "uint8": (0, 2**8 - 1), "uint16": (0, 2**16 - 1),
    "uint32": (0, 2**32 - 1), "uint64": (0, 2**64 - 1),
}


def parse_int(s: str, kind: str) -> int:
    if _INT_RE.match(s):
        v = int(s)
    elif _HEX_RE.match(s):
        v = int(s, 16)
    else:
        raise Invalid(f"Failed to parse string: {s!r} as a scalar of "
                      f"type {kind}")
    lo, hi = _INT_BOUNDS[kind]
    if not lo <= v <= hi:
        raise Invalid(f"Failed to parse string: {s!r} as a scalar of "
                      f"type {kind}")
    return v


def parse_float(s: str) -> float:
    if not _FLOAT_RE.match(s):
        raise Invalid(f"Failed to parse string: {s!r} as a scalar of "
                      "type double")
    return float(s)  # overflow -> inf, like the reference's parser


def parse_bool(s: str) -> bool:
    v = _BOOL.get(s.lower())
    if v is None:
        raise Invalid(f"Failed to parse value: {s}")
    return v
