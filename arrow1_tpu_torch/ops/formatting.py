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
the device moves only codes and the per-value table. Temporal values
format as the reference's cast to string does (ISO 8601: a date
YYYY-MM-DD, a time hh:mm:ss with the unit's fraction, a timestamp the
two with a space, a zoned one with its offset +hhmm; a duration its
integer) and parse from ISO 8601 (value_parsing.h
ParseTimestampISO8601). A decimal formats its unscaled integer with the
scale's point (``format_decimal``) and parses from plain or exponent
notation, exactly (``parse_decimal``; reference decimal.cc FromString).
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


def format_temporal(secs: int, rem: int, digits: int, kind: str) -> str:
    """A date ("date": ``secs`` counts days), time of day ("time") or
    timestamp ("ts") as ISO text, ``rem`` the fraction in ``digits``
    digits."""
    from datetime import datetime, timezone

    frac = f".{rem:0{digits}d}" if digits else ""
    if kind == "date":
        return datetime.fromtimestamp(
            secs * 86400, tz=timezone.utc).strftime("%Y-%m-%d")
    if kind == "time":
        h, r = divmod(secs, 3600)
        m, s = divmod(r, 60)
        return f"{h:02d}:{m:02d}:{s:02d}{frac}"
    d = datetime.fromtimestamp(secs, tz=timezone.utc)
    return d.strftime("%Y-%m-%d %H:%M:%S") + frac


_PER_S = {"s": 1, "ms": 10**3, "us": 10**6, "ns": 10**9}
_DIGITS = {"s": 0, "ms": 3, "us": 6, "ns": 9}


def format_temporal_values(uniq, src) -> np.ndarray:
    """The strings of distinct temporal storage values ``uniq`` (an
    int64 tensor, any device) of type ``src``, as an object array."""
    vals = uniq.cpu().numpy()
    kind = src.kind
    if kind == "duration":
        return np.array([str(int(v)) for v in vals], object)
    if kind in ("date32", "date64"):
        days = vals if kind == "date32" else vals // 86400000
        return np.array([format_temporal(int(v), 0, 0, "date")
                         for v in days], object)
    per, digits = _PER_S[src.unit], _DIGITS[src.unit]
    if kind in ("time32", "time64"):
        return np.array([format_temporal(*divmod(int(v), per), digits,
                                         "time") for v in vals], object)
    offs = np.zeros(len(vals), np.int64)
    suffix = [""] * len(vals)
    if src.tz:   # local time and its offset
        from ..utils.tzif import load_tz

        tz = load_tz(src.tz)
        secs = np.floor_divide(vals, per)
        offs = tz.utoff[np.searchsorted(tz.trans, secs, side="right")] \
            if len(tz.trans) else np.full(len(vals), int(tz.utoff[0]))
        for i, o in enumerate(offs.tolist()):
            hh, mm = divmod(abs(o) // 60, 60)
            suffix[i] = f"{'+' if o >= 0 else '-'}{hh:02d}{mm:02d}"
    return np.array([format_temporal(*divmod(int(v) + int(o) * per, per),
                                     digits, "ts") + sfx
                     for v, o, sfx in zip(vals.tolist(), offs.tolist(),
                                          suffix)], object)


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


def parse_temporal(s: str, dst) -> int:
    """ISO 8601 text -> ``dst``'s storage ticks (value_parsing.h
    ParseTimestampISO8601); a value that the unit cannot hold exactly
    raises."""
    import datetime as _dt

    if dst.kind in ("date32", "date64"):
        days = _dt.date.fromisoformat(s).toordinal() - 719163
        return days if dst.kind == "date32" else days * 86400000
    ns_per = {"s": 10**9, "ms": 10**6, "us": 10**3, "ns": 1}
    if dst.kind in ("time32", "time64"):
        t = _dt.time.fromisoformat(s)
        ns = ((t.hour * 3600 + t.minute * 60 + t.second) * 10**9
              + t.microsecond * 1000)
        per = ns_per[dst.unit]
        if ns % per:
            raise Invalid(f"time value {s!r} loses precision at {dst.unit}")
        return ns // per
    if dst.kind == "timestamp":
        if dst.tz:
            raise Invalid("cast string -> tz-aware timestamp is not "
                          "supported; cast to naive then assume_timezone")
        body, _, frac = s.replace("T", " ").partition(".")
        body = body.strip()
        if " " in body:
            d = _dt.datetime.fromisoformat(body)
        else:
            dd = _dt.date.fromisoformat(body)
            d = _dt.datetime(dd.year, dd.month, dd.day)
        secs = (d.toordinal() - 719163) * 86400 + d.hour * 3600 + \
            d.minute * 60 + d.second
        total_ns = secs * 10**9 + (int((frac + "0" * 9)[:9]) if frac else 0)
        per = ns_per[dst.unit]
        if total_ns % per:
            raise Invalid(f"timestamp {s!r} loses precision at {dst.unit}")
        return total_ns // per
    raise Invalid(f"unsupported cast string -> {dst}")


def parse_bool(s: str) -> bool:
    v = _BOOL.get(s.lower())
    if v is None:
        raise Invalid(f"Failed to parse value: {s}")
    return v


def format_decimal(unscaled: int, scale: int) -> str:
    """Arrow's Decimal ToString (decimal.cc AdjustIntegerStringWithScale):
    plain digits with the scale's point, or, for a negative scale or an
    adjusted exponent below -6 (Java's BigDecimal rule), one digit, the
    rest after a point, and E with the exponent: 1E-10, -1.23E-7, 0E-30.
    The JAX package always writes plain digits."""
    sign = "-" if unscaled < 0 else ""
    s = str(abs(unscaled))
    if scale == 0:
        return sign + s
    exponent = len(s) - 1 - scale
    if scale < 0 or exponent < -6:
        mantissa = s[0] + ("." + s[1:] if len(s) > 1 else "")
        return f"{sign}{mantissa}E{'+' if exponent >= 0 else ''}{exponent}"
    s = s.rjust(scale + 1, "0")
    return sign + s[:-scale] + "." + s[-scale:]


_DEC_RE = re.compile(
    r"([+-]?)([0-9]*)(?:\.([0-9]*))?(?:[eE]([+-]?[0-9]+))?\Z")


def parse_decimal(s: str, precision: int, scale: int) -> int:
    """The unscaled integer at ``scale``; raises on a malformed value, on
    digits lost to the scale, or past the precision."""
    m = _DEC_RE.match(s.strip())
    if not m or (not m.group(2) and not m.group(3)):
        raise Invalid(f"Failed to parse string: {s!r} as decimal")
    sign = -1 if m.group(1) == "-" else 1
    whole, frac = m.group(2) or "0", m.group(3) or ""
    unscaled = int(whole + frac)
    eff_scale = len(frac) - int(m.group(4) or 0)
    if eff_scale <= scale:
        unscaled *= 10 ** (scale - eff_scale)
    else:
        unscaled, r = divmod(unscaled, 10 ** (eff_scale - scale))
        if r:
            raise Invalid("Rescaling Decimal value would cause data loss")
    if unscaled >= 10 ** precision:
        raise Invalid(f"Decimal value {s!r} exceeds precision {precision}")
    return sign * unscaled
