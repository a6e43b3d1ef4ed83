"""Minimal-width sort keys and packed-word sorts (counterpart of
arrow1_tpu/kernels/radix.py).

Each column maps to the narrowest order-preserving unsigned key its type
allows, plus a 2-bit class key (value 0 < NaN 1 < null 2) when it can hold
NaN or null. Keys pack most-significant-first into 64-bit words; unsigned
order over the words is the required row order (stable; nulls last; NaN
after values and before null, as vector_sort.cc:1556-1563).

Words are unsigned 64-bit patterns held in int64 tensors: torch has few
uint64 ops. Shifts mask after an arithmetic right shift, and a sort flips
the sign bit so that signed order is unsigned order.

The JAX package leaves f64 keys as raw sort operands, because its TPU
could not bit-cast f64. Here f64 keys become 64-bit total-order bits like
every other key, with -0.0 folded into +0.0 first: lax.sort's comparator
treats the two zeros of a raw f64 operand as equal, so rows holding them
keep their input order. (Narrower floats are packed as total-order bits
by both packages, where -0.0 sorts before +0.0.) The sort itself is
``torch.sort(stable=True)``: one stable argsort per word, least
significant word first, then one gather per payload.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..column import Column
from ..dtypes import as_int64, from_int64
from ..errors import Invalid

__all__ = ["minimal_sort_keys", "pack_operands",
           "pack_layout", "decode_packed_key", "sort_key_decodable",
           "pack_split", "extract_pair_values", "sort_permutation",
           "sort_rows", "sort_rows_with_keys"]

_SIGN = -(1 << 63)   # the sign bit of an int64 word


def _mask(bits: int) -> int:
    """Low-bit mask as an int64 value (-1 for all 64 bits)."""
    return -1 if bits >= 64 else (1 << bits) - 1


def _flip_desc(key: torch.Tensor, bits: int) -> torch.Tensor:
    return key ^ _mask(bits)


def _float_total_order(x: torch.Tensor) -> Tuple[torch.Tensor, int]:
    """IEEE-754 total-order bits at native width (NaN via the class key):
    negative values flip every bit, others set the sign bit."""
    if x.dtype == torch.float64:
        bits = x.view(torch.int64)
        return torch.where(bits < 0, ~bits, bits ^ _SIGN), 64
    if x.dtype == torch.float16:
        x = x.to(torch.float32)
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    neg = bits >= (1 << 31)
    return torch.where(neg, bits ^ 0xFFFFFFFF, bits | (1 << 31)), 32


def minimal_sort_keys(col: Column, order: str = "ascending",
                      null_placement: str = "at_end"
                      ) -> List[Tuple[torch.Tensor, int]]:
    """(key, nbits) list, most significant first, minimal widths."""
    if null_placement not in ("at_end", "at_start"):
        raise Invalid(f"bad null_placement {null_placement!r}")
    if order not in ("ascending", "descending"):
        raise Invalid(f"bad sort order {order!r}")
    t = col.dtype
    has_nan = False
    if t.is_binary:
        nuniq = len(col.dictionary)
        kbits = max(1, (max(nuniq - 1, 0)).bit_length())
        if not nuniq:
            key = torch.zeros_like(col.data, dtype=torch.int64)
        elif col.dictionary.rank_is_identity:
            key = col.data.to(torch.int64)
        else:
            rank = torch.from_numpy(col.dictionary.rank.astype(np.int64))
            key = rank.to(col.device)[col.data.long().clamp(0, nuniq - 1)]
    elif t.is_floating:
        x = col.data
        if x.dtype == torch.float64:
            x = torch.where(x == 0, 0.0, x)   # -0.0 ties with +0.0
        key, kbits = _float_total_order(x)
        has_nan = True
    elif t.is_boolean:
        key, kbits = col.data.to(torch.int64), 1
    elif t.is_unsigned_integer:
        kbits = 8 * col.data.element_size()
        key = as_int64(col.data)   # uint64: its bits are its unsigned key
    elif t.is_signed_integer or t.is_temporal:   # signed storage
        kbits = 8 * col.data.element_size()
        if kbits >= 64:
            key = col.data ^ _SIGN
        else:  # bias to unsigned at native width (order-preserving)
            key = col.data.to(torch.int64) + (1 << (kbits - 1))
    elif t.is_decimal:
        return _decimal_sort_keys(col, order, null_placement)
    else:
        raise Invalid(f"sort: unsupported type {t}")

    if order == "descending":
        key = _flip_desc(key, kbits)
    if not (has_nan or col.validity is not None):
        return [(key, kbits)]
    valid_cls, null_cls = (2, 0) if null_placement == "at_start" else (0, 2)
    cls = torch.full_like(key, valid_cls)
    if has_nan:
        nan = torch.isnan(col.data)
        cls = torch.where(nan, 1, cls)
        key = torch.where(nan, 0, key)
    if col.validity is not None:
        cls = torch.where(col.validity, cls, null_cls)
        key = torch.where(col.validity, key, 0)
    return [(cls, 2), (key, kbits)]


def decimal_limb_keys(col: Column) -> List[torch.Tensor]:
    """A decimal's limbs as unsigned 64-bit keys, most significant first:
    the top limb with its sign bit flipped, the lower limbs as they are
    (reference: sort.py:115-125)."""
    hi = col.data2 if col.data2.dim() == 1 else col.data2.flip(1)
    upper = [hi] if hi.dim() == 1 else list(hi.unbind(1))
    return [upper[0] ^ _SIGN] + upper[1:] + [col.data]


def _decimal_sort_keys(col: Column, order: str, null_placement: str):
    keys = decimal_limb_keys(col)
    if order == "descending":
        keys = [~k for k in keys]
    if col.validity is None:
        return [(k, 64) for k in keys]
    valid_cls, null_cls = (2, 0) if null_placement == "at_start" else (0, 2)
    cls = torch.where(col.validity, valid_cls, null_cls).to(torch.int64)
    return [(cls, 2)] + [(torch.where(col.validity, k, 0), 64)
                         for k in keys]


def pack_operands(pairs: Sequence[Tuple[torch.Tensor, int]]
                  ) -> Tuple[List[torch.Tensor], List[int]]:
    """Greedy MSB-first packing of whole keys into 64-bit words. Returns
    (words, used_bits): the occupied low bits of each word."""
    words: List[torch.Tensor] = []
    used_bits: List[int] = []
    cur, used = None, 0
    for key, bits in pairs:
        if cur is not None and used + bits <= 64:
            cur = (cur << bits) | key
            used += bits
        else:
            if cur is not None:
                words.append(cur)
                used_bits.append(used)
            cur, used = key, bits
    if cur is not None:
        words.append(cur)
        used_bits.append(used)
    return words, used_bits


def pack_layout(pairs: Sequence[Tuple[torch.Tensor, int]]
                ) -> List[Tuple[int, int, int]]:
    """(word_index, low_bit_shift, nbits) of each pair under
    pack_operands, so callers can decode keys out of sorted words."""
    members: List[List[int]] = []
    cur: List[int] = []
    used = 0
    for i, (_, bits) in enumerate(pairs):
        if cur and used + bits > 64:
            members.append(cur)
            cur, used = [], 0
        cur.append(i)
        used += bits
    if cur:
        members.append(cur)
    placements: List[Tuple[int, int, int]] = [None] * len(pairs)
    for wi, word in enumerate(members):
        shift = 0
        for i in reversed(word):   # the last-packed key sits in low bits
            placements[i] = (wi, shift, pairs[i][1])
            shift += pairs[i][1]
    return placements


def field_of(word: torch.Tensor, shift: int, bits: int) -> torch.Tensor:
    """The ``bits``-wide field at ``shift`` of a packed word."""
    if bits >= 64:
        return word
    return (word >> shift) & _mask(bits)


def decode_packed_key(col: Column, vals: Sequence[torch.Tensor],
                      order: str = "ascending"):
    """Inverse of minimal_sort_keys (at_end placement): (data, validity)
    from the pair values read back out of sorted words."""
    t = col.dtype
    has_cls = len(vals) == 2
    cls = vals[0] if has_cls else None
    v = vals[-1]
    validity = None
    if has_cls and col.validity is not None:
        validity = cls != 2
    if t.is_binary:
        nuniq = len(col.dictionary)
        if order == "descending" and nuniq:
            v = v ^ _mask(max(1, (nuniq - 1).bit_length()))
        if nuniq and not col.dictionary.rank_is_identity:
            inv = np.argsort(col.dictionary.values, kind="stable")
            data = torch.from_numpy(inv.astype(np.int64)).to(v.device)[
                v.clamp(0, nuniq - 1)]
        else:
            data = v
        if validity is not None:
            data = torch.where(validity, data, 0)
        return data.to(col.data.dtype), validity
    if t.is_floating:
        width = 64 if col.data.dtype == torch.float64 else 32
        if order == "descending":
            v = _flip_desc(v, width)
        if width == 64:
            bits = torch.where(v < 0, v ^ _SIGN, ~v)
            f = bits.view(torch.float64)
        else:
            bits = torch.where(v >= (1 << 31), v ^ (1 << 31),
                               v ^ 0xFFFFFFFF)
            f = bits.to(torch.int32).view(torch.float32)
        f = torch.where(cls == 1, float("nan"), f) if has_cls else f
        return f.to(col.data.dtype), validity
    kbits = 1 if t.is_boolean else 8 * col.data.element_size()
    if order == "descending":
        v = _flip_desc(v, kbits)
    if t.is_boolean:
        return v != 0, validity
    if t.is_signed_integer or t.is_temporal:
        v = v ^ _SIGN if kbits >= 64 else v - (1 << (kbits - 1))
    elif col.data.dtype != torch.uint8:
        return from_int64(v, col.data.dtype), validity
    return v.to(col.data.dtype), validity


def sort_key_decodable(col: Column) -> bool:
    """Whether decode_packed_key inverts minimal_sort_keys for the column
    (every type but a decimal, whose keys are its limbs)."""
    return not col.dtype.is_decimal


def pack_split(pairs: Sequence[Tuple[torch.Tensor, int]]):
    """Greedy MSB-first packing that splits keys across word boundaries:
    every word but the last is full, so the words are the exact key bit
    stream. Returns (words, used_bits, frags); frags[i] lists pair i's
    fragments MSB-first as (word_idx, low_shift, nbits, src_shift)."""
    spec: List[Tuple[List, int]] = []
    cur: List[Tuple[int, int, int]] = []
    used = 0
    for i, (_, bits) in enumerate(pairs):
        rem = bits
        while rem:
            take = min(64 - used, rem)
            cur.append((i, rem - take, take))
            used += take
            rem -= take
            if used == 64:
                spec.append((cur, 64))
                cur, used = [], 0
    if cur:
        spec.append((cur, used))
    words: List[torch.Tensor] = []
    used_bits: List[int] = []
    frags: List[List[Tuple[int, int, int, int]]] = [[] for _ in pairs]
    for wi, (members, u) in enumerate(spec):
        w = None
        shift = u
        for i, src_shift, take in members:
            shift -= take
            part = field_of(pairs[i][0], src_shift, take)
            if shift:
                part = part << shift
            w = part if w is None else w | part
            frags[i].append((wi, shift, take, src_shift))
        words.append(w)
        used_bits.append(u)
    return words, used_bits, frags


def extract_pair_values(pairs, frags, sorted_words) -> List[torch.Tensor]:
    """Reassemble each pair's values out of (sorted) pack_split words."""
    vals: List[torch.Tensor] = []
    for i in range(len(pairs)):
        v = None
        for wi, low, take, src in frags[i]:
            part = field_of(sorted_words[wi], low, take)
            if src:
                part = part << src
            v = part if v is None else v | part
        vals.append(v)
    return vals


def _narrow(word: torch.Tensor, bits: int) -> torch.Tensor:
    """A sort key for a word whose value fits ``bits`` unsigned bits: the
    narrowest signed dtype that holds it as a non-negative value (a radix
    sort's passes scale with the key's width), else the word with its sign
    bit flipped so that signed order is unsigned order."""
    for dtype, width in ((torch.uint8, 8), (torch.int16, 15),
                         (torch.int32, 31), (torch.int64, 63)):
        if bits <= width:
            return word.to(dtype)
    return word ^ _SIGN


def sort_permutation(words: Sequence[torch.Tensor],
                     used_bits: Sequence[int] = None) -> torch.Tensor:
    """Stable lexicographic argsort over unsigned 64-bit words (most
    significant first): one stable argsort per word, least significant
    word first, each over the order found so far. ``used_bits`` gives the
    occupied low bits of each word (64 when not given)."""
    if used_bits is None:
        used_bits = [64] * len(words)
    perm = None
    for w, bits in zip(reversed(words), reversed(list(used_bits))):
        key = _narrow(w if perm is None else w[perm], bits)
        step = torch.sort(key, stable=True).indices
        perm = step if perm is None else perm[step]
    return perm


def sort_rows(pairs: Sequence[Tuple[torch.Tensor, int]],
              payloads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Payloads in stable sorted key order (split-packed words, LSD
    argsorts, one gather per payload)."""
    return sort_rows_with_keys(pairs, payloads)[0]


def sort_rows_with_keys(pairs, payloads):
    """sort_rows plus each pair's values in sorted order, so callers can
    decode key columns instead of carrying them as payloads."""
    words, used, frags = pack_split(pairs)
    perm = sort_permutation(words, used)
    sorted_words = [w[perm] for w in words]
    return ([p[perm] for p in payloads],
            extract_pair_values(pairs, frags, sorted_words))
