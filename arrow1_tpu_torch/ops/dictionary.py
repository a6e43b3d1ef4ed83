"""Dictionary unification, re-encoding and ``dictionary_decode``
(counterpart of arrow1_tpu/ops/dictionary.py).

The value pools live on the host (``column.Dictionary``); only the code
remap is a device gather. The join needs these for string keys whose two
sides carry different pools, and for the full-outer coalesce of a key.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from ..column import Column, Dictionary
from ..errors import Invalid
from ..registry import register_function

__all__ = ["unify_dictionaries", "unify_pair", "reencode_against",
           "one_pool"]


def _remap(col: Column, remap: np.ndarray) -> torch.Tensor:
    """The codes through ``remap``; a null slot's code is not read (it
    need not index the pool) and becomes 0."""
    if len(remap) == 0:
        return col.data
    table = torch.from_numpy(remap).to(col.device)
    codes = col.data.long()
    if col.validity is not None:
        codes = torch.where(col.validity, codes, 0)
    return table[codes]


def unify_dictionaries(cols: Sequence[Column]
                       ) -> Tuple[torch.Tensor, Dictionary]:
    """Merge the pools of several dictionary-encoded columns, in order of
    first appearance, and return the concatenated remapped codes and the
    unified Dictionary."""
    pool: dict = {}
    values: List = []
    remaps = []
    for c in cols:
        if c.dictionary is None:
            raise Invalid("unify_dictionaries: column has no dictionary")
        remap = np.empty(len(c.dictionary), dtype=np.int32)
        for code, v in enumerate(c.dictionary.values.tolist()):
            if v not in pool:
                pool[v] = len(values)
                values.append(v)
            remap[code] = pool[v]
        remaps.append(remap)
    unified = Dictionary(np.array(values, dtype=object))
    parts = [_remap(c, remap) for c, remap in zip(cols, remaps)]
    return torch.cat(parts), unified


def one_pool(args, n: int, device) -> List[Column]:
    """String arguments as columns over one pool: a string Scalar becomes
    ``n`` rows of a one-value pool (null when the scalar is), then pools
    that differ are unified (a no-op when they are one already)."""
    from ..datum import Scalar

    cols = []
    for a in args:
        if isinstance(a, Scalar):
            value = a.dictionary.values[int(a.value)] \
                if a.dictionary is not None else a.value
            a = Column(torch.zeros(n, dtype=torch.int32, device=device),
                       a.dtype, validity=None if a.is_valid else
                       torch.zeros(n, dtype=torch.bool, device=device),
                       dictionary=Dictionary(np.array([value],
                                                      dtype=object)))
        cols.append(a)
    if all(c.dictionary is cols[0].dictionary for c in cols):
        return cols
    merged, pool = unify_dictionaries(cols)
    out, pos = [], 0
    for c in cols:
        out.append(Column(merged[pos:pos + c.length], c.dtype,
                          validity=c.validity, dictionary=pool))
        pos += c.length
    return out


def unify_pair(a: Column, b: Column) -> Tuple[Column, Column]:
    """Two dictionary columns re-encoded against one merged pool."""
    merged, d = unify_dictionaries([a, b])
    return (Column(merged[:a.length], a.dtype, validity=a.validity,
                   dictionary=d),
            Column(merged[a.length:], b.dtype, validity=b.validity,
                   dictionary=d))


def reencode_against(col: Column, target: Dictionary) -> Column:
    """Re-encode a dictionary column's codes against ``target``. A value
    missing from the target raises (callers unify first)."""
    if col.dictionary is None:
        raise Invalid("reencode_against: column has no dictionary")
    if col.dictionary is target:
        return col
    idx = target.index
    try:
        remap = np.array([idx[v] for v in col.dictionary.values.tolist()],
                         dtype=np.int32)
    except KeyError as e:
        raise Invalid(f"reencode_against: value {e.args[0]!r} is not in "
                      "the target dictionary") from None
    return Column(_remap(col, remap), col.dtype, validity=col.validity,
                  dictionary=target)


def _dictionary_decode_exec(args, options, ctx):
    """Inverse of dictionary_encode: an explicit dictionary column becomes
    its value type: strings keep the codes and the pool (the port's string
    columns are code-backed), numbers are gathered from the pool. Any
    other column passes through unchanged, as in pyarrow."""
    (col,) = args
    if not col.dtype.is_dictionary:
        return col
    vt = col.dtype.value_type
    if vt.is_binary:
        return Column(col.data, vt, validity=col.validity,
                      dictionary=col.dictionary)
    pool = col.dictionary.values
    if not len(pool):
        return Column(torch.zeros_like(col.data, dtype=vt.physical_dtype()),
                      vt, validity=col.validity)
    lut = torch.from_numpy(np.asarray(pool).astype(vt.numpy_dtype()))
    return Column(lut.to(col.device)[col.data.long().clamp(0, len(pool) - 1)],
                  vt, validity=col.validity)


register_function("dictionary_decode", "vector", 1)(_dictionary_decode_exec)
