"""Test support: seeded random data and parity assertions against
pyarrow (counterpart of arrow1_tpu/testing.py).

Reference: cpp/src/arrow/testing/random.h:41 (RandomArrayGenerator,
seeded, with a null density a type) and gtest_util.h:176-288
(ArrayFromJSON, AssertArraysEqual). pyarrow is the oracle, imported
inside each function, so importing this module needs no pyarrow.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from . import dtypes as dt
from .column import Column
from .table import RecordBatch

__all__ = [
    "RandomDataGenerator",
    "assert_column_equal",
    "assert_batch_equal",
    "assert_equals_arrow",
    "array_from_json",
    "batch_from_json",
]


class RandomDataGenerator:
    """Seeded random column generator (reference: testing/random.h:41)."""

    def __init__(self, seed: int = 42):
        self.rng = np.random.default_rng(seed)

    def numeric(self, length: int, type: dt.DataType = dt.int64,
                null_probability: float = 0.0, low=None, high=None):
        import pyarrow as pa

        np_dt = type.numpy_dtype()
        if type.is_integer:
            info = np.iinfo(np_dt)
            lo = info.min if low is None else low
            hi = info.max if high is None else high
            data = self.rng.integers(lo, hi, size=length, dtype=np_dt,
                                     endpoint=False)
        elif type.is_boolean:
            data = self.rng.integers(0, 2, size=length).astype(bool)
        else:
            data = (self.rng.standard_normal(length) * 100).astype(np_dt)
        mask = None
        if null_probability > 0:
            mask = self.rng.random(length) < null_probability
        return pa.array(data, mask=mask)

    def strings(self, length: int, num_unique: int = 100,
                null_probability: float = 0.0, min_len: int = 3,
                max_len: int = 12):
        import pyarrow as pa

        alphabet = np.array(list("abcdefghijklmnopqrstuvwxyz0123456789"))
        uniq = []
        for _ in range(num_unique):
            n = int(self.rng.integers(min_len, max_len + 1))
            uniq.append("".join(self.rng.choice(alphabet, size=n)))
        codes = self.rng.integers(0, num_unique, size=length)
        vals = [uniq[c] for c in codes]
        mask = None
        if null_probability > 0:
            mask = self.rng.random(length) < null_probability
            vals = [None if m else v for v, m in zip(vals, mask)]
        return pa.array(vals, type=pa.string())

    def batch(self, length: int, spec: Sequence, null_probability: float = 0.0):
        """spec: sequence of (name, DataType) — strings allowed."""
        import pyarrow as pa

        arrays, names = [], []
        for name, typ in spec:
            if typ.kind in ("string", "large_string"):
                arrays.append(self.strings(length,
                                           null_probability=null_probability))
            else:
                arrays.append(self.numeric(length, typ,
                                           null_probability=null_probability))
            names.append(name)
        return pa.record_batch(arrays, names=names)


def assert_column_equal(result: Column, expected, check_dtype: bool = True,
                        approx: bool = False, rtol=1e-12):
    """Assert a Column equals a pyarrow Array / list (reference:
    AssertArraysEqual gtest_util.h:176)."""
    import pyarrow as pa

    if not isinstance(expected, (pa.Array, pa.ChunkedArray)):
        expected = pa.array(expected)
    if isinstance(expected, pa.ChunkedArray):
        expected = expected.combine_chunks()
    got = result.to_arrow()
    if pa.types.is_dictionary(got.type) and not pa.types.is_dictionary(expected.type):
        got = got.cast(expected.type)
    if check_dtype:
        assert got.type == expected.type, f"dtype: {got.type} != {expected.type}"
    if approx:
        g = np.asarray(got.cast(pa.float64()).to_numpy(zero_copy_only=False))
        e = np.asarray(expected.cast(pa.float64()).to_numpy(zero_copy_only=False))
        gn, en = np.isnan(g), np.isnan(e)
        assert (gn == en).all(), "nan/null pattern mismatch"
        np.testing.assert_allclose(g[~gn], e[~en], rtol=rtol)
        return
    if not got.equals(expected.cast(got.type) if got.type != expected.type
                      else expected):
        def same(a, b):
            if a is b or a == b:
                return True
            # NaN is a value (not null): NaN == NaN for comparison purposes
            return (isinstance(a, float) and isinstance(b, float)
                    and np.isnan(a) and np.isnan(b))

        gl, el = got.to_pylist(), expected.to_pylist()
        diffs = [(i, a, b) for i, (a, b) in enumerate(zip(gl, el))
                 if not same(a, b)][:10]
        if len(gl) == len(el) and not diffs:
            return
        raise AssertionError(
            f"columns differ (len {len(gl)} vs {len(el)}); first diffs: {diffs}")


def assert_batch_equal(result: RecordBatch, expected, **kwargs):
    import pyarrow as pa

    if isinstance(expected, pa.Table):
        expected = expected.combine_chunks().to_batches()[0]
    got = result
    assert got.names == tuple(expected.schema.names), (
        f"names: {got.names} != {tuple(expected.schema.names)}")
    for i, name in enumerate(got.names):
        try:
            assert_column_equal(got.columns[i], expected.column(i), **kwargs)
        except AssertionError as e:
            raise AssertionError(f"column {name!r}: {e}") from None


def assert_equals_arrow(result, expected, **kwargs):
    if isinstance(result, Column):
        assert_column_equal(result, expected, **kwargs)
    elif isinstance(result, RecordBatch):
        assert_batch_equal(result, expected, **kwargs)
    else:
        import pyarrow as pa

        exp = expected.as_py() if isinstance(expected, pa.Scalar) else expected
        got = result.as_py() if hasattr(result, "as_py") else result
        assert got == exp, f"{got} != {exp}"


def array_from_json(type, json_text: str, device=None):
    """ArrayFromJSON (reference: testing/gtest_util.h:288): a Column of
    ``type`` from a JSON array literal, on ``device`` (CUDA unless the
    caller names the CPU)."""
    import json as _json

    import pyarrow as pa

    from .interop import column_from_arrow

    vals = _json.loads(json_text)
    return column_from_arrow(pa.array(vals, type=dt.to_arrow(type)),
                             device=device)


def batch_from_json(schema, json_text: str, device=None):
    """RecordBatchFromJSON: a JSON array of row objects and the (name,
    type) pairs of ``schema`` -> a RecordBatch on ``device``."""
    import json as _json

    import pyarrow as pa

    from .interop import record_batch_from_arrow

    rows = _json.loads(json_text)
    fields = [(n, dt.to_arrow(t)) for n, t in schema]
    arrays = [pa.array([r.get(n) for r in rows], type=t)
              for n, t in fields]
    return record_batch_from_arrow(
        pa.record_batch(arrays, names=[n for n, _ in fields]),
        device=device)
