"""Expressions and the scalar kernels of the port (compare, arithmetic with
its checked variants, Kleene boolean logic) held against the JAX package
on the same seeded columns with nulls: values where valid, and validity,
must match exactly."""

import numpy as np
import pyarrow as pa
import pytest

import arrow1_tpu as a1t

import arrow1_tpu_torch as pt
from arrow1_tpu_torch.errors import Invalid

N = 257


def _batches(seed=0):
    rng = np.random.default_rng(seed)
    ints = rng.integers(-50, 50, N).astype(np.int64)
    ints[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, -1, 0]
    data = {
        "a": ints,
        "b": rng.integers(-5, 5, N).astype(np.int32),
        "x": rng.standard_normal(N),
        "y": rng.standard_normal(N).astype(np.float32),
        "p": rng.random(N) < 0.5,
        "q": rng.random(N) < 0.5,
    }
    rb = pa.record_batch({k: pa.array(v, mask=rng.random(N) < 0.15)
                          for k, v in data.items()})
    return a1t.record_batch(rb), pt.record_batch(rb, device="cpu")


def _same(got, want):
    wv = np.ones(N, bool) if want.validity is None else \
        np.asarray(want.validity)
    gv = np.ones(N, bool) if got.validity is None else got.validity.numpy()
    np.testing.assert_array_equal(gv, wv)
    wd, gd = np.asarray(want.data), got.data.numpy()
    assert gd.dtype == wd.dtype
    np.testing.assert_array_equal(gd[wv], wd[wv])


EXPRS = {
    "gt_mixed": lambda m: m.field("a") > m.field("b"),
    "le_scalar": lambda m: m.field("x") <= 0.25,
    "eq_int_float": lambda m: m.field("b") == m.field("y"),
    "ne": lambda m: m.field("p") != m.field("q"),
    "add_wraps": lambda m: m.field("a") + 7,
    "sub": lambda m: m.field("b") - m.field("a"),
    "mul_float": lambda m: m.field("a") * 2.5 + m.field("x"),
    "mul_int32_int64": lambda m: m.field("b") * m.field("a"),
    "div_float": lambda m: m.field("x") / m.field("y"),
    "div_int": lambda m: m.call("divide", [m.field("a"), 3]),
    "neg": lambda m: -m.field("a"),
    "and_kleene": lambda m: m.field("p") & m.field("q"),
    "or_kleene": lambda m: m.field("p") | (m.field("x") > 0),
    "and_not_kleene": lambda m: m.call("and_not_kleene",
                                       [m.field("p"), m.field("q")]),
    "invert": lambda m: ~m.field("q"),
    "xor": lambda m: m.call("xor", [m.field("p"), m.field("q")]),
    "kleene_null_scalar": lambda m: m.field("p") & m.literal(
        m.scalar(None, m.bool_)),
}


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_expression_matches_jax(name):
    jb, tb = _batches()
    make = EXPRS[name]
    _same(make(pt).execute(tb), make(a1t).execute(jb))


@pytest.mark.parametrize("fn", ["add_checked", "subtract_checked",
                                "multiply_checked"])
def test_checked_arithmetic_raises_like_jax(fn):
    jb, tb = _batches(1)
    # a holds int64 min and max: adding/subtracting/multiplying by 2
    # overflows, exactly where the JAX package raises
    with pytest.raises(Exception) as jerr:
        a1t.call_function(fn, [jb["a"], 2 if fn != "subtract_checked"
                               else -2])
    with pytest.raises(Invalid) as terr:
        pt.call_function(fn, [tb["a"], 2 if fn != "subtract_checked"
                              else -2])
    assert "overflow" in str(jerr.value) and "overflow" in str(terr.value)
    small = pt.record_batch({"s": np.arange(-3, 3)}, device="cpu")["s"]
    assert pt.call_function(fn, [small, 2]).to_pylist() == \
        a1t.call_function(fn, [a1t.record_batch(
            {"s": np.arange(-3, 3)})["s"], 2]).to_pylist()


def test_divide_by_zero_raises():
    col = pt.record_batch({"s": np.array([1, 2], np.int64)},
                          device="cpu")["s"]
    with pytest.raises(Invalid, match="divide by zero"):
        pt.call_function("divide", [col, 0])


def test_bind_checks_field_names():
    expr = (pt.field("a") > 1) & pt.field("p")
    assert repr(expr.bind(["a", "p"])) == repr(expr)
    with pytest.raises(KeyError):
        expr.bind(["a"])


def test_scalar_only_expression():
    out = (pt.literal(3) * 4 + 1).execute(pt.RecordBatch((), ()))
    assert out.as_py() == 13
    null = pt.literal(pt.scalar(None, pt.bool_))
    empty = pt.RecordBatch((), ())
    assert (pt.literal(True) & null).execute(empty).as_py() is None
    assert (pt.literal(False) & null).execute(empty).as_py() is False
