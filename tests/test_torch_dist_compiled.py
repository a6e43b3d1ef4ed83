"""The port's distributed compiled pipeline (``exec/dist_compiled.py``) and
the distributed TPC-H templates on four gloo ranks, against the JAX
package's at ``make_mesh(4)`` (twin of tests/test_dist_compiled.py).

Four spawned ranks (``test_torch_ranks``) run every pipeline once; the
JAX package's answers come from an answer worker. Sorted results compare
row for row (floats of a mean or variance within 1e-9, as the reference's
test holds its two group-by paths), the joins as multisets; an overflow
must raise in both. In place of the reference's count of jitted programs,
the pipeline must read the host once, for its overflow flag, before the
gather of its result.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

import test_torch_ranks

WORLD = 4
RANKS = dict(world=WORLD, from_env=False)   # test_torch_ranks.start_imported
AGGS = [("v", "sum"), ("v", "count"), ("f", "min"), ("f", "max"),
        ("f", "mean"), ("f", "variance"), ("f", "stddev")]
APPROX = ("f_mean", "f_variance", "f_stddev")


def make_tables(n=1000, m=32, seed=11):
    rng = np.random.default_rng(seed)
    facts = pa.record_batch({
        "k": pa.array(rng.integers(0, m, n)),
        "v": pa.array(rng.integers(-100, 100, n)),
        "f": pa.array(rng.normal(size=n))})
    dims = pa.record_batch({
        "k": pa.array(np.arange(m, dtype=np.int64)),
        "cat": pa.array((np.arange(m) % 5).astype(np.int64))})
    return facts, dims


def null_key_batch():
    rng = np.random.default_rng(5)
    n = 8_000
    k = rng.integers(0, 100, n).astype(np.int64)
    kmask = rng.random(n) < 0.05
    return pa.record_batch({
        "k": pa.array(k, mask=kmask),
        "v": pa.array(rng.integers(-100, 100, n).astype(np.int64)),
        "f": pa.array(rng.standard_normal(n))})


def distinct_batch():
    rng = np.random.default_rng(0)
    n = 4_000
    return pa.record_batch({
        "k": pa.array(np.arange(n, dtype=np.int64)),
        "v": pa.array(rng.integers(0, 10, n).astype(np.int64))})


def colliding_tables():
    """Key pairs whose 64-bit folds collide: they must not match."""
    M = np.uint64(0x9E3779B97F4A7C15)
    S = np.uint64(1 << 63)

    def u(x):
        return np.uint64(np.int64(x)) ^ S

    with np.errstate(over="ignore"):
        target = (u(1) * M) ^ u(2)
        b2 = np.int64((u(3) * M) ^ target ^ S)
    probe = pa.record_batch({
        "k1": pa.array([1, 7] * 8, pa.int64()),
        "k2": pa.array([2, 8] * 8, pa.int64()),
        "pv": pa.array(list(range(16)), pa.int64())})
    build = pa.record_batch({
        "k1": pa.array([3, 7], pa.int64()),
        "k2": pa.array([int(b2), 8], pa.int64()),
        "w": pa.array([111, 222], pa.int64())})
    return probe, build


def tpch_batches():
    """Small TPC-H tables (profile_main_path's recipe) with their string
    columns decoded, as pyarrow batches for both packages."""
    from arrow1_tpu_torch.profile_main_path import tpch_tables

    li, orders, _ = tpch_tables(6000, 1500, 150)

    def batch(cols):
        return pa.record_batch({
            k: pa.array(v[1][v[0]]) if isinstance(v, tuple) else pa.array(v)
            for k, v in cols.items()})

    return batch(li), batch(orders)


def _cases(P, ingest, mesh, rows, raises):
    """name -> the pipeline's rows (or its raise), for package adapter P."""
    out = {}
    facts_rb, dims_rb = make_tables()
    facts, dims = ingest(facts_rb), ingest(dims_rb)
    f = P.field
    out["filter_group_sort"] = raises(lambda: rows(
        P.builder(mesh).filter(f("v") > 0)
        .group_by(["k"], [("v", "sum"), ("v", "count")])
        .sort([("k", "ascending")]).compile()(facts)))
    out["full_pipeline_with_join"] = raises(lambda: rows(
        P.builder(mesh).filter(f("v") > -60).join(dims, "k", fanout=4)
        .group_by(["cat"], [("v", "sum"), ("v", "count"), ("f", "min")])
        .sort([("cat", "ascending")]).compile()(facts)))
    half = ingest(dims_rb.filter(pa.array(np.arange(32) < 16)))
    out["left_outer_join"] = raises(lambda: rows(
        P.builder(mesh).join(half, "k", join_type="left outer", fanout=4)
        .compile()(facts)))
    out["limit_and_project"] = raises(lambda: rows(
        P.builder(mesh).project([f("v") * f("v")], ["v2"])
        .filter(f("v2") > 2500).sort([("v2", "descending")]).limit(7)
        .compile()(facts)))
    out["overflow_flag"] = raises(lambda: rows(
        P.builder(mesh).join(dims, "k", fanout=4, shuffle_cap=2)
        .compile()(facts)))
    nk = ingest(null_key_batch())
    for cap, label in ((512, "partial"), (None, "rows")):
        out[f"group_by_{label}"] = raises(lambda: rows(
            P.builder(mesh).group_by(["k"], AGGS, shuffle_cap=cap)
            .sort([("k", "ascending")]).compile()(nk)))
    db = ingest(distinct_batch())
    out["partial_overflow"] = raises(lambda: rows(
        P.builder(mesh).group_by(["k"], [("v", "sum")], shuffle_cap=64)
        .compile()(db)))
    probe, build = (ingest(t) for t in colliding_tables())
    out["fold_collision"] = raises(lambda: rows(
        P.builder(mesh).join(build, ["k1", "k2"], join_type="left outer",
                             fanout=4).compile()(probe)))
    li, orders = (ingest(t) for t in tpch_batches())
    out["q1_distributed"] = raises(lambda: rows(P.q1(li, mesh=mesh)))
    out["q3_distributed"] = raises(lambda: rows(P.q3(li, orders,
                                                     mesh=mesh)))
    return out


ORDERED = {"filter_group_sort", "full_pipeline_with_join",
           "limit_and_project", "group_by_partial", "group_by_rows",
           "q1_distributed", "q3_distributed"}
CASES = sorted(ORDERED | {"left_outer_join", "overflow_flag",
                          "partial_overflow", "fold_collision"})


class _Port:
    def __init__(self):
        import arrow1_tpu_torch as pt
        from arrow1_tpu_torch.exec import DistPipelineBuilder
        from arrow1_tpu_torch.models import q1_distributed, q3_distributed

        self.field, self.builder = pt.field, DistPipelineBuilder
        self.q1, self.q3 = q1_distributed, q3_distributed


class _Jax:
    def __init__(self):
        import arrow1_tpu as a1t
        from arrow1_tpu.exec import DistPipelineBuilder
        from arrow1_tpu.models.tpch import q1_distributed, q3_distributed

        self.field, self.builder = a1t.field, DistPipelineBuilder
        self.q1, self.q3 = q1_distributed, q3_distributed


def _rows(rb):
    return rb.to_arrow().to_pylist()


def rank_cases(mesh):
    """Every pipeline on this rank, and the order of the host reads of one
    pipeline: the overflow flag, then the gather."""
    import arrow1_tpu_torch as pt
    from arrow1_tpu_torch.exec import dist_compiled as dc

    def ingest(rb):
        return pt.interop.record_batch_from_arrow(rb, device="cpu")

    out = _cases(_Port(), ingest, mesh, _rows, test_torch_ranks.outcome)
    reads = []
    real_flag, real_gather = dc.read_flag, dc.gather_live

    def flag(x):
        reads.append("overflow flag")
        return real_flag(x)

    def gather(*a):
        reads.append("gather")
        return real_gather(*a)

    dc.read_flag, dc.gather_live = flag, gather
    try:
        facts_rb, dims_rb = make_tables(n=400)
        facts, dims = ingest(facts_rb), ingest(dims_rb)
        (dc.DistPipelineBuilder(mesh).filter(pt.field("v") > 0)
         .join(dims, "k", fanout=4).group_by(["cat"], [("v", "sum")])
         .sort([("cat", "ascending")]).compile())(facts)
    finally:
        dc.read_flag, dc.gather_live = real_flag, real_gather
    out["host_reads"] = reads
    return out


PARTS = 2   # parts of the answers, each in a worker of its own


def reference_answers(part=None):
    """The JAX package's answers at make_mesh(4) (part p: every other
    case from the p-th, in order)."""
    import arrow1_tpu as a1t
    from arrow1_tpu.parallel import make_mesh

    seen = []

    def keep(fn):
        seen.append(None)
        if part is not None and (len(seen) - 1) % PARTS != part:
            return None
        return test_torch_ranks.outcome(fn)

    out = _cases(_Jax(), a1t.record_batch, make_mesh(WORLD),
                 lambda rb: a1t.interop.record_batch_to_arrow(
                     rb).to_pylist(), keep)
    return {k: v for k, v in out.items() if v is not None}


@pytest.fixture(scope="module")
def results():
    from test_torch_answers import answers_of

    test_torch_ranks.start(__name__, **RANKS)
    want = answers_of(__name__)
    return test_torch_ranks.results(__name__), want


def _key(row):
    return repr(sorted((k, v) for k, v in row.items() if k not in APPROX))


def _close(a, b):
    if a is None or b is None:
        return a is b
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return math.isclose(a, b, rel_tol=1e-9, abs_tol=1e-9)


@pytest.mark.parametrize("case", CASES)
def test_pipeline_matches_the_jax_package(case, results):
    ranks, want = results
    got, w = ranks[0][case], want[case]
    for r in ranks[1:]:   # every rank gets the whole result
        assert repr(r[case]) == repr(got)
    if isinstance(w, tuple):
        assert isinstance(got, tuple) and got[:2] == w[:2], (got, w)
        assert "overflow" in got[2]
        return
    assert not isinstance(got, tuple), got
    assert len(got) == len(w)
    if case not in ORDERED:
        got, w = sorted(got, key=_key), sorted(w, key=_key)
    for g, e in zip(got, w):
        assert _key(g) == _key(e), (g, e)
        for col in APPROX:
            if col in e:
                assert _close(g[col], e[col]), (col, g, e)


def test_the_pipeline_reads_the_host_once_before_its_gather(results):
    ranks, _ = results
    for r in ranks:
        assert r["host_reads"] == ["overflow flag", "gather"]
