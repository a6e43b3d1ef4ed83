"""The port's distributed operators (``arrow1_tpu_torch.parallel``) on four
gloo ranks against the JAX package's at ``make_mesh(4)`` (twins of
tests/test_parallel.py and tests/test_skew.py).

Four spawned ranks (``test_torch_ranks``) run every case of
``rank_cases`` once, each rank with the same global batch; every rank
must get the same whole result back. The JAX package's answers come from
the answer workers (``reference_answers``), at the same capacity
arguments, so that an overflow raises, and the salting splits, in both or
in neither. Rows compare as multisets (floats of an aggregate within
1e-12 relative), a sort row for row; ``partition_ids`` bit for bit. One
more case runs a one-rank gloo group in the test process.
"""

import math

import numpy as np
import pyarrow as pa
import pytest

import test_torch_ranks

WORLD = 4
RANKS = dict(world=WORLD, from_env=False)   # test_torch_ranks.start_imported
POOL = np.array(["ab", "cd", "ef", "gh", "ij", "kl", "mn", "op", "qr", "st"],
                dtype=object)


def gen_batch(n=200, seed=3, null_p=0.1):
    rng = np.random.default_rng(seed)

    def nulls():
        return rng.random(n) < null_p

    return pa.record_batch({
        "k": pa.array(rng.integers(0, 20, n), mask=nulls()),
        "s": pa.array(POOL[rng.integers(0, 10, n)], mask=nulls()),
        "v": pa.array(rng.integers(-100, 100, n), mask=nulls()),
        "f": pa.array(rng.standard_normal(n) * 100, mask=nulls()),
    })


def join_tables(seed, n, m, hi, null_l, null_r):
    rng = np.random.default_rng(seed)
    left = pa.record_batch({
        "k": pa.array(rng.integers(0, hi, n), mask=rng.random(n) < null_l),
        "lv": pa.array(np.arange(n, dtype=np.int64))})
    right = pa.record_batch({
        "k": pa.array(rng.integers(0, hi, m), mask=rng.random(m) < null_r),
        "rv": pa.array(np.arange(m, dtype=np.int64))})
    return left, right


def skewed_tables(n=400, hot_frac=0.9, seed=0, unmatched=False):
    rng = np.random.default_rng(seed)
    lk = np.where(rng.random(n) < hot_frac, 7,
                  rng.integers(0, 50, n)).astype(np.int64)
    if unmatched:
        lk = np.where(np.arange(n) % 11 == 0, 999, lk)
    rk = np.arange(50, dtype=np.int64)
    return (pa.record_batch({"k": pa.array(lk),
                             "lv": pa.array(np.arange(n, dtype=np.int64))}),
            pa.record_batch({"k": pa.array(rk), "rv": pa.array(rk * 100)}))


def no_skew_tables():
    rng = np.random.default_rng(5)
    return (pa.record_batch({
        "k": pa.array(rng.permutation(200).astype(np.int64)),
        "lv": pa.array(np.arange(200, dtype=np.int64))}),
        pa.record_batch({"k": pa.array(np.arange(200, dtype=np.int64)),
                         "rv": pa.array(np.arange(200, dtype=np.int64) * 3)}))


def decimal_batches():
    from decimal import Decimal

    rng = np.random.default_rng(0)
    d256 = pa.record_batch({
        "k": pa.array(rng.integers(0, 5, 64).astype(np.int64)),
        "d": pa.array([Decimal("1.50")] * 64, type=pa.decimal256(50, 2))})
    rng = np.random.default_rng(1)
    big = Decimal("92233720368547758.08")   # high limb != sign extension
    vals = [big if i % 2 else Decimal("1.00") for i in range(64)]
    d128 = pa.record_batch({
        "k": pa.array(rng.integers(0, 3, 64).astype(np.int64)),
        "d": pa.array(vals, type=pa.decimal128(38, 2))})
    dims = pa.record_batch({
        "k2": pa.array(np.arange(3, dtype=np.int64)),
        "dd": pa.array([big] * 3, type=pa.decimal128(38, 2))})
    return d256, d128, dims


GB_CASES = {   # name: (batch, keys, aggregates)
    "gb_sum_count": (dict(), ["k"], [("v", "sum"), ("v", "count")]),
    "gb_min_max_mean": (dict(seed=9), ["k"],
                        [("v", "min"), ("v", "max"), ("f", "mean")]),
    "gb_string_key": (dict(seed=5), ["s"], [("v", "sum")]),
    "gb_multi_key": (dict(seed=7), ["k", "s"], [("v", "sum"), ("f", "min")]),
}
JOIN_CASES = {   # name: (tables, keyword arguments)
    "join_inner": (lambda: join_tables(41, 150, 60, 30, 0.1, 0.1), {}),
    "join_left_outer": (lambda: join_tables(43, 100, 40, 40, 0.15, 0.0),
                        dict(join_type="left outer")),
    # tests/test_skew.py's capacity is 20 at eight devices; at four ranks
    # 50 is the least at which the salted join fits (and the unsalted
    # one, every source sending ~90 hot rows to one rank, overflows)
    "skew_unsalted_overflows": (skewed_tables, dict(
        salt=False, capacity_per_dest=50, output_capacity=4096)),
    "skew_salted_fits": (skewed_tables, dict(capacity_per_dest=50,
                                             output_capacity=4096)),
    "skew_salted": (skewed_tables, {}),
    "skew_salted_left_outer": (
        lambda: skewed_tables(seed=3, unmatched=True),
        dict(join_type="left outer")),
    "skew_none": (no_skew_tables, {}),
}
SORT_CASES = {
    "sort_single_key": (11, [("v", "ascending")]),
    "sort_multi_key_strings": (13, [("s", "ascending"), ("v", "descending")]),
}
VAR_AGGS = [("v", "variance"), ("v", "stddev"), ("b", "any"), ("b", "all")]
APPROX = ("f_mean", "v_variance", "v_stddev")


def var_batch():
    rng = np.random.default_rng(71)
    return pa.record_batch({
        "k": pa.array(rng.integers(0, 6, 160)),
        "v": pa.array(rng.standard_normal(160), mask=rng.random(160) < 0.1),
        "b": pa.array(rng.integers(0, 2, 160).astype(bool),
                      mask=rng.random(160) < 0.1)})


def _rows(rb):
    return rb.to_arrow().to_pylist()


def _cases(P, ingest, mesh, rows, raises):
    """The cases against package ``P`` (the port, or the JAX package
    through thin adapters); returns name -> rows or a raise."""
    out = {}
    b = ingest(gen_batch())
    e = P.field("v") > 0
    out["filter"] = raises(lambda: rows(P.dist_filter(b, e, mesh)))
    b333 = ingest(gen_batch(n=333, seed=5))
    out["filter_padded"] = raises(lambda: sorted(P.padded_counts(
        b333, P.field("v") <= 0, mesh)))
    b400 = ingest(gen_batch(n=400))
    out["filter_selective"] = raises(lambda: rows(
        P.dist_filter(b400, P.field("v") > 50, mesh)))
    for name, (kw, keys, aggs) in GB_CASES.items():
        gb = ingest(gen_batch(**kw))
        out[name] = raises(lambda: rows(
            P.dist_group_by(gb, keys, aggs, mesh)))
    vb = ingest(var_batch())
    out["gb_variance_any_all"] = raises(lambda: rows(
        P.dist_group_by(vb, ["k"], VAR_AGGS, mesh)))
    for name, (tables, kw) in JOIN_CASES.items():
        left, right = (ingest(t) for t in tables())
        out[name] = raises(lambda: rows(
            P.dist_join(left, right, keys=["k"], mesh=mesh, **kw)))
    for name, (seed, keys) in SORT_CASES.items():
        sb = ingest(gen_batch(seed=seed))
        out[name] = raises(lambda: rows(P.dist_sort(sb, keys, mesh)))
    si = ingest(gen_batch(seed=17))
    out["sort_indices"] = raises(lambda: P.dist_sort_indices(
        si, [("k", "descending"), ("f", "ascending")], mesh).to_pylist())
    d256, d128, dims = (ingest(t) for t in decimal_batches())
    out["dec256_count_by_k"] = raises(lambda: rows(
        P.dist_group_by(d256, ["k"], [("d", "count")], mesh)))
    out["dec256_count_by_d"] = raises(lambda: rows(
        P.dist_group_by(d256, ["d"], [("k", "count")], mesh)))
    out["dec128_by_d"] = raises(lambda: rows(
        P.dist_group_by(d128, ["d"], [("k", "count")], mesh)))
    out["dec128_filter"] = raises(lambda: rows(
        P.dist_filter(d128, P.field("k") > 0, mesh)))
    out["dec128_join"] = raises(lambda: rows(P.dist_join(
        d128, dims, keys=["k"], right_keys=["k2"], mesh=mesh)))
    out["dec128_sort"] = raises(lambda: rows(
        P.dist_sort(d128, [("k", "ascending")], mesh)))
    out["dec128_sum_raises"] = raises(lambda: rows(
        P.dist_group_by(d128, ["k"], [("d", "sum")], mesh)))
    return out


class _Port:
    """The port's operators under the names ``_cases`` calls."""

    def __init__(self):
        import arrow1_tpu_torch as pt
        from arrow1_tpu_torch.parallel import distributed as D

        self.field = pt.field
        self.dist_filter = D.dist_filter
        self.dist_group_by = D.dist_group_by
        self.dist_join = D.dist_join
        self.dist_sort = D.dist_sort
        self.dist_sort_indices = D.dist_sort_indices

    @staticmethod
    def padded_counts(batch, expr, mesh):
        from arrow1_tpu_torch.parallel import dist_filter_padded

        _, counts, names = dist_filter_padded(batch, expr, mesh)
        return [int(counts.sum())] + sorted(names)


def rank_cases(mesh):
    """Every case on this rank (the ranks run it together), and a check of
    what the filter gathers: each column's gather carries the ranks'
    output rows, never the input's."""
    import arrow1_tpu_torch as pt
    from arrow1_tpu_torch.parallel import distributed as D

    def ingest(rb):
        return pt.interop.record_batch_from_arrow(rb, device="cpu")

    out = _cases(_Port(), ingest, mesh, _rows, test_torch_ranks.outcome)
    real, gathered = D.gather_varlen, []

    def counting(x, sizes, m):
        gathered.append(sum(sizes))
        return real(x, sizes, m)

    D.gather_varlen = counting
    try:
        b = ingest(gen_batch(n=400))
        rows = _rows(D.dist_filter(b, pt.field("v") > 50, mesh))
    finally:
        D.gather_varlen = real
    out["filter_gathers"] = (len(rows), sorted(set(gathered)))
    return out


class _Jax:
    """The JAX package's operators under the names ``_cases`` calls."""

    def __init__(self):
        import arrow1_tpu as a1t
        from arrow1_tpu.parallel import distributed as D

        self.field = a1t.field
        self.dist_filter = D.dist_filter
        self.dist_group_by = D.dist_group_by
        self.dist_join = D.dist_join
        self.dist_sort = D.dist_sort
        self.dist_sort_indices = D.dist_sort_indices

    @staticmethod
    def padded_counts(batch, expr, mesh):
        from arrow1_tpu.parallel import dist_filter_padded

        _, counts, names = dist_filter_padded(batch, expr, mesh)
        return [int(np.asarray(counts).sum())] + sorted(names)


PART_KEYS = 2   # parts of the answers, each in a worker of its own


def reference_answers(part=None):
    """The JAX package's answers at make_mesh(4), and its partition ids
    (part p: every other case from the p-th, in order)."""
    import arrow1_tpu as a1t
    from arrow1_tpu.parallel import make_mesh
    from arrow1_tpu.parallel.shuffle import partition_ids

    mesh = make_mesh(WORLD)
    jax_cases = _Jax()
    names = []

    def keep(fn):   # compute only this part's cases
        names.append(None)
        if part is not None and (len(names) - 1) % PART_KEYS != part:
            return None
        return test_torch_ranks.outcome(fn)

    out = _cases(jax_cases, a1t.record_batch, mesh,
                 lambda rb: a1t.interop.record_batch_to_arrow(rb).to_pylist(),
                 keep)
    out = {k: v for k, v in out.items() if v is not None}
    if part in (None, 0):
        import jax.numpy as jnp

        keys, salt = _partition_inputs()
        for n in PARTS:
            out["pid", n] = np.asarray(partition_ids(
                jnp.asarray(keys), n)).tolist()
            out["pid_salt", n] = np.asarray(partition_ids(
                jnp.asarray(keys), n, jnp.asarray(salt))).tolist()
    return out


PARTS = (1, 2, 3, 4, 7, 8)


def _partition_inputs():
    rng = np.random.default_rng(12)
    keys = np.concatenate([
        rng.integers(0, 2**63, 200, dtype=np.uint64) * np.uint64(2),
        np.array([0, 1, 2**63, 2**64 - 1, 2**63 - 1], dtype=np.uint64)])
    salt = rng.integers(0, 8, keys.shape[0]).astype(np.int32)
    return keys, salt


@pytest.fixture(scope="module")
def results():
    """(the four ranks' results, the JAX package's answers): the ranks
    start first and run while the answers are awaited."""
    from test_torch_answers import answers_of

    test_torch_ranks.start(__name__, **RANKS)
    want = answers_of(__name__)
    return test_torch_ranks.results(__name__), want


CASES = (["filter", "filter_padded", "filter_selective"] + list(GB_CASES)
         + ["gb_variance_any_all"] + list(JOIN_CASES) + list(SORT_CASES)
         + ["sort_indices", "dec256_count_by_k", "dec256_count_by_d",
            "dec128_by_d", "dec128_filter", "dec128_join", "dec128_sort",
            "dec128_sum_raises"])
ORDERED = set(SORT_CASES) | {"sort_indices", "filter_padded"}


def _key(row):
    return repr(sorted((k, v) for k, v in row.items() if k not in APPROX))


def _close(a, b):
    if a is None or b is None:
        return a is b
    if math.isnan(a) or math.isnan(b):
        return math.isnan(a) and math.isnan(b)
    return math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-12)


def assert_same(got, want, ordered):
    if isinstance(want, tuple) and want and want[0] == "raises":
        assert isinstance(got, tuple) and got[0] == "raises", got
        assert got[1] == want[1], (got, want)
        return
    assert not (isinstance(got, tuple) and got and got[0] == "raises"), got
    if ordered:
        assert got == want
        return
    assert len(got) == len(want)
    for g, w in zip(sorted(got, key=_key), sorted(want, key=_key)):
        assert _key(g) == _key(w), (g, w)
        for col in APPROX:
            if col in w:
                assert _close(g[col], w[col]), (col, g, w)


@pytest.mark.parametrize("case", CASES)
def test_distributed_operators_match_the_jax_package(case, results):
    ranks, want = results
    for r in ranks[1:]:   # every rank gets the whole result
        assert repr(r[case]) == repr(ranks[0][case])
    assert_same(ranks[0][case], want[case], case in ORDERED)


def test_unsalted_join_overflows_where_the_salted_fits(results):
    ranks, want = results
    assert want["skew_unsalted_overflows"][0] == "raises"
    assert "overflow" in ranks[0]["skew_unsalted_overflows"][2]
    assert ranks[0]["skew_unsalted_overflows"][1] == "Invalid"
    assert not isinstance(ranks[0]["skew_salted_fits"], tuple)


def test_filter_gathers_only_its_output(results):
    ranks, _ = results
    for r in ranks:
        n_out, gathered = r["filter_gathers"]
        assert n_out < 400 // 2 and gathered == [n_out]


@pytest.mark.parametrize("n", PARTS)
def test_partition_ids_are_the_reference_bit_for_bit(n, results):
    import torch

    from arrow1_tpu_torch.parallel.shuffle import partition_ids

    _, want = results
    keys, salt = _partition_inputs()
    k = torch.from_numpy(keys.view(np.int64).copy())
    assert partition_ids(k, n).tolist() == want["pid", n]
    assert partition_ids(k, n, torch.from_numpy(salt)).tolist() == \
        want["pid_salt", n]


def test_one_rank_gloo_group_in_process():
    """A one-rank group over a HashStore (no port) in the test process:
    every operator equals the eager engine."""
    import arrow1_tpu_torch as pt
    from arrow1_tpu_torch.exec.plan import sort_batch
    from arrow1_tpu_torch.parallel import (dist_filter, dist_group_by,
                                           dist_join, make_mesh, multihost)
    from arrow1_tpu_torch.parallel.distributed import dist_sort

    multihost.initialize(device="cpu")
    try:
        mesh = make_mesh(device="cpu")
        assert (mesh.size, mesh.rank, mesh.device.type) == (1, 0, "cpu")
        b = pt.interop.record_batch_from_arrow(gen_batch(), device="cpu")
        e = pt.field("v") > 0
        assert_same(_rows(dist_filter(b, e, mesh)),
                    _rows(pt.filter(b, e.execute(b))), True)
        aggs = [("v", "sum"), ("v", "count"), ("f", "max")]
        assert_same(_rows(dist_group_by(b, ["k", "s"], aggs, mesh)),
                    _rows(pt.group_by(b, ["k", "s"], aggs)), False)
        left, right = (pt.interop.record_batch_from_arrow(t, device="cpu")
                       for t in join_tables(41, 150, 60, 30, 0.1, 0.1))
        for jt in ("inner", "left outer"):
            assert_same(_rows(dist_join(left, right, ["k"], join_type=jt,
                                        mesh=mesh)),
                        _rows(pt.join(left, right, ["k"], join_type=jt)),
                        False)
        keys = [("s", "ascending"), ("v", "descending")]
        assert _rows(dist_sort(b, keys, mesh)) == _rows(sort_batch(b, keys))
    finally:
        multihost.shutdown()
