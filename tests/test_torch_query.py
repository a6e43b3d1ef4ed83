"""The port's query layer against the JAX package on the same multi-batch
state: Table and concat_batches, the streaming aggregators, every
ExecPlan node, acero Declarations (also against pyarrow.acero), query()
and the TPC-H templates, and baseline_sort.

Each JAX Table is read out batch by batch as numpy and handed to the port
with ``from_reference_arrays``, so both engines start from the same bits,
per-batch dictionary pools included. Integers, counts, strings and
validity must match exactly. Float64 sums are added in another order in
each engine (per batch, then over the partials), so they must agree to
F64_RTOL, relative; values the engines only move must match bit for bit.

The JAX answers are computed once, on a thread pool (fixture
``jax_results``): the JAX package compiles every operation on first use
and shape, and the compiles of independent calls overlap. Its running
scans (``scan_blocked``) run under ``jax.jit``, one compile per combine
function, instead of one compile per level of the eager associative scan;
jit changes no result of an exact scan. The plan's filter is Q1's and
the acero Declarations read lineitem's first batch, so that they share
the templates' compiled shapes.
"""

import threading
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pyarrow as pa
import pyarrow.acero as pacero
import pyarrow.compute as pac
import jax
import pytest

import arrow1_tpu as a1t
import arrow1_tpu.acero as jacero
import arrow1_tpu.models as jmodels
import arrow1_tpu.ops.hash as jhash
import arrow1_tpu.ops.join as jjoin
import arrow1_tpu.ops.padded as jpadded
from arrow1_tpu.exec import plan as jplan
from arrow1_tpu.exec.streaming import (StreamingAggregator as JAgg,
                                       StreamingGroupBy as JGroupBy)
from arrow1_tpu.kernels.blockscan import scan_blocked
from test_tpch_pipeline import make_lineitem, make_orders

import arrow1_tpu_torch as pt
import arrow1_tpu_torch.acero as acero
import arrow1_tpu_torch.models as models
from arrow1_tpu_torch.errors import Invalid
from arrow1_tpu_torch.exec import plan
from arrow1_tpu_torch.exec.streaming import (StreamingAggregator,
                                             StreamingGroupBy)
from test_torch_answers import answers_of

F64_RTOL = 1e-12
NBATCH = 3


def _triple(c):
    return (np.asarray(c.data),
            None if c.validity is None else np.asarray(c.validity),
            None if c.dictionary is None else c.dictionary.values)


def _port(x):
    """A JAX RecordBatch or Table as the port's, on the CPU."""
    if isinstance(x, a1t.Table):
        return pt.from_reference_arrays(
            x.names, [[_triple(c) for c in b.columns] for b in x.batches],
            "cpu")
    return pt.from_reference_arrays(x.names, [_triple(c) for c in x.columns],
                                    "cpu")


def _lineitem_table():
    """make_lineitem's rows as a JAX Table of NBATCH batches, each ingested
    on its own (so each string column gets its own value pool). Rows are
    dealt to the batches by whether they pass Q1's and Q6's filters, so
    every batch keeps as many rows through each filter (a few rows are
    left out to make the counts divide): the JAX package then compiles
    each per-batch shape once, not once per batch."""
    rb = make_lineitem()
    col = {n: rb.column(n).to_numpy(zero_copy_only=False)
           for n in rb.schema.names}
    q1 = col["l_shipdate_days"] <= 10000
    q6 = (col["l_discount"] >= 0.02) & (col["l_discount"] <= 0.09) & \
        (col["l_quantity"] < 24)
    cls = 2 * q1 + q6
    parts = [[] for _ in range(NBATCH)]
    for c in range(4):
        rows = np.flatnonzero(cls == c)
        rows = rows[:len(rows) - len(rows) % NBATCH]
        for i in range(NBATCH):
            parts[i].extend(rows[i::NBATCH])
    return a1t.Table([a1t.record_batch(rb.take(np.sort(p))) for p in parts])


def _rows(b):
    """(names, rows) of a batch of either engine, strings decoded, floats
    as Python floats, nulls as None."""
    return list(b.names), b.to_arrow().to_pylist()


def _assert_same_rows(got, want, sort_by=None):
    gn, g = _rows(got)
    wn, w = _rows(want)
    assert gn == wn
    if sort_by:
        g = sorted(g, key=lambda r: [r[k] for k in sort_by])
        w = sorted(w, key=lambda r: [r[k] for k in sort_by])
    assert len(g) == len(w)
    for gr, wr in zip(g, w):
        for name in gn:
            a, b = gr[name], wr[name]
            if isinstance(b, float) and a is not None:
                assert a == pytest.approx(b, rel=F64_RTOL, abs=0), name
            else:
                assert a == b, name


def _nullable_batches():
    """Three batches of an int64 column with nulls, a float64 column and
    a string key with a value pool per batch (three words each, so the
    partial group tables share their shapes)."""
    rng = np.random.default_rng(21)
    out = []
    for words in (["x", "y", "z"], ["z", "w", "x"], ["y", "w", "x"]):
        n = 40
        out.append(pa.record_batch({
            "k": pa.array(rng.choice(words, n).tolist()),
            "v": pa.array(rng.integers(-1000, 1000, n), pa.int64(),
                          mask=rng.random(n) < 0.2),
            "f": pa.array(np.round(rng.uniform(-50, 50, n), 2))}))
    return out


NULLABLE = a1t.Table([a1t.record_batch(b) for b in _nullable_batches()])
SCALAR_AGGS = [(c, fn) for c in ("v", "f") for fn in
               ("sum", "count", "min", "max", "mean", "variance", "stddev")]
GROUP_AGGS = [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max"),
              ("v", "mean"), ("f", "sum")]
SORT_KEYS = [("s", "ascending"), ("k", "descending")]


def _sort_batch():
    """baseline_sort's input: a dictionary-string key and an int64 key,
    both with nulls, many ties."""
    rng = np.random.default_rng(23)
    n = 64
    return a1t.record_batch(pa.record_batch({
        "s": pa.array(rng.choice(["sym2", "sym0", "sym1"], n).tolist(),
                      mask=rng.random(n) < 0.1),
        "k": pa.array(rng.integers(-3, 3, n), pa.int64(),
                      mask=rng.random(n) < 0.15),
        "row": pa.array(np.arange(n), pa.int64())}))


SORTB = _sort_batch()


def _jax_scalar_aggs(table):
    agg = JAgg(SCALAR_AGGS)
    for b in table.batches:
        agg.consume(b)
    return agg.finalize()


def _jax_group_by(table):
    gb = JGroupBy(["k"], GROUP_AGGS)
    for b in table.batches:
        gb.consume(b)
    return gb.finalize()


def _q1_declaration(ac, source, field):
    return ac.Declaration.from_sequence([
        ac.Declaration("table_source", ac.TableSourceNodeOptions(source)),
        ac.Declaration("filter", ac.FilterNodeOptions(
            field("l_shipdate_days") <= 10000)),
        ac.Declaration("aggregate", ac.AggregateNodeOptions(
            [("l_quantity", "sum"), ("l_extendedprice", "sum"),
             ("l_quantity", "count")], keys=["l_returnflag"])),
        ac.Declaration("order_by", ac.OrderByNodeOptions(
            [("l_returnflag", "ascending")]))])


def _acero_misc(ac, left, right, field):
    """A project (with a literal), a scalar aggregate, a hash join and a
    union through one engine's acero."""
    src = ac.Declaration("table_source", ac.TableSourceNodeOptions(left))
    proj = ac.Declaration("project", ac.ProjectNodeOptions(
        [field("l_quantity") * 2, field("l_discount")],
        names=["q2", "disc"]), [src])
    scal = ac.Declaration("aggregate", ac.AggregateNodeOptions(
        [("l_quantity", "sum"), ("l_discount", "max")]), [src])
    join = ac.Declaration("hashjoin", ac.HashJoinNodeOptions(
        "inner", ["l_orderkey"], ["o_orderkey"]),
        [src, ac.Declaration("table_source",
                             ac.TableSourceNodeOptions(right))])
    union = ac.Declaration("union", None, [proj, proj])
    return {"project": proj.to_batch(), "scalar": scal.to_batch(),
            "join": join.to_batch(), "union": union.to_batch()}


def _customers():
    rng = np.random.default_rng(33)
    return a1t.record_batch(pa.record_batch({
        "c_custkey": pa.array(np.arange(30, dtype=np.int64)),
        "c_segment": pa.array(rng.choice(["AUTO", "HOUSE", "MACH"],
                                         30).tolist())}))


def _plan_run(lib, li, orders, probe_first):
    """filter -> project(with a literal) and a join whose probe batches
    arrive before (or after) the build side, each into a sink, plus an
    order_by over a union. ``lib`` is either engine's plan module."""
    p = lib.ExecPlan()
    src = lib.source_node(p, li.batches)
    flt = lib.filter_node(p, src, _field(lib)("l_shipdate_days") <= 10000)
    proj = lib.project_node(p, flt, [_field(lib)("l_quantity") + 1,
                                     _literal(lib)(7)], ["q1", "seven"])
    sinks = {"project": lib.sink_node(p, proj)}
    if probe_first:
        probe = lib.source_node(p, li.batches)
        build = lib.source_node(p, [orders])
    else:
        build = lib.source_node(p, [orders])
        probe = lib.source_node(p, li.batches)
    join = lib.join_node(p, probe, build, ["l_orderkey"], ["o_orderkey"])
    sinks["join"] = lib.sink_node(p, join)
    union = lib.union_node(p, [lib.source_node(p, li.batches[:1]),
                               lib.source_node(p, li.batches[1:])])
    sinks["order_by"] = lib.sink_node(p, lib.order_by_node(
        p, union, [("l_returnflag", "ascending"), ("l_orderkey",
                                                    "descending")]))
    p.run()
    return {k: s.result for k, s in sinks.items()}


def _field(lib):
    return a1t.field if lib is jplan else pt.field


def _literal(lib):
    return a1t.literal if lib is jplan else pt.literal


_JITTED_SCANS = {}
_JITTED_SCANS_LOCK = threading.Lock()


def _jitted_scan(fn, elems, reverse=False):
    key = (fn.__code__, tuple(c.cell_contents for c in fn.__closure__ or ()),
           reverse)
    with _JITTED_SCANS_LOCK:
        if key not in _JITTED_SCANS:
            _JITTED_SCANS[key] = jax.jit(
                lambda e: scan_blocked(fn, e, reverse=reverse))
        jitted = _JITTED_SCANS[key]
    return jitted(elems)


def _inputs():
    li = _lineitem_table()
    orders = a1t.record_batch(make_orders())
    return {"li": li, "orders": orders, "customers": _customers()}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


def reference_answers():
    """Every JAX answer the tests compare against, computed once (on its
    own copy of the seeded inputs)."""
    inputs = _inputs()
    li, orders, cust = inputs["li"], inputs["orders"], inputs["customers"]
    calls = {
        "q1": (jmodels.q1_pricing_summary, (li,)),
        "q3": (jmodels.q3_shipping_priority, (li, orders)),
        "q5": (jmodels.q5_local_supplier_volume, (li, orders, cust)),
        "q6": (jmodels.q6_forecast, (li,)),
        "scalar": (_jax_scalar_aggs, (NULLABLE,)),
        "group_by": (_jax_group_by, (NULLABLE,)),
        "concat": (a1t.concat_batches, (NULLABLE.batches,)),
        "acero_q1": (lambda: _q1_declaration(jacero, li.batches[0],
                                             a1t.field).to_table(), ()),
        "acero_misc": (_acero_misc, (jacero, li.batches[0], orders,
                                     a1t.field)),
        "plan": (_plan_run, (jplan, li, orders, True)),
        "sort": (jmodels.baseline_sort, (SORTB, SORT_KEYS)),
    }
    with pytest.MonkeyPatch.context() as mp, \
            ThreadPoolExecutor(len(calls)) as ex:
        for mod in (jhash, jjoin, jpadded):
            mp.setattr(mod, "scan_blocked", _jitted_scan)
        futs = {k: ex.submit(fn, *args) for k, (fn, args) in calls.items()}
        return {k: f.result() for k, f in futs.items()}


@pytest.fixture(scope="module")
def jax_results():
    return answers_of(__name__)


def test_table_and_concat_batches_unify_dictionaries(jax_results):
    table = _port(NULLABLE)
    assert isinstance(table, pt.Table) and table.num_rows == 120
    pools = {id(b["k"].dictionary) for b in table.batches}
    assert len(pools) == NBATCH   # one pool per batch, as ingested
    got = pt.concat_batches(table.batches)
    _assert_same_rows(got, jax_results["concat"])
    assert got.to_arrow().equals(table.combine_chunks().to_arrow())
    assert table.column("k").to_pylist() == got["k"].to_pylist()
    assert table.to_arrow().to_pylist() == got.to_arrow().to_pylist()
    assert pt.interop.table_from_arrow(table.to_arrow(), "cpu").to_arrow() \
        .equals(table.to_arrow())


def test_record_batch_select_set_drop_rename_slice():
    b = _port(NULLABLE.batches[0])
    v = b["v"]
    assert b.select(["v", "k"]).names == ("v", "k")
    assert b.set_column("v2", v).names == ("k", "v", "f", "v2")
    assert b.set_column("k", v)["k"] is v
    assert b.drop(["f"]).names == ("k", "v")
    assert b.rename({"v": "w"}).names == ("k", "w", "f")
    s = b.slice(5, 10)
    assert s.num_rows == 10
    assert s.to_arrow().equals(b.to_arrow().slice(5, 10))
    assert b.slice(38).num_rows == 2


def test_streaming_aggregator_matches_jax(jax_results):
    agg = StreamingAggregator(SCALAR_AGGS)
    for b in _port(NULLABLE).batches:
        agg.consume(b)
    got, want = agg.finalize(), jax_results["scalar"]
    assert list(got) == list(want)
    for name in want:
        g, w = got[name].as_py(), want[name].as_py()
        if isinstance(w, float):
            assert g == pytest.approx(w, rel=F64_RTOL, abs=0), name
        else:
            assert g == w, name


@pytest.mark.parametrize("values", [[2 ** 53, 1, 1], [2 ** 63 - 1, 1],
                                    [-5, None, 7]])
def test_streaming_integer_sum_is_exact_like_pyarrow(values):
    arr = pa.array(values, pa.int64())
    agg = StreamingAggregator([("v", "sum")])
    # one batch per value, so the total is a merge of partials
    for i in range(len(values)):
        agg.consume(pt.record_batch(pa.record_batch({"v": arr.slice(i, 1)}),
                                    device="cpu"))
    assert agg.finalize()["v_sum"].as_py() == pac.sum(arr).as_py()


def test_streaming_group_by_matches_jax(jax_results):
    gb = StreamingGroupBy(["k"], GROUP_AGGS)
    for b in _port(NULLABLE).batches:
        gb.consume(b)
    # group order is each engine's path's order: compare as sets
    _assert_same_rows(gb.finalize(), jax_results["group_by"], sort_by=["k"])
    assert pt.exec.run_streaming_aggregate(
        _port(NULLABLE).batches, ["k"], [("v", "count")]).num_rows == 4


@pytest.mark.parametrize("probe_first", [True, False],
                         ids=["probe_before_build", "build_first"])
def test_plan_nodes_match_jax(inputs, jax_results, probe_first):
    got = _plan_run(plan, _port(inputs["li"]), _port(inputs["orders"]),
                    probe_first)
    want = jax_results["plan"]
    for name in ("project", "join", "order_by"):
        assert len(got[name].batches) == len(want[name].batches), name
        for g, w in zip(got[name].batches, want[name].batches):
            _assert_same_rows(g, w)


def test_plan_errors():
    with pytest.raises(Invalid, match="plan has no sink"):
        plan.ExecPlan().run()
    p = plan.ExecPlan()
    b = _port(NULLABLE.batches[0])
    plan.sink_node(p, plan.join_node(p, plan.source_node(p, [b]),
                                     plan.source_node(p, []), ["k"]))
    with pytest.raises(Invalid, match="empty build side"):
        p.run()
    with pytest.raises(Invalid, match="unknown node factory"):
        plan.Declaration("scan", {}).to_table()


def test_plan_declaration_aggregate(inputs):
    """exec.plan's own Declaration: source -> filter -> aggregate."""
    li = _port(inputs["li"])
    decl = plan.Declaration("aggregate", {
        "keys": ["l_returnflag"],
        "aggregates": [("l_quantity", "sum"), ("l_quantity", "count")],
    }, [plan.Declaration("filter",
                         {"predicate": pt.field("l_shipdate_days") <= 10000},
                         [plan.Declaration("source",
                                           {"batches": li.batches})])])
    got = decl.to_table().combine_chunks()
    want = models.q1_pricing_summary(li)
    _assert_same_rows(got.select(["l_quantity_sum", "l_quantity_count",
                                  "l_returnflag"]),
                      want.select(["l_quantity_sum", "l_quantity_count",
                                   "l_returnflag"]),
                      sort_by=["l_returnflag"])


def test_acero_matches_jax_and_pyarrow(inputs, jax_results):
    li = _port(inputs["li"]).batches[0]
    got = _q1_declaration(acero, li, pt.field).to_table()
    assert isinstance(got, pt.Table)
    _assert_same_rows(got.combine_chunks(),
                      jax_results["acero_q1"].combine_chunks())
    arrow_li = pa.Table.from_batches([inputs["li"].batches[0].to_arrow()])
    want = pacero.Declaration.from_sequence([
        pacero.Declaration("table_source",
                           pacero.TableSourceNodeOptions(arrow_li)),
        pacero.Declaration("filter", pacero.FilterNodeOptions(
            pac.field("l_shipdate_days") <= 10000)),
        pacero.Declaration("aggregate", pacero.AggregateNodeOptions(
            [("l_quantity", "hash_sum", None, "l_quantity_sum"),
             ("l_extendedprice", "hash_sum", None, "l_extendedprice_sum"),
             ("l_quantity", "hash_count", None, "l_quantity_count")],
            keys=["l_returnflag"])),
        pacero.Declaration("order_by", pacero.OrderByNodeOptions(
            [("l_returnflag", "ascending")]))]).to_table()
    _assert_same_rows(got.combine_chunks(),
                      a1t.record_batch(want.select(list(got.names))))
    misc = _acero_misc(acero, li, _port(inputs["orders"]), pt.field)
    for name, w in jax_results["acero_misc"].items():
        _assert_same_rows(misc[name], w)


def test_acero_asof_join_matches_pyarrow():
    left = pa.table({"t": pa.array([1, 5, 10], pa.int64()),
                     "lv": pa.array([1, 2, 3], pa.int64())})
    right = pa.table({"t": pa.array([0, 4, 9], pa.int64()),
                      "rv": pa.array([10.0, 40.0, 90.0])})
    decl = acero.Declaration("asofjoin", acero.AsofJoinNodeOptions(
        left_on="t", right_on="t", tolerance=-2), [
        acero.Declaration("table_source", acero.TableSourceNodeOptions(
            pt.record_batch(left, device="cpu"))),
        acero.Declaration("table_source", acero.TableSourceNodeOptions(
            pt.record_batch(right, device="cpu")))])
    want = left.join_asof(right, on="t", by=[], tolerance=-2)
    assert decl.to_batch().to_arrow().to_pylist() == want.to_pylist()


@pytest.mark.parametrize("name", ["q1", "q3", "q5", "q6"])
def test_tpch_templates_match_jax(inputs, jax_results, name):
    li, orders = _port(inputs["li"]), _port(inputs["orders"])
    cust = _port(inputs["customers"])
    fn = {"q1": lambda: models.q1_pricing_summary(li),
          "q3": lambda: models.q3_shipping_priority(li, orders),
          "q5": lambda: models.q5_local_supplier_volume(li, orders, cust),
          "q6": lambda: models.q6_forecast(li)}[name]
    # q6 has no order_by: its group order is the path's, compared as a set
    _assert_same_rows(fn(), jax_results[name],
                      sort_by=["l_returnflag"] if name == "q6" else None)


def test_query_select_project_limit_and_sources(inputs):
    li = _port(inputs["li"])
    got = (pt.query(li).filter(pt.field("l_quantity") > 40)
           .select(["l_orderkey", "l_quantity"]).to_table())
    want = inputs["li"].to_arrow().filter(
        pac.field("l_quantity") > 40).select(["l_orderkey", "l_quantity"])
    assert got.to_arrow().to_pylist() == want.to_pylist()
    proj = (pt.query(li.batches[0]).project(
        [pt.field("l_quantity") * 2], ["q2"]).limit(5).to_batch())
    assert proj["q2"].to_pylist() == [
        2 * q for q in li.batches[0]["l_quantity"].to_pylist()[:5]]
    assert pt.query(li).count_rows() == inputs["li"].num_rows
    with pytest.raises(Invalid, match="unsupported query source"):
        pt.query(inputs["li"].to_arrow()).to_table()


def test_baseline_sort_nulls_and_dictionary_keys(jax_results):
    got = models.baseline_sort(_port(SORTB), SORT_KEYS)
    _assert_same_rows(got, jax_results["sort"])
    arrow = pa.Table.from_batches([SORTB.to_arrow()])
    idx = pac.sort_indices(arrow, sort_keys=SORT_KEYS)   # nulls at end
    assert got["row"].to_pylist() == arrow.take(idx)["row"].to_pylist()


def test_table_entry_point():
    t = pt.table({"a": np.arange(5, dtype=np.int64)}, device="cpu")
    assert isinstance(t, pt.Table) and len(t.batches) == 1
    assert t.num_rows == 5 and t.num_columns == 1
    assert t["a"].to_pylist() == list(range(5))
    with pytest.raises(Invalid):
        pt.Table([])
