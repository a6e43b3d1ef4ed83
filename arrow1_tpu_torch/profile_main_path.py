"""Where the card's time goes on the port's main path. Run on a GPU:

    python -m arrow1_tpu_torch.profile_main_path [--rows N] [--seed S]

For the fused flagship (selectivity 0.5), the entry pipeline
(filter -> project -> group_by -> sort, materialized) at 1K and ~1M
groups, and the eager group_by at BASELINE config 2 (sum/mean/count/sum
on the dense-key path at G = 1000 and 100000, sum/count/min/max on the
sorted path at G = 2^20), it prints the host wall time of one run (median
of 5, each synchronised), the device time that torch.profiler's CUDA
trace records over 3 runs, the resulting idle share of the card, and the
kernels that take the most device time (kernel records only, so no time
is counted twice). Data is bench.py's recipe from ``--seed``; the
group_by's ``w`` column is int32 with 10% nulls.

It then profiles the joins: BASELINE config 4 (100M probe rows against
10M build rows, ``join_data``; inner and left outer, over uniform and
skewed probe keys) and TPC-H Q3 at SF1 cardinalities (``q3_data``:
filter, join on the order key, group by order priority, sort), eager and
through the compiled pipeline.

Last, the query layer: TPC-H Q1 and Q3 at SF10 cardinalities through
``query()`` (``models.tpch``) over a Table of 2^20-row batches
(``tpch_tables``), and BASELINE config 3, a 100M-row sort on a
dictionary string and an int64 key with nulls (``sort_data``,
``models.baseline_sort``).
"""

from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

import arrow1_tpu_torch as pt

# TPC-H SF1 cardinalities
Q3_LINEITEM = 6_001_215
Q3_ORDERS = 1_500_000
Q3_PRIORITIES = np.array(["1-URGENT", "2-HIGH", "3-NORMAL"], dtype=object)
Q3_AGGS = [("l_extendedprice", "sum"), ("l_orderkey", "count")]
Q3_SHIPDATE_MAX = 10_000   # Q3's filter: l_shipdate_days <= this
# TPC-H SF10 cardinalities
SF10_LINEITEM = 59_986_052
SF10_ORDERS = 15_000_000
SF10_CUSTOMERS = 1_500_000
# Acero's TableSourceNodeOptions::kDefaultMaxBatchSize: a Table's batches
BATCH_ROWS = 1 << 20
CONFIG3_ROWS = 100_000_000
SEGMENTS = np.array(["AUTO", "HOUSE", "MACH"], dtype=object)


def join_data(kind: str, npr: int = 100_000_000, nb: int = 10_000_000,
              scale: int = 1):
    """BASELINE config 4 (the recipe of benchmarks/r5/measure_r5.py,
    seed 42). Build: 8M singleton keys plus 1M keys held twice, shuffled,
    with a payload ``bw``. Probe: keys uniform over [0, 12M), so about a
    quarter match nothing, with a payload ``pv``; 'skew' sends 10% of the
    probes to one doubled key. Returns (pk, pv, bk, bw) as int64 arrays."""
    rng = np.random.default_rng(42)
    npr, nb = npr // scale, nb // scale
    single, uniq, dom = (8_000_000 // scale, 9_000_000 // scale,
                         12_000_000 // scale)
    bk = np.concatenate([np.arange(single, dtype=np.int64),
                         np.tile(np.arange(single, uniq, dtype=np.int64),
                                 2)])
    rng.shuffle(bk)
    bw = rng.integers(0, 1 << 20, nb).astype(np.int64)
    pk = rng.integers(0, dom, npr).astype(np.int64)
    if kind == "skew":
        hot = np.int64((single + uniq) // 2)   # a doubled key
        pk[rng.random(npr) < 0.10] = hot
    pv = rng.integers(0, 1 << 20, npr).astype(np.int64)
    return pk, pv, bk, bw


def q3_data(n_li: int = Q3_LINEITEM, n_orders: int = Q3_ORDERS,
            seed: int = 1):
    """TPC-H Q3's shape with the columns of the JAX package's TPC-H test
    (tests/test_tpch_pipeline.py make_lineitem / make_orders) at the
    given cardinalities: l_orderkey uniform over the order keys, prices
    with two decimals, o_orderpriority a dictionary string. Returns
    (lineitem, orders): dicts of name -> numpy array, with each string
    column as (codes int32, value pool)."""
    rng = np.random.default_rng(seed)
    li = {
        "l_orderkey": rng.integers(0, n_orders, n_li).astype(np.int64),
        "l_quantity": rng.integers(1, 51, n_li).astype(np.int64),
        "l_extendedprice": np.round(rng.uniform(1.0, 1000.0, n_li), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.1, n_li), 2),
        "l_returnflag": (rng.integers(0, 3, n_li).astype(np.int32),
                         np.array(["A", "N", "R"], dtype=object)),
        "l_shipdate_days": rng.integers(8000, 11000, n_li).astype(np.int64),
    }
    orders = {
        "o_orderkey": np.arange(n_orders, dtype=np.int64),
        "o_custkey": rng.integers(0, 150_000, n_orders).astype(np.int64),
        "o_orderpriority": (rng.integers(0, 3, n_orders).astype(np.int32),
                            Q3_PRIORITIES),
    }
    return li, orders


def tpch_tables(n_li: int = SF10_LINEITEM, n_orders: int = SF10_ORDERS,
                n_customers: int = SF10_CUSTOMERS):
    """lineitem, orders and customers with the columns and distributions
    of the JAX package's TPC-H tests (tests/test_tpch_pipeline.py
    make_lineitem / make_orders, tests/test_query.py's customers), at the
    given cardinalities, from seeds 1, 2 and 3: l_orderkey uniform over
    [0, n_orders), o_orderkey = arange(n_orders), o_custkey uniform over
    [0, n_customers), c_custkey = arange(n_customers). Each string column
    is (codes int32, value pool). Returns three dicts of name -> array."""
    rng = np.random.default_rng(1)
    li = {
        "l_orderkey": rng.integers(0, n_orders, n_li).astype(np.int64),
        "l_quantity": rng.integers(1, 51, n_li).astype(np.int64),
        "l_extendedprice": np.round(rng.uniform(1.0, 1000.0, n_li), 2),
        "l_discount": np.round(rng.uniform(0.0, 0.1, n_li), 2),
        "l_returnflag": (rng.integers(0, 3, n_li).astype(np.int32),
                         np.array(["A", "N", "R"], dtype=object)),
        "l_shipdate_days": rng.integers(8000, 11000, n_li).astype(np.int64),
    }
    rng = np.random.default_rng(2)
    orders = {
        "o_orderkey": np.arange(n_orders, dtype=np.int64),
        "o_custkey": rng.integers(0, n_customers, n_orders).astype(np.int64),
        "o_orderpriority": (rng.integers(0, 3, n_orders).astype(np.int32),
                            Q3_PRIORITIES),
    }
    rng = np.random.default_rng(3)
    customers = {
        "c_custkey": np.arange(n_customers, dtype=np.int64),
        "c_segment": (rng.integers(0, 3, n_customers).astype(np.int32),
                      SEGMENTS),
    }
    return li, orders, customers


def as_table(cols: dict, device, batch_rows: int = BATCH_ROWS) -> "pt.Table":
    """A tpch_tables table as a port Table of ``batch_rows``-row batches
    (views of one set of device columns; string columns share one pool)."""
    whole = q3_batch(cols, device)
    return pt.Table([whole.slice(i, batch_rows)
                     for i in range(0, max(whole.num_rows, 1), batch_rows)])


def sort_data(n: int = CONFIG3_ROWS, seed: int = 9):
    """BASELINE config 3 (the recipe of benchmarks/r3/measure_r3.py's
    sort measurement, seed 9): ``s`` a dictionary string over 1000 values
    sym0000-sym0999, ``k`` int64 in [-2^60, 2^60) with 1% nulls, ``pay``
    int64 and ``price`` float64. Returns {name: array}, with ``s`` as
    (codes, pool) and ``k`` as (data, validity)."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 1000, n).astype(np.int32)
    k = rng.integers(-(1 << 60), 1 << 60, n).astype(np.int64)
    valid = rng.random(n) >= 0.01
    pay = rng.integers(0, 1 << 30, n).astype(np.int64)
    price = rng.standard_normal(n)
    pool = np.asarray([f"sym{i:04d}" for i in range(1000)], object)
    return {"s": (codes, pool), "k": (k, valid), "pay": pay, "price": price}


def sort_batch(cols: dict, device) -> "pt.RecordBatch":
    """A sort_data table as a RecordBatch on ``device``."""
    codes, pool = cols["s"]
    k, valid = cols["k"]
    return pt.from_reference_arrays(
        ["s", "k", "pay", "price"],
        [(codes, None, pool), (k, valid, None), (cols["pay"], None, None),
         (cols["price"], None, None)], device)


CONFIG3_KEYS = [("s", "ascending"), ("k", "descending")]


def q3_batch(cols: dict, device) -> "pt.RecordBatch":
    """A q3_data table as a RecordBatch on ``device``."""
    arrays = [(v[0], None, v[1]) if isinstance(v, tuple) else (v, None, None)
              for v in cols.values()]
    return pt.from_reference_arrays(list(cols), arrays, device)


def q3_eager(li, orders):
    """Q3 through the eager entry points: filter, join, group_by,
    sort_indices, take."""
    import arrow1_tpu_torch.compute as pc

    mask = (pt.field("l_shipdate_days") <= Q3_SHIPDATE_MAX).execute(li)
    joined = pt.join(pt.filter(li, mask), orders, keys=["l_orderkey"],
                     right_keys=["o_orderkey"])
    agg = pt.group_by(joined, ["o_orderpriority"], Q3_AGGS)
    idx = pc.sort_indices(agg, sort_keys=[("l_extendedprice_sum",
                                           "descending")])
    return pc.take(agg, idx)


def q3_pipeline(orders):
    """Q3 through the compiled pipeline (fanout 1: every line item has
    exactly one order)."""
    return (pt.PipelineBuilder()
            .filter(pt.field("l_shipdate_days") <= Q3_SHIPDATE_MAX)
            .join(orders, keys=["l_orderkey"], right_keys=["o_orderkey"],
                  fanout=1)
            .group_by(["o_orderpriority"], Q3_AGGS)
            .sort([("l_extendedprice_sum", "descending")])
            .compile())


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _wall_ms(fn, runs=5) -> float:
    walls = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(walls)


def profile(label: str, fn, runs: int = 3, top: int = 12) -> None:
    fn()   # warm-up: kernel builds, allocator
    wall = _wall_ms(fn)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    # kernel records only: an operator's record repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and _device_us(e) > 0]
    if not events:
        print(f"== {label}: wall {wall:.3f} ms per run (median of 5); the "
              "profiler recorded no device time: busy and idle share not "
              "measured")
        return
    busy_ms = sum(_device_us(e) for e in events) / 1e3 / runs
    print(f"== {label}: wall {wall:.3f} ms per run (median of 5); "
          f"device busy {busy_ms:.3f} ms per run (torch.profiler); "
          f"idle share {max(0.0, 1 - busy_ms / wall):.1%}")
    for e in sorted(events, key=_device_us, reverse=True)[:top]:
        ms = _device_us(e) / 1e3 / runs
        print(f"   {ms:9.4f} ms {ms / busy_ms:6.1%} x{e.count // runs:<3d} "
              f"{e.key[:100]}")


def profile_joins(dev) -> None:
    """BASELINE config 4's four legs and TPC-H Q3 at SF1."""
    for kind in ("uniform", "skew"):
        pk, pv, bk, bw = join_data(kind)
        probe = pt.record_batch({"k": pk, "pv": pv}, device=dev)
        build = pt.record_batch({"k": bk, "bw": bw}, device=dev)
        del pk, pv, bk, bw
        for jt in ("inner", "left outer"):
            profile(f"join {probe.num_rows} x {build.num_rows}, {jt}, "
                    f"{kind}", lambda: pt.join(probe, build, ["k"],
                                               join_type=jt))
        del probe, build
    li, orders = q3_data()
    lb, ob = q3_batch(li, dev), q3_batch(orders, dev)
    profile("TPC-H Q3 at SF1, eager", lambda: q3_eager(lb, ob))
    pipe = q3_pipeline(ob)
    profile("TPC-H Q3 at SF1, compiled pipeline", lambda: pipe(lb))


def profile_query_layer(dev) -> None:
    """TPC-H Q1 and Q3 at SF10 through query(), and config 3's sort."""
    from arrow1_tpu_torch import models

    li, orders, _ = tpch_tables()
    lt, ob = as_table(li, dev), q3_batch(orders, dev)
    del li, orders
    profile(f"TPC-H Q1 at SF10, query(), {len(lt.batches)} batches",
            lambda: models.q1_pricing_summary(lt))
    profile(f"TPC-H Q3 at SF10, query(), {len(lt.batches)} batches",
            lambda: models.q3_shipping_priority(lt, ob))
    del lt, ob
    batch = sort_batch(sort_data(), dev)
    profile(f"BASELINE config 3: sort of {batch.num_rows} rows on "
            "(s, k desc)", lambda: models.baseline_sort(batch,
                                                        CONFIG3_KEYS))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_000_000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    dev = pt.resolve_device()
    print(f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}; "
          f"{args.rows} rows, seed {args.seed}")
    rng = np.random.default_rng(args.seed)
    n = args.rows
    key, v, f = (torch.from_numpy(a).to(dev) for a in (
        rng.integers(0, 1 << 20, n).astype(np.int64),
        rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
        rng.standard_normal(n)))
    profile("flagship filter+project, selectivity 0.5",
            lambda: pt.filter_project_flagship(key, v, f, 0.0, -(1 << 30)))
    for label, ngroups, max_groups in (("1K groups", 1000, 65536),
                                       ("~1M groups", 1 << 20, 1 << 20)):
        batch = pt.record_batch({
            "k": rng.integers(0, ngroups, n).astype(np.int64),
            "v": rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64),
            "f": rng.standard_normal(n)}, device=dev)
        pipe = (pt.PipelineBuilder()
                .filter(pt.field("f") > 0.0)
                .project([pt.field("v") * 2 + 1], ["proj"])
                .group_by(["k"], [("proj", "sum"), ("v", "count")],
                          max_groups=max_groups)
                .sort([("proj_sum", "descending")])
                .compile())
        profile(f"pipeline, {label}", lambda: pipe(batch))
    dense = [("v", "sum"), ("v", "mean"), ("w", "count"), ("w", "sum")]
    for label, ngroups, aggs in (
            ("dense-key path, G=1000", 1000, dense),
            ("dense-key path, G=100000", 100_000, dense),
            ("sorted path, G=2^20", 1 << 20,
             [("v", "sum"), ("v", "count"), ("v", "min"), ("v", "max")])):
        batch = pt.record_batch({
            "k": rng.integers(0, ngroups, n).astype(np.int64),
            "v": rng.integers(-(1 << 30), 1 << 30, n).astype(np.int64)},
            device=dev)
        w = pt.Column(torch.from_numpy(rng.integers(
            -(1 << 20), 1 << 20, n).astype(np.int32)).to(dev), pt.int32,
            validity=torch.from_numpy(rng.random(n) >= 0.1).to(dev))
        batch = pt.RecordBatch(batch.columns + (w,), batch.names + ("w",))
        profile(f"eager group_by, {label}",
                lambda: pt.group_by(batch, ["k"], aggs))
    del batch, w, key, v, f
    profile_joins(dev)
    profile_query_layer(dev)


if __name__ == "__main__":
    main()

