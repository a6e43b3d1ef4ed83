"""TPC-H-style query templates over simplified schemas (counterpart of
arrow1_tpu/models/tpch.py).

Each builder takes port Tables or RecordBatches and returns the result
batch; the shapes follow the classic queries (filter -> [join] ->
aggregate -> sort), through ``query()``.
"""

from __future__ import annotations

from ..expr import field
from ..query import query

__all__ = ["q1_pricing_summary", "q3_shipping_priority",
           "q5_local_supplier_volume", "q6_forecast", "q1_distributed",
           "q3_distributed"]


def q1_pricing_summary(lineitem, ship_cutoff_days: int = 10000):
    """Q1: pricing summary report.

    select returnflag, sum(qty), sum(extendedprice), count(*)
    where shipdate <= cutoff group by returnflag order by returnflag
    """
    return (query(lineitem)
            .filter(field("l_shipdate_days") <= ship_cutoff_days)
            .group_by(["l_returnflag"],
                      [("l_quantity", "sum"), ("l_extendedprice", "sum"),
                       ("l_quantity", "count")])
            .order_by([("l_returnflag", "ascending")])
            .to_batch())


def q3_shipping_priority(lineitem, orders, top_n: int = 10):
    """Q3: shipping priority -- join lineitem x orders, revenue per
    priority, descending."""
    return (query(lineitem)
            .join(orders, keys=["l_orderkey"], right_keys=["o_orderkey"])
            .group_by(["o_orderpriority"],
                      [("l_extendedprice", "sum"), ("l_orderkey", "count")])
            .order_by([("l_extendedprice_sum", "descending")])
            .limit(top_n)
            .to_batch())


def q6_forecast(lineitem, min_discount: float = 0.02,
                max_discount: float = 0.09, max_quantity: int = 24):
    """Q6: forecasting revenue change -- pure filter + aggregate."""
    return (query(lineitem)
            .filter((field("l_discount") >= min_discount)
                    & (field("l_discount") <= max_discount)
                    & (field("l_quantity") < max_quantity))
            .group_by(["l_returnflag"], [("l_extendedprice", "sum")])
            .to_batch())


def q1_distributed(lineitem, mesh=None, ship_cutoff_days: int = 10000):
    """Q1 as one distributed program over the ranks (exec/dist_compiled.py:
    filter -> group_by -> sort with the shuffle inside); ``lineitem`` is
    the global batch, the same on every rank."""
    from ..exec.dist_compiled import DistPipelineBuilder

    return (DistPipelineBuilder(mesh)
            .filter(field("l_shipdate_days") <= ship_cutoff_days)
            .group_by(["l_returnflag"],
                      [("l_quantity", "sum"), ("l_extendedprice", "sum"),
                       ("l_quantity", "count")])
            .sort([("l_returnflag", "ascending")])
            .compile())(lineitem)


def q3_distributed(lineitem, orders, mesh=None, fanout: int = 2,
                   shuffle_cap=None, top_n: int = 10):
    """Q3 as one distributed program: the join (both sides shuffled), the
    group_by (a second shuffle), the sort and the limit."""
    from ..exec.dist_compiled import DistPipelineBuilder

    return (DistPipelineBuilder(mesh)
            .join(orders, keys=["l_orderkey"], right_keys=["o_orderkey"],
                  fanout=fanout, shuffle_cap=shuffle_cap)
            .group_by(["o_orderpriority"],
                      [("l_extendedprice", "sum"), ("l_orderkey", "count")])
            .sort([("l_extendedprice_sum", "descending")])
            .limit(top_n)
            .compile())(lineitem)


def q5_local_supplier_volume(lineitem, orders, customers, top_n: int = 10):
    """Q5-like: multi-join (lineitem x orders x customers) -> revenue per
    customer segment, descending."""
    step1 = (query(lineitem)
             .join(orders, keys=["l_orderkey"], right_keys=["o_orderkey"])
             .to_batch())
    return (query(step1)
            .join(customers, keys=["o_custkey"], right_keys=["c_custkey"])
            .group_by(["c_segment"], [("l_extendedprice", "sum")])
            .order_by([("l_extendedprice_sum", "descending")])
            .limit(top_n)
            .to_batch())
