"""Query templates: the BASELINE configs and TPC-H-style queries as
builders over the query layer (counterpart of arrow1_tpu/models), and Q1
and Q3 as distributed programs over a process group."""

from .baseline import (baseline_filter_project, baseline_group_by,  # noqa: F401
                       baseline_join, baseline_sort)
from .tpch import (q1_distributed, q1_pricing_summary,  # noqa: F401
                   q3_distributed, q3_shipping_priority,
                   q5_local_supplier_volume, q6_forecast)
