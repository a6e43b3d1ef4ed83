"""Query templates: the BASELINE configs and TPC-H-style queries as
builders over the query layer (counterpart of arrow1_tpu/models).
``q1_distributed`` and ``q3_distributed`` wait for
``exec/dist_compiled.py`` (ROADMAP Queue 1 item 11)."""

from .baseline import (baseline_filter_project, baseline_group_by,  # noqa: F401
                       baseline_join, baseline_sort)
from .tpch import (q1_pricing_summary, q3_shipping_priority,  # noqa: F401
                   q5_local_supplier_volume, q6_forecast)
