"""The BASELINE benchmark configs as executable templates (counterpart
of arrow1_tpu/models/baseline.py; BASELINE.md's workloads)."""

from __future__ import annotations

from typing import Sequence, Tuple

from ..expr import field
from ..registry import call_function

__all__ = ["baseline_filter_project", "baseline_group_by", "baseline_sort",
           "baseline_join"]


def baseline_filter_project(batch, predicate=None):
    """Config 1: predicate over an int64/float64 RecordBatch -> filtered
    rows."""
    pred = predicate if predicate is not None else (field("f") > 0.0)
    mask = pred.execute(batch)
    return call_function("filter", [batch, mask])


def baseline_group_by(batch, key: str = "k",
                      aggregates: Sequence[Tuple[str, str]] = ()):
    """Config 2: group_by(key) -> sum/count/min/max."""
    from ..ops.groupby import group_by

    aggs = list(aggregates) or [("v", "sum"), ("v", "count"),
                                ("v", "min"), ("v", "max")]
    return group_by(batch, [key], aggs)


def baseline_sort(batch, sort_keys=None):
    """Config 3: multi-column sort (int64 + dictionary-string keys):
    stable, nulls last."""
    from ..exec.plan import sort_batch

    return sort_batch(batch, sort_keys or [("k", "ascending"),
                                           ("s", "ascending")])


def baseline_join(probe, build, keys="k", join_type: str = "inner"):
    """Config 4: inner/left-outer equi-join."""
    from ..ops.join import join

    return join(probe, build, keys, join_type=join_type)
