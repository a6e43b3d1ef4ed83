"""Compute kernels; importing this package registers them."""

from . import (aggregate, arithmetic, boolean, compare, groupby,  # noqa: F401
               hash, join, selection, sort)
