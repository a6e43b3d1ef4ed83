"""Compute kernels; importing this package registers them."""

from . import arithmetic, boolean, compare, selection  # noqa: F401
