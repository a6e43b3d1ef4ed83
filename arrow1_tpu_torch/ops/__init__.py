"""Compute kernels; importing this package registers them."""

from . import (aggregate, arithmetic, bitwise, boolean, cast,  # noqa: F401
               compare, conditional, cumulative, dictionary, groupby, hash,
               join, math, nested, ree, selection, set_lookup, sort, strings,
               temporal, validity)
