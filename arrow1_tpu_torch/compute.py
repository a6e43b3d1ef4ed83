"""pyarrow.compute-shaped eager API over the port's registry (counterpart
of arrow1_tpu/compute.py).

One Python wrapper per registered function, as pyarrow/compute.py:190-231
generates them, so pyarrow.compute call sites translate one for one and
tests drive both engines with the same call specs:

    import arrow1_tpu_torch.compute as pc
    pc.sum(col)
    pc.hash_sum(values, group_ids)

Every registered options class is exported under its own name.
"""

from __future__ import annotations

import sys as _sys

from . import ops as _ops  # noqa: F401  (registers the kernels)
from .registry import call_function, function_registry, list_functions


def _make_wrapper(name: str):
    fn = function_registry.get(name)

    def wrapper(*args, options=None, **kwargs):
        return call_function(name, list(args), options=options, **kwargs)

    wrapper.__name__ = name
    wrapper.__qualname__ = name
    wrapper.__doc__ = fn.exec.__doc__ or f"Compute function {name!r}."
    return wrapper


_mod = _sys.modules[__name__]


def _install():
    for name in list_functions():
        attr = name + "_" if name in ("and", "or", "not") else name
        if not hasattr(_mod, attr):
            setattr(_mod, attr, _make_wrapper(name))
        oc = function_registry.get(name).options_class
        if oc is not None and not hasattr(_mod, oc.__name__):
            setattr(_mod, oc.__name__, oc)


_install()
