"""Function registry and the eager call API (counterpart of
arrow1_tpu/registry.py). Names follow pyarrow.compute so that both
engines are driven by the same call specs."""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

from .config import ExecContext, default_context
from .datum import Datum, as_datum
from .errors import KeyError_
from .profiler import _current as _current_profiler

__all__ = ["Function", "FunctionRegistry", "function_registry",
           "register_function", "call_function", "list_functions"]


@dataclasses.dataclass
class Function:
    """One compute function; ``exec(args, options, ctx)`` runs it."""

    name: str
    kind: str    # "scalar" | "vector"
    arity: int   # -1 = varargs
    exec: Callable
    options_class: Optional[type] = None


class FunctionRegistry:
    def __init__(self):
        self._functions: Dict[str, Function] = {}
        self._aliases: Dict[str, str] = {}

    def add(self, fn: Function, aliases: Sequence[str] = ()):
        if fn.name in self._functions:
            raise KeyError_(f"function {fn.name!r} already registered")
        self._functions[fn.name] = fn
        for a in aliases:
            self._aliases[a] = fn.name

    def get(self, name: str) -> Function:
        name = self._aliases.get(name, name)
        try:
            return self._functions[name]
        except KeyError:
            raise KeyError_(f"no function registered with name {name!r} "
                            "(not ported yet, or unknown)") from None

    def list_functions(self) -> List[str]:
        return sorted(self._functions)

    def __contains__(self, name: str) -> bool:
        return name in self._functions or name in self._aliases


function_registry = FunctionRegistry()


def register_function(name: str, kind: str, arity: int,
                      options_class: Optional[type] = None,
                      aliases: Sequence[str] = ()):
    """Decorator registering an exec function under a pyarrow name."""

    def deco(fn: Callable) -> Callable:
        function_registry.add(Function(name, kind, arity, fn, options_class),
                              aliases=aliases)
        return fn

    return deco


def call_function(name: str, args: Sequence[Any], options=None,
                  ctx: Optional[ExecContext] = None, **kwargs) -> Datum:
    """Eager entry point; keyword arguments fill the options class."""
    from . import ops  # noqa: F401  (registers the kernels)

    fn = function_registry.get(name)
    if fn.arity >= 0 and len(args) != fn.arity:
        raise ValueError(f"{name} expects {fn.arity} arguments, "
                         f"got {len(args)}")
    datums = [as_datum(a) for a in args]
    if kwargs:
        if fn.options_class is None:
            raise TypeError(f"{name} accepts no options, got {kwargs}")
        options = (dataclasses.replace(options, **kwargs)
                   if options is not None else fn.options_class(**kwargs))
    if options is None and fn.options_class is not None:
        options = fn.options_class()
    ctx = ctx or default_context()
    prof = _current_profiler()
    if prof is not None:
        return prof._measure(name, lambda: fn.exec(datums, options, ctx),
                             datums)
    return fn.exec(datums, options, ctx)


def list_functions() -> List[str]:
    from . import ops  # noqa: F401

    return function_registry.list_functions()
