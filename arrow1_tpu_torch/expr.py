"""Expression trees: literal | field_ref | call (counterpart of
arrow1_tpu/expr.py). Executing an expression against a RecordBatch calls
the registered kernels eagerly, one torch op graph per call."""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

from .datum import Datum, Scalar, scalar as make_scalar
from .errors import KeyError_
from .registry import call_function
from .table import RecordBatch

__all__ = ["Expression", "call", "field", "literal"]


class Expression:
    """Operator overloads build Call nodes with pyarrow.compute names."""

    def _bin(self, op, other, reverse=False):
        other = other if isinstance(other, Expression) else literal(other)
        return Call(op, (other, self) if reverse else (self, other))

    def __eq__(self, other):  # type: ignore[override]
        return self._bin("equal", other)

    def __ne__(self, other):  # type: ignore[override]
        return self._bin("not_equal", other)

    def __gt__(self, other):
        return self._bin("greater", other)

    def __ge__(self, other):
        return self._bin("greater_equal", other)

    def __lt__(self, other):
        return self._bin("less", other)

    def __le__(self, other):
        return self._bin("less_equal", other)

    def __add__(self, other):
        return self._bin("add", other)

    def __radd__(self, other):
        return self._bin("add", other, reverse=True)

    def __sub__(self, other):
        return self._bin("subtract", other)

    def __rsub__(self, other):
        return self._bin("subtract", other, reverse=True)

    def __mul__(self, other):
        return self._bin("multiply", other)

    def __rmul__(self, other):
        return self._bin("multiply", other, reverse=True)

    def __truediv__(self, other):
        return self._bin("divide", other)

    def __and__(self, other):
        return self._bin("and_kleene", other)

    def __or__(self, other):
        return self._bin("or_kleene", other)

    def __invert__(self):
        return Call("invert", (self,))

    def __neg__(self):
        return Call("negate", (self,))

    def __hash__(self):
        return hash(repr(self))

    def execute(self, batch: RecordBatch) -> Datum:
        raise NotImplementedError

    def bind(self, names: Sequence[str]) -> "Expression":
        """Check every field reference against the column ``names``."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class Literal(Expression):
    value: Scalar

    def execute(self, batch):
        return self.value

    def bind(self, names):
        return self

    def __repr__(self):
        return repr(self.value.as_py())


@dataclasses.dataclass(frozen=True, eq=False)
class FieldRef(Expression):
    name: str

    def execute(self, batch):
        return batch.column(self.name)

    def bind(self, names):
        if self.name not in names:
            raise KeyError_(f"no column named {self.name!r}")
        return self

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True, eq=False)
class Call(Expression):
    function: str
    args: Tuple[Expression, ...]
    options: Any = None

    def execute(self, batch):
        vals = [a.execute(batch) for a in self.args]
        if isinstance(self.options, dict):
            return call_function(self.function, vals, **self.options)
        return call_function(self.function, vals, options=self.options)

    def bind(self, names):
        return Call(self.function, tuple(a.bind(names) for a in self.args),
                    self.options)

    def __repr__(self):
        return f"{self.function}({', '.join(map(repr, self.args))})"


def field(name: str) -> FieldRef:
    return FieldRef(name)


def call(function: str, args, **options) -> Call:
    """Expression node invoking any registered compute function."""
    exprs = tuple(a if isinstance(a, Expression) else literal(a)
                  for a in args)
    return Call(function, exprs, options or None)


def literal(value) -> Literal:
    if isinstance(value, Literal):
        return value
    return Literal(make_scalar(value))
