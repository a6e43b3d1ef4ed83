"""Expression trees: literal | field_ref | call (counterpart of
arrow1_tpu/expr.py). Executing an expression against a RecordBatch calls
the registered kernels eagerly, one torch op graph per call.
``fold_constants`` and ``simplify_with_guarantee`` (reference:
expression.cc FoldConstants and SimplifyWithGuarantee, :963) rewrite a
tree before it runs."""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence, Tuple

from . import dtypes as dt
from .datum import Datum, Scalar, scalar as make_scalar
from .errors import KeyError_
from .registry import call_function
from .table import RecordBatch

__all__ = ["Expression", "call", "field", "literal", "fold_constants",
           "simplify_with_guarantee"]


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

    def is_valid(self):
        return Call("is_valid", (self,))

    def is_null(self, nan_is_null: bool = False):
        from .ops.validity import NullOptions

        return Call("is_null", (self,),
                    options=NullOptions(nan_is_null=nan_is_null))

    def is_nan(self):
        return Call("is_nan", (self,))

    def isin(self, values):
        return Call("is_in", (self,), options={"value_set": list(values)})

    def cast(self, target: dt.DataType, safe: bool = True):
        from .ops.cast import CastOptions

        return Call("cast", (self,), options=CastOptions.safe(target)
                    if safe else CastOptions.unsafe(target))

    def equals(self, other) -> bool:
        """Structural equality (pyarrow Expression.equals)."""
        return isinstance(other, Expression) and repr(self) == repr(other)

    def execute(self, batch: RecordBatch) -> Datum:
        raise NotImplementedError

    def fields(self) -> set:
        """The names of the columns the expression reads."""
        raise NotImplementedError

    def bind(self, names: Sequence[str]) -> "Expression":
        """Check every field reference against the column ``names``."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True, eq=False)
class Literal(Expression):
    value: Scalar

    def execute(self, batch):
        return self.value

    def fields(self):
        return set()

    def bind(self, names):
        return self

    def __repr__(self):
        return repr(self.value.as_py())


@dataclasses.dataclass(frozen=True, eq=False)
class FieldRef(Expression):
    name: str

    def execute(self, batch):
        return batch.column(self.name)

    def fields(self):
        return {self.name}

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

    def fields(self):
        return set().union(*(a.fields() for a in self.args))

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


def fold_constants(expr: Expression) -> Expression:
    """Evaluate the calls whose arguments are all literals (reference:
    FoldConstants, expression.cc)."""
    if not isinstance(expr, Call):
        return expr
    args = tuple(fold_constants(a) for a in expr.args)
    expr = Call(expr.function, args, expr.options)
    if all(isinstance(a, Literal) for a in args):
        try:
            result = expr.execute(RecordBatch((), ()))
        except Exception:
            return expr
        if isinstance(result, Scalar):
            return Literal(result)
    return expr


def simplify_with_guarantee(expr: Expression, guarantee: Expression
                            ) -> Expression:
    """Simplify ``expr`` under a guarantee such as
    ``field("year") == 2021`` (reference: SimplifyWithGuarantee,
    expression.cc:963, the dataset's partition pruning): the
    field == literal facts of the guarantee's conjunction replace their
    fields, constants fold, and boolean identities collapse."""
    facts = {}

    def collect(g: Expression):
        if isinstance(g, Call):
            if g.function in ("and", "and_kleene"):
                for a in g.args:
                    collect(a)
            elif g.function == "equal":
                a, b = g.args
                if isinstance(a, FieldRef) and isinstance(b, Literal):
                    facts[a.name] = b
                elif isinstance(b, FieldRef) and isinstance(a, Literal):
                    facts[b.name] = a

    collect(guarantee)

    def substitute(e: Expression) -> Expression:
        if isinstance(e, FieldRef) and e.name in facts:
            return facts[e.name]
        if isinstance(e, Call):
            return Call(e.function, tuple(substitute(a) for a in e.args),
                        e.options)
        return e

    return _simplify_boolean(fold_constants(substitute(expr)))


def _simplify_boolean(expr: Expression) -> Expression:
    """Collapse ``x and true -> x``, ``x and false -> false``, and the
    same for ``or``."""
    if not isinstance(expr, Call):
        return expr
    args = tuple(_simplify_boolean(a) for a in expr.args)
    expr = Call(expr.function, args, expr.options)

    def lit_bool(e):
        if isinstance(e, Literal) and e.value.dtype.is_boolean and \
                e.value.is_valid:
            return bool(e.value.as_py())
        return None

    if expr.function in ("and", "and_kleene") and len(args) == 2:
        vals = [lit_bool(a) for a in args]
        if False in vals:
            return literal(False)
        if vals[0] is True:
            return args[1]
        if vals[1] is True:
            return args[0]
    if expr.function in ("or", "or_kleene") and len(args) == 2:
        vals = [lit_bool(a) for a in args]
        if True in vals:
            return literal(True)
        if vals[0] is False:
            return args[1]
        if vals[1] is False:
            return args[0]
    return expr
