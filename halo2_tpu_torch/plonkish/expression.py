"""Gate-expression DAG, the analogue of halo2's ``Expression<F>``.

Expressions are built inside ``create_gate`` / ``lookup_any`` closures via a
``VirtualCells`` handle (``meta.query_advice(col, Rotation::cur())`` etc. —
the exact call surface measured in SURVEY.md §1.A) and later compiled into
vectorized device programs by :mod:`halo2_tpu.plonkish.evaluator`.

Operator overloading accepts host field elements and small ints so circuit
code reads like the reference's Rust (``s * (2 * a - b)``).
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .column import Column, ColumnKind, Rotation, Selector


class Expression:
    def __add__(self, o):
        return Sum(self, _wrap(o))

    def __radd__(self, o):
        return Sum(_wrap(o), self)

    def __sub__(self, o):
        return Sum(self, Negated(_wrap(o)))

    def __rsub__(self, o):
        return Sum(_wrap(o), Negated(self))

    def __mul__(self, o):
        return Product(self, _wrap(o))

    def __rmul__(self, o):
        return Product(_wrap(o), self)

    def __neg__(self):
        return Negated(self)

    # -- analysis helpers ---------------------------------------------------
    def degree(self) -> int:
        raise NotImplementedError

    def queried_columns(self):
        """Yield (Column | Selector, Rotation) pairs used by this expression."""
        for child in self.children():
            yield from child.queried_columns()

    def children(self):
        return ()


def _wrap(o) -> Expression:
    if isinstance(o, Expression):
        return o
    if isinstance(o, int):
        return Constant(o)
    # host PrimeField
    if hasattr(o, "SPEC"):
        return Constant(int(o))
    raise TypeError(f"cannot use {type(o)} in an expression")


@dataclasses.dataclass(frozen=True)
class Constant(Expression):
    value: Any  # int (canonical) — field-agnostic until evaluation

    def degree(self):
        return 0

    def __repr__(self):
        return f"{int(self.value)}"


@dataclasses.dataclass(frozen=True)
class Query(Expression):
    column: Column
    rotation: Rotation

    def degree(self):
        return 1

    def queried_columns(self):
        yield (self.column, self.rotation)

    def __repr__(self):
        return f"{self.column}@{self.rotation.value}"


@dataclasses.dataclass(frozen=True)
class SelectorExpr(Expression):
    selector: Selector

    def degree(self):
        return 1

    def queried_columns(self):
        yield (self.selector, Rotation.cur())

    def __repr__(self):
        return repr(self.selector)


@dataclasses.dataclass(frozen=True)
class Sum(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return max(self.a.degree(), self.b.degree())

    def children(self):
        return (self.a, self.b)

    def __repr__(self):
        return f"({self.a} + {self.b})"


@dataclasses.dataclass(frozen=True)
class Product(Expression):
    a: Expression
    b: Expression

    def degree(self):
        return self.a.degree() + self.b.degree()

    def children(self):
        return (self.a, self.b)

    def __repr__(self):
        return f"({self.a} * {self.b})"


@dataclasses.dataclass(frozen=True)
class Negated(Expression):
    a: Expression

    def degree(self):
        return self.a.degree()

    def children(self):
        return (self.a,)

    def __repr__(self):
        return f"(-{self.a})"


@dataclasses.dataclass(frozen=True)
class Scaled(Expression):
    a: Expression
    scale: Any  # canonical int

    def degree(self):
        return self.a.degree()

    def children(self):
        return (self.a,)

    def __repr__(self):
        return f"({int(self.scale)} * {self.a})"


class VirtualCells:
    """The ``meta`` handle passed to gate/lookup closures."""

    def __init__(self, cs):
        self._cs = cs

    def query_advice(self, column: Column, at: Rotation = None) -> Expression:
        at = at or Rotation.cur()
        assert column.kind == ColumnKind.ADVICE
        self._cs._record_query(column, at)
        return Query(column, at)

    def query_fixed(self, column: Column, at: Rotation = None) -> Expression:
        at = at or Rotation.cur()
        assert column.kind == ColumnKind.FIXED
        self._cs._record_query(column, at)
        return Query(column, at)

    def query_instance(self, column: Column, at: Rotation = None) -> Expression:
        at = at or Rotation.cur()
        assert column.kind == ColumnKind.INSTANCE
        self._cs._record_query(column, at)
        return Query(column, at)

    def query_any(self, column: Column, at: Rotation = None) -> Expression:
        at = at or Rotation.cur()
        self._cs._record_query(column, at)
        return Query(column, at)

    def query_selector(self, selector: Selector) -> Expression:
        return SelectorExpr(selector)
