"""Expression/value DSL (reference src/chips/util.rs, imported from zkevm-circuits).

``expr`` combinators build gate Expressions; ``value`` combinators compute the
same combinations on host field elements (witness side).
"""

from __future__ import annotations

from ..plonkish.expression import Constant, Expression


def pow_of_two(by: int) -> int:
    """2^by as a canonical constant — util.rs:203."""
    return 1 << by


class expr:
    """Expression combinators — util.rs:5-72."""

    @staticmethod
    def sum(inputs) -> Expression:
        acc: Expression = Constant(0)
        for e in inputs:
            acc = acc + e
        return acc

    @staticmethod
    def and_(inputs) -> Expression:
        acc: Expression = Constant(1)
        for e in inputs:
            acc = acc * e
        return acc

    @staticmethod
    def or_(inputs) -> Expression:
        return expr.not_(expr.and_([expr.not_(e) for e in inputs]))

    @staticmethod
    def not_(b) -> Expression:
        return Constant(1) - b

    @staticmethod
    def xor(a, b) -> Expression:
        return a + b - 2 * a * b

    @staticmethod
    def select(selector, when_true, when_false) -> Expression:
        return selector * when_true + expr.not_(selector) * when_false


class value:
    """Host-side counterparts — util.rs:74-132."""

    @staticmethod
    def sum(F, values):
        acc = F.zero()
        for v in values:
            acc = acc + v
        return acc

    @staticmethod
    def and_(F, values):
        acc = F.one()
        for v in values:
            acc = acc * v
        return acc

    @staticmethod
    def or_(F, values):
        return value.not_(F, value.and_(F, [value.not_(F, v) for v in values]))

    @staticmethod
    def not_(F, b):
        return F.one() - b

    @staticmethod
    def xor(F, a, b):
        return a + b - F.from_u64(2) * a * b

    @staticmethod
    def select(F, selector, when_true, when_false):
        return selector * when_true + value.not_(F, selector) * when_false


def bool_check(value_expr) -> Expression:
    """value * (1 - value)."""
    return value_expr * expr.not_(value_expr)


def expr_from_bytes(bytes_exprs) -> Expression:
    """Little-endian byte composition: sum(b_i * 2^(8i)) — util.rs:192-200."""
    acc: Expression = Constant(0)
    mult = 1
    for b in bytes_exprs:
        acc = acc + b * mult
        mult <<= 8
    return acc
