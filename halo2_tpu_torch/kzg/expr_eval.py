"""Host-side expression evaluation (shared by prover witness gen + verifier)."""

from __future__ import annotations

from ..field.params import BN254_FR
from ..plonkish.expression import (
    Constant,
    Expression,
    Negated,
    Product,
    Query,
    Scaled,
    SelectorExpr,
    Sum,
)

P = BN254_FR.p


def eval_expr(expr: Expression, getq) -> int:
    """getq(kind_value: str, index: int, rot: int) -> int."""
    if isinstance(expr, Constant):
        return int(expr.value) % P
    if isinstance(expr, Query):
        return getq(expr.column.kind.value, expr.column.index, expr.rotation.value) % P
    if isinstance(expr, SelectorExpr):
        return getq("selector", expr.selector.index, 0) % P
    if isinstance(expr, Sum):
        return (eval_expr(expr.a, getq) + eval_expr(expr.b, getq)) % P
    if isinstance(expr, Product):
        return eval_expr(expr.a, getq) * eval_expr(expr.b, getq) % P
    if isinstance(expr, Negated):
        return -eval_expr(expr.a, getq) % P
    if isinstance(expr, Scaled):
        return eval_expr(expr.a, getq) * (int(expr.scale) % P) % P
    raise TypeError(type(expr))


def eval_expr_rows(expr: Expression, columns: dict, n: int, rows: int, extra: dict = None):
    """Vectorized host evaluation of ``expr`` over rows [0, rows).

    numpy object arrays of Python ints: one elementwise array op per
    expression node instead of a per-row tree walk (the round-2 prover's
    per-row ``eval_expr`` loop was the lookup-permute hot spot).
    """
    import numpy as np

    cache: dict = {}

    def colarr(kind, idx):
        key = (kind, idx)
        if key not in cache:
            cache[key] = np.array(columns[kind][idx], dtype=object)
        return cache[key]

    def ev(e):
        if isinstance(e, Constant):
            return int(e.value) % P
        if isinstance(e, Query):
            if extra and (e.column.kind.value, e.column.index) in extra:
                return extra[(e.column.kind.value, e.column.index)] % P
            arr = colarr(e.column.kind.value, e.column.index)
            rot = e.rotation.value
            if rot:
                arr = np.roll(arr, -rot)
            return arr[:rows] % P
        if isinstance(e, SelectorExpr):
            return colarr("selector", e.selector.index)[:rows] % P
        if isinstance(e, Sum):
            return (ev(e.a) + ev(e.b)) % P
        if isinstance(e, Product):
            return ev(e.a) * ev(e.b) % P
        if isinstance(e, Negated):
            return (-ev(e.a)) % P
        if isinstance(e, Scaled):
            return ev(e.a) * (int(e.scale) % P) % P
        raise TypeError(type(e))

    out = ev(expr)
    if not isinstance(out, np.ndarray):
        out = np.full(rows, out, dtype=object)
    return out


def row_getter(columns: dict, n: int, row: int, extra: dict = None):
    """columns: kind -> list of per-column host value lists."""

    def getq(kind, idx, rot):
        if extra and (kind, idx) in extra:
            return extra[(kind, idx)]
        return columns[kind][idx][(row + rot) % n]

    return getq


def batch_invert(vals: list[int]) -> list[int]:
    """Montgomery batch inversion over host ints (zeros pass through as zero)."""
    prefix = []
    acc = 1
    for v in vals:
        prefix.append(acc)
        if v % P:
            acc = acc * v % P
    inv = pow(acc, -1, P)
    out = [0] * len(vals)
    for i in range(len(vals) - 1, -1, -1):
        v = vals[i]
        if v % P:
            out[i] = inv * prefix[i] % P
            inv = inv * v % P
    return out


def poly_eval(coeffs: list[int], x: int) -> int:
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc
