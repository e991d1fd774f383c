"""ConstraintSystem — the circuit-shape builder (halo2 `plonk::ConstraintSystem`).

Covers the exact call surface the reference exercises (SURVEY.md §1.A):
advice/instance/fixed columns, simple + complex selectors, enable_equality,
enable_constant, create_gate, lookup_any, annotate_lookup_any_column, and the
blinding-factor accounting that fixes the number of usable rows.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .column import Column, ColumnKind, Rotation, Selector
from .expression import Expression, VirtualCells


@dataclasses.dataclass
class Gate:
    name: str
    constraints: list[Expression]
    constraint_names: list[str]


@dataclasses.dataclass
class Lookup:
    name: str
    # list of (input_expr, table_expr) pairs, checked as a tuple-multiset inclusion
    pairs: list[tuple[Expression, Expression]]


class ConstraintSystem:
    def __init__(self):
        self.num_advice = 0
        self.num_fixed = 0
        self.num_instance = 0
        self.num_selectors = 0
        self.gates: list[Gate] = []
        self.lookups: list[Lookup] = []
        self.permutation_columns: list[Column] = []  # equality-enabled, in order
        self.constants_columns: list[Column] = []    # enable_constant targets
        self.annotations: dict[Column, str] = {}
        # per-column rotation sets, for blinding-factor accounting
        self._advice_queries: dict[int, set[int]] = {}

    # ---------------------------------------------------------------- columns
    def advice_column(self) -> Column:
        c = Column(ColumnKind.ADVICE, self.num_advice)
        self.num_advice += 1
        return c

    def fixed_column(self) -> Column:
        c = Column(ColumnKind.FIXED, self.num_fixed)
        self.num_fixed += 1
        return c

    def instance_column(self) -> Column:
        c = Column(ColumnKind.INSTANCE, self.num_instance)
        self.num_instance += 1
        return c

    def selector(self) -> Selector:
        s = Selector(self.num_selectors, is_simple=True)
        self.num_selectors += 1
        return s

    def complex_selector(self) -> Selector:
        s = Selector(self.num_selectors, is_simple=False)
        self.num_selectors += 1
        return s

    # ------------------------------------------------------------- equality
    def enable_equality(self, column: Column):
        if column not in self.permutation_columns:
            self.permutation_columns.append(column)

    def enable_constant(self, column: Column):
        """Mark a fixed column usable for global constant assignment."""
        assert column.kind == ColumnKind.FIXED
        if column not in self.constants_columns:
            self.constants_columns.append(column)
        self.enable_equality(column)

    # ----------------------------------------------------------------- gates
    def create_gate(self, name: str, builder: Callable[[VirtualCells], object]):
        meta = VirtualCells(self)
        out = builder(meta)
        if isinstance(out, Expression):
            out = [out]
        constraints, names = [], []
        for i, c in enumerate(out):
            if isinstance(c, tuple):  # (name, expr)
                names.append(c[0])
                constraints.append(c[1])
            else:
                names.append(str(i))
                constraints.append(c)
        assert constraints, "gates must contain at least one constraint"
        self.gates.append(Gate(name, constraints, names))

    def lookup_any(
        self, name: str, builder: Callable[[VirtualCells], list[tuple[Expression, Expression]]]
    ):
        meta = VirtualCells(self)
        pairs = builder(meta)
        self.lookups.append(Lookup(name, list(pairs)))
        return len(self.lookups) - 1

    def annotate_lookup_any_column(self, column: Column, annotation: Callable[[], str]):
        self.annotations[column] = annotation() if callable(annotation) else str(annotation)

    # -------------------------------------------------------------- metadata
    def _record_query(self, column: Column, at: Rotation):
        if column.kind == ColumnKind.ADVICE:
            self._advice_queries.setdefault(column.index, set()).add(at.value)

    def degree(self) -> int:
        d = 3  # permutation argument contributes degree 3 at least
        for g in self.gates:
            for c in g.constraints:
                d = max(d, c.degree())
        for lk in self.lookups:
            inp_deg = max((i.degree() for i, _ in lk.pairs), default=1)
            tab_deg = max((t.degree() for _, t in lk.pairs), default=1)
            # input_expression * theta-combining stays deg(inp); product rule adds 2
            d = max(d, 2 + inp_deg, 2 + tab_deg)
        return d

    def blinding_factors(self) -> int:
        """halo2's formula: max(3, max #rotations queried on one advice column) + 2."""
        factors = max((len(r) for r in self._advice_queries.values()), default=1)
        return max(3, factors) + 2

    def usable_rows(self, n: int) -> int:
        return n - (self.blinding_factors() + 1)
