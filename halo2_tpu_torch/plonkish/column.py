"""Columns, selectors and rotations of the PLONKish table.

Mirrors the column vocabulary of halo2_proofs consumed by the reference
(SURVEY.md §1.A): advice / instance / fixed columns, simple and complex
selectors, and ``Rotation::{prev,cur,next}``.
"""

from __future__ import annotations

import dataclasses
import enum


class ColumnKind(enum.Enum):
    ADVICE = "advice"
    FIXED = "fixed"
    INSTANCE = "instance"
    # prover-internal polynomials (identity, lagrange selectors, grand
    # products, permuted lookup columns, challenges) — never user-visible
    AUX = "aux"

    def __repr__(self):
        return self.value


@dataclasses.dataclass(frozen=True)
class Column:
    kind: ColumnKind
    index: int

    def __repr__(self):
        return f"{self.kind.value}[{self.index}]"


@dataclasses.dataclass(frozen=True)
class Selector:
    """A selector; ``is_simple`` selectors may only be 0/1-enabled and can be
    combined/compressed; complex selectors may appear in lookups
    (reference uses `complex_selector` at 4 call sites)."""

    index: int
    is_simple: bool = True

    def enable(self, region, offset: int):
        region.enable_selector(self, offset)

    def __repr__(self):
        return f"selector[{self.index}]"


@dataclasses.dataclass(frozen=True)
class Rotation:
    value: int

    @staticmethod
    def cur() -> "Rotation":
        return Rotation(0)

    @staticmethod
    def prev() -> "Rotation":
        return Rotation(-1)

    @staticmethod
    def next() -> "Rotation":
        return Rotation(1)
