"""Structured, locatable verification failures (halo2 `dev::VerifyFailure`).

The reference asserts on exact failure structures — two
``VerifyFailure::Permutation`` entries with column + region/offset at
src/circuits/add_carry_v1.rs:104-119 — so the taxonomy here mirrors halo2's:
``ConstraintNotSatisfied``, ``Permutation``, ``Lookup``, ``CellNotAssigned``
with ``FailureLocation::{InRegion, OutsideRegion}``.
"""

from __future__ import annotations

import dataclasses

from ..plonkish.column import Column


@dataclasses.dataclass(frozen=True)
class InRegion:
    region_index: int
    region_name: str
    offset: int

    def __repr__(self):
        return f"InRegion(region={self.region_index} ('{self.region_name}'), offset={self.offset})"


@dataclasses.dataclass(frozen=True)
class OutsideRegion:
    row: int

    def __repr__(self):
        return f"OutsideRegion(row={self.row})"


FailureLocation = InRegion | OutsideRegion


@dataclasses.dataclass(frozen=True)
class ConstraintNotSatisfied:
    gate_index: int
    gate_name: str
    constraint_index: int
    constraint_name: str
    location: FailureLocation

    def __repr__(self):
        return (
            f"ConstraintNotSatisfied(gate={self.gate_index} ('{self.gate_name}'), "
            f"constraint={self.constraint_index} ('{self.constraint_name}'), {self.location})"
        )


@dataclasses.dataclass(frozen=True)
class Permutation:
    # (column kind string, index within kind) — matches halo2's metadata::Column
    column: tuple
    location: FailureLocation

    @staticmethod
    def of(column: Column, location):
        return Permutation((column.kind.value, column.index), location)

    def __repr__(self):
        return f"Permutation(column=({self.column[0]}, {self.column[1]}), {self.location})"


@dataclasses.dataclass(frozen=True)
class Lookup:
    lookup_index: int
    name: str
    location: FailureLocation

    def __repr__(self):
        return f"Lookup({self.lookup_index} ('{self.name}'), {self.location})"


@dataclasses.dataclass(frozen=True)
class CellNotAssigned:
    gate_name: str
    region: tuple
    column: tuple
    offset: int


VerifyFailure = ConstraintNotSatisfied | Permutation | Lookup | CellNotAssigned
