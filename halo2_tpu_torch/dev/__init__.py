"""The MockProver on torch tensors.  ``failures`` and ``layout`` are copies
of the reference's host modules; ``mock_prover`` is the port's."""

from .failures import (
    CellNotAssigned,
    ConstraintNotSatisfied,
    InRegion,
    Lookup,
    OutsideRegion,
    Permutation,
)
from .mock_prover import MockProver

__all__ = [
    "MockProver",
    "CellNotAssigned",
    "ConstraintNotSatisfied",
    "InRegion",
    "Lookup",
    "OutsideRegion",
    "Permutation",
]
