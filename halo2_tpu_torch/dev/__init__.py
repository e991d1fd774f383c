"""The MockProver on torch tensors.  ``failures`` and ``layout`` are the
reference's host modules; ``mock_prover`` is the port's."""

from .._refpath import reference_dir

__path__.append(reference_dir("dev"))

from .failures import (  # noqa: E402
    CellNotAssigned,
    ConstraintNotSatisfied,
    InRegion,
    Lookup,
    OutsideRegion,
    Permutation,
)
from .mock_prover import MockProver  # noqa: E402

__all__ = [
    "MockProver",
    "CellNotAssigned",
    "ConstraintNotSatisfied",
    "InRegion",
    "Lookup",
    "OutsideRegion",
    "Permutation",
]
