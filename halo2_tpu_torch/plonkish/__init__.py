"""The reference's PLONKish frontend, re-exported; ``evaluator`` is the port's."""

from .._refpath import reference_dir

__path__.append(reference_dir("plonkish"))

from .column import Column, ColumnKind, Rotation, Selector  # noqa: E402
from .expression import Constant, Expression, Query, SelectorExpr, VirtualCells  # noqa: E402
from .value import Value  # noqa: E402
from .cs import ConstraintSystem, Gate, Lookup  # noqa: E402
from .assignment import (  # noqa: E402
    AssignedCell,
    Assignment,
    BoundsError,
    Cell,
    Layouter,
    Region,
    SynthesisError,
    run_synthesis,
)
from .circuit import Circuit  # noqa: E402

__all__ = [
    "Column",
    "ColumnKind",
    "Rotation",
    "Selector",
    "Constant",
    "Expression",
    "Query",
    "SelectorExpr",
    "VirtualCells",
    "Value",
    "ConstraintSystem",
    "Gate",
    "Lookup",
    "AssignedCell",
    "Assignment",
    "BoundsError",
    "Cell",
    "Layouter",
    "Region",
    "SynthesisError",
    "run_synthesis",
    "Circuit",
]
