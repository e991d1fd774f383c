"""A copy of the reference's PLONKish frontend; ``evaluator`` is the port's."""

from .column import Column, ColumnKind, Rotation, Selector
from .expression import Constant, Expression, Query, SelectorExpr, VirtualCells
from .value import Value
from .cs import ConstraintSystem, Gate, Lookup
from .assignment import (
    AssignedCell,
    Assignment,
    BoundsError,
    Cell,
    Layouter,
    Region,
    SynthesisError,
    run_synthesis,
)
from .circuit import Circuit

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
