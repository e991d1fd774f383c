"""Regions, layouter and deferred floor-planning (halo2 `circuit::*` analogue).

Reproduces the placement semantics of halo2's ``SimpleFloorPlanner`` /
``SingleChipLayouter`` (per-column first-fit: a region starts at the max
current height of the columns it uses; constants are appended to the first
``enable_constant`` fixed column right after each region) — but in ONE pass:
synthesis records region-relative cells, and placement is resolved after
synthesis completes.  This avoids Rust's call-the-closure-twice contract while
producing the same absolute rows, which the reference's tests observe directly
(exact permutation-failure locations, src/circuits/add_carry_v1.rs:104-119).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from .column import Column, ColumnKind, Selector
from .cs import ConstraintSystem
from .value import Value


class SynthesisError(Exception):
    pass


class BoundsError(SynthesisError):
    """Out-of-range instance access (halo2 `Error::BoundsFailure`)."""


def _name(x) -> str:
    return x() if callable(x) else str(x)


@dataclasses.dataclass(frozen=True)
class Cell:
    """A cell reference: region-relative for advice/fixed, absolute for
    instance (region_index is None)."""

    region_index: Optional[int]
    column: Column
    offset: int


class AssignedCell:
    __slots__ = ("_cell", "_value", "_assignment")

    def __init__(self, cell: Cell, value: Value, assignment: "Assignment"):
        self._cell = cell
        self._value = value
        self._assignment = assignment

    def cell(self) -> Cell:
        return self._cell

    def value(self) -> Value:
        return self._value

    def copy_advice(self, annotation, region: "Region", column: Column, offset: int):
        """Assign this cell's value at (column, offset) in `region` and
        equality-constrain the two cells (halo2 `AssignedCell::copy_advice`)."""
        new = region.assign_advice(annotation, column, offset, self._value)
        self._assignment.copies.append((self._cell, new._cell))
        return new

    def __repr__(self):
        return f"AssignedCell({self._cell}, {self._value})"


@dataclasses.dataclass
class RegionData:
    index: int
    name: str
    columns: set  # Column | Selector
    rows: int = 0
    # (column, offset) -> Value  for advice+fixed assignments
    cells: dict = dataclasses.field(default_factory=dict)
    enabled_selectors: list = dataclasses.field(default_factory=list)
    constants: list = dataclasses.field(default_factory=list)  # (int value, Cell)


class Region:
    def __init__(self, assignment: "Assignment", data: RegionData):
        self._a = assignment
        self._d = data

    def _grow(self, column, offset: int):
        self._d.columns.add(column)
        self._d.rows = max(self._d.rows, offset + 1)

    def _store(self, column: Column, offset: int, value: Value):
        self._grow(column, offset)
        self._d.cells[(column, offset)] = value

    @staticmethod
    def _to_value(value) -> Value:
        if callable(value):
            value = value()
        return Value.wrap(value)

    # ------------------------------------------------------------------ API
    def assign_advice(self, annotation, column: Column, offset: int, value) -> AssignedCell:
        assert column.kind == ColumnKind.ADVICE, f"not an advice column: {column}"
        v = self._to_value(value)
        if not self._a.witness:
            v = Value.unknown()
        self._store(column, offset, v)
        return AssignedCell(Cell(self._d.index, column, offset), v, self._a)

    def assign_fixed(self, annotation, column: Column, offset: int, value) -> AssignedCell:
        assert column.kind == ColumnKind.FIXED, f"not a fixed column: {column}"
        v = self._to_value(value)
        # fixed values are part of the circuit shape: must be known even in keygen
        self._store(column, offset, v)
        return AssignedCell(Cell(self._d.index, column, offset), v, self._a)

    def assign_advice_from_constant(
        self, annotation, column: Column, offset: int, constant
    ) -> AssignedCell:
        if not self._a.cs.constants_columns:
            raise SynthesisError("no enable_constant fixed column available")
        cell = self.assign_advice(annotation, column, offset, Value.known(constant))
        self._d.constants.append((int(constant), cell._cell))
        return cell

    def assign_advice_from_instance(
        self, annotation, instance: Column, row: int, advice: Column, offset: int
    ) -> AssignedCell:
        assert instance.kind == ColumnKind.INSTANCE
        col_vals = self._a.instances[instance.index]
        if row >= self._a.n:
            # halo2 pads instance columns to n rows (shorter rows read as
            # zero Padding), so BoundsFailure only triggers past n — this is
            # what lets the hardcoded 1000-row copy in the reference's
            # less_than chip succeed against an 800-row instance
            # (src/chips/less_than.rs:71, src/circuits/less_than.rs:36)
            raise BoundsError(f"instance row {row} out of range (n={self._a.n})")
        if row < len(col_vals):
            padded = col_vals[row]
        else:
            padded = self._a.field.zero() if self._a.field is not None else 0
        v = Value.known(padded) if self._a.witness else Value.unknown()
        cell = self.assign_advice(annotation, advice, offset, v)
        self._a.copies.append((Cell(None, instance, row), cell._cell))
        return cell

    def enable_selector(self, selector: Selector, offset: int):
        self._grow(selector, offset)
        self._d.enabled_selectors.append((selector, offset))

    def constrain_equal(self, a: Cell, b: Cell):
        self._a.copies.append((a, b))

    def constrain_constant(self, cell: Cell, constant):
        self._d.constants.append((int(constant), cell))


class Layouter:
    """Namespace-tracking layouter over a shared Assignment."""

    def __init__(self, assignment: "Assignment", path: tuple = ()):
        self._a = assignment
        self._path = path

    def namespace(self, name) -> "Layouter":
        return Layouter(self._a, self._path + (_name(name),))

    def assign_region(self, name, closure):
        full = "/".join(self._path + (_name(name),))
        data = RegionData(index=len(self._a.regions), name=_name(name), columns=set())
        data.name = full if self._a.qualified_region_names else _name(name)
        self._a.regions.append(data)
        region = Region(self._a, data)
        return closure(region)

    def constrain_instance(self, cell: Cell, instance: Column, row: int):
        assert instance.kind == ColumnKind.INSTANCE
        self._a.copies.append((cell, Cell(None, instance, row)))

    def get_root(self) -> "Layouter":
        return self


class Assignment:
    """Collects everything synthesis produces; `finalize` resolves placement
    and materializes dense columns (host ints) ready for device encoding."""

    def __init__(
        self,
        cs: ConstraintSystem,
        k: int,
        instances: list,
        witness: bool = True,
        qualified_region_names: bool = False,
        field=None,
    ):
        self.cs = cs
        self.k = k
        self.n = 1 << k
        self.witness = witness
        self.qualified_region_names = qualified_region_names
        self.field = field  # host PrimeField class, for instance padding values
        # instance values kept as given (field elements or ints); finalize
        # normalizes via int()
        self.instances = [list(col) for col in instances]
        if len(self.instances) < cs.num_instance:
            self.instances += [[] for _ in range(cs.num_instance - len(self.instances))]
        self.regions: list[RegionData] = []
        self.copies: list[tuple[Cell, Cell]] = []
        self._finalized = None

    def layouter(self) -> Layouter:
        return Layouter(self)

    # ------------------------------------------------------------- placement
    def place(self):
        """First-fit region placement (k-independent).

        Returns (region_starts, constant_cells [(abs_row, value)],
        constant_copies [(Cell, Cell)]) — shared by finalize and the
        CircuitLayout renderer (which must draw circuits that overflow the
        requested k, as halo2's does)."""
        cs = self.cs
        col_heights: dict = {}
        region_starts: list[int] = []
        constants_col = cs.constants_columns[0] if cs.constants_columns else None
        constant_cells: list[tuple[int, int]] = []  # (abs_row, value)
        constant_copies: list[tuple[Cell, Cell]] = []

        for data in self.regions:
            start = max((col_heights.get(c, 0) for c in data.columns), default=0)
            region_starts.append(start)
            for c in data.columns:
                col_heights[c] = start + data.rows
            if data.constants:
                if constants_col is None:
                    raise SynthesisError("constants requested but no enable_constant column")
                row = col_heights.get(constants_col, 0)
                for value, target in data.constants:
                    constant_cells.append((row, value))
                    constant_copies.append(
                        (Cell(None, constants_col, row), target)
                    )
                    row += 1
                col_heights[constants_col] = row
        return region_starts, constant_cells, constant_copies

    def finalize(self) -> "Finalized":
        if self._finalized is not None:
            return self._finalized
        cs, n = self.cs, self.n
        constants_col = cs.constants_columns[0] if cs.constants_columns else None
        region_starts, constant_cells, constant_copies = self.place()

        usable = cs.usable_rows(n)

        def resolve(cell: Cell) -> tuple[ColumnKind, int, int]:
            if cell.region_index is None:
                return (cell.column.kind, cell.column.index, cell.offset)
            row = region_starts[cell.region_index] + cell.offset
            return (cell.column.kind, cell.column.index, row)

        # materialize dense columns as canonical host ints
        advice = [[0] * n for _ in range(cs.num_advice)]
        advice_assigned = [[False] * n for _ in range(cs.num_advice)]
        fixed = [[0] * n for _ in range(cs.num_fixed)]
        selectors = [[0] * n for _ in range(cs.num_selectors)]
        for data, start in zip(self.regions, region_starts):
            for (col, off), v in data.cells.items():
                row = start + off
                if row >= n:
                    raise SynthesisError(
                        f"row {row} out of range (n={n}); region {data.name!r}"
                    )
                val = v.value()
                if col.kind == ColumnKind.ADVICE:
                    if val is not None:
                        advice[col.index][row] = int(val)
                    advice_assigned[col.index][row] = True
                elif col.kind == ColumnKind.FIXED:
                    fixed[col.index][row] = int(val) if val is not None else 0
            for sel, off in data.enabled_selectors:
                selectors[sel.index][start + off] = 1
        if constants_col is not None:
            for row, value in constant_cells:
                fixed[constants_col.index][row] = value

        instance_cols = []
        for i in range(cs.num_instance):
            vals = self.instances[i] if i < len(self.instances) else []
            if len(vals) > usable:
                raise SynthesisError("instance column longer than usable rows")
            instance_cols.append([int(v) for v in vals] + [0] * (n - len(vals)))

        copies = [
            (resolve(a), resolve(b)) for a, b in self.copies + constant_copies
        ]

        self._finalized = Finalized(
            assignment=self,
            region_starts=region_starts,
            advice=advice,
            advice_assigned=advice_assigned,
            fixed=fixed,
            selectors=selectors,
            instance=instance_cols,
            instance_lens=[len(c) for c in self.instances],
            copies=copies,
            usable_rows=usable,
        )
        return self._finalized


@dataclasses.dataclass
class Finalized:
    assignment: Assignment
    region_starts: list[int]
    advice: list[list[int]]
    advice_assigned: list[list[bool]]
    fixed: list[list[int]]
    selectors: list[list[int]]
    instance: list[list[int]]
    instance_lens: list[int]
    # ((kind, col, row), (kind, col, row)) pairs
    copies: list
    usable_rows: int

    def locate(self, column: Column, row: int):
        """Map an absolute cell to (region_index, region_name, offset) or None."""
        a = self.assignment
        for data, start in zip(a.regions, self.region_starts):
            if column in data.columns and start <= row < start + data.rows:
                return (data.index, data.name, row - start)
        return None


def run_synthesis(
    circuit,
    k: int,
    instances: list,
    witness: bool = True,
    field=None,
) -> tuple[ConstraintSystem, object, Assignment]:
    """configure + synthesize a circuit, returning (cs, config, assignment)."""
    cs = ConstraintSystem()
    # circuits whose shape depends on runtime parameters (Rust const generics)
    # define an instance-level configure_with; others use the classmethod
    if hasattr(circuit, "configure_with"):
        config = circuit.configure_with(cs)
    else:
        config = type(circuit).configure(cs)
    assignment = Assignment(cs, k, instances, witness=witness, field=field)
    circuit.synthesize(config, assignment.layouter())
    return cs, config, assignment
