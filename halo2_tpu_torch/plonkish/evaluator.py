"""Evaluate gate expressions as an instruction program over torch tensors
(port of halo2_tpu/plonkish/evaluator.py).

Expressions are CSE'd into a static SSA :class:`Program` (one instruction per
unique node, carried over unchanged from the reference).  The reference runs
it as a ``lax.scan`` VM inside one jitted program; here
:func:`.cuda_vm.compile_program` turns it into flat tables (registers
allocated by liveness) and :func:`.cuda_vm.vm_eval` runs them: on the card
the whole program is one kernel launch, on the CPU the kernel's plain
version.

Shared between the MockProver's gate and lookup checks
(``build_gate_checker``, ``build_expr_batch_eval`` over ``encode_columns``)
and the prover's quotient evaluation.
"""

from __future__ import annotations

import torch

from ..field.device import DeviceField
from .column import ColumnKind
from .cuda_vm import compile_program, vm_eval
from .expression import (
    Constant,
    Expression,
    Negated,
    Product,
    Query,
    Scaled,
    SelectorExpr,
    Sum,
)

# VM opcodes
_ADD, _MUL, _NEG = 0, 1, 2


class Program:
    """A compiled expression set: query table + constants + instructions."""

    def __init__(self, exprs, rot_scale: int = 1):
        self.rot_scale = rot_scale
        self.queries: list[tuple[str, int, int]] = []  # (kind, col_index, rotation)
        self._query_ids: dict = {}
        self.consts: list[int] = []
        self._const_ids: dict = {}
        # instructions hold symbolic refs; slots are resolved once the query
        # and constant tables stop growing (a ref's numeric slot depends on
        # the FINAL table sizes)
        self._sym_instrs: list[tuple[int, tuple, tuple]] = []
        self._node_ids: dict = {}
        self._out_refs = [self._visit(e) for e in exprs]
        self.instrs = [
            (op, self._slot(a), self._slot(b)) for op, a, b in self._sym_instrs
        ]

    def _query_slot(self, key) -> int:
        idx = self._query_ids.get(key)
        if idx is None:
            idx = len(self.queries)
            self._query_ids[key] = idx
            self.queries.append(key)
        return idx

    def _const_slot(self, v: int) -> int:
        idx = self._const_ids.get(v)
        if idx is None:
            idx = len(self.consts)
            self._const_ids[v] = idx
            self.consts.append(v)
        return idx

    def _emit(self, op: int, r1: tuple, r2: tuple) -> int:
        self._sym_instrs.append((op, r1, r2))
        return len(self._sym_instrs) - 1

    def _visit(self, e: Expression) -> tuple[str, int]:
        """Returns ('q'|'c'|'i', index)."""
        key = e
        hit = self._node_ids.get(key)
        if hit is not None:
            return hit
        if isinstance(e, Constant):
            out = ("c", self._const_slot(int(e.value)))
        elif isinstance(e, Query):
            out = ("q", self._query_slot((e.column.kind.value, e.column.index, e.rotation.value)))
        elif isinstance(e, SelectorExpr):
            out = ("q", self._query_slot(("selector", e.selector.index, 0)))
        elif isinstance(e, Sum):
            out = ("i", self._emit(_ADD, self._visit(e.a), self._visit(e.b)))
        elif isinstance(e, Product):
            out = ("i", self._emit(_MUL, self._visit(e.a), self._visit(e.b)))
        elif isinstance(e, Negated):
            r1 = self._visit(e.a)
            out = ("i", self._emit(_NEG, r1, r1))
        elif isinstance(e, Scaled):
            r1 = self._visit(e.a)
            r2 = ("c", self._const_slot(int(e.scale)))
            out = ("i", self._emit(_MUL, r1, r2))
        else:
            raise TypeError(f"unknown expression node {type(e)}")
        self._node_ids[key] = out
        return out

    def _slot(self, ref) -> int:
        tag, idx = ref
        if tag == "q":
            return idx
        if tag == "c":
            return len(self.queries) + idx
        return len(self.queries) + len(self.consts) + idx

    def output_slots(self) -> list[int]:
        return [self._slot(r) for r in self._out_refs]


def _run_program(prog: Program, df: DeviceField, columns: dict, rows=None) -> torch.Tensor:
    """Execute the program; returns (num_outputs, 16, n) Montgomery tensors,
    or (num_outputs, 16, count) over the rows ``rows = (row0, count)`` only
    (:func:`.cuda_vm.vm_eval`).

    ``columns[kind][ci]`` is a (16, n) tensor (a stacked (C, 16, n) tensor or
    a list of them; a (16, n) view of one element, as ``expand`` gives, is
    read as such).  A rotation by r rows reads row i + r * rot_scale,
    wrapping, as ``jnp.roll(arr, -r)`` does in the reference."""
    col = next((c for v in columns.values() for c in v), None)
    assert col is not None, "no columns to evaluate over"
    table = compile_program(prog, df.spec)
    queries = [columns[kind][ci] for kind, ci, _rot in prog.queries]
    return vm_eval(table, queries, table.consts_on(col.device), col.shape[-1], rows)


def encode_columns(df: DeviceField, finalized, device=None) -> dict:
    """Materialized host columns -> (C, 16, n) Montgomery tensors on
    ``device`` (the CPU when None), each kind uploaded in one copy."""
    n = finalized.assignment.n

    def enc(cols):
        if not cols:
            return torch.zeros((0, 16, n), dtype=torch.int32, device=device)
        flat = df.encode([v for col in cols for v in col], device=device)  # (16, C * n)
        return flat.reshape(16, len(cols), n).transpose(0, 1).contiguous()

    return {
        ColumnKind.ADVICE.value: enc(finalized.advice),
        ColumnKind.FIXED.value: enc(finalized.fixed),
        ColumnKind.INSTANCE.value: enc(finalized.instance),
        "selector": enc(finalized.selectors),
    }


# evaluators cached by (expression structure, field[, rot_scale]), as the
# reference caches its jitted programs: building a Program walks the whole
# expression DAG
_CHECKER_CACHE: dict = {}


def build_gate_checker(cs, df: DeviceField):
    """Returns (fn, meta): fn(columns) -> (C, n) bool nonzero mask, one row
    per gate constraint; meta[i] = (gate index, constraint index)."""
    meta = []
    exprs = []
    for gi, gate in enumerate(cs.gates):
        for ci, c in enumerate(gate.constraints):
            meta.append((gi, ci))
            exprs.append(c)

    key = ("gates", tuple(exprs), df.spec.name)
    cached = _CHECKER_CACHE.get(key)
    if cached is not None:
        return cached, meta

    prog = Program(exprs)

    def fn(columns):
        if not exprs:
            return torch.zeros((0, 1), dtype=torch.bool)
        outs = _run_program(prog, df, columns)
        return (outs != 0).any(dim=1)  # (C, n) nonzero mask

    _CHECKER_CACHE[key] = fn
    return fn, meta


def build_expr_batch_eval(cs, df: DeviceField, exprs, rot_scale: int = 1):
    """Evaluation of arbitrary expressions: fn(columns) -> (len(exprs), 16, n)."""
    key = ("batch", tuple(exprs), df.spec.name, rot_scale)
    cached = _CHECKER_CACHE.get(key)
    if cached is not None:
        return cached

    prog = Program(exprs, rot_scale=rot_scale)

    def fn(columns):
        return _run_program(prog, df, columns)

    _CHECKER_CACHE[key] = fn
    return fn
