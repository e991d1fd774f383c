"""MockProver — the constraint-satisfaction test oracle (port of
halo2_tpu/dev/mock_prover.py).

Runs synthesis on the host, then checks (a) every gate constraint on every
usable row as one instruction program over limb-vectorized columns on
``device``, (b) the permutation (copy) cycles on the host, (c) lookup
multiset inclusion, with the lookup expressions evaluated on ``device`` and
the membership test on the host.  ``verify()`` returns the reference's
structured failures (``dev/failures.py``), in the reference's order.

On a CUDA device every multiply of the gate and lookup programs is a launch
of the Montgomery kernel (``device=None`` means the CUDA device); on the CPU
(``device="cpu"``) the same calls run its plain version.  Each check brings its result back in one copy.

    prover = MockProver.run(k, circuit, [public_inputs], F=Fp, device="cuda")
    assert prover.verify() == []
    prover.assert_satisfied()             # raises with a report on failure
"""

from __future__ import annotations

from .._device import resolve_device
from ..field.device import get_device_field
from ..field.host import PrimeField
from ..plonkish.assignment import run_synthesis
from ..plonkish.column import Column, ColumnKind
from ..plonkish.evaluator import build_expr_batch_eval, build_gate_checker, encode_columns
from .failures import (
    ConstraintNotSatisfied,
    InRegion,
    Lookup,
    OutsideRegion,
    Permutation,
)


class MockProver:
    def __init__(self, cs, assignment, finalized, F, device=None):
        self.cs = cs
        self.assignment = assignment
        self.finalized = finalized
        self.F = F
        self.device = resolve_device(device)
        self._columns = None
        self._failures = None

    @classmethod
    def run(cls, k: int, circuit, instances: list, F: type[PrimeField], device=None):
        device = resolve_device(device)
        cs, _config, assignment = run_synthesis(
            circuit, k, instances, witness=True, field=F
        )
        finalized = assignment.finalize()
        return cls(cs, assignment, finalized, F, device)

    # ------------------------------------------------------------------ checks
    def verify(self) -> list:
        if self._failures is None:
            self._failures = (
                self._check_gates() + self._check_lookups() + self._check_permutation()
            )
        return self._failures

    def assert_satisfied(self):
        failures = self.verify()
        if failures:
            lines = "\n".join(f"  - {f!r}" for f in failures)
            raise AssertionError(f"circuit is not satisfied:\n{lines}")

    def _encoded_columns(self, df) -> dict:
        """The finalized columns on ``device``, encoded once for both checks."""
        if self._columns is None:
            self._columns = encode_columns(df, self.finalized, self.device)
        return self._columns

    # -- gates ---------------------------------------------------------------
    def _check_gates(self):
        df = get_device_field(self.F.SPEC)
        fin = self.finalized
        checker, meta = build_gate_checker(self.cs, df)
        mask = checker(self._encoded_columns(df)).cpu().numpy()  # (C, n) bool
        failures = []
        usable = fin.usable_rows
        for (gi, ci), row_mask in zip(meta, mask):
            gate = self.cs.gates[gi]
            cols = [c for c, _ in gate.constraints[ci].queried_columns() if isinstance(c, Column)]
            for row in row_mask[:usable].nonzero()[0]:
                failures.append(
                    ConstraintNotSatisfied(
                        gi,
                        gate.name,
                        ci,
                        gate.constraint_names[ci],
                        self._locate(cols, int(row)),
                    )
                )
        return failures

    def _locate(self, columns, row: int):
        for col in columns:
            loc = self.finalized.locate(col, row)
            if loc is not None:
                return InRegion(*loc)
        return OutsideRegion(row)

    # -- permutation (host code, as in the reference) --------------------------
    def _check_permutation(self):
        fin = self.finalized
        cols = self.cs.permutation_columns
        usable = fin.usable_rows

        # build cycle next-pointers exactly like halo2 permutation keygen
        mapping = {}
        aux = {}
        sizes = {}

        def find(x):
            root = x
            while aux.get(root, root) != root:
                root = aux[root]
            while aux.get(x, x) != x:
                aux[x], x = root, aux[x]
            return root

        for (ka, ca, ra), (kb, cb, rb) in fin.copies:
            a = (ka, ca, ra)
            b = (kb, cb, rb)
            la, lb = find(a), find(b)
            if la == lb:
                continue
            if sizes.get(la, 1) < sizes.get(lb, 1):
                la, lb = lb, la
            sizes[la] = sizes.get(la, 1) + sizes.get(lb, 1)
            aux[lb] = la
            # splice cycles: swap next pointers of the two representatives
            mapping.setdefault(a, a)
            mapping.setdefault(b, b)
            mapping[a], mapping[b] = mapping[b], mapping[a]

        def value(kind, col, row):
            if kind == ColumnKind.ADVICE:
                return fin.advice[col][row]
            if kind == ColumnKind.FIXED:
                return fin.fixed[col][row]
            return fin.instance[col][row]

        failures = []
        for col in cols:
            for row in range(usable):
                cell = (col.kind, col.index, row)
                nxt = mapping.get(cell)
                if nxt is None or nxt == cell:
                    continue
                if value(*cell) != value(*nxt):
                    failures.append(
                        Permutation(
                            (col.kind.value, col.index),
                            self._locate([col], row)
                            if col.kind != ColumnKind.INSTANCE
                            else OutsideRegion(row),
                        )
                    )
        return failures

    # -- lookups -------------------------------------------------------------
    def _check_lookups(self):
        if not self.cs.lookups:
            return []
        df = get_device_field(self.F.SPEC)
        fin = self.finalized
        columns = self._encoded_columns(df)
        usable = fin.usable_rows
        failures = []
        for li, lk in enumerate(self.cs.lookups):
            exprs = [e for pair in lk.pairs for e in pair]
            ev = build_expr_batch_eval(self.cs, df, exprs)
            # (2 * pairs, 16, n) Montgomery limbs, compared raw
            vals = ev(columns)[:, :, :usable].cpu().numpy()
            inputs = vals[0::2]  # (pairs, 16, usable)
            tables = vals[1::2]
            # pack rows into byte tuples for set membership
            inp_rows = inputs.transpose(2, 0, 1).reshape(usable, -1)
            tab_rows = tables.transpose(2, 0, 1).reshape(usable, -1)
            table_set = {r.tobytes() for r in tab_rows}
            for row in range(usable):
                if inp_rows[row].tobytes() not in table_set:
                    in_cols = [
                        c
                        for pair in lk.pairs
                        for c, _ in pair[0].queried_columns()
                        if isinstance(c, Column)
                    ]
                    failures.append(Lookup(li, lk.name, self._locate(in_cols, row)))
        return failures
