"""The port's MockProver against the reference's: the same failures.

Each vector is a positive or negative case of the reference's own experiment
tests (named beside it), built twice, once from each package's classes.  The
reference's ``MockProver.run(...).verify()`` (jnp on the CPU) and the port's
(``device="cpu"``: the Montgomery kernel's plain version) must return the
same failures in the same order.  The failure dataclasses load once under
each package name, so they are different classes: the ``repr`` lists are
compared.  Between them the vectors give ``ConstraintNotSatisfied``,
``Lookup`` and ``Permutation`` failures.
"""

import importlib
import types

import numpy as np
import pytest

import halo2_tpu.dev as ref_dev
import halo2_tpu_torch.dev as port_dev
from halo2_tpu.field.device import get_device_field as ref_device_field
from halo2_tpu.plonkish.evaluator import build_gate_checker as ref_gate_checker
from halo2_tpu.plonkish.evaluator import encode_columns as ref_encode_columns
from halo2_tpu_torch.field.device import get_device_field as port_device_field
from halo2_tpu_torch.plonkish.evaluator import build_gate_checker, encode_columns
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def _side(pkg: str):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        dev=mod("dev"),
        field=mod("field"),
        plonkish=mod("plonkish"),
        poseidon=mod("poseidon"),
        mst=mod("circuits.merkle_sum_tree"),
        poseidon_circuit=mod("circuits.poseidon"),
        less_than=mod("circuits.less_than"),
        overflow=mod("circuits.overflow_check"),
    )


REF, PORT = _side("halo2_tpu"), _side("halo2_tpu_torch")


def _mst(s, k, case):
    """tests/test_kzg.py's instance (k = 9, the flagship circuit at depth 5)
    and tests/test_merkle_sum_tree.py's negative vectors (k = 10)."""
    m, Fr = s.mst, s.field.Fr
    leaf = m.Node(Fr.from_u64(10), Fr.from_u64(100))
    elements = [
        m.Node(Fr.from_u64(h), Fr.from_u64(b))
        for h, b in [(1, 10), (5, 50), (6, 60), (9, 90), (9, 90)]
    ]
    indices = [Fr.from_u64(0)] * 5
    root = m.compute_merkle_sum_root(Fr, leaf, elements, indices)
    assets_sum = Fr.from_u64(200 if case == "not_less_than" else 500)
    public = [leaf.hash, leaf.balance, root.hash, assets_sum]
    if case == "bad_root":  # test_invalid_root_hash
        public[2] = Fr.from_u64(1000)
    if case == "non_binary_index":  # test_non_binary_index
        indices = [Fr.from_u64(2)] + indices[1:]
    circuit = m.MerkleSumTreeCircuit(
        Fr, leaf.hash, leaf.balance, [n.hash for n in elements],
        [n.balance for n in elements], indices, assets_sum,
    )
    return k, circuit, [public], Fr


def _poseidon(s, tamper):
    """tests/test_poseidon.py: width 5, rate 4, L = 4 over Pasta Fp, k = 7."""
    Fp, Value = s.field.Fp, s.plonkish.Value
    spec = s.poseidon.MySpec(5, 4)
    message = [Fp.from_u64(99)] * 4
    digest = s.poseidon.poseidon_hash(Fp, spec, message)
    circuit = s.poseidon_circuit.PoseidonCircuit(
        Fp, spec, 4, [Value.known(x) for x in message], Value.known(digest)
    )
    return 7, circuit, [[digest + Fp.one() if tamper else digest]], Fp


def _less_than(s, n_public):
    """tests/test_less_than.py::test_less_than: 755 must be in the table of
    public inputs (a dynamic lookup over Pasta Fp, k = 10)."""
    Fp = s.field.Fp
    circuit = s.less_than.LessThanCircuit(Fp, s.plonkish.Value.known(Fp.from_u64(755)))
    return 10, circuit, [[Fp.from_u64(i) for i in range(n_public)]], Fp


def _overflow(s, overflow):
    """tests/test_overflow_check.py (BN254 Fr, k = 4)."""
    Fr = s.field.Fr
    if overflow:  # test_overflow_case
        a, public = (1 << 32) + 2, [0, (1 << 16) - 1, 1, 1, 1]
    else:  # test_none_overflow_case
        a, public = (1 << 16) + 3, [0, (1 << 16) - 2, 0, 2, 1]
    circuit = s.overflow.OverflowCheckCircuit(Fr, s.plonkish.Value.known(Fr.from_u64(a)))
    return 4, circuit, [[Fr.from_u64(v) for v in public]], Fr


VECTORS = {
    "merkle_sum_tree-k9-valid": lambda s: _mst(s, 9, "valid"),
    "merkle_sum_tree-k9-bad_root": lambda s: _mst(s, 9, "bad_root"),
    "merkle_sum_tree-k10-non_binary_index": lambda s: _mst(s, 10, "non_binary_index"),
    "merkle_sum_tree-k10-not_less_than": lambda s: _mst(s, 10, "not_less_than"),
    "poseidon-k7-valid": lambda s: _poseidon(s, False),
    "poseidon-k7-bad_digest": lambda s: _poseidon(s, True),
    "less_than-k10-valid": lambda s: _less_than(s, 800),
    "less_than-k10-not_in_table": lambda s: _less_than(s, 754),
    "overflow_check-k4-valid": lambda s: _overflow(s, False),
    "overflow_check-k4-overflow": lambda s: _overflow(s, True),
}
EXPECTED_KINDS = {
    "merkle_sum_tree-k9-bad_root": {"Permutation"},
    "merkle_sum_tree-k10-non_binary_index": {"ConstraintNotSatisfied", "Permutation"},
    "merkle_sum_tree-k10-not_less_than": {"ConstraintNotSatisfied"},
    "poseidon-k7-bad_digest": {"Permutation"},
    "less_than-k10-not_in_table": {"Lookup"},
    "overflow_check-k4-overflow": {"ConstraintNotSatisfied"},
}


def _run(side, vector, **kw):
    k, circuit, instances, F = VECTORS[vector](side)
    return side.dev.MockProver.run(k, circuit, instances, F=F, **kw)


@pytest.mark.parametrize("vector", list(VECTORS))
def test_failures_match_reference(vector):
    want = [repr(f) for f in _run(REF, vector).verify()]
    prover = _run(PORT, vector, device="cpu")
    failures = prover.verify()
    assert [repr(f) for f in failures] == want
    assert {type(f).__name__ for f in failures} == EXPECTED_KINDS.get(vector, set())
    assert all(type(f).__module__ == "halo2_tpu_torch.dev.failures" for f in failures)
    if failures:
        with pytest.raises(AssertionError, match="not satisfied"):
            prover.assert_satisfied()
    else:
        prover.assert_satisfied()


def test_vectors_cover_every_failure_kind():
    kinds = set().union(*EXPECTED_KINDS.values())
    assert {"ConstraintNotSatisfied", "Lookup", "Permutation"} <= kinds
    assert port_dev.ConstraintNotSatisfied is not ref_dev.ConstraintNotSatisfied


@pytest.mark.parametrize(
    "vector", ["merkle_sum_tree-k10-non_binary_index", "overflow_check-k4-overflow"]
)
def test_gate_checker_mask_matches_reference(vector):
    ref_prover, port_prover = _run(REF, vector), _run(PORT, vector, device="cpu")
    spec = ref_prover.F.SPEC
    ref_df = ref_device_field(spec)
    ref_fn, ref_meta = ref_gate_checker(ref_prover.cs, ref_df)
    want = np.asarray(ref_fn(ref_encode_columns(ref_df, ref_prover.finalized)))

    df = port_device_field(port_prover.F.SPEC)
    fn, meta = build_gate_checker(port_prover.cs, df)
    got = fn(encode_columns(df, port_prover.finalized)).numpy()
    assert meta == ref_meta
    assert got.dtype == np.bool_ and got.shape == want.shape
    assert np.array_equal(got, want)
    assert got.any()
    # the checker is cached per (constraints, field), as the reference's is
    assert build_gate_checker(port_prover.cs, df)[0] is fn
