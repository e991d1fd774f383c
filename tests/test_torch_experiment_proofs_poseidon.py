"""merkle_v3's KZG proof (in-circuit Poseidon of width 3, k = 11, an
extended domain of 2^15) on the port against the reference's, as
tests/test_torch_experiment_proofs.py proves the other circuits: equal
bytes, both verifiers accept, both reject a tampered root, and the
committed fixture is the reference's proof."""

import test_torch_experiment_proofs as proofs
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)


def test_proof_matches_reference():
    proofs.check_proof("merkle_v3")


def test_fixture_is_the_reference_proof():
    proofs.check_fixture("merkle_v3")
