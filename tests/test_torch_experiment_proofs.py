"""The port's KZG proofs of the experiment circuits against the reference's,
byte for byte.

Each circuit's valid instance (the first vector of tests/experiment_vectors.py)
is built over BN254 Fr from each package's own classes and proved at the
smallest committed SRS at or above its MockProver k, with
``random.Random(PROOF_SEED)``: the reference's ``keygen``, ``create_proof``
and ``verify_proof``, and the port's on the CPU (``device="cpu"``: the
kernels' plain versions).  The proofs must be equal, the verdicts too, and
where the reference accepts its proof both reject a tampered instance.
Where the reference's verifier rejects its own proof, or its keygen raises,
the port must do the same (ROADMAP.md §3, "Reference caveats").  Every
reference result must also equal the committed one under
tests/data/experiments/, which chip_smoke.py holds the card's proofs
against (``python scripts/experiment_fixtures.py`` rewrites them).

merkle_v3 (its Poseidon rounds give the largest extended domain, 2^15) is
proved in tests/test_torch_experiment_proofs_poseidon.py, so that each file
stays a few minutes long.
"""

import functools

import pytest

import experiment_vectors as ev
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

REF, PORT = ev.side("halo2_tpu"), ev.side("halo2_tpu_torch")
# the reference's verifier rejects the reference's own proof of these,
# though the MockProver accepts the instance: ROADMAP.md §3, "Reference
# caveats", the entries add_carry_v1, inclusion_check and inclusion_check_v2
REJECTED = ("add_carry_v1", "inclusion_check", "inclusion_check_v2")
# the reference's keygen raises: ROADMAP.md §3, "Reference caveats",
# safe_accumulator
KEYGEN_RAISES = {"safe_accumulator": "IndexError"}
SLOW = ("merkle_v3",)
CIRCUITS = [name for name in ev.CIRCUITS if name not in SLOW]


@functools.lru_cache(maxsize=None)
def reference(name: str) -> dict:
    return ev.prove(REF, ev.proof_vector(REF, name))


def check_proof(name: str, **kw) -> None:
    want = reference(name)
    got = ev.prove(PORT, ev.proof_vector(PORT, name), device="cpu", **kw)
    assert got == want
    if name in KEYGEN_RAISES:
        assert got == {"keygen_error": KEYGEN_RAISES[name]}
    elif name in REJECTED:
        assert got["verifies"] is False
    else:
        assert got["verifies"] is True and got["tampered_verifies"] is False


def check_fixture(name: str) -> None:
    assert ev.load_results()["proofs"][name] == reference(name)


@pytest.mark.parametrize("name", CIRCUITS)
def test_proof_matches_reference(name):
    check_proof(name)


def test_proof_matches_reference_device_commit():
    """hash_v2's commitments on the port's device Pippenger (its plain
    versions here) give the same bytes."""
    check_proof("hash_v2", commit="device")


@pytest.mark.parametrize("name", CIRCUITS)
def test_fixture_is_the_reference_proof(name):
    check_fixture(name)


def test_fixture_holds_every_circuit():
    results = ev.load_results()["proofs"]
    assert list(results) == list(ev.CIRCUITS)
    for name, res in results.items():
        assert ("proof" in res) == (name not in KEYGEN_RAISES)
