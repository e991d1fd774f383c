"""The port's MockProver on the experiment circuits of
tests/experiment_vectors.py, against the reference's: the same failures.

Each vector is a positive or negative case of the reference's own
experiment tests, at their k and field, built once from each package's
classes.  The reference's ``MockProver.run(...).verify()`` (jnp on the CPU)
and the port's (``device="cpu"``: the kernels' plain versions) must return
the same failure ``repr``s in the same order, of the kinds named here.
Every reference result must also equal the committed one in
tests/data/experiments/results.json, which chip_smoke.py holds the card's
runs against (``python scripts/experiment_fixtures.py`` rewrites it).
"""

import functools
import json
import os
import subprocess
import sys

import pytest

import experiment_vectors as ev
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

REF, PORT = ev.side("halo2_tpu"), ev.side("halo2_tpu_torch")
LABELS = [v.label for v in ev.mock_vectors(PORT)]
BOTH = {"ConstraintNotSatisfied", "Permutation"}
EXPECTED_KINDS = {
    "add_carry_v1-k4-low_limb_carry": {"Permutation"},
    "hash_v2-k4-bad_output": {"Permutation"},
    "inclusion_check-k4-wrong_index": {"Permutation"},
    "inclusion_check-k4-absent_entry": {"Permutation"},
    "inclusion_check_v2-k5-wrong_index": {"Permutation"},
    "inclusion_check_v2-k5-absent_entry": {"Permutation"},
    "less_than_v3-k9-l_above_r": BOTH,
    "less_than_v3-k9-check_false": BOTH,
    "merkle_v1-k10-bad_digest": {"Permutation"},
    "merkle_v2-k10-bad_digest": {"Permutation"},
    "merkle_v3-k10-zero_root": {"Permutation"},
    "safe_accumulator-k8-overflow": BOTH,
    "safe_accumulator-k8-over_range_value": BOTH,
}


@functools.lru_cache(maxsize=None)
def _reference(label: str) -> tuple:
    return tuple(ev.failures(REF, ev.mock_vector(REF, label)))


@pytest.mark.parametrize("label", LABELS)
def test_failures_match_reference(label):
    v = ev.mock_vector(PORT, label)
    prover = PORT.dev.MockProver.run(v.k, v.circuit, v.instances, F=v.F, device="cpu")
    failures = prover.verify()
    assert [repr(f) for f in failures] == list(_reference(label))
    assert {type(f).__name__ for f in failures} == EXPECTED_KINDS.get(label, set())
    assert all(type(f).__module__ == "halo2_tpu_torch.dev.failures" for f in failures)
    if failures:
        with pytest.raises(AssertionError, match="not satisfied"):
            prover.assert_satisfied()
    else:
        prover.assert_satisfied()


def test_add_carry_v1_exact_failures():
    """tests/test_add_carry_v1.py::test_carry_2's structured list, in the
    port's own failure classes."""
    from halo2_tpu_torch.dev import InRegion, OutsideRegion, Permutation

    v = ev.mock_vector(PORT, "add_carry_v1-k4-low_limb_carry")
    assert PORT.dev.MockProver.run(v.k, v.circuit, v.instances, F=v.F, device="cpu").verify() == [
        Permutation(
            column=("advice", 2),
            location=InRegion(region_index=2, region_name="adivce row for accumulating", offset=1),
        ),
        Permutation(column=("instance", 0), location=OutsideRegion(row=1)),
    ]


def test_vectors_are_the_reference_tests():
    """25 vectors over ten circuits, each circuit's first one satisfied."""
    assert len(LABELS) == 25 and len(ev.CIRCUITS) == 10
    for name in ev.CIRCUITS:
        first = next(label for label in LABELS if label.startswith(f"{name}-k"))
        assert first not in EXPECTED_KINDS


@pytest.mark.parametrize("label", LABELS)
def test_fixture_is_the_reference(label):
    assert ev.load_results()["mock"][label] == list(_reference(label))


def test_fixture_holds_every_vector():
    assert list(ev.load_results()["mock"]) == LABELS


_PROBE = r"""
import json, sys
sys.modules["jax"] = None
import chip_smoke
ev = chip_smoke._experiment_vectors()
port = ev.side("halo2_tpu_torch")
labels = [v.label for v in ev.mock_vectors(port)]
labels += [ev.proof_vector(port, n).label for n in ev.CIRCUITS]
ev.load_results()
loaded = [k for k, m in sys.modules.items() if k.split(".")[0] in ("jax", "halo2_tpu") and m]
print(json.dumps({"labels": labels, "loaded": loaded}))
"""


def test_chip_smoke_builds_the_vectors_without_jax():
    """chip_smoke.py loads this module by path and builds every vector from
    the port alone: neither JAX nor the reference package is imported."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=root, capture_output=True, text=True, timeout=300
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["loaded"] == []
    assert out["labels"][:25] == LABELS and len(out["labels"]) == 35
