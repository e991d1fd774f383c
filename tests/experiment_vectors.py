"""The reference's experiment test vectors, built from either package.

Not a test file.  Each build function takes a package namespace (:func:`side`) and
a field, and returns the vectors of one circuit as the reference's own
tests build them (named beside each), at their own ``k``:
``(label, k, F, circuit, instances)``.  The first vector of every circuit
is its valid instance, the one that the proofs prove.  No package is
imported at module level, so the CPU tests build both sides from here and
chip_smoke.py builds the port's alone, where JAX is not installed.

    s = side("halo2_tpu_torch")
    for v in mock_vectors(s):
        MockProver.run(v.k, v.circuit, v.instances, F=v.F)
"""

from __future__ import annotations

import contextlib
import importlib
import json
import os
import random
import types
from typing import NamedTuple


class Vector(NamedTuple):
    label: str
    k: int
    F: type
    circuit: object
    instances: list


def side(pkg: str):
    """``pkg``'s field, plonkish frontend, MockProver, KZG entry points and
    circuits as one namespace."""
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        pkg=pkg,
        field=mod("field"),
        plonkish=mod("plonkish"),
        dev=mod("dev"),
        kzg=mod("kzg"),
        circuit=lambda name: mod(f"circuits.{name}"),
    )


def _known(s, F, values):
    return [s.plonkish.Value.known(F.from_u64(v)) for v in values]


def add_carry_v1(s, F):
    """tests/test_add_carry_v1.py: test_carry_1, then test_carry_2's invalid
    and valid publics."""
    circuit = s.circuit("add_carry_v1").AddCarryCircuit
    carry_1 = circuit(F, _known(s, F, [(1 << 16) - 1, 1]))
    carry_2 = circuit(F, _known(s, F, [(1 << 16) - 1, 2]))
    return [
        ("valid", carry_1, [[F.from_u64(1), F.from_u64(0)]]),
        ("low_limb_carry", carry_2, [[F.from_u64(1), F.from_u64(0)]]),
        ("carry_valid", carry_2, [[F.from_u64(1), F.from_u64(1)]]),
    ]


def add_carry_v2(s, F):
    """tests/test_add_carry_v2.py::test_carry_2."""
    circuit = s.circuit("add_carry_v2").AddCarryV2Circuit(F, s.plonkish.Value.known(F.from_u64(1)))
    public = [F.from_u64(v) for v in (0, (1 << 16) - 2, 0, (1 << 16) - 1)]
    return [("valid", circuit, [public])]


def hash_v2(s, F):
    """tests/test_hash_v2.py::test_hash_2."""
    Value = s.plonkish.Value
    circuit = s.circuit("hash_v2").Hash2Circuit(
        F, Value.known(F.from_u64(2)), Value.known(F.from_u64(7))
    )
    return [("valid", circuit, [[F.from_u64(9)]]), ("bad_output", circuit, [[F.from_u64(8)]])]


def _inclusion(F, circuit):
    return [
        ("valid", circuit, [[F.from_u64(7), F.from_u64(14)]]),
        ("wrong_index", circuit, [[F.from_u64(8), F.from_u64(16)]]),
        ("absent_entry", circuit, [[F.from_u64(10), F.from_u64(20)]]),
    ]


def _table(s, F):
    Value = s.plonkish.Value
    usernames = [Value.known(F.from_u64(i)) for i in range(10)]
    balances = [Value.known(F.from_u64(i) * F.from_u64(2)) for i in range(10)]
    return usernames, balances


def inclusion_check(s, F):
    """tests/test_inclusion_check.py::test_inclusion_check_1."""
    usernames, balances = _table(s, F)
    circuit = s.circuit("inclusion_check").InclusionCheckCircuit(
        F, usernames, balances, inclusion_index=7
    )
    return _inclusion(F, circuit)


def inclusion_check_v2(s, F):
    """tests/test_inclusion_check.py::test_inclusion_check_2."""
    usernames, balances = _table(s, F)
    circuit = s.circuit("inclusion_check_v2").InclusionCheckV2Circuit(
        F, usernames, balances, inclusion_index=7, constant=F.from_u64(0)
    )
    return _inclusion(F, circuit)


def less_than_v3(s, F):
    """tests/test_less_than.py::test_less_than_3."""
    circuit = s.circuit("less_than_v3").LessThanV3Circuit
    public = [[F.from_u64(10)]]
    return [
        ("valid", circuit(F, value_l=5, value_r=10, check=True), public),
        ("l_above_r", circuit(F, value_l=10, value_r=5, check=True), public),
        ("check_false", circuit(F, value_l=10, value_r=5, check=False), public),
    ]


def _merkle_witness(s, F):
    leaf, elements, indices = 99, [1, 5, 6, 9, 9], [0, 0, 0, 0, 0]
    return leaf, elements, indices, s.plonkish.Value.known(F.from_u64(leaf))


def _merkle_sum(s, F, name, cls):
    """tests/test_merkle_v1_v2.py: the digest is the leaf plus the path."""
    leaf, elements, indices, leaf_value = _merkle_witness(s, F)
    circuit = getattr(s.circuit(name), cls)(
        F, leaf_value, _known(s, F, elements), _known(s, F, indices)
    )
    public = [F.from_u64(leaf), F.from_u64(leaf + sum(elements))]
    bad = [public[0], public[1] + F.one()]
    return [("valid", circuit, [public]), ("bad_digest", circuit, [bad])]


def merkle_v1(s, F):
    """tests/test_merkle_v1_v2.py::test_merkle_tree_1."""
    return _merkle_sum(s, F, "merkle_v1", "MerkleTreeV1Circuit")


def merkle_v2(s, F):
    """tests/test_merkle_v1_v2.py::test_merkle_tree_2."""
    return _merkle_sum(s, F, "merkle_v2", "MerkleTreeV2Circuit")


def merkle_v3(s, F):
    """tests/test_merkle_v3.py::test_merkle_tree_3: the root is the Poseidon
    (width 3) digest of the path, from the circuit module's host oracle."""
    m = s.circuit("merkle_v3")
    leaf, elements, indices, leaf_value = _merkle_witness(s, F)
    root = m.compute_merkle_root(F, leaf, elements, indices)
    circuit = m.MerkleTreeV3Circuit(F, leaf_value, _known(s, F, elements), _known(s, F, indices))
    return [
        ("valid", circuit, [[F.from_u64(leaf), root]]),
        ("zero_root", circuit, [[F.from_u64(leaf), F.from_u64(0)]]),
    ]


def safe_accumulator(s, F):
    """tests/test_safe_accumulator.py: its four tests in order."""
    def circuit(values, accumulated):
        return s.circuit("safe_accumulator").SafeAccumulatorCircuit(
            F, _known(s, F, values), _known(s, F, accumulated)
        )

    result = [F.from_u64(v) for v in (0, 0, (1 << 4) - 1, 1)]
    return [
        ("valid", circuit([4], [0, 0, 14, 13]), [result]),
        ("valid_two_values", circuit([1, 3], [0, 0, 14, 13]), [result]),
        ("overflow", circuit([4], [0, 15, 15, 13]), [[]]),
        ("over_range_value", circuit([16], [0, 0, 14, 15]), [[]]),
    ]


# circuit -> (build function, the reference test's k, its field, the proof's k: the
# smallest committed SRS at or above the test's k; .srs/ has no k = 10, so
# the merkle circuits prove at 11)
CIRCUITS = {
    "add_carry_v1": (add_carry_v1, 4, "Fr", 4),
    "add_carry_v2": (add_carry_v2, 4, "Fr", 4),
    "hash_v2": (hash_v2, 4, "Fp", 4),
    "inclusion_check": (inclusion_check, 4, "Fp", 4),
    "inclusion_check_v2": (inclusion_check_v2, 5, "Fp", 5),
    "less_than_v3": (less_than_v3, 9, "Fr", 9),
    "merkle_v1": (merkle_v1, 10, "Fp", 11),
    "merkle_v2": (merkle_v2, 10, "Fp", 11),
    "merkle_v3": (merkle_v3, 10, "Fp", 11),
    "safe_accumulator": (safe_accumulator, 8, "Fr", 8),
}


def mock_vectors(s, circuits=CIRCUITS) -> list:
    """Every vector of ``circuits``, over the reference test's field at its k."""
    out = []
    for name in circuits:
        build, k, field, _proof_k = CIRCUITS[name]
        F = getattr(s.field, field)
        out += [Vector(f"{name}-k{k}-{case}", k, F, c, inst) for case, c, inst in build(s, F)]
    return out


def mock_vector(s, label: str) -> Vector:
    return next(v for v in mock_vectors(s, [label.split("-k")[0]]) if v.label == label)


def proof_vector(s, name: str) -> Vector:
    """``name``'s valid instance over BN254 Fr at its proof's k."""
    build, _k, _field, k = CIRCUITS[name]
    _case, circuit, instances = build(s, s.field.Fr)[0]
    return Vector(f"{name}-k{k}", k, s.field.Fr, circuit, instances)


def failures(s, v: Vector, **kw) -> list:
    """The ``repr`` of every failure of ``s``'s MockProver on ``v``, in
    order (the two packages' failure classes differ, their reprs do not);
    ``kw`` goes to the port's ``MockProver.run`` (``device=``)."""
    prover = s.dev.MockProver.run(v.k, v.circuit, v.instances, F=v.F, **kw)
    return [repr(f) for f in prover.verify()]


def tampered(v: Vector) -> list:
    """``v``'s instances with the last public value plus one."""
    column = list(v.instances[0])
    column[-1] = column[-1] + v.F.one()
    return [column] + v.instances[1:]


# the seed of every proof's random.Random
PROOF_SEED = 3


def _untimed(_name):
    return contextlib.nullcontext()


def prove(s, v: Vector, step=_untimed, **kw) -> dict:
    """``s``'s keygen, create_proof (``random.Random(PROOF_SEED)``) and
    verify_proof on ``v``, and the verdict on :func:`tampered` instances
    where the proof verifies; a keygen that raises ``IndexError`` (the
    reference's on safe_accumulator) gives that type's name.  Each of the
    three runs inside ``step(name)`` (``"keygen"``, ``"prove"``,
    ``"verify"``), a context manager that may time it.  ``kw`` goes to the
    port's ``keygen`` and ``create_proof`` (``device=``, ``commit=``)."""
    params = s.kzg.ParamsKZG.setup_cached(v.k)
    try:
        with step("keygen"):
            pk = s.kzg.keygen(params, v.circuit, v.k, v.F, **kw)
    except IndexError as e:
        return {"keygen_error": type(e).__name__}
    with step("prove"):
        proof = s.kzg.create_proof(
            params, pk, v.circuit, v.instances, rng=random.Random(PROOF_SEED), **kw
        )
    with step("verify"):
        out = {"proof": proof, "verifies": s.kzg.verify_proof(params, pk.vk, proof, v.instances)}
        if out["verifies"]:
            out["tampered_verifies"] = s.kzg.verify_proof(params, pk.vk, proof, tampered(v))
    return out


# the reference's results, committed: each MockProver vector's failures and
# each circuit's proof (scripts/experiment_fixtures.py writes them)
DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "experiments")
RESULTS = os.path.join(DATA, "results.json")


def proof_path(name: str) -> str:
    return os.path.join(DATA, f"{name}-k{CIRCUITS[name][3]}.proof")


def load_results() -> dict:
    """``{"mock": {label: [repr, ...]}, "proofs": {circuit: result}}``, each
    proof result as :func:`prove` returns it, its bytes read back."""
    with open(RESULTS) as f:
        results = json.load(f)
    for name, res in results["proofs"].items():
        if "proof" in res:
            with open(proof_path(name), "rb") as f:
                res["proof"] = f.read()
    return results


def save_results(results: dict) -> None:
    os.makedirs(DATA, exist_ok=True)
    out = {"mock": results["mock"], "proofs": {}}
    for name, res in results["proofs"].items():
        res = dict(res)
        if "proof" in res:
            with open(proof_path(name), "wb") as f:
                f.write(res["proof"])
            res["proof"] = os.path.basename(proof_path(name))
        out["proofs"][name] = res
    with open(RESULTS, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
