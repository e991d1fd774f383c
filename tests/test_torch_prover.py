"""The port's create_proof against the reference's, byte for byte.

Each circuit is built twice, once from each package's own classes.  The
reference makes the proving key and proves on its default engine; the port
loads the saved key (``ProvingKey.load``, the reference's pickle format) and
proves on the CPU, where every kernel runs its plain version, with its
commitments on the native host MSM or (``commit="device"``) the port's
device Pippenger.  Under the same
``random.Random`` seed the proofs must be equal; both verifiers must accept
the port's proof, and the port's must reject a tampered public input.

The flagship fixture tests/data/mst_d15_k11_rng7.proof (the reference's
proof of the depth-15, k = 11 merkle-sum-tree, which chip_smoke.py holds the
port's card proof against) is regenerated here with the reference.
"""

import os
import random

import numpy as np
import pytest

import halo2_tpu.circuits.hash_v1 as ref_hash_v1
import halo2_tpu.circuits.merkle_sum_tree as ref_mst
import halo2_tpu.field as ref_field
import halo2_tpu.kzg as ref_kzg
import halo2_tpu.plonkish as ref_plonkish
import halo2_tpu_torch.circuits.hash_v1 as port_hash_v1
import halo2_tpu_torch.circuits.merkle_sum_tree as port_mst
import halo2_tpu_torch.field as port_field
import halo2_tpu_torch.kzg as port_kzg
import halo2_tpu_torch.plonkish as port_plonkish
from halo2_tpu.kzg.keygen import ProvingKey as RefProvingKey
from halo2_tpu_torch.kzg.keygen import ProvingKey as PortProvingKey
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "mst_d15_k11_rng7.proof")


def _hash_v1(side):
    mod, field, plonkish = side
    Fr = field.Fr
    circuit = mod["hash_v1"].Hash1Circuit(Fr, plonkish.Value.known(Fr.from_u64(2)))
    return circuit, [Fr.from_u64(4)]


def _mst_k9(side):
    """The reference's test_full_prover instance (tests/test_kzg.py)."""
    mod, field, _plonkish = side
    m, Fr = mod["mst"], field.Fr
    leaf = m.Node(Fr.from_u64(10), Fr.from_u64(100))
    elements = [
        m.Node(Fr.from_u64(h), Fr.from_u64(b))
        for h, b in [(1, 10), (5, 50), (6, 60), (9, 90), (9, 90)]
    ]
    indices = [Fr.from_u64(0)] * 5
    root = m.compute_merkle_sum_root(Fr, leaf, elements, indices)
    assets_sum = Fr.from_u64(500)
    circuit = m.MerkleSumTreeCircuit(
        Fr, leaf.hash, leaf.balance, [n.hash for n in elements],
        [n.balance for n in elements], indices, assets_sum,
    )
    return circuit, [leaf.hash, leaf.balance, root.hash, assets_sum]


def _mst_flagship(side):
    """The north-star instance, built as scripts/north_star.py builds it."""
    mod, field, _plonkish = side
    m, Fr = mod["mst"], field.Fr
    depth = 15
    rng = random.Random(0xA11CE)
    leaf = m.Node(Fr.from_u64(10), Fr.from_u64(100))
    elements = [
        m.Node(Fr.from_u64(rng.randrange(1 << 32)), Fr.from_u64(rng.randrange(1 << 20)))
        for _ in range(depth)
    ]
    indices = [Fr.from_u64(rng.randrange(2)) for _ in range(depth)]
    root = m.compute_merkle_sum_root(Fr, leaf, elements, indices)
    assets_sum = root.balance + Fr.from_u64(1)
    circuit = m.MerkleSumTreeCircuit(
        Fr, leaf.hash, leaf.balance, [n.hash for n in elements],
        [n.balance for n in elements], indices, assets_sum,
    )
    return circuit, [leaf.hash, leaf.balance, root.hash, assets_sum]


REF = ({"hash_v1": ref_hash_v1, "mst": ref_mst}, ref_field, ref_plonkish)
PORT = ({"hash_v1": port_hash_v1, "mst": port_mst}, port_field, port_plonkish)


@pytest.mark.parametrize(
    "build, k, seed, tamper, commit",
    [(_hash_v1, 4, 9, 0, "native"), (_mst_k9, 9, 7, 2, "native"), (_hash_v1, 4, 9, 0, "device")],
    ids=["hash_v1-k4", "merkle_sum_tree-k9", "hash_v1-k4-device-commit"],
)
def test_proof_bytes_match_reference(tmp_path, build, k, seed, tamper, commit):
    ref_circuit, ref_public = build(REF)
    ref_params = ref_kzg.ParamsKZG.setup_cached(k)
    ref_pk = ref_kzg.keygen(ref_params, ref_circuit, k, ref_field.Fr)
    want = ref_kzg.create_proof(
        ref_params, ref_pk, ref_circuit, [list(ref_public)], rng=random.Random(seed)
    )

    path = str(tmp_path / "pk.pkl")
    ref_pk.save(path)
    circuit, public = build(PORT)
    params = port_kzg.ParamsKZG.setup_cached(k)
    pk = PortProvingKey.load(path, circuit, k, port_field.Fr)
    assert pk.vk.digest == ref_pk.vk.digest
    got = port_kzg.create_proof(
        params, pk, circuit, [list(public)], rng=random.Random(seed), device="cpu", commit=commit
    )

    assert got == want
    assert ref_kzg.verify_proof(ref_params, ref_pk.vk, got, [list(ref_public)])
    assert port_kzg.verify_proof(params, pk.vk, got, [list(public)])
    bad = list(public)
    bad[tamper] = bad[tamper] + port_field.Fr.from_u64(1)
    assert not port_kzg.verify_proof(params, pk.vk, got, [bad])


def test_proving_key_round_trips_reference_format(tmp_path):
    """from_saved takes exactly what the reference saves, and to_saved gives
    it back unchanged."""
    circuit, _ = _hash_v1(REF)
    params = ref_kzg.ParamsKZG.setup_cached(4)
    ref_pk = ref_kzg.keygen(params, circuit, 4, ref_field.Fr)
    path = str(tmp_path / "pk.pkl")
    ref_pk.save(path)
    pk = PortProvingKey.load(path, _hash_v1(PORT)[0], 4, port_field.Fr)
    ref_saved = RefProvingKey.load(path, circuit, 4, ref_field.Fr)
    saved = pk.to_saved()
    assert saved["digest"] == ref_saved.vk.digest
    assert saved["fixed_values"] == ref_saved.fixed_values
    assert saved["sigma_values"] == ref_saved.sigma_values
    assert np.array_equal(saved["fixed_coeffs"], np.asarray(ref_saved.fixed_coeffs))
    assert np.array_equal(saved["sigma_coeffs"], np.asarray(ref_saved.sigma_coeffs))
    with pytest.raises(ValueError):
        PortProvingKey.load(path, _hash_v1(PORT)[0], 5, port_field.Fr)


def test_flagship_fixture_is_the_reference_proof():
    circuit, public = _mst_flagship(REF)
    params = ref_kzg.ParamsKZG.setup_cached(11)
    pk = RefProvingKey.load(
        os.path.join(ROOT, ".srs", "pk_mst_d15_k11.pkl"), circuit, 11, ref_field.Fr
    )
    proof = ref_kzg.create_proof(params, pk, circuit, [list(public)], rng=random.Random(7))
    with open(FIXTURE, "rb") as f:
        assert f.read() == proof
