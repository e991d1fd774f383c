"""The port's graft entries (halo2_tpu_torch.graft_entry) against the
reference's (__graft_entry__.py), on the CPU.

``entry()`` on both sides gives the same violation count per gate
constraint, on the honest witness and with one planted advice cell.
``dryrun_multichip(2, device="cpu")`` runs once for the module (two gloo
ranks, mesh (1, 2), the kernels' plain versions) in a thread while the
reference's single-chip proofs are made here; each test reads one check of
every rank.  The four-rank mesh (2, 2) is in the slow tier.
"""

import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import __graft_entry__ as ref_entry
import halo2_tpu.field as ref_field
import halo2_tpu.kzg as ref_kzg
from halo2_tpu.circuits.hash_v1 import Hash1Circuit
from halo2_tpu.circuits.overflow_check_v2 import OverflowCheckCircuitV2
from halo2_tpu.plonkish import Value
from halo2_tpu_torch import graft_entry
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FR
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

# (column, row, value) of the advice cell set in both packages' columns
PLANTED = (2, 5, 12345)


def _ref_proofs() -> dict:
    """The reference's single-chip proofs of the dryrun's circuits:
    hash_v1 at k = 4 with Random(11), overflow_check_v2 at k = 5 with
    Random(13); name -> (proof, params, pk, instances)."""
    Fr = ref_field.Fr
    cases = {
        "hash_v1": (Hash1Circuit(Fr, Value.known(Fr.from_u64(2))), [[Fr.from_u64(4)]], 4, 11),
        "overflow_check_v2": (
            OverflowCheckCircuitV2(
                Fr, Value.known(Fr.from_u64((1 << 16) - 2)), Value.known(Fr.from_u64(1))
            ),
            [[]],
            5,
            13,
        ),
    }
    out = {}
    for name, (circuit, instances, k, seed) in cases.items():
        params = ref_kzg.ParamsKZG.setup_cached(k)
        pk = ref_kzg.keygen(params, circuit, k, Fr)
        proof = ref_kzg.create_proof(params, pk, circuit, instances, rng=random.Random(seed))
        out[name] = (proof, params, pk, instances)
    return out


@pytest.fixture(scope="module")
def dryrun():
    """Every rank's report of dryrun_multichip(2, device="cpu"), and the
    reference's proofs (:func:`_ref_proofs`), made while the ranks run."""
    pool = ThreadPoolExecutor(max_workers=1)
    future = pool.submit(graft_entry.dryrun_multichip, 2, "cpu")
    ref = _ref_proofs()
    yield {"ranks": future.result(timeout=1200), "ref": ref}
    pool.shutdown(wait=True)


def _port_violations(planted: bool):
    fn, (columns,) = graft_entry.entry(device="cpu")
    assert len(fn.program.output_slots()) == 23
    if planted:
        col, row, value = PLANTED
        columns["advice"][col, :, row] = get_device_field(BN254_FR).encode_scalar(value)
    return fn(columns).tolist()


def _ref_violations(planted: bool):
    from halo2_tpu.field.device import get_device_field as ref_device_field
    from halo2_tpu.field.params import BN254_FR as REF_FR

    fn, (columns,) = ref_entry.entry()
    if planted:
        col, row, value = PLANTED
        cell = ref_device_field(REF_FR).encode([value])[:, 0]
        columns = {**columns, "advice": columns["advice"].at[col, :, row].set(cell)}
    return np.asarray(fn(columns)).tolist()


@pytest.mark.parametrize("planted", [False, True], ids=["honest", "planted"])
def test_entry_matches_reference(planted):
    got = _port_violations(planted)
    assert got == _ref_violations(planted)
    assert len(got) == 23
    assert (sum(got) > 0) == planted


def test_entry_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.dryrun_multichip(2)


@pytest.mark.parametrize(
    "n, mesh", [(1, (1, 1)), (2, (1, 2)), (4, (2, 2)), (6, (3, 2)), (8, (2, 4)), (16, (2, 8))]
)
def test_dryrun_mesh_follows_the_reference_rule(n, mesh):
    """__graft_entry__.py's rule: sp the largest power of two dividing n,
    halved when it is all of n >= 4; dp the rest."""
    assert graft_entry.dryrun_mesh(n) == mesh


@pytest.mark.parametrize(
    "sp, k, want", [(1, 4, 4), (2, 4, 4), (4, 5, 5), (8, 4, 6), (8, 5, 6), (16, 5, 8)]
)
def test_dryrun_k_lets_the_four_step_ntt_split(sp, k, want):
    assert graft_entry._k_for(sp, k) == want


def test_dryrun_backend_from_counts(monkeypatch):
    from halo2_tpu_torch.parallel.launch import default_backend

    assert default_backend(1, "cpu") == default_backend(8, "cpu") == "gloo"
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert [default_backend(w, "cuda") for w in (1, 2, 8)] == ["nccl", "gloo", "gloo"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert [default_backend(w, "cuda") for w in (1, 2, 4, 8)] == ["nccl", "nccl", "nccl", "gloo"]


def test_dryrun_ranks_and_mesh(dryrun):
    ranks = dryrun["ranks"]
    assert [r["rank"] for r in ranks] == [0, 1]
    for r in ranks:
        assert r["mesh"] == (1, 2)
        assert r["device"] == "cpu"
        assert r["backend"] == "gloo"
        assert set(r["checks"]) == set(graft_entry.CHECKS)
        for check in r["checks"].values():
            assert check["seconds"] > 0
            assert set(check["launches"]) >= {"vm_eval", "mont_mul", "jac_add"}
            assert sum(check["launches"].values()) == 0  # CPU tensors launch no kernel


def test_dryrun_reports_print_each_rank_and_check(dryrun, capsys):
    graft_entry.print_reports(dryrun["ranks"])
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 2 * len(graft_entry.CHECKS)
    for line, (rank, name) in zip(lines, [(r, c) for r in (0, 1) for c in graft_entry.CHECKS]):
        assert line.startswith(f"[dryrun] rank {rank}, mesh (1, 2), cpu, gloo: {name} passed in ")


def test_dryrun_prove_step(dryrun):
    """The rank raises unless the iNTT, the MSMs and z equal their oracles;
    what it reports is the (zero) violation count of each constraint."""
    for r in dryrun["ranks"]:
        v = r["checks"]["prove_step"]["violations"]
        assert len(v) > 0 and v == [0] * len(v)


@pytest.mark.parametrize("name, k", [("hash_v1", 4), ("overflow_check_v2", 5)])
def test_dryrun_mesh_proof_is_the_reference_proof(dryrun, name, k):
    want, params, pk, instances = dryrun["ref"][name]
    assert ref_kzg.verify_proof(params.verifier_params(), pk.vk, want, instances)
    for r in dryrun["ranks"]:
        got = r["checks"][name]
        assert got["k"] == k
        assert got["proof"] == want


# ------------------------------------------------------------------- slow tier
@pytest.mark.slow
def test_dryrun_four_ranks():
    """Mesh (2, 2): the MSM's points split over dp as well."""
    ranks = graft_entry.dryrun_multichip(4, device="cpu")
    assert [r["mesh"] for r in ranks] == [(2, 2)] * 4
    want = _ref_proofs()
    for r in ranks:
        for name, (proof, *_rest) in want.items():
            assert r["checks"][name]["proof"] == proof
