"""The port's keygen against the reference's, limb for limb.

Each circuit is built twice, once from each package's own classes.  The
reference's ``keygen`` (its native host NTT and MSM) gives the key; the
port's ``keygen_vk``/``keygen_pk``/``keygen`` must give the same saved dict
(digest, commitments, fixed and sigma values and coefficients) on both of
its iNTT branches: the native host NTT (``device="native"``) and the torch
NTT on a device (``device="cpu"``: the NTT and Montgomery kernels' plain
versions), and with either commit backend.  The port's ``full_prover``
(its copy of ``circuits/utils.py``) must return the reference's proof bytes.
"""

import os
import pickle
import random

import numpy as np
import pytest
import torch

import halo2_tpu.circuits.utils as ref_utils
import halo2_tpu.ec.host as ec_ref
import halo2_tpu.field as ref_field
import halo2_tpu.kzg as ref_kzg
import halo2_tpu_torch.circuits.utils as port_utils
import halo2_tpu_torch.ec.host as ec_port
import halo2_tpu_torch.field as port_field
import halo2_tpu_torch.kzg as port_kzg
from halo2_tpu_torch.kzg.keygen import commit_coeffs_batch, commit_lagrange, keygen_cached
from test_torch_prover import PORT, REF, _hash_v1, _mst_k9
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

VECTORS = {"hash_v1-k4": (_hash_v1, 4), "merkle_sum_tree-k9": (_mst_k9, 9)}


def _assert_same_key(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name in ("k", "digest", "fixed_commitments", "sigma_commitments"):
        assert got[name] == want[name], name
    assert got["fixed_values"] == want["fixed_values"]
    assert got["sigma_values"] == want["sigma_values"]
    for name in ("fixed_coeffs", "sigma_coeffs"):
        assert got[name].dtype == np.uint32, name
        assert np.array_equal(got[name], np.asarray(want[name], np.uint32)), name


@pytest.fixture(scope="module")
def reference_keys(tmp_path_factory):
    """vector -> the dict the reference's ``ProvingKey.save`` writes for its
    key (its default, native branch)."""
    out = {}
    for name, (build, k) in VECTORS.items():
        circuit, _ = build(REF)
        params = ref_kzg.ParamsKZG.setup_cached(k)
        path = tmp_path_factory.mktemp("ref") / "pk.pkl"
        ref_kzg.keygen(params, circuit, k, ref_field.Fr).save(str(path))
        with open(path, "rb") as f:
            out[name] = pickle.load(f)
    return out


@pytest.mark.parametrize("device", ["native", "cpu"], ids=["native-ntt", "torch-ntt"])
@pytest.mark.parametrize("vector", list(VECTORS))
def test_keygen_matches_reference(reference_keys, vector, device):
    build, k = VECTORS[vector]
    circuit, _ = build(PORT)
    params = port_kzg.ParamsKZG.setup_cached(k)
    Fr = port_field.Fr
    want = reference_keys[vector]

    pk = port_kzg.keygen(params, circuit, k, Fr, device=device)
    _assert_same_key(pk.to_saved(), want)
    assert isinstance(pk.fixed_coeffs, np.ndarray) and isinstance(pk.sigma_coeffs, np.ndarray)

    vk = port_kzg.keygen_vk(params, circuit, k, Fr, device=device)
    split = port_kzg.keygen_pk(params, vk, circuit, k, Fr, device=device)
    assert vk.digest == want["digest"]
    _assert_same_key(split.to_saved(), want)

    if device != "native":
        # the coefficients computed on the device seed the engine's cache
        for which, host in (("fixed", pk.fixed_coeffs), ("sigma", pk.sigma_coeffs)):
            cached = pk._torch_coeffs[(which, torch.device(device))]
            assert cached.dtype == torch.int32
            assert np.array_equal(cached.numpy().view(np.uint32), host)


def test_device_commit_backend_gives_the_same_points(reference_keys):
    circuit, _ = _hash_v1(PORT)
    params = port_kzg.ParamsKZG.setup_cached(4)
    pk = port_kzg.keygen(params, circuit, 4, port_field.Fr, device="cpu", commit="device")
    _assert_same_key(pk.to_saved(), reference_keys["hash_v1-k4"])
    vk = port_kzg.keygen_vk(params, circuit, 4, port_field.Fr, device="cpu", commit="device")
    assert vk.digest == pk.vk.digest
    with pytest.raises(ValueError):
        port_kzg.keygen(params, circuit, 4, port_field.Fr, device="native", commit="device")
    with pytest.raises(ValueError):
        port_kzg.keygen_vk(params, circuit, 4, port_field.Fr, device="cpu", commit="gpu")


@pytest.mark.parametrize("keygen_device", ["native", "cpu"], ids=["native-keygen", "cpu"])
def test_commit_lagrange_is_the_fixed_commitment(keygen_device):
    circuit, _ = _hash_v1(PORT)
    params = port_kzg.ParamsKZG.setup_cached(4)
    pk = port_kzg.keygen(params, circuit, 4, port_field.Fr, device=keygen_device)
    domain = pk.vk.structure.domain
    for values, point in zip(pk.fixed_values, pk.vk.fixed_commitments):
        got = commit_lagrange(params, domain, values, device="cpu")
        assert got == point


def test_keygen_cached_round_trips(tmp_path, reference_keys):
    circuit, _ = _hash_v1(PORT)
    params = port_kzg.ParamsKZG.setup_cached(4)
    path = str(tmp_path / "keys" / "pk.pkl")
    first = keygen_cached(params, circuit, 4, port_field.Fr, path, device="cpu")
    assert os.path.exists(path)
    again = keygen_cached(params, circuit, 4, port_field.Fr, path)
    _assert_same_key(again.to_saved(), first.to_saved())
    _assert_same_key(again.to_saved(), reference_keys["hash_v1-k4"])
    # the reference loads what the port saved
    ref_circuit, _ = _hash_v1(REF)
    ref_pk = ref_kzg.ProvingKey.load(path, ref_circuit, 4, ref_field.Fr)
    assert ref_pk.vk.digest == first.vk.digest


def test_full_prover_matches_reference(capsys):
    ref_circuit, ref_public = _hash_v1(REF)
    want, ref_ok, _ = ref_utils.full_prover(ref_circuit, 4, ref_public, rng=random.Random(42))
    circuit, public = _hash_v1(PORT)
    got, ok, times = port_utils.full_prover(circuit, 4, public, rng=random.Random(42), device="cpu")
    assert ref_ok and ok
    assert got == want
    assert set(times) == {"vk", "pk", "prove", "verify"}
    assert "Time to generate vk" in capsys.readouterr().out


def test_g1_host_matches_reference():
    got = port_kzg.ParamsKZG.setup(4, device="cpu").g1_host()
    want = ref_kzg.ParamsKZG.setup(4).g1_host()
    assert len(got) == len(want) == 16
    assert [ec_port.g1_to_ints(p) for p in got] == [ec_ref.g1_to_ints(p) for p in want]


def test_commit_without_native_engine_matches_reference(reference_keys, monkeypatch):
    """Without the native engine, the default commit backend takes the
    reference's host-MSM fallback over ``g1_host()`` for host inputs: the
    keys' commitments equal the reference's."""
    import halo2_tpu_torch.native as port_native

    monkeypatch.setattr(port_native, "available", lambda: False)
    circuit, _ = _hash_v1(PORT)
    params = port_kzg.ParamsKZG.setup_cached(4)
    pk = port_kzg.keygen(params, circuit, 4, port_field.Fr, device="cpu")
    _assert_same_key(pk.to_saved(), reference_keys["hash_v1-k4"])
    want = [pk.vk.fixed_commitments[0], pk.vk.sigma_commitments[0]]
    host = [pk.fixed_coeffs[0], pk.sigma_coeffs[0]]
    assert commit_coeffs_batch(params, host) == want
    meta = [torch.from_numpy(c.view(np.int32)).to("meta") for c in host]
    with pytest.raises(RuntimeError):
        commit_coeffs_batch(params, meta)
