"""The port's prover engines, engine choice and entry scripts against the
reference's.

``NativeEngine`` (the native C++ host engine) and ``TorchEngine`` on the CPU
(the kernels' plain versions) must give the reference's proof bytes, which
the reference makes on its own ``NativeEngine``
(``HALO2_TPU_PROVER_BACKEND=native``).  Each ``NativeEngine`` method must
return the reference's arrays on the same numpy inputs, word for word, and
``select_engine`` must pick what the reference picks under the same
settings (its ``"device"`` is the port's ``"torch"``).  The north star and
the bench run on the CPU at small sizes and print one JSON line with the
reference scripts' keys.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

import halo2_tpu.field as ref_field
import halo2_tpu.kzg as ref_kzg
import halo2_tpu.kzg.engine as ref_engine
import halo2_tpu.native as ref_native
import halo2_tpu_torch.field as port_field
import halo2_tpu_torch.kzg as port_kzg
import halo2_tpu_torch.kzg.engine as port_engine
import halo2_tpu_torch.native as port_native
from halo2_tpu_torch import bench, north_star
from halo2_tpu.ec import host as ec_ref
from halo2_tpu_torch.ec import device as ecd
from halo2_tpu_torch.ec import host as ec_port
from halo2_tpu_torch.kzg.keygen import ProvingKey as PortProvingKey
from test_torch_prover import FIXTURE, PORT, REF, ROOT, _hash_v1
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

P = port_field.BN254_FR.p


@pytest.fixture(scope="module")
def hash_v1_k4(tmp_path_factory):
    """The Hash1Circuit k = 4 case of tests/test_native.py: the reference's
    params, key, circuit and public input, and the port's, from one saved key."""
    k = 4
    ref_circuit, ref_public = _hash_v1(REF)
    ref_params = ref_kzg.ParamsKZG.setup_cached(k)
    ref_pk = ref_kzg.keygen(ref_params, ref_circuit, k, ref_field.Fr)
    path = str(tmp_path_factory.mktemp("pk") / "pk.pkl")
    ref_pk.save(path)
    circuit, public = _hash_v1(PORT)
    params = port_kzg.ParamsKZG.setup_cached(k)
    pk = PortProvingKey.load(path, circuit, k, port_field.Fr)
    return {
        "ref": (ref_params, ref_pk, ref_circuit, ref_public),
        "port": (params, pk, circuit, public),
    }


def test_engines_give_the_reference_proof_bytes(hash_v1_k4, monkeypatch):
    ref_params, ref_pk, ref_circuit, ref_public = hash_v1_k4["ref"]
    params, pk, circuit, public = hash_v1_k4["port"]
    monkeypatch.setenv("HALO2_TPU_PROVER_BACKEND", "native")
    want = ref_kzg.create_proof(ref_params, ref_pk, ref_circuit, [list(ref_public)], rng=random.Random(9))
    native = port_kzg.create_proof(params, pk, circuit, [list(public)], rng=random.Random(9), engine="native")
    torch_cpu = port_kzg.create_proof(
        params, pk, circuit, [list(public)], rng=random.Random(9), device="cpu", engine="torch"
    )
    assert native == torch_cpu == want
    assert port_kzg.verify_proof(params, pk.vk, native, [list(public)])


def test_native_engine_proves_the_flagship_fixture():
    circuit, public = north_star.flagship()
    params = port_kzg.ParamsKZG.setup_cached(11)
    pk = PortProvingKey.load(os.path.join(ROOT, ".srs", "pk_mst_d15_k11.pkl"), circuit, 11, port_field.Fr)
    proof = port_kzg.create_proof(params, pk, circuit, [list(public)], rng=random.Random(7), engine="native")
    with open(FIXTURE, "rb") as f:
        assert proof == f.read()


def test_default_engine_is_the_card(hash_v1_k4, monkeypatch):
    """Without a card the default create_proof raises at once; the native
    engine needs none."""
    params, pk, circuit, public = hash_v1_k4["port"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_kzg.create_proof(params, pk, circuit, [list(public)], rng=random.Random(9))
    assert port_kzg.create_proof(params, pk, circuit, [list(public)], rng=random.Random(9), engine="native")


def _engines(hash_v1_k4):
    ref_params, ref_pk = hash_v1_k4["ref"][:2]
    params, pk = hash_v1_k4["port"][:2]
    return (
        ref_engine.NativeEngine(ref_params, ref_pk.vk.structure),
        port_engine.NativeEngine(params, pk.vk.structure),
        ref_pk,
        pk,
    )


def _random_polys(rng, lengths):
    return [port_native.pack_ints([rng.randrange(P) for _ in range(m)]) for m in lengths]


@pytest.mark.parametrize("lengths", ["equal", "mixed"])
def test_native_coeff_to_extended_many_matches_reference(hash_v1_k4, lengths):
    ref, port, _, pk = _engines(hash_v1_k4)
    n = pk.vk.structure.n
    polys = _random_polys(random.Random(1), [n, n, n] if lengths == "equal" else [n, 3, n // 2])
    want = ref.coeff_to_extended_many([p.copy() for p in polys])
    got = port.coeff_to_extended_many(polys)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == np.uint64 and np.array_equal(g, w)


def test_native_extended_to_coeff_matches_reference(hash_v1_k4):
    ref, port, _, _ = _engines(hash_v1_k4)
    (epoly,) = _random_polys(random.Random(2), [port.ext_n])
    assert np.array_equal(port.extended_to_coeff(epoly), ref.extended_to_coeff(epoly.copy()))


def test_native_quotient_eval_matches_reference(hash_v1_k4):
    ref, port, _, _ = _engines(hash_v1_k4)
    rot_scale = port.ext_n // port.n
    prog = port.st.quotient_program(rot_scale)
    size = {}
    for kind, ci, _rot in prog.queries:
        size[kind] = max(size.get(kind, 0), ci + 1)
    rng = random.Random(3)
    cols = {kind: _random_polys(rng, [port.ext_n] * m) for kind, m in size.items()}
    want = ref.quotient_eval(
        {kind: [c.copy() for c in cs] for kind, cs in cols.items()}, ref.st.combined_quotient(), rot_scale
    )
    got = port.quotient_eval(cols, port.st.combined_quotient(), rot_scale)
    assert np.array_equal(got, want)


def test_native_pk_coeff_and_commit_batch_match_reference(hash_v1_k4):
    ref, port, ref_pk, pk = _engines(hash_v1_k4)
    for which, count in (("fixed", len(pk.fixed_values)), ("sigma", len(pk.sigma_values))):
        for i in range(count):
            assert np.array_equal(port.pk_coeff(pk, which, i), ref.pk_coeff(ref_pk, which, i)), (which, i)
    polys = _random_polys(random.Random(4), [port.n] * 3)
    want = [ec_ref.g1_to_ints(p) for p in ref.commit_batch([p.copy() for p in polys])]
    assert [ec_port.g1_to_ints(p) for p in port.commit_batch(polys)] == want


# (reference HALO2_TPU_PROVER_BACKEND, port engine); min_ext relative to the
# structure's extended size
SELECT_CASES = [
    ("auto", "auto", 0), ("auto", "auto", -1), ("native", "native", 0),
    ("device", "torch", 0), ("native", "native", -1), ("device", "torch", -1),
]


@pytest.mark.parametrize("native_available", [True, False])
@pytest.mark.parametrize("ref_mode, engine, offset", SELECT_CASES)
def test_select_engine_matches_reference(hash_v1_k4, monkeypatch, ref_mode, engine, offset, native_available):
    ref_params, ref_pk = hash_v1_k4["ref"][:2]
    params, pk = hash_v1_k4["port"][:2]
    min_ext = pk.vk.structure.domain.extended_n + offset
    monkeypatch.setenv("HALO2_TPU_PROVER_BACKEND", ref_mode)
    monkeypatch.setenv("HALO2_TPU_DEVICE_MIN_EXT", str(min_ext))
    if not native_available:
        monkeypatch.setattr(ref_native, "available", lambda: False)
        monkeypatch.setattr(port_native, "available", lambda: False)
        if engine == "native":
            with pytest.raises(RuntimeError):
                ref_engine.select_engine(ref_params, ref_pk.vk.structure)
            with pytest.raises(RuntimeError, match="native"):
                port_engine.select_engine(params, pk.vk.structure, "cpu", engine=engine, min_ext=min_ext)
            return
    want = ref_engine.select_engine(ref_params, ref_pk.vk.structure).name
    got = port_engine.select_engine(params, pk.vk.structure, "cpu", engine=engine, min_ext=min_ext)
    assert {"device": "torch"}.get(want, want) == got.name
    if got.name == "torch":
        assert got.device == torch.device("cpu")


def test_select_engine_rejects_bad_names(hash_v1_k4):
    params, pk = hash_v1_k4["port"][:2]
    with pytest.raises(ValueError, match="engine"):
        port_engine.select_engine(params, pk.vk.structure, "cpu", engine="device")
    with pytest.raises(ValueError, match="commit"):
        port_engine.select_engine(params, pk.vk.structure, "cpu", engine="native", commit="host")
    with pytest.raises(ValueError, match="engine"):
        port_kzg.create_proof(params, pk, None, [[]], device="cpu", engine="jax")


def test_grand_product_fallback_matches_native(monkeypatch):
    rng = random.Random(5)
    num = [rng.randrange(1, P) for _ in range(40)]
    den = [rng.randrange(1, P) for _ in range(40)]
    want = port_engine._grand_product_fallback(num, den, 7)
    monkeypatch.setattr(port_native, "available", lambda: False)
    assert port_engine._grand_product_fallback(num, den, 7) == want
    assert want == ref_engine._grand_product_fallback(num, den, 7)
    assert want[0] == 7 and len(want) == 41


def test_north_star_prints_the_reference_summary(capsys):
    summary = north_star.main(["--device", "cpu", "--engine", "native", "--repeat", "2"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == summary
    for key in ("workload", "keygen_s", "keygen_vk_s", "keygen_pk_s", "prove_s", "prove_reps_s", "verify_s"):
        assert key in line, key
    assert line["workload"] == "merkle_sum_tree depth=15 k=11 KZG"
    assert len(line["prove_reps_s"]) == 2 and line["prove_s"] == line["prove_reps_s"][-1]
    assert line["proof_bytes"] == os.path.getsize(FIXTURE)
    assert line["engine"] == "native" and line["gpu"] is None


def test_bench_prints_the_reference_keys(capsys, monkeypatch):
    """The bench at small sizes on the CPU; the hybrid MSM's device share is
    pinned low so the plain-version Pippenger stays short."""
    monkeypatch.setattr(ecd, "_hybrid_device_frac", lambda n: 0.125)
    result = bench.main([
        "--device", "cpu", "--engine", "native", "--msm-log", "12", "--msm-big-log", "13",
        "--srs-k", "13", "--ntt-log", "12", "--reps", "1",
    ])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == result
    assert line["metric"] == "msm_points_per_sec_2^12_bn254" and line["unit"] == "points/s"
    for key in (
        "value", "vs_baseline", "msm_points_per_sec_2^13", "ntt_butterflies_per_sec_2^12", "ntt_vs_baseline",
        "northstar_prove_s", "northstar_verify_s", "northstar_keygen_s", "northstar_workload",
    ):
        assert key in line, key
    assert line["value"] > 0 and line["northstar_workload"] == "merkle_sum_tree depth=15 k=11 KZG"
    assert line["msm_device_frac_2^12"] == 0.125 and line["gpu"] is None
