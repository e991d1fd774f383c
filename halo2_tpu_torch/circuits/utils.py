"""full_prover harness (reference src/circuits/utils.rs:22-70).

The only real (non-mock) prove+verify path: seedable KZG setup, keygen,
create_proof, verify_proof — with the reference's wall-clock timing prints
(utils.rs:66-69) preserved verbatim in format.  Setup, keygen and the prove
run on ``device``: the CUDA device when None, the plain versions with
``device="cpu"``.
"""

from __future__ import annotations

import time

from .._device import resolve_device
from ..field.host import Fr
from ..kzg import ParamsKZG, create_proof, verify_proof
from ..kzg.keygen import keygen_pk, keygen_vk


def full_prover(circuit, k: int, public_input, seed: int = 0xD15C0, rng=None, device=None):
    """Returns (proof_bytes, ok, timings dict)."""
    device = resolve_device(device)
    params = ParamsKZG.setup_cached(k, seed, device=device)

    t0 = time.perf_counter()
    vk = keygen_vk(params, circuit, k, Fr, device=device)
    vk_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    pk = keygen_pk(params, vk, circuit, k, Fr, device=device)
    pk_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    proof = create_proof(params, pk, circuit, [list(public_input)], rng=rng, device=device)
    proof_time = time.perf_counter() - t0

    t0 = time.perf_counter()
    ok = verify_proof(params.verifier_params(), pk.vk, proof, [list(public_input)])
    verify_time = time.perf_counter() - t0
    assert ok, "proof verification failed"

    print(f"Time to generate vk {vk_time:.3f}s")
    print(f"Time to generate pk {pk_time:.3f}s")
    print(f"Prover Time {proof_time:.3f}s")
    print(f"Verifier Time {verify_time:.3f}s")
    return proof, ok, {
        "vk": vk_time,
        "pk": pk_time,
        "prove": proof_time,
        "verify": verify_time,
    }
