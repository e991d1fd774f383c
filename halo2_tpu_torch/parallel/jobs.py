"""Named jobs that each rank of a process group runs, so that a caller
outside the group can check the sharded layer against single-device
results: ``launch.spawn(jobs.run, W, backend, device, job_list)``.

Each job takes numpy inputs (or names a circuit), runs the port's sharded
function on this rank's device, and returns numpy arrays, ints or bytes;
:func:`run` records, for each job, this rank's kernel launches (every
count set to 0 just before the job, read just after) and its wall time
(after a synchronize on a card).  ``tests/test_torch_parallel.py`` and
``chip_smoke.py`` phase 9 use them; :func:`reset_launches` and
:func:`read_launches` are the one place that knows every kernel's launch
table, and ``chip_smoke.py`` counts each of its paths with them.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..field.device import get_device_field
from ..field.params import BN254_FR
from .mesh import rank_device


def _launch_tables():
    from ..ec import cuda_jac
    from ..field import cuda_mul, cuda_ops
    from ..plonkish import cuda_vm
    from ..poly import cuda_ntt

    return cuda_mul.LAUNCHES, cuda_ntt.LAUNCHES, cuda_jac.LAUNCHES, cuda_vm.LAUNCHES, cuda_ops.LAUNCHES


def reset_launches() -> None:
    for table in _launch_tables():
        for name in table:
            table[name] = 0


def read_launches() -> dict:
    return {name: n for table in _launch_tables() for name, n in table.items()}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def _jac_out(pt) -> dict:
    from ..ec.device import jac_host_affine

    return {"jac": _np(torch.stack([pt["x"], pt["y"], pt["z"]])), "affine": jac_host_affine(pt)}


def circuit(name: str):
    """(circuit, instances) of a named case: ``hash_v1`` (the reference's
    Hash1Circuit, 2 -> 4), ``less_than_v2`` (5 < 10, the reference's lookup
    case of its sharded tests), ``overflow_check_v2`` (2^16 - 2 + 1, a
    per-column lookup into the fixed range table: the reference dryrun's
    lookup case) or ``flagship`` (the north star)."""
    from ..field import Fr
    from ..plonkish import Value

    if name == "hash_v1":
        from ..circuits.hash_v1 import Hash1Circuit

        return Hash1Circuit(Fr, Value.known(Fr.from_u64(2))), [[Fr.from_u64(4)]]
    if name == "less_than_v2":
        from ..circuits.less_than_v2 import LessThanV2Circuit

        return LessThanV2Circuit(Fr, value_l=5, value_r=10, check=True), [[]]
    if name == "overflow_check_v2":
        from ..circuits.overflow_check_v2 import OverflowCheckCircuitV2

        a, b = Value.known(Fr.from_u64((1 << 16) - 2)), Value.known(Fr.from_u64(1))
        return OverflowCheckCircuitV2(Fr, a, b), [[]]
    if name == "flagship":
        from ..north_star import flagship

        c, public = flagship()
        return c, [list(public)]
    raise ValueError(f"unknown circuit {name!r}")


def _ntt(mesh, device, x, inverse=False):
    from .ntt import sharded_ntt

    return _np(sharded_ntt(mesh, BN254_FR, _tensor(x, device), inverse=inverse))


def _msm(mesh, device, px, py, scalars):
    from .msm import sharded_msm

    return _jac_out(sharded_msm(mesh, *(_tensor(a, device) for a in (px, py, scalars))))


def _prefix_product(mesh, device, x):
    from .scan import sharded_prefix_product

    return _np(sharded_prefix_product(mesh, BN254_FR, _tensor(x, device)))


def _grand_product_z(mesh, device, num, den):
    from .scan import grand_product_z

    return _np(grand_product_z(mesh, BN254_FR, _tensor(num, device), _tensor(den, device)))


def _prove(mesh, device, name, k, pk_path, seed, reps=1, verify=True):
    """``reps`` proves with ``random.Random(seed)`` each; returns the last
    proof, whether every proof was the same, each prove's wall time, the
    last prove's phase times, and (``verify``) the verifier's verdict."""
    import random

    from ..field import Fr
    from ..kzg import ParamsKZG, ProvingKey, create_proof, verify_proof

    from ..kzg.prover import PHASE_TIMINGS

    c, instances = circuit(name)
    params = ParamsKZG.setup_cached(k)
    pk = ProvingKey.load(pk_path, c, k, Fr)
    proofs, times = [], []
    for _ in range(reps):
        PHASE_TIMINGS.clear()
        _sync(device)
        t0 = time.perf_counter()
        proofs.append(create_proof(params, pk, c, instances, rng=random.Random(seed), mesh=mesh))
        _sync(device)
        times.append(time.perf_counter() - t0)
    out = {"proof": proofs[-1], "same": len(set(proofs)) == 1, "times": times, "phases": dict(PHASE_TIMINGS)}
    if verify:
        out["verified"] = verify_proof(params.verifier_params(), pk.vk, proofs[-1], instances)
    return out


def _pipeline(mesh, device, name, k, n_points, cells=()):
    """The sharded prove-step demo over the named circuit's witness columns
    and the first ``n_points`` points of the k SRS.  ``cells``: ``(kind,
    column, row, value)`` cells set in the encoded columns first (a witness
    that violates its gates)."""
    from ..ec.device import _wsums_host_affine
    from ..field import Fr
    from ..kzg import ParamsKZG
    from ..kzg.keygen import _device_srs
    from ..plonkish.assignment import run_synthesis
    from ..plonkish.evaluator import encode_columns
    from .pipeline import build_sharded_prove_step

    c, instances = circuit(name)
    cs, _cfg, assignment = run_synthesis(c, k, instances, witness=True, field=Fr)
    dfr = get_device_field(BN254_FR)
    columns = encode_columns(dfr, assignment.finalize(), device=device)
    for kind, ci, row, value in cells:
        columns[kind][ci, :, row] = dfr.encode_scalar(value, device=device)
    g1_x, g1_y = _device_srs(ParamsKZG.setup_cached(k), device)
    step = build_sharded_prove_step(mesh, cs, BN254_FR, n_points)
    violations, coeffs, commitments, z = step(columns, g1_x[:, :n_points], g1_y[:, :n_points])
    affine = _wsums_host_affine(torch.stack([commitments[k_].t() for k_ in ("x", "y", "z")]))
    return {"violations": _np(violations), "coeffs": _np(coeffs), "commitments": affine, "z": _np(z)}


JOBS = {
    "ntt": _ntt,
    "msm": _msm,
    "prefix_product": _prefix_product,
    "grand_product_z": _grand_product_z,
    "prove": _prove,
    "pipeline": _pipeline,
}


def run(mesh, job_list) -> list:
    """Run ``job_list`` (``[(name, kwargs), ...]``) on this rank; returns
    ``[{"name", "out", "launches", "seconds", "transports"}, ...]``, the
    transports being those :mod:`.comm` has used so far."""
    from . import comm

    device = rank_device(mesh)
    results = []
    for name, kwargs in job_list:
        reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        out = JOBS[name](mesh, device, **kwargs)
        _sync(device)
        dt = time.perf_counter() - t0
        results.append(
            {"name": name, "out": out, "launches": read_launches(), "seconds": dt, "transports": dict(comm.TRANSPORTS)}
        )
    return results
