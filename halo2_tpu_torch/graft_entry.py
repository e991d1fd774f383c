"""Entry points of the port for a quick run on one or many devices (port
of ``__graft_entry__.py``).

    python -m halo2_tpu_torch.graft_entry [entry | dryrun [N]]

``entry()``: the hot loop of the flagship merkle-sum-tree experiment at
depth 5, k = 10: every gate constraint evaluated on every row of the
witness columns, in one ``vm_eval`` launch on the card, giving each
constraint's count of violated rows.

``dryrun_multichip(n)``: ``n`` ranks of a ``(dp, sp)`` mesh
(:func:`.parallel.launch.spawn`), each running three checks: the sharded
prove step on the flagship at depth 2, k = 9 against single-device and host
results; ``hash_v1`` proved through ``create_proof(mesh=)`` equal to the
single-device proof; the same for ``overflow_check_v2``, a circuit with a
lookup.  Every failed check raises.

Both run on the CUDA device unless the caller passes ``device="cpu"``.
The command line runs on the card: ``entry`` prints the violation counts,
``dryrun N`` (default: every visible card) prints each rank's checks with
their seconds and launches and ends with ``dryrun_multichip OK``.
"""

from __future__ import annotations

import random
import sys
import time

import torch

from ._device import resolve_device
from .field.params import BN254_FR

# the proof checks: circuit (parallel.jobs.circuit), least k, seed of the rng
PROOFS = (("hash_v1", 4, 11), ("overflow_check_v2", 5, 13))
CHECKS = ("prove_step",) + tuple(name for name, _k, _seed in PROOFS)


def _flagship_columns(depth: int, k: int, device):
    """Synthesize the merkle-sum-tree circuit -> (cs, the evaluator's dict
    of (C, 16, n) Montgomery tensors on ``device``)."""
    from .circuits.merkle_sum_tree import MerkleSumTreeCircuit, Node, compute_merkle_sum_root
    from .field import Fr
    from .field.device import get_device_field
    from .plonkish.assignment import run_synthesis
    from .plonkish.evaluator import encode_columns

    leaf = Node(Fr.from_u64(10), Fr.from_u64(100))
    elements = [Node(Fr.from_u64(3 * i + 1), Fr.from_u64(10 * i + 10)) for i in range(depth)]
    indices = [Fr.from_u64(i % 2) for i in range(depth)]
    root = compute_merkle_sum_root(Fr, leaf, elements, indices)
    assets = root.balance + Fr.from_u64(1)
    circuit = MerkleSumTreeCircuit(
        Fr,
        leaf.hash,
        leaf.balance,
        [e.hash for e in elements],
        [e.balance for e in elements],
        indices,
        assets,
    )
    public = [leaf.hash, leaf.balance, root.hash, assets]
    cs, _cfg, assignment = run_synthesis(circuit, k, [public], witness=True, field=Fr)
    columns = encode_columns(get_device_field(BN254_FR), assignment.finalize(), device=device)
    return cs, columns


def entry(device=None):
    """Returns ``(fn, (columns,))``: ``fn(columns)`` is the (C,) count of
    violated rows of each gate constraint of the flagship (depth 5, k = 10),
    from one ``vm_eval`` over the columns on ``device``; ``fn.program`` is
    the gates' :class:`.plonkish.evaluator.Program` it runs."""
    from .field.device import get_device_field
    from .plonkish.evaluator import Program, _run_program

    cs, columns = _flagship_columns(depth=5, k=10, device=resolve_device(device))
    df = get_device_field(BN254_FR)
    prog = Program([c for gate in cs.gates for c in gate.constraints])

    def fn(cols):
        outs = _run_program(prog, df, cols)  # (C, 16, n)
        return (outs != 0).any(dim=1).sum(dim=-1)

    fn.program = prog
    return fn, (columns,)


def dryrun_mesh(n_devices: int) -> tuple[int, int]:
    """The dryrun's ``(dp, sp)`` for ``n_devices`` ranks: ``sp`` the largest
    power of two dividing n (the four-step NTT splits by powers of two),
    halved when it would take every rank (n >= 4), so that ``dp`` >= 2 and
    the MSM's exchange over ``dp`` runs; ``dp`` takes the rest."""
    if n_devices < 1:
        raise ValueError(f"dryrun_multichip needs at least one rank, got {n_devices}")
    sp = 1
    while n_devices % (sp * 2) == 0:
        sp *= 2
    if sp == n_devices and sp >= 4:
        sp //= 2
    return n_devices // sp, sp


def _k_for(sp: int, k: int) -> int:
    """The least k' >= k whose 2^k' rows the four-step NTT can split over
    ``sp`` ranks (sp divides n2 = 2^floor(k'/2), and so n1)."""
    while (1 << (k // 2)) % sp:
        k += 1
    return k


def _check_prove_step(mesh, device, n_points: int) -> dict:
    """The sharded prove step on the flagship at depth 2, k = 9, over the
    SRS-like points (i+1)G: no gate violated, and the advice iNTT, each
    column's commitment and the grand product z equal the single-device
    iNTT, the host MSM and the host recurrence."""
    from .ec import host as ec
    from .ec.device import df as dfq
    from .ec.device import jac_host_affine
    from .field.device import get_device_field
    from .parallel import build_sharded_prove_step, jobs
    from .poly.domain import _ntt_raw

    cs, columns = _flagship_columns(depth=2, k=9, device=device)
    pts = [ec.ec_mul(ec.G1, i + 1) for i in range(n_points)]
    d = dfq()
    px = d.encode([ec.g1_to_ints(p)[0] for p in pts], device=device)
    py = d.encode([ec.g1_to_ints(p)[1] for p in pts], device=device)
    step = build_sharded_prove_step(mesh, cs, BN254_FR, n_points)
    jobs.reset_launches()
    jobs._sync(device)
    t0 = time.perf_counter()
    violations, coeffs, commitments, z = step(columns, px, py)
    jobs._sync(device)
    seconds = time.perf_counter() - t0
    launches = jobs.read_launches()
    if int(violations.sum()) != 0:
        raise AssertionError(f"prove_step: the witness violates its gates: {violations.tolist()}")

    dfr = get_device_field(BN254_FR)
    adv = columns["advice"]
    n = adv.shape[-1]
    if not torch.equal(coeffs, _ntt_raw(BN254_FR, n, True)(adv)):
        raise AssertionError("prove_step: the sharded iNTT differs from the single-device iNTT")
    for a in range(adv.shape[0]):
        scalars = [int(v) for v in dfr.decode(coeffs[a], from_mont=True)][:n_points]
        want = ec.msm_host(pts, scalars)
        want = ec.g1_to_ints(want) if want is not None else (0, 0)
        got = jac_host_affine({c: commitments[c][a] for c in ("x", "y", "z")})
        if got != want:
            raise AssertionError(f"prove_step: the sharded MSM of advice column {a} != host MSM")
    p = BN254_FR.p
    adv0 = dfr.decode(adv[0])
    adv1 = dfr.decode(adv[1 % adv.shape[0]])
    z_host = [1] * n
    for r in range(n - 1):
        z_host[r + 1] = z_host[r] * (int(adv0[r]) + 1) * pow(int(adv1[r]) + 1, -1, p) % p
    if [int(v) for v in dfr.decode(z)] != z_host:
        raise AssertionError("prove_step: the sharded grand product z != the host recurrence")
    return {"violations": violations.tolist(), "seconds": seconds, "launches": launches}


def _check_proof(mesh, device, name: str, k: int, seed: int) -> dict:
    """The circuit ``name`` (:func:`.parallel.jobs.circuit`) at ``k`` proved
    through ``create_proof(mesh=)`` with ``random.Random(seed)``: the bytes
    equal the single-device proof on this rank's device, and the verifier
    accepts them."""
    from .field import Fr
    from .kzg import ParamsKZG, create_proof, keygen, verify_proof
    from .parallel import jobs

    circuit, instances = jobs.circuit(name)
    params = ParamsKZG.setup_cached(k, device=device)
    pk = keygen(params, circuit, k, Fr, device=device)
    single = create_proof(params, pk, circuit, instances, rng=random.Random(seed), device=device)
    jobs.reset_launches()
    jobs._sync(device)
    t0 = time.perf_counter()
    proof = create_proof(params, pk, circuit, instances, rng=random.Random(seed), mesh=mesh)
    jobs._sync(device)
    seconds = time.perf_counter() - t0
    launches = jobs.read_launches()
    if proof != single:
        raise AssertionError(f"{name}: the mesh proof != the single-device proof (k = {k})")
    if not verify_proof(params.verifier_params(), pk.vk, proof, instances):
        raise AssertionError(f"{name}: the verifier rejected the mesh proof (k = {k})")
    return {"k": k, "proof": proof, "seconds": seconds, "launches": launches}


def _dryrun_rank(mesh) -> dict:
    """One rank's three checks (raising on any failure); its report."""
    import torch.distributed as dist

    from .parallel import comm
    from .parallel.mesh import axis_size, rank_device

    device = rank_device(mesh)
    sp = axis_size(mesh, "sp")
    checks = {"prove_step": _check_prove_step(mesh, device, 16 * dist.get_world_size())}
    for name, k, seed in PROOFS:
        checks[name] = _check_proof(mesh, device, name, _k_for(sp, k), seed)
    return {
        "rank": dist.get_rank(),
        "mesh": (axis_size(mesh, "dp"), sp),
        "device": str(device),
        "backend": str(dist.get_backend()),
        "checks": checks,
        "transports": dict(comm.TRANSPORTS),
    }


def dryrun_multichip(n_devices: int, device=None) -> list[dict]:
    """The three checks on ``n_devices`` spawned ranks of a
    :func:`dryrun_mesh` mesh, over the backend
    :func:`.parallel.launch.default_backend` picks from the counts; returns
    each rank's report, in rank order: ``{"rank", "mesh", "device",
    "backend", "transports", "checks": {name: {..., "seconds",
    "launches"}}}``, the seconds and kernel launches those of the sharded
    computation alone (the step, or the mesh prove), and the proof checks'
    ``"proof"`` bytes and ``"k"``.  A failed check raises here."""
    from .kzg import ParamsKZG
    from .parallel.launch import default_backend, spawn

    device = resolve_device(device)
    dp, sp = dryrun_mesh(n_devices)
    for k in {_k_for(sp, k) for _name, k, _seed in PROOFS}:
        ParamsKZG.setup_cached(k, device=device)  # here, not in the ranks at once
    backend = default_backend(n_devices, device.type)
    return spawn(_dryrun_rank, n_devices, backend, device.type, dp=dp)


def print_reports(reports, tag: str = "[dryrun]") -> None:
    """One line per rank and check of :func:`dryrun_multichip`'s reports:
    its mesh, device, backend, seconds and the kernels it launched."""
    for rep in reports:
        for name in CHECKS:
            c = rep["checks"][name]
            launched = {kern: n for kern, n in c["launches"].items() if n}
            print(
                f"{tag} rank {rep['rank']}, mesh {rep['mesh']}, {rep['device']}, {rep['backend']}: "
                f"{name} passed in {c['seconds']:.3f} s; launches {launched}",
                flush=True,
            )


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    command = args[0] if args else "dryrun"
    device = resolve_device()
    names = [torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
    print(f"devices: {names}", flush=True)
    if command == "entry" and len(args) == 1:
        fn, (columns,) = entry(device)
        print(f"entry: violations per constraint {fn(columns).tolist()}", flush=True)
        return 0
    if command != "dryrun" or len(args) > 2:
        raise SystemExit(f"usage: graft_entry [entry | dryrun [N]]; {args}")
    n = int(args[1]) if len(args) == 2 else torch.cuda.device_count()
    t0 = time.perf_counter()
    reports = dryrun_multichip(n, device)
    print_reports(reports)
    dt = time.perf_counter() - t0
    print(f"[dryrun] {n} ranks in {dt:.1f} s, process start and build included", flush=True)
    print("dryrun_multichip OK", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
