"""North-star workload: the merkle-sum-tree proof of solvency, depth 15,
k = 11, keygen, prove and verify end to end (port of scripts/north_star.py).

    python -m halo2_tpu_torch.north_star [--k 11] [--depth 15] [--repeat N]
        [--no-pk-cache] [--profile-dir DIR] [--engine torch|native|auto]
        [--commit native|device] [--device cuda|cpu]

Prints the reference's vk/pk/prove/verify timing lines (reference
src/circuits/utils.rs:66-69), the prover's phase times when
``HALO2_TPU_TIMING`` is set (it is, when run as a script), and a last line
of JSON with the reference's keys, the engine, and the card's name and
power limit.  ``--engine`` and ``--commit`` are ``create_proof``'s
arguments (the reference's HALO2_TPU_PROVER_BACKEND and
HALO2_TPU_COMMIT_BACKEND); the default engine is the card's.  Keygen runs
on ``--device``, or on the native host NTT with ``--engine native``.  The
SRS and the proving key come from the repository's ``.srs/`` (the key is
made and saved there when it is missing, unless ``--no-pk-cache``).
``--profile-dir`` writes a torch.profiler trace of the first prove there.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import random
import time

import torch

from ._device import card_info, resolve_device

SRS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".srs")


def flagship(depth: int = 15):
    """The north-star circuit and its public input, from random.Random(0xA11CE)."""
    from .circuits.merkle_sum_tree import MerkleSumTreeCircuit, Node, compute_merkle_sum_root
    from .field import Fr

    rng = random.Random(0xA11CE)
    leaf = Node(Fr.from_u64(10), Fr.from_u64(100))
    elements = [
        Node(Fr.from_u64(rng.randrange(1 << 32)), Fr.from_u64(rng.randrange(1 << 20)))
        for _ in range(depth)
    ]
    indices = [Fr.from_u64(rng.randrange(2)) for _ in range(depth)]
    root = compute_merkle_sum_root(Fr, leaf, elements, indices)
    assets_sum = root.balance + Fr.from_u64(1)  # liabilities < assets
    public = [leaf.hash, leaf.balance, root.hash, assets_sum]
    circuit = MerkleSumTreeCircuit(
        Fr, leaf.hash, leaf.balance, [n.hash for n in elements],
        [n.balance for n in elements], indices, assets_sum,
    )
    return circuit, public


def _profiler(profile_dir):
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(profile_dir))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k", type=int, default=11)
    ap.add_argument("--depth", type=int, default=15)
    ap.add_argument("--no-pk-cache", action="store_true")
    ap.add_argument("--repeat", type=int, default=1, help="prove N times in one process and report each")
    ap.add_argument("--profile-dir", default=None, help="write a torch.profiler trace of the first prove here")
    ap.add_argument("--engine", default="torch", choices=("torch", "native", "auto"))
    ap.add_argument("--commit", default="native", choices=("native", "device"))
    ap.add_argument("--device", default=None, help="torch device of the torch engine and keygen (default: cuda)")
    args = ap.parse_args(argv)

    from .field import Fr
    from .kzg import ParamsKZG, ProvingKey, create_proof, keygen_pk, keygen_vk, verify_proof
    from .kzg.keygen import NATIVE_NTT
    from .kzg.prover import PHASE_TIMINGS

    device = None if args.engine == "native" and args.device is None else resolve_device(args.device)
    card = card_info() if device is not None and device.type == "cuda" else {"gpu": None, "power_limit": None}
    if card["gpu"]:
        print(f"{card['gpu']}, {card['power_limit']}", flush=True)
    print(f"torch {torch.__version__}, engine {args.engine}, device {device}", flush=True)

    def sync():
        if device is not None and device.type == "cuda":
            torch.cuda.synchronize(device)

    k, depth = args.k, args.depth
    t0 = time.perf_counter()
    circuit, public = flagship(depth)
    print(f"host oracle root ({depth} levels): {time.perf_counter() - t0:.2f}s", flush=True)

    t0 = time.perf_counter()
    params = ParamsKZG.setup_cached(k, device=device)
    print(f"SRS k={k} ready in {time.perf_counter() - t0:.1f}s", flush=True)

    vk_time = pk_time = None
    cache = os.path.join(SRS_DIR, f"pk_mst_d{depth}_k{k}.pkl")
    keygen_device = NATIVE_NTT if device is None else device
    t0 = time.perf_counter()
    if args.no_pk_cache or not os.path.exists(cache):
        # cold path: the two halo2 entry points, each timed (reference
        # src/circuits/utils.rs:31-36)
        vk = keygen_vk(params, circuit, k, Fr, device=keygen_device)
        sync()
        vk_time = time.perf_counter() - t0
        t1 = time.perf_counter()
        pk = keygen_pk(params, vk, circuit, k, Fr, device=keygen_device)
        sync()
        pk_time = time.perf_counter() - t1
        if not args.no_pk_cache:
            pk.save(cache)
    else:
        pk = ProvingKey.load(cache, circuit, k, Fr)
    keygen_time = time.perf_counter() - t0

    PHASE_TIMINGS.clear()
    prove_times = []
    for rep in range(max(1, args.repeat)):
        t0 = time.perf_counter()
        with _profiler(args.profile_dir) if rep == 0 else contextlib.nullcontext():
            proof = create_proof(
                params, pk, circuit, [list(public)], rng=random.Random(7),
                device=device, commit=args.commit, engine=args.engine,
            )
            sync()
        prove_times.append(time.perf_counter() - t0)
        if args.repeat > 1:
            print(f"prove rep {rep}: {prove_times[-1]:.3f}s", flush=True)
    proof_time = prove_times[-1]  # steady state: the first prove builds the static aux columns
    if args.profile_dir:
        print(f"profiler trace written to {args.profile_dir}", flush=True)

    t0 = time.perf_counter()
    ok = verify_proof(params.verifier_params(), pk.vk, proof, [list(public)])
    verify_time = time.perf_counter() - t0
    if not ok:
        raise AssertionError("north-star proof failed verification")
    bad = list(public)
    bad[2] = bad[2] + Fr.from_u64(1)
    if verify_proof(params.verifier_params(), pk.vk, proof, [bad]):
        raise AssertionError("the verifier accepted a tampered root")

    if vk_time is not None:
        print(f"Time to generate vk {vk_time:.3f}s")
        print(f"Time to generate pk {pk_time:.3f}s")
    else:
        print(f"Time to load vk+pk from cache {keygen_time:.3f}s")
    print(f"Prover Time {proof_time:.3f}s")
    print(f"Verifier Time {verify_time:.3f}s")
    summary = {
        "workload": f"merkle_sum_tree depth={depth} k={k} KZG",
        "keygen_s": round(keygen_time, 3),
        "keygen_vk_s": round(vk_time, 3) if vk_time is not None else None,
        "keygen_pk_s": round(pk_time, 3) if pk_time is not None else None,
        "prove_s": round(proof_time, 3),
        "prove_reps_s": [round(t, 3) for t in prove_times] if args.repeat > 1 else None,
        "verify_s": round(verify_time, 3),
        "proof_bytes": len(proof),
        "phases": {p: round(v, 3) for p, v in PHASE_TIMINGS.items()},
        "engine": args.engine,
        "commit": args.commit,
        "device": str(device) if device is not None else "native",
        **card,
    }
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    os.environ.setdefault("HALO2_TPU_TIMING", "1")
    main()
