"""Scaling of the sharded MSM and NTT over ranks (port of
scripts/scaling_bench.py).

    python -m halo2_tpu_torch.scaling [--device cuda] [--ranks 1,2,8]

Prints the reference script's keys (the last line is the whole result):
the sharded MSM of 2^12 points and the sharded NTT of 2^14 elements at
W = 1, 2 and 8 ranks (meshes (1, 1), (1, 2) and (2, 4), as the reference
lays them out), each time the slowest rank's, the least of two runs after
a warm-up.  One process group a W runs every section of that W, and
a JSON line follows each group:

  * ``msm_scaling_efficiency_{2,8}dev`` = t1 / (W tW), work-normalized;
  * ``msm_collective_overhead_2dev`` = t2 / t1(n / 2): the two-rank time
    against the same work on one rank at half the points (1.0: the
    exchange is free);
  * ``ntt_scaling_efficiency_{2,8}dev`` likewise.

Ranks take the visible cards in turn (rank r on card r mod count).  A
group that fits one rank a card runs on NCCL; more ranks than cards share
them over gloo, each exchange staged through host memory (NCCL refuses two
ranks on one device), so on one card these numbers say what sharing costs,
not how cards scale.  ``scaling_note`` says which it was, with the card's
name and power limit.  ``--device cpu`` runs the plain versions, which
would take minutes at these sizes: there the run checks the keys (the
tests), at 2^3 points and 2^4 elements, one timed run, W = 1 and 2.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

import numpy as np
import torch


# (log2 MSM points, log2 NTT elements, timed runs, default ranks) by device
# type: the reference script's on a card; a check of the keys on the CPU
SIZES = {"cuda": (12, 14, 2, "1,2,8"), "cpu": (3, 4, 1, "1,2")}


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _time_rank(mesh, tasks, reps: int) -> list:
    """This rank's least time of ``reps`` runs after one warm-up, for each
    task ``(kind, arrays)`` (``kind`` ``"msm"`` or ``"ntt"``), each run
    between barriers and ending in a synchronize."""
    import torch.distributed as dist

    from .field.params import BN254_FR
    from .parallel.mesh import rank_device
    from .parallel.msm import sharded_msm
    from .parallel.ntt import sharded_ntt

    device = rank_device(mesh)
    out = []
    for kind, arrays in tasks:
        ts = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device) for a in arrays]
        best = None
        for rep in range(reps + 1):
            dist.barrier()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            if kind == "msm":
                sharded_msm(mesh, *ts)
            else:
                sharded_ntt(mesh, BN254_FR, ts[0])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if rep:
                best = dt if best is None else min(best, dt)
        out.append(best)
    return out


def _inputs(msm_log: int, ntt_log: int):
    """The reference's inputs: 64 multiples of 7 G tiled to 2^msm_log points
    with random.Random(11) scalars; 1,024 random values tiled to 2^ntt_log."""
    from .ec import host as ec
    from .ec.device import df as dfq
    from .field.device import get_device_field
    from .field.params import BN254_FR

    n = 1 << msm_log
    rng = random.Random(11)
    base = ec.ec_mul(ec.G1, 7)
    pts = [ec.ec_mul(base, i + 1) for i in range(min(64, n))]
    xs = [ec.g1_to_ints(p)[0] for p in pts] * (n // len(pts))
    ys = [ec.g1_to_ints(p)[1] for p in pts] * (n // len(pts))
    dfr = get_device_field(BN254_FR)
    sc = dfr.encode_np([rng.randrange(BN254_FR.p) for _ in range(n)], to_mont=False)
    m = 1 << ntt_log
    x = dfr.encode_np([rng.randrange(BN254_FR.p) for _ in range(min(1024, m))])
    return (dfq().encode_np(xs), dfq().encode_np(ys), sc), np.tile(x, (1, m // x.shape[1]))


def _group_times(world: int, dp: int, device, tasks, reps: int) -> tuple:
    """(seconds of each task, backend) over one group of ``world`` ranks
    with a (dp, world / dp) mesh: each task's time is its slowest rank's."""
    from .parallel.launch import default_backend, spawn

    backend = default_backend(world, device.type)
    t0 = time.perf_counter()
    per_rank = spawn(_time_rank, world, backend, device.type, tasks, reps, dp=dp)
    times = [max(ts) for ts in zip(*per_rank)]
    log(f"W={world} ({backend}): {[kind for kind, _ in tasks]} {[round(t, 4) for t in times]} s, group {time.perf_counter() - t0:.1f} s")
    return times, backend


def main(argv=None) -> dict:
    from ._device import card_info, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device type (default: cuda)")
    ap.add_argument("--ranks", default=None, help="group sizes among 1, 2, 8 (default: 1,2,8; 1,2 on the CPU)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    msm_log, ntt_log, reps, default_ranks = SIZES[device.type]
    ranks = [int(r) for r in (args.ranks or default_ranks).split(",")]
    if 1 not in ranks or not set(ranks) <= {1, 2, 8}:
        raise ValueError(f"--ranks must include 1 and be among 1, 2, 8, got {args.ranks}")
    layout = {1: 1, 2: 1, 8: 2}  # dp of the reference's meshes (1, 1), (1, 2), (2, 4)
    card = card_info() if device.type == "cuda" else {"gpu": None, "power_limit": None}
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    msm_in, ntt_in = _inputs(msm_log, ntt_log)
    backends = {}
    if device.type == "cuda":
        shared = ", ".join(
            f"{w} ranks on {min(w, cards)} card(s) over {'nccl' if w <= cards else 'gloo (host-staged)'}" for w in ranks
        )
        where = f"{card['gpu']} at {card['power_limit']}, {cards} visible"
    else:
        shared = ", ".join(f"{w} ranks on the CPU over gloo" for w in ranks)
        where = f"the CPU ({os.cpu_count()} cores): plain versions, no card"
    result = {
        "scaling_host_cores": os.cpu_count() or 1,
        "scaling_note": (
            f"torch.distributed ranks, {shared}; {where}. Ranks sharing a card run one at a time on it, so "
            "efficiencies below 1 there are the cost of sharing, not of cards; msm_collective_overhead_2dev "
            "isolates the exchange (1.0 = free)"
        ),
    }

    half = tuple(a[:, : a.shape[1] // 2] for a in msm_in)
    tasks = [("msm", msm_in), ("ntt", (ntt_in,))] + ([("msm", half)] if 2 in ranks else [])
    (t1, nt1, *t1h), backends[1] = _group_times(1, 1, device, tasks, reps)
    result["msm_t1_s"] = round(t1, 4)
    result["ntt_t1_s"] = round(nt1, 4)
    print(json.dumps(result), flush=True)
    for w in (2, 8):
        if w not in ranks:
            continue
        (tw, ntw), backends[w] = _group_times(w, layout[w], device, tasks[:2], reps)
        result[f"msm_t{w}_s"] = round(tw, 4)
        result[f"msm_scaling_efficiency_{w}dev"] = round(t1 / (w * tw), 4)
        result[f"ntt_t{w}_s"] = round(ntw, 4)
        result[f"ntt_scaling_efficiency_{w}dev"] = round(nt1 / (w * ntw), 4)
        if w == 2:
            result["msm_t1_halfn_s"] = round(t1h[0], 4)
            result["msm_collective_overhead_2dev"] = round(tw / t1h[0], 4)
        print(json.dumps(result), flush=True)
    result.update({"scaling_backends": {str(w): b for w, b in sorted(backends.items())}, "device": device.type, **card})
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
