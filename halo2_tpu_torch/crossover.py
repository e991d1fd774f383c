"""The two constants the port's choices rest on, measured on the card (port
of scripts/device_crossover.py, with the hybrid MSM's split beside it).

    python -m halo2_tpu_torch.crossover [--ks 11,13] [--reps 5]
        [--sizes 16,20] [--fracs 0,0.25,0.5,0.75,0.9,1]

(an empty ``--ks`` or ``--sizes`` skips that table)

1. The engine crossover (``kzg.engine.DEVICE_MIN_EXT``): the north star
   (``python -m halo2_tpu_torch.north_star``) at each k, once with
   ``--engine native`` and once with ``--engine torch`` (native commits),
   each in its own process, proving 1 + ``reps`` times; the median of the
   warm proves.  It prints the largest extended-domain size at which the
   native engine was faster, and what ``engine="auto"`` picks at each size.
2. The hybrid MSM's device share (``ec.device._hybrid_device_frac``):
   ``msm_hybrid`` at each 2^size on bench.py's inputs (the k = 16 SRS and
   random.Random(42) scalars at 2^16; that SRS and random.Random(9) scalars
   tiled at larger sizes) at every device share, the median of ``reps``
   runs after a warm-up, with the native engine on all cores and on all but
   one (``native.set_threads``) while the main thread dispatches the
   device's work.  Each share's result must equal the native MSM.

Prints the card's name and power limit first and one JSON line per table.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from ._device import card_info

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def engine_crossover(ks, reps: int) -> dict:
    from .kzg.engine import DEVICE_MIN_EXT

    rows = []
    for k in ks:
        row = {"k": k, "extended_n": 1 << (k + 4)}
        for engine in ("native", "torch"):
            out = subprocess.run(
                [sys.executable, "-m", "halo2_tpu_torch.north_star", "--k", str(k), "--engine", engine,
                 "--repeat", str(reps + 1)],
                cwd=ROOT, capture_output=True, text=True, timeout=900, check=True,
            )
            summary = json.loads(out.stdout.strip().splitlines()[-1])
            warm = summary["prove_reps_s"][1:]
            row[f"{engine}_warm_s"] = warm
            row[f"{engine}_median_s"] = statistics.median(warm)
            row[f"{engine}_first_s"] = summary["prove_reps_s"][0]
            row[f"{engine}_phases_s"] = summary["phases"]
        row["auto_picks"] = "native" if row["extended_n"] <= DEVICE_MIN_EXT else "torch"
        rows.append(row)
        print(
            f"[crossover] k={k} (extended 2^{k + 4}): native {row['native_median_s']:.3f} s, torch "
            f"{row['torch_median_s']:.3f} s (warm medians of {reps}); auto picks {row['auto_picks']} "
            f"at DEVICE_MIN_EXT 2^{DEVICE_MIN_EXT.bit_length() - 1}",
            flush=True,
        )
    native_faster = [r["extended_n"] for r in rows if r["native_median_s"] < r["torch_median_s"]]
    return {"crossover": rows, "native_faster_up_to": max(native_faster) if native_faster else None}


def _msm_inputs(log_n: int):
    from .field.device import get_device_field
    from .field.params import BN254_FR
    from .kzg.params import ParamsKZG

    srs = ParamsKZG.load(os.path.join(ROOT, ".srs", "kzg_bn254_k16_s857536.pkl"))
    n = min(1 << log_n, srs.n)
    tiles = (1 << log_n) // n
    rng = random.Random(42 if tiles == 1 else 9)
    sc = get_device_field(BN254_FR).encode_np([rng.randrange(BN254_FR.p) for _ in range(n)], to_mont=False)
    return [np.ascontiguousarray(np.tile(a[:, :n], (1, tiles))) for a in (srs.g1_x, srs.g1_y, sc)]


def hybrid_sweep(sizes, fracs, reps: int, device="cuda") -> dict:
    """msm_hybrid's time at each size, native thread count and device share:
    each repeat takes every (threads, share) pair in turn, so that the
    host's drift falls on all of them alike."""
    from . import native
    from .ec import device as ecd

    cores = len(os.sched_getaffinity(0))
    settings = [(threads, frac) for threads in (cores, cores - 1) for frac in fracs]
    rows = []
    for log_n in sizes:
        host = _msm_inputs(log_n)
        dev = [torch.from_numpy(a.view(np.int32)).to(device) for a in host]
        want = native.msm_g1_mont(*[native.pack_device(a) for a in host])
        ifma = native.points_to52(native.pack_device(host[0][:, :1]), native.pack_device(host[1][:, :1])) is not None
        times = {s: [] for s in settings}
        try:
            for rep in range(reps + 1):
                for threads, frac in settings:
                    native.set_threads(threads)
                    t0 = time.perf_counter()
                    pt = ecd.msm_hybrid(*dev, *host, device_frac=frac)
                    pt["x"].cpu()
                    dt = time.perf_counter() - t0
                    if rep == 0:  # the warm-up run is the check
                        if ecd.jac_host_affine(pt) != want:
                            raise AssertionError(f"msm_hybrid 2^{log_n} at {frac}: not the native MSM {want}")
                    else:
                        times[(threads, frac)].append(dt * 1e3)
        finally:
            native.set_threads(0)
        for threads, frac in settings:
            ts = times[(threads, frac)]
            rows.append({"log_n": log_n, "threads": threads, "frac": frac, "ifma": ifma,
                         "median_ms": statistics.median(ts), "runs_ms": ts})
            print(
                f"[hybrid] 2^{log_n} frac {frac} native threads {threads} (IFMA {ifma}): "
                f"{statistics.median(ts):.2f} ms, runs {[round(t, 2) for t in ts]}",
                flush=True,
            )
    return {"hybrid": rows, "cores": cores}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ks", default="11,13")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sizes", default="16,20")
    ap.add_argument("--fracs", default="0,0.25,0.5,0.75,0.9,1")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the crossover is measured on the card")
    card = card_info()
    print(f"{card['gpu']}, {card['power_limit']}", flush=True)
    sizes = [int(s) for s in args.sizes.split(",") if s]
    if sizes:
        sweep = hybrid_sweep(sizes, [float(f) for f in args.fracs.split(",")], args.reps)
        print(json.dumps({**sweep, **card}), flush=True)
    ks = [int(k) for k in args.ks.split(",") if k]
    if ks:
        cross = engine_crossover(ks, args.reps)
        print(json.dumps({**cross, **card}), flush=True)


if __name__ == "__main__":
    main()
