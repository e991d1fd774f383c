"""Headline benchmark of the port on the card (port of bench.py).

    python -m halo2_tpu_torch.bench [--device cuda] [--engine torch]

Prints ONE JSON line with bench.py's keys and constants: the Pippenger MSM's
points/s at 2^16 (``metric``/``value``, through ``msm_hybrid`` with host
mirrors, as bench.py runs it) and at 2^20 (the 2^16 SRS tiled 16 times), the
forward NTT's butterflies/s at 2^20 (``poly/domain.py``'s kernels), and the
north star's prove, verify and keygen times (``python -m
halo2_tpu_torch.north_star --repeat 3`` in a subprocess: ``prove_s`` is a
warm prove), beside the card's name and power limit.  Extra context goes to
stderr.  bench.py's scaling keys wait for the sharded prover and are absent.

``--device cpu``, ``--engine`` and the size arguments exist for the tests,
which run the same code at small sizes on the CPU.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import time

import numpy as np
import torch

from ._device import card_info, resolve_device

# bench.py's baselines: the order-of-magnitude throughput of the reference's
# rayon'd CPU Pippenger, and its CPU radix-2 FFT at 2^20
BASELINE_POINTS_PER_SEC = 1.0e6
BASELINE_BUTTERFLIES_PER_SEC = 7.0e7
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _upload(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device)


def _time_msm(px, py, sc, device, reps: int):
    """Median wall time of msm_hybrid over the device tensors and their host
    mirrors, after one warm-up; each run ends in a read of the result."""
    from .ec.device import msm_hybrid

    args = [_upload(a, device) for a in (px, py, sc)]

    def run():
        msm_hybrid(*args, px, py, sc)["x"].cpu()

    run()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        ts.append(time.perf_counter() - t0)
    return sorted(ts)[len(ts) // 2]


def _scalars(seed: int, n: int) -> np.ndarray:
    from .field.device import get_device_field
    from .field.params import BN254_FR

    rng = random.Random(seed)
    return get_device_field(BN254_FR).encode_np([rng.randrange(BN254_FR.p) for _ in range(n)], to_mont=False)


def bench_msm(device, log_n: int = 16, srs_k: int = 16, reps: int = 9):
    """bench.py's headline: 2^log_n points of the k = srs_k SRS,
    random.Random(42) scalars, median of ``reps``.  Returns (points/s, s)."""
    from .kzg.params import ParamsKZG

    n = 1 << log_n
    t0 = time.perf_counter()
    params = ParamsKZG.setup_cached(srs_k, device=device)
    log(f"SRS k={srs_k} ready in {time.perf_counter() - t0:.1f}s")
    if n > params.n:
        raise ValueError(f"2^{log_n} points from a 2^{srs_k} SRS")
    px, py = (np.ascontiguousarray(a[:, :n]) for a in (params.g1_x, params.g1_y))
    dt = _time_msm(px, py, _scalars(42, n), device, reps)
    return n / dt, dt


def bench_msm_2_20(device, log_n: int = 20, srs_k: int = 16, reps: int = 5):
    """The larger MSM: the k = srs_k SRS and random.Random(9) scalars, both
    tiled to 2^log_n.  Returns (points/s, s)."""
    from .kzg.params import ParamsKZG

    n = 1 << log_n
    params = ParamsKZG.setup_cached(srs_k, device=device)
    tiles = n // params.n
    if tiles < 1:
        raise ValueError(f"2^{log_n} points from tiles of a 2^{srs_k} SRS")
    px, py = (np.tile(a, (1, tiles)) for a in (params.g1_x, params.g1_y))
    dt = _time_msm(px, py, np.tile(_scalars(9, params.n), (1, tiles)), device, reps)
    return n / dt, dt


def bench_ntt(device, log_n: int = 20, iters: int = 5):
    """Forward NTT of 2^log_n elements (random.Random(7) 4,096 values tiled)
    through the domain's kernels.  Returns (butterflies/s, s)."""
    from .field.device import get_device_field
    from .field.params import BN254_FR
    from .poly.domain import _ntt_raw

    n = 1 << log_n
    rng = random.Random(7)
    x = get_device_field(BN254_FR).encode([rng.randrange(BN254_FR.p) for _ in range(4096)], device=device)
    x = x.repeat(1, max(1, n // 4096))[:, :n].contiguous()
    fn = _ntt_raw(BN254_FR, n, False)
    fn(x)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(x)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    return (n // 2) * log_n / dt, dt


def bench_northstar(north_star_args=(), timeout: int = 480) -> dict:
    """``python -m halo2_tpu_torch.north_star --repeat 3`` in a subprocess;
    its summary's times under bench.py's keys."""
    out = subprocess.run(
        [sys.executable, "-m", "halo2_tpu_torch.north_star", "--repeat", "3", *north_star_args],
        cwd=ROOT, capture_output=True, text=True, timeout=timeout,
    )
    if out.returncode != 0:
        raise RuntimeError(f"north star failed (rc {out.returncode}): {out.stderr[-2000:]}")
    d = json.loads(out.stdout.strip().splitlines()[-1])
    return {
        "northstar_prove_s": d["prove_s"],
        "northstar_verify_s": d["verify_s"],
        "northstar_keygen_s": d["keygen_s"],
        "northstar_workload": d["workload"],
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    ap.add_argument("--engine", default="torch", choices=("torch", "native", "auto"), help="the north star's engine")
    ap.add_argument("--msm-log", type=int, default=16)
    ap.add_argument("--msm-big-log", type=int, default=20)
    ap.add_argument("--srs-k", type=int, default=16)
    ap.add_argument("--ntt-log", type=int, default=20)
    ap.add_argument("--reps", type=int, default=None, help="MSM repeats (default: 9 and 5, as bench.py)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_info() if device.type == "cuda" else {"gpu": None, "power_limit": None}
    log(f"torch {torch.__version__}, device {device}, {card}")

    from .ec.device import _hybrid_device_frac

    k = args.msm_log
    pps, dt = bench_msm(device, k, args.srs_k, args.reps or 9)
    log(f"MSM 2^{k}: {dt * 1e3:.1f} ms -> {pps:,.0f} points/s")
    result = {
        "metric": f"msm_points_per_sec_2^{k}_bn254",
        "value": round(pps),
        "unit": "points/s",
        "vs_baseline": round(pps / BASELINE_POINTS_PER_SEC, 4),
    }
    big = args.msm_big_log
    pps20, dt20 = bench_msm_2_20(device, big, args.srs_k, args.reps or 5)
    log(f"MSM 2^{big}: {dt20 * 1e3:.1f} ms -> {pps20:,.0f} points/s")
    result[f"msm_points_per_sec_2^{big}"] = round(pps20)
    bps, ntt_dt = bench_ntt(device, args.ntt_log)
    log(f"NTT 2^{args.ntt_log}: {ntt_dt * 1e3:.3f} ms -> {bps:,.0f} butterflies/s")
    result[f"ntt_butterflies_per_sec_2^{args.ntt_log}"] = round(bps)
    result["ntt_vs_baseline"] = round(bps / BASELINE_BUTTERFLIES_PER_SEC, 4)
    ns = bench_northstar(["--engine", args.engine, "--device", str(device)])
    log(f"north star: {ns}")
    result.update(ns)
    result.update(
        {
            f"msm_ms_2^{k}": round(dt * 1e3, 3),
            f"msm_ms_2^{big}": round(dt20 * 1e3, 3),
            f"msm_device_frac_2^{k}": _hybrid_device_frac(1 << k),
            f"msm_device_frac_2^{big}": _hybrid_device_frac(1 << big),
            "device": str(device),
            **card,
        }
    )
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
