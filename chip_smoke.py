"""Smoke run of the PyTorch/CUDA port (halo2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root, with one CUDA device.  Phases, each of which
passes or raises:

0. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
1. build of the CUDA kernels from halo2_tpu_torch/csrc (and of the native
   host engine), with their times;
2. every kernel against its plain PyTorch version on the card, limb for
   limb: mont_mul for BN254 Fr, BN254 Fq and Pasta Fp at m in {1, 511, 513,
   2^11, 2^15, 2^20} with edge values and a broadcast operand; the NTT stage
   kernels at n in {2^9, 2^11, 2^15, 2^20}, forward and inverse, and
   iNTT(NTT(x)) == x; at 2^11, 2^15 and 2^20 the time per call of kernel
   and plain version (CUDA events around back-to-back calls) and each
   kernel's device time per launch (torch.profiler);
3. the flagship prove: merkle-sum-tree depth 15, k = 11 (built as
   scripts/north_star.py builds it), proved three times with
   random.Random(7) on the card; the bytes must equal
   tests/data/mst_d15_k11_rng7.proof (the reference's proof), the verifier
   must accept it and reject a tampered root, and every kernel must have
   been launched during a prove.

The line before the last is a JSON object with one entry per kernel; the
last is {"ok": true, "device": {...}}.  Without a CUDA device, or outside
the repository, the script fails before printing either.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "mst_d15_k11_rng7.proof")
PK_CACHE = os.path.join(ROOT, ".srs", "pk_mst_d15_k11.pkl")
MUL_SIZES = (1, 511, 513, 1 << 11, 1 << 15, 1 << 20)
NTT_SIZES = (1 << 9, 1 << 11, 1 << 15, 1 << 20)
TIMED_SIZES = (1 << 11, 1 << 15, 1 << 20)
REPORT_SIZE = 1 << 15  # the flagship's extended domain: the ms in the JSON line


def _ms_per_call(fn, calls: int, runs: int = 5) -> float:
    """Time per call of fn(): CUDA events around ``calls`` back-to-back calls,
    synchronized, after one warm-up call; the median over ``runs`` such runs.
    It includes the host's launch cost, which bounds the small sizes."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _kernel_device_ms(fn, symbol: str, calls: int = 20) -> float:
    """Device time of one launch of the kernel whose name contains ``symbol``,
    from torch.profiler's per-kernel sums over ``calls`` calls of fn(): the
    mean over the launches the profiler recorded (it can drop a few)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total_us, count = 0.0, 0
    for e in prof.key_averages():
        if symbol in e.key and e.device_type == torch.autograd.DeviceType.CUDA:
            total_us += e.self_device_time_total
            count += e.count
    if not 0 < count <= calls:
        raise AssertionError(f"profiler saw {count} launches of {symbol} in {calls} calls")
    return total_us / count / 1e3


def _max_abs_err(name: str, got, want) -> float:
    """Kernel output against plain output: they must agree limb for limb."""
    import torch

    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {tuple(got.shape)}/{got.dtype} vs {tuple(want.shape)}/{want.dtype}")
    err = (got.to(torch.int64) - want.to(torch.int64)).abs().max().item() if got.numel() else 0
    if err != 0 or not torch.equal(got, want):
        raise AssertionError(f"{name}: kernel differs from plain version (max abs limb diff {err})")
    if got.numel() and int(got.max().item()) >= 1 << 16:
        raise AssertionError(f"{name}: a limb is >= 2^16")
    return float(err)


def _random_field(spec, shape, gen, device):
    """Random canonical (16, *shape) limbs: the top limb stays below p's."""
    import torch

    x = torch.randint(0, 1 << 16, (16, *shape), generator=gen, device=device, dtype=torch.int32)
    x[15] = torch.randint(0, spec.p >> 240, shape, generator=gen, device=device, dtype=torch.int32)
    return x


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on the GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi, flush=True)
    print(
        f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device 0: {torch.cuda.get_device_name(0)}, devices: {torch.cuda.device_count()}",
        flush=True,
    )
    return torch.device("cuda", 0)


def phase_build():
    from halo2_tpu_torch import _build, native

    t0 = time.perf_counter()
    _build.lib()
    dt = time.perf_counter() - t0
    print(f"[build] CUDA kernels: {dt:.2f} s -> {_build.library_path().name}", flush=True)
    for line in _build.log_path().read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}", flush=True)
    t0 = time.perf_counter()
    if not native.available():
        raise RuntimeError("native host engine did not build (g++ missing?)")
    print(f"[build] native host engine: {time.perf_counter() - t0:.2f} s", flush=True)


def phase_kernels(device):
    """Every kernel against its plain version; returns per-kernel results."""
    import torch

    from halo2_tpu_torch.field.cuda_mul import mont_mul, mont_mul_plain
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP
    from halo2_tpu_torch.poly import cuda_ntt
    from halo2_tpu_torch.poly.domain import _ntt_raw, twiddle_table

    gen = torch.Generator(device=device)
    gen.manual_seed(0x5EED)
    err = {"mont_mul": 0.0, "ntt_small_stages": 0.0, "ntt_large_stage": 0.0}
    times = {}

    for spec in (BN254_FR, BN254_FQ, PASTA_FP):
        df = get_device_field(spec)
        p = spec.p
        edges = df.encode([0, 1, p - 1, p - 2], device=device)
        for m in MUL_SIZES:
            a = _random_field(spec, (m,), gen, device)
            b = _random_field(spec, (m,), gen, device)
            k = min(4, m)
            a[:, :k] = edges[:, :k]
            b[:, :k] = edges.flip(1)[:, :k]
            col = _random_field(spec, (1,), gen, device)
            for tag, bb in (("full", b), ("bcast", col), ("edge-bcast", edges[:, 2:3].contiguous())):
                name = f"mont_mul {spec.name} m={m} b={tag}"
                e = _max_abs_err(name, mont_mul(spec, a, bb), mont_mul_plain(spec, a, bb))
                err["mont_mul"] = max(err["mont_mul"], e)
            if spec is BN254_FR and m in TIMED_SIZES:
                t_k = _ms_per_call(lambda: mont_mul(spec, a, b), 50)
                t_p = _ms_per_call(lambda: mont_mul_plain(spec, a, b), 3, runs=3)
                t_d = _kernel_device_ms(lambda: mont_mul(spec, a, b), "mont_mul_kernel")
                times[("mont_mul", m)] = (t_k, t_p)
                print(
                    f"[kernels] mont_mul bn254_fr m={m}: kernel {t_k:.4f} ms per call "
                    f"({t_d:.4f} ms on the device), plain {t_p:.4f} ms per call",
                    flush=True,
                )
        print(f"[kernels] mont_mul {spec.name}: equal to plain at m={list(MUL_SIZES)}", flush=True)

    spec = BN254_FR
    for n in NTT_SIZES:
        x = _random_field(spec, (n,), gen, device)
        for inverse in (False, True):
            tw = twiddle_table(spec, n, inverse, device)
            small = cuda_ntt.ntt_small_stages(spec, x, tw)
            err["ntt_small_stages"] = max(
                err["ntt_small_stages"],
                _max_abs_err(f"ntt_small_stages n={n} inv={inverse}", small,
                             cuda_ntt.ntt_small_stages_plain(spec, x, tw)),
            )
            y_k, y_p = small, small
            m = cuda_ntt.TILE
            while m < n:
                step_k = cuda_ntt.ntt_large_stage(spec, y_k, tw, m)
                err["ntt_large_stage"] = max(
                    err["ntt_large_stage"],
                    _max_abs_err(f"ntt_large_stage n={n} m={m} inv={inverse}", step_k,
                                 cuda_ntt.ntt_large_stage_plain(spec, y_k, tw, m)),
                )
                y_k = step_k
                y_p = cuda_ntt.ntt_large_stage_plain(spec, y_p, tw, m)
                m *= 2
            _max_abs_err(f"ntt ladder n={n} inv={inverse}", y_k, y_p)
        fwd = _ntt_raw(spec, n, False)(x)
        back = _ntt_raw(spec, n, True)(fwd)
        if not torch.equal(back, x):
            raise AssertionError(f"iNTT(NTT(x)) != x at n={n}")
        if n in TIMED_SIZES:
            tw = twiddle_table(spec, n, False, device)
            small = lambda: cuda_ntt.ntt_small_stages(spec, x, tw)  # noqa: E731
            large = lambda: cuda_ntt.ntt_large_stage(spec, x, tw, n // 2)  # noqa: E731
            t_sk, t_lk = _ms_per_call(small, 50), _ms_per_call(large, 50)
            t_sd = _kernel_device_ms(small, "ntt_small_stages_kernel")
            t_ld = _kernel_device_ms(large, "ntt_large_stage_kernel")
            t_sp = _ms_per_call(lambda: cuda_ntt.ntt_small_stages_plain(spec, x, tw), 2, runs=3)
            t_lp = _ms_per_call(lambda: cuda_ntt.ntt_large_stage_plain(spec, x, tw, n // 2), 2, runs=3)
            t_full = _ms_per_call(lambda: _ntt_raw(spec, n, False)(x), 10)
            times[("ntt_small_stages", n)] = (t_sk, t_sp)
            times[("ntt_large_stage", n)] = (t_lk, t_lp)
            print(
                f"[kernels] ntt n={n}: small stages kernel {t_sk:.4f} ms per call ({t_sd:.4f} ms "
                f"on the device), plain {t_sp:.4f} ms per call; large stage m={n // 2} kernel "
                f"{t_lk:.4f} ms per call ({t_ld:.4f} ms on the device), plain {t_lp:.4f} ms per "
                f"call; forward NTT through the kernels {t_full:.4f} ms per call",
                flush=True,
            )
        print(f"[kernels] ntt n={n}: kernels equal to plain, iNTT(NTT(x)) == x", flush=True)
    return err, times


def _flagship_circuit():
    """The north-star instance, built as scripts/north_star.py builds it."""
    from halo2_tpu_torch.circuits.merkle_sum_tree import (
        MerkleSumTreeCircuit,
        Node,
        compute_merkle_sum_root,
    )
    from halo2_tpu_torch.field import Fr

    depth = 15
    rng = random.Random(0xA11CE)
    leaf = Node(Fr.from_u64(10), Fr.from_u64(100))
    elements = [
        Node(Fr.from_u64(rng.randrange(1 << 32)), Fr.from_u64(rng.randrange(1 << 20)))
        for _ in range(depth)
    ]
    indices = [Fr.from_u64(rng.randrange(2)) for _ in range(depth)]
    root = compute_merkle_sum_root(Fr, leaf, elements, indices)
    assets_sum = root.balance + Fr.from_u64(1)
    public = [leaf.hash, leaf.balance, root.hash, assets_sum]
    circuit = MerkleSumTreeCircuit(
        Fr, leaf.hash, leaf.balance, [n.hash for n in elements],
        [n.balance for n in elements], indices, assets_sum,
    )
    return circuit, public


def _reset_launches():
    from halo2_tpu_torch.field import cuda_mul
    from halo2_tpu_torch.poly import cuda_ntt

    cuda_mul.LAUNCHES["mont_mul"] = 0
    for name in cuda_ntt.LAUNCHES:
        cuda_ntt.LAUNCHES[name] = 0


def _read_launches() -> dict:
    from halo2_tpu_torch.field import cuda_mul
    from halo2_tpu_torch.poly import cuda_ntt

    return {**cuda_mul.LAUNCHES, **cuda_ntt.LAUNCHES}


def phase_prove(device):
    import torch

    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import ParamsKZG, ProvingKey, create_proof, verify_proof
    from halo2_tpu_torch.kzg.prover import PHASE_TIMINGS

    k = 11
    circuit, public = _flagship_circuit()
    t0 = time.perf_counter()
    params = ParamsKZG.setup_cached(k)
    pk = ProvingKey.load(PK_CACHE, circuit, k, Fr)
    print(f"[prove] SRS + pk loaded in {time.perf_counter() - t0:.3f} s", flush=True)
    with open(FIXTURE, "rb") as f:
        want = f.read()

    torch.cuda.reset_peak_memory_stats(device)
    launches = None
    for rep in range(3):
        _reset_launches()
        PHASE_TIMINGS.clear()
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        proof = create_proof(params, pk, circuit, [list(public)], rng=random.Random(7), device=device)
        torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        counts = _read_launches()
        if launches is None:
            launches = counts
        phases = ", ".join(f"{k_}={v:.3f}" for k_, v in PHASE_TIMINGS.items())
        print(f"[prove] rep {rep}: {dt:.3f} s, {len(proof)} bytes, launches {counts}; phases (s): {phases}", flush=True)
        if proof != want:
            raise AssertionError(f"rep {rep}: proof differs from the reference proof in {FIXTURE}")
    print(f"[prove] peak device memory {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB", flush=True)
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched during the prove: {missing}")

    t0 = time.perf_counter()
    ok = verify_proof(params.verifier_params(), pk.vk, proof, [list(public)])
    print(f"[prove] verify: {ok} in {time.perf_counter() - t0:.3f} s", flush=True)
    if not ok:
        raise AssertionError("the verifier rejected the port's proof")
    bad = list(public)
    bad[2] = bad[2] + Fr.from_u64(1)
    if verify_proof(params.verifier_params(), pk.vk, proof, [bad]):
        raise AssertionError("the verifier accepted a tampered root")
    print("[prove] proof equals the reference fixture; tampered root rejected", flush=True)
    return launches


KERNELS = (
    ("mont_mul", "halo2_tpu_torch/csrc/mont_mul.cu", "halo2_tpu/field/pallas_mul.py:357"),
    ("ntt_small_stages", "halo2_tpu_torch/csrc/ntt.cu", "halo2_tpu/poly/pallas_ntt.py:47"),
    ("ntt_large_stage", "halo2_tpu_torch/csrc/ntt.cu", "halo2_tpu/poly/pallas_ntt.py:97"),
)


def main() -> int:
    device = phase_device()
    import torch

    phase_build()
    err, times = phase_kernels(device)
    launches = phase_prove(device)
    report = {
        "kernels": [
            {
                "name": name,
                "route": "cuda",
                "source": source,
                "replaces": replaces,
                "launches": launches[name],
                "max_abs_err": err[name],
                "ms": times[(name, REPORT_SIZE)][0],
                "plain_ms": times[(name, REPORT_SIZE)][1],
            }
            for name, source, replaces in KERNELS
        ]
    }
    print(json.dumps(report), flush=True)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
