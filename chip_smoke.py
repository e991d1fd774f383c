"""Smoke run of the PyTorch/CUDA port (halo2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root, with one CUDA device.  Phases, each of which
passes or raises:

0. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
1. build of the CUDA kernels from halo2_tpu_torch/csrc (and of the native
   host engine), with their times, each kernel's registers and spills, and
   the curve kernels' SASS instruction and IMAD counts (cuobjdump);
2. every kernel against its plain PyTorch version on the card, limb for
   limb: mont_mul and mont_sqr for BN254 Fr, BN254 Fq and Pasta Fp at m in
   {1, 511, 513, 2^11, 2^15, 2^20} with edge values (mont_mul also with a
   broadcast operand); jac_madd and jac_add, both variants (narrow, wide),
   the P == Q doubling included, at m in JAC_SIZES (both sides of the
   variant switch) on BN254 G1 points with z != 1, with the exception lanes
   first (P == Q, P == -Q, P at infinity, Q at infinity, a masked mixed-add
   lane), reading no P == Q flag back, and each variant's device time per
   launch at every m >= 32 on operands without those lanes; the NTT stage
   kernels for BN254 Fr (carry-chain arithmetic) and Pasta Fp (64-bit
   accumulators), forward and inverse, on batches of C columns (C in
   {1, 3, 83} at n in {2^11, 2^15}, C = 1 at 2^9 and 2^20; 83 is the
   flagship's coset batch), the large stages one a launch and as the passes
   of large_stage_plan(n) (several stages a launch), and the batched
   iNTT(NTT(x)) == x; each NTT kernel's device time per launch (each pass
   of the plan) and per column with its share of the C-scaled bound at
   2^11, 2^15 and 2^20 (C = 1) and the 2^15 batch of 83 (there and at 2^20
   also per call with CUDA events, the plan against one launch a large
   stage); at 2^11, 2^15 and 2^20 the time
   per call of kernel and plain version (CUDA events around back-to-back
   calls) and each kernel's device time per launch (torch.profiler; a
   reading below the kernel's bound is taken again, then fails); mod_add
   and mod_sub (and the negation, a subtract from a broadcast zero) for
   BN254 Fr, BN254 Fq and Pasta Fp at the same m, the 16 pairs of edge
   values first, with a broadcast element on either side; the expression VM
   (vm_eval, one launch per program) on the flagship's quotient program at
   its 2^15 rows (rot_scale 16: the 2042 rotation wraps; the challenges as
   stride-0 views), the Poseidon experiment's gates (Pasta Fp; also at
   101 rows, a partial last block) and the less-than experiment's lookup
   expressions (Pasta Fp), a program whose outputs are a bare query and a
   bare constant, programs of 100 and 150 live registers (shared memory
   above 48 KB a block; 32-row blocks) and one scheduled on a single
   stream, each with its streams, phases, registers, rows and shared
   memory a block; the times of the new kernels as for the others, the
   VM's at the flagship;
3. the device MSM: msm_points at 2^16 (the k = 16 SRS, random.Random(42)
   scalars) and 2^20 (that SRS and random.Random(9) scalars tiled 16 times)
   equals the native host MSM on the same arrays; the time of each (median
   of 3 runs after a warm-up), the device run's kernel launches, and no
   device -> host read of P == Q flags; then msm_hybrid (a device slice and
   the native host Pippenger on the tail, in a worker thread) on the same
   inputs and host mirrors, at its default device share and at 0.5, each
   equal to the native MSM, with its times, launches and the host's IFMA
   path;
4. the flagship prove: merkle-sum-tree depth 15, k = 11 (built as
   scripts/north_star.py builds it), proved twice with
   random.Random(7) and the commitments on the native host MSM, then once
   with commit="device" (the device MSM); every proof's bytes must equal
   tests/data/mst_d15_k11_rng7.proof (the reference's proof), the verifier
   must accept it and reject a tampered root; each prove's quotient phase
   and kernel launches; then one more native-commit prove under
   torch.profiler: its launches split by this package's kernels and by
   PyTorch's ops, and the device's busy time;
4b. the engines: the flagship on NativeEngine (create_proof(...,
   engine="native"), the native C++ host engine, no kernel launched) equals
   the fixture; at k = 13 (extended domain 2^17, .srs/pk_mst_d15_k13.pkl)
   the native and torch engines give equal proofs, which verify; what
   engine="auto" picks at k = 11 and k = 13;
5. the SRS setup on the card: ParamsKZG.setup(16) equals
   .srs/kzg_bn254_k16_s857536.pkl limb for limb;
6. keygen on the card: the flagship through keygen_vk then keygen_pk
   (native commits) and through keygen(..., commit="device"), each equal to
   .srs/pk_mst_d15_k11.pkl (digest, commitments, values, coefficients); a
   prove with the fresh pk equals the fixture and verifies; vk and pk times;
7. the MockProver on the card: the flagship valid and with a tampered root,
   the Poseidon experiment (Pasta Fp, width 5, k = 7) valid and tampered,
   and two of the reference's negative vectors (a ConstraintNotSatisfied
   and a Lookup failure); every card run's failures equal the same run on
   the CPU; verify times on the card and on the CPU;
8. the device Poseidon sponge: hash_device (MySpec(5, 4), L = 4, BN254 Fr)
   over 2^20 messages from random.Random, one level of a 2^21-leaf
   merkle-sum tree; its first 1024 lanes equal the plain versions on the
   CPU and 256 spread lanes equal the host poseidon_hash; hashes/s;
9. the sharded prover (halo2_tpu_torch.parallel, create_proof(mesh=)):
   vm_eval over row ranges of the flagship's quotient (the two halves, and
   two ranges that start inside a kernel block, where rotations wrap)
   equals its plain version and the full launch; (a) one rank on NCCL in
   this process, make_mesh(1): the flagship proof equals the fixture,
   verifies, and a tampered root fails; (b) two ranks on gloo, both on this
   card (NCCL takes one rank a device), make_mesh(2, dp=1) so that sp = 2
   and the NTT, the scan and the quotient exchange: on each rank the
   flagship equals the fixture, less_than_v2 at k = 9 (random.Random(13))
   equals the single-device proof and verifies, sharded_ntt at 2^15 and
   2^20 (both directions) equals the domain's NTT limb for limb,
   sharded_msm at 2^16 (phase 3's inputs) equals the native MSM, and
   grand_product_z at 2^11 equals the host recurrence; the warm proves'
   times at W = 1 and W = 2 beside the single-device ones (native and
   device commits) and their phases; the transport of every collective.
10. the graft entries (halo2_tpu_torch.graft_entry): entry() (the
   flagship at depth 5, k = 10, every gate constraint over its 2^10 rows
   in one vm_eval) gives no violation on the card, and with one planted
   advice cell the counts the same call gives on the CPU; its time per
   call and vm_eval's device time per launch beside the bound;
   dryrun_multichip(2) (two ranks on gloo, both on this card, mesh (1, 2))
   and, where more than one card is visible, dryrun_multichip(count) on
   NCCL: on every rank the sharded prove step's violations, iNTT, MSMs and
   z, and hash_v1 (k = 4) and overflow_check_v2 (k = 5, a lookup) through
   create_proof(mesh=) equal to the single-device proofs and verified;
   each check's seconds and launches per rank.

Phases 3-10 call the entry points without a device: they run on the card
by default (the ranks of phases 9 and 10 on their own card).  The device-commit paths of
phases 3-6 must read no P == Q flag back.  Every path of phases 3-10 runs
once with the launch counts set to 0
just before and read just after, and fails if a kernel it must launch was
not launched: mont_mul and the NTT kernels in the proves and the keygens,
vm_eval in every prove, jac_madd, jac_add and mod_sub (the MSM's signed
digits negate their points) in the device-commit prove and the
device-commit keygen, jac_madd and jac_add in the MSM and in every hybrid
MSM whose device share is above 0, none in a NativeEngine prove, mont_sqr, mont_mul and jac_add in the setup, vm_eval in every
MockProver run, mont_mul, mont_sqr and mod_add in the sponge, and in
phase 9 (each rank's counts set to 0 before each of its jobs and read
after) mont_mul, mont_sqr, mod_add, mod_sub, jac_madd, jac_add and vm_eval
in every sharded prove on every rank, both NTT kernels in the 2^20 sharded
NTTs, and jac_madd, jac_add and mont_sqr in the sharded MSM; in phase 10
vm_eval in entry() and every kernel of SHARDED_KERNELS in each dryrun
check on every rank.  The line
before the last is a JSON object with one entry per kernel (its launches
summed over those runs, its time at 2^15 beside its bound from this run's
inputs); the last
is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside the repository, the script fails before printing either.
"""

from __future__ import annotations

import json
import os
import random
import statistics
import subprocess
import sys
import time

from halo2_tpu_torch.parallel.jobs import read_launches, reset_launches

ROOT = os.path.dirname(os.path.abspath(__file__))
FIXTURE = os.path.join(ROOT, "tests", "data", "mst_d15_k11_rng7.proof")
PK_CACHE = os.path.join(ROOT, ".srs", "pk_mst_d15_k11.pkl")
SRS16 = os.path.join(ROOT, ".srs", "kzg_bn254_k16_s857536.pkl")
MUL_SIZES = (1, 511, 513, 1 << 11, 1 << 15, 1 << 20)
# the group-law widths: the suffix scans' 32 and 128 lanes (flagship) and
# 2,816 (2^16 MSM), the variant switch's 8,192 and 16,384
# (ec/cuda_jac.py:NARROW_MAX_LANES), the bucket rounds' 180,224 (2^16 MSM),
# and 2^20
JAC_SIZES = (1, 32, 128, 2816, 1 << 11, 1 << 13, 1 << 14, 1 << 15, 180224, 1 << 20)
TIMED_SIZES = (1 << 11, 1 << 15, 1 << 20)
# the coset NTT batch of the flagship prove: 20 advice, 11 fixed, 7 selector,
# 1 instance, 4 permutation z, 24 lookup and 16 sigma columns
FLAGSHIP_C = 83
# (columns, n) of the NTT kernels' checks, and those timed
NTT_CASES = tuple((c, n) for c in (1, 3, FLAGSHIP_C) for n in (1 << 11, 1 << 15)) + ((1, 1 << 9), (1, 1 << 20))
NTT_TIMED = tuple((1, n) for n in TIMED_SIZES) + ((FLAGSHIP_C, 1 << 15),)
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


def _kernel_device_ms(fn, symbol: str, bound_ms: float, calls: int = 20, tries: int = 3) -> float:
    """Device time of one launch of the kernel whose name contains ``symbol``:
    the median, over the launches that torch.profiler recorded in ``calls``
    calls of fn(), of each launch's own start-to-end interval on the card.
    A profile that recorded no launch, more than ``calls``, or a median below
    ``bound_ms`` (the least time the card could take, so not a time) is
    printed with every matching event and taken again; after ``tries`` such
    profiles it raises."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        launches = [
            e for e in prof.events() if symbol in e.name and e.device_type == torch.autograd.DeviceType.CUDA
        ]
        us = sorted(e.time_range.elapsed_us() for e in launches)
        self_us = sum(e.self_device_time_total for e in launches)  # what key_averages() sums
        if us and abs(self_us - sum(us)) > 0.05 * sum(us):
            print(
                f"[kernels] {symbol}: key_averages() would read {self_us / sum(us):.0%} of the launches' "
                f"intervals ({sum(e.is_async for e in launches)} of {len(us)} events marked async)",
                flush=True,
            )
        if 0 < len(us) <= calls and statistics.median(us) / 1e3 >= bound_ms:
            return statistics.median(us) / 1e3
        print(
            f"[kernels] profile {attempt} of {symbol} set aside: {len(us)} launches in {calls} calls, "
            f"bound {bound_ms:.6f} ms; events (name, async, us): "
            + "; ".join(f"{e.name[:60]}, {e.is_async}, {e.time_range.elapsed_us()}" for e in launches),
            flush=True,
        )
    raise AssertionError(f"{symbol}: no profile of {calls} calls gave a device time in {tries} tries")


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


def _timed(fn):
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0


def phase_build():
    """The CUDA kernels (nvcc) and the native host engine (g++), built at
    once: each build waits on its compiler processes."""
    from concurrent.futures import ThreadPoolExecutor

    from halo2_tpu_torch import _build, native

    with ThreadPoolExecutor(max_workers=1) as pool:
        host = pool.submit(_timed, native.available)
        _, dt = _timed(_build.lib)
        host_ok, host_dt = host.result()
    print(f"[build] CUDA kernels: {dt:.2f} s -> {_build.library_path().name}", flush=True)
    for line in _build.log_path().read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[build]   {line.strip()}", flush=True)
    for name, (total, wide, other) in _sass_counts(_build.library_path()).items():
        print(
            f"[build] SASS {name}: {total} instructions, {wide} IMAD.WIDE, {other} other IMAD "
            f"(IMAD.MOV not counted)",
            flush=True,
        )
    if not host_ok:
        raise RuntimeError("native host engine did not build (g++ missing?)")
    print(f"[build] native host engine: {host_dt:.2f} s (beside the CUDA build)", flush=True)


def _sass_counts(library) -> dict:
    """Static instruction counts of each curve kernel in the built library's
    SASS (``cuobjdump -sass``): (instructions, IMAD.WIDE, other IMADs but
    IMAD.MOV); empty when the toolkit has no cuobjdump."""
    from halo2_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        print("[build] SASS counts not measured: no cuobjdump beside nvcc", flush=True)
        return {}
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            name = next((k for k in ("jac_madd_wide", "jac_madd_narrow", "jac_add_wide", "jac_add_narrow") if k in fn), None)
            if name:
                counts[name] = [0, 0, 0]
        elif name and line.startswith("/*") and "*/" in line:
            ops = line.split("*/", 1)[1].split()
            if ops and ops[0].startswith("@"):
                ops = ops[1:]
            if not ops or ops[0].startswith("/*"):
                continue  # the second half of an instruction's encoding
            counts[name][0] += 1
            if ops[0].startswith("IMAD.WIDE"):
                counts[name][1] += 1
            elif ops[0].startswith("IMAD") and not ops[0].startswith("IMAD.MOV"):
                counts[name][2] += 1
    return {k: tuple(v) for k, v in counts.items()}


def _time_kernel(name, symbol, m, kernel, plain, times, bound_ms, plain_calls=3):
    """Time per call of kernel and plain version at m lanes, and the
    kernel's device time per launch; record and print them."""
    t_k = _ms_per_call(kernel, 50)
    t_p = _ms_per_call(plain, plain_calls, runs=3)
    t_d = _kernel_device_ms(kernel, symbol, bound_ms)
    times[(name, m)] = (t_k, t_p)
    print(
        f"[kernels] {name} m={m}: kernel {t_k:.4f} ms per call ({t_d:.4f} ms on the "
        f"device, {bound_ms / t_d:.0%} of the bound {bound_ms:.6f}), plain {t_p:.4f} ms per call",
        flush=True,
    )


def phase_kernels(device):
    """Every kernel against its plain version; returns per-kernel results."""
    import torch

    from halo2_tpu_torch.field.cuda_mul import mont_mul, mont_mul_plain, mont_sqr, mont_sqr_plain
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP

    gen = torch.Generator(device=device)
    gen.manual_seed(0x5EED)
    err = {name: 0.0 for name, _, _ in KERNELS}
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
                t_d = _kernel_device_ms(lambda: mont_mul(spec, a, b), "mont_mul_kernel", _bound(*_field_work(m)["mont_mul"])[0])
                times[("mont_mul", m)] = (t_k, t_p)
                print(
                    f"[kernels] mont_mul bn254_fr m={m}: kernel {t_k:.4f} ms per call "
                    f"({t_d:.4f} ms on the device), plain {t_p:.4f} ms per call",
                    flush=True,
                )
            e = _max_abs_err(f"mont_sqr {spec.name} m={m}", mont_sqr(spec, a), mont_sqr_plain(spec, a))
            err["mont_sqr"] = max(err["mont_sqr"], e)
            _max_abs_err(f"mont_sqr {spec.name} m={m} vs mont_mul", mont_sqr(spec, a), mont_mul(spec, a, a))
            if spec is BN254_FR and m in TIMED_SIZES:
                _time_kernel(
                    "mont_sqr", "mont_sqr_kernel", m, lambda: mont_sqr(spec, a),
                    lambda: mont_sqr_plain(spec, a), times, _bound(*_field_work(m)["mont_sqr"])[0],
                )
        print(f"[kernels] mont_mul, mont_sqr {spec.name}: equal to plain at m={list(MUL_SIZES)}", flush=True)

    _check_field_ops(device, gen, err, times)

    classes = _check_jac_kernels(device, err, times)

    _check_ntt_kernels(device, gen, err, times)

    vm_bound = _check_vm(device, gen, err, times)

    for n in TIMED_SIZES:
        bounds = _bounds(classes, n)
        print(
            f"[kernels] bounds at n={n} (ms, what bounds it): "
            + ", ".join(f"{k} {v[0]:.6f} {v[1]}" for k, v in bounds.items()),
            flush=True,
        )
    return err, times, {**_bounds(classes, REPORT_SIZE), "vm_eval": vm_bound}


def _check_field_ops(device, gen, err, times):
    """mod_add and mod_sub against their plain versions, limb for limb, for
    BN254 Fr, BN254 Fq and Pasta Fp at every MUL_SIZES width: the 16 pairs of
    edge values (0, 1, p - 1, p - 2) first, a broadcast element on the right
    (add, sub) and on the left (sub), and the negation (a subtract from a
    broadcast zero); for BN254 Fr at TIMED_SIZES the time per call of kernel
    and plain version and the kernel's device time per launch."""
    from halo2_tpu_torch.field import cuda_ops
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP

    for spec in (BN254_FR, BN254_FQ, PASTA_FP):
        p = spec.p
        edges = get_device_field(spec).encode([0, 1, p - 1, p - 2], device=device)
        for m in MUL_SIZES:
            a = _random_field(spec, (m,), gen, device)
            b = _random_field(spec, (m,), gen, device)
            k = min(16, m)
            a[:, :k] = edges.repeat_interleave(4, dim=1)[:, :k]
            b[:, :k] = edges.repeat(1, 4)[:, :k]
            col = _random_field(spec, (1,), gen, device)
            cases = [("mod_add", f"b={tag}", a, bb) for tag, bb in (("full", b), ("bcast", col), ("edge-bcast", edges[:, 2:3].contiguous()))]
            cases += [("mod_sub", f"b={tag}", a, bb) for tag, bb in (("full", b), ("bcast", col))]
            cases += [("mod_sub", f"a={tag}", aa, b) for tag, aa in (("bcast", col), ("edge-bcast", edges[:, 2:3].contiguous()))]
            for name, tag, x, y in cases:
                got = getattr(cuda_ops, name)(spec, x, y)
                want = getattr(cuda_ops, f"{name}_plain")(spec, x, y)
                err[name] = max(err[name], _max_abs_err(f"{name} {spec.name} m={m} {tag}", got, want))
            e = _max_abs_err(f"mod_neg {spec.name} m={m}", cuda_ops.mod_neg(spec, a), cuda_ops.mod_neg_plain(spec, a))
            err["mod_sub"] = max(err["mod_sub"], e)
            if spec is BN254_FR and m in TIMED_SIZES:
                for name in ("mod_add", "mod_sub"):
                    kernel, plain = getattr(cuda_ops, name), getattr(cuda_ops, f"{name}_plain")
                    _time_kernel(
                        name, f"{name}_kernel", m, lambda: kernel(spec, a, b), lambda: plain(spec, a, b),
                        times, _bound(*_field_work(m)[name])[0],
                    )
        print(
            f"[kernels] mod_add, mod_sub, mod_neg {spec.name}: equal to plain at m={list(MUL_SIZES)}, "
            f"edge pairs and broadcast elements included",
            flush=True,
        )


def _synthesized_cs(circuit, k, F):
    from halo2_tpu_torch.plonkish.assignment import run_synthesis

    cs, _cfg, _asn = run_synthesis(circuit.without_witnesses(), k, [], witness=False, field=F)
    return cs


def _vm_programs():
    """(label, Program, field spec, rows, stride-0 aux columns) for the VM
    checks: the flagship's combined quotient at its extended domain (2^15
    rows, rot_scale 16, so the 2042 rotation wraps to row shift 32,672; the
    challenges beta, gamma, theta and y as expanded views, as the prover
    hands them over), the Poseidon experiment's gates (Pasta Fp, k = 7), the
    less-than experiment's lookup expressions (Pasta Fp, k = 10; the
    Poseidon circuit has no lookup), the Poseidon gates again at 101 rows
    (a partial last block), a program with no instruction whose outputs
    are a bare query and a bare constant, two programs of 100 and 150
    live registers (100 x 32 bytes x 64 rows is 200 KB of shared memory a
    block, above the 48 KB a launch gets by default; 150 registers take
    the 32-row block), and a balanced tree of 256 products, which four
    streams would hold all live, so it runs on one."""
    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.field.params import BN254_FR, PASTA_FP
    from halo2_tpu_torch.kzg.keygen import AuxLayout, PlonkStructure
    from halo2_tpu_torch.plonkish.column import Column, ColumnKind, Rotation
    from halo2_tpu_torch.plonkish.evaluator import Program
    from halo2_tpu_torch.plonkish.expression import Constant, Query

    k = 11
    flagship, _public = _flagship_circuit()
    st = PlonkStructure(_synthesized_cs(flagship, k, Fr), k)
    vectors = {label: (kk, circuit, F) for label, kk, circuit, _inst, F, _kinds in _mock_vectors()}
    k_pos, poseidon, Fp = vectors["poseidon valid"]
    k_lt, less_than, _ = vectors["less_than not in table"]
    pcs, lcs = _synthesized_cs(poseidon, k_pos, Fp), _synthesized_cs(less_than, k_lt, Fp)
    query = Query(Column(ColumnKind.ADVICE, 0), Rotation(-1))
    challenges = (AuxLayout.BETA, AuxLayout.GAMMA, AuxLayout.THETA, AuxLayout.Y)
    return [
        ("flagship quotient", st.quotient_program(16), BN254_FR, (1 << k) * 16, challenges),
        ("poseidon gates", Program([c for g in pcs.gates for c in g.constraints]), PASTA_FP, 1 << k_pos, ()),
        ("poseidon gates, partial block", Program([c for g in pcs.gates for c in g.constraints]), PASTA_FP, 101, ()),
        ("less_than lookups", Program([e for lk in lcs.lookups for pair in lk.pairs for e in pair]), PASTA_FP, 1 << k_lt, ()),
        ("bare query and constant", Program([query, Constant(5)]), BN254_FR, 1 << k, ()),
        ("100 live registers", Program([query * Constant(i + 2) for i in range(100)]), BN254_FR, 1 << k, ()),
        ("150 live registers", Program([query * Constant(i + 2) for i in range(150)]), PASTA_FP, 1000, ()),
        ("product tree", Program([_product_tree(query, 0, 256)]), BN254_FR, 1 << k, ()),
    ]


def _product_tree(query, lo, hi):
    """query^(hi - lo) times the constants lo + 2 .. hi + 1, a balanced tree."""
    from halo2_tpu_torch.plonkish.expression import Constant

    if hi - lo == 1:
        return query * Constant(lo + 2)
    return _product_tree(query, lo, (lo + hi) // 2) * _product_tree(query, (lo + hi) // 2, hi)


def _vm_columns(prog, spec, n, gen, device, stride0):
    """kind -> random canonical columns for every queried kind: the views of
    one (C, 16, n) batch, as the prover's coset batch and the MockProver's
    encoded columns are; the aux columns in ``stride0`` one element expanded
    to (16, n)."""
    counts = {}
    for kind, ci, _rot in prog.queries:
        counts[kind] = max(counts.get(kind, 0), ci + 1)
    cols = {}
    for kind, c in counts.items():
        batch = list(_random_field(spec, (c, n), gen, device).transpose(0, 1).contiguous().unbind(0))
        if kind == "aux":
            for ci in stride0:
                if ci < c:
                    batch[ci] = _random_field(spec, (1,), gen, device).expand(16, n)
        cols[kind] = batch
    return cols


def _vm_work(prog, queries, n: int, n_consts: int) -> tuple:
    """(bytes, IMADs) of one VM launch over n rows: each distinct full-width
    column read once, each broadcast element and constant once, each output
    written once; 272 IMADs a product and row.  The scratch registers are the
    design's own cost, not counted."""
    full, one = set(), set()
    for t in queries:
        t = t.expand(16, n)
        (full if t.stride(1) else one).add((t.data_ptr(), t.stride(0)))
    products = sum(op == 1 for op, _a, _b in prog.instrs)
    nbytes = (len(full) + len(prog.output_slots())) * ELEM * n + (len(one) + n_consts) * ELEM
    return nbytes, IMAD_MUL * products * n


def _check_vm(device, gen, err, times):
    """vm_eval against vm_eval_plain on the card, limb for limb, for every
    _vm_programs case; at the flagship the kernel's device time per launch,
    time per call and the plain version's, with the share of the bound.
    Returns the flagship's bound (ms, what bounds it)."""
    from halo2_tpu_torch.plonkish import cuda_vm

    flagship_bound = None
    for label, prog, spec, n, stride0 in _vm_programs():
        cols = _vm_columns(prog, spec, n, gen, device, stride0)
        table = cuda_vm.compile_program(prog, spec)
        queries = [cols[kind][ci] for kind, ci, _rot in prog.queries]
        consts = table.consts_on(device)
        kernel = lambda: cuda_vm.vm_eval(table, queries, consts, n)  # noqa: E731
        plain = lambda: cuda_vm.vm_eval_plain(table, queries, consts, n)  # noqa: E731
        err["vm_eval"] = max(err["vm_eval"], _max_abs_err(f"vm_eval {label}", kernel(), plain()))
        ops = {name: sum(op == code for op, _a, _b in prog.instrs) for code, name in enumerate(("add", "mul", "neg"))}
        rows, smem = cuda_vm.rows_per_block(table.num_regs)
        print(
            f"[kernels] vm_eval {label} ({spec.name}, n={n}, {len(prog.queries)} queries, "
            f"{len(prog.consts)} constants, {len(prog.instrs)} instructions {ops}, {table.num_regs} registers, "
            f"{len(table.outputs)} outputs; {table.streams} streams, {table.phases} phases, {rows} rows a "
            f"block, {smem} bytes of shared memory a block): equal to plain",
            flush=True,
        )
        if label == "flagship quotient":
            flagship_bound = _bound(*_vm_work(prog, queries, n, len(prog.consts)))
            rot = sorted({r * prog.rot_scale % n for _k, _c, r in prog.queries})
            print(f"[kernels] vm_eval flagship row shifts {rot}, bound {flagship_bound[0]:.6f} ms ({flagship_bound[1]})", flush=True)
            _time_kernel("vm_eval", "vm_eval_kernel", n, kernel, plain, times, flagship_bound[0], plain_calls=1)
    return flagship_bound


def _large_ladder(spec, x, tw, fn=None, fused: bool = True):
    """The large stages of one transform through ``fn`` (default the
    kernel's wrapper): every pass of large_stage_plan(n), or with ``fused``
    False every stage in a launch of its own."""
    from halo2_tpu_torch.poly import cuda_ntt

    fn = fn or cuda_ntt.ntt_large_stage
    for m0, stages in cuda_ntt.large_stage_plan(x.shape[-1]):
        for m, r in [(m0, stages)] if fused else [(m0 << i, 1) for i in range(stages)]:
            x = fn(spec, x, tw, m, r)
    return x


def _check_ntt_kernels(device, gen, err, times):
    """Both NTT stage kernels against their plain versions, limb for limb,
    for BN254 Fr (the kernels' carry-chain arithmetic) and Pasta Fp (the
    64-bit-accumulator one), forward and inverse, at every NTT_CASES batch:
    the small stages, then every large stage of the ladder on its own
    (stages=1), then every pass of large_stage_plan(n) (several stages a
    launch); the batched iNTT(NTT(x)) == x.  Then the device time per
    launch and per column of each kernel at NTT_TIMED, the large stages as
    every pass of the plan, with its share of the bound for the batch, and
    the time per call of kernel and plain version at 2^11, 2^15 and 2^20
    for one column (the large stages: the whole plan)."""
    import torch

    from halo2_tpu_torch.field.params import BN254_FR, PASTA_FP
    from halo2_tpu_torch.poly import cuda_ntt
    from halo2_tpu_torch.poly.domain import _ntt_raw, twiddle_table

    batches = {}
    for spec in (BN254_FR, PASTA_FP):
        for cols, n in NTT_CASES:
            x = _random_field(spec, (n,), gen, device) if cols == 1 else (
                _random_field(spec, (cols, n), gen, device).transpose(0, 1).contiguous()
            )
            label = f"{spec.name} C={cols} n={n}"
            plan = cuda_ntt.large_stage_plan(n)
            for inverse in (False, True):
                tw = twiddle_table(spec, n, inverse, device)
                want = cuda_ntt.ntt_small_stages_plain(spec, x, tw)
                got = cuda_ntt.ntt_small_stages(spec, x, tw)
                e = _max_abs_err(f"ntt_small_stages {label} inv={inverse}", got, want)
                err["ntt_small_stages"] = max(err["ntt_small_stages"], e)
                for fused in (False, True):
                    def step(sp, y, t, m, r):
                        got = cuda_ntt.ntt_large_stage(sp, y, t, m, r)
                        e = _max_abs_err(
                            f"ntt_large_stage {label} m={m} stages={r} inv={inverse}", got,
                            cuda_ntt.ntt_large_stage_plain(sp, y, t, m, r),
                        )
                        err["ntt_large_stage"] = max(err["ntt_large_stage"], e)
                        return got

                    _large_ladder(spec, want, tw, step, fused)
            if not torch.equal(_ntt_raw(spec, n, True)(_ntt_raw(spec, n, False)(x)), x):
                raise AssertionError(f"iNTT(NTT(x)) != x for {label}")
            if (cols, n) in NTT_TIMED:
                batches[(spec, cols, n)] = x
            print(
                f"[kernels] ntt {label}: both kernels equal to plain (the large stages one at a time and "
                f"as the passes {plan}), iNTT(NTT(x)) == x",
                flush=True,
            )

    for (spec, cols, n), x in batches.items():
        tw = twiddle_table(spec, n, False, device)
        small_bound = _ntt_bounds(n, cols)["ntt_small_stages"]
        call = lambda: cuda_ntt.ntt_small_stages(spec, x, tw)  # noqa: E731
        t_d = _kernel_device_ms(call, "ntt_small_stages_kernel", small_bound[0])
        times[("ntt_small_stages", spec.name, cols, n)] = t_d
        parts = [
            f"ntt_small_stages {t_d:.4f} ms a launch, {t_d / cols:.5f} a column, {small_bound[0] / t_d:.0%} "
            f"of the bound {small_bound[0]:.6f}"
        ]
        if cols == FLAGSHIP_C:  # a check on the profiler: launch gaps are small beside 0.1-0.4 ms
            parts.append(f"ntt_small_stages {_ms_per_call(call, 20):.4f} ms a call (CUDA events)")
        ladder = 0.0
        for m0, stages in cuda_ntt.large_stage_plan(n):
            bound = _bound(*_ntt_work(n, cols, m0, stages))
            call = lambda: cuda_ntt.ntt_large_stage(spec, x, tw, m0, stages)  # noqa: E731
            t_d = _kernel_device_ms(call, "ntt_large_stage_kernel", bound[0])
            ladder += t_d
            parts.append(
                f"ntt_large_stage m0={m0} stages={stages} {t_d:.4f} ms a launch, {t_d / cols:.5f} a column, "
                f"{bound[0] / t_d:.0%} of the bound {bound[0]:.6f} ({bound[1]})"
            )
        times[("ntt_large_stage", spec.name, cols, n)] = ladder
        large_bound = _ntt_bounds(n, cols)["ntt_large_stage"]
        parts.append(f"the large stages {ladder:.4f} ms, {large_bound[0] / ladder:.0%} of {large_bound[0]:.6f}")
        if cols == FLAGSHIP_C or n == TIMED_SIZES[-1]:  # the plan against one launch a stage, CUDA events
            fused = _ms_per_call(lambda: _large_ladder(spec, x, tw), 20)
            alone = _ms_per_call(lambda: _large_ladder(spec, x, tw, fused=False), 20)
            parts.append(
                f"the large stages as the plan's passes {fused:.4f} ms a call, one launch a stage {alone:.4f} "
                f"(CUDA events)"
            )
        print(f"[kernels] ntt {spec.name} C={cols} n={n} on the device: " + "; ".join(parts), flush=True)

    spec = BN254_FR
    for n in TIMED_SIZES:
        x = batches[(spec, 1, n)]
        tw = twiddle_table(spec, n, False, device)
        small = lambda: cuda_ntt.ntt_small_stages(spec, x, tw)  # noqa: E731
        large = lambda: _large_ladder(spec, x, tw)  # noqa: E731
        t_sk, t_lk = _ms_per_call(small, 50), _ms_per_call(large, 50)
        t_sp = _ms_per_call(lambda: cuda_ntt.ntt_small_stages_plain(spec, x, tw), 2, runs=3)
        t_lp = _ms_per_call(lambda: _large_ladder(spec, x, tw, cuda_ntt.ntt_large_stage_plain), 2, runs=3)
        t_full = _ms_per_call(lambda: _ntt_raw(spec, n, False)(x), 10)
        times[("ntt_small_stages", n)] = (t_sk, t_sp)
        times[("ntt_large_stage", n)] = (t_lk, t_lp)
        print(
            f"[kernels] ntt {spec.name} n={n}: small stages kernel {t_sk:.4f} ms per call, plain "
            f"{t_sp:.4f} ms per call; large stages (passes {cuda_ntt.large_stage_plan(n)}) kernel {t_lk:.4f} "
            f"ms per call, plain {t_lp:.4f} ms per call; forward NTT through the kernels {t_full:.4f} ms per call",
            flush=True,
        )


def _curve_lanes(device, m, exceptions=True):
    """BN254 G1 operands for the group-law kernels at m lanes: p Jacobian
    with z != 1, q affine (mixed add) and Jacobian with z != 1 (full add),
    from the k = 16 SRS's points.  With ``exceptions``, lanes 0-4 are the
    exception lanes: P == Q, P == -Q, P at infinity, Q at infinity (a (0, 0)
    masked lane of the mixed add), and a masked mixed-add lane."""
    import numpy as np
    import torch

    from halo2_tpu_torch.ec import device as ecd
    from halo2_tpu_torch.kzg.params import ParamsKZG

    srs = ParamsKZG.load(SRS16)
    n = srs.n
    reps = -(-(m + n) // n)
    x, y = (
        torch.from_numpy(np.tile(a, (1, reps)).view(np.int32)).to(device) for a in (srs.g1_x, srs.g1_y)
    )
    p = ecd.jac_double(ecd.jac_from_affine(x[:, :m].contiguous(), y[:, :m].contiguous()))
    qx, qy = x[:, n - 1 : n - 1 + m].contiguous(), y[:, n - 1 : n - 1 + m].contiguous()
    q = ecd.jac_double(ecd.jac_from_affine(qx, qy))
    valid = torch.ones(m, dtype=torch.bool, device=device)
    if not exceptions:
        return p, q, qx, qy, valid
    front = min(2, m)
    ax, ay = ecd.jac_to_affine({k: v[:, :front].contiguous() for k, v in p.items()})
    ay = torch.stack([ay[:, 0], ecd.df().neg(ay)[:, -1]], dim=1)  # lane 0: P, lane 1: -P
    for i in range(front):  # q as an affine point (z = 1)
        qx[:, i], qy[:, i] = ax[:, i], ay[:, i]
        q["x"][:, i], q["y"][:, i], q["z"][:, i] = ax[:, i], ay[:, i], ecd.df().one_mont((), device=device)
    inf = ecd.jac_infinity((), device=device)
    if m > 2:
        for k in p:
            p[k][:, 2] = inf[k]
    if m > 3:
        for k in q:
            q[k][:, 3] = inf[k]
        qx[:, 3], qy[:, 3], valid[3] = 0, 0, False
    if m > 4:
        valid[4] = False
    return p, q, qx, qy, valid


def _check_jac_kernels(device, err, times):
    """jac_madd and jac_add, every variant, against their plain versions
    (the P == Q doubling included), limb for limb, at every JAC_SIZES width,
    with the exception lanes first; the device time per launch of each
    variant at each width of 32 lanes or more, on operands without the
    exception lanes (what the MSM's scans give them).  Returns the lane
    classes of the operands at each TIMED_SIZES width, for the bounds."""
    from halo2_tpu_torch.ec import cuda_jac

    classes = {}
    for m in JAC_SIZES:
        p, q, qx, qy, valid = _curve_lanes(device, m)
        gp, gq, gqx, gqy, gvalid = _curve_lanes(device, m, exceptions=False)
        general_bound = _jac_bounds({"jac_madd": (m, 0), "jac_add": (m, 0)}, m)
        if m in TIMED_SIZES:
            classes[m] = _lane_classes(p, q, qx, qy, valid)
        cases = (
            ("jac_madd", lambda w: cuda_jac._jac_madd(p, qx, qy, valid, w),
             lambda: cuda_jac.jac_madd_plain(p, qx, qy, valid),
             lambda w: cuda_jac._jac_madd(gp, gqx, gqy, gvalid, w)),
            ("jac_add", lambda w: cuda_jac._jac_add(p, q, w), lambda: cuda_jac.jac_add_plain(p, q),
             lambda w: cuda_jac._jac_add(gp, gq, w)),
        )
        for name, kernel, plain, general in cases:
            want = plain()
            for which in cuda_jac.VARIANTS:
                with _FlagReads() as flags:
                    got = kernel(which)
                if flags.reads:
                    raise AssertionError(f"{name} m={m} {which}: {flags.reads} P == Q flag reads")
                for k in ("x", "y", "z"):
                    err[name] = max(err[name], _max_abs_err(f"{name} m={m} {which} {k}", got[k], want[k]))
                if m >= 32:
                    t_d = _kernel_device_ms(lambda: general(which), f"{name}_{which}_kernel", general_bound[name][0])
                    times[(name, which, m)] = t_d
                    print(f"[kernels] {name} m={m} {which}: {t_d:.4f} ms on the device (general lanes)", flush=True)
            if m in TIMED_SIZES:
                bound = _jac_bounds(classes[m], m)[name][0]
                _time_kernel(name, f"{name}_", m, lambda: kernel(None), plain, times, bound, plain_calls=2)
        print(
            f"[kernels] jac_madd, jac_add m={m}: every variant equal to plain, P == Q doubling "
            f"included, no flag reads (default variant {cuda_jac.variant(m)})",
            flush=True,
        )
    return classes


def _lane_classes(p, q, qx, qy, valid) -> dict:
    """The lanes of the group-law operands by the work their formulas need:
    finite sums (madd: valid, P finite; add: both finite) and P == Q lanes,
    from the plain versions' flags."""
    from halo2_tpu_torch.ec import cuda_jac
    from halo2_tpu_torch.ec import device as ecd

    _, same_madd = cuda_jac.jac_madd_flagged_plain(p, qx, qy, valid)
    _, same_add = cuda_jac.jac_add_flagged_plain(p, q)
    p_fin, q_fin = ~ecd.is_infinity(p), ~ecd.is_infinity(q)
    return {
        "jac_madd": (int((valid & p_fin).sum()), int(same_madd.sum())),
        "jac_add": (int((p_fin & q_fin).sum()), int(same_add.sum())),
    }


# IMADs of one Montgomery product and one square on 8 x 32-bit words (64
# 32x32->64 products of two IMADs each, plus the reduction's; the square
# shares its 28 cross products), the integer rate of one H100 (132 SMs x 64
# IMAD lanes x 1.98 GHz, half its published 67 TFLOP/s float32 rate) and its
# published memory rate.
IMAD_MUL, IMAD_SQR = 272, 216
IMAD_PER_S = 132 * 64 * 1.98e9
BYTES_PER_S = 3.35e12
ELEM = 64  # bytes of one (16,) int32 field element


def _bounds(classes: dict, n: int) -> dict:
    """Least time (ms) and what bounds it, per kernel, for the work of this
    run's calls at n elements or lanes (NTT: n elements, the large stages as
    the passes of large_stage_plan(n)): each input read once, each output written once, against
    the IMADs of the products that the inputs need."""
    return {
        **{name: _bound(*w) for name, w in _field_work(n).items()},
        **_ntt_bounds(n, 1),
        **_jac_bounds(classes[n], n),
    }


def _bound(nbytes: int, imads: int) -> tuple:
    t_bytes, t_ops = nbytes / BYTES_PER_S * 1e3, imads / IMAD_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _field_work(n: int) -> dict:
    """(bytes, IMADs) of one mont_mul (full-width b), one mont_sqr and one
    mod_add or mod_sub (full-width operands, no product) over n elements."""
    return {
        "mont_mul": (3 * ELEM * n, IMAD_MUL * n),
        "mont_sqr": (2 * ELEM * n, IMAD_SQR * n),
        "mod_add": (3 * ELEM * n, 0),
        "mod_sub": (3 * ELEM * n, 0),
    }


def _jac_bounds(classes: dict, m: int) -> dict:
    """Bounds of jac_madd and jac_add over m lanes whose work ``classes``
    gives per kernel as (finite sums, P == Q doublings)."""
    dbl = 2 * IMAD_MUL + 5 * IMAD_SQR  # dbl-2009-l
    return {
        "jac_madd": _bound(
            (5 * ELEM + 4 + 3 * ELEM) * m,
            (7 * IMAD_MUL + 4 * IMAD_SQR) * classes["jac_madd"][0] + dbl * classes["jac_madd"][1],
        ),
        "jac_add": _bound(
            9 * ELEM * m,
            (12 * IMAD_MUL + 4 * IMAD_SQR) * classes["jac_add"][0] + dbl * classes["jac_add"][1],
        ),
    }


def _stage_products(n: int, m: int) -> int:
    """Montgomery products of one butterfly stage with half-size m over n
    elements that the transform needs: n / 2m blocks of m butterflies, all
    but the one whose twiddle is w^0 = 1."""
    return n // (2 * m) * (m - 1)


def _ntt_work(n: int, cols: int, m0: int, stages: int) -> tuple:
    """(bytes, IMADs) of one ntt_large_stage launch over ``cols`` columns of
    n elements, the stages m0 .. m0 2^(stages - 1): each element read and
    written once, each twiddle the stages read (stage m: m of them, columns
    m - 1 .. 2m - 2 of the table) read once for the batch."""
    ms = [m0 << s for s in range(stages)]
    return 2 * ELEM * n * cols + ELEM * sum(ms), IMAD_MUL * sum(_stage_products(n, m) for m in ms) * cols


def _ntt_bounds(n: int, cols: int) -> dict:
    """The bound of each NTT kernel's work in one transform of ``cols``
    columns of n elements: one small-stages launch (the 511 twiddles of m =
    1 .. 256 read once), and the large stages as the launches of
    large_stage_plan(n), their bounds summed (bounded by what bounds the
    larger part of the sum)."""
    from halo2_tpu_torch.poly import cuda_ntt

    small = sum(_stage_products(n, 1 << lm) for lm in range(1, 9))  # m = 2 .. 256; m = 1 has none
    passes = [_bound(*_ntt_work(n, cols, m0, r)) for m0, r in cuda_ntt.large_stage_plan(n)]
    by_ops = sum(t for t, by in passes if by == "operations")
    return {
        "ntt_small_stages": _bound(2 * ELEM * n * cols + ELEM * 511, IMAD_MUL * small * cols),
        "ntt_large_stage": (
            sum(t for t, _ in passes), "operations" if 2 * by_ops > sum(t for t, _ in passes) else "bytes"
        ),
    }


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


def _require(path: str, counts: dict, names) -> None:
    missing = [name for name in names if counts[name] == 0]
    if missing:
        raise AssertionError(f"{path}: kernels not launched: {missing}")


class _FlagReads:
    """Counts the group ops' device -> host reads of their P == Q flags: one
    per call of a plain version's ``_double_fixup``.  The kernels double on
    the card, so the CUDA path makes none."""

    def __enter__(self):
        from halo2_tpu_torch.ec import cuda_jac

        self.module, self.orig = cuda_jac, cuda_jac._double_fixup
        self.reads = 0

        def counted(*args):
            self.reads += 1
            return self.orig(*args)

        cuda_jac._double_fixup = counted
        return self

    def __exit__(self, *exc):
        self.module._double_fixup = self.orig


def _no_flag_reads(path: str, flags: _FlagReads) -> None:
    if flags.reads:
        raise AssertionError(f"{path}: {flags.reads} P == Q flag reads on the CUDA path")


def phase_msm(device):
    """msm_points at 2^16 and 2^20 (bench.py's inputs) against the native
    host MSM; returns the launch counts of each size's first run."""
    import numpy as np
    import torch

    from halo2_tpu_torch import native
    from halo2_tpu_torch.ec import device as ecd
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FR
    from halo2_tpu_torch.kzg.params import ParamsKZG

    srs = ParamsKZG.load(SRS16)
    n = srs.n
    dfr = get_device_field(BN254_FR)
    rng = random.Random(42)
    sc16 = dfr.encode_np([rng.randrange(BN254_FR.p) for _ in range(n)], to_mont=False)
    rng = random.Random(9)
    sc20 = np.tile(dfr.encode_np([rng.randrange(BN254_FR.p) for _ in range(n)], to_mont=False), (1, 16))
    cases = (
        ("2^16", srs.g1_x, srs.g1_y, sc16),
        ("2^20", np.tile(srs.g1_x, (1, 16)), np.tile(srs.g1_y, (1, 16)), sc20),
    )
    runs = []
    for label, px, py, sc in cases:
        args = [torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(device) for a in (px, py, sc)]
        packed = [native.pack_device(a) for a in (px, py, sc)]
        reset_launches()
        torch.cuda.synchronize(device)
        with _FlagReads() as flags:
            t0 = time.perf_counter()
            got = ecd.msm_points(*args)
            first = time.perf_counter() - t0
        counts = read_launches()
        want = native.msm_g1_mont(*packed)
        if got != want or got == (0, 0):
            raise AssertionError(f"MSM {label}: device {got} != native {want}")
        _no_flag_reads(f"MSM {label}", flags)
        _require(f"MSM {label}", counts, ("jac_madd", "jac_add"))
        runs.append(counts)
        t_dev, t_nat = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            ecd.msm_points(*args)
            t_dev.append(time.perf_counter() - t0)
        native.msm_g1_mont(*packed)
        for _ in range(3):
            t0 = time.perf_counter()
            native.msm_g1_mont(*packed)
            t_nat.append(time.perf_counter() - t0)
        dev, nat = statistics.median(t_dev), statistics.median(t_nat)
        points = px.shape[1]
        print(
            f"[msm] {label}: equal to native; device {dev * 1e3:.1f} ms ({points / dev:.4g} points/s, "
            f"first run {first * 1e3:.1f} ms, runs {[round(t * 1e3, 1) for t in t_dev]}), native "
            f"{nat * 1e3:.1f} ms ({points / nat:.4g} points/s, runs {[round(t * 1e3, 1) for t in t_nat]}); "
            f"first run: launches {counts}, P == Q flag reads {flags.reads}",
            flush=True,
        )
        runs += _check_hybrid(label, device, args, (px, py, sc), want)
    return runs


def _check_hybrid(label, device, args, host, want) -> list:
    """msm_hybrid at its default device share and at 0.5 against the native
    MSM ``want``; returns the launch counts of each first run."""
    import numpy as np
    import torch

    from halo2_tpu_torch import native
    from halo2_tpu_torch.ec import device as ecd

    points = host[0].shape[1]
    one = [native.pack_device(np.ascontiguousarray(a[:, :1])) for a in host[:2]]
    ifma = "IFMA (msm_g1_mont52)" if native.points_to52(*one) is not None else "64-bit (msm_g1_mont)"
    runs = []
    for frac in (None, 0.5):
        share = ecd._hybrid_device_frac(points) if frac is None else frac
        reset_launches()
        _sync(device)
        with _FlagReads() as flags:
            t0 = time.perf_counter()
            pt = ecd.msm_hybrid(*args, *host, device_frac=frac)
            got = ecd.jac_host_affine(pt)
            first = time.perf_counter() - t0
        counts = read_launches()
        if got != want:
            raise AssertionError(f"hybrid MSM {label} at device share {share}: {got} != native {want}")
        _no_flag_reads(f"hybrid MSM {label}", flags)
        if share > 0:
            _require(f"hybrid MSM {label} at device share {share}", counts, ("jac_madd", "jac_add"))
        runs.append(counts)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            ecd.msm_hybrid(*args, *host, device_frac=frac)["x"].cpu()
            ts.append(time.perf_counter() - t0)
        med = statistics.median(ts)
        print(
            f"[msm] hybrid {label} at device share {share} ({'default' if frac is None else 'given'}): equal "
            f"to native; {med * 1e3:.1f} ms ({points / med:.4g} points/s, runs "
            f"{[round(t * 1e3, 1) for t in ts]}, first {first * 1e3:.1f} ms); host tail {ifma}; launches {counts}",
            flush=True,
        )
    return runs


def _prove(params, pk, circuit, public, want, device, commit, reps):
    """Prove ``reps`` times; every proof must equal ``want``.  Returns the
    last proof and the launch counts of the first prove."""
    import torch

    from halo2_tpu_torch.kzg import create_proof
    from halo2_tpu_torch.kzg.prover import PHASE_TIMINGS

    launches = None
    for rep in range(reps):
        reset_launches()
        PHASE_TIMINGS.clear()
        torch.cuda.synchronize(device)
        with _FlagReads() as flags:
            t0 = time.perf_counter()
            proof = create_proof(params, pk, circuit, [list(public)], rng=random.Random(7), commit=commit)
            torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
        counts = read_launches()
        _no_flag_reads(f"commit={commit} prove", flags)
        if launches is None:
            launches = counts
        phases = ", ".join(f"{k_}={v:.3f}" for k_, v in PHASE_TIMINGS.items())
        ntt = counts["ntt_small_stages"] + counts["ntt_large_stage"]
        print(
            f"[prove] commit={commit} rep {rep}: {dt:.3f} s, quotient phase {PHASE_TIMINGS['quotient']:.3f} s, "
            f"{len(proof)} bytes, NTT launches {ntt}, kernel launches {counts}; phases (s): {phases}",
            flush=True,
        )
        if proof != want:
            raise AssertionError(f"commit={commit} rep {rep}: proof differs from the reference proof in {FIXTURE}")
    return proof, launches


def profile_prove(device, params=None, pk=None, warm: int = 1) -> None:
    """One native-commit flagship prove under torch.profiler, after ``warm``
    proves: its device launches, split into this package's kernels (by
    kernel) and PyTorch's own ops (by op), copies, the device's busy time
    (the launches' intervals summed) against the wall, and the phase times.
    It uses only the port's entry points, so it also profiles an older
    checkout of the port: run it from that checkout's root with this file
    loaded by path, as scripts/torch_compare.sh does."""
    import collections

    import torch
    from torch.profiler import ProfilerActivity, profile

    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import ParamsKZG, ProvingKey, create_proof
    from halo2_tpu_torch.kzg.prover import PHASE_TIMINGS

    circuit, public = _flagship_circuit()
    if params is None:
        params = ParamsKZG.setup_cached(11)
        pk = ProvingKey.load(PK_CACHE, circuit, 11, Fr)
    with open(FIXTURE, "rb") as f:
        want = f.read()
    prove = lambda: create_proof(params, pk, circuit, [list(public)], rng=random.Random(7))  # noqa: E731
    for _ in range(warm):
        prove()
    torch.cuda.synchronize(device)
    PHASE_TIMINGS.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        proof = prove()
        torch.cuda.synchronize(device)
        wall = (time.perf_counter() - t0) * 1e3
    if proof != want:
        raise AssertionError(f"the profiled prove differs from {FIXTURE}")
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    copies = [e for e in events if e.name.startswith(("Memcpy", "Memset"))]
    kernels = [e for e in events if not e.name.startswith(("Memcpy", "Memset"))]
    ours = collections.Counter()
    torch_ops = collections.Counter()
    us = collections.Counter()
    for e in kernels:
        # each of this package's kernel symbols holds its name and an underscore
        name = next((k for k, _, _ in KERNELS if f"{k}_" in e.name), None)
        (ours if name else torch_ops)[name or e.name[:70]] += 1
        us[name or e.name[:70]] += e.time_range.elapsed_us()
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    n_ours = sum(ours.values())
    print(
        f"[profile] native-commit prove after {warm} warm-up: {wall:.1f} ms wall under the profiler; "
        f"{len(kernels)} kernel launches ({n_ours} of this package's kernels, {len(kernels) - n_ours} "
        f"PyTorch ops) and {len(copies)} copies/sets; device busy {busy:.2f} ms ({busy / wall:.2%} of "
        f"the wall); phases (s): " + ", ".join(f"{k}={v:.3f}" for k, v in PHASE_TIMINGS.items()),
        flush=True,
    )
    print(
        "[profile]   kernels (launches, device ms): "
        + "; ".join(f"{k} {n} {us[k] / 1e3:.3f}" for k, n in ours.most_common()),
        flush=True,
    )
    print(
        "[profile]   PyTorch ops, top 12 (launches, device ms): "
        + "; ".join(f"{k} {n} {us[k] / 1e3:.3f}" for k, n in torch_ops.most_common(12)),
        flush=True,
    )


def time_proves(device, reps: int = 5) -> list:
    """Wall times (s) of ``reps`` warm native-commit flagship proves after
    one warm-up, each ending in a synchronize and equal to the fixture.  It
    uses only the port's entry points, so it also times an older checkout of
    the port (scripts/torch_compare.sh), as profile_prove does."""
    import torch

    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import ParamsKZG, ProvingKey, create_proof

    circuit, public = _flagship_circuit()
    params = ParamsKZG.setup_cached(11)
    pk = ProvingKey.load(PK_CACHE, circuit, 11, Fr)
    with open(FIXTURE, "rb") as f:
        want = f.read()
    times = []
    for rep in range(reps + 1):
        torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        proof = create_proof(params, pk, circuit, [list(public)], rng=random.Random(7))
        torch.cuda.synchronize(device)
        if proof != want:
            raise AssertionError(f"prove {rep} differs from {FIXTURE}")
        if rep:
            times.append(time.perf_counter() - t0)
    print(
        f"[proves] {reps} warm native-commit proves (s): {[round(t, 3) for t in times]}; "
        f"median {statistics.median(times):.3f}",
        flush=True,
    )
    return times


def phase_prove(device):
    """The flagship, native commits then device commits; returns the launch
    counts of each first prove."""
    import torch

    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import ParamsKZG, ProvingKey, verify_proof

    k = 11
    circuit, public = _flagship_circuit()
    t0 = time.perf_counter()
    params = ParamsKZG.setup_cached(k)
    pk = ProvingKey.load(PK_CACHE, circuit, k, Fr)
    print(f"[prove] SRS + pk loaded in {time.perf_counter() - t0:.3f} s", flush=True)
    with open(FIXTURE, "rb") as f:
        want = f.read()

    torch.cuda.reset_peak_memory_stats(device)
    proof, native_counts = _prove(params, pk, circuit, public, want, device, "native", 2)
    _require("native-commit prove", native_counts, ("mont_mul", "ntt_small_stages", "ntt_large_stage", "vm_eval"))
    _, device_counts = _prove(params, pk, circuit, public, want, device, "device", 1)
    _require(
        "device-commit prove", device_counts,
        ("mont_mul", "ntt_small_stages", "ntt_large_stage", "jac_madd", "jac_add", "vm_eval", "mod_sub"),
    )
    print(f"[prove] peak device memory {torch.cuda.max_memory_allocated(device) / 2**20:.1f} MiB", flush=True)
    profile_prove(device, params, pk)

    t0 = time.perf_counter()
    ok = verify_proof(params.verifier_params(), pk.vk, proof, [list(public)])
    print(f"[prove] verify: {ok} in {time.perf_counter() - t0:.3f} s", flush=True)
    if not ok:
        raise AssertionError("the verifier rejected the port's proof")
    bad = list(public)
    bad[2] = bad[2] + Fr.from_u64(1)
    if verify_proof(params.verifier_params(), pk.vk, proof, [bad]):
        raise AssertionError("the verifier accepted a tampered root")
    print("[prove] proofs equal the reference fixture; tampered root rejected", flush=True)
    return [native_counts, device_counts]


def phase_engines(device):
    """The flagship on NativeEngine against the fixture, the k = 13 proofs of
    both engines against each other, and engine="auto"'s picks; returns the
    launch counts of each prove."""
    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import ParamsKZG, ProvingKey, create_proof, verify_proof
    from halo2_tpu_torch.kzg.engine import DEVICE_MIN_EXT, select_engine

    circuit, public = _flagship_circuit()
    with open(FIXTURE, "rb") as f:
        fixture = f.read()
    runs = []
    for k, engines in ((11, ("native",)), (13, ("native", "torch"))):
        params = ParamsKZG.setup_cached(k)
        pk = ProvingKey.load(os.path.join(ROOT, ".srs", f"pk_mst_d15_k{k}.pkl"), circuit, k, Fr)
        proofs = {}
        for engine in engines:
            reset_launches()
            _sync(device)
            t0 = time.perf_counter()
            proofs[engine] = create_proof(params, pk, circuit, [list(public)], rng=random.Random(7), engine=engine)
            _sync(device)
            dt = time.perf_counter() - t0
            counts = read_launches()
            if engine == "native" and any(counts.values()):
                raise AssertionError(f"k={k}: NativeEngine launched kernels: {counts}")
            if engine == "torch":
                _require(f"k={k} torch prove", counts, ("mont_mul", "ntt_small_stages", "ntt_large_stage", "vm_eval"))
            runs.append(counts)
            print(f"[engines] k={k} engine={engine}: first prove {dt:.3f} s, {len(proofs[engine])} bytes; launches {counts}", flush=True)
        if k == 11 and proofs["native"] != fixture:
            raise AssertionError(f"the NativeEngine flagship proof differs from {FIXTURE}")
        if k == 13:
            if proofs["native"] != proofs["torch"]:
                raise AssertionError("k=13: the native and torch engines' proofs differ")
            if not verify_proof(params.verifier_params(), pk.vk, proofs["torch"], [list(public)]):
                raise AssertionError("k=13: the verifier rejected the proof")
            bad = list(public)
            bad[2] = bad[2] + Fr.from_u64(1)
            if verify_proof(params.verifier_params(), pk.vk, proofs["torch"], [bad]):
                raise AssertionError("k=13: the verifier accepted a tampered root")
        auto = select_engine(params, pk.vk.structure, device, engine="auto").name
        print(
            f"[engines] k={k} (extended 2^{pk.vk.structure.domain.extended_k}): engine='auto' picks {auto} "
            f"(DEVICE_MIN_EXT 2^{DEVICE_MIN_EXT.bit_length() - 1}); "
            + ("native proof equals the fixture" if k == 11 else "native == torch proof, verified, tampered root rejected"),
            flush=True,
        )
    return runs


def phase_setup(device):
    """ParamsKZG.setup(16) on the card against the saved k = 16 SRS; returns
    the launch counts of the setup."""
    import numpy as np
    import torch

    from halo2_tpu_torch.kzg.params import ParamsKZG

    want = ParamsKZG.load(SRS16)
    reset_launches()
    torch.cuda.synchronize(device)
    with _FlagReads() as flags:
        t0 = time.perf_counter()
        got = ParamsKZG.setup(16)
        dt = time.perf_counter() - t0
    counts = read_launches()
    _no_flag_reads("setup", flags)
    for name in ("g1_x", "g1_y"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"setup(16) on the card: {name} differs from {SRS16}")
    if [c.c for c in got.s_g2] != [c.c for c in want.s_g2]:
        raise AssertionError(f"setup(16) on the card: s_g2 differs from {SRS16}")
    _require("setup", counts, ("mont_sqr", "mont_mul", "jac_add"))
    print(f"[setup] k=16 on the card: {dt:.3f} s, equal to {os.path.relpath(SRS16, ROOT)}; launches {counts}", flush=True)
    return [counts]


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_key(label: str, pk, want: dict) -> None:
    """A generated pk against the dict the reference saved: digest,
    commitments, values and coefficients."""
    import numpy as np

    got = pk.to_saved()
    for name, value in want.items():
        same = np.array_equal(got[name], value) if isinstance(value, np.ndarray) else got[name] == value
        if not same:
            raise AssertionError(f"{label}: {name} differs from {PK_CACHE}")


def phase_keygen(device):
    """The flagship's keys generated on the card, split (native commits) and
    fused (device commits), each equal to the reference's saved pk; one prove
    with the fresh pk equals the fixture.  Returns the launch counts of the
    split keygen, the fused keygen and the prove."""
    import pickle

    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import ParamsKZG, create_proof, keygen, keygen_pk, keygen_vk, verify_proof

    k = 11
    circuit, public = _flagship_circuit()
    params = ParamsKZG.setup_cached(k)
    # the pickle is the repository's own cache, written by the reference
    with open(PK_CACHE, "rb") as f:
        want = pickle.load(f)
    with open(FIXTURE, "rb") as f:
        want_proof = f.read()

    reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    vk = keygen_vk(params, circuit, k, Fr)
    _sync(device)
    t_vk = time.perf_counter() - t0
    pk = keygen_pk(params, vk, circuit, k, Fr)
    _sync(device)
    t_pk = time.perf_counter() - t0 - t_vk
    split_counts = read_launches()
    _require("keygen_vk + keygen_pk", split_counts, ("mont_mul", "ntt_small_stages", "ntt_large_stage"))
    _check_key("keygen_vk + keygen_pk", pk, want)

    reset_launches()
    with _FlagReads() as flags:
        t0 = time.perf_counter()
        pk_dev = keygen(params, circuit, k, Fr, commit="device")
        _sync(device)
        t_fused = time.perf_counter() - t0
    fused_counts = read_launches()
    _no_flag_reads("keygen, device commits", flags)
    _require(
        "keygen, device commits", fused_counts,
        ("mont_mul", "ntt_small_stages", "ntt_large_stage", "jac_madd", "jac_add", "mod_sub"),
    )
    _check_key("keygen, device commits", pk_dev, want)
    print(
        f"[keygen] k={k} on the card: keygen_vk {t_vk:.3f} s, keygen_pk {t_pk:.3f} s (launches "
        f"{split_counts}); keygen with commit=\"device\" {t_fused:.3f} s (launches {fused_counts}); "
        f"both equal to {os.path.relpath(PK_CACHE, ROOT)}",
        flush=True,
    )

    reset_launches()
    t0 = time.perf_counter()
    proof = create_proof(params, pk, circuit, [list(public)], rng=random.Random(7))
    _sync(device)
    t_prove = time.perf_counter() - t0
    prove_counts = read_launches()
    _require("prove with the generated pk", prove_counts, ("mont_mul", "ntt_small_stages", "ntt_large_stage", "vm_eval"))
    if proof != want_proof:
        raise AssertionError(f"the proof with the generated pk differs from {FIXTURE}")
    if not verify_proof(params.verifier_params(), pk.vk, proof, [list(public)]):
        raise AssertionError("the verifier rejected the proof made with the generated pk")
    print(
        f"[keygen] prove with the generated pk: {t_prove:.3f} s, equal to the fixture, verified; "
        f"launches {prove_counts}",
        flush=True,
    )
    return [split_counts, fused_counts, prove_counts]


def _mock_vectors():
    """(label, k, circuit, instances, F, failure kinds that must appear);
    None for a vector that must be satisfied."""
    from halo2_tpu_torch.circuits.less_than import LessThanCircuit
    from halo2_tpu_torch.circuits.merkle_sum_tree import MerkleSumTreeCircuit, Node, compute_merkle_sum_root
    from halo2_tpu_torch.circuits.poseidon import PoseidonCircuit
    from halo2_tpu_torch.field import Fp, Fr
    from halo2_tpu_torch.plonkish import Value
    from halo2_tpu_torch.poseidon import MySpec, poseidon_hash

    flagship, public = _flagship_circuit()
    bad_root = list(public)
    bad_root[2] = bad_root[2] + Fr.from_u64(1)

    spec = MySpec(5, 4)
    message = [Fp.from_u64(99)] * 4
    digest = poseidon_hash(Fp, spec, message)
    poseidon = PoseidonCircuit(Fp, spec, 4, [Value.known(x) for x in message], Value.known(digest))

    # tests/test_merkle_sum_tree.py::test_non_binary_index: the bool and swap
    # gates fail (ConstraintNotSatisfied)
    leaf = Node(Fr.from_u64(10), Fr.from_u64(100))
    elements = [Node(Fr.from_u64(h), Fr.from_u64(b)) for h, b in [(1, 10), (5, 50), (6, 60), (9, 90), (9, 90)]]
    indices = [Fr.from_u64(2)] + [Fr.from_u64(0)] * 4
    root = compute_merkle_sum_root(Fr, leaf, elements, [Fr.from_u64(0)] * 5)
    non_binary = MerkleSumTreeCircuit(
        Fr, leaf.hash, leaf.balance, [n.hash for n in elements], [n.balance for n in elements],
        indices, Fr.from_u64(500),
    )
    mst_public = [leaf.hash, leaf.balance, root.hash, Fr.from_u64(500)]

    # tests/test_less_than.py::test_less_than, its invalid half: 755 is not
    # among the 754 public inputs of the dynamic lookup (Lookup)
    less_than = LessThanCircuit(Fp, Value.known(Fp.from_u64(755)))

    return [
        ("flagship valid", 11, flagship, [list(public)], Fr, None),
        ("flagship tampered root", 11, flagship, [bad_root], Fr, set()),
        ("poseidon valid", 7, poseidon, [[digest]], Fp, None),
        ("poseidon tampered digest", 7, poseidon, [[digest + Fp.one()]], Fp, set()),
        ("merkle_sum_tree non-binary index", 10, non_binary, [mst_public], Fr, {"ConstraintNotSatisfied"}),
        ("less_than not in table", 10, less_than, [[Fp.from_u64(i) for i in range(754)]], Fp, {"Lookup"}),
    ]


def phase_mock(device):
    """MockProver.run on the card against the same run on the CPU (the plain
    versions): equal failure lists, and the expected verdicts.  Returns the
    launch counts of each card run."""
    import torch

    from halo2_tpu_torch.dev import MockProver

    vectors = _mock_vectors()
    results = {}
    for label, k, circuit, instances, F, _kinds in vectors:
        reset_launches()
        _sync(device)
        t0 = time.perf_counter()
        prover = MockProver.run(k, circuit, instances, F=F)
        t_run = time.perf_counter() - t0
        failures = prover.verify()
        _sync(device)
        t_card = time.perf_counter() - t0 - t_run
        counts = read_launches()
        results[label] = ([repr(f) for f in failures], {type(f).__name__ for f in failures}, t_card, counts)
    runs = [counts for *_, counts in results.values()]
    # each gate check and lookup evaluation is one VM launch (its products
    # run inside the kernel); every vector's card run must launch it
    for label, counts in zip(results, runs):
        _require(f"MockProver {label}", counts, ("vm_eval",))
    cpu = torch.device("cpu")
    for label, k, circuit, instances, F, kinds in vectors:
        t0 = time.perf_counter()
        prover = MockProver.run(k, circuit, instances, F=F, device=cpu)
        t_run = time.perf_counter() - t0
        want = [repr(f) for f in prover.verify()]
        t_cpu = time.perf_counter() - t0 - t_run
        got, got_kinds, t_card, counts = results[label]
        if got != want:
            raise AssertionError(f"MockProver {label}: the card's failures differ from the CPU's")
        if (kinds is None) != (got == []) or (kinds and not kinds <= got_kinds):
            raise AssertionError(f"MockProver {label}: unexpected failures {sorted(got_kinds)} ({len(got)})")
        print(
            f"[mock] {label} (k={k}, {F.SPEC.name}): {len(got)} failures {sorted(got_kinds)}, equal on "
            f"card and CPU; synthesis {t_run:.3f} s, verify on the card {t_card:.3f} s, on the CPU "
            f"{t_cpu:.3f} s; card launches: vm_eval {counts['vm_eval']}",
            flush=True,
        )
    return runs


def phase_poseidon(device, batch: int = 1 << 20):
    """hash_device (MySpec(5, 4), L = 4, BN254 Fr) over ``batch`` random
    messages on the card: the first 1024 lanes equal the plain versions on
    the CPU, 256 lanes spread over the batch equal the host poseidon_hash.
    Returns the launch counts of the first run."""
    import numpy as np
    import torch

    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FR
    from halo2_tpu_torch.poseidon import MySpec, hash_device, poseidon_hash

    spec, L = MySpec(5, 4), 4
    df = get_device_field(BN254_FR)
    # canonical Montgomery limbs: the top limb below p's keeps every value < p
    rng = random.Random(0x905E1D)
    limbs = np.frombuffer(rng.randbytes(L * 16 * batch * 2), np.uint16).reshape(L, 16, batch).astype(np.int32)
    limbs[:, 15] %= BN254_FR.p >> 240
    messages = torch.from_numpy(limbs).to(device)
    del limbs

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    _sync(device)
    t0 = time.perf_counter()
    out = hash_device(df, spec, L, messages)
    _sync(device)
    first = time.perf_counter() - t0
    counts = read_launches()
    _require("hash_device", counts, ("mont_mul", "mont_sqr", "mod_add"))
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else float("nan")

    lanes = min(1024, batch)
    plain = hash_device(df, spec, L, messages[:, :, :lanes].cpu())
    if not torch.equal(out[:, :lanes].cpu(), plain):
        raise AssertionError(f"hash_device: the card's first {lanes} lanes differ from the plain versions")
    spread = list(range(0, batch, max(1, batch // 256)))[:256]
    msgs = df.decode(messages[:, :, spread].transpose(0, 1).cpu())  # (L, 256) ints
    digests = df.decode(out[:, spread].cpu())
    for j, lane in enumerate(spread):
        want = int(poseidon_hash(Fr, spec, [Fr(int(msgs[i, j])) for i in range(L)]))
        if int(digests[j]) != want:
            raise AssertionError(f"hash_device lane {lane}: differs from the host poseidon_hash")

    times = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        hash_device(df, spec, L, messages)
        _sync(device)
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    print(
        f"[poseidon] hash_device MySpec(5, 4), L={L}, BN254 Fr, B={batch}: {med * 1e3:.1f} ms, "
        f"{batch / med:.4g} hashes/s (median of 3 after the first run, {first * 1e3:.1f} ms; runs "
        f"{[round(t * 1e3, 1) for t in times]}); peak device memory {peak:.1f} MiB; first {lanes} lanes "
        f"equal the plain versions, {len(spread)} spread lanes equal poseidon_hash; launches {counts}",
        flush=True,
    )
    return [counts]


SHARDED_KERNELS = ("mont_mul", "mont_sqr", "mod_add", "mod_sub", "jac_madd", "jac_add", "vm_eval")


def _check_vm_rows(device, gen) -> None:
    """vm_eval over row ranges of the flagship's quotient program (2^15
    rows) against vm_eval_plain over the same range on the card and the
    same columns of the full launch: the two halves (the row blocks of two
    ranks) and two ranges that start inside a block of the kernel, one at
    row 37 (the -1 rotation wraps below row 16) and one ending at the last
    row (the 2042 rotation's reads wrap past n)."""
    from halo2_tpu_torch.plonkish import cuda_vm

    _label, prog, spec, n, stride0 = _vm_programs()[0]
    cols = _vm_columns(prog, spec, n, gen, device, stride0)
    table = cuda_vm.compile_program(prog, spec)
    queries = [cols[kind][ci] for kind, ci, _rot in prog.queries]
    consts = table.consts_on(device)
    full = cuda_vm.vm_eval(table, queries, consts, n)
    block = cuda_vm.rows_per_block(table.num_regs)[0]
    for row0, count in ((0, n // 2), (n // 2, n // 2), (37, 2 * block + 9), (n - 3 * block - 5, 3 * block + 5)):
        got = cuda_vm.vm_eval(table, queries, consts, n, (row0, count))
        plain = cuda_vm.vm_eval_plain(table, queries, consts, n, (row0, count))
        _max_abs_err(f"vm_eval rows ({row0}, {count})", got, plain)
        _max_abs_err(f"vm_eval rows ({row0}, {count}) against the full launch", got, full[..., row0 : row0 + count])
    print(f"[sharded] vm_eval row ranges of the flagship quotient ({block}-row blocks): equal to plain and to the full launch", flush=True)


def _sharded_w1(device, params, pk, circuit, public, want, reps: int):
    """One rank on NCCL in this process: the flagship through
    create_proof(mesh=make_mesh(1)) (the collectives over groups of one
    rank, through parallel.comm) equals the fixture, verifies, and a
    tampered root fails.  Returns the first prove's launches, the warm
    proves' times and the transports."""
    import tempfile

    import torch.distributed as dist

    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import create_proof, verify_proof
    from halo2_tpu_torch.kzg.prover import PHASE_TIMINGS
    from halo2_tpu_torch.parallel import comm, make_mesh

    with tempfile.TemporaryDirectory(prefix="h2t_nccl_") as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rendezvous"), rank=0, world_size=1)
        try:
            mesh = make_mesh(1)
            times, counts = [], None
            for rep in range(reps + 1):
                reset_launches()
                PHASE_TIMINGS.clear()
                _sync(device)
                t0 = time.perf_counter()
                proof = create_proof(params, pk, circuit, [list(public)], rng=random.Random(7), mesh=mesh)
                _sync(device)
                dt = time.perf_counter() - t0
                if proof != want:
                    raise AssertionError(f"sharded prove W=1 (nccl), rep {rep}: differs from {FIXTURE}")
                if rep == 0:
                    counts = read_launches()
                else:
                    times.append(dt)
            transports = dict(comm.TRANSPORTS)
            phases = dict(PHASE_TIMINGS)
        finally:
            dist.destroy_process_group()
    _require("sharded prove W=1 (nccl)", counts, SHARDED_KERNELS)
    if not verify_proof(params.verifier_params(), pk.vk, proof, [list(public)]):
        raise AssertionError("sharded prove W=1: the verifier rejected the proof")
    bad = list(public)
    bad[2] = bad[2] + Fr.from_u64(1)
    if verify_proof(params.verifier_params(), pk.vk, proof, [bad]):
        raise AssertionError("sharded prove W=1: the verifier accepted a tampered root")
    return counts, times, transports, phases


def _phases(timings: dict) -> str:
    return ", ".join(f"{k} {v:.3f}" for k, v in timings.items())


def phase_sharded(device, reps: int = 3):
    """Phase 9: the sharded prover.  (a) one rank on NCCL in this process,
    the flagship equal to the fixture; (b) two ranks on gloo, both on this
    card (NCCL takes one rank a device), mesh (1, 2) so that the NTT, the
    scan and the quotient exchange: the flagship equal to the fixture on
    both ranks, less_than_v2 at k = 9 equal to the single-device proof,
    sharded_ntt at 2^15 and 2^20 equal to the domain's NTT, sharded_msm at
    2^16 equal to the native MSM, grand_product_z at 2^11 equal to the host
    recurrence; and vm_eval's row ranges against its plain version.  Each
    rank's launches are counted per job; the flagship proves must launch
    every kernel of SHARDED_KERNELS on every rank, the 2^20 NTTs both NTT
    kernels.  Returns the launch counts of the flagship proves."""
    import torch

    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import ParamsKZG, ProvingKey, create_proof
    from halo2_tpu_torch.kzg.prover import PHASE_TIMINGS

    gen = torch.Generator(device=device)
    gen.manual_seed(9)
    _check_vm_rows(device, gen)

    circuit, public = _flagship_circuit()
    params = ParamsKZG.setup_cached(11)
    pk = ProvingKey.load(PK_CACHE, circuit, 11, Fr)
    with open(FIXTURE, "rb") as f:
        want = f.read()
    single, single_phases = {}, {}
    for commit in ("native", "device"):
        ts = []
        for rep in range(reps + 1):
            PHASE_TIMINGS.clear()
            _sync(device)
            t0 = time.perf_counter()
            proof = create_proof(params, pk, circuit, [list(public)], rng=random.Random(7), commit=commit)
            _sync(device)
            if proof != want:
                raise AssertionError(f"single-device prove ({commit} commits) differs from {FIXTURE}")
            if rep:
                ts.append(time.perf_counter() - t0)
        single[commit] = ts
        single_phases[commit] = dict(PHASE_TIMINGS)
    w1_counts, w1_times, w1_transports, w1_phases = _sharded_w1(device, params, pk, circuit, public, want, reps)
    print(
        f"[sharded] W=1 (nccl): the flagship equals the fixture, verifies, tampered root rejected; launches "
        f"{w1_counts}; transports {w1_transports}",
        flush=True,
    )
    for label, timings in (("single, native commits", single_phases["native"]),
                           ("single, device commits", single_phases["device"]), ("W=1 nccl", w1_phases)):
        print(f"[sharded] last warm prove's phases (s), {label}: {_phases(timings)}", flush=True)

    ranks, t_spawn = _sharded_group(device, 2, "gloo", 1, reps, want)
    runs = [w1_counts] + [res[0]["launches"] for res in ranks]
    med = {k: statistics.median(v) for k, v in (("single, native commits", single["native"]),
                                                ("single, device commits", single["device"]), ("W=1 nccl", w1_times))}
    w2 = [statistics.median(r[0]["out"]["times"][1:]) for r in ranks]
    print(
        f"[sharded] warm flagship proves, medians of {reps} (s): "
        + ", ".join(f"{k} {v:.3f}" for k, v in med.items())
        + f", W=2 gloo rank 0 {w2[0]:.3f}, rank 1 {w2[1]:.3f} (single {[round(t, 3) for t in single['native']]} / "
        f"{[round(t, 3) for t in single['device']]}, W=1 {[round(t, 3) for t in w1_times]}); the W=2 group "
        f"in {t_spawn:.1f} s, process start included",
        flush=True,
    )
    return runs


def _sharded_group(device, world: int, backend: str, dp, reps: int, want: bytes):
    """``world`` spawned ranks on ``backend`` (ranks on the visible cards in
    turn), mesh (dp, world / dp), each running the flagship (``reps`` + 1
    proves), less_than_v2 at k = 9, sharded_ntt at 2^15 and 2^20,
    sharded_msm at 2^16 and grand_product_z at 2^11, each checked against
    its single-device or host value and its launches.  Returns every rank's
    job results and the group's wall time."""
    import tempfile

    import numpy as np
    import torch

    from halo2_tpu_torch import native
    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FR
    from halo2_tpu_torch.kzg import ParamsKZG, create_proof, keygen
    from halo2_tpu_torch.parallel import jobs
    from halo2_tpu_torch.parallel.launch import spawn
    from halo2_tpu_torch.parallel.mesh import mesh_shape
    from halo2_tpu_torch.poly.domain import _ntt_raw

    dfr = get_device_field(BN254_FR)
    lt_circuit, lt_inst = jobs.circuit("less_than_v2")
    lt_params = ParamsKZG.setup_cached(9)
    lt_pk = keygen(lt_params, lt_circuit, 9, Fr)
    lt_want = create_proof(lt_params, lt_pk, lt_circuit, lt_inst, rng=random.Random(13))
    rng = random.Random(5)
    x15 = dfr.encode_np([rng.randrange(BN254_FR.p) for _ in range(1 << 15)])
    x20 = np.tile(dfr.encode_np([rng.randrange(BN254_FR.p) for _ in range(4096)]), (1, 1 << 8))
    srs = ParamsKZG.load(SRS16)
    rng = random.Random(42)
    sc16 = dfr.encode_np([rng.randrange(BN254_FR.p) for _ in range(srs.n)], to_mont=False)
    msm_want = native.msm_g1_mont(*(native.pack_device(np.ascontiguousarray(a)) for a in (srs.g1_x, srs.g1_y, sc16)))
    rng = random.Random(21)
    nums = [rng.randrange(1, BN254_FR.p) for _ in range(1 << 11)]
    dens = [rng.randrange(1, BN254_FR.p) for _ in range(1 << 11)]
    z_host = [1] * len(nums)
    for r in range(len(nums) - 1):
        z_host[r + 1] = z_host[r] * nums[r] % BN254_FR.p * pow(dens[r], -1, BN254_FR.p) % BN254_FR.p
    with tempfile.TemporaryDirectory(prefix="h2t_lt_") as tmp:
        lt_path = os.path.join(tmp, "pk_less_than_v2_k9.pkl")
        lt_pk.save(lt_path)
        job_list = [
            ("prove", {"name": "flagship", "k": 11, "pk_path": PK_CACHE, "seed": 7, "reps": reps + 1}),
            ("prove", {"name": "less_than_v2", "k": 9, "pk_path": lt_path, "seed": 13}),
            ("ntt", {"x": x15}),
            ("ntt", {"x": x15, "inverse": True}),
            ("ntt", {"x": x20}),
            ("ntt", {"x": x20, "inverse": True}),
            ("msm", {"px": srs.g1_x, "py": srs.g1_y, "scalars": sc16}),
            ("grand_product_z", {"num": dfr.encode_np(nums), "den": dfr.encode_np(dens)}),
        ]
        t0 = time.perf_counter()
        ranks = spawn(jobs.run, world, backend, "cuda", job_list, dp=dp)
        t_spawn = time.perf_counter() - t0
    wants = {}
    for x in (x15, x20):
        xt = torch.from_numpy(x.view(np.int32)).to(device)
        for inverse in (False, True):
            wants[(x.shape[1], inverse)] = _ntt_raw(BN254_FR, x.shape[1], inverse)(xt).cpu().numpy()
    label = f"W={world} ({backend})"
    for rank, res in enumerate(ranks):
        flag, lt = res[0], res[1]
        if flag["out"]["proof"] != want or not flag["out"]["same"] or not flag["out"]["verified"]:
            raise AssertionError(f"sharded prove {label}, rank {rank}: the flagship differs from {FIXTURE} or fails to verify")
        _require(f"sharded prove {label}, rank {rank}", flag["launches"], SHARDED_KERNELS)
        if lt["out"]["proof"] != lt_want or not lt["out"]["verified"]:
            raise AssertionError(f"sharded prove {label}, rank {rank}: less_than_v2 k=9 differs from single-device")
        _require(f"less_than_v2 {label}, rank {rank}", lt["launches"], SHARDED_KERNELS)
        for job, (n, inverse) in zip(res[2:6], ((1 << 15, False), (1 << 15, True), (1 << 20, False), (1 << 20, True))):
            _max_abs_err(f"sharded_ntt 2^{n.bit_length() - 1} inverse={inverse}, rank {rank}", torch.from_numpy(job["out"]), torch.from_numpy(wants[(n, inverse)]))
            if n == 1 << 20:
                _require(f"sharded_ntt 2^20, rank {rank}", job["launches"], ("ntt_small_stages", "ntt_large_stage", "mont_mul"))
        msm, gp = res[6], res[7]
        if msm["out"]["affine"] != msm_want:
            raise AssertionError(f"sharded_msm 2^16, rank {rank}: {msm['out']['affine']} != native {msm_want}")
        _require(f"sharded_msm 2^16, rank {rank}", msm["launches"], ("jac_madd", "jac_add", "mont_sqr"))
        if [int(v) for v in dfr.decode(torch.from_numpy(gp["out"]))] != z_host:
            raise AssertionError(f"grand_product_z 2^11, rank {rank}: differs from the host recurrence")
        ntt_s = ", ".join(f"{j['seconds']:.3f}" for j in res[2:6])
        print(f"[sharded] {label} rank {rank}, last warm prove's phases (s): {_phases(flag['out']['phases'])}", flush=True)
        print(
            f"[sharded] {label}, mesh {tuple(mesh_shape(world, dp))}, rank {rank}: the flagship equals the fixture and verifies; "
            f"warm proves (s) {[round(t, 3) for t in flag['out']['times'][1:]]}; less_than_v2 k=9 equals "
            f"single-device and verifies ({lt['seconds']:.3f} s); sharded_ntt 2^15 / 2^20 equal the domain's "
            f"({ntt_s} s); sharded_msm 2^16 equals native "
            f"({msm['seconds']:.3f} s); grand_product_z 2^11 equals the host ({gp['seconds']:.3f} s); flagship "
            f"launches {flag['launches']}; transports {res[-1]['transports']}",
            flush=True,
        )
    return ranks, t_spawn


# (column, row, value) of the advice cell phase 10 plants in entry()'s columns
GRAFT_PLANTED = (2, 5, 12345)


def _graft_dryrun(n: int) -> list:
    """dryrun_multichip(n) on the card, each rank's checks printed with the
    backend it ran on, their seconds and launches.  Every kernel of
    SHARDED_KERNELS must launch in every check on every rank; returns the
    launch counts of every check on every rank."""
    from halo2_tpu_torch import graft_entry

    t0 = time.perf_counter()
    ranks = graft_entry.dryrun_multichip(n)
    dt = time.perf_counter() - t0
    graft_entry.print_reports(ranks, tag="[graft]")
    runs = []
    for rank in ranks:
        for name in graft_entry.CHECKS:
            launches = rank["checks"][name]["launches"]
            _require(f"dryrun_multichip({n}), rank {rank['rank']}, {name}", launches, SHARDED_KERNELS)
            runs.append(launches)
    print(
        f"[graft] dryrun_multichip({n}) over {sorted({r['backend'] for r in ranks})}: every check passed "
        f"on {n} ranks in {dt:.1f} s, process start included; transports {ranks[0]['transports']}",
        flush=True,
    )
    return runs


def phase_graft(device):
    """Phase 10: the graft entries.  entry() on the card: no violation on
    the honest witness, with a planted cell the counts its columns give on
    the CPU, its time per call and vm_eval's device time beside the bound;
    dryrun_multichip(2) on this card over gloo, and dryrun_multichip(count)
    over NCCL where more than one card is visible.  Returns the launch
    counts of entry() and of every dryrun check on every rank."""
    import torch

    from halo2_tpu_torch import graft_entry
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FR
    from halo2_tpu_torch.plonkish import cuda_vm

    t0 = time.perf_counter()
    fn, (columns,) = graft_entry.entry()
    reset_launches()
    _sync(device)
    honest = fn(columns).tolist()
    counts = read_launches()
    _require("entry()", counts, ("vm_eval",))
    if any(honest):
        raise AssertionError(f"entry(): the honest witness violates its gates: {honest}")
    col, row, value = GRAFT_PLANTED
    cell = get_device_field(BN254_FR).encode_scalar(value, device=device)
    bad = {kind: c.clone() for kind, c in columns.items()}
    bad["advice"][col, :, row] = cell
    planted = fn(bad).tolist()
    want = fn({kind: c.cpu() for kind, c in bad.items()}).tolist()
    if planted != want or not any(planted):
        raise AssertionError(f"entry() with a planted cell: card {planted}, CPU {want}")
    prog = fn.program
    queries = [columns[kind][ci] for kind, ci, _rot in prog.queries]
    n = columns["advice"].shape[-1]
    bound = _bound(*_vm_work(prog, queries, n, len(prog.consts)))
    call_ms = _ms_per_call(lambda: fn(columns), 20)
    device_ms = _kernel_device_ms(lambda: fn(columns), "vm_eval_kernel", bound[0])
    table = cuda_vm.compile_program(prog, BN254_FR)
    print(
        f"[graft] entry(): {len(honest)} constraints over {n} rows, no violation; planted cell "
        f"{GRAFT_PLANTED}: {planted} (the CPU's); launches {counts}; {call_ms:.4f} ms a call, vm_eval "
        f"{device_ms:.4f} ms a launch on the device ({table.streams} streams, {table.num_regs} registers), "
        f"bound {bound[0]:.6f} ms ({bound[1]}), {bound[0] / device_ms:.0%} of it; "
        f"{time.perf_counter() - t0:.1f} s",
        flush=True,
    )
    runs = [counts] + _graft_dryrun(2)
    if torch.cuda.device_count() > 1:
        runs += _graft_dryrun(torch.cuda.device_count())
    return runs


KERNELS = (
    ("mont_mul", "halo2_tpu_torch/csrc/mont_mul.cu", "halo2_tpu/field/pallas_mul.py:357"),
    ("mont_sqr", "halo2_tpu_torch/csrc/mont_mul.cu", "halo2_tpu/field/pallas_mul.py:363"),
    ("ntt_small_stages", "halo2_tpu_torch/csrc/ntt.cu", "halo2_tpu/poly/pallas_ntt.py:47"),
    ("ntt_large_stage", "halo2_tpu_torch/csrc/ntt.cu", "halo2_tpu/poly/pallas_ntt.py:97"),
    ("jac_madd", "halo2_tpu_torch/csrc/jac.cu", "halo2_tpu/ec/pallas_jac.py:76"),
    ("jac_add", "halo2_tpu_torch/csrc/jac.cu", "halo2_tpu/ec/pallas_jac.py:127"),
    # no Pallas counterpart: the reference's scanned VM and its jnp add/sub/neg
    ("vm_eval", "halo2_tpu_torch/csrc/vm.cu", "halo2_tpu/plonkish/evaluator.py:121"),
    ("mod_add", "halo2_tpu_torch/csrc/field_ops.cu", "halo2_tpu/field/device.py:145"),
    ("mod_sub", "halo2_tpu_torch/csrc/field_ops.cu", "halo2_tpu/field/device.py:150"),
)


def main() -> int:
    device = phase_device()
    import torch

    t_start = time.perf_counter()
    spent = {}

    def timed(name, phase, *args):
        out, spent[name] = _timed(lambda: phase(*args))
        return out

    timed("build", phase_build)
    err, times, bounds = timed("kernels", phase_kernels, device)
    runs = []
    for name, phase in (
        ("msm", phase_msm), ("prove", phase_prove), ("engines", phase_engines), ("setup", phase_setup),
        ("keygen", phase_keygen), ("mock", phase_mock), ("poseidon", phase_poseidon), ("sharded", phase_sharded),
        ("graft", phase_graft),
    ):
        runs += timed(name, phase, device)
    launches = {name: sum(r[name] for r in runs) for name, _, _ in KERNELS}
    print(
        f"[done] all phases in {time.perf_counter() - t_start:.1f} s ("
        + ", ".join(f"{k} {v:.1f}" for k, v in spent.items()) + ")",
        flush=True,
    )
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
                "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                # no single PyTorch call computes a 256-bit Montgomery
                # product or modular add, a prime-field NTT, a curve add or
                # an expression program over field columns
                "library_ms": None,
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
