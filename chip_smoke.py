"""Smoke run of the PyTorch/CUDA port (halo2_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the repository root, with one CUDA device.  Phases, each of which
passes or raises:

0. the card (nvidia-smi name and power limit) and the torch/CUDA versions;
1. build of the CUDA kernels from halo2_tpu_torch/csrc (and of the native
   host engine), with their times, each kernel's registers and spills, and
   the curve kernels' SASS instruction and IMAD counts (cuobjdump), and
   the inverse kernel's batch loop by pipe with an issue and a chain bound;
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
   iNTT(NTT(x)) == x; ntt_small_stages below 512 points (the whole
   transform, natural order in) at n = 1 .. 256 for C = 1 and 3 and at the
   local transforms the sharded prover gives it (SMALL_NTT_SHAPES), with the
   device time of the W = 1 ones; each NTT kernel's device time per launch (each pass
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
   VM's at the flagship; the two ladder kernels: jac_horner (the sharded
   MSM's Horner combine in one launch) at every window size and lane count
   of HORNER_CASES, with infinite windows, a leading run of them, P == Q
   and P == -Q lanes, and mont_pow (a power's whole square-and-multiply ladder
   in one launch) for BN254 Fr, BN254 Fq and Pasta Fp at POW_SIZES
   elements with the exponents p - 2, 0, 1, 2 and one of 300 bits; each
   one's device time per launch beside its throughput bound and its chain
   of dependent products; mont_inv (the inverse as a fixed-count safegcd
   in one launch) at the same sizes and fields and at the sharded
   flagship's batched 4,096, 8,192 and 16,384 (INV_BATCHED) against its plain
   version, with inv_plan's lane group and with each of INV_GROUPS, and
   against the mont_pow kernel's a^(p - 2), zero included, timed beside
   mont_pow in this call with its bound, its chain of divsteps and each
   lane group's cycles a divstep; the
   device MSM's window-sum kernels, msm_chunk_acc (a batch's intra-chunk
   rounds in one launch, in the schedule acc_plan picks and in each of
   ACC_SCHEDULES forced, every one held limb for limb, each forced one
   timed at ACC_SCHEDULES_TIMED) and jac_suffix_scan (the cross-chunk suffix scan
   in the schedule scan_plan picks, and in each of SCAN_SCHEDULES forced
   at every level, timed at the flagship's batches), on the batches of
   MSM_CASES (the flagship's
   commit batches of 1, 4, 8, 16 and 20 columns at 2^11, a W = 2 rank's
   2^10, the dryrun's 2^9, the 2^16 MSM and a 2^18-point slice),
   with exception lanes (a (0, 0) point, a y = 0 point, P == Q and P == -Q
   in a chunk) and the scan at SCAN_RAGGED chunk counts in every
   schedule, each one's device time a call beside its bound and its chain
   of dependent group ops; jac_ladder (a per-lane double-and-add in one
   launch; no path launches it since jac_fixed_base) at LADDER_SIZES lanes with 256 bit rows (a zero scalar, 1,
   R - 1, an infinity base, P == Q at row 254) on uint8 and int32 bits,
   reading no P == Q flag, timed at LADDER_TIMED lanes of the setup's own
   operands beside the bound of the work they need; jac_fixed_base (the
   setup's G tau^i: one shared point's window table, a mixed add a window
   a lane, in one launch) at FIXED_BASE_SIZES lanes for two points (G and
   7 G; scalars 0, 1, R - 1, R with P == -Q in the top window, 2^255 - R
   with P == Q there, 2^256 - 1), reading no P == Q flag, timed at
   FIXED_BASE_TIMED lanes of the setup's operands beside its bound and the
   double-and-add's bound of the same scalars; poseidon_hash
   (the sponge, or a permutation, in one launch) at SPONGE_SIZES lanes for
   SPONGE_CASES (BN254 Fr MySpec(5, 4) at L = 4, Pasta Fp P128Pow5T3 at
   L = 2 and 3, width 5 at L = 3, and permute_device at both widths),
   timed at SPONGE_TIMED lanes with hashes/s beside the bound;
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
   .srs/kzg_bn254_k16_s857536.pkl limb for limb, through one
   jac_fixed_base launch, then mont_inv and mont_mul (SETUP_KERNELS), and
   no jac_ladder, mont_sqr, mod_add, mod_sub or jac_add (SETUP_GONE);
6. keygen on the card: the flagship through keygen_vk then keygen_pk
   (native commits) and through keygen(..., commit="device"), each equal to
   .srs/pk_mst_d15_k11.pkl (digest, commitments, values, coefficients); a
   prove with the fresh pk equals the fixture and verifies; vk and pk times;
7. the MockProver on the card: the flagship valid and with a tampered root,
   the Poseidon experiment (Pasta Fp, width 5, k = 7) valid and tampered,
   and two of the reference's negative vectors (a ConstraintNotSatisfied
   and a Lookup failure); every card run's failures equal the same run on
   the CPU; verify times on the card and on the CPU;
7b. the experiment circuits (tests/experiment_vectors.py: add_carry_v1,
   add_carry_v2, hash_v2, inclusion_check, inclusion_check_v2,
   less_than_v3, merkle_v1, merkle_v2, merkle_v3, safe_accumulator): the
   25 MockProver vectors of the reference's own tests on the card, each
   one's failures equal to the reference's committed in
   tests/data/experiments/results.json; each circuit's valid instance over
   BN254 Fr through keygen, create_proof (random.Random(3)) and
   verify_proof with native commits, and merkle_v3 (k = 11) also with
   commit="device": the proof bytes equal the committed reference proof,
   the verdict the reference's (the reference rejects its own proofs of
   add_carry_v1, inclusion_check and inclusion_check_v2, and its keygen
   raises IndexError on safe_accumulator: the port must do the same), and
   a tampered instance fails wherever the reference's proof verifies; one
   line a circuit with its MockProver seconds, keygen, prove and verify
   seconds and launches by kernel;
8. the device Poseidon sponge: hash_device (MySpec(5, 4), L = 4, BN254 Fr)
   over 2^20 messages from random.Random, one level of a 2^21-leaf
   merkle-sum tree, in one poseidon_hash launch and no mont_mul, mont_sqr
   or mod_add (SPONGE_GONE); its first 1024 lanes equal the plain versions
   on the CPU and 256 spread lanes equal the host poseidon_hash; hashes/s
   and peak device memory;
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
   device commits) and their phases; the transport of every collective;
   the launches a rank by kernel at W = 1 and W = 2, beside a W = 1
   prove's before jac_horner and mont_pow (W1_LAUNCHES_BEFORE), with
   exactly two mont_inv launches a flagship prove (its permutation chunks'
   and its lookups' grand products, one batch each); the
   commitments of each device MSM batch in one single-device
   device-commit prove and one W = 1 prove; one warm
   W = 1 prove under torch.profiler: its launches by kernel and by width,
   and the device's busy share.
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
phases 3-6 and 7b must read no P == Q flag back.  Every path of phases 3-10 runs
once with the launch counts set to 0
just before and read just after, and fails if a kernel it must launch was
not launched: mont_mul and the NTT kernels in the proves and the keygens,
vm_eval in every prove, the MSM's kernels (MSM_KERNELS: msm_chunk_acc,
jac_suffix_scan, jac_add) and jac_horner in the device-commit prove and
the device-commit keygen, the MSM's kernels in the MSM and in every hybrid
MSM whose device share is above 0, none in a NativeEngine prove,
jac_fixed_base, mont_inv and mont_mul in the setup, vm_eval in every
MockProver run (in phase 7b every run of a circuit with gates or lookups:
inclusion_check has neither), in every experiment keygen and prove the NTT
kernels and mont_mul (ntt_large_stage above 512 points) and in the prove
vm_eval, with device commits also the MSM's kernels and jac_horner,
poseidon_hash in the sponge, and in
phase 9 (each rank's counts set to 0 before each of its jobs and read
after) every kernel of SHARDED_KERNELS (mont_mul, jac_horner, mont_inv,
ntt_small_stages, vm_eval and the MSM's) in every sharded prove on every
rank, ntt_small_stages and mont_mul (and ntt_large_stage at 2^20) and no
mod_add or mod_sub in every sharded NTT, the MSM's kernels and jac_horner
in the sharded MSM, and mont_inv in the sharded grand product; and no MSM
path (the MSM, the device-commit and sharded proves, the sharded MSM)
launches jac_madd or mod_sub (MSM_GONE: the mixed add and the negation
run inside msm_chunk_acc), nor the device-commit keygen jac_madd; the
setup no jac_ladder, mont_sqr, mod_add, mod_sub or jac_add (SETUP_GONE:
its multiples are one jac_fixed_base launch) and the sponge no mont_mul, mont_sqr or
mod_add (SPONGE_GONE: its rounds run inside poseidon_hash); in phase 10
vm_eval in entry() and every kernel of SHARDED_KERNELS in each dryrun
check on every rank.  The line
before the last is a JSON object with one entry per kernel (its launches
summed over those runs, its time at 2^15 beside its bound from this run's
inputs); the last
is {"ok": true, "device": {...}}.  Without a CUDA device, or
outside the repository, the script fails before printing either.
"""

from __future__ import annotations

import collections
import contextlib
import functools
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
# the lanes of ParamsKZG.setup(16)'s fixed-base multiplication (one
# jac_fixed_base launch)
SETUP_LANES = 1 << 16
# the coset NTT batch of the flagship prove: 20 advice, 11 fixed, 7 selector,
# 1 instance, 4 permutation z, 24 lookup and 16 sigma columns
FLAGSHIP_C = 83
# (columns, n) of the NTT kernels' checks, and those timed
NTT_CASES = tuple((c, n) for c in (1, 3, FLAGSHIP_C) for n in (1 << 11, 1 << 15)) + ((1, 1 << 9), (1, 1 << 20))
NTT_TIMED = tuple((1, n) for n in TIMED_SIZES) + ((FLAGSHIP_C, 1 << 15),)
REPORT_SIZE = 1 << 15  # the flagship's extended domain: the ms in the JSON line
# jac_horner: (c, lane counts) of each Horner the main paths run, each
# checked and timed at -(-254 // c) windows of c bits: the sharded
# flagship's (2^11 points a rank: c = 8; one MSM, a commit batch's columns,
# a block's 32 lanes and one past it, two blocks), phase 9's sharded_msm
# 2^16 at W = 2 (2^15 points a rank: c = 12, one MSM) and phase 10's
# dryrun checks (at most 2^8 points: c = 4; their commit batches' columns);
# the JSON line's ms at c = 8, 20 lanes (the flagship's widest batch)
HORNER_CASES = ((8, (1, 5, 20, 32, 33, 64)), (12, (1,)), (4, (1, 2, 4, 5, 8, 20)))
HORNER_REPORT_C, HORNER_REPORT_B = 8, 20
# mont_pow: the sharded grand product's block of denominators (2^10 a rank
# at W = 2, 2^11 at W = 1) and the setup's inverse at k = 16 (2^16); the
# JSON line's ms at 2^11
POW_SIZES = (1, 1 << 10, 1 << 11, 1 << 16)
POW_REPORT_M = 1 << 11
# the flagship's grand products: its 4 permutation chunks in one batch, its
# 8 lookups in another; a prove on a mesh runs one mont_inv launch each
FLAGSHIP_GRAND_PRODUCTS = (4, 8)
# mont_inv also at the sharded flagship's batched launches: each batch's
# columns of 2^11 / W denominators a rank, at W = 1 and W = 2 (4,096, 8,192
# and 16,384 elements)
INV_BATCHED = tuple(sorted({(cols << 11) >> w for cols in FLAGSHIP_GRAND_PRODUCTS for w in (0, 1)}))
# the H100's SM clock (boost), for cycles a divstep from a device time
SM_HZ = 1.98e9
# the elements a stage of the sharded flagship's local stage ladders gave
# mont_mul (half of 83 columns of 2^15 at W = 1, a quarter a rank at W = 2)
# before its local transforms were one ntt_small_stages launch each: kept as
# mont_mul's periodic-b cases at four elements a thread
SHARDED_LADDER = (FLAGSHIP_C << 14, FLAGSHIP_C << 13)
# ntt_small_stages below 512 points: (columns, n) of the local transforms
# the sharded prover gives it (parallel/ntt.py's four-step split): 2^11 as
# 32 x 64 then 64 x 32 points, 2^15 over the 83-column coset batch as 83 x
# 128 x 256 then 83 x 256 x 128 (W = 1), then their W = 2 halves, and the
# dryrun's k = 9 as 16 x 32 then 32 x 16 and its halves; the first four
# are timed
SMALL_NTT_SHAPES = ((32, 64), (64, 32), (FLAGSHIP_C * 128, 256), (FLAGSHIP_C * 256, 128),
                    (16, 64), (32, 32), (FLAGSHIP_C * 64, 256), (FLAGSHIP_C * 128, 128),
                    (16, 32), (32, 16), (8, 32), (16, 16))
# the chained-product microbenchmark's products in one thread
CHAIN_ITERS = 4096
# the device MSM's window-sum kernels (msm_chunk_acc, jac_suffix_scan):
# (points, scalar sets a batch) of the batches the main paths give them: the
# flagship's commit batches at 2^11 (its prove commits batches of 1, 4, 8, 16
# and 20 columns), a W = 2 rank's half of them (2^10), the dryrun's k = 9
# (2^9), the 2^16 MSM and one 2^18-point slice of the 2^20 one (q = 16:
# 16,384 chunks a window); the JSON line's times at the largest batch
MSM_CASES = ((1 << 11, (1, 4, 8, 16, 20)), (1 << 10, (1, 4, 20)), (1 << 9, (1, 4)), (1 << 16, (1,)), (1 << 18, (1,)))
MSM_REPORT = (1 << 11, 20)
# the points at which phase 2 times the scan in each of its schedules: the
# flagship prove's batches (elsewhere, scan_plan's schedule alone)
SCHEDULES_TIMED_N = 1 << 11
# the (points, sets) batches at which phase 2 times msm_chunk_acc in each of
# its schedules (elsewhere, acc_plan's alone): the flagship's batches of 1,
# 4 and 20 sets, 2^10 at 20 sets (where three blocks an SM leave the fuller
# last wave) and the 2^16 MSM
ACC_SCHEDULES_TIMED = ((1 << 11, 1), (1 << 11, 4), (1 << 11, 20), (1 << 10, 20), (1 << 16, 1))
# the scan also at chunk counts no path gives it: one chunk, a tile's 256
# plus one (two tiles, a ragged one), and three tiles and a bit
SCAN_RAGGED = (1, 2, 65, 257, 700)
# the shape at which each kernel's ms in the JSON line is taken
# jac_ladder: the lanes at which it is held against its plain version (one
# plain run over the widest, 256 bit rows) and at which it is timed on the
# setup's own operands (the device branch runs k = 13 and up:
# 2^13, 2^14 and k = 16's 2^16 lanes, and 2^11 for the JSON line); the
# JSON line's ms at 2^11, where the plain version's 256 rounds take seconds
LADDER_SIZES = (1, 33, 1 << 11)
LADDER_TIMED = (1 << 11, 1 << 13, 1 << 14, SETUP_LANES)
LADDER_REPORT_M = 1 << 11
# poseidon_hash: (field, spec, L) of the sponges held against the plain
# versions (L None: permute_device alone): the flagship's BN254 Fr
# MySpec(5, 4) at L = 4 (phase 8), Pasta Fp P128Pow5T3 at L = 2 and 3
# (one chunk, two), width 5 at L = 3 (padded), BN254 Fr P128Pow5T3 at L = 2
# (so both widths run under both arithmetics), and a permutation of each
# width; the lanes of the checks, of the timing (phase 8 hashes 2^20) and
# of the JSON line's ms
SPONGE_CASES = (("bn254_fr", "MySpec(5, 4)", 4), ("pasta_fp", "P128Pow5T3", 2), ("pasta_fp", "P128Pow5T3", 3),
                ("pasta_fp", "MySpec(5, 4)", 3), ("bn254_fr", "P128Pow5T3", 2), ("bn254_fr", "MySpec(5, 4)", None),
                ("pasta_fp", "P128Pow5T3", None))
SPONGE_SIZES = (1, 33, 1 << 11)
SPONGE_TIMED = (1 << 11, 1 << 16, 1 << 20)
SPONGE_REPORT_M = 1 << 11
# jac_fixed_base: the lanes at which it is held against its plain version
# (for G and 7 G), those at which it is timed on the setup's own operands
# (the device branch runs k = 13 and up), and the JSON line's (k = 16's)
FIXED_BASE_SIZES = (1, 33, 1 << 11)
FIXED_BASE_TIMED = (1 << 13, 1 << 14, SETUP_LANES)
FIXED_BASE_REPORT_M = SETUP_LANES
REPORT_AT = {"jac_horner": HORNER_REPORT_B, "mont_pow": POW_REPORT_M, "mont_inv": POW_REPORT_M,
             "msm_chunk_acc": MSM_REPORT, "jac_suffix_scan": MSM_REPORT, "jac_ladder": LADDER_REPORT_M,
             "poseidon_hash": SPONGE_REPORT_M, "jac_fixed_base": FIXED_BASE_REPORT_M}


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


@functools.lru_cache(maxsize=None)
def _sass_text(library) -> str:
    """``cuobjdump -sass`` of the built library, once a library ("" without
    cuobjdump)."""
    from halo2_tpu_torch import _build

    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return ""
    return subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, check=True, timeout=300).stdout


def _sass_counts(library) -> dict:
    """Static instruction counts of each curve kernel, of the power and
    inverse kernels (for each arithmetic) and of the chained-product
    microbenchmark in the built library's
    SASS (``cuobjdump -sass``): (instructions, IMAD.WIDE, other IMADs but
    IMAD.MOV); empty when the toolkit has no cuobjdump."""
    import re

    text = _sass_text(library)
    if not text:
        print("[build] SASS counts not measured: no cuobjdump beside nvcc", flush=True)
        return {}
    counts, name = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            kernels = ("jac_madd_wide", "jac_madd_narrow", "jac_add_wide", "jac_add_narrow", "jac_horner", "mont_pow",
                       "mont_inv", "mul_chain", "jac_suffix_scan_cluster", "jac_suffix_scan_coarse",
                       "msm_chunk_acc_group", "msm_chunk_acc_thread3", "msm_chunk_acc_thread",
                       "jac_ladder", "jac_fixed_base", "poseidon_kernel")
            name = next((k for k in kernels if k in fn), None)
            if name == "mont_inv":
                g = re.search(r"Li(\d)E", fn)
                name = f"mont_inv G={g.group(1) if g else '?'}"
            if name == "poseidon_kernel":
                w = re.search(r"Li(\d)E", fn)
                name = f"poseidon W={w.group(1) if w else '?'}"
            if name and name.startswith(("mont_pow", "mont_inv", "poseidon")):
                name += " cc" if "CcArith" in fn else " wide"
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


def _time_kernel(name, symbol, m, kernel, plain, times, bound_ms, plain_calls=3, plain_runs=3):
    """Time per call of kernel and plain version at m lanes, and the
    kernel's device time per launch; record and print them.  Returns the
    device time."""
    t_k = _ms_per_call(kernel, 50)
    t_p = _ms_per_call(plain, plain_calls, runs=plain_runs)
    t_d = _kernel_device_ms(kernel, symbol, bound_ms)
    times[(name, m)] = (t_k, t_p)
    print(
        f"[kernels] {name} m={m}: kernel {t_k:.4f} ms per call ({t_d:.4f} ms on the "
        f"device, {bound_ms / t_d:.0%} of the bound {bound_ms:.6f}), plain {t_p:.4f} ms per call",
        flush=True,
    )
    return t_d


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

    _check_mul_columns(device, gen, err)

    _check_field_ops(device, gen, err, times)

    classes = _check_jac_kernels(device, err, times)

    _check_ntt_kernels(device, gen, err, times)

    _check_small_ntt(device, gen, err, times)

    vm_bound = _check_vm(device, gen, err, times)

    ladder_bounds = _check_ladders(device, gen, err, times)

    msm_bounds = _check_msm_kernels(device, gen, err, times)

    setup_bounds = {**_check_setup_ladder(device, err, times), **_check_fixed_base(device, err, times),
                    **_check_sponge(device, err, times)}

    for n in TIMED_SIZES:
        bounds = _bounds(classes, n)
        print(
            f"[kernels] bounds at n={n} (ms, what bounds it): "
            + ", ".join(f"{k} {v[0]:.6f} {v[1]}" for k, v in bounds.items()),
            flush=True,
        )
    return err, times, {**_bounds(classes, REPORT_SIZE), "vm_eval": vm_bound, **ladder_bounds, **msm_bounds,
                        **setup_bounds}


def _mul_columns_work(n: int, cols: int, b_elems: int) -> tuple:
    """(bytes, IMADs) of one mont_mul_columns launch: ``cols`` columns of n
    elements read and written once, b's ``b_elems`` elements read once."""
    return 2 * ELEM * n * cols + ELEM * b_elems, IMAD_MUL * n * cols


def _elems(m: int) -> str:
    """m as ``C x 2^k`` (FLAGSHIP_C columns), for labels."""
    return f"{FLAGSHIP_C} x 2^{(m // FLAGSHIP_C).bit_length() - 1}" if m % FLAGSHIP_C == 0 else str(m)


def _check_mul_columns(device, gen, err) -> None:
    """mont_mul_columns against its plain version, limb for limb, at the
    shapes the main paths give it, for BN254 Fr, BN254 Fq and Pasta Fp:
    the flagship's 83 x 2^15 coset scale (one (16, 2^15) b for every
    column), a lone 2^11 column times one element (an iNTT's n^-1), the
    stage ladders' twiddles as a period P of the sub-2^9 transforms of a
    2^11 and a 2^15 column (n / 2 elements a stage, P = 1 .. 128), the
    sharded flagship's ladder stages (SHARDED_LADDER: 83 columns of 2^15,
    83 x 2^14 elements a stage at W = 1 and 83 x 2^13 a rank at W = 2, four
    elements a thread, P = 1 .. 128), full-width b on a batch, strided
    columns (a slice of a batch) and a ragged n (below and past
    MUL_VEC_MIN_ELEMS: one element a thread); for BN254 Fr the device
    time per launch of the coset scale, the lone column and the period-64
    stage of a 2^15 column and of the sharded W = 1 ladder beside their
    bound."""
    from halo2_tpu_torch.field.cuda_mul import mont_mul_columns, mont_mul_columns_plain
    from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP

    def check(name, spec, a, b):
        got = mont_mul_columns(spec, a, b)
        err["mont_mul"] = max(err["mont_mul"], _max_abs_err(name, got, mont_mul_columns_plain(spec, a, b)))

    for spec in (BN254_FR, BN254_FQ, PASTA_FP):
        coset = _random_field(spec, (1 << 15,), gen, device)
        batch = _random_field(spec, (FLAGSHIP_C, 1 << 15), gen, device).movedim(1, 0).contiguous()
        lone = _random_field(spec, (1 << 11,), gen, device)
        n_inv = _random_field(spec, (1,), gen, device)
        cases = [(f"{FLAGSHIP_C} x 2^15, shared b", batch, coset), ("1 x 2^11, one element", lone, n_inv)]
        for n, top in ((1 << 11, 32), (1 << 15, 128)):
            a = _random_field(spec, (n // 2,), gen, device)
            for lp in range(top.bit_length()):
                cases.append((f"2^{n.bit_length() - 1} ladder stage, period {1 << lp}", a, _random_field(spec, (1 << lp,), gen, device)))
        for elems in SHARDED_LADDER:
            a = _random_field(spec, (elems,), gen, device)
            for lp in range(8):
                cases.append((f"sharded ladder stage {_elems(elems)}, period {1 << lp}", a, _random_field(spec, (1 << lp,), gen, device)))
        small = _random_field(spec, (5, 1 << 11), gen, device).movedim(1, 0).contiguous()
        ragged = _random_field(spec, (3, 1001), gen, device).movedim(1, 0).contiguous()
        wide_ragged = _random_field(spec, (131, 1001), gen, device).movedim(1, 0).contiguous()  # >= 2^17 elements
        for tag, x in (("5 x 2^11", small), ("3 x 1001", ragged), ("131 x 1001", wide_ragged)):
            full = _random_field(spec, (x.shape[0], x.shape[-1]), gen, device).movedim(1, 0).contiguous()
            cases += [(f"{tag}, full-width b", x, full), (f"{tag}, strided columns", x[::2], full[::2]),
                      (f"{tag}, one element", x, n_inv)]
        for label, a, b in cases:
            check(f"mont_mul_columns {spec.name} {label}", spec, a, b)
        print(f"[kernels] mont_mul_columns {spec.name}: equal to plain in {len(cases)} cases", flush=True)
        if spec is not BN254_FR:
            continue
        timed = ("2^15 ladder stage, period 64", f"sharded ladder stage {_elems(SHARDED_LADDER[0])}, period 64")
        for label, a, b in cases[:2] + [c for c in cases if c[0] in timed]:
            cols, n = (1, a.shape[-1]) if a.dim() == 2 else (a.shape[0], a.shape[-1])
            bound = _bound(*_mul_columns_work(n, cols, b.shape[-1] if b.dim() == 2 else n * cols))
            t_d = _kernel_device_ms(lambda: mont_mul_columns(spec, a, b), "mont_mul_kernel", bound[0])
            print(
                f"[kernels] mont_mul_columns bn254_fr {label}: {t_d:.4f} ms on the device in one launch, "
                f"bound {bound[0]:.6f} ms ({bound[1]}, {bound[0] / t_d:.0%} of it)",
                flush=True,
            )


def _check_mul_chain(device) -> None:
    """The chained-product microbenchmark: one thread's CHAIN_ITERS
    Montgomery products x <- x * b with cc::mul, the carry chains of the
    curve kernels, jac_horner and mont_pow (mul_chain), equal to Python
    ints, and the time a product: CUDA events around one launch of
    CHAIN_ITERS products less one of none (the launch's own cost), medians
    of 5, over CHAIN_ITERS.  (The profiler's interval of this 2 ms
    one-thread launch read half of that in some profiles, and none in
    others.)"""
    import torch

    from halo2_tpu_torch.field import cuda_mul
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP

    def launch_ms(spec, a, b, iters):
        times = []
        for _ in range(5):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            cuda_mul.mul_chain(spec, a, b, iters)
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    for spec in (BN254_FQ, BN254_FR, PASTA_FP):
        p = spec.p
        df = get_device_field(spec)
        av, bv = random.Random(1).randrange(p), random.Random(2).randrange(p)
        a, b = df.encode([av], to_mont=False, device=device), df.encode([bv], to_mont=False, device=device)
        want, rinv = av, pow(1 << 256, -1, p)
        for _ in range(CHAIN_ITERS):
            want = want * bv * rinv % p
        got = cuda_mul.mul_chain(spec, a, b, CHAIN_ITERS)
        if df.decode(got.cpu(), from_mont=False) != [want]:
            raise AssertionError(f"mul_chain {spec.name}: differs from Python ints")
        us = (launch_ms(spec, a, b, CHAIN_ITERS) - launch_ms(spec, a, b, 0)) * 1e3 / CHAIN_ITERS
        print(
            f"[kernels] chained product {spec.name}, one thread, {CHAIN_ITERS} products: "
            f"cc {us:.4f} us a product (equal to Python ints)",
            flush=True,
        )


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


def _check_small_ntt(device, gen, err, times) -> None:
    """ntt_small_stages below 512 points (the whole transform a launch,
    natural order in) against its plain version, limb for limb: n = 1 ..
    256 on batches of C = 1 and 3 columns for BN254 Fr and Pasta Fp, and
    every SMALL_NTT_SHAPES batch (BN254 Fr), forward and inverse; then the
    device time per launch of the W = 1 sharded shapes beside their bound,
    and the time a call of the two local transforms of a W = 1 sharded 2^15
    NTT (CUDA events) against their plain versions."""
    from halo2_tpu_torch.field.params import BN254_FR, PASTA_FP
    from halo2_tpu_torch.poly import cuda_ntt
    from halo2_tpu_torch.poly.domain import twiddle_table

    def check(spec, cols, n):
        x = _random_field(spec, (cols, n), gen, device).movedim(1, 0).contiguous()
        for inverse in (False, True):
            tw = twiddle_table(spec, n, inverse, device)
            got = cuda_ntt.ntt_small_stages(spec, x, tw)
            e = _max_abs_err(f"ntt_small_stages {spec.name} C={cols} n={n} inv={inverse}", got,
                             cuda_ntt.ntt_small_stages_plain(spec, x, tw))
            err["ntt_small_stages"] = max(err["ntt_small_stages"], e)
        return x

    for spec in (BN254_FR, PASTA_FP):
        for n in (1 << k for k in range(9)):
            for cols in (1, 3):
                check(spec, cols, n)
    shaped = {shape: check(BN254_FR, *shape) for shape in SMALL_NTT_SHAPES}
    print(
        f"[kernels] ntt_small_stages below 512 points: equal to plain for n = 1 .. 256 at C = 1, 3 (bn254_fr, "
        f"pasta_fp) and at the sharded shapes (C, n) {list(SMALL_NTT_SHAPES)}, forward and inverse",
        flush=True,
    )
    spec = BN254_FR
    for cols, n in SMALL_NTT_SHAPES[:4]:
        x = shaped[(cols, n)]
        tw = twiddle_table(spec, n, False, device)
        bound = _ntt_bounds(n, cols)["ntt_small_stages"]
        t_d = _kernel_device_ms(lambda: cuda_ntt.ntt_small_stages(spec, x, tw), "ntt_small_stages_kernel", bound[0])
        times[("ntt_small_stages", spec.name, cols, n)] = t_d
        print(
            f"[kernels] ntt_small_stages bn254_fr C={cols} n={n}: {t_d:.4f} ms a launch on the device, bound "
            f"{bound[0]:.6f} ms ({bound[1]}, {bound[0] / t_d:.0%} of it)",
            flush=True,
        )
    pair = [(shaped[s], twiddle_table(spec, s[1], False, device)) for s in SMALL_NTT_SHAPES[2:4]]
    t_k = _ms_per_call(lambda: [cuda_ntt.ntt_small_stages(spec, x, tw) for x, tw in pair], 20)
    t_p = _ms_per_call(lambda: [cuda_ntt.ntt_small_stages_plain(spec, x, tw) for x, tw in pair], 1, runs=3)
    print(
        f"[kernels] ntt_small_stages, the W = 1 sharded 2^15 NTT's two local transforms (C, n) "
        f"{list(SMALL_NTT_SHAPES[2:4])}: kernel {t_k:.4f} ms a call (CUDA events), plain {t_p:.4f} ms",
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


def _msm_batch(device, gen, n: int, sets: int):
    """The inputs msm_chunk_acc and jac_suffix_scan get from one batch of
    ``sets`` random scalar sets over n points of the k = 16 SRS (tiled past
    2^16), as ec/device.py:_msm_wsums_raw makes them: the points and the
    rows' sorted entries (point indices and signs), chunked."""
    import numpy as np
    import torch

    from halo2_tpu_torch.ec import device as ecd
    from halo2_tpu_torch.field.params import BN254_FR
    from halo2_tpu_torch.kzg.params import ParamsKZG

    srs = ParamsKZG.load(SRS16)
    reps = -(-n // srs.n)
    px, py = (torch.from_numpy(np.tile(a, (1, reps))[:, :n].copy().view(np.int32)).to(device) for a in (srs.g1_x, srs.g1_y))
    sc = _random_field(BN254_FR, (sets, n), gen, device).movedim(1, 0)
    c, q = ecd._msm_c(n), ecd._q_rounds(n)
    digits, signs = ecd._signed_digits(ecd._digits_from_limbs(sc, c), c)
    rows = digits.shape[0] * digits.shape[1]
    chunks = max(1, n // q)
    _, order, sign = ecd._sorted_entries(digits.reshape(rows, n), signs.reshape(rows, n), n // chunks)
    return px, py, order, sign


def _chunk_acc_work(px, order, sfx_z) -> tuple:
    """(bytes, IMADs) of one msm_chunk_acc launch: the points, entries and
    outputs each moved once; a madd's 7 products and 4 squares for every
    round whose accumulator is finite (from the plain version's running
    sums: a chunk's first round and a round after a P == -Q sum copy)."""
    from halo2_tpu_torch.ec import device as ecd

    rows, q, chunks = order.shape
    finite = int((~ecd.df().is_zero(sfx_z.reshape(16, rows, q, chunks)[:, :, 1:])).sum())
    nbytes = 2 * ELEM * px.shape[1] + 5 * order.numel() + 3 * ELEM * rows * chunks * (q + 1)
    return nbytes, finite * (7 * IMAD_MUL + 4 * IMAD_SQR)


def _scan_work(rows: int, chunks: int) -> tuple:
    """(bytes, IMADs) of the exclusive suffix scan of rows x chunks points:
    each point read and written once; the sequential scan's adds of two
    finite points, chunks - 2 a row (add-2007-bl: 12 products, 4 squares)."""
    return 6 * ELEM * rows * chunks, rows * max(0, chunks - 2) * (12 * IMAD_MUL + 4 * IMAD_SQR)


def _scan_symbol(schedule) -> str:
    """The kernel symbol of a tile pass in ``schedule``."""
    return f"jac_suffix_scan_{schedule[0]}_kernel"


def _scan_device_ms(tot, schedule=None) -> tuple:
    """Device time of one jac_suffix_scan call over ``tot``, each level in
    ``schedule`` (None: scan_plan's): each of its launches timed alone
    (_kernel_device_ms: the median of the recorded launches, so a profile
    that dropped some events still reads), summed.  Returns (ms,
    launches)."""
    from halo2_tpu_torch.ec import cuda_jac

    rows, chunks = tot.shape[2:]
    sched = cuda_jac._plan(schedule)(rows, chunks)
    T, k = cuda_jac.scan_tile(chunks, sched)
    tiles = lambda: cuda_jac._scan_tiles_cuda(tot, sched, T, k, chunks > T)  # noqa: E731
    ms = _kernel_device_ms(tiles, _scan_symbol(sched), 0.0)
    if chunks <= T:
        return ms, 1
    excl, sums = tiles()
    inner, launches = _scan_device_ms(sums, schedule)
    suffix = cuda_jac._jac_suffix_scan(sums, schedule)
    offsets = _kernel_device_ms(lambda: cuda_jac._scan_offsets_cuda(excl, suffix, T), "jac_suffix_scan_offsets_kernel", 0.0)
    return ms + inner + offsets, launches + 2


def _scan_call_ms(tot, runs: int = 10) -> tuple:
    """Device time of one jac_suffix_scan_cuda call over ``tot``, all its
    launches: CUDA events around the call, queued behind a ~1 ms spin
    kernel (torch.cuda._sleep) so that the events time the card and not
    the host's launches; the median of ``runs`` calls.  (torch.profiler
    drops some launches of a window of calls, which a sum over launches
    cannot tell from a faster call.)  Returns (ms, launches a call).  It
    uses only the wrapper, so it also times an older checkout."""
    import torch

    from halo2_tpu_torch.ec import cuda_jac

    cuda_jac.jac_suffix_scan_cuda(tot)
    torch.cuda.synchronize()
    before = cuda_jac.LAUNCHES["jac_suffix_scan"]
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        cuda_jac.jac_suffix_scan_cuda(tot)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times), (cuda_jac.LAUNCHES["jac_suffix_scan"] - before) // runs


def _scan_chain(rows: int, chunks: int, schedule=None) -> int:
    """Dependent complete adds on the scan's longest path, each level in
    ``schedule`` (None: scan_plan's): a tile's log2(T / k) Kogge-Stone
    steps, and k - 1 adds before them and after them where a thread holds k
    chunks; one offsets add a level above the first."""
    from halo2_tpu_torch.ec import cuda_jac

    sched = cuda_jac._plan(schedule)(rows, chunks)
    T, k = cuda_jac.scan_tile(chunks, sched)
    steps = (T // k).bit_length() - 1 + 2 * (k - 1)
    return steps if chunks <= T else steps + 1 + _scan_chain(rows, -(-chunks // T), schedule)


def _scan_name(schedule) -> str:
    return "cluster" if schedule[0] == "cluster" else f"k={schedule[1]}"


def _check_scan_schedules(s, label: str, err: dict) -> None:
    """jac_suffix_scan over ``s`` in scan_plan's schedule and in each of
    SCAN_SCHEDULES forced at every level, each limb for limb against its
    plain version; the plain version runs once for each distinct order
    (each level's (T, k): the cluster's is k = 1's)."""
    from halo2_tpu_torch.ec import cuda_jac

    rows, chunks = s.shape[2:]
    plain = {}
    for schedule in (None,) + cuda_jac.SCAN_SCHEDULES:
        plan, c, order = cuda_jac._plan(schedule), chunks, ()
        while True:
            T, k = cuda_jac.scan_tile(c, plan(rows, c))
            order += ((T, k),)
            if c <= T:
                break
            c = -(-c // T)
        if order not in plain:
            plain[order] = cuda_jac._scan_plain(s, schedule)
        got = cuda_jac._jac_suffix_scan(s, schedule)
        name = "scan_plan's" if schedule is None else _scan_name(schedule)
        err["jac_suffix_scan"] = max(err["jac_suffix_scan"], _max_abs_err(f"jac_suffix_scan {label} {name}", got, plain[order]))


def _check_msm_kernels(device, gen, err, times) -> dict:
    """msm_chunk_acc (in acc_plan's schedule and in each of ACC_SCHEDULES
    forced, each forced one timed at ACC_SCHEDULES_TIMED) and
    jac_suffix_scan against their plain versions, limb for limb, at every
    MSM_CASES batch, with each one's device time a call beside its bound
    and its chain; exception
    lanes at the flagship's one-set batch (a (0, 0) point, a y = 0 point, a
    chunk adding one point twice (P == Q), one adding a point and its
    negative (P == -Q), one adding a y = 0 point eight times, one starting
    at the (0, 0) point) and the scan
    at SCAN_RAGGED chunk counts with P == Q, P == -Q and infinite chunks.
    Returns the bounds at MSM_REPORT."""
    import torch

    from halo2_tpu_torch.ec import cuda_jac
    from halo2_tpu_torch.ec import device as ecd

    bounds = {}
    for n, batches in MSM_CASES:
        for sets in batches:
            px, py, order, sign = _msm_batch(device, gen, n, sets)
            cases = [("", px, py, order, sign)]
            if (n, sets) == (1 << 11, 1):
                ex = [t.clone() for t in (px, py, order, sign)]
                ex[0][:, 3] = ex[1][:, 3] = 0
                ex[1][:, 5] = 0
                # entry pos of chunk c at [row, pos, c]; the rounds run from pos q - 1 down
                ex[2][0, -2, 0], ex[3][0, -2, 0] = ex[2][0, -1, 0], ex[3][0, -1, 0]
                ex[2][0, -2, 1], ex[3][0, -2, 1] = ex[2][0, -1, 1], ~ex[3][0, -1, 1]
                ex[2][1, :, 0], ex[3][1, :, 0] = 5, True
                ex[2][1, -1, 1] = 3
                cases.append((" exceptions", *ex))
            rows, q, chunks = order.shape
            label = f"n=2^{n.bit_length() - 1} B={sets} ({rows} rows x {chunks} chunks x {q})"
            for tag, cpx, cpy, corder, csign in reversed(cases):  # the general batch last: its results stay
                want = cuda_jac.msm_chunk_acc_plain(cpx, cpy, corder, csign)
                for schedule in (None,) + cuda_jac.ACC_SCHEDULES:
                    got = cuda_jac.msm_chunk_acc_cuda(cpx, cpy, corder, csign, schedule)
                    for what, g, w in zip(("sfx", "tot"), got, want):
                        err["msm_chunk_acc"] = max(
                            err["msm_chunk_acc"],
                            _max_abs_err(f"msm_chunk_acc {label}{tag} {schedule or 'acc_plan'} {what}", g, w),
                        )
            nbytes, imads = _chunk_acc_work(px, order, want[0][2])
            del want
            bound = _bound(nbytes, imads)
            kernel = lambda: cuda_jac.msm_chunk_acc_cuda(px, py, order, sign)  # noqa: E731
            plan = cuda_jac.acc_plan(rows, chunks)
            t_d = _kernel_device_ms(kernel, f"msm_chunk_acc_{plan}_kernel", bound[0])
            each = {}
            if (n, sets) in ACC_SCHEDULES_TIMED:
                each = {
                    schedule: _kernel_device_ms(
                        lambda: cuda_jac.msm_chunk_acc_cuda(px, py, order, sign, schedule),
                        f"msm_chunk_acc_{schedule}_kernel", bound[0],
                    )
                    for schedule in cuda_jac.ACC_SCHEDULES
                }
            if (n, sets) == MSM_REPORT:
                bounds["msm_chunk_acc"] = bound
                times[("msm_chunk_acc", MSM_REPORT)] = (
                    _ms_per_call(kernel, 20), _ms_per_call(lambda: cuda_jac.msm_chunk_acc_plain(px, py, order, sign), 1, runs=3),
                )
            print(
                f"[kernels] msm_chunk_acc {label}: every schedule equal to plain; acc_plan's {plan} {t_d:.4f} ms on "
                f"the device, bound {bound[0]:.6f} ms ({bound[1]}, {bound[0] / t_d:.1%} of it); chain {q} dependent "
                "madds a lane"
                + ("; each schedule: " + ", ".join(f"{k} {v:.4f} ms ({bound[0] / v:.1%})" for k, v in each.items())
                   if each else ""),
                flush=True,
            )
            tot = got[1]
            sbound = _bound(*_scan_work(rows, chunks))
            _check_scan_schedules(tot, label, err)
            each = {}
            if n == SCHEDULES_TIMED_N:
                each = {schedule: _scan_device_ms(tot, schedule)[0] for schedule in cuda_jac.SCAN_SCHEDULES}
            t_d, launches = _scan_device_ms(tot)
            if t_d < sbound[0]:
                raise AssertionError(f"jac_suffix_scan {label}: {t_d} ms on the device, below its bound")
            if (n, sets) == MSM_REPORT:
                bounds["jac_suffix_scan"] = sbound
                times[("jac_suffix_scan", MSM_REPORT)] = (
                    _ms_per_call(lambda: cuda_jac.jac_suffix_scan_cuda(tot), 20),
                    _ms_per_call(lambda: cuda_jac.jac_suffix_scan_plain(tot), 1, runs=3),
                )
            chain = _scan_chain(rows, chunks)
            plan = cuda_jac.scan_plan(rows, chunks)
            print(
                f"[kernels] jac_suffix_scan {label}: every schedule equal to plain; scan_plan's {_scan_name(plan)} "
                f"{t_d:.4f} ms on the device in {launches} launches, bound {sbound[0]:.6f} ms ({sbound[1]}, "
                f"{sbound[0] / t_d:.1%} of it); chain {chain} dependent adds, {t_d * 1e3 / chain:.2f} us each"
                + ("; each schedule at every level: " + ", ".join(f"{_scan_name(k)} {v:.4f}" for k, v in each.items())
                   + " ms" if each else ""),
                flush=True,
            )
    # the scan at ragged chunk counts, exception chunks included
    px, py, order, sign = _msm_batch(device, gen, 1 << 11, 1)
    base = cuda_jac.msm_chunk_acc_cuda(px, py, order, sign)[1][:, :, :2].contiguous()  # (3, 16, 2, 256)
    inf = torch.stack(list(ecd.jac_infinity((), device=device).values()))[:, :, None]
    neg = ecd.df().neg(base[1, :, 0, 3].contiguous())
    for chunks in SCAN_RAGGED:
        s = base.repeat(1, 1, 1, -(-chunks // base.shape[-1]))[..., :chunks].contiguous()
        if chunks > 4:
            s[:, :, 0, 1] = s[:, :, 0, 0]  # P == Q
            s[:, :, 0, 2], s[1, :, 0, 2] = s[:, :, 0, 3], neg  # P == -Q
            s[:, :, 1, chunks // 2] = inf[:, :, 0]
            s[:, :, 1, -1] = inf[:, :, 0]
        _check_scan_schedules(s, f"C={chunks}", err)
    print(
        f"[kernels] jac_suffix_scan at C={list(SCAN_RAGGED)}, P == Q, P == -Q and infinite chunks, scan_plan's "
        "schedule and each of SCAN_SCHEDULES at every level: equal to plain",
        flush=True,
    )
    return bounds


def _horner_windows(device, c: int, windows: int, batch: int):
    """(3, 16, batch, windows) window sums on the card, from the k = 16
    SRS's points doubled (z != 1): window 3 of every lane at infinity; lane
    0's second window 2^c times its top one (the accumulator equals it:
    P == Q), lane 1's its negative (P == -Q), lane 2's top three windows at
    infinity (a leading run)."""
    import numpy as np
    import torch

    from halo2_tpu_torch.ec import device as ecd
    from halo2_tpu_torch.kzg.params import ParamsKZG

    srs = ParamsKZG.load(SRS16)
    n = batch * windows
    x, y = (torch.from_numpy(np.ascontiguousarray(a[:, :n]).view(np.int32)).to(device) for a in (srs.g1_x, srs.g1_y))
    pts = ecd.jac_double(ecd.jac_from_affine(x, y))
    w = torch.stack([pts[k] for k in ("x", "y", "z")]).reshape(3, 16, batch, windows).contiguous()
    top = {k: w[i, :, :, -1].contiguous() for i, k in enumerate(("x", "y", "z"))}
    for _ in range(c):
        top = ecd.jac_double(top)
    inf = torch.stack(list(ecd.jac_infinity((), device=device).values()))
    w[:, :, :, 3] = inf[:, :, None]
    w[:, :, 0, -2] = torch.stack([top[k][:, 0] for k in ("x", "y", "z")])
    if batch > 1:
        w[:, :, 1, -2] = torch.stack([top["x"][:, 1], ecd.df().neg(top["y"])[:, 1], top["z"][:, 1]])
    if batch > 2:
        w[:, :, 2, -3:] = inf[:, :, None]
    return w


def _horner_work(w, c: int) -> tuple:
    """(bytes, IMADs, chain) of one jac_horner call over the window sums w
    at c bits, counting what this data needs (the Horner replayed on the
    host): each window sum read once and each lane's point written once; c
    doublings (dbl-2009-l: 5 squares, 2 products) a window only while the
    lane's accumulator is finite; for a finite window sum on a finite
    accumulator the complete add's 12 products and 4 squares, or, where the
    two are equal, the 6 products and 2 squares that find it and one
    doubling, or, where they are opposite, those 6 and 2 alone (the sum is
    infinity); nothing where either is infinity.  The chain is the longest
    lane's dependent products: 3 a doubling, 5 an add, 2 to find P == +-Q."""
    from halo2_tpu_torch.ec import host as ec
    from halo2_tpu_torch.ec.device import df
    from halo2_tpu_torch.field.params import BN254_FQ

    q = BN254_FQ.p
    batch, windows = w.shape[2], w.shape[3]
    x, y, z = (df().decode(w[i].reshape(16, -1).cpu()) for i in range(3))
    dbl, add, find = 2 * IMAD_MUL + 5 * IMAD_SQR, 12 * IMAD_MUL + 4 * IMAD_SQR, 6 * IMAD_MUL + 2 * IMAD_SQR
    imads = chain = 0
    for b in range(batch):
        acc, depth = None, 0
        for i in reversed(range(windows)):
            if acc is not None:
                for _ in range(c):
                    acc = ec.ec_double(acc)
                imads += c * dbl
                depth += 3 * c
            j = b * windows + i
            zi = pow(int(z[j]), -1, q) if int(z[j]) % q else None
            if zi is None:
                continue
            pt = ec.g1_from_ints(int(x[j]) * zi * zi % q, int(y[j]) * zi * zi * zi % q)
            if acc is None:
                acc = pt
            elif acc == pt:
                imads += find + dbl
                depth += 2 + 3
                acc = ec.ec_double(acc)
            elif acc[0] == pt[0]:
                imads += find
                depth += 2
                acc = None
            else:
                imads += add
                depth += 5
                acc = ec.ec_add(acc, pt)
        chain = max(chain, depth)
    return 3 * ELEM * batch * (windows + 1), imads, chain


def _pow_work(m: int, e: int) -> tuple:
    """(bytes, IMADs) of one mont_pow over m elements: each read once and
    written once; e.bit_length() - 1 squares and popcount(e) - 1 products an
    element."""
    return 2 * ELEM * m, ((e.bit_length() - 1) * IMAD_SQR + (bin(e).count("1") - 1) * IMAD_MUL) * m


def _check_ladders(device, gen, err, times) -> dict:
    """jac_horner and mont_pow against their plain versions, limb for limb:
    the Horner at every window size and lane count of HORNER_CASES (the
    exception windows of _horner_windows); the power for BN254 Fr, BN254
    Fq and Pasta Fp at POW_SIZES elements (0, 1, p - 1 and p - 2 first)
    with the exponents p - 2, 0, 1, 2 and a 300-bit one.  Each kernel's
    device time per launch at every timed shape beside its throughput bound
    and its chain of dependent products; kernel and plain version per call
    at the report shapes.  Returns the bounds at the report shapes."""
    import torch

    from halo2_tpu_torch.ec import cuda_jac
    from halo2_tpu_torch.field import cuda_mul
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP

    bounds = {}
    _check_mul_chain(device)
    for c, batches in HORNER_CASES:
        windows = -(-254 // c)
        # the lanes are independent, so one plain run (~8 s on the card) over
        # the widest stack gives every narrower one's expected lanes
        w_all = _horner_windows(device, c, windows, max(batches))
        want = cuda_jac.horner_plain(w_all, c)
        for batch in batches:
            w = w_all[:, :, :batch].contiguous()
            with _FlagReads() as flags:
                got = cuda_jac.jac_horner_cuda(w, c)
            if flags.reads:
                raise AssertionError(f"jac_horner c={c} B={batch}: {flags.reads} P == Q flag reads")
            for k in ("x", "y", "z"):
                diff = _max_abs_err(f"jac_horner c={c} B={batch} {k}", got[k], want[k][:, :batch].contiguous())
                err["jac_horner"] = max(err["jac_horner"], diff)
            nbytes, imads, chain = _horner_work(w, c)
            bound = _bound(nbytes, imads)
            kernel = lambda: cuda_jac.jac_horner_cuda(w, c)  # noqa: E731
            if (c, batch) == (HORNER_REPORT_C, HORNER_REPORT_B):
                bounds["jac_horner"] = bound
                t_d = _time_kernel(
                    "jac_horner", "jac_horner_kernel", batch, kernel, lambda: cuda_jac.horner_plain(w, c),
                    times, bound[0], plain_calls=1, plain_runs=1,
                )
            else:
                t_d = _kernel_device_ms(kernel, "jac_horner_kernel", bound[0])
            print(
                f"[kernels] jac_horner B={batch}, {windows} windows, c={c}: equal to plain, no flag reads; "
                f"{t_d:.4f} ms on the device; throughput bound {bound[0]:.6f} ms ({bound[1]}, "
                f"{bound[0] / t_d:.2%} of it); chain {chain} dependent products on the longest lane, "
                f"{t_d * 1e3 / chain:.3f} us each",
                flush=True,
            )
    rnd = random.Random(300).randrange(1 << 299, 1 << 300)
    for spec in (BN254_FR, BN254_FQ, PASTA_FP):
        p = spec.p
        edges = get_device_field(spec).encode([0, 1, p - 1, p - 2], device=device)
        for m in POW_SIZES + INV_BATCHED:
            a = _random_field(spec, (m,), gen, device)
            a[:, : min(4, m)] = edges[:, : min(4, m)]
            if m in POW_SIZES:
                for e in (p - 2, 0, 1, 2, rnd):
                    got = cuda_mul.mont_pow(spec, a, e)
                    e_err = _max_abs_err(f"mont_pow {spec.name} m={m} e={e:#x}"[:80], got, cuda_mul.mont_pow_plain(spec, a, e))
                    err["mont_pow"] = max(err["mont_pow"], e_err)
            inv, want = cuda_mul.mont_inv(spec, a), cuda_mul.mont_inv_plain(spec, a)
            err["mont_inv"] = max(err["mont_inv"], _max_abs_err(f"mont_inv {spec.name} m={m}", inv, want))
            for group in cuda_mul.INV_GROUPS:
                got = cuda_mul._mont_inv(spec, a, group)
                err["mont_inv"] = max(err["mont_inv"], _max_abs_err(f"mont_inv {spec.name} m={m} G={group}", got, want))
            if m in POW_SIZES:
                _max_abs_err(f"mont_inv {spec.name} m={m} against the mont_pow kernel's a^(p - 2)", inv, cuda_mul.mont_pow(spec, a, p - 2))
            if spec is BN254_FR and m > 1:
                _time_inverses(spec, a, m, times, bounds)
        print(
            f"[kernels] mont_pow {spec.name}: equal to plain at m={list(POW_SIZES)}, five exponents; mont_inv "
            f"equal to plain with inv_plan's G and with each G of {list(cuda_mul.INV_GROUPS)} at "
            f"m={list(POW_SIZES + INV_BATCHED)}, and to mont_pow(a, p - 2) at m={list(POW_SIZES)} (0, 1, p - 1, "
            "p - 2 first)",
            flush=True,
        )
    return bounds


def _time_inverses(spec, a, m: int, times, bounds) -> None:
    """mont_inv(a), BN254 Fr, m elements, with inv_plan's G and with each
    G of INV_GROUPS: each one's device time per launch in this call
    beside its throughput bound, its share of it and its cycles a divstep
    (at SM_HZ); at POW_SIZES also mont_pow(a, p - 2) beside it; at
    POW_REPORT_M also each kernel's and plain version's time a call (the
    JSON line's) and the most divsteps a lane of a needs."""
    from halo2_tpu_torch.field import cuda_mul

    p = spec.p
    inv_bound, inv_chain = _inv_bound(m), _inv_work(m)[2]
    plan = cuda_mul.inv_plan(m)
    power = lambda: cuda_mul.mont_pow(spec, a, p - 2)  # noqa: E731
    inverse = lambda: cuda_mul.mont_inv(spec, a)  # noqa: E731
    t_pow = None
    if m == POW_REPORT_M:
        pow_bound = _bound(*_pow_work(m, p - 2))
        bounds["mont_pow"], bounds["mont_inv"] = pow_bound, inv_bound
        t_pow = _time_kernel("mont_pow", "mont_pow_kernel", m, power,
                             lambda: cuda_mul.mont_pow_plain(spec, a, p - 2), times, pow_bound[0], plain_calls=1)
        t_inv = _time_kernel("mont_inv", "mont_inv_kernel", m, inverse,
                             lambda: cuda_mul.mont_inv_plain(spec, a), times, inv_bound[0], plain_calls=1)
    else:
        if m in POW_SIZES:
            pow_bound = _bound(*_pow_work(m, p - 2))
            t_pow = _kernel_device_ms(power, "mont_pow_kernel", pow_bound[0])
        t_inv = _kernel_device_ms(inverse, "mont_inv_kernel", inv_bound[0])
    if t_pow is not None:
        steps = (p - 2).bit_length() - 1 + bin(p - 2).count("1") - 1
        print(
            f"[kernels] mont_pow bn254_fr m={m}, e = p - 2: {t_pow:.4f} ms on the device; throughput "
            f"bound {pow_bound[0]:.6f} ms ({pow_bound[1]}, {pow_bound[0] / t_pow:.2%} of it); chain {steps} dependent "
            f"products an element, {t_pow * 1e3 / steps:.3f} us each",
            flush=True,
        )
    sched = []
    for group in cuda_mul.INV_GROUPS:  # the plan's G is t_inv; the other is forced
        t_s = t_inv if group == plan else _kernel_device_ms(
            lambda: cuda_mul._mont_inv(spec, a, group), "mont_inv_kernel", inv_bound[0])
        sched.append(
            f"G={group} {t_s:.4f} ms ({inv_bound[0] / t_s:.2%}, "
            f"{t_s * 1e-3 * SM_HZ / inv_chain:.1f} cycles a divstep)"
        )
    needed = f"; the most divsteps a lane of this data needs: {_divsteps_needed(a, spec)}" if m == POW_REPORT_M else ""
    than_pow = f" ({t_pow / t_inv:.1f}x faster than mont_pow's {t_pow:.4f} in this call)" if t_pow else ""
    print(
        f"[kernels] mont_inv bn254_fr m={m}: {t_inv:.4f} ms on the device with inv_plan's G={plan}{than_pow}; "
        f"throughput bound {inv_bound[0]:.6f} ms ({inv_bound[1]}, {inv_bound[0] / t_inv:.2%} of it; "
        f"{_inv_bound(m, INV_SLOTS_STEPWISE)[0] / t_inv:.2%} of the step-at-a-time count, {INV_SLOTS_STEPWISE} slots an "
        f"element); chain "
        f"{inv_chain} dependent divsteps on every lane (and {cuda_mul.INV_BATCHES} matrix applications, one "
        f"product), {t_inv * 1e3 / inv_chain:.4f} us, {t_inv * 1e-3 * SM_HZ / inv_chain:.1f} cycles a divstep{needed}; "
        f"each G: " + "; ".join(sched),
        flush=True,
    )


def _inv_work(m: int) -> tuple:
    """(bytes, issue slots, chain) of one mont_inv over m elements: each
    element read once and written once; the least instruction issue slots
    of its fixed-count table-jump safegcd (INV_*_SLOTS); the chain is the
    divsteps every lane runs, one after another (the count does not depend
    on the data)."""
    from halo2_tpu_torch.field import cuda_mul

    singles = cuda_mul.INV_STEPS - cuda_mul.INV_JUMP * cuda_mul.INV_JUMPS
    batch = cuda_mul.INV_JUMPS * INV_JUMP_SLOTS + singles * INV_DIVSTEP_SLOTS + INV_BATCH_SLOTS
    slots = cuda_mul.INV_BATCHES * batch + INV_TAIL_SLOTS + IMAD_MUL
    return 2 * ELEM * m, slots * m, cuda_mul.INV_BATCHES * cuda_mul.INV_STEPS


def _inv_bound(m: int, slots_per_elem: int | None = None) -> tuple:
    """Least time (ms) of one mont_inv over m elements and what bounds it:
    its bytes at BYTES_PER_S against its issue slots at 2 x IMAD_PER_S
    (``slots_per_elem`` in place of _inv_work's count: INV_SLOTS_STEPWISE for
    the share against the step-at-a-time count)."""
    nbytes, slots, _ = _inv_work(m)
    if slots_per_elem is not None:
        slots = slots_per_elem * m
    t_bytes, t_ops = nbytes / BYTES_PER_S * 1e3, slots / (2 * IMAD_PER_S) * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def _divsteps_needed(a, spec) -> int:
    """The most divsteps any element of the Montgomery array a needs before
    g reaches 0, in the kernel's half-delta divstep (zeta = -1 at the
    start), replayed on the host over exact integers: the margin of the
    fixed count on this data."""
    from halo2_tpu_torch.field.device import get_device_field

    df = get_device_field(spec)
    worst = 0
    for x in df.decode(a.cpu(), from_mont=False).reshape(-1):
        zeta, f, g, steps = -1, spec.p, int(x), 0
        while g:
            if zeta < 0 and g & 1:
                zeta, f, g = -zeta - 2, g, (g - f) >> 1
            else:
                zeta, g = zeta - 1, (g + f) >> 1 if g & 1 else g >> 1
            steps += 1
        worst = max(worst, steps)
    return worst


def _once_ms(fn):
    """fn()'s result and its time in ms: CUDA events around one call,
    synchronized (for the plain versions, too slow to call twice)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _events_ms(fn, bound_ms: float, calls: int) -> float:
    """Time of one call of fn(), which makes one kernel launch of a
    millisecond or so: CUDA events around ``calls`` back-to-back calls, the
    median of 3 runs after a warm-up (the host's share of a call, ~10 us,
    is ~1 % of these kernels).  torch.profiler is not used: late in phase 2,
    after long runs of plain versions, its profiles have come back without
    the launches.  A time below ``bound_ms`` raises."""
    t = _ms_per_call(fn, calls, runs=3)
    if t < bound_ms:
        raise AssertionError(f"{t:.6f} ms a call is below the bound {bound_ms:.6f} ms: not a time")
    return t


def _ladder_lanes(device, m: int):
    """jac_ladder's checked operands at m lanes: the k = 16 SRS's points
    doubled (z != 1) and random.Random(254) scalars below R as (256, m)
    uint8 bit rows; lane 0 the scalar 0, lane 1 the scalar 1, lane 2 R - 1,
    lane 3 an infinity base, lane 4 the bits of 2^254 mod R in rows 0-253
    and row 254 set (acc equals base at row 254: the add's P == Q)."""
    import torch

    from halo2_tpu_torch.ec import device as ecd
    from halo2_tpu_torch.ec import host as ec
    from halo2_tpu_torch.kzg.params import scalar_bits

    p = _curve_lanes(device, m, exceptions=False)[0]
    rng = random.Random(254)
    scalars = [rng.randrange(ec.R) for _ in range(m)]
    special = [0, 1, ec.R - 1, scalars[3 % m], (1 << 254) % ec.R + (1 << 254)]
    scalars[: min(5, m)] = special[: min(5, m)]
    if m > 3:
        for k, v in ecd.jac_infinity((), device=device).items():
            p[k][:, 3] = v
    return p, torch.from_numpy(scalar_bits(scalars)).to(device)


def _setup_inputs(device, m: int):
    """ParamsKZG.setup(16)'s ladder operands, its first m lanes: G on every
    lane and the bit rows of tau^i (tau from the setup's seed)."""
    import torch

    from halo2_tpu_torch.ec import device as ecd
    from halo2_tpu_torch.ec import host as ec
    from halo2_tpu_torch.field.params import BN254_FQ
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.kzg.params import scalar_bits

    tau = random.Random(0xD15C0).randrange(1, ec.R)
    powers = [1] * m
    for i in range(1, m):
        powers[i] = powers[i - 1] * tau % ec.R
    g = get_device_field(BN254_FQ).encode(list(ec.g1_to_ints(ec.G1)), device=device)
    base = ecd.jac_from_affine(g[:, :1].expand(16, m).contiguous(), g[:, 1:].expand(16, m).contiguous())
    return base, torch.from_numpy(scalar_bits(powers)).to(device)


def _ladder_work(bits) -> tuple:
    """(bytes, IMADs) of one jac_ladder over the (nbits, m) bit rows: each
    lane's point read once and its sum written once, the bit rows read
    once; nbits - 1 doublings (dbl-2009-l: 2 products, 5 squares) a lane
    and one complete add (12 products, 4 squares) a set bit."""
    nbits, m = bits.shape
    dbl, add = 2 * IMAD_MUL + 5 * IMAD_SQR, 12 * IMAD_MUL + 4 * IMAD_SQR
    adds = int((bits != 0).sum())
    return 6 * ELEM * m + bits.numel() * bits.element_size(), max(nbits - 1, 0) * dbl * m + add * adds


def _check_setup_ladder(device, err, times) -> dict:
    """jac_ladder against scalar_mul_batched_plain, limb for limb, with 256
    bit rows at LADDER_SIZES lanes (one plain run over the widest; the
    exception lanes of _ladder_lanes), on uint8 and int32 bits, reading no
    P == Q flag; its time a launch (_events_ms) at LADDER_TIMED lanes of the
    setup's own operands beside the bound of the work they need; kernel
    and plain version per call at the JSON line's 2^11.  Returns that
    bound."""
    import torch

    from halo2_tpu_torch.ec import cuda_jac

    p_all, bits_all = _ladder_lanes(device, max(LADDER_SIZES))
    want, plain_ms = _once_ms(lambda: cuda_jac.scalar_mul_batched_plain(p_all, bits_all))
    for m in LADDER_SIZES:
        p = {k: v[:, :m].contiguous() for k, v in p_all.items()}
        bits = bits_all[:, :m].contiguous()
        for b in (bits, bits.to(torch.int32)):
            with _FlagReads() as flags:
                got = cuda_jac.jac_ladder_cuda(p, b)
            if flags.reads:
                raise AssertionError(f"jac_ladder m={m}: {flags.reads} P == Q flag reads")
            for k in ("x", "y", "z"):
                label = f"jac_ladder m={m} {b.dtype} {k}"
                err["jac_ladder"] = max(err["jac_ladder"], _max_abs_err(label, got[k], want[k][:, :m].contiguous()))
    print(
        f"[kernels] jac_ladder m={list(LADDER_SIZES)}, 256 bit rows: equal to plain on uint8 and int32 bits "
        f"(lanes: 0, 1, R - 1, an infinity base, P == Q at row 254), no flag reads",
        flush=True,
    )
    bound = None
    for m in LADDER_TIMED:
        base, bits = _setup_inputs(device, m)
        b = _bound(*_ladder_work(bits))
        t_d = _events_ms(lambda: cuda_jac.jac_ladder_cuda(base, bits), b[0], calls=3)
        print(
            f"[kernels] jac_ladder m={m} (the setup's operands, 256 rows, {int((bits != 0).sum())} set bits): "
            f"bound {b[0]:.6f} ms ({b[1]}); {t_d:.4f} ms a launch (CUDA events), {b[0] / t_d:.1%} of the bound",
            flush=True,
        )
        if m == LADDER_REPORT_M:
            bound = b
            t_k = _ms_per_call(lambda: cuda_jac.jac_ladder_cuda(base, bits), 10, runs=3)
            times[("jac_ladder", m)] = (t_k, plain_ms)
            print(f"[kernels] jac_ladder m={m}: kernel {t_k:.4f} ms per call, plain {plain_ms:.1f} ms (one call, "
                  f"the check's operands)", flush=True)
    return {"jac_ladder": bound}


def _fixed_base_lanes(m: int, seed: int) -> list:
    """jac_fixed_base's checked scalars at m lanes: random.Random(seed)
    ones below 2^256, lanes 0-5 the scalars 0, 1, R - 1, R (the top window,
    bits 252 and up at w = 4 or 6, holds the digit 3 and meets -3 2^252 P:
    P == -Q, the sum infinity), 2^255 - R (the digit 4 meets 4 2^252 P:
    P == Q) and 2^256 - 1."""
    from halo2_tpu_torch.ec import host as ec

    rng = random.Random(seed)
    scalars = [rng.getrandbits(256) for _ in range(m)]
    special = [0, 1, ec.R - 1, ec.R, (1 << 255) - ec.R, (1 << 256) - 1]
    scalars[: min(len(special), m)] = special[: min(len(special), m)]
    return scalars


def _fixed_base_work(words, window: int) -> tuple:
    """(bytes, IMADs) of one jac_fixed_base over the (8, m) scalar words:
    the words read once, the table read once, the sums written once; a
    mixed add (7 products and 4 squares, 2,768 IMADs) for each nonzero
    digit after a lane's first (the first takes the entry as it is)."""
    from halo2_tpu_torch.ec import cuda_jac

    digits = cuda_jac.fixed_base_digits(words, window)
    m = words.shape[1]
    adds = int((digits != 0).sum()) - int((digits != 0).any(dim=0).sum())
    table = cuda_jac.fixed_base_windows(window) * ((1 << window) - 1) * 4 * cuda_jac.ENTRY_WORDS
    return 4 * 8 * m + table + 3 * ELEM * m, adds * (7 * IMAD_MUL + 4 * IMAD_SQR)


def _check_fixed_base(device, err, times) -> dict:
    """jac_fixed_base against fixed_base_mul_plain, limb for limb, at
    FIXED_BASE_SIZES lanes (one plain run over the widest) for G and for
    7 G, on _fixed_base_lanes' scalars, reading no P == Q flag; its time a
    launch (_events_ms) at FIXED_BASE_TIMED lanes of ParamsKZG.setup(16)'s
    own scalars (tau^i) beside its bound and the double-and-add's bound of
    the same scalars (_ladder_work); kernel and plain version per call at
    the JSON line's 2^16, where the two also agree.  Returns that bound."""
    import numpy as np
    import torch

    from halo2_tpu_torch.ec import cuda_jac
    from halo2_tpu_torch.ec import host as ec
    from halo2_tpu_torch.kzg.params import scalar_bits, scalar_words

    w = cuda_jac.FIXED_BASE_WINDOW
    top = max(FIXED_BASE_SIZES)
    words_all = torch.from_numpy(scalar_words(_fixed_base_lanes(top, 0xF1B)).view(np.int32)).to(device)
    for k in (1, 7):
        x, y = ec.g1_to_ints(ec.ec_mul(ec.G1, k))
        table = cuda_jac.fixed_base_table_tensor(x, y, w, device)
        want = cuda_jac.fixed_base_mul_plain(table, words_all)
        for m in FIXED_BASE_SIZES:
            words = words_all[:, :m].contiguous()
            with _FlagReads() as flags:
                got = cuda_jac.jac_fixed_base_cuda(table, words)
            if flags.reads:
                raise AssertionError(f"jac_fixed_base m={m}: {flags.reads} P == Q flag reads")
            for c in ("x", "y", "z"):
                label = f"jac_fixed_base {k} G m={m} {c}"
                err["jac_fixed_base"] = max(err["jac_fixed_base"], _max_abs_err(label, got[c], want[c][:, :m].contiguous()))
    print(
        f"[kernels] jac_fixed_base w={w}, m={list(FIXED_BASE_SIZES)}, G and 7 G: equal to plain (lanes: 0, 1, "
        f"R - 1, R (P == -Q in the top window), 2^255 - R (P == Q there), 2^256 - 1), no flag reads",
        flush=True,
    )
    tau = random.Random(0xD15C0).randrange(1, ec.R)
    powers = [1] * max(FIXED_BASE_TIMED)
    for i in range(1, len(powers)):
        powers[i] = powers[i - 1] * tau % ec.R
    gx, gy = ec.g1_to_ints(ec.G1)
    table = cuda_jac.fixed_base_table_tensor(gx, gy, w, device)
    bound = None
    for m in FIXED_BASE_TIMED:
        words = torch.from_numpy(scalar_words(powers[:m]).view(np.int32)).to(device)
        b = _bound(*_fixed_base_work(words, w))
        ladder = _bound(*_ladder_work(torch.from_numpy(scalar_bits(powers[:m]))))
        t_d = _events_ms(lambda: cuda_jac.jac_fixed_base_cuda(table, words), b[0], calls=5)
        print(
            f"[kernels] jac_fixed_base m={m} (the setup's scalars, w={w}): {t_d:.4f} ms a launch (CUDA events); "
            f"bound {b[0]:.6f} ms ({b[1]}, {b[0] / t_d:.1%} of it); the double-and-add's bound of the same "
            f"scalars {ladder[0]:.6f} ms ({ladder[1]})",
            flush=True,
        )
        if m == FIXED_BASE_REPORT_M:
            bound = b
            want, plain_ms = _once_ms(lambda: cuda_jac.fixed_base_mul_plain(table, words))
            got = cuda_jac.jac_fixed_base_cuda(table, words)
            for c in ("x", "y", "z"):
                _max_abs_err(f"jac_fixed_base setup m={m} {c}", got[c], want[c])
            t_k = _ms_per_call(lambda: cuda_jac.jac_fixed_base_cuda(table, words), 10, runs=3)
            times[("jac_fixed_base", m)] = (t_k, plain_ms)
            print(f"[kernels] jac_fixed_base m={m}: kernel {t_k:.4f} ms per call, equal to plain, plain "
                  f"{plain_ms:.1f} ms (one call)", flush=True)
    return {"jac_fixed_base": bound}


def _sponge_messages(spec, words: int, m: int, seed: int, device):
    """(words, 16, m) random canonical Montgomery limbs from
    random.Random(seed); lane 0 all zeros, lane 1 all p - 1."""
    import numpy as np
    import torch

    from halo2_tpu_torch.field.device import get_device_field

    rng = random.Random(seed)
    limbs = np.frombuffer(rng.randbytes(words * 16 * m * 2), np.uint16).reshape(words, 16, m).astype(np.int32)
    limbs[:, 15] %= spec.p >> 240
    x = torch.from_numpy(limbs).to(device)
    x[:, :, 0] = 0
    if m > 1:
        x[:, :, 1] = get_device_field(spec).encode([spec.p - 1], device=device)[:, 0]
    return x


def _sponge_work(spec, L: int | None, m: int) -> tuple:
    """(bytes, IMADs) of one poseidon_hash launch over m lanes: hashing
    (L words) reads the messages and writes the digests, permuting (L None)
    reads and writes W words; a permutation is W 2 r_f + r_p S-boxes (2
    squares and a product) and the fewest MDS products that give its
    output: W^2 a full round, and in the partial rounds the sparse form
    the kernel runs (one dense W x W matrix, then 2 W - 1 products a round:
    a row and a column); IMAD_MUL and IMAD_SQR each (the carry-chain arithmetic's count),
    ceil(L / rate) permutations a hash."""
    W, r_f, r_p = spec.width, spec.full_rounds() // 2, spec.partial_rounds()
    mds = 2 * r_f * W * W + W * W + r_p * (2 * W - 1)
    perm = (W * 2 * r_f + r_p) * (2 * IMAD_SQR + IMAD_MUL) + mds * IMAD_MUL
    if L is None:
        return 2 * W * ELEM * m, perm * m
    return (L + 1) * ELEM * m, perm * -(-L // spec.rate) * m


def _check_sponge(device, err, times) -> dict:
    """poseidon_hash against the plain versions, limb for limb, at
    SPONGE_SIZES lanes (one plain run over the widest) for each of
    SPONGE_CASES and permute_device alone for both widths; its time a
    launch (_events_ms) at SPONGE_TIMED lanes for BN254 Fr MySpec(5, 4), L = 4,
    beside the bound; kernel and plain version per call at the JSON line's
    2^11 (the plain version's one call, the check's).  Returns that bound."""
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FR, PASTA_FP
    from halo2_tpu_torch.poseidon import (
        MySpec,
        P128Pow5T3,
        hash_device,
        hash_device_plain,
        permute_device,
        permute_device_plain,
    )

    specs = {"MySpec(5, 4)": MySpec(5, 4), "P128Pow5T3": P128Pow5T3()}
    fields = {"bn254_fr": BN254_FR, "pasta_fp": PASTA_FP}
    top, plain_ms = max(SPONGE_SIZES), None
    for n, (field, name, L) in enumerate(SPONGE_CASES):
        spec, df = specs[name], get_device_field(fields[field])
        words = spec.width if L is None else L
        x = _sponge_messages(df.spec, words, top, 0x5B0 + n, device)
        if L is None:
            run, plain = lambda y: permute_device(df, spec, y), lambda y: permute_device_plain(df, spec, y)
        else:
            run, plain = lambda y: hash_device(df, spec, L, y), lambda y: hash_device_plain(df, spec, L, y)
        want, ms = _once_ms(lambda: plain(x))
        if (field, name, L) == ("bn254_fr", "MySpec(5, 4)", 4):
            plain_ms = ms
        for m in SPONGE_SIZES:
            got = run(x[..., :m].contiguous())
            label = f"poseidon_hash {field} {name} {'permute' if L is None else f'L={L}'} m={m}"
            err["poseidon_hash"] = max(err["poseidon_hash"], _max_abs_err(label, got, want[..., :m].contiguous()))
    print(f"[kernels] poseidon_hash: equal to plain at m={list(SPONGE_SIZES)} for {SPONGE_CASES} (L None: "
          f"permute_device)", flush=True)
    spec, df, L = specs["MySpec(5, 4)"], get_device_field(BN254_FR), 4
    bound = None
    for m in SPONGE_TIMED:
        x = _sponge_messages(df.spec, L, m, 0x5B1, device)
        b = _bound(*_sponge_work(spec, L, m))
        t_d = _events_ms(lambda: hash_device(df, spec, L, x), b[0], calls=5)
        print(
            f"[kernels] poseidon_hash bn254_fr MySpec(5, 4) L={L} m={m}: {t_d:.4f} ms a launch (CUDA events), "
            f"{m / t_d * 1e3:.4g} hashes/s; bound {b[0]:.6f} ms ({b[1]}, {b[0] / t_d:.1%} of it)",
            flush=True,
        )
        if m == SPONGE_REPORT_M:
            bound = b
            t_k = _ms_per_call(lambda: hash_device(df, spec, L, x), 20, runs=3)
            times[("poseidon_hash", m)] = (t_k, plain_ms)
            print(f"[kernels] poseidon_hash m={m}: kernel {t_k:.4f} ms per call, plain {plain_ms:.1f} ms (one "
                  f"call, the check's operands)", flush=True)
    return {"poseidon_hash": bound}


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
# The least instruction issue slots of one mont_inv element (csrc/inv.cu),
# counted low so that the bound is one, for one lane holding the whole
# matrix (a lane group splits the same work): a batch is INV_JUMPS table
# jumps of INV_JUMP divsteps at 22 slots each (the index 5: zeta clamped
# both ways, f's and g's low bits, the address; the entry 2 loads, as whole
# words; 4 products and 2 shifts on (f, g); 8 products on the matrix's two
# columns; 1 for zeta's affine map), its last single divsteps at 18 each
# (two conditions, the conditional adds to g, f, q, r, u, v, three shifts
# and zeta's update, the conditional negations fused into them), and 285
# for its matrix application (91 products accumulated in 64 bits, IMAD.WIDE
# at two slots each, and the 30-bit masks and 64-bit shifts of 17 limb
# steps); 100 for the limb conversions and the normalization; the closing
# product's IMAD_MUL.  The step-at-a-time safegcd this kernel replaced
# counted every divstep at 18 slots (16,872 an element, INV_SLOTS_STEPWISE):
# the shares against that count are printed beside, to compare with its.  Any 32-bit integer instruction may
# issue at 4 x 32 lanes a SM a clock (the ALU and the FMA pipe each take
# half), twice IMAD_PER_S.
INV_JUMP_SLOTS, INV_DIVSTEP_SLOTS, INV_BATCH_SLOTS, INV_TAIL_SLOTS = 22, 18, 285, 100
INV_SLOTS_STEPWISE = 16_872
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
    columns of n elements: one small-stages launch (the min(n, 512) - 1
    twiddles of its stages read once), and the large stages as the launches of
    large_stage_plan(n), their bounds summed (bounded by what bounds the
    larger part of the sum)."""
    from halo2_tpu_torch.poly import cuda_ntt

    tile = min(n, cuda_ntt.TILE)  # below 512 points the whole transform
    small = sum(_stage_products(n, 1 << lm) for lm in range(1, tile.bit_length() - 1))  # m = 2 .. tile / 2
    passes = [_bound(*_ntt_work(n, cols, m0, r)) for m0, r in cuda_ntt.large_stage_plan(n)]
    by_ops = sum(t for t, by in passes if by == "operations")
    return {
        "ntt_small_stages": _bound(2 * ELEM * n * cols + ELEM * (tile - 1), IMAD_MUL * small * cols),
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


# the device MSM's kernels: its window-sum rounds and scan, its Abel combine
# and tree sums (jac_add); the mixed add and the negations' mod_sub are
# inside msm_chunk_acc, so no MSM path launches jac_madd or mod_sub
MSM_KERNELS = ("msm_chunk_acc", "jac_suffix_scan", "jac_add")
MSM_GONE = ("jac_madd", "mod_sub")


def _forbid(path: str, counts: dict, names) -> None:
    launched = {name: counts[name] for name in names if counts[name]}
    if launched:
        raise AssertionError(f"{path}: launched {launched}, which it must not")


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
        _require(f"MSM {label}", counts, MSM_KERNELS)
        _forbid(f"MSM {label}", counts, MSM_GONE)
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
            _require(f"hybrid MSM {label} at device share {share}", counts, MSM_KERNELS)
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


# the position of the lane (or element) count among the arguments of each
# kernel's C entry point, for profile_prove's launches by width
WIDTH_ARG = {"mont_mul": 6, "mont_sqr": 2, "mont_pow": 2, "mont_inv": 2, "mod_add": 3, "mod_sub": 3,
             "jac_madd": 9, "jac_add": 9, "jac_horner": 2, "ntt_small_stages": 2, "msm_chunk_acc": 6,
             "jac_suffix_scan": 5}
# the columns a launch of mont_mul and ntt_small_stages, and the rows of the
# MSM's window-sum kernels (their width: chunks)
COLS_ARG = {"mont_mul": 7, "ntt_small_stages": 3, "msm_chunk_acc": 5, "jac_suffix_scan": 4}
# mont_mul launches of one warm flagship prove before mont_mul took a batch
# of columns in one launch (the port at commit 222e703 on an NVIDIA H100 80GB HBM3 at
# 700 W, PERF.md): native commits, and the W = 1 sharded prove
MONT_MUL_BEFORE = {"native": 141, "sharded": 1138}


def profile_prove(device, params=None, pk=None, warm: int = 1, mesh=None) -> None:
    """One flagship prove under torch.profiler (native commits; with
    ``mesh``, the sharded prove over it), after ``warm`` proves: its device
    launches, split into this package's kernels (by kernel, and by the
    lanes or elements of each launch) and PyTorch's own ops (by op), copies,
    the device's busy time (the launches' intervals summed) against the
    wall, and the phase times.  It uses only the port's entry points, so it
    also profiles an older checkout of the port: run it from that checkout's
    root with this file loaded by path, as scripts/torch_compare.sh does
    (native commits; profile_sharded_prove the same way)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from halo2_tpu_torch import _build
    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import ParamsKZG, ProvingKey, create_proof
    from halo2_tpu_torch.kzg.prover import PHASE_TIMINGS

    if mesh is None:
        label = "native-commit prove"
    else:
        import torch.distributed as dist

        label = f"sharded W={dist.get_world_size()} ({dist.get_backend()}) prove"
    circuit, public = _flagship_circuit()
    if params is None:
        params = ParamsKZG.setup_cached(11)
        pk = ProvingKey.load(PK_CACHE, circuit, 11, Fr)
    with open(FIXTURE, "rb") as f:
        want = f.read()
    prove = lambda: create_proof(params, pk, circuit, [list(public)], rng=random.Random(7), mesh=mesh)  # noqa: E731
    for _ in range(warm):
        prove()
    torch.cuda.synchronize(device)
    PHASE_TIMINGS.clear()
    widths = collections.defaultdict(collections.Counter)
    launch = _build.launch

    def counted(kernel, dev, *args):
        if kernel == "mont_mul" and len(args) <= COLS_ARG[kernel]:  # an older checkout: one column a launch
            widths[kernel][f"1 x {args[3]}"] += 1
        elif kernel in WIDTH_ARG:
            width = args[WIDTH_ARG[kernel]]
            widths[kernel][f"{args[COLS_ARG[kernel]]} x {width}" if kernel in COLS_ARG else width] += 1
        return launch(kernel, dev, *args)

    _build.launch = counted
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            proof = prove()
            torch.cuda.synchronize(device)
            wall = (time.perf_counter() - t0) * 1e3
    finally:
        _build.launch = launch
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
        f"[profile] {label} after {warm} warm-up: {wall:.1f} ms wall under the profiler; "
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
    before = MONT_MUL_BEFORE["native" if mesh is None else "sharded"]
    print(f"[profile]   mont_mul launches: {ours['mont_mul']} (before one launch a column batch: {before})", flush=True)
    print(
        "[profile]   kernels by width (lanes or elements a launch, mont_mul and ntt_small_stages columns x "
        "elements, msm_chunk_acc and jac_suffix_scan rows x chunks: launches; "
        "the 6 most common): "
        + "; ".join(
            f"{k} " + ", ".join(f"{m}: {n}" for m, n in c.most_common(6))
            for k, c in sorted(widths.items(), key=lambda kv: -sum(kv[1].values()))
        ),
        flush=True,
    )
    print(
        "[profile]   PyTorch ops, top 12 (launches, device ms): "
        + "; ".join(f"{k} {n} {us[k] / 1e3:.3f}" for k, n in torch_ops.most_common(12)),
        flush=True,
    )


def time_proves(device, reps: int = 3) -> dict:
    """Wall times (s) of ``reps`` warm flagship proves with native commits
    and ``reps`` with device commits, in turns, after one warm-up of each;
    each ends in a synchronize and equals the fixture.  Beside each wall,
    the prove's grand_products phase (PHASE_TIMINGS).  It uses only the
    port's entry points, so it also times an older checkout of the port
    (scripts/torch_compare.sh), as profile_prove does.  Prints the times as
    one JSON object after "[proves] " and returns it."""
    import torch

    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import ParamsKZG, ProvingKey, create_proof
    from halo2_tpu_torch.kzg.prover import PHASE_TIMINGS

    circuit, public = _flagship_circuit()
    params = ParamsKZG.setup_cached(11)
    pk = ProvingKey.load(PK_CACHE, circuit, 11, Fr)
    with open(FIXTURE, "rb") as f:
        want = f.read()
    out = {f"{commit}{key}": [] for commit in ("native", "device") for key in ("", "_grand_products")}
    for rep in range(reps + 1):
        for commit in ("native", "device"):
            PHASE_TIMINGS.clear()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            proof = create_proof(params, pk, circuit, [list(public)], rng=random.Random(7), commit=commit)
            torch.cuda.synchronize(device)
            dt = time.perf_counter() - t0
            if proof != want:
                raise AssertionError(f"{commit}-commit prove {rep} differs from {FIXTURE}")
            if rep:
                out[commit].append(dt)
                out[f"{commit}_grand_products"].append(PHASE_TIMINGS["grand_products"])
    print("[proves] " + json.dumps(out), flush=True)
    return out


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
        ("mont_mul", "ntt_small_stages", "ntt_large_stage", "vm_eval", "jac_horner") + MSM_KERNELS,
    )
    _forbid("device-commit prove", device_counts, MSM_GONE)
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


# the setup's kernels: G's fixed-base multiples, then jac_to_affine's
# inverse and products; the double-and-add ladder it ran before and the
# field ops and adds of that ladder's rounds are gone from it
SETUP_KERNELS = ("jac_fixed_base", "mont_inv", "mont_mul")
SETUP_GONE = ("jac_ladder", "mont_sqr", "mod_add", "mod_sub", "jac_add")


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
    _require("setup", counts, SETUP_KERNELS)
    _forbid("setup", counts, SETUP_GONE)
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
        "keygen, device commits", fused_counts, ("mont_mul", "ntt_small_stages", "ntt_large_stage", "jac_horner") + MSM_KERNELS
    )
    _forbid("keygen, device commits", fused_counts, ("jac_madd",))
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


def _experiment_vectors():
    """tests/experiment_vectors.py, loaded by path: tests/ is no package and
    its conftest imports JAX; the module itself imports no package."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("experiment_vectors", os.path.join(ROOT, "tests", "experiment_vectors.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class _Steps:
    """``experiment_vectors.prove``'s ``step``: each step's seconds and
    launch counts (set to 0 before it, read after)."""

    def __init__(self):
        self.seconds, self.launches = {}, {}

    @contextlib.contextmanager
    def __call__(self, name):
        reset_launches()
        t0 = time.perf_counter()
        yield
        self.seconds[name] = time.perf_counter() - t0
        self.launches[name] = read_launches()


# the experiment circuits also proved with their commitments on the device MSM
EXPERIMENT_DEVICE_COMMIT = ("merkle_v3",)


def _experiment_kernels(n: int, commit: str) -> tuple:
    """The kernels a keygen or prove over an ``n``-point domain must launch:
    the NTT and the Montgomery products, the large NTT stages above 512
    points, and with device commits the MSM's kernels and its Horner."""
    names = ("ntt_small_stages", "mont_mul") + (("ntt_large_stage",) if n > 512 else ())
    return names + (MSM_KERNELS + ("jac_horner",) if commit == "device" else ())


def _launched(counts: dict) -> str:
    return ", ".join(f"{name} {c}" for name, c in counts.items() if c) or "none"


def _verdicts(res: dict) -> str:
    if "keygen_error" in res:
        return f"keygen raised {res['keygen_error']}"
    out = f"{len(res['proof'])} bytes, {'verified' if res['verifies'] else 'rejected by the verifier'}"
    return out + (", a tampered instance rejected" if res.get("tampered_verifies") is False else "")


def phase_experiments(device):
    """The ten experiment circuits of tests/experiment_vectors.py on the
    card, held against the reference's results committed under
    tests/data/experiments/: every MockProver vector's failures, and each
    circuit's keygen, proof bytes and verdicts (native commits; merkle_v3
    also with device commits); a tampered instance is rejected wherever the
    reference accepts.  One line a circuit.  Returns the launch counts of
    every MockProver run, keygen and prove."""
    ev = _experiment_vectors()
    port = ev.side("halo2_tpu_torch")
    want = ev.load_results()
    runs = []
    for name, (_build, mock_k, field, _proof_k) in ev.CIRCUITS.items():
        mock = []
        for v in ev.mock_vectors(port, [name]):
            reset_launches()
            t0 = time.perf_counter()
            prover = port.dev.MockProver.run(v.k, v.circuit, v.instances, F=v.F)
            got = [repr(f) for f in prover.verify()]
            _sync(device)
            dt = time.perf_counter() - t0
            counts = read_launches()
            # inclusion_check has neither gates nor lookups: its MockProver
            # checks only the copy constraints, on the host
            if prover.cs.gates or prover.cs.lookups:
                _require(f"MockProver {v.label}", counts, ("vm_eval",))
            if got != want["mock"][v.label]:
                raise AssertionError(f"MockProver {v.label}: {got} differs from the reference's {want['mock'][v.label]}")
            runs.append(counts)
            mock.append(f"{v.label.rsplit('-', 1)[1]} {len(got)} failures in {dt:.3f} s (vm_eval {counts['vm_eval']})")
        v = ev.proof_vector(port, name)
        proofs = []
        for commit in ("native",) + (("device",) if name in EXPERIMENT_DEVICE_COMMIT else ()):
            steps = _Steps()
            with _FlagReads() as flags:
                got = ev.prove(port, v, step=steps, commit=commit)
            _no_flag_reads(f"{name} commit={commit}", flags)
            if got != want["proofs"][name]:
                raise AssertionError(
                    f"{name} commit={commit}: {_verdicts(got)}, not the reference's {_verdicts(want['proofs'][name])}"
                )
            if "prove" in steps.launches:
                _require(f"{name} keygen commit={commit}", steps.launches["keygen"], _experiment_kernels(1 << v.k, commit))
                # the extended domain has at least 2n points
                _require(f"{name} prove commit={commit}", steps.launches["prove"],
                         ("vm_eval",) + _experiment_kernels(2 << v.k, commit))
                _forbid(f"{name} prove commit={commit}", steps.launches["prove"], MSM_GONE)
                runs += [steps.launches["keygen"], steps.launches["prove"]]
            proofs.append(", ".join(
                [f"commit={commit}: {_verdicts(got)}, as the reference's"]
                + [f"{step} {t:.3f} s (launches: {_launched(steps.launches[step])})" for step, t in steps.seconds.items()]
            ))
        print(
            f"[experiments] {name}: MockProver k={mock_k} {field}: " + "; ".join(mock)
            + f", as the reference's | proof k={v.k} Fr: " + " | ".join(proofs),
            flush=True,
        )
    return runs


# the field ops of the sponge's rounds, which run inside poseidon_hash
SPONGE_GONE = ("mont_mul", "mont_sqr", "mod_add")


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
    from halo2_tpu_torch.poseidon import MySpec, hash_device, hash_device_plain, poseidon_hash

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
    _require("hash_device", counts, ("poseidon_hash",))
    _forbid("hash_device", counts, SPONGE_GONE)
    peak = torch.cuda.max_memory_allocated(device) / 2**20 if device.type == "cuda" else float("nan")

    lanes = min(1024, batch)
    plain = hash_device_plain(df, spec, L, messages[:, :, :lanes].cpu())
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


# the kernels every sharded prove and every dryrun check launches: its
# local transforms below 512 points (ntt_small_stages), twiddles and
# products (mont_mul), the MSM's window sums, scan, group ops and Horner,
# the grand product's inverses (mont_inv) and the quotient (vm_eval)
SHARDED_KERNELS = ("mont_mul", "jac_horner", "mont_inv", "ntt_small_stages", "vm_eval") + MSM_KERNELS
# the launches of one W = 1 sharded flagship prove before jac_horner and
# mont_pow ran its Horner combines and field powers (the port at commit
# b0938bf, on an NVIDIA H100 80GB HBM3 at 700 W: PERF.md's kernel table);
# phase 9 prints them beside this run's
W1_LAUNCHES_BEFORE = {"mont_mul": 6746, "mont_sqr": 13276, "mod_add": 19079, "mod_sub": 11423, "jac_madd": 536,
                      "jac_add": 6420, "vm_eval": 1}


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


@contextlib.contextmanager
def _commit_batches():
    """The commitments of each device MSM batch launched meanwhile: the
    lanes of each jac_horner launch (one a batch, a lane a scalar set)."""
    from halo2_tpu_torch import _build

    launch, sets = _build.launch, []

    def counted(kernel, dev, *args):
        if kernel == "jac_horner":
            sets.append(args[2])
        return launch(kernel, dev, *args)

    _build.launch = counted
    try:
        yield sets
    finally:
        _build.launch = launch


@contextlib.contextmanager
def _one_rank_mesh():
    """make_mesh(1) over a one-rank NCCL group in this process."""
    import tempfile

    import torch.distributed as dist

    from halo2_tpu_torch.parallel import make_mesh

    with tempfile.TemporaryDirectory(prefix="h2t_nccl_") as tmp:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "rendezvous"), rank=0, world_size=1)
        try:
            yield make_mesh(1)
        finally:
            dist.destroy_process_group()


def compare_kernels(device) -> None:
    """The kernel times a comparison with an older checkout of the port
    reads (scripts/torch_compare.sh, mode kernels), through calls both
    trees have: mont_mul's device time per launch on a lone BN254 Fr column
    at 2^11, 2^15 and 2^20 (b full width and one element), and at 2^11 and
    2^15 the time a call (CUDA events around 200 back-to-back calls, host
    dispatch included) of mont_mul and of DeviceField.mul; both NTT
    kernels' device time per launch (each pass of the large stages) at the
    NTT_TIMED batches; the local
    transforms of the sharded W = 1 NTTs (poly.domain._ntt_unscaled at the
    first four SMALL_NTT_SHAPES: the stage ladder before the small-size
    ntt_small_stages, one launch after) and DeviceField.inv at POW_SIZES
    and INV_BATCHED elements (the G inv_plan picks, in a tree that has
    one), each per call and on the device
    summed over the call's launches of every kernel (copies included); the flagship's
    83 x 2^15 coset scale through poly.domain._mul_columns, per call (CUDA
    events) and its device time summed over the call's launches; jac_horner
    at every (c, lanes) of HORNER_CASES; msm_chunk_acc (the schedule each
    tree picks; torch.profiler, the median launch) and jac_suffix_scan (its
    launches summed a call) at every MSM_CASES batch; jac_madd and jac_add, both
    variants, at every JAC_SIZES width (_check_jac_kernels); the device MSM
    with its Horner (ec.device._msm_raw) over 1 and 16 scalar sets at 2^11
    points and one set at 2^16, per call and on the device over all its
    launches.  Run it from the checkout's root with this file loaded by
    path."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from halo2_tpu_torch.ec import cuda_jac
    from halo2_tpu_torch.field.cuda_mul import mont_mul
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import BN254_FR
    from halo2_tpu_torch.poly import cuda_ntt
    from halo2_tpu_torch.poly.domain import _mul_columns, _ntt_unscaled, twiddle_table

    spec = BN254_FR
    df = get_device_field(spec)
    gen = torch.Generator(device=device)
    gen.manual_seed(7)
    for n in TIMED_SIZES:
        a, b = _random_field(spec, (n,), gen, device), _random_field(spec, (n,), gen, device)
        one = _random_field(spec, (1,), gen, device)
        for tag, bb in (("full", b), ("one element", one)):
            t = _kernel_device_ms(lambda: mont_mul(spec, a, bb), "mont_mul_kernel", _bound(*_field_work(n)["mont_mul"])[0] / 2)
            line = f"[compare] mont_mul bn254_fr n={n}, b {tag}: {t:.4f} ms on the device"
            if n < TIMED_SIZES[-1]:
                line += (
                    f", {_ms_per_call(lambda: mont_mul(spec, a, bb), 200):.4f} ms a call of mont_mul, "
                    f"{_ms_per_call(lambda: df.mul(a, bb), 200):.4f} ms a call of DeviceField.mul"
                )
            print(line, flush=True)

    def launches_ms(fn, reps=5):
        """(ms on the device a call, summed over every kernel it launched,
        launches a call)."""
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize(device)
        ev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
        return sum(e.time_range.elapsed_us() for e in ev) / (reps * 1e3), len(ev) / reps

    for cols, n in NTT_TIMED:  # the NTT kernels at n >= 512, where this PR changed nothing
        x = _random_field(spec, (cols, n), gen, device).movedim(1, 0).contiguous()
        tw = twiddle_table(spec, n, False, device)
        small = _kernel_device_ms(lambda: cuda_ntt.ntt_small_stages(spec, x, tw), "ntt_small_stages_kernel",
                                  _ntt_bounds(n, cols)["ntt_small_stages"][0])
        large = [
            _kernel_device_ms(lambda: cuda_ntt.ntt_large_stage(spec, x, tw, m0, r), "ntt_large_stage_kernel",
                              _bound(*_ntt_work(n, cols, m0, r))[0])
            for m0, r in cuda_ntt.large_stage_plan(n)
        ]
        print(
            f"[compare] ntt bn254_fr C={cols} n={n}: ntt_small_stages {small:.4f} ms on the device, ntt_large_stage "
            f"passes {cuda_ntt.large_stage_plan(n)} {' + '.join(f'{t:.4f}' for t in large)} ms",
            flush=True,
        )
    for cols, n in SMALL_NTT_SHAPES[:4]:
        x = _random_field(spec, (cols, n), gen, device).movedim(1, 0).contiguous()
        call = lambda: _ntt_unscaled(spec, x, False)  # noqa: E731
        dev_ms, n_launch = launches_ms(call)
        print(
            f"[compare] sharded local transforms C={cols} n={n} (_ntt_unscaled): {_ms_per_call(call, 10):.4f} ms "
            f"a call, {dev_ms:.4f} ms on the device in {n_launch:.0f} launches",
            flush=True,
        )
    for m in POW_SIZES + INV_BATCHED:
        a = _random_field(spec, (m,), gen, device)
        dev_ms, n_launch = launches_ms(lambda: df.inv(a))
        print(
            f"[compare] DeviceField.inv m={m}: {_ms_per_call(lambda: df.inv(a), 20):.4f} ms a call, {dev_ms:.4f} ms "
            f"on the device in {n_launch:.0f} launches",
            flush=True,
        )
    x = _random_field(spec, (FLAGSHIP_C, 1 << 15), gen, device).movedim(1, 0).contiguous()
    coset = _random_field(spec, (1 << 15,), gen, device)
    per_call = _ms_per_call(lambda: _mul_columns(spec, x, coset), 10)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            _mul_columns(spec, x, coset)
        torch.cuda.synchronize(device)
    launches = [e for e in prof.events() if "mont_mul_kernel" in e.name and e.device_type == torch.autograd.DeviceType.CUDA]
    print(
        f"[compare] {FLAGSHIP_C} x 2^15 coset scale (_mul_columns): {per_call:.4f} ms a call, "
        f"{sum(e.time_range.elapsed_us() for e in launches) / 5e3:.4f} ms on the device in {len(launches) / 5:.0f} launches",
        flush=True,
    )
    for c, batches in HORNER_CASES:
        w_all = _horner_windows(device, c, -(-254 // c), max(batches))
        for batch in batches:
            w = w_all[:, :, :batch].contiguous()
            nbytes, imads, chain = _horner_work(w, c)
            t = _kernel_device_ms(lambda: cuda_jac.jac_horner_cuda(w, c), "jac_horner_kernel", _bound(nbytes, imads)[0])
            print(f"[compare] jac_horner c={c} B={batch}: {t:.4f} ms on the device, {t * 1e3 / chain:.3f} us a chained product", flush=True)
    for n, batches in MSM_CASES:
        for sets in batches:
            px, py, order, sign = _msm_batch(device, gen, n, sets)
            acc = _kernel_device_ms(lambda: cuda_jac.msm_chunk_acc_cuda(px, py, order, sign), "msm_chunk_acc", 0.0)
            rows, q, chunks = order.shape
            print(
                f"[compare] msm_chunk_acc n=2^{n.bit_length() - 1} B={sets} ({rows} rows x {chunks} chunks x {q}): "
                f"{acc:.4f} ms on the device",
                flush=True,
            )
            tot = cuda_jac.msm_chunk_acc_cuda(px, py, order, sign)[1]
            ms, launches = _scan_call_ms(tot)
            print(
                f"[compare] jac_suffix_scan n=2^{n.bit_length() - 1} B={sets} ({tot.shape[2]} rows x {tot.shape[3]} chunks): "
                f"{ms:.4f} ms on the device a call ({launches} launches; CUDA events behind a spin kernel, median of "
                "10 calls)",
                flush=True,
            )
    _check_jac_kernels(device, {"jac_madd": 0.0, "jac_add": 0.0}, {})
    import numpy as np

    from halo2_tpu_torch.ec import device as ecd
    from halo2_tpu_torch.kzg.params import ParamsKZG

    srs = ParamsKZG.load(SRS16)
    for n, sets in ((1 << 11, 1), (1 << 11, 16), (1 << 16, 1)):
        px, py = (torch.from_numpy(np.ascontiguousarray(a[:, :n]).view(np.int32)).to(device) for a in (srs.g1_x, srs.g1_y))
        sc = _random_field(spec, (sets, n), gen, device).movedim(1, 0).contiguous()
        call = lambda: ecd._msm_raw(px, py, sc)["x"]  # noqa: E731
        dev_ms, n_launch = launches_ms(call, reps=3)
        print(
            f"[compare] device MSM (_msm_raw) n=2^{n.bit_length() - 1}, {sets} scalar sets: "
            f"{_ms_per_call(call, 3, runs=3):.3f} ms a call, {dev_ms:.3f} ms on the device in {n_launch:.0f} launches",
            flush=True,
        )


def profile_sharded_prove(device) -> None:
    """profile_prove of the flagship's sharded prove at W = 1 (NCCL, this
    process).  Like profile_prove, it also profiles an older checkout."""
    with _one_rank_mesh() as mesh:
        profile_prove(device, mesh=mesh)


def _sharded_w1(device, params, pk, circuit, public, want, reps: int):
    """One rank on NCCL in this process: the flagship through
    create_proof(mesh=make_mesh(1)) (the collectives over groups of one
    rank, through parallel.comm) equals the fixture, verifies, and a
    tampered root fails; then one warm prove under torch.profiler.
    Returns the first prove's launches and commitments a batch, the warm
    proves' times, the transports and the phases."""
    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import create_proof, verify_proof
    from halo2_tpu_torch.kzg.prover import PHASE_TIMINGS
    from halo2_tpu_torch.parallel import comm

    times, counts = [], None
    with _one_rank_mesh() as mesh:
        for rep in range(reps + 1):
            reset_launches()
            PHASE_TIMINGS.clear()
            _sync(device)
            t0 = time.perf_counter()
            with _commit_batches() if rep == 0 else contextlib.nullcontext([]) as sets:
                proof = create_proof(params, pk, circuit, [list(public)], rng=random.Random(7), mesh=mesh)
            _sync(device)
            dt = time.perf_counter() - t0
            if proof != want:
                raise AssertionError(f"sharded prove W=1 (nccl), rep {rep}: differs from {FIXTURE}")
            if rep == 0:
                counts, batches = read_launches(), sets
            else:
                times.append(dt)
        transports = dict(comm.TRANSPORTS)
        phases = dict(PHASE_TIMINGS)
        profile_prove(device, params, pk, mesh=mesh)
    _require("sharded prove W=1 (nccl)", counts, SHARDED_KERNELS)
    _forbid("sharded prove W=1 (nccl)", counts, MSM_GONE)
    _expect_inv_launches("sharded prove W=1 (nccl)", counts["mont_inv"], 1)
    if not verify_proof(params.verifier_params(), pk.vk, proof, [list(public)]):
        raise AssertionError("sharded prove W=1: the verifier rejected the proof")
    bad = list(public)
    bad[2] = bad[2] + Fr.from_u64(1)
    if verify_proof(params.verifier_params(), pk.vk, proof, [bad]):
        raise AssertionError("sharded prove W=1: the verifier accepted a tampered root")
    return counts, batches, times, transports, phases


def _expect_inv_launches(path: str, launches: int, proves: int) -> None:
    want = len(FLAGSHIP_GRAND_PRODUCTS) * proves
    if launches != want:
        raise AssertionError(
            f"{path}: {launches} mont_inv launches in {proves} proves, expected {want} (one batched grand product "
            f"for the {FLAGSHIP_GRAND_PRODUCTS[0]} permutation chunks, one for the {FLAGSHIP_GRAND_PRODUCTS[1]} lookups)"
        )


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
    single, single_phases, single_batches = {}, {}, []
    for commit in ("native", "device"):
        ts = []
        for rep in range(reps + 1):
            PHASE_TIMINGS.clear()
            _sync(device)
            t0 = time.perf_counter()
            with _commit_batches() if rep == 0 else contextlib.nullcontext([]) as sets:
                proof = create_proof(params, pk, circuit, [list(public)], rng=random.Random(7), commit=commit)
            single_batches += sets
            _sync(device)
            if proof != want:
                raise AssertionError(f"single-device prove ({commit} commits) differs from {FIXTURE}")
            if rep:
                ts.append(time.perf_counter() - t0)
        single[commit] = ts
        single_phases[commit] = dict(PHASE_TIMINGS)
    w1_counts, w1_batches, w1_times, w1_transports, w1_phases = _sharded_w1(
        device, params, pk, circuit, public, want, reps
    )
    print(
        f"[sharded] W=1 (nccl): the flagship equals the fixture, verifies, tampered root rejected; launches "
        f"{w1_counts}; transports {w1_transports}",
        flush=True,
    )
    print(
        f"[sharded] commitments a device MSM batch (the lanes of each jac_horner), one prove: single device, "
        f"device commits {single_batches} ({sum(single_batches)} in {len(single_batches)} batches); W=1 "
        f"{w1_batches} ({sum(w1_batches)} in {len(w1_batches)})",
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
    names = [name for name, _, _ in KERNELS if name in w1_counts or name in W1_LAUNCHES_BEFORE]
    # a W = 2 rank's flagship job runs reps + 1 proves: its launches a prove
    w2_counts = [{k: r[0]["launches"].get(k, 0) / (reps + 1) for k in names} for r in ranks]
    print(
        "[sharded] launches a flagship prove by kernel, W=1 before jac_horner and mont_pow (W1_LAUNCHES_BEFORE) "
        "-> W=1 (nccl) / W=2 (gloo) rank 0, rank 1 (the mean of a rank's proves): "
        + "; ".join(
            f"{k} {W1_LAUNCHES_BEFORE.get(k, 0)} -> {w1_counts.get(k, 0)} / {w2_counts[0][k]:g}, {w2_counts[1][k]:g}"
            for k in names
        )
        + f"; totals {sum(W1_LAUNCHES_BEFORE.values())} -> {sum(w1_counts.values())} / "
        f"{sum(w2_counts[0].values()):g}, {sum(w2_counts[1].values()):g}",
        flush=True,
    )
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
        _forbid(f"sharded prove {label}, rank {rank}", flag["launches"], MSM_GONE)
        _expect_inv_launches(f"sharded prove {label}, rank {rank}", flag["launches"]["mont_inv"], reps + 1)
        if flag["out"]["grand_products"] != [(16, c, 1 << 11) for c in FLAGSHIP_GRAND_PRODUCTS]:
            raise AssertionError(f"sharded prove {label}, rank {rank}: grand products {flag['out']['grand_products']}")
        if lt["out"]["proof"] != lt_want or not lt["out"]["verified"]:
            raise AssertionError(f"sharded prove {label}, rank {rank}: less_than_v2 k=9 differs from single-device")
        _require(f"less_than_v2 {label}, rank {rank}", lt["launches"], SHARDED_KERNELS)
        for job, (n, inverse) in zip(res[2:6], ((1 << 15, False), (1 << 15, True), (1 << 20, False), (1 << 20, True))):
            label_n = f"sharded_ntt 2^{n.bit_length() - 1} inverse={inverse}, rank {rank}"
            _max_abs_err(label_n, torch.from_numpy(job["out"]), torch.from_numpy(wants[(n, inverse)]))
            _require(label_n, job["launches"], ("ntt_small_stages", "mont_mul") + (("ntt_large_stage",) if n == 1 << 20 else ()))
            if job["launches"]["mod_add"] or job["launches"]["mod_sub"]:
                raise AssertionError(f"{label_n}: launched mod_add or mod_sub ({job['launches']})")
        msm, gp = res[6], res[7]
        if msm["out"]["affine"] != msm_want:
            raise AssertionError(f"sharded_msm 2^16, rank {rank}: {msm['out']['affine']} != native {msm_want}")
        _require(f"sharded_msm 2^16, rank {rank}", msm["launches"], MSM_KERNELS + ("jac_horner",))
        _forbid(f"sharded_msm 2^16, rank {rank}", msm["launches"], MSM_GONE)
        if [int(v) for v in dfr.decode(torch.from_numpy(gp["out"]))] != z_host:
            raise AssertionError(f"grand_product_z 2^11, rank {rank}: differs from the host recurrence")
        _require(f"grand_product_z 2^11, rank {rank}", gp["launches"], ("mont_inv", "mont_mul"))
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
    # the reference's fori_loop Horner and lax.scan power as one launch each
    ("jac_horner", "halo2_tpu_torch/csrc/jac.cu", "halo2_tpu/ec/device.py:597"),
    ("mont_pow", "halo2_tpu_torch/csrc/mont_mul.cu", "halo2_tpu/field/device.py:239"),
    # the reference's Fermat inverse (a lax.scan power) as a safegcd in one launch
    ("mont_inv", "halo2_tpu_torch/csrc/inv.cu", "halo2_tpu/field/device.py:251"),
    # the MSM's window-sum loops: the intra-chunk fori_loop and the suffix scan
    ("msm_chunk_acc", "halo2_tpu_torch/csrc/msm.cu", "halo2_tpu/ec/device.py:465"),
    ("jac_suffix_scan", "halo2_tpu_torch/csrc/msm.cu", "halo2_tpu/ec/device.py:359"),
    # the setup's lax.scan double-and-add and the sponge's three lax.scans
    ("jac_ladder", "halo2_tpu_torch/csrc/ladder.cu", "halo2_tpu/ec/device.py:246"),
    ("poseidon_hash", "halo2_tpu_torch/csrc/poseidon.cu", "halo2_tpu/poseidon/primitives.py:163"),
    # the setup's G tau^i, which the reference runs as that double-and-add
    # over G on every lane, from G's window table
    ("jac_fixed_base", "halo2_tpu_torch/csrc/ladder.cu", "halo2_tpu/kzg/params.py:74"),
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
        ("keygen", phase_keygen), ("mock", phase_mock), ("experiments", phase_experiments),
        ("poseidon", phase_poseidon), ("sharded", phase_sharded), ("graft", phase_graft),
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
                "ms": times[(name, REPORT_AT.get(name, REPORT_SIZE))][0],
                "plain_ms": times[(name, REPORT_AT.get(name, REPORT_SIZE))][1],
                "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1],
                # no single PyTorch call computes a 256-bit Montgomery
                # product, power or modular add, a prime-field NTT, a curve
                # add, Horner or ladder, an expression program over field
                # columns, or a Poseidon sponge
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
