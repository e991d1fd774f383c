"""The device MSM over a batch of scalar sets (``halo2_tpu_torch/ec/device.py``)
and the plain versions of its two window-sum kernels, against the reference.

- ``msm_chunk_acc_plain`` (the ``msm_chunk_acc`` kernel's plain version)
  equals the reference's intra-chunk rounds limb for limb: its signed
  negation and ``_jac_madd_jnp`` a round (``halo2_tpu/ec/device.py:465``),
  with negated entries, a y = 0 point, (0, 0) padding points, P == Q and
  P == -Q chunks.
- ``jac_suffix_scan_plain`` (the ``jac_suffix_scan`` kernel's plain
  version, in ``scan_plan``'s schedule and in each schedule forced at every
  level: Kogge-Stone over one chunk a slot for the cluster, k = 1, 2 and 4
  chunks a thread for the coarsened scan) equals the exclusive suffix sums
  taken on the host with ``_hj_add``, as affine points, at C = 1, 2, 3,
  64, 65, 255, 256, 257, 300 and 4096 (C not a multiple of k among them),
  with P == Q and P == -Q neighbours and infinite chunks at a group's edge;
  ``scan_plan`` at its thresholds' edges, a schedule outside
  ``SCAN_SCHEDULES`` refused, and no shape up to 65,536 chunks in more
  than three scan passes.
- The batched ``_msm_raw`` and ``_commit_device`` over B = 1, 3 and 17
  scalar sets equal ``msm_points`` a set, the native host MSM and the
  reference's ``msm_points`` (JAX on the CPU) at n = 2^4, 2^8 and 2^11
  (B = 17 at the two smaller sizes: the plain versions' CPU time), and a
  batch split into sub-batches equals the whole.

On the CPU every kernel wrapper runs its plain version.  Inputs come from
seeded numpy generators.
"""

import functools
import json
import os
import pickle
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.ec import device as ref_ecd
from halo2_tpu_torch import native
from halo2_tpu_torch.ec import cuda_jac, host
from halo2_tpu_torch.ec import device as ecd
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR
from halo2_tpu_torch.kzg.keygen import _commit_device
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = BN254_FQ.p
DQ = get_device_field(BN254_FQ)


def _port(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr, np.uint32).view(np.int32))


def _srs(n):
    with open(os.path.join(ROOT, ".srs", "kzg_bn254_k13_s857536.pkl"), "rb") as f:
        data = pickle.load(f)
    return np.ascontiguousarray(data["g1_x"][:, :n]), np.ascontiguousarray(data["g1_y"][:, :n])


def _affine(stacked) -> list:
    """(3, 16, ...) Jacobian limbs (x, y, z; Montgomery) -> host affine
    (x, y) per point in row-major order, (0, 0) = infinity."""
    stacked = stacked if isinstance(stacked, torch.Tensor) else _port(stacked)
    x, y, z = ([int(v) for v in DQ.decode(stacked[i].reshape(16, -1))] for i in range(3))
    out = []
    for X, Y, Z in zip(x, y, z):
        if Z % Q == 0:
            out.append((0, 0))
        else:
            zi = pow(Z, Q - 2, Q)
            out.append((X * zi * zi % Q, Y * zi * zi * zi % Q))
    return out


# ----------------------------------------------------------- msm_chunk_acc
def _chunk_inputs(rows, chunks, q, seed):
    """Points (the SRS's, point 3 replaced by (0, 0) and point 5's y by 0)
    and random entries, with exception chunks (the rounds run from the last
    entry down): (0, 0) adds its first point twice (P == Q), (0, 1) its
    first point then its negative (P == -Q), (1, 0) the y = 0 point q
    times, negated, (1, 1) starts at the (0, 0) point."""
    n = 64
    px, py = _srs(n)
    px, py = px.copy(), py.copy()
    px[:, 3] = py[:, 3] = 0
    py[:, 5] = 0
    rng = np.random.default_rng(seed)
    # entry pos of chunk c at [row, pos, c], as msm_chunk_acc takes them
    order = rng.integers(0, n, (rows, q, chunks)).astype(np.int32)
    sign = rng.integers(0, 2, (rows, q, chunks)).astype(bool)
    order[0, q - 2, 0], sign[0, q - 2, 0] = order[0, q - 1, 0], sign[0, q - 1, 0]
    order[0, q - 2, 1], sign[0, q - 2, 1] = order[0, q - 1, 1], ~sign[0, q - 1, 1]
    order[1, :, 0], sign[1, :, 0] = 5, True
    order[1, q - 1, 1] = 3
    return px, py, order, sign


def test_msm_chunk_acc_plain_matches_reference_rounds():
    rows, chunks, q = 2, 4, 8
    px, py, order, sign = _chunk_inputs(rows, chunks, q, 11)
    sfx, tot = cuda_jac.msm_chunk_acc_plain(
        _port(px), _port(py), torch.from_numpy(order), torch.from_numpy(sign)
    )
    assert sfx.shape == (3, 16, rows, q * chunks) and tot.shape == (3, 16, rows, chunks)

    d = ref_ecd.df()
    valid = jnp.ones((rows, chunks), bool)

    @jax.jit
    def round_(acc, gx, gy, sgn):  # the reference's loop body (device.py:465-481)
        qy = d.select(sgn != 0, d.neg(gy), gy)
        return ref_ecd._jac_madd_jnp(acc, gx, qy, valid)

    stacked = np.concatenate([px, py])
    acc = ref_ecd.jac_infinity((rows, chunks))
    want = np.zeros((3, 16, rows, q, chunks), np.uint32)
    for pos in reversed(range(q)):
        g = stacked[:, order[:, pos]]
        acc = round_(acc, g[:16], g[16:], sign[:, pos].astype(np.uint32))
        for i, k in enumerate(("x", "y", "z")):
            want[i, :, :, pos] = np.asarray(acc[k])
    got = sfx.numpy().view(np.uint32).reshape(3, 16, rows, q, chunks)
    assert np.array_equal(got, want)
    assert np.array_equal(tot.numpy().view(np.uint32), want[:, :, :, 0])
    # the exception chunks did what they were built for: P + (-P) is
    # infinite (z = 0), P + P the doubling
    assert not want[2, :, 0, q - 2, 1].any()
    i = order[0, q - 1, 0]
    x, y = (int(DQ.decode(_port(a[:, i : i + 1]))[0]) for a in (px, py))
    x2, y2, z2 = ecd._hj_dbl((x, (-y if sign[0, q - 1, 0] else y) % Q, 1), Q)
    zi = pow(z2, -1, Q)
    assert _affine(want[:, :, 0, q - 2, 0][:, :, None]) == [(x2 * zi * zi % Q, y2 * zi**3 % Q)]


# ---------------------------------------------------------- jac_suffix_scan
@functools.lru_cache(maxsize=None)
def _scan_inputs(rows, chunks, seed):
    """(3, 16, rows, chunks) Jacobian points with random z != 1, and the
    same as host Jacobian tuples (None = infinity): row 0 has P == Q at
    chunks 0, 1 and P == -Q at 2, 3, and above 16 chunks infinity at 7 and
    8 (a group's edge for k = 2 and 4) and P == Q at 11, 12; the last
    row infinity at chunk C // 2 and at the last chunk."""
    n = rows * chunks
    px, py = _srs(max(n, 1))
    rng = np.random.default_rng(seed)
    pts = []
    for i in range(n):
        x, y = (int(v) for v in DQ.decode(_port(np.stack([px[:, i], py[:, i]], 1))))
        z = int(rng.integers(2, 1 << 62)) ** 3 % Q
        pts.append((x * z * z % Q, y * z * z * z % Q, z))
    if chunks > 4:
        x, y, z = pts[0]
        z2 = z * 5 % Q
        pts[1] = (x * 25 % Q, y * 125 % Q, z2)  # the same point, another z
        pts[3] = (pts[2][0], (-pts[2][1]) % Q, pts[2][2])
    if chunks > 16:
        pts[7] = pts[8] = None
        x, y, z = pts[11]
        pts[12] = (x * 49 % Q, y * 343 % Q, z * 7 % Q)
        pts[(rows - 1) * chunks + chunks // 2] = None
        pts[rows * chunks - 1] = None
    inf = (0, 1, 0)
    coords = [[(inf if p is None else p)[k] for p in pts] for k in range(3)]
    enc = torch.stack([DQ.encode(c) for c in coords]).reshape(3, 16, rows, chunks)
    return enc.contiguous(), [pts[r * chunks : (r + 1) * chunks] for r in range(rows)]


def _host_suffix(row) -> list:
    out, acc = [], None
    for p in reversed(row):
        out.append(acc)
        acc = ecd._hj_add(acc, p, Q)
    out.reverse()
    return [
        (0, 0) if p is None else (p[0] * pow(p[2], -2, Q) % Q, p[1] * pow(p[2], -3, Q) % Q)
        for p in out
    ]


@pytest.mark.parametrize("schedule", [None, *cuda_jac.SCAN_SCHEDULES], ids=str)
@pytest.mark.parametrize("chunks", [1, 2, 3, 64, 65, 255, 256, 257, 300, 4096])
def test_jac_suffix_scan_plain_matches_host_suffix(chunks, schedule):
    """The plain scan in scan_plan's schedule (None) or in one forced at
    every level equals the host's sequential suffix sums as affine points;
    the CPU wrapper is the plain version."""
    rows = 2 if chunks <= 256 else 1
    s, host_rows = _scan_inputs(rows, chunks, chunks)
    got = cuda_jac._scan_plain(s, schedule)
    assert got.shape == s.shape and got.dtype == torch.int32
    assert int(got.max()) < 1 << 16
    want = [pt for row in host_rows for pt in _host_suffix(row)]
    assert _affine(got.numpy()) == want
    if schedule is None:
        assert torch.equal(cuda_jac.jac_suffix_scan_cuda(s), got)
    else:
        assert torch.equal(cuda_jac._jac_suffix_scan(s, schedule), got)


def _edges():
    plan = cuda_jac.SCAN_PLAN
    above = [schedule for _, schedule in plan[1:]] + [cuda_jac.SCAN_PLAN_ABOVE]
    return [(most, schedule, nxt) for (most, schedule), nxt in zip(plan, above)]


@pytest.mark.parametrize("lanes, at, above", _edges())
def test_scan_plan_at_its_thresholds(lanes, at, above):
    """scan_plan picks by rows x chunks: a threshold's own lane count takes
    the schedule below it, one row more the one above it, whatever the
    split into rows and chunks; a schedule outside SCAN_SCHEDULES is
    refused."""
    for chunks in (64, 256):
        rows = lanes // chunks
        assert cuda_jac.scan_plan(rows, chunks) == at
        assert cuda_jac.scan_plan(rows + 1, chunks) == above
    assert cuda_jac.scan_plan(1, 1) == ("cluster", 1)
    assert cuda_jac.scan_plan(1 << 20, 1 << 10) == cuda_jac.SCAN_PLAN_ABOVE
    for schedule in (("coarse", 3), ("coarse", 8), ("cluster", 2)):
        with pytest.raises(ValueError):
            cuda_jac._plan(schedule)


@pytest.mark.parametrize("schedule", [None, *cuda_jac.SCAN_SCHEDULES], ids=str)
@pytest.mark.parametrize(
    "rows, chunks", [(32, 1), (32, 256), (640, 256), (2, 257), (22, 8192), (22, 16384), (1, 65536)]
)
def test_scan_passes_per_shape(rows, chunks, schedule):
    """One tile pass up to 256 chunks in every schedule, and at most three
    passes (tiles with totals, the totals' scan, the offsets) up to 65,536
    chunks, as the scan took before its two schedules."""
    passes = []

    def tiles(s, sched, T, k, totals):
        assert T & (T - 1) == 0 and 1 <= k <= T and sched in cuda_jac.SCAN_SCHEDULES
        passes.append(("tiles", sched, T, k))
        if not totals:
            return torch.empty_like(s), None
        tot = torch.empty((3, 16, s.shape[2], -(-s.shape[3] // T)), device="meta")
        return torch.empty_like(s), tot

    def offsets(s, suffix, T):
        passes.append(("offsets", T))
        return torch.empty_like(s)

    s = torch.empty((3, 16, rows, chunks), dtype=torch.int32, device="meta")
    cuda_jac._suffix_scan(s, cuda_jac._plan(schedule), tiles, offsets)
    T, _ = cuda_jac.scan_tile(chunks, cuda_jac._plan(schedule)(rows, chunks))
    assert len(passes) == (1 if chunks <= T else 3)
    assert chunks > 256 or len(passes) == 1


# ---------------------------------------------------- the batched device MSM
SETS = 17


def _scalar_sets(n, sets, seed):
    """``sets`` random canonical Fr scalar sets (sets, 16, n) as uint32 limbs."""
    rng = np.random.default_rng(seed)
    words = rng.integers(0, 1 << 32, (sets, n, 8), dtype=np.uint64)
    vals = [
        [sum(int(w) << (32 * k) for k, w in enumerate(v)) % BN254_FR.p for v in row]
        for row in words
    ]
    return np.stack([get_device_field(BN254_FR).encode_np(row, to_mont=False) for row in vals])


# the reference's msm_points (JAX, jitted on the CPU) of a case's first three
# sets, in a process of its own: its three XLA:CPU compiles (~50-100 s
# each) run at once and beside the port's tests of this module
REF_SCRIPT = """
import json, sys
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_compilation_cache", False)
import numpy as np
from halo2_tpu.ec import device as ref_ecd
d = np.load(sys.argv[1])
with open(sys.argv[2], "w") as f:
    json.dump([[int(v) for v in ref_ecd.msm_points(d["px"], d["py"], s)] for s in d["sc"]], f)
"""


@pytest.fixture(scope="module")
def msm_cases(tmp_path_factory):
    """Per n: points (with a (0, 0) point at n = 2^4), SETS scalar sets
    (set 1 all zero at n = 2^4), the native MSM of each set, a function
    that returns the reference's msm_points of the first three (computed
    in a child process started here), and the port's batch results the
    tests have computed so far."""
    tmp = tmp_path_factory.mktemp("msm_ref")
    cases, procs = {}, {}
    for n in (1 << 4, 1 << 8, 1 << 11):
        px, py = _srs(n)
        sc = _scalar_sets(n, SETS, n)
        if n == 16:
            px, py = px.copy(), py.copy()
            px[:, 2] = py[:, 2] = 0
            sc[1] = 0
        np.savez(tmp / f"in{n}.npz", px=px, py=py, sc=sc[:3])
        procs[n] = subprocess.Popen(
            [sys.executable, "-c", REF_SCRIPT, str(tmp / f"in{n}.npz"), str(tmp / f"out{n}.json")],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        packed = [native.pack_device(a) for a in (px, py)]
        nat = [native.msm_g1_mont(*packed, native.pack_device(np.ascontiguousarray(s))) for s in sc]
        cases[n] = {"px": px, "py": py, "sc": sc, "native": nat, "port": {}}

    def reference(n):
        out = procs[n].communicate(timeout=900)[0]
        assert procs[n].returncode == 0, out.decode()[-2000:]
        with open(tmp / f"out{n}.json") as f:
            return [tuple(v) for v in json.load(f)]

    yield cases, reference
    for p in procs.values():
        p.kill()
        p.wait()


BATCHES = [(16, 1), (16, 3), (16, SETS), (256, 1), (256, 3), (256, SETS), (2048, 1), (2048, 3)]


def _batched(case, sets):
    """The port's batched device MSM of a case's first ``sets`` sets, as
    host affine points (cached in the case)."""
    if sets not in case["port"]:
        pt = ecd._msm_raw(_port(case["px"]), _port(case["py"]), _port(case["sc"][:sets]))
        assert pt["x"].shape == (16, sets)
        xs, ys = ecd._wsums_host_affine(torch.stack([pt["x"], pt["y"], pt["z"]]))
        case["port"][sets] = list(zip(xs, ys))
    return case["port"][sets]


@pytest.mark.parametrize("n, sets", BATCHES)
def test_batched_msm_raw_matches_each_set(msm_cases, n, sets):
    """One batch over ``sets`` scalar sets equals the native MSM of each
    set and, at B = 1 and 3 (B = 1 at 2^11), the port's one-set msm_points
    (its host Horner) of each."""
    case = msm_cases[0][n]
    got = _batched(case, sets)
    assert got == case["native"][:sets]
    if sets <= (3 if n < 2048 else 1):
        for i in range(sets):
            one = ecd.msm_points(_port(case["px"]), _port(case["py"]), _port(case["sc"][i]))
            assert one == got[i]
    if n == 16 and sets > 1:
        assert got[1] == (0, 0)


@pytest.mark.parametrize("n, sets", [(16, 1), (16, 3), (16, SETS), (256, 3), (2048, 1)])
def test_commit_device_batches_by_length(msm_cases, n, sets, monkeypatch):
    """Columns of two lengths in one call: each length one batch (one
    Horner at its width), every commitment equal to the native MSM's."""
    case = msm_cases[0][n]
    px, py, sc, nat = case["px"], case["py"], case["sc"], case["native"]
    dfr = get_device_field(BN254_FR)

    class Params:
        g1_x, g1_y = _srs(2048)

    if n == 16:
        Params.g1_x, Params.g1_y = Params.g1_x.copy(), Params.g1_y.copy()
        Params.g1_x[:, :16], Params.g1_y[:, :16] = px, py
    cols = [dfr.to_mont_arr(_port(sc[i])) for i in range(sets)]
    short = dfr.to_mont_arr(_port(_scalar_sets(8, 1, n)[0]))
    horners = []
    orig = cuda_jac.jac_horner_cuda

    def counted(w, c):
        horners.append(tuple(w.shape[2:-1]))
        return orig(w, c)

    monkeypatch.setattr(ecd, "jac_horner_cuda", counted)
    got = _commit_device(Params, cols[:1] + [short] + cols[1:])
    assert sorted(horners) == sorted([(sets,), (1,)])
    assert [host.g1_to_ints(p) for p in got[:1] + got[2:]] == nat[:sets]
    pts8 = [native.pack_device(np.ascontiguousarray(a[:, :8])) for a in (Params.g1_x, Params.g1_y)]
    canon8 = dfr.from_mont_arr(short).numpy().view(np.uint32)
    assert host.g1_to_ints(got[1]) == native.msm_g1_mont(*pts8, native.pack_device(canon8))


def test_batch_splits_into_sub_batches(msm_cases, monkeypatch):
    """A budget of two sets' running sums splits 5 sets into 2 + 2 + 1:
    three window passes, one Horner, the same points."""
    case = msm_cases[0][16]
    px, py, sc, nat = case["px"], case["py"], case["sc"], case["native"]
    need = ecd._SFX_BYTES * 64 * 16  # 64 windows of 4 bits
    monkeypatch.setattr(ecd, "_MSM_BATCH_BYTES", 2 * need + need // 2)
    assert ecd._batch_sets(16, 4) == 2
    passes = []
    orig = ecd._window_sums

    def counted(px_, py_, digits, *args, **kw):
        passes.append(digits.shape[0])
        return orig(px_, py_, digits, *args, **kw)

    monkeypatch.setattr(ecd, "_window_sums", counted)
    w = ecd._msm_wsums_raw(_port(px), _port(py), _port(sc[:5]))
    assert passes == [128, 128, 64]
    assert w.shape == (3, 16, 5, 64)
    pt = ecd._horner_device(w, 4)
    xs, ys = ecd._wsums_host_affine(torch.stack([pt["x"], pt["y"], pt["z"]]))
    assert list(zip(xs, ys)) == nat[:5]


@pytest.mark.parametrize("n", [16, 256, 2048])
def test_batched_msm_matches_reference_jax(msm_cases, n):
    """The batch of the first three sets equals the reference's
    msm_points of each (JAX on the CPU)."""
    cases, reference = msm_cases
    assert _batched(cases[n], 3) == reference(n)
