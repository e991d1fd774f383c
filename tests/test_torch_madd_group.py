"""``msm_chunk_acc``'s two schedules, on the CPU.

- The group schedule's mixed add (``csrc/jac.cuh:madd_group``: four threads
  a lane, four levels of products and the adds and subtracts between them
  spread over the ranks) emulated in torch, each rank's operand picks and
  each shuffle as the kernel makes them, on
  ``cuda_jac.plain_field()``: it equals ``jac_madd_plain`` limb for limb
  and the reference's ``_jac_madd_jnp`` (JAX on the CPU), over seeded
  random points and over each exception: p at infinity, a (0, 0) point, a
  y = 0 point, P == Q and P == -Q (z3 = 0 with x3 = rr^2, y3 = -rr^3).
- ``acc_plan`` maps every shape the paths give the kernel (up to the 2^18
  slice) into ``ACC_SCHEDULES``, its thresholds rise, a forced schedule
  outside ``ACC_SCHEDULES`` is refused, and on the CPU every forced
  schedule returns the plain rounds.

Inputs come from seeded numpy generators and the k = 13 SRS's points.
"""

import os
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.ec import device as ref_ecd
from halo2_tpu_torch.ec import cuda_jac
from halo2_tpu_torch.ec import device as ecd
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FQ
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = BN254_FQ.p
DQ = get_device_field(BN254_FQ)
GROUP = 4


def _madd_group_emulated(p, qx, qy):
    """p + (qx, qy) as madd_group computes it, every rank's registers held
    apart: at each level rank g multiplies the operands it picks, at each
    step it adds or subtracts them, and ``frm(v, src)`` is the shuffle that
    gives rank g rank ``src[g]``'s value of v.  Returns the point and the
    ranks' (A, B) step results (h on rank 0, rr on rank 1)."""
    d = cuda_jac.plain_field()
    x1, y1, z1 = p["x"], p["y"], p["z"]

    def frm(v, src):
        return [v[s] for s in src]

    def each(op, a, b):
        assert len(a) == len(b) == GROUP
        return [op(u, w) for u, w in zip(a, b)]

    pr = each(d.mul, [z1, qy, qx, z1], [z1, z1, y1, z1])  # L1 (rank 3's unused)
    x2 = d.add(x1, x1)
    o = frm(pr, [0] * GROUP)  # z1z1
    pr = each(d.mul, [qx, pr[1], pr[2], x1], [o[0], o[1], o[2], y1])  # L2
    o = frm(pr, [0, 1, 3, 0])
    # A: h | s2 - y1 | h y1 | h
    ra = each(d.sub, [o[0], o[1], pr[2], o[3]], [x1, y1, o[2], x1])
    # B: w | rr | 2 h y1 | 2 h
    rb = each(d.add, [o[0], ra[1], ra[2], ra[3]], [x2, ra[1], ra[2], ra[3]])
    h_zero, r_zero = d.is_zero(ra[0]), d.is_zero(rb[1])
    rr = frm(rb, [3, 1, 1, 1])
    o = frm(rb, [0] * GROUP)  # w
    # L3: i | rr^2 | rr w | z3
    pr = each(d.mul, [rr[0], rr[1], rr[2], z1], [rr[0], rr[1], o[2], rb[3]])
    p3 = list(pr)
    e = each(d.sub, pr, rb)  # E: rank 2's b
    o = frm(pr, [0, 0, 0, 1])
    # L4: j | 2 v | i b | rr^3
    pr = each(d.mul, [ra[0], x2, o[2], rr[3]], [o[0], o[1], e[2], o[3]])
    o = frm(pr, [3, 0, 3, 3])
    b = each(d.sub, [pr[0], p3[1], pr[2], pr[3]], o)  # G: rr^2 - j | y3
    a = each(d.sub, b, pr)  # H: x3
    x3, y3, z3 = a[1], b[2], p3[3]
    p_inf = d.is_zero(z1)
    same = ~p_inf & h_zero & r_zero
    dbl = ecd.jac_double(p, d)
    one = d.one_mont(qx.shape[1:])
    out = {}
    for k, aff, new in (("x", qx, x3), ("y", qy, y3), ("z", one, z3)):
        out[k] = torch.where(p_inf[None], aff, torch.where(same[None], dbl[k], new))
    return out, {"h": ra[0], "rr": rb[1]}


def _srs_affine(n):
    with open(os.path.join(ROOT, ".srs", "kzg_bn254_k13_s857536.pkl"), "rb") as f:
        data = pickle.load(f)
    x = DQ.decode(torch.from_numpy(np.ascontiguousarray(data["g1_x"][:, :n]).view(np.int32)))
    y = DQ.decode(torch.from_numpy(np.ascontiguousarray(data["g1_y"][:, :n]).view(np.int32)))
    return [int(v) for v in x], [int(v) for v in y]


def _madd_cases(m, seed):
    """(p, qx, qy) of m lanes, Montgomery limbs: p a Jacobian point with
    random z != 1, q another point's affine coordinates; then the
    exception lanes 0-5: p at infinity, q = (0, 0), q's y = 0, P == Q,
    P == -Q, and p at infinity with q = (0, 0)."""
    xs, ys = _srs_affine(2 * m)
    rng = np.random.default_rng(seed)
    px, py, pz = [], [], []
    for i in range(m):
        z = int(rng.integers(2, 1 << 62)) ** 3 % Q
        px.append(xs[i] * z * z % Q)
        py.append(ys[i] * z * z * z % Q)
        pz.append(z)
    qx, qy = xs[m:], ys[m:]
    px[0], py[0], pz[0] = 0, 1, 0
    qx[1], qy[1] = 0, 0
    qy[2] = 0
    qx[3], qy[3] = xs[3], ys[3]  # P == Q: p is point 3 with its z
    qx[4], qy[4] = xs[4], (-ys[4]) % Q  # P == -Q
    px[5], py[5], pz[5], qx[5], qy[5] = 0, 1, 0, 0, 0
    p = {"x": DQ.encode(px), "y": DQ.encode(py), "z": DQ.encode(pz)}
    return p, DQ.encode(qx), DQ.encode(qy)


def test_madd_group_levels_match_plain_and_reference():
    m = 64
    p, qx, qy = _madd_cases(m, 18)
    got, mid = _madd_group_emulated(p, qx, qy)
    valid = torch.ones((m,), dtype=torch.bool)
    want = cuda_jac.jac_madd_plain(p, qx, qy, valid)
    for k in ("x", "y", "z"):
        assert torch.equal(got[k], want[k]), k
    u32 = lambda t: jnp.asarray(t.numpy().view(np.uint32))  # noqa: E731
    ref = ref_ecd._jac_madd_jnp({k: u32(p[k]) for k in p}, u32(qx), u32(qy), jnp.ones((m,), bool))
    for k in ("x", "y", "z"):
        assert np.array_equal(np.asarray(ref[k]), got[k].numpy().view(np.uint32)), k
    # the exception lanes did what they were built for
    one = DQ.encode([1])[:, 0]
    assert torch.equal(got["x"][:, 0], qx[:, 0]) and torch.equal(got["y"][:, 0], qy[:, 0])
    assert torch.equal(got["z"][:, 0], one)
    assert torch.equal(got["z"][:, 5], one)
    assert not got["x"][:, 5].any() and not got["y"][:, 5].any()
    d = cuda_jac.plain_field()
    dbl = ecd.jac_double({k: p[k][:, 3:4] for k in p}, d)
    assert all(torch.equal(got[k][:, 3:4], dbl[k]) for k in ("x", "y", "z"))
    rr = mid["rr"][:, 4:5]
    assert not got["z"][:, 4].any() and d.is_zero(mid["h"][:, 4:5]).all()
    assert not d.is_zero(rr).any()
    assert torch.equal(got["x"][:, 4:5], d.square(rr))
    assert torch.equal(got["y"][:, 4:5], d.neg(d.mul(rr, d.square(rr))))


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_madd_group_chain_matches_plain_rounds(seed):
    """Eight rounds in a row, as a lane runs them (the sum feeds the next
    round), from infinity: the emulated group madd equals jac_madd_plain
    after every round."""
    m = 16
    xs, ys = _srs_affine(8 * m)
    rng = np.random.default_rng(seed)
    d = cuda_jac.plain_field()
    acc = ecd.jac_infinity((m,))
    ref = dict(acc)
    for r in range(8):
        idx = rng.integers(0, len(xs), m)
        neg = rng.integers(0, 2, m).astype(bool)
        qx = DQ.encode([xs[i] for i in idx])
        qy = DQ.encode([(-ys[i]) % Q if s else ys[i] for i, s in zip(idx, neg)])
        if r == 3:  # P == Q in lane 0: add the sum's own affine point
            x, y, z = (int(DQ.decode(acc[k][:, :1])[0]) for k in ("x", "y", "z"))
            zi = pow(z, -1, Q)
            qx[:, 0] = DQ.encode([x * zi * zi % Q])[:, 0]
            qy[:, 0] = DQ.encode([y * zi**3 % Q])[:, 0]
        acc, _ = _madd_group_emulated(acc, qx, qy)
        ref = cuda_jac.jac_madd_plain(ref, qx, qy, torch.ones((m,), dtype=torch.bool))
        for k in ("x", "y", "z"):
            assert torch.equal(acc[k], ref[k]), (r, k)
    assert not d.is_zero(acc["z"]).any()


# ------------------------------------------------------------------ acc_plan
# (points, scalar sets, the schedule measured fastest on the H100) of every
# batch the main paths give msm_chunk_acc: 1-20 sets at 2^9, 2^10 and 2^11
# points, one at 2^16 and the 2^18 slice, and a few points.  The group wins
# up to 8,192 lanes, the thread at four blocks an SM above, and at three
# where that leaves the fuller last wave (2^10 at 20 sets: 81,920 lanes);
# scripts/msm_probe.py sweep and chip_smoke.py's ACC_SCHEDULES_TIMED, PERF.md.
# The few-point batches (1,024-3,072 lanes) were not swept: the group, as
# at 2,048-8,192.
PATH_BATCHES = (
    (1 << 9, 1, "group"), (1 << 9, 4, "group"),
    (1 << 10, 1, "group"), (1 << 10, 4, "thread"), (1 << 10, 20, "thread3"),
    (1 << 11, 1, "group"), (1 << 11, 4, "thread"), (1 << 11, 8, "thread"),
    (1 << 11, 16, "thread"), (1 << 11, 20, "thread"),
    (1 << 16, 1, "thread"), (1 << 18, 1, "thread"),
    (16, 1, "group"), (16, 17, "group"), (256, 1, "group"), (256, 3, "group"),
)


def _path_shapes():
    """(rows, chunks, the fastest schedule) of each of PATH_BATCHES."""
    shapes = []
    for n, sets, fastest in PATH_BATCHES:
        windows = -(-254 // ecd._msm_c(n))
        q = n // max(1, n // ecd._q_rounds(n))
        rows, chunks = sets * windows, n // q
        shapes.append(pytest.param(rows, chunks, fastest, id=f"{rows}-{chunks}"))
    return shapes


@pytest.mark.parametrize("rows, chunks, fastest", _path_shapes())
def test_acc_plan_maps_every_path_shape(rows, chunks, fastest):
    assert fastest in cuda_jac.ACC_SCHEDULES
    assert cuda_jac.acc_plan(rows, chunks) == fastest


def test_acc_plan_thresholds_rise():
    most = [m for m, _ in cuda_jac.ACC_PLAN]
    assert most == sorted(set(most)) and most[0] > 0
    assert all(s in cuda_jac.ACC_SCHEDULES for _, s in cuda_jac.ACC_PLAN)
    assert cuda_jac.ACC_PLAN_ABOVE in cuda_jac.ACC_SCHEDULES
    above = [s for _, s in cuda_jac.ACC_PLAN[1:]] + [cuda_jac.ACC_PLAN_ABOVE]
    for (m, s), nxt in zip(cuda_jac.ACC_PLAN, above):
        for chunks in (64, 256):
            assert cuda_jac.acc_plan(m // chunks, chunks) == s
            assert cuda_jac.acc_plan(m // chunks + 1, chunks) == nxt
    assert cuda_jac.acc_plan(1, 1) == cuda_jac.ACC_PLAN[0][1]
    assert cuda_jac.acc_plan(22, 1 << 14) == cuda_jac.ACC_PLAN_ABOVE


def _entries(rows, q, chunks, seed):
    xs, ys = _srs_affine(32)
    rng = np.random.default_rng(seed)
    px, py = DQ.encode(xs), DQ.encode(ys)
    px[:, 3] = py[:, 3] = 0
    order = torch.from_numpy(rng.integers(0, 32, (rows, q, chunks)).astype(np.int32))
    sign = torch.from_numpy(rng.integers(0, 2, (rows, q, chunks)).astype(bool))
    order[0, -2, 0], sign[0, -2, 0] = order[0, -1, 0], sign[0, -1, 0]  # P == Q
    return px, py, order, sign


@pytest.mark.parametrize("schedule", [None, *cuda_jac.ACC_SCHEDULES], ids=str)
def test_forced_schedule_on_cpu_is_the_plain_rounds(schedule):
    px, py, order, sign = _entries(2, 8, 3, 5)
    want = cuda_jac.msm_chunk_acc_plain(px, py, order, sign)
    got = cuda_jac.msm_chunk_acc_cuda(px, py, order, sign, schedule)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("schedule", ["warp", "cluster", ("group",), ""], ids=repr)
def test_unknown_schedule_is_refused(schedule):
    px, py, order, sign = _entries(1, 2, 2, 6)
    with pytest.raises(ValueError):
        cuda_jac.msm_chunk_acc_cuda(px, py, order, sign, schedule)
