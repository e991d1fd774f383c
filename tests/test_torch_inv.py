"""The port's field inverse against the reference on the CPU, limb for limb.

``DeviceField.inv`` goes to ``field.cuda_mul.mont_inv``: on the card the
``mont_inv`` kernel (``csrc/inv.cu``, a fixed-count safegcd in one launch),
on the CPU its plain version ``mont_inv_plain``, which runs the kernel's
divsteps in int64 torch ops on the same 30-bit limbs for the same count.
Here the plain version is held against the reference's
``DeviceField.inv`` (its ``lax.scan`` Fermat power, JAX on the CPU),
against ``mont_pow_plain(a, p - 2)`` and against Python's
``pow(x, -1, p)``, for BN254 Fr, BN254 Fq and Pasta Fp, on 0, 1, p - 1,
R mod p, powers of two and numpy-seeded random values.  The kernel is held
against the plain version on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 2).
"""

import numpy as np
import pytest
import torch

from halo2_tpu.field import params as ref_params
from halo2_tpu.field.device import get_device_field as ref_field
from halo2_tpu_torch.field import cuda_mul
from halo2_tpu_torch.field import params as port_params
from halo2_tpu_torch.field.device import get_device_field as port_field
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

FIELDS = ["BN254_FR", "BN254_FQ", "PASTA_FP"]


def _values(p: int, seed: int, count: int = 40) -> list:
    """0, 1, p - 1, R mod p, powers of two below p, then numpy-seeded
    random values below p (eight 32-bit words each, reduced)."""
    powers = [1 << k for k in (1, 31, 64, 128, 200, p.bit_length() - 1)]
    edges = [0, 1, p - 1, (1 << 256) % p] + powers
    words = np.random.default_rng(seed).integers(0, 1 << 32, size=(count, 8), dtype=np.uint64)
    rand = [sum(int(w) << (32 * k) for k, w in enumerate(row)) % p for row in words]
    return edges + rand


def _inverses(vals: list, p: int) -> list:
    return [pow(v, -1, p) if v else 0 for v in vals]


def _port(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.uint32)).view(np.int32))


@pytest.mark.parametrize("field", FIELDS)
def test_mont_inv_plain_matches_reference_inv(field):
    rf = ref_field(getattr(ref_params, field))
    spec = getattr(port_params, field)
    vals = _values(rf.p, seed=len(field))
    a_np = rf.encode_np(vals)
    a = _port(a_np)
    got = cuda_mul.mont_inv_plain(spec, a)
    assert int(got.max()) < 1 << 16, "a limb is >= 2^16"
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(rf.inv(a_np)))
    assert torch.equal(got, cuda_mul.mont_pow_plain(spec, a, rf.p - 2))
    assert [int(v) for v in port_field(spec).decode(got)] == _inverses(vals, rf.p)
    assert torch.equal(a, _port(a_np)), "the input was written"


@pytest.mark.parametrize("field", FIELDS)
@pytest.mark.parametrize("m", [1, 3, 5, (1 << 11) - 1])
def test_mont_inv_plain_matches_reference_at_ragged_sizes(field, m):
    """The sizes a lane group leaves ragged (a group of 2 or 4 lanes an
    element, 32-lane warps): each of 0, 1, p - 1 and p - 2 at the front in
    turn, the rest numpy-seeded random values below p."""
    rf = ref_field(getattr(ref_params, field))
    spec = getattr(port_params, field)
    p = rf.p
    edges = [0, 1, p - 1, p - 2]
    rand = _values(p, seed=m, count=max(0, m - 4))[10:]
    for rot in range(4 if m < 4 else 1):
        vals = (edges[rot:] + edges[:rot] + rand)[:m]
        a_np = rf.encode_np(vals)
        got = cuda_mul.mont_inv_plain(spec, _port(a_np))
        assert np.array_equal(got.numpy().view(np.uint32), np.asarray(rf.inv(a_np))), (m, rot)
        assert [int(v) for v in port_field(spec).decode(got).reshape(-1)] == _inverses(vals, p)


PLAN_SIZES = {most + d for most, _s in cuda_mul.INV_PLAN for d in (-1, 0, 1)}


@pytest.mark.parametrize("m", sorted({1, 2, 1 << 16, 1 << 20} | PLAN_SIZES))
def test_inv_plan_thresholds(m):
    """inv_plan takes the first INV_PLAN entry whose most elements m does
    not exceed (at, below and just above each threshold), else
    INV_PLAN_ABOVE; every G it picks is one of INV_GROUPS."""
    want = next((s for most, s in cuda_mul.INV_PLAN if m <= most), cuda_mul.INV_PLAN_ABOVE)
    assert cuda_mul.inv_plan(m) == want
    assert want in cuda_mul.INV_GROUPS
    nexts = [*cuda_mul.INV_PLAN[1:], (None, cuda_mul.INV_PLAN_ABOVE)]
    for (most, sched), (nxt, nsched) in zip(cuda_mul.INV_PLAN, nexts):
        assert cuda_mul.inv_plan(most) == sched and cuda_mul.inv_plan(most + 1) == nsched
        assert nxt is None or nxt > most


def _signed(v: int, bits: int) -> int:
    v &= (1 << bits) - 1
    return v - (1 << bits) if v >> (bits - 1) else v


def _jump_batch(zeta: int, f: int, g: int) -> tuple:
    """One batch of INV_STEPS divsteps as csrc/inv.cu's kernel runs it on
    the low limbs (mod 2^32): INV_JUMPS table jumps of INV_JUMP steps, then
    single steps; returns zeta and (u, v, q, r)."""
    table, (lo, hi) = cuda_mul.inv_jump_table(), cuda_mul.INV_ZETA_CLAMP
    jump, m32 = cuda_mul.INV_JUMP, (1 << 32) - 1
    half, full = 1 << (jump - 1), 1 << jump
    cols = [[1, 0], [0, 1]]  # (top, bottom): (u, q) and (v, r)
    for _ in range(cuda_mul.INV_JUMPS):
        zc = min(max(zeta, lo), hi)
        entry = ((zc - lo) * half + ((f >> 1) & (half - 1))) * full + (g & (full - 1))
        words = [int(w) for w in table[entry]]
        m00, m01, m10, m11, s, c = (_signed(w >> (16 * k), 16) for w in words[:3] for k in range(2))
        assert words[3] == 0
        zeta = s * zeta + c
        f, g = ((m00 * f + m01 * g) & m32) >> jump, ((m10 * f + m11 * g) & m32) >> jump
        cols = [[(m00 * t + m01 * b) & m32, (m10 * t + m11 * b) & m32] for t, b in cols]
    for i in range(cuda_mul.INV_STEPS - jump * cuda_mul.INV_JUMPS):
        odd = (g >> i) & 1
        swap = odd and zeta < 0
        g_next = (g - f) if swap else (g + f) if odd else g
        f, g = (2 * g if swap else 2 * f) & m32, g_next & m32
        zeta = -zeta - 2 if swap else zeta - 1
        cols = [
            [(2 * b if swap else 2 * t) & m32, ((b - t) if swap else (b + t) if odd else b) & m32]
            for t, b in cols
        ]
    return zeta, tuple(_signed(v, 32) for v in (cols[0][0], cols[1][0], cols[0][1], cols[1][1]))


def test_inv_jump_table_gives_the_divsteps_matrix():
    """The kernel's table-driven batch (INV_JUMPS lookups of INV_JUMP
    divsteps, then single steps) gives the plain version's transition
    matrix and zeta, on numpy-seeded 30-bit low limbs (f odd) and zeta
    across the clamp's classes and far outside them."""
    rng = np.random.default_rng(23)
    n = 400
    f = rng.integers(0, 1 << 29, n, dtype=np.int64) * 2 + 1
    g = rng.integers(0, 1 << 30, n, dtype=np.int64)
    zeta = rng.integers(-700, 700, n, dtype=np.int64)
    zeta[:40] = np.arange(-20, 20)
    want_z, want_t = cuda_mul._divsteps_30(*(torch.from_numpy(v) for v in (zeta, f, g)))
    for k in range(n):
        z, t = _jump_batch(int(zeta[k]), int(f[k]), int(g[k]))
        assert z == int(want_z[k])
        assert t == tuple(int(w[k]) for w in want_t)
    lo, hi = cuda_mul.INV_ZETA_CLAMP
    assert cuda_mul.inv_jump_table().shape == ((hi - lo + 1) << (2 * cuda_mul.INV_JUMP - 1), 4)
    # the clamp keeps every INV_JUMP-step map: zeta and its class agree
    for z in range(-60, 61):
        for fv in range(1, 1 << cuda_mul.INV_JUMP, 2):
            for gv in range(1 << cuda_mul.INV_JUMP):
                want = cuda_mul._divsteps_path(min(max(z, lo), hi), fv, gv, cuda_mul.INV_JUMP)
                assert cuda_mul._divsteps_path(z, fv, gv, cuda_mul.INV_JUMP) == want
    assert cuda_mul.INV_JUMP * cuda_mul.INV_JUMPS <= cuda_mul.INV_STEPS


def test_mont_inv_forced_groups():
    """Every G gives the plain version's limbs on a CPU tensor; an unknown
    G raises before anything runs."""
    spec = port_params.BN254_FR
    a = port_field(spec).encode(_values(spec.p, seed=3, count=20))
    want = cuda_mul.mont_inv_plain(spec, a)
    for group in cuda_mul.INV_GROUPS:
        assert torch.equal(cuda_mul._mont_inv(spec, a, group), want)
    for bad in (0, 1, 3, 8, 32, (2,)):
        with pytest.raises(ValueError, match="unknown lane group"):
            cuda_mul._mont_inv(spec, a, bad)


@pytest.mark.parametrize("field", FIELDS)
def test_inv_goes_to_mont_inv_and_keeps_the_batch_shape(field, monkeypatch):
    """DeviceField.inv calls mont_inv (not mont_pow) once, over a 2-d batch,
    and gives its shape back; the wrapper on a CPU tensor is the plain
    version."""
    spec = getattr(port_params, field)
    pf = port_field(spec)
    vals = _values(spec.p, seed=7, count=3)[:12]
    a = pf.encode(vals).reshape(16, 3, 4)
    calls = []
    monkeypatch.setattr(cuda_mul, "mont_pow", lambda *args: calls.append("mont_pow"))
    real = cuda_mul.mont_inv
    monkeypatch.setattr(
        "halo2_tpu_torch.field.device.mont_inv", lambda s, x: calls.append("mont_inv") or real(s, x)
    )
    got = pf.inv(a)
    assert calls == ["mont_inv"]
    assert got.shape == (16, 3, 4)
    assert torch.equal(got, cuda_mul.mont_inv_plain(spec, a))
    assert [int(v) for v in pf.decode(got).reshape(-1)] == _inverses(vals, spec.p)


def test_mont_inv_wrapper_checks_its_input():
    spec = port_params.BN254_FR
    a = port_field(spec).encode([3, 5, 7, 11])
    with pytest.raises(TypeError):
        cuda_mul.mont_inv(spec, a.to(torch.int64))
    with pytest.raises(ValueError):
        cuda_mul.mont_inv(spec, a[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        cuda_mul.mont_inv(spec, a[:8])  # not (16, ...)
    with pytest.raises(ValueError):
        cuda_mul.mont_inv(spec, a.to("meta"))  # neither the CPU nor a card
    assert cuda_mul.mont_inv(spec, a[:, :0].contiguous()).shape == (16, 0)


@pytest.mark.parametrize("field", FIELDS + ["PASTA_FQ"])
def test_inv_constants_are_the_kernels(field):
    """inv_words is the 27-word argument csrc/inv.cu reads: p and n0, R^3 mod
    p, p in nine 30-bit limbs, p^-1 mod 2^30."""
    spec = getattr(port_params, field)
    p = spec.p
    words = [int(w) for w in cuda_mul.inv_words(spec)]
    assert len(words) == 27
    assert words[:9] == [int(w) for w in cuda_mul.modulus_words(spec)]
    assert sum(w << (32 * k) for k, w in enumerate(words[9:17])) == pow(2, 768, p)
    assert sum(w << (30 * k) for k, w in enumerate(words[17:26])) == p
    assert all(w < 1 << 30 for w in words[17:26])
    assert words[26] * p % (1 << 30) == 1
    assert cuda_mul.INV_BATCHES * cuda_mul.INV_STEPS >= 590  # enough for every input below 2^256
