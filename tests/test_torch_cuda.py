"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test skips.  This file imports
no JAX, so it runs on the machine with the card, where JAX is absent and
tests/conftest.py (which imports it) must be left out:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda
"""

import os
import pickle
import random

import numpy as np
import pytest
import torch

from halo2_tpu_torch import native
from halo2_tpu_torch.ec import cuda_jac
from halo2_tpu_torch.ec import device as ecd
from halo2_tpu_torch.field import cuda_mul
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP
from halo2_tpu_torch.poly import cuda_ntt
from halo2_tpu_torch.poly.domain import _ntt_raw, twiddle_table

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _encoded(spec, n, seed, device):
    rng = random.Random(seed)
    p = spec.p
    vals = ([0, 1, p - 1, p - 2] + [rng.randrange(p) for _ in range(n)])[:n]
    return get_device_field(spec).encode(vals, device=device)


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("m", [1, 511, 513, 4096])
def test_mont_mul_kernel_matches_plain(device, spec, m):
    a = _encoded(spec, m, 1, device)
    b = _encoded(spec, m, 2, device).flip(1).contiguous()
    col = _encoded(spec, 1, 3, device)
    before = cuda_mul.LAUNCHES["mont_mul"]
    for bb in (b, col):
        got = cuda_mul.mont_mul(spec, a, bb)
        torch.cuda.synchronize(device)
        assert torch.equal(got, cuda_mul.mont_mul_plain(spec, a, bb))
    assert cuda_mul.LAUNCHES["mont_mul"] == before + 2


@pytest.mark.parametrize("k", [9, 12])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernels_match_plain(device, k, inverse):
    spec, n = BN254_FR, 1 << k
    x = _encoded(spec, n, k, device)
    tw = twiddle_table(spec, n, inverse, device)
    y = cuda_ntt.ntt_small_stages(spec, x, tw)
    assert torch.equal(y, cuda_ntt.ntt_small_stages_plain(spec, x, tw))
    m = cuda_ntt.TILE
    while m < n:
        z = cuda_ntt.ntt_large_stage(spec, y, tw, m)
        assert torch.equal(z, cuda_ntt.ntt_large_stage_plain(spec, y, tw, m))
        y, m = z, m * 2
    torch.cuda.synchronize(device)
    assert torch.equal(_ntt_raw(spec, n, True)(_ntt_raw(spec, n, False)(x)), x)


@pytest.mark.parametrize("spec", [BN254_FR, PASTA_FP], ids=lambda s: s.name)
def test_batched_ntt_kernels_match_plain(device, spec):
    """Three columns in one launch, both arithmetics (``cuda_ntt._arith``)."""
    n = 1 << 11
    x = torch.stack([_encoded(spec, n, 20 + c, device) for c in range(3)])
    tw = twiddle_table(spec, n, False, device)
    before = dict(cuda_ntt.LAUNCHES)
    y = cuda_ntt.ntt_small_stages(spec, x, tw)
    z = cuda_ntt.ntt_large_stage(spec, y, tw, 512)
    assert cuda_ntt.LAUNCHES["ntt_small_stages"] == before["ntt_small_stages"] + 1
    assert cuda_ntt.LAUNCHES["ntt_large_stage"] == before["ntt_large_stage"] + 1
    torch.cuda.synchronize(device)
    assert torch.equal(y, cuda_ntt.ntt_small_stages_plain(spec, x, tw))
    assert torch.equal(z, cuda_ntt.ntt_large_stage_plain(spec, y, tw, 512))
    assert torch.equal(_ntt_raw(spec, n, True)(_ntt_raw(spec, n, False)(x)), x)


def test_cuda_ntt_matches_cpu_ntt(device):
    spec, n = BN254_FR, 1 << 11
    x = _encoded(spec, n, 5, torch.device("cpu"))
    want = _ntt_raw(spec, n, False)(x)
    got = _ntt_raw(spec, n, False)(x.to(device))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("m", [1, 511, 513, 4096])
def test_mont_sqr_kernel_matches_plain(device, spec, m):
    a = _encoded(spec, m, 4, device)
    before = cuda_mul.LAUNCHES["mont_sqr"]
    got = cuda_mul.mont_sqr(spec, a)
    torch.cuda.synchronize(device)
    assert torch.equal(got, cuda_mul.mont_sqr_plain(spec, a))
    assert torch.equal(got, cuda_mul.mont_mul(spec, a, a))
    assert cuda_mul.LAUNCHES["mont_sqr"] == before + 1


def _srs(n, device):
    with open(os.path.join(ROOT, ".srs", "kzg_bn254_k13_s857536.pkl"), "rb") as f:
        data = pickle.load(f)
    px, py = (np.ascontiguousarray(data[k][:, :n]) for k in ("g1_x", "g1_y"))
    return px, py, *(torch.from_numpy(a.view(np.int32)).to(device) for a in (px, py))


def _points(m, device):
    """p: points with z != 1 (doubled); q: affine points.  Lane 0: P == Q,
    lane 1: P == -Q, lane 2: P at infinity, lane 3: Q at infinity (full add)
    or masked (mixed add)."""
    _, _, x, y = _srs(2 * m, device)
    p = ecd.jac_double(ecd.jac_from_affine(x[:, :m].contiguous(), y[:, :m].contiguous()))
    qx, qy = x[:, m:].contiguous(), y[:, m:].contiguous()
    ax, ay = ecd.jac_to_affine(p)
    qx[:, :2], qy[:, 0], qy[:, 1] = ax[:, :2], ay[:, 0], ecd.df().neg(ay)[:, 1]
    q = ecd.jac_double(ecd.jac_from_affine(qx, qy))
    for k in q:
        q[k][:, 0] = p[k][:, 0]
    q["x"][:, 1], q["y"][:, 1], q["z"][:, 1] = p["x"][:, 1], ecd.df().neg(p["y"])[:, 1], p["z"][:, 1]
    inf = ecd.jac_infinity((), device=device)
    for k in p:
        p[k][:, 2] = inf[k]
        q[k][:, 3] = inf[k]
    valid = torch.ones(m, dtype=torch.bool, device=device)
    valid[3] = False
    return p, q, qx, qy, valid


@pytest.fixture
def flag_reads(monkeypatch):
    """Counts calls of the plain versions' P == Q fix-up, each one device ->
    host read; the CUDA path must make none."""
    calls = []
    orig = cuda_jac._double_fixup

    def counted(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(cuda_jac, "_double_fixup", counted)
    return calls


@pytest.mark.parametrize("m", [8, 513, 4096])
def test_jac_kernels_match_plain(device, m, flag_reads):
    p, q, qx, qy, valid = _points(m, device)
    before = dict(cuda_jac.LAUNCHES)
    for which in cuda_jac.VARIANTS:
        got_madd = cuda_jac._jac_madd(p, qx, qy, valid, which)
        got_add = cuda_jac._jac_add(p, q, which)
        torch.cuda.synchronize(device)
        assert flag_reads == [], which
        want_madd = cuda_jac.jac_madd_plain(p, qx, qy, valid)
        want_add = cuda_jac.jac_add_plain(p, q)
        for k in ("x", "y", "z"):
            assert torch.equal(got_madd[k], want_madd[k]), (which, k)
            assert torch.equal(got_add[k], want_add[k]), (which, k)
        flag_reads.clear()
    assert cuda_jac.LAUNCHES["jac_madd"] == before["jac_madd"] + len(cuda_jac.VARIANTS)
    assert cuda_jac.LAUNCHES["jac_add"] == before["jac_add"] + len(cuda_jac.VARIANTS)


def test_msm_points_matches_native(device, flag_reads):
    n = 1 << 12
    rng = random.Random(12)
    px, py, x, y = _srs(n, device)
    sc = get_device_field(BN254_FR).encode_np([rng.randrange(BN254_FR.p) for _ in range(n)], to_mont=False)
    before = dict(cuda_jac.LAUNCHES)
    got = ecd.msm_points(x, y, torch.from_numpy(sc.view(np.int32)).to(device))
    want = native.msm_g1_mont(native.pack_device(px), native.pack_device(py), native.pack_device(sc))
    assert got == want
    assert cuda_jac.LAUNCHES["jac_madd"] > before["jac_madd"]
    assert cuda_jac.LAUNCHES["jac_add"] > before["jac_add"]
    assert flag_reads == []


def test_entry_points_default_to_the_card(device):
    from halo2_tpu_torch._device import resolve_device
    from halo2_tpu_torch.circuits.less_than import LessThanCircuit
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.field import Fp
    from halo2_tpu_torch.plonkish import Value

    assert resolve_device(None).type == "cuda"
    circuit = LessThanCircuit(Fp, Value.known(Fp.from_u64(3)))
    prover = MockProver.run(10, circuit, [[Fp.from_u64(i) for i in range(754)]], F=Fp)
    assert prover.device.type == "cuda"
    assert prover.verify() == []
