"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test skips.  This file imports
no JAX, so it runs on the machine with the card, where JAX is absent and
tests/conftest.py (which imports it) must be left out:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda
"""

import random

import pytest
import torch

from halo2_tpu_torch.field import cuda_mul
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP
from halo2_tpu_torch.poly import cuda_ntt
from halo2_tpu_torch.poly.domain import _ntt_raw, twiddle_table

pytestmark = pytest.mark.cuda


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


def test_cuda_ntt_matches_cpu_ntt(device):
    spec, n = BN254_FR, 1 << 11
    x = _encoded(spec, n, 5, torch.device("cpu"))
    want = _ntt_raw(spec, n, False)(x)
    got = _ntt_raw(spec, n, False)(x.to(device))
    assert torch.equal(got.cpu(), want)
