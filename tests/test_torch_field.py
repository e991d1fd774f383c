"""halo2_tpu_torch DeviceField against the reference DeviceField, limb for
limb: mul/square/add/sub/neg, pow_fixed/inv, mul_small, the predicates and
select, to_mont_arr/from_mont_arr/from_u32_array, encode/decode over BN254
Fr, BN254 Fq and Pasta Fp, on the edge values {0, 1, p-1, p-2} and seeded
random values, at batch sizes straddling the reference's 512-lane tile and
with a (16, 1) broadcast operand.

On the CPU the port's ``mul``/``square`` run the plain versions of the CUDA
Montgomery kernels (the kernels themselves are held against them on the card
by chip_smoke.py);
the reference runs its jnp path, as its own tests do off the TPU.
"""

import random

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
BATCHES = [1, 511, 512, 513]


def _values(p: int, n: int, seed: int) -> list:
    rng = random.Random(seed)
    edges = [0, 1, p - 1, p - 2]
    return (edges + [rng.randrange(p) for _ in range(max(n - 4, 0))])[:n]


def _port(arr) -> torch.Tensor:
    """Reference numpy / jnp uint32 limbs -> the port's int32 tensor."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.uint32)).view(np.int32))


def _same(port_out: torch.Tensor, ref_out) -> bool:
    got = port_out.numpy().view(np.uint32)
    assert got.max(initial=0) < 1 << 16, "a limb is >= 2^16"
    return np.array_equal(got, np.asarray(ref_out))


@pytest.fixture(params=FIELDS)
def fields(request):
    name = request.param
    return ref_field(getattr(ref_params, name)), port_field(getattr(port_params, name))


@pytest.mark.parametrize("n", BATCHES)
def test_encode_decode_matches_reference(fields, n):
    rf, pf = fields
    vals = _values(rf.p, n, seed=n)
    for mont in (True, False):
        enc = pf.encode(vals, to_mont=mont)
        assert enc.dtype == torch.int32 and tuple(enc.shape) == (16, n)
        assert _same(enc, rf.encode_np(vals, to_mont=mont))
        assert [int(v) for v in pf.decode(enc, from_mont=mont)] == [v % rf.p for v in vals]


@pytest.mark.parametrize("n", BATCHES)
@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_binary_op_matches_reference(fields, n, op):
    rf, pf = fields
    a_np = rf.encode_np(_values(rf.p, n, seed=1))
    b_np = rf.encode_np(list(reversed(_values(rf.p, n, seed=2))))
    want = getattr(rf, op)(a_np, b_np)
    assert _same(getattr(pf, op)(_port(a_np), _port(b_np)), want)


@pytest.mark.parametrize("n", BATCHES)
def test_broadcast_operand_matches_reference(fields, n):
    """(16, n) x (16, 1), as the NTT's n^-1 and coset constants are applied."""
    rf, pf = fields
    a_np = rf.encode_np(_values(rf.p, n, seed=3))
    for c in (rf.p - 1, 7):
        col = rf.encode_np([c])  # (16, 1)
        assert _same(pf.mul(_port(a_np), _port(col)), rf.mul(a_np, col))
        assert _same(pf.mul(_port(col), _port(a_np)), rf.mul(col, a_np))
        assert _same(pf.add(_port(a_np), _port(col)), rf.add(a_np, col))


@pytest.mark.parametrize("n", BATCHES)
def test_unary_ops_match_reference(fields, n):
    rf, pf = fields
    vals = _values(rf.p, n, seed=4)
    a_np = rf.encode_np(vals)
    assert _same(pf.neg(_port(a_np)), rf.neg(a_np))
    assert _same(pf.from_mont_arr(_port(a_np)), rf.from_mont_arr(a_np))
    raw = rf.encode_np(vals, to_mont=False)
    assert _same(pf.to_mont_arr(_port(raw)), rf.to_mont_arr(raw))


@pytest.mark.parametrize("n", BATCHES)
def test_square_matches_reference(fields, n):
    rf, pf = fields
    a_np = rf.encode_np(_values(rf.p, n, seed=5))
    got = pf.square(_port(a_np))
    assert _same(got, rf.square(a_np))
    assert torch.equal(got, cuda_mul.mont_sqr_plain(pf.spec, _port(a_np)))
    assert torch.equal(got, pf.mul(_port(a_np), _port(a_np)))


def test_pow_and_inv_match_reference(fields):
    rf, pf = fields
    a_np = rf.encode_np(_values(rf.p, 9, seed=6))
    assert _same(pf.inv(_port(a_np)), rf.inv(a_np))  # inv(0) = 0
    for e in (0, 1, 2, 5, 0xFFFF_FFFF_FFFF, rf.p - 1):
        assert _same(pf.pow_fixed(_port(a_np), e), rf.pow_fixed(a_np, e)), e


def test_predicates_select_and_small_ops_match_reference(fields):
    rf, pf = fields
    n = 9
    a_np = rf.encode_np(_values(rf.p, n, seed=7))
    b_np = a_np.copy()
    b_np[:, 5:] = rf.encode_np(_values(rf.p, n, seed=8))[:, 5:]
    a, b = _port(a_np), _port(b_np)
    assert np.array_equal(pf.is_zero(a).numpy(), np.asarray(rf.is_zero(a_np)))
    assert np.array_equal(pf.eq(a, b).numpy(), np.asarray(rf.eq(a_np, b_np)))
    mask_np = np.array([i % 3 == 0 for i in range(n)])
    assert _same(pf.select(torch.from_numpy(mask_np), a, b), rf.select(mask_np, a_np, b_np))
    col = rf.encode_np([3])
    assert _same(pf.select(torch.from_numpy(mask_np), _port(col), b), rf.select(mask_np, col, b_np))
    for k in range(5):
        assert _same(pf.mul_small(a, k), rf.mul_small(a_np, k)), k
    rng = random.Random(9)
    u32 = np.array(
        [0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF] + [rng.randrange(1 << 32) for _ in range(4)], np.uint32
    )
    want = rf.from_u32_array(u32)
    assert _same(pf.from_u32_array(torch.from_numpy(u32.view(np.int32))), want)
    assert _same(pf.from_u32_array(torch.from_numpy(u32.astype(np.int64))), want)


def test_mont_mul_wrapper_checks_its_inputs():
    spec = port_params.BN254_FR
    a = torch.zeros((16, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        cuda_mul.mont_mul(spec, a.to(torch.int64), a)
    with pytest.raises(ValueError):
        cuda_mul.mont_mul(spec, a[:8], a[:8])
    with pytest.raises(ValueError):
        cuda_mul.mont_mul(spec, a, torch.zeros((16, 3), dtype=torch.int32))
    with pytest.raises(ValueError):
        cuda_mul.mont_mul(spec, a[:, ::2], a[:, ::2])
    with pytest.raises(TypeError):
        cuda_mul.mont_sqr(spec, a.to(torch.int64))
    with pytest.raises(ValueError):
        cuda_mul.mont_sqr(spec, a[:, ::2])
