"""The plain versions of the CUDA field add/subtract kernels, and their
wrappers on CPU tensors, against the reference's jnp ``add``/``sub``/``neg``
limb for limb: BN254 Fr, BN254 Fq and Pasta Fp, the edge values {0, 1, p-1,
p-2} against each other (every pair), seeded random values, and one
broadcast element on either side.  The kernels are held against these plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import random

import numpy as np
import pytest
import torch

from halo2_tpu.field import params as ref_params
from halo2_tpu.field.device import get_device_field as ref_field
from halo2_tpu_torch.field import cuda_ops
from halo2_tpu_torch.field import params as port_params
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

FIELDS = ["BN254_FR", "BN254_FQ", "PASTA_FP"]


def _operands(p: int, seed: int):
    """(a, b) host ints: every ordered pair of edge values, then random."""
    edges = [0, 1, p - 1, p - 2]
    rng = random.Random(seed)
    pairs = [(x, y) for x in edges for y in edges] + [(rng.randrange(p), rng.randrange(p)) for _ in range(47)]
    return [x for x, _ in pairs], [y for _, y in pairs]


def _port(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.uint32)).view(np.int32))


def _same(got: torch.Tensor, want) -> bool:
    g = got.numpy().view(np.uint32)
    assert g.max(initial=0) < 1 << 16, "a limb is >= 2^16"
    return g.shape == np.asarray(want).shape and np.array_equal(g, np.asarray(want))


@pytest.fixture(params=FIELDS)
def field(request):
    name = request.param
    return ref_field(getattr(ref_params, name)), getattr(port_params, name)


@pytest.mark.parametrize("op", ["add", "sub", "neg"])
def test_plain_matches_reference(field, op):
    rf, spec = field
    xs, ys = _operands(rf.p, seed=len(op))
    a_np, b_np = rf.encode_np(xs), rf.encode_np(ys)
    a, b = _port(a_np), _port(b_np)
    if op == "neg":
        want = rf.neg(a_np)
        assert _same(cuda_ops.mod_neg_plain(spec, a), want)
        assert _same(cuda_ops.mod_neg(spec, a), want)
    else:
        want = getattr(rf, op)(a_np, b_np)
        assert _same(getattr(cuda_ops, f"mod_{op}_plain")(spec, a, b), want)
        assert _same(getattr(cuda_ops, f"mod_{op}")(spec, a, b), want)


@pytest.mark.parametrize("side", ["left", "right"])
@pytest.mark.parametrize("op", ["add", "sub"])
def test_broadcast_element_matches_reference(field, op, side):
    """One element, (16, 1) or (16,), against a (16, 60) batch, on either
    side (the wrapper's add takes it on the right only: it commutes)."""
    rf, spec = field
    xs, _ = _operands(rf.p, seed=7)
    batch_np = rf.encode_np(xs[:60])
    for v in (0, 1, rf.p - 1, 12345):
        one_np = rf.encode_np([v])  # (16, 1)
        a_np, b_np = (one_np, batch_np) if side == "left" else (batch_np, one_np)
        want = getattr(rf, op)(a_np, b_np)
        assert _same(getattr(cuda_ops, f"mod_{op}_plain")(spec, _port(a_np), _port(b_np)), want)
        for one in (_port(one_np), _port(one_np[:, 0])):  # (16, 1) and (16,)
            a, b = (one, _port(batch_np)) if side == "left" else (_port(batch_np), one)
            if op == "add" and side == "left":
                a, b = b, a
            assert _same(getattr(cuda_ops, f"mod_{op}")(spec, a, b), want)


def test_wrappers_reject_other_broadcasts():
    spec = port_params.BN254_FR
    a = torch.zeros((16, 8), dtype=torch.int32)
    for bad in (torch.zeros((16, 4), dtype=torch.int32), torch.zeros((16, 2, 8), dtype=torch.int32)):
        with pytest.raises(ValueError):
            cuda_ops.mod_add(spec, a, bad)
        with pytest.raises(ValueError):
            cuda_ops.mod_sub(spec, bad, a)
    with pytest.raises(ValueError):
        cuda_ops.mod_add(spec, a[:, :1].contiguous(), a)  # the wide operand goes left
    with pytest.raises(TypeError):
        cuda_ops.mod_sub(spec, a.long(), a)
    with pytest.raises(ValueError):
        cuda_ops.mod_neg(spec, torch.zeros((16, 16), dtype=torch.int32)[:, ::2])  # not contiguous


def test_cpu_calls_launch_nothing():
    spec = port_params.PASTA_FP
    a = torch.ones((16, 5), dtype=torch.int32)
    before = dict(cuda_ops.LAUNCHES)
    cuda_ops.mod_add(spec, a, a)
    cuda_ops.mod_sub(spec, a, a)
    cuda_ops.mod_neg(spec, a)
    assert cuda_ops.LAUNCHES == before
