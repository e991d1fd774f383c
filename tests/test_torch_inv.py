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
