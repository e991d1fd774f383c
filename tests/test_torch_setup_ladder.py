"""The SRS setup's double-and-add as one ``jac_ladder`` launch, checked on
the CPU, where the wrappers run their plain versions:

- ``scalar_mul_batched_plain`` (``ec/cuda_jac.py``) and the rewired
  ``ec.device.scalar_mul_batched`` against the reference's
  ``halo2_tpu.ec.device.scalar_mul_batched`` (its ``lax.scan``, jnp on the
  CPU) limb for limb: 8 lanes of Jacobian points with z != 1, 32 bit rows,
  a zero scalar and an infinity base among them, on uint8 and int32 bits;
- the plain ladder's P == Q add (the bits of 2^254 mod R below row 254
  and row 254 set) against the host ``ec_mul``;
- the setup's bit rows (``kzg.params.scalar_bits``, one ``np.unpackbits``)
  against the construction they replace (16-bit limbs and a shift) on
  2^10 random powers, and ``device_g1_powers`` at n = 32 against the host
  branch of ``ParamsKZG.setup``;
- the wrapper's dispatch: a CPU tensor runs the plain version and counts
  no launch; another device, a bad dtype or shape raises; any nonzero
  uint8 or int32 value is a set bit.

The kernel is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2).  Inputs come from a
numpy seed.
"""

import jax
import numpy as np
import pytest
import torch

from halo2_tpu.ec import device as ref_ecd
from halo2_tpu_torch.ec import cuda_jac, host
from halo2_tpu_torch.ec import device as ecd
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR
from halo2_tpu_torch.kzg.params import device_g1_powers, scalar_bits
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

Q = BN254_FQ.p
LANES, ROWS = 8, 32


def _port(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.uint32)).view(np.int32))


def _points(seed: int):
    """LANES Jacobian points (x z^2, y z^3, z), z random, as (16, LANES)
    Montgomery limbs (numpy uint32); lane 1 the infinity (0, 1, 0)."""
    rng = np.random.default_rng(seed)
    d = get_device_field(BN254_FQ)
    cols = {"x": [], "y": [], "z": []}
    for i in range(LANES):
        if i == 1:
            x, y, z = 0, 1, 0
        else:
            k = int.from_bytes(rng.bytes(16), "little") + 1
            ax, ay = host.g1_to_ints(host.ec_mul(host.G1, k))
            z = int.from_bytes(rng.bytes(32), "little") % (Q - 1) + 1
            x, y = ax * z * z % Q, ay * z * z * z % Q
        for k_, v in zip("xyz", (x, y, z)):
            cols[k_].append(v)
    return {k: d.encode_np(v) for k, v in cols.items()}


def _scalars(seed: int, nbits: int) -> list:
    """LANES scalars below 2^nbits; lane 0 is 0."""
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(8), "little") % (1 << nbits) for _ in range(LANES)]
    vals[0] = 0
    return vals


def test_scalar_mul_batched_plain_matches_reference():
    pts = _points(1)
    bits = scalar_bits(_scalars(2, ROWS))[:ROWS]  # (32, 8) uint8
    want = jax.jit(ref_ecd.scalar_mul_batched)(pts, bits.astype(np.uint32))
    port_pts = {k: _port(v) for k, v in pts.items()}
    for b in (torch.from_numpy(bits), torch.from_numpy(bits.astype(np.int32))):
        plain = cuda_jac.scalar_mul_batched_plain(port_pts, b)
        for got in (plain, ecd.scalar_mul_batched(port_pts, b)):
            for k in ("x", "y", "z"):
                assert np.array_equal(got[k].numpy().view(np.uint32), np.asarray(want[k])), k
    assert all(torch.equal(port_pts[k], _port(pts[k])) for k in pts), "the input was written"


def test_plain_ladder_doubles_where_acc_meets_base():
    """Row 254 adds base to an acc equal to it (the P == Q branch, the
    plain version's _double_fixup), and the result is the host's."""
    s = (1 << 254) % host.R + (1 << 254)
    pt = host.ec_mul(host.G1, 7)
    d = get_device_field(BN254_FQ)
    x, y = host.g1_to_ints(pt)
    p = ecd.jac_from_affine(d.encode([x]), d.encode([y]))
    calls = []
    fixup = cuda_jac._double_fixup

    def counted(out, same, p_, d_):
        calls.append(int(same.sum()))
        return fixup(out, same, p_, d_)

    try:
        cuda_jac._double_fixup = counted
        got = cuda_jac.scalar_mul_batched_plain(p, torch.from_numpy(scalar_bits([s])))
    finally:
        cuda_jac._double_fixup = fixup
    # (row 255 meets it too, in an add the select leaves out)
    assert calls[254] == 1, "row 254 did not meet the P == Q branch"
    ax, ay = ecd.jac_to_affine(got)
    assert (int(d.decode(ax)[0]), int(d.decode(ay)[0])) == host.g1_to_ints(host.ec_mul(pt, s))


def test_scalar_bits_match_the_limb_construction():
    """The bits of 2^10 random powers equal the rows the setup built before:
    16-bit limbs, each shifted by 0 .. 15."""
    rng = np.random.default_rng(10)
    tau = int.from_bytes(rng.bytes(32), "little") % host.R
    powers = [1] * (1 << 10)
    for i in range(1, len(powers)):
        powers[i] = powers[i - 1] * tau % host.R
    limbs = get_device_field(BN254_FR).encode_np(powers, to_mont=False)  # (16, n)
    shifts = np.arange(16, dtype=np.uint32)[None, :, None]
    old = ((limbs[:, None, :] >> shifts) & 1).reshape(256, len(powers))
    got = scalar_bits(powers)
    assert got.dtype == np.uint8 and got.shape == (256, len(powers)) and got.flags.c_contiguous
    assert np.array_equal(got, old)


def test_device_g1_powers_matches_host_branch():
    n = 32
    rng = np.random.default_rng(32)
    tau = int.from_bytes(rng.bytes(32), "little") % host.R
    powers = [pow(tau, i, host.R) for i in range(n)]
    d = get_device_field(BN254_FQ)
    pts = [host.g1_to_ints(host.ec_mul(host.G1, v)) for v in powers]
    g1_x, g1_y = device_g1_powers(powers, torch.device("cpu"))
    assert np.array_equal(g1_x, d.encode_np([p[0] for p in pts]))
    assert np.array_equal(g1_y, d.encode_np([p[1] for p in pts]))


def test_jac_ladder_dispatch_and_checks():
    pts = {k: _port(v) for k, v in _points(3).items()}
    bits = torch.from_numpy(scalar_bits(_scalars(4, 8))[:8])
    before = dict(cuda_jac.LAUNCHES)
    got = cuda_jac.jac_ladder_cuda(pts, bits)
    want = cuda_jac.scalar_mul_batched_plain(pts, bits)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert cuda_jac.LAUNCHES == before, "a CPU tensor launched a kernel"
    with pytest.raises(ValueError, match="bits"):
        cuda_jac.jac_ladder_cuda(pts, bits.to(torch.int64))
    with pytest.raises(ValueError, match="bits"):
        cuda_jac.jac_ladder_cuda(pts, bits[:, :4].contiguous())
    with pytest.raises(ValueError, match="bits"):
        cuda_jac.jac_ladder_cuda(pts, bits.t())
    with pytest.raises(TypeError):
        cuda_jac.jac_ladder_cuda({k: v.to(torch.int64) for k, v in pts.items()}, bits)
    meta = {k: torch.empty(v.shape, dtype=v.dtype, device="meta") for k, v in pts.items()}
    with pytest.raises(ValueError, match="unsupported device"):
        cuda_jac.jac_ladder_cuda(meta, torch.empty(bits.shape, dtype=bits.dtype, device="meta"))


@pytest.mark.parametrize(
    "dtype, value",
    [(torch.uint8, 1), (torch.uint8, 255), (torch.int32, 1), (torch.int32, -1),
     (torch.int32, 1 << 30)],
    ids=["u8-1", "u8-255", "i32-1", "i32-minus1", "i32-2^30"],
)
def test_jac_ladder_any_nonzero_bit_is_set(dtype, value):
    """Bit rows whose set entries hold ``value`` give the limbs of the 0/1
    uint8 rows, with no launch."""
    pts = {k: _port(v) for k, v in _points(5).items()}
    bits = torch.from_numpy(scalar_bits(_scalars(6, 12))[:12])
    want = cuda_jac.scalar_mul_batched_plain(pts, bits)
    before = dict(cuda_jac.LAUNCHES)
    got = cuda_jac.jac_ladder_cuda(pts, torch.where(bits != 0, value, 0).to(dtype))
    assert cuda_jac.LAUNCHES == before
    assert all(torch.equal(got[k], want[k]) for k in want)
