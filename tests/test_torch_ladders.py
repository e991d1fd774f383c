"""The two ladders the port runs as one kernel launch each, against the
reference on the CPU, limb for limb:

- ``mont_pow`` (``field/cuda_mul.py``): ``mont_pow_plain`` and the rewired
  ``DeviceField.pow_fixed``/``inv`` against the reference's
  ``DeviceField.pow_fixed``/``inv`` (its ``lax.scan``) over BN254 Fr, BN254
  Fq and Pasta Fp, for exponents 0, 1, 2, p - 2 and a random one of more
  than 256 bits, on inputs that include 0, 1 and p - 1;
- ``jac_horner`` (``ec/cuda_jac.py``): ``horner_plain`` and the rewired
  ``ec.device._horner_device`` against the reference's Horner, built here
  from ``halo2_tpu.ec.device.jac_double``/``jac_add`` in a ``lax.fori_loop``
  as ``halo2_tpu/ec/device.py:597-607`` builds it, on window sums at
  B = 1, 3 and 33 lanes with c = 4 and 8: windows at infinity (with the
  standard and with arbitrary x, y), a leading run of infinite windows, and
  lanes whose accumulated point equals the next window sum (P == Q) or its
  negative.

On the CPU the wrappers run their plain versions; the kernels are held
against those on the card (tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from halo2_tpu.ec import device as ref_ecd
from halo2_tpu.field import params as ref_params
from halo2_tpu.field.device import get_device_field as ref_field
from halo2_tpu_torch.ec import cuda_jac, host
from halo2_tpu_torch.ec import device as ecd
from halo2_tpu_torch.field import cuda_mul
from halo2_tpu_torch.field import params as port_params
from halo2_tpu_torch.field.device import get_device_field as port_field
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

FIELDS = ["BN254_FR", "BN254_FQ", "PASTA_FP"]
EXPONENTS = ["0", "1", "2", "p-2", "random-300-bit"]
Q = port_params.BN254_FQ.p
WINDOWS = 6


def _port(arr) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(arr, np.uint32)).view(np.int32))


def _same(port_out: torch.Tensor, ref_out) -> bool:
    got = port_out.numpy().view(np.uint32)
    assert got.max(initial=0) < 1 << 16, "a limb is >= 2^16"
    return np.array_equal(got, np.asarray(ref_out))


def _exponent(name: str, p: int) -> int:
    if name == "p-2":
        return p - 2
    if name == "random-300-bit":
        return random.Random(300).randrange(1 << 299, 1 << 300)
    return int(name)


def _elements(p: int, n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [0, 1, p - 1, p - 2] + [rng.randrange(p) for _ in range(n - 4)]


# ------------------------------------------------------------------ mont_pow
@pytest.mark.parametrize("exp", EXPONENTS)
@pytest.mark.parametrize("field", FIELDS)
def test_mont_pow_plain_matches_reference_pow_fixed(field, exp):
    rf = ref_field(getattr(ref_params, field))
    pf = port_field(getattr(port_params, field))
    e = _exponent(exp, rf.p)
    a_np = rf.encode_np(_elements(rf.p, 7, seed=len(exp)))
    want = rf.pow_fixed(a_np, e)
    a = _port(a_np)
    assert _same(cuda_mul.mont_pow_plain(pf.spec, a, e), want)
    assert _same(cuda_mul.mont_pow(pf.spec, a, e), want)
    assert _same(pf.pow_fixed(a, e), want)
    assert torch.equal(a, _port(a_np)), "the input was written"


@pytest.mark.parametrize("field", FIELDS)
def test_inv_matches_reference(field):
    rf = ref_field(getattr(ref_params, field))
    pf = port_field(getattr(port_params, field))
    vals = _elements(rf.p, 9, seed=12)
    a_np = rf.encode_np(vals).reshape(16, 3, 3)  # a 2-d batch
    got = pf.inv(_port(a_np))
    assert _same(got, rf.inv(a_np))
    assert [int(v) for v in pf.decode(got).reshape(-1)] == [pow(v, rf.p - 2, rf.p) for v in vals]
    assert pf.decode(got).reshape(-1)[0] == 0  # inv(0) = 0


def test_mont_pow_wrapper_checks_and_exponent_cache():
    spec = port_params.BN254_FR
    a = port_field(spec).encode([3, 5])
    with pytest.raises(TypeError):
        cuda_mul.mont_pow(spec, a.to(torch.int64), 3)
    with pytest.raises(ValueError):
        cuda_mul.mont_pow(spec, a.t().contiguous().t(), 3)
    with pytest.raises(ValueError):
        cuda_mul.mont_pow(spec, a, -1)
    e = _exponent("random-300-bit", spec.p)
    words = cuda_mul._exponent_words(e, torch.device("cpu"))
    assert words is cuda_mul._exponent_words(e, torch.device("cpu"))
    assert sum(int(w) % (1 << 32) << (32 * k) for k, w in enumerate(words.tolist())) == e
    assert cuda_mul._exponent_words(0, torch.device("cpu")).tolist() == [0]


# ---------------------------------------------------------------- jac_horner
def _ref_horner_fn(ws, c):
    """The reference's device Horner (halo2_tpu/ec/device.py:597-607): from
    the top window down, c ``jac_double``s and one ``jac_add``, as nested
    ``fori_loop``s; c is traced, so one compile serves both window sizes."""
    num_windows = ws["x"].shape[-1]
    axis = ws["x"].ndim - 1

    def horner(i, acc):
        acc = jax.lax.fori_loop(0, c, lambda _, a: ref_ecd.jac_double(a), acc)
        top = num_windows - 1 - i
        w = {k: jax.lax.dynamic_index_in_dim(v, top, axis, False) for k, v in ws.items()}
        return ref_ecd.jac_add(acc, w)

    return jax.lax.fori_loop(0, num_windows, horner, ref_ecd.jac_infinity(ws["x"].shape[1:-1]))


_ref_horner = jax.jit(_ref_horner_fn)


def _jacobian(pt, z: int) -> tuple:
    """An affine host point (or None, infinity) as Jacobian ints with this
    z: (x z^2, y z^3, z), or the standard infinity (0, 1, 0)."""
    if pt is None:
        return 0, 1, 0
    x, y = host.g1_to_ints(pt)
    return x * z * z % Q, y * z * z * z % Q, z


def _window_sums(batch: int, c: int, seed: int):
    """(3, 16, batch, WINDOWS) Montgomery window sums (numpy uint32) and the
    host affine sum_i 2^(c i) w_i of each lane.  Lane patterns, by lane % 4,
    from the top window (5) down:
    0: infinity, P, 2^c P (the accumulator equals it: P == Q), random,
       infinity with arbitrary x and y (z = 0), random;
    1: P, -(2^c P) (the accumulator is its negative: infinity), infinity,
       random, random, infinity;
    2: a leading run of three infinities, then random windows;
    3: random windows."""
    rng = random.Random(seed)
    G = host.G1

    def rand_pt():
        return host.ec_mul(G, rng.randrange(1, 1 << 40))

    lanes, sums = [], []
    for b in range(batch):
        pattern = b % 4
        k = rng.randrange(1, 1 << 40)
        P, PC = host.ec_mul(G, k), host.ec_mul(G, k << c)
        if pattern == 0:
            top = [None, P, PC, rand_pt(), "odd", rand_pt()]
        elif pattern == 1:
            top = [P, host.ec_neg(PC), None, rand_pt(), rand_pt(), None]
        elif pattern == 2:
            top = [None, None, None, rand_pt(), rand_pt(), rand_pt()]
        else:
            top = [rand_pt() for _ in range(WINDOWS)]
        windows = list(reversed(top))  # windows[i] is w_i
        jac = []
        for w in windows:
            if w == "odd":
                jac.append((rng.randrange(Q), rng.randrange(Q), 0))
            else:
                jac.append(_jacobian(w, rng.randrange(1, Q)))
        lanes.append(jac)
        total = None
        for i, w in enumerate(windows):
            if w is not None and w != "odd":
                term = host.ec_mul(w, 1 << (c * i))
                total = term if total is None else host.ec_add(total, term)
        sums.append((0, 0) if total is None else host.g1_to_ints(total))
    d = port_field(port_params.BN254_FQ)
    out = np.zeros((3, 16, batch, WINDOWS), np.uint32)
    for b, jac in enumerate(lanes):
        for k in range(3):
            out[k, :, b, :] = d.encode_np([pt[k] for pt in jac])
    return out, sums


def _affine(pt) -> list:
    d = port_field(port_params.BN254_FQ)
    coords = [[int(v) for v in np.asarray(d.decode(pt[k])).reshape(-1)] for k in ("x", "y", "z")]
    out = []
    for x, y, z in zip(*coords):
        if z == 0:
            out.append((0, 0))
        else:
            zi = pow(z, Q - 2, Q)
            out.append((x * zi * zi % Q, y * zi * zi * zi % Q))
    return out


@pytest.mark.parametrize("c", [4, 8])
@pytest.mark.parametrize("batch", [1, 3, 33])
def test_horner_plain_matches_reference_horner(batch, c):
    w_np, sums = _window_sums(batch, c, seed=batch * 10 + c)
    want = _ref_horner({k: jnp.asarray(w_np[i]) for i, k in enumerate("xyz")}, jnp.int32(c))
    w = _port(w_np)
    plain = cuda_jac.horner_plain(w, c)
    wrapped = cuda_jac.jac_horner_cuda(w, c)
    routed = ecd._horner_device(w, c)
    for k in ("x", "y", "z"):
        assert tuple(plain[k].shape) == (16, batch)
        assert _same(plain[k], want[k]), k
        assert torch.equal(wrapped[k], plain[k]), k
        assert torch.equal(routed[k], plain[k]), k
    assert _affine(plain) == sums


def test_horner_of_one_msm_and_empty_windows():
    """An unbatched (3, 16, W) stack (one MSM's window sums) gives a (16,)
    point; no windows give infinity."""
    w_np, sums = _window_sums(1, 8, seed=5)
    one = cuda_jac.horner_plain(_port(w_np[:, :, 0, :]), 8)
    assert tuple(one["x"].shape) == (16,)
    assert _affine({k: v[:, None] for k, v in one.items()}) == sums
    none = cuda_jac.jac_horner_cuda(_port(np.zeros((3, 16, 2, 0), np.uint32)), 8)
    assert _affine(none) == [(0, 0), (0, 0)]


def test_horner_wrapper_checks_inputs():
    w = _port(_window_sums(3, 4, seed=1)[0])
    with pytest.raises(TypeError):
        cuda_jac.jac_horner_cuda(w.to(torch.int64), 4)
    with pytest.raises(ValueError):  # not contiguous
        cuda_jac.jac_horner_cuda(w.transpose(2, 3), 4)
    with pytest.raises(ValueError):  # not (3, 16, *B, W)
        cuda_jac.jac_horner_cuda(w[:2], 4)
    with pytest.raises(ValueError):
        cuda_jac.jac_horner_cuda(w, -1)
