"""Jacobian group ops on the MSM's path: the CUDA kernels, their plain
PyTorch versions, and the wrappers that pick one by the tensors' device
(port of halo2_tpu/ec/pallas_jac.py).

The kernels (``csrc/jac.cu``) replace ``halo2_tpu/ec/pallas_jac.py``'s
``_madd_kernel`` (mixed Jacobian + affine add) and ``_add_kernel`` (complete
Jacobian add).  They compute the reference's canonical formulas
(``ec/device.py:_jac_madd_jnp`` and ``_jac_add_jnp``) with their P == Q
doubling, so their output equals the plain versions here limb for limb and
the wrappers read nothing back from the card.  A point is a dict ``{x, y,
z}`` of ``(16, *batch)`` int32 Montgomery limb tensors over BN254 Fq; z == 0
marks infinity.  A third kernel, ``jac_horner``, runs the sharded MSM's
Horner combine of window sums (the reference's ``fori_loop`` of doublings
and complete adds, ``halo2_tpu/ec/device.py:597-607``) in one launch.

Each add kernel has two variants: ``wide`` (one thread per lane) and
``narrow`` (four warps per 32 lanes splitting each formula's independent
products); :func:`variant` picks one from the lane count.  The plain
versions flag the P == Q lanes and double them in :func:`_double_fixup`,
behind one device -> host read of ``same.any()`` (the reference's
``lax.cond``).  :func:`jac_madd_cuda` / :func:`jac_add_cuda` /
:func:`jac_horner_cuda` run the plain versions for CPU tensors and launch
the kernels for CUDA tensors; there is no fallback between the two.
``LAUNCHES`` counts kernel launches.
"""

from __future__ import annotations

import functools

import torch

from ..field.cuda_mul import (
    check_limbs,
    modulus_one_words,
    mont_inv_plain,
    mont_mul_plain,
    mont_pow_plain,
    mont_sqr_plain,
)
from ..field.cuda_ops import mod_add_plain, mod_neg_plain, mod_sub_plain
from ..field.device import DeviceField
from ..field.params import BN254_FQ, NUM_LIMBS

L = NUM_LIMBS
LAUNCHES = {"jac_madd": 0, "jac_add": 0, "jac_horner": 0}


class _PlainField(DeviceField):
    """DeviceField whose multiplies, adds and subtracts are the plain
    versions on any device, so the plain group ops launch no kernel of this
    package."""

    def mul(self, a, b):
        return mont_mul_plain(self.spec, a, b)

    def square(self, a):
        return mont_sqr_plain(self.spec, a)

    def add(self, a, b):
        return mod_add_plain(self.spec, *self._bcast(a, b)[:2])

    def sub(self, a, b):
        return mod_sub_plain(self.spec, *self._bcast(a, b)[:2])

    def neg(self, a):
        return mod_neg_plain(self.spec, a)

    def _pow_bits(self, a, e):
        return mont_pow_plain(self.spec, a, e)

    def inv(self, a):
        return mont_inv_plain(self.spec, a)


@functools.lru_cache(maxsize=None)
def plain_field() -> _PlainField:
    return _PlainField(BN254_FQ)


# ------------------------------------------------------------ plain versions
def jac_madd_flagged_plain(p, qx, qy, valid):
    """p + (qx, qy) where ``valid`` else p, without the P == Q doubling;
    returns ``(point, same)``.  The formulas of ``_jac_madd_jnp``
    (madd-2007-bl); (qx, qy) is a finite affine point on valid lanes."""
    d = plain_field()
    x1, y1, z1 = p["x"], p["y"], p["z"]
    z1z1 = d.square(z1)
    u2 = d.mul(qx, z1z1)
    s2 = d.mul(qy, d.mul(z1, z1z1))
    h = d.sub(u2, x1)
    hh = d.square(h)
    i = d.double(d.double(hh))
    j = d.mul(h, i)
    rr = d.double(d.sub(s2, y1))
    v = d.mul(x1, i)
    x3 = d.sub(d.sub(d.square(rr), j), d.double(v))
    y3 = d.sub(d.mul(rr, d.sub(v, x3)), d.double(d.mul(y1, j)))
    z3 = d.sub(d.sub(d.square(d.add(z1, h)), z1z1), hh)

    p_inf = d.is_zero(z1)
    same = valid & d.is_zero(h) & d.is_zero(rr) & ~p_inf
    aff = {"x": qx, "y": qy, "z": d.one_mont(qx.shape[1:], device=qx.device)}
    out = {k: d.select(p_inf, aff[k], v_) for k, v_ in (("x", x3), ("y", y3), ("z", z3))}
    return {k: d.select(valid, out[k], p[k]) for k in out}, same


def jac_add_flagged_plain(p, q):
    """Complete p + q without the P == Q doubling; returns ``(point,
    same)``.  The formulas and selects of ``_jac_add_jnp`` (add-2007-bl):
    P == -Q gives infinity (0, 1, 0), an infinite side returns the other."""
    d = plain_field()
    x1, y1, z1 = p["x"], p["y"], p["z"]
    x2, y2, z2 = q["x"], q["y"], q["z"]
    z1z1 = d.square(z1)
    z2z2 = d.square(z2)
    u1 = d.mul(x1, z2z2)
    u2 = d.mul(x2, z1z1)
    s1 = d.mul(d.mul(y1, z2), z2z2)
    s2 = d.mul(d.mul(y2, z1), z1z1)
    h = d.sub(u2, u1)
    r = d.sub(s2, s1)

    hh = d.square(h)
    i = d.double(d.double(hh))
    j = d.mul(h, i)
    rr = d.double(r)
    v = d.mul(u1, i)
    x3 = d.sub(d.sub(d.square(rr), j), d.double(v))
    y3 = d.sub(d.mul(rr, d.sub(v, x3)), d.double(d.mul(s1, j)))
    z3 = d.mul(d.double(d.mul(z1, z2)), h)

    h_zero, r_zero = d.is_zero(h), d.is_zero(r)
    p_inf, q_inf = d.is_zero(z1), d.is_zero(z2)
    same = h_zero & r_zero & ~p_inf & ~q_inf
    opposite = h_zero & ~r_zero & ~p_inf & ~q_inf
    batch = x3.shape[1:]
    inf = {
        "x": d.zeros(batch, device=x3.device),
        "y": d.one_mont(batch, device=x3.device),
        "z": d.zeros(batch, device=x3.device),
    }
    out = {"x": x3, "y": y3, "z": z3}
    out = {k: d.select(opposite, inf[k], out[k]) for k in out}
    out = {k: d.select(p_inf, q[k], out[k]) for k in out}
    return {k: d.select(q_inf, p[k], out[k]) for k in out}, same


def _double_fixup(out, same, p, d):
    """The (rare) P == Q lanes take jac_double(p), computed only when some
    lane is flagged: one device -> host sync per call."""
    if not bool(same.any()):
        return out
    from .device import jac_double

    dbl = jac_double(p, d)
    return {k: torch.where(same[None], dbl[k], out[k]) for k in out}


def jac_madd_plain(p, qx, qy, valid):
    """Mixed add p + (qx, qy) where ``valid`` else p, in plain torch ops."""
    out, same = jac_madd_flagged_plain(p, qx, qy, valid)
    return _double_fixup(out, same, p, plain_field())


def jac_add_plain(p, q):
    """Complete Jacobian add p + q in plain torch ops."""
    out, same = jac_add_flagged_plain(p, q)
    return _double_fixup(out, same, p, plain_field())


def horner_plain(w, c: int):
    """Stacked ``(3, 16, *B, W)`` window sums -> sum_i 2^(c i) w_i as a jac
    point ``(16, *B)`` in plain torch ops on w's device: from the top window
    down, c doublings (``jac_double``, dbl-2009-l) and one complete add
    (:func:`jac_add_plain`), the reference's ``fori_loop`` Horner
    (``halo2_tpu/ec/device.py:597-607``)."""
    from .device import jac, jac_double, jac_infinity

    d = plain_field()
    acc = jac_infinity(tuple(w.shape[2:-1]), device=w.device)
    for i in reversed(range(w.shape[-1])):
        for _ in range(c):
            acc = jac_double(acc, d)
        acc = jac_add_plain(acc, jac(w[0, ..., i], w[1, ..., i], w[2, ..., i]))
    return acc


# ------------------------------------------------------------------ wrappers
# Up to this many lanes the narrow variant is the faster (measured on one
# H100, PERF.md): the wide one then fills few of the 132 SMs, and its time is
# one thread's chain of 16 (add) or 11 (madd) dependent products.
NARROW_MAX_LANES = 1 << 13
VARIANTS = {"wide": 0, "narrow": 1}


def variant(m: int) -> str:
    """The kernel variant for a call over ``m`` lanes."""
    return "narrow" if m <= NARROW_MAX_LANES else "wide"


def _check_points(op: str, batch, points: dict) -> None:
    check_limbs(op, **points)
    for name, t in points.items():
        if tuple(t.shape[1:]) != tuple(batch):
            raise ValueError(f"{op}: {name} has batch {tuple(t.shape[1:])}, expected {tuple(batch)}")


def _launch(kernel: str, ins, which):
    """Launch ``kernel`` over the flattened batch of ``ins`` in variant
    ``which`` (None: :func:`variant` of the lane count); returns the point."""
    from .. import _build

    x = ins[0]
    out = {k: torch.empty_like(x) for k in ("x", "y", "z")}
    m = x.numel() // L
    if m:
        _build.launch(
            kernel, x.device, *(t.data_ptr() for t in ins),
            out["x"].data_ptr(), out["y"].data_ptr(), out["z"].data_ptr(),
            m, modulus_one_words(BN254_FQ).ctypes.data, VARIANTS[which or variant(m)],
        )
        LAUNCHES[kernel] += 1
    return out


def jac_madd_cuda(p, qx, qy, valid):
    """Mixed add p + (qx, qy) where ``valid`` else p, with the P == Q
    doubling: the ``jac_madd`` kernel on CUDA tensors (its variant chosen
    from the lane count), the plain version on CPU ones.  Contiguous int32
    inputs of one batch shape; ``valid`` is a bool tensor of that batch
    shape."""
    return _jac_madd(p, qx, qy, valid)


def _jac_madd(p, qx, qy, valid, which=None):
    """:func:`jac_madd_cuda` in variant ``which`` (None: :func:`variant`);
    the checks that hold every variant to the plain version force one."""
    batch = p["x"].shape[1:]
    _check_points("jac_madd", batch, {"px": p["x"], "py": p["y"], "pz": p["z"], "qx": qx, "qy": qy})
    if valid.dtype != torch.bool or tuple(valid.shape) != tuple(batch) or valid.device != qx.device:
        raise ValueError(f"jac_madd: valid must be bool {tuple(batch)} on {qx.device}")
    if qx.device.type == "cpu":
        return jac_madd_plain(p, qx, qy, valid)
    if qx.device.type != "cuda":
        raise ValueError(f"jac_madd: unsupported device {qx.device}")
    ins = [p["x"], p["y"], p["z"], qx, qy, valid.to(torch.int32)]
    return _launch("jac_madd", ins, which)


def jac_add_cuda(p, q):
    """Complete Jacobian add p + q, with the P == Q doubling: the
    ``jac_add`` kernel on CUDA tensors (its variant chosen from the lane
    count), the plain version on CPU ones.  Contiguous int32 inputs of one
    batch shape."""
    return _jac_add(p, q)


def _jac_add(p, q, which=None):
    """:func:`jac_add_cuda` in variant ``which`` (None: :func:`variant`)."""
    batch = p["x"].shape[1:]
    _check_points(
        "jac_add", batch,
        {"px": p["x"], "py": p["y"], "pz": p["z"], "qx": q["x"], "qy": q["y"], "qz": q["z"]},
    )
    if q["x"].device.type == "cpu":
        return jac_add_plain(p, q)
    if q["x"].device.type != "cuda":
        raise ValueError(f"jac_add: unsupported device {q['x'].device}")
    ins = [p["x"], p["y"], p["z"], q["x"], q["y"], q["z"]]
    return _launch("jac_add", ins, which)


def jac_horner_cuda(w, c: int):
    """sum_i 2^(c i) w_i of stacked ``(3, 16, *B, W)`` window sums (x, y, z;
    contiguous int32 Montgomery limbs over Fq) as a jac point ``(16, *B)``:
    the ``jac_horner`` kernel on a CUDA tensor (the whole ladder in one
    launch), :func:`horner_plain` on a CPU one."""
    if w.dtype != torch.int32:
        raise TypeError(f"jac_horner: w must be int32, got {w.dtype}")
    if w.dim() < 3 or w.shape[0] != 3 or w.shape[1] != L:
        raise ValueError(f"jac_horner: w must be (3, 16, *B, W), got {tuple(w.shape)}")
    if not w.is_contiguous():
        raise ValueError("jac_horner: w must be contiguous")
    if c < 0:
        raise ValueError(f"jac_horner: c must be >= 0, got {c}")
    if w.device.type == "cpu":
        return horner_plain(w, c)
    if w.device.type != "cuda":
        raise ValueError(f"jac_horner: unsupported device {w.device}")
    from .. import _build

    batch = tuple(w.shape[2:-1])
    out = torch.empty((3, L) + batch, dtype=torch.int32, device=w.device)
    m = out[0].numel() // L
    if m:
        _build.launch(
            "jac_horner", w.device, w.data_ptr(), out.data_ptr(), m, w.shape[-1], c,
            modulus_one_words(BN254_FQ).ctypes.data,
        )
        LAUNCHES["jac_horner"] += 1
    return {"x": out[0], "y": out[1], "z": out[2]}
