"""Batched Montgomery multiply and square: the CUDA kernels, their plain
PyTorch versions, and the wrappers that pick one by the tensors' device.

The kernels (``csrc/mont_mul.cu``) replace
``halo2_tpu/field/pallas_mul.py:_mont_mul_kernel`` and ``_mont_sqr_kernel``.
Field arrays are ``(16, *batch)`` int32 tensors of 16-bit limbs, Montgomery
form, canonical (< p): the reference's ``uint32`` numbers held in int32.

:func:`mont_mul` (:func:`mont_sqr`) runs :func:`mont_mul_plain`
(:func:`mont_sqr_plain`) for a CPU tensor and launches the kernel for a CUDA
tensor; there is no fallback between the two.  ``LAUNCHES`` counts kernel
launches by name.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .params import LIMB_BITS, LIMB_MASK, NUM_LIMBS, FieldSpec

L = NUM_LIMBS
LAUNCHES = {"mont_mul": 0, "mont_sqr": 0}


@functools.lru_cache(maxsize=None)
def modulus_words(spec: FieldSpec) -> np.ndarray:
    """(9,) uint32 kernel argument: p as 8 little-endian words, then
    n0 = -p^{-1} mod 2^32."""
    words = [(spec.p >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    words.append((-pow(spec.p, -1, 1 << 32)) % (1 << 32))
    return np.array(words, np.uint32)


# ------------------------------------------------------------- plain version
def carry(t: torch.Tensor):
    """Carry-propagate int64 limb columns ``(nl, *B)`` (any sign) into
    16-bit limbs; returns ``(limbs, carry_out)``, carry_out < 0 on a borrow."""
    out = []
    c = None
    for row in t.unbind(0):
        if c is not None:
            row = row + c
        c = row >> LIMB_BITS
        out.append(row & LIMB_MASK)
    return torch.stack(out), c


@functools.lru_cache(maxsize=None)
def _plain_consts(spec: FieldSpec, device: torch.device):
    """p as an int64 (16, 1) column, and the Toeplitz matrices (float64) whose
    product with a limb column gives the column sums of x * N' mod R and of
    x * p (N' = -p^{-1} mod R).  Every sum is below 16 * 2^32 < 2^53, so the
    float64 products are exact."""
    nprime = (-pow(spec.p, -1, 1 << 256)) % (1 << 256)
    n_l = [(nprime >> (LIMB_BITS * j)) & LIMB_MASK for j in range(L)]
    p_l = [(spec.p >> (LIMB_BITS * j)) & LIMB_MASK for j in range(L)]
    t_n = np.zeros((L, L), np.float64)
    t_p = np.zeros((2 * L, L), np.float64)
    for i in range(L):
        for j in range(L):
            if i + j < L:
                t_n[i + j, i] = n_l[j]
            t_p[i + j, i] = p_l[j]
    p_col = torch.tensor(p_l, dtype=torch.int64, device=device).reshape(L, 1)
    return (
        p_col,
        torch.from_numpy(t_n).to(device),
        torch.from_numpy(t_p).to(device),
    )


def _redc_plain(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """int64 product columns ``(2L, m)`` of T < p * R -> T * R^-1 mod p as
    int32 limbs: m = (T mod R) * N' mod R, (T + m p) / R, one conditional
    subtract."""
    p_col, t_n, t_p = _plain_consts(spec, t.device)
    t_low, _ = carry(t[:L])  # T mod R
    m, _ = carry((t_n @ t_low.double()).to(torch.int64))
    s, _ = carry(t + (t_p @ m.double()).to(torch.int64))  # low half is zero
    res = s[L:]  # (T + m p) / R < 2p
    red, borrow = carry(res - p_col)
    return torch.where(borrow < 0, res, red).to(torch.int32)


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p in int64 torch ops (the reference's loop-free
    algorithm): T = a * b, then :func:`_redc_plain`.  a, b broadcast over
    their batch axes."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    a = a.reshape(L, -1).to(torch.int64)
    b = b.reshape(L, -1).to(torch.int64)
    t = a.new_zeros((2 * L, a.shape[1]))
    for i in range(L):
        t[i : i + L] += a[i] * b  # column sums < 16 * 2^32
    return _redc_plain(spec, t).reshape(shape)


def mont_sqr_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a * a * 2^-256 mod p in int64 torch ops: T from the 136 limb products
    of the upper triangle (off-diagonal ones doubled), then
    :func:`_redc_plain`; equal to ``mont_mul_plain(spec, a, a)``."""
    shape = a.shape
    a = a.reshape(L, -1).to(torch.int64)
    t = a.new_zeros((2 * L, a.shape[1]))
    for i in range(L):
        t[2 * i] += a[i] * a[i]
        t[2 * i + 1 : i + L] += 2 * a[i] * a[i + 1 :]  # column sums < 2^37
    return _redc_plain(spec, t).reshape(shape)


# --------------------------------------------------------------------- wrapper
def check_limbs(op: str, **tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous int32 ``(16, ...)`` limb
    array, all on one device."""
    devices = set()
    for name, x in tensors.items():
        if x.dtype != torch.int32:
            raise TypeError(f"{op}: {name} must be int32, got {x.dtype}")
        if x.dim() < 1 or x.shape[0] != L:
            raise ValueError(f"{op}: {name} must be (16, ...), got {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{op}: {name} must be contiguous")
        devices.add(x.device)
    if len(devices) > 1:
        raise ValueError(f"{op}: tensors on several devices {sorted(map(str, devices))}")


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    check_limbs("mont_mul", a=a, b=b)
    if b.shape != a.shape and b.numel() != L:
        raise ValueError(
            f"mont_mul: b must match a {tuple(a.shape)} or be one element, got {tuple(b.shape)}"
        )


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Montgomery product of ``(16, *batch)`` a and b (b full width, or one
    broadcast element).  CPU tensors: plain version; CUDA tensors: kernel."""
    _check(a, b)
    if a.device.type == "cpu":
        return mont_mul_plain(spec, a, b)
    return _mont_mul_into(spec, a, b, torch.empty_like(a))


def _mont_mul_into(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
    """:func:`mont_mul` written to ``out`` (contiguous, a's shape, dtype and
    device), for callers that fill one column of a batch; CPU tensors: the
    plain version copied in."""
    _check(a, b)
    if out.shape != a.shape or out.dtype != a.dtype or out.device != a.device or not out.is_contiguous():
        raise ValueError(f"mont_mul: out must be a contiguous int32 {tuple(a.shape)} on {a.device}")
    if a.device.type == "cpu":
        return out.copy_(mont_mul_plain(spec, a, b))
    if a.device.type != "cuda":
        raise ValueError(f"mont_mul: unsupported device {a.device}")
    from .. import _build

    m = a.numel() // L
    if m == 0:
        return out
    _build.launch(
        "mont_mul", a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), m,
        int(b.numel() == L), modulus_words(spec).ctypes.data,
    )
    LAUNCHES["mont_mul"] += 1
    return out


def mont_sqr(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """Montgomery square of ``(16, *batch)`` a.  CPU tensors: plain version;
    CUDA tensors: kernel."""
    check_limbs("mont_sqr", a=a)
    if a.device.type == "cpu":
        return mont_sqr_plain(spec, a)
    if a.device.type != "cuda":
        raise ValueError(f"mont_sqr: unsupported device {a.device}")
    from .. import _build

    out = torch.empty_like(a)
    m = a.numel() // L
    if m == 0:
        return out
    _build.launch("mont_sqr", a.device, a.data_ptr(), out.data_ptr(), m, modulus_words(spec).ctypes.data)
    LAUNCHES["mont_sqr"] += 1
    return out
