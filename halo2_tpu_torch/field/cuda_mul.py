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
    16-bit limbs; returns ``(limbs, carry_out)``, carry_out < 0 on a borrow.
    Every row passes its carry up at once, until no row has one: a few
    passes of whole-tensor ops (a ripple through limbs of 0xFFFF takes one
    more pass a limb) instead of one pass a row, which at the narrow widths
    of a curve's Horner tail is what the plain versions' time goes to."""
    c = torch.zeros_like(t[0])
    while True:
        hi = t >> LIMB_BITS
        if not bool(hi.any()):
            return t, c
        t = t & LIMB_MASK
        c = c + hi[-1]
        t[1:] += hi[:-1]


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


@functools.lru_cache(maxsize=None)
def _terms(square: bool, device: torch.device) -> tuple:
    """The limb products a_i b_j of a schoolbook product, as index tensors
    ``(i, j, column i + j, weight)``: all 256 for a product; for a square
    the 136 of the upper triangle (i <= j), the off-diagonal ones weighted
    2, as the kernel forms them."""
    i, j = torch.meshgrid(torch.arange(L), torch.arange(L), indexing="ij")
    i, j = i.reshape(-1), j.reshape(-1)
    if square:
        keep = i <= j
        i, j = i[keep], j[keep]
    w = torch.where(i == j, 1, 2) if square else torch.ones_like(i)
    return tuple(v.to(device) for v in (i, j, i + j, w))


_PRODUCT_CHUNK = 1 << 16  # columns a pass: up to 256 int64 products each, 128 MB


def _product_columns(a: torch.Tensor, b: torch.Tensor | None) -> torch.Tensor:
    """int64 limbs ``(L, m)`` -> the ``(2L, m)`` column sums of the
    schoolbook product a * b, or of the square a * a when ``b`` is None
    (each sum < 16 * 2^32): every limb product of a chunk of columns at
    once, summed into its column by one ``index_add_`` (exact in int64)."""
    i, j, col, w = _terms(b is None, a.device)
    b = a if b is None else b
    t = a.new_zeros((2 * L, a.shape[1]))
    for lo in range(0, a.shape[1], _PRODUCT_CHUNK):
        hi = lo + _PRODUCT_CHUNK
        t[:, lo:hi].index_add_(0, col, a[i, lo:hi] * b[j, lo:hi] * w[:, None])
    return t


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b * 2^-256 mod p in int64 torch ops (the reference's loop-free
    algorithm): T = a * b, then :func:`_redc_plain`.  a, b broadcast over
    their batch axes."""
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    t = _product_columns(a.reshape(L, -1).to(torch.int64), b.reshape(L, -1).to(torch.int64))
    return _redc_plain(spec, t).reshape(shape)


def mont_sqr_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """a * a * 2^-256 mod p in int64 torch ops: T from the 136 limb products
    of the upper triangle (off-diagonal ones doubled), then
    :func:`_redc_plain`; equal to ``mont_mul_plain(spec, a, a)``."""
    shape = a.shape
    return _redc_plain(spec, _product_columns(a.reshape(L, -1).to(torch.int64), None)).reshape(shape)


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
