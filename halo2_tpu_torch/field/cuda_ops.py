"""Batched prime-field add and subtract: the CUDA kernels, their plain
PyTorch versions, and the wrappers that pick one by the tensors' device.

The kernels (``csrc/field_ops.cu``) have no Pallas counterpart: they replace
the reference's ``jnp`` ``add``/``sub``/``neg``
(``halo2_tpu/field/device.py:145-157``), which XLA fuses into the programs
that call them; in the port each is one launch.  Negation is ``0 - a``: a
subtract whose left operand is one broadcast zero.  Field arrays are
``(16, *batch)`` int32 tensors of 16-bit limbs, canonical (< p); the results
are canonical, so they equal the reference's limb for limb.

:func:`mod_add` (:func:`mod_sub`, :func:`mod_neg`) runs :func:`mod_add_plain`
(:func:`mod_sub_plain`, :func:`mod_neg_plain`) for a CPU tensor and launches
the kernel for a CUDA tensor; there is no fallback between the two.
``LAUNCHES`` counts kernel launches by name.
"""

from __future__ import annotations

import functools

import torch

from .cuda_mul import ARITH, _plain_consts, arith, carry, check_limbs, modulus_words
from .params import NUM_LIMBS, FieldSpec

L = NUM_LIMBS
LAUNCHES = {"mod_add": 0, "mod_sub": 0}


# ------------------------------------------------------------- plain versions
def _p(spec: FieldSpec, t: torch.Tensor) -> torch.Tensor:
    """p as int64 limbs shaped (16, 1, ..., 1) to broadcast against t."""
    return _plain_consts(spec, t.device)[0].reshape((L,) + (1,) * (t.dim() - 1))


def mod_add_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p in int64 torch ops: the limb sum carried (< 2p < 2^256),
    then p subtracted where that does not borrow.  a, b broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    s, _ = carry(a.to(torch.int64) + b.to(torch.int64))
    d, borrow = carry(s - _p(spec, s))
    return torch.where(borrow < 0, s, d).to(torch.int32)


def mod_sub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p in int64 torch ops: the limb difference carried, plus p
    where it borrowed.  a, b broadcast."""
    a, b = torch.broadcast_tensors(a, b)
    d, borrow = carry(a.to(torch.int64) - b.to(torch.int64))
    wrapped, _ = carry(d + _p(spec, d))
    return torch.where(borrow < 0, wrapped, d).to(torch.int32)


def mod_neg_plain(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """-a mod p: ``mod_sub_plain(0, a)``."""
    return mod_sub_plain(spec, torch.zeros_like(a), a)


# -------------------------------------------------------------------- wrappers
def _one(x: torch.Tensor) -> bool:
    return x.numel() == L


def _column(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """One element as a (16, 1, ..., 1) column of ``ndim`` axes."""
    return x.reshape((L,) + (1,) * (ndim - 1))


def _launch(kernel: str, spec: FieldSpec, a, b, full, *flags) -> torch.Tensor:
    """Launch ``kernel`` over the elements of ``full`` (the output's shape);
    CPU tensors never get here."""
    if a.device.type != "cuda":
        raise ValueError(f"{kernel}: unsupported device {a.device}")
    from .. import _build

    out = torch.empty_like(full)
    m = full.numel() // L
    if m:
        _build.launch(
            kernel, a.device, a.data_ptr(), b.data_ptr(), out.data_ptr(), m, *flags,
            modulus_words(spec).ctypes.data, ARITH[arith(spec)],
        )
        LAUNCHES[kernel] += 1
    return out


def mod_add(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p of ``(16, *batch)`` a and b (b a's shape, or one
    broadcast element); a's shape.  CPU tensors: plain version; CUDA
    tensors: kernel."""
    check_limbs("mod_add", a=a, b=b)
    b_bcast = b.shape != a.shape
    if b_bcast and not _one(b):
        raise ValueError(f"mod_add: b must match a {tuple(a.shape)} or be one element, got {tuple(b.shape)}")
    if a.device.type == "cpu":
        return mod_add_plain(spec, a, _column(b, a.dim()) if b_bcast else b)
    return _launch("mod_add", spec, a, b, a, int(b_bcast))


def mod_sub(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p of ``(16, *batch)`` a and b: both of one shape, or
    either one broadcast element; the other's shape.  CPU tensors: plain
    version; CUDA tensors: kernel."""
    check_limbs("mod_sub", a=a, b=b)
    a_bcast = a.shape != b.shape and _one(a)
    b_bcast = a.shape != b.shape and not a_bcast
    if b_bcast and not _one(b):
        raise ValueError(f"mod_sub: a {tuple(a.shape)} and b {tuple(b.shape)} must match, or one be one element")
    if a.device.type == "cpu":
        if a_bcast:
            a = _column(a, b.dim())
        elif b_bcast:
            b = _column(b, a.dim())
        return mod_sub_plain(spec, a, b)
    return _launch("mod_sub", spec, a, b, b if a_bcast else a, int(a_bcast), int(b_bcast))


@functools.lru_cache(maxsize=None)
def _zero(device: torch.device) -> torch.Tensor:
    return torch.zeros((L, 1), dtype=torch.int32, device=device)


def mod_neg(spec: FieldSpec, a: torch.Tensor) -> torch.Tensor:
    """-a mod p of ``(16, *batch)`` a: :func:`mod_sub` from one broadcast
    zero.  CPU tensors: plain version; CUDA tensors: the subtract kernel."""
    check_limbs("mod_neg", a=a)
    return mod_sub(spec, _zero(a.device), a)
