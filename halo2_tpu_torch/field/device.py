"""Prime-field arithmetic on torch tensors (port of halo2_tpu/field/device.py).

A *field array* keeps the reference's layout: ``(16, *batch)`` little-endian
16-bit limbs, limb axis leading, Montgomery form (R = 2^256), canonical
(< p) between ops.  The port stores it as ``torch.int32``: the limbs are below
2^16, so the numbers are the reference's ``uint32`` ones, and torch's
``uint32`` lacks the CPU ops the plain arithmetic needs.

``mul`` and ``square`` go to :func:`.cuda_mul.mont_mul` (a periodic
broadcast to :func:`.cuda_mul.mont_mul_columns`) and
:func:`.cuda_mul.mont_sqr`, ``add``/``sub``/``neg``/``double`` to
:func:`.cuda_ops.mod_add`, :func:`.cuda_ops.mod_sub` and
:func:`.cuda_ops.mod_neg`, ``pow_fixed`` to :func:`.cuda_mul.mont_pow`
(the reference's ``lax.scan`` over the exponent's bits, which the host
knows, as one launch), ``inv`` to :func:`.cuda_mul.mont_inv` (a
fixed-count safegcd in one launch, where the reference scans a^(p - 2)):
the CUDA kernels for a CUDA tensor, their plain versions (int64 torch ops)
for a CPU tensor.  :func:`plain_field` gives a :class:`PlainField`, whose
ops are the plain versions on any device: the plain versions of the
kernels that run a whole loop (the group ops, the ladder, the sponge) are
written on it.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .cuda_mul import (
    mont_inv,
    mont_inv_plain,
    mont_mul,
    mont_mul_columns,
    mont_mul_plain,
    mont_pow,
    mont_pow_plain,
    mont_sqr,
    mont_sqr_plain,
)
from .cuda_ops import mod_add, mod_add_plain, mod_neg, mod_neg_plain, mod_sub, mod_sub_plain
from .params import FieldSpec, LIMB_BITS, LIMB_MASK, NUM_LIMBS, to_limbs

L = NUM_LIMBS


def _period(shape: tuple, full: tuple):
    """P when a ``shape`` operand broadcasts against ``full`` as a
    ``(16, P)`` period of the flat form (its batch axes, leading 1s
    dropped, are full's last ones; P their product), else None."""
    tail = list(shape[1:])
    while tail and tail[0] == 1:
        tail.pop(0)
    if tuple(tail) != tuple(full[len(full) - len(tail):]):
        return None
    return math.prod(tail)


def _col(limbs_list) -> np.ndarray:
    return np.array(limbs_list, dtype=np.uint32)


class DeviceField:
    """Vectorized field arithmetic bound to one :class:`FieldSpec`."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.p
        self._one_mont_np = _col(to_limbs(spec.r))
        self._r2_np = _col(to_limbs(spec.r2))
        self._one_raw_np = _col(to_limbs(1))

    @functools.lru_cache(maxsize=None)
    def _const(self, name: str, device: torch.device, ndim: int):
        """A (16,) limb constant shaped (16, 1, ..., 1) to broadcast over
        ``ndim`` batch axes."""
        arr = getattr(self, f"_{name}_np").astype(np.int64)
        t = torch.from_numpy(arr).to(device=device, dtype=torch.int32)
        return t.reshape((L,) + (1,) * ndim)

    # ---------------------------------------------------------------- shapes
    def _bcast(self, a, b):
        batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        full = (L,) + tuple(batch)
        return a.expand(full), b.expand(full), tuple(batch)

    def zeros(self, batch_shape=(), device=None):
        return torch.zeros((L,) + tuple(batch_shape), dtype=torch.int32, device=device)

    def one_mont(self, batch_shape=(), device=None):
        one = self._const("one_mont", torch.device(device or "cpu"), len(batch_shape))
        return one.expand((L,) + tuple(batch_shape))

    # ------------------------------------------------------------------- ops
    def _operands(self, a, b, swap: bool):
        """a and b for a kernel, broadcast as the reference's ``_bcast``: both
        full width, or one of them one element (a broadcast column for the
        kernel).  With ``swap`` (the op commutes) that one goes right; without
        it either side may be (the subtract takes both).  Any other broadcast
        is materialized."""
        full = (L,) + tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
        if swap and tuple(a.shape) != full:
            a, b = b, a
        if tuple(a.shape) == full:
            fits = b.shape == a.shape or b.numel() == L
        else:
            fits = not swap and a.numel() == L and tuple(b.shape) == full
        if not fits:
            a, b = a.expand(full), b.expand(full)
        return a.contiguous(), b.contiguous()

    def add(self, a, b):
        return mod_add(self.spec, *self._operands(a, b, swap=True))

    def sub(self, a, b):
        return mod_sub(self.spec, *self._operands(a, b, swap=False))

    def neg(self, a):
        return mod_neg(self.spec, a.contiguous())

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Montgomery product a * b * R^-1 mod p, broadcasting as the
        reference's ``_bcast``, in one launch over the flat ``(16, m)``
        form.  Equal shapes and a one-element operand go straight to
        :func:`.cuda_mul.mont_mul`.  An operand that broadcasts only along
        leading batch axes, ``(16, 1, ..., 1, *tail)`` against a full
        ``(16, ..., *tail)`` (a stage ladder's ``(16, 1, ..., m)``
        twiddles), stays a ``(16, prod(tail))`` period for the kernel; any
        other broadcast is materialized."""
        if a.shape != b.shape:
            if a.numel() == L and a.dim() <= b.dim():
                a, b = b, a
            if b.numel() != L or b.dim() > a.dim():
                return self._mul_broadcast(a, b)
        return mont_mul(self.spec, a.contiguous(), b.contiguous())

    def _mul_broadcast(self, a, b):
        full = (L,) + tuple(torch.broadcast_shapes(a.shape[1:], b.shape[1:]))
        if math.prod(full) == 0:
            return torch.empty(full, dtype=torch.int32, device=a.device)
        if tuple(a.shape) != full:
            a, b = b, a
        period = _period(tuple(b.shape), full) if tuple(a.shape) == full else None
        if period is None:
            a, b = a.expand(full), b.expand(full)
            period = math.prod(full[1:])
        flat = a.contiguous().reshape(L, -1)
        return mont_mul_columns(self.spec, flat, b.contiguous().reshape(L, period)).reshape(full)

    def square(self, a):
        return mont_sqr(self.spec, a.contiguous())

    def mul_small(self, a, k: int):
        """Multiply by a small host constant k (adds, for k <= 4)."""
        if k == 0:
            return self.zeros(a.shape[1:], device=a.device)
        acc = a
        for _ in range(k - 1):
            acc = self.add(acc, a)
        return acc

    # ------------------------------------------------------------ pow / inv
    def pow_fixed(self, a, e: int):
        """a^e for a host-known exponent."""
        if e == 0:
            return self.one_mont(a.shape[1:], device=a.device)
        return self._pow_bits(a, e)

    def _pow_bits(self, a, e: int):
        """Square-and-multiply over the bits of e, LSB first: the
        ``mont_pow`` kernel (one launch) or its plain version."""
        return mont_pow(self.spec, a.contiguous(), e)

    def inv(self, a):
        """Batched inverse, inv(0) = 0: the limbs of the reference's Fermat
        a^(p-2) (an inverse is unique), by the ``mont_inv`` kernel's safegcd
        (one launch) or its plain version."""
        return mont_inv(self.spec, a.contiguous())

    # ------------------------------------------------------------ predicates
    def is_zero(self, a):
        return (a == 0).all(dim=0)

    def eq(self, a, b):
        a, b, _ = self._bcast(a, b)
        return (a == b).all(dim=0)

    def select(self, mask, a, b):
        """mask: (*B,) bool -> where(mask, a, b) over (L, *B)."""
        a, b, _ = self._bcast(a, b)
        return torch.where(mask[None], a, b)

    # ----------------------------------------------------------- conversions
    def encode_np(self, values, to_mont: bool = True) -> np.ndarray:
        """Host ints / PrimeField elems -> (L, N) numpy uint32 limbs."""
        p = self.p
        vals = np.array([int(v) % p for v in values], dtype=object)
        if to_mont and len(vals):
            vals = vals * self.spec.r % p
        out = np.empty((L, len(vals)), np.uint32)
        for j in range(L):
            out[j] = (vals >> (LIMB_BITS * j)) & LIMB_MASK
        return out

    def encode(self, values, to_mont: bool = True, device=None) -> torch.Tensor:
        """Host ints / PrimeField elems -> (L, N) int32 tensor on ``device``."""
        arr = self.encode_np(values, to_mont=to_mont).view(np.int32)
        return torch.from_numpy(arr).to(device)

    def encode_scalar(self, v, to_mont: bool = True, device=None) -> torch.Tensor:
        return self.encode([v], to_mont=to_mont, device=device)[:, 0]

    def decode(self, fa, from_mont: bool = True):
        """(L, *B) tensor -> numpy object array of Python ints."""
        arr = fa.detach().cpu().numpy().astype(np.uint32).astype(object)
        flat = arr.reshape(L, -1)
        vals = np.zeros(flat.shape[1], dtype=object)
        for j in range(L):
            vals += flat[j] << (LIMB_BITS * j)
        if from_mont:
            rinv, p = self.spec.r_inv, self.p
            vals = np.array([int(v) * rinv % p for v in vals], dtype=object)
        return vals.reshape(tuple(fa.shape[1:])) if fa.dim() > 1 else int(vals[0])

    def from_u32_array(self, v):
        """Values below 2^32 (*B,) (int64, or int32 holding uint32 bits) ->
        Montgomery field arrays (L, *B)."""
        v = v.to(torch.int64) & 0xFFFFFFFF
        lo, hi = v & LIMB_MASK, v >> LIMB_BITS
        raw = torch.stack([lo, hi] + [torch.zeros_like(lo)] * (L - 2)).to(torch.int32)
        return self.to_mont_arr(raw)

    def to_mont_arr(self, raw):
        """Canonical-limb array -> Montgomery form: multiply by R^2."""
        return self.mul(raw, self._const("r2", raw.device, raw.dim() - 1))

    def from_mont_arr(self, fa):
        """Montgomery form -> canonical limbs: multiply by 1."""
        return self.mul(fa, self._const("one_raw", fa.device, fa.dim() - 1))


@functools.lru_cache(maxsize=None)
def get_device_field(spec: FieldSpec) -> DeviceField:
    return DeviceField(spec)


class PlainField(DeviceField):
    """DeviceField whose multiplies, squares, adds, subtracts, powers and
    inverses are the plain versions on any device, so the plain versions
    of the loops that became one kernel each (the group ops, the ladder,
    the sponge) launch no kernel of this package."""

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
def plain_field(spec: FieldSpec) -> PlainField:
    return PlainField(spec)
