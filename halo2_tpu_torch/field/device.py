"""Prime-field arithmetic on torch tensors (port of halo2_tpu/field/device.py).

A *field array* keeps the reference's layout: ``(16, *batch)`` little-endian
16-bit limbs, limb axis leading, Montgomery form (R = 2^256), canonical
(< p) between ops.  The port stores it as ``torch.int32``: the limbs are below
2^16, so the numbers are the reference's ``uint32`` ones, and torch's
``uint32`` lacks the CPU ops the plain arithmetic needs.

``mul`` goes to :func:`.cuda_mul.mont_mul` (the CUDA kernel for a CUDA
tensor, its plain version for a CPU tensor).  ``add``/``sub``/``neg`` are
plain torch ops, as they are ``jnp`` ops in the reference; they compute in
int64 and return int32.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .cuda_mul import carry, mont_mul
from .params import FieldSpec, LIMB_BITS, LIMB_MASK, NUM_LIMBS, to_limbs

L = NUM_LIMBS


def _col(limbs_list) -> np.ndarray:
    return np.array(limbs_list, dtype=np.uint32)


class DeviceField:
    """Vectorized field arithmetic bound to one :class:`FieldSpec`."""

    def __init__(self, spec: FieldSpec):
        self.spec = spec
        self.p = spec.p
        self._p_np = _col(spec.p_limbs())
        self._one_mont_np = _col(to_limbs(spec.r))
        self._r2_np = _col(to_limbs(spec.r2))
        self._one_raw_np = _col(to_limbs(1))

    @functools.lru_cache(maxsize=None)
    def _const(self, name: str, device: torch.device, ndim: int, dtype=torch.int32):
        """A (16,) limb constant shaped (16, 1, ..., 1) to broadcast over
        ``ndim`` batch axes."""
        arr = getattr(self, f"_{name}_np").astype(np.int64)
        t = torch.from_numpy(arr).to(device=device, dtype=dtype)
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
    def _cond_sub_p(self, s):
        """int64 canonical limbs of a value < 2p -> int32 value mod p."""
        p = self._const("p", s.device, s.dim() - 1, torch.int64)
        d, borrow = carry(s - p)
        return torch.where(borrow < 0, s, d).to(torch.int32)

    def add(self, a, b):
        a, b, _ = self._bcast(a, b)
        s, _ = carry(a.to(torch.int64) + b.to(torch.int64))  # < 2p < 2^256
        return self._cond_sub_p(s)

    def sub(self, a, b):
        a, b, _ = self._bcast(a, b)
        d, borrow = carry(a.to(torch.int64) - b.to(torch.int64))
        p = self._const("p", d.device, d.dim() - 1, torch.int64)
        wrapped, _ = carry(d + p)
        return torch.where(borrow < 0, wrapped, d).to(torch.int32)

    def neg(self, a):
        return self.sub(self.zeros(a.shape[1:], device=a.device), a)

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Montgomery product a * b * R^-1 mod p, broadcasting as the
        reference's ``_bcast``.  A one-element operand stays a broadcast
        column for the kernel; any other broadcast is materialized."""
        batch = torch.broadcast_shapes(a.shape[1:], b.shape[1:])
        full = (L,) + tuple(batch)
        if tuple(a.shape) != full:
            a, b = b, a  # the product commutes
        if tuple(a.shape) != full or (b.shape != a.shape and b.numel() != L):
            a, b = a.expand(full), b.expand(full)
        return mont_mul(self.spec, a.contiguous(), b.contiguous())

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

    def to_mont_arr(self, raw):
        """Canonical-limb array -> Montgomery form: multiply by R^2."""
        return self.mul(raw, self._const("r2", raw.device, raw.dim() - 1))

    def from_mont_arr(self, fa):
        """Montgomery form -> canonical limbs: multiply by 1."""
        return self.mul(fa, self._const("one_raw", fa.device, fa.dim() - 1))


@functools.lru_cache(maxsize=None)
def get_device_field(spec: FieldSpec) -> DeviceField:
    return DeviceField(spec)
