"""Radix-2 NTT stage kernels: the CUDA kernels, their plain PyTorch versions,
and the wrappers that pick one by the tensor's device.

The kernels (``csrc/ntt.cu``) replace
``halo2_tpu/poly/pallas_ntt.py:_small_stages_kernel`` (every stage with
half-size m <= TILE / 2, fused per TILE-element tile) and
``_large_stage_kernel`` (one stage with m >= TILE).  Input is the
bit-reversed ``(16, n)`` int32 field array, n a power of two >= TILE.

Twiddles come as one ``(16, n - 1)`` table: the m twiddles of the stage with
half-size m start at column m - 1 (see :func:`.domain.twiddle_table`).

``LAUNCHES`` counts kernel launches by kernel name.
"""

from __future__ import annotations

import torch

from ..field.cuda_mul import modulus_words, mont_mul_plain
from ..field.device import get_device_field
from ..field.params import FieldSpec

L = 16
TILE = 512
LAUNCHES = {"ntt_small_stages": 0, "ntt_large_stage": 0}


# ------------------------------------------------------------- plain versions
def _stage_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, m: int) -> torch.Tensor:
    """One butterfly stage with half-size m: (a, b) -> (a + b w, a - b w)."""
    df = get_device_field(spec)
    n = x.shape[1]
    v = x.reshape(L, n // (2 * m), 2, m)
    a, b = v[:, :, 0, :], v[:, :, 1, :]
    if m > 1:
        b = mont_mul_plain(spec, b, tw[:, m - 1 : 2 * m - 1].unsqueeze(1))
    return torch.stack([df.add(a, b), df.sub(a, b)], dim=2).reshape(L, n)


def ntt_small_stages_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    m = 1
    while m <= TILE // 2:
        x = _stage_plain(spec, x, tw, m)
        m *= 2
    return x


def ntt_large_stage_plain(
    spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, m: int
) -> torch.Tensor:
    return _stage_plain(spec, x, tw, m)


# -------------------------------------------------------------------- wrappers
def _check(x: torch.Tensor, tw: torch.Tensor, kernel: str) -> int:
    if x.dtype != torch.int32 or tw.dtype != torch.int32:
        raise TypeError(f"{kernel}: x and tw must be int32, got {x.dtype}, {tw.dtype}")
    if x.dim() != 2 or x.shape[0] != L:
        raise ValueError(f"{kernel}: x must be (16, n), got {tuple(x.shape)}")
    n = x.shape[1]
    if n < TILE or n & (n - 1):
        raise ValueError(f"{kernel}: n must be a power of two >= {TILE}, got {n}")
    if tuple(tw.shape) != (L, n - 1):
        raise ValueError(f"{kernel}: tw must be (16, {n - 1}), got {tuple(tw.shape)}")
    if not (x.is_contiguous() and tw.is_contiguous()):
        raise ValueError(f"{kernel}: x and tw must be contiguous")
    if x.device != tw.device:
        raise ValueError(f"{kernel}: x on {x.device}, tw on {tw.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {x.device}")
    return n


def _launch(kernel: str, x: torch.Tensor, *args) -> torch.Tensor:
    from .. import _build

    out = torch.empty_like(x)
    _build.launch(kernel, x.device, x.data_ptr(), out.data_ptr(), *args)
    LAUNCHES[kernel] += 1
    return out


def ntt_small_stages(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Every stage with half-size m = 1 .. TILE / 2."""
    n = _check(x, tw, "ntt_small_stages")
    if x.device.type == "cpu":
        return ntt_small_stages_plain(spec, x, tw)
    return _launch("ntt_small_stages", x, n, tw.data_ptr(), n - 1, modulus_words(spec).ctypes.data)


def ntt_large_stage(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, m: int) -> torch.Tensor:
    """The stage with half-size m (TILE <= m <= n / 2, a power of two)."""
    n = _check(x, tw, "ntt_large_stage")
    if m < TILE or m > n // 2 or m & (m - 1):
        raise ValueError(f"ntt_large_stage: bad half-size m={m} for n={n}")
    if x.device.type == "cpu":
        return ntt_large_stage_plain(spec, x, tw, m)
    return _launch(
        "ntt_large_stage", x, n, m, tw.data_ptr(), n - 1, modulus_words(spec).ctypes.data
    )


def ntt_stages(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The whole butterfly ladder over a bit-reversed (16, n) input, n >= TILE:
    the fused small stages, then one launch per large stage."""
    x = ntt_small_stages(spec, x, tw)
    m = TILE
    while m < x.shape[1]:
        x = ntt_large_stage(spec, x, tw, m)
        m *= 2
    return x
