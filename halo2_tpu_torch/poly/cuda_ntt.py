"""Radix-2 NTT stage kernels: the CUDA kernels, their plain PyTorch versions,
and the wrappers that pick one by the tensor's device.

The kernels (``csrc/ntt.cu``) replace
``halo2_tpu/poly/pallas_ntt.py:_small_stages_kernel`` (every stage with
half-size m <= TILE / 2, fused per TILE-element tile) and
``_large_stage_kernel`` (one stage with m >= TILE; here up to
:data:`MAX_FUSED` consecutive large stages in one pass, as
:func:`large_stage_plan` groups them).  Input is an int32 field array: one
column ``(16, n)``, or a batch of C columns ``(C, 16, n)``, contiguous,
column c the ``(16, n)`` block at offset ``c * 16 * n``.  One launch covers
the batch.  For n >= TILE it is bit-reversed (the caller gathers it).
Below TILE (n = 1 .. 256: the sharded NTT's local transforms)
``ntt_small_stages`` is the whole transform in one launch: the kernel
holds whole columns a block, reads them in natural order through the
bit-reversal itself and runs all log2(n) stages, where the reference runs
its ``jnp`` stage ladder (``halo2_tpu/poly/domain.py:78-91``), compiled by
XLA into one program.

Twiddles come as one ``(16, n - 1)`` table shared by every column: the m
twiddles of the stage with half-size m start at column m - 1 (see
:func:`.domain.twiddle_table`).

The kernels' arithmetic is a template argument: the PTX carry chains of
``csrc/field_cc.cuh``, whose bounds hold for p < 2^254 (both BN254 fields),
or ``csrc/field.cuh``'s 64-bit accumulators for any other modulus (the
255-bit Pasta fields); :func:`_arith` (``field.cuda_ops.arith``) picks it
from the modulus.

``LAUNCHES`` counts kernel launches by kernel name.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field.cuda_mul import modulus_words, mont_mul_plain
from ..field.cuda_ops import ARITH, mod_add_plain, mod_sub_plain
from ..field.cuda_ops import arith as _arith
from ..field.params import FieldSpec

L = 16
TILE = 512
MAX_FUSED = 6  # large stages a launch: 16 x 2^6 elements, 32 KB of shared memory a block
LAUNCHES = {"ntt_small_stages": 0, "ntt_large_stage": 0}


@functools.lru_cache(maxsize=None)
def rev_index(n: int, device: torch.device) -> torch.Tensor:
    """The bit-reversal permutation of 0 .. n - 1 (n a power of two) as an
    int64 index tensor on ``device``, made once per (n, device)."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    rev = np.zeros(n, np.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return torch.from_numpy(rev).to(device)


# ------------------------------------------------------------- plain versions
def _stage_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, m: int) -> torch.Tensor:
    """One butterfly stage with half-size m over the last axis of a
    ``(*lead, 16, n)`` array: (a, b) -> (a + b w, a - b w), in plain torch
    ops only (the yardstick of both kernels)."""
    lead, n = x.shape[:-2], x.shape[-1]
    v = x.movedim(-2, 0).reshape(L, *lead, n // (2 * m), 2, m)  # limbs first
    a, b = v[..., 0, :], v[..., 1, :]
    if m > 1:
        w = tw[:, m - 1 : 2 * m - 1].reshape(L, *(1,) * (len(lead) + 1), m)
        b = mont_mul_plain(spec, b, w)
    y = torch.stack([mod_add_plain(spec, a, b), mod_sub_plain(spec, a, b)], dim=-2).reshape(L, *lead, n)
    return y.movedim(0, -2).contiguous()


def ntt_small_stages_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The stages m = 1 .. min(n, TILE) / 2; below TILE after the
    bit-reversal gather of the natural-order input, as the kernel reads it."""
    n = x.shape[-1]
    if n < TILE:
        x = x.index_select(-1, rev_index(n, x.device))
    m = 1
    while m < min(n, TILE):
        x = _stage_plain(spec, x, tw, m)
        m *= 2
    return x


def ntt_large_stage_plain(
    spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, m: int, stages: int = 1
) -> torch.Tensor:
    for s in range(stages):
        x = _stage_plain(spec, x, tw, m << s)
    return x


def large_stage_plan(n: int) -> list[tuple[int, int]]:
    """The passes of an n-point transform's large stages, ``[(m0, stages),
    ...]``: its log2(n) - 9 stages m = TILE .. n / 2, in order, in
    ceil((log2(n) - 9) / MAX_FUSED) passes whose sizes differ by at most
    one, the longer first (2^11: one pass of 2; 2^15: one of 6; 2^20: 6 + 5)."""
    total = n.bit_length() - TILE.bit_length()
    if total <= 0:
        return []
    passes = -(-total // MAX_FUSED)
    plan, m = [], TILE
    for i in range(passes):
        r = total // passes + (i < total % passes)
        plan.append((m, r))
        m <<= r
    return plan


# -------------------------------------------------------------------- wrappers
def _check(x: torch.Tensor, tw: torch.Tensor, kernel: str, min_n: int) -> tuple:
    """Raise unless x is a contiguous int32 (16, n) or (C, 16, n), n a power
    of two >= min_n, and tw the (16, n - 1) table beside it; returns (n, C)."""
    if x.dtype != torch.int32 or tw.dtype != torch.int32:
        raise TypeError(f"{kernel}: x and tw must be int32, got {x.dtype}, {tw.dtype}")
    if x.dim() not in (2, 3) or x.shape[-2] != L:
        raise ValueError(f"{kernel}: x must be (16, n) or (C, 16, n), got {tuple(x.shape)}")
    n = x.shape[-1]
    if n < min_n or n & (n - 1):
        raise ValueError(f"{kernel}: n must be a power of two >= {min_n}, got {n}")
    if tuple(tw.shape) != (L, n - 1):
        raise ValueError(f"{kernel}: tw must be (16, {n - 1}), got {tuple(tw.shape)}")
    if not (x.is_contiguous() and tw.is_contiguous()):
        raise ValueError(f"{kernel}: x and tw must be contiguous")
    if x.device != tw.device:
        raise ValueError(f"{kernel}: x on {x.device}, tw on {tw.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel}: unsupported device {x.device}")
    cols = x.shape[0] if x.dim() == 3 else 1
    if cols > 65535 and n >= TILE:  # the kernels' grid y
        raise ValueError(f"{kernel}: at most 65535 columns, got {cols}")
    return n, cols


def _launch(kernel: str, spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, *args) -> torch.Tensor:
    from .. import _build

    if x.data_ptr() % 16:
        raise ValueError(f"{kernel}: x must be 16-byte aligned for the kernel's vector loads")
    out = torch.empty_like(x)
    if x.numel():
        _build.launch(
            kernel, x.device, x.data_ptr(), out.data_ptr(), *args, tw.data_ptr(),
            modulus_words(spec).ctypes.data, ARITH[_arith(spec)],
        )
        LAUNCHES[kernel] += 1
    return out


def ntt_small_stages(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Every stage with half-size m = 1 .. min(n, TILE) / 2, on each column:
    for n >= TILE over a bit-reversed x; below TILE over a natural-order x
    (the kernel reads it through the bit-reversal), which makes it the whole
    transform."""
    n, cols = _check(x, tw, "ntt_small_stages", 1)
    if x.device.type == "cpu":
        return ntt_small_stages_plain(spec, x, tw)
    return _launch("ntt_small_stages", spec, x, tw, n, cols)


def ntt_large_stage(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, m: int, stages: int = 1) -> torch.Tensor:
    """The ``stages`` consecutive stages with half-sizes m, 2m, ..,
    m 2^(stages - 1) (m >= TILE a power of two, 1 <= stages <=
    MAX_FUSED, m 2^stages <= n), on each column, in one launch."""
    n, cols = _check(x, tw, "ntt_large_stage", TILE)
    if m < TILE or m & (m - 1) or not 1 <= stages <= MAX_FUSED or m << stages > n:
        raise ValueError(f"ntt_large_stage: bad half-size m={m} or stages={stages} for n={n}")
    if x.device.type == "cpu":
        return ntt_large_stage_plain(spec, x, tw, m, stages)
    return _launch("ntt_large_stage", spec, x, tw, n, cols, m, stages)


def ntt_stages(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The whole butterfly ladder over a (16, n) or (C, 16, n) input, bit-
    reversed for n >= TILE, in natural order below: the fused small stages,
    then one launch per pass of :func:`large_stage_plan` (none below TILE),
    each over every column."""
    x = ntt_small_stages(spec, x, tw)
    for m, stages in large_stage_plan(x.shape[-1]):
        x = ntt_large_stage(spec, x, tw, m, stages)
    return x
