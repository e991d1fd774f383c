"""Polynomials evaluated exactly through float64 matrix products.

A column of n coefficients c_i (16-bit limbs c_(i,a)) at a point x with
powers x^i mod p (16-bit limbs w_(i,b)) is sum over a, b of 2^(16 (a + b))
times sum_i c_(i,a) w_(i,b).  Each inner sum adds n products below 2^32,
so below 2^53 for n <= 2^21: float64 holds every partial sum exactly,
whatever the order of the additions.  The products run as one matrix
product over all columns; the 256 sums combine in Python ints.
"""

from __future__ import annotations

import torch

from ..fields import LIMBS, ints_to_limbs

_BLOCK = 1 << 18


def powers(x: int, n: int, p: int) -> list[int]:
    out, v = [0] * n, 1
    for i in range(n):
        out[i] = v
        v = v * x % p
    return out


def power_limbs(x: int, n: int, p: int, device) -> torch.Tensor:
    """x^0 .. x^(n - 1) mod p as (16, n) float64 limbs on ``device``."""
    return torch.from_numpy(ints_to_limbs(powers(x, n, p))).to(device, torch.float64)


def evaluate(cols: torch.Tensor, xl: torch.Tensor, p: int) -> list[int]:
    """sum_i cols[k, :, i] x^i mod p for each column k of (C, 16, n) limbs
    (the ints the limbs spell, Montgomery or not), with ``xl`` the (16, n)
    limbs of the powers of x."""
    c, _, n = cols.shape
    if n > 1 << 21:
        raise ValueError(f"evaluate: {n} terms could round in float64")
    acc = torch.zeros((c * LIMBS, LIMBS), dtype=torch.float64, device=xl.device)
    flat = cols.reshape(c * LIMBS, n)
    for s in range(0, n, _BLOCK):
        blk = flat[:, s : s + _BLOCK].to(xl.device, torch.float64)
        acc += blk @ xl[:, s : s + _BLOCK].T
    if not torch.equal(acc, acc.round()):
        raise AssertionError("evaluate: a float64 sum was not an integer")
    sums = acc.to(torch.int64).reshape(c, LIMBS, LIMBS).cpu().tolist()
    return [
        sum(v << (16 * (a + b)) for a, row in enumerate(col) for b, v in enumerate(row)) % p for col in sums
    ]
