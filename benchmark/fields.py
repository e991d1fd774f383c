"""BN254 field constants and limb helpers of the benchmark's own.

The program stores a field element as 16 little-endian 16-bit limbs in
Montgomery form (R = 2^256), one int32 per limb, limb axis second to last
here (``(*lead, 16, n)``).  The benchmark makes its inputs in that form and
reads the program's outputs back through these helpers; nothing here comes
from the program.
"""

from __future__ import annotations

import numpy as np
import torch

# BN254 scalar field Fr (halo2curves bn256)
FR = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
LIMBS = 16
R = 1 << 256


def to_mont(v: int, p: int = FR) -> int:
    return v * R % p


def from_mont(m: int, p: int = FR) -> int:
    return m * pow(R, -1, p) % p


def limbs_to_ints(t: torch.Tensor) -> list[int]:
    """(16, N) limbs (any int dtype, any device) -> N Python ints."""
    a = t.detach().to("cpu", torch.int64).numpy().astype("<u2").T.copy()
    raw = a.tobytes()
    return [int.from_bytes(raw[32 * i : 32 * i + 32], "little") for i in range(a.shape[0])]


def ints_to_limbs(vals) -> np.ndarray:
    """N ints in [0, 2^256) -> (16, N) int32 limbs."""
    raw = b"".join(int(v).to_bytes(32, "little") for v in vals)
    return np.frombuffer(raw, "<u2").reshape(len(vals), LIMBS).T.astype(np.int32)


def random_elements(lead: tuple, n: int, gen: torch.Generator, device, p: int = FR) -> torch.Tensor:
    """Field elements as (*lead, 16, n) int32 limbs, canonical: uniform
    limbs with the top one below p's top limb, so every value is below
    p >> 240 << 240 < p (all of [0, p) but its top 2.5e-5)."""
    x = torch.randint(0, 1 << 16, (*lead, LIMBS, n), generator=gen, device=device, dtype=torch.int32)
    x[..., LIMBS - 1, :] %= p >> 240
    return x


def clear_low_limb(x: torch.Tensor) -> torch.Tensor:
    """A copy of (*lead, 16, n) limbs with the lowest limb of every element
    cleared: each word held to its top 240 bits."""
    y = x.clone()
    y[..., 0, :] = 0
    return y


def mont_mul(a: torch.Tensor, b: torch.Tensor, p: int = FR) -> torch.Tensor:
    """a b 2^-256 mod p for (16, N) limbs (either may be (16, 1)),
    canonical in and out, in plain int64 torch ops: Montgomery's CIOS over
    16-bit limbs with the carries left in the words until the end (a word
    stays below 2^38)."""
    dev = a.device
    a, b = a.to(torch.int64), b.to(torch.int64)
    n = max(a.shape[-1], b.shape[-1])
    pl = torch.tensor([(p >> (16 * j)) & 0xFFFF for j in range(LIMBS)], dtype=torch.int64, device=dev)[:, None]
    n0 = (-pow(p, -1, 1 << 16)) % (1 << 16)
    t = torch.zeros((LIMBS, n), dtype=torch.int64, device=dev)
    for i in range(LIMBS):
        t = t + a[i] * b
        t = t + ((t[0] * n0) & 0xFFFF) * pl  # word 0 is now 0 mod 2^16
        carry = t[0] >> 16
        t = torch.cat([t[1:], torch.zeros_like(t[:1])])
        t[0] += carry
    for j in range(LIMBS - 1):  # the value is below 2p < 2^256: no carry out of word 15
        t[j + 1] += t[j] >> 16
        t[j] &= 0xFFFF
    s = t - pl
    for j in range(LIMBS - 1):
        borrow = (s[j] < 0).to(torch.int64)
        s[j] += borrow << 16
        s[j + 1] -= borrow
    return torch.where(s[LIMBS - 1] >= 0, s, t).to(torch.int32)


def count_noncanonical(x: torch.Tensor, p: int = FR) -> int:
    """How many elements of (*lead, 16, n) limbs are not canonical: a limb
    outside [0, 2^16), or a value >= p."""
    x = x.to(torch.int64)
    bad = ((x < 0) | (x >= 1 << 16)).any(dim=-2)
    order = torch.zeros(bad.shape, dtype=torch.int64, device=x.device)  # sign of value - p
    for j in reversed(range(LIMBS)):
        s = torch.sign(x[..., j, :] - ((p >> (16 * j)) & 0xFFFF))
        order = torch.where(order == 0, s, order)
    return int((bad | (order >= 0)).sum())
