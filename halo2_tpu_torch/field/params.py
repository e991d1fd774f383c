"""Prime-field parameters for the fields used by the reference experiments.

The reference (summa-dev/halo2-experiments) uses two scalar fields:
  * ``halo2curves::pasta::Fp``  — Pallas base field, used by most MockProver tests
    (reference: src/circuits/*.rs ``use halo2_proofs::halo2curves::pasta::Fp``)
  * ``halo2curves::bn256::Fr``  — BN254 scalar field, used by the KZG path and the
    zkevm-gadget tests (reference: src/circuits/utils.rs:2)
plus the BN254 base field Fq for G1 point arithmetic inside the KZG commitment
scheme (reference: src/circuits/utils.rs:40-48, KZGCommitmentScheme<Bn256>).

Device representation: 16 little-endian limbs of 16 bits each (256 bits total),
held in uint32 arrays with the limb axis LEADING so that batch axes map onto TPU
lanes.  All device arithmetic is in Montgomery form with R = 2^256.
"""

from __future__ import annotations

import dataclasses
import functools

LIMB_BITS = 16
NUM_LIMBS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1
R_BITS = LIMB_BITS * NUM_LIMBS  # 256

# Pallas base field (pasta Fp)
PASTA_FP_MODULUS = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
# Vesta base field (pasta Fq) — Pallas scalar field; kept for completeness.
PASTA_FQ_MODULUS = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001
# BN254 scalar field (bn256 Fr)
BN254_FR_MODULUS = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001
# BN254 base field (bn256 Fq) — coordinates of G1
BN254_FQ_MODULUS = 0x30644E72E131A029B85045B68181585D97816A916871CA8D3C208C16D87CFD47


def _mont_n0(p: int) -> int:
    """-p^{-1} mod 2^LIMB_BITS, the CIOS per-limb reduction constant."""
    return (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)


@dataclasses.dataclass(frozen=True)
class FieldSpec:
    """Static description of a prime field (host-side Python ints only)."""

    name: str
    p: int
    # multiplicative generator of the full group (halo2's `S`-adicity data)
    generator: int

    @property
    def num_bits(self) -> int:
        return self.p.bit_length()

    @functools.cached_property
    def r(self) -> int:  # Montgomery R mod p
        return (1 << R_BITS) % self.p

    @functools.cached_property
    def r2(self) -> int:  # R^2 mod p, for to-Montgomery conversion
        return (self.r * self.r) % self.p

    @functools.cached_property
    def r_inv(self) -> int:
        return pow(self.r, -1, self.p)

    @functools.cached_property
    def n0(self) -> int:
        return _mont_n0(self.p)

    @functools.cached_property
    def two_adicity(self) -> int:
        s = 0
        t = self.p - 1
        while t % 2 == 0:
            t //= 2
            s += 1
        return s

    @functools.cached_property
    def root_of_unity(self) -> int:
        """Generator of the 2^two_adicity subgroup."""
        return pow(self.generator, (self.p - 1) >> self.two_adicity, self.p)

    def p_limbs(self) -> list[int]:
        return to_limbs(self.p)


def to_limbs(v: int) -> list[int]:
    """Decompose a <2^256 int into NUM_LIMBS little-endian LIMB_BITS limbs."""
    return [(v >> (LIMB_BITS * j)) & LIMB_MASK for j in range(NUM_LIMBS)]


def from_limbs(limbs) -> int:
    out = 0
    for j, l in enumerate(limbs):
        out |= int(l) << (LIMB_BITS * j)
    return out


# Multiplicative generators (matching halo2curves):
#   pasta Fp: 5, pasta Fq: 5, bn254 Fr: 7, bn254 Fq: 3 (bn254 Fq has 2-adicity 1).
PASTA_FP = FieldSpec("pasta_fp", PASTA_FP_MODULUS, generator=5)
PASTA_FQ = FieldSpec("pasta_fq", PASTA_FQ_MODULUS, generator=5)
BN254_FR = FieldSpec("bn254_fr", BN254_FR_MODULUS, generator=7)
BN254_FQ = FieldSpec("bn254_fq", BN254_FQ_MODULUS, generator=3)

SPECS = {s.name: s for s in (PASTA_FP, PASTA_FQ, BN254_FR, BN254_FQ)}
