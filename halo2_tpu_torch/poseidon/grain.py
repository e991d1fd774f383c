"""Grain-LFSR Poseidon constant generation (halo2_gadgets `primitives::grain`).

Reproduces the Poseidon reference implementation's generate_parameters_grain
algorithm exactly as halo2_gadgets implements it (the reference repo's MySpec
relies on it via ``Spec::constants`` — src/chips/poseidon/spec.rs:17-31 with
secure_mds = 0):

* 80-bit LFSR state seeded with [2-bit field tag=1 | 4-bit sbox tag=0 (x^a) |
  12-bit n_bits | 12-bit t | 10-bit R_F | 10-bit R_P | 30 ones], each field
  written MSB-first;
* 160 initial clockings discarded; new bit = s62^s51^s38^s23^s13^s0;
* self-shrinking output: clock pairs (b1, b2), emit b2 only when b1 = 1;
* field elements sampled n_bits at a time MSB-first — WITH rejection for
  round constants, WITHOUT rejection (reduce mod p) for the Cauchy MDS x/y
  values; duplicate x/y batches are resampled; ``secure_mds`` batches are
  skipped before accepting an MDS.

Everything here is host-side preprocessing; results are cached per
(field, t, R_F, R_P, secure_mds).
"""

from __future__ import annotations

import functools

from ..field.params import FieldSpec


class Grain:
    def __init__(self, spec: FieldSpec, sbox_tag: int, t: int, r_f: int, r_p: int):
        self.spec = spec
        self.n_bits = spec.num_bits
        bits: list[int] = []

        def push(value: int, width: int):
            for i in reversed(range(width)):
                bits.append((value >> i) & 1)

        push(1, 2)          # field tag: prime-order
        push(sbox_tag, 4)   # sbox tag: 0 = x^alpha
        push(self.n_bits, 12)
        push(t, 12)
        push(r_f, 10)
        push(r_p, 10)
        bits.extend([1] * 30)
        assert len(bits) == 80
        self.state = bits
        for _ in range(160):
            self._clock()

    def _clock(self) -> int:
        s = self.state
        new_bit = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        s.pop(0)
        s.append(new_bit)
        return new_bit

    def next_bit(self) -> int:
        """Self-shrinking sampler."""
        while True:
            b1 = self._clock()
            b2 = self._clock()
            if b1:
                return b2

    def _sample_int(self) -> int:
        v = 0
        for _ in range(self.n_bits):
            v = (v << 1) | self.next_bit()  # first sampled bit is the MSB
        return v

    def next_field_element(self) -> int:
        """With rejection sampling (used for round constants)."""
        while True:
            v = self._sample_int()
            if v < self.spec.p:
                return v

    def next_field_element_without_rejection(self) -> int:
        """Reduce mod p (used for MDS x/y values)."""
        return self._sample_int() % self.spec.p


def _generate_mds(grain: Grain, t: int, select: int):
    """Cauchy MDS a_ij = 1/(x_i + y_j); mirrors halo2_gadgets mds.rs."""
    p = grain.spec.p
    while True:
        while True:
            vals = [grain.next_field_element_without_rejection() for _ in range(2 * t)]
            if len(set(vals)) == len(vals):
                xs, ys = vals[:t], vals[t:]
                break
        if select != 0:
            select -= 1
            continue
        mds = [[0] * t for _ in range(t)]
        ok = True
        for i in range(t):
            for j in range(t):
                s = (xs[i] + ys[j]) % p
                if s == 0:
                    ok = False
                    break
                mds[i][j] = pow(s, -1, p)
            if not ok:
                break
        if ok:
            break
    # invert the MDS matrix over GF(p) by Gauss-Jordan
    mds_inv = _invert_matrix(mds, p)
    return mds, mds_inv


def _invert_matrix(m, p):
    t = len(m)
    aug = [
        [m[i][j] % p for j in range(t)] + [1 if i == j else 0 for j in range(t)]
        for i in range(t)
    ]
    for col in range(t):
        piv = next(r for r in range(col, t) if aug[r][col] % p != 0)
        aug[col], aug[piv] = aug[piv], aug[col]
        inv = pow(aug[col][col], -1, p)
        aug[col] = [(x * inv) % p for x in aug[col]]
        for r in range(t):
            if r != col and aug[r][col] % p != 0:
                f = aug[r][col]
                aug[r] = [(a - f * b) % p for a, b in zip(aug[r], aug[col])]
    return [row[t:] for row in aug]


@functools.lru_cache(maxsize=None)
def generate_constants(spec: FieldSpec, t: int, r_f: int, r_p: int, secure_mds: int = 0):
    """Returns (round_constants[(r_f+r_p)][t], mds[t][t], mds_inv[t][t]) as
    canonical ints — halo2_gadgets `generate_constants`."""
    grain = Grain(spec, sbox_tag=0, t=t, r_f=r_f, r_p=r_p)
    round_constants = [
        [grain.next_field_element() for _ in range(t)] for _ in range(r_f + r_p)
    ]
    mds, mds_inv = _generate_mds(grain, t, secure_mds)
    return round_constants, mds, mds_inv
