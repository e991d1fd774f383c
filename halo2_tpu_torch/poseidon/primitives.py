"""Poseidon primitive: specs and the host sponge (halo2_tpu/poseidon/
primitives.py lines 24-151, carried over unchanged because that file also
holds the JAX device sponge and so cannot be loaded here).

Mirrors halo2_gadgets ``poseidon::primitives`` (Spec, ConstantLength domain,
Hash).  These digests feed instance columns, so they must match the
reference bit-exactly.  The batched device sponge (``permute_device``,
``hash_device``) is not ported yet.
"""

from __future__ import annotations

from ..field.host import PrimeField
from .grain import generate_constants


class Spec:
    """Poseidon spec bound to (width, rate); halo2_gadgets `Spec` trait."""

    def __init__(self, width: int, rate: int):
        assert rate == width - 1
        self.width = width
        self.rate = rate

    def full_rounds(self) -> int:
        raise NotImplementedError

    def partial_rounds(self) -> int:
        raise NotImplementedError

    def sbox(self, v):
        return v ** 5

    def secure_mds(self) -> int:
        return 0

    def constants(self, F: type[PrimeField]):
        """(round_constants, mds, mds_inv) as host field elements."""
        rcs, mds, mds_inv = generate_constants(
            F.SPEC, self.width, self.full_rounds(), self.partial_rounds(), self.secure_mds()
        )
        wrap = lambda rows: [[F(v) for v in row] for row in rows]  # noqa: E731
        return wrap(rcs), wrap(mds), wrap(mds_inv)


class MySpec(Spec):
    """The reference's MySpec (src/chips/poseidon/spec.rs): 8 full + 56
    partial rounds, x^5 sbox, secure_mds = 0, any width/rate."""

    def full_rounds(self) -> int:
        return 8

    def partial_rounds(self) -> int:
        return 56


class P128Pow5T3(MySpec):
    """halo2_gadgets' hardcoded width-3 spec; its constants are exactly the
    grain-generated ones for (t=3, 8, 56), so MySpec<3,2> coincides with it."""

    def __init__(self):
        super().__init__(3, 2)


class ConstantLength:
    """ConstantLength<L> domain: zero-pad to a multiple of RATE; capacity
    element encodes the length as L << 64."""

    def __init__(self, L: int):
        self.L = L

    def initial_capacity_element(self, F):
        return F.from_u128(self.L << 64)

    def padding(self, F, rate: int):
        k = (self.L + rate - 1) // rate
        return [F.zero()] * (k * rate - self.L)


def permute(state: list, spec: Spec, mds, round_constants):
    """Host permutation on field elements; halo2_gadgets primitives::permute."""
    width = spec.width
    r_f = spec.full_rounds() // 2
    r_p = spec.partial_rounds()

    def apply_mds(st):
        return [
            sum((mds[i][j] * st[j] for j in range(width)), start=type(st[0]).zero())
            for i in range(width)
        ]

    def full_round(st, rcs):
        return apply_mds([spec.sbox(w + rc) for w, rc in zip(st, rcs)])

    def part_round(st, rcs):
        st = [w + rc for w, rc in zip(st, rcs)]
        st[0] = spec.sbox(st[0])
        return apply_mds(st)

    rounds = [full_round] * r_f + [part_round] * r_p + [full_round] * r_f
    for f, rcs in zip(rounds, round_constants):
        state = f(state, rcs)
    return state


class Hash:
    """Out-of-circuit Poseidon hash (halo2_gadgets primitives::Hash) for
    ConstantLength domains."""

    def __init__(self, F: type[PrimeField], spec: Spec, domain: ConstantLength):
        self.F = F
        self.spec = spec
        self.domain = domain
        self.rcs, self.mds, self.mds_inv = spec.constants(F)

    @classmethod
    def init(cls, F, spec: Spec, domain: ConstantLength) -> "Hash":
        return cls(F, spec, domain)

    def hash(self, message):
        F, spec = self.F, self.spec
        assert len(message) == self.domain.L
        words = list(message) + self.domain.padding(F, spec.rate)
        state = [F.zero()] * spec.rate + [self.domain.initial_capacity_element(F)]
        for chunk_start in range(0, len(words), spec.rate):
            chunk = words[chunk_start : chunk_start + spec.rate]
            for i, w in enumerate(chunk):
                state[i] = state[i] + w
            state = permute(state, spec, self.mds, self.rcs)
        return state[0]


def poseidon_hash(F, spec: Spec, message) -> PrimeField:
    """Convenience one-shot hash with ConstantLength<len(message)>."""
    return Hash(F, spec, ConstantLength(len(message))).hash(message)
