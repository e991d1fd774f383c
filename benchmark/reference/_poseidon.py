"""Poseidon over a prime field in Python ints, dense, as halo2_gadgets
defines it (``primitives::{grain, mds, permute, Hash}``): the Grain LFSR
constants, the Cauchy MDS matrix, x^5 S-boxes, and the ConstantLength
sponge whose capacity word is L 2^64.  Written for the benchmark; it
shares no code with the program."""

from __future__ import annotations

import functools


class _Grain:
    def __init__(self, p: int, t: int, r_f: int, r_p: int):
        self.p, self.n_bits = p, p.bit_length()
        bits = []
        for value, width in ((1, 2), (0, 4), (self.n_bits, 12), (t, 12), (r_f, 10), (r_p, 10)):
            bits += [(value >> i) & 1 for i in reversed(range(width))]
        self.s = bits + [1] * 30
        for _ in range(160):
            self._clock()

    def _clock(self) -> int:
        s = self.s
        bit = s[62] ^ s[51] ^ s[38] ^ s[23] ^ s[13] ^ s[0]
        del s[0]
        s.append(bit)
        return bit

    def _bit(self) -> int:
        while True:
            b1, b2 = self._clock(), self._clock()
            if b1:
                return b2

    def _int(self) -> int:
        v = 0
        for _ in range(self.n_bits):
            v = v << 1 | self._bit()
        return v

    def element(self) -> int:
        while True:
            v = self._int()
            if v < self.p:
                return v

    def element_reduced(self) -> int:
        return self._int() % self.p


@functools.lru_cache(maxsize=None)
def constants(p: int, t: int, r_f: int, r_p: int) -> tuple:
    """(round constants, MDS) of width t with r_f full rounds in all and
    r_p partial ones (secure_mds = 0)."""
    g = _Grain(p, t, r_f, r_p)
    rcs = tuple(tuple(g.element() for _ in range(t)) for _ in range(r_f + r_p))
    while True:
        vals = [g.element_reduced() for _ in range(2 * t)]
        if len(set(vals)) < 2 * t:
            continue
        xs, ys = vals[:t], vals[t:]
        if all((x + y) % p for x in xs for y in ys):
            mds = tuple(tuple(pow(x + y, -1, p) for y in ys) for x in xs)
            return rcs, mds


def permute(state: list, p: int, r_f: int, r_p: int) -> list:
    """The permutation, dense: r_f / 2 full rounds, r_p partial, r_f / 2 full."""
    t = len(state)
    rcs, mds = constants(p, t, r_f, r_p)
    half = r_f // 2
    for r, rc in enumerate(rcs):
        state = [(v + c) % p for v, c in zip(state, rc)]
        if half <= r < half + r_p:
            state[0] = pow(state[0], 5, p)
        else:
            state = [pow(v, 5, p) for v in state]
        state = [sum(m * v for m, v in zip(row, state)) % p for row in mds]
    return state


def hash_constant_length(message: list, p: int, width: int, rate: int, r_f: int, r_p: int) -> int:
    """ConstantLength<len(message)>: zero padding to a multiple of the rate,
    capacity word len 2^64, absorb a rate's words a permutation, squeeze
    word 0."""
    n = len(message)
    words = list(message) + [0] * (-n % rate)
    state = [0] * rate + [(n << 64) % p] + [0] * (width - rate - 1)
    for s in range(0, len(words), rate):
        for i, w in enumerate(words[s : s + rate]):
            state[i] = (state[i] + w) % p
        state = permute(state, p, r_f, r_p)
    return state[0]
