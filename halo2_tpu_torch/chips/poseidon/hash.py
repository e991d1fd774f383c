"""PoseidonChip (no-instance variant) — reference src/chips/poseidon/hash.rs.

Thin wrapper over Pow5Chip: creates partial_sbox advice + rc_a/rc_b fixed
columns (WIDTH each, :50-52), enables equality on the WIDTH state columns
(:54-56) and enable_constant(rc_b[0]) (:57); `hash` runs the in-circuit
ConstantLength<L> sponge over L cells (:75-89).
"""

from __future__ import annotations

import dataclasses

from ...poseidon.primitives import ConstantLength, Spec
from .pow5 import HashGadget, Pow5Chip, Pow5Config


@dataclasses.dataclass
class PoseidonConfig:
    pow5_config: Pow5Config


class PoseidonChip:
    def __init__(self, config: PoseidonConfig, spec: Spec, L: int, F):
        self.config = config
        self.spec = spec
        self.L = L
        self.F = F

    construct = classmethod(lambda cls, config, spec, L, F: cls(config, spec, L, F))

    @staticmethod
    def configure(meta, spec: Spec, F, hash_inputs: list) -> PoseidonConfig:
        partial_sbox = meta.advice_column()
        rc_a = [meta.fixed_column() for _ in range(spec.width)]
        rc_b = [meta.fixed_column() for _ in range(spec.width)]
        for col in hash_inputs:
            meta.enable_equality(col)
        meta.enable_constant(rc_b[0])
        pow5_config = Pow5Chip.configure(
            meta, spec, F, list(hash_inputs), partial_sbox, rc_a, rc_b
        )
        return PoseidonConfig(pow5_config)

    def hash(self, layouter, input_cells):
        pow5_chip = Pow5Chip(self.config.pow5_config, self.F)
        hasher = HashGadget.init(
            pow5_chip, layouter.namespace("hasher"), ConstantLength(self.L)
        )
        return hasher.hash(layouter.namespace("hash"), input_cells)
