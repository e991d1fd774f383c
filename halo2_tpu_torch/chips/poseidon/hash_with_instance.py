"""PoseidonChip (instance variant) — reference src/chips/poseidon/hash_with_instance.rs.

Same as hash.py plus hash_inputs advice vec + instance column in the config
(:18-22), load_private_inputs (:78), hash copies inputs into the hash_inputs
row before running the sponge (:106-139), and expose_public (:141-148).
"""

from __future__ import annotations

import dataclasses

from ...poseidon.primitives import ConstantLength, Spec
from .pow5 import HashGadget, Pow5Chip, Pow5Config


@dataclasses.dataclass
class PoseidonConfig:
    hash_inputs: list
    instance: object
    pow5_config: Pow5Config


class PoseidonChip:
    def __init__(self, config: PoseidonConfig, spec: Spec, L: int, F):
        self.config = config
        self.spec = spec
        self.L = L
        self.F = F

    construct = classmethod(lambda cls, config, spec, L, F: cls(config, spec, L, F))

    @staticmethod
    def configure(meta, spec: Spec, F, hash_inputs: list, instance) -> PoseidonConfig:
        partial_sbox = meta.advice_column()
        rc_a = [meta.fixed_column() for _ in range(spec.width)]
        rc_b = [meta.fixed_column() for _ in range(spec.width)]
        for col in hash_inputs:
            meta.enable_equality(col)
        meta.enable_equality(instance)
        meta.enable_constant(rc_b[0])
        pow5_config = Pow5Chip.configure(
            meta, spec, F, list(hash_inputs), partial_sbox, rc_a, rc_b
        )
        return PoseidonConfig(list(hash_inputs), instance, pow5_config)

    def load_private_inputs(self, layouter, inputs):
        def closure(region):
            return [
                region.assign_advice("private input", self.config.hash_inputs[i], 0, x)
                for i, x in enumerate(inputs)
            ]

        return layouter.assign_region("load private inputs", closure)

    def hash(self, layouter, input_cells):
        def closure(region):
            return [
                cell.copy_advice(f"word {i}", region, self.config.hash_inputs[i], 0)
                for i, cell in enumerate(input_cells)
            ]

        hash_input_cells = layouter.assign_region(
            "copy input cells to hash input cells", closure
        )
        pow5_chip = Pow5Chip(self.config.pow5_config, self.F)
        hasher = HashGadget.init(
            pow5_chip, layouter.namespace("hasher"), ConstantLength(self.L)
        )
        return hasher.hash(layouter.namespace("hash"), hash_input_cells)

    def expose_public(self, layouter, cell, row: int):
        layouter.constrain_instance(cell.cell(), self.config.instance, row)
