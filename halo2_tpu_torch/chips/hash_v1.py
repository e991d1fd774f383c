"""Hash1Chip — dummy hash v1: gate ``s * (2a - b)`` (experiment 3).

TPU-native re-design of reference src/chips/hash_v1.rs: same columns
(2 advice + instance + selector), same gate polynomial (hash_v1.rs:42-50),
same assignment row (hash_v1.rs:59-83) and instance exposure (:86-92).
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value


@dataclasses.dataclass
class Hash1Config:
    advice: list  # [col_a, col_b]
    instance: object
    selector: object


class Hash1Chip:
    def __init__(self, config: Hash1Config, F):
        self.config = config
        self.F = F

    construct = classmethod(lambda cls, config, F: cls(config, F))

    @staticmethod
    def configure(meta, advice, instance) -> Hash1Config:
        col_a, col_b = advice
        hash_selector = meta.selector()
        meta.enable_equality(col_b)
        meta.enable_equality(instance)

        def gate(m):
            s = m.query_selector(hash_selector)
            a = m.query_advice(col_a, Rotation.cur())
            b = m.query_advice(col_b, Rotation.cur())
            return [s * (2 * a - b)]

        meta.create_gate("hash constraint", gate)
        return Hash1Config([col_a, col_b], instance, hash_selector)

    def assign_advice_row(self, layouter, a: Value):
        def closure(region):
            self.config.selector.enable(region, 0)
            region.assign_advice("a", self.config.advice[0], 0, a)
            return region.assign_advice(
                "b", self.config.advice[1], 0, a * Value.known(self.F.from_u64(2))
            )

        return layouter.assign_region("adivce row", closure)

    def expose_public(self, layouter, b_cell, row: int):
        layouter.constrain_instance(b_cell.cell(), self.config.instance, row)
