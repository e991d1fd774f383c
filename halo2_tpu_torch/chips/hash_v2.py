"""Hash2Chip — dummy hash v2: gate ``s * (a + b - c)`` (experiment 4).

Re-design of reference src/chips/hash_v2.rs: load_private (:63-73) loads a
witness into col a; hash (:76-100) copy-constrains two input cells and
assigns c = a + b; expose_public (:104-111).
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation


@dataclasses.dataclass
class Hash2Config:
    advice: list  # [a, b, c]
    instance: object
    selector: object


class Hash2Chip:
    def __init__(self, config: Hash2Config, F=None):
        self.config = config

    construct = classmethod(lambda cls, config, F=None: cls(config, F))

    @staticmethod
    def configure(meta, advice, instance) -> Hash2Config:
        col_a, col_b, col_c = advice
        hash_selector = meta.selector()
        meta.enable_equality(col_c)
        meta.enable_equality(instance)
        meta.enable_equality(col_a)
        meta.enable_equality(col_b)

        def gate(m):
            s = m.query_selector(hash_selector)
            a = m.query_advice(col_a, Rotation.cur())
            b = m.query_advice(col_b, Rotation.cur())
            c = m.query_advice(col_c, Rotation.cur())
            return [s * (a + b - c)]

        meta.create_gate("hash constraint", gate)
        return Hash2Config([col_a, col_b, col_c], instance, hash_selector)

    def load_private(self, layouter, input_value):
        return layouter.assign_region(
            "load private",
            lambda region: region.assign_advice(
                "private input", self.config.advice[0], 0, input_value
            ),
        )

    def hash(self, layouter, a_cell, b_cell):
        def closure(region):
            self.config.selector.enable(region, 0)
            a_cell.copy_advice("input_a", region, self.config.advice[0], 0)
            b_cell.copy_advice("input_b", region, self.config.advice[1], 0)
            return region.assign_advice(
                "c", self.config.advice[2], 0, a_cell.value() + b_cell.value()
            )

        return layouter.assign_region("hash row", closure)

    def expose_public(self, layouter, c_cell, row: int):
        layouter.constrain_instance(c_cell.cell(), self.config.instance, row)
