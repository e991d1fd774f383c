"""AddCarryChip v1 — 16-bit-limb accumulator (experiment 13).

Re-design of reference src/chips/add_carry_v1.rs: accumulator held as
acc_hi*2^16 + acc_lo; gate
``s * ((a + prev_b*2^16 + prev_c) - (b*2^16 + c))`` (:46-60); first row
zeroed from constants (:72-96); limb split via f_to_nbits (:131).
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value
from .utils import f_to_nbits


@dataclasses.dataclass
class AddCarryConfig:
    advice: list  # [a, b, c]
    constant: object
    instance: object
    selector: object


class AddCarryChip:
    def __init__(self, config: AddCarryConfig, F):
        self.config = config
        self.F = F

    construct = classmethod(lambda cls, config, F: cls(config, F))

    @staticmethod
    def configure(meta, advice, constant, selector, instance) -> AddCarryConfig:
        col_a, col_b, col_c = advice
        meta.enable_equality(col_b)
        meta.enable_equality(col_c)
        meta.enable_equality(instance)
        meta.enable_constant(constant)

        def gate(m):
            s = m.query_selector(selector)
            prev_b = m.query_advice(col_b, Rotation.prev())
            prev_c = m.query_advice(col_c, Rotation.prev())
            a = m.query_advice(col_a, Rotation.cur())
            b = m.query_advice(col_b, Rotation.cur())
            c = m.query_advice(col_c, Rotation.cur())
            return [s * ((a + prev_b * (1 << 16) + prev_c) - (b * (1 << 16) + c))]

        meta.create_gate("accumulate constraint", gate)
        return AddCarryConfig([col_a, col_b, col_c], constant, instance, selector)

    def assign_first_row(self, layouter):
        def closure(region):
            b_cell = region.assign_advice_from_constant(
                "first acc[1]", self.config.advice[1], 0, self.F.zero()
            )
            c_cell = region.assign_advice_from_constant(
                "first acc[2]", self.config.advice[2], 0, self.F.zero()
            )
            return b_cell, c_cell

        return layouter.assign_region("Initialize first row as zero", closure)

    def assign_advice_row(self, layouter, a: Value, prev_b, prev_c):
        def closure(region):
            self.config.selector.enable(region, 1)
            prev_b.copy_advice("prev_b", region, self.config.advice[1], 0)
            prev_c.copy_advice("prev_c", region, self.config.advice[2], 0)
            region.assign_advice("a", self.config.advice[0], 1, a)

            F = self.F
            total = F.zero()
            bv = prev_b.value().value()
            if bv is not None:
                total = total + bv * F.from_u64(1 << 16)
            cv = prev_c.value().value()
            if cv is not None:
                total = total + cv
            av = a.value()
            if av is not None:
                total = total + av
            hi, lo = f_to_nbits(16, total)

            b_cell = region.assign_advice("sum_hi", self.config.advice[1], 1, Value.known(hi))
            c_cell = region.assign_advice("sum_lo", self.config.advice[2], 1, Value.known(lo))
            return b_cell, c_cell

        return layouter.assign_region("adivce row for accumulating", closure)

    def expose_public(self, layouter, cell, row: int):
        layouter.constrain_instance(cell.cell(), self.config.instance, row)
