"""AddCarryV2Chip — accumulator with overflow guard (experiment 14).

Re-design of reference src/chips/add_carry_v2.rs: v1 plus an extra ``b_inv``
column; second constraint ``s * b * (1 - b * b_inv)`` forces acc_hi = 0
(:44-62, inlined is_zero); first row loaded FROM INSTANCE (:72-98); in-line
repeated-subtraction limb split (:131-142, here an equivalent divmod).
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value
from .utils import f_to_nbits


@dataclasses.dataclass
class AddCarryV2Config:
    advice: list  # [a, b_inv, b, c]
    instance: object
    selector: object


class AddCarryV2Chip:
    def __init__(self, config: AddCarryV2Config, F):
        self.config = config
        self.F = F

    construct = classmethod(lambda cls, config, F: cls(config, F))

    @staticmethod
    def configure(meta, advice, selector, instance) -> AddCarryV2Config:
        col_a, col_b_inv, col_b, col_c = advice
        meta.enable_equality(col_b)
        meta.enable_equality(col_c)
        meta.enable_equality(instance)

        def gate(m):
            s = m.query_selector(selector)
            prev_b = m.query_advice(col_b, Rotation.prev())
            prev_c = m.query_advice(col_c, Rotation.prev())
            a = m.query_advice(col_a, Rotation.cur())
            b_inv = m.query_advice(col_b_inv, Rotation.cur())
            b = m.query_advice(col_b, Rotation.cur())
            c = m.query_advice(col_c, Rotation.cur())
            return [
                s * ((a + prev_b * (1 << 16) + prev_c) - (b * (1 << 16) + c)),
                s * b * (1 - b * b_inv),
            ]

        meta.create_gate("accumulate constraint", gate)
        return AddCarryV2Config(list(advice), instance, selector)

    def assign_first_row(self, layouter):
        def closure(region):
            b_cell = region.assign_advice_from_instance(
                "first acc[1]", self.config.instance, 0, self.config.advice[2], 0
            )
            c_cell = region.assign_advice_from_instance(
                "first acc[2]", self.config.instance, 1, self.config.advice[3], 0
            )
            return b_cell, c_cell

        return layouter.assign_region("first row", closure)

    def assign_advice_row(self, layouter, a: Value, prev_b, prev_c):
        def closure(region):
            self.config.selector.enable(region, 1)
            prev_b.copy_advice("prev_b", region, self.config.advice[2], 0)
            prev_c.copy_advice("prev_c", region, self.config.advice[3], 0)
            region.assign_advice("a", self.config.advice[0], 1, a)

            F = self.F
            total = F.zero()
            av = a.value()
            if av is not None:
                total = total + av
            bv = prev_b.value().value()
            if bv is not None:
                total = total + bv * F.from_u64(1 << 16)
            cv = prev_c.value().value()
            if cv is not None:
                total = total + cv
            hi, lo = f_to_nbits(16, total)

            b_cell = region.assign_advice("sum_hi", self.config.advice[2], 1, Value.known(hi))
            c_cell = region.assign_advice("sum_lo", self.config.advice[3], 1, Value.known(lo))
            b_inv = Value.known(hi).map(lambda v: v.invert_or_zero())
            region.assign_advice("b inv", self.config.advice[1], 1, b_inv)
            return b_cell, c_cell

        return layouter.assign_region("adivce row for accumulating", closure)

    def expose_public(self, layouter, cell, row: int):
        layouter.constrain_instance(cell.cell(), self.config.instance, row)
