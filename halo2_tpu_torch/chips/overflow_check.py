"""OverFlowChip — 3-limb accumulator + IsZero overflow flag (experiment 15).

Re-design of reference src/chips/overflow_check.rs: limbs weighted
2^32 / 2^16 / 2^0; gate adds constraint + ``s_over * (1 - is_zero)``
(:58-84); assignment computes carries via the add_carry helper (:168-206).
Faithfulness quirks preserved: both b and c seeded from instance row 0
(:109-123), and the is_zero witness is assigned from the PRE-carry hi value
(Rust shadowing at :190-199 leaves the outer `hi` intact).
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value
from .is_zero import IsZeroChip, IsZeroConfig
from .utils import add_carry


@dataclasses.dataclass
class OverFlowCheckConfig:
    advice: list  # [a, b_inv, b, c, d]
    instance: object
    is_zero: IsZeroConfig
    selector: list  # [add_carry, overflow_check]


class OverFlowChip:
    def __init__(self, config: OverFlowCheckConfig, F):
        self.config = config
        self.F = F

    construct = classmethod(lambda cls, config, F: cls(config, F))

    @staticmethod
    def configure(meta, advice, selector, instance) -> OverFlowCheckConfig:
        col_a, col_b_inv, col_b, col_c, col_d = advice
        add_carry_selector, overflow_check_selector = selector
        is_zero = IsZeroChip.configure(
            meta,
            lambda m: m.query_selector(overflow_check_selector),
            lambda m: m.query_advice(col_b, Rotation.cur()),
            col_b_inv,
        )

        meta.enable_equality(col_b)
        meta.enable_equality(col_c)
        meta.enable_equality(col_d)
        meta.enable_equality(instance)

        def gate(m):
            s_add = m.query_selector(add_carry_selector)
            s_over = m.query_selector(overflow_check_selector)
            prev_b = m.query_advice(col_b, Rotation.prev())
            prev_c = m.query_advice(col_c, Rotation.prev())
            prev_d = m.query_advice(col_d, Rotation.prev())
            a = m.query_advice(col_a, Rotation.cur())
            b = m.query_advice(col_b, Rotation.cur())
            c = m.query_advice(col_c, Rotation.cur())
            d = m.query_advice(col_d, Rotation.cur())
            return [
                s_add
                * (
                    (a + prev_b * (1 << 32) + prev_c * (1 << 16) + prev_d)
                    - (b * (1 << 32) + c * (1 << 16) + d)
                ),
                s_over * (1 - is_zero.expr()),
            ]

        meta.create_gate("accumulate constraint", gate)
        return OverFlowCheckConfig(
            list(advice), instance, is_zero, [add_carry_selector, overflow_check_selector]
        )

    def assign_first_row(self, layouter):
        def closure(region):
            # NOTE: b and c both read instance row 0 (reference quirk,
            # overflow_check.rs:109-123)
            b_cell = region.assign_advice_from_instance(
                "first acc[2]", self.config.instance, 0, self.config.advice[2], 0
            )
            c_cell = region.assign_advice_from_instance(
                "first acc[4]", self.config.instance, 0, self.config.advice[3], 0
            )
            d_cell = region.assign_advice_from_instance(
                "first acc[4]", self.config.instance, 1, self.config.advice[4], 0
            )
            return b_cell, c_cell, d_cell

        return layouter.assign_region("first row", closure)

    def assign_advice_row(self, layouter, a: Value, prev_b, prev_c, prev_d):
        is_zero_chip = IsZeroChip(self.config.is_zero)
        F = self.F

        def closure(region):
            self.config.selector[0].enable(region, 1)
            self.config.selector[1].enable(region, 1)
            prev_b.copy_advice("prev_b", region, self.config.advice[2], 0)
            prev_c.copy_advice("prev_c", region, self.config.advice[3], 0)
            prev_d.copy_advice("prev_d", region, self.config.advice[4], 0)
            region.assign_advice("a", self.config.advice[0], 1, a)

            hi, lo = add_carry(16, a, prev_c, prev_d)

            c_cell = region.assign_advice("sum_hi", self.config.advice[3], 1, Value.known(hi))
            d_cell = region.assign_advice("sum_lo", self.config.advice[4], 1, Value.known(lo))

            sum_overflow = F.zero()
            if int(hi) >= (1 << 16):
                # inner shadow of `hi` in the reference — the outer value is
                # still what the is_zero witness sees below
                ov, hi2 = add_carry(16, Value.known(F.zero()), prev_b, c_cell)
                sum_overflow = ov
                c_cell = region.assign_advice(
                    "sum_hi", self.config.advice[3], 1, Value.known(hi2)
                )

            b_cell = region.assign_advice(
                "sum_overflow", self.config.advice[2], 1, Value.known(sum_overflow)
            )
            is_zero_chip.assign(region, 1, Value.known(hi))
            return b_cell, c_cell, d_cell

        return layouter.assign_region("adivce row for accumulating", closure)

    def expose_public(self, layouter, cell, row: int):
        layouter.constrain_instance(cell.cell(), self.config.instance, row)
