"""SafeACcumulatorChip (sic) — field-modulus-safe accumulator (experiment 17).

Re-design of reference src/chips/safe_accumulator.rs: columns
``update_value, left_most_inv, add_carries[ACC_COLS], accumulate[ACC_COLS]``
(:14-22).  Gates: carries boolean (:62-73, on a selector that is never
enabled — reference quirk, preserved), add+carry chain (:75-148 with the
worked examples), overflow ``1 - is_zero(left_most)`` (:150-151), and
polynomial range checks on prev/updated accumulators (:158-159).  Assignment
does big-int arithmetic then decomposes (:186-259).
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value
from .is_zero import IsZeroChip, IsZeroConfig
from .utils import (
    decompose_bigint_to_ubits,
    range_check,
    range_check_vec,
    value_f_to_big_uint,
)


@dataclasses.dataclass
class SafeAccumulatorConfig:
    max_bits: int
    acc_cols: int
    update_value: object
    left_most_inv: object
    add_carries: list
    accumulate: list
    instance: object
    is_zero: IsZeroConfig
    selector: list  # [add_carry, overflow_check]


class SafeACcumulatorChip:
    def __init__(self, config: SafeAccumulatorConfig, F):
        self.config = config
        self.F = F

    construct = classmethod(lambda cls, config, F: cls(config, F))

    @staticmethod
    def configure(
        meta,
        max_bits,
        acc_cols,
        update_value,
        left_most_inv,
        add_carries,
        accumulate,
        selector,
        instance,
    ) -> SafeAccumulatorConfig:
        bool_selector, add_carry_selector, overflow_check_selector = selector

        is_zero = IsZeroChip.configure(
            meta,
            lambda m: m.query_selector(overflow_check_selector),
            lambda m: m.query_advice(accumulate[0], Rotation.cur()),
            left_most_inv,
        )

        for col in accumulate:
            meta.enable_equality(col)
        for col in add_carries:
            meta.enable_equality(col)
        meta.enable_equality(instance)

        def bool_gate(m):
            s = m.query_selector(bool_selector)
            return [
                s * (a := m.query_advice(c, Rotation.cur())) * (1 - a)
                for c in add_carries
            ]

        meta.create_gate("bool constraint", bool_gate)

        def acc_gate(m):
            s_add = m.query_selector(add_carry_selector)
            s_over = m.query_selector(overflow_check_selector)
            value = m.query_advice(update_value, Rotation.cur())
            previous_acc = [m.query_advice(accumulate[i], Rotation.prev()) for i in range(acc_cols)]
            carries_acc = [m.query_advice(add_carries[i], Rotation.cur()) for i in range(acc_cols)]
            updated_acc = [m.query_advice(accumulate[i], Rotation.cur()) for i in range(acc_cols)]
            shift = 1 << max_bits

            exprs = [
                s_add
                * (
                    (value + previous_acc[acc_cols - 1])
                    - (carries_acc[acc_cols - 1] * shift + updated_acc[acc_cols - 1])
                ),
                s_add * range_check(value, 1 << max_bits),
            ]
            exprs += [
                s_add
                * (
                    (updated_acc[i] + carries_acc[i] * shift)
                    - (previous_acc[i] + carries_acc[i + 1])
                )
                for i in range(acc_cols - 1)
            ]
            exprs.append(s_over * (1 - is_zero.expr()))
            exprs += range_check_vec(s_over, previous_acc, 1 << max_bits)
            exprs += range_check_vec(s_over, updated_acc, 1 << max_bits)
            return exprs

        meta.create_gate("accumulation constraint", acc_gate)

        return SafeAccumulatorConfig(
            max_bits,
            acc_cols,
            update_value,
            left_most_inv,
            list(add_carries),
            list(accumulate),
            instance,
            is_zero,
            [add_carry_selector, overflow_check_selector],
        )

    def assign(self, layouter, offset: int, update_value: Value, accumulated_values):
        cfg = self.config
        F = self.F
        is_zero_chip = IsZeroChip(cfg.is_zero)

        def closure(region):
            cfg.selector[0].enable(region, offset + 1)
            cfg.selector[1].enable(region, offset + 1)

            sum_big = value_f_to_big_uint(update_value)
            region.assign_advice("assign value for adding", cfg.update_value, 1, update_value)

            for idx, val in enumerate(accumulated_values):
                region.assign_advice(
                    f"assign previous accumulate[{idx}] col", cfg.accumulate[idx], 0, val
                )

            for idx in reversed(range(cfg.acc_cols)):
                shift_bits = cfg.max_bits * ((cfg.acc_cols - 1) - idx)
                sum_big += value_f_to_big_uint(accumulated_values[idx]) << shift_bits
                carry_flag = F.zero()
                if sum_big >= (1 << (cfg.max_bits + shift_bits)) and idx > 0:
                    carry_flag = F.one()
                region.assign_advice(
                    f"assign carried value at [{idx}]",
                    cfg.add_carries[idx],
                    offset + 1,
                    Value.known(carry_flag),
                )

            decomposed = decompose_bigint_to_ubits(sum_big, cfg.acc_cols, cfg.max_bits, F)

            updated = [Value.known(F.zero())] * cfg.acc_cols
            assigned_cells = []
            left_most_idx = cfg.acc_cols - 1
            for i, v in enumerate(decomposed):
                if i == left_most_idx:
                    is_zero_chip.assign(region, 1, Value.known(v))
                cell = region.assign_advice(
                    f"assign updated value to accumulated[{i}]",
                    cfg.accumulate[left_most_idx - i],
                    offset + 1,
                    Value.known(v),
                )
                assigned_cells.append(cell)
                updated[left_most_idx - i] = Value.known(v)
            return assigned_cells, updated

        return layouter.assign_region("calculate accumulates", closure)

    def expose_public(self, layouter, cell, row: int):
        layouter.constrain_instance(cell.cell(), self.config.instance, row)
