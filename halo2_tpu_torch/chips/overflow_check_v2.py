"""OverflowChipV2 — overflow check by decomposition + range lookup (experiment 16).

Re-design of reference src/chips/overflow_check_v2.rs: gate
``sum(decomposed_i * 2^(MAX_BITS*i)) - value`` (:41-59); per-column
``lookup_any`` of each decomposed limb into a fixed ``range`` table (:63-69);
``load`` fills the table with 0..2^MAX_BITS (:116-133).  Const generics
<MAX_BITS, ACC_COLS> become constructor parameters.
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value
from .utils import decompose_bigint_to_ubits, value_f_to_big_uint


@dataclasses.dataclass
class OverflowCheckV2Config:
    max_bits: int
    acc_cols: int
    value: object
    decomposed_values: list
    range: object
    instance: object
    selector: object


class OverflowChipV2:
    def __init__(self, config: OverflowCheckV2Config, F):
        self.config = config
        self.F = F

    construct = classmethod(lambda cls, config, F: cls(config, F))

    @staticmethod
    def configure(
        meta, max_bits, acc_cols, value, decomposed_values, range_col, instance, selector
    ) -> OverflowCheckV2Config:
        for col in decomposed_values:
            meta.enable_equality(col)

        def gate(m):
            s_doc = m.query_selector(selector)
            v = m.query_advice(value, Rotation.cur())
            dec = [m.query_advice(decomposed_values[i], Rotation.cur()) for i in range(acc_cols)]
            # columns hold big-endian limbs: column 0 carries weight 2^(MAX_BITS*(ACC_COLS-1))
            acc = dec[acc_cols - 1]
            for i in range(acc_cols - 1):
                acc = acc + dec[i] * (1 << (max_bits * ((acc_cols - 1) - i)))
            return [s_doc * (acc - v)]

        meta.create_gate("equality check between decomposed value and value", gate)

        meta.annotate_lookup_any_column(range_col, lambda: "LOOKUP_MAXBITS_RANGE")

        for column in decomposed_values:
            def lookup(m, column=column):
                cell = m.query_advice(column, Rotation.cur())
                rng = m.query_fixed(range_col, Rotation.cur())
                return [(cell, rng)]

            meta.lookup_any("range check for MAXBITS", lookup)

        return OverflowCheckV2Config(
            max_bits, acc_cols, value, list(decomposed_values), range_col, instance, selector
        )

    def assign(self, layouter, update_value: Value):
        cfg = self.config
        F = self.F

        def closure(region):
            cfg.selector.enable(region, 0)
            region.assign_advice("assign value", cfg.value, 0, update_value)
            # NOTE: reference swaps (number_of_limbs, bit_len) args here
            # (overflow_check_v2.rs:96-100) — harmless since MAX_BITS == ACC_COLS
            decomposed = decompose_bigint_to_ubits(
                value_f_to_big_uint(update_value), cfg.max_bits, cfg.acc_cols, F
            )
            # decomposed is little-endian; columns are big-endian
            for idx, val in enumerate(reversed(decomposed)):
                region.assign_advice(
                    f"assign decomposed[{idx}] col",
                    cfg.decomposed_values[idx],
                    0,
                    Value.known(val),
                )

        return layouter.assign_region("assign decomposed values", closure)

    def load(self, layouter):
        cfg = self.config
        rng = 1 << cfg.max_bits

        def closure(region):
            for i in range(rng):
                region.assign_fixed(
                    "assign cell in fixed column",
                    cfg.range,
                    i,
                    Value.known(self.F.from_u64(i)),
                )

        return layouter.assign_region(
            f"load range check table of {cfg.max_bits} bits", closure
        )

    def expose_public(self, layouter, cell, row: int):
        layouter.constrain_instance(cell.cell(), self.config.instance, row)
