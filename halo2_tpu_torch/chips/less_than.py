"""LessThanChip — input < target via a dynamic lookup (experiment 9).

Re-design of reference src/chips/less_than.rs: ``lookup_any`` of the input
advice into an ``advice_table`` column (:46-53) that is dynamically filled by
copying instance rows 0..1000 via assign_advice_from_instance (:71-80 —
hardcoded 1000; rows past the provided instance length read zero padding).
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value


@dataclasses.dataclass
class LessThanConfig:
    input: object
    table: object          # instance column holding 0..target-1
    advice_table: object


class LessThanChip:
    def __init__(self, config: LessThanConfig, F=None):
        self.config = config

    construct = classmethod(lambda cls, config, F=None: cls(config, F))

    @staticmethod
    def configure(meta, input_col, table) -> LessThanConfig:
        advice_table = meta.advice_column()
        meta.enable_equality(table)
        meta.enable_equality(advice_table)
        meta.annotate_lookup_any_column(advice_table, lambda: "Adv-table")

        def lookup(m):
            inp = m.query_advice(input_col, Rotation.cur())
            adv = m.query_advice(advice_table, Rotation.cur())
            return [(inp, adv)]

        meta.lookup_any("dynamic lookup check", lookup)
        return LessThanConfig(input_col, table, advice_table)

    def assign(self, layouter, input_value: Value):
        def closure(region):
            for i in range(1000):
                region.assign_advice_from_instance(
                    "Advice from instance tables",
                    self.config.table,
                    i,
                    self.config.advice_table,
                    i,
                )
            region.assign_advice("input", self.config.input, 0, input_value)

        return layouter.assign_region("less than assignment", closure)
