"""Experiment 9 — dynamic-lookup less-than circuit (reference src/circuits/less_than.rs)."""

from __future__ import annotations

from ..chips.less_than import LessThanChip, LessThanConfig
from ..plonkish import Circuit, Value


class LessThanCircuit(Circuit):
    def __init__(self, F, input_value: Value = None):
        self.F = F
        self.input = input_value if input_value is not None else Value.unknown()

    def without_witnesses(self):
        return LessThanCircuit(self.F)

    @classmethod
    def configure(cls, meta) -> LessThanConfig:
        input_col = meta.advice_column()
        table = meta.instance_column()
        return LessThanChip.configure(meta, input_col, table)

    def synthesize(self, config, layouter):
        chip = LessThanChip(config)
        # reference discards the Result here (src/circuits/less_than.rs:36)
        try:
            chip.assign(layouter.namespace("init table"), self.input)
        except Exception:
            pass
