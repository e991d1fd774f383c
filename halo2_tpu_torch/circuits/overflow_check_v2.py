"""Experiment 16 — OverflowCheckCircuitV2 (reference src/circuits/overflow_check_v2.rs).

Checks a, b and a+b separately for decomposition-range overflow
(overflow_check_v2.rs:51-56, README.md:478-487).  MAX_BITS=4, ACC_COLS=4.
"""

from __future__ import annotations

from ..chips.overflow_check_v2 import OverflowCheckV2Config, OverflowChipV2
from ..plonkish import Circuit, Value

MAX_BITS = 4
ACC_COLS = 4


class OverflowCheckCircuitV2(Circuit):
    def __init__(self, F, a: Value = None, b: Value = None):
        self.F = F
        self.a = a if a is not None else Value.unknown()
        self.b = b if b is not None else Value.unknown()

    def without_witnesses(self):
        return OverflowCheckCircuitV2(self.F)

    @classmethod
    def configure(cls, meta) -> OverflowCheckV2Config:
        col_a = meta.advice_column()
        decomposed = [meta.advice_column() for _ in range(ACC_COLS)]
        u8 = meta.fixed_column()
        selector = meta.selector()
        instance = meta.instance_column()
        return OverflowChipV2.configure(
            meta, MAX_BITS, ACC_COLS, col_a, decomposed, u8, instance, selector
        )

    def synthesize(self, config, layouter):
        chip = OverflowChipV2(config, self.F)
        chip.load(layouter)
        chip.assign(layouter.namespace("checking overflow value a"), self.a)
        chip.assign(layouter.namespace("checking overflow value b"), self.b)
        chip.assign(layouter.namespace("checking overflow value a + b"), self.a + self.b)
