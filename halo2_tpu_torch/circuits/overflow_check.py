"""Experiment 15 — OverflowCheckCircuit (reference src/circuits/overflow_check.rs)."""

from __future__ import annotations

from ..chips.overflow_check import OverFlowCheckConfig, OverFlowChip
from ..plonkish import Circuit, Value


class OverflowCheckCircuit(Circuit):
    def __init__(self, F, a: Value = None):
        self.F = F
        self.a = a if a is not None else Value.unknown()

    def without_witnesses(self):
        return OverflowCheckCircuit(self.F)

    @classmethod
    def configure(cls, meta) -> OverFlowCheckConfig:
        advice = [meta.advice_column() for _ in range(5)]
        carry_selector = meta.selector()
        overflow_selector = meta.selector()
        instance = meta.instance_column()
        return OverFlowChip.configure(
            meta, advice, [carry_selector, overflow_selector], instance
        )

    def synthesize(self, config, layouter):
        chip = OverFlowChip(config, self.F)
        prev_b, prev_c, prev_d = chip.assign_first_row(layouter.namespace("load first row"))
        b, c, d = chip.assign_advice_row(
            layouter.namespace("load row"), self.a, prev_b, prev_c, prev_d
        )
        chip.expose_public(layouter.namespace("overflow check"), b, 2)
        chip.expose_public(layouter.namespace("sum_high check"), c, 3)
        chip.expose_public(layouter.namespace("sum_low check"), d, 4)
