"""Experiment 14 — AddCarryCircuit v2 (reference src/circuits/add_carry_v2.rs)."""

from __future__ import annotations

from ..chips.add_carry_v2 import AddCarryV2Chip, AddCarryV2Config
from ..plonkish import Circuit, Value


class AddCarryV2Circuit(Circuit):
    def __init__(self, F, a: Value = None):
        self.F = F
        self.a = a if a is not None else Value.unknown()

    def without_witnesses(self):
        return AddCarryV2Circuit(self.F)

    @classmethod
    def configure(cls, meta) -> AddCarryV2Config:
        advice = [meta.advice_column() for _ in range(4)]
        carry_selector = meta.complex_selector()
        instance = meta.instance_column()
        return AddCarryV2Chip.configure(meta, advice, carry_selector, instance)

    def synthesize(self, config, layouter):
        chip = AddCarryV2Chip(config, self.F)
        prev_b, prev_c = chip.assign_first_row(layouter.namespace("load first row"))
        b, c = chip.assign_advice_row(layouter.namespace("load row"), self.a, prev_b, prev_c)
        chip.expose_public(layouter.namespace("carry check"), b, 2)
        chip.expose_public(layouter.namespace("remain check"), c, 3)
