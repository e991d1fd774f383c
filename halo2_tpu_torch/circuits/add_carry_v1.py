"""Experiment 13 — AddCarryCircuit v1 (reference src/circuits/add_carry_v1.rs)."""

from __future__ import annotations

from ..chips.add_carry_v1 import AddCarryChip, AddCarryConfig
from ..plonkish import Circuit


class AddCarryCircuit(Circuit):
    def __init__(self, F, a: list = None):
        self.F = F
        self.a = a or []

    def without_witnesses(self):
        return AddCarryCircuit(self.F)

    @classmethod
    def configure(cls, meta) -> AddCarryConfig:
        col_a = meta.advice_column()
        col_b = meta.advice_column()
        col_c = meta.advice_column()
        constant = meta.fixed_column()
        carry_selector = meta.complex_selector()
        instance = meta.instance_column()
        return AddCarryChip.configure(
            meta, [col_a, col_b, col_c], constant, carry_selector, instance
        )

    def synthesize(self, config, layouter):
        chip = AddCarryChip(config, self.F)
        prev_b, prev_c = chip.assign_first_row(layouter.namespace("load first row"))
        for i, a in enumerate(self.a):
            prev_b, prev_c = chip.assign_advice_row(
                layouter.namespace(f"load row {i}"), a, prev_b, prev_c
            )
        chip.expose_public(layouter.namespace("carry check"), prev_b, 0)
        chip.expose_public(layouter.namespace("remain check"), prev_c, 1)
