"""Experiment 3 — Hash1Circuit (reference src/circuits/hash_v1.rs)."""

from __future__ import annotations

from ..chips.hash_v1 import Hash1Chip, Hash1Config
from ..plonkish import Circuit, Value


class Hash1Circuit(Circuit):
    def __init__(self, F, a: Value = None):
        self.F = F
        self.a = a if a is not None else Value.unknown()

    def without_witnesses(self):
        return Hash1Circuit(self.F)

    @classmethod
    def configure(cls, meta) -> Hash1Config:
        col_a = meta.advice_column()
        col_b = meta.advice_column()
        instance = meta.instance_column()
        return Hash1Chip.configure(meta, [col_a, col_b], instance)

    def synthesize(self, config, layouter):
        chip = Hash1Chip(config, self.F)
        b = chip.assign_advice_row(layouter.namespace("load row"), self.a)
        chip.expose_public(layouter.namespace("hash output check"), b, 0)
