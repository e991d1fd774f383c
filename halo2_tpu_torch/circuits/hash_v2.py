"""Experiment 4 — Hash2Circuit (reference src/circuits/hash_v2.rs)."""

from __future__ import annotations

from ..chips.hash_v2 import Hash2Chip, Hash2Config
from ..plonkish import Circuit, Value


class Hash2Circuit(Circuit):
    def __init__(self, F, a: Value = None, b: Value = None):
        self.F = F
        self.a = a if a is not None else Value.unknown()
        self.b = b if b is not None else Value.unknown()

    def without_witnesses(self):
        return Hash2Circuit(self.F)

    @classmethod
    def configure(cls, meta) -> Hash2Config:
        advice = [meta.advice_column() for _ in range(3)]
        instance = meta.instance_column()
        return Hash2Chip.configure(meta, advice, instance)

    def synthesize(self, config, layouter):
        chip = Hash2Chip(config)
        a = chip.load_private(layouter.namespace("load a"), self.a)
        b = chip.load_private(layouter.namespace("load b"), self.b)
        c = chip.hash(layouter.namespace("load row"), a, b)
        chip.expose_public(layouter.namespace("hash output check"), c, 0)
