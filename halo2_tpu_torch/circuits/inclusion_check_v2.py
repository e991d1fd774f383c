"""Experiment 2 — inclusion check v2 circuit (reference src/circuits/inclusion_check_v2.rs)."""

from __future__ import annotations

from ..chips.inclusion_check_v2 import InclusionCheckV2Chip, InclusionCheckV2Config
from ..plonkish import Circuit, Value


class InclusionCheckV2Circuit(Circuit):
    def __init__(self, F, usernames=None, balances=None, inclusion_index: int = 0, constant=None):
        self.F = F
        self.usernames = usernames or [Value.default()] * 10
        self.balances = balances or [Value.default()] * 10
        self.inclusion_index = inclusion_index
        self.constant = constant if constant is not None else F.zero()

    def without_witnesses(self):
        return InclusionCheckV2Circuit(self.F)

    @classmethod
    def configure(cls, meta) -> InclusionCheckV2Config:
        advice = [meta.advice_column() for _ in range(4)]
        instance = meta.instance_column()
        constant = meta.fixed_column()
        return InclusionCheckV2Chip.configure(meta, advice, instance, constant)

    def synthesize(self, config, layouter):
        chip = InclusionCheckV2Chip(config)
        user_acc_cell, balance_acc_cell = chip.assign_rows(
            layouter.namespace("init table"),
            self.usernames,
            self.balances,
            self.constant,
            self.inclusion_index,
        )
        chip.expose_public(layouter.namespace("expose public"), user_acc_cell, 0)
        chip.expose_public(layouter.namespace("expose public"), balance_acc_cell, 1)
