"""Experiment 1 — inclusion check circuit (reference src/circuits/inclusion_check.rs)."""

from __future__ import annotations

from ..chips.inclusion_check import InclusionCheckChip, InclusionCheckConfig
from ..plonkish import Circuit, Value


class InclusionCheckCircuit(Circuit):
    def __init__(self, F, usernames=None, balances=None, inclusion_index: int = 0):
        self.F = F
        self.usernames = usernames or [Value.default()] * 10
        self.balances = balances or [Value.default()] * 10
        self.inclusion_index = inclusion_index

    def without_witnesses(self):
        return InclusionCheckCircuit(self.F)

    @classmethod
    def configure(cls, meta) -> InclusionCheckConfig:
        col_username = meta.advice_column()
        col_balance = meta.advice_column()
        instance = meta.instance_column()
        return InclusionCheckChip.configure(meta, [col_username, col_balance], instance)

    def synthesize(self, config, layouter):
        chip = InclusionCheckChip(config)
        for i in range(len(self.usernames)):
            if i == self.inclusion_index:
                username_cell, balance_cell = chip.assign_inclusion_check_row(
                    layouter.namespace("inclusion row"),
                    self.usernames[i],
                    self.balances[i],
                )
                chip.expose_public(
                    layouter.namespace("expose public"), username_cell, balance_cell
                )
            else:
                chip.assign_generic_row(
                    layouter.namespace("generic row"), self.usernames[i], self.balances[i]
                )
