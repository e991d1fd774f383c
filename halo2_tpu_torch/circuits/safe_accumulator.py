"""Experiment 17 — SafeAccumulatorCircuit (reference src/circuits/safe_accumulator.rs).

MAX_BITS=4, ACC_COLS=4 (4 bits per column, 4 columns)."""

from __future__ import annotations

from ..chips.safe_accumulator import SafeACcumulatorChip, SafeAccumulatorConfig
from ..plonkish import Circuit, Value

MAX_BITS = 4
ACC_COLS = 4


class SafeAccumulatorCircuit(Circuit):
    def __init__(self, F, values=None, accumulated_value=None):
        self.F = F
        self.values = values or []
        self.accumulated_value = (
            accumulated_value
            if accumulated_value is not None
            else [Value.unknown()] * ACC_COLS
        )

    def without_witnesses(self):
        return SafeAccumulatorCircuit(self.F)

    @classmethod
    def configure(cls, meta) -> SafeAccumulatorConfig:
        new_value = meta.advice_column()
        left_most_acc_inv = meta.advice_column()
        carry_cols = [meta.advice_column() for _ in range(ACC_COLS)]
        acc_cols = [meta.advice_column() for _ in range(ACC_COLS)]
        add_selector = meta.selector()
        overflow_selector = meta.selector()
        boolean_selector = meta.selector()
        instance = meta.instance_column()
        return SafeACcumulatorChip.configure(
            meta,
            MAX_BITS,
            ACC_COLS,
            new_value,
            left_most_acc_inv,
            carry_cols,
            acc_cols,
            [boolean_selector, add_selector, overflow_selector],
            instance,
        )

    def synthesize(self, config, layouter):
        chip = SafeACcumulatorChip(config, self.F)
        assigned_cells, previous_accumulates = chip.assign(
            layouter.namespace("initial rows"), 0, self.values[0], self.accumulated_value
        )
        for i, v in enumerate(self.values[1:]):
            assigned_cells, latest = chip.assign(
                layouter.namespace("additional rows"), i, v, previous_accumulates
            )
            previous_accumulates = latest
        for i, cell in enumerate(reversed(assigned_cells)):
            chip.expose_public(layouter.namespace(f"accumulate_{i}"), cell, i)
