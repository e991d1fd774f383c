"""Experiment 10 — LtChip comparison circuit (reference src/circuits/less_than_v2.rs).

Gate ``q * (is_lt - check)`` (:53-63); `check` is a free witness, so
check=false with lhs>rhs is VALID (contrast v3).
"""

from __future__ import annotations

import dataclasses

from ..chips.lt import LtChip, LtConfig
from ..plonkish import Circuit, Rotation, Value


@dataclasses.dataclass
class LessThanV2Config:
    q_enable: object
    value_l: object
    value_r: object
    check: object
    lt: LtConfig


class LessThanV2Circuit(Circuit):
    def __init__(self, F, value_l: int = 0, value_r: int = 0, check: bool = False):
        self.F = F
        self.value_l = value_l
        self.value_r = value_r
        self.check = check

    def without_witnesses(self):
        return LessThanV2Circuit(self.F)

    @classmethod
    def configure(cls, meta) -> LessThanV2Config:
        q_enable = meta.complex_selector()
        value_l = meta.advice_column()
        value_r = meta.advice_column()
        check = meta.advice_column()

        lt = LtChip.configure(
            meta,
            lambda m: m.query_selector(q_enable),
            lambda m: m.query_advice(value_l, Rotation.cur()),
            lambda m: m.query_advice(value_r, Rotation.cur()),
            n_bytes=8,
        )
        config = LessThanV2Config(q_enable, value_l, value_r, check, lt)

        def gate(m):
            q = m.query_selector(q_enable)
            check_e = m.query_advice(config.check, Rotation.cur())
            return [q * (config.lt.is_lt(m) - check_e)]

        meta.create_gate("verifies that `check` current confif = is_lt from LtChip ", gate)
        return config

    def synthesize(self, config, layouter):
        F = self.F
        chip = LtChip(config.lt, F)
        chip.load(layouter)

        def closure(region):
            region.assign_advice(
                "value left", config.value_l, 0, Value.known(F.from_u64(self.value_l))
            )
            region.assign_advice(
                "value right", config.value_r, 0, Value.known(F.from_u64(self.value_r))
            )
            region.assign_advice(
                "check", config.check, 0, Value.known(F.from_u64(1 if self.check else 0))
            )
            config.q_enable.enable(region, 0)
            chip.assign(region, 0, F.from_u64(self.value_l), F.from_u64(self.value_r))

        layouter.assign_region("witness", closure)
