"""Experiment 11 — LtChip + Hash1Chip composition (reference src/circuits/less_than_v3.rs).

Same as v2 but `check` is pinned to 1 in synthesize (:102), so check=false
now FAILS; also drives Hash1Chip to demonstrate one Field bound serving both
gadget families (:112-116).
"""

from __future__ import annotations

import dataclasses

from ..chips.hash_v1 import Hash1Chip, Hash1Config
from ..chips.lt import LtChip, LtConfig
from ..plonkish import Circuit, Rotation, Value


@dataclasses.dataclass
class LessThanV3Config:
    q_enable: object
    value_l: object
    value_r: object
    check: object
    lt: LtConfig
    hash_config: Hash1Config


class LessThanV3Circuit(Circuit):
    def __init__(self, F, value_l: int = 0, value_r: int = 0, check: bool = False):
        self.F = F
        self.value_l = value_l
        self.value_r = value_r
        self.check = check

    def without_witnesses(self):
        return LessThanV3Circuit(self.F)

    @classmethod
    def configure(cls, meta) -> LessThanV3Config:
        q_enable = meta.complex_selector()
        value_l = meta.advice_column()
        value_r = meta.advice_column()
        check = meta.advice_column()
        instance = meta.instance_column()

        lt = LtChip.configure(
            meta,
            lambda m: m.query_selector(q_enable),
            lambda m: m.query_advice(value_l, Rotation.cur()),
            lambda m: m.query_advice(value_r, Rotation.cur()),
            n_bytes=8,
        )
        hash_config = Hash1Chip.configure(meta, [value_l, value_r], instance)
        config = LessThanV3Config(q_enable, value_l, value_r, check, lt, hash_config)

        def gate(m):
            q = m.query_selector(q_enable)
            check_e = m.query_advice(config.check, Rotation.cur())
            return [q * (config.lt.is_lt(m) - check_e)]

        meta.create_gate("verifies that `check` current confif = is_lt from LtChip ", gate)
        return config

    def synthesize(self, config, layouter):
        F = self.F
        lt_chip = LtChip(config.lt, F)
        lt_chip.load(layouter)
        hash_chip = Hash1Chip(config.hash_config, F)

        def closure(region):
            region.assign_advice(
                "value left", config.value_l, 0, Value.known(F.from_u64(self.value_l))
            )
            region.assign_advice(
                "value right", config.value_r, 0, Value.known(F.from_u64(self.value_r))
            )
            # check pinned to 1 regardless of self.check
            region.assign_advice("check", config.check, 0, Value.known(F.from_u64(1)))
            config.q_enable.enable(region, 0)
            lt_chip.assign(region, 0, F.from_u64(self.value_l), F.from_u64(self.value_r))

        layouter.assign_region("witness", closure)

        b = hash_chip.assign_advice_row(
            layouter.namespace("load row"), Value.known(F.from_u64(self.value_l))
        )
        hash_chip.expose_public(layouter.namespace("hash output check"), b, 0)
