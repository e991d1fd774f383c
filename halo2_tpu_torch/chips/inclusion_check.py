"""InclusionCheckChip — copy-constraint-only inclusion proof (experiment 1).

Re-design of reference src/chips/inclusion_check.rs: proves a
(username, balance) row exists at a chosen index using only equality
constraints to the instance column — no gate, no selector
(inclusion_check.rs:24-43 configure, :45-62 generic row, :64-87 inclusion
row, :89-101 expose_public).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class InclusionCheckConfig:
    advice: list  # [col_username, col_balance]
    instance: object


class InclusionCheckChip:
    def __init__(self, config: InclusionCheckConfig, F=None):
        self.config = config

    construct = classmethod(lambda cls, config, F=None: cls(config, F))

    @staticmethod
    def configure(meta, advice, instance) -> InclusionCheckConfig:
        col_username, col_balance = advice
        meta.enable_equality(col_username)
        meta.enable_equality(col_balance)
        meta.enable_equality(instance)
        return InclusionCheckConfig([col_username, col_balance], instance)

    def assign_generic_row(self, layouter, username, balance):
        def closure(region):
            region.assign_advice("username", self.config.advice[0], 0, username)
            region.assign_advice("balance", self.config.advice[1], 0, balance)

        return layouter.assign_region("generic row", closure)

    def assign_inclusion_check_row(self, layouter, username, balance):
        def closure(region):
            username_cell = region.assign_advice(
                "username", self.config.advice[0], 0, username
            )
            balance_cell = region.assign_advice(
                "balance", self.config.advice[1], 0, balance
            )
            return username_cell, balance_cell

        return layouter.assign_region("inclusion row", closure)

    def expose_public(self, layouter, public_username_cell, public_balance_cell):
        layouter.constrain_instance(public_username_cell.cell(), self.config.instance, 0)
        layouter.constrain_instance(public_balance_cell.cell(), self.config.instance, 1)
