"""InclusionCheckV2Chip — accumulator-based inclusion proof (experiment 2).

Re-design of reference src/chips/inclusion_check_v2.rs: two accumulator
columns carry the selected row's values to the last row.  Gate
``s * (value + prev_acc - acc)`` for both username and balance
(inclusion_check_v2.rs:55-73); first row seeded from a constant fixed column
via assign_advice_from_constant (:104-116); non-selected rows copy_advice the
running accumulator (:168-180).
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation


@dataclasses.dataclass
class InclusionCheckV2Config:
    advice: list  # [username, balance, username_acc, balance_acc]
    selector: object
    instance: object
    constant: object


class InclusionCheckV2Chip:
    def __init__(self, config: InclusionCheckV2Config, F=None):
        self.config = config

    construct = classmethod(lambda cls, config, F=None: cls(config, F))

    @staticmethod
    def configure(meta, advice, instance, constant) -> InclusionCheckV2Config:
        username_column, balance_column, username_acc_column, balance_acc_column = advice
        selector = meta.selector()
        meta.enable_equality(username_acc_column)
        meta.enable_equality(balance_acc_column)
        meta.enable_constant(constant)
        meta.enable_equality(instance)

        def gate(m):
            s = m.query_selector(selector)
            username = m.query_advice(username_column, Rotation.cur())
            username_acc = m.query_advice(username_acc_column, Rotation.cur())
            prev_username_acc = m.query_advice(username_acc_column, Rotation.prev())
            balance = m.query_advice(balance_column, Rotation.cur())
            balance_acc = m.query_advice(balance_acc_column, Rotation.cur())
            prev_balance_acc = m.query_advice(balance_acc_column, Rotation.prev())
            return [
                s * (username + prev_username_acc - username_acc),
                s * (balance + prev_balance_acc - balance_acc),
            ]

        meta.create_gate("accumulator constraint", gate)
        return InclusionCheckV2Config(list(advice), selector, instance, constant)

    def assign_rows(self, layouter, usernames, balances, constant, inclusion_index):
        def closure(region):
            username_acc_cell = region.assign_advice_from_constant(
                "username accumulator init", self.config.advice[2], 0, constant
            )
            balance_acc_cell = region.assign_advice_from_constant(
                "balance accumulator init", self.config.advice[3], 0, constant
            )
            for i in range(len(usernames)):
                if i == inclusion_index:
                    self.config.selector.enable(region, i + 1)
                    region.assign_advice("username", self.config.advice[0], i + 1, usernames[i])
                    region.assign_advice("balance", self.config.advice[1], i + 1, balances[i])
                    username_acc_cell = region.assign_advice(
                        "username accumulator", self.config.advice[2], i + 1, usernames[i]
                    )
                    balance_acc_cell = region.assign_advice(
                        "balance accumulator", self.config.advice[3], i + 1, balances[i]
                    )
                else:
                    region.assign_advice("username", self.config.advice[0], i + 1, usernames[i])
                    region.assign_advice("balance", self.config.advice[1], i + 1, balances[i])
                    username_acc_cell = username_acc_cell.copy_advice(
                        "copy username acc cell from prev row",
                        region,
                        self.config.advice[2],
                        i + 1,
                    )
                    balance_acc_cell = balance_acc_cell.copy_advice(
                        "copy balance acc cell from prev row",
                        region,
                        self.config.advice[3],
                        i + 1,
                    )
            return username_acc_cell, balance_acc_cell

        return layouter.assign_region("user and balance table", closure)

    def expose_public(self, layouter, cell, row: int):
        layouter.constrain_instance(cell.cell(), self.config.instance, row)
