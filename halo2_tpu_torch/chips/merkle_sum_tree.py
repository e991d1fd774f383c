"""MerkleSumTreeChip — proof-of-solvency Merkle sum tree (experiment 12, flagship).

Re-design of reference src/chips/merkle_sum_tree.rs: 5 advice columns; gates —
bool (:62-66), dual swap for (hash, balance) pairs (:70-91), sum
``s*(lb + rb - computed_sum)`` (:94-100), and ``check == is_lt`` (:126-135).
Poseidon over 4 inputs (WIDTH=5, RATE=4, L=4 — :7-9) hashes
[left_hash, left_balance, right_hash, right_balance] per level (:288-300);
``enforce_less_than`` copies the running sum, pulls instance row 3 (total
assets), pins check=1 and runs the LtChip (:306-355).
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value
from ..poseidon.primitives import MySpec
from .lt import LtChip, LtConfig
from .poseidon.hash import PoseidonChip, PoseidonConfig

WIDTH = 5
RATE = 4
L = 4


@dataclasses.dataclass
class MerkleSumTreeConfig:
    advice: list
    bool_selector: object
    swap_selector: object
    sum_selector: object
    lt_selector: object
    instance: object
    poseidon_config: PoseidonConfig
    lt_config: LtConfig


class MerkleSumTreeChip:
    def __init__(self, config: MerkleSumTreeConfig, F):
        self.config = config
        self.F = F

    construct = classmethod(lambda cls, config, F: cls(config, F))

    @staticmethod
    def configure(meta, F, advice, instance) -> MerkleSumTreeConfig:
        col_a, col_b, col_c, col_d, col_e = advice
        bool_selector = meta.selector()
        swap_selector = meta.selector()
        sum_selector = meta.selector()
        lt_selector = meta.selector()

        for col in advice:
            meta.enable_equality(col)
        meta.enable_equality(instance)

        def bool_gate(m):
            s = m.query_selector(bool_selector)
            e = m.query_advice(col_e, Rotation.cur())
            return [s * e * (1 - e)]

        meta.create_gate("bool constraint", bool_gate)

        def swap_gate(m):
            s = m.query_selector(swap_selector)
            a = m.query_advice(col_a, Rotation.cur())
            b = m.query_advice(col_b, Rotation.cur())
            c = m.query_advice(col_c, Rotation.cur())
            d = m.query_advice(col_d, Rotation.cur())
            e = m.query_advice(col_e, Rotation.cur())
            l1 = m.query_advice(col_a, Rotation.next())
            l2 = m.query_advice(col_b, Rotation.next())
            r1 = m.query_advice(col_c, Rotation.next())
            r2 = m.query_advice(col_d, Rotation.next())
            return [
                s * (e * 2 * (c - a) - (l1 - a) - (c - r1)),
                s * (e * 2 * (d - b) - (l2 - b) - (d - r2)),
            ]

        meta.create_gate("swap constraint", swap_gate)

        def sum_gate(m):
            s = m.query_selector(sum_selector)
            left_balance = m.query_advice(col_b, Rotation.cur())
            right_balance = m.query_advice(col_d, Rotation.cur())
            computed_sum = m.query_advice(col_e, Rotation.cur())
            return [s * (left_balance + right_balance - computed_sum)]

        meta.create_gate("sum constraint", sum_gate)

        hash_inputs = [meta.advice_column() for _ in range(WIDTH)]
        poseidon_config = PoseidonChip.configure(meta, MySpec(WIDTH, RATE), F, hash_inputs)

        lt_config = LtChip.configure(
            meta,
            lambda m: m.query_selector(lt_selector),
            lambda m: m.query_advice(col_a, Rotation.cur()),
            lambda m: m.query_advice(col_b, Rotation.cur()),
            n_bytes=8,
        )

        config = MerkleSumTreeConfig(
            list(advice),
            bool_selector,
            swap_selector,
            sum_selector,
            lt_selector,
            instance,
            poseidon_config,
            lt_config,
        )

        def check_gate(m):
            q = m.query_selector(lt_selector)
            check = m.query_advice(col_c, Rotation.cur())
            return [q * (config.lt_config.is_lt(m) - check)]

        meta.create_gate(
            "verifies that `check` from current config equal to is_lt from LtChip ", check_gate
        )
        return config

    def assing_leaf_hash_and_balance(self, layouter, leaf_hash, leaf_balance):
        leaf_hash_cell = layouter.assign_region(
            "assign leaf hash",
            lambda region: region.assign_advice(
                "leaf hash", self.config.advice[0], 0, Value.known(leaf_hash)
            ),
        )
        leaf_balance_cell = layouter.assign_region(
            "assign leaf balance",
            lambda region: region.assign_advice(
                "leaf balance", self.config.advice[1], 0, Value.known(leaf_balance)
            ),
        )
        return leaf_hash_cell, leaf_balance_cell

    def merkle_prove_layer(
        self, layouter, prev_hash, prev_balance, element_hash, element_balance, index
    ):
        def closure(region):
            self.config.bool_selector.enable(region, 0)
            self.config.swap_selector.enable(region, 0)
            l1 = prev_hash.copy_advice(
                "copy hash cell from previous level", region, self.config.advice[0], 0
            )
            l2 = prev_balance.copy_advice(
                "copy balance cell from previous level", region, self.config.advice[1], 0
            )
            r1 = region.assign_advice(
                "assign element_hash", self.config.advice[2], 0, Value.known(element_hash)
            )
            r2 = region.assign_advice(
                "assign balance", self.config.advice[3], 0, Value.known(element_balance)
            )
            region.assign_advice("assign index", self.config.advice[4], 0, Value.known(index))

            l1_val, l2_val = l1.value(), l2.value()
            r1_val, r2_val = r1.value(), r2.value()

            self.config.sum_selector.enable(region, 1)

            if not index.is_zero():
                l1_val, l2_val, r1_val, r2_val = r1_val, r2_val, l1_val, l2_val

            left_hash = region.assign_advice(
                "assign left hash to be hashed", self.config.advice[0], 1, l1_val
            )
            left_balance = region.assign_advice(
                "assign left balance to be hashed", self.config.advice[1], 1, l2_val
            )
            right_hash = region.assign_advice(
                "assign right hash to be hashed", self.config.advice[2], 1, r1_val
            )
            right_balance = region.assign_advice(
                "assign right balance to be hashed", self.config.advice[3], 1, r2_val
            )
            computed_sum = left_balance.value() + right_balance.value()
            computed_sum_cell = region.assign_advice(
                "assign sum of left and right balance", self.config.advice[4], 1, computed_sum
            )
            return left_hash, left_balance, right_hash, right_balance, computed_sum_cell

        (left_hash, left_balance, right_hash, right_balance, computed_sum_cell) = (
            layouter.assign_region("merkle prove layer", closure)
        )

        poseidon_chip = PoseidonChip(
            self.config.poseidon_config, MySpec(WIDTH, RATE), L, self.F
        )
        computed_hash = poseidon_chip.hash(
            layouter.namespace("hash four child nodes"),
            [left_hash, left_balance, right_hash, right_balance],
        )
        return computed_hash, computed_sum_cell

    def enforce_less_than(self, layouter, prev_computed_sum_cell, computed_sum, total_assets):
        chip = LtChip(self.config.lt_config, self.F)
        chip.load(layouter)

        def closure(region):
            prev_computed_sum_cell.copy_advice(
                "copy computed sum", region, self.config.advice[0], 0
            )
            region.assign_advice_from_instance(
                "copy total assets", self.config.instance, 3, self.config.advice[1], 0
            )
            region.assign_advice("check", self.config.advice[2], 0, Value.known(self.F.from_u64(1)))
            self.config.lt_selector.enable(region, 0)
            chip.assign(region, 0, computed_sum, total_assets)

        layouter.assign_region("enforce sum to be less than total assets", closure)

    def expose_public(self, layouter, cell, row: int):
        layouter.constrain_instance(cell.cell(), self.config.instance, row)
