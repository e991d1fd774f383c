"""MerkleTreeV3Chip — Merkle inclusion with real Poseidon (experiment 8).

Re-design of reference src/chips/merkle_v3.rs: WIDTH=3, RATE=2, L=2 (:5-7);
bool/swap gates (:47-68); 2-row swap region (:104-148); digest via
``poseidon_chip.hash([left, right])`` (:151-161).
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value
from ..poseidon.primitives import MySpec
from .poseidon.hash import PoseidonChip, PoseidonConfig

WIDTH = 3
RATE = 2
L = 2


@dataclasses.dataclass
class MerkleTreeV3Config:
    advice: list
    bool_selector: object
    swap_selector: object
    instance: object
    poseidon_config: PoseidonConfig


class MerkleTreeV3Chip:
    def __init__(self, config: MerkleTreeV3Config, F):
        self.config = config
        self.F = F

    construct = classmethod(lambda cls, config, F: cls(config, F))

    @staticmethod
    def configure(meta, F, advice, instance) -> MerkleTreeV3Config:
        col_a, col_b, col_c = advice
        bool_selector = meta.selector()
        swap_selector = meta.selector()
        meta.enable_equality(col_a)
        meta.enable_equality(col_b)
        meta.enable_equality(col_c)
        meta.enable_equality(instance)

        def bool_gate(m):
            s = m.query_selector(bool_selector)
            c = m.query_advice(col_c, Rotation.cur())
            return [s * c * (1 - c)]

        meta.create_gate("bool constraint", bool_gate)

        def swap_gate(m):
            s = m.query_selector(swap_selector)
            a = m.query_advice(col_a, Rotation.cur())
            b = m.query_advice(col_b, Rotation.cur())
            c = m.query_advice(col_c, Rotation.cur())
            l = m.query_advice(col_a, Rotation.next())
            r = m.query_advice(col_b, Rotation.next())
            return [s * (c * 2 * (b - a) - (l - a) - (b - r))]

        meta.create_gate("swap constraint", swap_gate)

        hash_inputs = [meta.advice_column() for _ in range(WIDTH)]
        poseidon_config = PoseidonChip.configure(meta, MySpec(WIDTH, RATE), F, hash_inputs)

        return MerkleTreeV3Config(
            [col_a, col_b, col_c], bool_selector, swap_selector, instance, poseidon_config
        )

    def assing_leaf(self, layouter, leaf: Value):
        return layouter.assign_region(
            "assign leaf",
            lambda region: region.assign_advice("assign leaf", self.config.advice[0], 0, leaf),
        )

    def merkle_prove_layer(self, layouter, node_cell, path_element: Value, index: Value):
        def closure(region):
            self.config.bool_selector.enable(region, 0)
            self.config.swap_selector.enable(region, 0)
            node_cell.copy_advice(
                "copy node cell from previous prove layer", region, self.config.advice[0], 0
            )
            region.assign_advice("assign element", self.config.advice[1], 0, path_element)
            region.assign_advice("assign index", self.config.advice[2], 0, index)

            l, r = node_cell.value(), path_element
            idx = index.value()
            if idx is not None and not idx.is_zero():
                l, r = r, l
            left = region.assign_advice("assign left to be hashed", self.config.advice[0], 1, l)
            right = region.assign_advice("assign right to be hashed", self.config.advice[1], 1, r)
            return left, right

        left, right = layouter.assign_region("merkle prove layer", closure)
        poseidon_chip = PoseidonChip(
            self.config.poseidon_config, MySpec(WIDTH, RATE), L, self.F
        )
        return poseidon_chip.hash(layouter.namespace("hash row constaint"), [left, right])

    def expose_public(self, layouter, cell, row: int):
        layouter.constrain_instance(cell.cell(), self.config.instance, row)
