"""MerkleTreeV1Chip — monolithic Merkle inclusion with dummy hash (experiment 5).

Re-design of reference src/chips/merkle_v1.rs: 3 gates — bool
``s*c*(1-c)`` (:52-56), swap ``s*(c*2*(b-a) - (l-a) - (b-r))`` with l,r at
Rotation::next (:61-73), hash ``s*(a+b-c)`` (:77-84); 2-row region per level
(:114-162): row0 = node/path/bit, row1 = left/right/digest.
"""

from __future__ import annotations

import dataclasses

from ..plonkish import Rotation, Value


@dataclasses.dataclass
class MerkleTreeV1Config:
    advice: list
    bool_selector: object
    swap_selector: object
    hash_selector: object
    instance: object


class MerkleTreeV1Chip:
    def __init__(self, config: MerkleTreeV1Config, F=None):
        self.config = config

    construct = classmethod(lambda cls, config, F=None: cls(config, F))

    @staticmethod
    def configure(meta, advice, instance) -> MerkleTreeV1Config:
        col_a, col_b, col_c = advice
        bool_selector = meta.selector()
        swap_selector = meta.selector()
        hash_selector = meta.selector()
        meta.enable_equality(col_c)
        meta.enable_equality(instance)
        meta.enable_equality(col_a)

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

        def hash_gate(m):
            s = m.query_selector(hash_selector)
            a = m.query_advice(col_a, Rotation.cur())
            b = m.query_advice(col_b, Rotation.cur())
            c = m.query_advice(col_c, Rotation.cur())
            return [s * (a + b - c)]

        meta.create_gate("hash constraint", hash_gate)

        return MerkleTreeV1Config(
            [col_a, col_b, col_c], bool_selector, swap_selector, hash_selector, instance
        )

    def assing_leaf(self, layouter, leaf: Value):
        # (sic) name preserved from reference merkle_v1.rs:95
        return layouter.assign_region(
            "assign leaf",
            lambda region: region.assign_advice("assign leaf", self.config.advice[0], 0, leaf),
        )

    def merkle_prove_layer(self, layouter, node_cell, path_element: Value, index: Value):
        def closure(region):
            self.config.bool_selector.enable(region, 0)
            self.config.swap_selector.enable(region, 0)
            node_cell.copy_advice(
                "prev node_cell copy constraint", region, self.config.advice[0], 0
            )
            region.assign_advice("assign path element", self.config.advice[1], 0, path_element)
            region.assign_advice("assign bit", self.config.advice[2], 0, index)

            self.config.hash_selector.enable(region, 1)
            input_l = node_cell.value()
            input_r = path_element
            idx = index.value()
            if idx is not None and not idx.is_zero():
                input_l, input_r = path_element, node_cell.value()

            region.assign_advice("input left", self.config.advice[0], 1, input_l)
            region.assign_advice("input right", self.config.advice[1], 1, input_r)
            return region.assign_advice("digest", self.config.advice[2], 1, input_l + input_r)

        return layouter.assign_region("merkle prove layer", closure)

    def expose_public(self, layouter, cell, row: int):
        layouter.constrain_instance(cell.cell(), self.config.instance, row)
