"""Experiment 12 — MerkleSumTreeCircuit (reference src/circuits/merkle_sum_tree.rs).

Includes the host-side oracle compute_merkle_sum_root (:121-150) used to build
instance values for the tests and benchmarks.
"""

from __future__ import annotations

import dataclasses

from ..chips.merkle_sum_tree import RATE, WIDTH, MerkleSumTreeChip, MerkleSumTreeConfig
from ..plonkish import Circuit
from ..poseidon.primitives import MySpec, poseidon_hash


@dataclasses.dataclass
class Node:
    hash: object
    balance: object


def compute_merkle_sum_root(F, node: Node, elements: list, indices: list) -> Node:
    digest = Node(node.hash, node.balance)
    spec = MySpec(WIDTH, RATE)
    for elem, idx in zip(elements, indices):
        if int(idx) == 0:
            message = [digest.hash, digest.balance, elem.hash, elem.balance]
        else:
            message = [elem.hash, elem.balance, digest.hash, digest.balance]
        digest.hash = poseidon_hash(F, spec, message)
        digest.balance = digest.balance + elem.balance
    return digest


class MerkleSumTreeCircuit(Circuit):
    def __init__(
        self,
        F,
        leaf_hash=None,
        leaf_balance=None,
        path_element_hashes=None,
        path_element_balances=None,
        path_indices=None,
        assets_sum=None,
    ):
        self.F = F
        self.leaf_hash = leaf_hash if leaf_hash is not None else F.zero()
        self.leaf_balance = leaf_balance if leaf_balance is not None else F.zero()
        self.path_element_hashes = path_element_hashes or []
        self.path_element_balances = path_element_balances or []
        self.path_indices = path_indices or []
        self.assets_sum = assets_sum if assets_sum is not None else F.zero()

    def without_witnesses(self):
        F = self.F
        return MerkleSumTreeCircuit(
            F,
            F.zero(),
            F.zero(),
            [F.zero()] * len(self.path_element_hashes),
            [F.zero()] * len(self.path_element_balances),
            [F.zero()] * len(self.path_indices),
            F.zero(),
        )

    def configure_with(self, meta) -> MerkleSumTreeConfig:
        advice = [meta.advice_column() for _ in range(5)]
        instance = meta.instance_column()
        return MerkleSumTreeChip.configure(meta, self.F, advice, instance)

    def synthesize(self, config, layouter):
        chip = MerkleSumTreeChip(config, self.F)
        leaf_hash, leaf_balance = chip.assing_leaf_hash_and_balance(
            layouter.namespace("assign leaf"), self.leaf_hash, self.leaf_balance
        )
        chip.expose_public(layouter.namespace("public leaf hash"), leaf_hash, 0)
        chip.expose_public(layouter.namespace("public leaf balance"), leaf_balance, 1)

        next_hash, next_sum = chip.merkle_prove_layer(
            layouter.namespace("level 0 merkle proof"),
            leaf_hash,
            leaf_balance,
            self.path_element_hashes[0],
            self.path_element_balances[0],
            self.path_indices[0],
        )
        for i in range(1, len(self.path_element_balances)):
            next_hash, next_sum = chip.merkle_prove_layer(
                layouter.namespace(f"level {i} merkle proof"),
                next_hash,
                next_sum,
                self.path_element_hashes[i],
                self.path_element_balances[i],
                self.path_indices[i],
            )

        computed_sum = self.leaf_balance
        for x in self.path_element_balances:
            computed_sum = computed_sum + x

        chip.enforce_less_than(
            layouter.namespace("enforce less than"), next_sum, computed_sum, self.assets_sum
        )
        chip.expose_public(layouter.namespace("public root"), next_hash, 2)
