"""Experiment 6 — MerkleTreeV2Circuit (reference src/circuits/merkle_v2.rs).

NOTE the reference drops the Result of the leaf expose_public (:34) — in this
port the call simply executes, which is the same observable behavior.
"""

from __future__ import annotations

from ..chips.merkle_v2 import MerkleTreeV2Chip, MerkleTreeV2Config
from ..plonkish import Circuit, Value


class MerkleTreeV2Circuit(Circuit):
    def __init__(self, F, leaf: Value = None, path_elements=None, path_indices=None):
        self.F = F
        self.leaf = leaf if leaf is not None else Value.unknown()
        self.path_elements = path_elements or []
        self.path_indices = path_indices or []

    def without_witnesses(self):
        return MerkleTreeV2Circuit(
            self.F,
            Value.unknown(),
            [Value.unknown()] * len(self.path_elements),
            [Value.unknown()] * len(self.path_indices),
        )

    @classmethod
    def configure(cls, meta) -> MerkleTreeV2Config:
        advice = [meta.advice_column() for _ in range(3)]
        instance = meta.instance_column()
        return MerkleTreeV2Chip.configure(meta, advice, instance)

    def synthesize(self, config, layouter):
        chip = MerkleTreeV2Chip(config)
        leaf_cell = chip.assing_leaf(layouter.namespace("assign leaf"), self.leaf)
        chip.expose_public(layouter.namespace("public leaf"), leaf_cell, 0)
        digest = chip.merkle_prove_layer(
            layouter.namespace("merkle_prove"),
            leaf_cell,
            self.path_elements[0],
            self.path_indices[0],
        )
        for i in range(1, len(self.path_elements)):
            digest = chip.merkle_prove_layer(
                layouter.namespace("next level"),
                digest,
                self.path_elements[i],
                self.path_indices[i],
            )
        chip.expose_public(layouter.namespace("public root"), digest, 1)
