"""Experiment 5 — MerkleTreeV1Circuit (reference src/circuits/merkle_v1.rs)."""

from __future__ import annotations

from ..chips.merkle_v1 import MerkleTreeV1Chip, MerkleTreeV1Config
from ..plonkish import Circuit, Value


class MerkleTreeV1Circuit(Circuit):
    def __init__(self, F, leaf: Value = None, path_elements=None, path_indices=None):
        self.F = F
        self.leaf = leaf if leaf is not None else Value.unknown()
        self.path_elements = path_elements or []
        self.path_indices = path_indices or []

    def without_witnesses(self):
        return MerkleTreeV1Circuit(
            self.F,
            Value.unknown(),
            [Value.unknown()] * len(self.path_elements),
            [Value.unknown()] * len(self.path_indices),
        )

    @classmethod
    def configure(cls, meta) -> MerkleTreeV1Config:
        advice = [meta.advice_column() for _ in range(3)]
        instance = meta.instance_column()
        return MerkleTreeV1Chip.configure(meta, advice, instance)

    def synthesize(self, config, layouter):
        chip = MerkleTreeV1Chip(config)
        leaf_cell = chip.assing_leaf(layouter.namespace("load leaf"), self.leaf)
        chip.expose_public(layouter.namespace("leaf"), leaf_cell, 0)
        digest = chip.merkle_prove_layer(
            layouter.namespace("level 0"), leaf_cell, self.path_elements[0], self.path_indices[0]
        )
        for i in range(1, len(self.path_elements)):
            digest = chip.merkle_prove_layer(
                layouter.namespace("next level"),
                digest,
                self.path_elements[i],
                self.path_indices[i],
            )
        chip.expose_public(layouter.namespace("root"), digest, 1)
