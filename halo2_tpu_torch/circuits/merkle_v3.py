"""Experiment 8 — MerkleTreeV3Circuit (reference src/circuits/merkle_v3.rs).

Includes the host-side golden oracle compute_merkle_root (:72-87), which the
reference computes with P128Pow5T3 while the chip uses MySpec — identical
constants at width 3.
"""

from __future__ import annotations

from ..chips.merkle_v3 import MerkleTreeV3Chip, MerkleTreeV3Config
from ..plonkish import Circuit, Value
from ..poseidon.primitives import P128Pow5T3, poseidon_hash


def compute_merkle_root(F, leaf: int, elements: list, indices: list):
    digest = F.from_u64(leaf)
    spec = P128Pow5T3()
    for elem, idx in zip(elements, indices):
        if idx == 0:
            message = [digest, F.from_u64(elem)]
        else:
            message = [F.from_u64(elem), digest]
        digest = poseidon_hash(F, spec, message)
    return digest


class MerkleTreeV3Circuit(Circuit):
    def __init__(self, F, leaf: Value = None, path_elements=None, path_indices=None):
        self.F = F
        self.leaf = leaf if leaf is not None else Value.unknown()
        self.path_elements = path_elements or []
        self.path_indices = path_indices or []

    def without_witnesses(self):
        return MerkleTreeV3Circuit(
            self.F,
            Value.unknown(),
            [Value.unknown()] * len(self.path_elements),
            [Value.unknown()] * len(self.path_indices),
        )

    def configure_with(self, meta) -> MerkleTreeV3Config:
        advice = [meta.advice_column() for _ in range(3)]
        instance = meta.instance_column()
        return MerkleTreeV3Chip.configure(meta, self.F, advice, instance)

    def synthesize(self, config, layouter):
        chip = MerkleTreeV3Chip(config, self.F)
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
