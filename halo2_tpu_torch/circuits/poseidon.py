"""Experiment 7 — PoseidonCircuit (reference src/circuits/poseidon.rs)."""

from __future__ import annotations

from ..chips.poseidon.hash_with_instance import PoseidonChip, PoseidonConfig
from ..plonkish import Circuit, Value
from ..poseidon.primitives import Spec


class PoseidonCircuit(Circuit):
    def __init__(self, F, spec: Spec, L: int, hash_input=None, digest: Value = None):
        self.F = F
        self.spec = spec
        self.L = L
        self.hash_input = (
            hash_input if hash_input is not None else [Value.unknown()] * L
        )
        self.digest = digest if digest is not None else Value.unknown()

    def without_witnesses(self):
        return PoseidonCircuit(self.F, self.spec, self.L)

    def configure_with(self, meta) -> PoseidonConfig:
        instance = meta.instance_column()
        hash_inputs = [meta.advice_column() for _ in range(self.spec.width)]
        return PoseidonChip.configure(meta, self.spec, self.F, hash_inputs, instance)

    # configure needs spec/F/L, which live on the instance; run_synthesis calls
    # type(circuit).configure(cs) — route through a per-instance hook
    @classmethod
    def configure(cls, meta):
        raise NotImplementedError("use MockProver/run_synthesis with instance configure")

    def synthesize(self, config, layouter):
        chip = PoseidonChip(config, self.spec, self.L, self.F)
        assigned_input_cells = chip.load_private_inputs(
            layouter.namespace("load private inputs"), self.hash_input
        )
        digest = chip.hash(layouter.namespace("poseidon chip"), assigned_input_cells)
        chip.expose_public(layouter.namespace("expose result"), digest, 0)
