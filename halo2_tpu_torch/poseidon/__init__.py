"""Poseidon: a copy of the reference's grain constants, the host sponge and the batched
device sponge (``permute_device``/``hash_device``: one ``poseidon_hash`` kernel launch
on the card, the plain versions on the CPU) on torch tensors."""

from .grain import Grain, generate_constants
from .primitives import (
    ConstantLength,
    Hash,
    MySpec,
    P128Pow5T3,
    Spec,
    hash_device,
    hash_device_plain,
    permute,
    permute_device,
    permute_device_plain,
    poseidon_hash,
)

__all__ = [
    "Grain",
    "generate_constants",
    "ConstantLength",
    "Hash",
    "MySpec",
    "P128Pow5T3",
    "Spec",
    "hash_device",
    "hash_device_plain",
    "permute",
    "permute_device",
    "permute_device_plain",
    "poseidon_hash",
]
