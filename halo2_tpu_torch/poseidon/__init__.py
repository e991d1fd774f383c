"""Poseidon: the reference's grain constants and the host sponge.  The batched
device sponge (``permute_device``/``hash_device``) is not ported yet."""

from .._refpath import reference_dir

__path__.append(reference_dir("poseidon"))

from .grain import Grain, generate_constants  # noqa: E402
from .primitives import (  # noqa: E402
    ConstantLength,
    Hash,
    MySpec,
    P128Pow5T3,
    Spec,
    permute,
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
    "permute",
    "poseidon_hash",
]
