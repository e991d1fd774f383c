"""KZG proving on torch tensors.  ``transcript``, ``queries``, ``expr_eval``,
``shplonk`` and ``verifier`` are copies of the reference's host modules; ``params``,
``keygen``, ``engine`` and ``prover`` are the port's."""

from .params import ParamsKZG
from .keygen import ProvingKey, VerifyingKey, keygen, keygen_pk, keygen_vk
from .prover import create_proof
from .verifier import verify_proof
from .transcript import Blake2bRead, Blake2bWrite

__all__ = [
    "ParamsKZG",
    "ProvingKey",
    "VerifyingKey",
    "keygen",
    "keygen_vk",
    "keygen_pk",
    "create_proof",
    "verify_proof",
    "Blake2bRead",
    "Blake2bWrite",
]
