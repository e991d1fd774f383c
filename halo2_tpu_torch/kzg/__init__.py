"""KZG proving on torch tensors.  ``transcript``, ``queries``, ``expr_eval``,
``shplonk`` and ``verifier`` are the reference's host modules; ``params``,
``keygen``, ``engine`` and ``prover`` are the port's."""

from .._refpath import reference_dir

__path__.append(reference_dir("kzg"))

from .params import ParamsKZG  # noqa: E402
from .keygen import ProvingKey, VerifyingKey, keygen, keygen_pk, keygen_vk  # noqa: E402
from .prover import create_proof  # noqa: E402
from .verifier import verify_proof  # noqa: E402
from .transcript import Blake2bRead, Blake2bWrite  # noqa: E402

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
