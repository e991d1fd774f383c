"""Field arithmetic: copies of the reference's host modules (``params``, ``host``) plus
the torch :class:`DeviceField` and its CUDA Montgomery multiply."""

from .params import (
    FieldSpec,
    LIMB_BITS,
    NUM_LIMBS,
    PASTA_FP,
    PASTA_FQ,
    BN254_FR,
    BN254_FQ,
    SPECS,
    to_limbs,
    from_limbs,
)
from .host import PrimeField, field_class, Fp, Fr, Fq, Fq_pasta
from .device import DeviceField, get_device_field

__all__ = [
    "FieldSpec",
    "LIMB_BITS",
    "NUM_LIMBS",
    "PASTA_FP",
    "PASTA_FQ",
    "BN254_FR",
    "BN254_FQ",
    "SPECS",
    "to_limbs",
    "from_limbs",
    "PrimeField",
    "field_class",
    "Fp",
    "Fr",
    "Fq",
    "Fq_pasta",
    "DeviceField",
    "get_device_field",
]
