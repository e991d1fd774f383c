"""Curve arithmetic: the reference's host module (``host``), and the port's
device Jacobian ops and Pippenger MSM (``device``) with their CUDA group-law
kernels (``cuda_jac``)."""

from .._refpath import reference_dir

__path__.append(reference_dir("ec"))

from . import device, host  # noqa: E402
from .device import (  # noqa: E402
    is_infinity,
    jac,
    jac_add,
    jac_double,
    jac_from_affine,
    jac_infinity,
    jac_neg,
    jac_to_affine,
    msm,
    msm_points,
    scalar_mul_batched,
)

__all__ = [
    "device",
    "host",
    "jac",
    "jac_add",
    "jac_double",
    "jac_from_affine",
    "jac_infinity",
    "jac_neg",
    "jac_to_affine",
    "is_infinity",
    "msm",
    "msm_points",
    "scalar_mul_batched",
]
