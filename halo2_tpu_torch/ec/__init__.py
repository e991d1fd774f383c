"""Curve arithmetic: a copy of the reference's host module (``host``), and the port's
device Jacobian ops and Pippenger MSM (``device``) with their CUDA group-law
kernels (``cuda_jac``)."""

from . import device, host
from .device import (
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
