"""Curve arithmetic: the reference's host module.  The device Jacobian ops and
the Pippenger MSM (``ec/device.py``, ``ec/pallas_jac.py``) are not ported yet;
commitments go to the native host MSM."""

from .._refpath import reference_dir

__path__.append(reference_dir("ec"))

from . import host  # noqa: E402

__all__ = ["host"]
