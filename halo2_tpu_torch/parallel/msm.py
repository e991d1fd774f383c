"""The MSM across ranks (port of halo2_tpu/parallel/msm.py).

Each rank runs the whole device Pippenger (:func:`..ec.device._msm_raw`,
the Horner combine included) over its 1/D of the points, giving one
Jacobian partial sum; a hypercube butterfly then sums the D partials:
log2(size) rounds per mesh axis, in the reference's order (``dp``, then
``sp``), each an :func:`.comm.exchange` with the rank whose coordinate
differs in one bit and one ``jac_add``.  In every round both ranks add the
lower coordinate's partial first, so they compute the same sum from the
same operands and every rank ends with the same Jacobian limbs: the
reference's device 0 (its ``jac_add(own, other)``), replicated.

The exchange is O(D) field elements against O(N / D) local bucket work.
"""

from __future__ import annotations

import math

import torch

from ..ec.device import _msm_raw, jac, jac_add
from . import comm
from .mesh import axis_index, axis_size


def sharded_msm(mesh, px, py, scalars_canonical, axes=("dp", "sp")):
    """MSM of replicated ``(16, N)`` inputs split over the mesh axes
    ``axes``: px, py affine Montgomery Fq, scalars canonical Fr limbs (or a
    batch ``(B, 16, N)`` of scalar sets over the same points), on this
    rank's device.  Returns the sum as a jac point ``(16,)`` (``(16, B)``),
    the same limbs on every rank.  N must divide over the ranks of
    ``axes``, and each axis size must be a power of two."""
    sizes = [axis_size(mesh, a) for a in axes]
    ranks = math.prod(sizes)
    n = px.shape[-1]
    if n % ranks:
        raise ValueError(f"sharded_msm: point count {n} must divide over {ranks} ranks")
    if any(size & (size - 1) for size in sizes):
        raise ValueError(f"sharded_msm: mesh axis sizes must be powers of two, got {sizes}")
    shard = 0
    for a, size in zip(axes, sizes):  # the first axis major, as P(None, axes)
        shard = shard * size + axis_index(mesh, a)
    m = n // ranks
    lo, hi = shard * m, (shard + 1) * m
    part = _msm_raw(px[:, lo:hi], py[:, lo:hi], scalars_canonical[..., lo:hi])
    for a, size in zip(axes, sizes):
        me, bit = axis_index(mesh, a), 1
        while bit < size:
            peer = me ^ bit
            got = comm.exchange(mesh, a, torch.stack([part["x"], part["y"], part["z"]]), peer)
            other = jac(got[0], got[1], got[2])
            part = jac_add(part, other) if me < peer else jac_add(other, part)
            bit <<= 1
    return part
