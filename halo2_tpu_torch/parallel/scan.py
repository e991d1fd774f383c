"""The grand-product prefix scan across ranks (port of
halo2_tpu/parallel/scan.py).

The permutation and lookup arguments build z with z[0] = 1,
z[r + 1] = z[r] * num[r] / den[r].  Rows are split over the ``sp`` axis:
each rank takes a log-depth inclusive scan of ``mont_mul`` over its block
(Hillis-Steele doubling), the ranks ``all_gather`` the block totals, and
each folds the totals of the blocks before its own into its block; a last
``all_gather`` gives every rank the whole column.  Products of canonical
field elements do not depend on their order, so the limbs are the
reference's ``associative_scan``'s.  A batch of C columns, ``(16, C, n)``,
runs every step once for all of them (one ``mont_inv`` launch over C
blocks of denominators, one product a scan round), each column's limbs
those of its scan alone.
"""

from __future__ import annotations

import torch

from ..field.device import get_device_field
from . import comm
from .mesh import axis_index, axis_size

# The shape of each grand_product_z call's num, in call order: a sharded
# prove makes one call for its permutation chunks and one for its lookups
# (parallel.jobs clears and reads it around each prove).
GRAND_PRODUCT_CALLS: list = []


def _prefix_product_local(df, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along the last axis of a ``(16, m)`` or
    ``(16, C, m)`` tensor, in ceil(lg m) rounds of one multiply each."""
    d = 1
    while d < x.shape[-1]:
        x = torch.cat([x[..., :d], df.mul(x[..., d:], x[..., :-d])], dim=-1)
        d *= 2
    return x


def _block(mesh, axis: str, n: int) -> slice:
    shards = axis_size(mesh, axis)
    if n % shards:
        raise ValueError(f"{n} rows do not divide over {shards} ranks")
    m = n // shards
    s = axis_index(mesh, axis)
    return slice(s * m, (s + 1) * m)


def _prefix_from_block(mesh, df, local: torch.Tensor, axis: str) -> torch.Tensor:
    """The whole inclusive prefix product of each column, given this rank's
    block (``(16, m)`` or ``(16, C, m)``)."""
    pref = _prefix_product_local(df, local)
    totals = comm.all_gather(mesh, axis, pref[..., -1:].contiguous())  # (S, 16, [C,] 1)
    off = None
    for j in range(axis_index(mesh, axis)):
        off = totals[j] if off is None else df.mul(off, totals[j])
    if off is not None:
        pref = df.mul(pref, off)
    full = comm.all_gather(mesh, axis, pref)  # (S, 16, [C,] m)
    return full.movedim(0, -2).reshape(*pref.shape[:-1], -1)


def sharded_prefix_product(mesh, spec, x: torch.Tensor, axis: str = "sp") -> torch.Tensor:
    """Inclusive prefix product over the rows of a replicated ``(16, n)``
    Montgomery tensor, split over ``axis``; every rank gets the whole
    result.  :func:`grand_product_z` is the exclusive form the prover
    takes."""
    df = get_device_field(spec)
    return _prefix_from_block(mesh, df, x[:, _block(mesh, axis, x.shape[-1])].contiguous(), axis)


def grand_product_z(mesh, spec, num: torch.Tensor, den: torch.Tensor, axis: str = "sp") -> torch.Tensor:
    """z[r] = prod_{i < r} num[i] / den[i], z[0] = 1, for replicated
    ``(16, n)`` Montgomery num and den, or for each column of a ``(16, C,
    n)`` batch; each rank inverts only its block of den, every column's at
    once (:meth:`DeviceField.inv`: one ``mont_inv`` launch)."""
    if num.shape != den.shape or num.dim() not in (2, 3):
        raise ValueError(f"grand_product_z: num and den must be one (16, n) or (16, C, n) shape, "
                         f"got {tuple(num.shape)} and {tuple(den.shape)}")
    GRAND_PRODUCT_CALLS.append(tuple(num.shape))
    df = get_device_field(spec)
    rows = _block(mesh, axis, num.shape[-1])
    ratio = df.mul(num[..., rows].contiguous(), df.inv(den[..., rows].contiguous()))
    pref = _prefix_from_block(mesh, df, ratio, axis)
    return torch.cat([df.one_mont((*pref.shape[1:-1], 1), device=pref.device), pref[..., :-1]], dim=-1)
