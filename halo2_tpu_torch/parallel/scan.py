"""The grand-product prefix scan across ranks (port of
halo2_tpu/parallel/scan.py).

The permutation and lookup arguments build z with z[0] = 1,
z[r + 1] = z[r] * num[r] / den[r].  Rows are split over the ``sp`` axis:
each rank takes a log-depth inclusive scan of ``mont_mul`` over its block
(Hillis-Steele doubling), the ranks ``all_gather`` the block totals, and
each folds the totals of the blocks before its own into its block; a last
``all_gather`` gives every rank the whole column.  Products of canonical
field elements do not depend on their order, so the limbs are the
reference's ``associative_scan``'s.
"""

from __future__ import annotations

import torch

from ..field.device import get_device_field
from . import comm
from .mesh import axis_index, axis_size


def _prefix_product_local(df, x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix product along the last axis of a ``(16, m)``
    tensor, in ceil(lg m) rounds of one multiply each."""
    d = 1
    while d < x.shape[-1]:
        x = torch.cat([x[:, :d], df.mul(x[:, d:], x[:, :-d])], dim=1)
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
    """The whole inclusive prefix product, given this rank's block."""
    pref = _prefix_product_local(df, local)
    totals = comm.all_gather(mesh, axis, pref[:, -1:].contiguous())  # (S, 16, 1)
    off = None
    for j in range(axis_index(mesh, axis)):
        off = totals[j] if off is None else df.mul(off, totals[j])
    if off is not None:
        pref = df.mul(pref, off)
    full = comm.all_gather(mesh, axis, pref)  # (S, 16, m)
    return full.permute(1, 0, 2).reshape(16, -1)


def sharded_prefix_product(mesh, spec, x: torch.Tensor, axis: str = "sp") -> torch.Tensor:
    """Inclusive prefix product over the rows of a replicated ``(16, n)``
    Montgomery tensor, split over ``axis``; every rank gets the whole
    result.  :func:`grand_product_z` is the exclusive form the prover
    takes."""
    df = get_device_field(spec)
    return _prefix_from_block(mesh, df, x[:, _block(mesh, axis, x.shape[-1])].contiguous(), axis)


def grand_product_z(mesh, spec, num: torch.Tensor, den: torch.Tensor, axis: str = "sp") -> torch.Tensor:
    """z[r] = prod_{i < r} num[i] / den[i], z[0] = 1, for replicated
    ``(16, n)`` Montgomery num and den; each rank inverts only its block of
    den (:meth:`DeviceField.inv`: one ``mont_inv`` launch)."""
    df = get_device_field(spec)
    rows = _block(mesh, axis, num.shape[-1])
    ratio = df.mul(num[:, rows].contiguous(), df.inv(den[:, rows].contiguous()))
    pref = _prefix_from_block(mesh, df, ratio, axis)
    return torch.cat([df.one_mont((1,), device=pref.device), pref[:, :-1]], dim=1)
