"""The distributed four-step NTT (port of halo2_tpu/parallel/ntt.py).

The classic four-step decomposition of the size-n DFT over the same omega
as ``poly/domain.py``'s transform, so the result is the same, limb for limb:

  n = n1 * n2, the input viewed as M[i, jj] = x[i * n2 + jj], the columns
  jj split over the ``sp`` axis (this rank: n2 / S of them).
    1. local n1-point transforms down each column (root omega^n2);
    2. the twiddle multiply by omega^(jj * k1);
    3. an ``all_to_all``: column blocks -> row blocks (this rank: the rows
       k1 of its block, every column);
    4. local n2-point transforms along each row (root omega^n1),
  giving X[k1 + k2 * n1] = E[k1, k2].

The reference returns the rows sharded and transposes the global array; in
SPMD every rank ends with the whole result, so an ``all_gather`` of the
row blocks follows, and the inverse's n^-1 multiply is applied once, at
the end.  The local transforms are :func:`..poly.domain._ntt_unscaled` over
a ``(B, 16, n_i)`` batch of columns: the NTT kernels for n_i >= 512, the
``mont_mul``/``mod_add``/``mod_sub`` stage ladder below, with the twiddles
of the sub-size and no per-transform n_i^-1.  Any leading batch dims of
the input ride along (the prover's coset batch: one exchange for all its
columns).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..field.device import get_device_field
from ..field.params import FieldSpec
from ..poly.domain import _mul_columns, _n_inv, _ntt_unscaled
from . import comm
from .mesh import axis_index, axis_size


def _split(n: int) -> tuple[int, int]:
    """(n1, n2) with n1 = 2^ceil(lg n / 2), as the reference splits."""
    lg = n.bit_length() - 1
    n1 = 1 << ((lg + 1) // 2)
    return n1, n // n1


@functools.lru_cache(maxsize=None)
def _twiddle_block(spec: FieldSpec, n: int, inverse: bool, shards: int, shard: int, device: torch.device):
    """omega^(jj * k1) for the columns jj of block ``shard`` (of ``shards``)
    and every k1, as a Montgomery ``(16, n2 / shards, n1)`` tensor on
    ``device`` (the reference's twiddle matrix, transposed, one block)."""
    n1, n2 = _split(n)
    b = n2 // shards
    p = spec.p
    omega = pow(spec.root_of_unity, 1 << (spec.two_adicity - n.bit_length() + 1), p)
    if inverse:
        omega = pow(omega, -1, p)
    vals = []
    for jj in range(shard * b, (shard + 1) * b):
        w, v = pow(omega, jj, p), 1
        for _ in range(n1):
            vals.append(v)
            v = v * w % p
    arr = get_device_field(spec).encode_np(vals).reshape(16, b, n1)
    return torch.from_numpy(arr.view(np.int32)).to(device)


def sharded_ntt(mesh, spec: FieldSpec, x: torch.Tensor, inverse: bool = False, axis: str = "sp") -> torch.Tensor:
    """The NTT of a replicated ``(*lead, 16, n)`` Montgomery tensor (each
    column), split over ``axis``; every rank returns the whole result,
    equal limb for limb to ``poly.domain._ntt_raw(spec, n, inverse)``."""
    n = x.shape[-1]
    lead = x.shape[:-2]
    n1, n2 = _split(n)
    shards, s = axis_size(mesh, axis), axis_index(mesh, axis)
    if n1 % shards or n2 % shards:
        raise ValueError(f"sharded_ntt: n={n} too small for {shards}-way sharding")
    cols = math.prod(lead)
    b, r = n2 // shards, n1 // shards
    # 1. this rank's columns jj, as a batch of n1-point transforms over i
    m = x.reshape(cols, 16, n1, n2)[..., s * b : (s + 1) * b]
    t = _ntt_unscaled(spec, m.permute(0, 3, 1, 2).reshape(cols * b, 16, n1).contiguous(), inverse)
    # 2. twiddles, limbs leading: (cols, 16, b [jj], n1 [k1])
    t = t.reshape(cols, b, 16, n1).permute(0, 2, 1, 3).contiguous()
    t = _mul_columns(spec, t, _twiddle_block(spec, n, inverse, shards, s, x.device))
    # 3. block q of the rows k1 goes to rank q; block q received holds q's columns
    send = t.reshape(cols, 16, b, shards, r).permute(3, 0, 1, 2, 4)
    recv = comm.all_to_all(mesh, axis, send.contiguous())  # (shards [src], cols, 16, b, r)
    rows = recv.permute(1, 4, 2, 0, 3).reshape(cols * r, 16, n2)
    # 4. n2-point transforms along jj for each of this rank's rows k1
    e = _ntt_unscaled(spec, rows.contiguous(), inverse)
    e = e.reshape(cols, r, 16, n2).permute(0, 2, 1, 3).contiguous()  # (cols, 16, r [k1], n2 [k2])
    if inverse:
        e = _mul_columns(spec, e.reshape(cols, 16, r * n2), _n_inv(spec, n, x.device))
    # every rank's rows; X[k1 + k2 n1] = E[k1, k2]
    g = comm.all_gather(mesh, axis, e.reshape(cols, 16, r, n2))  # (shards, cols, 16, r, n2)
    return g.permute(1, 2, 4, 0, 3).reshape(*lead, 16, n)
