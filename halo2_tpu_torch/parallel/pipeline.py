"""The sharded prove-step demo (port of halo2_tpu/parallel/pipeline.py).

The production multi-rank prover is ``create_proof(..., mesh=)``
(:class:`..kzg.engine.ShardedEngine`).  This module keeps the reference's
fused demo of the phases that touch the row axis, each split over the mesh:

  * gate evaluation: every gate constraint on this rank's block of rows
    (one row-range ``vm_eval`` over the whole columns), the violation counts
    summed over ``sp`` with an ``all_gather``;
  * the iNTT of every advice column: :func:`.ntt.sharded_ntt`, one batch;
  * a commitment of each column: :func:`.msm.sharded_msm` over the mesh,
    the columns as one batch of scalar sets;
  * a grand product z with synthetic labels (num = adv0 + 1,
    den = adv1 + 1): :func:`.scan.grand_product_z`.

The reference jits the step over the mesh; here it runs eagerly on every
rank, and every output is replicated.
"""

from __future__ import annotations

import torch

from ..field.device import get_device_field
from ..plonkish.evaluator import Program, _run_program
from . import comm
from .mesh import axis_index, axis_size
from .msm import sharded_msm
from .ntt import sharded_ntt
from .scan import grand_product_z


def build_sharded_prove_step(mesh, cs, spec, n_points: int):
    """Returns ``step(columns, px, py) -> (violations, coeffs, commitments,
    z)`` over ``mesh``.

    ``columns`` is the evaluator's dict of (C, 16, n) Montgomery tensors
    (:func:`..plonkish.evaluator.encode_columns`) on this rank's device, the
    same on every rank; ``px, py`` the (16, n_points) SRS points there.
    Outputs: the violation count of each gate constraint (C,), the (A, 16,
    n) coefficients of the advice columns, their commitments as a jac dict
    of (A, 16) leaves (over the first n_points coefficients), and the
    (16, n) z column."""
    df = get_device_field(spec)
    prog = Program([c for gate in cs.gates for c in gate.constraints])

    def step(columns, px, py):
        adv = columns["advice"]
        n = adv.shape[-1]
        shards = axis_size(mesh, "sp")
        if n % shards:
            raise ValueError(f"{n} rows do not divide over {shards} ranks")
        m = n // shards
        outs = _run_program(prog, df, columns, rows=(axis_index(mesh, "sp") * m, m))  # (C, 16, m)
        local = (outs != 0).any(dim=1).sum(dim=-1).to(torch.int32)
        violations = comm.all_gather(mesh, "sp", local).sum(dim=0)

        coeffs = sharded_ntt(mesh, spec, adv, inverse=True, axis="sp")
        scalars = torch.stack([df.from_mont_arr(c)[:, :n_points] for c in coeffs.unbind(0)])
        pts = sharded_msm(mesh, px, py, scalars)  # one batch: (16, A) leaves
        commitments = {k: v.t().contiguous() for k, v in pts.items()}

        one = df.one_mont((n,), device=adv.device)
        num = df.add(adv[0], one)
        den = df.add(adv[1 % adv.shape[0]], one)
        z = grand_product_z(mesh, spec, num, den, axis="sp")
        return violations, coeffs, commitments, z

    return step
