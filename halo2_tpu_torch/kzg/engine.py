"""The torch prover engine (port of halo2_tpu/kzg/engine.py:DeviceEngine).

Engine polys are (16, m) int32 Montgomery tensors on the engine's device.
On a CUDA device every transform runs the NTT kernels and every field
multiply the Montgomery kernel; on the CPU the same calls run the kernels'
plain versions.  As in the reference's ``DeviceEngine``, grand products run
on the native C++ host engine, and so do commitments by default
(``commit="native"``): ``commit_batch`` fetches the whole batch in one copy
and hands it to the host Pippenger.  ``commit="device"`` (the reference's
``HALO2_TPU_COMMIT_BACKEND=device``) runs each commitment on the device
Pippenger instead, over the SRS uploaded once per (params, device).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..field.device import get_device_field
from ..field.params import BN254_FR
from ..plonkish.evaluator import _run_program
from .keygen import commit_coeffs_batch, to_host_limbs


class TorchEngine:
    """``create_proof``'s row-axis compute on torch tensors on ``device``."""

    name = "torch"

    def __init__(self, params, st, device, commit: str = "native"):
        if commit not in ("native", "device"):
            raise ValueError(f"commit must be 'native' or 'device', got {commit!r}")
        self.params = params
        self.st = st
        self.domain = st.domain
        self.device = torch.device(device)
        self.commit = commit
        self.dfr = get_device_field(BN254_FR)

    def _upload(self, limbs_u32: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(limbs_u32).view(np.int32)).to(self.device)

    # ---- poly construction
    def coeffs_from_values(self, vals):
        """Host ints (or a (n, 4) u64 canonical host poly) that are already
        coefficients -> engine poly."""
        if isinstance(vals, np.ndarray) and vals.dtype == np.uint64:
            return self._upload(native.unpack_device(native.to_mont(vals, "fr")))
        return self.dfr.encode(vals, device=self.device)

    def to_coeffs(self, vals):
        """Host Lagrange values -> coefficient-form engine poly (iNTT)."""
        return self.domain.lagrange_to_coeff(self.dfr.encode(vals, device=self.device))

    def pk_coeff(self, pk, which: str, i: int):
        """The pk's fixed/sigma coefficients, moved to the device once per
        (pk, device) and cached on the pk."""
        cache = getattr(pk, "_torch_coeffs", None)
        if cache is None:
            cache = {}
            pk._torch_coeffs = cache
        key = (which, self.device)
        if key not in cache:
            cache[key] = self._upload(pk.fixed_coeffs if which == "fixed" else pk.sigma_coeffs)
        return cache[key][i]

    # ---- transforms
    def coeff_to_extended(self, coeffs):
        return self.domain.coeff_to_extended(coeffs)

    def coeff_to_extended_many(self, coeffs_list):
        """Every column padded into one zeroed (C, 16, extended_n) tensor,
        then one batched coset scale and forward NTT: on the card, one
        gather and one kernel ladder for all C columns.  Returns the
        columns as views of the batch."""
        if not coeffs_list:
            return []
        padded = coeffs_list[0].new_zeros((len(coeffs_list), 16, self.domain.extended_n))
        for i, c in enumerate(coeffs_list):
            padded[i, :, : c.shape[-1]] = c
        return list(self.domain.coeff_to_extended(padded).unbind(0))

    def extended_to_coeff(self, epoly):
        return self.domain.extended_to_coeff(epoly)

    def slice_coeffs(self, coeffs, lo, hi):
        return coeffs[:, lo:hi]

    # ---- extended-domain helpers
    def epoly_from_values(self, vals):
        return self.dfr.encode(vals, device=self.device)

    def epoly_const(self, v):
        return self.dfr.encode([v], device=self.device).expand(16, self.domain.extended_n)

    def mul_ext(self, a, b):
        return self.dfr.mul(a, b)

    def vanishing_inv_extended(self):
        return self.domain.vanishing_inv_extended(self.device)

    def quotient_eval(self, columns_ext, combined_expr, rot_scale):
        """columns_ext: kind -> list of epolys.  Returns the numerator epoly
        of the structure's combined quotient expression."""
        assert combined_expr is self.st.combined_quotient(), (
            "TorchEngine.quotient_eval only evaluates st.combined_quotient()"
        )
        prog = self.st.quotient_program(rot_scale)
        return _run_program(prog, self.dfr, columns_ext)[0]

    def grand_product_z(self, num_ints, den_ints, carry: int):
        """z[0] = carry, z[r+1] = z[r] num[r] / den[r] on the native engine."""
        z = native.grand_product_fr(
            native.pack_ints([int(v) for v in num_ints]),
            native.pack_ints([int(v) for v in den_ints]),
            carry,
        )
        return native.unpack_ints(z)

    # ---- commitments / decode
    def commit_batch(self, coeffs_list):
        if not coeffs_list:
            return []
        return commit_coeffs_batch(self.params, coeffs_list, backend=self.commit)

    def decode_many(self, polys):
        """Engine polys -> (m, 4) u64 canonical host polys (the native
        engine's host-poly convention, which ``create_proof`` takes), in one
        device -> host copy."""
        if not polys:
            return []
        limbs = to_host_limbs(polys)  # (M, 16, m)
        n_polys, _, m = limbs.shape
        packed = native.pack_device(np.moveaxis(limbs, 1, 0).reshape(16, -1))
        return list(native.from_mont(packed, "fr").reshape(n_polys, m, 4))
