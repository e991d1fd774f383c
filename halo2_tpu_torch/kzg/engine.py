"""The prover engines of ``create_proof`` (port of halo2_tpu/kzg/engine.py).

Two interchangeable engines give the same proof bytes for the same rng:

* :class:`TorchEngine` (the reference's ``DeviceEngine``): engine polys are
  (16, m) int32 Montgomery tensors on the engine's device.  On a CUDA device
  every transform runs the NTT kernels and every field multiply the
  Montgomery kernel; on the CPU the same calls run the kernels' plain
  versions.  As in the reference, grand products run on the native C++ host
  engine, and so do commitments by default (``commit="native"``):
  ``commit_batch`` fetches the whole batch in one copy and hands it to the
  host Pippenger.  ``commit="device"`` (the reference's
  ``HALO2_TPU_COMMIT_BACKEND=device``) runs each commitment on the device
  Pippenger instead, over the SRS uploaded once per (params, device).
* :class:`NativeEngine` (carried over verbatim): the C++ host engine of
  ``..native``; engine polys are (m, 4) uint64 canonical numpy arrays, and
  nothing runs on a device.
* :class:`ShardedEngine` (``create_proof(..., mesh=)``): TorchEngine's
  polys, with every row-axis phase split over the ranks of a mesh through
  ``..parallel``.

:func:`select_engine` chooses between them as the reference does, with the
reference's environment variables as arguments.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native
from .._device import resolve_device
from ..ec import host as ec
from ..field.device import get_device_field
from ..field.params import BN254_FR
from ..plonkish.evaluator import _run_program
from .keygen import _device_srs, commit_coeffs_batch, to_host_limbs

P = BN254_FR.p

# engine="auto" proves on NativeEngine at or below this many extended-domain
# points, on TorchEngine above (the reference's HALO2_TPU_DEVICE_MIN_EXT).
# On one H100 (700 W) and its host, TorchEngine's warm flagship proves were
# faster at both sizes measured, 2^15 and 2^17 (python -m
# halo2_tpu_torch.crossover, PERF.md), so the bound sits below the smallest.
DEVICE_MIN_EXT = 1 << 14


def select_engine(params, st, device=None, engine: str = "auto", commit: str = "native", min_ext: int = DEVICE_MIN_EXT):
    """The engine for proving over ``st`` (a PlonkStructure).

    ``engine="torch"``: :class:`TorchEngine` on ``device`` (the CUDA device
    when None) with commitments where ``commit`` says; ``"native"``:
    :class:`NativeEngine`, which needs the native engine's compiler and no
    card; ``"auto"``: the reference's rule, native when the native engine is
    available and the extended domain has at most ``min_ext`` points, torch
    otherwise.  NativeEngine always commits on the host Pippenger."""
    if commit not in ("native", "device"):
        raise ValueError(f"commit must be 'native' or 'device', got {commit!r}")
    if engine not in ("torch", "native", "auto"):
        raise ValueError(f"engine must be 'torch', 'native' or 'auto', got {engine!r}")
    if engine == "native" and not native.available():
        raise RuntimeError("engine='native' but the native engine has no compiler")
    if engine == "native" or (engine == "auto" and native.available() and st.domain.extended_n <= min_ext):
        return NativeEngine(params, st)
    return TorchEngine(params, st, resolve_device(device), commit=commit)


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
        return _grand_product_fallback(num_ints, den_ints, carry)

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


# ===================================================================== sharded
class ShardedEngine(TorchEngine):
    """The prover's row-axis phases split over the ranks of a ``(dp, sp)``
    mesh (:mod:`..parallel`), SPMD: every rank proves with the same
    arguments, holds every engine poly whole on its own device, computes its
    share of each phase, exchanges, and ends with the single-device proof
    bytes for the same rng (port of the reference's ``ShardedEngine``):

    * ``to_coeffs``, ``coeff_to_extended(_many)``, ``extended_to_coeff``:
      the four-step :func:`..parallel.ntt.sharded_ntt` over ``sp`` (the
      coset scales replicated, as in the reference);
    * ``commit_batch``: every commitment, whatever ``commit`` would say, on
      :func:`..parallel.msm.sharded_msm` over the whole mesh (a call's
      columns as one batch), over the SRS uploaded once per (params,
      device), decoded to affine on the host;
    * ``grand_product_z``: :func:`..parallel.scan.grand_product_z` with the
      prover's labels;
    * ``quotient_eval``: each rank runs the quotient program (one
      ``vm_eval``) over its ``extended_n / S`` rows of the whole columns,
      then an ``all_gather`` over ``sp``.

    ``device``: this rank's device (None: its current CUDA device on a
    ``"cuda"`` mesh, the CPU on a ``"cpu"`` one); a device of another type
    than the mesh's raises, and so does a mesh whose process group is gone."""

    name = "sharded"

    def __init__(self, params, st, mesh, device=None):
        import torch.distributed as dist

        from ..parallel.mesh import AXES, rank_device

        if not dist.is_initialized():
            raise RuntimeError("ShardedEngine: no process group (torch.distributed is not initialized)")
        if tuple(mesh.mesh_dim_names or ()) != AXES:
            raise ValueError(f"ShardedEngine: a mesh of axes {AXES} (parallel.make_mesh), got {mesh.mesh_dim_names}")
        device = rank_device(mesh) if device is None else torch.device(device)
        if device.type != mesh.device_type:
            raise ValueError(f"ShardedEngine: device {device} on a {mesh.device_type!r} mesh")
        super().__init__(params, st, device, commit="device")
        self.mesh = mesh

    def _ntt(self, x, inverse: bool):
        from ..parallel.ntt import sharded_ntt

        return sharded_ntt(self.mesh, BN254_FR, x, inverse=inverse, axis="sp")

    # ---- transforms (the distributed NTT)
    def to_coeffs(self, vals):
        return self._ntt(self.dfr.encode(vals, device=self.device), True)

    def coeff_to_extended(self, coeffs):
        return self.coeff_to_extended_many([coeffs])[0]

    def coeff_to_extended_many(self, coeffs_list):
        """Every column padded into one (C, 16, extended_n) batch, coset
        scaled, and one sharded forward NTT for the batch (one exchange)."""
        from ..poly.domain import _mul_columns

        if not coeffs_list:
            return []
        ext_n = self.domain.extended_n
        padded = coeffs_list[0].new_zeros((len(coeffs_list), 16, ext_n))
        for i, c in enumerate(coeffs_list):
            padded[i, :, : c.shape[-1]] = c
        scaled = _mul_columns(BN254_FR, padded, self.domain._coset_powers(ext_n, self.device))
        return list(self._ntt(scaled, False).unbind(0))

    def extended_to_coeff(self, epoly):
        coeffs = self._ntt(epoly, True)
        return self.dfr.mul(coeffs, self.domain._coset_powers_inv(self.domain.extended_n, self.device))

    # ---- the row-sharded quotient
    def quotient_eval(self, columns_ext, combined_expr, rot_scale):
        from ..parallel import comm
        from ..parallel.mesh import axis_index, axis_size

        assert combined_expr is self.st.combined_quotient(), (
            "ShardedEngine.quotient_eval only evaluates st.combined_quotient()"
        )
        ext_n = self.domain.extended_n
        shards = axis_size(self.mesh, "sp")
        if ext_n % shards:
            raise ValueError(f"quotient: {ext_n} rows do not divide over {shards} ranks")
        m = ext_n // shards
        prog = self.st.quotient_program(rot_scale)
        part = _run_program(prog, self.dfr, columns_ext, rows=(axis_index(self.mesh, "sp") * m, m))[0]
        return comm.all_gather(self.mesh, "sp", part).permute(1, 0, 2).reshape(16, ext_n)

    # ---- the distributed grand product (the prover's real labels)
    def grand_product_z(self, num_ints, den_ints, carry: int):
        from ..parallel.scan import grand_product_z

        u, n = len(num_ints), self.st.n
        num = self.dfr.encode([int(v) for v in num_ints] + [1] * (n - u), device=self.device)
        den = self.dfr.encode([int(v) for v in den_ints] + [1] * (n - u), device=self.device)
        zi = self.dfr.decode(grand_product_z(self.mesh, BN254_FR, num, den, axis="sp"))
        return [carry * int(zi[r]) % P for r in range(u + 1)]

    # ---- distributed commitments
    def commit_batch(self, coeffs_list):
        """One sharded MSM for the columns of each length (a batch of scalar
        sets over the same SRS points: one Horner and one exchange per
        round for all of them), decoded to affine on the host."""
        from ..ec.device import _wsums_host_affine
        from ..parallel.msm import sharded_msm

        g1_x, g1_y = _device_srs(self.params, self.device)
        out = [None] * len(coeffs_list)
        for m in dict.fromkeys(c.shape[-1] for c in coeffs_list):
            idx = [i for i, c in enumerate(coeffs_list) if c.shape[-1] == m]
            canon = torch.stack([self.dfr.from_mont_arr(coeffs_list[i]) for i in idx])
            pt = sharded_msm(self.mesh, g1_x[:, :m], g1_y[:, :m], canon)
            xs, ys = _wsums_host_affine(torch.stack([pt["x"], pt["y"], pt["z"]]))
            for i, x, y in zip(idx, xs, ys):
                out[i] = ec.g1_from_ints(x, y)
        return out


def _grand_product_fallback(num_ints, den_ints, carry: int):
    """z[0]=carry, z[r+1]=z[r]*num[r]/den[r] — native C++ when available."""
    if native.available():
        z = native.grand_product_fr(
            native.pack_ints([int(v) for v in num_ints]),
            native.pack_ints([int(v) for v in den_ints]),
            carry,
        )
        return native.unpack_ints(z)
    from .expr_eval import batch_invert

    den_inv = batch_invert([int(v) for v in den_ints])
    z = [0] * (len(num_ints) + 1)
    z[0] = carry
    for r in range(len(num_ints)):
        z[r + 1] = z[r] * int(num_ints[r]) % P * den_inv[r] % P
    return z


# ====================================================================== native
class NativeEngine:
    """C++ host engine — numpy (m, 4) u64 canonical polys, no device programs."""

    name = "native"

    def __init__(self, params, st):
        self.native = native
        self.params = params
        self.st = st
        self.domain = st.domain
        self.n = st.n
        self.ext_n = st.domain.extended_n

    # ---- poly construction
    def coeffs_from_values(self, vals):
        if isinstance(vals, np.ndarray) and vals.dtype == np.uint64:
            return vals  # already an engine poly (host-poly convention)
        return self.native.pack_ints([int(v) % P for v in vals])

    def to_coeffs(self, vals):
        return self.native.ntt_fr(self.coeffs_from_values(vals), inverse=True)

    def pk_coeff(self, pk, which: str, i: int):
        cache = getattr(pk, "_native_coeffs", None)
        if cache is None:
            cache = {}
            pk._native_coeffs = cache
        key = (which, i)
        if key not in cache:
            src = pk.fixed_coeffs if which == "fixed" else pk.sigma_coeffs
            arr = np.asarray(src[i])  # (16, n) Montgomery
            cache[key] = self.native.from_mont(self.native.pack_device(arr), "fr")
        return cache[key]

    # ---- transforms
    def _coset_powers_row(self):
        # cached on the INSTANCE (an lru_cache on the method would key by
        # self and pin every engine + its arrays for the process lifetime)
        cached = getattr(self, "_coset_powers_row_cache", None)
        if cached is not None:
            return cached
        p = P
        g = self.domain.g_coset
        pows = [1] * self.ext_n
        for i in range(1, self.ext_n):
            pows[i] = pows[i - 1] * g % p
        cached = self.native.pack_ints(pows)
        self._coset_powers_row_cache = cached
        return cached

    def coeff_to_extended(self, coeffs):
        return self.coeff_to_extended_many([coeffs])[0]

    def coeff_to_extended_many(self, coeffs_list):
        """Pad + coset-scale + forward NTT for MANY columns in ONE fused
        native call (8-column IFMA lane blocks share the twiddle/scale
        tables; this was the largest slice of the native quotient phase)."""
        if not coeffs_list:
            return []
        nb = len(coeffs_list)
        lens = {c.shape[0] for c in coeffs_list}
        if len(lens) == 1:
            stacked = np.ascontiguousarray(
                np.stack(coeffs_list).astype(np.uint64, copy=False)
            )
            out = self.native.coset_ntt_fr_batch(
                stacked, self.ext_n, self._coset_powers_row()
            )
            return [out[b] for b in range(nb)]
        padded = np.zeros((nb, self.ext_n, 4), np.uint64)
        for b, c in enumerate(coeffs_list):
            padded[b, : c.shape[0]] = c
        scaled = self.native.scale_row_fr_batch(padded, self._coset_powers_row())
        out = self.native.ntt_fr_batch(scaled, inverse=False)
        return [out[b] for b in range(nb)]

    def extended_to_coeff(self, epoly):
        coeffs = self.native.ntt_fr(epoly, inverse=True)
        ginv = pow(self.domain.g_coset, -1, P)
        return self.native.scale_powers_fr(coeffs, ginv)

    def slice_coeffs(self, coeffs, lo, hi):
        return coeffs[lo:hi]

    # ---- extended-domain helpers
    def epoly_from_values(self, vals):
        return self.native.pack_ints([int(v) % P for v in vals])

    def epoly_const(self, v):
        one = self.native.pack_ints([int(v) % P])
        return np.broadcast_to(one, (self.ext_n, 4)).copy()

    def mul_ext(self, a, b):
        return self.native.mul_fr(a, b)

    def vanishing_inv_extended(self):
        cached = getattr(self, "_vanish_inv_cache", None)
        if cached is None:
            cached = self.native.pack_ints(
                list(self.domain.vanishing_inv_extended_ints())
            )
            self._vanish_inv_cache = cached
        return cached

    def quotient_eval(self, columns_ext, combined_expr, rot_scale):
        # the native path runs the precompiled quotient Program; it is only
        # valid for the structure's own combined quotient expression
        assert combined_expr is self.st.combined_quotient(), (
            "NativeEngine.quotient_eval only evaluates st.combined_quotient()"
        )
        prog = self.st.quotient_program(rot_scale)
        rows, rots, strides = [], [], []
        for kind, ci, rot in prog.queries:
            rows.append(columns_ext[kind][ci])
            rots.append(rot * rot_scale)
            strides.append(1)
        for v in prog.consts:
            rows.append(self.native.pack_ints([int(v) % P]))
            rots.append(0)
            strides.append(0)  # broadcast constant, read in place
        nq_c = len(rows)
        instrs = np.array(
            [(op, s1, s2, nq_c + i) for i, (op, s1, s2) in enumerate(prog.instrs)],
            np.int32,
        ).reshape(-1, 4)
        out = self.native.expr_eval_fr_rows(
            rows, rots, strides, instrs, prog.output_slots(), self.ext_n
        )
        return out[0]

    # ---- commitments / decode
    def _srs(self, m):
        cached = getattr(self.params, "_native_srs", None)
        if cached is None:
            px = self.native.pack_device(np.asarray(self.params.g1_x))
            py = self.native.pack_device(np.asarray(self.params.g1_y))
            cached = (px, py)
            self.params._native_srs = cached
        return cached[0][:m], cached[1][:m]

    def commit_batch(self, coeffs_list):
        if not coeffs_list:
            return []
        m = coeffs_list[0].shape[0]
        px, py = self._srs(m)
        batch = np.stack(coeffs_list)  # (B, m, 4) canonical
        out = self.native.msm_g1_mont_batch(px, py, batch)
        return [ec.g1_from_ints(x, y) for x, y in out]

    def decode_many(self, polys):
        # engine polys ARE host (m, 4) canonical arrays — hand them to the
        # prover tail as-is (the int round trip cost ~0.5 s per prove)
        return list(polys)

    def grand_product_z(self, num_ints, den_ints, carry: int):
        return _grand_product_fallback(num_ints, den_ints, carry)
