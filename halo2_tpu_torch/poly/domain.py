"""Evaluation domains and the radix-2 NTT on torch tensors (port of
halo2_tpu/poly/domain.py).

The NTT is the reference's iterative Cooley-Tukey: one bit-reversal gather,
then log2(n) butterfly stages, over one (16, n) column or over every column
of a (C, 16, n) batch at once, through the CUDA kernels of :mod:`.cuda_ntt`
(their plain versions on the CPU).  For n >= TILE (512) the gather is an
``index_select`` before the kernels; below it one ``ntt_small_stages``
launch is the whole transform, the gather included, where the reference
runs a stage ladder of ``mul``/``add``/``sub``.  Tensors that the
transforms need (bit-reversal index, twiddle table, n^-1, coset powers) are
cached per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..field.cuda_mul import mont_mul_columns
from ..field.device import get_device_field
from ..field.params import FieldSpec
from .cuda_ntt import TILE, ntt_stages, rev_index


@functools.lru_cache(maxsize=None)
def _stage_twiddles(spec: FieldSpec, n: int, inverse: bool):
    """Per-stage twiddles, Montgomery-encoded numpy (L, m) arrays: stage with
    half-size m holds w^0 .. w^(m-1) for w = omega^(n / 2m)."""
    df = get_device_field(spec)
    s = spec.two_adicity
    omega = pow(spec.root_of_unity, 1 << (s - n.bit_length() + 1), spec.p)
    if inverse:
        omega = pow(omega, -1, spec.p)
    stages = []
    m = 1
    while m < n:
        w = pow(omega, n // (2 * m), spec.p)
        tw = [pow(w, j, spec.p) for j in range(m)]
        stages.append(df.encode_np(tw))  # (L, m)
        m *= 2
    return stages


@functools.lru_cache(maxsize=None)
def twiddle_table(spec: FieldSpec, n: int, inverse: bool, device: torch.device) -> torch.Tensor:
    """All stages' twiddles as one (16, n - 1) int32 tensor (empty for n =
    1); the stage with half-size m starts at column m - 1."""
    table = np.concatenate([np.zeros((16, 0), np.uint32), *_stage_twiddles(spec, n, inverse)], axis=1)
    return torch.from_numpy(table.view(np.int32)).to(device)


@functools.lru_cache(maxsize=None)
def _n_inv(spec: FieldSpec, n: int, device: torch.device) -> torch.Tensor:
    return get_device_field(spec).encode([pow(n, -1, spec.p)], device=device)


def _mul_columns(spec: FieldSpec, x: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x * b for each column of a (*lead, 16, n) x, all columns in one
    Montgomery launch; b is one (16, n) for every column, or a (16, P)
    period (P = 1: one element)."""
    cols = x.reshape(-1, 16, x.shape[-1])
    return mont_mul_columns(spec, cols, b.reshape(16, -1)).reshape(x.shape)


def _ntt_unscaled(spec: FieldSpec, x: torch.Tensor, inverse: bool) -> torch.Tensor:
    """The transform of each column of a (16, n) or (C, 16, n) Montgomery
    tensor over omega (omega^-1 when ``inverse``) without the inverse's n^-1
    scaling (natural order in and out): the NTT kernels over every column,
    after the bit-reversal gather for n >= TILE (below it the one
    ``ntt_small_stages`` launch reads through the bit-reversal itself)."""
    n = x.shape[-1]
    x = x.index_select(-1, rev_index(n, x.device)) if n >= TILE else x.contiguous()
    return ntt_stages(spec, x, twiddle_table(spec, n, inverse, x.device))


def _ntt_raw(spec: FieldSpec, n: int, inverse: bool):
    """(16, n) or (C, 16, n) Montgomery tensor -> the NTT of each column
    (natural order in and out)."""

    def fn(coeffs: torch.Tensor) -> torch.Tensor:
        x = _ntt_unscaled(spec, coeffs, inverse)
        if inverse:
            x = _mul_columns(spec, x, _n_inv(spec, n, coeffs.device))
        return x

    return fn


class EvaluationDomain:
    """Domain of size n = 2^k with an extended coset of size 2^extended_k.

    The coset generator is the field's multiplicative generator, as in the
    reference (not halo2's ZETA)."""

    def __init__(self, spec: FieldSpec, k: int, degree: int):
        self.spec = spec
        self.k = k
        self.n = 1 << k
        self.df = get_device_field(spec)
        quotient_poly_degree = max(degree - 1, 1)
        self.extended_k = k + (quotient_poly_degree - 1).bit_length()
        self.extended_n = 1 << self.extended_k
        p = spec.p
        s = spec.two_adicity
        assert self.extended_k <= s
        self.omega = pow(spec.root_of_unity, 1 << (s - k), p)
        self.omega_inv = pow(self.omega, -1, p)
        self.extended_omega = pow(spec.root_of_unity, 1 << (s - self.extended_k), p)
        self.g_coset = spec.generator

    # ------------------------------------------------------------- transforms
    def lagrange_to_coeff(self, evals: torch.Tensor) -> torch.Tensor:
        """(16, n) evals on H, or a (C, 16, n) batch of columns -> coefficients."""
        return _ntt_raw(self.spec, self.n, True)(evals)

    def coeff_to_lagrange(self, coeffs: torch.Tensor) -> torch.Tensor:
        return _ntt_raw(self.spec, self.n, False)(coeffs)

    def coeff_to_extended(self, coeffs: torch.Tensor) -> torch.Tensor:
        """(16, m) coeffs, or a (C, 16, m) batch of columns -> (16,
        extended_n) evals on the extended coset (per column): pad, scale by
        the coset powers, forward NTT."""
        ext_n = self.extended_n
        padded = coeffs
        if coeffs.shape[-1] != ext_n:
            padded = coeffs.new_zeros((*coeffs.shape[:-1], ext_n))
            padded[..., : coeffs.shape[-1]] = coeffs
        scaled = _mul_columns(self.spec, padded.contiguous(), self._coset_powers(ext_n, coeffs.device))
        return _ntt_raw(self.spec, ext_n, False)(scaled)

    def extended_to_coeff(self, evals: torch.Tensor) -> torch.Tensor:
        """(16, extended_n) coset evals, or a (C, 16, extended_n) batch ->
        coefficients of the same shape."""
        ext_n = self.extended_n
        coeffs = _ntt_raw(self.spec, ext_n, True)(evals)
        return _mul_columns(self.spec, coeffs, self._coset_powers_inv(ext_n, evals.device))

    def _powers(self, g: int, n: int) -> list:
        p = self.spec.p
        pows = [1] * n
        for i in range(1, n):
            pows[i] = pows[i - 1] * g % p
        return pows

    @functools.lru_cache(maxsize=None)
    def _coset_powers(self, n: int, device: torch.device) -> torch.Tensor:
        return self.df.encode(self._powers(self.g_coset, n), device=device)

    @functools.lru_cache(maxsize=None)
    def _coset_powers_inv(self, n: int, device: torch.device) -> torch.Tensor:
        ginv = pow(self.g_coset, -1, self.spec.p)
        return self.df.encode(self._powers(ginv, n), device=device)

    # ------------------------------------------------------- vanishing helpers
    @functools.lru_cache(maxsize=None)
    def vanishing_inv_extended_ints(self) -> tuple:
        """1 / (X^n - 1) on the extended coset, host ints.  (g w^i)^n cycles
        with period extended_n / n, so only that many inverses are computed."""
        p = self.spec.p
        rot = self.extended_n // self.n
        gn = pow(self.g_coset, self.n, p)
        wn = pow(self.extended_omega, self.n, p)
        vals = []
        acc = gn
        for _ in range(rot):
            vals.append(pow(acc - 1, -1, p))
            acc = acc * wn % p
        return tuple(vals[i % rot] for i in range(self.extended_n))

    @functools.lru_cache(maxsize=None)
    def vanishing_inv_extended(self, device: torch.device) -> torch.Tensor:
        """1 / (X^n - 1) on the extended coset, encoded on ``device``."""
        return self.df.encode(list(self.vanishing_inv_extended_ints()), device=device)

    # host-side scalar helpers (verifier)
    def l_i(self, i: int, x: int) -> int:
        """Lagrange basis L_i evaluated at x (host int)."""
        p = self.spec.p
        w_i = pow(self.omega, i, p)
        if (x - w_i) % p == 0:
            return 1
        xn = pow(x, self.n, p)
        num = w_i * (xn - 1) % p
        den = self.n * ((x - w_i) % p) % p
        return num * pow(den, -1, p) % p

    def eval_lagrange_interp(self, values: list[int], x: int) -> int:
        """Evaluate the poly with given Lagrange values (rest zero) at x."""
        p = self.spec.p
        acc = 0
        for i, v in enumerate(values):
            if v:
                acc = (acc + v * self.l_i(i, x)) % p
        return acc


@functools.lru_cache(maxsize=None)
def get_domain(spec: FieldSpec, k: int, degree: int) -> EvaluationDomain:
    return EvaluationDomain(spec, k, degree)
