"""Judges ``lagrange_to_coeff``'s coefficients.  The coefficients c of the
values v over the domain of omega = g^((p - 1) / 2^k) (g the field's
multiplicative generator, halo2curves' 7 for BN254 Fr) satisfy
v_j = sum_i c_i omega^(i j).  For each sampled request, at a seeded sample
of points omega^j, every column's coefficients are evaluated exactly
(``_evaluate.py``; the Montgomery factor R cancels on both sides) and must
equal the input value at j; every coefficient of a sampled request must be
canonical."""

from __future__ import annotations

import random

import torch

from ..fields import FR, count_noncanonical, limbs_to_ints
from ._evaluate import evaluate, power_limbs


def check(config, traffic, samples, seed):
    k = config["k"]
    n = 1 << k
    omega = pow(config["generator"], (FR - 1) >> k, FR)
    rng = random.Random(seed ^ 0xE7A1)
    wrong = checked = noncanon = total = 0
    per_request = []
    table = None
    for values, coeffs in samples:
        if table is None:
            table = power_limbs(omega, n, FR, coeffs.device)
            idx = torch.arange(n, dtype=torch.int64, device=coeffs.device)
        bad = 0
        for j in rng.sample(range(n), min(traffic["check"]["points"], n)):
            got = evaluate(coeffs, table[:, idx * j % n], FR)
            want = limbs_to_ints(values[:, :, j].T)
            bad += sum(g != w for g, w in zip(got, want))
            checked += len(want)
        nc = count_noncanonical(coeffs)
        wrong += bad
        noncanon += nc
        total += coeffs.shape[0] * n
        per_request.append(bad + nc == 0)
    return {
        "wrong_evaluations": {"value": wrong, "limit": 0, "of": checked},
        "noncanonical_coefficients": {"value": noncanon, "limit": 0, "of": total},
    }, per_request
