"""KZG structured reference string (port of halo2_tpu/kzg/params.py).

The SRS stays host numpy, as in the reference: ``g1_x``/``g1_y`` are
(16, n) uint32 Montgomery limbs over BN254 Fq, read by the native host MSM.
``load`` reads the reference's pickles (numpy arrays and ints only).
``setup`` computes the powers on the host for n <= 4096; the reference's
device branch for larger n (batched fixed-base scalar multiply) waits for the
device curve arithmetic.
"""

from __future__ import annotations

import os
import pickle
import random

import numpy as np

from ..ec import host as ec
from ..field.device import get_device_field
from ..field.params import BN254_FQ

HOST_SETUP_MAX_N = 4096


class ParamsKZG:
    """g1 powers [G, tau G, ..., tau^{n-1} G] (host numpy, Montgomery affine
    limbs), g2, s_g2 = tau G2 (host)."""

    def __init__(self, k: int, g1_x, g1_y, g2, s_g2):
        self.k = k
        self.n = 1 << k
        self.g1_x = np.asarray(g1_x)  # (16, n) host numpy, Montgomery
        self.g1_y = np.asarray(g1_y)
        self.g2 = g2
        self.s_g2 = s_g2

    @classmethod
    def setup(cls, k: int, seed: int = 0xD15C0):
        n = 1 << k
        if n > HOST_SETUP_MAX_N:
            raise NotImplementedError(
                f"SRS setup for n={n} > {HOST_SETUP_MAX_N} needs the device "
                "scalar multiply, not ported yet; load a cached SRS instead"
            )
        rng = random.Random(seed)
        tau = rng.randrange(1, ec.R)
        powers = [1] * n
        for i in range(1, n):
            powers[i] = powers[i - 1] * tau % ec.R
        d = get_device_field(BN254_FQ)
        pts = [ec.ec_mul(ec.G1, v) for v in powers]
        g1_x = d.encode_np([ec.g1_to_ints(p)[0] for p in pts])
        g1_y = d.encode_np([ec.g1_to_ints(p)[1] for p in pts])
        return cls(k, g1_x, g1_y, ec.G2, ec.ec_mul(ec.G2, tau))

    # ------------------------------------------------------------ persistence
    def save(self, path: str):
        data = {
            "k": self.k,
            "g1_x": np.asarray(self.g1_x),
            "g1_y": np.asarray(self.g1_y),
            "g2": [c.c for c in self.g2],
            "s_g2": [c.c for c in self.s_g2],
        }
        with open(path, "wb") as f:
            pickle.dump(data, f)

    @classmethod
    def load(cls, path: str):
        with open(path, "rb") as f:
            data = pickle.load(f)
        g2 = (ec.FQ2(data["g2"][0]), ec.FQ2(data["g2"][1]))
        s_g2 = (ec.FQ2(data["s_g2"][0]), ec.FQ2(data["s_g2"][1]))
        return cls(data["k"], data["g1_x"], data["g1_y"], g2, s_g2)

    @classmethod
    def setup_cached(cls, k: int, seed: int = 0xD15C0, cache_dir: str = None):
        """Load ``<cache_dir>/kzg_bn254_k{k}_s{seed}.pkl`` (the repo's ``.srs/``
        by default, shared with the reference), or set up and save it."""
        cache_dir = cache_dir or os.path.join(os.path.dirname(__file__), "..", "..", ".srs")
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"kzg_bn254_k{k}_s{seed}.pkl")
        if os.path.exists(path):
            return cls.load(path)
        params = cls.setup(k, seed)
        params.save(path)
        return params

    def verifier_params(self) -> "ParamsKZG":
        return self
