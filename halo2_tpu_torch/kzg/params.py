"""KZG structured reference string (port of halo2_tpu/kzg/params.py).

The SRS stays host numpy, as in the reference: ``g1_x``/``g1_y`` are
(16, n) uint32 Montgomery limbs over BN254 Fq, read by the native host MSM.
``load`` reads the reference's pickles (numpy arrays and ints only).
``setup`` computes G * tau^i on the host for n <= 4096 or ``device="cpu"``,
and otherwise takes the reference's device branch (there a batched
double-and-add over G on every lane, ``scalar_mul_batched``): here G's
fixed-base window table and the powers' 32-bit words
(:func:`..ec.device.fixed_base_mul`, one ``jac_fixed_base`` launch), then
``jac_to_affine`` (``mont_inv``, ``mont_mul``).
"""

from __future__ import annotations

import os
import pickle
import random

import numpy as np
import torch

from .._device import resolve_device
from ..ec import host as ec
from ..field.device import get_device_field
from ..field.params import BN254_FQ

HOST_SETUP_MAX_N = 4096


def value_bits(values) -> np.ndarray:
    """Ints in [0, 2^256) -> (n, 256) uint8, bit r of value i at [i, r]:
    one unpack of their little-endian bytes."""
    raw = np.frombuffer(b"".join(int(v).to_bytes(32, "little") for v in values), np.uint8)
    return np.unpackbits(raw.reshape(len(values), 32), axis=1, bitorder="little")


def scalar_bits(values) -> np.ndarray:
    """Ints in [0, 2^256) -> their (256, n) uint8 bit rows, LSB first (row r
    holds bit r of every value): :func:`value_bits` transposed."""
    return np.ascontiguousarray(value_bits(values).T)


def scalar_words(values) -> np.ndarray:
    """Ints in [0, 2^256) -> their (8, n) uint32 little-endian words (word k
    of value i at [k, i])."""
    raw = np.frombuffer(b"".join(int(v).to_bytes(32, "little") for v in values), "<u4")
    return raw.reshape(len(values), 8).T.copy()


def device_g1_powers(powers, device) -> tuple:
    """[G * v for v in powers] as affine Montgomery limbs (two (16, n) numpy
    uint32 arrays), computed on ``device``: the reference's device branch of
    ``ParamsKZG.setup``.  The powers go to the device as (8, n) 32-bit
    words (2 MB at n = 2^16) for one fixed-base multiplication of G."""
    from ..ec.device import fixed_base_mul, jac_to_affine

    words = torch.from_numpy(scalar_words(powers).view(np.int32)).to(device)
    acc = fixed_base_mul(ec.g1_to_ints(ec.G1), words)
    g1_x, g1_y = jac_to_affine(acc)
    return tuple(a.cpu().numpy().view(np.uint32) for a in (g1_x, g1_y))


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
    def setup(cls, k: int, seed: int = 0xD15C0, device=None):
        """The seeded SRS; G * tau^i on ``device`` (the CUDA device when
        None) when it is not the CPU and n > 4096, on the host otherwise."""
        n = 1 << k
        device = resolve_device(device)
        rng = random.Random(seed)
        tau = rng.randrange(1, ec.R)
        powers = [1] * n
        for i in range(1, n):
            powers[i] = powers[i - 1] * tau % ec.R
        if device.type == "cpu" or n <= HOST_SETUP_MAX_N:
            d = get_device_field(BN254_FQ)
            pts = [ec.ec_mul(ec.G1, v) for v in powers]
            g1_x = d.encode_np([ec.g1_to_ints(p)[0] for p in pts])
            g1_y = d.encode_np([ec.g1_to_ints(p)[1] for p in pts])
        else:
            g1_x, g1_y = device_g1_powers(powers, device)
        return cls(k, g1_x, g1_y, ec.G2, ec.ec_mul(ec.G2, tau))

    def g1_host(self) -> list:
        """SRS points as host ints (lazily decoded from the limb arrays)."""
        if getattr(self, "_g1_host", None) is None:
            d = get_device_field(BN254_FQ)
            xs, ys = (
                d.decode(torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32)))
                for a in (self.g1_x, self.g1_y)
            )
            self._g1_host = [
                ec.g1_from_ints(int(x), int(y)) for x, y in zip(xs, ys)
            ]
        return self._g1_host

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
    def setup_cached(cls, k: int, seed: int = 0xD15C0, cache_dir: str = None, device=None):
        """Load ``<cache_dir>/kzg_bn254_k{k}_s{seed}.pkl`` (the repo's ``.srs/``
        by default, shared with the reference), or set up on ``device`` and
        save it."""
        cache_dir = cache_dir or os.path.join(os.path.dirname(__file__), "..", "..", ".srs")
        os.makedirs(cache_dir, exist_ok=True)
        path = os.path.join(cache_dir, f"kzg_bn254_k{k}_s{seed}.pkl")
        if os.path.exists(path):
            return cls.load(path)
        params = cls.setup(k, seed, device)
        params.save(path)
        return params

    def verifier_params(self) -> "ParamsKZG":
        return self
