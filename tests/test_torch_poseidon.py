"""The port's batched device Poseidon sponge against the reference's.

Messages of B = 8 lanes, made from a numpy seed, go as (L, 16, B) Montgomery
limbs through the port's ``hash_device``/``permute_device`` on CPU tensors
(the Montgomery kernels' plain versions).  Each lane must equal the
reference's host sponge (``poseidon_hash``, ``permute``) exactly.  For
P128Pow5T3 over Pasta Fp the batch must also equal the reference's device
permutation (jnp on the CPU) limb for limb.  The width-5 specs are held
against the reference's host sponge only: the reference's width-5 device
sponge takes 50 s to trace and compile on the CPU per field.
"""

import numpy as np
import pytest
import torch

import halo2_tpu.poseidon as ref_poseidon
import halo2_tpu_torch.poseidon as port_poseidon
from halo2_tpu.field.device import get_device_field as ref_device_field
from halo2_tpu.field.host import field_class
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FR, PASTA_FP
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

B = 8


def _messages(spec, L: int, seed: int):
    """(L, B) canonical ints and their (L, 16, B) Montgomery limbs (numpy
    uint32, the reference's layout)."""
    rng = np.random.default_rng(seed)
    vals = [[int.from_bytes(rng.bytes(32), "little") % spec.p for _ in range(B)] for _ in range(L)]
    enc = ref_device_field(spec).encode_np([v for row in vals for v in row])
    return vals, enc.reshape(16, L, B).transpose(1, 0, 2).copy()


def _port(limbs: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(limbs).view(np.int32))


CASES = [
    # (field, spec name, width, L): L < rate pads; L > rate takes two chunks
    (PASTA_FP, "P128Pow5T3", 3, 2),
    (PASTA_FP, "P128Pow5T3", 3, 3),
    (BN254_FR, "MySpec", 5, 4),
    (PASTA_FP, "MySpec", 5, 3),
]


def _spec(pkg, name, width):
    return pkg.P128Pow5T3() if name == "P128Pow5T3" else pkg.MySpec(width, width - 1)


@pytest.mark.parametrize(
    "field, spec_name, width, L", CASES, ids=[f"{c[0].name}-{c[1]}-w{c[2]}-L{c[3]}" for c in CASES]
)
def test_hash_device_matches_host_sponge(field, spec_name, width, L):
    vals, limbs = _messages(field, L, seed=width * 10 + L)
    df = get_device_field(field)
    got = port_poseidon.hash_device(df, _spec(port_poseidon, spec_name, width), L, _port(limbs))
    assert got.shape == (16, B) and got.dtype == torch.int32
    F = field_class(field)
    ref_spec = _spec(ref_poseidon, spec_name, width)
    want = [
        int(ref_poseidon.poseidon_hash(F, ref_spec, [F(vals[i][b]) for i in range(L)]))
        for b in range(B)
    ]
    assert np.array_equal(got.numpy().view(np.uint32), ref_device_field(field).encode_np(want))
    with pytest.raises(ValueError):
        port_poseidon.hash_device(df, _spec(port_poseidon, spec_name, width), L + 1, _port(limbs))


@pytest.mark.parametrize("field", [BN254_FR, PASTA_FP], ids=lambda f: f.name)
def test_permute_device_matches_host_permute(field):
    width = 5
    vals, limbs = _messages(field, width, seed=3)
    got = port_poseidon.permute_device(
        get_device_field(field), port_poseidon.MySpec(width, width - 1), _port(limbs)
    )
    F = field_class(field)
    ref_spec = ref_poseidon.MySpec(width, width - 1)
    rcs, mds, _ = ref_spec.constants(F)
    want = np.zeros((width, 16, B), np.uint32)
    for b in range(B):
        out = ref_poseidon.permute([F(vals[i][b]) for i in range(width)], ref_spec, mds, rcs)
        want[:, :, b] = ref_device_field(field).encode_np([int(x) for x in out]).T
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_p128_matches_reference_device_sponge():
    """The reference's jnp permutation on the sponge's first state: its
    whole output against ``permute_device``, its word 0 against
    ``hash_device`` (L = rate, so the hash is that one permutation).  One
    trace and compile of the reference, not two."""
    import jax.numpy as jnp

    L = 2
    _vals, limbs = _messages(PASTA_FP, L, seed=7)
    state = np.zeros((3, 16, B), np.uint32)
    state[:L] = limbs
    state[2] = ref_device_field(PASTA_FP).encode_np([L << 64])
    want = np.asarray(
        ref_poseidon.permute_device(
            ref_device_field(PASTA_FP), ref_poseidon.P128Pow5T3(), jnp.asarray(state)
        )
    )
    df = get_device_field(PASTA_FP)
    got = port_poseidon.permute_device(df, port_poseidon.P128Pow5T3(), _port(state))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    digest = port_poseidon.hash_device(df, port_poseidon.P128Pow5T3(), L, _port(limbs))
    assert np.array_equal(digest.numpy().view(np.uint32), want[0])
