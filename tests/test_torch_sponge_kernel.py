"""The Poseidon sponge as one ``poseidon_hash`` launch, checked on the CPU,
where ``hash_device``/``permute_device`` run their plain versions:

- ``permute_device_plain`` at width 3 (P128Pow5T3, Pasta Fp) against the
  reference's device permutation (its ``lax.scan``s, jnp on the CPU) limb
  for limb, on 8 lanes with a zero state and a state of p - 1 words;
- ``hash_device_plain`` at width 5 (MySpec(5, 4): BN254 Fr at L = 4, Pasta
  Fp at L = 3, padded) against the reference's host ``poseidon_hash`` (its
  width-5 device sponge takes ~50 s to compile on the CPU);
- the kernel's constant table (``cuda_sponge.constants_words``): its full
  rounds' constants and MDS matrix against the spec's, and the capacity
  word (the partial rounds' sparse form: tests/test_torch_sponge_sparse.py);
- the dispatch: a CPU tensor runs the plain versions and counts no
  launch; another device or a bad shape raises, and so does a width the
  kernel was not built for, before anything is launched.

The kernel is held against the plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phases 2 and 8).  Inputs come from
a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import halo2_tpu.poseidon as ref_poseidon
import halo2_tpu_torch.poseidon as port_poseidon
from halo2_tpu.field.device import get_device_field as ref_device_field
from halo2_tpu.field.host import field_class
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FR, PASTA_FP
from halo2_tpu_torch.poseidon import cuda_sponge
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

B = 8


def _words(field, rows: int, seed: int):
    """(rows, B) canonical ints and their (rows, 16, B) Montgomery limbs
    (numpy uint32): lane 0 all 0, lane 1 all p - 1."""
    rng = np.random.default_rng(seed)
    vals = [
        [int.from_bytes(rng.bytes(32), "little") % field.p for _ in range(B)] for _ in range(rows)
    ]
    for row in vals:
        row[0], row[1] = 0, field.p - 1
    enc = ref_device_field(field).encode_np([v for row in vals for v in row])
    return vals, enc.reshape(16, rows, B).transpose(1, 0, 2).copy()


def _port(limbs: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(limbs).view(np.int32))


def test_permute_plain_width3_matches_reference_device_permutation():
    _vals, state = _words(PASTA_FP, 3, seed=31)
    ref_df = ref_device_field(PASTA_FP)
    want = np.asarray(
        ref_poseidon.permute_device(ref_df, ref_poseidon.P128Pow5T3(), jnp.asarray(state))
    )
    df, spec = get_device_field(PASTA_FP), port_poseidon.P128Pow5T3()
    got = port_poseidon.permute_device_plain(df, spec, _port(state))
    assert np.array_equal(got.numpy().view(np.uint32), want)
    assert torch.equal(port_poseidon.permute_device(df, spec, _port(state)), got)


@pytest.mark.parametrize(
    "field, L", [(BN254_FR, 4), (PASTA_FP, 3)], ids=["bn254_fr-L4", "pasta_fp-L3"]
)
def test_hash_plain_width5_matches_host_sponge(field, L):
    vals, limbs = _words(field, L, seed=50 + L)
    df, spec = get_device_field(field), port_poseidon.MySpec(5, 4)
    got = port_poseidon.hash_device_plain(df, spec, L, _port(limbs))
    F, ref_spec = field_class(field), ref_poseidon.MySpec(5, 4)
    want = [
        int(ref_poseidon.poseidon_hash(F, ref_spec, [F(vals[i][b]) for i in range(L)]))
        for b in range(B)
    ]
    assert np.array_equal(got.numpy().view(np.uint32), ref_device_field(field).encode_np(want))
    assert torch.equal(port_poseidon.hash_device(df, spec, L, _port(limbs)), got)


@pytest.mark.parametrize(
    "field, width",
    [(BN254_FR, 5), (PASTA_FP, 3), (PASTA_FP, 5)],
    ids=["bn254_fr-w5", "pasta_fp-w3", "pasta_fp-w5"],
)
def test_constant_table_holds_the_spec_constants(field, width):
    """The full rounds' constants and the MDS matrix stand in the table as
    the spec gives them; the partial block's entries (the sparse form) are
    held by tests/test_torch_sponge_sparse.py."""
    spec = port_poseidon.MySpec(width, width - 1)
    table = cuda_sponge.constants_words(
        field, width, spec.full_rounds(), spec.partial_rounds(), spec.secure_mds()
    )
    F = field_class(field)
    rcs, mds, _ = ref_poseidon.MySpec(width, width - 1).constants(F)
    r_f, r_p = spec.full_rounds() // 2, spec.partial_rounds()
    lay = cuda_sponge.table_layout(width, spec.full_rounds(), r_p)
    assert table.dtype == np.uint32 and table.shape == (lay["rows"], 8)
    values = [sum(int(w) << (32 * k) for k, w in enumerate(row)) for row in table]
    r_inv = pow(2**256, -1, field.p)
    plain = [v * r_inv % field.p for v in values]  # out of Montgomery form
    full = rcs[:r_f] + rcs[r_f + r_p :]
    assert plain[: lay["c_hat"]] == [int(c) for row in full for c in row]
    assert plain[lay["mds"] : lay["edge"]] == [int(c) for row in mds for c in row]
    cap = cuda_sponge._capacity_words(field, 4)
    assert sum(int(w) << (32 * k) for k, w in enumerate(cap)) * r_inv % field.p == 4 << 64


def test_sponge_dispatch_and_checks():
    df = get_device_field(BN254_FR)
    spec = port_poseidon.MySpec(5, 4)
    _vals, limbs = _words(BN254_FR, 5, seed=9)
    state = _port(limbs)
    before = dict(cuda_sponge.LAUNCHES)
    port_poseidon.permute_device(df, spec, state)
    port_poseidon.hash_device(df, spec, 4, state[:4].contiguous())
    assert cuda_sponge.LAUNCHES == before, "a CPU tensor launched a kernel"
    with pytest.raises(ValueError, match="ConstantLength"):
        port_poseidon.hash_device(df, spec, 3, state[:4].contiguous())
    with pytest.raises(ValueError, match="int32"):
        port_poseidon.hash_device(df, spec, 4, state[:4].to(torch.int64))
    with pytest.raises(ValueError, match="state"):
        port_poseidon.permute_device(df, spec, state[:3].contiguous())
    meta = torch.empty(state.shape, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        port_poseidon.permute_device(df, spec, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        port_poseidon.hash_device(df, spec, 4, meta[:4])
    with pytest.raises(ValueError, match="widths"):  # before the kernel library is loaded
        cuda_sponge.launch(
            BN254_FR, port_poseidon.MySpec(4, 3), state[:4].contiguous(), 4, hash_mode=False
        )
    assert cuda_sponge.LAUNCHES == before
