"""The Poseidon sponge's partial rounds in the sparse form that the
``poseidon_hash`` kernel runs (``poseidon/cuda_sponge.py``: ``sparse_form``,
``constants_words``), checked on the CPU, where only the card runs the
kernel:

- ``cuda_sponge.permute_sparse_host``, the kernel's schedule over its packed
  table read back (Python ints), against the reference's host
  ``halo2_tpu.poseidon.primitives.permute`` exactly, for P128Pow5T3,
  MySpec(5, 4), MySpec(3, 2) and MySpec(4, 3) over BN254 Fr and Pasta Fp,
  on numpy-seeded states, the all-zero state and the all-(p - 1) state;
- the factorisation: for every partial round q, the sparse matrix S_q times
  the block matrix B_q = [[1, 0], [0, A_hat]] rebuilds A_q, where A_q is M
  for the last round and B_(q + 1) M before it;
- the packed table unpacks to the values the host model reads, in the
  kernel's layout, and the host model's digests equal the plain versions'
  dense sponge (``hash_device_plain``) limb for limb.
"""

import numpy as np
import pytest
import torch

from halo2_tpu.field.host import field_class
from halo2_tpu.poseidon import primitives as ref
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FR, PASTA_FP
from halo2_tpu_torch.poseidon import MySpec, P128Pow5T3, cuda_sponge, hash_device_plain
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

FIELDS = [BN254_FR, PASTA_FP]
SPECS = {
    "P128Pow5T3": (P128Pow5T3, ref.P128Pow5T3),
    "MySpec(5, 4)": (lambda: MySpec(5, 4), lambda: ref.MySpec(5, 4)),
    "MySpec(3, 2)": (lambda: MySpec(3, 2), lambda: ref.MySpec(3, 2)),
    "MySpec(4, 3)": (lambda: MySpec(4, 3), lambda: ref.MySpec(4, 3)),
}


def _state(field, width: int, kind: str) -> list:
    if kind == "zero":
        return [0] * width
    if kind == "p-1":
        return [field.p - 1] * width
    rng = np.random.default_rng(width * 7 + field.p % 1000)
    return [int.from_bytes(rng.bytes(40), "little") % field.p for _ in range(width)]


@pytest.mark.parametrize("kind", ["seeded", "zero", "p-1"])
@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_sparse_host_model_equals_reference_permute(field, spec_name, kind):
    port_spec, ref_spec = (make() for make in SPECS[spec_name])
    F = field_class(field)
    rcs, mds, _ = ref_spec.constants(F)
    state = _state(field, port_spec.width, kind)
    want = ref.permute([F(v) for v in state], ref_spec, mds, rcs)
    from halo2_tpu_torch.field.host import field_class as port_field_class

    got = cuda_sponge.permute_sparse_host(port_field_class(field), port_spec, state)
    assert [int(v) for v in got] == [int(v) for v in want]


def _matrices(field, width: int):
    port_spec = MySpec(width, width - 1)
    rcs, mds, _ = ref.MySpec(width, width - 1).constants(field_class(field))
    rcs = [[int(c) for c in row] for row in rcs]
    mds = [[int(c) for c in row] for row in mds]
    r_f, r_p = port_spec.full_rounds() // 2, port_spec.partial_rounds()
    return cuda_sponge.sparse_form(field.p, rcs, mds, r_f, r_p), mds, r_p


@pytest.mark.parametrize("width", [3, 4, 5])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_factorisation_rebuilds_each_partial_round(field, width):
    sp, mds, r_p = _matrices(field, width)
    p = field.p
    mul = cuda_sponge._mat_mul
    for q in range(r_p):
        a, s, b = sp["blocks"][q]
        assert mul(s, b, p) == a, q
        want = mds if q == r_p - 1 else mul(sp["blocks"][q + 1][2], mds, p)
        assert a == want, q
        # S_q: the first row and column the kernel reads, the identity elsewhere
        assert s[0] == sp["rows"][q] and [row[0] for row in s[1:]] == sp["cols"][q]
        assert all(s[i][j] == int(i == j) for i in range(1, width) for j in range(1, width))
        # B_q fixes word 0, so it commutes with the S-box on word 0
        assert b[0] == [1] + [0] * (width - 1) and all(row[0] == 0 for row in b[1:])
    assert sp["edge"] == sp["blocks"][0][2]
    assert sp["ks"][-1] == 0


@pytest.mark.parametrize("width", [3, 5])
@pytest.mark.parametrize("field", FIELDS, ids=lambda f: f.name)
def test_packed_table_unpacks_to_the_host_model_values(field, width):
    spec = MySpec(width, width - 1)
    args = (field, width, spec.full_rounds(), spec.partial_rounds(), spec.secure_mds())
    words = cuda_sponge.constants_words(*args)
    vals = cuda_sponge.constants_ints(*args)
    lay = cuda_sponge.table_layout(width, spec.full_rounds(), spec.partial_rounds())
    assert words.dtype == np.uint32 and words.shape == (lay["rows"], 8) and words.flags.c_contiguous
    assert lay["rows"] == {3: 381, 5: 655}[width]
    assert cuda_sponge.unpack_words(field, words) == vals
    sp, mds, r_p = _matrices(field, width)
    assert vals[lay["c_hat"] : lay["ks"]] == sp["c_hat"]
    assert vals[lay["ks"] : lay["mds"]] == sp["ks"]
    assert vals[lay["edge"] : lay["sparse"]] == [v for row in sp["edge"] for v in row]
    for q in range(r_p):
        at = lay["sparse"] + q * (2 * width - 1)
        assert vals[at : at + 2 * width - 1] == sp["rows"][q] + sp["cols"][q], q


@pytest.mark.parametrize(
    "field, width, L", [(BN254_FR, 5, 4), (PASTA_FP, 3, 3)], ids=["bn254_fr-w5", "pasta_fp-w3"]
)
def test_sparse_sponge_equals_the_plain_dense_sponge(field, width, L):
    """A ConstantLength<L> sponge on the host model equals
    hash_device_plain (the dense rounds) limb for limb on 4 lanes."""
    from halo2_tpu_torch.field.host import field_class as port_field_class

    F = port_field_class(field)
    spec = MySpec(width, width - 1)
    rng = np.random.default_rng(width + L)
    msgs = [[int.from_bytes(rng.bytes(40), "little") % field.p for _ in range(4)] for _ in range(L)]
    df = get_device_field(field)
    limbs = torch.stack([df.encode(row) for row in msgs])
    want = hash_device_plain(df, spec, L, limbs)
    digests = []
    for b in range(4):
        rate = spec.rate
        words = [msgs[i][b] for i in range(L)] + [0] * (-L % rate)
        state = [0] * rate + [L << 64]
        for c in range(0, len(words), rate):
            state = [(v + w) % field.p for v, w in zip(state, words[c : c + rate] + [0])]
            state = [int(v) for v in cuda_sponge.permute_sparse_host(F, spec, state)]
        digests.append(state[0])
    assert torch.equal(df.encode(digests), want)
