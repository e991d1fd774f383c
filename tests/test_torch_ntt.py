"""halo2_tpu_torch NTT and evaluation domain against the reference, exactly.

Both sides of the n = 512 split are covered: below it the port runs the
stage ladder of field ops, from 512 up the NTT stage kernels' plain versions
(the kernels are held against those on the card by chip_smoke.py).

The reference NTT is reached two ways: its jitted ``_ntt_fn`` at n = 2^4
and 2^9, and its native engine's ``ntt_fr``, which tests/test_native.py holds
equal to ``_ntt_fn``, at every n = 2^4 .. 2^13 (an XLA:CPU compile of
``_ntt_fn`` costs 5-20 s per size, too much to repeat ten times here).  The
coset transforms are held against the reference ``EvaluationDomain`` at
k = 5 and 9 (extended n = 128 and 2048, both sides of the split), and
against the reference's native engine at k = 9.
"""

import random
import types

import numpy as np
import pytest
import torch

from halo2_tpu import native
from halo2_tpu.field.device import get_device_field as ref_field
from halo2_tpu.field.params import BN254_FR as REF_FR
from halo2_tpu.kzg.engine import NativeEngine
from halo2_tpu.poly.domain import _ntt_fn
from halo2_tpu.poly.domain import get_domain as ref_domain
from halo2_tpu_torch.field.device import get_device_field as port_field
from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP, PASTA_FQ
from halo2_tpu_torch.kzg.engine import TorchEngine
from halo2_tpu_torch.poly import cuda_ntt
from halo2_tpu_torch.poly.domain import get_domain as port_domain
from halo2_tpu_torch.poly.domain import twiddle_table
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

P = BN254_FR.p
DEGREE = 5  # extended domain = 4n


def _values(n: int, seed: int) -> list:
    rng = random.Random(seed)
    return [0, 1, P - 1] + [rng.randrange(P) for _ in range(n - 3)]


def _ints(port_out: torch.Tensor) -> list:
    assert port_out.dtype == torch.int32
    assert int(port_out.max()) < 1 << 16, "a limb is >= 2^16"
    return [int(v) for v in port_field(BN254_FR).decode(port_out)]


@pytest.mark.parametrize("k", [4, 9])
def test_ntt_matches_reference_jit(k):
    n = 1 << k
    vals = _values(n, seed=k)
    rf = ref_field(REF_FR)
    dom = port_domain(BN254_FR, k, DEGREE)
    x = port_field(BN254_FR).encode(vals)
    for port_fn, inverse in ((dom.coeff_to_lagrange, False), (dom.lagrange_to_coeff, True)):
        want = np.asarray(_ntt_fn(REF_FR, n, inverse)(rf.encode(vals)))
        assert np.array_equal(port_fn(x).numpy().view(np.uint32), want)


@pytest.mark.parametrize("k", range(4, 14))
def test_ntt_matches_reference_native(k):
    n = 1 << k
    vals = _values(n, seed=100 + k)
    dom = port_domain(BN254_FR, k, DEGREE)
    x = port_field(BN254_FR).encode(vals)
    fwd = dom.coeff_to_lagrange(x)
    assert _ints(fwd) == native.unpack_ints(native.ntt_fr(native.pack_ints(vals), False))
    back = dom.lagrange_to_coeff(x)
    assert _ints(back) == native.unpack_ints(native.ntt_fr(native.pack_ints(vals), True))
    assert torch.equal(dom.lagrange_to_coeff(fwd), x)


@pytest.mark.parametrize("k", [5, 9])
def test_extended_matches_reference_domain(k):
    rd, pd = ref_domain(REF_FR, k, DEGREE), port_domain(BN254_FR, k, DEGREE)
    assert (pd.extended_k, pd.omega, pd.extended_omega, pd.g_coset) == (
        rd.extended_k, rd.omega, rd.extended_omega, rd.g_coset,
    )
    coeffs = ref_field(REF_FR).encode_np(_values(pd.n, seed=7))
    ext = pd.coeff_to_extended(torch.from_numpy(coeffs.view(np.int32)))
    ext_ref = rd.coeff_to_extended(coeffs)
    assert np.array_equal(ext.numpy().view(np.uint32), np.asarray(ext_ref))
    back = pd.extended_to_coeff(ext)
    assert np.array_equal(back.numpy().view(np.uint32), np.asarray(rd.extended_to_coeff(ext_ref)))
    vinv = pd.vanishing_inv_extended(torch.device("cpu"))
    assert np.array_equal(vinv.numpy().view(np.uint32), np.asarray(rd.vanishing_inv_extended()))


def test_extended_matches_reference_native_engine():
    """At k = 9 (extended n = 2048, above the kernel split) against the
    reference's native engine, whose proofs equal its device engine's."""
    k = 9
    rd, pd = ref_domain(REF_FR, k, DEGREE), port_domain(BN254_FR, k, DEGREE)
    eng = NativeEngine(None, types.SimpleNamespace(domain=rd, n=rd.n))
    vals = _values(pd.n, seed=9)
    ext = pd.coeff_to_extended(port_field(BN254_FR).encode(vals))
    ext_ref = eng.coeff_to_extended(native.pack_ints(vals))
    assert _ints(ext) == native.unpack_ints(ext_ref)
    back = pd.extended_to_coeff(ext)
    assert _ints(back) == native.unpack_ints(eng.extended_to_coeff(ext_ref))
    assert _ints(back)[: pd.n] == vals and not any(_ints(back)[pd.n :])


def test_ntt_wrappers_check_their_inputs():
    spec = BN254_FR
    x = torch.zeros((16, 1024), dtype=torch.int32)
    tw = torch.zeros((16, 1023), dtype=torch.int32)
    cuda_ntt.ntt_large_stage(spec, x, tw, 512)
    with pytest.raises(ValueError):
        cuda_ntt.ntt_small_stages(spec, x[:, :256], tw[:, :255])
    with pytest.raises(ValueError):
        cuda_ntt.ntt_small_stages(spec, x, tw[:, :100])
    with pytest.raises(ValueError):
        cuda_ntt.ntt_large_stage(spec, x, tw, 256)
    with pytest.raises(TypeError):
        cuda_ntt.ntt_small_stages(spec, x.to(torch.int64), tw)


@pytest.mark.parametrize("spec", [BN254_FR, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("n", [512, 2048])
def test_batched_stage_plain_versions_equal_per_column(spec, n):
    """The stage functions over a (3, 16, n) batch equal them on each column,
    with the one (16, n - 1) twiddle table shared."""
    df = port_field(spec)
    rng = random.Random(n)
    cols = [df.encode([0, 1, spec.p - 1] + [rng.randrange(spec.p) for _ in range(n - 3)]) for _ in range(3)]
    batch = torch.stack(cols)
    for inverse in (False, True):
        tw = twiddle_table(spec, n, inverse, torch.device("cpu"))
        small = cuda_ntt.ntt_small_stages(spec, batch, tw)
        assert small.shape == batch.shape and small.is_contiguous()
        for c in range(3):
            assert torch.equal(small[c], cuda_ntt.ntt_small_stages(spec, cols[c], tw))
        for m in (512, n // 2) if n > 512 else ():
            large = cuda_ntt.ntt_large_stage(spec, small, tw, m)
            for c in range(3):
                assert torch.equal(large[c], cuda_ntt.ntt_large_stage(spec, small[c], tw, m))
        full = cuda_ntt.ntt_stages(spec, batch, tw)
        for c in range(3):
            assert torch.equal(full[c], cuda_ntt.ntt_stages(spec, cols[c], tw))


def test_arith_switch_is_by_modulus_size():
    assert [cuda_ntt._arith(s) for s in (BN254_FR, BN254_FQ, PASTA_FP, PASTA_FQ)] == ["cc", "cc", "wide", "wide"]


def test_mont_mul_into_fills_one_column_of_a_batch():
    """The batched transforms' per-column product writes into its slot of
    the batch and nowhere else, and refuses an out it cannot fill."""
    from halo2_tpu_torch.field.cuda_mul import _mont_mul_into, mont_mul

    df = port_field(BN254_FR)
    rng = random.Random(3)
    batch = torch.stack([df.encode([rng.randrange(P) for _ in range(8)]) for _ in range(3)])
    b = df.encode([rng.randrange(P)])
    out = torch.zeros_like(batch)
    assert _mont_mul_into(BN254_FR, batch[1], b, out[1]) is not None
    assert torch.equal(out[1], mont_mul(BN254_FR, batch[1], b))
    assert not out[0].any() and not out[2].any()
    with pytest.raises(ValueError):
        _mont_mul_into(BN254_FR, batch[1], b, out[1][:, :4])
    with pytest.raises(ValueError):
        _mont_mul_into(BN254_FR, batch[1], b, out.transpose(1, 2)[1])


@pytest.mark.parametrize("k", [5, 9])
def test_coeff_to_extended_many_matches_reference_domain(k):
    """TorchEngine's one batched pad + coset scale + NTT over three columns
    (one shorter than n) equals the reference's per-column coeff_to_extended."""
    rd, pd = ref_domain(REF_FR, k, DEGREE), port_domain(BN254_FR, k, DEGREE)
    eng = TorchEngine(None, types.SimpleNamespace(domain=pd), "cpu")
    cols = [ref_field(REF_FR).encode_np(_values(pd.n, seed=20 + i)) for i in range(3)]
    cols[2] = cols[2][:, : pd.n // 2]
    got = eng.coeff_to_extended_many([torch.from_numpy(c.view(np.int32)) for c in cols])
    assert len(got) == 3
    for g, c in zip(got, cols):
        assert g.shape == (16, pd.extended_n) and g.is_contiguous()
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(rd.coeff_to_extended(c)))
    back = pd.extended_to_coeff(torch.stack(got))
    for b, g in zip(back, got):
        assert torch.equal(b, pd.extended_to_coeff(g))
    assert eng.coeff_to_extended_many([]) == []


@pytest.mark.parametrize("k", [4, 9])
def test_batched_intt_columns_matches_reference(k, monkeypatch):
    """keygen's batched iNTT on the CPU equals the reference's per-column
    device branch (its ``jnp.stack`` of ``lagrange_to_coeff``), which it
    takes without the native engine."""
    import halo2_tpu.native as ref_native
    from halo2_tpu.kzg.keygen import _intt_columns as ref_intt_columns
    from halo2_tpu_torch.kzg.keygen import _intt_columns

    n = 1 << k
    values = [_values(n, seed=40 + i) for i in range(3)]
    monkeypatch.setattr(ref_native, "available", lambda: False)
    want = np.asarray(ref_intt_columns(ref_domain(REF_FR, k, DEGREE), ref_field(REF_FR), values, n))
    got = _intt_columns(port_domain(BN254_FR, k, DEGREE), values, device="cpu")
    assert got.shape == (3, 16, n)
    assert np.array_equal(got.numpy().view(np.uint32), want)
