"""halo2_tpu_torch NTT and evaluation domain against the reference, exactly.

Both sides of the n = 512 split are covered: below it the port runs the
stage ladder of field ops, from 512 up the NTT stage kernels' plain versions
(the kernels are held against those on the card by chip_smoke.py).

The reference NTT is reached two ways: its jitted ``_ntt_fn`` at n = 2^4
and 2^9 (BN254 Fr) and 2^10 .. 2^14 (Pasta Fp, whose NTT the native engine
lacks), and its native engine's ``ntt_fr``, which tests/test_native.py holds
equal to ``_ntt_fn``, at every n = 2^4 .. 2^14 (an XLA:CPU compile of
``_ntt_fn`` costs 5-20 s per size, too much to repeat ten times here).  The
coset transforms are held against the reference ``EvaluationDomain`` at
k = 5 and 9 (extended n = 128 and 2048, both sides of the split), and
against the reference's native engine at k = 9.  The large stages run as the
passes of ``large_stage_plan`` (several stages a launch on the card); the
plan and the fused plain version are checked on their own.
"""

import random
import types

import numpy as np
import pytest
import torch

from halo2_tpu import native
from halo2_tpu.field.device import get_device_field as ref_field
from halo2_tpu.field.params import BN254_FR as REF_FR
from halo2_tpu.field.params import PASTA_FP as REF_PASTA_FP
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
    cols = [
        df.encode([0, 1, spec.p - 1] + [rng.randrange(spec.p) for _ in range(n - 3)])
        for _ in range(3)
    ]
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
    arith = [cuda_ntt._arith(s) for s in (BN254_FR, BN254_FQ, PASTA_FP, PASTA_FQ)]
    assert arith == ["cc", "cc", "wide", "wide"]


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


@pytest.mark.parametrize("k", range(9, 21))
def test_large_stage_plan_covers_every_large_stage_once(k):
    """The plan runs the stages m = 512 .. n / 2 once each, in order, in
    ceil((k - 9) / 6) passes of at most 6 stages whose sizes differ by at
    most one."""
    n = 1 << k
    plan = cuda_ntt.large_stage_plan(n)
    stages = [m0 << i for m0, r in plan for i in range(r)]
    assert stages == [1 << j for j in range(9, k)]
    assert len(plan) == -(-(k - 9) // 6)
    sizes = [r for _m0, r in plan]
    assert all(1 <= r <= cuda_ntt.MAX_FUSED for r in sizes)
    assert not sizes or max(sizes) - min(sizes) <= 1
    assert sizes == sorted(sizes, reverse=True)
    assert plan == {11: [(512, 2)], 15: [(512, 6)], 20: [(512, 6), (32768, 5)]}.get(k, plan)


@pytest.mark.parametrize("spec", [BN254_FR, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("n", [1 << 11, 1 << 13])
@pytest.mark.parametrize("cols", [1, 3])
def test_fused_large_stages_equal_chained_single_stages(spec, n, cols):
    """ntt_large_stage(..., m0, stages=r), plain and through the wrapper on
    the CPU, equals r single stages chained, for every run of consecutive
    large stages, forward and inverse."""
    df = port_field(spec)
    rng = random.Random(n + cols)
    p = spec.p
    enc = [df.encode([0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)]) for _ in range(cols)]
    x = torch.stack(enc) if cols > 1 else enc[0]
    for inverse in (False, True):
        tw = twiddle_table(spec, n, inverse, torch.device("cpu"))
        m0 = cuda_ntt.TILE
        while m0 < n:
            y, r = x, 0
            while m0 << (r + 1) <= n and r < cuda_ntt.MAX_FUSED:
                y, r = cuda_ntt.ntt_large_stage_plain(spec, y, tw, m0 << r), r + 1
                assert torch.equal(cuda_ntt.ntt_large_stage_plain(spec, x, tw, m0, r), y), (m0, r)
                assert torch.equal(cuda_ntt.ntt_large_stage(spec, x, tw, m0, r), y), (m0, r)
            m0 *= 2


@pytest.mark.parametrize("k", range(10, 15))
@pytest.mark.parametrize("cols", [1, 3])
def test_ntt_stages_match_reference_native(k, cols):
    """BN254 Fr, forward and inverse, one column or a batch of three: the
    port's transform (small stages, then the plan's passes) equals the
    reference's native NTT of each column."""
    from halo2_tpu_torch.poly.domain import _ntt_raw

    n = 1 << k
    vals = [_values(n, seed=200 + 10 * k + c) for c in range(cols)]
    enc = [port_field(BN254_FR).encode(v) for v in vals]
    x = torch.stack(enc) if cols > 1 else enc[0]
    for inverse in (False, True):
        got = _ntt_raw(BN254_FR, n, inverse)(x)
        got = list(got) if cols > 1 else [got]
        for g, v in zip(got, vals):
            assert _ints(g) == native.unpack_ints(native.ntt_fr(native.pack_ints(v), inverse))


@pytest.mark.parametrize("k", range(10, 15))
def test_ntt_stages_match_reference_jit_pasta(k):
    """Pasta Fp (the 64-bit-accumulator arithmetic), forward: a batch of
    three columns and one column alone through the port's transform equal
    the reference's jitted NTT of each column."""
    from halo2_tpu_torch.poly.domain import _ntt_raw

    n = 1 << k
    rng = random.Random(300 + k)
    p = PASTA_FP.p
    vals = [[0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)] for _ in range(3)]
    ref = _ntt_fn(REF_PASTA_FP, n, False)
    want = [np.asarray(ref(ref_field(REF_PASTA_FP).encode_np(v))) for v in vals]
    x = torch.stack([port_field(PASTA_FP).encode(v) for v in vals])
    batch = _ntt_raw(PASTA_FP, n, False)(x)
    for c in range(3):
        assert np.array_equal(batch[c].numpy().view(np.uint32), want[c])
    alone = _ntt_raw(PASTA_FP, n, False)(x[1].contiguous())
    assert np.array_equal(alone.numpy().view(np.uint32), want[1])


def test_fused_large_stage_checks_its_span():
    spec = BN254_FR
    x = torch.zeros((16, 4096), dtype=torch.int32)
    tw = torch.zeros((16, 4095), dtype=torch.int32)
    assert torch.equal(cuda_ntt.ntt_large_stage(spec, x, tw, 512, 3), x)  # m0 2^3 = n
    for m0, stages in ((512, 0), (512, 4), (1024, 3), (512, 7), (768, 1)):
        with pytest.raises(ValueError):
            cuda_ntt.ntt_large_stage(spec, x, tw, m0, stages)
