"""The batched Montgomery multiply (``mont_mul_columns``) and the callers
that use it, against the reference on the CPU.

Limbs are integers, so every comparison is exact equality.  Inputs come
from numpy seeds.  The reference's ``mont_mul`` is reached through its
``DeviceField.mul`` on the CPU (its jnp path, as tests/test_pallas.py runs
it), with b broadcast the way each of the port's forms reads it.  The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import numpy as np
import pytest
import torch

from halo2_tpu.field.device import get_device_field as ref_field
from halo2_tpu.field.params import BN254_FQ as REF_FQ
from halo2_tpu.field.params import BN254_FR as REF_FR
from halo2_tpu.field.params import PASTA_FP as REF_PASTA_FP
from halo2_tpu.poly.domain import get_domain as ref_domain
from halo2_tpu_torch.field import cuda_mul
from halo2_tpu_torch.field.device import _period
from halo2_tpu_torch.field.device import get_device_field as port_field
from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP, to_limbs
from halo2_tpu_torch.parallel import jobs
from halo2_tpu_torch.parallel.launch import spawn
from halo2_tpu_torch.poly import domain as port_domain_mod
from halo2_tpu_torch.poly.domain import _ntt_raw, _stage_twiddles
from halo2_tpu_torch.poly.domain import get_domain as port_domain
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SPECS = {
    "bn254_fr": (BN254_FR, REF_FR),
    "bn254_fq": (BN254_FQ, REF_FQ),
    "pasta_fp": (PASTA_FP, REF_PASTA_FP),
}
N = 64  # elements a column


def _limbs(spec, shape, seed: int) -> np.ndarray:
    """Random canonical (16, *shape) uint32 limbs (top limb below p's),
    the first elements 0, 1 and p - 1."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, (16, *shape), dtype=np.uint32)
    x[15] = rng.integers(0, spec.p >> 240, shape, dtype=np.uint32)
    flat = x.reshape(16, -1)
    for i, v in enumerate((0, 1, spec.p - 1)[: flat.shape[1]]):
        flat[:, i] = to_limbs(v)
    return x


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _ref_mul(ref, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.asarray(ref_field(ref).mul(a, b))


# the forms of b for a (C, 16, n) batch: (name, b's shape, how the
# reference broadcasts it against a (16, C, n / P, P) view of a)
B_FORMS = ("full", "shared", "one", "period1", "period2", "period32")


def _b_of(form: str, cols: int, spec, seed: int):
    """(port b, reference b broadcasting against a's (16, C, n / P, P) view, P)."""
    if form == "full":
        b = _limbs(spec, (cols, N), seed)  # (16, C, n)
        return _t(b.transpose(1, 0, 2)), b.reshape(16, cols, 1, N), N
    if form == "shared":
        b = _limbs(spec, (N,), seed)
        return _t(b), b.reshape(16, 1, 1, N), N
    p = 1 if form == "one" else int(form[len("period"):])
    b = _limbs(spec, (p,), seed)
    return _t(b), b.reshape(16, 1, 1, p), p


@pytest.mark.parametrize("spec_name", list(SPECS))
@pytest.mark.parametrize("cols", [1, 3, 83])
@pytest.mark.parametrize("form", B_FORMS)
def test_mont_mul_columns_matches_reference(spec_name, cols, form):
    spec, ref = SPECS[spec_name]
    a = _limbs(spec, (cols, N), 100 + cols)  # (16, C, n)
    b, b_ref, p = _b_of(form, cols, spec, 200 + cols)
    want = _ref_mul(ref, a.reshape(16, cols, N // p, p), b_ref)
    want = want.reshape(16, cols, N).transpose(1, 0, 2)
    a_port = _t(a.transpose(1, 0, 2))  # (C, 16, n)
    got = cuda_mul.mont_mul_columns_plain(spec, a_port, b)
    assert got.shape == (cols, 16, N) and got.is_contiguous()
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # a CPU tensor: the plain version
    assert torch.equal(cuda_mul.mont_mul_columns(spec, a_port, b), got)
    if cols == 1 and form != "full":  # the flat (16, n) form
        flat = cuda_mul.mont_mul_columns(spec, a_port[0], b)
        assert flat.shape == (16, N) and torch.equal(flat, got[0])


def test_mont_mul_columns_takes_a_column_stride():
    """Columns that are slices of a wider batch (each contiguous, a stride
    between them) give the same product as the packed batch."""
    spec = BN254_FR
    wide = _t(_limbs(spec, (5, N), 7).transpose(1, 0, 2))  # (5, 16, n)
    a = wide[::2]  # columns 0, 2, 4: stride 2 * 16 * n
    assert not a.is_contiguous()
    b = _t(_limbs(spec, (N,), 8))
    got = cuda_mul.mont_mul_columns(spec, a, b)
    assert torch.equal(got, cuda_mul.mont_mul_columns(spec, a.contiguous(), b))


@pytest.mark.parametrize(
    "a_shape, b_shape",
    [
        ((16, 3, 8), (16, 3, 8)),   # b full width, but a's columns are not (16, n) contiguous
        ((4, 16, 8), (16, 3)),      # a period that does not divide n
        ((4, 16, 8), (16, 0)),
        ((4, 16, 8), (4, 16, 4)),
        ((4, 8, 8), (16, 1)),       # not 16 limbs
        ((2, 4, 16, 8), (16, 1)),   # more than one batch axis
    ],
)
def test_mont_mul_columns_rejects_what_the_kernel_does_not_take(a_shape, b_shape):
    a = torch.zeros(a_shape, dtype=torch.int32)
    b = torch.zeros(b_shape, dtype=torch.int32)
    if a_shape == (16, 3, 8):
        a, b = a.permute(1, 0, 2), b.permute(1, 0, 2)  # (3, 16, 8) with strided columns
    with pytest.raises(ValueError):
        cuda_mul.mont_mul_columns(BN254_FR, a, b)
    with pytest.raises(TypeError):
        a64 = torch.zeros((2, 16, 8), dtype=torch.int64)
        cuda_mul.mont_mul_columns(BN254_FR, a64, torch.zeros((16, 1), dtype=torch.int32))


@pytest.mark.parametrize(
    "shape, full, want",
    [
        ((16,), (16, 4, 8), 1),
        ((16, 1, 1), (16, 4, 8), 1),
        ((16, 1, 8), (16, 4, 8), 8),
        ((16, 8), (16, 4, 8), 8),
        ((16, 4, 8), (16, 4, 8), 32),
        ((16, 1, 1, 2, 8), (16, 3, 5, 2, 8), 16),
        ((16, 4, 1), (16, 4, 8), None),
        ((16, 2, 8), (16, 4, 2, 8), 16),
        ((16, 3, 1, 8), (16, 3, 2, 8), None),
    ],
)
def test_period_of_a_broadcast(shape, full, want):
    assert _period(shape, full) == want


@pytest.mark.parametrize("spec_name", list(SPECS))
def test_device_field_mul_broadcasts_match_reference(spec_name):
    """DeviceField.mul over the stage ladder's (16, 1, ..., m) twiddles, a
    one-element operand on either side, and a broadcast it materializes."""
    spec, ref = SPECS[spec_name]
    pf = port_field(spec)
    a = _limbs(spec, (3, 4, 8), 31)
    bs = [_limbs(spec, shape, 32 + i) for i, shape in enumerate([(1, 1, 8), (1, 1, 1), (3, 1, 1)])]
    for b in bs + [a[:, :1]]:
        want = _ref_mul(ref, a, b)
        assert np.array_equal(pf.mul(_t(a), _t(b)).numpy().view(np.uint32), want)
        assert np.array_equal(pf.mul(_t(b), _t(a)).numpy().view(np.uint32), want)
    assert pf.mul(_t(a)[:, :0], _t(a)[:, :1]).shape == (16, 0, 4, 8)


@pytest.mark.parametrize(
    "a_shape, b_shape",
    [((4,), (4,)), ((4,), (1,)), ((1,), (4,)), ((3, 4), (1, 4)), ((1, 4), (3, 4)), ((3, 1), (3, 4)),
     ((3, 4), (3, 1)), ((2, 3, 4), (1, 1, 4)), ((1, 1, 1), (2, 3, 4)), ((0,), (1,))],
)
def test_device_field_mul_routes_every_broadcast_like_the_reference(a_shape, b_shape):
    """Equal shapes and a one-element operand on either side (straight to
    mont_mul), a period and a broadcast it materializes (through
    mont_mul_columns): the reference's shape and limbs, both orders."""
    spec, ref = SPECS["bn254_fr"]
    pf = port_field(spec)
    a, b = _limbs(spec, a_shape, 71), _limbs(spec, b_shape, 72)
    want = _ref_mul(ref, a, b)
    for x, y in ((a, b), (b, a)):
        got = pf.mul(_t(x), _t(y))
        assert got.shape == want.shape and np.array_equal(got.numpy().view(np.uint32), want)


def test_mul_columns_is_one_call_for_a_batch(monkeypatch):
    """The coset scale and the iNTT's n^-1 of a 5-column batch each reach
    mont_mul_columns once (one kernel launch on the card)."""
    calls = []
    real = port_domain_mod.mont_mul_columns

    def counted(spec, a, b):
        calls.append((tuple(a.shape), tuple(b.shape)))
        return real(spec, a, b)

    monkeypatch.setattr(port_domain_mod, "mont_mul_columns", counted)
    pd = port_domain(BN254_FR, 5, 5)
    x = _t(_limbs(BN254_FR, (5, pd.n), 41).transpose(1, 0, 2))
    pd.coeff_to_extended(x)
    assert calls == [((5, 16, pd.extended_n), (16, pd.extended_n))]
    calls.clear()
    pd.lagrange_to_coeff(x)
    assert calls == [((5, 16, pd.n), (16, 1))]


@pytest.mark.parametrize("k", [5, 9])
def test_coset_transforms_of_a_batch_match_reference_columns(k):
    """coeff_to_extended and extended_to_coeff on a batch of 5 columns
    equal the reference's EvaluationDomain column by column."""
    pd, rd = port_domain(BN254_FR, k, 5), ref_domain(REF_FR, k, 5)
    cols = _limbs(BN254_FR, (5, pd.n), 50 + k)  # (16, 5, n)
    ext = pd.coeff_to_extended(_t(cols.transpose(1, 0, 2)))
    assert ext.shape == (5, 16, pd.extended_n)
    back = pd.extended_to_coeff(ext)
    for c in range(5):
        want_ext = np.asarray(rd.coeff_to_extended(np.ascontiguousarray(cols[:, c])))
        assert np.array_equal(ext[c].numpy().view(np.uint32), want_ext)
        want_back = np.asarray(rd.extended_to_coeff(want_ext))
        assert np.array_equal(back[c].numpy().view(np.uint32), want_back)


def test_stage_twiddles_are_cached_on_the_device():
    """The twiddle table of a transform below 512 points (one small-stages
    launch reads it) is made once per (spec, n, direction, device) and holds
    _stage_twiddles' limbs, stage m from column m - 1."""
    cpu = torch.device("cpu")
    first = port_domain_mod.twiddle_table(BN254_FR, 64, True, cpu)
    assert port_domain_mod.twiddle_table(BN254_FR, 64, True, cpu) is first
    stages = _stage_twiddles(BN254_FR, 64, True)
    assert [tw.shape[1] for tw in stages] == [1, 2, 4, 8, 16, 32]
    for tw in stages:
        m = tw.shape[1]
        assert np.array_equal(first[:, m - 1 : 2 * m - 1].numpy().view(np.uint32), tw)


@pytest.fixture(scope="module")
def sharded_w2():
    """Two gloo ranks (mesh (1, 2)) running the sharded NTT of a 3-column
    batch at 2^8 (local stage ladders) and 2^10, both directions."""
    x8 = _limbs(BN254_FR, (3, 1 << 8), 61).transpose(1, 0, 2).copy()
    x10 = _limbs(BN254_FR, (3, 1 << 10), 62).transpose(1, 0, 2).copy()
    job_list = [("ntt", {"x": x, "inverse": inv}) for x in (x8, x10) for inv in (False, True)]
    return [x8, x8, x10, x10], spawn(jobs.run, 2, "gloo", "cpu", job_list, dp=1)


@pytest.mark.parametrize("index", range(4))
def test_sharded_ntt_of_a_batch_matches_the_domain_ntt(sharded_w2, index):
    xs, ranks = sharded_w2
    x = _t(xs[index])
    want = _ntt_raw(BN254_FR, x.shape[-1], index % 2 == 1)(x).numpy()
    for rank in ranks:
        assert rank[index]["name"] == "ntt"
        assert np.array_equal(rank[index]["out"], want)


@pytest.mark.parametrize("spec_name", ["bn254_fq", "pasta_fp"])
def test_mul_chain_plain_matches_python_ints(spec_name):
    """mul_chain on CPU tensors (its plain version) is x <- x b R^-1, iters
    times, and raises on what the kernel does not take."""
    spec = SPECS[spec_name][0]
    p = spec.p
    pf = port_field(spec)
    a, b = 5 * p // 7, p - 3
    got = cuda_mul.mul_chain(spec, pf.encode([a], to_mont=False), pf.encode([b], to_mont=False), 9)
    x, rinv = a, pow(1 << 256, -1, p)
    for _ in range(9):
        x = x * b * rinv % p
    assert pf.decode(got, from_mont=False) == [x]
    with pytest.raises(ValueError):
        cuda_mul.mul_chain(spec, pf.encode([a, b]), pf.encode([a, b]), 1)
    with pytest.raises(ValueError):
        cuda_mul.mul_chain(spec, pf.encode([a]), pf.encode([b]), -1)
