"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without a CUDA device every test skips.  This file imports
no JAX, so it runs on the machine with the card, where JAX is absent and
tests/conftest.py (which imports it) must be left out:

    python -m pytest tests/test_torch_cuda.py --noconftest -q -m cuda
"""

import os
import pickle
import random

import numpy as np
import pytest
import torch

from halo2_tpu_torch import native
from halo2_tpu_torch.ec import cuda_jac
from halo2_tpu_torch.ec import device as ecd
from halo2_tpu_torch.field import cuda_mul, cuda_ops
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR, PASTA_FP
from halo2_tpu_torch.plonkish import cuda_vm
from halo2_tpu_torch.plonkish.evaluator import Program, _run_program
from halo2_tpu_torch.poly import cuda_ntt
from halo2_tpu_torch.poly.domain import _ntt_raw, twiddle_table

pytestmark = pytest.mark.cuda
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _encoded(spec, n, seed, device):
    rng = random.Random(seed)
    p = spec.p
    vals = ([0, 1, p - 1, p - 2] + [rng.randrange(p) for _ in range(n)])[:n]
    return get_device_field(spec).encode(vals, device=device)


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("m", [1, 511, 513, 4096])
def test_mont_mul_kernel_matches_plain(device, spec, m):
    a = _encoded(spec, m, 1, device)
    b = _encoded(spec, m, 2, device).flip(1).contiguous()
    col = _encoded(spec, 1, 3, device)
    before = cuda_mul.LAUNCHES["mont_mul"]
    for bb in (b, col):
        got = cuda_mul.mont_mul(spec, a, bb)
        torch.cuda.synchronize(device)
        assert torch.equal(got, cuda_mul.mont_mul_plain(spec, a, bb))
    assert cuda_mul.LAUNCHES["mont_mul"] == before + 2


@pytest.mark.parametrize("k", [9, 12])
@pytest.mark.parametrize("inverse", [False, True])
def test_ntt_kernels_match_plain(device, k, inverse):
    spec, n = BN254_FR, 1 << k
    x = _encoded(spec, n, k, device)
    tw = twiddle_table(spec, n, inverse, device)
    y = cuda_ntt.ntt_small_stages(spec, x, tw)
    assert torch.equal(y, cuda_ntt.ntt_small_stages_plain(spec, x, tw))
    m = cuda_ntt.TILE
    while m < n:
        z = cuda_ntt.ntt_large_stage(spec, y, tw, m)
        assert torch.equal(z, cuda_ntt.ntt_large_stage_plain(spec, y, tw, m))
        y, m = z, m * 2
    torch.cuda.synchronize(device)
    assert torch.equal(_ntt_raw(spec, n, True)(_ntt_raw(spec, n, False)(x)), x)


@pytest.mark.parametrize("spec", [BN254_FR, PASTA_FP], ids=lambda s: s.name)
def test_batched_ntt_kernels_match_plain(device, spec):
    """Three columns in one launch, both arithmetics (``cuda_ntt._arith``)."""
    n = 1 << 11
    x = torch.stack([_encoded(spec, n, 20 + c, device) for c in range(3)])
    tw = twiddle_table(spec, n, False, device)
    before = dict(cuda_ntt.LAUNCHES)
    y = cuda_ntt.ntt_small_stages(spec, x, tw)
    z = cuda_ntt.ntt_large_stage(spec, y, tw, 512)
    assert cuda_ntt.LAUNCHES["ntt_small_stages"] == before["ntt_small_stages"] + 1
    assert cuda_ntt.LAUNCHES["ntt_large_stage"] == before["ntt_large_stage"] + 1
    torch.cuda.synchronize(device)
    assert torch.equal(y, cuda_ntt.ntt_small_stages_plain(spec, x, tw))
    assert torch.equal(z, cuda_ntt.ntt_large_stage_plain(spec, y, tw, 512))
    assert torch.equal(_ntt_raw(spec, n, True)(_ntt_raw(spec, n, False)(x)), x)


def test_cuda_ntt_matches_cpu_ntt(device):
    spec, n = BN254_FR, 1 << 11
    x = _encoded(spec, n, 5, torch.device("cpu"))
    want = _ntt_raw(spec, n, False)(x)
    got = _ntt_raw(spec, n, False)(x.to(device))
    assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("m", [1, 511, 513, 4096])
def test_mont_sqr_kernel_matches_plain(device, spec, m):
    a = _encoded(spec, m, 4, device)
    before = cuda_mul.LAUNCHES["mont_sqr"]
    got = cuda_mul.mont_sqr(spec, a)
    torch.cuda.synchronize(device)
    assert torch.equal(got, cuda_mul.mont_sqr_plain(spec, a))
    assert torch.equal(got, cuda_mul.mont_mul(spec, a, a))
    assert cuda_mul.LAUNCHES["mont_sqr"] == before + 1


def _srs(n, device):
    with open(os.path.join(ROOT, ".srs", "kzg_bn254_k13_s857536.pkl"), "rb") as f:
        data = pickle.load(f)
    px, py = (np.ascontiguousarray(data[k][:, :n]) for k in ("g1_x", "g1_y"))
    return px, py, *(torch.from_numpy(a.view(np.int32)).to(device) for a in (px, py))


def _points(m, device):
    """p: points with z != 1 (doubled); q: affine points.  Lane 0: P == Q,
    lane 1: P == -Q, lane 2: P at infinity, lane 3: Q at infinity (full add)
    or masked (mixed add)."""
    _, _, x, y = _srs(2 * m, device)
    p = ecd.jac_double(ecd.jac_from_affine(x[:, :m].contiguous(), y[:, :m].contiguous()))
    qx, qy = x[:, m:].contiguous(), y[:, m:].contiguous()
    ax, ay = ecd.jac_to_affine(p)
    qx[:, :2], qy[:, 0], qy[:, 1] = ax[:, :2], ay[:, 0], ecd.df().neg(ay)[:, 1]
    q = ecd.jac_double(ecd.jac_from_affine(qx, qy))
    for k in q:
        q[k][:, 0] = p[k][:, 0]
    q["x"][:, 1], q["y"][:, 1], q["z"][:, 1] = (
        p["x"][:, 1], ecd.df().neg(p["y"])[:, 1], p["z"][:, 1]
    )
    inf = ecd.jac_infinity((), device=device)
    for k in p:
        p[k][:, 2] = inf[k]
        q[k][:, 3] = inf[k]
    valid = torch.ones(m, dtype=torch.bool, device=device)
    valid[3] = False
    return p, q, qx, qy, valid


@pytest.fixture
def flag_reads(monkeypatch):
    """Counts calls of the plain versions' P == Q fix-up, each one device ->
    host read; the CUDA path must make none."""
    calls = []
    orig = cuda_jac._double_fixup

    def counted(*args):
        calls.append(1)
        return orig(*args)

    monkeypatch.setattr(cuda_jac, "_double_fixup", counted)
    return calls


@pytest.mark.parametrize("m", [8, 513, 4096])
def test_jac_kernels_match_plain(device, m, flag_reads):
    p, q, qx, qy, valid = _points(m, device)
    before = dict(cuda_jac.LAUNCHES)
    for which in cuda_jac.VARIANTS:
        got_madd = cuda_jac._jac_madd(p, qx, qy, valid, which)
        got_add = cuda_jac._jac_add(p, q, which)
        torch.cuda.synchronize(device)
        assert flag_reads == [], which
        want_madd = cuda_jac.jac_madd_plain(p, qx, qy, valid)
        want_add = cuda_jac.jac_add_plain(p, q)
        for k in ("x", "y", "z"):
            assert torch.equal(got_madd[k], want_madd[k]), (which, k)
            assert torch.equal(got_add[k], want_add[k]), (which, k)
        flag_reads.clear()
    assert cuda_jac.LAUNCHES["jac_madd"] == before["jac_madd"] + len(cuda_jac.VARIANTS)
    assert cuda_jac.LAUNCHES["jac_add"] == before["jac_add"] + len(cuda_jac.VARIANTS)


def _window_stack(batch, windows, c, device):
    """(3, 16, batch, windows) window sums on the card: SRS points doubled
    (z != 1); window 3 of every lane at infinity; lane 0's second window
    2^c times its top one (the accumulator equals it: P == Q), lane 1's its
    negative, lane 2's top three windows at infinity (a leading run)."""
    _, _, x, y = _srs(batch * windows, device)
    pts = ecd.jac_double(ecd.jac_from_affine(x, y))
    w = torch.stack([pts[k] for k in ("x", "y", "z")]).reshape(3, 16, batch, windows).contiguous()
    top = {k: w[i, :, :, -1].contiguous() for i, k in enumerate(("x", "y", "z"))}
    for _ in range(c):
        top = ecd.jac_double(top)
    inf = torch.stack([v for v in ecd.jac_infinity((), device=device).values()])
    w[:, :, :, 3] = inf[:, :, None]
    w[:, :, 0, -2] = torch.stack([top[k][:, 0] for k in ("x", "y", "z")])
    if batch > 1:
        w[:, :, 1, -2] = torch.stack([top["x"][:, 1], ecd.df().neg(top["y"])[:, 1], top["z"][:, 1]])
    if batch > 2:
        w[:, :, 2, -3:] = inf[:, :, None]
    return w


@pytest.mark.parametrize("batch", [1, 5, 32, 33, 64])
def test_jac_horner_kernel_matches_plain(device, batch, flag_reads):
    """The flagship's Horner (32 windows, c = 8) in one launch equals the
    plain loop limb for limb, reading no P == Q flag back."""
    w = _window_stack(batch, 32, 8, device)
    before = cuda_jac.LAUNCHES["jac_horner"]
    got = cuda_jac.jac_horner_cuda(w, 8)
    torch.cuda.synchronize(device)
    assert cuda_jac.LAUNCHES["jac_horner"] == before + 1
    assert flag_reads == []
    want = cuda_jac.horner_plain(w, 8)
    for k in ("x", "y", "z"):
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(ecd._horner_device(w, 8)["y"], want["y"])
    assert cuda_jac.LAUNCHES["jac_horner"] == before + 2


@pytest.mark.parametrize(
    "c, windows, batch", [(8, 32, 20), (12, 22, 1), (4, 64, 1), (4, 64, 8), (4, 64, 20)]
)
def test_jac_horner_kernel_matches_plain_at_every_path_shape(device, c, windows, batch):
    """The Horner at the shapes of the sharded MSM 2^16 at W = 2 (c = 12)
    and the dryrun checks (c = 4, 64 windows) and the flagship's widest
    commit batch, equal to the plain loop limb for limb."""
    w = _window_stack(batch, windows, c, device)
    got = cuda_jac.jac_horner_cuda(w, c)
    torch.cuda.synchronize(device)
    want = cuda_jac.horner_plain(w, c)
    for k in ("x", "y", "z"):
        assert torch.equal(got[k], want[k]), k


def _columns(spec, cols, n, seed, device):
    return torch.stack([_encoded(spec, n, seed + i, device) for i in range(cols)])


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize(
    "case",
    ["83x2^15 shared", "1x2^11 one", "ladder P=1", "ladder P=2", "ladder P=32", "ladder P=128",
     "sharded ladder 83x2^14", "sharded ladder 83x2^13", "3x2^11 full", "strided", "ragged",
     "ragged 131x1001"],
)
def test_mont_mul_columns_kernel_matches_plain(device, spec, case):
    """The batched product in one launch at the main paths' shapes: the
    flagship's coset scale, an iNTT's n^-1, the stage ladders of a 2^15
    column (2^14 elements, twiddles of period P), the sharded flagship's
    ladder stages (83 columns of 2^15 a transform, 83 x 2^14 elements a
    stage at W = 1 and 83 x 2^13 a rank at W = 2, four elements a thread,
    every P = 1 .. 128), a full-width batch, strided columns, and a ragged
    n, small and past the four-element threshold (one element a thread)."""
    if case.startswith("sharded ladder"):
        a = _encoded(spec, 83 << int(case[-2:]), 10, device)
        for lp in range(8):
            b = _encoded(spec, 1 << lp, 9 + lp, device)
            before = cuda_mul.LAUNCHES["mont_mul"]
            got = cuda_mul.mont_mul_columns(spec, a, b)
            torch.cuda.synchronize(device)
            assert cuda_mul.LAUNCHES["mont_mul"] == before + 1
            assert torch.equal(got, cuda_mul.mont_mul_columns_plain(spec, a, b)), 1 << lp
        return
    if case == "83x2^15 shared":
        a, b = _columns(spec, 83, 1 << 15, 10, device), _encoded(spec, 1 << 15, 9, device)
    elif case == "1x2^11 one":
        a, b = _encoded(spec, 1 << 11, 10, device), _encoded(spec, 1, 9, device)
    elif case.startswith("ladder"):
        period = int(case[len("ladder P="):])
        a, b = _encoded(spec, 1 << 14, 10, device), _encoded(spec, period, 9, device)
    elif case == "3x2^11 full":
        a, b = _columns(spec, 3, 1 << 11, 10, device), _columns(spec, 3, 1 << 11, 20, device)
    elif case == "strided":
        a = _columns(spec, 5, 1 << 11, 10, device)[::2]
        b = _columns(spec, 5, 1 << 11, 20, device)[::2]
    elif case == "ragged":
        a, b = _columns(spec, 3, 1001, 10, device), _encoded(spec, 1001, 9, device)
    else:
        a, b = _columns(spec, 131, 1001, 10, device), _encoded(spec, 1001, 9, device)
    before = cuda_mul.LAUNCHES["mont_mul"]
    got = cuda_mul.mont_mul_columns(spec, a, b)
    torch.cuda.synchronize(device)
    assert cuda_mul.LAUNCHES["mont_mul"] == before + 1
    assert torch.equal(got, cuda_mul.mont_mul_columns_plain(spec, a, b))


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ, PASTA_FP], ids=lambda s: s.name)
def test_mul_chain_products_match_python_ints(device, spec):
    """The kernels' Montgomery product (carry chains) chained 1000 times in
    one thread equals Python ints."""
    df = get_device_field(spec)
    av, bv = random.Random(1).randrange(spec.p), random.Random(2).randrange(spec.p)
    a = df.encode([av], to_mont=False, device=device)
    b = df.encode([bv], to_mont=False, device=device)
    want, rinv = av, pow(1 << 256, -1, spec.p)
    for _ in range(1000):
        want = want * bv * rinv % spec.p
    got = cuda_mul.mul_chain(spec, a, b, 1000)
    assert df.decode(got.cpu(), from_mont=False) == [want]


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("m", [1, 1 << 10, 1 << 16])
def test_mont_pow_kernel_matches_plain(device, spec, m):
    """The whole ladder in one launch a call, for p - 2 (the inverse), 0, 1,
    2 and a 300-bit exponent, on values that include 0, 1 and p - 1."""
    a = _encoded(spec, m, 5, device)
    exps = (spec.p - 2, 0, 1, 2, random.Random(300).randrange(1 << 299, 1 << 300))
    before = cuda_mul.LAUNCHES["mont_pow"]
    for e in exps:
        got = cuda_mul.mont_pow(spec, a, e)
        torch.cuda.synchronize(device)
        assert torch.equal(got, cuda_mul.mont_pow_plain(spec, a, e)), e
    inv = get_device_field(spec).pow_fixed(a, spec.p - 2)  # pow_fixed is the one DeviceField caller
    torch.cuda.synchronize(device)
    assert cuda_mul.LAUNCHES["mont_pow"] == before + len(exps) + 1
    assert torch.equal(inv, cuda_mul.mont_pow_plain(spec, a, spec.p - 2))


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("m", [1, 1 << 10, 1 << 11, 1 << 16])
def test_mont_inv_kernel_matches_plain(device, spec, m):
    """The safegcd inverse in one launch (DeviceField.inv's, which launches
    no mont_pow) against its plain version and the mont_pow kernel's
    a^(p - 2), on values that include 0, 1, p - 1 and p - 2."""
    a = _encoded(spec, m, 7, device)
    before = dict(cuda_mul.LAUNCHES)
    got = get_device_field(spec).inv(a)
    torch.cuda.synchronize(device)
    assert cuda_mul.LAUNCHES["mont_inv"] == before["mont_inv"] + 1
    assert cuda_mul.LAUNCHES["mont_pow"] == before["mont_pow"]
    assert torch.equal(got, cuda_mul.mont_inv_plain(spec, a))
    assert torch.equal(got, cuda_mul.mont_pow(spec, a, spec.p - 2))
    assert int(got[:, 0].abs().sum()) == 0  # inv(0) = 0


@pytest.mark.parametrize("spec", [BN254_FR, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("group", cuda_mul.INV_GROUPS, ids=lambda g: f"G{g}")
@pytest.mark.parametrize("m", [1, 3, 5, (1 << 11) - 1, 1 << 11, 4096, 8192, 16384, 1 << 16])
def test_mont_inv_groups_match_plain(device, spec, group, m):
    """The mont_inv kernel with each G lanes an element, forced, at the
    sizes a group leaves ragged, the sharded grand product's 2^11 and
    batched 4,096 (a W = 2 rank's chunks), 8,192 and 16,384, and setup's
    2^16: one launch a call, the plain version's limbs (0, 1, p - 1 and
    p - 2 first)."""
    a = _encoded(spec, m, 11, device)
    before = cuda_mul.LAUNCHES["mont_inv"]
    got = cuda_mul._mont_inv(spec, a, group)
    torch.cuda.synchronize(device)
    assert cuda_mul.LAUNCHES["mont_inv"] == before + 1
    assert torch.equal(got, cuda_mul.mont_inv_plain(spec, a))


@pytest.mark.parametrize("spec", [BN254_FR, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("n", [1 << k for k in range(9)])
@pytest.mark.parametrize("cols", [1, 3])
def test_small_ntt_kernel_matches_plain(device, spec, n, cols):
    """Below 512 points one ntt_small_stages launch is the whole transform
    (natural order in, the bit-reversal in the kernel's load), forward and
    inverse, against its plain version."""
    enc = [_encoded(spec, n, 50 + c, device) for c in range(cols)]
    x = torch.stack(enc) if cols > 1 else enc[0]
    for inverse in (False, True):
        tw = twiddle_table(spec, n, inverse, device)
        before = cuda_ntt.LAUNCHES["ntt_small_stages"]
        got = cuda_ntt.ntt_small_stages(spec, x, tw)
        torch.cuda.synchronize(device)
        assert cuda_ntt.LAUNCHES["ntt_small_stages"] == before + 1
        assert torch.equal(got, cuda_ntt.ntt_small_stages_plain(spec, x, tw))


@pytest.mark.parametrize(
    "cols, n",
    [(32, 64), (64, 32), (16, 64), (32, 32), (83 * 128, 256), (83 * 256, 128), (83 * 64, 256),
     (83 * 128, 128), (32, 16)],
)
def test_small_ntt_kernel_at_the_sharded_shapes(device, cols, n):
    """The local transforms the sharded prover gives the kernel: 2^11 as 32
    x 64 then 64 x 32 points, 2^15 over 83 columns as 83 x 128 x 256 then 83
    x 256 x 128 (W = 1), their W = 2 halves, and the dryrun's k = 9."""
    spec = BN254_FR
    gen = torch.Generator(device=device)
    gen.manual_seed(cols + n)
    x = torch.randint(0, 1 << 16, (cols, 16, n), generator=gen, device=device, dtype=torch.int32)
    top = spec.p >> 240
    x[:, 15] = torch.randint(0, top, (cols, n), generator=gen, device=device, dtype=torch.int32)
    tw = twiddle_table(spec, n, False, device)
    got = cuda_ntt.ntt_small_stages(spec, x, tw)
    torch.cuda.synchronize(device)
    assert torch.equal(got, cuda_ntt.ntt_small_stages_plain(spec, x, tw))


def test_ntt_below_512_launches_no_field_op(device):
    """_ntt_raw below 512 points and sharded_ntt at 2^11 (one rank, gloo
    through host memory) launch one ntt_small_stages a local transform and
    no mod_add or mod_sub."""
    import tempfile

    import torch.distributed as dist

    from halo2_tpu_torch.parallel import make_mesh
    from halo2_tpu_torch.parallel.ntt import sharded_ntt

    spec = BN254_FR
    x = torch.stack([_encoded(spec, 1 << 11, 60 + c, device) for c in range(3)])
    before = {**cuda_ntt.LAUNCHES, **cuda_ops.LAUNCHES}
    y = _ntt_raw(spec, 64, False)(x[:, :, :64].contiguous())
    torch.cuda.synchronize(device)
    assert cuda_ntt.LAUNCHES["ntt_small_stages"] == before["ntt_small_stages"] + 1
    assert torch.equal(y.cpu(), _ntt_raw(spec, 64, False)(x[:, :, :64].cpu().contiguous()))
    with tempfile.TemporaryDirectory(prefix="h2t_gloo_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        dist.init_process_group("gloo", init_method=init, rank=0, world_size=1)
        try:
            got = sharded_ntt(make_mesh(1), spec, x)
        finally:
            dist.destroy_process_group()
    torch.cuda.synchronize(device)
    assert cuda_ntt.LAUNCHES["ntt_small_stages"] == before["ntt_small_stages"] + 3
    assert cuda_ntt.LAUNCHES["ntt_large_stage"] == before["ntt_large_stage"]
    for op in ("mod_add", "mod_sub"):
        assert cuda_ops.LAUNCHES[op] == before[op]
    assert torch.equal(got, _ntt_raw(spec, 1 << 11, False)(x))


def test_ladder_wrappers_raise_on_bad_inputs(device):
    spec = BN254_FR
    a = _encoded(spec, 64, 6, device)
    with pytest.raises(TypeError):
        cuda_mul.mont_pow(spec, a.to(torch.int64), 5)
    with pytest.raises(ValueError):
        cuda_mul.mont_pow(spec, a[:, ::2], 5)
    with pytest.raises(TypeError):
        cuda_mul.mont_inv(spec, a.to(torch.int64))
    with pytest.raises(ValueError):
        cuda_mul.mont_inv(spec, a[:, ::2])
    w = _window_stack(3, 6, 4, device)
    with pytest.raises(TypeError):
        cuda_jac.jac_horner_cuda(w.to(torch.int64), 4)
    with pytest.raises(ValueError):
        cuda_jac.jac_horner_cuda(w[..., ::2], 4)


def test_msm_points_matches_native(device, flag_reads):
    n = 1 << 12
    rng = random.Random(12)
    px, py, x, y = _srs(n, device)
    sc = get_device_field(BN254_FR).encode_np(
        [rng.randrange(BN254_FR.p) for _ in range(n)], to_mont=False
    )
    before = dict(cuda_jac.LAUNCHES)
    got = ecd.msm_points(x, y, torch.from_numpy(sc.view(np.int32)).to(device))
    want = native.msm_g1_mont(
        native.pack_device(px), native.pack_device(py), native.pack_device(sc)
    )
    assert got == want
    assert cuda_jac.LAUNCHES["msm_chunk_acc"] > before["msm_chunk_acc"]
    assert cuda_jac.LAUNCHES["jac_add"] > before["jac_add"]
    assert flag_reads == []


def test_entry_points_default_to_the_card(device):
    from halo2_tpu_torch._device import resolve_device
    from halo2_tpu_torch.circuits.less_than import LessThanCircuit
    from halo2_tpu_torch.dev import MockProver
    from halo2_tpu_torch.field import Fp
    from halo2_tpu_torch.plonkish import Value

    assert resolve_device(None).type == "cuda"
    circuit = LessThanCircuit(Fp, Value.known(Fp.from_u64(3)))
    prover = MockProver.run(10, circuit, [[Fp.from_u64(i) for i in range(754)]], F=Fp)
    assert prover.device.type == "cuda"
    assert prover.verify() == []


@pytest.mark.parametrize("spec", [BN254_FR, BN254_FQ, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("m", [1, 511, 513, 4096])
def test_field_op_kernels_match_plain(device, spec, m):
    """mod_add, mod_sub and mod_neg (a subtract from a broadcast zero): full
    operands, and one broadcast element on the right (add, sub) and on the
    left (sub)."""
    a = _encoded(spec, m, 6, device)
    b = _encoded(spec, m, 7, device).flip(1).contiguous()
    one = _encoded(spec, 1, 8, device)
    before = dict(cuda_ops.LAUNCHES)
    cases = [
        (cuda_ops.mod_add(spec, a, b), cuda_ops.mod_add_plain(spec, a, b)),
        (cuda_ops.mod_add(spec, a, one), cuda_ops.mod_add_plain(spec, a, one)),
        (cuda_ops.mod_sub(spec, a, b), cuda_ops.mod_sub_plain(spec, a, b)),
        (cuda_ops.mod_sub(spec, a, one), cuda_ops.mod_sub_plain(spec, a, one)),
        (cuda_ops.mod_sub(spec, one, b), cuda_ops.mod_sub_plain(spec, one, b)),
        (cuda_ops.mod_neg(spec, a), cuda_ops.mod_neg_plain(spec, a)),
    ]
    torch.cuda.synchronize(device)
    for i, (got, want) in enumerate(cases):
        assert torch.equal(got, want), i
    assert cuda_ops.LAUNCHES["mod_add"] == before["mod_add"] + 2
    assert cuda_ops.LAUNCHES["mod_sub"] == before["mod_sub"] + 4


def _flagship_program(rot_scale):
    """The flagship's combined quotient program (merkle-sum tree, k = 11)."""
    from halo2_tpu_torch.circuits import merkle_sum_tree as m
    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg.keygen import PlonkStructure
    from halo2_tpu_torch.plonkish.assignment import run_synthesis

    leaf = m.Node(Fr.from_u64(10), Fr.from_u64(100))
    elements = [m.Node(Fr.from_u64(h), Fr.from_u64(b)) for h, b in [(1, 10), (5, 50)]]
    indices = [Fr.from_u64(0), Fr.from_u64(1)]
    root = m.compute_merkle_sum_root(Fr, leaf, elements, indices)
    circuit = m.MerkleSumTreeCircuit(
        Fr, leaf.hash, leaf.balance, [n.hash for n in elements],
        [n.balance for n in elements], indices, root.balance + Fr.from_u64(1),
    )
    cs, _cfg, _asn = run_synthesis(circuit.without_witnesses(), 11, [], witness=False, field=Fr)
    return PlonkStructure(cs, 11).quotient_program(rot_scale)


def _vm_columns(prog, spec, n, device, stride0=()):
    """kind -> list of (16, n) random canonical columns; the aux columns in
    ``stride0`` as one element expanded to (16, n)."""
    counts = {}
    for kind, ci, _rot in prog.queries:
        counts[kind] = max(counts.get(kind, 0), ci + 1)
    cols = {}
    for kind, c in counts.items():
        cols[kind] = [
            _encoded(spec, 1, 100 + ci, device).expand(16, n) if kind == "aux" and ci in stride0
            else _encoded(spec, n, 100 + ci, device)
            for ci in range(c)
        ]
    return cols


@pytest.mark.parametrize("case", ["flagship", "bare"])
def test_vm_kernel_matches_plain(device, case):
    """The whole program in one launch, equal to the plain version: the
    flagship's quotient at n = 2^12 (rot_scale 16: the 2042 rotation wraps)
    with the challenges as stride-0 views, and a program with no
    instruction whose outputs are a bare query and a bare constant."""
    from halo2_tpu_torch.kzg.keygen import AuxLayout
    from halo2_tpu_torch.plonkish.column import Column, ColumnKind, Rotation
    from halo2_tpu_torch.plonkish.expression import Constant, Query

    spec, n = BN254_FR, 1 << 12
    if case == "flagship":
        prog = _flagship_program(16)
        stride0 = (AuxLayout.BETA, AuxLayout.GAMMA, AuxLayout.THETA, AuxLayout.Y)
    else:
        prog = Program([Query(Column(ColumnKind.ADVICE, 0), Rotation(-1)), Constant(5)])
        stride0 = ()
    cols = _vm_columns(prog, spec, n, device, stride0)
    table = cuda_vm.compile_program(prog, spec)
    queries = [cols[kind][ci] for kind, ci, _rot in prog.queries]
    before = cuda_vm.LAUNCHES["vm_eval"]
    got = cuda_vm.vm_eval(table, queries, table.consts_on(device), n)
    torch.cuda.synchronize(device)
    assert cuda_vm.LAUNCHES["vm_eval"] == before + 1
    assert torch.equal(got, cuda_vm.vm_eval_plain(table, queries, table.consts_on(device), n))
    assert torch.equal(_run_program(prog, get_device_field(spec), cols), got)
    cpu = {k: [c.cpu() for c in v] for k, v in cols.items()}
    assert torch.equal(_run_program(prog, get_device_field(spec), cpu), got.cpu())


def test_vm_kernel_pasta_gates(device):
    """The Poseidon experiment's gates (Pasta Fp: field.cuh's arithmetic)."""
    from halo2_tpu_torch.circuits.poseidon import PoseidonCircuit
    from halo2_tpu_torch.field import Fp
    from halo2_tpu_torch.plonkish import Value
    from halo2_tpu_torch.plonkish.assignment import run_synthesis
    from halo2_tpu_torch.poseidon import MySpec, poseidon_hash

    spec_p = MySpec(5, 4)
    message = [Fp.from_u64(99)] * 4
    circuit = PoseidonCircuit(
        Fp, spec_p, 4, [Value.known(x) for x in message],
        Value.known(poseidon_hash(Fp, spec_p, message)),
    )
    cs, _cfg, _asn = run_synthesis(circuit.without_witnesses(), 7, [], witness=False, field=Fp)
    prog = Program([c for gate in cs.gates for c in gate.constraints])
    cols = _vm_columns(prog, PASTA_FP, 128, device)
    got = _run_program(prog, get_device_field(PASTA_FP), cols)
    torch.cuda.synchronize(device)
    cpu = {k: [c.cpu() for c in v] for k, v in cols.items()}
    assert torch.equal(got.cpu(), _run_program(prog, get_device_field(PASTA_FP), cpu))


def _product_tree(query, lo, hi):
    from halo2_tpu_torch.plonkish.expression import Constant

    if hi - lo == 1:
        return query * Constant(lo + 2)
    return _product_tree(query, lo, (lo + hi) // 2) * _product_tree(query, (lo + hi) // 2, hi)


@pytest.mark.parametrize("case", ["partial_block", "smem_above_48k", "rows_32", "one_stream"])
def test_vm_kernel_block_shapes(device, case):
    """The kernel's block shapes against the plain version: the flagship
    over four streams at 4,079 rows (a partial last block), 100 live
    registers (200 KB of shared memory a block, above the default 48 KB),
    150 (32-row blocks, Pasta Fp), and a balanced product tree scheduled on
    one stream."""
    from halo2_tpu_torch.kzg.keygen import AuxLayout
    from halo2_tpu_torch.plonkish.column import Column, ColumnKind, Rotation
    from halo2_tpu_torch.plonkish.expression import Constant, Query

    query = Query(Column(ColumnKind.ADVICE, 0), Rotation(-1))
    spec, n, stride0 = BN254_FR, 1 << 11, ()
    if case == "partial_block":
        prog, n = _flagship_program(16), (1 << 12) - 17
        stride0 = (AuxLayout.BETA, AuxLayout.GAMMA, AuxLayout.THETA, AuxLayout.Y)
    elif case == "smem_above_48k":
        prog = Program([query * Constant(i + 2) for i in range(100)])
    elif case == "rows_32":
        prog, spec, n = Program([query * Constant(i + 2) for i in range(150)]), PASTA_FP, 1000
    else:
        prog = Program([_product_tree(query, 0, 256)])
    table = cuda_vm.compile_program(prog, spec)
    rows, smem = cuda_vm.rows_per_block(table.num_regs)
    expect = {
        "partial_block": (4, 64),
        "smem_above_48k": (4, 64),
        "rows_32": (4, 32),
        "one_stream": (1, 64),
    }[case]
    assert (table.streams, rows) == expect
    assert (smem > 48 * 1024) == (case in ("partial_block", "smem_above_48k", "rows_32"))
    cols = _vm_columns(prog, spec, n, device, stride0)
    queries = [cols[kind][ci] for kind, ci, _rot in prog.queries]
    before = cuda_vm.LAUNCHES["vm_eval"]
    got = cuda_vm.vm_eval(table, queries, table.consts_on(device), n)
    torch.cuda.synchronize(device)
    assert cuda_vm.LAUNCHES["vm_eval"] == before + 1
    assert torch.equal(got, cuda_vm.vm_eval_plain(table, queries, table.consts_on(device), n))


@pytest.mark.parametrize("spec", [BN254_FR, PASTA_FP], ids=lambda s: s.name)
@pytest.mark.parametrize("k", [10, 11, 13, 15, 16])
@pytest.mark.parametrize("cols", [1, 3])
def test_fused_large_stages_match_plain(device, spec, k, cols):
    """Every pass of large_stage_plan(n), several stages a launch, against
    the chained plain stages, forward and inverse; ntt_stages launches the
    large-stage kernel once a pass."""
    n = 1 << k
    enc = [_encoded(spec, n, 30 + c, device) for c in range(cols)]
    x = torch.stack(enc) if cols > 1 else enc[0]
    plan = cuda_ntt.large_stage_plan(n)
    assert len(plan) == -(-(k - 9) // cuda_ntt.MAX_FUSED)
    for inverse in (False, True):
        tw = twiddle_table(spec, n, inverse, device)
        y = cuda_ntt.ntt_small_stages_plain(spec, x, tw)
        for m0, stages in plan:
            got = cuda_ntt.ntt_large_stage(spec, y, tw, m0, stages)
            torch.cuda.synchronize(device)
            want = cuda_ntt.ntt_large_stage_plain(spec, y, tw, m0, stages)
            assert torch.equal(got, want), (m0, stages)
            y = got
        before = cuda_ntt.LAUNCHES["ntt_large_stage"]
        full = cuda_ntt.ntt_stages(spec, x, tw)
        assert cuda_ntt.LAUNCHES["ntt_large_stage"] == before + len(plan)
        torch.cuda.synchronize(device)
        assert torch.equal(full, y)


def test_every_large_stage_span_matches_plain(device):
    """At 2^13 every run of 1 .. 4 consecutive large stages in one launch
    (m0 = 512 .. 4096) equals the chained plain stages."""
    spec, n = BN254_FR, 1 << 13
    x = torch.stack([_encoded(spec, n, 40 + c, device) for c in range(3)])
    tw = twiddle_table(spec, n, False, device)
    m0 = cuda_ntt.TILE
    while m0 < n:
        stages = 1
        while m0 << stages <= n:
            got = cuda_ntt.ntt_large_stage(spec, x, tw, m0, stages)
            torch.cuda.synchronize(device)
            want = cuda_ntt.ntt_large_stage_plain(spec, x, tw, m0, stages)
            assert torch.equal(got, want), (m0, stages)
            stages += 1
        m0 *= 2


def _msm_entries(n, sets, device, seed):
    """The MSM's sorted, chunked entries of ``sets`` random scalar sets over
    n SRS points, as ec/device.py:_msm_wsums_raw makes them."""
    rng = random.Random(seed)
    _, _, x, y = _srs(n, device)
    sc = torch.stack([
        torch.from_numpy(get_device_field(BN254_FR).encode_np(
            [rng.randrange(BN254_FR.p) for _ in range(n)], to_mont=False).view(np.int32))
        for _ in range(sets)
    ]).to(device)
    c, q = ecd._msm_c(n), ecd._q_rounds(n)
    digits, signs = ecd._signed_digits(ecd._digits_from_limbs(sc, c), c)
    rows = sets * digits.shape[1]
    _, order, sign = ecd._sorted_entries(digits.reshape(rows, n), signs.reshape(rows, n), min(q, n))
    return x, y, order, sign


@pytest.mark.parametrize("schedule", [None, *cuda_jac.ACC_SCHEDULES], ids=str)
@pytest.mark.parametrize("n, sets", [(1 << 9, 1), (1 << 11, 1), (1 << 11, 4), (1 << 11, 8)])
def test_msm_chunk_acc_kernel_matches_plain(device, n, sets, schedule):
    """One launch, in acc_plan's schedule (None) or one forced, equals the
    plain rounds limb for limb, with a (0, 0) point, a y = 0 point, P == Q
    and P == -Q chunks."""
    x, y, order, sign = _msm_entries(n, sets, device, n + sets)
    x, y = x.clone(), y.clone()
    x[:, 3] = y[:, 3] = 0
    y[:, 5] = 0
    # entry pos of chunk c at [row, pos, c]; the rounds run from pos q - 1 down
    order[0, -2, 0], sign[0, -2, 0] = order[0, -1, 0], sign[0, -1, 0]
    order[0, -2, 1], sign[0, -2, 1] = order[0, -1, 1], ~sign[0, -1, 1]
    order[1, :, 0], sign[1, :, 0] = 5, True
    order[1, -1, 1] = 3
    before = dict(cuda_jac.LAUNCHES)
    got = cuda_jac.msm_chunk_acc_cuda(x, y, order, sign, schedule)
    torch.cuda.synchronize(device)
    assert cuda_jac.LAUNCHES["msm_chunk_acc"] == before["msm_chunk_acc"] + 1
    assert cuda_jac.LAUNCHES["jac_madd"] == before["jac_madd"]
    want = cuda_jac.msm_chunk_acc_plain(x, y, order, sign)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("schedule", [None, *cuda_jac.SCAN_SCHEDULES], ids=str)
@pytest.mark.parametrize("chunks", [1, 2, 64, 65, 256, 257, 4096, 8192])
def test_jac_suffix_scan_kernel_matches_plain(device, chunks, schedule):
    """The scan equals its plain version limb for limb in scan_plan's
    schedule (None) and in each schedule forced at every level, in one
    launch up to a tile and three above, with P == Q, P == -Q and infinite
    chunks."""
    x, y, order, sign = _msm_entries(1 << 11, 1, device, 7)
    tot = cuda_jac.msm_chunk_acc_cuda(x, y, order, sign)[1][:, :, :3]
    s = tot.repeat(1, 1, 1, -(-chunks // tot.shape[-1]))[..., :chunks].contiguous()
    if chunks > 4:
        s[:, :, 0, 1] = s[:, :, 0, 0]
        s[:, :, 0, 2] = s[:, :, 0, 3]
        s[1, :, 0, 2] = ecd.df().neg(s[1, :, 0, 3].contiguous())
        inf = torch.stack(list(ecd.jac_infinity((), device=device).values()))
        s[:, :, 2, chunks // 2] = inf
    before = cuda_jac.LAUNCHES["jac_suffix_scan"]
    got = cuda_jac._jac_suffix_scan(s, schedule)
    torch.cuda.synchronize(device)
    T, _ = cuda_jac.scan_tile(chunks, schedule or cuda_jac.scan_plan(s.shape[2], chunks))
    assert cuda_jac.LAUNCHES["jac_suffix_scan"] == before + (1 if chunks <= T else 3)
    assert torch.equal(got, cuda_jac._scan_plain(s, schedule))


def test_msm_window_kernels_raise_on_bad_inputs(device):
    x, y, order, sign = _msm_entries(1 << 9, 1, device, 3)
    with pytest.raises(ValueError):
        cuda_jac.msm_chunk_acc_cuda(x, y, order.long(), sign)
    with pytest.raises(ValueError):
        cuda_jac.msm_chunk_acc_cuda(x, y, order, sign.int())
    with pytest.raises(ValueError):
        cuda_jac.msm_chunk_acc_cuda(x, y, order, sign, "warp")
    many = order.repeat(1, 3, 1)[:, : cuda_jac.ACC_QMAX + 1].contiguous()
    many_sign = sign.repeat(1, 3, 1)[:, : cuda_jac.ACC_QMAX + 1].contiguous()
    with pytest.raises(ValueError):
        cuda_jac.msm_chunk_acc_cuda(x, y, many, many_sign)
    tot = cuda_jac.msm_chunk_acc_cuda(x, y, order, sign)[1]
    with pytest.raises(TypeError):
        cuda_jac.jac_suffix_scan_cuda(tot.long())
    with pytest.raises(ValueError):
        cuda_jac.jac_suffix_scan_cuda(tot[..., ::2])
    with pytest.raises(ValueError):
        cuda_jac.jac_suffix_scan_cuda(tot[:2])
    with pytest.raises(ValueError):
        cuda_jac._jac_suffix_scan(tot, ("coarse", 3))


def test_batched_device_commits_launch_one_window_pass(device, flag_reads):
    """Five columns of one length commit in one batch: one msm_chunk_acc,
    one jac_horner, no jac_madd or mod_sub; the points equal the native
    MSM's."""
    from halo2_tpu_torch.kzg.keygen import _commit_device
    from halo2_tpu_torch.kzg.params import ParamsKZG

    params = ParamsKZG.setup_cached(11)
    dfr = get_device_field(BN254_FR)
    rng = random.Random(15)
    cols = [
        dfr.encode([rng.randrange(BN254_FR.p) for _ in range(1 << 11)], device=device)
        for _ in range(5)
    ]
    before = {**cuda_jac.LAUNCHES, **cuda_ops.LAUNCHES}
    got = _commit_device(params, cols)
    torch.cuda.synchronize(device)
    after = {**cuda_jac.LAUNCHES, **cuda_ops.LAUNCHES}
    assert after["msm_chunk_acc"] == before["msm_chunk_acc"] + 1
    assert after["jac_horner"] == before["jac_horner"] + 1
    assert after["jac_madd"] == before["jac_madd"] and after["mod_sub"] == before["mod_sub"]
    assert flag_reads == []
    px, py = (native.pack_device(np.ascontiguousarray(a)) for a in (params.g1_x, params.g1_y))
    from halo2_tpu_torch.ec import host

    for col, pt in zip(cols, got):
        canon = dfr.from_mont_arr(col).cpu().numpy().view(np.uint32)
        assert host.g1_to_ints(pt) == native.msm_g1_mont(px, py, native.pack_device(canon))


# ------------------------------------------------ the setup ladder, the sponge
def _ladder_operands(m, device):
    """m SRS points doubled (z != 1) and random.Random(254) scalars below R
    as (256, m) uint8 bit rows: lane 0 the scalar 0, lane 1 the scalar 1,
    lane 2 R - 1, lane 3 an infinity base, lane 4 P == Q at row 254."""
    from halo2_tpu_torch.ec import host
    from halo2_tpu_torch.kzg.params import scalar_bits

    _, _, x, y = _srs(m, device)
    p = ecd.jac_double(ecd.jac_from_affine(x, y))
    rng = random.Random(254)
    scalars = [rng.randrange(host.R) for _ in range(m)]
    special = [0, 1, host.R - 1, rng.randrange(host.R), (1 << 254) % host.R + (1 << 254)]
    scalars[:5] = special[: min(5, m)]
    if m > 3:
        for k, v in ecd.jac_infinity((), device=device).items():
            p[k][:, 3] = v
    return p, torch.from_numpy(scalar_bits(scalars)).to(device)


@pytest.mark.parametrize("m", [1, 33, 300, 2081])
def test_jac_ladder_kernel_matches_plain(device, m, flag_reads):
    p, bits = _ladder_operands(m, device)
    before = cuda_jac.LAUNCHES["jac_ladder"]
    got = cuda_jac.jac_ladder_cuda(p, bits)
    got32 = cuda_jac.jac_ladder_cuda(p, bits.to(torch.int32))
    torch.cuda.synchronize(device)
    assert cuda_jac.LAUNCHES["jac_ladder"] == before + 2
    assert flag_reads == []
    want = cuda_jac.scalar_mul_batched_plain(p, bits)
    for k in ("x", "y", "z"):
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got32[k], want[k]), k


def test_setup_runs_one_ladder(device):
    """ParamsKZG.setup(13), the device branch's smallest k, equals the saved
    SRS, through one jac_fixed_base launch (G's window multiples) and no
    jac_ladder, field-op or add launch."""
    from halo2_tpu_torch.kzg.params import ParamsKZG
    from halo2_tpu_torch.parallel.jobs import read_launches, reset_launches

    reset_launches()
    got = ParamsKZG.setup(13)
    counts = read_launches()
    want = ParamsKZG.load(os.path.join(ROOT, ".srs", "kzg_bn254_k13_s857536.pkl"))
    assert np.array_equal(got.g1_x, want.g1_x) and np.array_equal(got.g1_y, want.g1_y)
    assert counts["jac_fixed_base"] == 1 and counts["mont_inv"] == 1 and counts["jac_ladder"] == 0
    assert counts["mont_sqr"] == counts["mod_add"] == counts["mod_sub"] == counts["jac_add"] == 0


def _fixed_base_scalars(m, device):
    """m random.Random(0xF1B) scalars below 2^256 as (8, m) int32 words;
    lanes 0-5: 0, 1, R - 1, R (P == -Q in the top window at w = 4 or 6),
    2^255 - R (P == Q there), 2^256 - 1."""
    from halo2_tpu_torch.ec import host
    from halo2_tpu_torch.kzg.params import scalar_words

    rng = random.Random(0xF1B)
    scalars = [rng.getrandbits(256) for _ in range(m)]
    special = [0, 1, host.R - 1, host.R, (1 << 255) - host.R, (1 << 256) - 1]
    scalars[: min(6, m)] = special[: min(6, m)]
    return torch.from_numpy(scalar_words(scalars).view(np.int32)).to(device)


@pytest.mark.parametrize("k", [1, 7])
@pytest.mark.parametrize("m", [1, 33, 300, 2081])
def test_jac_fixed_base_kernel_matches_plain(device, k, m, flag_reads):
    from halo2_tpu_torch.ec import host

    x, y = host.g1_to_ints(host.ec_mul(host.G1, k))
    table = cuda_jac.fixed_base_table_tensor(x, y, cuda_jac.FIXED_BASE_WINDOW, device)
    words = _fixed_base_scalars(m, device)
    before = cuda_jac.LAUNCHES["jac_fixed_base"]
    got = cuda_jac.jac_fixed_base_cuda(table, words)
    torch.cuda.synchronize(device)
    assert cuda_jac.LAUNCHES["jac_fixed_base"] == before + 1
    assert flag_reads == []
    want = cuda_jac.fixed_base_mul_plain(table, words)
    for c in ("x", "y", "z"):
        assert torch.equal(got[c], want[c]), c


def test_fixed_base_mul_matches_host(device):
    """ec.device.fixed_base_mul on the card, then jac_to_affine, equals the
    host ec_mul on the exception lanes and a few random ones."""
    from halo2_tpu_torch.ec import host

    words = _fixed_base_scalars(12, device)
    ax, ay = ecd.jac_to_affine(ecd.fixed_base_mul(host.g1_to_ints(host.G1), words))
    d = get_device_field(BN254_FQ)
    shifts = 32 * np.arange(8)[:, None]
    vals = (words.cpu().numpy().view(np.uint32).astype(object) << shifts).sum(axis=0)
    for i, (x, y) in enumerate(zip(d.decode(ax), d.decode(ay))):
        assert (int(x), int(y)) == host.g1_to_ints(host.ec_mul(host.G1, int(vals[i]))), i


def test_jac_fixed_base_refuses_bad_inputs(device):
    from halo2_tpu_torch.ec import host

    x, y = host.g1_to_ints(host.G1)
    table = cuda_jac.fixed_base_table_tensor(x, y, cuda_jac.FIXED_BASE_WINDOW, device)
    words = _fixed_base_scalars(8, device)
    with pytest.raises(ValueError, match="table"):
        cuda_jac.jac_fixed_base_cuda(table[:-1].contiguous(), words)
    with pytest.raises(ValueError, match="scalars"):
        cuda_jac.jac_fixed_base_cuda(table, words[:7].contiguous())
    with pytest.raises(ValueError, match="scalars"):
        cuda_jac.jac_fixed_base_cuda(table, words.cpu())


SPONGE_CASES = [(BN254_FR, 5, 4), (PASTA_FP, 3, 2), (PASTA_FP, 3, 3), (PASTA_FP, 5, 3),
                (BN254_FR, 3, 2), (BN254_FR, 5, None), (PASTA_FP, 3, None), (BN254_FR, 3, None),
                (PASTA_FP, 5, None)]


@pytest.mark.parametrize(
    "field, width, L", SPONGE_CASES, ids=lambda v: getattr(v, "name", str(v))
)
@pytest.mark.parametrize("m", [1, 33, 2048])
def test_poseidon_kernel_matches_plain(device, field, width, L, m):
    """hash_device (L words) or permute_device (L None) in one poseidon_hash
    launch, limb for limb against the plain versions."""
    from halo2_tpu_torch import poseidon
    from halo2_tpu_torch.poseidon import cuda_sponge

    df = get_device_field(field)
    spec = poseidon.P128Pow5T3() if width == 3 else poseidon.MySpec(5, 4)
    words = width if L is None else L
    x = torch.stack([_encoded(field, m, 40 + i, device) for i in range(words)])
    before = cuda_sponge.LAUNCHES["poseidon_hash"]
    if L is None:
        got, want = poseidon.permute_device(df, spec, x), poseidon.permute_device_plain(df, spec, x)
    else:
        got, want = poseidon.hash_device(df, spec, L, x), poseidon.hash_device_plain(df, spec, L, x)
    torch.cuda.synchronize(device)
    assert cuda_sponge.LAUNCHES["poseidon_hash"] == before + 1
    assert torch.equal(got, want)


def test_poseidon_kernel_refuses_other_widths(device):
    from halo2_tpu_torch import poseidon

    df = get_device_field(BN254_FR)
    x = torch.stack([_encoded(BN254_FR, 64, 60 + i, device) for i in range(4)])
    with pytest.raises(ValueError, match="widths"):
        poseidon.permute_device(df, poseidon.MySpec(4, 3), x)
