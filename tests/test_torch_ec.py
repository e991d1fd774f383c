"""halo2_tpu_torch's curve arithmetic and MSM against the reference.

- The plain group ops (``jac_madd_plain``/``jac_add_plain``, which the CUDA
  kernels equal limb for limb on the card) equal the reference's
  ``_jac_madd_jnp``/``_jac_add_jnp`` limb for limb, and its Pallas kernels
  (run in interpret mode, as tests/test_pallas_jac.py runs them) as affine
  points, on the exception lanes of tests/test_pallas_jac.py: P == Q,
  P == -Q, infinity on either side, a masked lane, and a 2-d batch.
- ``jac_double`` and ``scalar_mul_batched`` equal the host ``ec_mul``.
- ``msm_points`` equals the native host MSM at n = 2^4, 2^8 and 2^12 (window
  sizes 4 and 8; the size changes at 256), at n = 33 (padding), on zero
  scalars, duplicate and identity points, and the reference's JAX
  ``msm_points`` at n = 32.
- The device branch of ``ParamsKZG.setup`` equals the host branch at n = 16.

On the CPU every kernel wrapper runs its plain version.  Inputs come from
seeded ``random``.
"""

import os
import pickle
import random

import jax
import numpy as np
import pytest
import torch

import halo2_tpu.ec.pallas_jac as pj
import halo2_tpu.field.pallas_mul as pm
from halo2_tpu.ec import device as ref_ecd
from halo2_tpu_torch import native
from halo2_tpu_torch.ec import cuda_jac, host
from halo2_tpu_torch.ec import device as ecd
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FQ, BN254_FR
from halo2_tpu_torch.kzg.params import ParamsKZG, device_g1_powers
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q = BN254_FQ.p


def _port(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, np.uint32).view(np.int32))


def _ref(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _affine(pt) -> list:
    """A Jacobian point dict (numpy or torch limbs, any representative below
    2^256, Montgomery) -> host affine (x, y) ints per lane, (0, 0) = infinity."""
    d = get_device_field(BN254_FQ)
    coords = []
    for k in ("x", "y", "z"):
        a = pt[k]
        a = a if isinstance(a, torch.Tensor) else _port(a)
        coords.append([int(v) for v in np.asarray(d.decode(a)).reshape(-1)])
    out = []
    for x, y, z in zip(*coords):
        if z % Q == 0:
            out.append((0, 0))
        else:
            zi = pow(z, Q - 2, Q)
            out.append((x * zi * zi % Q, y * zi * zi * zi % Q))
    return out


def _sample_points(n, seed):
    """n affine points as (16, n) Montgomery numpy limbs."""
    d = get_device_field(BN254_FQ)
    rng = random.Random(seed)
    pts = [host.ec_mul(host.G1, rng.randrange(1, 1 << 60)) for _ in range(n)]
    return d.encode_np([p[0].c[0] for p in pts]), d.encode_np([p[1].c[0] for p in pts])


def _neg_np(y):
    d = get_device_field(BN254_FQ)
    return _ref(d.neg(_port(y)))


def _case(name):
    """(ref inputs, port inputs) for the exception-lane cases of
    tests/test_pallas_jac.py; every q of the full add has z != 1."""
    if name == "madd":
        n = 8
        x, y = _sample_points(n, 1)
        qx, qy = _sample_points(n, 2)
        # lane 0: p == q (double), lane 1: p == -q, lane 2: p == inf,
        # lane 3: masked out, rest: generic
        qx[:, 0], qy[:, 0] = x[:, 0], y[:, 0]
        qx[:, 1], qy[:, 1] = x[:, 1], _neg_np(y)[:, 1]
        p = {k: np.array(v) for k, v in ref_ecd.jac_from_affine(x, y).items()}
        inf = ref_ecd.jac_infinity(())
        for k in p:
            p[k][:, 2] = np.asarray(inf[k])
        valid = np.array([True, True, True, False, True, True, True, True])
        port = ({k: _port(v) for k, v in p.items()}, _port(qx), _port(qy), torch.from_numpy(valid))
        return (p, qx, qy, valid), port
    n = 8 if name == "add" else 6
    x1, y1 = _sample_points(n, 3 if name == "add" else 5)
    x2, y2 = _sample_points(n, 4 if name == "add" else 6)
    if name == "add":
        # lane 0: p == q, lane 1: p == -q, lane 2: p inf, lane 3: q inf
        x2[:, 0], y2[:, 0] = x1[:, 0], y1[:, 0]
        x2[:, 1], y2[:, 1] = x1[:, 1], _neg_np(y1)[:, 1]
    p = {k: np.array(v) for k, v in ref_ecd.jac_from_affine(x1, y1).items()}
    q = {k: np.array(v) for k, v in ref_ecd.jac_double(ref_ecd.jac_from_affine(x2, y2)).items()}
    if name == "add":
        inf = ref_ecd.jac_infinity(())
        for k in p:
            p[k][:, 2] = np.asarray(inf[k])
            q[k][:, 3] = np.asarray(inf[k])
        # lane 0 stays P == Q: q there is p itself, not its double
        for k in q:
            q[k][:, 0] = p[k][:, 0]
            q[k][:, 1] = p[k][:, 1] if k != "y" else _neg_np(p["y"])[:, 1]
    else:  # a (2, 3) batch
        p = {k: v.reshape(16, 2, 3) for k, v in p.items()}
        q = {k: v.reshape(16, 2, 3) for k, v in q.items()}
    return (p, q), ({k: _port(v) for k, v in p.items()}, {k: _port(v) for k, v in q.items()})


CASES = ["madd", "add", "add-2d"]


def _run(name, ref_in, port_in):
    if name == "madd":
        return (
            ref_ecd._jac_madd_jnp(*ref_in[:3], jax.numpy.asarray(ref_in[3])),
            cuda_jac.jac_madd_plain(*port_in),
            cuda_jac.jac_madd_cuda(*port_in),
        )
    return (
        ref_ecd._jac_add_jnp(*ref_in),
        cuda_jac.jac_add_plain(*port_in),
        cuda_jac.jac_add_cuda(*port_in),
    )


@pytest.mark.parametrize("name", CASES)
def test_plain_group_ops_match_reference_jnp(name):
    ref_in, port_in = _case(name)
    want, plain, wrapped = _run(name, ref_in, port_in)
    for k in ("x", "y", "z"):
        got = _ref(plain[k])
        assert got.max() < 1 << 16
        assert np.array_equal(got, np.asarray(want[k])), k
        assert torch.equal(wrapped[k], plain[k]), k
    if name == "madd":
        flagged, same = cuda_jac.jac_madd_flagged_plain(*port_in)
        assert same.tolist() == [True] + [False] * 7
        assert torch.equal(flagged["x"][:, 3], port_in[0]["x"][:, 3])  # masked lane


@pytest.fixture(scope="module")
def interpret_pallas():
    """The reference's Pallas kernels in interpret mode, as
    tests/test_pallas_jac.py runs them."""
    orig = pm.pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    pj._madd_call.cache_clear()
    pj._add_call.cache_clear()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pm.pl, "pallas_call", patched)
        mp.setattr(pj.pl, "pallas_call", patched)
        yield
    pj._madd_call.cache_clear()
    pj._add_call.cache_clear()


@pytest.mark.parametrize("name", CASES)
def test_plain_group_ops_match_pallas_kernels_as_points(interpret_pallas, name):
    ref_in, port_in = _case(name)
    if name == "madd":
        want = pj.jac_madd_pallas(*ref_in[:3], jax.numpy.asarray(ref_in[3]))
        got = cuda_jac.jac_madd_plain(*port_in)
    else:
        want = pj.jac_add_pallas(*ref_in)
        got = cuda_jac.jac_add_plain(*port_in)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert _affine(got) == _affine(want)


def test_group_op_wrappers_check_inputs():
    p, qx, qy, valid = _case("madd")[1]
    with pytest.raises(ValueError):  # valid must be bool of the batch shape
        cuda_jac.jac_madd_cuda(p, qx, qy, valid.to(torch.int32))
    with pytest.raises(ValueError):  # batch mismatch
        cuda_jac.jac_madd_cuda(p, qx[:, :4].contiguous(), qy[:, :4].contiguous(), valid[:4])
    with pytest.raises(ValueError):  # not contiguous
        cuda_jac.jac_add_cuda(p, {k: v.flip(1).t().contiguous().t() for k, v in p.items()})
    with pytest.raises(TypeError):
        cuda_jac.jac_add_cuda(p, {k: v.to(torch.int64) for k, v in p.items()})


@pytest.mark.parametrize(
    "m, want",
    [(1, "narrow"), (128, "narrow"), (2816, "narrow"), (cuda_jac.NARROW_MAX_LANES, "narrow"),
     (cuda_jac.NARROW_MAX_LANES + 1, "wide"), (180224, "wide"), (1 << 20, "wide")],
)
def test_kernel_variant_is_chosen_from_the_lane_count(m, want):
    assert cuda_jac.variant(m) == want
    assert set(cuda_jac.VARIANTS) == {"narrow", "wide"}


def test_double_and_scalar_mul_match_host():
    d = get_device_field(BN254_FQ)
    rng = random.Random(11)
    n, nbits = 6, 40
    ks = [rng.randrange(1, 1 << 50) for _ in range(n)]
    scalars = [rng.randrange(1 << nbits) for _ in range(n - 1)] + [0]
    pts = [host.ec_mul(host.G1, k) for k in ks]
    x = d.encode([p[0].c[0] for p in pts])
    y = d.encode([p[1].c[0] for p in pts])
    p = ecd.jac_from_affine(x, y)
    assert _affine(ecd.jac_double(p)) == [host.g1_to_ints(host.ec_double(pt)) for pt in pts]
    assert _affine(ecd.jac_double(ecd.jac_infinity((2,)))) == [(0, 0)] * 2
    bits = torch.tensor([[(s >> r) & 1 for s in scalars] for r in range(nbits)], dtype=torch.int32)
    got = ecd.scalar_mul_batched(ecd.jac_double(p), bits)
    assert _affine(got) == [host.g1_to_ints(host.ec_mul(pt, 2 * s)) for pt, s in zip(pts, scalars)]
    ax, ay = ecd.jac_to_affine(got)
    assert [(int(a), int(b)) for a, b in zip(d.decode(ax), d.decode(ay))] == _affine(got)


def _srs(n):
    with open(os.path.join(ROOT, ".srs", "kzg_bn254_k13_s857536.pkl"), "rb") as f:
        data = pickle.load(f)
    return data["g1_x"][:, :n], data["g1_y"][:, :n]


def _native_msm(px, py, sc):
    return native.msm_g1_mont(
        native.pack_device(px), native.pack_device(py), native.pack_device(sc)
    )


@pytest.mark.parametrize("n", [16, 33, 256, 4096])
def test_msm_points_matches_native(n):
    rng = random.Random(n)
    px, py = _srs(n)
    sc = get_device_field(BN254_FR).encode_np(
        [rng.randrange(BN254_FR.p) for _ in range(n)], to_mont=False
    )
    got = ecd.msm_points(_port(px), _port(py), _port(sc))
    assert got == _native_msm(px, py, sc)
    assert got != (0, 0)


def test_msm_edge_cases():
    """Zero scalars, duplicate points, identity ((0, 0)) points."""
    d = get_device_field(BN254_FQ)
    pts = [host.G1, host.G1, host.ec_mul(host.G1, 7), None] + [None] * 28
    scalars = [0, 5, 3, 11] + [1] * 28
    x = d.encode([host.g1_to_ints(p)[0] for p in pts])
    y = d.encode([host.g1_to_ints(p)[1] for p in pts])
    sc = get_device_field(BN254_FR).encode(scalars, to_mont=False)
    want = host.g1_to_ints(host.ec_mul(host.G1, 5 + 3 * 7))
    assert ecd.msm_points(x, y, sc) == want
    assert _affine(ecd.msm(x, y, sc)) == [want]
    assert ecd.msm_points(x, y, torch.zeros_like(sc)) == (0, 0)
    assert ecd.jac_host_affine(ecd.msm(x, y, torch.zeros_like(sc))) == (0, 0)


def test_msm_points_matches_reference_jax():
    n = 32
    rng = random.Random(42)
    px, py = _srs(n)
    sc = get_device_field(BN254_FR).encode_np(
        [rng.randrange(BN254_FR.p) for _ in range(n)], to_mont=False
    )
    with jax.disable_jit():  # op by op: the same values, without compiling the whole MSM
        want = ref_ecd.msm_points(px, py, sc)
    assert ecd.msm_points(_port(px), _port(py), _port(sc)) == want


def test_setup_device_branch_matches_host():
    k = 4
    params = ParamsKZG.setup(k, device="cpu")  # n = 16: the host branch
    with open(os.path.join(ROOT, ".srs", f"kzg_bn254_k{k}_s857536.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert np.array_equal(params.g1_x, saved["g1_x"])
    rng = random.Random(0xD15C0)
    tau = rng.randrange(1, host.R)
    powers = [pow(tau, i, host.R) for i in range(1 << k)]
    g1_x, g1_y = device_g1_powers(powers, torch.device("cpu"))
    assert np.array_equal(g1_x, params.g1_x)
    assert np.array_equal(g1_y, params.g1_y)


# ------------------------------------------------------------- hybrid MSM
HYBRID_N = 1 << 12


def _hybrid_inputs():
    """Fresh 2^12-point mirrors (new objects: no cached IFMA lane form)."""
    rng = random.Random(12)
    px, py = _srs(HYBRID_N)
    sc = get_device_field(BN254_FR).encode_np(
        [rng.randrange(BN254_FR.p) for _ in range(HYBRID_N)], to_mont=False
    )
    return np.array(px), np.array(py), sc


def _count_calls(monkeypatch, module, name):
    calls = []
    orig = getattr(module, name)

    def counted(*args, **kw):
        calls.append(args)
        return orig(*args, **kw)

    monkeypatch.setattr(module, name, counted)
    return calls


@pytest.mark.parametrize("ifma", [True, False], ids=["ifma", "no-ifma"])
@pytest.mark.parametrize("frac", [0.0, 0.125, 1.0])
def test_msm_hybrid_matches_native(frac, ifma, monkeypatch):
    """The device slice (the plain versions here) and the native tail, with
    the host's IFMA Pippenger or (points_to52 giving None, a host without
    IFMA) the 64-bit one, sum to the native MSM."""
    px, py, sc = _hybrid_inputs()
    want = _native_msm(px, py, sc)
    if not ifma:
        monkeypatch.setattr(native, "points_to52", lambda *a: None)
    dev = _count_calls(monkeypatch, ecd, "_msm_wsums_raw")
    host52 = _count_calls(monkeypatch, native, "msm_g1_mont52")
    host64 = _count_calls(monkeypatch, native, "msm_g1_mont")
    got = ecd.msm_hybrid(_port(px), _port(py), _port(sc), px, py, sc, device_frac=frac)
    assert _affine(got) == [want] and ecd.jac_host_affine(got) == want
    nd = int(HYBRID_N * frac)
    assert [a[0].shape[-1] for a in dev] == ([nd] if nd else [])
    tails = [a[0].shape[0] for a in (host52 if ifma else host64)]
    assert tails == ([HYBRID_N - nd] if nd < HYBRID_N else [])
    assert (host64 if ifma else host52) == []


@pytest.mark.parametrize(
    "frac, ifma",
    [(0.0, True), (0.0, False), (0.125, True)],
    ids=["0-ifma", "0-no-ifma", "0.125-ifma"],
)
def test_msm_hybrid_matches_reference(frac, ifma, monkeypatch):
    """The reference's msm_hybrid at the same split (HALO2_TPU_MSM_DEVICE_FRAC;
    its device slice is one jit-compiled Pippenger) gives the same point."""
    import halo2_tpu.native as ref_native
    import jax.numpy as jnp

    px, py, sc = _hybrid_inputs()
    if not ifma:
        monkeypatch.setattr(native, "points_to52", lambda *a: None)
        monkeypatch.setattr(ref_native, "points_to52", lambda *a: None)
    monkeypatch.setenv("HALO2_TPU_MSM_DEVICE_FRAC", str(frac))
    want = ref_ecd.msm_hybrid(jnp.asarray(px), jnp.asarray(py), jnp.asarray(sc), px, py, sc)
    got = ecd.msm_hybrid(_port(px), _port(py), _port(sc), *_hybrid_inputs(), device_frac=frac)
    assert _affine(got) == _affine({k: np.asarray(v) for k, v in want.items()}) != [(0, 0)]


def test_msm_hybrid_guards_are_the_device_msm(monkeypatch):
    """Below 2^12 points, without host mirrors or without the native engine,
    msm_hybrid is msm; the native engine is not called."""
    sentinel = object()
    monkeypatch.setattr(ecd, "msm", lambda *a: sentinel)
    for name in ("msm_g1_mont52", "msm_g1_mont", "points_to52"):
        monkeypatch.setattr(native, name, lambda *a: pytest.fail("the native MSM ran"))
    px, py, sc = _hybrid_inputs()
    args = [_port(a) for a in (px, py, sc)]
    small = [a[:, : HYBRID_N - 1] for a in args]
    assert ecd.msm_hybrid(*small, px[:, :-1], py[:, :-1], sc[:, :-1], device_frac=0.0) is sentinel
    assert ecd.msm_hybrid(*args, device_frac=0.0) is sentinel
    assert ecd.msm_hybrid(*args, px, py, None, device_frac=0.0) is sentinel
    monkeypatch.setattr(native, "available", lambda: False)
    assert ecd.msm_hybrid(*args, px, py, sc, device_frac=0.0) is sentinel


def test_hybrid_device_frac_is_a_share():
    for n in (1 << 12, 1 << 16, 1 << 17, 1 << 20, 1 << 22):
        assert 0.0 <= ecd._hybrid_device_frac(n) <= 1.0


def test_pts52_cache_is_a_small_lru_of_frozen_mirrors(monkeypatch):
    """The lane-form cache: hits by identity, evicts the least recently used
    beyond _PTS52_CACHE_MAX entries, never serves an entry whose arrays are
    not the caller's, and freezes what it caches."""
    import collections

    made = []

    def fake_points_to52(px, py):
        made.append(px.shape[0])
        return px + np.uint64(1), py + np.uint64(1)

    monkeypatch.setattr(native, "points_to52", fake_points_to52)
    monkeypatch.setattr(ecd, "_PTS52_CACHE", collections.OrderedDict())
    size = ecd._PTS52_CACHE_MAX
    mirrors = [
        (np.full((16, 4), i, np.uint32), np.full((16, 4), i + 100, np.uint32))
        for i in range(size + 2)
    ]
    first = ecd._host_pts52(*mirrors[0], 1)
    assert made == [3]
    assert ecd._host_pts52(*mirrors[0], 1)[0] is first[0] and made == [3]
    for a in (*mirrors[0], *first):
        with pytest.raises(ValueError):
            a[0, 0] = 7
    for px, py in mirrors[1:]:
        ecd._host_pts52(px, py, 0)
    assert len(ecd._PTS52_CACHE) == size
    keys = [(id(px), id(py), nd) for (px, py), nd in zip(mirrors, [1] + [0] * (size + 1))]
    assert list(ecd._PTS52_CACHE) == keys[2:]  # entries 0 and 1 went first
    ecd._host_pts52(*mirrors[2], 0)  # a hit makes entry 2 the most recent
    assert list(ecd._PTS52_CACHE)[-1] == keys[2]
    # an entry under the caller's ids but for other arrays is not served
    other = (np.zeros((16, 4), np.uint32), np.zeros((16, 4), np.uint32))
    px, py = mirrors[-1]
    ecd._PTS52_CACHE[(id(px), id(py), 0)] = (*other, *other)
    n_made = len(made)
    got = ecd._host_pts52(px, py, 0)
    assert len(made) == n_made + 1 and got[0] is not other[0]
