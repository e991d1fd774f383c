"""The port's NTT below 512 points against the reference on the CPU, limb
for limb.

Below TILE = 512 one ``ntt_small_stages`` launch is the whole transform of
every column (``poly/cuda_ntt.py``: the kernel reads its input through the
bit-reversal and runs all log2(n) stages); on the CPU the wrapper runs its
plain version.  Here:

- the port's ``_ntt_raw`` for n = 2 .. 256 (BN254 Fr; Pasta Fp at 2, 64
  and 256), one column and a batch of 3, forward and inverse, equals the
  reference's ``halo2_tpu.poly.domain._ntt_raw`` (its ``jnp`` stage ladder,
  jitted as its ``_ntt_fn``: an XLA:CPU compile of 1-10 s a size, where the
  eager ladder took up to 35 s) on every column;
- below 512 a transform is one ``ntt_small_stages`` call over the whole
  batch and no field add, subtract or multiply (the stage ladder it
  replaces), and the plain version equals the stage-by-stage ladder;
- ``sharded_ntt`` at W = 1 and W = 2 (gloo ranks spawned on the CPU, mesh
  (1, W)) at 2^11 (3 columns) and 2^15 (2 columns), both directions,
  equals ``_ntt_raw``; in one rank of one process its local transforms are
  two ``ntt_small_stages`` calls of the shapes the four-step split gives
  (2^11: 64 x 32 points, 2^15: 256 x 128).

The kernel is held against the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py phase 2).
"""

import os
import random
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from halo2_tpu.field.params import BN254_FR as REF_FR
from halo2_tpu.field.params import PASTA_FP as REF_PASTA_FP
from halo2_tpu.poly.domain import _ntt_fn as ref_ntt_fn
from halo2_tpu_torch.field import cuda_mul, cuda_ops
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FR, PASTA_FP
from halo2_tpu_torch.parallel import jobs, make_mesh
from halo2_tpu_torch.parallel.launch import spawn
from halo2_tpu_torch.parallel.ntt import sharded_ntt
from halo2_tpu_torch.poly import cuda_ntt
from halo2_tpu_torch.poly.domain import _ntt_raw, twiddle_table
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

SPECS = {"bn254_fr": (BN254_FR, REF_FR), "pasta_fp": (PASTA_FP, REF_PASTA_FP)}
SMALL_N = [1 << k for k in range(1, 9)]
SHARDED = {"2^11": (1 << 11, 3), "2^15": (1 << 15, 2)}


def _columns(spec, cols: int, n: int, seed: int) -> np.ndarray:
    """(cols, 16, n) Montgomery limbs: 0, 1, p - 1, then seeded values."""
    rng = random.Random(seed)
    df = get_device_field(spec)
    out = []
    for _ in range(cols):
        vals = ([0, 1, spec.p - 1] + [rng.randrange(spec.p) for _ in range(n)])[:n]
        out.append(df.encode_np(vals))
    return np.stack(out)


def _t(arr: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(arr).view(np.int32))


@pytest.mark.parametrize("cols", [1, 3])
@pytest.mark.parametrize(
    "spec_name, n", [("bn254_fr", n) for n in SMALL_N] + [("pasta_fp", n) for n in (2, 64, 256)]
)
def test_small_ntt_matches_reference_ntt_raw(spec_name, n, cols):
    spec, ref_spec = SPECS[spec_name]
    arr = _columns(spec, cols, n, seed=n + cols)
    x = _t(arr) if cols > 1 else _t(arr[0])
    for inverse in (False, True):
        got = _ntt_raw(spec, n, inverse)(x)
        assert got.shape == x.shape and got.is_contiguous()
        assert int(got.max()) < 1 << 16, "a limb is >= 2^16"
        got3 = got.reshape(cols, 16, n).numpy().view(np.uint32)
        for c in range(cols):
            want = np.asarray(ref_ntt_fn(ref_spec, n, inverse)(arr[c].view(np.uint32)))
            assert np.array_equal(got3[c], want), (c, inverse)


@pytest.fixture
def field_op_calls(monkeypatch):
    """Counts of the field kernels' wrappers and of ntt_small_stages (with
    each call's shape) while a test runs."""
    calls = {"mont_mul": 0, "mod_add": 0, "mod_sub": 0, "ntt_small_stages": []}
    for mod, name in ((cuda_mul, "mont_mul"), (cuda_mul, "mont_mul_columns"), (cuda_ops, "mod_add"),
                      (cuda_ops, "mod_sub")):
        real = getattr(mod, name)
        key = "mont_mul" if name.startswith("mont_mul") else name

        def counted(*args, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*args, **kw)

        monkeypatch.setattr(mod, name, counted)
        for user in ("halo2_tpu_torch.field.device", "halo2_tpu_torch.poly.domain"):
            if hasattr(__import__(user, fromlist=[name]), name):
                monkeypatch.setattr(f"{user}.{name}", counted)
    real_small = cuda_ntt.ntt_small_stages

    def small(spec, x, tw):
        calls["ntt_small_stages"].append(tuple(x.shape))
        return real_small(spec, x, tw)

    monkeypatch.setattr(cuda_ntt, "ntt_small_stages", small)
    return calls


def _field_ops(calls) -> tuple:
    return calls["mont_mul"], calls["mod_add"], calls["mod_sub"]


@pytest.mark.parametrize("n", [2, 32, 256])
def test_small_ntt_is_one_small_stages_call(n, field_op_calls):
    """An unscaled transform below 512 is one ntt_small_stages call over
    the whole batch and no field op; the inverse adds only its n^-1
    multiply."""
    x = _t(_columns(BN254_FR, 5, n, seed=3))
    _ntt_raw(BN254_FR, n, False)(x)
    assert field_op_calls["ntt_small_stages"] == [(5, 16, n)]
    assert _field_ops(field_op_calls) == (0, 0, 0)
    _ntt_raw(BN254_FR, n, True)(x)
    assert field_op_calls["ntt_small_stages"] == [(5, 16, n)] * 2
    assert _field_ops(field_op_calls) == (1, 0, 0)


@pytest.mark.parametrize("n", [1, 4, 128])
def test_small_stages_plain_equals_the_stage_ladder(n):
    """The plain version below 512 (the gather, then every stage) equals the
    stages one by one over the bit-reversed input, and n = 1 is a copy."""
    spec = BN254_FR
    x = _t(_columns(spec, 3, n, seed=n))
    tw = twiddle_table(spec, n, False, torch.device("cpu"))
    assert tw.shape == (16, n - 1)
    got = cuda_ntt.ntt_small_stages(spec, x, tw)
    want = x.index_select(-1, cuda_ntt.rev_index(n, x.device))
    m = 1
    while m < n:
        want = cuda_ntt._stage_plain(spec, want, tw, m)
        m *= 2
    assert torch.equal(got, want)
    assert got.data_ptr() != x.data_ptr()


# ----------------------------------------------------------------- sharded
@pytest.fixture(scope="module")
def sharded_groups():
    """W = 1 and W = 2 (gloo, mesh (1, W)) spawned at once, each running the
    sharded NTT of every SHARDED batch in both directions."""
    inputs = {key: _columns(BN254_FR, cols, n, seed=n) for key, (n, cols) in SHARDED.items()}
    job_list = [
        ("ntt", {"x": inputs[key], "inverse": inv}) for key in SHARDED for inv in (False, True)
    ]
    with ThreadPoolExecutor(max_workers=2) as pool:
        futures = {
            w: pool.submit(spawn, jobs.run, w, "gloo", "cpu", job_list, dp=1) for w in (1, 2)
        }
        yield inputs, futures


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("key", list(SHARDED))
@pytest.mark.parametrize("world", [1, 2])
def test_sharded_ntt_matches_ntt_raw(sharded_groups, world, key, inverse):
    inputs, futures = sharded_groups
    x = _t(inputs[key])
    want = _ntt_raw(BN254_FR, x.shape[-1], inverse)(x).numpy()
    index = 2 * list(SHARDED).index(key) + inverse
    ranks = futures[world].result(timeout=900)
    assert len(ranks) == world
    for rank in ranks:
        assert rank[index]["name"] == "ntt"
        assert np.array_equal(rank[index]["out"], want)


@pytest.fixture
def one_rank_mesh():
    """make_mesh(1) over a one-rank gloo group in this process."""
    with tempfile.TemporaryDirectory(prefix="h2t_gloo_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        dist.init_process_group("gloo", init_method=init, rank=0, world_size=1)
        try:
            yield make_mesh(1)
        finally:
            dist.destroy_process_group()


def test_sharded_ntt_local_transforms_are_two_small_stages_calls(one_rank_mesh, field_op_calls):
    """At W = 1 the 2^11 transform of 3 columns is 3 x 32 transforms of 64
    points, then 3 x 64 of 32: two ntt_small_stages calls, one twiddle
    multiply and no field add or subtract."""
    x = _t(_columns(BN254_FR, 3, 1 << 11, seed=5))
    got = sharded_ntt(one_rank_mesh, BN254_FR, x)
    assert field_op_calls["ntt_small_stages"] == [(96, 16, 64), (192, 16, 32)]
    assert _field_ops(field_op_calls) == (1, 0, 0)
    assert torch.equal(got, _ntt_raw(BN254_FR, 1 << 11, False)(x))
