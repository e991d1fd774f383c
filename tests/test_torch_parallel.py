"""The port's sharded layer (halo2_tpu_torch.parallel, create_proof(mesh=))
against the reference's, on the CPU.

Each group of ranks is spawned once for the module (gloo, ``device="cpu"``,
so the kernels' plain versions run): W = 1; W = 2 with dp = 1, so that
sp = 2 and the NTT, the scan and the quotient really exchange; W = 4 at the
reference's default layout (2, 2).  The three groups run at once, in
threads of this process, while the reference's results are computed here;
every rank runs the same job list (``halo2_tpu_torch.parallel.jobs``) and
each test reads one check from every rank of a group.

The reference's sharded functions run on its 8-device virtual CPU mesh
(tests/conftest.py).  Its jitted sharded MSM and device-Horner MSM take
minutes of XLA:CPU compile at 32 points (178 s measured for
tests/test_parallel.py's case), so the default tier holds the port's MSMs
against the reference's host oracle (``halo2_tpu.ec.host``, the oracle
tests/test_parallel.py holds the reference's sharded MSM to) and the port's
single-device MSM; the ``slow`` tier compares with the reference's
``sharded_msm`` and ``_msm_raw`` themselves, and proves ``less_than_v2`` at
k = 9 (a lookup circuit: over a minute a rank on the CPU; chip_smoke.py
phase 9 proves it on the card).
"""

import random
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import halo2_tpu.field as ref_field
import halo2_tpu.kzg as ref_kzg
import halo2_tpu.parallel as ref_par
from halo2_tpu.ec import host as ref_ec
from halo2_tpu.field.params import BN254_FR as REF_FR
from halo2_tpu_torch.ec import device as ecd
from halo2_tpu_torch.field.device import get_device_field
from halo2_tpu_torch.field.params import BN254_FR
from halo2_tpu_torch.parallel import jobs
from halo2_tpu_torch.parallel.launch import spawn
from halo2_tpu_torch.parallel.mesh import make_mesh, mesh_shape
from halo2_tpu_torch.plonkish import cuda_vm
from halo2_tpu_torch.poly.domain import _ntt_raw
from test_torch_prover import PORT, REF, _hash_v1
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

P = BN254_FR.p
GROUPS = {"w1": (1, None), "w2_sp2": (2, 1), "w4": (4, None)}
NTT_N, MSM_N, GP_N = 1 << 8, 32, 1 << 9
# the batched grand product: (16, C, GP_N) at these C, the first C of
# GP_COLS numpy-seeded columns
GP_BATCHES, GP_COLS = (1, 4, 8), 8
# a lookup circuit whose mesh prove makes both batched grand products: 4
# permutation chunks and 4 lookups at k = 5 (the dryrun's, Random(13))
LOOKUP_CASE = ("overflow_check_v2", 5, 13)
# hash_v1 rows (k = 4) whose gate s * (2a - b) is switched on with a = 1:
# one violated row in the first half of the rows (rank 0's block at
# sp = 2) and two in the second, so that a rank whose count is dropped or
# that reads the other's rows changes the total
PLANTED_ROWS = (3, 9, 14)
PLANTED = tuple(cell for r in PLANTED_ROWS for cell in (("selector", 0, r, 1), ("advice", 0, r, 1)))


def ref_overflow_check_v2():
    """The reference's overflow_check_v2 circuit as the jobs' ``circuit``
    builds the port's: 2^16 - 2 + 1."""
    from halo2_tpu.circuits.overflow_check_v2 import OverflowCheckCircuitV2
    from halo2_tpu.plonkish import Value

    Fr = ref_field.Fr
    a, b = Value.known(Fr.from_u64((1 << 16) - 2)), Value.known(Fr.from_u64(1))
    return OverflowCheckCircuitV2(Fr, a, b)


def _inputs():
    """numpy inputs of every check, from seeds (the MSM's points and scalars
    as tests/test_parallel.py:55 makes them)."""
    dfr = get_device_field(BN254_FR)
    rng = random.Random(11)
    x = dfr.encode_np([rng.randrange(P) for _ in range(NTT_N)])
    prng = random.Random(1)
    pts = [ref_ec.ec_mul(ref_ec.G1, prng.randrange(1, ref_ec.R)) for _ in range(MSM_N)]
    srng = random.Random(7)
    scalars = [srng.randrange(ref_ec.R) for _ in range(MSM_N)]
    dfq = ecd.df()
    px = dfq.encode_np([ref_ec.g1_to_ints(p)[0] for p in pts])
    py = dfq.encode_np([ref_ec.g1_to_ints(p)[1] for p in pts])
    grng = random.Random(21)
    nums = [grng.randrange(1, P) for _ in range(GP_N)]
    dens = [grng.randrange(1, P) for _ in range(GP_N)]
    acc = None
    for p, s in zip(pts, scalars):
        acc = ref_ec.ec_add(acc, ref_ec.ec_mul(p, s)) if acc else ref_ec.ec_mul(p, s)
    z = [1] * GP_N
    for r in range(GP_N - 1):
        z[r + 1] = z[r] * nums[r] % P * pow(dens[r], -1, P) % P
    cols = np.random.default_rng(17).integers(1, 1 << 62, size=(2, GP_COLS, GP_N), dtype=np.int64)
    num_cols, den_cols = (
        np.stack([dfr.encode_np([int(v) % P for v in c]) for c in half], axis=1) for half in cols
    )
    return {
        "x": x, "points": pts, "scalars": scalars, "px": px, "py": py,
        "sc": dfr.encode_np(scalars, to_mont=False),
        "num": dfr.encode_np(nums), "den": dfr.encode_np(dens),
        "nums": nums, "dens": dens, "msm_host": ref_ec.g1_to_ints(acc), "z_host": z,
        "num_cols": num_cols, "den_cols": den_cols,  # (16, GP_COLS, GP_N)
    }


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The inputs, the reference's hash_v1 k = 4 key (saved for the ranks)
    and its single-chip proof with random.Random(11), and the three groups'
    results as futures (the spawns run while the tests compute the
    reference's side)."""
    inp = _inputs()
    k = 4
    ref_circuit, ref_public = _hash_v1(REF)
    ref_params = ref_kzg.ParamsKZG.setup_cached(k)
    ref_pk = ref_kzg.keygen(ref_params, ref_circuit, k, ref_field.Fr)
    pk_path = str(tmp_path_factory.mktemp("pk") / "pk_hash_v1_k4.pkl")
    ref_pk.save(pk_path)
    proof = ref_kzg.create_proof(
        ref_params, ref_pk, ref_circuit, [list(ref_public)], rng=random.Random(11)
    )
    name, lk_k, lk_seed = LOOKUP_CASE
    lk_circuit = ref_overflow_check_v2()
    lk_params = ref_kzg.ParamsKZG.setup_cached(lk_k)
    lk_pk = ref_kzg.keygen(lk_params, lk_circuit, lk_k, ref_field.Fr)
    lk_pk_path = str(tmp_path_factory.mktemp("pk") / f"pk_{name}_k{lk_k}.pkl")
    lk_pk.save(lk_pk_path)
    lk_proof = ref_kzg.create_proof(lk_params, lk_pk, lk_circuit, [[]], rng=random.Random(lk_seed))
    job_list = [
        ("ntt", {"x": inp["x"]}),
        ("ntt", {"x": inp["x"], "inverse": True}),
        ("msm", {"px": inp["px"], "py": inp["py"], "scalars": inp["sc"]}),
        ("grand_product_z", {"num": inp["num"], "den": inp["den"]}),
        ("prove", {"name": "hash_v1", "k": k, "pk_path": pk_path, "seed": 11}),
        ("pipeline", {"name": "hash_v1", "k": k, "n_points": 16}),
        ("prefix_product", {"x": inp["num"]}),
        ("pipeline", {"name": "hash_v1", "k": k, "n_points": 16, "cells": PLANTED}),
        *[
            ("grand_product_z", {"num": inp["num_cols"][:, :c], "den": inp["den_cols"][:, :c]})
            for c in GP_BATCHES
        ],
        ("prove", {"name": name, "k": lk_k, "pk_path": lk_pk_path, "seed": lk_seed}),
    ]
    pool = ThreadPoolExecutor(max_workers=len(GROUPS))
    futures = {
        g: pool.submit(spawn, jobs.run, w, "gloo", "cpu", job_list, dp=dp)
        for g, (w, dp) in GROUPS.items()
    }
    yield {"inp": inp, "proof": proof, "lookup_proof": lk_proof, "futures": futures, "k": k}
    pool.shutdown(wait=True)


def _outs(case, group, index):
    """Job ``index``'s output on every rank of ``group``."""
    return [rank[index]["out"] for rank in case["futures"][group].result(timeout=900)]


@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_mesh_shape_matches_reference(n):
    ref = ref_par.make_mesh(n).shape
    assert mesh_shape(n) == (ref["dp"], ref["sp"])


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(1)
    with pytest.raises(ValueError):
        mesh_shape(6, dp=4)


@pytest.fixture(scope="module")
def ref_ntt(case):
    import jax.numpy as jnp

    xj = jnp.asarray(case["inp"]["x"])
    mesh = ref_par.make_mesh(8)
    return {
        inv: np.array(ref_par.sharded_ntt(mesh, REF_FR, xj, inverse=inv)) for inv in (False, True)
    }


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("inverse", [False, True])
def test_sharded_ntt_matches_reference(case, ref_ntt, group, inverse):
    x = torch.from_numpy(case["inp"]["x"].view(np.int32))
    single = _ntt_raw(BN254_FR, NTT_N, inverse)(x).numpy()
    want = ref_ntt[inverse].view(np.int32)
    assert np.array_equal(single, want)
    for got in _outs(case, group, 1 if inverse else 0):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("group", list(GROUPS))
def test_sharded_msm_matches_reference_oracle(case, group):
    outs = _outs(case, group, 2)
    for got in outs:
        assert got["affine"] == case["inp"]["msm_host"]
        assert np.array_equal(got["jac"], outs[0]["jac"])  # the same limbs on every rank


def _port_msm_args(inp):
    return [torch.from_numpy(inp[k].view(np.int32)) for k in ("px", "py", "sc")]


def test_msm_raw_matches_port_msm_and_reference_oracle(case):
    args = _port_msm_args(case["inp"])
    got = ecd.jac_host_affine(ecd._msm_raw(*args))
    assert got == ecd.msm_points(*args) == case["inp"]["msm_host"]


def test_msm_raw_batch_matches_each_msm(case):
    px, py, sc = _port_msm_args(case["inp"])
    sc2 = torch.flip(sc, dims=[1]).contiguous()
    both = ecd._msm_raw(px, py, torch.stack([sc, sc2]))
    for i, s in enumerate((sc, sc2)):
        got = ecd.jac_host_affine({k: v[:, i] for k, v in both.items()})
        assert got == ecd.msm_points(px, py, s)


@pytest.fixture(scope="module")
def ref_gp(case):
    import jax.numpy as jnp

    mesh = ref_par.make_mesh(8)
    inp = case["inp"]
    z = ref_par.grand_product_z(mesh, REF_FR, jnp.asarray(inp["num"]), jnp.asarray(inp["den"]))
    return np.array(z)


@pytest.mark.parametrize("group", list(GROUPS))
def test_grand_product_z_matches_reference_and_host(case, ref_gp, group):
    dfr = get_device_field(BN254_FR)
    want = ref_gp.view(np.int32)
    assert [int(v) for v in dfr.decode(torch.from_numpy(want))] == case["inp"]["z_host"]
    for got in _outs(case, group, 3):
        assert np.array_equal(got, want)


@pytest.fixture(scope="module")
def ref_gp_cols(case):
    """The reference's grand_product_z on each of the GP_COLS columns
    alone, (16, GP_COLS, GP_N)."""
    import jax.numpy as jnp

    mesh = ref_par.make_mesh(8)
    inp = case["inp"]
    return np.stack([
        np.array(ref_par.grand_product_z(mesh, REF_FR, jnp.asarray(inp["num_cols"][:, c]),
                                         jnp.asarray(inp["den_cols"][:, c])))
        for c in range(GP_COLS)
    ], axis=1)


@pytest.mark.parametrize("group", list(GROUPS))
@pytest.mark.parametrize("batch", range(len(GP_BATCHES)), ids=[f"C{c}" for c in GP_BATCHES])
def test_batched_grand_product_z_matches_reference_per_column(case, ref_gp_cols, group, batch):
    """A (16, C, n) batch in one call: each column equals the reference's
    grand product of that column alone, on every rank."""
    cols = GP_BATCHES[batch]
    want = ref_gp_cols[:, :cols].view(np.int32)
    for rank in case["futures"][group].result(timeout=900):
        res = rank[8 + batch]
        assert res["out"].shape == (16, cols, GP_N)
        assert np.array_equal(res["out"], want)


@pytest.mark.parametrize("group", list(GROUPS))
def test_mesh_prove_batches_its_grand_products(case, group):
    """A mesh prove makes one sharded grand product for all its permutation
    chunks and one for all its lookups (overflow_check_v2 at k = 5: 4 and
    4 columns of 32 rows; hash_v1 at k = 4: 2 chunks, no lookup), and its
    bytes are the single-device prove's."""
    name, k, _seed = LOOKUP_CASE
    for got in _outs(case, group, 8 + len(GP_BATCHES)):
        assert got["grand_products"] == [(16, 4, 1 << k), (16, 4, 1 << k)]
        assert got["proof"] == case["lookup_proof"]
        assert got["verified"]
    for got in _outs(case, group, 4):
        assert got["grand_products"] == [(16, 2, 1 << case["k"])]


@pytest.mark.parametrize("group", list(GROUPS))
def test_sharded_prefix_product_matches_host(case, group):
    dfr = get_device_field(BN254_FR)
    acc, want = 1, []
    for v in case["inp"]["nums"]:
        acc = acc * v % P
        want.append(acc)
    for got in _outs(case, group, 6):
        assert [int(v) for v in dfr.decode(torch.from_numpy(got))] == want


@pytest.mark.parametrize("group", list(GROUPS))
def test_create_proof_mesh_gives_the_reference_bytes(case, group):
    outs = _outs(case, group, 4)
    for got in outs:
        assert got["proof"] == case["proof"]
        assert got["verified"]


@pytest.mark.parametrize("group", list(GROUPS))
def test_sharded_prove_step(case, group):
    """The pipeline demo: no gate violated, the advice iNTT, each column's
    commitment and the synthetic-label z equal their single-device values."""
    from halo2_tpu_torch.field import Fr
    from halo2_tpu_torch.kzg import ParamsKZG
    from halo2_tpu_torch.plonkish.assignment import run_synthesis
    from halo2_tpu_torch.plonkish.evaluator import encode_columns

    k = case["k"]
    circuit, public = _hash_v1(PORT)
    _cs, _cfg, assignment = run_synthesis(circuit, k, [public], witness=True, field=Fr)
    dfr = get_device_field(BN254_FR)
    adv = encode_columns(dfr, assignment.finalize())["advice"]
    coeffs = _ntt_raw(BN254_FR, 1 << k, True)(adv)
    params = ParamsKZG.setup_cached(k)
    px, py = (
        torch.from_numpy(np.ascontiguousarray(a[:, :16]).view(np.int32))
        for a in (params.g1_x, params.g1_y)
    )
    commits = [ecd.msm_points(px, py, dfr.from_mont_arr(c)[:, :16]) for c in coeffs.unbind(0)]
    num = [(int(v) + 1) % P for v in dfr.decode(adv[0])]
    den = [(int(v) + 1) % P for v in dfr.decode(adv[1 % adv.shape[0]])]
    z = [1] * (1 << k)
    for r in range((1 << k) - 1):
        z[r + 1] = z[r] * num[r] % P * pow(den[r], -1, P) % P
    for got in _outs(case, group, 5):
        assert got["violations"].tolist() == [0] * len(got["violations"])
        assert np.array_equal(got["coeffs"], coeffs.numpy())
        assert list(zip(*got["commitments"])) == commits
        assert [int(v) for v in dfr.decode(torch.from_numpy(got["z"]))] == z


def _ref_planted_columns(k):
    """The reference's hash_v1 witness columns at k, encoded by the
    reference, with the PLANTED cells set; and its constraint system."""
    from halo2_tpu.field.device import get_device_field as ref_device_field
    from halo2_tpu.plonkish.assignment import run_synthesis
    from halo2_tpu.plonkish.evaluator import encode_columns

    circuit, public = _hash_v1(REF)
    cs, _cfg, assignment = run_synthesis(
        circuit, k, [list(public)], witness=True, field=ref_field.Fr
    )
    dfr = ref_device_field(REF_FR)
    columns = encode_columns(dfr, assignment.finalize())
    for kind, ci, row, value in PLANTED:
        columns[kind] = columns[kind].at[ci, :, row].set(dfr.encode([value])[:, 0])
    return cs, dfr, columns


@pytest.fixture(scope="module")
def ref_planted(case):
    """The reference gate checker's (C, n) violation mask over the planted
    columns: what its sharded prove step sums into its violation counts."""
    from halo2_tpu.plonkish.evaluator import build_gate_checker

    cs, dfr, columns = _ref_planted_columns(case["k"])
    check, _meta = build_gate_checker(cs, dfr)
    return np.asarray(check(columns))


@pytest.mark.parametrize("group", list(GROUPS))
def test_sharded_prove_step_counts_planted_violations(case, ref_planted, group):
    """A witness with the gate broken on one row of the first half and two
    of the second: every rank reports the reference's per-constraint counts,
    exactly [3], at each W."""
    assert [list(np.nonzero(row)[0]) for row in ref_planted] == [list(PLANTED_ROWS)]
    want = ref_planted.sum(axis=-1).tolist()
    assert want == [len(PLANTED_ROWS)]
    for got in _outs(case, group, 7):
        assert got["violations"].tolist() == want


@pytest.mark.parametrize("rows", [(0, 64), (0, 32), (32, 32), (5, 40), (63, 1), (17, 47)])
def test_vm_eval_rows_match_slices_of_the_full_run(rows):
    """A row range of the plain VM (and of the wrapper, on the CPU) equals
    the same columns of the full run, rotations wrapping at the full n."""
    from halo2_tpu_torch.field.params import BN254_FR as FR
    from halo2_tpu_torch.plonkish.column import Column, ColumnKind, Rotation
    from halo2_tpu_torch.plonkish.evaluator import Program
    from halo2_tpu_torch.plonkish.expression import Constant, Query

    n, rot_scale = 64, 4

    def q(i, r):
        return Query(Column(ColumnKind.ADVICE, i), Rotation(r))

    exprs = [q(0, 0) * q(1, 1) + q(0, -1) * Constant(7), q(1, 3) - q(0, 2) * q(1, -3), q(1, -1)]
    table = cuda_vm.compile_program(Program(exprs, rot_scale=rot_scale), FR)
    gen = torch.Generator().manual_seed(5)
    cols = [
        get_device_field(FR).encode(
            [int(v) for v in torch.randint(0, 1 << 62, (n,), generator=gen)]
        )
        for _ in range(2)
    ]
    queries = [cols[ci] for _kind, ci, _rot in table.queries]
    consts = table.consts_on("cpu")
    full = cuda_vm.vm_eval_plain(table, queries, consts, n)
    row0, count = rows
    want = full[..., row0 : row0 + count]
    assert torch.equal(cuda_vm.vm_eval_plain(table, queries, consts, n, rows), want)
    assert torch.equal(cuda_vm.vm_eval(table, queries, consts, n, rows), want)


@pytest.mark.parametrize("rows", [(0, 0), (-1, 4), (60, 5), (0, 65)])
def test_vm_eval_rejects_bad_row_ranges(rows):
    from halo2_tpu_torch.field.params import BN254_FR as FR
    from halo2_tpu_torch.plonkish.column import Column, ColumnKind, Rotation
    from halo2_tpu_torch.plonkish.evaluator import Program
    from halo2_tpu_torch.plonkish.expression import Query

    table = cuda_vm.compile_program(Program([Query(Column(ColumnKind.ADVICE, 0), Rotation(1))]), FR)
    col = get_device_field(FR).encode(list(range(64)))
    with pytest.raises(ValueError, match="row range"):
        cuda_vm.vm_eval(table, [col], table.consts_on("cpu"), 64, rows)


def test_create_proof_mesh_without_process_group_raises():
    from halo2_tpu_torch.kzg import ParamsKZG, create_proof
    from halo2_tpu_torch.kzg.engine import ShardedEngine

    with pytest.raises(RuntimeError, match="no process group"):
        ShardedEngine(None, None, mesh=object())
    circuit, public = _hash_v1(PORT)
    with pytest.raises(ValueError, match="engine='native'"):
        create_proof(
            ParamsKZG.setup_cached(4), None, circuit, [public], mesh=object(), engine="native"
        )


def test_spawn_raises_when_a_rank_raises():
    from torch_rank_fails import fail_on_rank

    with pytest.raises(Exception, match="rank 1 fails on purpose"):
        spawn(fail_on_rank, 2, "gloo", "cpu", 1, dp=1)


# ------------------------------------------------------------------- slow tier
@pytest.mark.slow
def test_sharded_msm_matches_reference_sharded_msm(case):
    """The reference's own sharded MSM and device-Horner MSM on the same
    inputs, as affine points (minutes of XLA:CPU compile)."""
    import jax.numpy as jnp
    from halo2_tpu.ec.device import _msm_raw as ref_msm_raw
    from halo2_tpu.ec.device import df as ref_dfq, jac_to_affine

    inp = case["inp"]
    args = [jnp.asarray(inp[k]) for k in ("px", "py", "sc")]
    d = ref_dfq()
    for pt in (ref_par.sharded_msm(ref_par.make_mesh(8), *args), ref_msm_raw(MSM_N)(*args)):
        gx, gy = jac_to_affine(pt)
        want = (int(d.decode(gx)), int(d.decode(gy)))
        assert want == inp["msm_host"]
        for group in GROUPS:
            assert _outs(case, group, 2)[0]["affine"] == want


@pytest.mark.slow
def test_sharded_prove_step_matches_reference_pipeline(case):
    """The reference's own sharded prove step (its 8-device mesh) over the
    same planted columns and SRS points: the same violation counts, advice
    coefficients and z limb for limb, the same commitments as affine points
    (minutes of XLA:CPU compile)."""
    import jax.numpy as jnp
    from halo2_tpu.ec.device import df as ref_dfq, jac_to_affine
    from halo2_tpu_torch.kzg import ParamsKZG

    cs, _dfr, columns = _ref_planted_columns(case["k"])
    params = ParamsKZG.setup_cached(case["k"])
    px, py = (jnp.asarray(np.ascontiguousarray(a[:, :16])) for a in (params.g1_x, params.g1_y))
    step = ref_par.build_sharded_prove_step(ref_par.make_mesh(8), cs, REF_FR, 16)
    violations, coeffs, commitments, z = step(columns, px, py)
    gx, gy = jac_to_affine({key: v.T for key, v in commitments.items()})
    d = ref_dfq()
    want_commits = [(int(x), int(y)) for x, y in zip(d.decode(gx), d.decode(gy))]
    for group in GROUPS:
        for got in _outs(case, group, 7):
            assert got["violations"].tolist() == np.asarray(violations).tolist()
            assert np.array_equal(got["coeffs"], np.asarray(coeffs).view(np.int32))
            assert np.array_equal(got["z"], np.asarray(z).view(np.int32))
            assert list(zip(*got["commitments"])) == want_commits


@pytest.mark.slow
def test_create_proof_mesh_lookup_circuit(tmp_path):
    """less_than_v2 at k = 9 (the reference's lookup case of its sharded
    tests, random.Random(13)) at W = 2, sp = 2: equal to the reference's
    single-chip proof on both ranks, and verified."""
    k = 9
    from halo2_tpu.circuits.less_than_v2 import LessThanV2Circuit

    ref_circuit = LessThanV2Circuit(ref_field.Fr, value_l=5, value_r=10, check=True)
    ref_params = ref_kzg.ParamsKZG.setup_cached(k)
    ref_pk = ref_kzg.keygen(ref_params, ref_circuit, k, ref_field.Fr)
    pk_path = str(tmp_path / "pk_lt_v2_k9.pkl")
    ref_pk.save(pk_path)
    want = ref_kzg.create_proof(ref_params, ref_pk, ref_circuit, [[]], rng=random.Random(13))
    job = [("prove", {"name": "less_than_v2", "k": k, "pk_path": pk_path, "seed": 13})]
    for rank in spawn(jobs.run, 2, "gloo", "cpu", job, dp=1):
        assert rank[0]["out"]["proof"] == want
        assert rank[0]["out"]["verified"]
