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
    assert cuda_jac.LAUNCHES["jac_madd"] > before["jac_madd"]
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
