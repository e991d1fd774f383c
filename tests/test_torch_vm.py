"""The port's compiled expression VM against the reference's, exactly.

Each program is compiled by ``cuda_vm.compile_program`` and run by the CUDA
kernel's plain version, ``vm_eval_plain`` (on the CPU), and the same
expressions go through the reference's ``build_expr_batch_eval`` (its
``lax.scan`` VM, jnp on the CPU), on the same random canonical Montgomery
columns made with numpy from a seed; the outputs must agree limb for limb.
The programs: the flagship's combined quotient (merkle-sum tree, k = 11,
so the permutation's last-row rotation is 2042; rot_scale 16 at a narrow
width, with the challenge columns handed over as stride-0 views, as the
prover does), the Poseidon experiment's gates and a dynamic lookup's
expressions over Pasta Fp, 150 live products (150 registers), and programs
whose output is a bare query, a bare constant, or nothing.  The register
allocation is pinned and replayed; the kernel's per-warp streams are
checked for races within a phase and replayed in another order; the
kernel's block sizes are pinned.
"""

import copy
import importlib
import random
import types

import numpy as np
import pytest
import torch

from halo2_tpu.field.device import get_device_field as ref_field
from halo2_tpu.plonkish.evaluator import build_expr_batch_eval as ref_batch_eval
from halo2_tpu_torch.field import params as port_params
from halo2_tpu_torch.plonkish import cuda_vm
from halo2_tpu_torch.plonkish.evaluator import Program, _run_program
from halo2_tpu_torch.field.device import get_device_field as port_field
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

WIDTH = 256  # rows of every random column
ROT_SCALE = 16
K = 11  # the flagship's k: the last usable row, and a rotation, is 2042


def _side(pkg: str):
    mod = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        field=mod("field"),
        params=mod("field.params"),
        plonkish=mod("plonkish"),
        column=mod("plonkish.column"),
        expression=mod("plonkish.expression"),
        assignment=mod("plonkish.assignment"),
        keygen=mod("kzg.keygen"),
        poseidon=mod("poseidon"),
        mst=mod("circuits.merkle_sum_tree"),
        poseidon_circuit=mod("circuits.poseidon"),
        less_than=mod("circuits.less_than"),
    )


REF, PORT = _side("halo2_tpu"), _side("halo2_tpu_torch")


def _cs(s, circuit, k, F):
    cs, _cfg, _asn = s.assignment.run_synthesis(circuit.without_witnesses(), k, [], witness=False, field=F)
    return cs


def _flagship(s):
    """The flagship's structure (its constraint system does not depend on
    the tree's depth; two levels keep synthesis short)."""
    m, Fr = s.mst, s.field.Fr
    leaf = m.Node(Fr.from_u64(10), Fr.from_u64(100))
    elements = [m.Node(Fr.from_u64(h), Fr.from_u64(b)) for h, b in [(1, 10), (5, 50)]]
    indices = [Fr.from_u64(0), Fr.from_u64(1)]
    root = m.compute_merkle_sum_root(Fr, leaf, elements, indices)
    circuit = m.MerkleSumTreeCircuit(
        Fr, leaf.hash, leaf.balance, [n.hash for n in elements],
        [n.balance for n in elements], indices, root.balance + Fr.from_u64(1),
    )
    return s.keygen.PlonkStructure(_cs(s, circuit, K, Fr), K)


def _poseidon_cs(s):
    """The Poseidon experiment: width 5, rate 4, L = 4 over Pasta Fp, k = 7."""
    Fp, Value = s.field.Fp, s.plonkish.Value
    spec = s.poseidon.MySpec(5, 4)
    message = [Fp.from_u64(99)] * 4
    digest = s.poseidon.poseidon_hash(Fp, spec, message)
    circuit = s.poseidon_circuit.PoseidonCircuit(Fp, spec, 4, [Value.known(x) for x in message], Value.known(digest))
    return _cs(s, circuit, 7, Fp)


def _less_than_cs(s):
    """The less-than experiment's dynamic lookup over Pasta Fp, k = 10."""
    Fp = s.field.Fp
    return _cs(s, s.less_than.LessThanCircuit(Fp, s.plonkish.Value.known(Fp.from_u64(755))), 10, Fp)


def _bare(s, which):
    col, ex = s.column, s.expression
    query = ex.Query(col.Column(col.ColumnKind.ADVICE, 1), col.Rotation(-3))
    const = ex.Constant(7)
    return {
        "many_registers": [query * ex.Constant(i + 2) for i in range(150)],
        "bare_query": [query, query * const],
        "bare_constant": [const, ex.Constant(0), query + const],
        "query_and_constant_only": [query, const],
        "empty": [],
    }[which]


def _gates(cs):
    return [c for gate in cs.gates for c in gate.constraints]


def _lookups(cs):
    return [e for lk in cs.lookups for pair in lk.pairs for e in pair]


# name -> (side -> (exprs, rot_scale), field name, stride-0 aux columns)
CASES = {
    "flagship_quotient": (lambda s: ([_flagship(s).combined_quotient()], ROT_SCALE), "BN254_FR", True),
    "poseidon_gates": (lambda s: (_gates(_poseidon_cs(s)), 1), "PASTA_FP", False),
    "less_than_lookups": (lambda s: (_lookups(_less_than_cs(s)), 1), "PASTA_FP", False),
    **{
        name: ((lambda name: lambda s: (_bare(s, name), 1))(name), "BN254_FR", False)
        for name in (
            "many_registers", "bare_query", "bare_constant", "query_and_constant_only", "empty",
        )
    },
}


def _aux_challenges(s):
    """The flagship's challenge columns (beta, gamma, theta, y), which the
    prover hands the VM as expanded (16, 1) constants."""
    aux = s.keygen.AuxLayout(0, 0)
    return {aux.BETA, aux.GAMMA, aux.THETA, aux.Y}


@pytest.fixture(scope="module")
def programs():
    """name -> (reference exprs, port exprs, rot_scale, port Program)."""
    out = {}
    for name, (build, _field, _aux) in CASES.items():
        (ref_exprs, rot), (port_exprs, _) = build(REF), build(PORT)
        out[name] = (ref_exprs, port_exprs, rot, Program(port_exprs, rot_scale=rot))
    return out


def _columns(prog, field: str, seed: int, stride0: bool):
    """Random canonical Montgomery columns for every queried kind: the
    reference's (C, 16, WIDTH) uint32 arrays and the port's lists of int32
    (16, WIDTH) tensors, the challenge columns of the aux kind as expanded
    views of one element when ``stride0``."""
    rng = random.Random(seed)
    spec = getattr(REF.params, field)
    enc = ref_field(spec).encode_np
    counts = {"advice": 1}
    for kind, ci, _rot in prog.queries:
        counts[kind] = max(counts.get(kind, 0), ci + 1)
    challenges = _aux_challenges(PORT) if stride0 else set()
    ref_cols, port_cols = {}, {}
    for kind, c in counts.items():
        arrs, tensors = [], []
        for ci in range(c):
            if kind == "aux" and ci in challenges:
                one = enc([rng.randrange(spec.p)])
                arrs.append(np.broadcast_to(one, (16, WIDTH)))
                tensors.append(torch.from_numpy(one.view(np.int32)).expand(16, WIDTH))
            else:
                limbs = enc([rng.randrange(spec.p) for _ in range(WIDTH)])
                arrs.append(limbs)
                tensors.append(torch.from_numpy(limbs.view(np.int32)))
        ref_cols[kind] = np.stack(arrs) if arrs else np.zeros((0, 16, WIDTH), np.uint32)
        port_cols[kind] = tensors
    return ref_cols, port_cols


def _port_eval(prog, field: str, port_cols):
    spec = getattr(port_params, field)
    table = cuda_vm.compile_program(prog, spec)
    queries = [port_cols[kind][ci] for kind, ci, _rot in prog.queries]
    return cuda_vm.vm_eval_plain(table, queries, table.consts_on("cpu"), WIDTH)


@pytest.mark.parametrize("seed", [1, 2])
@pytest.mark.parametrize("name", list(CASES))
def test_vm_plain_matches_reference(programs, name, seed):
    ref_exprs, _port_exprs, rot, prog = programs[name]
    _build, field, stride0 = CASES[name]
    ref_cols, port_cols = _columns(prog, field, seed, stride0)
    ref_spec = getattr(REF.params, field)
    # build_expr_batch_eval reads no constraint system
    want = np.asarray(ref_batch_eval(None, ref_field(ref_spec), ref_exprs, rot)(ref_cols))
    got = _port_eval(prog, field, port_cols)
    assert got.dtype == torch.int32 and tuple(got.shape) == (len(ref_exprs), 16, WIDTH)
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # _run_program is the same compiled VM; on CPU tensors it takes the plain version
    assert torch.equal(_run_program(prog, port_field(getattr(port_params, field)), port_cols), got)


def test_flagship_program_shape(programs):
    """The flagship's quotient program: every rotation (2042 the wrap at
    k = 11), its size, and the challenges read as stride-0 queries."""
    prog = programs["flagship_quotient"][3]
    assert sorted({rot for _k, _c, rot in prog.queries}) == [-1, 0, 1, 2042]
    assert (len(prog.queries), len(prog.consts), len(prog.instrs)) == (127, 76, 771)
    aux = {ci for kind, ci, _rot in prog.queries if kind == "aux"}
    layout = PORT.keygen.AuxLayout
    assert {layout.BETA, layout.GAMMA, layout.Y} <= aux  # theta only compresses multi-column lookups
    table = cuda_vm.compile_program(prog, port_params.BN254_FR)
    assert 2042 * ROT_SCALE % WIDTH in table.shifts(WIDTH)


# liveness over the stream schedule: the flagship's quotient program needs
# 27 registers (16 when one stream runs it in program order; more results
# are live at once when four streams each work on their own part of it)
REGISTERS = {"flagship_quotient": 27, "many_registers": 150}


@pytest.mark.parametrize("name", list(CASES))
def test_register_allocation_replays_the_program(programs, name):
    """Replaying the compiled table symbolically, in table order, gives back
    the Program: every register source holds, when read, the result the
    Program names (defined before use, not yet overwritten), and so does
    every output."""
    prog = programs[name][3]
    table = cuda_vm.compile_program(prog, port_params.BN254_FR)
    assert cuda_vm.compile_program(prog, port_params.BN254_FR) is table  # cached
    nq, nc = len(prog.queries), len(prog.consts)
    holds = {}  # register -> the instruction whose result it holds

    def check(src, slot):
        tag, idx = src & 3, src >> 2
        if slot < nq:
            assert (tag, idx) == (cuda_vm.SRC_QUERY, slot)
        elif slot < nq + nc:
            assert (tag, idx) == (cuda_vm.SRC_CONST, slot - nq)
        else:
            assert tag == cuda_vm.SRC_REG and holds.get(idx) == slot - nq - nc

    assert table.instrs.shape == (len(prog.instrs), 4)
    assert sorted(table.order.tolist()) == list(range(len(prog.instrs)))
    for j, (top, t1, t2, dst) in zip(table.order.tolist(), table.instrs.tolist()):
        op, s1, s2 = prog.instrs[j]
        assert top == op
        check(t1, s1)
        check(t2, s2)
        assert 0 <= dst < table.num_regs
        holds[dst] = j
    assert len(table.outputs) == len(prog.output_slots())
    for src, slot in zip(table.outputs.tolist(), prog.output_slots()):
        check(src, slot)
    if name in REGISTERS:
        assert table.num_regs == REGISTERS[name]
    assert table.num_regs <= max(len(prog.instrs), 1)


def test_constants_are_montgomery_words(programs):
    prog = programs["flagship_quotient"][3]
    spec = port_params.BN254_FR
    table = cuda_vm.compile_program(prog, spec)
    assert table.consts.dtype == np.uint32 and table.consts.shape == (len(prog.consts), 8)
    for v, words in zip(prog.consts, table.consts.tolist()):
        assert sum(w << (32 * k) for k, w in enumerate(words)) == v * spec.r % spec.p
    limbs = cuda_vm._const_limbs(table.consts_on("cpu"))
    assert torch.equal(limbs, port_field(spec).encode(prog.consts))


def test_vm_eval_takes_the_plain_version_on_cpu(programs):
    prog = programs["flagship_quotient"][3]
    _ref, port_cols = _columns(prog, "BN254_FR", 3, True)
    table = cuda_vm.compile_program(prog, port_params.BN254_FR)
    queries = [port_cols[kind][ci] for kind, ci, _rot in prog.queries]
    consts = table.consts_on("cpu")
    before = cuda_vm.LAUNCHES["vm_eval"]
    assert torch.equal(
        cuda_vm.vm_eval(table, queries, consts, WIDTH), cuda_vm.vm_eval_plain(table, queries, consts, WIDTH)
    )
    assert cuda_vm.LAUNCHES["vm_eval"] == before


@pytest.mark.parametrize(
    "bad",
    ["too_few_queries", "wrong_width", "int64_query", "consts_shape", "meta_device", "zero_rows"],
)
def test_vm_eval_rejects_what_the_kernel_cannot_take(programs, bad):
    prog = programs["bare_query"][3]
    table = cuda_vm.compile_program(prog, port_params.BN254_FR)
    q = torch.zeros((16, WIDTH), dtype=torch.int32)
    queries, consts, n = [q] * len(prog.queries), table.consts_on("cpu"), WIDTH
    if bad == "too_few_queries":
        queries = []
    elif bad == "wrong_width":
        queries = [q[:, :7]] * len(queries)
    elif bad == "int64_query":
        queries = [q.long()] * len(queries)
    elif bad == "consts_shape":
        consts = consts[:0]
    elif bad == "meta_device":
        queries, consts = [q.to("meta")] * len(queries), consts.to("meta")
    else:
        n = 0
    with pytest.raises((ValueError, TypeError)):
        cuda_vm.vm_eval(table, queries, consts, n)


def test_unknown_opcode_raises():
    prog = Program([])
    prog.instrs = [(7, 0, 0)]
    with pytest.raises(ValueError, match="opcode"):
        cuda_vm.compile_program(prog, port_params.BN254_FR)


def _stream_ranges(table):
    """(phase, stream, instruction rows) of the compiled schedule."""
    off, streams = table.offsets.tolist(), table.streams
    return [
        (p, st, range(off[p * streams + st], off[p * streams + st + 1]))
        for p in range(table.phases)
        for st in range(streams)
    ]


@pytest.mark.parametrize("name", list(CASES))
def test_streams_share_no_register_within_a_phase(programs, name):
    """The kernel's warps of one row meet only at the barriers that end the
    phases: within a phase no register that one stream writes is read or
    written by another, and the phases cover the table in order."""
    table = cuda_vm.compile_program(programs[name][3], port_params.BN254_FR)
    assert table.offsets[0] == 0 and table.offsets[-1] == len(table.instrs)
    assert np.all(np.diff(table.offsets) >= 0)
    for p in range(table.phases):
        touched = {}  # register -> {stream: wrote?}
        for _p, st, rows in _stream_ranges(table):
            if _p != p:
                continue
            for op, s1, s2, dst in table.instrs[rows.start : rows.stop].tolist():
                for src in (s1,) if op == cuda_vm.OP_NEG else (s1, s2):
                    if src & 3 == cuda_vm.SRC_REG:
                        touched.setdefault(src >> 2, {}).setdefault(st, False)
                touched.setdefault(dst, {})[st] = True
        for reg, by in touched.items():
            writers = [st for st, wrote in by.items() if wrote]
            assert not writers or len(by) == 1, (p, reg, by)


@pytest.mark.parametrize("name", list(CASES))
def test_vm_streams_replayed_in_reverse_match_reference(programs, name):
    """The per-warp streams replayed with the streams of each phase in the
    reverse order (a plain replay: no order among the streams of a phase
    may matter) equal the reference's ``build_expr_batch_eval``."""
    ref_exprs, _port_exprs, rot, prog = programs[name]
    _build, field, stride0 = CASES[name]
    ref_cols, port_cols = _columns(prog, field, 5, stride0)
    spec = getattr(port_params, field)
    table = cuda_vm.compile_program(prog, spec)
    ranges = _stream_ranges(table)
    by_phase = [[rows for q, _st, rows in reversed(ranges) if q == p] for p in range(table.phases)]
    order = [i for runs in by_phase for rows in runs for i in rows]
    replay = copy.copy(table)
    replay.instrs = table.instrs[order]
    queries = [port_cols[kind][ci] for kind, ci, _rot in prog.queries]
    got = cuda_vm.vm_eval_plain(replay, queries, table.consts_on("cpu"), WIDTH)
    ref_spec = getattr(REF.params, field)
    want = np.asarray(ref_batch_eval(None, ref_field(ref_spec), ref_exprs, rot)(ref_cols))
    assert np.array_equal(got.numpy().view(np.uint32), want)


# (registers, rows a block, shared-memory bytes a block) of each program the
# kernel runs; the Poseidon gates (the MockProver's) spread over four
# streams keep 80 registers live
BLOCKS = {
    "flagship_quotient": (27, 64, 55296),
    "poseidon_gates": (80, 64, 163840),
    "less_than_lookups": (0, 64, 0),
    "many_registers": (150, 32, 153600),
}


@pytest.mark.parametrize("name", list(BLOCKS))
def test_rows_per_block_of_the_programs(programs, name):
    _build, field, _stride0 = CASES[name]
    table = cuda_vm.compile_program(programs[name][3], getattr(port_params, field))
    regs, rows, smem = BLOCKS[name]
    assert table.num_regs == regs
    assert cuda_vm.rows_per_block(table.num_regs) == (rows, smem)
    assert rows * table.streams <= 256 and smem <= cuda_vm.SMEM_MAX


@pytest.mark.parametrize(
    "regs, want",
    [
        (0, (64, 0)), (113, (64, 231424)), (114, (32, 116736)), (227, (32, 232448)),
        (228, None), (1000, None),
    ],
)
def test_rows_per_block_limits(regs, want):
    """64 rows while 64 rows of registers fit 227 KB, then 32, then none."""
    if want is None:
        with pytest.raises(ValueError, match="registers"):
            cuda_vm.rows_per_block(regs)
    else:
        assert cuda_vm.rows_per_block(regs) == want


def _product_tree(side, lo, hi):
    """The product of a query times each constant lo + 2 .. hi + 1, as a
    balanced tree: every leaf is ready at once, so four streams would hold
    them all live where one stream, in program order, needs log2 of them."""
    col, ex = side.column, side.expression
    if hi - lo == 1:
        return ex.Query(col.Column(col.ColumnKind.ADVICE, 0), col.Rotation(0)) * ex.Constant(lo + 2)
    mid = (lo + hi) // 2
    return _product_tree(side, lo, mid) * _product_tree(side, mid, hi)


def test_a_program_too_wide_for_four_streams_runs_on_one():
    """A balanced tree of 256 products: over four streams its 256 leaves
    would be live at once (more than 227 registers), so the program is
    scheduled on one stream in its own order, and still equals the
    reference."""
    prog = Program([_product_tree(PORT, 0, 256)])
    table = cuda_vm.compile_program(prog, port_params.BN254_FR)
    assert (table.streams, table.phases, table.num_regs) == (1, 1, 9)
    four = cuda_vm._compile_streams(prog, port_params.BN254_FR, cuda_vm.STREAMS)
    assert four.num_regs > cuda_vm.MAX_REGS
    ref_cols, port_cols = _columns(prog, "BN254_FR", 6, False)
    queries = [port_cols[kind][ci] for kind, ci, _rot in prog.queries]
    got = cuda_vm.vm_eval(table, queries, table.consts_on("cpu"), WIDTH)
    ref_eval = ref_batch_eval(None, ref_field(REF.params.BN254_FR), [_product_tree(REF, 0, 256)], 1)
    want = np.asarray(ref_eval(ref_cols))
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_vm_eval_refuses_a_program_the_kernel_cannot_hold():
    """228 live results do not fit the kernel's shared memory on any
    schedule: vm_eval raises, on the CPU as on the card."""
    col, ex = PORT.column, PORT.expression
    query = ex.Query(col.Column(col.ColumnKind.ADVICE, 0), col.Rotation(0))
    prog = Program([query * ex.Constant(i + 2) for i in range(228)])
    table = cuda_vm.compile_program(prog, port_params.BN254_FR)
    assert table.num_regs == 228
    q = torch.zeros((16, WIDTH), dtype=torch.int32)
    with pytest.raises(ValueError, match="registers"):
        cuda_vm.vm_eval(table, [q], table.consts_on("cpu"), WIDTH)
