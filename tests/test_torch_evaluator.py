"""The port's quotient instruction VM against the reference's, exactly.

The merkle-sum-tree flagship's ``st.combined_quotient()`` (gates, the
permutation and lookup arguments, Horner-folded over y) runs on random
Montgomery columns through the reference's ``build_expr_batch_eval`` (jnp
on the CPU) and through the port's ``_run_program`` (the plain Montgomery
multiply on the CPU).  The column width is kept small: the VM treats every
row alike, and rotations wrap the same way at any width.
"""

import random

import numpy as np
import pytest
import torch

import halo2_tpu.circuits.merkle_sum_tree as ref_mst
import halo2_tpu_torch.circuits.merkle_sum_tree as port_mst
from halo2_tpu.field.device import get_device_field as ref_field
from halo2_tpu.field.host import Fr as RefFr
from halo2_tpu.field.params import BN254_FR as REF_FR
from halo2_tpu.kzg.keygen import PlonkStructure as RefStructure
from halo2_tpu.plonkish.assignment import run_synthesis as ref_synthesis
from halo2_tpu.plonkish.evaluator import build_expr_batch_eval as ref_batch_eval
from halo2_tpu_torch.field.device import get_device_field as port_field
from halo2_tpu_torch.field.host import Fr as PortFr
from halo2_tpu_torch.field.params import BN254_FR
from halo2_tpu_torch.kzg.keygen import PlonkStructure as PortStructure
from halo2_tpu_torch.plonkish.assignment import run_synthesis as port_synthesis
from halo2_tpu_torch.plonkish.evaluator import _run_program, build_expr_batch_eval
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

K = 9
WIDTH = 256  # rows of every random column
ROT_SCALE = 16


def _structure(mst, Fr, synthesis, structure_cls):
    leaf = mst.Node(Fr.from_u64(10), Fr.from_u64(100))
    elements = [mst.Node(Fr.from_u64(h), Fr.from_u64(b)) for h, b in [(1, 10), (5, 50)]]
    indices = [Fr.from_u64(0), Fr.from_u64(1)]
    root = mst.compute_merkle_sum_root(Fr, leaf, elements, indices)
    circuit = mst.MerkleSumTreeCircuit(
        Fr, leaf.hash, leaf.balance, [n.hash for n in elements],
        [n.balance for n in elements], indices, root.balance + Fr.from_u64(1),
    )
    cs, _cfg, _asn = synthesis(circuit.without_witnesses(), K, [], witness=False, field=Fr)
    return structure_cls(cs, K)


@pytest.fixture(scope="module")
def structures():
    return (
        _structure(ref_mst, RefFr, ref_synthesis, RefStructure),
        _structure(port_mst, PortFr, port_synthesis, PortStructure),
    )


def _random_columns(prog, seed):
    """kind -> (C, 16, WIDTH) random canonical Montgomery limbs (numpy)."""
    rng = random.Random(seed)
    counts = {}
    for kind, ci, _rot in prog.queries:
        counts[kind] = max(counts.get(kind, 0), ci + 1)
    enc = ref_field(REF_FR).encode_np
    cols = {}
    for kind in ("advice", "fixed", "instance", "selector", "aux"):
        c = counts.get(kind, 0)
        limbs = enc([rng.randrange(REF_FR.p) for _ in range(c * WIDTH)])
        cols[kind] = limbs.reshape(16, c, WIDTH).transpose(1, 0, 2).copy()
    return cols


def test_program_tables_match_reference(structures):
    ref_st, port_st = structures
    ref_prog = ref_st.quotient_program(ROT_SCALE)
    port_prog = port_st.quotient_program(ROT_SCALE)
    assert port_prog.queries == ref_prog.queries
    assert port_prog.consts == ref_prog.consts
    assert port_prog.instrs == ref_prog.instrs
    assert len(port_prog.instrs) > 700


@pytest.mark.parametrize("seed", [1, 2])
def test_combined_quotient_matches_reference(structures, seed):
    ref_st, port_st = structures
    cols = _random_columns(port_st.quotient_program(ROT_SCALE), seed)
    want = ref_batch_eval(ref_st.cs, ref_field(REF_FR), [ref_st.combined_quotient()], ROT_SCALE)(
        cols
    )
    port_cols = {k: torch.from_numpy(v.view(np.int32)) for k, v in cols.items()}
    got = _run_program(port_st.quotient_program(ROT_SCALE), port_field(BN254_FR), port_cols)
    assert got.shape == (1, 16, WIDTH)
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(want))
    via_batch = build_expr_batch_eval(
        port_st.cs, port_field(BN254_FR), [port_st.combined_quotient()], ROT_SCALE
    )(port_cols)
    assert torch.equal(via_batch, got)
