"""The port's CircuitLayout against the reference's and the committed goldens.

The six circuits of tests/test_layout.py (the reference's ``print_*``
tests), each built once from each package's classes and rendered by that
package's ``CircuitLayout().render``: the port's SVG must equal the golden
in prints/ and the reference's render of the same circuit, byte for byte.
This test only reads the goldens; a missing one fails it.
"""

import importlib
import os

import pytest

import experiment_vectors as ev
from torch_threads import one_torch_thread  # noqa: F401  (autouse fixture)

PRINTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "prints")
REF, PORT = ev.side("halo2_tpu"), ev.side("halo2_tpu_torch")


def _zeros(s, n):
    return [s.plonkish.Value.known(s.field.Fp.zero())] * n


def _merkle(version):
    name, cls = f"merkle_v{version}", f"MerkleTreeV{version}Circuit"

    def build(s):
        z = s.plonkish.Value.known(s.field.Fp.zero())
        return getattr(s.circuit(name), cls)(s.field.Fp, z, [z] * 5, [z] * 5)

    return build


def _inclusion_check(s):
    circuit = s.circuit("inclusion_check").InclusionCheckCircuit
    return circuit(s.field.Fp, _zeros(s, 10), _zeros(s, 10), 2)


def _poseidon(s):
    spec = importlib.import_module(f"{s.pkg}.poseidon").MySpec(5, 4)
    zero = s.plonkish.Value.known(s.field.Fp.zero())
    return s.circuit("poseidon").PoseidonCircuit(s.field.Fp, spec, 4, _zeros(s, 4), zero)


def _merkle_sum_tree(s):
    z = s.field.Fp.zero()
    circuit = s.circuit("merkle_sum_tree").MerkleSumTreeCircuit
    return circuit(s.field.Fp, z, z, [z] * 4, [z] * 4, [z] * 4, z)


# golden -> (k, build function, title), as tests/test_layout.py renders them
LAYOUTS = {
    "inclusion-check-1-layout.svg": (3, _inclusion_check, "Inclusion Check 1 Layout"),
    "merkle-tree-1-layout.svg": (4, _merkle(1), "Merkle Tree 1 Layout"),
    "merkle-tree-2-layout.svg": (4, _merkle(2), "Merkle Tree 2 Layout"),
    "merkle-tree-3-layout.svg": (8, _merkle(3), "Merkle Tree 3 Layout"),
    "poseidon-layout.svg": (7, _poseidon, "Poseidon Layout"),
    "merkle-sum-tree-layout.svg": (8, _merkle_sum_tree, "Merkle Sum Tree Layout"),
}


def _render(s, golden):
    k, build, title = LAYOUTS[golden]
    layout = importlib.import_module(f"{s.pkg}.dev.layout")
    return layout.CircuitLayout().render(k, build(s), None, F=s.field.Fp, title=title)


@pytest.mark.parametrize("golden", list(LAYOUTS))
def test_layout_matches_golden_and_reference(golden):
    with open(os.path.join(PRINTS, golden)) as f:
        want = f.read()
    got = _render(PORT, golden)
    assert got == want
    assert got == _render(REF, golden)
