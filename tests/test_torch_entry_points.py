"""The port's entry points run on the card unless the caller asks for the CPU.

Called without ``device`` while ``torch.cuda.is_available`` says False, each
entry point must raise a RuntimeError that names ``device='cpu'``, before any
work: it never carries on on the CPU.  The arguments other than ``device``
are dummies, since the device is resolved first.
"""

import pytest
import torch

from halo2_tpu_torch._device import resolve_device
from halo2_tpu_torch.circuits.utils import full_prover
from halo2_tpu_torch.dev import MockProver
from halo2_tpu_torch.kzg import ParamsKZG, create_proof, keygen, keygen_pk, keygen_vk
from halo2_tpu_torch.kzg.keygen import _intt_columns, commit_lagrange, keygen_cached

ENTRY_POINTS = {
    "create_proof": lambda tmp: create_proof(None, None, None, [[]]),
    "MockProver.__init__": lambda tmp: MockProver(None, None, None, None),
    "MockProver.run": lambda tmp: MockProver.run(4, None, [], F=None),
    "ParamsKZG.setup": lambda tmp: ParamsKZG.setup(4),
    "ParamsKZG.setup_cached": lambda tmp: ParamsKZG.setup_cached(4, cache_dir=str(tmp)),
    "keygen_vk": lambda tmp: keygen_vk(None, None, 4, None),
    "keygen_pk": lambda tmp: keygen_pk(None, None, None, 4, None),
    "keygen": lambda tmp: keygen(None, None, 4, None),
    "keygen_cached": lambda tmp: keygen_cached(None, None, 4, None, str(tmp / "pk.pkl")),
    "commit_lagrange": lambda tmp: commit_lagrange(None, None, [1, 2]),
    "_intt_columns": lambda tmp: _intt_columns(None, [[1, 2]]),
    "full_prover": lambda tmp: full_prover(None, 4, []),
}


@pytest.mark.parametrize("name", list(ENTRY_POINTS))
def test_entry_point_without_a_card_raises(name, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](tmp_path)


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 0)) == torch.device("cuda", 0)
