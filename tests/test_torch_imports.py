"""The port stands alone and imports without JAX, as it must on the machine
with the card.

A subprocess blocks ``jax`` (``sys.modules["jax"] = None``) and imports every
module of the port, the flagship circuit and chip_smoke.py.  JAX must never
load, the reference package ``halo2_tpu`` and its ``__graft_entry__`` must
never be imported, and every
``halo2_tpu_torch`` module's file and every ``__path__`` entry of its
packages must lie under ``halo2_tpu_torch/``: the port keeps its own copies
of the reference's host modules.
"""

import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_DIR = os.path.join(ROOT, "halo2_tpu_torch")
JAX_IMPORT = re.compile(r"^\s*(import jax|from jax)\b", re.M)

SLICE_MODULES = [
    "halo2_tpu_torch",
    "halo2_tpu_torch._build",
    "halo2_tpu_torch.field",
    "halo2_tpu_torch.field.cuda_mul",
    "halo2_tpu_torch.field.cuda_ops",
    "halo2_tpu_torch.field.device",
    "halo2_tpu_torch.poly",
    "halo2_tpu_torch.poly.cuda_ntt",
    "halo2_tpu_torch.poly.domain",
    "halo2_tpu_torch.plonkish",
    "halo2_tpu_torch.plonkish.cuda_vm",
    "halo2_tpu_torch.plonkish.evaluator",
    "halo2_tpu_torch.poseidon",
    "halo2_tpu_torch.poseidon.primitives",
    "halo2_tpu_torch.ec",
    "halo2_tpu_torch.ec.cuda_jac",
    "halo2_tpu_torch.ec.device",
    "halo2_tpu_torch.native",
    "halo2_tpu_torch.kzg",
    "halo2_tpu_torch.kzg.params",
    "halo2_tpu_torch.kzg.keygen",
    "halo2_tpu_torch.kzg.engine",
    "halo2_tpu_torch.kzg.prover",
    "halo2_tpu_torch.kzg.verifier",
    "halo2_tpu_torch.dev",
    "halo2_tpu_torch.dev.mock_prover",
    "halo2_tpu_torch.circuits.utils",
    "halo2_tpu_torch.circuits.add_carry_v1",
    "halo2_tpu_torch.circuits.add_carry_v2",
    "halo2_tpu_torch.circuits.hash_v1",
    "halo2_tpu_torch.circuits.hash_v2",
    "halo2_tpu_torch.circuits.inclusion_check",
    "halo2_tpu_torch.circuits.inclusion_check_v2",
    "halo2_tpu_torch.circuits.less_than",
    "halo2_tpu_torch.circuits.less_than_v2",
    "halo2_tpu_torch.circuits.less_than_v3",
    "halo2_tpu_torch.circuits.merkle_sum_tree",
    "halo2_tpu_torch.circuits.merkle_v1",
    "halo2_tpu_torch.circuits.merkle_v2",
    "halo2_tpu_torch.circuits.merkle_v3",
    "halo2_tpu_torch.circuits.overflow_check",
    "halo2_tpu_torch.circuits.overflow_check_v2",
    "halo2_tpu_torch.circuits.poseidon",
    "halo2_tpu_torch.circuits.safe_accumulator",
    "halo2_tpu_torch.north_star",
    "halo2_tpu_torch.bench",
    "halo2_tpu_torch.crossover",
    "halo2_tpu_torch.scaling",
    "halo2_tpu_torch.parallel",
    "halo2_tpu_torch.parallel.mesh",
    "halo2_tpu_torch.parallel.comm",
    "halo2_tpu_torch.parallel.launch",
    "halo2_tpu_torch.parallel.msm",
    "halo2_tpu_torch.parallel.ntt",
    "halo2_tpu_torch.parallel.scan",
    "halo2_tpu_torch.parallel.pipeline",
    "halo2_tpu_torch.parallel.jobs",
    "halo2_tpu_torch.graft_entry",
    "chip_smoke",
]

_PROBE = r"""
import importlib, json, os, pkgutil, sys
sys.modules["jax"] = None
import halo2_tpu_torch
names = json.loads(sys.argv[1])
walk = pkgutil.walk_packages(halo2_tpu_torch.__path__, "halo2_tpu_torch.")
names += [m.name for m in walk if "._engine_" not in m.name]  # not the native engine's library
for name in names:
    importlib.import_module(name)
loaded = [
    k for k, v in sys.modules.items() if v is not None and (k == "jax" or k.startswith("jax."))
]
ref = [
    k for k in sys.modules if k in ("halo2_tpu", "__graft_entry__") or k.startswith("halo2_tpu.")
]
port = {k: m for k, m in list(sys.modules.items()) if k.startswith("halo2_tpu_torch")}
files = {k: os.path.abspath(m.__file__) for k, m in port.items() if getattr(m, "__file__", None)}
paths = {
    k: [os.path.abspath(p) for p in m.__path__] for k, m in port.items() if hasattr(m, "__path__")
}
print(json.dumps({"jax": loaded, "reference_package": ref, "files": files, "paths": paths}))
"""


def test_slice_imports_without_jax():
    res = subprocess.run(
        [sys.executable, "-c", _PROBE, json.dumps(SLICE_MODULES)],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["jax"] == []
    assert out["reference_package"] == []
    assert len(out["files"]) > 80
    outside = {k: f for k, f in out["files"].items() if not f.startswith(PORT_DIR + os.sep)}
    assert outside == {}
    outside = {
        k: p
        for k, ps in out["paths"].items()
        for p in ps
        if not (p + os.sep).startswith(PORT_DIR + os.sep)
    }
    assert outside == {}
    for name in (
        "halo2_tpu_torch.north_star",
        "halo2_tpu_torch.bench",
        "halo2_tpu_torch.crossover",
        "halo2_tpu_torch.circuits.merkle_sum_tree",
        "halo2_tpu_torch.kzg.verifier",
        "halo2_tpu_torch.dev.failures",
        "halo2_tpu_torch.circuits.utils",
        "halo2_tpu_torch.native",
        "halo2_tpu_torch.parallel.ntt",
        "halo2_tpu_torch.parallel.launch",
        "halo2_tpu_torch.scaling",
        "halo2_tpu_torch.graft_entry",
    ):
        assert out["files"][name].startswith(PORT_DIR + os.sep)


def test_no_port_file_imports_jax():
    scripts = (
        "chip_smoke.py", "scripts/inv_probe.py", "scripts/msm_probe.py", "scripts/prove_pairs.py",
        "scripts/ladder_probe.py",
    )
    paths = [os.path.join(ROOT, name) for name in scripts]
    for dirpath, _dirs, names in os.walk(PORT_DIR):
        paths += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(paths) > 15
    for path in paths:
        with open(path) as f:
            assert not JAX_IMPORT.search(f.read()), path
