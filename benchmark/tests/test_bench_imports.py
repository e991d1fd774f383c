"""Nothing of the benchmark imports JAX or the JAX package (top-level
module names compared whole: ``halo2_tpu_torch`` is the port, ``halo2_tpu``
the JAX package), and the references import nothing of the port."""

import ast
import json
import subprocess
import sys

from benchmark import run

FORBIDDEN = {"jax", "jaxlib", "flax", "halo2_tpu"}


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_module_of_the_benchmark_imports_jax():
    files = sorted(p for p in (run.HERE).rglob("*.py") if "_cache" not in p.parts)
    assert len(files) > 20
    for f in files:
        assert not set(_imports(f)) & FORBIDDEN, f


def test_references_and_yardstick_import_nothing_of_the_program():
    here = run.HERE
    for f in [*(here / "reference").glob("*.py"), *(here / "metrics").glob("*.py"), here / "fields.py", here / "trace.py"]:
        assert "halo2_tpu_torch" not in set(_imports(f)), f


def test_a_run_loads_no_jax(tmp_path):
    code = (
        "import json, sys, time; from benchmark import run\n"
        "b = run.manifest()\n"
        "small = {'hash_device': {'batches': [2]}, 'lagrange_to_coeff': {'columns': 1}}\n"
        "for cell in b['workloads']:\n"
        "    t = run.load_json('workloads', cell['traffic']); c = run.load_json('configs', cell['config'])\n"
        "    t.update(small[t['entry']]); c.update({'k': 3} if 'k' in c else {})\n"
        "    run.run_cell(b, cell, 3, 0.01, False, 'cpu', config=c, traffic=t, t0=time.perf_counter(), cache_dir=run.Path(sys.argv[1]))\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], cwd=run.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert "halo2_tpu_torch" in loaded and not loaded & FORBIDDEN
    assert set(run.FORBIDDEN) == FORBIDDEN
