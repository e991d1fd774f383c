"""``BENCHMARK.json`` against the benchmark's contract, every file it names
loads by name, and a cell, a configuration and a per-layer metric are
added with new files and new entries alone."""

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

ROOT = run.ROOT
BENCH = run.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "configs": ({"name", "source", "file", "reduced", "why"}, set()),
    "workloads": ({"name", "config", "traffic", "chips", "why"}, set()),
    "end_to_end": ({"name", "unit", "better", "bound", "source"}, {"workloads"}),
    "per_layer": ({"name", "unit", "better", "source", "layer", "moves"}, {"workloads"}),
}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "end_to_end", "per_layer", "workloads"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p for p in BENCH["paths"])
    for kind, (need, may) in KEYS.items():
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
        for e in BENCH[kind]:
            assert need <= set(e) <= need | may, (kind, e["name"])
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert _line(e[key]), (e["name"], key)
    metric_names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metric_names) == len(set(metric_names))


def test_configs_and_cells():
    assert 1 <= len(BENCH["configs"]) <= 24 and 1 <= len(BENCH["workloads"]) <= 24
    used = {w["config"] for w in BENCH["workloads"]}
    pairs = set()
    for c in BENCH["configs"]:
        assert c["name"] in used and c["source"].startswith("https://")
        f = ROOT / c["file"]
        assert f.is_file() and c["file"].startswith(tuple(p + "/" for p in BENCH["paths"]))
        data = json.loads(f.read_text())
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert _line(data["source"]) and data["guarantee"] and data["assumed"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        assert w["chips"] in (1, 4) and NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        traffic = run.load_json("workloads", w["traffic"])
        run.load_json("configs", w["config"])
        run.load_module("drivers", traffic["entry"])
        run.load_module("reference", traffic["entry"])


def test_metrics():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
        run.load_module("metrics", m["name"])
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in run.cell_metrics(BENCH, cell, "end_to_end")}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
        run.load_module("metrics", m["name"])
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
    for w in BENCH["workloads"]:
        names = {m["name"] for m in run.cell_metrics(BENCH, w["name"], "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert run.cell_metrics(BENCH, w["name"], "per_layer")


def test_run_seconds_fit_a_full_check():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_files_under_paths_are_named_from_names():
    for p in BENCH["paths"]:
        for f in (ROOT / p).rglob("*"):
            rel = f.relative_to(ROOT).as_posix()
            if "_cache" in rel or "__pycache__" in rel or ".pytest_cache" in rel:
                continue
            assert re.fullmatch(r"[A-Za-z0-9_./-]+", rel), rel


def test_a_cell_a_configuration_and_a_metric_come_as_new_files(tmp_path):
    """A copy of the benchmark gains a configuration (width-3 Poseidon), a
    traffic mix, a cell on them and a per-layer metric of a new reader,
    with no file of the copy edited; the new cell runs on the CPU and
    reports the new metric."""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    before = {p: p.read_bytes() for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    cfg = json.loads((ROOT / "benchmark/configs/summa_mst_bn254.json").read_text())
    cfg.update({"width": 3, "rate": 2})
    (tmp_path / "benchmark/configs/mst_width3.json").write_text(json.dumps(cfg))
    (tmp_path / "benchmark/workloads/hash_tiny.json").write_text(
        json.dumps({"entry": "hash_device", "batches": [3, 2], "pool": 2, "check": {"requests": 1, "lanes": 8}})
    )
    (tmp_path / "benchmark/metrics/lanes_per_request.py").write_text(
        "def read(ctx):\n    return sum(c['lanes'] for c in ctx.state['calls'])\n"
    )
    bench["configs"].append({"name": "mst_width3", "source": "https://example.org/w3", "file": "benchmark/configs/mst_width3.json",
                             "reduced": [], "why": "width 3"})
    bench["workloads"].append({"name": "w3.tiny", "config": "mst_width3", "traffic": "hash_tiny", "chips": 1, "why": "tiny"})
    for m in bench["end_to_end"]:
        if m["name"] in ("hashes_per_s", "request_p95_ms"):
            m["workloads"].append("w3.tiny")
    bench["per_layer"].append({"name": "lanes_per_request.hash", "unit": "lanes", "better": "higher", "source": "program_counter",
                               "layer": "entry", "moves": "hashes_per_s", "workloads": ["w3.tiny"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, time; from benchmark import run\n"
        "b = run.manifest(); cell = next(w for w in b['workloads'] if w['name'] == 'w3.tiny')\n"
        "for trace in (False, True):\n"
        "    r = run.run_cell(b, cell, 9, 0.01, trace, 'cpu', t0=time.perf_counter())[0]\n"
        "    print(json.dumps({'correct': r['correct'], 'metrics': sorted(r['metrics'])}))\n"
    )
    env = {"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.splitlines() if x.startswith("{")]
    assert lines[0] == {"correct": True, "metrics": ["hashes_per_s", "request_p95_ms", "setup_s"]}
    assert lines[1]["correct"] and "lanes_per_request.hash" in lines[1]["metrics"]
    assert all(p.read_bytes() == b for p, b in before.items())


@pytest.mark.parametrize("argv", [["--workload", "mst.tree_build_d15", "--seed", "1", "--seconds", "1", "--trace", "0"]])
def test_without_a_card_or_a_program_no_result(argv, tmp_path):
    """Without a card the run exits non-zero and prints no result; so does
    a directory holding only BENCHMARK.json and the benchmark."""
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, "-m", "benchmark.run", *argv], cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    code = "from benchmark import run; import sys, time; b = run.manifest(); sys.exit(0 if run.run_cell(b, b['workloads'][0], 1, 0.01, False, 'cpu', t0=time.perf_counter()) is None else 1)"
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and "halo2_tpu_torch" in out.stderr
