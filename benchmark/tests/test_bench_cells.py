"""Every cell at a small size through the harness's whole run but its look
for a card, on the port's plain CPU paths: the reference agrees with the
program, and ``correct`` comes out false for the control (inputs held to
240 bits) and for each fault the cell can have, planted under the
program's entry: an answer returned unchanged, half the batch left out,
one answer altered where it is produced."""

import time

import pytest
import torch

from benchmark import run

BENCH = run.manifest()
SMALL = {
    "mst.tree_build_d15": ({}, {"batches": [4, 2, 1]}),
    "k20.intt_b16": ({"k": 4}, {"columns": 4}),
}


def _run(name, tmp_path, device="cpu", **kw):
    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    config = {**run.load_json("configs", cell["config"]), **SMALL[name][0]}
    traffic = {**run.load_json("workloads", cell["traffic"]), **SMALL[name][1]}
    return run.run_cell(BENCH, cell, (1 << 31) + 77, 0.01, False, device, config=config, traffic=traffic,
                        cache_dir=tmp_path, t0=time.perf_counter(), **kw)[0]


def _unchanged(entry_name):
    return {
        "hash_device": lambda f: (lambda msgs: msgs[0].clone()),
        "lagrange_to_coeff": lambda f: (lambda x: x.clone()),
    }[entry_name]


def _half(entry_name):
    def hash_half(f):
        def g(msgs):
            b = msgs.shape[-1]
            out = torch.zeros((16, b), dtype=torch.int32, device=msgs.device)
            out[:, : (b + 1) // 2] = f(msgs[..., : (b + 1) // 2].contiguous())
            return out
        return g

    def ntt_half(f):
        def g(x):
            out = torch.zeros_like(x)
            out[: x.shape[0] // 2] = f(x[: x.shape[0] // 2].contiguous())
            return out
        return g

    return {"hash_device": hash_half, "lagrange_to_coeff": ntt_half}[entry_name]


def _altered(entry_name):
    def flip(f):
        def g(x):
            out = f(x).clone()
            out.view(-1)[0] ^= 1
            return out
        return g

    return {"hash_device": flip, "lagrange_to_coeff": flip}[entry_name]


def _entry(name):
    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    return run.load_json("workloads", cell["traffic"])["entry"]


@pytest.mark.parametrize("name", list(SMALL))
def test_cell_is_correct_and_reports_its_metrics(name, tmp_path):
    res = _run(name, tmp_path)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] >= 1
    want = {m["name"] for m in run.cell_metrics(BENCH, name, "end_to_end")}
    assert set(res["metrics"]) == want
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("name", list(SMALL))
def test_control_is_not_correct(name, tmp_path):
    res = _run(name, tmp_path, control=True)
    assert not res["correct"], res["checks"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", list(SMALL))
def test_fault_is_not_correct(name, fault, tmp_path):
    wrap = {"unchanged": _unchanged, "half": _half, "altered": _altered}[fault](_entry(name))
    res = _run(name, tmp_path, wrap_entry=wrap)
    assert not res["correct"], res["checks"]
    assert res["failed"] >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(SMALL))
def test_cell_and_control_on_the_card(name, tmp_path, card):
    assert _run(name, tmp_path, device=card)["correct"]
    assert not _run(name, tmp_path, device=card, control=True)["correct"]


@pytest.mark.parametrize("name", list(SMALL))
def test_traced_run_reads_its_per_layer_metrics(name, tmp_path):
    """On the CPU no device operation is traced: the device metrics read
    an idle device, and the kernels' rooflines find nothing to read.  The
    host's clock is read in the untraced window alone, before the traced
    one."""
    cell = next(w for w in BENCH["workloads"] if w["name"] == name)
    config = {**run.load_json("configs", cell["config"]), **SMALL[name][0]}
    traffic = {**run.load_json("workloads", cell["traffic"]), **SMALL[name][1]}
    res, info = run.run_cell(BENCH, cell, 5, 0.01, True, "cpu", config=config, traffic=traffic, cache_dir=tmp_path,
                             t0=time.perf_counter())
    assert res["correct"]
    names = {m["name"] for m in run.cell_metrics(BENCH, name, "per_layer")}
    assert set(res["metrics"]) <= names
    assert not any(k.endswith("_roofline") for k in res["metrics"])
    assert info.trace["window_s"] > 0 and info.trace["busy_s"] == 0
    assert res["attempted"] > len(info.latencies_s) >= 1
    host = [m["name"] for m in run.cell_metrics(BENCH, name, "per_layer") if m["source"] == "host_clock"]
    assert set(host) <= set(res["metrics"])
