"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (``halo2_tpu_torch``).  The
harness is driven by data: the cell names a configuration
(``configs/<config>.json``) and a traffic mix (``workloads/<traffic>.json``);
the traffic names its entry, whose driver (``drivers/<entry>.py``) makes the
inputs from the seed and calls the program, and whose reference
(``reference/<entry>.py``) judges a seeded sample of the answers once the
window has closed; each metric is read by ``metrics/<name>.py`` (or, for a
name with a dot, ``metrics/<part before the dot>.py``).

A run: set-up (the kernel build on a checkout's first run, the driver's
inputs and program objects, one warm request), then a closed loop of
requests from one client for ``--seconds``: the next request is issued when
the previous one has finished, and each ends in a synchronise or a read of
its result.  With ``--trace 0`` the line carries the end-to-end metrics.
With ``--trace 1`` a second window of the same loop follows the first under
``torch.profiler``, and the line carries the per-layer metrics: those of
the host's clock from the first window, which no profiler slows, and
those of the device trace from the second.  ``--control 1`` feeds the
program inputs held to their top 240 bits while the reference judges
against the exact inputs: the comparison's control, which must come out
not correct.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from contextlib import nullcontext  # noqa: E402
from pathlib import Path  # noqa: E402

from .trace import summarize  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = HERE / "_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "halo2_tpu")
# a traced run profiles at most this many seconds, after its window
TRACE_SECONDS = 10
# the port's own launch counters, read before and after the window
COUNTERS = (
    "halo2_tpu_torch.field.cuda_mul",
    "halo2_tpu_torch.field.cuda_ops",
    "halo2_tpu_torch.poly.cuda_ntt",
    "halo2_tpu_torch.ec.cuda_jac",
    "halo2_tpu_torch.poseidon.cuda_sponge",
    "halo2_tpu_torch.plonkish.cuda_vm",
)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    return json.loads((HERE / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str) -> types.ModuleType:
    """``<kind>/<name>.py``, or for a metric ``metrics/<family>.py`` where
    the name is ``<family>.<part>`` and no file of the whole name exists."""
    path = HERE / kind / f"{name}.py"
    if not path.exists() and kind == "metrics" and "." in name:
        path = HERE / kind / f"{name.split('.')[0]}.py"
    modname = f"benchmark.{kind}.{path.stem.replace('.', '_').replace('-', '_')}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {kind} file for {name!r} under {HERE / kind}")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_metrics(bench: dict, cell: str, kind: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports."""
    return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def _launches() -> dict:
    out = {}
    for name in COUNTERS:
        mod = sys.modules.get(name)
        if mod is not None:
            out.update(getattr(mod, "LAUNCHES", {}))
    return out


def _sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(
    bench: dict,
    cell: dict,
    seed: int,
    seconds: float,
    trace: bool,
    device,
    *,
    control: bool = False,
    wrap_entry=None,
    config: dict | None = None,
    traffic: dict | None = None,
    cache_dir: Path = CACHE,
    t0: float | None = None,
) -> dict:
    """One run of ``cell`` on ``device``: set-up, the window, the metrics,
    then the reference's checks.  ``config``/``traffic`` replace the files'
    (tests run at small sizes); ``wrap_entry`` wraps the program's entry
    (tests plant faults under it).  Returns the result line's object but
    its ``device``, and the run's peak memory, trace summary, launch counts
    and request latencies."""
    import torch

    t0 = _T0 if t0 is None else t0
    config = config or load_json("configs", cell["config"])
    traffic = traffic or load_json("workloads", cell["traffic"])
    driver = load_module("drivers", traffic["entry"])
    t_in = time.perf_counter()
    state = driver.setup(config, traffic, seed, device, rounded=control, cache_dir=Path(cache_dir))
    if wrap_entry is not None:
        state["entry"] = wrap_entry(state["entry"])
    _sync(device)
    t_warm = time.perf_counter()
    driver.finish(state, driver.request(state, 0))  # the warm request: every shape of the traffic
    _sync(device)
    print(
        f"set-up: {t_in - t0:.3f} s to the driver, {t_warm - t_in:.3f} s inputs and program objects, "
        f"{time.perf_counter() - t_warm:.3f} s the warm request",
        file=sys.stderr,
    )

    keep = traffic["check"]["requests"]
    rng = random.Random(seed)
    kept: list = []
    latencies, dispatch = [], []

    def loop(i, w0, until, span):
        """Requests from i on until one ends ``until`` seconds or more after
        w0; returns the next request's index and that end."""
        while True:
            with span("bench.request"):
                a = time.perf_counter()
                with span("bench.dispatch"):
                    handle = driver.request(state, i)
                b = time.perf_counter()
                with span("bench.wait"):
                    answer = driver.finish(state, handle)
                c = time.perf_counter()
            latencies.append(c - a)
            dispatch.append(b - a)
            if len(kept) < keep:  # a seeded uniform sample of the run's requests
                kept.append((i, answer))
            else:
                j = rng.randrange(i + 1)
                if j < keep:
                    kept[j] = (i, answer)
            del handle, answer
            i += 1
            if c - w0 >= until:
                return i, c

    before = _launches()
    w0 = time.perf_counter()
    requests, c = loop(0, w0, seconds, nullcontext)
    setup_s = w0 - t0
    window_s = c - w0
    after = _launches()
    trace_summary, attempted = None, requests
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.device(device).type == "cuda" else [])
        with profile(activities=activities) as prof:
            with record_function("bench.window"):
                attempted, _ = loop(requests, time.perf_counter(), min(seconds, TRACE_SECONDS), record_function)
        trace_summary = summarize(prof)
        del prof
    peak = torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0

    ctx = types.SimpleNamespace(
        cell=cell, config=config, traffic=traffic, seed=seed, device=device, driver=driver, state=state,
        setup_s=setup_s, window_s=window_s, requests=requests,
        latencies_s=latencies[:requests], dispatch_s=dispatch[:requests],
        work={k: v * requests for k, v in state["work"].items()},
        trace=trace_summary, trace_requests=attempted - requests,
        launches={k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)},
    )
    metrics = {}
    for m in cell_metrics(bench, cell["name"], "per_layer" if trace else "end_to_end"):
        ctx.metric = m
        value = load_module("metrics", m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    samples = [(driver.inputs(state, i), answer) for i, answer in sorted(kept, key=lambda t: t[0])]
    driver.release(state)
    del kept
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    checks, per_request = load_module("reference", traffic["entry"]).check(config, traffic, samples, seed)
    line = {
        "correct": all(c["value"] <= c["limit"] for c in checks.values()),
        "attempted": attempted,
        "failed": sum(1 for ok in per_request if not ok),
        "metrics": metrics,
        "checks": checks,
    }
    return line, types.SimpleNamespace(peak=peak, trace=trace_summary, launches=ctx.launches, latencies_s=ctx.latencies_s)


def main(argv=None) -> int:
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(
            f"{args.workload} needs {cell['chips']} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
            file=sys.stderr,
        )
        return 2
    device = torch.device("cuda", 0)
    line, info = run_cell(bench, cell, args.seed, args.seconds, bool(args.trace), device, control=bool(args.control))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"the run loaded {', '.join(found)}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    checks = line.pop("checks")
    line["device"] = {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(device),
        "count": cell["chips"],
        "memory_peak_bytes": info.peak,
    }
    if info.trace is not None:
        line["device"].update(busy_s=info.trace["busy_s"], window_s=info.trace["window_s"])
        line["breakdown"] = {"device_ops": info.trace["device_ops"], "idle_gaps": info.trace["idle_gaps"]}
    line["checks"] = checks  # the compared numbers come last
    lat = info.latencies_s
    ends = [sum(lat[: k + 1]) for k in range(len(lat))]
    tenths = [sum(1 for e in ends if t * ends[-1] / 10 < e <= (t + 1) * ends[-1] / 10) for t in range(10)]
    lat = sorted(lat)
    print(f"launches in the window (the port's counters): {json.dumps(info.launches, sort_keys=True)}", file=sys.stderr)
    print(
        f"requests: {len(lat)}; ms min {lat[0] * 1e3:.3f}, median {lat[len(lat) // 2] * 1e3:.3f}, "
        f"max {lat[-1] * 1e3:.3f}; requests ending in each tenth of their summed time: {tenths}",
        file=sys.stderr,
    )
    for name, c in checks.items():
        print(f"check {name} = {c['value']} (limit {c['limit']}, of {c['of']})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
