"""``poly.domain.EvaluationDomain.lagrange_to_coeff``: a request is one
call on a (columns, 16, 2^k) batch of Lagrange values over the domain
``get_domain(field, k, degree)``, then one synchronise."""

from __future__ import annotations

import torch

from ..fields import clear_low_limb, random_elements


def setup(config, traffic, seed, device, rounded=False, cache_dir=None) -> dict:
    from halo2_tpu_torch.field.params import SPECS
    from halo2_tpu_torch.poly.domain import get_domain

    k, cols = config["k"], traffic["columns"]
    domain = get_domain(SPECS[config["field"]], k, config["degree"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    pool = [random_elements((cols,), 1 << k, gen, device) for _ in range(traffic["pool"])]
    return {
        "entry": domain.lagrange_to_coeff,
        "device": device,
        "pool": pool,
        "fed": [clear_low_limb(x) for x in pool] if rounded else pool,
        "work": {"butterflies": cols * (k << k) // 2, "columns": cols},
        "calls": [{"columns": cols, "n": 1 << k}],
    }


def request(state, i):
    return state["entry"](state["fed"][i % len(state["fed"])])


def finish(state, handle):
    if torch.device(state["device"]).type == "cuda":
        torch.cuda.synchronize(state["device"])
    return handle


def inputs(state, i):
    return state["pool"][i % len(state["pool"])]


def release(state) -> None:
    state.pop("entry", None)
