"""``poseidon.primitives.hash_device``: a request is one call a batch of the
traffic's ``batches`` (node messages of the configuration's words), issued
back to back, then one synchronise."""

from __future__ import annotations

import torch

from ..fields import FR, R, clear_low_limb, ints_to_limbs, mont_mul, random_elements


def _messages(config: dict, lanes: int, gen, device) -> torch.Tensor:
    """(L, 16, lanes) Montgomery words: ``hash`` words uniform in Fr,
    ``balance`` words below 2^balance_bits."""
    words = []
    r2 = torch.from_numpy(ints_to_limbs([R * R % FR])).to(device)
    for kind in config["node_words"]:
        if kind == "hash":
            words.append(random_elements((), lanes, gen, device))
        elif kind == "balance":
            bits = config["balance_bits"]
            raw = torch.randint(0, 1 << 16, (16, lanes), generator=gen, device=device, dtype=torch.int32)
            raw[bits // 16 :] = 0
            words.append(mont_mul(raw, r2))  # b -> b R mod p
        else:
            raise ValueError(f"unknown node word {kind!r}")
    return torch.stack(words)


def setup(config, traffic, seed, device, rounded=False, cache_dir=None) -> dict:
    from halo2_tpu_torch.field.device import get_device_field
    from halo2_tpu_torch.field.params import SPECS
    from halo2_tpu_torch.poseidon.primitives import MySpec, hash_device

    spec = MySpec(config["width"], config["rate"])
    if (spec.full_rounds(), spec.partial_rounds()) != (config["full_rounds"], config["partial_rounds"]):
        raise ValueError("the program's MySpec has other round counts than the configuration")
    df, L = get_device_field(SPECS[config["field"]]), len(config["node_words"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    batches = traffic["batches"]
    pool = [[_messages(config, b, gen, device) for b in batches] for _ in range(traffic["pool"])]
    return {
        "entry": lambda msgs: hash_device(df, spec, L, msgs),
        "device": device,
        "pool": pool,
        "fed": [[clear_low_limb(m) for m in req] for req in pool] if rounded else pool,
        "work": {"hashes": sum(batches)},
        "calls": [{"lanes": b} for b in batches],
    }


def request(state, i):
    return [state["entry"](m) for m in state["fed"][i % len(state["fed"])]]


def finish(state, handle):
    if torch.device(state["device"]).type == "cuda":
        torch.cuda.synchronize(state["device"])
    return handle


def inputs(state, i):
    return state["pool"][i % len(state["pool"])]


def release(state) -> None:
    state.pop("entry", None)
