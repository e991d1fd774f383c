"""Judges ``hash_device``'s digests: for each sampled request, a seeded
sample of each call's lanes is hashed again by the plain Poseidon sponge
(``_poseidon.py``, Python ints) from the exact input words, and its digest,
in Montgomery form, must equal the program's limb for limb; every digest
of a sampled request must be canonical."""

from __future__ import annotations

import random

import torch

from ..fields import FR, count_noncanonical, from_mont, limbs_to_ints, to_mont
from ._poseidon import hash_constant_length


def check(config, traffic, samples, seed):
    rng = random.Random(seed ^ 0x5EED)
    per_lane = traffic["check"]["lanes"]
    wrong = checked = noncanon = total = 0
    per_request = []
    for msgs_list, digests_list in samples:
        bad = 0
        for msgs, digests in zip(msgs_list, digests_list):
            lanes = msgs.shape[-1]
            idx = sorted(rng.sample(range(lanes), min(per_lane, lanes)))
            sel = torch.tensor(idx, device=msgs.device)
            words = [limbs_to_ints(w) for w in msgs.index_select(-1, sel)]
            got = limbs_to_ints(digests.index_select(-1, sel.to(digests.device)))
            for k in range(len(idx)):
                message = [from_mont(w[k]) for w in words]
                want = to_mont(hash_constant_length(message, FR, config["width"], config["rate"],
                                                    config["full_rounds"], config["partial_rounds"]))
                wrong += got[k] != want
                bad += got[k] != want
            nc = count_noncanonical(digests)
            noncanon += nc
            bad += nc
            checked += len(idx)
            total += lanes
        per_request.append(bad == 0)
    return {
        "wrong_digests": {"value": int(wrong), "limit": 0, "of": checked},
        "noncanonical_digests": {"value": noncanon, "limit": 0, "of": total},
    }, per_request
