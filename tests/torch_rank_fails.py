"""A rank function for the spawn fault test: ``spawn(fail_on_rank, W, ...,
rank)`` raises on rank ``rank`` only.  It lives apart from the test module
so that a spawned rank imports nothing but torch to unpickle it."""

import torch.distributed as dist


def fail_on_rank(mesh, rank):
    if dist.get_rank() == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    return None
