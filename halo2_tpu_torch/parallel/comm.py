"""The collectives of the sharded prover, over one axis of a mesh.

Each replaces a ``shard_map`` collective of the reference
(``halo2_tpu/parallel``) and runs on the axis's process group
(``mesh.get_group(axis)``), whose rank i is coordinate i along the axis:

  * :func:`all_to_all`: ``jax.lax.all_to_all`` (the four-step NTT's
    transpose), through ``all_to_all_single``;
  * :func:`all_gather`: ``jax.lax.all_gather`` (scan totals, row-sharded
    outputs made whole), through ``all_gather``;
  * :func:`exchange`: one ``jax.lax.ppermute`` pair (the MSM butterfly),
    through ``batch_isend_irecv``.

The transport follows the group's backend, never a failure: under NCCL a
CUDA tensor goes through the collective directly; under gloo a CUDA tensor
is copied to host memory, exchanged and copied back (two ranks on one card
cannot share an NCCL communicator), and a CPU tensor is exchanged as it is.
Any other pairing raises.  Each collective prints its transport the first
time it is used on an axis, and :data:`TRANSPORTS` keeps them.  Nothing here
catches a collective's error.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

# (collective, axis) -> the transport it used, as printed at first use
TRANSPORTS: dict = {}


def _route(op: str, mesh, axis: str, x: torch.Tensor):
    """(process group, staged through host memory?) for ``op`` on ``x``."""
    group = mesh.get_group(axis)
    backend = str(dist.get_backend(group))
    if x.dtype != torch.int32:
        raise TypeError(f"{op}: int32 limb tensors only, got {x.dtype}")
    if backend == "nccl" and x.device.type == "cuda":
        staged, how = False, "nccl, CUDA tensors direct"
    elif backend == "gloo" and x.device.type == "cuda":
        staged, how = True, "gloo, CUDA tensors staged through host memory"
    elif backend == "gloo" and x.device.type == "cpu":
        staged, how = False, "gloo, CPU tensors direct"
    else:
        raise ValueError(f"{op}: backend {backend} cannot exchange {x.device.type} tensors")
    if (op, axis) not in TRANSPORTS:
        TRANSPORTS[(op, axis)] = how
        print(f"[comm] rank {dist.get_rank()}: {op} over {axis}: {how}", flush=True)
    return group, staged


def all_to_all(mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Block i of ``x`` (its dim 0, one block a rank of the axis) goes to
    rank i; returns the blocks received, block j from rank j."""
    group, staged = _route("all_to_all", mesh, axis, x)
    src = x.contiguous().cpu() if staged else x.contiguous()
    out = torch.empty_like(src)
    dist.all_to_all_single(out, src, group=group)
    return out.to(x.device) if staged else out


def all_gather(mesh, axis: str, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked along a new dim 0, in axis order."""
    group, staged = _route("all_gather", mesh, axis, x)
    src = x.contiguous().cpu() if staged else x.contiguous()
    out = src.new_empty((dist.get_world_size(group), *src.shape))
    dist.all_gather(list(out.unbind(0)), src, group=group)
    return out.to(x.device) if staged else out


def exchange(mesh, axis: str, x: torch.Tensor, peer: int) -> torch.Tensor:
    """Send ``x`` to the rank at coordinate ``peer`` of the axis and return
    what that rank sends here (same shape)."""
    group, staged = _route("exchange", mesh, axis, x)
    src = x.contiguous().cpu() if staged else x.contiguous()
    out = torch.empty_like(src)
    other = dist.get_global_rank(group, peer)
    ops = [dist.P2POp(dist.isend, src, other, group), dist.P2POp(dist.irecv, out, other, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out
