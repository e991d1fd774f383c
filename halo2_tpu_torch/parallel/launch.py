"""Run a function on every rank of a new process group, one process a rank.

    results = spawn(fn, world_size, "gloo", "cpu", *args, dp=None)

starts ``world_size`` processes with ``torch.multiprocessing.spawn`` (CUDA
cannot be forked), which rendezvous through a ``file://`` store in a fresh
temporary directory (so runs side by side never contend for a port), build
the ``(dp, sp)`` mesh of :func:`.mesh.make_mesh`, call ``fn(mesh, *args)``
and hand each rank's result back to the caller, in rank order.  A rank that
raises makes :func:`spawn` raise.

``fn`` is pickled by its import path, so it must be a module-level function
that a fresh interpreter can import; the arguments and results are pickled
too.  On ``device="cuda"`` rank r computes on card r mod the visible count
(two ranks on one card share it); the CUDA kernels and the native host
engine are built here before any rank starts, since both are cached by a
hash of their sources and ranks building at once would race.  On the CPU
each rank runs one torch thread: the kernels' plain versions issue small
int64 ops that threads do not speed up, and W ranks would oversubscribe the
cores.
"""

from __future__ import annotations

import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import make_mesh


def _rank_main(rank, fn, world_size, backend, device_type, dp, tmp, args):
    if device_type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    init = "file://" + os.path.join(tmp, "rendezvous")
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world_size)
    mesh = make_mesh(world_size, dp, device_type=device_type)
    result = fn(mesh, *args)
    path = os.path.join(tmp, f"result_{rank}.pkl")
    with open(path + ".part", "wb") as f:
        pickle.dump(result, f)
    os.replace(path + ".part", path)
    dist.barrier()
    dist.destroy_process_group()


def default_backend(world_size: int, device_type: str) -> str:
    """``"nccl"`` when every rank can have a card of its own, ``"gloo"``
    otherwise (NCCL refuses two ranks on one card) and on the CPU; from the
    counts alone, never from a failed attempt."""
    if device_type == "cuda" and world_size <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def spawn(fn, world_size: int, backend: str, device, *args, dp: int | None = None) -> list:
    """``fn(mesh, *args)`` on ``world_size`` ranks of a ``backend`` process
    group (``"gloo"`` or ``"nccl"``) whose ranks compute on ``device``
    (``"cpu"`` or ``"cuda"``); returns the ranks' results in rank order."""
    device_type = torch.device(device).type
    if device_type not in ("cpu", "cuda"):
        raise ValueError(f"spawn: device must be 'cpu' or 'cuda', got {device!r}")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("spawn: no CUDA device")
        from .. import _build

        _build.build()
    from .. import native

    native.available()
    with tempfile.TemporaryDirectory(prefix="h2t_spawn_") as tmp:
        mp.spawn(
            _rank_main, args=(fn, world_size, backend, device_type, dp, tmp, args), nprocs=world_size, join=True
        )
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"result_{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
