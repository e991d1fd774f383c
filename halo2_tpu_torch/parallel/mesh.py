"""The device mesh of the sharded prover (port of halo2_tpu/parallel/mesh.py).

The reference lays ``n`` devices out as a ``jax.sharding.Mesh`` of axes
``("dp", "sp")``, one controller over all of them.  The port runs one
process a rank (SPMD over ``torch.distributed``), and the mesh is a
:class:`torch.distributed.device_mesh.DeviceMesh` of shape ``(dp, sp)`` with
the reference's axis names over the default process group, which the caller
initializes (:func:`.launch.spawn`, ``torchrun``):

  * ``dp``: data parallel over MSM points;
  * ``sp``: "sequence" (row) parallel over circuit rows, NTT columns and
    the quotient's rows.

Collectives over an axis run on that axis's process group
(``mesh.get_group("sp")``), through :mod:`.comm`.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("dp", "sp")


def mesh_shape(n: int, dp: int | None = None) -> tuple[int, int]:
    """The reference's layout of n devices: ``dp`` = 2 when n is even and
    above 1, else 1 (unless given); ``sp`` = n / dp."""
    if n < 1:
        raise ValueError(f"a mesh needs at least one device, got {n}")
    if dp is None:
        dp = 2 if n % 2 == 0 and n > 1 else 1
    if dp < 1 or n % dp:
        raise ValueError(f"dp={dp} does not divide {n} devices")
    return dp, n // dp


def make_mesh(n_devices: int | None = None, dp: int | None = None, device_type: str | None = None) -> DeviceMesh:
    """A ``(dp, sp)`` DeviceMesh over every rank of the initialized default
    process group.  ``n_devices`` (default: the world size) must equal the
    world size; ``dp`` as :func:`mesh_shape`.  ``device_type`` is ``"cuda"``
    when the ranks hold the card (each has set its CUDA device), ``"cpu"``
    otherwise; None takes ``"cuda"`` where a card is visible.  Raises without
    an initialized process group."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; initialize torch.distributed first (parallel.launch.spawn, torchrun)")
    world = dist.get_world_size()
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"make_mesh: {n} devices, but the process group has {world} ranks")
    if device_type is None:
        device_type = "cuda" if torch.cuda.is_available() else "cpu"
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"make_mesh: device_type must be 'cuda' or 'cpu', got {device_type!r}")
    return init_device_mesh(device_type, mesh_shape(n, dp), mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's coordinate along ``axis``."""
    return mesh.get_local_rank(mesh.mesh_dim_names.index(axis))


def rank_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank computes on: its current CUDA device on a
    ``"cuda"`` mesh, the CPU on a ``"cpu"`` one."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
