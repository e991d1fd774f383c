"""The device an entry point runs on when its caller names none."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a torch device; None means the CUDA device.  Without a
    card, None raises: the CPU runs only when the caller asks for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def card_info() -> dict:
    """The CUDA card's name and power limit as nvidia-smi reports them (None
    when there is no card), for printing beside a measurement."""
    if not torch.cuda.is_available():
        return {"gpu": None, "power_limit": None}
    import subprocess

    line = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    name, _, limit = line.rpartition(",")
    return {"gpu": name.strip(), "power_limit": limit.strip()}
