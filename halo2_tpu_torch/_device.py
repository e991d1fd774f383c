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
