"""Device resolution shared by the port's entry points."""
from __future__ import annotations

import torch


def resolve(device="cuda") -> torch.device:
    """``torch.device(device)``; raises if it names CUDA and there is no
    CUDA device (the entry points never fall back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return device
