"""The working device of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """The working device; asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev
