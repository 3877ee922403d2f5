"""Binary hole filling (torch counterpart of kimimaro_tpu.ops.fill.fill).

A "hole" is background not 6-connected to the volume border; filling sets
it to foreground. Implemented as a border-seeded flood
fill over the background (ops.geodesic.flood_fill).
"""

from __future__ import annotations

import torch

from .geodesic import flood_fill


def fill(binimg: torch.Tensor, return_fill_count: bool = False):
    """Fill interior holes of a 3D boolean volume."""
    bin3 = binimg.to(torch.bool)
    if bin3.ndim != 3:
        raise ValueError("fill expects a 3D volume")

    bg = ~bin3
    border = torch.zeros(bin3.shape, dtype=torch.bool, device=bin3.device)
    for axis in range(3):
        idx = [slice(None)] * 3
        idx[axis] = 0
        border[tuple(idx)] = True
        idx[axis] = bin3.shape[axis] - 1
        border[tuple(idx)] = True

    reached = flood_fill(border & bg, bg)
    filled = bin3 | ~reached
    if return_fill_count:
        return filled, int(filled.sum()) - int(bin3.sum())
    return filled
