"""Shared stencil utilities for voxel-grid kernels (torch counterpart of
kimimaro_tpu.ops.stencils, without the voxel_graph bit helpers)."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def neighborhood_offsets() -> List[Tuple[int, int, int]]:
    """The 26 neighbour offsets in lexicographic order, the fixed order
    every tie-break uses."""
    return [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            if (dx, dy, dz) != (0, 0, 0)]


def pad_const(vol: torch.Tensor, width: int, fill) -> torch.Tensor:
    """`vol` padded by `width` on both sides of every axis with `fill`."""
    shape = tuple(s + 2 * width for s in vol.shape)
    out = torch.full(shape, fill, dtype=vol.dtype, device=vol.device)
    out[tuple(slice(width, width + s) for s in vol.shape)] = vol
    return out


def shifted(vol: torch.Tensor, offset: Sequence[int], fill) -> torch.Tensor:
    """out[v] = vol[v + offset], out-of-bounds filled with `fill`."""
    out = torch.full_like(vol, fill)
    src, dst = [], []
    for o, n in zip(offset, vol.shape):
        if abs(o) >= n:
            return out
        if o >= 0:
            src.append(slice(o, n))
            dst.append(slice(0, n - o))
        else:
            src.append(slice(0, n + o))
            dst.append(slice(-o, n))
    out[tuple(dst)] = vol[tuple(src)]
    return out
