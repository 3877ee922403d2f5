"""Binary hole filling (torch counterpart of kimimaro_tpu.ops.fill).

A "hole" is background not 6-connected (4-connected in 2D) to the volume
border; filling sets it to foreground. Implemented as a border-seeded
flood fill over the background (ops.geodesic), for one volume (`fill`)
or for the crops of many labels of one volume at once, lane-batched by
crop tier (`fill_label_crops`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from .geodesic import _flood6_stage, flood_fill
from .stencils import as_tensor


def fill(binimg: torch.Tensor, return_fill_count: bool = False,
         device="cuda"):
    """Fill interior holes of a 3D boolean volume; a 2D input is filled
    with its border on the 2D perimeter only. An array-like goes to
    `device`, a tensor stays on its own."""
    bin3 = as_tensor(binimg, device).to(torch.bool)
    squeeze_back = bin3.ndim == 2
    if squeeze_back:
        bin3 = bin3[..., None]
    if bin3.ndim != 3:
        raise ValueError("fill expects a 2D or 3D volume")

    bg = ~bin3
    border = torch.zeros(bin3.shape, dtype=torch.bool, device=bin3.device)
    for axis in ((0, 1) if squeeze_back else (0, 1, 2)):
        idx = [slice(None)] * 3
        idx[axis] = 0
        border[tuple(idx)] = True
        idx[axis] = bin3.shape[axis] - 1
        border[tuple(idx)] = True

    reached = flood_fill(border & bg, bg)
    filled = bin3 | ~reached
    if squeeze_back:
        filled = filled[..., 0]
    if return_fill_count:
        return filled, int(filled.sum()) - int(bin3.sum())
    return filled


def _fill_crops_stage(vol, offs, lids, crop: Tuple[int, int, int],
                      rounds: int):
    """Border-seeded hole masks for a batch of label crops.

    vol: (X, Y, Z) int volume on the device. offs (B, 3) int64 crop
    origins (pre-clamped), lids (B,) per-lane label id. Each lane cuts
    `crop` at its offset and fills holes of `crop == lid`. Embedding a
    tight bbox in a larger crop is exact: padding voxels are background,
    connected to the crop border. Returns (holes (B,)+crop bool, n (B,)
    int64, conv (B,) bool)."""
    dev = vol.device
    ar = [torch.arange(c, device=dev) for c in crop]
    xi = (offs[:, 0, None] + ar[0]).view(-1, crop[0], 1, 1)
    yi = (offs[:, 1, None] + ar[1]).view(-1, 1, crop[1], 1)
    zi = (offs[:, 2, None] + ar[2]).view(-1, 1, 1, crop[2])
    ok = vol[xi, yi, zi] != lids.view(-1, 1, 1, 1).to(vol.dtype)
    face = torch.zeros(crop, dtype=torch.bool, device=dev)
    for axis in range(3):
        face.narrow(axis, 0, 1).fill_(True)
        face.narrow(axis, crop[axis] - 1, 1).fill_(True)
    reached, conv = _flood6_stage(ok, face.expand_as(ok), rounds)
    holes = ok & ~reached
    return holes, holes.flatten(1).sum(dim=1), conv


# crop tiers for the batched fills; clamped per-axis to the volume
_FILL_CROP_MENU = (16, 32, 64, 128, 256, 512, 1024)


def fill_label_crops(
    vol_dev: torch.Tensor,
    offsets: np.ndarray,
    shapes: np.ndarray,
    lids: np.ndarray,
    vol_shape: Tuple[int, int, int],
    budget_bytes: int = 768 << 20,
) -> List[Tuple[Optional[np.ndarray], int]]:
    """Hole masks for many labels of one volume, batched by crop tier.

    vol_dev: int volume on the device. offsets/shapes (N, 3): each label's
    TIGHT bbox origin and extent; lids (N,). Returns host results as a
    list of (holes_tight bool array of shape `shapes[i]`, n) aligned with
    the inputs; lanes with n == 0 return (None, 0) without fetching the
    mask.
    """
    n = len(lids)
    out: list = [(None, 0)] * n
    if n == 0:
        return out
    dev = vol_dev.device
    offsets = np.asarray(offsets, dtype=np.int64).reshape(n, 3)
    shapes = np.asarray(shapes, dtype=np.int64).reshape(n, 3)
    vol_shape = tuple(int(s) for s in vol_shape)

    # tier assignment: smallest menu crop (clamped) holding the bbox
    tiers = []
    for m in _FILL_CROP_MENU:
        c = tuple(min(m, s) for s in vol_shape)
        if not tiers or c != tiers[-1]:
            tiers.append(c)
    tier_of = np.full(n, len(tiers) - 1, dtype=np.int64)
    for t in range(len(tiers) - 1, -1, -1):
        fits = np.all(shapes <= np.asarray(tiers[t]), axis=1)
        tier_of[fits] = t

    for t, crop in enumerate(tiers):
        sel = np.flatnonzero(tier_of == t)
        if len(sel) == 0:
            continue
        # clamped crop origins (bbox stays inside: crop >= shape)
        offs_t = np.minimum(
            offsets[sel], np.asarray(vol_shape) - np.asarray(crop))
        offs_t = np.maximum(offs_t, 0)
        lids_t = np.asarray(lids)[sel].astype(np.int64)
        vox = int(np.prod(crop))
        chunk = int(min(512, max(1, budget_bytes // max(16 * vox, 1))))
        for i in range(0, len(sel), chunk):
            idx = sel[i: i + chunk]
            o = torch.as_tensor(offs_t[i: i + chunk], device=dev)
            lab = torch.as_tensor(lids_t[i: i + chunk], device=dev)
            # escalation ladder: most holes close in a few rounds; rerun
            # the stage (from scratch) at a deeper budget while any lane's
            # flood has not stalled
            for rounds in (6, 24, 96, max(int(sum(crop)) + 8, 384)):
                holes, cnt, conv = _fill_crops_stage(
                    vol_dev, o, lab, crop, rounds)
                if bool(conv.all()):
                    break
            cnt_h = cnt.cpu().numpy()
            nz = np.flatnonzero(cnt_h > 0)
            if len(nz) == 0:
                continue
            holes_h = holes[torch.as_tensor(nz, device=dev)].cpu().numpy()
            for k, j in enumerate(nz):
                gi = int(idx[j])
                sh = shapes[gi]
                rel = offsets[gi] - offs_t[i + j]
                out[gi] = (
                    holes_h[k][rel[0]: rel[0] + sh[0],
                               rel[1]: rel[1] + sh[1],
                               rel[2]: rel[2] + sh[2]],
                    int(cnt_h[j]),
                )
    return out
