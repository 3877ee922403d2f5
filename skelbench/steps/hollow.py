"""bench.py's `synthetic_volume_hollow` carving of the labels: interior
holes in about `labels` labels, up to `pits` nested pit labels, and `balls`
soma-scale balls of radius `ball_radius` voxels in x and y (z squashed by
`ball_z_squash`); numpy RandomState(`seed`) decisions, the volume edited on
its device."""

from __future__ import annotations

import numpy as np
import torch


def apply(vol, graph, p, shape, device):
    return hollow(vol, p), graph


def _bboxes(vol: torch.Tensor, n: int):
    """Per label 1..n-1: (min corner, max corner + 1) as host int arrays,
    min > max where the label is absent (scipy's find_objects, on the
    device)."""
    flat = vol.reshape(-1).long()
    sx, sy, sz = vol.shape
    idx = torch.arange(flat.numel(), device=vol.device)
    coords = (idx // (sy * sz), (idx // sz) % sy, idx % sz)
    lo = torch.full((3, n), 1 << 30, dtype=torch.long, device=vol.device)
    hi = torch.full((3, n), -1, dtype=torch.long, device=vol.device)
    for a, c in enumerate(coords):
        lo[a].scatter_reduce_(0, flat, c, reduce="amin")
        hi[a].scatter_reduce_(0, flat, c, reduce="amax")
    return lo.T.cpu().numpy(), (hi + 1).T.cpu().numpy()


def hollow(vol: torch.Tensor, p: dict) -> torch.Tensor:
    """bench.py's hollow carving (numpy RandomState(`seed`) decisions, the
    volume edited on its device)."""
    vol = vol.clone()
    n = vol.shape[0]
    nxt = int(vol.max()) + 1
    lo, hi = _bboxes(vol, nxt)
    rng = np.random.RandomState(int(p["seed"]))
    lids = rng.choice(nxt - 1, size=min(int(p["labels"]), nxt - 1),
                      replace=False)
    n_pits = 0
    for k, li in enumerate(lids):
        lab = int(li) + 1
        ext = hi[lab] - lo[lab]
        if (hi[lab] <= lo[lab]).any() or (ext < 8).any():
            continue
        ctr = (lo[lab] + hi[lab]) // 2
        r = np.maximum(ext // 5, 2)
        sl = tuple(slice(int(c - rr), int(c + rr)) for c, rr in zip(ctr, r))
        region = vol[sl]
        mine = region == lab
        if k % 3 == 0 and n_pits < int(p["pits"]):
            region[mine] = nxt         # a nested pit label inside the host
            nxt += 1
            n_pits += 1
        else:
            region[mine] = 0           # an interior hole
    rs = min(int(p["ball_radius"]), max(4, n // 6))
    w = torch.arange(-rs, rs + 1, device=vol.device, dtype=torch.float64)
    ox, oy, oz = torch.meshgrid(w, w, w, indexing="ij")
    ball = ox ** 2 + oy ** 2 + (oz * float(p["ball_z_squash"])) ** 2 <= rs ** 2
    for _ in range(int(p["balls"])):
        c = rng.randint(rs + 2, n - rs - 2, size=3)
        sl = tuple(slice(int(cc - rs), int(cc + rs + 1)) for cc in c)
        vol[sl][ball] = nxt
        nxt += 1
    return vol
