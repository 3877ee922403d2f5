"""An anisotropic Voronoi partition of the chunk: `labels` seeds (integer
voxel positions drawn from `seed`), each voxel labelled by its nearest seed
in physical units (`scale`), ties to the lower seed index. The squared
distances are integers below 2^53, so float64 holds them exactly and the
result is the same on every device."""

from __future__ import annotations

import torch

from gen import generator

# the search goes tile by tile: a tile of voxels needs only the seeds that
# could be nearest to some voxel in it (those no farther from the tile
# than the least, over all seeds, of a seed's farthest distance to the
# tile); TILES_AT_ONCE tiles are searched together
TILE = (16, 16, 8)
TILES_AT_ONCE = 512


def apply(vol, graph, p, shape, device):
    return voronoi(shape, int(p["labels"]), p["scale"], int(p["seed"]),
                   device), graph


def voronoi(shape, n_labels: int, scale, seed: int, device) -> torch.Tensor:
    """int32 labels 1..n_labels of the nearest seed point."""
    g = generator(device, seed)
    shape = [int(x) for x in shape]
    pts = torch.stack([torch.randint(0, s, (n_labels,), generator=g,
                                     device=device) for s in shape], dim=1)
    f64 = torch.float64
    w = torch.tensor([float(c) for c in scale], dtype=f64, device=device)
    sp = pts.to(f64)
    # ties to the lower index: each distance takes its seed's index in
    # the bits below the smallest step between two squared distances
    # (all squared distances are integers, so a step is at least 1)
    rank = torch.arange(n_labels, dtype=f64, device=device) \
        / float(1 << (int(n_labels).bit_length()))
    nt = [-(-s // t) for s, t in zip(shape, TILE)]
    tiles = torch.stack(torch.meshgrid(
        *[torch.arange(n, device=device) for n in nt], indexing="ij"),
        dim=-1).reshape(-1, 3) * torch.tensor(TILE, device=device)
    offs = torch.stack(torch.meshgrid(
        *[torch.arange(t, device=device) for t in TILE], indexing="ij"),
        dim=-1).reshape(-1, 3)
    out = torch.empty((tiles.shape[0], offs.shape[0]), dtype=torch.int32,
                      device=device)
    top = torch.tensor(TILE, device=device, dtype=f64) - 1
    for c0 in range(0, tiles.shape[0], TILES_AT_ONCE):
        lo = tiles[c0:c0 + TILES_AT_ONCE].to(f64)           # (C, 3)
        hi = lo + top
        near = torch.clamp(torch.maximum(lo[:, None] - sp[None],
                                         sp[None] - hi[:, None]), min=0)
        far = torch.maximum((sp[None] - lo[:, None]).abs(),
                            (sp[None] - hi[:, None]).abs())
        near2 = ((near * w) ** 2).sum(-1)                    # (C, L)
        tau = ((far * w) ** 2).sum(-1).min(dim=1).values
        cand = near2 <= tau[:, None]
        k = int(cand.sum(dim=1).max())
        idx = torch.where(cand, near2, torch.inf).topk(
            k, dim=1, largest=False).indices                 # (C, K)
        ok = cand.gather(1, idx)
        vox = (lo[:, None] + offs[None].to(f64)) * w         # (C, V, 3)
        cs = sp[idx] * w                                     # (C, K, 3)
        d2 = rank[idx][:, None, :].expand(-1, vox.shape[1], -1).clone()
        for a in range(3):
            d2 += (vox[:, :, None, a] - cs[:, None, :, a]) ** 2
        d2.masked_fill_(~ok[:, None, :], torch.inf)
        out[c0:c0 + TILES_AT_ONCE] = (idx.gather(1, d2.argmin(dim=2))
                                      + 1).to(torch.int32)
    vol = out.reshape(*nt, *TILE).permute(0, 3, 1, 4, 2, 5).reshape(
        *[n * t for n, t in zip(nt, TILE)])
    return vol[:shape[0], :shape[1], :shape[2]].contiguous()
