"""bench.py's `synthetic_volume_neurite` morphology, made on the device:
`tubes` persistent random walks (lengths drawn from `length`, turning by
`turn` a step, one physical step of 2 voxel widths along x), each stamped
as a tube of a radius drawn from `radius` voxels (z squashed by the
anisotropy `scale`), with up to `branches` - 1 side walks of lengths drawn
from `branch_length` leaving it at a random point, and with probability
`soma_share` a ball of a radius drawn from `soma_radius`. Tubes are
stamped first-writer-wins in their order (a voxel keeps the lowest tube
label over it), so a crossing can split a later tube into components:
winding, branched labels at the fixture's component density, where the
Voronoi cells are convex. Everything is drawn from `seed`."""

from __future__ import annotations

import torch

from gen import generator

# points a stamping call expands into their balls at once
POINTS_AT_ONCE = 1 << 16


def apply(vol, graph, p, shape, device):
    return neurite(shape, p, device), graph


def _walks(g, starts, dirs, steps, step, top, turn):
    """(B, steps, 3) float32 centrelines of persistent random walks,
    advanced in lock-step."""
    pts = torch.empty((starts.shape[0], steps, 3), dtype=torch.float32,
                      device=starts.device)
    pos = starts.to(torch.float32).clone()
    d = dirs / dirs.norm(dim=1, keepdim=True).clamp_min(1e-6)
    for i in range(steps):
        pts[:, i] = pos
        d = d + torch.randn(d.shape, generator=g, device=d.device) * turn
        d = d / d.norm(dim=1, keepdim=True).clamp_min(1e-6)
        pos = torch.minimum(torch.clamp(pos + d * step, min=0), top)
    return pts


def _ball(r, squash, device):
    """Integer offsets of a ball of radius r voxels, z squashed."""
    w = torch.arange(-r, r + 1, device=device)
    ox, oy, oz = torch.meshgrid(w, w, w, indexing="ij")
    keep = ox ** 2 + oy ** 2 + (oz * squash) ** 2 <= r ** 2
    return torch.stack([ox[keep], oy[keep], oz[keep]], dim=1)


def _stamp(vol, centres, labels, r, squash):
    """vol = min(vol, label) over the ball of radius r at each centre."""
    offs = _ball(r, squash, vol.device)
    shape = torch.tensor(vol.shape, device=vol.device)
    flat = vol.view(-1)
    for k in range(0, centres.shape[0], POINTS_AT_ONCE):
        c = centres[k:k + POINTS_AT_ONCE].long()
        vox = torch.minimum((c[:, None] + offs[None]).clamp_min(0),
                            shape - 1).reshape(-1, 3)
        idx = (vox[:, 0] * vol.shape[1] + vox[:, 1]) * vol.shape[2] \
            + vox[:, 2]
        lab = labels[k:k + POINTS_AT_ONCE, None].expand(-1, offs.shape[0])
        flat.scatter_reduce_(0, idx, lab.reshape(-1).to(vol.dtype),
                             reduce="amin")


def neurite(shape, p, device) -> torch.Tensor:
    g = generator(device, int(p["seed"]))
    n_t = int(p["tubes"])
    scale = torch.tensor([float(x) for x in p["scale"]], device=device)
    step = 2.0 / (scale / scale[0])
    squash = float(scale[2] / scale[0])
    top = torch.tensor([float(s - 1) for s in shape], device=device)
    turn = float(p["turn"])

    def ints(lo_hi, n):
        return torch.randint(int(lo_hi[0]), int(lo_hi[1]), (n,), generator=g,
                             device=device)

    def uniform(lo_hi, n):
        lo, hi = float(lo_hi[0]), float(lo_hi[1])
        return lo + (hi - lo) * torch.rand(n, generator=g, device=device)

    lengths = ints(p["length"], n_t)
    starts = torch.stack([ints((0, s), n_t) for s in shape], dim=1)
    dirs = torch.randn((n_t, 3), generator=g, device=device)
    radii = torch.round(uniform(p["radius"], n_t)).long()
    n_br = ints(p["branches"], n_t)
    soma = torch.rand(n_t, generator=g, device=device) < float(
        p["soma_share"])
    soma_r = torch.round(uniform(p["soma_radius"], n_t)).long()

    trunk = _walks(g, starts, dirs, int(lengths.max()), step, top, turn)
    tube = torch.arange(n_t, device=device)
    on_trunk = torch.arange(trunk.shape[1], device=device)[None] \
        < lengths[:, None]
    # side walks: tube t has n_br[t] of them, from a random trunk point
    owner = torch.repeat_interleave(tube, n_br)
    at = (torch.rand(owner.shape[0], generator=g, device=device)
          * lengths[owner]).long()
    b_len = ints(p["branch_length"], owner.shape[0])
    b_steps = int(b_len.max()) if owner.numel() else 0
    side = _walks(g, trunk[owner, at], torch.randn(
        (owner.shape[0], 3), generator=g, device=device), b_steps, step,
        top, turn)
    on_side = torch.arange(b_steps, device=device)[None] < b_len[:, None]

    centres = torch.cat([trunk[on_trunk], side[on_side]])
    who = torch.cat([tube[:, None].expand_as(on_trunk)[on_trunk],
                     owner[:, None].expand_as(on_side)[on_side]])
    big = torch.iinfo(torch.int32).max
    vol = torch.full([int(s) for s in shape], big, dtype=torch.int32,
                     device=device)
    for r in torch.unique(radii).tolist():
        mine = radii[who] == r
        _stamp(vol, centres[mine], who[mine] + 1, int(r), squash)
    # a soma ball at a random trunk point of the tubes that have one
    s_at = (torch.rand(n_t, generator=g, device=device) * lengths).long()
    s_c = trunk[tube, s_at]
    for r in torch.unique(soma_r[soma]).tolist():
        mine = soma & (soma_r == r)
        _stamp(vol, s_c[mine], tube[mine] + 1, int(r), squash)
    vol[vol == big] = 0
    return vol
