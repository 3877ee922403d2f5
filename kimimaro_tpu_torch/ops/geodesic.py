"""Shortest-path fields on voxel grids by directional plane sweeps.

Torch counterpart of the parts of kimimaro_tpu.ops.geodesic that the host
trace path and the crop engine use. Distances are the fixpoint of
monotone relaxation: a round is six directional plane sweeps (+-x, +-y,
+-z; kernel B5 through `ops.sweep.sweep_axis0`, or B4 through
`ops.sweep.sweep_axis0_batched` for a batch of lanes), and rounds repeat
until one changes nothing, so the result is exactly the Dijkstra distance.

Two edge-cost modes:
  - euclidean: step cost = anisotropic length of the offset
  - node: cost of entering voxel v = node_cost[v]
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .fma import fma_f32
from .stencils import neighborhood_offsets, shifted
from .sweep import sweep_axis0, sweep_axis0_batched

INF = float("inf")

# the 26 offsets in deterministic lexicographic order; parent codes index
# into this list (sentinel 26 = "is a source / no parent")
OFFSETS26 = neighborhood_offsets()

_STAGE_ROUNDS = 6     # rounds per relaxation stage (plus one checking round)
_MAX_ROUNDS = 4096


def _off_cost(off, anisotropy) -> float:
    w = np.asarray(anisotropy, dtype=np.float64)
    return float(np.float32(np.sqrt(np.sum(
        (np.array(off, dtype=np.float64) * w) ** 2))))


class _SweptViews:
    """The static operands of a relax (the ok mask and the node costs)
    moved to axis 0 of each of the three sweep axes, built once per
    distance field and reused by every sweep of every stage; only the
    field itself moves per sweep."""

    __slots__ = ("ok", "nc")

    def __init__(self, ok, node_cost):
        self.ok = tuple(torch.movedim(ok, a, 0).contiguous()
                        for a in range(3))
        self.nc = (None if node_cost is None else
                   tuple(torch.movedim(node_cost, a, 0).contiguous()
                         for a in range(3)))


def _sweep(dist, views: _SweptViews, axis: int, direction: int, anisotropy,
           clamp_positive: bool):
    """One directional plane sweep along `axis` in `direction` (+1/-1)."""
    if dist.shape[axis] <= 1:
        return dist
    anis_perm = (float(anisotropy[axis]),) + tuple(
        float(anisotropy[i]) for i in range(3) if i != axis)
    d2 = torch.movedim(dist, axis, 0).contiguous()
    nc2 = None if views.nc is None else views.nc[axis]
    out = sweep_axis0(d2, views.ok[axis], nc2, anis_perm, nc2 is not None,
                      bool(clamp_positive), descending=direction < 0)
    return torch.movedim(out, 0, axis).contiguous()


def _lane_changed(nd, d, conv: str):
    """Per-lane change flags of a (B, ...) batch under `conv`."""
    if conv == "reach":
        diff = torch.isfinite(nd) != torch.isfinite(d)
    elif conv == "negative":
        diff = torch.where(nd <= 0, nd, INF) != torch.where(d <= 0, d, INF)
    else:
        diff = nd != d
    return diff.flatten(1).any(dim=1)


def _changed(nd, d, conv: str) -> bool:
    return bool(_lane_changed(nd[None], d[None], conv)[0])


def _relax_stage(d, views: _SweptViews, anisotropy, clamp_positive: bool,
                 rounds: int, conv: str = "exact"):
    """`rounds` full 6-sweep rounds plus one checking round. Returns
    (dist, converged): converged when the last round changed nothing
    under `conv`."""
    changed = True
    for _ in range(int(rounds) + 1):
        nd = d
        for axis in range(3):
            for direction in (1, -1):
                nd = _sweep(nd, views, axis, direction, anisotropy,
                            clamp_positive)
        changed = _changed(nd, d, conv)
        d = nd
    return d, not changed


def relax_rounds_batched(d, ok, nc, anisotropy, rounds: int,
                         clamp_positive: bool = False, conv: str = "exact"):
    """`rounds` full 6-sweep rounds plus one checking round over a batch
    of (B, X, Y, Z) lanes (counterpart of geodesic.relax_rounds_batchable
    under vmap). Returns (d, converged): converged[b] when lane b's last
    round changed nothing under `conv` ("exact", "reach" or "negative").

    Axes 1 and 2 are swept through permuted contiguous copies (ok and nc
    are permuted once per call, d twice per axis and round). The loop
    stops early after a round that changed no value of any lane: the field
    is then a fixpoint, so the values and flags equal a full run's."""
    node_mode = nc is not None
    layouts = []
    for a in range(3):
        h, w = [i for i in range(3) if i != a]
        perm = (0, 1 + a, 1 + h, 1 + w)
        inv = tuple(int(i) for i in np.argsort(perm))
        anis_perm = (float(anisotropy[a]), float(anisotropy[h]),
                     float(anisotropy[w]))
        okp = ok.permute(perm).contiguous()
        ncp = nc.permute(perm).contiguous() if node_mode else None
        layouts.append((perm, inv, anis_perm, okp, ncp))

    changed = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    for _ in range(int(rounds) + 1):
        nd = d
        for perm, inv, anis_perm, okp, ncp in layouts:
            dm = nd.permute(perm).contiguous()
            for desc in (False, True):
                dm = sweep_axis0_batched(dm, okp, ncp, anis_perm, node_mode,
                                         bool(clamp_positive), desc)
            nd = dm.permute(inv).contiguous()
        same = not bool((nd != d).any())
        changed = _lane_changed(nd, d, conv)
        d = nd
        if same:
            break
    return d, ~changed


def distance_field(ok_mask, init_dist, anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                   node_cost=None, clamp_positive: bool = False,
                   max_rounds: int = _MAX_ROUNDS,
                   conv: str = "exact") -> torch.Tensor:
    """Exact SSSP distance field to fixpoint.

    ok_mask: bool volume of traversable voxels. init_dist: float32, +inf
    everywhere except the sources. node_cost: if given, the cost of
    entering v is node_cost[v]; else anisotropic euclidean step costs.
    clamp_positive: values > 0 reset to +inf each sweep (invalidation
    ball). `conv` is the convergence criterion matched to what the caller
    reads: "exact" or "negative" (the <= 0 part).
    Raises if the field still changes after `max_rounds` rounds.
    """
    ok = ok_mask.to(torch.bool)
    d = torch.where(ok, init_dist.to(torch.float32), INF)
    nc = None if node_cost is None else node_cost.to(torch.float32)
    views = _SweptViews(ok, nc)
    done = 0
    while done < int(max_rounds):
        d, converged = _relax_stage(d, views, anisotropy,
                                    bool(clamp_positive), _STAGE_ROUNDS, conv)
        done += _STAGE_ROUNDS + 1
        if converged:
            return d
    raise RuntimeError(f"distance_field: not converged in {max_rounds} rounds")


def euclidean_distance_field(ok_mask, source, anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                             return_max_location: bool = False):
    """Geodesic (foreground-constrained) anisotropic euclidean distance
    from source voxel(s); unreachable voxels are +inf. source: (3,) voxel
    coordinate or (k, 3) array."""
    ok = ok_mask.to(torch.bool)
    init = torch.full(ok.shape, INF, dtype=torch.float32, device=ok.device)
    src = np.asarray(source, dtype=np.int64).reshape(-1, 3)
    init[tuple(torch.as_tensor(src[:, a], device=ok.device)
               for a in range(3))] = 0.0
    dist = distance_field(ok, init, anisotropy)
    if not return_max_location:
        return dist
    finite = torch.where(torch.isfinite(dist), dist, -1.0)
    flat = int(torch.argmax(finite))
    target = tuple(int(c) for c in np.unravel_index(flat, tuple(dist.shape)))
    return dist, target


def parent_field(dist, ok_mask, anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                 node_cost=None) -> torch.Tensor:
    """Parent direction codes (int8 index into OFFSETS26; 26 = source or
    none). At the fixpoint dist[v] == min_u (dist[u] + cost(u->v)) exactly,
    so a post-hoc argmin rebuilds a shortest-path tree with a
    deterministic (offset order) tie break."""
    ok = ok_mask.to(torch.bool)
    best = torch.full(dist.shape, INF, dtype=torch.float32, device=dist.device)
    parent = torch.full(dist.shape, 26, dtype=torch.int8, device=dist.device)
    for k, off in enumerate(OFFSETS26):
        s = shifted(dist, off, INF)
        if node_cost is not None:
            cand = s + node_cost
        else:
            cand = s + _off_cost(off, anisotropy)
        better = cand < best
        best = torch.where(better, cand, best)
        parent = torch.where(better, k, parent).to(torch.int8)
    consistent = best <= dist
    return torch.where(consistent & ok & torch.isfinite(dist), parent,
                       26).to(torch.int8)


def invalidation_seeds(ok_mask, dbf, path_voxels, scale: float,
                       const: float, fused: bool = False):
    """The sources of a rolling-ball invalidation: (ok, init), `ok` the
    mask with the path voxels set (sources expand even where an earlier
    ball invalidated them), `init` +inf but -(scale*DBF[v] + const) at each
    path voxel v (the largest ball where several share a voxel). fused:
    the radius is one fused multiply-add, as in the JAX package's jitted
    loops (its eager callers round the product and the sum apart)."""
    ok = ok_mask.to(torch.bool).clone()
    pv = np.asarray(path_voxels, dtype=np.int64).reshape(-1, 3)
    idx = tuple(torch.as_tensor(pv[:, a], device=ok.device) for a in range(3))
    scale, const = float(np.float32(scale)), float(np.float32(const))
    if fused:
        radii = fma_f32(dbf[idx], scale, const)
    else:
        radii = dbf[idx] * scale + const
    init = torch.full(ok.shape, INF, dtype=torch.float32, device=ok.device)
    lin = np.ravel_multi_index(tuple(pv.T), tuple(ok.shape))
    init.view(-1).scatter_reduce_(
        0, torch.as_tensor(lin, device=ok.device), -radii, "amin")
    ok[idx] = True
    return ok, init


def invalidation_ball(ok_mask, dbf, path_voxels, scale: float, const: float,
                      anisotropy: Sequence[float] = (1.0, 1.0, 1.0)
                      ) -> torch.Tensor:
    """Rolling-ball invalidation restricted to the connected component:
    for each path vertex v, every foreground voxel within geodesic
    distance scale*DBF[v] + const (physical units, 26-connected steps) is
    invalidated. A multi-source capped relaxation from
    `invalidation_seeds` (radii not fused: the JAX package's eager
    loop), positives clamped to +inf, to convergence. Returns a bool mask
    of invalidated voxels."""
    ok, init = invalidation_seeds(ok_mask, dbf, path_voxels, scale, const)
    dist = distance_field(ok, init, anisotropy, clamp_positive=True,
                          conv="negative")
    return dist <= 0.0


def _flood6_stage(ok, init, rounds: int):
    """6-connected flood by plane sweeps (only the axial offsets take
    part). `rounds` rounds plus one checking round; returns (d, converged)
    under the reachability criterion."""

    def sweep6(d, axis, direction):
        n = d.shape[axis]
        if n <= 1:
            return d
        dd = torch.movedim(d, axis, 0)
        mm = torch.movedim(ok, axis, 0)
        out = torch.empty_like(dd)
        order = range(n - 1, -1, -1) if direction < 0 else range(n)
        prev = None
        for p in order:
            new = dd[p] if prev is None else torch.where(
                mm[p], torch.minimum(dd[p], prev + 1.0), INF)
            out[p] = new
            prev = new
        return torch.movedim(out, 0, axis)

    d = torch.where(ok, init, INF)
    changed = True
    for _ in range(int(rounds) + 1):
        nd = d
        for axis in range(3):
            for direction in (1, -1):
                nd = sweep6(nd, axis, direction)
        changed = _changed(nd, d, "reach")
        d = nd
    return d, not changed


def flood_fill(seed_mask, ok_mask) -> torch.Tensor:
    """Binary reachability: all ok voxels 6-connected to seed_mask."""
    ok = ok_mask.to(torch.bool)
    init = torch.where(seed_mask.to(torch.bool) & ok, 0.0, INF)
    d = torch.where(ok, init, INF)
    done = 0
    while done < _MAX_ROUNDS:
        d, converged = _flood6_stage(ok, d, _STAGE_ROUNDS)
        done += _STAGE_ROUNDS + 1
        if converged:
            return torch.isfinite(d)
    raise RuntimeError("flood_fill: not converged")
