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

`voronoi_feature_field` relaxes a distance and the id of the nearest seed
together (kernel V1, `ops.voronoi.voronoi_sweep`), and
`voronoi_feature_field_batched` does so for many volumes at once (V1's
lane-batched form, `ops.voronoi.voronoi_sweep_lanes`); `invalidation_cube`
is the legacy box-shaped invalidation, slice fills on `device`.

`voxel_graph` (optional, cc3d convention, ops.stencils.GRAPH_BITS): a
candidate reaching v from u = v + o counts only where u permits the move
along -o. The sweeps read that permission at v, from v's gate word
(ops.stencils.graph_into) through the bits of their layout
(ops.gsweep.gate_bits9): `relax_rounds_batched` builds the gate of its
lanes once a call (or takes it prebuilt, `gate=`), and a field builds it
once (or takes a `SweepGate` built once for many fields, as the host
trace path does for a label).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import profiling
from .fma import fma_f32
from .gsweep import gate_bits9
from .stencils import (GRAPH_BITS, as_tensor, graph_allows, graph_into,
                       neighborhood_offsets, shifted)
from .sweep import sweep_axis0, sweep_axis0_batched
from .voronoi import voronoi_sweep
from ..utils.device import resolve_device

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


@functools.lru_cache(maxsize=None)
def sweep_bits9(axis: int, descending: bool) -> tuple:
    """The voxel-graph bits that gate a sweep along `axis` laid out with
    that axis first and the other two in order (the layout of `_sweep`
    and of relax_rounds_batched): the neighbour at (dy, dz) of the
    previous plane lies at offset o, o[axis] = -1 (+1 when descending),
    and moves into the voxel along -o."""
    h, w = [i for i in range(3) if i != axis]
    bits = []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            o = [0, 0, 0]
            o[axis] = 1 if descending else -1
            o[h], o[w] = dy, dz
            bits.append(GRAPH_BITS[tuple(-c for c in o)])
    return tuple(bits)


class SweepGate:
    """A voxel graph's gate (ops.stencils.graph_into) moved to axis 0 of
    each of the three sweep axes: built once, it serves every sweep of
    every field of a volume. Any function of this module that takes a
    `voxel_graph` for its sweeps takes a SweepGate there too."""

    __slots__ = ("views",)

    def __init__(self, voxel_graph):
        gate = graph_into(voxel_graph)
        self.views = tuple(torch.movedim(gate, a, 0).contiguous()
                           for a in range(3))


class _SweptViews:
    """The static operands of a relax (the ok mask, the node costs and
    the voxel graph's gate) moved to axis 0 of each of the three sweep
    axes, built once per distance field (the gate once per SweepGate) and
    reused by every sweep of every stage; only the field itself moves per
    sweep."""

    __slots__ = ("ok", "nc", "gate")

    def __init__(self, ok, node_cost, voxel_graph=None):
        def moved(t):
            return (None if t is None else
                    tuple(torch.movedim(t, a, 0).contiguous()
                          for a in range(3)))

        self.ok = moved(ok)
        self.nc = moved(node_cost)
        if voxel_graph is not None and \
                not isinstance(voxel_graph, SweepGate):
            voxel_graph = SweepGate(as_tensor(voxel_graph).to(ok.device))
        self.gate = None if voxel_graph is None else voxel_graph.views


def _sweep(dist, views: _SweptViews, axis: int, direction: int, anisotropy,
           clamp_positive: bool):
    """One directional plane sweep along `axis` in `direction` (+1/-1)."""
    if dist.shape[axis] <= 1:
        return dist
    anis_perm = (float(anisotropy[axis]),) + tuple(
        float(anisotropy[i]) for i in range(3) if i != axis)
    d2 = torch.movedim(dist, axis, 0).contiguous()
    nc2 = None if views.nc is None else views.nc[axis]
    gate = None if views.gate is None else views.gate[axis]
    bits = None if gate is None else gate_bits9(axis, direction < 0)
    out = sweep_axis0(d2, views.ok[axis], nc2, anis_perm, nc2 is not None,
                      bool(clamp_positive), descending=direction < 0,
                      gate=gate, gate_bits9=bits)
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
                         clamp_positive: bool = False, conv: str = "exact",
                         voxel_graph=None, gate=None):
    """`rounds` full 6-sweep rounds plus one checking round over a batch
    of (B, X, Y, Z) lanes (counterpart of geodesic.relax_rounds_batchable
    under vmap). Returns (d, converged): converged[b] when lane b's last
    round changed nothing under `conv` ("exact", "reach" or "negative").
    `voxel_graph`: (B, X, Y, Z) per-lane bitfields gating every move;
    `gate`: their gate words (ops.stencils.graph_into of the batch),
    built once by a caller that relaxes the same lanes many times (one of
    the two at most).

    Axes 1 and 2 are swept through permuted contiguous copies (ok, nc and
    the gate are permuted once per call, d twice per axis and round). The
    loop stops early after a round that changed no value of any lane: the
    field is then a fixpoint, so the values and flags equal a full run's."""
    node_mode = nc is not None
    if voxel_graph is not None:
        if gate is not None:
            raise ValueError("relax_rounds_batched: give voxel_graph or "
                             "gate, not both")
        gate = graph_into(voxel_graph)
    layouts = []
    for a in range(3):
        h, w = [i for i in range(3) if i != a]
        perm = (0, 1 + a, 1 + h, 1 + w)
        inv = tuple(int(i) for i in np.argsort(perm))
        anis_perm = (float(anisotropy[a]), float(anisotropy[h]),
                     float(anisotropy[w]))
        okp = ok.permute(perm).contiguous()
        ncp = nc.permute(perm).contiguous() if node_mode else None
        gp = None if gate is None else gate.permute(perm).contiguous()
        layouts.append((a, perm, inv, anis_perm, okp, ncp, gp))

    changed = torch.ones(d.shape[0], dtype=torch.bool, device=d.device)
    for _ in range(int(rounds) + 1):
        nd = d
        for a, perm, inv, anis_perm, okp, ncp, gp in layouts:
            dm = nd.permute(perm).contiguous()
            for desc in (False, True):
                bits = None if gp is None else gate_bits9(a, desc)
                dm = sweep_axis0_batched(dm, okp, ncp, anis_perm, node_mode,
                                         bool(clamp_positive), desc,
                                         gate=gp, gate_bits9=bits)
            nd = dm.permute(inv).contiguous()
        same = not profiling.host((nd != d).any(), bool)
        changed = _lane_changed(nd, d, conv)
        d = nd
        if same:
            break
    return d, ~changed


def _bool_volume(x, device=None) -> torch.Tensor:
    return as_tensor(x, device).to(torch.bool)


def distance_field(ok_mask, init_dist,
                   anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                   node_cost=None, clamp_positive: bool = False,
                   max_rounds: int = _MAX_ROUNDS, voxel_graph=None,
                   rounds: Optional[int] = None,
                   conv: str = "exact", device="cuda") -> torch.Tensor:
    """Exact SSSP distance field to fixpoint (the parameters of
    kimimaro_tpu.ops.geodesic.distance_field, in its order).

    ok_mask: bool volume of traversable voxels. init_dist: float32, +inf
    everywhere except the sources. node_cost: if given, the cost of
    entering v is node_cost[v]; else anisotropic euclidean step costs.
    clamp_positive: values > 0 reset to +inf each sweep (invalidation
    ball). `voxel_graph`: the cc3d-convention bitfield gating every move,
    or a SweepGate built from it.
    `rounds`: run exactly rounds + 1 rounds and return, with no host
    synchronization (the field may be unconverged). Otherwise stages of
    seven rounds run until one changes nothing under `conv` ("exact",
    "negative": the <= 0 part, or "reach": finiteness) or `max_rounds`
    rounds have run; the field is returned either way, as JAX returns
    it. An array-like `ok_mask` goes to `device` (a tensor stays on its
    own), the other volumes to the mask's device."""
    ok = _bool_volume(ok_mask, device)
    init = as_tensor(init_dist).to(device=ok.device, dtype=torch.float32)
    d = torch.where(ok, init, INF)
    nc = (None if node_cost is None else
          as_tensor(node_cost).to(device=ok.device, dtype=torch.float32))
    views = _SweptViews(ok, nc, voxel_graph)
    if rounds is not None:
        for _ in range(int(rounds) + 1):
            for axis in range(3):
                for direction in (1, -1):
                    d = _sweep(d, views, axis, direction, anisotropy,
                               bool(clamp_positive))
        return d
    done = 0
    while done < int(max_rounds):
        d, converged = _relax_stage(d, views, anisotropy,
                                    bool(clamp_positive), _STAGE_ROUNDS, conv)
        done += _STAGE_ROUNDS + 1
        if converged:
            break
    return d


def euclidean_distance_field(ok_mask, source, anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                             return_max_location: bool = False,
                             voxel_graph=None, device="cuda"):
    """Geodesic (foreground-constrained) anisotropic euclidean distance
    from source voxel(s); unreachable voxels are +inf. source: (3,) voxel
    coordinate or (k, 3) array. An array-like mask goes to `device`."""
    ok = _bool_volume(ok_mask, device)
    init = torch.full(ok.shape, INF, dtype=torch.float32, device=ok.device)
    src = np.asarray(source, dtype=np.int64).reshape(-1, 3)
    init[tuple(torch.as_tensor(src[:, a], device=ok.device)
               for a in range(3))] = 0.0
    dist = distance_field(ok, init, anisotropy, voxel_graph=voxel_graph)
    if not return_max_location:
        return dist
    finite = torch.where(torch.isfinite(dist), dist, -1.0)
    flat = int(torch.argmax(finite))
    target = tuple(int(c) for c in np.unravel_index(flat, tuple(dist.shape)))
    return dist, target


def parent_field(dist, ok_mask, anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                 node_cost=None, voxel_graph=None,
                 device="cuda") -> torch.Tensor:
    """Parent direction codes (int8 index into OFFSETS26; 26 = source or
    none). At the fixpoint dist[v] == min_u (dist[u] + cost(u->v)) exactly,
    so a post-hoc argmin rebuilds a shortest-path tree with a
    deterministic (offset order) tie break. `voxel_graph`: a parent u =
    v + o counts only where u permits the move along -o. An array-like
    mask goes to `device` (a tensor stays on its own), the other volumes
    to the mask's device."""
    ok = _bool_volume(ok_mask, device)
    dist = as_tensor(dist).to(device=ok.device, dtype=torch.float32)
    if node_cost is not None:
        node_cost = as_tensor(node_cost).to(device=ok.device,
                                            dtype=torch.float32)
    if voxel_graph is not None:
        voxel_graph = as_tensor(voxel_graph).to(ok.device)
    best = torch.full(dist.shape, INF, dtype=torch.float32, device=dist.device)
    parent = torch.full(dist.shape, 26, dtype=torch.int8, device=dist.device)
    for k, off in enumerate(OFFSETS26):
        s = shifted(dist, off, INF)
        if voxel_graph is not None:
            neg = tuple(-c for c in off)
            s = torch.where(shifted(graph_allows(voxel_graph, neg), off,
                                    False), s, INF)
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


def jax_index(coords, shape):
    """JAX's rule for an (L, 3) coordinate array used as indices: a
    negative coordinate counts from the end once. Returns (the wrapped
    coordinates, the rows inside the volume). A gather clamps the wrapped
    coordinates into the volume; a scatter drops the rows outside (as a
    path that a chase walked out of its crop needs)."""
    size = np.asarray(shape, dtype=np.int64)
    c = np.asarray(coords, dtype=np.int64).reshape(-1, 3)
    c = np.where(c < 0, c + size, c)
    return c, ((c >= 0) & (c < size)).all(axis=1)


def invalidation_seeds(ok_mask, dbf, path_voxels, scale: float,
                       const: float, fused: bool = False, device=None):
    """The sources of a rolling-ball invalidation: (ok, init), `ok` the
    mask with the path voxels set (sources expand even where an earlier
    ball invalidated them), `init` +inf but -(scale*DBF[v] + const) at each
    path voxel v (the largest ball where several share a voxel). fused:
    the radius is one fused multiply-add, as in the JAX package's jitted
    loops (its eager callers round the product and the sum apart). Path
    voxels follow JAX's index rule (`jax_index`). An array-like mask goes
    to `device` (the CPU where None)."""
    ok = _bool_volume(ok_mask, device).clone()
    dbf = as_tensor(dbf).to(device=ok.device, dtype=torch.float32)
    pv, inb = jax_index(path_voxels, ok.shape)
    near = np.minimum(np.maximum(pv, 0), np.asarray(ok.shape) - 1)
    idx = tuple(torch.as_tensor(near[:, a], device=ok.device)
                for a in range(3))
    scale, const = float(np.float32(scale)), float(np.float32(const))
    if fused:
        radii = fma_f32(dbf[idx], scale, const)
    else:
        radii = dbf[idx] * scale + const
    init = torch.full(ok.shape, INF, dtype=torch.float32, device=ok.device)
    lin = np.ravel_multi_index(tuple(pv[inb].T), tuple(ok.shape))
    keep = torch.as_tensor(inb, device=ok.device)
    init.view(-1).scatter_reduce_(
        0, torch.as_tensor(lin, device=ok.device), -radii[keep], "amin")
    ok.view(-1)[torch.as_tensor(lin, device=ok.device)] = True
    return ok, init


def invalidation_ball(ok_mask, dbf, path_voxels, scale: float, const: float,
                      anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                      voxel_graph=None, device="cuda") -> torch.Tensor:
    """Rolling-ball invalidation restricted to the connected component:
    for each path vertex v, every foreground voxel within geodesic
    distance scale*DBF[v] + const (physical units, 26-connected steps) is
    invalidated. A multi-source capped relaxation from
    `invalidation_seeds` (radii not fused: the JAX package's eager
    loop), positives clamped to +inf, to convergence. Returns a bool mask
    of invalidated voxels. An array-like mask goes to `device`, the other
    volumes to the mask's device."""
    ok, init = invalidation_seeds(ok_mask, dbf, path_voxels, scale, const,
                                  device=device)
    dist = distance_field(ok, init, anisotropy, clamp_positive=True,
                          conv="negative", voxel_graph=voxel_graph)
    return dist <= 0.0


def invalidation_cube(labels, dbf, path_voxels, scale: float, const: float,
                      anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                      device="cuda"):
    """Cube-shaped TEASAR invalidation: zero every voxel within the
    axis-aligned box of physical half-extent scale*DBF[v] + const around
    each path vertex v, crossing label gaps (the legacy
    skeletontricks.roll_invalidation_cube semantics, as
    kimimaro_tpu.ops.geodesic.invalidation_cube). Vertices with v[0] < 0
    are skipped; DBF is read by JAX's index rule (`jax_index`, clamped).
    The radius is one fused multiply-add, as XLA computes it in the JAX
    package's jitted cube. Voxel c lies in the box where |c_a - v_a| <=
    r / w_a in float32 on every axis a; for integer offsets below 2^24 that
    is |c_a - v_a| <= floor(r / w_a), so each box is one slice fill.
    `labels` and `dbf` may be arrays: array labels go to `device`, a
    tensor stays on its own, and `labels`' device holds the work. Returns
    (n_invalidated, labels)."""
    labels = as_tensor(labels, device)
    dbf = as_tensor(dbf).to(device=labels.device, dtype=torch.float32)
    shape = np.asarray(dbf.shape, dtype=np.int64)
    pv = np.asarray(path_voxels, dtype=np.int32).reshape(-1, 3)
    pv = pv[pv[:, 0] >= 0].astype(np.int64)
    mask = torch.zeros(tuple(shape), dtype=torch.bool, device=labels.device)
    if len(pv):
        near, _ = jax_index(pv, shape)
        near = np.clip(near, 0, shape - 1)
        at = dbf[tuple(torch.as_tensor(near[:, a], device=dbf.device)
                       for a in range(3))]
        radii = fma_f32(at, float(np.float32(scale)),
                        float(np.float32(const))).cpu().numpy()
        half = radii[:, None] / np.asarray(anisotropy, dtype=np.float32)
        for v, h in zip(pv, half):
            if np.isnan(h).any():
                continue
            reach = np.floor(np.minimum(h, 2.0**30)).astype(np.int64)
            lo = np.maximum(v - reach, 0)
            hi = np.minimum(v + reach, shape - 1)
            if (lo <= hi).all():
                mask[lo[0]:hi[0] + 1, lo[1]:hi[1] + 1, lo[2]:hi[2] + 1] = True
    n_inv = (mask & (labels != 0)).sum()
    return n_inv, torch.where(mask, torch.zeros_like(labels), labels)


@functools.lru_cache(maxsize=None)
def plane_costs(axis: int, descending: bool, anisotropy: tuple) -> tuple:
    """The nine step costs of a sweep along `axis` in the (dy, dz) order
    of its layout (the other two axes in order): the length of the offset
    from the neighbour on the previous plane, rounded as the JAX package's
    `_off_cost` rounds it."""
    h, w = [i for i in range(3) if i != axis]
    costs = []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            o = [0, 0, 0]
            o[axis] = 1 if descending else -1
            o[h], o[w] = dy, dz
            costs.append(_off_cost(o, anisotropy))
    return tuple(costs)


def _seed_cells(seeds, shape):
    """The seeds of a Voronoi field by JAX's index rule (`jax_index`: a
    negative coordinate counts from the end, rows outside are dropped),
    the last occurrence of a repeated voxel kept: (linear indices into
    `shape`, their 1-based seed ids)."""
    seeds = np.asarray(seeds, dtype=np.int64).reshape(-1, 3)
    c, inb = jax_index(seeds, shape)
    lin = np.ravel_multi_index(tuple(c[inb].T), shape)
    ids = np.arange(1, len(seeds) + 1, dtype=np.int32)[inb]
    # the last occurrence of each voxel (index_put_ with repeated indices
    # is unordered on CUDA)
    _, last = np.unique(lin[::-1], return_index=True)
    keep = len(lin) - 1 - last
    return lin[keep], ids[keep]


def _voronoi_rounds(max_rounds: int) -> int:
    """The rounds JAX's stages of seven run for `max_rounds`."""
    stage = _STAGE_ROUNDS + 1
    return stage * -(-int(max_rounds) // stage)


def voronoi_feature_field(ok_mask, seeds,
                          anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                          max_rounds: int = _MAX_ROUNDS, device="cuda"):
    """Multi-source geodesic distance field and nearest-seed feature map
    (kimimaro_tpu.ops.geodesic.voronoi_feature_field). `seeds`: (k, 3)
    voxel coordinates (JAX's index rule: a negative coordinate counts from
    the end, rows outside are dropped); a repeated voxel keeps the later
    seed. Features are 1-based seed indices (0 = unreached). Rounds of six
    directed sweeps (kernel V1, `ops.voronoi.voronoi_sweep`) run until one
    changes nothing; where none does, the fields after as many rounds as
    the JAX package's stages of seven run for `max_rounds` are returned,
    as JAX returns them. An array-like `ok_mask` goes to `device`, a
    tensor stays on its own (a CUDA tensor runs V1 on the card). Returns
    (dist float32, features int32)."""
    ok = _bool_volume(ok_mask, device)
    dev, shape = ok.device, tuple(ok.shape)
    lin, ids = _seed_cells(seeds, shape)
    at = torch.as_tensor(lin, device=dev)
    d = torch.full(shape, INF, dtype=torch.float32, device=dev)
    f = torch.zeros(shape, dtype=torch.int32, device=dev)
    d.view(-1)[at] = 0.0
    f.view(-1)[at] = torch.as_tensor(ids, device=dev)
    rounds = _voronoi_rounds(max_rounds)
    if rounds <= 0:
        return d, f
    d = torch.where(ok, d, INF)
    oks = tuple(torch.movedim(ok, a, 0).contiguous() for a in range(3))
    anis = tuple(float(a) for a in anisotropy)
    changed = torch.zeros(1, dtype=torch.int32, device=dev)
    for _ in range(rounds):
        changed.zero_()
        for axis in range(3):
            if shape[axis] <= 1:
                continue
            dm = torch.movedim(d, axis, 0).contiguous()
            fm = torch.movedim(f, axis, 0).contiguous()
            for desc in (False, True):
                dm, fm = voronoi_sweep(dm, fm, oks[axis],
                                       plane_costs(axis, desc, anis), desc,
                                       changed)
            d = torch.movedim(dm, 0, axis).contiguous()
            f = torch.movedim(fm, 0, axis).contiguous()
        profiling.count("voronoi_rounds")
        if not bool(changed.item()):
            break
    return d, f


# the batched field's buckets: each side rounded up to a multiple of this
VORONOI_BUCKET = 16
# device bytes a padded voxel of a batch takes: its ok mask in each of the
# three sweep layouts and two copies of the distance and the feature
VORONOI_BYTES_PER_VOXEL = 3 + 16
# each sweep axis' layout of an (X, Y, Z) volume: the axis first, the
# other two in order (torch.movedim(v, axis, 0))
_LAYOUTS = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


def voronoi_bucket(shape) -> tuple:
    """The bucket of a volume of `shape`: each side rounded up to a
    multiple of VORONOI_BUCKET."""
    q = VORONOI_BUCKET
    return tuple(-(-int(s) // q) * q for s in shape)


class _Bucket:
    """The lanes of one bucket shape in a batch: their indices, their
    segment [start, start + len * prod(shape)) of the flat storages, and,
    once every lane is done, the storage that holds the final fields."""

    def __init__(self, shape, lanes, start):
        self.shape, self.lanes, self.start = shape, lanes, start
        self.size = len(lanes) * int(np.prod(shape))
        self.final = None

    def view(self, flat, layout):
        """The bucket's segment of a flat storage as (B, n, H, W) in the
        sweep layout of axis `layout`."""
        dims = tuple(self.shape[a] for a in _LAYOUTS[layout])
        return flat[self.start:self.start + self.size].view(
            len(self.lanes), *dims)


def _lane_table(buckets, shapes, layout, n_lanes):
    """The V1 lane table of a batch in the sweep layout of axis `layout`:
    lane i at its bucket's offset, its own extent, the bucket's strides."""
    table = np.zeros((n_lanes, 6), dtype=np.int64)
    a, h, w = _LAYOUTS[layout]
    for b in buckets:
        _, H, W = (b.shape[a], b.shape[h], b.shape[w])
        vox = int(np.prod(b.shape))
        for k, i in enumerate(b.lanes):
            table[i] = (b.start + k * vox, shapes[i][a], shapes[i][h],
                        shapes[i][w], W, H * W)
    return table


def _batch_setup(masks, shapes, seeds_list, buckets, total, dev):
    """The flat storages of a batch: the ok masks in the three sweep
    layouts (each bucket's lanes at its low corners, assembled on the host
    where the masks are arrays), and the seeded distance and feature."""
    ok_flat = [torch.zeros(total, dtype=torch.bool, device=dev)
               for _ in range(3)]
    d = torch.full((total,), INF, dtype=torch.float32, device=dev)
    f = torch.zeros(total, dtype=torch.int32, device=dev)
    seed_lin, seed_ids = [], []
    for b in buckets:
        ok0 = b.view(ok_flat[0], 0)
        if all(not torch.is_tensor(masks[i]) for i in b.lanes):
            host = np.zeros(ok0.shape, dtype=bool)
            for k, i in enumerate(b.lanes):
                x, y, z = shapes[i]
                host[k, :x, :y, :z] = masks[i]
            ok0.copy_(torch.from_numpy(host))
        else:
            for k, i in enumerate(b.lanes):
                x, y, z = shapes[i]
                ok0[k, :x, :y, :z] = torch.as_tensor(masks[i]).to(dev)
        b.view(ok_flat[1], 1).copy_(ok0.permute(0, 2, 1, 3))
        b.view(ok_flat[2], 2).copy_(ok0.permute(0, 3, 1, 2))
        vox = int(np.prod(b.shape))
        for k, i in enumerate(b.lanes):
            lin, ids = _seed_cells(seeds_list[i], shapes[i])
            c = np.unravel_index(lin, shapes[i])
            seed_lin.append(b.start + k * vox
                            + np.ravel_multi_index(c, b.shape))
            seed_ids.append(ids)
    if seed_lin:
        at = torch.as_tensor(np.concatenate(seed_lin), device=dev)
        d[at] = 0.0
        f[at] = torch.as_tensor(np.concatenate(seed_ids), device=dev)
    return ok_flat, d, f


def _batch_rounds(d, f, ok_flat, buckets, shapes, anisotropy, rounds: int):
    """The rounds of a batch (d, f in axis 0's layout, non-ok voxels +inf):
    each directed sweep one `voronoi_sweep_lanes` call for every lane, the
    layouts of axes 1 and 2 one copy a bucket, the change flags read once a
    round; a lane whose round changed nothing leaves `active`, a bucket
    whose lanes all left keeps its fields where they are (`final`).
    Returns the storages of the last round's (d, f)."""
    from .voronoi import VoronoiLanes, voronoi_sweep_lanes

    n_lanes, total = len(shapes), d.numel()
    lanes = [VoronoiLanes(_lane_table(buckets, shapes, a, n_lanes), total)
             for a in range(3)]
    src = (d, f)
    dst = (torch.empty_like(d), torch.empty_like(f))
    anis = tuple(float(a) for a in anisotropy)
    changed = torch.zeros(n_lanes, dtype=torch.int32, device=d.device)
    live = np.ones(n_lanes, dtype=bool)
    active = torch.ones(n_lanes, dtype=torch.bool, device=d.device)
    ran = 0
    for _ in range(rounds):
        changed.zero_()
        moving = [b for b in buckets if b.final is None]
        for a in range(3):
            if a > 0:  # into axis a's layout, bucket by bucket
                for b in moving:
                    for s, t in zip(src, dst):
                        b.view(t, a).copy_(b.view(s, a - 1).permute(
                            (0, 2, 1, 3) if a == 1 else (0, 3, 2, 1)))
                src, dst = dst, src
            for desc in (False, True):
                voronoi_sweep_lanes(src[0], src[1], ok_flat[a], lanes[a],
                                    plane_costs(a, desc, anis), desc,
                                    changed, active)
        for b in moving:  # back to axis 0's layout
            for s, t in zip(src, dst):
                b.view(t, 0).copy_(b.view(s, 2).permute(0, 2, 3, 1))
        src, dst = dst, src
        ran += int(live.sum())
        live &= changed.cpu().numpy() != 0
        for b in moving:
            if not live[b.lanes].any():
                b.final = src
        if not live.any():
            break
        active.copy_(torch.from_numpy(live))
    profiling.count("voronoi_rounds", ran)
    return src


def voronoi_feature_field_batched(oks, seeds_list,
                                  anisotropy: Sequence[float] = (1.0, 1.0,
                                                                 1.0),
                                  max_rounds: int = _MAX_ROUNDS,
                                  device="cuda", with_ok: bool = False):
    """`voronoi_feature_field` of many volumes at once: lane i the mask
    `oks[i]` (any 3-D shape) with the seeds `seeds_list[i]`, each result
    bit-equal to voronoi_feature_field(oks[i], seeds_list[i], anisotropy,
    max_rounds). The lanes whose planes all fit the lane-batched V1
    (`ops.voronoi.lane_capacity` cells in each of the three sweep
    layouts) are grouped into buckets of one shape, each side rounded up
    to a multiple of VORONOI_BUCKET, at the low corner; each sweep of a
    round is one call of `ops.voronoi.voronoi_sweep_lanes` for every lane
    of every bucket, over flat storages that hold the buckets in turn,
    with the axis-1 and axis-2 layouts made by one copy per bucket and
    axis. Every round's change flags are read once for the whole batch; a
    lane whose round changed nothing (a fixpoint of the round) is not
    swept again, and every lane stops at the same cap on rounds. A lane
    with a larger plane takes `voronoi_feature_field` alone, whose forms
    spread a plane over many SMs. Array-like masks go to `device`
    (tensors keep theirs; all on one device). Phases: voronoi_setup (the
    masks, their layouts and the seeds), voronoi_sweeps (the rounds).
    Counters: `voronoi_rounds` (lane-rounds), `voronoi_batches`,
    `voronoi_voxels`, `voronoi_padded_voxels` (of the batched lanes),
    `voronoi_single_lanes`. Returns a list of (dist float32, features
    int32), views of the batch's storages; with `with_ok`, (dist,
    features, ok) with each lane's mask on the device."""
    from .voronoi import lane_capacity

    masks = [x if torch.is_tensor(x) else np.asarray(x) for x in oks]
    on = [x.device for x in masks if torch.is_tensor(x)]
    dev = on[0] if on else resolve_device(device)
    shapes = [tuple(int(s) for s in x.shape) for x in masks]
    if any(len(s) != 3 for s in shapes) or len(seeds_list) != len(masks):
        raise ValueError("voronoi_feature_field_batched: one 3-D mask and "
                         "one seed array a lane")
    cap = lane_capacity(dev)
    out = [None] * len(masks)
    batched = []
    for i, (x, y, z) in enumerate(shapes):
        if max(y * z, x * z, x * y) <= cap:
            batched.append(i)
            continue
        profiling.count("voronoi_single_lanes")
        ok = _bool_volume(masks[i], dev)
        d, f = voronoi_feature_field(ok, seeds_list[i], anisotropy,
                                     max_rounds)
        out[i] = (d, f, ok)
    if batched:
        fields = _voronoi_lanes([masks[i] for i in batched],
                                [seeds_list[i] for i in batched],
                                [shapes[i] for i in batched], anisotropy,
                                max_rounds, dev)
        for i, field in zip(batched, fields):
            out[i] = field
    return out if with_ok else [(d, f) for d, f, _ in out]


def _voronoi_lanes(masks, seeds_list, shapes, anisotropy, max_rounds, dev):
    """The lane-batched fields of `voronoi_feature_field_batched` for
    lanes whose planes all fit the kernel: a list of (dist, features, ok)
    views, one per lane, into the batch's storages."""
    groups = {}
    for i, s in enumerate(shapes):
        groups.setdefault(voronoi_bucket(s), []).append(i)
    buckets, start = [], 0
    for key in sorted(groups):
        buckets.append(_Bucket(key, groups[key], start))
        start += buckets[-1].size
    total = start
    profiling.count("voronoi_batches")
    profiling.count("voronoi_voxels", sum(int(np.prod(s)) for s in shapes))
    profiling.count("voronoi_padded_voxels", total)

    with profiling.phase("voronoi_setup", dev):
        ok_flat, d_a, f_a = _batch_setup(masks, shapes, seeds_list, buckets,
                                         total, dev)
    rounds = _voronoi_rounds(max_rounds)
    src = (d_a, f_a)
    if rounds > 0:
        d_a.masked_fill_(~ok_flat[0], INF)  # seeds outside the masks
        with profiling.phase("voronoi_sweeps", dev):
            src = _batch_rounds(d_a, f_a, ok_flat, buckets, shapes,
                                anisotropy, rounds)
    out = [None] * len(shapes)
    for b in buckets:
        d_f = b.final if b.final is not None else src
        views = [b.view(t, 0) for t in (*d_f, ok_flat[0])]
        for k, i in enumerate(b.lanes):
            x, y, z = shapes[i]
            out[i] = tuple(v[k, :x, :y, :z] for v in views)
    return out


def _reach_scan(reached, ok, axis: int, descending: bool):
    """One directed 6-connected sweep of reachability along `axis`: a
    voxel is reached when it is ok and a reached voxel precedes it in its
    run of ok voxels (the first plane passes through). The distance
    sweep's `where(ok, min(cur, prev + 1), inf)` read through isfinite,
    as one segmented scan instead of a loop over planes."""
    if descending:
        reached, ok = reached.flip(axis), ok.flip(axis)
    n = reached.shape[axis]
    pos = torch.arange(n, dtype=torch.int32, device=reached.device).view(
        [n if a == axis else 1 for a in range(reached.ndim)])
    last_r = torch.where(reached, pos, -1).cummax(axis).values
    last_wall = torch.where(ok, -1, pos).cummax(axis).values
    out = last_r > last_wall
    return out.flip(axis) if descending else out


def _flood6_stage(ok, reached, rounds: int):
    """6-connected flood of `reached` through `ok`, both (..., X, Y, Z)
    bool with any leading lane dimensions: `rounds` rounds of six directed
    sweeps plus one checking round, as the JAX package's `_flood6_stage`
    runs them (its distances are read only through isfinite, so the
    reachability is carried alone). Returns (reached, converged per
    lane): converged when the last round reached nothing new. A round
    that reaches nothing new in any lane is a fixpoint, so the loop stops
    there with every lane converged."""
    nd = ok.ndim
    reached = reached & ok
    changed = torch.ones(ok.shape[:-3], dtype=torch.bool, device=ok.device)
    for _ in range(int(rounds) + 1):
        nr = reached
        for axis in range(nd - 3, nd):
            for descending in (False, True):
                nr = _reach_scan(nr, ok, axis, descending)
        changed = (nr != reached).flatten(nd - 3).any(dim=-1)
        reached = nr
        if not profiling.host(changed.any(), bool):
            break
    return reached, ~changed


def flood_fill(seed_mask, ok_mask, connectivity: int = 6,
               rounds: Optional[int] = None, device="cuda") -> torch.Tensor:
    """Binary reachability: all ok voxels connected to seed_mask
    (kimimaro_tpu.ops.geodesic.flood_fill). connectivity 6 or 26 (26:
    `distance_field` with unit costs read through finiteness). `rounds`:
    the bounded form, rounds + 1 rounds and no host synchronization (may
    under-flood); otherwise stages of seven rounds until one reaches
    nothing new, at most 4096 rounds. An array-like mask goes to `device`
    (a tensor stays on its own), the seeds to the mask's device."""
    ok = _bool_volume(ok_mask, device)
    seeds = _bool_volume(seed_mask).to(ok.device) & ok
    if connectivity == 26:
        init = torch.where(seeds, 0.0, INF)
        dist = distance_field(ok, init, (1.0, 1.0, 1.0), rounds=rounds,
                              conv="reach")
        return torch.isfinite(dist)
    if rounds is not None:
        return _flood6_stage(ok, seeds, int(rounds))[0]
    reached = seeds
    done = 0
    while done < _MAX_ROUNDS:
        reached, converged = _flood6_stage(ok, reached, _STAGE_ROUNDS)
        done += _STAGE_ROUNDS + 1
        if profiling.host(converged.all(), bool):
            break
    return reached
