"""Volume sharding over a list of devices: the multi-device preamble.

Torch counterpart of kimimaro_tpu.parallel.sharded. A volume's leading
axis is split into equal slabs, one per mesh position, each a tensor on
its device (`shard_volume`, a `ShardedVolume`). One process drives every
shard; the JAX package's collectives are the explicit exchanges of
`parallel.comm`. On the shards:

  * the multi-label EDT runs its passes along the unsharded axes locally
    (the run-boundary scan, then a banded parabola pass with the static
    band min(n - 1, 256)), and the pass along the sharded axis as a ring
    min-plus: blocks of (distances, labels) rotate around the ring while
    each shard folds their lower-envelope contribution into its lines;
  * distance sweeps and CCL exchange one boundary plane per round
    (halos) and iterate to a global fixpoint (a psum'd changed flag).

The distance rounds follow the JAX package's schedule exactly (kernel B5
on each slab with its halo plane as plane 0, which the kernel passes
unchanged), so a fixed `rounds` gives its values too. The CCL fixpoint
runs B1's minid form on each slab extended by its halo planes, with
local pointer jumps: the fixpoint is unique (each voxel carries the
minimum linear index + 1 over the voxels that reach it), so it equals the
JAX package's; a fixed `rounds` runs the JAX package's own stencil round.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops import geodesic, gsweep
from ..ops.edt import BIG, _axial_pass, _parabola_pass_banded, wall_segments
from ..ops.geodesic import OFFSETS26, _SweptViews, _sweep
from ..ops.stencils import (as_tensor, graph_allows, graph_into, graph_word,
                             shifted)
from ..trace import pow_1_01
from . import comm
from .comm import Mesh

INF = float("inf")
AXIS = "shard"  # the mesh axis; a volume's leading axis is sharded over it
BIGID = gsweep.BIGID

_AXIS_UNIT = ((1, 0, 0), (0, 1, 0), (0, 0, 1))


def make_mesh(n_devices: int, device="cuda") -> Mesh:
    """A 1-D mesh of `n_devices` shards over the volume's leading axis:
    shard i on cuda:{i % torch.cuda.device_count()} (a one-card host puts
    every shard on cuda:0), or every shard on the CPU with
    device="cpu". Asking for CUDA where there is none raises."""
    n = int(n_devices)
    if n < 1:
        raise ValueError("make_mesh: n_devices must be at least 1")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: device='cuda' was requested but "
                               "CUDA is not available; pass device='cpu'")
        n_cards = torch.cuda.device_count()
        return Mesh([torch.device("cuda", i % n_cards) for i in range(n)])
    return Mesh([dev] * n)


class ShardedVolume:
    """A volume held as equal leading-axis slabs, slab i on the mesh's
    device i. `shape` may stop short of the slabs' rows (a view of the
    leading rows, as the JAX package's `vol[:n0]` of a padded volume).
    Region reads go through `crop` (also `vol[index]`), which copies only
    the region to the home device."""

    def __init__(self, slabs: Sequence[torch.Tensor], mesh: Mesh,
                 shape: Optional[Tuple[int, int, int]] = None):
        self.slabs = list(slabs)
        self.mesh = mesh
        if len(self.slabs) != mesh.size:
            raise ValueError("one slab per mesh position")
        h = int(self.slabs[0].shape[0])
        if any(tuple(s.shape) != tuple(self.slabs[0].shape)
               for s in self.slabs):
            raise ValueError("slabs must have one shape")
        self.h = h
        full = (h * mesh.size,) + tuple(int(s) for s in
                                        self.slabs[0].shape[1:])
        self.shape = tuple(full if shape is None else shape)

    @property
    def dtype(self):
        return self.slabs[0].dtype

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    def rows(self, n: int) -> "ShardedVolume":
        """The view of the first `n` rows (no copy)."""
        return ShardedVolume(self.slabs, self.mesh,
                             (int(n),) + tuple(self.shape[1:]))

    def like(self, slabs: Sequence[torch.Tensor]) -> "ShardedVolume":
        return ShardedVolume(slabs, self.mesh, self.shape)

    def crop(self, index) -> torch.Tensor:
        """vol[index] for basic indexing (ints and unit-step slices), the
        region gathered from the slabs it meets onto the home device."""
        if not isinstance(index, tuple):
            index = (index,)
        index = index + (slice(None),) * (3 - len(index))
        if len(index) != 3:
            raise IndexError("a sharded volume takes three indices")
        rest = []
        for ax in (1, 2):
            ix = index[ax]
            if isinstance(ix, slice):
                a, b, step = ix.indices(self.shape[ax])
                if step != 1:
                    raise IndexError("unit-step slices only")
                rest.append(slice(a, max(a, b)))
            else:
                rest.append(_norm_int(ix, self.shape[ax]))
        ix0 = index[0]
        if isinstance(ix0, slice):
            a, b, step = ix0.indices(self.shape[0])
            if step != 1:
                raise IndexError("unit-step slices only")
            b = max(a, b)
            pieces = []
            for i, slab in enumerate(self.slabs):
                lo, hi = max(a, i * self.h), min(b, (i + 1) * self.h)
                if lo < hi:
                    pieces.append(slab[(slice(lo - i * self.h,
                                             hi - i * self.h),) + tuple(rest)])
            if not pieces:
                pieces = [self.slabs[0][(slice(0, 0),) + tuple(rest)]]
            pieces = comm.gather_crop(pieces, self.mesh)
            return torch.cat(pieces, dim=0) if len(pieces) > 1 else pieces[0]
        x = _norm_int(ix0, self.shape[0])
        i = x // self.h
        return comm.gather_crop(
            [self.slabs[i][(x - i * self.h,) + tuple(rest)]], self.mesh)[0]

    __getitem__ = crop


def _norm_int(i, n) -> int:
    i = int(i)
    if i < -n or i >= n:
        raise IndexError(f"index {i} out of range for size {n}")
    return i + n if i < 0 else i


def shard_volume(vol, mesh: Mesh) -> ShardedVolume:
    """The volume (array-like or tensor) split along its leading axis into
    one slab per mesh position, each on its device. The leading axis must
    divide evenly over the mesh (the JAX package's sharding requires it
    too). Unsigned 32-bit values are held as their int32 bits."""
    if isinstance(vol, ShardedVolume):
        if vol.mesh.size != mesh.size:
            raise ValueError("volume sharded over another mesh size")
        return vol
    t = as_tensor(vol)
    if t.dtype == torch.uint32:
        t = t.view(torch.int32)
    n = mesh.size
    if t.ndim != 3 or t.shape[0] % n:
        raise ValueError("shard_volume: a 3D volume whose leading axis "
                         "divides evenly over the mesh")
    h = t.shape[0] // n
    return ShardedVolume(
        [t[i * h:(i + 1) * h].to(mesh.devices[i]).contiguous()
         for i in range(n)], mesh)


def _label_slabs(labels: ShardedVolume) -> List[torch.Tensor]:
    """Label slabs as int32 words (equality and != 0 kept)."""
    out = []
    for s in labels.slabs:
        if s.dtype == torch.int32:
            out.append(s)
        elif s.dtype == torch.uint32:
            out.append(s.view(torch.int32))
        else:
            out.append(s.to(torch.int32))
    return out


# --------------------------------------------------------------------------- #
# Ring min-plus parabola pass (the sharded-axis EDT pass)


def _block_envelope(d_blk, l_blk, d_out, l_out, i_glob, j_glob, w,
                    w_blk=None, w_out=None):
    """min(d_out, min over j in the resident block of (g + w^2 (i - j)^2))
    for every local output line position i; g = d_blk[j] where labels
    (and wall segments) match, else 0. d_blk/l_blk: (nb, L); d_out/l_out:
    (ni, L). The lines are taken in chunks of about 2^23 broadcast
    elements."""
    w2 = float(np.float32(w) ** 2)
    diff = (i_glob[:, None].to(torch.float32)
            - j_glob[None, :].to(torch.float32))
    kern = (diff * diff * w2)[:, :, None]  # (ni, nb, 1)
    ni, L = d_out.shape
    nb = d_blk.shape[0]
    chunk = max(1, min(L, (1 << 23) // max(1, ni * nb)))
    out = torch.empty_like(d_out)
    for c0 in range(0, L, chunk):
        c1 = min(L, c0 + chunk)
        same = l_out[:, None, c0:c1] == l_blk[None, :, c0:c1]
        if w_blk is not None:
            same = same & (w_out[:, None, c0:c1] == w_blk[None, :, c0:c1])
        g = torch.where(same, d_blk[None, :, c0:c1], 0.0)
        cand = (g + kern).amin(dim=1)
        out[:, c0:c1] = torch.minimum(d_out[:, c0:c1], cand)
    return out


def _ring_parabola_pass(ds, labs, w: float, black_border: bool,
                        n_total: int, mesh: Mesh, walls=None):
    """Exact parabola pass along the sharded leading axis as a ring: the
    (distances, labels[, wall segments]) blocks rotate one shard per step
    while each shard folds every block into its own lines. ds, labs:
    per-shard (h, n1, n2); walls: per-shard (h, L) GLOBAL wall-segment
    indices or None."""
    n_dev = mesh.size
    shape = tuple(ds[0].shape)
    h = shape[0]
    L = shape[1] * shape[2]
    d2 = [d.reshape(h, L) for d in ds]
    l2 = [lab.reshape(h, L) for lab in labs]
    out = [torch.full_like(d, BIG) for d in d2]
    i_glob = [torch.arange(h, device=d.device) + i * h
              for i, d in enumerate(d2)]
    blk_d, blk_l, blk_w = list(d2), list(l2), walls
    owner = list(range(n_dev))
    for step in range(n_dev):
        for i in range(n_dev):
            j_glob = torch.arange(h, device=d2[i].device) + owner[i] * h
            out[i] = _block_envelope(
                blk_d[i], blk_l[i], out[i], l2[i], i_glob[i], j_glob, w,
                None if walls is None else blk_w[i],
                None if walls is None else walls[i])
        if step + 1 < n_dev:
            blk_d = comm.ring_shift(blk_d, mesh)
            blk_l = comm.ring_shift(blk_l, mesh)
            if walls is not None:
                blk_w = comm.ring_shift(blk_w, mesh)
            owner = [(o - 1) % n_dev for o in owner]
    w2 = float(np.float32(w) ** 2)
    res = []
    for i in range(n_dev):
        o = torch.minimum(out[i], d2[i])  # fold the previous passes
        if black_border:
            ii = i_glob[i].to(torch.float32)
            near = torch.minimum(ii + 1.0, float(n_total) - ii)
            o = torch.minimum(o, (near * near * w2)[:, None])
        res.append(o.reshape(shape))
    return res


def _lines(vol, axis):
    return torch.movedim(vol, axis, 0).reshape(vol.shape[axis], -1)


def _local_passes(lab, vg, anis, black_border: bool):
    """The EDT passes of one slab along its unsharded axes 1 and 2: the
    run-boundary scan first, then a banded parabola pass with the static
    band min(n - 1, 256) (no escalation, as in the JAX package)."""
    d = torch.full(lab.shape, BIG, dtype=torch.float32, device=lab.device)
    first = True
    for axis in (1, 2):
        w = anis[axis]
        n = lab.shape[axis]
        if n == 1:
            if black_border:
                d = torch.clamp(d, max=float(np.float32(w) ** 2))
            continue
        lab_t = _lines(lab, axis)
        wall = (None if vg is None else wall_segments(
            _lines(graph_allows(vg, _AXIS_UNIT[axis]), axis), 0))
        if first:
            out = _axial_pass(lab_t, w, bool(black_border), wall)
            first = False
        else:
            out = _parabola_pass_banded(_lines(d, axis), lab_t, w,
                                        bool(black_border), min(n - 1, 256),
                                        wall)
        moved = list(lab.shape)
        moved.insert(0, moved.pop(axis))
        d = torch.movedim(out.reshape(moved), 0, axis)
        d = torch.where(lab == 0, 0.0, d).contiguous()
    return d


def _global_walls0(vgs, mesh: Mesh):
    """GLOBAL wall-segment indices along the sharded axis 0 per shard: a
    local cumsum of blocked +x edges (the previous shard's last plane
    through one ppermute) plus the totals of the earlier shards (one
    all_gather), so segments match the unsharded cumsum."""
    n = mesh.size
    h = vgs[0].shape[0]
    L = vgs[0].shape[1] * vgs[0].shape[2]
    allow = [graph_allows(v, _AXIS_UNIT[0]).reshape(h, L) for v in vgs]
    prev = comm.ring_shift([a[-1:] for a in allow], mesh)
    prev[0] = torch.ones_like(prev[0])
    local = []
    for i in range(n):
        blocked = torch.cat([~prev[i], ~allow[i][:-1]], dim=0)
        local.append(torch.cumsum(blocked.to(torch.int32), dim=0,
                                  dtype=torch.int32))
    totals = comm.all_gather([x[-1] for x in local], mesh)  # (n, L)
    out = []
    for i in range(n):
        prefix = totals[:i].sum(dim=0, dtype=torch.int32) if i else \
            torch.zeros_like(totals[0])
        out.append(local[i] + prefix.to(local[i].device)[None, :])
    return out


def sharded_edtsq(labels, mesh: Mesh,
                  anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                  black_border: bool = False, voxel_graph=None
                  ) -> ShardedVolume:
    """Multi-label anisotropic squared EDT with the volume sharded over
    the mesh's leading axis: local passes along the unsharded axes, the
    ring min-plus along the sharded one. `voxel_graph`: an optional
    cc3d-convention bitfield sharded like the volume; blocked axis edges
    act as label boundaries (along axis 0 through global wall
    segments)."""
    labels = shard_volume(labels, mesh)
    n0 = labels.h * mesh.size
    anis = tuple(float(a) for a in anisotropy)
    labs = _label_slabs(labels)
    vgs = (None if voxel_graph is None
           else shard_volume(voxel_graph, mesh).slabs)
    ds = [_local_passes(lab, None if vgs is None else vgs[i], anis,
                        bool(black_border)) for i, lab in enumerate(labs)]
    walls = None if vgs is None else _global_walls0(vgs, mesh)
    ds = _ring_parabola_pass(ds, labs, anis[0], bool(black_border), n0, mesh,
                             walls)
    return labels.like([torch.where(lab == 0, 0.0, d)
                        for lab, d in zip(labs, ds)])


def sqrt_f32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root (taken in float64)."""
    return torch.sqrt(x.double()).float()


# --------------------------------------------------------------------------- #
# Halo-exchange directional sweeps (sharded SSSP)


def _axis0_sweep_with_halo(d, halo, ok, nc, anis_perm, node_mode: bool,
                           descending: bool):
    """One axis-0 sweep of a slab (B5) with the neighbour's halo plane as
    the sweep's plane 0, which the kernel passes unchanged: the JAX
    package's relax of the slab's first plane from the halo. `ok`/`nc`
    are the slab's operands extended by one plane on the halo's side."""
    sweep_axis0 = geodesic.sweep_axis0  # B5, as the host trace path calls it
    if halo is None:
        return sweep_axis0(d, ok[1:] if not descending else ok[:-1],
                           None if nc is None else
                           (nc[1:] if not descending else nc[:-1]),
                           anis_perm, node_mode, False, descending)
    if descending:
        ext = torch.cat([d, halo[None]], dim=0)
        return sweep_axis0(ext, ok, nc, anis_perm, node_mode, False,
                           True)[:-1]
    ext = torch.cat([halo[None], d], dim=0)
    return sweep_axis0(ext, ok, nc, anis_perm, node_mode, False, False)[1:]


def sharded_distance_rounds(init_dist, ok_mask, mesh: Mesh,
                            anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
                            node_cost=None, rounds: Optional[int] = None,
                            max_rounds: int = 0) -> ShardedVolume:
    """Six directional plane sweeps per round with halo exchange on the
    sharded axis (kimimaro_tpu.parallel.sharded_distance_rounds): both
    halos are taken before the round's axis-0 sweeps, then axes 1 and 2
    sweep each slab. `rounds=None` iterates to the global fixpoint (a
    psum'd changed flag: no distance anywhere improved), at most
    `max_rounds` rounds (0: sum of the volume's extents + 8); an integer
    runs that many rounds."""
    init = shard_volume(init_dist, mesh)
    ok = shard_volume(ok_mask, mesh)
    oks = [o.to(torch.bool) for o in ok.slabs]
    d = [torch.where(o, x.to(torch.float32), INF)
         for o, x in zip(oks, init.slabs)]
    node_mode = node_cost is not None
    ncs = (None if not node_mode else
           [x.to(torch.float32) for x in shard_volume(node_cost, mesh).slabs])
    anis = tuple(float(a) for a in anisotropy)
    anis0 = (anis[0], anis[1], anis[2])
    n = mesh.size
    views = [_SweptViews(oks[i], None if ncs is None else ncs[i])
             for i in range(n)]
    # the axis-0 operands extended by one plane on each halo side (the
    # extra plane is the sweep's plane 0, whose operands are not read)
    ok_up = [torch.cat([o[:1], o]) for o in oks]
    ok_dn = [torch.cat([o, o[-1:]]) for o in oks]
    nc_up = None if ncs is None else [torch.cat([x[:1], x]) for x in ncs]
    nc_dn = None if ncs is None else [torch.cat([x, x[-1:]]) for x in ncs]

    def one_round(d):
        prev, nxt = comm.halos([x[0] for x in d], [x[-1] for x in d], mesh,
                               INF)
        out = []
        for i in range(n):
            x = _axis0_sweep_with_halo(
                d[i], prev[i] if i > 0 else None, ok_up[i],
                None if nc_up is None else nc_up[i], anis0, node_mode, False)
            x = _axis0_sweep_with_halo(
                x, nxt[i] if i < n - 1 else None, ok_dn[i],
                None if nc_dn is None else nc_dn[i], anis0, node_mode, True)
            for axis in (1, 2):
                for direction in (1, -1):
                    x = _sweep(x, views[i], axis, direction, anis, False)
            out.append(x)
        return out

    if rounds is not None:
        for _ in range(int(rounds)):
            d = one_round(d)
        return init.like(d)
    if max_rounds <= 0:
        max_rounds = int(sum(init.shape)) + 8
    for _ in range(int(max_rounds)):
        new = one_round(d)
        moved = [(a < b).any() for a, b in zip(new, d)]
        d = new
        if not comm.any_changed(moved, mesh):
            break
    return init.like(d)


# --------------------------------------------------------------------------- #
# Sharded connected-components labeling


def _ext(planes_prev, slab, planes_next):
    parts = [p[None] for p in (planes_prev,) if p is not None] + [slab] \
        + [p[None] for p in (planes_next,) if p is not None]
    return torch.cat(parts, dim=0) if len(parts) > 1 else slab


def _local_jump(ids, lo: int):
    """One pointer jump of the ids whose root lies in this slab (global
    linear index + 1 in (lo, lo + size])."""
    flat = ids.reshape(-1)
    size = flat.numel()
    local = (flat > lo) & (flat <= lo + size)
    idx = torch.clamp(flat.long() - 1 - lo, 0, size - 1)
    hop = flat[idx]
    return torch.where(local & (hop > 0), torch.minimum(flat, hop),
                       flat).reshape(ids.shape)


def _stencil_round(ids, labs, vgs, fg, mesh: Mesh):
    """The JAX package's sharded CCL round: a 26-neighbour min over the
    slab extended by its halo planes, then two local pointer jumps."""
    n = mesh.size
    prev_i, next_i = comm.halos([x[:1] for x in ids], [x[-1:] for x in ids],
                                mesh, 0)
    prev_l, next_l = comm.halos([x[:1] for x in labs],
                                [x[-1:] for x in labs], mesh, 0)
    if vgs is not None:
        prev_g, next_g = comm.halos([x[:1] for x in vgs],
                                    [x[-1:] for x in vgs], mesh, 0)
    out = []
    for i in range(n):
        size = ids[i].numel()
        ids_ext = torch.cat([prev_i[i], ids[i], next_i[i]])
        lab_ext = torch.cat([prev_l[i], labs[i], next_l[i]])
        best = ids[i]
        for off in OFFSETS26:
            nb_ids = shifted(ids_ext, off, 0)[1:-1]
            nb_lab = shifted(lab_ext, off, 0)[1:-1]
            okn = fg[i] & (nb_lab == labs[i]) & (nb_ids > 0) & (nb_ids < best)
            if vgs is not None:
                vg_ext = torch.cat([prev_g[i], vgs[i], next_g[i]])
                neg = tuple(-c for c in off)
                okn = okn & shifted(graph_allows(vg_ext, neg), off,
                                    False)[1:-1]
            best = torch.where(okn, nb_ids, best)
        lo = i * size
        out.append(_local_jump(_local_jump(best, lo), lo))
    return out


def sharded_ccl_rounds(labels, mesh: Mesh, rounds: Optional[int] = None,
                       max_rounds: int = 0, voxel_graph=None
                       ) -> ShardedVolume:
    """26-connected multi-label CCL of a sharded volume: int32 ids, each
    the minimum global linear index + 1 over the voxels that reach it
    (0 on background). `rounds=None` iterates to the global fixpoint (at
    most `max_rounds`, 0: sum of extents + 8): per round each slab,
    extended by its halo planes, takes one round of B1's minid sweeps
    (B1-vg on G1's CCL gate under a voxel graph) and local pointer jumps.
    An integer `rounds` runs that many of the JAX package's stencil
    rounds instead, giving its values at any count."""
    labels = shard_volume(labels, mesh)
    labs = _label_slabs(labels)
    vgs = (None if voxel_graph is None else
           [graph_word(v) for v in shard_volume(voxel_graph, mesh).slabs])
    n = mesh.size
    size = labs[0].numel()
    fg = [lab != 0 for lab in labs]
    lin = [torch.arange(1, size + 1, dtype=torch.int32,
                        device=lab.device).reshape(lab.shape) + i * size
           for i, lab in enumerate(labs)]
    if rounds is not None:
        ids = [torch.where(f, x, 0) for f, x in zip(fg, lin)]
        for _ in range(int(rounds)):
            ids = _stencil_round(ids, labs, vgs, fg, mesh)
        return labels.like(ids)

    if max_rounds <= 0:
        max_rounds = int(sum(labels.shape)) + 8
    # the static operands of each slab's extended sweeps: the labels, or
    # under a graph G1's CCL gate of the extended labels and graph (halo
    # planes carry their own labels; the ids are what cross halos)
    prev_l, next_l = comm.halos([x[0] for x in labs], [x[-1] for x in labs],
                                mesh, 0)
    if vgs is not None:
        prev_g, next_g = comm.halos([x[0] for x in vgs],
                                    [x[-1] for x in vgs], mesh, 0)
    lab_v, gate_v, top = [], [], []
    for i in range(n):
        p = prev_l[i] if i > 0 else None
        q = next_l[i] if i < n - 1 else None
        lab = _ext(p, labs[i], q)
        top.append(0 if p is None else 1)
        if vgs is None:
            lab_v.append(gsweep.MaskViews(lab))
            gate_v.append(None)
        else:
            g = _ext(prev_g[i] if i > 0 else None, vgs[i],
                     next_g[i] if i < n - 1 else None)
            lab_v.append(None)
            gate_v.append(gsweep.MaskViews(graph_into(g, lab)))
    ids = [torch.where(f, x, BIGID) for f, x in zip(fg, lin)]
    anis = (1.0, 1.0, 1.0)
    for _ in range(int(max_rounds)):
        prev, nxt = comm.halos([x[0] for x in ids], [x[-1] for x in ids],
                               mesh, BIGID)
        new = []
        for i in range(n):
            ext = _ext(prev[i] if i > 0 else None, ids[i],
                       nxt[i] if i < n - 1 else None)
            ext = gsweep.one_round(ext, lab_v[i], None, None, anis, "minid",
                                   False, gate_v[i])
            x = ext[top[i]:top[i] + labels.h]
            x = torch.where(x == BIGID, 0, x)
            x = _local_jump(x, i * size)
            new.append(torch.where(fg[i], x, BIGID))
        moved = [(a != b).any() for a, b in zip(new, ids)]
        ids = new
        if not comm.any_changed(moved, mesh):
            break
    return labels.like([torch.where(f, x, 0) for f, x in zip(fg, ids)])


# --------------------------------------------------------------------------- #
# The sharded preamble step


def sharded_argmax(vol: ShardedVolume) -> int:
    """The global flat index of the first maximum of a sharded field."""
    n = vol.mesh.size
    size = vol.slabs[0].numel()
    vals = [s.reshape(-1).max() for s in vol.slabs]
    gval = comm.pmax([v.reshape(1) for v in vals], vol.mesh)
    flats = []
    for i, s in enumerate(vol.slabs):
        flat = s.reshape(-1)
        k = torch.argmax(flat)
        hit = flat[k] == gval.to(flat.device)[0]
        flats.append(torch.where(hit, k + i * size,
                                 torch.iinfo(torch.int64).max).reshape(1))
    return int(comm.fetch(comm.pmin(flats, vol.mesh))[0])


def preamble_step(labels, mesh: Mesh,
                  anisotropy: Tuple[float, float, float] = (1.0, 1.0, 1.0),
                  pdrf_scale: float = 100000.0, pdrf_exponent: int = 4,
                  sweep_rounds: Optional[int] = None,
                  ccl_rounds: Optional[int] = None) -> dict:
    """One full sharded preamble pass (kimimaro_tpu.parallel.preamble_step):
    multi-label EDT (the ring pass) -> PDRF penalty field -> CCL ->
    distance sweeps from the global DBF argmax (None: to the fixpoint;
    integers run fixed counts). Returns {"dbf", "pdrf", "cc", "daf"} as
    sharded volumes."""
    labels = shard_volume(labels, mesh)
    dsq = sharded_edtsq(labels, mesh, anisotropy, black_border=False)
    dbf = dsq.like([sqrt_f32(x) for x in dsq.slabs])
    dbf_max = comm.pmax([x.max().reshape(1) for x in dbf.slabs], mesh)
    dbf_max = torch.clamp(dbf_max, min=float(np.float32(1e-6)))
    m = torch.reciprocal(pow_1_01(dbf_max))
    pdrf = []
    for x in dbf.slabs:
        p = 1.0 - torch.where(x == 0, INF, x) * m.to(x.device)
        e = int(pdrf_exponent)
        while e > 1:  # powers of two
            p = p * p
            e >>= 1
        pdrf.append(p * float(np.float32(pdrf_scale)))
    cc = sharded_ccl_rounds(labels, mesh, rounds=ccl_rounds)
    flat_idx = sharded_argmax(dbf)
    size = labels.slabs[0].numel()
    init = []
    for i, lab in enumerate(labels.slabs):
        d0 = torch.full(lab.shape, INF, dtype=torch.float32,
                        device=lab.device)
        if i * size <= flat_idx < (i + 1) * size:
            d0.view(-1)[flat_idx - i * size] = 0.0
        init.append(d0)
    daf = sharded_distance_rounds(
        labels.like(init), labels.like([lab != 0 for lab in labels.slabs]),
        mesh, anisotropy, rounds=sweep_rounds)
    return {"dbf": dbf, "pdrf": dbf.like(pdrf), "cc": cc, "daf": daf}
