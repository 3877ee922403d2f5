"""Sharded global trace engine: the global engine's lock-step TEASAR loop
over a mesh's slabs.

Torch counterpart of kimimaro_tpu.parallel.gengine. The volume stays
sharded for the whole trace, and every phase exchanges only planes,
per-lane scalars or path voxels between the shards:

  * cc-masked directional sweeps (kernel B1 on each slab, the
    neighbour's halo plane as the sweep's plane 0, which B1 passes
    unchanged) iterate to a psum'd global fixpoint: exact distances, so
    nothing is tainted for want of convergence. These relaxes are
    monotone min-plus (or max-plus) iterations, whose fixpoint does not
    depend on the order of the sweeps;
  * per-label argmaxes run B3 on each slab with each label's box cut to
    the slab, combined by a pmax of the value and a pmin of the global
    flat index among the maxima (the single-device first maximum);
  * the path chase walks all lanes in lock step: each step the shard
    owning a lane's voxel contributes its descent byte through a psum;
  * ball seeds, rail zeros and radii touch only the path voxels each
    shard owns.

Semantics are the JAX package's sharded engine's: its eligibility split,
its PDRF (computed in the setup from per-voxel label maxima), its
iteration budget (K_ITER x 16 lock-step iterations, the lanes still
active then keep the paths they have) and no non-convergence taint.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..engine import _paths_structurally_valid
from ..gengine import (K_ITER, T_CAP, _descent_code, _lane_bucket,
                       _tier_crops)
from ..ops import gsweep
from ..ops.crop_argmax import crop_argmax
from ..ops.fma import fma_f32
from ..trace import integer_pow, pow_1_01
from ..utils import profiling
from . import comm
from .comm import Mesh
from .sharded import ShardedVolume

INF = float("inf")
NEG_INF = float("-inf")
MAX_SEGS = 16  # the JAX package's path-buffer segments (KIMIMARO_TPU_GENGINE_SEGS)
_CHASE_CHECK = 16
_BIG_FLAT = 2**62


# --------------------------------------------------------------------------- #
# cc-masked sharded sweeps


class _Operand:
    """A static per-relax operand (cc ids or node costs) of every slab in
    the layouts its sweeps read: the x layout extended by the halo plane
    of each side (`up`: the previous shard's last plane first, `dn`: the
    next shard's first plane last; none at the mesh's ends) and the y and
    z layouts of the slab itself."""

    __slots__ = ("up", "dn", "views")

    def __init__(self, slabs: List[torch.Tensor], mesh: Mesh, fill,
                 halo: bool = True):
        n = mesh.size
        if halo:
            prev, nxt = comm.halos([s[0] for s in slabs],
                                   [s[-1] for s in slabs], mesh, fill)
        else:  # node costs: the halo plane's costs are never read
            prev = [s[0] for s in slabs]
            nxt = [s[-1] for s in slabs]
        self.up = [slabs[i] if i == 0 else torch.cat([prev[i][None],
                                                      slabs[i]])
                   for i in range(n)]
        self.dn = [slabs[i] if i == n - 1 else torch.cat([slabs[i],
                                                          nxt[i][None]])
                   for i in range(n)]
        self.views = [gsweep.MaskViews(s) for s in slabs]


def _yz_sweeps(x, cc_v, nc_v, anis, mode, clamp):
    """The +-y and +-z sweeps of one slab (B1 on the rotated layouts)."""
    ax, ay, az = anis
    x = gsweep._permute(x, gsweep._PERM_TO_Y)
    for desc in (False, True):
        x = gsweep.sweep0(x, cc_v.y, None if nc_v is None else nc_v.y, None,
                          (ay, ax, az), mode, clamp, desc)
    x = gsweep._permute(x, gsweep._PERM_Y_TO_Z)
    for desc in (False, True):
        x = gsweep.sweep0(x, cc_v.z, None if nc_v is None else nc_v.z, None,
                          (az, ax, ay), mode, clamp, desc)
    return gsweep._permute(x, gsweep._PERM_Z_TO_X)


def _one_round_cc(d, cc: _Operand, nc: Optional[_Operand], anis, mode,
                  clamp, mesh: Mesh):
    """One +-x/+-y/+-z round with sharded-axis halos: the ascending x
    sweep from the previous shard's last plane, the descending one from
    the next shard's first plane after ITS ascending sweep."""
    n = mesh.size
    fill = NEG_INF if mode == "maxflood" else INF
    anis0 = tuple(float(a) for a in anis)
    prev, _ = comm.halos([x[0] for x in d], [x[-1] for x in d], mesh, fill)
    up = []
    for i in range(n):
        ext = d[i] if i == 0 else torch.cat([prev[i][None], d[i]])
        out = gsweep.sweep0(ext, cc.up[i], None if nc is None else nc.up[i],
                            None, anis0, mode, clamp, False)
        up.append(out if i == 0 else out[1:])
    _, nxt = comm.halos([x[0] for x in up], [x[-1] for x in up], mesh, fill)
    res = []
    for i in range(n):
        ext = up[i] if i == n - 1 else torch.cat([up[i], nxt[i][None]])
        out = gsweep.sweep0(ext, cc.dn[i], None if nc is None else nc.dn[i],
                            None, anis0, mode, clamp, True)
        out = out if i == n - 1 else out[:-1]
        res.append(_yz_sweeps(out, cc.views[i],
                              None if nc is None else nc.views[i], anis0,
                              mode, clamp))
    return res


def _relax_fixpoint_cc(d, cc: _Operand, nc: Optional[_Operand], anis, mode,
                       clamp, mesh: Mesh, max_rounds: int):
    """Rounds until no shard changes a value (a psum'd flag), at most
    `max_rounds`: the exact fixpoint for every label at once."""
    for _ in range(int(max_rounds)):
        new = _one_round_cc(d, cc, nc, anis, mode, clamp, mesh)
        profiling.count("sharded_relax_rounds")
        moved = [(a != b).any() for a, b in zip(new, d)]
        d = new
        if not comm.any_changed(moved, mesh):
            break
    return d


# --------------------------------------------------------------------------- #
# per-label argmax over the slabs


def _slab_argmax(packed, cc, offs, crops, boxes, lids, mesh: Mesh, h: int,
                 HW: Tuple[int, int]):
    """Per-label first maximum of a sharded field: B3 on each slab, each
    lane's window cut into the slab and its box (the label's bbox, or
    size 0 for a lane with nothing to scan) cut to the slab's rows, then
    pmax of the value and pmin of the global flat index among the
    maxima. Host arrays offs, crops, box origins and sizes (N, 3) global.
    Returns (values (N,), flat (N,) int64) on the home device."""
    H, W = HW
    box_off, box_size = boxes
    vals, flats = [], []
    for i, (f, c) in enumerate(zip(packed, cc)):
        base = i * h
        c0 = np.minimum(crops[:, 0], h)
        ls0 = np.clip(offs[:, 0] - base, 0, h - c0)
        w_off = np.stack([ls0, offs[:, 1], offs[:, 2]], axis=1)
        w_crop = np.stack([c0, crops[:, 1], crops[:, 2]], axis=1)
        lo = np.maximum(box_off[:, 0], base)
        hi = np.minimum(box_off[:, 0] + box_size[:, 0], base + h)
        has = (hi > lo) & (box_size > 0).all(axis=1)
        b_off = np.where(has[:, None], np.stack(
            [lo - base, box_off[:, 1], box_off[:, 2]], axis=1), w_off)
        b_size = np.where(has[:, None], np.stack(
            [hi - lo, box_size[:, 1], box_size[:, 2]], axis=1), 0)

        def t(a):
            return torch.as_tensor(a.astype(np.int32), device=f.device)

        coords, v = crop_argmax(f, c, t(w_off), lids.to(f.device), t(w_crop),
                                (t(b_off), t(b_size)))
        coords = coords.long()
        flats.append((coords[:, 0] + base) * (H * W) + coords[:, 1] * W
                     + coords[:, 2])
        vals.append(v)
    gval = comm.pmax(vals, mesh)
    cand = [torch.where((v.to(gval.device) == gval) & (gval > NEG_INF),
                        fl.to(gval.device), _BIG_FLAT)
            for v, fl in zip(vals, flats)]
    return gval, comm.pmin(cand, mesh)


def _unflatten(flat, H: int, W: int):
    x = flat // (H * W)
    r = flat - x * (H * W)
    return torch.stack([x, r // W, r % W], dim=-1)


# --------------------------------------------------------------------------- #
# descent code + ownership-migrated chase


def _descent_code_slab(d_rail, cc, mesh: Mesh):
    """Per-voxel descent bytes of each slab (the global engine's
    `_descent_code`) with one halo plane of (d, cc) on each side."""
    dp, dn = comm.halos([x[0] for x in d_rail], [x[-1] for x in d_rail],
                        mesh, INF)
    cp, cn = comm.halos([x[0] for x in cc], [x[-1] for x in cc], mesh, -1)
    out = []
    for i in range(mesh.size):
        ext_d = torch.cat([dp[i][None], d_rail[i], dn[i][None]])
        ext_c = torch.cat([cp[i][None], cc[i], cn[i][None]])
        out.append(_descent_code(ext_d, ext_c)[1:-1].reshape(-1))
    return out


def _chase_sharded(codes, starts_flat, L: int, slab: int, total: int,
                   HW: Tuple[int, int], active, mesh: Mesh):
    """Lock-step walk of all active lanes over the sharded descent codes:
    each step the shard owning a lane's voxel contributes its byte
    through a psum. Matches the global engine's `_chase_codes` row for
    row. Returns (path (N, L) int64 global flats, -1 padded; plen;
    reached)."""
    H, W = HW
    home = mesh.home
    deltas = torch.tensor(
        [dx * (H * W) + dy * W + dz
         for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        dtype=torch.int64, device=home)
    cur = starts_flat.clone()
    N = cur.shape[0]
    path = torch.full((N, L), -1, dtype=torch.int64, device=home)
    plen = torch.zeros(N, dtype=torch.int64, device=home)
    done = ~active
    for t in range(L):
        act = ~done
        path[:, t] = torch.where(act, cur, -1)
        parts = []
        for i, code in enumerate(codes):
            c = cur.to(code.device)
            local = c - i * slab
            owned = (local >= 0) & (local < slab)
            b = code[torch.clamp(local, 0, slab - 1)]
            parts.append(torch.where(owned, b.to(torch.int32), 0))
        byte = comm.psum(parts, mesh)
        at_rail = (byte & 1) == 1
        nxt = torch.clamp(cur + deltas[(byte >> 1).long()], 0, total - 1)
        cur = torch.where(act & ~at_rail, nxt, cur)
        plen = plen + act.to(torch.int64)
        done = done | at_rail
        if t % _CHASE_CHECK == _CHASE_CHECK - 1 and bool(done.all()):
            break
    return path, plen, done


# --------------------------------------------------------------------------- #
# scatter/gather of per-lane points and path voxels


def _scatter_points(pts_flat, vals, shape, slab: int, mesh: Mesh):
    """Per slab: a +inf volume with vals scatter-min'd at the global flat
    indices the slab owns."""
    out = []
    for i, dev in enumerate(mesh.devices):
        p = pts_flat.to(dev)
        local = p - i * slab
        owned = (local >= 0) & (local < slab)
        vol = torch.full(shape, INF, dtype=torch.float32, device=dev)
        vol.view(-1).scatter_reduce_(0, local[owned], vals.to(dev)[owned],
                                     "amin")
        out.append(vol)
    return out


def _gather_path_vals(vol, sel, slab: int, mesh: Mesh):
    """vol's values at the global flat indices `sel`, each read from the
    shard that owns it and psum-combined."""
    parts = []
    for i, v in enumerate(vol):
        s = sel.to(v.device)
        local = s - i * slab
        owned = (local >= 0) & (local < slab)
        g = v.reshape(-1)[torch.clamp(local, 0, slab - 1)]
        parts.append(torch.where(owned, g, 0.0))
    return comm.psum(parts, mesh)


def _owned(sel, i: int, slab: int, dev):
    s = sel.to(dev)
    local = s - i * slab
    owned = (local >= 0) & (local < slab)
    return local[owned], owned


def first_voxels_sharded(cc: ShardedVolume, n_ids: int) -> torch.Tensor:
    """Per compact id 0..n_ids-1 the minimum global flat index of its
    voxels (the voxel count where absent): a scatter-min per slab and a
    pmin."""
    total = cc.h * cc.mesh.size * int(np.prod(cc.slabs[0].shape[1:]))
    parts = []
    for i, s in enumerate(cc.slabs):
        flat = s.reshape(-1).long()
        n = flat.numel()
        out = torch.full((n_ids,), total, dtype=torch.int64, device=s.device)
        keep = (flat < n_ids)
        idx = torch.arange(n, device=s.device) + i * n
        parts.append(out.scatter_reduce_(0, flat[keep], idx[keep], "amin"))
    return comm.pmin(parts, cc.mesh)


# --------------------------------------------------------------------------- #
# setup and iteration


def _setup(cc_i, dbf, firstvox_flat, roots_in, has_root, live, offs, crops,
           boxes, lids_d, anis, pdrf_scale, pdrf_exponent, max_rounds,
           mesh: Mesh, h: int, HW):
    """The setup fields (root probe, roots, DAF, PDRF, rail) on the slabs.
    Returns (daf, pdrf, d_rail, roots (N, 3) int64 home)."""
    H, W = HW
    slab = h * H * W
    shape = tuple(cc_i[0].shape)
    fg = [c > 0 for c in cc_i]
    cc_eff = _Operand([torch.where(f, c, -1) for f, c in zip(fg, cc_i)],
                      mesh, -1)
    src0 = torch.where(live, 0.0, INF).to(torch.float32)

    # root probe from each label's first voxel
    d0 = _scatter_points(firstvox_flat, src0, shape, slab, mesh)
    probe = _relax_fixpoint_cc(d0, cc_eff, None, anis, "euclid", False, mesh,
                               max_rounds)
    packed = [torch.where(torch.isfinite(p), p, NEG_INF) for p in probe]
    del probe
    _, aflat = _slab_argmax(packed, cc_i, offs, crops, boxes, lids_d, mesh,
                            h, HW)
    roots = torch.where(has_root[:, None], roots_in,
                        _unflatten(aflat, H, W))
    roots_flat = roots[:, 0] * (H * W) + roots[:, 1] * W + roots[:, 2]

    # DAF
    d0 = _scatter_points(roots_flat, src0, shape, slab, mesh)
    daf = _relax_fixpoint_cc(d0, cc_eff, None, anis, "euclid", False, mesh,
                             max_rounds)
    daf = [torch.where(torch.isfinite(x), x, 0.0) for x in daf]

    # per-label broadcasts (max dbf^1.01, max DAF) as maxfloods
    dbfp = [torch.where(f, pow_1_01(x), NEG_INF) for f, x in zip(fg, dbf)]
    m_fl = _relax_fixpoint_cc(dbfp, cc_eff, None, anis, "maxflood", False,
                              mesh, max_rounds)
    d_fl = _relax_fixpoint_cc([torch.where(f, x, NEG_INF)
                               for f, x in zip(fg, daf)], cc_eff, None, anis,
                              "maxflood", False, mesh, max_rounds)

    # PDRF
    root_zero = _scatter_points(roots_flat, src0, shape, slab, mesh)
    pdrf = []
    for f, x, a, m, dm, rz in zip(fg, dbf, daf, m_fl, d_fl, root_zero):
        m_vol = torch.where(f, torch.reciprocal(torch.clamp(m, min=1e-30)),
                            0.0)
        imd_vol = torch.where(dm > 0,
                              torch.reciprocal(torch.clamp(dm, min=1e-30)),
                              0.0)
        pdrf.append(torch.minimum(torch.where(
            f, pdrf_field(torch.where(x == 0, INF, x), a, m_vol, imd_vol,
                          pdrf_scale, pdrf_exponent), INF), rz))
    del m_fl, d_fl
    d_rail = _relax_fixpoint_cc(root_zero, cc_eff, _Operand(pdrf, mesh, 0.0,
                                                            halo=False),
                                anis, "node", False, mesh, max_rounds)
    return daf, pdrf, d_rail, roots


def pdrf_field(dbf_inf, daf, m_vol, imd_vol, pdrf_scale,
               pdrf_exponent: int):
    """The sharded engine's PDRF from its per-voxel label terms:
    (1 - dbf*m)^exponent * pdrf_scale + daf*imd, with the multiply-adds
    fused where XLA fuses them in the JAX package's jitted setup."""
    p = fma_f32(dbf_inf, m_vol, 1.0, negate=True)
    e = int(pdrf_exponent)
    p = integer_pow(p, e) if e > 0 else torch.ones_like(p)
    return fma_f32(daf, imd_vol, p * float(np.float32(pdrf_scale)))


def trace_global_sharded(
    cc_dev: ShardedVolume,
    dbf_dev: ShardedVolume,
    jobs: List[dict],
    teasar_params: dict,
    anisotropy: Sequence[float],
    fix_branching: bool,
    mesh: Mesh,
    progress: bool = False,
    firstvox_arr: Optional[np.ndarray] = None,
) -> Tuple[Dict[int, List[Tuple[np.ndarray, np.ndarray]]], List[dict]]:
    """The sharded form of gengine.trace_global: same job contract, same
    eligibility split; leftover jobs go to the crop engine. cc_dev and
    dbf_dev are sharded volumes (compact int32 ids, float32 DBF);
    firstvox_arr: (n_ids, 3) each component's first voxel, or None to
    find them on the slabs. Returns ({segid: [(verts, radii), ...]},
    leftover_jobs)."""
    p = dict(teasar_params)
    scale = float(np.float32(p.get("scale", 10)))
    const = float(np.float32(p.get("const", 10)))
    pdrf_scale = float(p.get("pdrf_scale", 5000))
    pdrf_exponent = int(p.get("pdrf_exponent", 16))
    sdt = float(p.get("soma_detection_threshold", 1100))
    sat = float(p.get("soma_acceptance_threshold", 4000))
    max_paths = p.get("max_paths", None)
    anis = tuple(float(a) for a in anisotropy)
    soma_cut = min(sdt, sat)
    n_dev = mesh.size
    home = mesh.home

    vol_shape = tuple(int(s) for s in cc_dev.shape)
    H, W = vol_shape[1], vol_shape[2]
    h = cc_dev.h
    if h * n_dev != vol_shape[0]:
        raise ValueError("trace_global_sharded: the volume's rows must be "
                         "its slabs' rows")

    eligible: List[dict] = []
    leftover: List[dict] = []
    for job in jobs:
        dmx = job.get("dbfmax")
        soma_possible = (dmx is None) or (float(dmx) > soma_cut)
        n_b, n_a = len(job["before"]), len(job["after"])
        blocked = (max_paths is not None) and (n_b + n_a) >= int(max_paths)
        if soma_possible or n_b > T_CAP or n_a > T_CAP or blocked:
            leftover.append(job)
        else:
            eligible.append(job)

    tiers = _tier_crops(vol_shape)
    crop_max = tiers[-1]

    def fits(job, crop):
        return all(int(s) <= c for s, c in zip(job["shape"], crop))

    leftover.extend(j for j in eligible if not fits(j, crop_max))
    eligible = [j for j in eligible if fits(j, crop_max)]
    if len(eligible) < 2:
        return {}, leftover + eligible

    by_tier: List[List[dict]] = [[] for _ in tiers]
    for j in eligible:
        for t, c in enumerate(tiers):
            if fits(j, c):
                by_tier[t].append(j)
                break
    groups = []
    lane_jobs: List[Optional[dict]] = []
    for t, c in enumerate(tiers):
        b = _lane_bucket(len(by_tier[t]))
        start = len(lane_jobs)
        lane_jobs.extend(by_tier[t])
        lane_jobs.extend([None] * (b - len(by_tier[t])))
        groups.append((start, start + b, c))

    N = len(lane_jobs)
    live = np.array([j is not None for j in lane_jobs])
    L = max(2 * sum(crop_max), 64)
    max_rounds = int(sum(vol_shape)) + 8

    lids = np.zeros(N, dtype=np.int32)
    offs = np.zeros((N, 3), dtype=np.int64)
    roots_in = np.zeros((N, 3), dtype=np.int64)
    has_root = np.zeros(N, dtype=bool)
    before_stack = np.zeros((N, T_CAP, 3), dtype=np.int64)
    nb0 = np.zeros(N, dtype=np.int64)
    after_stack = np.zeros((N, T_CAP, 3), dtype=np.int64)
    na0 = np.zeros(N, dtype=np.int64)
    max_paths_arr = np.full(N, 1 << 30, dtype=np.int64)
    job_off = np.zeros((N, 3), dtype=np.int64)
    box_size = np.zeros((N, 3), dtype=np.int64)
    crop_of = np.empty((N, 3), dtype=np.int64)
    for (a, b, c) in groups:
        crop_of[a:b] = np.asarray(c)
    for i, job in enumerate(lane_jobs):
        if job is None:
            continue
        lids[i] = job["segid"]
        mn = np.asarray(job["offset"], dtype=np.int64)
        job_off[i] = mn
        box_size[i] = np.asarray(job["shape"], dtype=np.int64)
        offs[i] = np.maximum(np.minimum(mn, np.asarray(vol_shape)
                                        - crop_of[i]), 0)
        for t_i, t in enumerate(job["before"]):
            before_stack[i, t_i] = np.asarray(t, dtype=np.int64) + mn
        nb0[i] = len(job["before"])
        for t_i, t in enumerate(job["after"]):
            after_stack[i, t_i] = np.asarray(t, dtype=np.int64) + mn
        na0[i] = len(job["after"])
        if job.get("root") is not None:
            roots_in[i] = np.asarray(job["root"], dtype=np.int64) + mn
            has_root[i] = True
        if max_paths is not None:
            max_paths_arr[i] = int(max_paths)

    n_voxels = int(np.prod(vol_shape))
    if firstvox_arr is None:
        flat_first = comm.fetch(first_voxels_sharded(
            cc_dev, int(np.max(lids)) + 1))
        fv_flat = np.minimum(flat_first[lids], n_voxels - 1)
    else:
        fv_flat = np.ravel_multi_index(tuple(firstvox_arr[lids].T),
                                       vol_shape)
    fv_flat = np.where(live, fv_flat, 0).astype(np.int64)

    def dev(a):
        return torch.as_tensor(a, device=home)

    cc_i = [s.to(torch.int32) for s in cc_dev.slabs]
    dbf = [s.to(torch.float32) for s in dbf_dev.slabs]
    lids_d, live_d = dev(lids), dev(live)
    slab = h * H * W
    boxes = (job_off, box_size)
    dead = np.zeros_like(box_size)

    with profiling.phase("sharded_gengine_setup", home):
        daf, pdrf, d_rail, roots = _setup(
            cc_i, dbf, dev(fv_flat), dev(roots_in), dev(has_root), live_d,
            offs, crop_of, boxes, lids_d, anis, pdrf_scale, pdrf_exponent,
            max_rounds, mesh, h, (H, W))

    cc_eff = _Operand([torch.where(c > 0, c, -1) for c in cc_i], mesh, -1)
    valid = [(c > 0).to(torch.uint8) for c in cc_i]
    nb, na = dev(nb0), dev(na0)
    done = dev(~live)
    before_d, after_d, mp_d = dev(before_stack), dev(after_stack), \
        dev(max_paths_arr)
    lanes = torch.arange(N, device=home)

    per_lane: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    t_overflow = np.zeros(N, dtype=bool)
    it = 0
    with profiling.phase("sharded_gengine_loop", home):
        for it in range(K_ITER * MAX_SEGS):
            # --- target selection (done lanes scan nothing)
            packed = [torch.where(v != 0, a, NEG_INF)
                      for v, a in zip(valid, daf)]
            done_h = comm.fetch(done)
            am_val, am_flat = _slab_argmax(
                packed, cc_i, offs, crop_of,
                (job_off, np.where(done_h[:, None], dead, box_size)),
                lids_d, mesh, h, (H, W))
            del packed
            auto_t = _unflatten(am_flat, H, W)
            has_valid = am_val > NEG_INF
            use_before = nb > 0
            use_after = (~use_before) & (~has_valid) & (na > 0)
            bt = before_d[lanes, torch.clamp(nb - 1, min=0)]
            at = after_d[lanes, torch.clamp(na - 1, min=0)]
            target = torch.where(use_before[:, None], bt,
                                 torch.where(use_after[:, None], at, auto_t))
            work = has_valid | (nb > 0) | (na > 0)
            active = work & (~done) & (it < mp_d)
            nb = torch.where(active & use_before, nb - 1, nb)
            na = torch.where(active & use_after, na - 1, na)
            start = torch.where(active[:, None], target, roots)
            start_flat = start[:, 0] * (H * W) + start[:, 1] * W + start[:, 2]

            # --- chase on the shared rail field
            codes = _descent_code_slab(d_rail, cc_i, mesh)
            path, plen, reached = _chase_sharded(
                codes, start_flat, L, slab, slab * n_dev, (H, W), active,
                mesh)
            del codes
            overflow = active & (~reached)
            plen = torch.where(active, plen, 0)
            pmask = ((torch.arange(L, device=home)[None, :] < plen[:, None])
                     & active[:, None])
            sel = path[pmask]

            # --- rolling-ball invalidation
            dsel = _gather_path_vals(dbf, sel, slab, mesh)
            radii = ball_radii(dsel, scale, const)
            ball0, ok_cc = [], []
            for i, d_dev in enumerate(mesh.devices):
                local, owned = _owned(sel, i, slab, d_dev)
                b0 = torch.full(tuple(cc_i[i].shape), INF,
                                dtype=torch.float32, device=d_dev)
                b0.view(-1).scatter_reduce_(0, local,
                                            -radii.to(d_dev)[owned], "amin")
                ball0.append(b0)
                ok = valid[i].clone()
                ok.view(-1)[local] = 1
                ok_cc.append(torch.where((cc_i[i] > 0) & (ok != 0), cc_i[i],
                                         -1))
            ball_d = _relax_fixpoint_cc(ball0, _Operand(ok_cc, mesh, -1),
                                        None, anis, "euclid", True, mesh,
                                        max_rounds)
            del ball0, ok_cc
            valid = [torch.where(b <= 0.0, 0, v).to(torch.uint8)
                     for b, v in zip(ball_d, valid)]
            del ball_d

            # --- new rails
            if fix_branching:
                for i, d_dev in enumerate(mesh.devices):
                    local, _ = _owned(sel, i, slab, d_dev)
                    z = torch.zeros(local.shape, dtype=torch.float32,
                                    device=d_dev)
                    pdrf[i] = pdrf[i].clone()
                    pdrf[i].view(-1).scatter_reduce_(0, local, z, "amin")
                    d_rail[i] = d_rail[i].clone()
                    d_rail[i].view(-1).scatter_reduce_(0, local, z, "amin")
                d_rail = _relax_fixpoint_cc(
                    d_rail, cc_eff, _Operand(pdrf, mesh, 0.0, halo=False),
                    anis, "node", False, mesh, max_rounds)

            done = done | (~work) | overflow
            n_act = int(comm.fetch(active.sum()))
            if n_act == 0:
                break
            # --- the iteration's paths to the host
            act_h = comm.fetch(active) & live
            plen_h = comm.fetch(plen)
            t_overflow |= comm.fetch(overflow) & live
            rows = np.nonzero(act_h & (plen_h > 0))[0]
            if len(rows):
                ln_max = int(plen_h[rows].max())
                path_h = comm.fetch(path[dev(rows), :ln_max])
                dvals = torch.zeros((N, L), dtype=torch.float32, device=home)
                dvals[pmask] = dsel
                dvals_h = comm.fetch(dvals[dev(rows), :ln_max])
                for r, lane in enumerate(rows):
                    ln = int(plen_h[lane])
                    verts = np.stack(np.unravel_index(path_h[r, :ln],
                                                      vol_shape), axis=-1)
                    per_lane.setdefault(int(lane), []).append(
                        ((verts[::-1] - job_off[lane]).astype(np.int64),
                         dvals_h[r, :ln][::-1].astype(np.float32)))
    profiling.count("sharded_gengine_iterations", it + 1)

    tainted = t_overflow.copy()
    results: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    for lane, paths in per_lane.items():
        if tainted[lane] or lane_jobs[lane] is None:
            continue
        if not _paths_structurally_valid(paths):
            tainted[lane] = True
            continue
        results[int(lids[lane])] = paths
    for n_i in np.nonzero(tainted)[0]:
        if lane_jobs[n_i] is None:
            continue
        results.pop(int(lids[n_i]), None)
        leftover.append(lane_jobs[n_i])
    profiling.count("sharded_gengine_jobs", len(results))
    profiling.count("sharded_gengine_fallback", int((tainted & live).sum()))
    return results, leftover


def ball_radii(dvals, scale: float, const: float):
    """Invalidation radii scale*DBF + const at the path voxels, fused as
    XLA fuses them in the JAX package's jitted iteration."""
    return fma_f32(dvals, scale, const)
