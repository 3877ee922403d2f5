"""Multi-device end-to-end skeletonization.

Torch counterpart of kimimaro_tpu.parallel.skeletonize. `skeletonize_sharded`
runs the whole pipeline with the volume held as leading-axis slabs over a
mesh: CCL and EDT on the slabs (parallel/sharded.py), compaction, counts,
boxes and border targets from the slabs, the sharded global engine
(parallel/gengine.py) for the labels it can hold, then the crop engine
on crops gathered off the slabs and the host trace path on crops read
off them. No step gathers the whole volume: every region read goes
through `ShardedVolume.crop` or `_gather_crops_sharded`, and every
device-to-host copy through `comm.fetch`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

from .. import engine, intake
from ..intake import DEFAULT_TEASAR_PARAMS
from ..ops.ccl import runs_bbox
from ..utils import profiling
from ..utils.profiling import phase
from . import comm
from .comm import Mesh
from .gengine import trace_global_sharded
from .sharded import (ShardedVolume, make_mesh, shard_volume,
                      sharded_ccl_rounds, sharded_edtsq, sqrt_f32)


def _gather_crops_sharded(cc: ShardedVolume, dbf: ShardedVolume, offs,
                          mesh: Mesh, bshape, vg: Optional[ShardedVolume] = None):
    """One batched crop gather off the slabs: each slab copies every
    requested crop's intersection with its rows into the crop stack on
    the home device (zeros elsewhere; the psum of the JAX package's
    per-shard intersections). offs: (B, 3) crop origins. Returns (cc, dbf)
    or (cc, dbf, vg) stacks, each (B,) + bshape."""
    offs = np.asarray(offs.cpu() if torch.is_tensor(offs) else offs,
                      dtype=np.int64).reshape(-1, 3)
    B0, B1, B2 = (int(b) for b in bshape)
    vols = [cc, dbf] + ([] if vg is None else [vg])
    outs = [torch.zeros((len(offs), B0, B1, B2), dtype=v.dtype,
                        device=mesh.home) for v in vols]
    h = cc.h
    where, pieces = [], []
    for i in range(mesh.size):
        base = i * h
        for b, (x0, y0, z0) in enumerate(offs):
            lo, hi = max(int(x0), base), min(int(x0) + B0, base + h)
            if lo >= hi:
                continue
            src = (slice(lo - base, hi - base), slice(int(y0), int(y0) + B1),
                   slice(int(z0), int(z0) + B2))
            for out, v in zip(outs, vols):
                where.append((out, b, slice(lo - int(x0), hi - int(x0))))
                pieces.append(v.slabs[i][src])
    for (out, b, rows), piece in zip(where, comm.gather_crop(pieces, mesh)):
        out[b, rows] = piece
    return tuple(outs)


def _compact_cc_sharded(ids: ShardedVolume):
    """Compaction of raw sharded CCL ids to 1..N in scan order (the
    single-device `compact_cc`): each shard lists its component roots
    (voxels whose id is their global linear index + 1), the lists are
    gathered (one all_gather of a few ints per component) and each voxel
    takes its root's rank. Returns (cc, n_components, roots: the roots'
    global flat indices in order, on the home device)."""
    mesh = ids.mesh
    n = ids.slabs[0].numel()
    roots = []
    for i, s in enumerate(ids.slabs):
        flat = s.reshape(-1).long()
        lin = torch.arange(1, n + 1, device=s.device) + i * n
        roots.append(torch.nonzero(flat == lin)[:, 0] + i * n)
    roots_all = comm.all_gather_cat(roots, mesh)
    cc = []
    for s in ids.slabs:
        r = roots_all.to(s.device)
        rank = torch.searchsorted(r, s.reshape(-1).long() - 1) + 1
        cc.append(torch.where(s.reshape(-1) > 0, rank, 0).to(torch.int32)
                  .reshape(s.shape))
    return ids.like(cc), int(roots_all.numel()), roots_all


def _label_info_sharded(cc: ShardedVolume, labels: ShardedVolume, n_max: int,
                        roots, dbf: ShardedVolume):
    """Per-component counts, bounding boxes, original labels (read at each
    component's root voxel) and DBF maxima from per-slab reductions:
    psum of the counts, pmin/pmax of the box corners, pmax of the maxima.
    Returns host arrays (counts, bbmin, bbmax, orig, dbfmax), each
    n_max + 1 long."""
    mesh = cc.mesh
    imax = torch.iinfo(torch.int32).max
    parts = {"n": [], "mn": [], "mx": [], "v": []}
    for i, (c, d) in enumerate(zip(cc.slabs, dbf.slabs)):
        ids = torch.arange(n_max + 1, dtype=torch.int32, device=c.device)
        counts, mn, mx, present, vmax = runs_bbox(
            c.reshape(-1).to(torch.int32), c.shape, ids, d.reshape(-1))
        shift = torch.tensor([i * cc.h, 0, 0], dtype=torch.int32,
                             device=c.device)
        parts["n"].append(counts)
        parts["mn"].append(torch.where(present[:, None], mn + shift, imax))
        parts["mx"].append(torch.where(present[:, None], mx + shift, -1))
        parts["v"].append(vmax)
    counts = comm.fetch(comm.psum(parts["n"], mesh))
    bbmin = comm.fetch(comm.pmin(parts["mn"], mesh))
    bbmax = comm.fetch(comm.pmax(parts["mx"], mesh))
    dbfmax = comm.fetch(comm.pmax(parts["v"], mesh))
    n = labels.slabs[0].numel()
    at_root = []
    for i, s in enumerate(labels.slabs):
        local = roots.to(s.device) - i * n
        owned = (local >= 0) & (local < n)
        v = s.reshape(-1)[torch.clamp(local, 0, n - 1)].to(torch.int32)
        at_root.append(torch.where(owned, v, 0))
    orig = np.zeros(n_max + 1, dtype=np.uint32)
    got = comm.fetch(comm.psum(at_root, mesh)).view(np.uint32)
    orig[1:1 + len(got)] = got
    return counts, bbmin, bbmax, orig, dbfmax


@profiling.entry("skeletonize_sharded")
def skeletonize_sharded(
    all_labels,
    mesh: Optional[Mesh] = None,
    n_devices: Optional[int] = None,
    teasar_params: Optional[dict] = None,
    anisotropy=(1.0, 1.0, 1.0),
    object_ids=None,
    dust_threshold: int = 1000,
    fix_branching: bool = True,
    fix_borders: bool = True,
    extra_targets_before=None,
    extra_targets_after=None,
    voxel_graph=None,
    progress: bool = False,
    device="cuda",
) -> Dict[int, object]:
    """Skeletonize a labeled volume sharded over a mesh (the signature of
    kimimaro_tpu.parallel.skeletonize_sharded plus `device`, the mesh's
    device when no `mesh` is given: n_devices shards, by default one per
    card). Semantics match `skeletonize` for the supported surface (no
    fill_holes / fix_avocados). `voxel_graph`: an optional cc3d-convention
    bitfield of the volume's shape; it shards with the volume and gates
    CCL, EDT walls and every trace sweep. The leading axis is padded with
    zeros up to a multiple of the mesh. Returns {label: Skeleton} in
    physical space."""
    teasar_params = dict(DEFAULT_TEASAR_PARAMS if teasar_params is None
                         else teasar_params)
    labels = intake.format_labels(all_labels)
    if object_ids is not None:
        labels = intake.apply_object_mask(labels, object_ids)
    if labels.size == 0 or not labels.any():
        return {}
    if labels.dtype.itemsize > 4:
        raise ValueError(
            "skeletonize_sharded: renumber >32-bit labels before sharding")
    minlabel = int(labels[labels != 0].min())
    maxlabel = int(labels.max())

    if mesh is None:
        dev = intake.resolve_device(device)
        mesh = make_mesh(n_devices or (torch.cuda.device_count()
                                       if dev.type == "cuda" else 1), dev)
    else:
        for d in mesh.devices:
            intake.resolve_device(d)
    n_dev = mesh.size
    home = mesh.home
    anisotropy = np.array(anisotropy, dtype=np.float32)
    anis_t = tuple(float(a) for a in anisotropy)

    # pad the sharded axis to a multiple of the mesh: zero voxels drop
    # out of CCL, EDT and the trace, and with black_border the pad
    # interface supplies the border's own term
    n0 = labels.shape[0]
    pad = (-n0) % n_dev
    with phase("sharded_upload", home):
        upload = intake._as_int32(labels)
        if pad:
            upload = np.concatenate(
                [upload, np.zeros((pad,) + upload.shape[1:], upload.dtype)])
        lab_dev = shard_volume(upload, mesh)
        vg_dev = None
        if voxel_graph is not None:
            vg = np.asarray(voxel_graph)
            while vg.ndim < 3:
                vg = vg[..., np.newaxis]
            if vg.shape != labels.shape:
                raise ValueError("voxel_graph must match the volume")
            vg = np.ascontiguousarray(vg, dtype=np.uint32).view(np.int32)
            if pad:
                vg = np.concatenate(
                    [vg, np.zeros((pad,) + vg.shape[1:], vg.dtype)])
            vg_dev = shard_volume(vg, mesh)

    with phase("sharded_ccl", home):
        ids_raw = sharded_ccl_rounds(lab_dev, mesh, voxel_graph=vg_dev)
        cc_dev, n_components, roots = _compact_cc_sharded(ids_raw)
        del ids_raw
    if n_components == 0:
        return {}
    with phase("sharded_edt", home):
        dsq = sharded_edtsq(lab_dev, mesh, anis_t,
                            black_border=(minlabel == maxlabel),
                            voxel_graph=vg_dev)
        dbf_dev = dsq.like([sqrt_f32(x) for x in dsq.slabs])
        del dsq
    with phase("sharded_label_info", home):
        n_max = 1 << max(int(np.ceil(np.log2(max(n_components, 2)))), 1)
        counts, bbmin, bbmax, orig, dbfmax = _label_info_sharded(
            cc_dev, lab_dev, n_max, roots, dbf_dev)
        remapping = {i: int(orig[i]) for i in range(1, n_components + 1)}
        firstvox = np.zeros((n_components + 1, 3), dtype=np.int64)
        firstvox[1:] = np.stack(np.unravel_index(
            comm.fetch(roots), tuple(cc_dev.shape)), axis=-1)
    del lab_dev

    extra_targets_before = intake.points_to_labels(
        extra_targets_before or [], cc_dev)
    extra_targets_after = intake.points_to_labels(
        extra_targets_after or [], cc_dev)

    border_targets = defaultdict(list)
    if fix_borders:
        # the border planes of the REAL volume (not the padding)
        with phase("sharded_border_targets", home):
            border_targets = intake.compute_border_targets(
                cc_dev.rows(n0), anisotropy)

    segids = [s for s in range(1, n_components + 1)
              if counts[s] > dust_threshold]
    all_jobs = intake.make_jobs(
        segids, {s: (bbmin[s], bbmax[s]) for s in segids}, border_targets,
        extra_targets_before, extra_targets_after, dbfmax=dbfmax)

    # stage 1: the sharded global engine (not under a voxel graph)
    g_results: Dict[int, list] = {}
    jobs = all_jobs
    if vg_dev is None and len(jobs) >= 2:
        with phase("sharded_gengine", home):
            g_results, jobs = trace_global_sharded(
                cc_dev, dbf_dev, jobs, teasar_params, anis_t, fix_branching,
                mesh, progress=progress, firstvox_arr=firstvox)
    profiling.count("crop_engine_jobs", len(jobs))

    # stage 2: the crop engine on crops gathered off the slabs, one
    # gather per batch
    def crop_source(crop_offs, n_real, bshape):
        got = _gather_crops_sharded(cc_dev, dbf_dev, crop_offs, mesh, bshape,
                                    vg=vg_dev)
        if n_real < len(crop_offs):
            for g in got:
                g[n_real:] = 0
        return got

    with phase("crop_engine", home):
        results, fallback_jobs = engine.trace_batched(
            cc_dev, dbf_dev, jobs, teasar_params, anis_t, fix_branching,
            voxel_graph=vg_dev, crop_source=crop_source)
    results.update(g_results)
    profiling.count("fallback_jobs", len(fallback_jobs))

    # the host trace path reads each job's crops off the slabs
    return intake.finish_skeletons(
        results, all_jobs, fallback_jobs, cc_dev, dbf_dev, vg_dev, remapping,
        teasar_params, anisotropy, fix_branching, home)
