"""Whole-image skeletonization pipeline (the `skeletonize` driver).

Torch counterpart of kimimaro_tpu.intake on its main path: the preamble
(CCL, EDT, per-label metadata, border targets) runs as full-volume device
passes on `device`; the global lock-step engine (gengine) traces every
label it can hold; the labels it hands back (soma candidates, manual
target overflow, bboxes beyond its crop tiers, unconverged labels) go to
the batched crop engine (engine.trace_batched); and only the labels the
crop engine cannot hold are traced one by one by the host trace path
(trace.trace).

With `fill_holes` or `fix_avocados` the host stages of
kimimaro_tpu.intake run between CCL and the engines: hole filling
(hole masks batched by crop tier on the device, ops.fill), avocado
protection (host passes over the labels, EDT on the device), then counts
and boxes on the host. Every label is then soma-possible (no DBF max), so
the global engine takes none and the crop engine takes all. A
CompressedLabelVolume streams slab by slab into one device volume.

With a `voxel_graph` (self-touch walls, cc3d convention) the graph goes
to the device as uint32 beside the labels; the CCL and every EDT take it,
the global engine is bypassed, and every label goes to the crop engine,
which gates its relaxations, re-EDT and chase by the graph (the labels it
hands back take the host trace path with their crop of it).

Stages: upload, ccl, edt, label_info (or fill_holes, avocado_pass_{i},
avocado_edt), border_targets, gengine, crop_engine, finalize,
host_fallback, merge.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import scipy.spatial
import torch

from . import engine, gengine
from . import trace as trace_mod
from .carray import CompressedLabelVolume
from .ops import edt as edt_ops
from .ops import fill as fill_ops
from .ops.ccl import compact_cc, connected_components, label_info
from .skeleton import Skeleton
from .utility import find_objects
from .utils import profiling
from .utils.bbox import Bbox
from .utils.device import resolve_device
from .utils.profiling import phase


class DimensionError(Exception):
    pass


# kimimaro intake.py:47-56
DEFAULT_TEASAR_PARAMS = {
    "scale": 1.5,
    "const": 300,
    "pdrf_scale": 100000,
    "pdrf_exponent": 4,
    "soma_acceptance_threshold": 3500,
    "soma_detection_threshold": 750,
    "soma_invalidation_const": 300,
    "soma_invalidation_scale": 2,
}


def _as_int32(labels: np.ndarray) -> np.ndarray:
    """The labels as the device holds them: int32, with unsigned 32-bit
    values bitcast (which keeps equality and != 0)."""
    if labels.dtype.kind == "u" or labels.dtype == bool:
        return np.ascontiguousarray(
            labels.astype(np.uint32, copy=False)).view(np.int32)
    return np.ascontiguousarray(labels.astype(np.int32, copy=False))


def _upload(labels: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host -> device copy of the labels as int32 (`_as_int32`), pinned
    for a CUDA target."""
    t = torch.from_numpy(_as_int32(labels))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _plan_streaming(clv: CompressedLabelVolume, object_ids):
    """Slab-streaming upload plan for a CompressedLabelVolume
    (kimimaro_tpu.intake._plan_streaming): one pass over the slabs for
    min/max (and the unique set of labels wider than 32 bits), then an
    upload function that allocates the device volume once and copies each
    decompressed slab into its z range through a pinned buffer, so host
    RAM stays at slab scale and the device holds the volume once. Slabs
    travel as uint16 when every label fits; the device volume is int32,
    equal to `_upload` of the whole array.

    Returns (minlabel, maxlabel, wide_back, upload(device))."""
    if not (clv.dtype == bool or np.issubdtype(clv.dtype, np.integer)):
        raise TypeError(
            f"Input labels must be an integer data type. Got: {clv.dtype}")
    obj = None
    if object_ids is not None:
        obj = np.asarray(list(object_ids), dtype=clv.dtype)

    minlabel, maxlabel = None, None
    wide = clv.dtype.itemsize > 4
    uniques = set()
    for _, sl in clv.slabs():
        if obj is not None:
            sl = np.where(np.isin(sl, obj), sl, 0)
        mn, mx = int(sl.min()), int(sl.max())
        minlabel = mn if minlabel is None else min(minlabel, mn)
        maxlabel = mx if maxlabel is None else max(maxlabel, mx)
        if wide:
            uniques.update(np.unique(sl).tolist())

    wide_back = None
    u_nz = None
    if wide:
        u_nz = np.array(sorted(x for x in uniques if x != 0),
                        dtype=clv.dtype)
        wide_back = {i + 1: int(v) for i, v in enumerate(u_nz)}
    narrow = (len(u_nz) if wide else maxlabel) < 2**16 and (
        wide or minlabel >= 0)

    def upload(device: torch.device) -> torch.Tensor:
        out = torch.empty(clv.shape, dtype=torch.int32, device=device)
        pinned, busy = {}, {}
        for i, (z0, sl) in enumerate(clv.slabs()):
            if obj is not None:
                sl = np.where(np.isin(sl, obj), sl, 0)
            if wide:
                compact = np.searchsorted(u_nz, sl).astype(np.uint32) + 1
                compact[sl == 0] = 0
                sl = compact
            if narrow:
                host = np.ascontiguousarray(
                    sl.astype(np.uint16, copy=False)).view(np.int16)
            else:
                host = _as_int32(sl)
            if not host.flags.writeable:
                host = host.copy()
            src = torch.from_numpy(host)
            if device.type == "cuda":
                # two pinned buffers in turn: a buffer is refilled only
                # after its last copy to the device has ended
                slot = i % 2
                if slot in busy:
                    busy[slot].synchronize()
                buf = pinned.get(slot)
                if buf is None or buf.shape != src.shape:
                    buf = pinned[slot] = torch.empty_like(
                        src, pin_memory=True)
                buf.copy_(src)
                src = buf.to(device, non_blocking=True)
                busy[slot] = torch.cuda.Event()
                busy[slot].record()
            out[:, :, z0: z0 + sl.shape[2]] = (
                src.to(torch.int32) & 0xFFFF if narrow else src)
        return out

    return minlabel, maxlabel, wide_back, upload


@profiling.entry("skeletonize")
def skeletonize(
    all_labels,
    teasar_params=DEFAULT_TEASAR_PARAMS,
    anisotropy: Sequence[float] = (1, 1, 1),
    object_ids=None,
    dust_threshold: int = 1000,
    progress: bool = False,
    fix_branching: bool = True,
    in_place: bool = False,
    fix_borders: bool = True,
    parallel: int = 1,
    parallel_chunk_size: int = 100,
    extra_targets_before=[],
    extra_targets_after=[],
    fill_holes: bool = False,
    fix_avocados: bool = False,
    voxel_graph=None,
    device="cuda",
) -> Dict[int, Skeleton]:
    """Skeletonize all nonzero labels of a 2D/3D integer volume (or of a
    CompressedLabelVolume, which streams to the device slab by slab).

    The signature of kimimaro_tpu.skeletonize plus `device` ("cuda" or
    "cpu"). Returns {segid: Skeleton} with vertices in physical space.
    `progress`, `parallel` and `parallel_chunk_size` are accepted for API
    parity (`progress` draws no bar). `voxel_graph`: an optional
    cc3d-convention connectivity bitfield of the labels' shape (bit k at a
    voxel permits leaving it along ops.stencils.GRAPH_BITS' offset k): the
    components, distances and paths respect its walls, and every label is
    traced by the crop engine (or the host trace path).
    """
    device = resolve_device(device)
    anisotropy = np.array(anisotropy, dtype=np.float32)
    host_stages = fill_holes or fix_avocados

    # a compressed volume streams slab by slab; the host stages are
    # whole-volume by nature and materialize it
    streaming = (isinstance(all_labels, CompressedLabelVolume)
                 and not host_stages)
    if streaming:
        if all_labels.size <= dust_threshold:
            return {}
        minlabel, maxlabel, wide_back, stream_upload = _plan_streaming(
            all_labels, object_ids)
        if minlabel == 0 and maxlabel == 0:
            return {}
        n_voxels = all_labels.size
    else:
        # the caller's array is copied only where a stage writes: object
        # masking and the host stages
        will_mutate = object_ids is not None or host_stages
        all_labels = format_labels(all_labels,
                                   in_place=in_place or not will_mutate)
        all_labels = apply_object_mask(all_labels, object_ids)
        if all_labels.size <= dust_threshold:
            return {}
        minlabel, maxlabel = int(all_labels.min()), int(all_labels.max())
        if minlabel == 0 and maxlabel == 0:
            return {}
        n_voxels = all_labels.size

        # labels wider than 32 bits are renumbered on the host first;
        # wide_back restores the original ids at the end
        wide_back = None
        if all_labels.dtype.itemsize > 4:
            u = np.unique(all_labels)
            u_nz = u[u != 0]
            compact = np.searchsorted(u_nz, all_labels).astype(np.uint32) + 1
            compact[all_labels == 0] = 0
            wide_back = {i + 1: int(v) for i, v in enumerate(u_nz)}
            all_labels = compact

    with phase("upload", device):
        labels_dev = (stream_upload(device) if streaming
                      else _upload(all_labels, device))
        vg_dev = None
        if voxel_graph is not None:
            vg_host = np.asarray(voxel_graph)
            while vg_host.ndim < 3:
                vg_host = vg_host[..., np.newaxis]
            vg_dev = torch.from_numpy(
                np.ascontiguousarray(vg_host, dtype=np.uint32)).to(device)
    with phase("ccl", device):
        cc_dev, n_components, rep_prefix = compact_cc(
            connected_components(labels_dev, voxel_graph=vg_dev))
    if n_components == 0:
        return {}

    anis_t = tuple(float(a) for a in anisotropy)

    def edtfn_dev(cc):
        return edt_ops.edt(cc, anisotropy=anis_t,
                           black_border=(minlabel == maxlabel),
                           voxel_graph=vg_dev)

    dbfmax_arr = None  # per-label DBF max; only the device preamble has it
    if host_stages:
        # the host stages need the labels on the host once
        cc_labels = cc_dev.cpu().numpy()
        # each component's original label, read at its first voxel
        firstcc = gengine._first_voxels(cc_dev, n_components + 1).cpu()
        flat_orig = all_labels.reshape(-1)
        remapping = {u: int(flat_orig[int(firstcc[u])])
                     for u in range(1, n_components + 1)}

        if fill_holes:
            with phase("fill_holes", device):
                cc_labels = fill_all_holes(cc_labels, progress,
                                           vol_dev=cc_dev)

        def edtfn(labels):
            with phase("avocado_edt", device):
                return edtfn_dev(torch.from_numpy(labels).to(device)).cpu(
                ).numpy()

        all_dbf = edtfn(cc_labels)
        if fix_avocados:
            cc_labels, all_dbf, remapping = engage_avocado_protection(
                cc_labels, all_dbf, remapping,
                soma_detection_threshold=teasar_params.get(
                    "soma_detection_threshold", 0),
                edtfn=edtfn, progress=progress, device=device)
        with phase("host_label_info", device):
            cc_dev = torch.from_numpy(cc_labels).to(device)
            dbf_dev = torch.from_numpy(all_dbf).to(device)
            cc_segids_all, pxct = _unique_ids(cc_labels, return_counts=True)
            counts_map = dict(zip(cc_segids_all.tolist(), pxct.tolist()))
            slices = find_objects(cc_labels)
            bb = {}
            for sid in cc_segids_all:
                sid = int(sid)
                if sid == 0 or slices[sid - 1] is None:
                    continue
                roi = Bbox.from_slices(slices[sid - 1])
                bb[sid] = (roi.minpt, roi.maxpt - 1)
            segid_iter = [s for s in counts_map
                          if s != 0 and counts_map[s] > dust_threshold
                          and s in bb]
    else:
        with phase("edt", device):
            dbf_dev = edtfn_dev(cc_dev)
        with phase("label_info", device):
            n_max = 1 << max(int(np.ceil(np.log2(max(n_components, 2)))), 1)
            info = label_info(cc_dev, labels_dev, n_max=n_max,
                              rep_prefix=rep_prefix, dbf=dbf_dev)
            counts, bbmin, bbmax, orig, dbfmax_arr = (
                profiling.host(a).numpy()[: n_components + 1] for a in info)
            orig = orig.view(np.uint32)
        remapping = {i: int(orig[i]) for i in range(1, n_components + 1)}
        counts_map = {i: int(counts[i]) for i in range(1, n_components + 1)}
        bb = {i: (bbmin[i], bbmax[i])
              for i in range(1, n_components + 1) if counts[i] > 0}
        segid_iter = [s for s in range(1, n_components + 1)
                      if counts_map.get(s, 0) > dust_threshold and s in bb]
    del labels_dev
    if wide_back is not None:
        remapping = {k: wide_back[v] for k, v in remapping.items()}

    cc_host = None
    if extra_targets_before or extra_targets_after:
        cc_host = cc_dev.to("cpu").numpy()
    extra_targets_before = points_to_labels(extra_targets_before, cc_host)
    extra_targets_after = points_to_labels(extra_targets_after, cc_host)

    border_targets = defaultdict(list)
    if fix_borders:
        with phase("border_targets", device):
            border_targets = compute_border_targets(cc_dev, anisotropy)

    print_quotes(parallel)  # easter egg (kimimaro intake.py:796-803)

    jobs = make_jobs(segid_iter, bb, border_targets, extra_targets_before,
                     extra_targets_after, counts=counts_map, dbfmax=dbfmax_arr)

    if vg_dev is not None:
        # the global engine runs no graph: every label to the crop engine
        results, crop_jobs = {}, jobs
    else:
        with phase("gengine", device):
            results, crop_jobs = _trace_global(
                cc_dev, dbf_dev, jobs, teasar_params, anisotropy,
                fix_branching, None if host_stages else rep_prefix,
                n_components, n_voxels)
    profiling.count("crop_engine_jobs", len(crop_jobs))
    with phase("crop_engine", device):
        crop_results, fallback_jobs = engine.trace_batched(
            cc_dev, dbf_dev, crop_jobs, teasar_params, anisotropy,
            fix_branching, voxel_graph=vg_dev)
        results.update(crop_results)
    profiling.count("engine_jobs", len(jobs) - len(fallback_jobs))
    profiling.count("fallback_jobs", len(fallback_jobs))

    return finish_skeletons(results, jobs, fallback_jobs, cc_dev, dbf_dev,
                            vg_dev, remapping, teasar_params, anisotropy,
                            fix_branching, device)


def make_jobs(segids, bb, border_targets, extra_targets_before,
              extra_targets_after, counts=None, dbfmax=None) -> List[dict]:
    """One trace job per label in `segids` whose box `bb[segid]` = (min,
    max corner) holds more than one voxel: its offset and shape, its
    manual targets (border targets, the last of them the root, then the
    extra targets) in the box's frame, and, where given, its voxel count
    and DBF maximum (`counts` a mapping, `dbfmax` an array by segid)."""
    jobs = []
    for segid in segids:
        mn, mx = bb[segid]
        mn = np.asarray(mn, dtype=np.int64)
        shape = np.asarray(mx, dtype=np.int64) - mn + 1
        if int(np.prod(shape)) <= 1:
            continue

        manual_before, manual_after, root = [], [], None

        def translate(targets):
            return [tuple(int(c) - int(m) for c, m in zip(t, mn)) for t in targets]

        if len(border_targets[segid]) > 0:
            manual_before = translate(border_targets[segid])
            root = manual_before.pop()
        if segid in extra_targets_before and len(extra_targets_before[segid]) > 0:
            manual_before.extend(translate(extra_targets_before[segid]))
        if segid in extra_targets_after and len(extra_targets_after[segid]) > 0:
            manual_after.extend(translate(extra_targets_after[segid]))

        job = {
            "segid": segid,
            "offset": mn,
            "shape": shape,
            "before": manual_before,
            "after": manual_after,
            "root": root,
            "dbfmax": None if dbfmax is None else float(dbfmax[segid]),
        }
        if counts is not None:
            job["count"] = counts.get(segid, 0)
        jobs.append(job)
    return jobs


def finish_skeletons(results, jobs, fallback_jobs, cc_dev, dbf_dev, vg_dev,
                     remapping, teasar_params, anisotropy, fix_branching,
                     device) -> Dict[int, Skeleton]:
    """The engines' paths -> {original label: Skeleton} in physical space:
    every label's paths in `results` assembled at its job's offset (`jobs`:
    every job, whichever engine traced it), the host trace path for
    `fallback_jobs`, then the merge of each label's pieces. `cc_dev`,
    `dbf_dev` and `vg_dev` may be sharded volumes."""
    offsets_by_segid = {j["segid"]: j["offset"] for j in jobs}
    skeletons = defaultdict(list)
    with phase("finalize"):
        batched = engine.paths_to_skeletons_batched(
            results, offsets_by_segid, anisotropy)
        if batched is None:
            # >= 2^16 labels: per-label assembly (identical semantics)
            batched = {}
            for segid, path_list in results.items():
                skel = engine.paths_to_skeleton(path_list, anisotropy)
                if skel.empty():
                    continue
                skel.vertices += offsets_by_segid[segid].astype(np.float32)
                batched[segid] = skel
        for segid, skel in batched.items():
            orig_segid = remapping[segid]
            skel.id = orig_segid
            skel.vertices = np.multiply(skel.vertices, anisotropy,
                                        dtype=np.float32)
            skel.space = "physical"
            skeletons[orig_segid].append(skel)

    # labels neither engine could hold: the host trace path
    with phase("host_fallback", device):
        _run_host_fallback(
            fallback_jobs, cc_dev, dbf_dev, vg_dev, remapping, skeletons,
            teasar_params, anisotropy, fix_branching)

    with phase("merge"):
        return merge(skeletons)


def _trace_global(cc_dev, dbf_dev, jobs, teasar_params, anisotropy,
                  fix_branching, rep_prefix, n_components, n_voxels):
    """The global engine on `jobs`: (results, the jobs it hands back).
    `rep_prefix` (None after the host stages, which renumber) gives each
    component's first voxel; without it the engine finds them."""
    device = cc_dev.device
    firstvox_arr = None
    if rep_prefix is not None:
        # each component's lexicographically first voxel, from the
        # monotone root prefix (compact ids are first-appearance ordered)
        fv_flat = profiling.host(torch.searchsorted(
            rep_prefix, torch.arange(1, n_components + 1, dtype=torch.int32,
                                     device=device))).numpy()
        fv_flat = np.minimum(fv_flat, n_voxels - 1)
        firstvox_arr = np.zeros((n_components + 1, 3), np.int64)
        firstvox_arr[1:] = np.stack(
            np.unravel_index(fv_flat, tuple(cc_dev.shape)), axis=-1)
    return gengine.trace_global(
        cc_dev, dbf_dev, jobs, teasar_params, anisotropy, fix_branching,
        firstvox_arr=firstvox_arr)


def _run_host_fallback(fallback_jobs, cc_dev, dbf_dev, vg_dev, remapping,
                       skeletons, teasar_params, anisotropy, fix_branching):
    """Per-label host trace loop for the jobs the crop engine could not
    hold: more than T_CAP manual targets, path capacity overflow, or
    relaxations still unconverged after its escalation (kimimaro's plain
    serial path, intake.py:434-517), each with its crop of the voxel
    graph `vg_dev` where there is one. The crops stay on the device of
    `cc_dev`; each is read through `cc_dev[slices]`, so the volumes may be
    sharded volumes whose crops are gathered off their slabs."""
    for job in fallback_jobs:
        segid = job["segid"]
        mn = np.asarray(job["offset"], dtype=np.int64)
        shape = np.asarray(job["shape"], dtype=np.int64)
        slc = tuple(slice(int(a), int(a + s)) for a, s in zip(mn, shape))
        labels_crop = cc_dev[slc] == segid
        dbf_crop = torch.where(labels_crop, dbf_dev[slc], 0.0)
        skeleton = trace_mod.trace(
            labels_crop, dbf_crop,
            anisotropy=tuple(float(a) for a in anisotropy),
            fix_branching=fix_branching,
            manual_targets_before=list(job["before"]),
            manual_targets_after=list(job["after"]),
            root=job["root"],
            voxel_graph=None if vg_dev is None else vg_dev[slc],
            device=cc_dev.device,
            **teasar_params,
        )
        if skeleton.empty():
            continue
        skeleton.vertices += mn.astype(np.float32)
        orig_segid = remapping[segid]
        skeleton.id = orig_segid
        skeleton.vertices = np.multiply(
            skeleton.vertices, anisotropy, dtype=np.float32)
        skeleton.space = "physical"
        skeletons[orig_segid].append(skeleton)


# --------------------------------------------------------------------------- #
# Label formatting / masking (kimimaro intake.py:315-342,519-535)


def format_labels(labels, in_place: bool = False) -> np.ndarray:
    labels = np.asarray(labels)
    if not in_place:
        labels = np.copy(labels)

    if labels.dtype == bool:
        labels = labels.view(np.uint8)

    original_shape = labels.shape
    while labels.ndim < 3:
        labels = labels[..., np.newaxis]
    while labels.ndim > 3:
        if labels.shape[-1] == 1:
            labels = labels[..., 0]
        else:
            raise DimensionError(
                "Input labels may be no more than three non-trivial dimensions. "
                f"Got: {original_shape}"
            )
    return labels


def apply_object_mask(all_labels: np.ndarray, object_ids) -> np.ndarray:
    if object_ids is None:
        return all_labels
    keep = np.isin(all_labels, np.asarray(list(object_ids), dtype=all_labels.dtype))
    return np.where(keep, all_labels, 0)


def points_to_labels(pts, cc_labels) -> Dict[int, list]:
    """Bucket (x,y,z) targets by the connected-component label under them
    (kimimaro intake.py:537-542)."""
    mapping = defaultdict(list)
    for pt in pts:
        pt = tuple(int(c) for c in pt)
        mapping[int(cc_labels[pt])].append(pt)
    return mapping


def merge(skeletons: Dict[int, List[Skeleton]]) -> Dict[int, Skeleton]:
    """Fuse per-component skeletons of the same original label
    (kimimaro intake.py:587-593)."""
    merged = {}
    for segid, skels in skeletons.items():
        if len(skels) == 1:
            skels[0].id = segid
            merged[segid] = skels[0]
            continue
        skel = Skeleton.simple_merge(skels)
        skel.id = segid
        merged[segid] = skel.consolidate()
    return merged


def _unique_ids(arr: np.ndarray, return_counts: bool = False):
    """np.unique of a label array (with the counts), by one counting pass
    where the labels are small non-negative integers (compact ids), else
    by np.unique's sort."""
    arr = np.asarray(arr)
    if arr.size and arr.dtype.kind in "ui" and arr.dtype.itemsize <= 4 \
            and int(arr.min()) >= 0 and int(arr.max()) < (1 << 26):
        counts = np.bincount(arr.reshape(-1))
        ids = np.flatnonzero(counts).astype(arr.dtype)
        return (ids, counts[ids]) if return_counts else ids
    return np.unique(arr, return_counts=return_counts)


# --------------------------------------------------------------------------- #
# Hole filling (kimimaro intake.py:747-794)


def fill_all_holes(cc_labels: np.ndarray, progress: bool = False,
                   return_fill_count: bool = False, vol_dev=None,
                   device="cuda"):
    """Fill interior holes of each connected component; labels that were
    holes are absorbed by the surrounding label
    (kimimaro_tpu.intake.fill_all_holes).

    Hole masks for ALL labels are computed in lane-batched device passes
    per crop tier from the pre-fill volume (ops.fill.fill_label_crops);
    kimimaro's serial per-label form is replayed on the host over those
    masks, which is exact: an applied label's mask never changes under
    earlier labels' writes (a label with any voxel inside an earlier
    filled hole is absorbed and skipped; all other labels' voxel sets are
    untouched). `vol_dev` is the volume already on its device (else it is
    uploaded to `device`). `progress` draws no bar."""
    cc_labels = np.copy(cc_labels)
    labels = _unique_ids(cc_labels)
    labels_set = set(int(u) for u in labels if u != 0)

    all_slices = find_objects(cc_labels)
    pixels_filled = 0

    cand, offsets, shapes = [], [], []
    for label in labels:
        label = int(label)
        if label == 0 or all_slices[label - 1] is None:
            continue
        roi = Bbox.from_slices(all_slices[label - 1])
        cand.append(label)
        offsets.append(np.asarray(roi.minpt))
        shapes.append(np.asarray(roi.maxpt) - np.asarray(roi.minpt))

    if vol_dev is None:
        vol_dev = torch.from_numpy(cc_labels.astype(np.int32)).to(
            resolve_device(device))
    masks = fill_ops.fill_label_crops(
        vol_dev, np.asarray(offsets).reshape(-1, 3),
        np.asarray(shapes).reshape(-1, 3),
        np.asarray(cand, dtype=np.int64), cc_labels.shape)

    for label, (holes, n) in zip(cand, masks):
        if label not in labels_set or n == 0:
            continue
        slices = all_slices[label - 1]
        pixels_filled += int(n)
        sub_labels = set(int(u) for u in np.unique(cc_labels[slices][holes]))
        sub_labels.discard(label)
        labels_set -= sub_labels
        cc_labels[slices] = np.where(holes, label, cc_labels[slices])
    profiling.count("fill_labels", sum(1 for _, n in masks if n))
    profiling.count("fill_voxels", pixels_filled)

    if return_fill_count:
        return cc_labels, pixels_filled
    return cc_labels


# --------------------------------------------------------------------------- #
# Avocado protection (kimimaro intake.py:600-704, skeletontricks.pyx:905-993)


def find_avocado_fruit(labels: np.ndarray, cx: int, cy: int, cz: int,
                       background=0):
    """Cast 6 axis rays from (cx,cy,cz); if >=3 rays terminate on the same
    surrounding label (one mismatch allowed when more than 3 hits), classify
    (pit, fruit). Mirrors kimimaro pyx:905-993."""
    sx, sy, sz = labels.shape
    if cx >= sx or cy >= sy or cz >= sz:
        raise ValueError(f"<{cx},{cy},{cz}> must be within <{sx},{sy},{sz}>")

    label = labels[cx, cy, cz]

    def ray(coords_iter, index_fn):
        for i in coords_iter:
            v = index_fn(i)
            if v == background:
                return None
            if v != label:
                return v
        return None

    rays = [
        ray(range(cx, sx), lambda x: labels[x, cy, cz]),
        ray(range(cx, 0, -1), lambda x: labels[x, cy, cz]),
        ray(range(cy, sy), lambda y: labels[cx, y, cz]),
        ray(range(cy, 0, -1), lambda y: labels[cx, y, cz]),
        ray(range(cz, sz), lambda z: labels[cx, cy, z]),
        ray(range(cz, 0, -1), lambda z: labels[cx, cy, z]),
    ]
    changes = [r for r in rays if r is not None]

    if len(changes) < 3:
        return (label, label)

    allowed_differences = 1 if len(changes) > 3 else 0
    uniq, cts = np.unique(changes, return_counts=True)
    candidate = int(np.argmax(cts))
    differences = len(changes) - cts[candidate]
    if differences > allowed_differences:
        return (label, label)
    return (label, uniq[candidate])


def _paint_walls(binimg: np.ndarray, device) -> np.ndarray:
    """2D-fill each wall so inclusions touching a wall are still treated as
    interior (kimimaro intake.py:666-677); the fills run on `device`."""
    for axis in range(3):
        for side in (0, -1):
            idx = [slice(None)] * 3
            idx[axis] = side
            wall = torch.from_numpy(binimg[tuple(idx)]).to(device)
            binimg[tuple(idx)] = fill_ops.fill(wall).cpu().numpy()
    return binimg


def engage_avocado_protection(cc_labels, all_dbf, remapping,
                              soma_detection_threshold, edtfn,
                              progress=False, device="cuda"):
    """Merge each "pit" label enclosed by a "fruit" label into it, up to 20
    passes (kimimaro intake.py:600-644), then renumber contiguously by
    first appearance and rebuild the remapping. `edtfn` recomputes the
    EDT of a host volume after a pass that changed labels; the fills run
    on `device`. `progress` draws no bar."""
    orig_cc_labels = np.copy(cc_labels)
    cc_labels = np.copy(cc_labels)
    unchanged = set()
    device = resolve_device(device)

    for _ in range(20):
        # nested-avocado cap (kimimaro intake.py:610-614)
        candidates = set(_unique_ids(
            cc_labels[all_dbf > soma_detection_threshold / 2.5]).tolist())
        candidates -= unchanged
        candidates.discard(0)

        profiling.count("avocado_passes")
        profiling.count("avocado_candidates", len(candidates))
        with phase("avocado_pass", device):
            cc_labels, unchanged_this_cycle, changes = _avocado_single_pass(
                cc_labels, all_dbf, candidates=sorted(candidates),
                device=device)
        unchanged |= unchanged_this_cycle
        if len(changes) == 0:
            break
        all_dbf = edtfn(cc_labels)

    # renumber contiguously by first appearance in scan order and rebuild
    # the remapping (kimimaro intake.py:636-644; fastremap.renumber orders
    # labels by first occurrence): the first voxel of each id by a
    # scatter-min on the device, in place of a sort of the volume
    cc_t = torch.from_numpy(cc_labels.astype(np.int64, copy=False)).to(device)
    n_ids = int(cc_t.max()) + 1 if cc_t.numel() else 1
    first = gengine._first_voxels(cc_t, n_ids).cpu().numpy()
    fg_ids = np.flatnonzero(first[1:] < cc_labels.size) + 1
    order = np.argsort(first[fg_ids], kind="stable")
    lut = np.zeros(n_ids, dtype=np.int64)
    lut[fg_ids[order]] = np.arange(1, len(fg_ids) + 1)
    new_t = torch.from_numpy(lut).to(device)[cc_t]
    new_cc = new_t.cpu().numpy().astype(cc_labels.dtype)

    # new cc id -> the smallest old cc id occupying its voxels that the
    # remapping holds -> original label
    old_t = torch.from_numpy(
        orig_cc_labels.astype(np.int64, copy=False)).to(device).reshape(-1)
    known = np.zeros(max(int(orig_cc_labels.max()) + 1, 1), dtype=bool)
    keys = np.fromiter((k for k in remapping if 0 <= k < len(known)),
                       dtype=np.int64)
    known[keys] = True
    big = torch.iinfo(torch.int64).max
    old_t = torch.where(torch.from_numpy(known).to(device)[old_t], old_t,
                        big)
    least = torch.full((len(fg_ids) + 1,), big, dtype=torch.int64,
                       device=device).scatter_reduce_(
        0, new_t.reshape(-1), old_t, "amin").cpu().numpy()
    seen = {i: remapping[int(least[i])] for i in range(1, len(least))
            if least[i] != big}

    profiling.count("avocado_absorbed",
                    int(np.count_nonzero(_unique_ids(orig_cc_labels)))
                    - len(fg_ids))
    return new_cc, all_dbf, seen


def _avocado_single_pass(cc_labels, all_dbf, candidates, device="cuda"):
    unchanged = set()
    changed = set()
    if len(candidates) == 0:
        return cc_labels, unchanged, changed

    slcs = find_objects(cc_labels)
    device = resolve_device(device)

    for label in candidates:
        slc = slcs[label - 1]
        if slc is None:
            continue
        offset = Bbox.from_slices(slc).minpt
        binimg = _paint_walls(cc_labels[slc] == label, device)
        masked = np.where(binimg, all_dbf[slc], 0.0)
        coord = np.unravel_index(np.argmax(masked), masked.shape)
        coord = tuple(int(c) + int(o) for c, o in zip(coord, offset))

        pit, fruit = find_avocado_fruit(cc_labels, *coord)
        if pit == fruit and pit not in changed:
            unchanged.add(int(pit))
        else:
            unchanged.discard(int(pit))
            unchanged.discard(int(fruit))
            changed.add(int(pit))
            changed.add(int(fruit))
            binimg |= cc_labels[slc] == fruit

        filled = fill_ops.fill(torch.from_numpy(binimg).to(device))
        cc_labels[slc] = np.where(filled.cpu().numpy(), fruit, cc_labels[slc])

    return cc_labels, unchanged, changed


# --------------------------------------------------------------------------- #
# fix_borders: deterministic chunk-joining targets
# (kimimaro intake.py:544-585, skeletontricks.pyx:528-760)


def _compute_centroids(cc_plane: np.ndarray, wx: float, wy: float) -> Dict[int, tuple]:
    """Per-label centroid on a 2D plane, rounded toward the plane center so
    every coordinate frame picks the same pixel (reference pyx:573-586).
    Vectorized over labels (single bincount pass)."""
    wx32, wy32 = np.float32(wx), np.float32(wy)
    sx, sy = cc_plane.shape
    cx = np.float32(wx32 * sx / 2)
    cy = np.float32(wy32 * sy / 2)

    xs, ys = np.nonzero(cc_plane)
    vals = cc_plane[xs, ys].astype(np.int64)
    if len(vals) == 0:
        return {}
    nl = int(vals.max()) + 1
    cnt = np.bincount(vals, minlength=nl).astype(np.float32)
    sx_sum = np.bincount(vals, weights=xs, minlength=nl)
    sy_sum = np.bincount(vals, weights=ys, minlength=nl)

    present = np.flatnonzero(cnt > 0)
    px = (wx32 * sx_sum[present].astype(np.float32) / cnt[present]).astype(np.float32)
    py = (wy32 * sy_sum[present].astype(np.float32) / cnt[present]).astype(np.float32)
    px = np.where(px - cx < 0, (px + wx32).astype(np.float32), px)
    py = np.where(py - cy < 0, (py + wy32).astype(np.float32), py)
    return {
        int(l): (float(a / wx32), float(b / wy32))
        for l, a, b in zip(present, px, py)
    }


def _distsq(p, q, wx, wy):
    dx = wx * (p[..., 0] - q[0])
    dy = wy * (p[..., 1] - q[1])
    return dx * dx + dy * dy


def find_border_targets(dt_plane: np.ndarray, cc_plane: np.ndarray, wx: float, wy: float):
    """Per 2D label: the max-EDT point, with the reference's 5-stage
    coordinate-frame-free tiebreak (closest to label centroid, then plane
    centroid, then corner, then edge, then first in y-major scan order;
    reference pyx:591-715). Bit-deterministic across chunk frames.
    Vectorized: one grouped lexsort over all max-EDT candidates."""
    sx, sy = dt_plane.shape
    centroids = _compute_centroids(cc_plane, wx, wy)
    cx, cy = np.float32(wx * sx / 2.0), np.float32(wy * sy / 2.0)

    flat_cc = cc_plane.ravel().astype(np.int64)
    flat_dt = dt_plane.ravel()
    fgm = (flat_cc > 0) & (flat_dt > 0)
    if not fgm.any():
        return {}
    nl = int(flat_cc[fgm].max()) + 1
    mx = np.zeros(nl, dtype=flat_dt.dtype)
    np.maximum.at(mx, flat_cc[fgm], flat_dt[fgm])

    cand_mask = fgm & (flat_dt == mx[flat_cc])
    idxs = np.flatnonzero(cand_mask)
    labs = flat_cc[idxs]
    xs = (idxs // sy).astype(np.float32)
    ys = (idxs % sy).astype(np.float32)

    centx = np.zeros(nl, dtype=np.float32)
    centy = np.zeros(nl, dtype=np.float32)
    for l, (a, b) in centroids.items():
        centx[l], centy[l] = float(int(a)), float(int(b))

    cand = np.stack([xs, ys], axis=1)
    dx = wx * (xs - centx[labs])
    dy = wy * (ys - centy[labs])
    k1 = dx * dx + dy * dy
    # NB: the reference compares against (wx*sx/2, wy*sy/2) expressed in
    # pixel units (pyx:694-696) — replicated verbatim for bit parity.
    k2 = _distsq(cand, (cx, cy), wx, wy)
    corners = [(-0.5, -0.5), (sx - 0.5, -0.5), (sx - 0.5, sy - 0.5), (-0.5, sx - 0.5)]
    k3 = np.min(np.stack([_distsq(cand, c, wx, wy) for c in corners]), axis=0)
    k4 = np.minimum.reduce(
        [
            wx * (xs - 0.5),
            wx * (sx - 0.5 - xs),
            wy * (ys - 0.5),
            wy * (sy - 0.5 - ys),
        ]
    )
    scan = ys * sx + xs  # y-major scan order (pyx:628-630)

    order = np.lexsort((scan, k4, k3, k2, k1, labs))
    labs_sorted = labs[order]
    first = np.ones(len(order), dtype=bool)
    first[1:] = labs_sorted[1:] != labs_sorted[:-1]
    winners = order[first]
    return {
        int(labs[w]): (int(xs[w]), int(ys[w])) for w in winners
    }

def _face_stack(cc) -> torch.Tensor:
    """The six border faces of a volume packed into one (11, P0, P1)
    zero-padded int32 stack with zero separator planes between faces
    (26-conn CCL cannot merge across a zero plane). `cc` is a tensor or a
    sharded volume: only the faces are read (each through `cc[index]`)."""
    sx, sy, sz = cc.shape
    P0, P1 = max(sx, sy), max(sy, sz)
    faces = [
        cc[:, :, 0], cc[:, :, -1],
        cc[:, 0, :], cc[:, -1, :],
        cc[0, :, :], cc[-1, :, :],
    ]
    stack = torch.zeros((11, P0, P1), dtype=torch.int32,
                        device=faces[0].device)
    for i, f in enumerate(faces):
        stack[2 * i, : f.shape[0], : f.shape[1]] = f.to(torch.int32)
    return stack


def compute_border_targets(cc_labels, anisotropy) -> Dict[int, np.ndarray]:
    """For each of the six faces: 2D CCL + 2D EDT + deterministic per-label
    max picks (kimimaro intake.py:544-585). All six faces ride one batched
    CCL call and three batched EDT calls (one per anisotropy pair);
    padding with background is exact because a zero-label neighbour
    raises the same distance wall as `black_border`. `cc_labels`: a
    tensor, or a sharded volume whose faces are read off its slabs."""
    sx, sy, sz = cc_labels.shape

    face_meta = (
        ((sx, sy), (0, 1), lambda x, y: (x, y, 0)),
        ((sx, sy), (0, 1), lambda x, y: (x, y, sz - 1)),
        ((sx, sz), (0, 2), lambda x, z: (x, 0, z)),
        ((sx, sz), (0, 2), lambda x, z: (x, sy - 1, z)),
        ((sy, sz), (1, 2), lambda y, z: (0, y, z)),
        ((sy, sz), (1, 2), lambda y, z: (sx - 1, y, z)),
    )

    stack_dev = _face_stack(cc_labels)
    cc_stack_dev = connected_components(stack_dev)
    stack_np = profiling.host(stack_dev[0::2]).numpy()
    cc_stack = profiling.host(cc_stack_dev[0::2]).numpy()

    # batched EDT per anisotropy pair: stacking along axis 0 with a huge
    # axis-0 weight leaves in-plane distances exact
    dt_faces = [None] * 6
    for pair in ((0, 1), (2, 3), (4, 5)):
        if not cc_stack[list(pair)].any():
            continue
        dims = face_meta[pair[0]][1]
        wx = float(anisotropy[dims[0]])
        wy = float(anisotropy[dims[1]])
        sub = torch.stack([cc_stack_dev[2 * i] for i in pair])
        dt = edt_ops.edt(sub, (1e9, wx, wy), black_border=True)
        dt = profiling.host(dt).numpy()
        dt_faces[pair[0]], dt_faces[pair[1]] = dt[0], dt[1]

    target_list = defaultdict(set)
    for face_i, (fshape, dims, rotatefn) in enumerate(face_meta):
        if dt_faces[face_i] is None:
            continue
        wx, wy = float(anisotropy[dims[0]]), float(anisotropy[dims[1]])
        plane = stack_np[face_i, : fshape[0], : fshape[1]]
        if not plane.any():
            continue
        cc_raw = cc_stack[face_i, : fshape[0], : fshape[1]]
        # compact to 1..N preserving background = 0
        uniq, inv = np.unique(cc_raw, return_inverse=True)
        has_bg = len(uniq) > 0 and uniq[0] == 0
        new_vals = np.arange(len(uniq)) if has_bg else np.arange(1, len(uniq) + 1)
        cc_plane = new_vals[inv].reshape(plane.shape).astype(np.int32)

        dt_plane = dt_faces[face_i][: fshape[0], : fshape[1]]
        plane_targets = find_border_targets(dt_plane, cc_plane, wx, wy)

        # the target pixel itself carries the original cc_labels value
        for label, pt in plane_targets.items():
            orig = int(plane[pt[0], pt[1]])
            if orig == 0:
                continue
            target_list[orig].add(rotatefn(int(pt[0]), int(pt[1])))

    out = defaultdict(lambda: np.array([], dtype=np.uint32))
    for label, pts in target_list.items():
        out[label] = np.array(sorted(pts), dtype=np.uint32)
    return out


# --------------------------------------------------------------------------- #
# Point utilities (kimimaro intake.py:268-313,706-745)


def connect_points(labels, start, end, anisotropy=(1, 1, 1),
                   fill_holes: bool = False, in_place: bool = False,
                   pdrf_scale: float = 100000, pdrf_exponent: int = 4,
                   device="cuda") -> Skeleton:
    """Extract one centerline between two points of a binary image
    (kimimaro_tpu.connect_points plus `device`). 2-D points are padded to
    3-D; points in different components (or in the background) raise
    ValueError. `fill_holes` is accepted and, as in the JAX package, does
    nothing. Vertices are in physical units."""
    device = resolve_device(device)
    anisotropy = np.array(anisotropy, dtype=np.float32)
    start = tuple(int(c) for c in start)
    end = tuple(int(c) for c in end)

    labels = np.asarray(labels).astype(bool)
    labels = format_labels(labels, in_place=in_place)

    # the raw component ids (kernel B1) at the two points: equal raw ids
    # are equal compact ids, and 0 is the background
    start3 = (start + (0, 0, 0))[:3]
    end3 = (end + (0, 0, 0))[:3]
    with phase("connect_ccl", device):
        cc = connected_components(_upload(labels, device))
        cs, ce = int(cc[start3]), int(cc[end3])
        del cc
    if cs == 0 or cs != ce:
        raise ValueError(
            "Cannot extract centerline from disconnected components.")

    with phase("point_to_point", device):
        skel = trace_mod.point_to_point(
            labels, start3, end3,
            anisotropy=tuple(float(a) for a in anisotropy),
            pdrf_scale=pdrf_scale, pdrf_exponent=pdrf_exponent,
            device=device)
    skel.vertices *= anisotropy
    skel.space = "physical"
    return skel


def _point_clouds(labels: np.ndarray, ids) -> Dict[object, np.ndarray]:
    """{id: the coordinates of its voxels, in C order} for each of `ids`
    that the volume holds, from one pass: the voxels whose value is one of
    the ids, sorted stably by value. An id counts where it equals its own
    cast to the volume's dtype, as `labels == id` compares."""
    keys = {}
    for label in ids:
        try:
            v = np.asarray(label).astype(labels.dtype)
        except (OverflowError, TypeError, ValueError):
            continue
        if v == label:
            keys[label] = v
    if not keys:
        return {}
    flat = labels.reshape(-1)
    idx = np.flatnonzero(np.isin(
        flat, np.array(list(keys.values()), dtype=labels.dtype)))
    vals = flat[idx]
    order = np.argsort(vals, kind="stable")
    idx, vals = idx[order], vals[order]
    out = {}
    for label, v in keys.items():
        lo = np.searchsorted(vals, v, "left")
        hi = np.searchsorted(vals, v, "right")
        if hi > lo:
            out[label] = np.stack(np.unravel_index(idx[lo:hi], labels.shape),
                                  axis=1)
    return out


def synapses_to_targets(labels, synapses, progress: bool = False
                        ) -> Dict[tuple, int]:
    """Convert synapse centroids into in-label target voxels keyed by SWC
    label (kimimaro intake.py:706-745): for each label and SWC label, the
    label's voxels nearest to each centroid (the first in C order on a
    tie). The labels' voxels come from one pass over the volume
    (`_point_clouds`), in its C order."""
    labels = np.asarray(labels)
    while labels.ndim > 3:
        labels = labels[..., 0]

    clouds = _point_clouds(labels, synapses.keys())
    targets = {}
    for label, pairs in synapses.items():
        point_cloud = clouds.get(label)
        if point_cloud is None:
            continue
        swc_labels = defaultdict(list)
        for centroid, swc_label in pairs:
            swc_labels[swc_label].append(centroid)
        for swc_label, centroids in swc_labels.items():
            distances = scipy.spatial.distance.cdist(point_cloud, centroids)
            minima = np.unique(np.argmin(distances, axis=0))
            for idx in minima:
                targets[tuple(int(c) for c in point_cloud[idx])] = swc_label
    return targets


def print_quotes(parallel: int) -> None:
    """Easter-egg parity with kimimaro intake.py:796-803."""
    if parallel == -1:
        print("Against the power of will I possess... The capability of my body is nothing.")
    elif parallel == -2:
        print("I will see the truth of this world... OROCHIMARU-SAMA WILL SHOW ME!!!")
    if -2 <= parallel < 0:
        print("CURSED SEAL OF THE EARTH!!!")
