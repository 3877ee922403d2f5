"""Whole-image skeletonization pipeline (the `skeletonize` driver).

Torch counterpart of kimimaro_tpu.intake on its main path: the preamble
(CCL, EDT, per-label metadata, border targets) runs as full-volume device
passes on `device`; the global lock-step engine (gengine) traces every
label it can hold; the labels it hands back (soma candidates, manual
target overflow, bboxes beyond its crop tiers, unconverged labels) go to
the batched crop engine (engine.trace_batched); and only the labels the
crop engine cannot hold are traced one by one by the host trace path
(trace.trace).

Stages: upload, ccl, edt, label_info, border_targets, gengine,
crop_engine, finalize, host_fallback, merge.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch

from . import engine, gengine
from . import trace as trace_mod
from .ops import edt as edt_ops
from .ops.ccl import compact_cc, connected_components, label_info
from .skeleton import Skeleton
from .utils import profiling
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


def resolve_device(device) -> torch.device:
    """The working device; asking for CUDA where there is none raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' was requested but CUDA is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


def _upload(labels: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host -> device copy of the labels as int32 (unsigned 32-bit values
    bitcast, which keeps equality and != 0), pinned for a CUDA target."""
    if labels.dtype.kind == "u" or labels.dtype == bool:
        arr = np.ascontiguousarray(labels.astype(np.uint32, copy=False))
        arr = arr.view(np.int32)
    else:
        arr = np.ascontiguousarray(labels.astype(np.int32, copy=False))
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


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
    """Skeletonize all nonzero labels of a 2D/3D integer volume.

    The signature of kimimaro_tpu.skeletonize plus `device` ("cuda" or
    "cpu"). Returns {segid: Skeleton} with vertices in physical space.
    `progress`, `parallel` and `parallel_chunk_size` are accepted for API
    parity. `fill_holes`, `fix_avocados` and `voxel_graph` are not ported
    yet and raise.
    """
    if fill_holes or fix_avocados or voxel_graph is not None:
        raise NotImplementedError(
            "fill_holes, fix_avocados and voxel_graph are not ported yet")
    device = resolve_device(device)
    anisotropy = np.array(anisotropy, dtype=np.float32)

    all_labels = format_labels(all_labels,
                               in_place=in_place or object_ids is None)
    all_labels = apply_object_mask(all_labels, object_ids)
    if all_labels.size <= dust_threshold:
        return {}
    minlabel, maxlabel = int(all_labels.min()), int(all_labels.max())
    if minlabel == 0 and maxlabel == 0:
        return {}

    # labels wider than 32 bits are renumbered on the host first; wide_back
    # restores the original ids at the end
    wide_back = None
    if all_labels.dtype.itemsize > 4:
        u = np.unique(all_labels)
        u_nz = u[u != 0]
        compact = np.searchsorted(u_nz, all_labels).astype(np.uint32) + 1
        compact[all_labels == 0] = 0
        wide_back = {i + 1: int(v) for i, v in enumerate(u_nz)}
        all_labels = compact

    with phase("upload", device):
        labels_dev = _upload(all_labels, device)
    with phase("ccl", device):
        cc_dev, n_components, rep_prefix = compact_cc(
            connected_components(labels_dev))
    if n_components == 0:
        return {}

    with phase("edt", device):
        dbf_dev = edt_ops.edt(
            cc_dev, anisotropy=tuple(float(a) for a in anisotropy),
            black_border=(minlabel == maxlabel))
    with phase("label_info", device):
        n_max = 1 << max(int(np.ceil(np.log2(max(n_components, 2)))), 1)
        info = label_info(cc_dev, labels_dev, n_max=n_max,
                          rep_prefix=rep_prefix, dbf=dbf_dev)
        counts, bbmin, bbmax, orig, dbfmax_arr = (
            a.to("cpu").numpy()[: n_components + 1] for a in info)
        orig = orig.view(np.uint32)
    remapping = {i: int(orig[i]) for i in range(1, n_components + 1)}
    counts_map = {i: int(counts[i]) for i in range(1, n_components + 1)}
    bb = {i: (bbmin[i], bbmax[i])
          for i in range(1, n_components + 1) if counts[i] > 0}
    segid_iter = [s for s in range(1, n_components + 1)
                  if counts_map.get(s, 0) > dust_threshold and s in bb]
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

    # --- per-label jobs
    jobs = []
    for segid in segid_iter:
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

        jobs.append({
            "segid": segid,
            "offset": mn,
            "shape": shape,
            "before": manual_before,
            "after": manual_after,
            "root": root,
            "count": counts_map.get(segid, 0),
            "dbfmax": float(dbfmax_arr[segid]),
        })

    with phase("gengine", device):
        # each component's lexicographically first voxel, from the monotone
        # root prefix (compact ids are first-appearance ordered)
        fv_flat = torch.searchsorted(
            rep_prefix, torch.arange(1, n_components + 1, dtype=torch.int32,
                                     device=device)).to("cpu").numpy()
        fv_flat = np.minimum(fv_flat, all_labels.size - 1)
        firstvox_arr = np.zeros((n_components + 1, 3), np.int64)
        firstvox_arr[1:] = np.stack(
            np.unravel_index(fv_flat, tuple(cc_dev.shape)), axis=-1)
        results, crop_jobs = gengine.trace_global(
            cc_dev, dbf_dev, jobs, teasar_params, anisotropy, fix_branching,
            firstvox_arr=firstvox_arr)
    profiling.count("crop_engine_jobs", len(crop_jobs))
    with phase("crop_engine", device):
        crop_results, fallback_jobs = engine.trace_batched(
            cc_dev, dbf_dev, crop_jobs, teasar_params, anisotropy,
            fix_branching)
        results.update(crop_results)
    profiling.count("engine_jobs", len(jobs) - len(fallback_jobs))
    profiling.count("fallback_jobs", len(fallback_jobs))

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
            fallback_jobs, cc_dev, dbf_dev, remapping, skeletons,
            teasar_params, anisotropy, fix_branching)

    with phase("merge"):
        return merge(skeletons)


def _run_host_fallback(fallback_jobs, cc_dev, dbf_dev, remapping, skeletons,
                       teasar_params, anisotropy, fix_branching):
    """Per-label host trace loop for the jobs the crop engine could not
    hold: more than T_CAP manual targets, path capacity overflow, or
    relaxations still unconverged after its escalation (kimimaro's plain
    serial path, intake.py:434-517). The crops stay on the device of
    `cc_dev`."""
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

def _face_stack(cc: torch.Tensor) -> torch.Tensor:
    """The six border faces of a volume packed into one (11, P0, P1)
    zero-padded stack with zero separator planes between faces (26-conn
    CCL cannot merge across a zero plane)."""
    sx, sy, sz = cc.shape
    P0, P1 = max(sx, sy), max(sy, sz)
    faces = [
        cc[:, :, 0], cc[:, :, -1],
        cc[:, 0, :], cc[:, -1, :],
        cc[0, :, :], cc[-1, :, :],
    ]
    stack = torch.zeros((11, P0, P1), dtype=cc.dtype, device=cc.device)
    for i, f in enumerate(faces):
        stack[2 * i, : f.shape[0], : f.shape[1]] = f
    return stack


def compute_border_targets(cc_labels: torch.Tensor, anisotropy) -> Dict[int, np.ndarray]:
    """For each of the six faces: 2D CCL + 2D EDT + deterministic per-label
    max picks (kimimaro intake.py:544-585). All six faces ride one batched
    CCL call and three batched EDT calls (one per anisotropy pair);
    padding with background is exact because a zero-label neighbour
    raises the same distance wall as `black_border`."""
    sx, sy, sz = cc_labels.shape

    face_meta = (
        ((sx, sy), (0, 1), lambda x, y: (x, y, 0)),
        ((sx, sy), (0, 1), lambda x, y: (x, y, sz - 1)),
        ((sx, sz), (0, 2), lambda x, z: (x, 0, z)),
        ((sx, sz), (0, 2), lambda x, z: (x, sy - 1, z)),
        ((sy, sz), (1, 2), lambda y, z: (0, y, z)),
        ((sy, sz), (1, 2), lambda y, z: (sx - 1, y, z)),
    )

    stack_dev = _face_stack(cc_labels.to(torch.int32))
    cc_stack_dev = connected_components(stack_dev)
    stack_np = stack_dev[0::2].to("cpu").numpy()
    cc_stack = cc_stack_dev[0::2].to("cpu").numpy()

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
        dt = dt.to("cpu").numpy()
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


def print_quotes(parallel: int) -> None:
    """Easter-egg parity with kimimaro intake.py:796-803."""
    if parallel == -1:
        print("Against the power of will I possess... The capability of my body is nothing.")
    elif parallel == -2:
        print("I will see the truth of this world... OROCHIMARU-SAMA WILL SHOW ME!!!")
    if -2 <= parallel < 0:
        print("CURSED SEAL OF THE EARTH!!!")
