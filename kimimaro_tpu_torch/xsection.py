"""Cross-sectional area analysis along skeleton paths.

Torch counterpart of kimimaro_tpu.xsection. Adds the per-vertex
attributes `cross_sectional_area` and `cross_sectional_area_contacts` to
skeletons embedded in a labelled volume; supports smoothing_window, step,
multipass, repair_contacts, fill_holes and visualize_section_planes. The
plane normal at each vertex is the smoothed path tangent (forward and
backward moving averages cancel the phase shift).

The default path batches every skeleton's plane queries against the
volume uploaded once (ops.xsbatch). fill_holes and
visualize_section_planes, and volumes whose ids do not fit the int32
equality test, take the per-label bounding-box path (ops.xsarea).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from .intake import resolve_device
from .ops.xsarea import cross_section_areas
from .skeleton import Skeleton
from .utility import add_property, find_objects, moving_average
from .utils.bbox import Bbox

XS_PROP = {
    "id": "cross_sectional_area",
    "data_type": "float32",
    "num_components": 1,
}
XS_CONTACT_PROP = {
    "id": "cross_sectional_area_contacts",
    "data_type": "uint8",
    "num_components": 1,
}


def _skeleton_list(skeletons) -> List[Skeleton]:
    if isinstance(skeletons, dict):
        return list(skeletons.values())
    if hasattr(skeletons, "vertices"):
        return [skeletons]
    return list(skeletons)


def _id_bboxes_device(all_labels, ids, device):
    """Inclusive per-id bounding boxes of the raw label volume, from one
    device pass (ops.ccl.runs_bbox over the volume's ids mapped onto
    1..len(ids)). Returns {id: (mn (3,), mx (3,))} for the ids present,
    or None when the ids fall outside [0, 2^31 - 1) (the caller takes the
    host renumber path)."""
    from .ops.ccl import runs_bbox

    ids = np.asarray(sorted({int(i) for i in ids}), dtype=np.int64)
    if ids.size == 0:
        return {}
    if (all_labels.dtype.kind not in "ui" or int(ids.max()) >= 2**31 - 1
            or int(ids.min()) < 0):
        return None
    if all_labels.dtype.itemsize == 8:
        # values beyond the int32 range match no id: keep them apart
        lab64 = all_labels.view(np.int64)
        flat = np.where((lab64 >= 0) & (lab64 < 2**31 - 1), lab64,
                        -1).astype(np.int32)
    elif all_labels.dtype == np.uint32:
        flat = all_labels.view(np.int32)  # ids >= 2^31 turn negative
    else:
        flat = all_labels.astype(np.int32)
    flat = torch.from_numpy(flat.reshape(-1)).to(device)
    ids_d = torch.from_numpy(ids.astype(np.int32)).to(device)
    pos = torch.searchsorted(ids_d, flat)
    hit = ids_d[torch.clamp(pos, max=ids.size - 1)] == flat
    compact = torch.where(hit, pos + 1, 0).to(torch.int32)
    zeros = torch.zeros((), dtype=torch.float32, device=device).expand(
        compact.numel())
    query = torch.arange(1, ids.size + 1, dtype=torch.int32, device=device)
    _counts, mn, mx, present, _ = runs_bbox(compact, all_labels.shape, query,
                                            zeros)
    mn, mx = mn.cpu().numpy(), mx.cpu().numpy()
    present = present.cpu().numpy()
    return {int(i): (mn[k], mx[k]) for k, i in enumerate(ids) if present[k]}


def shape_iterator(all_labels, skeletons, fill_holes, in_place, progress, fn,
                   device="cpu"):
    """Call fn(skel, binimg, roi) for each skeleton with its binary crop,
    the label's bounding box grown by one voxel."""
    from .ops import fill as fill_ops

    iterator = _skeleton_list(skeletons)
    all_labels = np.asarray(all_labels)
    dev = torch.device(device)

    def crop(binimg, skel, roi):
        if fill_holes:
            binimg = fill_ops.fill(
                torch.from_numpy(binimg).to(dev)).cpu().numpy()
        fn(skel, binimg, roi)

    if all_labels.dtype != bool:
        bboxes = _id_bboxes_device(
            all_labels, [s.id for s in iterator if s.id != 0], dev)
        if bboxes is not None:
            for skel in iterator:
                if skel.id == 0 or skel.id not in bboxes:
                    continue
                mn, mx = bboxes[skel.id]
                roi = Bbox(mn, mx + 1)
                if roi.volume() <= 1:
                    continue
                roi.grow(1)
                roi.minpt = np.clip(roi.minpt, 0, None)
                roi.maxpt = np.minimum(roi.maxpt, np.array(all_labels.shape))
                crop(all_labels[roi.to_slices()] == skel.id, skel, roi)
            return iterator

    if all_labels.dtype == bool:
        remapping = {True: 1, False: 0, 1: 1, 0: 0}
        lookup = all_labels.view(np.uint8)
    else:
        uniq, first_idx, inv = np.unique(
            all_labels, return_index=True, return_inverse=True)
        has_bg = len(uniq) > 0 and uniq[0] == 0
        fg_uniq = uniq[1:] if has_bg else uniq
        fg_first = first_idx[1:] if has_bg else first_idx
        order = np.argsort(fg_first, kind="stable")
        new_ids = np.empty(len(fg_uniq), dtype=np.int64)
        new_ids[order] = np.arange(1, len(fg_uniq) + 1)
        full_new = np.concatenate([[0], new_ids]) if has_bg else new_ids
        lookup = full_new[inv].reshape(all_labels.shape)
        remapping = {int(u): int(n) for u, n in zip(fg_uniq, new_ids)}

    all_slices = find_objects(lookup)

    for skel in iterator:
        label = 1 if all_labels.dtype == bool else skel.id
        if label == 0 or label not in remapping:
            continue
        label = remapping[label]
        slices = all_slices[label - 1]
        if slices is None:
            continue
        roi = Bbox.from_slices(slices)
        if roi.volume() <= 1:
            continue
        roi.grow(1)
        roi.minpt = np.clip(roi.minpt, 0, None)
        roi.maxpt = np.minimum(roi.maxpt, np.array(lookup.shape))
        crop(lookup[roi.to_slices()] == label, skel, roi)
    return iterator


def _default_attributes(skelitr) -> None:
    """Register both attributes; skeletons the driver never visited get
    areas of -1 and no contacts."""
    for skel in skelitr:
        add_property(skel, XS_PROP)
        add_property(skel, XS_CONTACT_PROP)
        if not hasattr(skel, "cross_sectional_area"):
            skel.cross_sectional_area = np.full(
                len(skel.vertices), -1, dtype=np.float32)
        if not hasattr(skel, "cross_sectional_area_contacts"):
            skel.cross_sectional_area_contacts = np.zeros(
                len(skel.vertices), dtype=np.uint8)


def cross_sectional_area(
    all_labels,
    skeletons: Union[Dict[int, Skeleton], List[Skeleton], Skeleton],
    anisotropy=np.array([1, 1, 1], dtype=np.float32),
    smoothing_window: int = 1,
    progress: bool = False,
    in_place: bool = False,
    fill_holes: bool = False,
    multipass: bool = False,
    repair_contacts: bool = False,
    visualize_section_planes: bool = False,
    step: int = 1,
    device="cuda",
):
    """Per-vertex cross sectional areas for skeletons embedded in a
    labelled volume: the signature of kimimaro_tpu.cross_sectional_area
    plus `device` ("cuda" or "cpu"). Returns `skeletons`, updated."""
    assert step > 0
    assert smoothing_window > 0
    dev = resolve_device(device)
    anisotropy = np.asarray(anisotropy, dtype=np.float32)

    if (not fill_holes and not visualize_section_planes
            and _cross_sectional_area_batched(
                all_labels, skeletons, anisotropy, smoothing_window,
                multipass, repair_contacts, step, dev)):
        return skeletons

    def helper(skel, binimg, roi):
        _cross_sectional_area_impl(
            binimg, skel, roi, anisotropy, smoothing_window, multipass,
            repair_contacts, visualize_section_planes, step, dev)

    shape_iterator(all_labels, skeletons, fill_holes, in_place, progress,
                   helper, dev)
    _default_attributes(_skeleton_list(skeletons))
    return skeletons


def cross_sectional_area_single(
    binimg,
    skel: Skeleton,
    roi: Optional[Bbox] = None,
    anisotropy=np.array([1, 1, 1], dtype=np.float32),
    smoothing_window: int = 1,
    progress: bool = False,
    in_place: bool = False,
    multipass: bool = False,
    repair_contacts: bool = False,
    visualize_section_planes: bool = False,
    step: int = 1,
    device="cuda",
) -> Skeleton:
    """Cross sectional areas for one skeleton and an overlapping binary
    image: the signature of kimimaro_tpu.cross_sectional_area_single plus
    `device`."""
    assert step > 0
    assert smoothing_window > 0
    dev = resolve_device(device)
    anisotropy = np.asarray(anisotropy, dtype=np.float32)
    return _cross_sectional_area_impl(
        binimg, skel, roi, anisotropy, smoothing_window, multipass,
        repair_contacts, visualize_section_planes, step, dev)


def _collect_queries(skel, shape, roi_min, anisotropy, smoothing_window,
                     multipass, repair_contacts, step):
    """This skeleton's (vertex, normal) sectioning queries with the
    per-path stride, branch-point and repair gating.

    Returns (areas, contacts, query_verts, query_normals, query_idx,
    branch_pts)."""
    shape = np.asarray(shape)
    if skel.space == "physical":
        all_verts = (skel.vertices / anisotropy).round().astype(int)
    else:
        all_verts = np.copy(skel.vertices).astype(int)
    if roi_min is not None:
        all_verts = all_verts - roi_min

    mapping = {tuple(v): i for i, v in enumerate(all_verts)}
    visited = np.zeros(all_verts.shape[0], dtype=bool)

    if repair_contacts or (multipass and hasattr(skel, "cross_sectional_area")):
        areas = skel.cross_sectional_area
        contacts = skel.cross_sectional_area_contacts
    else:
        # zero = "skipped in this pass"; -1 marks skeletons the driver
        # never visited at all
        areas = np.zeros(all_verts.shape[0], dtype=np.float32)
        contacts = np.zeros(all_verts.shape[0], dtype=np.uint8)

    branch_pts = set(int(b) for b in skel.branches())
    query_verts: List[tuple] = []
    query_normals: List[np.ndarray] = []
    query_idx: List[int] = []

    for path in skel.paths():
        if skel.space == "physical":
            path = (path / anisotropy).round().astype(int)
        else:
            path = path.astype(int)
        if roi_min is not None:
            path = path - roi_min
        if len(path) < 2:
            continue

        normals = (path[1:] - path[:-1]).astype(np.float32)
        normals = np.concatenate([normals, [normals[-1]]])
        # forward+backward moving average kills phase shift
        normals = moving_average(normals, smoothing_window)
        normals = moving_average(normals[::-1], smoothing_window)[::-1]
        norm = np.linalg.norm(normals, axis=1, keepdims=True)
        norm[norm == 0] = 1.0
        normals = normals / norm

        end_i = len(path) - 1
        ct = 0
        for i, vert in enumerate(path):
            ct += 1
            if ct < step and not (i == 0 or i == end_i):
                continue
            elif ct == step:
                ct = 0
            if np.any(vert < 0) or np.any(vert >= shape):
                continue
            idx = mapping[tuple(vert)]
            if (areas[idx] == 0 or (idx in branch_pts)
                    or (repair_contacts and contacts[idx] > 0
                        and not visited[idx])):
                visited[idx] = True
                query_verts.append(tuple(vert))
                query_normals.append(normals[i])
                query_idx.append(idx)

    return areas, contacts, query_verts, query_normals, query_idx, branch_pts


def _apply_results(skel, areas, contacts, query_idx, branch_pts,
                   qareas, qcontacts, repair_contacts):
    """Scatter the query results back onto the skeleton (branch points
    average over their incident paths)."""
    branch_pt_vals = defaultdict(list)
    for k, idx in enumerate(query_idx):
        areas[idx] = qareas[k]
        if repair_contacts:
            contacts[idx] = qcontacts[k]
        else:
            contacts[idx] |= qcontacts[k]
        if idx in branch_pts:
            branch_pt_vals[idx].append(float(qareas[k]))

    for idx, vals in branch_pt_vals.items():
        areas[idx] = sum(vals) / len(vals)

    skel.cross_sectional_area = np.asarray(areas, dtype=np.float32)
    skel.cross_sectional_area_contacts = np.asarray(contacts, dtype=np.uint8)
    add_property(skel, XS_PROP)
    add_property(skel, XS_CONTACT_PROP)
    return skel


def _cross_sectional_area_batched(all_labels, skeletons, anisotropy,
                                  smoothing_window, multipass,
                                  repair_contacts, step, device) -> bool:
    """Every skeleton's queries in shared full-volume batches
    (ops.xsbatch). Returns False when the volume's ids cannot ride the
    int32 equality test (the caller takes the per-label path)."""
    from .ops.xsbatch import cross_section_areas_volume

    skelitr = _skeleton_list(skeletons)
    all_labels = np.asarray(all_labels)
    if all_labels.ndim != 3 or (
            all_labels.dtype != bool and all_labels.dtype.kind not in "ui"):
        return False
    shape = all_labels.shape

    states = []
    qv, qn, qlab, qrad = [], [], [], []
    for skel in skelitr:
        label = 1 if all_labels.dtype == bool else skel.id
        if label == 0 or skel.vertices.shape[0] == 0:
            continue
        areas, contacts, verts, normals, idx, branch_pts = _collect_queries(
            skel, shape, None, anisotropy, smoothing_window, multipass,
            repair_contacts, step)
        states.append((skel, areas, contacts, idx, branch_pts, len(verts)))
        if verts:
            qv.append(np.asarray(verts, dtype=np.int32))
            qn.append(np.asarray(normals, dtype=np.float32))
            qlab.append(np.full(len(verts), label, dtype=np.int64))
            if skel.radii.size:
                qrad.append(skel.radii[np.asarray(idx, dtype=np.int64)]
                            .astype(np.float32))
            else:
                qrad.append(np.full(len(verts), -1.0, dtype=np.float32))

    if qv:
        out = cross_section_areas_volume(
            all_labels, np.concatenate(qv), np.concatenate(qn),
            np.concatenate(qlab), anisotropy, radii=np.concatenate(qrad),
            device=device)
        if out is None:
            return False
        qareas, qcontacts = out
    else:
        qareas = np.zeros(0, dtype=np.float32)
        qcontacts = np.zeros(0, dtype=np.uint8)

    off = 0
    for skel, areas, contacts, idx, branch_pts, nq in states:
        _apply_results(skel, areas, contacts, idx, branch_pts,
                       qareas[off: off + nq], qcontacts[off: off + nq],
                       repair_contacts)
        off += nq
    _default_attributes(skelitr)
    return True


def _cross_sectional_area_impl(binimg, skel, roi, anisotropy,
                               smoothing_window, multipass, repair_contacts,
                               visualize_section_planes, step,
                               device) -> Skeleton:
    binimg = np.asarray(binimg)
    roi_min = roi.minpt if roi is not None else None
    areas, contacts, query_verts, query_normals, query_idx, branch_pts = \
        _collect_queries(skel, binimg.shape, roi_min, anisotropy,
                         smoothing_window, multipass, repair_contacts, step)

    if query_verts:
        qareas, qcontacts = cross_section_areas(
            binimg, np.array(query_verts), np.array(query_normals),
            anisotropy, device=device)
    else:
        qareas = np.zeros(0, dtype=np.float32)
        qcontacts = np.zeros(0, dtype=np.uint8)

    if visualize_section_planes and query_verts:
        from .ops.xsarea import cross_section_image

        cross_sections = np.zeros(binimg.shape, dtype=np.uint32)
        for k, idx in enumerate(query_idx):
            img = cross_section_image(binimg, query_verts[k],
                                      query_normals[k], anisotropy,
                                      device=device)
            cross_sections[img > 0] = idx
        try:
            import microviewer

            microviewer.view(cross_sections, seg=True)
        except ImportError:
            print("kimimaro_tpu_torch: microviewer not installed; "
                  "skipping view.")

    return _apply_results(skel, areas, contacts, query_idx, branch_pts,
                          qareas, qcontacts, repair_contacts)
