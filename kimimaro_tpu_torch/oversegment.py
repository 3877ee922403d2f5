"""Skeleton-guided oversegmentation.

Torch counterpart of kimimaro_tpu.oversegment: per label, the multi-source
geodesic distance field seeded at the (optionally downsampled) skeleton
vertices assigns every voxel of the label's crop to its nearest vertex,
giving a composite label map renumbered from 1 in order of first
appearance and a per-vertex `segments` attribute. The crops are gathered
first, sorted by their bucket shape and cut into batches under a device
memory budget (BATCH_BYTES); each batch's fields are one call of
ops.geodesic.voronoi_feature_field_batched (kernel V1's lane-batched form
on CUDA: one launch per directed sweep for the whole batch; a crop whose
planes exceed one CTA's shared memory takes V1's single-volume forms). The
composite is summed and renumbered on `device`.

Phases: oversegment_crops (the crops, with their fields), oversegment_v1
(the fields alone), oversegment_renumber, oversegment_segments. Counters:
voronoi_rounds (lane-rounds), voronoi_batches, voronoi_voxels,
voronoi_padded_voxels, voronoi_single_lanes.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from .intake import resolve_device
from .ops.geodesic import (VORONOI_BYTES_PER_VOXEL, voronoi_bucket,
                           voronoi_feature_field,
                           voronoi_feature_field_batched)
from .skeleton import Skeleton
from .utility import add_property
from .utils.profiling import phase
from .xsection import shape_iterator

# device bytes a batch of crops' fields may take
BATCH_BYTES = 4 << 30

SEGMENTS_PROP = {
    "id": "segments",
    "data_type": "uint64",
    "num_components": 1,
}


def renumber_first_appearance(vol: torch.Tensor) -> torch.Tensor:
    """The ids of a non-negative int64 volume renumbered 1, 2, ... in order
    of first appearance in C order, 0 kept (fastremap.renumber's result,
    as the JAX package computes it with np.unique)."""
    flat = vol.reshape(-1)
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    first = torch.full((uniq.numel(),), flat.numel(), dtype=torch.int64,
                       device=vol.device)
    first.scatter_reduce_(0, inv, torch.arange(flat.numel(),
                                               device=vol.device), "amin")
    has_bg = uniq.numel() > 0 and int(uniq[0]) == 0
    fg_first = first[1:] if has_bg else first
    fg_new = torch.empty_like(fg_first)
    fg_new[torch.argsort(fg_first)] = torch.arange(
        1, fg_first.numel() + 1, device=vol.device)
    if has_bg:
        fg_new = torch.cat([fg_new.new_zeros(1), fg_new])
    return fg_new[inv].reshape(vol.shape)


def _batches(crops):
    """The crops' indices by bucket shape, cut into runs whose padded
    voxels take at most BATCH_BYTES (a crop above it alone)."""
    keys = [voronoi_bucket(c[0].shape) for c in crops]
    order = sorted(range(len(crops)), key=lambda i: (keys[i], i))
    out, cur, held = [], [], 0
    for i in order:
        b = int(np.prod(keys[i])) * VORONOI_BYTES_PER_VOXEL
        if cur and held + b > BATCH_BYTES:
            out.append(cur)
            cur, held = [], 0
        cur.append(i)
        held += b
    if cur:
        out.append(cur)
    return out


def oversegment(
    all_labels: np.ndarray,
    skeletons: Union[Dict[int, Skeleton], List[Skeleton], Skeleton],
    anisotropy=np.array([1, 1, 1], dtype=np.float32),
    progress: bool = False,
    fill_holes: bool = False,
    in_place: bool = False,
    downsample: int = 0,
    device="cuda",
) -> Tuple[np.ndarray, Union[Dict[int, Skeleton], List[Skeleton], Skeleton]]:
    """Split pre-existing labels into per-skeleton-vertex territories (the
    signature of kimimaro_tpu.oversegment plus `device`). Returns the
    uint64 composite and a copy of `skeletons` with `segments` set."""
    return _oversegment(all_labels, skeletons, anisotropy, progress,
                        fill_holes, in_place, downsample, device)


def _oversegment(all_labels, skeletons, anisotropy, progress, fill_holes,
                 in_place, downsample, device, per_crop: bool = False):
    """`oversegment`; with `per_crop`, the reference route that runs
    voronoi_feature_field on each crop in turn, with the same result."""
    device = resolve_device(device)
    anisotropy = np.asarray(anisotropy, dtype=np.float32)
    anis = tuple(float(a) for a in anisotropy)
    skeletons = copy.deepcopy(skeletons)

    if hasattr(skeletons, "vertices"):
        skeleton_list = [skeletons]
    elif isinstance(skeletons, dict):
        skeleton_list = list(skeletons.values())
    else:
        skeleton_list = skeletons

    all_labels = np.asarray(all_labels)
    all_features = torch.zeros(all_labels.shape, dtype=torch.int64,
                               device=device)
    next_label = 0
    crops = []  # (binary crop, roi, seeds, first id), in iteration order

    def helper(skel, binimg, roi):
        nonlocal next_label

        segment_skel = skel
        if downsample > 0:
            segment_skel = skel.downsample(downsample)

        vertices = (segment_skel.vertices / anisotropy).round().astype(int)
        vertices = vertices - roi.minpt
        shape = np.array(binimg.shape)
        inb = np.all((vertices >= 0) & (vertices < shape), axis=1)
        vertices = vertices[inb]
        if vertices.shape[0] == 0:
            return

        add_property(skel, SEGMENTS_PROP)
        crops.append((binimg, roi, vertices, next_label))
        next_label += vertices.shape[0]

    def add(feature_map, ok, roi, first):
        feature_map = feature_map.to(torch.int64)
        feature_map = torch.where(ok, feature_map + first, feature_map)
        all_features[roi.to_slices()] += feature_map

    with phase("oversegment_crops", device):
        shape_iterator(all_labels, skeletons, fill_holes, in_place, progress,
                       helper, device=device)
        if per_crop:
            for binimg, roi, vertices, first in crops:
                ok = torch.from_numpy(binimg).to(device)
                with phase("oversegment_v1", device):
                    _, feature_map = voronoi_feature_field(ok, vertices, anis)
                add(feature_map, ok, roi, first)
        else:
            for batch in _batches(crops):
                with phase("oversegment_v1", device):
                    fields = voronoi_feature_field_batched(
                        [crops[i][0] for i in batch],
                        [crops[i][2] for i in batch], anis, device=device,
                        with_ok=True)
                for i, (_, feature_map, ok) in zip(batch, fields):
                    add(feature_map, ok, crops[i][1], crops[i][3])
                del fields

    with phase("oversegment_renumber", device):
        all_features = renumber_first_appearance(all_features)
        all_features = all_features.cpu().numpy().astype(np.uint64)

    with phase("oversegment_segments"):
        for skel in skeleton_list:
            vertices = (skel.vertices / anisotropy).round().astype(int)
            shape = np.array(all_features.shape)
            vertices = np.clip(vertices, 0, shape - 1)
            skel.segments = all_features[
                vertices[:, 0], vertices[:, 1], vertices[:, 2]
            ]

    return all_features, skeletons
