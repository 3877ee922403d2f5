"""Skeleton-guided oversegmentation.

Torch counterpart of kimimaro_tpu.oversegment: per label, the multi-source
geodesic distance field seeded at the (optionally downsampled) skeleton
vertices assigns every voxel of the label's crop to its nearest vertex
(ops.geodesic.voronoi_feature_field, kernel V1 on CUDA), giving a
composite label map renumbered from 1 in order of first appearance and a
per-vertex `segments` attribute. The composite is summed and renumbered on
`device`.

Phases: oversegment_crops (the crops, with their fields), oversegment_v1
(the fields alone), oversegment_renumber, oversegment_segments.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Tuple, Union

import numpy as np
import torch

from .intake import resolve_device
from .ops.geodesic import voronoi_feature_field
from .skeleton import Skeleton
from .utility import add_property
from .utils.profiling import phase
from .xsection import shape_iterator

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

        ok = torch.from_numpy(binimg).to(device)
        with phase("oversegment_v1", device):
            _, feature_map = voronoi_feature_field(ok, vertices, anis)

        add_property(skel, SEGMENTS_PROP)

        feature_map = feature_map.to(torch.int64)
        feature_map = torch.where(ok, feature_map + next_label, feature_map)
        next_label += vertices.shape[0]
        all_features[roi.to_slices()] += feature_map

    with phase("oversegment_crops", device):
        shape_iterator(all_labels, skeletons, fill_holes, in_place, progress,
                       helper, device=device)

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
