"""Utility layer: CCL with the original-label mapping, bounding-box
slices, skeleton attributes, binary skeleton import and moving averages
(the counterparts of kimimaro_tpu.utility; CCL on the port's
ops.ccl.connected_components, the rest host numpy)."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.ndimage

from .skeleton import Skeleton


def compute_cc_labels(all_labels, voxel_graph=None, device="cuda"
                      ) -> Tuple[np.ndarray, Dict[int, int]]:
    """26-connected multi-label CCL + cc-id -> original-label mapping
    (kimimaro utility.py:58-83). Output cc ids are contiguous 1..N in
    first-appearance (scan) order; background is 0. `voxel_graph`: an
    optional cc3d-convention bitfield (self-touch walls). The CCL runs on
    `device`."""
    import torch

    from .intake import _upload, resolve_device
    from .ops.ccl import connected_components

    device = resolve_device(device)
    all_labels = np.asarray(all_labels)
    vg = None
    if voxel_graph is not None:
        vg = torch.from_numpy(np.ascontiguousarray(
            voxel_graph, dtype=np.uint32)).to(device)
    cc_raw = connected_components(
        _upload(all_labels, device), voxel_graph=vg).cpu().numpy()

    uniq, first_idx, inv = np.unique(cc_raw, return_index=True,
                                     return_inverse=True)
    has_bg = len(uniq) > 0 and uniq[0] == 0
    fg_uniq = uniq[1:] if has_bg else uniq
    fg_first = first_idx[1:] if has_bg else first_idx

    # number components by first appearance in scan order (deterministic)
    order = np.argsort(fg_first, kind="stable")
    new_ids = np.empty(len(fg_uniq), dtype=np.int64)
    new_ids[order] = np.arange(1, len(fg_uniq) + 1)

    full_new = np.concatenate([[0], new_ids]) if has_bg else new_ids
    cc_labels = full_new[inv].reshape(cc_raw.shape)

    dtype = np.uint16 if len(fg_uniq) < 2**16 else np.uint32
    cc_labels = cc_labels.astype(dtype)

    flat_orig = all_labels.reshape(-1)
    remapping = {
        int(nid): int(flat_orig[fidx])
        for nid, fidx in zip(new_ids, fg_first)
    }
    return cc_labels, remapping


def find_objects(labels) -> List[Optional[tuple]]:
    """Per-label bounding-box slices, indexed by label-1."""
    return scipy.ndimage.find_objects(np.ascontiguousarray(labels))


def add_property(skel: Skeleton, prop: dict) -> None:
    """Register an extra per-vertex attribute if absent."""
    for existing in skel.extra_attributes:
        if existing["id"] == prop["id"]:
            return
    skel.extra_attributes.append(dict(prop))


def moving_average(a: np.ndarray, n: int, mode: str = "symmetric") -> np.ndarray:
    """Length-preserving moving average with symmetric edge padding."""
    if n <= 0:
        raise ValueError(f"Window size ({n}), must be >= 1.")
    if n == 1:
        return a
    a = np.asarray(a)
    if len(a) == 0:
        return a
    if a.ndim == 2:
        a = np.pad(a, [[n, n], [0, 0]], mode=mode)
    else:
        a = np.pad(a, [n, n], mode=mode)
    ret = np.cumsum(a, dtype=float, axis=0)
    ret = (ret[n:] - ret[:-n])[:-n]
    ret /= float(n)
    return ret


# --------------------------------------------------------------------------- #
# Binary skeleton image -> graph (kimimaro utility.py:54-56,
# skeletontricks.hpp:448-495)

_HALF26 = [
    (dx, dy, dz)
    for dx in (-1, 0, 1)
    for dy in (-1, 0, 1)
    for dz in (-1, 0, 1)
    if (dx, dy, dz) > (0, 0, 0)
]  # 13 forward directions: each 26-edge counted once


def extract_skeleton_from_binary_image(image) -> Skeleton:
    """Convert a voxel skeleton image into a vertex/edge Skeleton.

    Each pair of 26-adjacent foreground voxels becomes one edge. Vertices
    are emitted in scan order.
    """
    img = np.asarray(image)
    while img.ndim < 3:
        img = img[..., np.newaxis]
    fg = img != 0

    coords = np.argwhere(fg)
    n = coords.shape[0]
    vert_id = -np.ones(fg.shape, dtype=np.int64)
    vert_id[tuple(coords.T)] = np.arange(n)

    edges = []
    for off in _HALF26:
        src = coords
        dst = coords + np.array(off)
        inb = np.all((dst >= 0) & (dst < np.array(fg.shape)), axis=1)
        src, dst = src[inb], dst[inb]
        hit = fg[tuple(dst.T)]
        if np.any(hit):
            e = np.stack(
                [vert_id[tuple(src[hit].T)], vert_id[tuple(dst[hit].T)]], axis=1
            )
            edges.append(e)
    edges = (
        np.concatenate(edges, axis=0).astype(np.uint32)
        if edges
        else np.zeros((0, 2), dtype=np.uint32)
    )
    return Skeleton(coords.astype(np.float32), edges)
