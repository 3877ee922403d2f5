"""Out-of-core / multi-host chunked skeletonization (a copy of
kimimaro_tpu.chunked on the port's `skeletonize` and `postprocess`).

kimimaro's cross-machine scaling story is zero-communication spatial
decomposition (kimimaro README.md:389-409): chunks are skeletonized
independently with fix_borders=True so adjacent chunks pin deterministic
endpoints on their shared faces (1-voxel overlap), and the per-label
fragments are later fused with simple_merge + postprocess. This module
makes that protocol a first-class API. The same protocol serves volumes
larger than one card's memory; `device` (and every other keyword of
`skeletonize`) passes through.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from .intake import DEFAULT_TEASAR_PARAMS, skeletonize
from .post import postprocess
from .skeleton import Skeleton


def chunk_bounds(
    shape: Sequence[int], chunk_size: Sequence[int]
) -> List[Tuple[Tuple[int, int, int], Tuple[int, int, int]]]:
    """Grid of chunk bounds with the protocol's 1-voxel face overlap:
    chunk k spans [k*cs, (k+1)*cs + 1) clipped to the volume, so adjacent
    chunks share exactly one plane (kimimaro README.md:391-393)."""
    out = []
    cs = [int(c) for c in chunk_size]
    grid = [max(1, -(-int(s) // c)) for s, c in zip(shape, cs)]
    for ix in range(grid[0]):
        for iy in range(grid[1]):
            for iz in range(grid[2]):
                lo = (ix * cs[0], iy * cs[1], iz * cs[2])
                hi = tuple(
                    min(int(shape[a]) , lo[a] + cs[a] + 1) for a in range(3)
                )
                out.append((lo, hi))
    return out


def skeletonize_chunk(
    labels_chunk,
    offset: Sequence[int],
    teasar_params=DEFAULT_TEASAR_PARAMS,
    anisotropy: Sequence[float] = (1, 1, 1),
    **kwargs,
) -> Dict[int, Skeleton]:
    """Skeletonize one chunk (independently schedulable on any machine) and
    translate results into the global physical frame."""
    kwargs.setdefault("fix_borders", True)
    skels = skeletonize(
        labels_chunk, teasar_params=teasar_params, anisotropy=anisotropy,
        **kwargs,
    )
    shift = np.asarray(offset, dtype=np.float32) * np.asarray(
        anisotropy, dtype=np.float32
    )
    for skel in skels.values():
        skel.vertices = skel.vertices + shift
    return skels


def merge_chunk_skeletons(
    per_chunk: Sequence[Dict[int, Skeleton]],
    dust_threshold: float = 0.0,
    tick_threshold: float = 0.0,
) -> Dict[int, Skeleton]:
    """Fuse per-chunk fragments by label: simple_merge + consolidate heals
    the shared-face vertices; postprocess (loops/dust/join/ticks) repairs
    the seams (kimimaro README.md:100-112, post.py:49-87)."""
    grouped: Dict[int, List[Skeleton]] = defaultdict(list)
    for skels in per_chunk:
        for segid, skel in skels.items():
            grouped[segid].append(skel)

    merged = {}
    for segid, parts in grouped.items():
        skel = Skeleton.simple_merge(parts).consolidate()
        skel.id = segid
        if dust_threshold > 0 or tick_threshold > 0:
            skel = postprocess(
                skel, dust_threshold=dust_threshold,
                tick_threshold=tick_threshold,
            )
        merged[segid] = skel
    return merged


def skeletonize_chunked(
    all_labels,
    chunk_size: Sequence[int] = (512, 512, 512),
    teasar_params=DEFAULT_TEASAR_PARAMS,
    anisotropy: Sequence[float] = (1, 1, 1),
    dust_threshold: int = 1000,
    postprocess_params: Optional[dict] = None,
    progress: bool = False,
    **kwargs,
) -> Dict[int, Skeleton]:
    """Skeletonize a volume larger than one device pass chunk-by-chunk and
    merge the fragments. `postprocess_params` (dust_threshold /
    tick_threshold, physical units) control seam repair."""
    all_labels = np.asarray(all_labels)
    while all_labels.ndim < 3:
        all_labels = all_labels[..., np.newaxis]

    bounds = chunk_bounds(all_labels.shape, chunk_size)
    per_chunk = []
    for lo, hi in bounds:
        slc = tuple(slice(a, b) for a, b in zip(lo, hi))
        chunk = all_labels[slc]
        if not chunk.any():
            continue
        per_chunk.append(
            skeletonize_chunk(
                chunk, lo, teasar_params=teasar_params,
                anisotropy=anisotropy, dust_threshold=dust_threshold,
                progress=progress, **kwargs,
            )
        )

    pp = postprocess_params or {}
    return merge_chunk_skeletons(
        per_chunk,
        dust_threshold=pp.get("dust_threshold", 0.0),
        tick_threshold=pp.get("tick_threshold", 0.0),
    )
