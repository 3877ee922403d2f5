"""Host helpers of the analysis functions: bounding-box slices, skeleton
attributes and moving averages (numpy; the counterparts of
kimimaro_tpu.utility's `find_objects`, `add_property` and
`moving_average`)."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import scipy.ndimage

from .skeleton import Skeleton


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
