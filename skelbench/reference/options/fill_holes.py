"""`fill_holes`: every 26-connected component of every label has its holes
filled with it before tracing, one component after another.

The components are the reference's own (`teasar.components` of each label
in its box), numbered 1.. in scan order: by the C-order index of their
first voxel, which names them alike under every relabelling of the ids.
In that order each component's box is filled by scipy's
`binary_fill_holes` (a hole: voxels off the component that no path of
face-adjacent such voxels joins to the box's faces), and the hole voxels
take the component. A component with a voxel in an earlier component's
hole is absorbed and not filled itself (kimimaro's serial form).
"""

from __future__ import annotations

import contextlib
import multiprocessing

import numpy as np
from scipy import ndimage

from .. import teasar

# the per-component work of a volume of POOL_FROM voxels or more runs on
# WORKERS processes
WORKERS = 7
POOL_FROM = 1 << 22


def _components(job):
    """(value, the 26-connected components of `crop == value` (0 off it),
    the flat index in the crop of each component's first voxel)."""
    value, crop = job
    comp, n = teasar.components(crop == value)
    flat = comp.ravel()
    on = np.flatnonzero(flat)
    _, first = np.unique(flat[on], return_index=True)
    return value, comp.astype(np.uint8 if n < 256 else np.int32), on[first]


def scan_components(labels, pool=None):
    """(ids, owner): `ids` (int32, the volume's shape) numbers the
    26-connected components of each nonzero label 1.. in scan order, and
    `owner[i]` is component i's label value (`owner[0]` 0)."""
    lab = np.asarray(labels)
    if lab.min() < 0 or lab.max() >= 1 << 24:
        raise ValueError("label ids must lie in [0, 2^24): the traffic's "
                         "ids are compact")
    boxes = {v: box for v, box in enumerate(ndimage.find_objects(lab), 1)
             if box is not None}
    ids = np.zeros(lab.shape, np.int32)
    first, owner = [], []
    for value, comp, at in pmap(pool, _components,
                                ((v, lab[box]) for v, box in boxes.items())):
        box = boxes[value]
        on = comp > 0
        ids[box][on] = comp[on].astype(np.int32) + len(owner)
        local = np.unravel_index(at, comp.shape)
        first.extend(np.ravel_multi_index(
            tuple(x + s.start for x, s in zip(local, box)), lab.shape))
        owner.extend([value] * len(at))
    rank = np.zeros(len(owner) + 1, np.int32)
    order = np.argsort(np.asarray(first, np.int64), kind="stable")
    rank[order + 1] = np.arange(1, len(owner) + 1, dtype=np.int32)
    owner = np.concatenate([[0], np.asarray(owner, np.int64)[order]])
    return rank[ids], owner.astype(lab.dtype)


def _holes(job):
    c, crop = job
    mine = crop == c
    holes = ndimage.binary_fill_holes(mine) & ~mine
    return c, holes if holes.any() else None


def prepare(labels, graph, value):
    if not value:
        return labels, graph
    if graph is not None:
        raise ValueError("fill_holes under a voxel graph: not implemented")
    # a component's holes depend on its own voxels alone, which no earlier
    # fill changes unless it absorbs the component: so every hole mask is
    # taken from the volume as it comes, and they are applied in order
    with pool_for(np.size(labels)) as pool:
        ids, owner = scan_components(labels, pool)
        boxes = ndimage.find_objects(ids)
        holes = dict(pmap(pool, _holes, ((c, ids[box]) for c, box in
                                         enumerate(boxes, 1) if box)))
    absorbed = np.zeros(len(owner), bool)
    for c, box in enumerate(boxes, 1):
        if holes.get(c) is None or absorbed[c]:
            continue
        view = ids[box]
        absorbed[view[holes[c]]] = True
        view[holes[c]] = c
    return owner[ids], graph


@contextlib.contextmanager
def pool_for(size):
    """A pool of WORKERS processes for the per-component work on a volume
    of `size` voxels, from POOL_FROM up; else None (this process)."""
    if size < POOL_FROM:
        yield None
        return
    pool = multiprocessing.get_context("spawn").Pool(WORKERS)
    try:
        yield pool
    finally:
        pool.close()
        pool.join()


def pmap(pool, fn, jobs):
    """fn over jobs, on `pool` where given, in any order."""
    if pool is None:
        return map(fn, jobs)
    return pool.imap_unordered(fn, jobs, chunksize=8)
