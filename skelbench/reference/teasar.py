"""The plain reference: kimimaro's TEASAR skeleton of one label of a label
volume, in NumPy and SciPy alone (exact EDT by `distance_transform_edt`,
heap Dijkstra by `scipy.sparse.csgraph`). It imports nothing of the
program under test, and works out the components, the distances, the
border targets and the paths again from the labels (and the voxel graph)
it is handed.

The semantics are kimimaro's (`trace.py`, `intake.py`) as the program
states them: components are 26-connected (under a voxel graph: connected
by its open moves), and each with more than `dust_threshold` voxels is
traced; its distance to boundary (DBF) is the anisotropic EDT of the
component labelling, with the volume's edge open; with `fix_borders` the
face targets (per 2-D component of each volume face: the largest 2-D EDT,
kimimaro's tie-break) come first and the largest of them is the root; a
component whose DBF passes `soma_detection_threshold` has its holes filled
and its DBF taken again inside its box; the path loop takes, while voxels
stay valid, the valid voxel farthest from the root, routes it to the
rails (root and earlier paths) under PDRF node costs, and invalidates
every still-valid voxel within `scale * DBF + const` of the path, measured
inside the still-valid set.

`precision` names the precision the fields are held in (`PRECISIONS`):
float64 by default; a control rounds the DBF, or the root distance and
the PDRF, to a lower one.
"""

from __future__ import annotations

from itertools import product

import numpy as np
from scipy import ndimage, sparse
from scipy.sparse import csgraph

# precision name: (the DBF's, the root distance's and the PDRF's)
PRECISIONS = {
    "float64": ("float64", "float64"),
    # every field a step below the configuration's float32
    "bfloat16": ("bfloat16", "bfloat16"),
    # the paths' fields below float32, the DBF (and so the radii and the
    # invalidation balls) at it
    "bfloat16-paths": ("float32", "bfloat16"),
}

OFFSETS = [o for o in product((-1, 0, 1), repeat=3) if o != (0, 0, 0)]

# cc3d's voxel_connectivity_graph bit for each move (as in skelbench.gen)
GRAPH_BITS = {
    (1, 0, 0): 0, (-1, 0, 0): 1, (0, 1, 0): 2, (0, -1, 0): 3,
    (0, 0, 1): 4, (0, 0, -1): 5,
    (1, 1, 0): 6, (-1, 1, 0): 7, (1, -1, 0): 8, (-1, -1, 0): 9,
    (1, 0, 1): 10, (-1, 0, 1): 11, (0, 1, 1): 12, (0, -1, 1): 13,
    (1, 0, -1): 14, (-1, 0, -1): 15, (0, 1, -1): 16, (0, -1, -1): 17,
    (1, 1, 1): 18, (-1, 1, 1): 19, (1, -1, 1): 20, (-1, -1, 1): 21,
    (1, 1, -1): 22, (-1, 1, -1): 23, (1, -1, -1): 24, (-1, -1, -1): 25,
}


def _pair(o, shape):
    """(a, b) slices: voxel v in a, v + o in b."""
    a = tuple(slice(max(-c, 0), n - max(c, 0)) for c, n in zip(o, shape))
    b = tuple(slice(max(c, 0), n - max(-c, 0)) for c, n in zip(o, shape))
    return a, b


def moves(fg, graph=None, anisotropy=(1, 1, 1), offsets=OFFSETS):
    """The open moves along `offsets` between voxels of `fg`: (rows, cols,
    physical step lengths) over flat indices; under `graph` only the moves
    whose bit is set at the source."""
    idx = np.arange(fg.size).reshape(fg.shape)
    rows, cols, steps = [], [], []
    for o in offsets:
        a, b = _pair(o, fg.shape)
        ok = fg[a] & fg[b]
        if graph is not None:
            ok &= ((graph[a] >> np.uint32(GRAPH_BITS[o])) & 1).astype(bool)
        rows.append(idx[a][ok])
        cols.append(idx[b][ok])
        s = float(np.sqrt(sum((c * w) ** 2 for c, w in zip(o, anisotropy))))
        steps.append(np.full(len(rows[-1]), s))
    return np.concatenate(rows), np.concatenate(cols), np.concatenate(steps)


def components(mask, graph=None):
    """(component ids (0 off `mask`, 1.. on it), count): 26-connected, or
    by the open moves of `graph`."""
    if graph is None:
        return ndimage.label(mask, structure=np.ones((3, 3, 3), bool))
    # each undirected pair once: cc3d's graphs open a move both ways
    r, c, _ = moves(mask, graph, offsets=[o for o in OFFSETS
                                          if o > (0, 0, 0)])
    n = mask.size
    g = sparse.csr_matrix((np.ones(len(r), np.int8), (r, c)), shape=(n, n))
    _, lab = csgraph.connected_components(g, directed=False)
    ids = np.zeros(n, np.int64)
    on = mask.ravel()
    _, ids[on] = np.unique(lab[on], return_inverse=True)
    ids[on] += 1
    return ids.reshape(mask.shape), int(ids.max())


def _edt(fg, anisotropy, black_border):
    if black_border:
        d = ndimage.distance_transform_edt(np.pad(fg, 1), sampling=anisotropy)
        d = d[1:-1, 1:-1, 1:-1]
    else:
        d = ndimage.distance_transform_edt(fg, sampling=anisotropy)
    return np.where(fg, d, 0.0)


# --------------------------------------------------------------------------
# border targets (kimimaro intake: per volume face, per 2-D component, the
# largest 2-D EDT; ties by the centroid of the 2-D component, the plane's
# centre, the corners, the edges, then the first in y-major scan order)

def _face_target(dt, mask2, wx, wy, sx, sy, ox, oy):
    """The target pixel (face coordinates) of one 2-D component: `dt` and
    `mask2` a window of the face at (ox, oy); (sx, sy) the whole face."""
    f32 = np.float32
    wx32, wy32 = f32(wx), f32(wy)
    xs, ys = np.nonzero(mask2)
    xs, ys = xs + ox, ys + oy
    cnt = f32(len(xs))
    cx, cy = f32(wx32 * sx / 2), f32(wy32 * sy / 2)
    px = f32(wx32 * f32(np.float64(xs.sum())) / cnt)
    py = f32(wy32 * f32(np.float64(ys.sum())) / cnt)
    px = f32(px + wx32) if px - cx < 0 else px
    py = f32(py + wy32) if py - cy < 0 else py
    centx, centy = float(int(float(px / wx32))), float(int(float(py / wy32)))
    vals = dt[mask2]
    top = vals == vals.max()
    xs = xs[top].astype(f32)
    ys = ys[top].astype(f32)

    def dsq(qx, qy):
        dx = wx * (xs - qx)
        dy = wy * (ys - qy)
        return dx * dx + dy * dy

    k1 = dsq(f32(centx), f32(centy))
    k2 = dsq(cx, cy)
    corners = [(-0.5, -0.5), (sx - 0.5, -0.5), (sx - 0.5, sy - 0.5),
               (-0.5, sx - 0.5)]
    k3 = np.min(np.stack([dsq(a, b) for a, b in corners]), axis=0)
    k4 = np.minimum.reduce([wx * (xs - 0.5), wx * (sx - 0.5 - xs),
                            wy * (ys - 0.5), wy * (sy - 0.5 - ys)])
    scan = ys * sx + xs
    w = np.lexsort((scan, k4, k3, k2, k1))[0]
    return int(xs[w]), int(ys[w])


def border_targets(comp, origin, full_shape, anisotropy):
    """Sorted global voxel coordinates of the face targets of the
    component `comp` (a bool crop at `origin` of a volume `full_shape`)."""
    out = set()
    for axis in range(3):
        for side in (0, full_shape[axis] - 1):
            k = side - origin[axis]
            if not 0 <= k < comp.shape[axis]:
                continue
            plane = np.take(comp, k, axis=axis)
            if not plane.any():
                continue
            dims = [a for a in range(3) if a != axis]
            wx, wy = float(anisotropy[dims[0]]), float(anisotropy[dims[1]])
            sx, sy = full_shape[dims[0]], full_shape[dims[1]]
            ox, oy = origin[dims[0]], origin[dims[1]]
            lab2, n2 = ndimage.label(plane, structure=np.ones((3, 3), bool))
            for c in range(1, n2 + 1):
                m2 = lab2 == c
                d2 = ndimage.distance_transform_edt(
                    np.pad(m2, 1), sampling=(wx, wy))[1:-1, 1:-1]
                # the program's EDT is float32 after a float64 root
                d2 = np.sqrt(np.float32(d2 ** 2).astype(np.float64)) \
                    .astype(np.float32)
                x, y = _face_target(d2, m2, wx, wy, sx, sy, ox, oy)
                p = [0, 0, 0]
                p[axis], p[dims[0]], p[dims[1]] = side, x, y
                out.add(tuple(p))
    return sorted(out)


# --------------------------------------------------------------------------
# the path loop


class _Grid:
    """The component's voxels and open moves, for Dijkstra."""

    def __init__(self, fg, graph, anisotropy):
        self.shape = fg.shape
        self.n = fg.size
        self.rows, self.cols, self.steps = moves(fg, graph, anisotropy)
        self.euclid = sparse.csr_matrix((self.steps, (self.rows, self.cols)),
                                        shape=(self.n, self.n))
        # where each move lands in a CSR built from (rows, cols), to refill
        # its weights without sorting again
        order = sparse.csr_matrix(
            (np.arange(1, len(self.rows) + 1, dtype=np.float64),
             (self.rows, self.cols)), shape=(self.n, self.n))
        self.perm = order.data.astype(np.int64) - 1
        self.node = order

    def node_costs(self, field):
        """Moving into v costs field[v] (dijkstra3d's node weights)."""
        self.node.data = field.ravel()[self.cols[self.perm]]
        return self.node

    def ball(self, ok, sources, radii):
        """Voxels within geodesic distance radii[i] of sources[i], moving
        only through `ok` (and the sources)."""
        ok = ok.ravel().copy()
        ok[sources] = True
        keep = ok[self.rows] & ok[self.cols]
        top = float(radii.max())
        n = self.n
        r = np.concatenate([self.rows[keep], np.full(len(sources), n)])
        c = np.concatenate([self.cols[keep], sources])
        w = np.concatenate([self.steps[keep], top - radii])
        g = sparse.csr_matrix((w, (r, c)), shape=(n + 1, n + 1))
        d = csgraph.dijkstra(g, indices=n, limit=top)[:n]
        return d <= top


def _round(a, dtype):
    """`a` held in `dtype` ("float64", "float32" or "bfloat16": float32
    rounded to nearest even on its upper 16 bits), as float64."""
    a = np.asarray(a, dtype=np.float64)
    if dtype != "bfloat16":
        return a.astype(dtype).astype(np.float64)
    bits = a.astype(np.float32).view(np.uint32).astype(np.uint64)
    bits = (bits + 0x7FFF + ((bits >> 16) & 1)) & 0xFFFF0000
    return bits.astype(np.uint32).view(np.float32).astype(np.float64)


def trace(fg, dbf, params, anisotropy, before, graph=None,
          precision="float64"):
    """(paths (lists of flat indices), DBF, PDRF (flat, inf off the
    component)) of one component: `fg` its bool box, `dbf` its DBF there,
    `before` its face targets (box coordinates, sorted; the last is the
    root)."""
    dbf_dtype, path_dtype = PRECISIONS[precision]
    aniso = np.asarray(anisotropy, dtype=np.float64)
    dbf = np.where(fg, dbf, 0.0)
    dbf_max = float(dbf.max())
    soma_mode = False
    if dbf_max > params["soma_detection_threshold"]:
        filled = ndimage.binary_fill_holes(fg)
        if filled.sum() > fg.sum():
            fg = filled
            dbf = _edt(fg, aniso, bool(fg.all()))
        dbf_max = float(dbf.max())
        soma_mode = dbf_max > params["soma_acceptance_threshold"]
    dbf = _round(dbf, dbf_dtype)
    dbf_max = float(dbf.max())
    grid = _Grid(fg, graph, aniso)
    flat_fg = fg.ravel()
    before = [int(np.ravel_multi_index(t, fg.shape)) for t in before]
    root = before.pop() if before else None

    soma_radius = 0.0
    if soma_mode:
        if root is not None:
            before.insert(0, root)
        maxima = np.argwhere(dbf >= dbf_max)
        com = maxima.mean(axis=0)
        best = maxima[np.argmin(((maxima - com) ** 2).sum(axis=1))]
        root = int(np.ravel_multi_index(tuple(best), fg.shape))
        soma_radius = (dbf_max * params["soma_invalidation_scale"]
                       + params["soma_invalidation_const"])
    elif root is None:
        first = int(np.argmax(flat_fg))
        probe = csgraph.dijkstra(grid.euclid, indices=first)
        root = int(np.argmax(np.where(np.isfinite(probe) & flat_fg, probe,
                                      -np.inf)))

    daf = csgraph.dijkstra(grid.euclid, indices=root)
    daf = _round(np.where(np.isfinite(daf) & flat_fg, daf, 0.0),
                 path_dtype)
    target = int(np.argmax(np.where(flat_fg, daf, -np.inf)))
    max_daf = daf[target]
    m = 1.0 / dbf_max ** 1.01
    with np.errstate(divide="ignore", invalid="ignore"):
        p = 1.0 - np.where(dbf.ravel() == 0, np.inf, dbf.ravel()) * m
    pdrf = params["pdrf_scale"] * p ** int(params["pdrf_exponent"])
    if max_daf > 0:
        pdrf = pdrf + daf / max_daf
    pdrf = _round(np.where(flat_fg, pdrf, np.inf), path_dtype)

    valid = flat_fg.copy()
    radius = params["scale"] * dbf.ravel() + params["const"]
    if soma_mode:
        r0 = np.array([params["soma_invalidation_scale"] * dbf.ravel()[root]
                       + params["soma_invalidation_const"]])
        valid &= ~grid.ball(valid, np.array([root]), r0)
    elif not before:
        before.append(target)
    n_valid = int(valid.sum())
    max_paths = max(n_valid, 1)
    rails = {root}
    node = grid.node_costs(pdrf)
    paths = []
    while (n_valid > 0 or before) and len(paths) < max_paths:
        if before:
            t = before.pop()
        else:
            t = int(np.argmax(np.where(valid, daf, -np.inf)))
        _, pred, _ = csgraph.dijkstra(node, indices=sorted(rails),
                                      min_only=True,
                                      return_predecessors=True)
        path = [t]
        while pred[path[-1]] >= 0:
            path.append(int(pred[path[-1]]))
        path = path[::-1]                 # rail first
        if soma_mode:
            pc = np.stack(np.unravel_index(path, fg.shape), axis=1)
            rc = np.array(np.unravel_index(root, fg.shape))
            d = np.linalg.norm(aniso * (pc - rc), axis=1)
            path = path[:1] + [v for v, dd in zip(path, d) if dd > soma_radius]
        pv = np.array(path, dtype=np.int64)
        if n_valid > 0:
            hit = grid.ball(valid, pv, radius[pv])
            n_valid -= int((hit & valid).sum())
            valid &= ~hit
        rails.update(path)
        paths.append(path)
    return paths, dbf, pdrf


def skeleton(paths, dbf, shape):
    """(vertices (N, 3) box voxel coordinates, edges (E, 2), radii) of the
    union of `paths`."""
    verts = sorted({v for p in paths for v in p})
    if not verts:
        return np.zeros((0, 3), np.int64), np.zeros((0, 2), np.int64), \
            np.zeros(0)
    at = {v: i for i, v in enumerate(verts)}
    edges = sorted({(min(at[a], at[b]), max(at[a], at[b]))
                    for p in paths for a, b in zip(p[:-1], p[1:]) if a != b})
    coords = np.stack(np.unravel_index(np.array(verts), shape), axis=1)
    return coords, np.array(edges, np.int64).reshape(-1, 2), \
        dbf.ravel()[np.array(verts)]


def label_skeleton(crop, origin, full_shape, label, params, anisotropy,
                   dust_threshold, fix_borders=True, graph=None,
                   precision="float64"):
    """The reference skeleton of `label`: `crop` the label's box grown by
    one voxel (clipped to the volume) at `origin`, `graph` the voxel graph
    there or None. Returns a list with one dict for each component
    traced: `verts` (global voxel coordinates), `edges`, `radii`, `dbf`
    (its DBF in its box), `pdrf` (its PDRF there, flat, inf off the
    component), `lo` (the box's global origin), `fg` (its voxels
    in the box, holes filled where the soma test filled them), `graph` (the
    voxel graph in the box, or None), `aniso` and `soma` (traced in soma
    mode); and
    the component ids of the crop."""
    comp, n = components(crop == label, graph)
    aniso = np.asarray(anisotropy, dtype=np.float64)
    out = []
    for c in range(1, n + 1):
        m = comp == c
        if int(m.sum()) <= dust_threshold:
            continue
        # DBF: distance to the nearest voxel off the component; the grown
        # box holds it, and the volume's own edge stays open
        dbf = _edt(m, aniso, False)
        box = ndimage.find_objects(m.astype(np.int32))[0]
        lo = np.array([s.start for s in box])
        fg = m[box]
        if fg.size <= 1:
            continue
        targets = []
        if fix_borders:
            targets = [tuple(np.array(t) - lo - origin) for t in
                       border_targets(m, origin, full_shape, aniso)]
        g = None if graph is None else graph[box]
        paths, dbf_used, pdrf = trace(fg, dbf[box], params, aniso, targets,
                                      g, precision)
        v, e, r = skeleton(paths, dbf_used, fg.shape)
        gl = lo + np.asarray(origin)
        out.append({"verts": v + gl, "edges": e, "radii": r,
                    "dbf": dbf_used, "pdrf": pdrf, "lo": gl, "fg": dbf_used > 0,
                    "graph": g, "aniso": aniso, "soma": float(dbf_used.max())
                    > params["soma_acceptance_threshold"]})
    return out, comp
