"""The comparison that decides `correct`: the program's skeletons against
the plain reference (`teasar.py`), on the chunks a run's window produced.

Four numbers, each with its limit (`LIMITS`; `PERF.md` gives the readings
they were set from; three are exact, by the configuration's guarantees):

- `labels_off`: labels whose presence differs, over every chunk of the
  window: the program's skeleton keys against the labels the reference
  finds a component of more than `dust_threshold` voxels in.
- `stray_parts`: over the sampled labels, program vertices that lie off
  every traced component of their label, and edges that do not join
  26-neighbours of one component (a move across a voxel graph's wall).
- `uncovered`: over the sampled labels, voxels of a traced component that
  no skeleton vertex v covers: farther from every v, along the component's
  open moves, than the invalidation radius scale * DBF(v) + const (DBF the
  reference's, with a slack of COVER_SLACK for float32 distances). TEASAR
  traces until every voxel is so covered (not checked on a component
  traced in soma mode, whose root ball has another radius).
- `radius_gap`: over the sampled labels' vertices, the largest gap of the
  program's radius from the reference's DBF at that voxel, relative to the
  latter.
Two more are logged for each sampled label (the details) but not
compared, since sound runs read as high as the control does on some
labels (`PERF.md`):

- path excess: over the branches of the label's skeleton (the
  chains of edges between vertices of another degree than 2), the largest
  excess of a branch's cost under the reference's float64 PDRF over the
  cheapest path between its two ends, relative to the latter. A cost is
  the sum of the PDRF over a path's voxels, both ends included. A branch
  of a TEASAR skeleton is part of one path that was cheapest from its
  target to the rails, so it is the cheapest between its ends under the
  field it was traced on, or two such paths where a path ended on the end
  of an earlier one (the root, or a target, whose degree was 1): a branch
  is judged as one part or as two parts split at one of its vertices,
  whichever reads less. Rounding the field differently moves a branch
  onto a path that is dearer under the reference's; so does a near-tie in
  the choice of the root or of a target, which changes the field.
- vertex gap: the share of the label's vertices with no vertex of the
  reference's skeleton within one voxel step.

The sample is drawn from the run's seed: the label with the most voxels,
up to CROP_SAMPLE of the BRANCHY labels with the most skeleton ends in the
window's first chunk (the labels that keep the global engine iterating
longest, which its bail hands to the crop engine), and the rest from the
others.

The reference implements the skeletonize options in `BUILT_IN`; any other
option of a configuration needs a module `options/<option>.py` whose
`prepare(labels, graph, value)` returns the labels and graph the
reference reads under it. A configuration with an option the reference
does not implement is refused.
"""

from __future__ import annotations

import importlib
import multiprocessing
import re

import numpy as np
from scipy import ndimage
from scipy.sparse import csgraph
from scipy.spatial import cKDTree

from . import teasar

LIMITS = {
    "labels_off": 0,
    "stray_parts": 0,
    "uncovered": 0,
    "radius_gap": 2e-5,
}
COVER_SLACK = 1e-4

# sampled labels a run: the largest, up to CROP_SAMPLE drawn from the
# BRANCHY labels with the most skeleton ends, the rest from the others
SAMPLE = 12
CROP_SAMPLE = 6
BRANCHY = 24
WORKERS = 7

BUILT_IN = {"teasar_params", "anisotropy", "dust_threshold", "fix_borders",
            "fix_branching"}
TEASAR_KEYS = {"scale", "const", "pdrf_exponent", "pdrf_scale",
               "soma_detection_threshold", "soma_acceptance_threshold",
               "soma_invalidation_scale", "soma_invalidation_const"}


def option_modules(kwargs):
    """{option: its module} of a configuration's skeletonize options
    `kwargs` beyond `BUILT_IN`; raises ValueError on an option the
    reference does not implement."""
    unknown = set(kwargs["teasar_params"]) - TEASAR_KEYS
    if unknown:
        raise ValueError(f"teasar_params the reference does not implement: "
                         f"{sorted(unknown)}")
    if not kwargs.get("fix_branching", True):
        raise ValueError("the reference traces with fix_branching only")
    out = {}
    for key in sorted(set(kwargs) - BUILT_IN):
        if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", key):
            raise ValueError(f"bad option name {key!r}")
        try:
            out[key] = importlib.import_module(f"reference.options.{key}")
        except ModuleNotFoundError:
            raise ValueError(
                f"the reference does not implement the skeletonize option "
                f"{key!r}: it needs skelbench/reference/options/{key}.py")
    return out


def reference_input(kwargs, labels, graph):
    """(labels, graph) the reference reads under a configuration's
    skeletonize options `kwargs`."""
    for key, mod in option_modules(kwargs).items():
        labels, graph = mod.prepare(labels, graph, kwargs[key])
    return labels, graph


def grown_boxes(vol):
    """{label: (lo, hi)}: each nonzero label's box grown by one voxel,
    clipped to the volume."""
    out = {}
    for lab, s in enumerate(ndimage.find_objects(vol), 1):
        if s is None:
            continue
        lo = tuple(max(x.start - 1, 0) for x in s)
        hi = tuple(min(x.stop + 1, n) for x, n in zip(s, vol.shape))
        out[lab] = (lo, hi)
    return out


def _crop(a, lo, hi):
    return None if a is None else np.ascontiguousarray(
        a[tuple(slice(x, y) for x, y in zip(lo, hi))])


def _survivor(args):
    """(label, voxel count of its components over the dust threshold, the
    label's voxel count)."""
    crop, graph, label, dust = args
    comp, n = teasar.components(crop == label, graph)
    sizes = np.bincount(comp.ravel(), minlength=n + 1)[1:]
    return label, int(sizes[sizes > dust].sum()), int(sizes.sum())


def _reference(args):
    crop, lo, full_shape, label, kw, graph, precision = args
    comps, _ = teasar.label_skeleton(
        crop, lo, full_shape, label, kw["teasar_params"], kw["anisotropy"],
        kw["dust_threshold"], kw["fix_borders"], graph, precision)
    return label, comps


class Reference:
    """The reference's view of one base volume (the chunks are its
    relabellings): each label's grown box, its surviving voxel count, and
    the reference skeletons of sampled labels. `base` and `graph` are what
    the run handed the program; `kwargs` the configuration's skeletonize
    options."""

    def __init__(self, base, graph, kwargs, pool):
        self.kwargs, self.pool = kwargs, pool
        base, graph = reference_input(kwargs, base, graph)
        self.base, self.graph = base, graph
        self.boxes = grown_boxes(base)
        jobs = ((_crop(base, lo, hi), _crop(graph, lo, hi), lab,
                 kwargs["dust_threshold"])
                for lab, (lo, hi) in self.boxes.items())
        self.size = {}
        self.surviving = set()
        for lab, kept, size in pool.imap_unordered(_survivor, jobs,
                                                   chunksize=16):
            self.size[lab] = size
            if kept:
                self.surviving.add(lab)

    def skeletons(self, labels, precision="float64"):
        """{base label: its components (`teasar.label_skeleton`)}."""
        jobs = [(_crop(self.base, *self.boxes[lab]), self.boxes[lab][0],
                 self.base.shape, lab, self.kwargs,
                 _crop(self.graph, *self.boxes[lab]), precision)
                for lab in labels]
        return dict(self.pool.imap_unordered(_reference, jobs))


def make_pool():
    return multiprocessing.get_context("spawn").Pool(WORKERS)


def skeleton_ends(skel):
    """Vertices of degree 1 of a program skeleton."""
    e = np.asarray(skel.edges, np.int64).reshape(-1, 2)
    deg = np.bincount(e.ravel(), minlength=len(skel.vertices))
    return int((deg == 1).sum())


def sample(ref, ends, seed):
    """The sampled base labels: the largest surviving label, up to
    CROP_SAMPLE drawn from the BRANCHY labels with the most skeleton ends
    (`ends`: {base label: ends in the program's output}), the rest from
    the others, drawn from `seed`."""
    rng = np.random.default_rng(int(seed) % (1 << 63))
    alive = sorted(ref.surviving)
    largest = max(alive, key=lambda lab: (ref.size[lab], -lab))
    ranked = sorted((lab for lab in alive if lab != largest),
                    key=lambda lab: (-ends.get(lab, 0), lab))
    branchy, rest = ranked[:BRANCHY], sorted(ranked[BRANCHY:])
    take_b = list(rng.permutation(branchy)[
        :max(CROP_SAMPLE, SAMPLE - 1 - len(rest))])
    take_rest = list(rng.permutation(rest)[:SAMPLE - 1 - len(take_b)])
    return [largest] + [int(x) for x in take_b + take_rest]


def _voxels(skel, anisotropy):
    """(vertices as voxel coordinates, edges, radii) of a program
    skeleton (physical vertices)."""
    v = np.rint(np.asarray(skel.vertices, np.float64)
                / np.asarray(anisotropy, np.float64)).astype(np.int64)
    return v, np.asarray(skel.edges, np.int64).reshape(-1, 2), \
        np.asarray(skel.radii, np.float64)


def branches(n, edges):
    """The chains of vertex indices between vertices of another degree
    than 2 (each edge in one chain; loops of degree-2 vertices alone are
    left out)."""
    adj = [[] for _ in range(n)]
    for a, b in {(min(a, b), max(a, b)) for a, b in edges if a != b}:
        adj[a].append(b)
        adj[b].append(a)
    seen, out = set(), []
    for s in range(n):
        if len(adj[s]) == 2:
            continue
        for t in adj[s]:
            if (min(s, t), max(s, t)) in seen:
                continue
            seen.add((min(s, t), max(s, t)))
            chain, prev, cur = [s], s, t
            while len(adj[cur]) == 2:
                chain.append(cur)
                nxt = adj[cur][0] if adj[cur][0] != prev else adj[cur][1]
                seen.add((min(cur, nxt), max(cur, nxt)))
                prev, cur = cur, nxt
            chain.append(cur)
            out.append(chain)
    return out


def _path_excess(comp, grid, verts, edges):
    """(largest relative excess of a branch's PDRF cost over the cheapest
    path between its ends, branches that are no path of open moves) of
    the program's vertices `verts` (global voxels) and `edges` on one
    component. A branch may be two cheapest paths joined at one vertex
    (a path that ends on the end of an earlier one, such as the root):
    its excess is the least, over the vertices s of the branch, of the
    larger excess of its two parts a..s and s..b."""
    pdrf = comp["pdrf"]
    if len(verts) == 0:
        return 0.0, 0
    flat = np.ravel_multi_index(tuple((verts - comp["lo"]).T),
                                comp["fg"].shape)
    chains = [flat[ch] for ch in branches(len(verts), edges)]
    reach = {}
    for f in chains:
        cost = float(pdrf[f].sum())
        for end in (int(f[0]), int(f[-1])):
            reach[end] = max(reach.get(end, 0.0), cost - pdrf[end])
    node = grid.node_costs(pdrf)
    dist = {end: csgraph.dijkstra(node, indices=end,
                                  limit=r * (1 + 1e-6) + 1e-9)
            for end, r in reach.items()}
    worst, broken = 0.0, 0
    for f in chains:
        c = pdrf[f]
        da, db = dist[int(f[0])][f], dist[int(f[-1])][f]
        if not (np.isfinite(c).all() and np.isfinite(da).all()
                and np.isfinite(db).all()):
            broken += 1
            continue
        head = np.cumsum(c)                      # a..s
        tail = np.cumsum(c[::-1])[::-1]          # s..b
        e1 = head / (c[0] + da) - 1.0
        e2 = tail / (c[-1] + db) - 1.0
        worst = max(worst, float(np.maximum(e1, e2).min()))
    return worst, broken


def judge_label(args):
    """(stray parts, uncovered voxels, vertex gap, radius gap, path
    excess) of one label: `got` the (voxel vertices, edges, radii) under
    judgement, `comps` the reference's components
    (`teasar.label_skeleton`), `params` the TEASAR parameters."""
    got, comps, params = args
    v, e, r = got
    stray = 0
    where = np.full(len(v), -1, np.int64)
    gap = 0.0
    for i, p in enumerate(v):
        for k, c in enumerate(comps):
            q = p - c["lo"]
            if ((q >= 0) & (q < c["fg"].shape)).all() and c["fg"][tuple(q)]:
                where[i] = k
                ref_r = float(c["dbf"][tuple(q)])
                gap = max(gap, abs(float(r[i]) - ref_r) / ref_r)
                break
        else:
            stray += 1
    for a, b in e:
        if np.abs(v[a] - v[b]).max() > 1 or where[a] != where[b] \
                or where[a] < 0:
            stray += 1
    uncovered, excess = 0, 0.0
    for k, c in enumerate(comps):
        if c["soma"]:
            continue
        grid = teasar._Grid(c["fg"], c["graph"], c["aniso"])
        mine = np.flatnonzero(where == k)
        uncovered += _uncovered(c, grid, v[mine], params)
        at = np.full(len(v), -1, np.int64)
        at[mine] = np.arange(len(mine))
        sub = e[(where[e[:, 0]] == k) & (where[e[:, 1]] == k)] \
            if len(e) else e
        x, broken = _path_excess(c, grid, v[mine], at[sub])
        excess = max(excess, x)
        stray += broken
    rv = np.concatenate([c["verts"] for c in comps]) if comps else \
        np.zeros((0, 3), np.int64)
    if len(v) == 0 or len(rv) == 0:
        vgap = float(len(v) != len(rv))
    else:
        d1, _ = cKDTree(rv).query(v, p=np.inf)
        d2, _ = cKDTree(v).query(rv, p=np.inf)
        vgap = 1.0 - ((d1 <= 1).sum() + (d2 <= 1).sum()) / (len(v) + len(rv))
    return stray, uncovered, float(vgap), float(gap), float(excess)


def _uncovered(comp, grid, verts, params):
    """Voxels of the component `comp` outside every vertex's invalidation
    ball (geodesic, along the component's open moves)."""
    fg = comp["fg"]
    if len(verts) == 0:
        return int(fg.sum())
    src = np.ravel_multi_index(tuple((verts - comp["lo"]).T), fg.shape)
    radii = (params["scale"] * comp["dbf"].ravel()[src] + params["const"]) \
        * (1 + COVER_SLACK)
    hit = grid.ball(fg, src, radii)
    return int((fg.ravel() & ~hit).sum())


def check(luts, results, ref, picked, refs, control=None, details=None,
          pool=None):
    """The four numbers of a run. `luts`: the id table of each chunk of
    the window (chunk = lut[base]); `results`: the program's {label:
    Skeleton} of each; `picked`: [(chunk index, base label)]; `refs`: the
    reference's skeletons of those base labels; `control`: in place of the
    program's skeletons of the picked labels, {base label: components} of
    another reference (the control). `details`, where given (a list),
    gets (base label, vertices judged, reference vertices, stray parts,
    vertex gap, radius gap, uncovered, path excess) of each picked label.
    `pool` judges the labels in parallel."""
    kw = ref.kwargs
    off = 0
    for lut, res in zip(luts, results):
        want = {int(lut[lab]) for lab in ref.surviving}
        off += len(want ^ set(int(k) for k in res))
    jobs, labs = [], []
    for ci, lab in picked:
        if control is not None:
            cc = control[lab]
            got = (np.concatenate([c["verts"] for c in cc]),
                   _joined_edges(cc), np.concatenate([c["radii"] for c in cc]))
        else:
            skel = results[ci].get(int(luts[ci][lab]))
            if skel is None:
                continue      # counted in labels_off
            got = _voxels(skel, kw["anisotropy"])
        jobs.append((got, refs[lab], kw["teasar_params"]))
        labs.append(lab)
    judged = pool.map(judge_label, jobs) if pool else \
        [judge_label(j) for j in jobs]
    stray, cover, rgap = 0, 0, 0.0
    for lab, job, (s, u, vg, rg, px) in zip(labs, jobs, judged):
        if details is not None:
            details.append((int(lab), len(job[0][0]),
                            sum(len(c["verts"]) for c in job[1]), s, vg, rg,
                            u, px))
        stray += s
        cover += u
        rgap = max(rgap, rg)
    return {"labels_off": off, "stray_parts": stray, "uncovered": cover,
            "radius_gap": rgap}


def _joined_edges(comps):
    out, base = [], 0
    for c in comps:
        out.append(c["edges"] + base)
        base += len(c["verts"])
    return np.concatenate(out) if out else np.zeros((0, 2), np.int64)


def passes(numbers):
    return all(numbers[k] is not None and numbers[k] <= LIMITS[k]
               for k in LIMITS)
