"""
Skeleton data model for kimimaro_tpu_torch (host-side numpy).

A copy of kimimaro_tpu.skeleton, the counterpart of the `osteoid.Skeleton`
container used by kimimaro (see kimimaro/trace.py:182-193 and
kimimaro/post.py for how kimimaro consumes this API). The voxel work runs
on the device; skeletons themselves are small (10^2-10^5 vertices)
irregular graphs, so this container is host-side numpy.

Capabilities (reference parity surface):
  - vertices / edges / radii / vertex_types storage
  - from_path, simple_merge, merge, consolidate, components
  - paths, branches, terminals, cable_length, downsample, equivalent
  - SWC serialization (to_swc / from_swc)
  - `space` ('voxel' | 'physical') and a 3x4 `transform`, voxel_space()
  - extra vertex attribute registry (used by cross_sectional_area)
"""

from __future__ import annotations

import datetime
from collections import defaultdict, deque
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

IDENTITY_TRANSFORM = np.array(
    [[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0]], dtype=np.float32
)


class Skeleton:
    """A vertex/edge graph with per-vertex radii and types.

    Mirrors the behavioral surface of the reference skeleton container
    (reference call sites: kimimaro/trace.py:182-193,
    post.py:89-218, intake.py:509-517).
    """

    def __init__(
        self,
        vertices=None,
        edges=None,
        radii=None,
        vertex_types=None,
        segid: Optional[int] = None,
        extra_attributes: Optional[List[dict]] = None,
        space: str = "voxel",
        transform=None,
    ):
        if vertices is None:
            vertices = np.zeros((0, 3), dtype=np.float32)
        self.vertices = np.asarray(vertices, dtype=np.float32).reshape(-1, 3)

        if edges is None:
            edges = np.zeros((0, 2), dtype=np.uint32)
        self.edges = np.asarray(edges, dtype=np.uint32).reshape(-1, 2)

        n = self.vertices.shape[0]
        if radii is None:
            radii = np.full((n,), -1.0, dtype=np.float32)
        self.radii = np.asarray(radii, dtype=np.float32).reshape(-1)

        if vertex_types is None:
            vertex_types = np.zeros((n,), dtype=np.uint8)
        self.vertex_types = np.asarray(vertex_types, dtype=np.uint8).reshape(-1)

        self.id = segid
        self.space = space
        if transform is None:
            transform = IDENTITY_TRANSFORM.copy()
        self.transform = np.asarray(transform, dtype=np.float32).reshape(3, 4)

        # registry of extra per-vertex attributes, entries like
        # {"id": "cross_sectional_area", "data_type": "float32", "num_components": 1}
        self.extra_attributes: List[dict] = (
            list(extra_attributes) if extra_attributes else []
        )

    # ------------------------------------------------------------------ #
    # Basic properties

    def empty(self) -> bool:
        return self.vertices.size == 0

    def __len__(self) -> int:
        return self.vertices.shape[0]

    def __eq__(self, other) -> bool:
        if not isinstance(other, Skeleton):
            return NotImplemented
        return (
            self.vertices.shape == other.vertices.shape
            and self.edges.shape == other.edges.shape
            and np.allclose(self.vertices, other.vertices)
            and np.array_equal(self.edges, other.edges)
        )

    def clone(self) -> "Skeleton":
        skel = Skeleton(
            self.vertices.copy(),
            self.edges.copy(),
            self.radii.copy(),
            self.vertex_types.copy(),
            segid=self.id,
            extra_attributes=[dict(p) for p in self.extra_attributes],
            space=self.space,
            transform=self.transform.copy(),
        )
        for prop in self.extra_attributes:
            name = prop["id"]
            if hasattr(self, name):
                setattr(skel, name, np.copy(getattr(self, name)))
        return skel

    def _extra_arrays(self) -> Dict[str, np.ndarray]:
        out = {}
        for prop in self.extra_attributes:
            name = prop["id"]
            if hasattr(self, name):
                out[name] = getattr(self, name)
        return out

    # ------------------------------------------------------------------ #
    # Constructors

    @classmethod
    def from_path(cls, path) -> "Skeleton":
        """Create a chain skeleton from an ordered sequence of points.

        Mirrors reference usage at kimimaro/trace.py:183.
        Consecutive duplicate points are fused.
        """
        path = np.asarray(path, dtype=np.float32).reshape(-1, 3)
        if path.shape[0] == 0:
            return cls()
        keep = np.ones(path.shape[0], dtype=bool)
        keep[1:] = np.any(path[1:] != path[:-1], axis=1)
        path = path[keep]
        n = path.shape[0]
        edges = np.stack(
            [np.arange(n - 1, dtype=np.uint32), np.arange(1, n, dtype=np.uint32)],
            axis=1,
        )
        return cls(path, edges)

    @classmethod
    def simple_merge(cls, skeletons: Sequence["Skeleton"]) -> "Skeleton":
        """Concatenate skeletons, offsetting edge indices. No deduplication.

        Mirrors reference usage at kimimaro/trace.py:182,
        post.py:186, intake.py:590.
        """
        skeletons = [s for s in skeletons if s is not None]
        if len(skeletons) == 0:
            return cls()
        if len(skeletons) == 1:
            return skeletons[0]

        verts, edges, radii, vtypes = [], [], [], []
        offset = 0
        segid = None
        space = skeletons[0].space
        transform = skeletons[0].transform
        extra_props: List[dict] = []
        extra_vals: Dict[str, list] = defaultdict(list)
        have_extras = set()
        for s in skeletons:
            for p in s.extra_attributes:
                if p["id"] not in have_extras:
                    have_extras.add(p["id"])
                    extra_props.append(dict(p))

        for s in skeletons:
            verts.append(s.vertices)
            edges.append(s.edges.astype(np.int64) + offset)
            radii.append(s.radii)
            vtypes.append(s.vertex_types)
            if segid is None:
                segid = s.id
            for p in extra_props:
                name = p["id"]
                if hasattr(s, name):
                    extra_vals[name].append(np.asarray(getattr(s, name)))
                else:
                    dt = np.dtype(p.get("data_type", "float32"))
                    extra_vals[name].append(np.zeros(len(s), dtype=dt))
            offset += s.vertices.shape[0]

        out = cls(
            np.concatenate(verts, axis=0),
            np.concatenate(edges, axis=0).astype(np.uint32),
            np.concatenate(radii, axis=0),
            np.concatenate(vtypes, axis=0),
            segid=segid,
            extra_attributes=extra_props,
            space=space,
            transform=transform,
        )
        for name, vals in extra_vals.items():
            setattr(out, name, np.concatenate(vals, axis=0))
        return out

    def merge(self, other: "Skeleton") -> "Skeleton":
        """Merge with another skeleton, fusing identical vertices."""
        return Skeleton.simple_merge([self, other]).consolidate()

    # ------------------------------------------------------------------ #
    # Normalization

    def consolidate(self, remove_disconnected_vertices: bool = True) -> "Skeleton":
        """Deduplicate identical vertices, remap edges, drop self-loops and
        duplicate edges; optionally drop vertices that touch no edge.

        Mirrors reference semantics (post.py:80, trace.py:184).
        """
        if self.empty():
            return self.clone()

        verts = self.vertices
        # unique rows; use a structured view for exact matching
        order = np.lexsort((verts[:, 2], verts[:, 1], verts[:, 0]))
        sorted_verts = verts[order]
        is_new = np.ones(len(verts), dtype=bool)
        if len(verts) > 1:
            is_new[1:] = np.any(sorted_verts[1:] != sorted_verts[:-1], axis=1)
        group_id = np.cumsum(is_new) - 1  # id per sorted position
        # mapping: original index -> consolidated id
        remap = np.empty(len(verts), dtype=np.int64)
        remap[order] = group_id
        n_unique = int(group_id[-1]) + 1

        # representative original index for each unique vertex: first occurrence
        # (minimum original index within each group) for deterministic attrs.
        rep = np.full(n_unique, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(rep, remap, np.arange(len(verts), dtype=np.int64))

        new_verts = verts[rep]
        new_radii = self.radii[rep] if self.radii.size else self.radii
        new_types = self.vertex_types[rep] if self.vertex_types.size else self.vertex_types
        extras = {k: np.asarray(v)[rep] for k, v in self._extra_arrays().items()}

        edges = remap[self.edges.astype(np.int64)]
        edges = edges[edges[:, 0] != edges[:, 1]]
        if edges.size:
            edges = np.sort(edges, axis=1)
            edges = np.unique(edges, axis=0)
        else:
            edges = edges.reshape(0, 2)

        if remove_disconnected_vertices:
            used = np.zeros(n_unique, dtype=bool)
            if edges.size:
                used[edges.reshape(-1)] = True
            keep_ids = np.flatnonzero(used)
            final_map = np.full(n_unique, -1, dtype=np.int64)
            final_map[keep_ids] = np.arange(len(keep_ids))
            new_verts = new_verts[keep_ids]
            new_radii = new_radii[keep_ids] if new_radii.size else new_radii
            new_types = new_types[keep_ids] if new_types.size else new_types
            extras = {k: v[keep_ids] for k, v in extras.items()}
            if edges.size:
                edges = final_map[edges]

        out = Skeleton(
            new_verts,
            edges.astype(np.uint32),
            new_radii,
            new_types,
            segid=self.id,
            extra_attributes=[dict(p) for p in self.extra_attributes],
            space=self.space,
            transform=self.transform.copy(),
        )
        for k, v in extras.items():
            setattr(out, k, v)
        return out

    # ------------------------------------------------------------------ #
    # Topology

    def _adjacency(self) -> Dict[int, List[int]]:
        adj: Dict[int, List[int]] = defaultdict(list)
        for e1, e2 in self.edges.astype(np.int64):
            adj[int(e1)].append(int(e2))
            adj[int(e2)].append(int(e1))
        return adj

    def components(self) -> List["Skeleton"]:
        """Split into connected components. Vertices touching no edge are
        dropped (they carry no cable)."""
        if self.edges.size == 0:
            return []

        n = self.vertices.shape[0]
        # union-find over edges
        parent = np.arange(n, dtype=np.int64)

        def find(x):
            root = x
            while parent[root] != root:
                root = parent[root]
            while parent[x] != root:
                parent[x], x = root, parent[x]
            return root

        for e1, e2 in self.edges.astype(np.int64):
            r1, r2 = find(e1), find(e2)
            if r1 != r2:
                parent[r2] = r1

        comp_of = np.array([find(i) for i in range(n)], dtype=np.int64)
        used = np.zeros(n, dtype=bool)
        used[self.edges.reshape(-1).astype(np.int64)] = True

        comps: Dict[int, List[int]] = defaultdict(list)
        for i in range(n):
            if used[i]:
                comps[int(comp_of[i])].append(i)

        extras = self._extra_arrays()
        out = []
        for root_id in sorted(comps.keys()):
            ids = np.array(comps[root_id], dtype=np.int64)
            lookup = np.full(n, -1, dtype=np.int64)
            lookup[ids] = np.arange(len(ids))
            mask = np.all(lookup[self.edges.astype(np.int64)] >= 0, axis=1)
            sub_edges = lookup[self.edges.astype(np.int64)[mask]]
            skel = Skeleton(
                self.vertices[ids],
                sub_edges.astype(np.uint32),
                self.radii[ids] if self.radii.size else None,
                self.vertex_types[ids] if self.vertex_types.size else None,
                segid=self.id,
                extra_attributes=[dict(p) for p in self.extra_attributes],
                space=self.space,
                transform=self.transform.copy(),
            )
            for k, v in extras.items():
                setattr(skel, k, np.asarray(v)[ids])
            out.append(skel)
        return out

    def _degrees(self) -> np.ndarray:
        deg = np.zeros(self.vertices.shape[0], dtype=np.int64)
        if self.edges.size:
            np.add.at(deg, self.edges.reshape(-1).astype(np.int64), 1)
        return deg

    def terminals(self) -> np.ndarray:
        """Vertex indices with degree 1."""
        return np.flatnonzero(self._degrees() == 1)

    def branches(self) -> np.ndarray:
        """Vertex indices with degree >= 3."""
        return np.flatnonzero(self._degrees() >= 3)

    def cable_length(self) -> float:
        """Sum of physical edge lengths (in the skeleton's current space)."""
        if self.edges.size == 0:
            return 0.0
        e = self.edges.astype(np.int64)
        d = self.vertices[e[:, 0]] - self.vertices[e[:, 1]]
        return float(np.sum(np.sqrt(np.sum(d * d, axis=1))))

    def paths(self) -> List[np.ndarray]:
        """Decompose into root-to-terminal vertex-coordinate paths, one per
        terminal, per connected component (used by cross-section analysis,
        reference utility.py:449).

        Returns a list of (L, 3) float arrays of vertex positions.
        """
        idx_paths = self.interjoint_paths(return_indices=True, full=True)
        return [self.vertices[p] for p in idx_paths]

    def interjoint_paths(self, return_indices=False, full=True) -> List[np.ndarray]:
        """Returns root->terminal paths: per connected component, build a
        BFS spanning tree from a deterministic root (the smallest terminal),
        then walk parents back from every tree leaf. Covers all spanning-tree
        edges; cycle edges (rare post-repair) are omitted from paths."""
        if self.edges.size == 0:
            return []

        adj = self._adjacency()
        deg = self._degrees()
        n = self.vertices.shape[0]
        out_paths: List[np.ndarray] = []

        comp_seen = np.zeros(n, dtype=bool)
        for start in np.flatnonzero(deg > 0):
            start = int(start)
            if comp_seen[start]:
                continue
            comp = []
            dq = deque([start])
            comp_seen[start] = True
            while dq:
                v = dq.popleft()
                comp.append(v)
                for w in adj[v]:
                    if not comp_seen[w]:
                        comp_seen[w] = True
                        dq.append(w)
            terms = [v for v in comp if deg[v] == 1]
            root = min(terms) if terms else min(comp)

            parent = {root: -1}
            order = [root]
            dq = deque([root])
            while dq:
                v = dq.popleft()
                for w in sorted(adj[v]):
                    if w not in parent:
                        parent[w] = v
                        order.append(w)
                        dq.append(w)
            is_parent = set(parent[v] for v in order if parent[v] != -1)
            leaves = [v for v in order if v not in is_parent and v != root]
            if not leaves and len(order) > 1:
                leaves = [order[-1]]
            for leaf in leaves:
                path = []
                v = leaf
                while v != -1:
                    path.append(v)
                    v = parent[v]
                out_paths.append(np.array(path[::-1], dtype=np.int64))

        if return_indices:
            return out_paths
        return [self.vertices[p] for p in out_paths]

    def downsample(self, factor: int) -> "Skeleton":
        """Keep every `factor`-th vertex along paths; branch points and
        terminals are always preserved. Mirrors osteoid downsample used at
        reference utility.py:608."""
        if factor <= 1 or self.empty() or self.edges.size == 0:
            return self.clone()

        deg = self._degrees()
        critical = set(np.flatnonzero((deg == 1) | (deg >= 3)).tolist())
        keep = set(critical)

        for path in self.interjoint_paths(return_indices=True):
            ct = 0
            for v in path:
                v = int(v)
                if v in critical:
                    ct = 0
                    keep.add(v)
                    continue
                ct += 1
                if ct == factor:
                    keep.add(v)
                    ct = 0

        # rebuild edges: contract chains of removed degree-2 vertices
        adj = self._adjacency()
        new_edges = set()
        visited = set()
        keep_sorted = sorted(keep)
        for v in keep_sorted:
            for w in adj[v]:
                # walk through removed vertices until hitting a kept vertex
                prev, cur = v, w
                walk = [(prev, cur)]
                while cur not in keep:
                    nxts = [x for x in adj[cur] if x != prev]
                    if not nxts:
                        break
                    prev, cur = cur, nxts[0]
                    walk.append((prev, cur))
                if cur in keep and cur != v:
                    ekey = (min(v, cur), max(v, cur))
                    if ekey not in new_edges:
                        new_edges.add(ekey)

        ids = np.array(keep_sorted, dtype=np.int64)
        lookup = np.full(self.vertices.shape[0], -1, dtype=np.int64)
        lookup[ids] = np.arange(len(ids))
        edges = np.array(
            [[lookup[a], lookup[b]] for a, b in sorted(new_edges)], dtype=np.uint32
        ).reshape(-1, 2)

        out = Skeleton(
            self.vertices[ids],
            edges,
            self.radii[ids] if self.radii.size else None,
            self.vertex_types[ids] if self.vertex_types.size else None,
            segid=self.id,
            extra_attributes=[dict(p) for p in self.extra_attributes],
            space=self.space,
            transform=self.transform.copy(),
        )
        for k, v in self._extra_arrays().items():
            setattr(out, k, np.asarray(v)[ids])
        return out

    # ------------------------------------------------------------------ #
    # Equivalence / spaces

    @staticmethod
    def equivalent(first: "Skeleton", second: "Skeleton") -> bool:
        """Topological + geometric equality, ignoring vertex order.

        Mirrors osteoid.Skeleton.equivalent used at reference
        automated_test.py:333,630.
        """
        first = first.consolidate()
        second = second.consolidate()
        if first.vertices.shape != second.vertices.shape:
            return False
        if first.edges.shape != second.edges.shape:
            return False

        def canonical(skel):
            order = np.lexsort(
                (skel.vertices[:, 2], skel.vertices[:, 1], skel.vertices[:, 0])
            )
            remap = np.empty(len(skel.vertices), dtype=np.int64)
            remap[order] = np.arange(len(order))
            verts = skel.vertices[order]
            edges = remap[skel.edges.astype(np.int64)]
            edges = np.sort(edges, axis=1)
            edges = edges[np.lexsort((edges[:, 1], edges[:, 0]))]
            return verts, edges

        v1, e1 = canonical(first)
        v2, e2 = canonical(second)
        return np.array_equal(v1, v2) and np.array_equal(e1, e2)

    def apply_transform(self) -> "Skeleton":
        """Apply the 3x4 transform to the vertices (returns a clone)."""
        skel = self.clone()
        verts = np.hstack(
            [self.vertices, np.ones((len(self.vertices), 1), dtype=np.float32)]
        )
        skel.vertices = (self.transform @ verts.T).T.astype(np.float32)
        return skel

    def physical_space(self) -> "Skeleton":
        if self.space == "physical":
            return self.clone()
        skel = self.apply_transform()
        skel.space = "physical"
        return skel

    def voxel_space(self) -> "Skeleton":
        """Inverse-transform vertices back to voxel coordinates
        (reference automated_test.py:140)."""
        if self.space == "voxel":
            return self.clone()
        skel = self.clone()
        mat = np.vstack([self.transform, [0, 0, 0, 1]]).astype(np.float64)
        inv = np.linalg.inv(mat)[:3]
        verts = np.hstack(
            [self.vertices, np.ones((len(self.vertices), 1), dtype=np.float32)]
        )
        skel.vertices = (inv @ verts.T).T.astype(np.float32)
        skel.space = "voxel"
        return skel

    # ------------------------------------------------------------------ #
    # SWC IO (reference: osteoid to_swc/from_swc used by kimimaro_cli)

    def to_swc(self, contributors: str = "") -> str:
        """Serialize to SWC. Produces one tree per connected component
        (forests use multiple roots)."""
        sx, sy, sz = (
            self.transform[0, 0],
            self.transform[1, 1],
            self.transform[2, 2],
        )
        header = (
            f"# ORIGINAL_SOURCE kimimaro_tpu\n"
            f"# CREATURE\n"
            f"# REGION\n"
            f"# FIELD/LAYER\n"
            f"# TYPE\n"
            f"# CONTRIBUTOR {contributors}\n"
            f"# REFERENCE\n"
            f"# RAW\n"
            f"# EXTRAS\n"
            f"# SOMA_AREA\n"
            f"# SHRINKAGE_CORRECTION\n"
            f"# VERSION_NUMBER 1\n"
            f"# VERSION_DATE {datetime.datetime.now(datetime.timezone.utc).date()}\n"
            f"# SCALE {sx:.1f} {sy:.1f} {sz:.1f}\n"
        )

        n = self.vertices.shape[0]
        parent = np.full(n, -1, dtype=np.int64)
        visited = np.zeros(n, dtype=bool)
        adj = self._adjacency()
        order = []
        for seed in range(n):
            if visited[seed]:
                continue
            visited[seed] = True
            dq = deque([seed])
            while dq:
                v = dq.popleft()
                order.append(v)
                for w in sorted(adj[v]):
                    if not visited[w]:
                        visited[w] = True
                        parent[w] = v
                        dq.append(w)

        pos_of = np.empty(n, dtype=np.int64)
        pos_of[np.array(order, dtype=np.int64)] = np.arange(1, n + 1)

        lines = [header]
        for v in order:
            p = parent[v]
            swc_parent = -1 if p < 0 else int(pos_of[p])
            x, y, z = self.vertices[v]
            r = self.radii[v] if self.radii.size else 1.0
            t = int(self.vertex_types[v]) if self.vertex_types.size else 0
            lines.append(
                f"{int(pos_of[v])} {t} {x:.6f} {y:.6f} {z:.6f} {r:.6f} {swc_parent}"
            )
        return "\n".join(lines) + "\n"

    @classmethod
    def from_swc(cls, swcstr: str) -> "Skeleton":
        verts, radii, vtypes, edges = [], [], [], []
        idmap = {}
        parents = []
        for line in swcstr.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            fields = line.split()
            nid = int(fields[0])
            t = int(fields[1])
            x, y, z = float(fields[2]), float(fields[3]), float(fields[4])
            r = float(fields[5])
            par = int(fields[6])
            idmap[nid] = len(verts)
            verts.append((x, y, z))
            radii.append(r)
            vtypes.append(t)
            parents.append((nid, par))
        for nid, par in parents:
            if par != -1 and par in idmap:
                edges.append((idmap[par], idmap[nid]))
        skel = cls(
            np.array(verts, dtype=np.float32).reshape(-1, 3),
            np.array(edges, dtype=np.uint32).reshape(-1, 2),
            np.array(radii, dtype=np.float32),
            np.array(vtypes, dtype=np.uint8),
            space="physical",
        )
        return skel

    def __repr__(self):
        return (
            f"Skeleton(segid={self.id}, vertices={self.vertices.shape[0]}, "
            f"edges={self.edges.shape[0]}, space='{self.space}')"
        )
