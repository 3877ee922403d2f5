"""Host-side path assembly shared by the engines (torch counterpart of
the host parts of kimimaro_tpu.engine): path validity checks and the
conversion of traced paths to consolidated Skeletons."""

from __future__ import annotations

import numpy as np

from .skeleton import Skeleton


def _paths_structurally_valid(path_list) -> bool:
    """TEASAR tree invariants, checked on host from fetched paths:
    every step is a 26-neighbor move, and each path's rail anchor (first
    vertex, rail-first order) lies on the tree built by earlier paths
    (the first path's anchor is the root). Catches wandering chases from
    a divergent rail field regardless of what the device kernel reported."""
    tree = None
    for verts, _ in path_list:
        if len(verts) == 0:
            continue
        steps = np.abs(np.diff(verts, axis=0))
        if steps.size and int(steps.max()) > 1:
            return False
        if tree is None:
            tree = set(map(tuple, verts.tolist()))
            continue
        if tuple(verts[0].tolist()) not in tree:
            return False
        tree.update(map(tuple, verts.tolist()))
    return True


def paths_to_skeleton(path_list, anisotropy) -> Skeleton:
    """Paths+radii -> consolidated Skeleton with reference transform
    semantics (reference trace.py:182-193)."""
    skels = []
    radii_map = {}
    for verts, rads in path_list:
        if len(verts) == 0:
            continue
        skels.append(Skeleton.from_path(verts))
        for v, r in zip(verts, rads):
            radii_map[tuple(int(c) for c in v)] = float(r)
    if not skels:
        return Skeleton()
    skel = Skeleton.simple_merge(skels).consolidate()
    if not skel.empty():
        skel.radii = np.array(
            [radii_map.get(tuple(int(c) for c in v), 0.0) for v in skel.vertices],
            dtype=np.float32,
        )
    skel.transform = np.array(
        [[anisotropy[0], 0, 0, 0],
         [0, anisotropy[1], 0, 0],
         [0, 0, anisotropy[2], 0]], dtype=np.float32)
    return skel


def paths_to_skeletons_batched(results, offsets_by_segid, anisotropy):
    """Vectorized finalize: every label's paths -> consolidated Skeleton in
    ONE set of array passes (semantics identical to per-label
    paths_to_skeleton: from_path consecutive-dup fusion, consolidate's
    first-occurrence vertex dedup in (x,y,z)-sorted order, undirected edge
    dedup, disconnected-vertex removal, last-write-wins radii — reference
    trace.py:182-193). The per-label loop cost ~2 ms x thousands of labels;
    this replaces it with ~15 numpy passes over the concatenated paths.

    results: {segid: [(verts int (P,3) in bbox frame, radii (P,)), ...]}
    offsets_by_segid: {segid: (3,) bbox offset}
    Returns {segid: Skeleton} with GLOBAL voxel vertices (not yet scaled
    to physical space; caller applies anisotropy/transform bookkeeping).
    """
    seg_list = [s for s in results if results[s]]
    if not seg_list:
        return {}
    if len(seg_list) >= (1 << 16):
        # key packing carries 16 bits of label index; huge id spaces take
        # the per-label path
        return None
    seg_index = {s: i for i, s in enumerate(seg_list)}

    vparts, rparts, sparts, pparts = [], [], [], []
    pid = 0
    for s in seg_list:
        mn = np.asarray(offsets_by_segid[s], dtype=np.int64)
        for verts, rads in results[s]:
            if len(verts) == 0:
                continue
            v = np.asarray(verts, dtype=np.int64) + mn
            vparts.append(v)
            rparts.append(np.asarray(rads, dtype=np.float32))
            sparts.append(np.full(len(v), seg_index[s], dtype=np.int64))
            pparts.append(np.full(len(v), pid, dtype=np.int64))
            pid += 1
    if not vparts:
        return {}

    V = np.concatenate(vparts)          # (T, 3) global voxel coords
    R = np.concatenate(rparts)          # (T,)
    S = np.concatenate(sparts)          # (T,) label index
    P = np.concatenate(pparts)          # (T,) path id

    # from_path: fuse consecutive duplicates within a path (keep the raw
    # arrays too — reference radii are last-write-wins over the RAW
    # stream, including occurrences the fusion drops)
    V_raw, R_raw, S_raw = V, R, S
    keep = np.ones(len(V), dtype=bool)
    keep[1:] = (P[1:] != P[:-1]) | np.any(V[1:] != V[:-1], axis=1)
    V, R, S, P = V[keep], R[keep], S[keep], P[keep]
    T = len(V)

    def pack(Sa, Va):
        # vertex dedup key per (label, voxel): coords < 2^16 per axis and
        # label index < 2^16 by construction of seg_list chunking upstream
        return ((Sa.astype(np.uint64) << 48)
                | (Va[:, 0].astype(np.uint64) << 32)
                | (Va[:, 1].astype(np.uint64) << 16)
                | Va[:, 2].astype(np.uint64))

    key = pack(S, V)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    is_new = np.ones(T, dtype=bool)
    is_new[1:] = ks[1:] != ks[:-1]
    gid_sorted = np.cumsum(is_new) - 1
    n_groups = int(gid_sorted[-1]) + 1
    gid = np.empty(T, dtype=np.int64)
    gid[order] = gid_sorted

    # group -> representative (first occurrence in fused order)
    rep = np.full(n_groups, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(rep, gid, np.arange(T, dtype=np.int64))

    # last-write radii over the RAW stream (every raw key exists in the
    # fused set, so the searchsorted is an exact match)
    uniq_keys = ks[is_new]
    raw_gid = np.searchsorted(uniq_keys, pack(S_raw, V_raw))
    last_raw = np.zeros(n_groups, dtype=np.int64)
    np.maximum.at(last_raw, raw_gid, np.arange(len(V_raw), dtype=np.int64))

    g_verts = V[rep]
    g_radii = R_raw[last_raw]
    g_seg = S[rep]

    # edges: consecutive path vertices, undirected, deduped
    same_path = P[1:] == P[:-1]
    e0 = gid[:-1][same_path]
    e1 = gid[1:][same_path]
    lo = np.minimum(e0, e1)
    hi = np.maximum(e0, e1)
    ekey = lo.astype(np.uint64) * np.uint64(n_groups) + hi.astype(np.uint64)
    ekey = np.unique(ekey)
    lo = (ekey // np.uint64(n_groups)).astype(np.int64)
    hi = (ekey % np.uint64(n_groups)).astype(np.int64)

    # disconnected-vertex removal + final per-group local ids. Groups are
    # already ordered by (label, x, y, z) — consolidate's output order.
    used = np.zeros(n_groups, dtype=bool)
    used[lo] = True
    used[hi] = True
    final_id = np.cumsum(used) - 1
    # per-label base offset of the local numbering
    kept_seg = g_seg[used]
    kept_verts = g_verts[used].astype(np.float32)
    kept_radii = g_radii[used]
    n_kept = len(kept_seg)
    seg_starts = np.searchsorted(kept_seg, np.arange(len(seg_list)))
    seg_ends = np.searchsorted(kept_seg, np.arange(len(seg_list)),
                               side="right")

    local = final_id - seg_starts[g_seg]
    elo = local[lo].astype(np.uint32)
    ehi = local[hi].astype(np.uint32)
    eseg = g_seg[lo]
    eorder = np.argsort(eseg, kind="stable")
    elo, ehi, eseg = elo[eorder], ehi[eorder], eseg[eorder]
    es_starts = np.searchsorted(eseg, np.arange(len(seg_list)))
    es_ends = np.searchsorted(eseg, np.arange(len(seg_list)), side="right")

    anisotropy = np.asarray(anisotropy, dtype=np.float32)
    transform = np.array(
        [[anisotropy[0], 0, 0, 0],
         [0, anisotropy[1], 0, 0],
         [0, 0, anisotropy[2], 0]], dtype=np.float32)

    out = {}
    for s, i in seg_index.items():
        v0, v1 = int(seg_starts[i]), int(seg_ends[i])
        if v1 <= v0:
            continue
        e0_, e1_ = int(es_starts[i]), int(es_ends[i])
        skel = Skeleton(
            kept_verts[v0:v1],
            np.stack([elo[e0_:e1_], ehi[e0_:e1_]], axis=1),
            kept_radii[v0:v1],
            segid=s,
        )
        skel.transform = transform.copy()
        out[s] = skel
    return out
