"""The self-touch deployment: about one label in `share` relabelled to the id
of a touching neighbour (each label in one merge at most), with the
connectivity graph of the labels before the merge as the voxel graph
(cc3d's `voxel_connectivity_graph` convention, uint32 bits)."""

from __future__ import annotations

import numpy as np
import torch

from gen import GRAPH_BITS, label_graph, pair_slices


def apply(vol, graph, p, shape, device):
    return merge(vol, p)


def merge(pre: torch.Tensor, p: dict):
    """(merged labels, the graph of `pre` as a host uint32 array)."""
    k = int(pre.max()) + 1
    keys = []
    for o in GRAPH_BITS:
        if o < (0, 0, 0):
            continue               # each undirected pair of moves once
        dst, src = pair_slices(o, pre.shape)
        a, b = pre[dst], pre[src]
        m = (a != b) & (a != 0) & (b != 0)
        lo = torch.minimum(a, b)[m].long()
        hi = torch.maximum(a, b)[m].long()
        keys.append(torch.unique(lo * k + hi))
    keys = torch.unique(torch.cat(keys)).cpu().numpy()
    want = int((torch.bincount(pre.reshape(-1).long(), minlength=k)[1:] > 0)
               .sum()) // int(p["share"])
    lut = torch.arange(k, dtype=torch.int32, device=pre.device)
    used, n = set(), 0
    for key in keys:
        a, b = int(key // k), int(key % k)
        if a in used or b in used:
            continue
        lut[b] = a
        used.update((a, b))
        n += 1
        if n >= want:
            break
    graph = label_graph(pre).cpu().numpy().view(np.uint32)
    return lut[pre.long()], graph
