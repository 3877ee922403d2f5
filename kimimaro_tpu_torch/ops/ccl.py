"""26-connected multi-label connected components labeling.

Torch counterpart of kimimaro_tpu.ops.ccl (the gsweep `minid` path). Each
voxel starts as its own 1-based linear index; minid sweep rounds
(ops.gsweep, kernel B1) carry the minimum index over same-label
26-neighbours until a round changes nothing; components that are still
unconverged after the first rounds are accelerated by pointer jumps. The
fixpoint is unique (each component carries its minimum linear index), so
the schedule does not change the result.

With a voxel graph (cc3d convention, self-touch walls) the sweeps run
B1-vg: a neighbour's id moves into a voxel only where the neighbour has
the voxel's label and its bit for that move is set. Both tests and the
voxel's occupancy sit in one word at the receiving voxel, built once by
G1's CCL form (ops.stencils.graph_into with the labels), so the sweeps
read the ids and that word and no labels. The fixpoint is still unique:
each voxel carries the minimum linear index over the voxels that reach
it, which pointer jumps keep, also for an asymmetric graph.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..utils import profiling
from . import gsweep
from .stencils import as_tensor, graph_into

BIGID = 2**31 - 1

_PHASE1_ROUNDS = 6     # sweep rounds before pointer jumping starts
_MAX_ROUNDS = 4096     # hard cap: a volume still changing after it is a bug


def _lin(shape, device):
    n = int(torch.Size(shape).numel())
    return torch.arange(1, n + 1, dtype=torch.int32,
                        device=device).reshape(shape)


def _jump(ids):
    flat = torch.where(ids == BIGID, 0, ids).reshape(-1)
    hop = flat[torch.clamp(flat - 1, min=0).long()]
    hop = torch.where(flat > 0, hop, BIGID).reshape(ids.shape)
    return torch.minimum(ids, hop)


def label_words(labels) -> torch.Tensor:
    """Labels as the int32 words the minid sweeps compare: int32 as it
    is, unsigned 32-bit bitcast and narrower types widened (each keeps
    equality and != 0), 64-bit labels renumbered by their sorted unique
    values (0 stays 0). An array-like is taken as a CPU tensor."""
    labels = as_tensor(labels)
    if labels.dtype == torch.int32:
        return labels
    if labels.dtype == torch.uint32:
        return labels.view(torch.int32)
    if labels.element_size() < 4 or labels.dtype == torch.bool:
        return labels.to(torch.int32)
    uniq, inv = profiling.host(
        labels, lambda t: torch.unique(t, return_inverse=True))
    zero = profiling.host(uniq == 0, torch.nonzero)
    rank = inv.to(torch.int32) + 1
    if zero.numel():
        rank = torch.where(inv == zero[0, 0], 0, rank)
    return rank


def connected_components(labels, voxel_graph=None,
                         device="cuda") -> torch.Tensor:
    """Raw 26-connected multi-label CCL of a 3D label volume (any integer
    type, as `label_words` takes it; an array-like on `device`, a tensor
    on its own device). Returns an int32 volume where each component is
    labeled by the 1-based minimum linear index of its voxels; background
    is 0. `voxel_graph`: an optional cc3d-convention bitfield of the same
    shape (uint32 or int32), taken to the labels' device."""
    labels = label_words(as_tensor(labels, device))
    if labels.ndim != 3:
        raise ValueError("connected_components takes a 3D volume")
    fg = labels != 0
    ids = torch.where(fg, _lin(labels.shape, labels.device), BIGID)
    if voxel_graph is None:
        cc_v, gate_v = gsweep.MaskViews(labels), None
    else:
        voxel_graph = as_tensor(voxel_graph).to(labels.device)
        cc_v = None
        gate_v = gsweep.MaskViews(graph_into(voxel_graph, labels))
    anis = (1.0, 1.0, 1.0)

    def sweep_round(x):
        return gsweep.one_round(x, cc_v, None, None, anis, "minid", False,
                                gate_v)

    for r in range(_MAX_ROUNDS):
        if r < _PHASE1_ROUNDS:
            nids = sweep_round(ids)
        else:
            nids = _jump(sweep_round(sweep_round(ids)))
        if profiling.host(nids, lambda t: torch.equal(t, ids)):
            break
        ids = nids
    else:
        raise RuntimeError("connected_components did not converge")
    return torch.where(fg, ids, 0)


def rep_prefix(cc_raw: torch.Tensor) -> torch.Tensor:
    """Inclusive count of component roots (voxels whose raw id equals
    1 + their linear index) in scan order, flat int32."""
    flat = cc_raw.reshape(-1)
    lin = torch.arange(1, flat.numel() + 1, dtype=flat.dtype,
                       device=flat.device)
    return torch.cumsum((flat == lin).to(torch.int32), 0, dtype=torch.int32)


def compact_cc(cc_raw: torch.Tensor):
    """Compaction of raw CCL output to contiguous 1..N in first-appearance
    (scan) order. The raw id of a component is 1 + the linear index of
    its root, so each voxel reads its root's scan-order rank directly.

    Returns (cc int32 compact, n_components int, rep_prefix (flat int32)).
    """
    prefix = rep_prefix(cc_raw)
    n_components = profiling.host(prefix[-1], int) if prefix.numel() else 0
    if n_components == 0:
        return torch.zeros_like(cc_raw), 0, prefix
    idx = torch.clamp(cc_raw.reshape(-1) - 1, min=0).long()
    cc = torch.where(cc_raw.reshape(-1) > 0, prefix[idx], 0)
    return cc.reshape(cc_raw.shape), n_components, prefix


def runs_bbox(flat, shape, ids, values):
    """Counts, per-id bounding boxes and per-id value maxima of a
    flattened id volume.

    flat: (n,) int32 nonnegative ids; shape: the 3D volume shape; ids:
    (q,) int32 query ids; values: (n,) f32. Returns (counts, mn (q,3),
    mx (q,3) inclusive, present, vmax (q,)); mn/mx are int32 max / -1 and
    vmax 0 for absent ids.

    Every output is a count, min or max per id, which no order of the
    voxels can change, so the reductions scatter directly instead of
    sorting the volume.
    """
    device = flat.device
    nx, ny, nz = (int(s) for s in shape)
    n_ids = max(profiling.host(flat.max(), int) + 1 if flat.numel() else 1,
                profiling.host(ids.max(), int) + 1 if ids.numel() else 1)
    key = flat.long()
    lin = torch.arange(flat.numel(), dtype=torch.int64, device=device)
    coords = (lin // (ny * nz), (lin // nz) % ny, lin % nz)
    counts_all = profiling.host(
        key, lambda k: torch.bincount(k, minlength=n_ids))
    imax = torch.iinfo(torch.int32).max
    mn_all, mx_all = [], []
    for c in coords:
        c = c.to(torch.int32)
        mn_all.append(torch.full((n_ids,), imax, dtype=torch.int32,
                                 device=device).scatter_reduce_(
            0, key, c, "amin"))
        mx_all.append(torch.full((n_ids,), -1, dtype=torch.int32,
                                 device=device).scatter_reduce_(
            0, key, c, "amax"))
    q = ids.long()
    counts = counts_all[q].to(torch.int32)
    present = counts > 0
    mn = torch.stack([m[q] for m in mn_all], dim=1)
    mx = torch.stack([m[q] for m in mx_all], dim=1)
    vmax_all = torch.full((n_ids,), float("-inf"), dtype=torch.float32,
                          device=device).scatter_reduce_(
        0, key, values.reshape(-1).to(torch.float32), "amax")
    vmax = torch.where(present, vmax_all[q], 0.0)
    return counts, mn, mx, present, vmax


def label_info(cc, orig_labels, n_max: int, rep_prefix, dbf):
    """Per-component metadata: voxel counts, bounding boxes, the original
    label of each component (read at its representative voxel, via the
    monotone `rep_prefix` from compact_cc) and the per-component DBF max.

    Returns (counts (n_max+1,), bbox_min (n_max+1,3), bbox_max (n_max+1,3)
    inclusive, orig (n_max+1,), dbfmax (n_max+1,)); `orig` holds the label
    values as stored in `orig_labels` (int32 bit patterns).
    """
    flat = cc.reshape(-1).to(torch.int32)
    ids = torch.arange(n_max + 1, dtype=torch.int32, device=cc.device)
    counts, bbox_min, bbox_max, _, dbfmax = runs_bbox(
        flat, cc.shape, ids, dbf.reshape(-1))
    rep_lin = torch.searchsorted(rep_prefix, ids)
    rep_lin = torch.clamp(rep_lin, 0, rep_prefix.numel() - 1)
    orig = orig_labels.reshape(-1)[rep_lin]
    orig[0] = 0
    return counts, bbox_min, bbox_max, orig, dbfmax


def renumber_cc(cc_raw, orig_labels, device="cuda"
                ) -> Tuple[np.ndarray, Dict[int, int]]:
    """Compaction of raw CCL output to contiguous ids in the order of the
    raw ids (background 0 stays 0; without background the ids start at
    1), plus the cc-id -> original-label mapping, each component's label
    taken at its first voxel (kimimaro_tpu.ops.ccl.renumber_cc). The
    sort and the first voxels are found on `cc_raw`'s device (`device`
    for an array); the result is a host array, as JAX returns it."""
    if not torch.is_tensor(cc_raw):
        cc_raw = np.asarray(cc_raw)
        if cc_raw.dtype.kind == "u" and cc_raw.dtype.itemsize >= 4:
            cc_raw = cc_raw.astype(np.int64)  # torch sorts no wide unsigned
    raw = as_tensor(cc_raw, device)
    flat = raw.reshape(-1)
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    first_idx = torch.full((uniq.numel(),), flat.numel(), dtype=torch.int64,
                           device=flat.device).scatter_reduce_(
        0, inv, torch.arange(flat.numel(), device=flat.device), "amin")
    n = int(uniq.numel())
    start = 0 if n and int(uniq[0]) == 0 else 1
    cc = (inv + start).reshape(raw.shape).cpu().numpy()
    cc = cc.astype(np.uint32 if n < 2**32 else np.uint64)
    first_idx = first_idx.cpu().numpy()
    flat_orig = np.asarray(orig_labels.cpu() if torch.is_tensor(orig_labels)
                           else orig_labels).reshape(-1)
    return cc, {uid: int(flat_orig[fidx])
                for uid, fidx in enumerate(first_idx.tolist(), start)
                if uid != 0}
