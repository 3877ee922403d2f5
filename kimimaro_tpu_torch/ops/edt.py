"""Multi-label anisotropic 3D Euclidean distance transform.

Torch counterpart of kimimaro_tpu.ops.edt (edt, edtsq). For each voxel of
label L: the distance to the nearest voxel of a different label (label 0
is background, distance 0), with per-axis anisotropic weights;
`black_border=True` additionally treats the volume boundary as
background.

Exact separable squared-distance transform as three axis passes: the first
axis is an O(n) run-boundary scan; later axes are banded min-plus parabola
passes

    D_new[i] = min_{|o|<=band} ( g(i+o) + w^2 o^2 ),
    g(j) = D_old[j] if label[j] == label[i] else 0

with the band escalated wherever the result exceeds what the band can
prove. A voxel graph (self-touch walls) breaks a line where its +axis edge
is blocked, exactly like a label change: each line carries the index of
its wall segment, and voxels of different segments do not see each other.
The f32 operation order mirrors the JAX package, and the final
square root is taken in float64 and rounded once, which is the correctly
rounded f32 root on every device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .stencils import as_tensor, graph_allows

BIG = float(np.float32(3.4e37))  # stand-in for +inf that survives arithmetic


def _lines(vol, axis):
    """(n, B) view with `axis` first."""
    n = vol.shape[axis]
    return torch.movedim(vol, axis, 0).reshape(n, -1)


def _unlines(t, shape, axis):
    moved = list(shape)
    moved.insert(0, moved.pop(axis))
    return torch.movedim(t.reshape(moved), 0, axis)


def _axial_pass(labels, w: float, black_border: bool, wall=None):
    """Squared distance along the FIRST axis of (n, B) lines to the
    nearest different-label voxel: within a run of equal labels [s, e] it
    is at s-1 or e+1. `wall`: (n, B) wall-segment indices; a segment
    change breaks a run like a label change."""
    n, B = labels.shape
    idx = torch.arange(n, dtype=torch.int32, device=labels.device)[:, None]

    def run_starts(lab, wl):
        change = torch.zeros((n, B), dtype=torch.bool, device=lab.device)
        change[1:] = lab[1:] != lab[:-1]
        if wl is not None:
            change[1:] |= wl[1:] != wl[:-1]
        return torch.cummax(torch.where(change, idx, 0), dim=0).values

    flip = None if wall is None else torch.flip(wall, (0,))
    start = run_starts(labels, wall)
    end = (n - 1) - torch.flip(run_starts(torch.flip(labels, (0,)), flip),
                               (0,))

    has_left = start > 0
    has_right = end < n - 1
    left = (idx - start + 1).to(torch.float32)
    right = (end - idx + 1).to(torch.float32)
    fidx = idx.to(torch.float32)
    if black_border:
        left = torch.where(has_left, left, fidx + 1.0)
        right = torch.where(has_right, right, float(n) - fidx)
    else:
        left = torch.where(has_left, left, BIG)
        right = torch.where(has_right, right, BIG)

    d = torch.minimum(left, right)
    d = torch.clamp(d, max=BIG)
    wd = float(np.float32(w)) * d
    return torch.clamp(wd * wd, max=BIG)


def _parabola_pass_banded(d, labels, w: float, black_border: bool,
                          band: int, wall=None):
    """Banded min-plus parabola pass along the FIRST axis of (n, B) lines.
    Exact wherever the result satisfies D_new <= (band*w)^2. `wall`: (n,
    B) wall-segment indices; voxels of different segments are mutually
    invisible, as if of different labels."""
    n, B = d.shape
    w2 = np.float32(w) ** 2
    oob_g = 0.0 if black_border else BIG
    dev = d.device

    d_p = torch.full((n + 2 * band, B), BIG, dtype=torch.float32, device=dev)
    d_p[band:band + n] = d
    l_p = torch.zeros((n + 2 * band, B), dtype=labels.dtype, device=dev)
    l_p[band:band + n] = labels
    v_p = torch.zeros((n + 2 * band, 1), dtype=torch.bool, device=dev)
    v_p[band:band + n] = True
    if wall is not None:
        w_p = torch.full((n + 2 * band, B), -1, dtype=wall.dtype, device=dev)
        w_p[band:band + n] = wall

    best = torch.full_like(d, BIG)
    for o in range(2 * band + 1):
        d_s = d_p[o:o + n]
        l_s = l_p[o:o + n]
        v_s = v_p[o:o + n]
        same = l_s == labels
        if wall is not None:
            same = same & (w_p[o:o + n] == wall)
        g = torch.where(v_s & same, d_s,
                        torch.where(v_s, 0.0, oob_g).to(torch.float32))
        off = np.float32(o - band)
        cand = g + float(w2 * off * off)
        best = torch.minimum(best, cand)
    return torch.minimum(best, d)


def _banded_with_escalation(d, labels, w: float, black_border: bool, n: int,
                            wall=None):
    """Banded parabola pass, re-run once with a band that the first
    result proves sufficient wherever the 16-band guarantee fails."""
    band = min(16, n - 1)
    out = _parabola_pass_banded(d, labels, w, black_border, band, wall)
    if band >= n - 1:
        return out
    thresh = float((np.float32(w) * band) ** 2)
    max_out = float(out.max())
    if max_out <= thresh:
        return out
    need = int(np.ceil(np.sqrt(max_out) / w)) + 1
    band = 16
    while band < need:
        band <<= 1
    band = min(band, n - 1)
    return _parabola_pass_banded(d, labels, w, black_border, band, wall)


AXIS_UNIT = ((1, 0, 0), (0, 1, 0), (0, 0, 1))


def wall_segments(open_edges: torch.Tensor, dim: int) -> torch.Tensor:
    """int32 wall-segment index along `dim` of lines whose voxels' next
    edge along `dim` is open where `open_edges` holds: it steps up after
    each blocked edge."""
    n = open_edges.shape[dim]
    steps = torch.zeros(open_edges.shape, dtype=torch.int32,
                        device=open_edges.device)
    steps.narrow(dim, 1, n - 1).copy_(~open_edges.narrow(dim, 0, n - 1))
    return torch.cumsum(steps, dim=dim, dtype=torch.int32)


def edtsq(labels: torch.Tensor, anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
          black_border: bool = False, voxel_graph=None,
          device="cuda") -> torch.Tensor:
    """Squared multi-label anisotropic EDT of a 2D or 3D integer volume.
    Returns float32, BIG where the distance is unbounded (single label, no
    black border). `voxel_graph`: a cc3d-convention bitfield of the same
    shape; a blocked axis edge acts as a label boundary in that axis's
    pass (self-touch walls). Array-likes go to `device`, a tensor stays
    on its own; unsigned 32-bit labels are compared through their int32
    bits."""
    labels = as_tensor(labels, device)
    if labels.dtype == torch.uint32:
        labels = labels.view(torch.int32)
    if voxel_graph is not None:
        voxel_graph = as_tensor(voxel_graph).to(labels.device)
    squeeze_2d = labels.ndim == 2
    if squeeze_2d:
        # a borderless singleton z axis
        labels = labels[..., None]
        anisotropy = tuple(anisotropy) + (1.0,)
        if voxel_graph is not None:
            voxel_graph = voxel_graph[..., None]
    if labels.ndim != 3:
        raise ValueError("edt expects a 2D or 3D volume")
    shape = tuple(labels.shape)

    d = torch.full(shape, BIG, dtype=torch.float32, device=labels.device)
    first = True
    for axis in range(2 if squeeze_2d else 3):
        w = float(anisotropy[axis])
        n = shape[axis]
        if n == 1:
            # the only contribution along a singleton axis is the border
            if black_border:
                d = torch.clamp(d, max=float(np.float32(w) ** 2))
            continue
        lab_t = _lines(labels, axis)
        wall = (None if voxel_graph is None else wall_segments(
            _lines(graph_allows(voxel_graph, AXIS_UNIT[axis]), axis), 0))
        if first:
            out = _axial_pass(lab_t, w, bool(black_border), wall)
            first = False
        else:
            out = _banded_with_escalation(_lines(d, axis), lab_t, w,
                                          bool(black_border), n, wall)
        d = _unlines(out, shape, axis)
        # background distances are never read by foreground lines
        # (different label => g = 0): zeroing them keeps the escalation
        # check foreground-only
        d = torch.where(labels == 0, 0.0, d).contiguous()
    return d[..., 0] if squeeze_2d else d


def edt(labels: torch.Tensor, anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
        black_border: bool = False, voxel_graph=None,
        device="cuda") -> torch.Tensor:
    """Multi-label anisotropic euclidean distance transform (physical
    units); `voxel_graph` and `device` as in `edtsq`."""
    return torch.sqrt(edtsq(labels, anisotropy, black_border,
                            voxel_graph, device).double()).float()
