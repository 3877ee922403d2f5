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
prove. The f32 operation order mirrors the JAX package, and the final
square root is taken in float64 and rounded once, which is the correctly
rounded f32 root on every device.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

BIG = float(np.float32(3.4e37))  # stand-in for +inf that survives arithmetic


def _lines(vol, axis):
    """(n, B) view with `axis` first."""
    n = vol.shape[axis]
    return torch.movedim(vol, axis, 0).reshape(n, -1)


def _unlines(t, shape, axis):
    moved = list(shape)
    moved.insert(0, moved.pop(axis))
    return torch.movedim(t.reshape(moved), 0, axis)


def _axial_pass(labels, w: float, black_border: bool):
    """Squared distance along the FIRST axis of (n, B) lines to the
    nearest different-label voxel: within a run of equal labels [s, e] it
    is at s-1 or e+1."""
    n, B = labels.shape
    idx = torch.arange(n, dtype=torch.int32, device=labels.device)[:, None]

    def run_starts(lab):
        change = torch.zeros((n, B), dtype=torch.bool, device=lab.device)
        change[1:] = lab[1:] != lab[:-1]
        return torch.cummax(torch.where(change, idx, 0), dim=0).values

    start = run_starts(labels)
    end = (n - 1) - torch.flip(run_starts(torch.flip(labels, (0,))), (0,))

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
                          band: int):
    """Banded min-plus parabola pass along the FIRST axis of (n, B) lines.
    Exact wherever the result satisfies D_new <= (band*w)^2."""
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

    best = torch.full_like(d, BIG)
    for o in range(2 * band + 1):
        d_s = d_p[o:o + n]
        l_s = l_p[o:o + n]
        v_s = v_p[o:o + n]
        same = l_s == labels
        g = torch.where(v_s & same, d_s,
                        torch.where(v_s, 0.0, oob_g).to(torch.float32))
        off = np.float32(o - band)
        cand = g + float(w2 * off * off)
        best = torch.minimum(best, cand)
    return torch.minimum(best, d)


def _banded_with_escalation(d, labels, w: float, black_border: bool, n: int):
    """Banded parabola pass, re-run once with a band that the first
    result proves sufficient wherever the 16-band guarantee fails."""
    band = min(16, n - 1)
    out = _parabola_pass_banded(d, labels, w, black_border, band)
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
    return _parabola_pass_banded(d, labels, w, black_border, band)


def edtsq(labels: torch.Tensor, anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
          black_border: bool = False) -> torch.Tensor:
    """Squared multi-label anisotropic EDT of a 3D integer volume. Returns
    float32, BIG where the distance is unbounded (single label, no black
    border)."""
    if labels.ndim != 3:
        raise ValueError("edt expects a 3D volume")
    shape = tuple(labels.shape)

    d = torch.full(shape, BIG, dtype=torch.float32, device=labels.device)
    first = True
    for axis in range(3):
        w = float(anisotropy[axis])
        n = shape[axis]
        if n == 1:
            # the only contribution along a singleton axis is the border
            if black_border:
                d = torch.clamp(d, max=float(np.float32(w) ** 2))
            continue
        lab_t = _lines(labels, axis)
        if first:
            out = _axial_pass(lab_t, w, bool(black_border))
            first = False
        else:
            out = _banded_with_escalation(_lines(d, axis), lab_t, w,
                                          bool(black_border), n)
        d = _unlines(out, shape, axis)
        # background distances are never read by foreground lines
        # (different label => g = 0): zeroing them keeps the escalation
        # check foreground-only
        d = torch.where(labels == 0, 0.0, d).contiguous()
    return d


def edt(labels: torch.Tensor, anisotropy: Sequence[float] = (1.0, 1.0, 1.0),
        black_border: bool = False) -> torch.Tensor:
    """Multi-label anisotropic euclidean distance transform (physical
    units)."""
    return torch.sqrt(edtsq(labels, anisotropy, black_border).double()).float()
