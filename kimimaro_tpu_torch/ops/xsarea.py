"""Plane-box cross-section areas and the per-label section driver.

Torch counterpart of kimimaro_tpu.ops.xsarea:
  - `box_plane_area`: the closed-form area of a plane slicing an
    axis-aligned box (the box-spline density of three uniforms, evaluated
    stably by sorting the three projection widths);
  - `cross_section_areas`: many sectioning planes of ONE binary image,
    grouped by dominant axis; each group climbs windowed slab rungs
    (ops.xsbatch `slab_sections_volume`: kernels B6 and X1 on the card)
    and ends in the dense 3D rung, whose 26-connected flood is a bounded
    relaxation through ops.geodesic `relax_rounds_batched` (kernel B4);
    degenerate (zero) normals go straight to the dense rungs;
  - `cross_section_image`: the per-voxel section areas of one plane.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..utils import profiling
from .fma import fma_f32
from .geodesic import INF, distance_field, relax_rounds_batched

_EPS = 1e-20
_PERMS = ((1, 2, 0), (0, 2, 1), (0, 1, 2))  # dominant axis d moved last
# bytes of device memory per crop voxel and lane of the dense rung (the
# relaxation's field and mask copies, the plane areas and their temporaries)
_DENSE_BYTES_PER_VOXEL = 96
LANE_BUDGET_BYTES = 1 << 31


def _trapezoid_integral(x, a, b, fused: bool):
    """I(x) = integral_0^x r(u) du for the symmetric trapezoid
    r(u) = clamp01(((a+b)/2 - |u|)/b), handled as an odd function."""
    M = (a + b) / 2.0
    ax = torch.abs(x)
    flat = torch.minimum(ax, torch.clamp(M - b, min=0.0))
    xhat = torch.minimum(torch.maximum(ax, M - b), M)
    d = M - xhat
    num = fma_f32(d, d, b * b, negate=True) if fused else b * b - d * d
    ramp = num / (2.0 * torch.clamp(b, min=_EPS))
    return torch.sign(x) * (flat + ramp)


def box_plane_area(t, normal, anisotropy, fused: bool = True):
    """Area of the intersection of a plane with an axis-aligned box.

    t: (...) float32 signed distances from box centres to the plane along
    `normal` (physical units); normal: (..., 3) unit normals broadcastable
    against t; anisotropy: the three box edge lengths. fused: the ramp's
    b*b - d*d is one fused multiply-add, as under the JAX package's jit
    (False for its eagerly run `cross_section_image`)."""
    s = torch.as_tensor(np.asarray(anisotropy, dtype=np.float32),
                        device=t.device)
    w = torch.abs(normal) * s
    w_sorted = torch.sort(w, dim=-1).values
    a = w_sorted[..., 2]
    b = w_sorted[..., 1]
    c = w_sorted[..., 0]

    M = (a + b) / 2.0
    r_mid = torch.clamp((M - torch.abs(t)) / torch.clamp(b, min=_EPS),
                        0.0, 1.0)
    ic = torch.clamp(c, min=_EPS)
    mean_big = (_trapezoid_integral(t + c / 2.0, a, b, fused)
                - _trapezoid_integral(t - c / 2.0, a, b, fused)) / ic
    mean = torch.where(c <= 1e-3 * a, r_mid,
                       torch.clamp(mean_big, 0.0, 1.0))
    boxvol = s[0] * s[1] * s[2]
    return boxvol / torch.clamp(a, min=_EPS) * mean


def lane_chunks(n: int, per_lane_bytes: int):
    """Slices of n lanes into batches of at most LANE_BUDGET_BYTES."""
    lanes = max(1, LANE_BUDGET_BYTES // max(int(per_lane_bytes), 1))
    return [slice(i, min(i + lanes, n)) for i in range(0, n, lanes)]


def _sections_batch(fg, verts, normals, anisotropy, rounds: int):
    """The dense rung: for each (vertex, normal) lane, the area of the
    plane section of the bool crop `fg` (X, Y, Z) 26-connected to the
    vertex, its face-contact bits and whether the bounded flood
    converged. verts (B, 3) int, normals (B, 3) float32, on fg's device.
    Returns (areas (B,), contacts (B,) uint8, conv (B,) bool)."""
    dev = fg.device
    B = verts.shape[0]
    X, Y, Z = fg.shape
    s = torch.as_tensor(np.asarray(anisotropy, dtype=np.float32), device=dev)
    p0 = verts.to(torch.float32) * s
    gx = torch.arange(X, dtype=torch.float32, device=dev).view(1, X, 1, 1)
    gy = torch.arange(Y, dtype=torch.float32, device=dev).view(1, 1, Y, 1)
    gz = torch.arange(Z, dtype=torch.float32, device=dev).view(1, 1, 1, Z)
    col = [p0[:, k].view(B, 1, 1, 1) for k in range(3)]
    nrm = [normals[:, k].view(B, 1, 1, 1) for k in range(3)]
    # XLA fuses the y product into the x one; the z product is added apart
    t = (fma_f32(gy * s[1] - col[1], nrm[1], (gx * s[0] - col[0]) * nrm[0])
         + (gz * s[2] - col[2]) * nrm[2])
    areas = box_plane_area(t, normals.view(B, 1, 1, 1, 3), anisotropy)
    del t
    sec = fg[None] & (areas > 0.0)
    seed = torch.zeros_like(sec)
    v = verts.long()
    seed[torch.arange(B, device=dev), v[:, 0], v[:, 1], v[:, 2]] = True
    d0 = torch.where(seed & sec, 0.0, INF)
    d, conv = relax_rounds_batched(d0, sec, None, (1.0, 1.0, 1.0), rounds,
                                   conv="reach")
    kept = torch.isfinite(d)
    area = torch.where(kept, areas, 0.0).sum(dim=(1, 2, 3))
    contact = torch.zeros(B, dtype=torch.uint8, device=dev)
    for axis in range(3):
        lo = kept.select(axis + 1, 0).flatten(1).any(dim=1)
        hi = kept.select(axis + 1, fg.shape[axis] - 1).flatten(1).any(dim=1)
        contact |= lo.to(torch.uint8) << (2 * axis)
        contact |= hi.to(torch.uint8) << (2 * axis + 1)
    return area, contact, conv


def _run_rungs(rungs, verts, normals, out, count_first: bool = True):
    """Run the first rung over every query, then each later rung over the
    queries still unconverged; `out` is (areas, contacts, conv) host
    arrays the rungs fill in. Counts `xs_rung{r}_queries` per rung (the
    first one only with `count_first`)."""
    areas, contacts, conv = out
    for r, (run, per_lane_bytes) in enumerate(rungs):
        todo = np.arange(len(verts)) if r == 0 else np.flatnonzero(~conv)
        if len(todo) == 0:
            break
        pend = []
        for sl in lane_chunks(len(todo), per_lane_bytes):
            idx = todo[sl]
            pend.append((idx, run(verts[idx], normals[idx])))
        for idx, (a, c, cv) in pend:
            areas[idx] = a.cpu().numpy()
            contacts[idx] = c.cpu().numpy()
            conv[idx] = cv.cpu().numpy()
        if r or count_first:
            profiling.count(f"xs_rung{r}_queries", len(todo))


def cross_section_areas(binimg, verts, normals,
                        anisotropy: Sequence[float] = (1, 1, 1),
                        device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """Evaluate many sectioning planes of one binary image.

    binimg: (X, Y, Z) binary image (numpy or tensor); verts (N, 3) int
    voxel coordinates; normals (N, 3) unit physical normals. Returns
    (areas float32 (N,), contacts uint8 (N,)) as numpy arrays."""
    from .xsbatch import slab_lane_bytes, slab_sections_volume

    dev = torch.device(device)
    fg = torch.as_tensor(np.asarray(binimg) != 0, device=dev)
    verts = np.asarray(verts, dtype=np.int32).reshape(-1, 3)
    normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
    n = verts.shape[0]
    anis = np.asarray(anisotropy, dtype=np.float32)
    w = np.abs(normals) * anis[None, :]
    dom = np.argmax(w, axis=1)
    degenerate = w.max(axis=1) < 1e-12
    areas = np.zeros(n, dtype=np.float32)
    contacts = np.zeros(n, dtype=np.uint8)

    def dense_rung(fg_t, anis_t, rounds):
        def run(v, m):
            return _sections_batch(fg_t, torch.from_numpy(v).to(dev),
                                   torch.from_numpy(m).to(dev), anis_t,
                                   rounds)
        return run, _DENSE_BYTES_PER_VOXEL * fg_t.numel()

    def slab_rung(vol_t, anis_t, W, rounds, method):
        def run(v, m):
            return slab_sections_volume(
                vol_t, torch.ones(len(v), dtype=torch.int32, device=dev),
                torch.from_numpy(v).to(dev), torch.from_numpy(m).to(dev),
                anis_t, W, rounds, method)
        return run, slab_lane_bytes(vol_t.shape, W)

    for d in range(3):
        sel = np.flatnonzero((dom == d) & ~degenerate)
        if len(sel) == 0:
            continue
        perm = _PERMS[d]
        fg_t = fg.permute(perm).contiguous()
        vol_t = fg_t.to(torch.int32)
        anis_p = tuple(float(anis[p]) for p in perm)
        # window/round escalation: small crops are one full-window sweep
        # rung; larger ones climb from a small dilation window to full
        # window sweeps; the dense 3D flood is the last resort
        full = max(fg_t.shape[0], fg_t.shape[1])
        if full <= 128:
            rungs = [slab_rung(vol_t, anis_p, full, 10, "sweep")]
        else:
            rungs = [slab_rung(vol_t, anis_p, 64, 96, "dilate"),
                     slab_rung(vol_t, anis_p, 256, 4, "sweep"),
                     slab_rung(vol_t, anis_p, full, 10, "sweep")]
        rungs.append(dense_rung(fg_t, anis_p, 192))
        g = (np.zeros(len(sel), np.float32), np.zeros(len(sel), np.uint8),
             np.zeros(len(sel), bool))
        _run_rungs(rungs, verts[sel][:, perm], normals[sel][:, perm], g)
        areas[sel] = g[0]
        # remap permuted-axis contact bit pairs back to original axes
        cc = np.zeros_like(g[1])
        for j, p in enumerate(perm):
            cc |= ((g[1] >> (2 * j)) & 3) << (2 * p)
        contacts[sel] = cc

    degs = np.flatnonzero(degenerate)
    if len(degs):
        anis_t = tuple(float(x) for x in anis)
        g = (np.zeros(len(degs), np.float32), np.zeros(len(degs), np.uint8),
             np.zeros(len(degs), bool))
        _run_rungs([dense_rung(fg, anis_t, r) for r in (8, 48, 192)],
                   verts[degs], normals[degs], g, count_first=False)
        areas[degs] = g[0]
        contacts[degs] = g[1]
    return areas, contacts


def cross_section_image(binimg, vert, normal,
                        anisotropy: Sequence[float] = (1, 1, 1),
                        device="cpu") -> np.ndarray:
    """Float image of per-voxel section areas for one plane: the plane's
    areas on the voxels of the section 26-connected to `vert`."""
    dev = torch.device(device)
    fg = torch.as_tensor(np.asarray(binimg) != 0, device=dev)
    v = torch.as_tensor(np.asarray(vert, dtype=np.int64).reshape(1, 3),
                        device=dev)
    m = torch.as_tensor(np.asarray(normal, dtype=np.float32).reshape(1, 3),
                        device=dev)
    s = torch.as_tensor(np.asarray(anisotropy, dtype=np.float32), device=dev)
    X, Y, Z = fg.shape
    p0 = v[0].to(torch.float32) * s
    gx = torch.arange(X, dtype=torch.float32, device=dev).view(X, 1, 1)
    gy = torch.arange(Y, dtype=torch.float32, device=dev).view(1, Y, 1)
    gz = torch.arange(Z, dtype=torch.float32, device=dev).view(1, 1, Z)
    t = ((gx * s[0] - p0[0]) * m[0, 0] + (gy * s[1] - p0[1]) * m[0, 1]
         + (gz * s[2] - p0[2]) * m[0, 2])
    areas = box_plane_area(t, m[0], anisotropy, fused=False)
    sec = fg & (areas > 0.0)
    init = torch.full(sec.shape, INF, device=dev)
    init[tuple(int(c) for c in v[0])] = 0.0
    dist = distance_field(sec, torch.where(sec, init, INF), (1.0, 1.0, 1.0),
                          conv="reach")
    return torch.where(torch.isfinite(dist), areas, 0.0).cpu().numpy()
