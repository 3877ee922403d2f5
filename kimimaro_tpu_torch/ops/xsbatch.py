"""Cross-label windowed cross sections over the full label volume.

Torch counterpart of kimimaro_tpu.ops.xsbatch (the gather path). All
sectioning planes of a volume share one upload and one permuted copy of
the volume per dominant-axis group (dominant axis last, so each cell's K
candidate cells are contiguous). Each query lane takes a W x W window of
columns around its own vertex and compares the window's cells with its
own label, so lanes of many labels share a batch:

  1. per lane, the plane's slab base zb(i, j) of every window column;
  2. kernel B6 (ops.xsfetch `fetch_secb`): the K-bit foreground word of
     every column;
  3. the per-cell plane areas (ops.xsarea `box_plane_area`) clip the
     words to the section; kernel X1 (ops.xsslab `section_flood`) floods
     the section from the vertex;
  4. a section that reaches a window edge that is not a volume face has
     not converged; the area sums the kept cells' areas, and the contact
     bits test the volume faces.

Each query starts at the smallest rung whose window holds its radius hint
and climbs the rung menu while unconverged. Lanes go to the device in
batches bounded by memory, not by a fixed lane width.
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils import profiling
from . import xsfetch, xsslab
from .fma import fma_f32
from .xsarea import box_plane_area, lane_chunks
from .xsslab import K

_PERMS = ((1, 2, 0), (0, 2, 1), (0, 1, 2))  # dominant axis moved last
# bytes of device memory per window cell and lane (the K-cell areas and
# their temporaries, the words, masks and indices)
_CELL_BYTES = 320

# (W, rounds, method) rung menu; rung 0 is radius-gated
_RUNGS = (
    (32, 36, "dilate"),
    (64, 6, "sweep"),
    (128, 6, "sweep"),
    (512, 24, "sweep"),
    (512, 96, "sweep"),
)


def slab_lane_bytes(dims, W: int) -> int:
    """Device bytes one lane of a W-window batch over `dims` takes."""
    return _CELL_BYTES * min(W, int(dims[0])) * min(W, int(dims[1]))


def _finish_section(raw, gx, gy, zb, a, denom, verts, wx0, wy0, normals,
                    anisotropy, dims, Wx: int, Wy: int, method: str,
                    rounds: int):
    """Per-cell areas, seeded flood over the window, escape test, area
    sum and contact bits of a batch of lanes. `raw` holds the K-bit
    foreground words (z-validity included)."""
    tx, ty, tz = dims
    B = raw.shape[0]
    dev = raw.device
    kidx = torch.arange(K, dtype=torch.int32, device=dev)
    kbit = torch.ones(K, dtype=torch.int32, device=dev) << kidx
    zidx = zb[..., None] + kidx
    # XLA fuses this multiply-add (the window plane `a` it leaves apart)
    t = fma_f32(zidx.to(torch.float32), denom.view(B, 1, 1, 1),
                a[..., None])
    areas = box_plane_area(t, normals.view(B, 1, 1, 1, 3), anisotropy)
    del t
    sec = ((raw[..., None] & kbit) != 0) & (areas > 0.0)
    secb = (sec.to(torch.int32) * kbit).sum(dim=-1, dtype=torch.int32)
    del sec

    lanes = torch.arange(B, device=dev)
    si = (verts[:, 0] - wx0).long()
    sj = (verts[:, 1] - wy0).long()
    kseed = verts[:, 2] - zb[lanes, si, sj]
    seedbit = torch.where((kseed >= 0) & (kseed < K),
                          torch.ones_like(kseed)
                          << torch.clamp(kseed, 0, K - 1), 0)
    seed = torch.zeros_like(secb)
    seed[lanes, si, sj] = seedbit.to(torch.int32)
    seed &= secb

    if tz > xsslab.ZB_MAX:
        # zb + k lies in [0, tz) wherever secb has bit k, so zb fits X1's
        # int16 there for volumes below 2^15 along the sections' z
        xsslab.check_zb(secb, zb)
    kept, changed, _ = xsslab.section_flood(seed, secb, zb, rounds, method)

    x0, y0 = wx0.view(B, 1, 1), wy0.view(B, 1, 1)
    esc = (((gx == x0) & (x0 > 0)) | ((gx == x0 + Wx - 1) & (x0 + Wx < tx))
           | ((gy == y0) & (y0 > 0)) | ((gy == y0 + Wy - 1) & (y0 + Wy < ty)))
    escaped = ((kept != 0) & esc).flatten(1).any(dim=1)
    conv = ~changed & ~escaped

    kmask = (kept[..., None] & kbit) != 0
    area = torch.where(kmask, areas, 0.0).sum(dim=(1, 2, 3))

    def touches(face):
        return (kmask & face).flatten(1).any(dim=1).to(torch.uint8)

    contact = (touches((gx == 0)[..., None])
               | touches((gx == tx - 1)[..., None]) << 1
               | touches((gy == 0)[..., None]) << 2
               | touches((gy == ty - 1)[..., None]) << 3
               | touches(zidx == 0) << 4
               | touches(zidx == tz - 1) << 5)
    return area, contact, conv


def slab_sections_volume(volp, qlabels, verts, normals, anisotropy,
                         W: int = 32, rounds: int = 36,
                         method: str = "dilate"):
    """Windowed cross sections of a multi-label volume, many labels per
    batch.

    volp: (tx, ty, tz) int32 volume whose last axis is every lane's
    dominant axis (|n_z| s_z = max_a |n_a| s_a); qlabels (B,) int32
    per-lane label ids; verts (B, 3) int and normals (B, 3) float32 in the
    same permuted order, as is `anisotropy`; all on volp's device.
    Returns (areas (B,) float32, contacts (B,) uint8 in permuted xxyyzz
    bit order, conv (B,) bool)."""
    dev = volp.device
    tx, ty, tz = (int(v) for v in volp.shape)
    Wx, Wy = int(min(W, tx)), int(min(W, ty))
    B = verts.shape[0]
    s = torch.as_tensor(np.asarray(anisotropy, dtype=np.float32), device=dev)
    v = verts.to(torch.int32)
    wx0 = torch.clamp(v[:, 0] - Wx // 2, 0, max(tx - Wx, 0))
    wy0 = torch.clamp(v[:, 1] - Wy // 2, 0, max(ty - Wy, 0))
    gx = wx0.view(B, 1, 1) + torch.arange(
        Wx, dtype=torch.int32, device=dev).view(1, Wx, 1)
    gy = wy0.view(B, 1, 1) + torch.arange(
        Wy, dtype=torch.int32, device=dev).view(1, 1, Wy)

    p0 = v.to(torch.float32) * s
    nx, ny, nz = (normals[:, k].view(B, 1, 1) for k in range(3))
    # XLA fuses the y product into the sum; the per-lane product p0_z*n_z
    # is rounded apart
    a = (fma_f32(gy.to(torch.float32) * s[1] - p0[:, 1].view(B, 1, 1), ny,
                 (gx.to(torch.float32) * s[0] - p0[:, 0].view(B, 1, 1)) * nx)
         - (p0[:, 2] * normals[:, 2]).view(B, 1, 1))
    denom = normals[:, 2] * s[2]
    safe = torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
    zb = (torch.floor(-a / safe.view(B, 1, 1)).to(torch.int32) - K // 2)

    raw = xsfetch.fetch_secb(volp, zb, wx0, wy0,
                             qlabels.to(torch.int32).contiguous())
    return _finish_section(raw, gx, gy, zb, a, denom, v, wx0, wy0, normals,
                           anisotropy, (tx, ty, tz), Wx, Wy, method, rounds)


def _as_int32_volume(all_labels) -> Optional[np.ndarray]:
    """Reinterpret/convert the label volume to int32 for device equality
    tests, or None when ids can't be represented losslessly."""
    all_labels = np.asarray(all_labels)
    if all_labels.ndim != 3:
        return None
    if all_labels.dtype == bool:
        return np.ascontiguousarray(all_labels).astype(np.int32)
    if all_labels.dtype.kind not in "ui":
        return None
    if all_labels.dtype.itemsize == 4:
        # bit-pattern equality: uint32 ids >= 2^31 survive a view
        return np.ascontiguousarray(all_labels).view(np.int32)
    if all_labels.dtype.itemsize < 4:
        conv = np.int32 if all_labels.dtype.kind == "i" else np.uint32
        return np.ascontiguousarray(all_labels.astype(conv)).view(np.int32)
    mx = int(all_labels.max()) if all_labels.size else 0
    mn = int(all_labels.min()) if all_labels.size else 0
    if mn < 0 or mx >= 2 ** 32:
        return None
    return np.ascontiguousarray(
        all_labels.astype(np.uint32)).view(np.int32)


def _label_to_i32(label: int) -> np.int32:
    """Label id under the same bit-pattern reinterpretation."""
    return np.uint64(label).astype(np.uint32).view(np.int32)


def cross_section_areas_volume(all_labels, verts, normals, labels_q,
                               anisotropy: Sequence[float] = (1, 1, 1),
                               radii: Optional[np.ndarray] = None,
                               device="cpu"):
    """Evaluate sectioning planes drawn from MANY labels of one volume.

    all_labels: (X, Y, Z) integer volume. verts (N, 3) int global voxel
    coords, normals (N, 3) unit physical normals, labels_q (N,) the label
    each query sections, radii (N,) optional physical radius hints (used
    to pick the starting window; -1/None = unknown). Returns
    (areas (N,) f32, contacts (N,) uint8) or None when the volume dtype
    can't ride the int32 equality test (the caller takes the per-label
    path)."""
    vol = _as_int32_volume(all_labels)
    if vol is None:
        return None
    n = int(np.asarray(verts).shape[0])
    areas = np.zeros(n, dtype=np.float32)
    contacts = np.zeros(n, dtype=np.uint8)
    if n == 0:
        return areas, contacts

    dev = torch.device(device)
    verts = np.asarray(verts, dtype=np.int32).reshape(-1, 3)
    normals = np.asarray(normals, dtype=np.float32).reshape(-1, 3)
    qlab = np.asarray(
        [_label_to_i32(int(l)) for l in np.asarray(labels_q).reshape(-1)],
        dtype=np.int32)
    anis = np.asarray(anisotropy, dtype=np.float32)

    vol_dev = torch.from_numpy(vol).to(dev)
    # one permuted contiguous copy per dominant-axis group dispatched
    # (537 MB each at 512^3)
    vol_cache = {}

    def vol_for(d):
        if d not in vol_cache:
            vol_cache[d] = vol_dev.permute(_PERMS[d]).contiguous()
        return vol_cache[d]

    w = np.abs(normals) * anis[None, :]
    dom = np.argmax(w, axis=1)
    # a degenerate (zero) normal intersects nothing: area 0, contact 0,
    # converged without a dispatch
    degenerate = w.max(axis=1) < 1e-12

    if radii is None:
        r_vox = np.full(n, np.inf, dtype=np.float32)
    else:
        radii = np.asarray(radii, dtype=np.float32).reshape(-1)
        s_min = float(anis.min())
        r_vox = np.where(radii >= 0, radii / max(s_min, 1e-9), np.inf)

    # starting rung per query: the smallest window that plausibly holds
    # the section (radius hint 2r+10), capped at the first full-extent
    # rung; unconverged lanes escalate to the next rung
    need = 2.0 * r_vox + 10.0
    first_full = next(i for i, (W, _, _) in enumerate(_RUNGS) if W >= 512)
    start = np.full(n, first_full, dtype=np.int64)
    for r in range(first_full - 1, -1, -1):
        start = np.where(need <= _RUNGS[r][0], r, start)

    conv = degenerate.copy()
    for r, (W, rounds, method) in enumerate(_RUNGS):
        todo = np.flatnonzero(~conv & (start <= r))
        if len(todo) == 0:
            continue
        t0 = time.perf_counter()
        pend = []
        for d in range(3):
            sel = todo[dom[todo] == d]
            if len(sel) == 0:
                continue
            perm = _PERMS[d]
            volp = vol_for(d)
            anis_p = tuple(float(anis[p]) for p in perm)
            for sl in lane_chunks(len(sel), slab_lane_bytes(volp.shape, W)):
                idx = sel[sl]
                out = slab_sections_volume(
                    volp, torch.from_numpy(qlab[idx]).to(dev),
                    torch.from_numpy(verts[idx][:, perm].copy()).to(dev),
                    torch.from_numpy(normals[idx][:, perm].copy()).to(dev),
                    anis_p, W=W, rounds=rounds, method=method)
                pend.append((idx, perm, out))
        for idx, perm, (pa, pc, pv) in pend:
            areas[idx] = pa.cpu().numpy()
            conv[idx] = pv.cpu().numpy()
            # remap permuted contact bit pairs back to original axes
            pc = pc.cpu().numpy()
            cc = np.zeros_like(pc)
            for j, p in enumerate(perm):
                cc |= ((pc >> (2 * j)) & 3) << (2 * p)
            contacts[idx] = cc
        profiling.count(f"xsb_rung{r}_queries", len(todo))
        profiling.count(f"xsb_rung{r}_ms",
                        int(1000 * (time.perf_counter() - t0)))

    leftovers = int((~conv).sum())
    if leftovers:
        profiling.count("xsb_unconverged", leftovers)
    return areas, contacts
