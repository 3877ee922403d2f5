"""Per-label masked argmax over crop windows of a full volume (B3).

Torch counterpart of kimimaro_tpu.ops.pallas_argmax (`crop_argmax`), with
the semantics of kimimaro_tpu.gengine._crop_argmax: per lane, the first
maximum of an f32 field over the voxels with cc == lid inside the window
[off, off + crop). Ties go to the first maximum in (x, y, z) lexicographic
order; a lane whose label holds only -inf answers -inf at the crop origin.
For CUDA tensors `crop_argmax` launches the kernel of csrc/argmax.cu; for
CPU tensors it runs the plain version beside it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels


def _crop_argmax_plain(field, cc, offs, lids, crop):
    """Plain torch version of the B3 kernel: a loop over lanes, each an
    argmax over its masked crop (torch.argmax returns the first maximum)."""
    cx, cy, cz = crop
    n = offs.shape[0]
    coords = torch.empty((n, 3), dtype=torch.int32, device=field.device)
    vals = torch.empty((n,), dtype=torch.float32, device=field.device)
    offs_h = offs.to("cpu").tolist()
    for i in range(n):
        x, y, z = offs_h[i]
        f = field[x:x + cx, y:y + cy, z:z + cz]
        c = cc[x:x + cx, y:y + cy, z:z + cz]
        v = torch.where(c == lids[i], f, float("-inf")).reshape(-1)
        k = torch.argmax(v)
        vals[i] = v[k]
        kx = k // (cy * cz)
        r = k - kx * (cy * cz)
        ky = r // cz
        coords[i, 0] = x + kx
        coords[i, 1] = y + ky
        coords[i, 2] = z + (r - ky * cz)
    return coords, vals


def crop_argmax(field: torch.Tensor, cc: torch.Tensor, offs: torch.Tensor,
                lids: torch.Tensor, crop: Tuple[int, int, int]):
    """Returns (coords (N, 3) int32 global, values (N,) float32)."""
    crop = tuple(int(c) for c in crop)
    if field.ndim != 3 or offs.ndim != 2 or offs.shape[1] != 3 \
            or lids.shape != (offs.shape[0],):
        raise ValueError("crop_argmax: field (X,Y,Z), offs (N,3), lids (N,)")
    vol = torch.tensor(field.shape, device=offs.device)
    if bool(((offs < 0) | (offs + torch.tensor(crop, device=offs.device)
                           > vol)).any()):
        raise ValueError("crop_argmax: a crop window leaves the volume")
    if field.device.type == "cpu":
        return _crop_argmax_plain(field, cc, offs, lids, crop)
    kernels.require_cuda("crop_argmax", field, cc,
                         dtypes=((torch.float32,), (torch.int32,)),
                         shape=field.shape)
    kernels.require_cuda("crop_argmax", offs, lids,
                         dtypes=((torch.int32,), (torch.int32,)))
    n = offs.shape[0]
    coords = torch.empty((n, 3), dtype=torch.int32, device=field.device)
    vals = torch.empty((n,), dtype=torch.float32, device=field.device)
    X, Y, Z = field.shape
    rc = kernels.lib().kt_crop_argmax(
        kernels.ptr(field), kernels.ptr(cc), kernels.ptr(offs),
        kernels.ptr(lids), n, X, Y, Z, crop[0], crop[1], crop[2],
        kernels.ptr(coords), kernels.ptr(vals),
        kernels.stream_ptr(field.device))
    kernels.check(rc, "crop_argmax")
    kernels.LAUNCHES["crop_argmax"] += 1
    return coords, vals
