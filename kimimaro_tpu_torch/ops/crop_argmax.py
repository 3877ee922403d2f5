"""Per-label masked argmax over crop windows of a full volume (B3).

Torch counterpart of kimimaro_tpu.ops.pallas_argmax (`crop_argmax`), with
the semantics of kimimaro_tpu.gengine._crop_argmax: per lane, the first
maximum of an f32 field over the voxels with cc == lid inside the window
[off, off + crop). Ties go to the first maximum in (x, y, z) lexicographic
order; a lane whose label holds only -inf answers -inf at the crop origin.

A lane may name a box inside its window (the label's bounding box); only
the box is scanned. The first maximum in (x, y, z) order is the same in
any box that holds the label's voxels of the window, so the answer does
not change; a lane with an empty box answers -inf at the window origin.
`crop` may differ from lane to lane (an (N, 3) tensor), so that the lanes
of every crop tier go through one call.

For CUDA tensors `crop_argmax` launches the kernels of csrc/argmax.cu; for
CPU tensors it runs the plain version beside it.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from .. import kernels
from ..utils import profiling

Boxes = Tuple[torch.Tensor, torch.Tensor]


def _lane_crops(crop, offs):
    """`crop` as an (N, 3) int32 tensor on the device of `offs`."""
    if isinstance(crop, torch.Tensor):
        if crop.shape != offs.shape:
            raise ValueError("crop_argmax: a crop tensor is (N, 3)")
        return crop.to(device=offs.device, dtype=torch.int32)
    crop = torch.tensor([int(c) for c in crop], dtype=torch.int32,
                        device=offs.device)
    return crop.expand(offs.shape[0], 3)


def _crop_argmax_plain(field, cc, offs, lids, crop, boxes=None):
    """Plain torch version of the B3 kernel: a loop over lanes, each an
    argmax over its masked box (torch.argmax returns the first maximum);
    without boxes a lane's box is its window."""
    n = offs.shape[0]
    coords = offs.to(torch.int32).clone()
    vals = torch.full((n,), float("-inf"), dtype=torch.float32,
                      device=field.device)
    if boxes is None:
        box_off, box_size = offs, _lane_crops(crop, offs)
    else:
        box_off, box_size = boxes
    off_h = box_off.to("cpu").tolist()
    size_h = box_size.to("cpu").tolist()
    for i in range(n):
        (x, y, z), (bx, by, bz) = off_h[i], size_h[i]
        if bx <= 0 or by <= 0 or bz <= 0:
            continue
        f = field[x:x + bx, y:y + by, z:z + bz]
        c = cc[x:x + bx, y:y + by, z:z + bz]
        v = torch.where(c == lids[i], f, float("-inf")).reshape(-1)
        k = torch.argmax(v)
        if bool(v[k] == float("-inf")):
            continue  # -inf at the window origin
        vals[i] = v[k]
        kx = k // (by * bz)
        r = k - kx * (by * bz)
        ky = r // bz
        coords[i, 0] = x + kx
        coords[i, 1] = y + ky
        coords[i, 2] = z + (r - ky * bz)
    return coords, vals


def crop_argmax(field: torch.Tensor, cc: torch.Tensor, offs: torch.Tensor,
                lids: torch.Tensor,
                crop: Union[Tuple[int, int, int], torch.Tensor],
                boxes: Optional[Boxes] = None):
    """Returns (coords (N, 3) int32 global, values (N,) float32).

    crop: the window size, one for all lanes or an (N, 3) int32 tensor.
    boxes: optional (origin (N, 3), size (N, 3)) int32 tensors, each box
    inside its lane's window; a size of 0 marks a lane with nothing to
    scan."""
    if field.ndim != 3 or offs.ndim != 2 or offs.shape[1] != 3 \
            or lids.shape != (offs.shape[0],):
        raise ValueError("crop_argmax: field (X,Y,Z), offs (N,3), lids (N,)")
    crops = _lane_crops(crop, offs)
    vol = torch.tensor(field.shape, device=offs.device)
    bad = (offs < 0) | (offs + crops > vol)
    if boxes is None:
        box_off, box_size = offs, crops
    else:
        box_off, box_size = boxes
        if box_off.shape != offs.shape or box_size.shape != offs.shape:
            raise ValueError("crop_argmax: boxes are ((N,3), (N,3))")
        bad = bad | (box_size < 0) | (box_off < offs) \
            | (box_off + box_size > offs + crops)
    bad = bad.any() | (box_size.long().prod(dim=1) >= 2**32).any()
    if profiling.host(bad, bool):
        raise ValueError("crop_argmax: a crop window leaves the volume, or "
                         "a box its window")
    if field.device.type == "cpu":
        return _crop_argmax_plain(field, cc, offs, lids, crops,
                                  None if boxes is None
                                  else (box_off, box_size))
    box_off = box_off.contiguous()
    box_size = box_size.contiguous()
    kernels.require_cuda("crop_argmax", field, cc,
                         dtypes=((torch.float32,), (torch.int32,)),
                         shape=field.shape)
    kernels.require_cuda("crop_argmax", offs, lids, box_off, box_size,
                         dtypes=((torch.int32,),) * 4)
    n = offs.shape[0]
    coords = torch.empty((n, 3), dtype=torch.int32, device=field.device)
    vals = torch.empty((n,), dtype=torch.float32, device=field.device)
    # the kernels' scratch: the lanes' running row counts and their keys
    row_start = torch.empty((n + 1,), dtype=torch.int64, device=field.device)
    keys = torch.empty((n,), dtype=torch.int64, device=field.device)
    X, Y, Z = field.shape
    rc = kernels.lib().kt_crop_argmax(
        kernels.ptr(field), kernels.ptr(cc), kernels.ptr(offs),
        kernels.ptr(lids), kernels.ptr(box_off), kernels.ptr(box_size),
        n, X, Y, Z, kernels.ptr(row_start), kernels.ptr(keys),
        kernels.ptr(coords), kernels.ptr(vals),
        kernels.stream_ptr(field.device))
    kernels.check(rc, "crop_argmax")
    kernels.LAUNCHES["crop_argmax"] += 1
    return coords, vals
