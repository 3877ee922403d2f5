"""Window foreground fetch of windowed cross sections (kernel B6).

Counterpart of kimimaro_tpu.ops.xsfetch `fetch_secb` and of the element
gather of kimimaro_tpu.ops.xsbatch `slab_sections_volume`: per lane, the
packed K-bit label-match word of every cell of a (Wx, Wy) window, bit k
of cell (i, j) = [vol[wx0 + i, wy0 + j, zb(i, j) + k] == label]. Bits
whose z falls outside [0, tz) are 0 (the gather path's z-validity mask).

The volume is a permuted contiguous copy with the plane's dominant axis
LAST, so each cell's K values are K consecutive int32 (one or two 32-byte
sectors); the plain version gathers the same copy. Windows may start
anywhere and have any extent. For CUDA tensors the wrapper launches
kernel B6 (csrc/xsfetch.cu), which reads a cell's values as two 16-byte
loads where `fetch_plan` allows it; for CPU tensors it runs the plain
version.
"""

from __future__ import annotations

import torch

from .. import kernels
from .fma import magic_divisor
from .xsslab import K


def _fetch_secb_plain(volp, zb, wx0, wy0, labels):
    """Plain torch version of kernel B6: a take of the B x Wx x Wy x K
    window cells, a compare and a shift-sum."""
    tx, ty, tz = volp.shape
    B, Wx, Wy = zb.shape
    dev = volp.device
    gx = wx0.long().view(B, 1, 1) + torch.arange(Wx, device=dev).view(1, Wx, 1)
    gy = wy0.long().view(B, 1, 1) + torch.arange(Wy, device=dev).view(1, 1, Wy)
    zidx = zb.long()[..., None] + torch.arange(K, device=dev)
    zvalid = (zidx >= 0) & (zidx < tz)
    flat = ((gx * ty + gy) * tz)[..., None] + torch.clamp(zidx, 0, tz - 1)
    fg = (torch.take(volp, flat) == labels.view(B, 1, 1, 1)) & zvalid
    kbit = torch.tensor([1 << k for k in range(K)], dtype=torch.int32,
                        device=dev)
    return (fg.to(torch.int32) * kbit).sum(dim=-1, dtype=torch.int32)


def fetch_plan(volp, zb):
    """How kernel B6 reads a volume: {"vector": two 16-byte loads of the
    aligned 8-word span holding a cell's K values where tz % 4 == 0 and
    the volume's base is 16-byte aligned, else K 4-byte loads; "magic",
    "shift": the division-free split of a cell index by Wy}."""
    tz = volp.shape[-1]
    _, magic, shift = magic_divisor(int(zb.shape[-1]))
    return {"vector": tz % 4 == 0 and volp.data_ptr() % 16 == 0,
            "magic": magic, "shift": shift}


def fetch_secb(volp, zb, wx0, wy0, labels):
    """Per-lane K-bit foreground words of (Wx, Wy) windows.

    volp: (tx, ty, tz) int32 volume, dominant axis last; zb: (B, Wx, Wy)
    int32 slab bases (bit k samples z = zb + k); wx0, wy0: (B,) int32
    window starts with wx0 + Wx <= tx and wy0 + Wy <= ty; labels: (B,)
    int32. Returns (B, Wx, Wy) int32."""
    if volp.device.type == "cpu":
        return _fetch_secb_plain(volp, zb, wx0, wy0, labels)
    kernels.require_cuda("fetch_secb", volp, zb, wx0, wy0, labels,
                         dtypes=((torch.int32,),) * 5)
    if volp.ndim != 3 or zb.ndim != 3 or any(
            tuple(t.shape) != (zb.shape[0],) for t in (wx0, wy0, labels)):
        raise ValueError("fetch_secb: needs a 3D volume, (B, Wx, Wy) zb "
                         "and (B,) starts and labels")
    tx, ty, tz = volp.shape
    B, Wx, Wy = zb.shape
    plan = fetch_plan(volp, zb)
    out = torch.empty_like(zb)
    rc = kernels.lib().kt_xs_fetch(
        kernels.ptr(volp), kernels.ptr(zb), kernels.ptr(wx0),
        kernels.ptr(wy0), kernels.ptr(labels), kernels.ptr(out),
        tx, ty, tz, B, Wx, Wy, int(plan["vector"]), plan["magic"],
        plan["shift"], kernels.stream_ptr(volp.device))
    kernels.check(rc, "fetch_secb")
    kernels.LAUNCHES["fetch_secb"] += 1
    return out
