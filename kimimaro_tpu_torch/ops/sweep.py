"""One directed axis-0 sweep of a single volume, gated by an ok mask (B5).

Torch counterpart of kimimaro_tpu.ops.pallas_sweep (`sweep_axis0`):

  node mode:      new = min(cur, min_9(prev_shifted) + node_cost)
  euclidean mode: new = min(cur, min_9(prev_shifted + step_cost))
  clamp_positive: positives reset to +inf (invalidation balls)

The first plane of the sweep passes through unchanged. `descending` walks
the planes from the last to the first instead of flipping the data. For
CUDA tensors `sweep_axis0` launches the kernel of csrc/sweep.cu; for CPU
tensors it runs the plain version beside it.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels
from .gsweep import _costs9
from .stencils import pad_const

INF = float("inf")


def _sweep_axis0_plain(d, ok, node_cost, anisotropy, node_mode: bool,
                       clamp_positive: bool, descending: bool):
    """Plain torch version of the B5 kernel: a Python loop over planes."""
    costs9 = _costs9(anisotropy)
    n, H, W = d.shape
    out = torch.empty_like(d)
    order = range(n - 1, -1, -1) if descending else range(n)
    prev = None
    for p in order:
        cur = d[p]
        if prev is None:
            new = cur
        else:
            pv = pad_const(prev, 1, INF)
            cand = torch.full_like(cur, INF)
            for (dy, dz), c in costs9:
                s = pv[1 + dy:1 + dy + H, 1 + dz:1 + dz + W]
                cand = torch.minimum(cand, s if node_mode else s + c)
            if node_mode:
                cand = cand + node_cost[p]
            new = torch.where(ok[p], torch.minimum(cur, cand), INF)
            if clamp_positive:
                new = torch.where(new > 0.0, INF, new)
        out[p] = new
        prev = new
    return out


def sweep_axis0(d, ok, node_cost, anisotropy: Tuple[float, float, float],
                node_mode: bool, clamp_positive: bool,
                descending: bool = False):
    """One axis-0 directional sweep of an (n, H, W) float32 volume; `ok`
    is a bool volume of the same shape, `node_cost` float32 (read only in
    node mode, may be None otherwise)."""
    if d.device.type == "cpu":
        return _sweep_axis0_plain(d, ok, node_cost, anisotropy, node_mode,
                                  clamp_positive, descending)
    nc = node_cost if node_mode else None
    if node_mode and nc is None:
        raise ValueError("sweep_axis0: node mode needs node_cost")
    kernels.require_cuda(
        "sweep_axis0", d, ok, nc,
        dtypes=((torch.float32,), (torch.bool,), (torch.float32,)),
        shape=d.shape)
    n, H, W = d.shape
    out = torch.empty_like(d)
    rc = kernels.lib().kt_sweep_axis0(
        kernels.ptr(d), kernels.ptr(ok), kernels.ptr(nc), kernels.ptr(out),
        n, H, W, kernels.costs_arg(_costs9(anisotropy)), int(bool(node_mode)),
        int(bool(clamp_positive)), int(bool(descending)),
        kernels.stream_ptr(d.device))
    kernels.check(rc, "sweep_axis0")
    kernels.LAUNCHES["sweep_axis0"] += 1
    return out
