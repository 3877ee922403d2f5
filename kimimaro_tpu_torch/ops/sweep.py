"""Directed axis-0 sweeps gated by an ok mask: one volume (B5) or a batch
of lanes (B4).

Torch counterpart of kimimaro_tpu.ops.pallas_sweep (`sweep_axis0`,
`sweep_axis0_batched`):

  node mode:      new = min(cur, min_9(prev_shifted) + node_cost)
  euclidean mode: new = min(cur, min_9(prev_shifted + step_cost))
  clamp_positive: positives reset to +inf (invalidation balls)

The first plane of the sweep passes through unchanged. `descending` walks
the planes from the last to the first instead of flipping the data. For
CUDA tensors each wrapper launches its kernel of csrc/sweep.cu once a
sweep, in the form `sweep_axis0_plan` (B5) or `sweep_axis0_batched_plan`
(B4) names; for CPU tensors it runs the plain version beside it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

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
    # the grid-wide strips' edge-row mailboxes (two edges, two steps, W
    # cells a strip), zero before every sweep
    plan = _axis0_plan(H, W, bool(node_mode), d.device.index)
    mail = torch.zeros((plan["ctas"] * 4 * W,), dtype=torch.int64,
                       device=d.device) if plan["form"] == "strips" else None
    rc = kernels.lib().kt_sweep_axis0(
        kernels.ptr(d), kernels.ptr(ok), kernels.ptr(nc), kernels.ptr(mail),
        kernels.ptr(out), n, H, W, kernels.costs_arg(_costs9(anisotropy)),
        int(bool(node_mode)), int(bool(clamp_positive)),
        int(bool(descending)), kernels.stream_ptr(d.device))
    kernels.check(rc, "sweep_axis0")
    kernels.LAUNCHES["sweep_axis0"] += 1
    return out


_AXIS0_FORMS = ("plane", "strips", "cluster")


def sweep_axis0_plan(H: int, W: int, node_mode: bool) -> dict:
    """How the B5 kernel runs an (H, W) plane on the current CUDA device:
    `form` "cluster" (one launch per sweep in a grid of one thread-block
    cluster), "strips" (one cooperative launch per sweep over the SMs) or
    "plane" (one launch per plane, for planes too large for both), with
    `ctas` strips of `rows` rows each."""
    return dict(_axis0_plan(int(H), int(W), bool(node_mode),
                            torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _axis0_plan(H: int, W: int, node_mode: bool, device_index) -> dict:
    rows, ctas = ctypes.c_int(), ctypes.c_int()
    form = kernels.lib().kt_sweep_axis0_plan(
        int(H), int(W), int(node_mode), ctypes.byref(rows),
        ctypes.byref(ctas))
    return {"form": _AXIS0_FORMS[form], "rows": rows.value,
            "ctas": ctas.value}


def _sweep_axis0_batched_plain(d, ok, node_cost, anisotropy, node_mode: bool,
                               clamp_positive: bool, descending: bool,
                               vg=None, bits9=None):
    """Plain torch version of the B4 kernel: a Python loop over the
    (B, H, W) planes of a (B, n, H, W) batch. With `vg`, a candidate from
    the neighbour u on the previous plane counts only where bit bits9[k]
    of u's bitfield is set (zero padding: no permission at the edge)."""
    costs9 = _costs9(anisotropy)
    B, n, H, W = d.shape
    out = torch.empty_like(d)
    order = range(n - 1, -1, -1) if descending else range(n)
    prev = prev_vg = None
    for p in order:
        cur = d[:, p]
        if prev is None:
            new = cur
        else:
            pv = F.pad(prev, (1, 1, 1, 1), value=INF)
            gv = (F.pad(prev_vg, (1, 1, 1, 1), value=0) if vg is not None
                  else None)
            cand = torch.full_like(cur, INF)
            for k, ((dy, dz), c) in enumerate(costs9):
                s = pv[:, 1 + dy:1 + dy + H, 1 + dz:1 + dz + W]
                if gv is not None:
                    g = gv[:, 1 + dy:1 + dy + H, 1 + dz:1 + dz + W]
                    s = torch.where(((g >> bits9[k]) & 1) > 0, s, INF)
                cand = torch.minimum(cand, s if node_mode else s + c)
            if node_mode:
                cand = cand + node_cost[:, p]
            new = torch.where(ok[:, p], torch.minimum(cur, cand), INF)
            if clamp_positive:
                new = torch.where(new > 0.0, INF, new)
        out[:, p] = new
        prev = new
        if vg is not None:
            prev_vg = vg[:, p]
    return out


def sweep_axis0_batched(d, ok, nc, anisotropy: Tuple[float, float, float],
                        node_mode: bool, clamp_positive: bool,
                        descending: bool = False, vg=None,
                        bits9: Optional[Tuple[int, ...]] = None):
    """One directed sweep along axis 1 of a (B, n, H, W) float32 batch of
    lanes; `ok` bool of the same shape, `nc` float32 (read only in node
    mode, may be None otherwise). `vg`/`bits9` (both or neither): per-lane
    voxel-graph bitfields (int32 or uint32, same shape) and the nine bit
    indices of this layout's offsets in (dy, dz) order."""
    if (vg is None) != (bits9 is None):
        raise ValueError("sweep_axis0_batched: give vg and bits9 together")
    if vg is not None:
        # uint32 bitfields are read through an int32 view: the bit tests
        # see the same bits
        vg = vg.view(torch.int32) if vg.dtype == torch.uint32 else vg
        bits9 = tuple(int(b) for b in bits9)
        if len(bits9) != 9 or not all(0 <= b < 32 for b in bits9):
            raise ValueError(f"sweep_axis0_batched: bad bits9 {bits9}")
    if d.device.type == "cpu":
        return _sweep_axis0_batched_plain(d, ok, nc, anisotropy, node_mode,
                                          clamp_positive, descending, vg,
                                          bits9)
    nc = nc if node_mode else None
    if node_mode and nc is None:
        raise ValueError("sweep_axis0_batched: node mode needs nc")
    kernels.require_cuda(
        "sweep_axis0_batched", d, ok, nc, vg,
        dtypes=((torch.float32,), (torch.bool,), (torch.float32,),
                (torch.int32,)),
        shape=d.shape)
    B, n, H, W = d.shape
    out = torch.empty_like(d)
    bits = None if vg is None else (ctypes.c_int * 9)(*bits9)
    # the per-lane grid strips' edge-row mailboxes, zero before every sweep
    plan = _batched_plan(B, H, W, bool(node_mode), vg is not None,
                         d.device.index)
    mail = torch.zeros((B * plan["ctas"] * 4 * W,), dtype=torch.int64,
                       device=d.device) if plan["form"] == "strips" else None
    rc = kernels.lib().kt_sweep_axis0_batched(
        kernels.ptr(d), kernels.ptr(ok), kernels.ptr(nc), kernels.ptr(vg),
        kernels.ptr(mail), kernels.ptr(out), B, n, H, W,
        kernels.costs_arg(_costs9(anisotropy)),
        bits, int(bool(node_mode)), int(bool(clamp_positive)),
        int(bool(descending)), kernels.stream_ptr(d.device))
    kernels.check(rc, "sweep_axis0_batched")
    kernels.LAUNCHES["sweep_axis0_batched"] += 1
    return out


def sweep_axis0_batched_plan(B: int, H: int, W: int, node_mode: bool,
                             has_vg: bool = False) -> dict:
    """How the B4 kernel runs B lanes of (H, W) planes on the current CUDA
    device: `form` "cluster" (one launch per sweep, one thread-block
    cluster a lane), "strips" (one cooperative launch per sweep, each
    lane's grid-wide strips) or "plane" (one launch per plane for all
    lanes), with `ctas` strips a lane of `rows` rows each."""
    return dict(_batched_plan(int(B), int(H), int(W), bool(node_mode),
                              bool(has_vg), torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _batched_plan(B: int, H: int, W: int, node_mode: bool, has_vg: bool,
                  device_index) -> dict:
    rows, ctas = ctypes.c_int(), ctypes.c_int()
    form = kernels.lib().kt_sweep_axis0_batched_plan(
        int(B), int(H), int(W), int(node_mode), int(has_vg),
        ctypes.byref(rows), ctypes.byref(ctas))
    if form < 0:
        raise ValueError(f"sweep_axis0_batched_plan: bad shape {(B, H, W)}")
    return {"form": _AXIS0_FORMS[form], "rows": rows.value,
            "ctas": ctas.value}
