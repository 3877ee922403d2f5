"""Directed axis-0 sweeps of the joint Voronoi relaxation (kernel V1).

The sweep of kimimaro_tpu.ops.geodesic `_voronoi_stage` (a lax.scan there,
with no Pallas form): a float32 distance field and an int32 field of the
1-based id of the nearest seed, relaxed together along axis 0 of an
(n, H, W) layout. For plane i > 0, over the nine (dy, dz) neighbours of
plane i-1 in (-1, 0, 1) x (-1, 0, 1) order, the first strictly smallest
`dist + cost` wins with its feature; a voxel of `ok` takes it where it is
strictly below its own distance, a voxel outside `ok` becomes +inf and
keeps its feature. Plane 0 passes through. For CUDA tensors the wrapper
launches the kernel of csrc/voronoi.cu once a sweep, in the form
`voronoi_plan` names; for CPU tensors it runs the plain version beside it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from .. import kernels
from .stencils import pad_const

INF = float("inf")


def _voronoi_sweep_plain(d, f, ok, costs9: Sequence[float],
                         descending: bool, changed):
    """Plain torch version of the V1 kernel: a Python loop over planes.
    `changed` (one int32) becomes 1 if the sweep alters a distance or a
    feature."""
    n, H, W = d.shape
    out_d, out_f = torch.empty_like(d), torch.empty_like(f)
    order = range(n - 1, -1, -1) if descending else range(n)
    prev_d = prev_f = None
    moved = torch.zeros((), dtype=torch.bool, device=d.device)
    for p in order:
        cur_d, cur_f = d[p], f[p]
        if prev_d is None:
            nd, nf = cur_d, cur_f
        else:
            pd = pad_const(prev_d, 1, INF)
            pf = pad_const(prev_f, 1, 0)
            best_d = torch.full_like(cur_d, INF)
            best_f = torch.zeros_like(cur_f)
            for k in range(9):
                dy, dz = divmod(k, 3)
                win = (slice(dy, dy + H), slice(dz, dz + W))
                sd = pd[win] + costs9[k]
                better = sd < best_d
                best_d = torch.where(better, sd, best_d)
                best_f = torch.where(better, pf[win], best_f)
            okp = ok[p]
            take = okp & (best_d < cur_d)
            nd = torch.where(take, best_d, torch.where(okp, cur_d, INF))
            nf = torch.where(take, best_f, cur_f)
            moved |= ((nd != cur_d) | (nf != cur_f)).any()
        out_d[p], out_f[p] = nd, nf
        prev_d, prev_f = nd, nf
    changed |= moved.to(changed.dtype)
    return out_d, out_f


def voronoi_sweep(d, f, ok, costs9: Sequence[float], descending: bool,
                  changed: torch.Tensor):
    """One axis-0 directional sweep of (dist, feature): `d` float32 and `f`
    int32 of one (n, H, W) shape, `ok` bool of it, `costs9` the nine step
    costs in (dy, dz) order, `changed` a one-element int32 tensor, set to 1
    (never cleared) when the sweep alters a value. Returns (d, f)."""
    if len(costs9) != 9:
        raise ValueError(f"voronoi_sweep: {len(costs9)} step costs, not 9")
    if d.device.type == "cpu":
        return _voronoi_sweep_plain(d, f, ok, costs9, descending, changed)
    kernels.require_cuda(
        "voronoi_sweep", d, f, ok,
        dtypes=((torch.float32,), (torch.int32,), (torch.bool,)),
        shape=d.shape)
    kernels.require_cuda("voronoi_sweep", changed, dtypes=((torch.int32,),),
                         shape=(1,))
    if changed.device != d.device:
        raise ValueError("voronoi_sweep: `changed` on another device")
    n, H, W = d.shape
    out_d, out_f = torch.empty_like(d), torch.empty_like(f)
    # the grid-wide strips' edge-row mailboxes (two edges, two steps, two
    # fields of W cells a strip), zero before every sweep
    plan = _plan(H, W, d.device.index)
    mail = torch.zeros((plan["ctas"] * 8 * W,), dtype=torch.int64,
                       device=d.device) if plan["form"] == "strips" else None
    rc = kernels.lib().kt_voronoi_sweep(
        kernels.ptr(d), kernels.ptr(f), kernels.ptr(ok), kernels.ptr(mail),
        kernels.ptr(out_d), kernels.ptr(out_f), kernels.ptr(changed), n, H,
        W, kernels.costs_arg([(None, c) for c in costs9]),
        int(bool(descending)), kernels.stream_ptr(d.device))
    kernels.check(rc, "voronoi_sweep")
    kernels.LAUNCHES["voronoi_sweep"] += 1
    return out_d, out_f


_FORMS = ("plane", "strips", "cluster")


def voronoi_plan(H: int, W: int) -> dict:
    """How the V1 kernel runs an (H, W) plane on the current CUDA device:
    `form` "cluster" (one launch per sweep in a grid of one thread-block
    cluster), "strips" (one cooperative launch per sweep over the SMs) or
    "plane" (one launch per plane), with `ctas` strips of `rows` rows."""
    return dict(_plan(int(H), int(W), torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _plan(H: int, W: int, device_index) -> dict:
    rows, ctas = ctypes.c_int(), ctypes.c_int()
    form = kernels.lib().kt_voronoi_plan(int(H), int(W), ctypes.byref(rows),
                                         ctypes.byref(ctas))
    if form < 0:
        raise ValueError(f"voronoi_plan: bad plane {(H, W)}")
    return {"form": _FORMS[form], "rows": rows.value, "ctas": ctas.value}
