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

The lane-batched form (`voronoi_sweep_lanes`) sweeps many volumes of
different extents in one launch: lane i is the (n, H, W) box at element
`base` of flat storage, its rows `row` and its planes `plane` elements
apart (`VoronoiLanes`), swept in place within its own extent with a change
flag of its own. A lane's plane must fit one CTA's shared memory
(`lane_capacity` cells); a volume with a larger plane takes
`voronoi_sweep`. `voronoi_sweep_batched` is the same sweep over a
(B, N, H, W) batch with an extent a lane.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# the lane-batched form

# columns of a lane table: the lane's first element, its extent (n, H, W),
# and the elements between its rows and between its planes
LANE_COLUMNS = ("base", "n", "H", "W", "row", "plane")


# the plane cells a lane of the batched kernel may have where no card is
# asked (the CPU): an H100's, (227 KiB of shared memory a CTA - 2 KiB) /
# 16 bytes a cell, so that the CPU routes lanes as the card does
LANE_CELLS = 14400


def lane_capacity(device) -> int:
    """The most plane cells (H x W) a lane of the batched V1 may have on
    `device`: what one CTA's shared memory carries on a CUDA device,
    LANE_CELLS elsewhere."""
    device = torch.device(device)
    if device.type == "cuda":
        return _lanes_limits(device.index)[0]
    return LANE_CELLS


class VoronoiLanes:
    """The lanes of a batched V1 sweep over flat storage of `numel`
    elements: an int64 (L, 6) table of `LANE_COLUMNS`. A lane of zero
    extent is never swept. The kernel's table, its lane order and its
    packs of lanes a CTA are made once per device and kept."""

    def __init__(self, table, numel: int):
        t = np.ascontiguousarray(np.asarray(table, dtype=np.int64)
                                 .reshape(-1, len(LANE_COLUMNS)))
        base, n, H, W, row, plane = t.T
        live = (n > 0) & (H > 0) & (W > 0)
        if (t < 0).any() or (live & ((row < W) | (plane < (H - 1) * row + W))
                             ).any():
            raise ValueError("VoronoiLanes: a lane's rows or planes overlap")
        end = base + (n - 1) * plane + (H - 1) * row + W
        if (live & (end > int(numel))).any():
            raise ValueError("VoronoiLanes: a lane reaches past the storage")
        self.table = t
        self.numel = int(numel)
        self._device = {}

    def __len__(self) -> int:
        return len(self.table)

    def live(self) -> np.ndarray:
        _, n, H, W, _, _ = self.table.T
        return (n > 0) & (H > 0) & (W > 0)

    def cells(self) -> np.ndarray:
        """The voxels of each lane's plane (H x W)."""
        return self.table[:, 2] * self.table[:, 3]

    @classmethod
    def batched(cls, shape, extents) -> "VoronoiLanes":
        """The lanes of a (B, N, H, W) batch, lane b the box of
        `extents[b]` = (n, H, W) at the low corner of its (N, H, W)
        volume."""
        B, N, H, W = (int(s) for s in shape)
        ext = np.asarray(extents.cpu() if torch.is_tensor(extents)
                         else extents, dtype=np.int64).reshape(-1, 3)
        if len(ext) != B or (ext < 0).any() or (ext > (N, H, W)).any():
            raise ValueError(f"voronoi_sweep_batched: extents "
                             f"{ext.tolist()} for a batch {tuple(shape)}")
        table = np.empty((B, len(LANE_COLUMNS)), dtype=np.int64)
        table[:, 0] = np.arange(B) * N * H * W
        table[:, 1:4] = ext
        table[:, 4] = W
        table[:, 5] = H * W
        return cls(table, B * N * H * W)

    def on(self, device) -> tuple:
        """(table, order, packs, cells) on a CUDA device: the lanes in
        packs of one CTA each (`pack_lanes`), and the shared-memory cells
        of the launch."""
        key = str(device)
        if key not in self._device:
            cap, _, max_pack = _lanes_limits(torch.device(device).index)
            order, packs, used = pack_lanes(self.table, cap, max_pack)
            as_dev = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
            self._device[key] = (as_dev(self.table, torch.int64),
                                 as_dev(order, torch.int32),
                                 as_dev(packs, torch.int32), used)
        return self._device[key]


def pack_lanes(table, capacity: int, max_pack: int):
    """The lanes of a launch in packs, one CTA each: the live lanes by
    their plane count, most first, filled in that order into packs of at
    most `max_pack` lanes whose planes (H x W each) hold at most
    `capacity` cells together, so that lanes stepping through similar
    plane counts share a CTA. Returns (order, packs (P, 2) of (first
    index into order, lanes), the most cells of a pack). Raises where a
    live lane's plane alone exceeds `capacity`."""
    t = np.asarray(table, dtype=np.int64).reshape(-1, len(LANE_COLUMNS))
    n, cells = t[:, 1], t[:, 2] * t[:, 3]
    live = (n > 0) & (cells > 0)
    if (cells[live] > capacity).any():
        raise ValueError(f"pack_lanes: a plane of {int(cells[live].max())} "
                         f"cells, one CTA holds {capacity}")
    order = np.flatnonzero(live)
    order = order[np.argsort(-n[order], kind="stable")]
    packs, used = [], 0
    start, held = 0, 0
    for i, lane in enumerate(order):
        c = int(cells[lane])
        count = i - start
        if count and (count == max_pack or held + c > capacity):
            packs.append((start, count))
            used = max(used, held)
            start, held = i, 0
        held += c
    if len(order) > start:
        packs.append((start, len(order) - start))
        used = max(used, held)
    return (order.astype(np.int32),
            np.asarray(packs, dtype=np.int32).reshape(-1, 2), used)


def _voronoi_sweep_lanes_plain(d, f, ok, lanes: VoronoiLanes,
                               costs9: Sequence[float], descending: bool,
                               changed, active=None):
    """Plain torch version of the lane-batched V1 kernel, the arithmetic
    of `_voronoi_sweep_plain` for all live, active lanes at once: step s
    gathers plane s of every lane (plane n - 1 - s descending) into an
    (L, H, W) stack of the largest extent, cells outside a lane's extent
    offering nothing (+inf), relaxes it from the step before and writes
    back each lane's extent while s < n. changed[i] becomes 1 where lane
    i's sweep alters a value."""
    on = lanes.live()
    if active is not None:
        on &= active.cpu().numpy().astype(bool)
    pick = np.flatnonzero(on)
    if not len(pick):
        return d, f
    dev = d.device
    d1, f1, ok1 = d.view(-1), f.view(-1), ok.view(-1)
    base, n, H, W, row, plane = (c[:, None, None] for c in torch.as_tensor(
        lanes.table[pick], device=dev).unbind(1))
    Hm, Wm = int(H.max()), int(W.max())
    yy = torch.arange(Hm, device=dev)[None, :, None]
    zz = torch.arange(Wm, device=dev)[None, None, :]
    inside = (yy < H) & (zz < W)
    offs = torch.where(inside, yy * row + zz, 0)
    moved = torch.zeros(len(pick), dtype=torch.bool, device=dev)
    prev_d = prev_f = None
    for s in range(int(n.max())):
        live = s < n
        p = torch.clamp(n - 1 - s, min=0) if descending else \
            torch.clamp(n - 1, max=s)
        at = base + p * plane + offs
        cur_d, cur_f = d1[at], f1[at]
        if prev_d is None:
            nd, nf = cur_d, cur_f
        else:
            pd = F.pad(torch.where(inside, prev_d, INF), (1, 1, 1, 1),
                       value=INF)
            pf = F.pad(prev_f, (1, 1, 1, 1), value=0)
            best_d = torch.full_like(cur_d, INF)
            best_f = torch.zeros_like(cur_f)
            for k in range(9):
                dy, dz = divmod(k, 3)
                win = (slice(None), slice(dy, dy + Hm), slice(dz, dz + Wm))
                sd = pd[win] + costs9[k]
                better = sd < best_d
                best_d = torch.where(better, sd, best_d)
                best_f = torch.where(better, pf[win], best_f)
            okp = ok1[at]
            take = okp & (best_d < cur_d)
            nd = torch.where(take, best_d, torch.where(okp, cur_d, INF))
            nf = torch.where(take, best_f, cur_f)
            moved |= (((nd != cur_d) | (nf != cur_f)) & inside & live
                      ).flatten(1).any(dim=1)
        write = inside & live
        d1[at[write]] = nd[write]
        f1[at[write]] = nf[write]
        prev_d, prev_f = nd, nf
    idx = torch.as_tensor(pick, device=changed.device)
    changed[idx] = changed[idx] | moved.to(changed.device, changed.dtype)
    return d, f


def voronoi_sweep_lanes(d, f, ok, lanes: VoronoiLanes,
                        costs9: Sequence[float], descending: bool,
                        changed: torch.Tensor,
                        active: Optional[torch.Tensor] = None):
    """One axis-0 directional sweep of every lane of `lanes` over flat,
    contiguous storage (`d` float32, `f` int32, `ok` bool, of
    `lanes.numel` elements each), in place: within its extent each live
    lane is swept as `voronoi_sweep` sweeps its box; nothing outside the
    lanes' extents is read as a candidate or written. `changed` (L,)
    int32: entry i is set to 1 (never cleared) where lane i's sweep alters
    a value. `active` (L,) bool: a lane that is not active is not swept.
    Each live lane's plane (H x W) holds at most `lane_capacity` cells.
    For CUDA tensors one launch of the kernel for all lanes. Returns
    (d, f)."""
    if len(costs9) != 9:
        raise ValueError(f"voronoi_sweep_lanes: {len(costs9)} step costs, "
                         f"not 9")
    L = len(lanes)
    for name, t in (("d", d), ("f", f), ("ok", ok)):
        if t.numel() != lanes.numel:
            raise ValueError(f"voronoi_sweep_lanes: `{name}` has "
                             f"{t.numel()} elements, the lanes "
                             f"{lanes.numel}")
    if tuple(changed.shape) != (L,) or (
            active is not None and tuple(active.shape) != (L,)):
        raise ValueError(f"voronoi_sweep_lanes: flags for {L} lanes")
    cap = lane_capacity(d.device)
    if (lanes.cells()[lanes.live()] > cap).any():
        raise ValueError(f"voronoi_sweep_lanes: a plane beyond {cap} cells "
                         f"(such a volume takes voronoi_sweep)")
    if d.device.type == "cpu":
        return _voronoi_sweep_lanes_plain(d, f, ok, lanes, costs9,
                                          descending, changed, active)
    kernels.require_cuda(
        "voronoi_sweep_lanes", d, f, ok,
        dtypes=((torch.float32,), (torch.int32,), (torch.bool,)))
    kernels.require_cuda("voronoi_sweep_lanes", d, changed, active,
                         dtypes=((torch.float32,), (torch.int32,),
                                 (torch.bool,)))
    table, order, packs, cells = lanes.on(d.device)
    rc = kernels.lib().kt_voronoi_lanes(
        kernels.ptr(d), kernels.ptr(f), kernels.ptr(ok), kernels.ptr(table),
        kernels.ptr(order), kernels.ptr(packs), int(packs.shape[0]),
        kernels.ptr(changed), kernels.ptr(active), int(cells),
        kernels.costs_arg([(None, c) for c in costs9]),
        int(bool(descending)), kernels.stream_ptr(d.device))
    kernels.check(rc, "voronoi_sweep_batched")
    kernels.LAUNCHES["voronoi_sweep_batched"] += 1
    return d, f


def voronoi_sweep_batched(d, f, ok, extents, costs9: Sequence[float],
                          descending: bool, changed: torch.Tensor,
                          active: Optional[torch.Tensor] = None):
    """One axis-0 directional sweep of each lane of a (B, N, H, W) batch
    (`d` float32, `f` int32, `ok` bool), in place: lane b is its extent
    `extents[b]` = (n, H, W) (int32 (B, 3)) at the low corner, swept as
    `voronoi_sweep` sweeps d[b, :n, :H, :W]; voxels outside the extent
    are neither read as candidates nor written. `changed` (B,) int32, one
    flag a lane, set to 1 where the lane's sweep alters a value; `active`
    (B,) bool: lanes that are not active return at once. `voronoi_sweep
    _lanes` over `VoronoiLanes.batched`: one launch for the batch on CUDA
    tensors, the plain version on CPU tensors. Returns (d, f)."""
    if d.dim() != 4 or tuple(f.shape) != tuple(d.shape) or \
            tuple(ok.shape) != tuple(d.shape):
        raise ValueError("voronoi_sweep_batched: d, f, ok of one (B, N, H, "
                         "W) shape")
    return voronoi_sweep_lanes(d, f, ok,
                               VoronoiLanes.batched(d.shape, extents),
                               costs9, descending, changed, active)


@functools.lru_cache(maxsize=None)
def _lanes_limits(device_index) -> tuple:
    """(shared-memory cells of a CTA, threads of a CTA, lanes of a pack)
    of the lane-batched kernel on a device."""
    threads, max_pack = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device_index):
        cap = kernels.lib().kt_voronoi_lanes_limits(ctypes.byref(threads),
                                                    ctypes.byref(max_pack))
    if cap < 0:
        raise RuntimeError("voronoi_sweep_lanes: no device limits")
    return cap, threads.value, max_pack.value


def voronoi_batched_plan(B: int, H: int, W: int) -> dict:
    """How B lanes of (H, W) planes run on the current CUDA device: `form`
    "shared" (the lane-batched kernel, lanes packed into CTAs, each CTA's
    planes carried in its shared memory) or "single" (a plane beyond one
    CTA's shared memory: each such volume takes `voronoi_sweep`'s forms,
    `voronoi_plan`), with `lanes` a CTA and `ctas` of the batched kernel
    (0 for "single"), its `threads` and the shared-memory `capacity` in
    cells."""
    cap, threads, max_pack = _lanes_limits(torch.cuda.current_device())
    cells = int(H) * int(W)
    if not 0 < cells <= cap:
        return {"form": "single", "lanes": 0, "ctas": 0, "threads": threads,
                "capacity": cap}
    per = min(max_pack, cap // cells)
    return {"form": "shared", "lanes": per, "ctas": -(-int(B) // per),
            "threads": threads, "capacity": cap}
