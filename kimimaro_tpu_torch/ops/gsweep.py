"""Full-volume label-masked directional sweeps: the global engine's core.

Torch counterpart of kimimaro_tpu.ops.gsweep. Connected components
partition the foreground, so every label's geodesic field is computed in
ONE set of sweeps over the full volume: propagation between voxels is
admitted only when their compact cc ids are equal.

Sweep semantics: plane i is relaxed from plane i-1 through the nine
(dy, dz) offsets; six directed sweeps make one round.

Modes:
  euclid:   new = min(cur, min9(prev_same_label + step_cost))
  node:     new = min(cur, min9(prev_same_label) + nodecost[cur])
  maxflood: new = max(cur, max9(prev_same_label))
  minid:    int32 CCL ids, occupancy cc != 0
clamp_positive resets positives to +inf (rolling-ball invalidation);
`okmask` additionally restricts occupancy. In minid mode the CCL under a
voxel graph reads G1's CCL gate instead of `cc` (`gate`, `bits9`: the
labels' equality, the graph's moves and the occupancy in one word).

`sweep0` (B1) and `sweep0_dual` (B2) launch the CUDA kernels of
csrc/gsweep.cu for CUDA tensors (one persistent launch per sweep, or one
per plane for planes too large to hold, by `sweep0_plan` and
`dual_plan`); for CPU tensors they run the plain versions beside them.
Non-axis-0 sweeps run on transposed layouts (the MaskViews rotation of
the JAX package).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from .. import kernels
from ..utils import profiling
from .stencils import GRAPH_BITS, OCC_BIT, pad_const

INF = float("inf")
NEG_INF = float("-inf")
BIGID = 2**31 - 1  # minid mode fill (matches ops.ccl.BIGID)

_MODES = {"euclid": 0, "node": 1, "maxflood": 2, "minid": 3}
_KINDS = {"ball_rail": 0, "max2": 1}
_MASK_DTYPES = (torch.uint8, torch.bool)


# the nine (dy, dz) offsets of the previous plane, in the order of the step
# costs and of a gate's bits9
_OFFSETS9 = tuple((dy, dz) for dy in (-1, 0, 1) for dz in (-1, 0, 1))


def _costs9(anis_perm) -> list:
    out = []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            c = np.float32(np.sqrt(
                anis_perm[0] ** 2
                + (dy * anis_perm[1]) ** 2
                + (dz * anis_perm[2]) ** 2
            ))
            out.append(((dy, dz), float(c)))
    return out


def _fill(mode: str):
    if mode == "maxflood":
        return NEG_INF
    if mode == "minid":
        return BIGID
    return INF


# --------------------------------------------------------------------------- #
# B1: one directed sweep


def _sweep0_plain(d, cc, nodecost, okmask, anis_perm, mode: str,
                  clamp_positive: bool, descending: bool):
    """Plain torch version of the B1 kernel: a Python loop over planes
    (the JAX package's `_sweep0_scan`)."""
    fill = _fill(mode)
    costs9 = _costs9(anis_perm)
    n, H, W = d.shape
    occ = (cc != 0) if mode == "minid" else (cc > 0)
    if okmask is not None:
        occ = occ & (okmask != 0)
    cc_eff = torch.where(occ, cc, -1)
    clamp = clamp_positive and mode in ("euclid", "node")
    out = torch.empty_like(d)
    order = range(n - 1, -1, -1) if descending else range(n)
    prev_v = prev_c = None
    for p in order:
        cur, ccc = d[p], cc[p]
        if prev_v is None:
            new = torch.where(occ[p], cur, fill)
        else:
            pv = pad_const(prev_v, 1, fill)
            pc = pad_const(prev_c, 1, -1)
            cand = torch.full_like(cur, fill)
            for (dy, dz), c in costs9:
                sv = pv[1 + dy:1 + dy + H, 1 + dz:1 + dz + W]
                sc = pc[1 + dy:1 + dy + H, 1 + dz:1 + dz + W]
                sv = torch.where(sc == ccc, sv, fill)
                if mode == "euclid":
                    sv = sv + c
                if mode == "maxflood":
                    cand = torch.maximum(cand, sv)
                else:
                    cand = torch.minimum(cand, sv)
            if mode == "node":
                cand = cand + nodecost[p]
            if mode == "maxflood":
                new = torch.where(occ[p], torch.maximum(cur, cand), fill)
            else:
                new = torch.where(occ[p], torch.minimum(cur, cand), fill)
        if clamp:
            new = torch.where(new > 0.0, INF, new)
        out[p] = new
        prev_v, prev_c = new, cc_eff[p]
    return out


def _sweep0_gate_plain(d, gate, bits9, descending: bool):
    """Plain torch version of B1-vg: a minid sweep on G1's CCL gate (int32
    words of ops.stencils.graph_into with labels, the shape of `d`). A
    voxel is occupied where its bit OCC_BIT is set; the neighbour k of
    the previous plane counts where bit bits9[k] is set (the JAX
    package's `_ccl_stage` with a voxel graph: same label, the move
    into the voxel open)."""
    n, H, W = d.shape
    occ = ((gate >> OCC_BIT) & 1) > 0
    out = torch.empty_like(d)
    order = range(n - 1, -1, -1) if descending else range(n)
    prev_v = None
    for p in order:
        cur = d[p]
        if prev_v is None:
            new = torch.where(occ[p], cur, BIGID)
        else:
            pv = pad_const(prev_v, 1, BIGID)
            cand = torch.full_like(cur, BIGID)
            for k, (dy, dz) in enumerate(_OFFSETS9):
                sv = pv[1 + dy:1 + dy + H, 1 + dz:1 + dz + W]
                open_ = ((gate[p] >> bits9[k]) & 1) > 0
                cand = torch.minimum(cand, torch.where(open_, sv, BIGID))
            new = torch.where(occ[p], torch.minimum(cur, cand), BIGID)
        out[p] = new
        prev_v = new
    return out


def _check_gate(mode, cc, nodecost, okmask, clamp_positive, gate, bits9):
    """The graph gate's operands, checked: bits9 as nine ints in 0..31."""
    if (gate is None) != (bits9 is None):
        raise ValueError("sweep0: give gate and bits9 together")
    if gate is None:
        if cc is None:
            raise ValueError("sweep0: cc is required without a gate")
        return None
    if mode != "minid" or cc is not None or nodecost is not None \
            or okmask is not None or clamp_positive:
        raise ValueError("sweep0: a graph gate runs in minid mode alone, "
                         "without cc (its labels ride the gate)")
    bits9 = tuple(int(b) for b in bits9)
    if len(bits9) != 9 or not all(0 <= b < 32 for b in bits9):
        raise ValueError(f"sweep0: bad bits9 {bits9}")
    return bits9


def sweep0(d, cc, nodecost, okmask, anis_perm, mode: str,
           clamp_positive: bool, descending: bool, gate=None, bits9=None):
    """One directed sweep along axis 0 of an (n, H, W) volume (B1). With
    `gate`/`bits9` (minid mode, `cc` None) B1-vg: the CCL under a voxel
    graph on G1's CCL gate (ops.stencils.graph_into with labels), counted
    apart as "gsweep_sweep0_vg"."""
    bits9 = _check_gate(mode, cc, nodecost, okmask, clamp_positive, gate,
                        bits9)
    if d.device.type == "cpu":
        if gate is not None:
            return _sweep0_gate_plain(d, gate, bits9, descending)
        return _sweep0_plain(d, cc, nodecost, okmask, anis_perm, mode,
                             clamp_positive, descending)
    if mode not in _MODES:
        raise ValueError(f"unknown sweep mode {mode!r}")
    if (mode == "node") != (nodecost is not None):
        raise ValueError("nodecost is required in node mode and only there")
    vdt = torch.int32 if mode == "minid" else torch.float32
    name = "gsweep_sweep0" if gate is None else "gsweep_sweep0_vg"
    kernels.require_cuda(
        name, d, cc, nodecost, okmask, gate,
        dtypes=((vdt,), (torch.int32,), (torch.float32,), _MASK_DTYPES,
                (torch.int32,)),
        shape=d.shape)
    n, H, W = d.shape
    out = torch.empty_like(d)
    # the strips' edge-row mailboxes (two edges, two steps, W cells a
    # strip), zero before every sweep
    plan = _sweep0_plan(H, W, mode, okmask is not None, gate is not None,
                        d.device.index)
    mail = torch.zeros((plan["strips"] * 4 * W,), dtype=torch.int64,
                       device=d.device) if plan["persistent"] else None
    bits = None if gate is None else (ctypes.c_int * 9)(*bits9)
    rc = kernels.lib().kt_gsweep_sweep0(
        kernels.ptr(d), kernels.ptr(cc), kernels.ptr(nodecost),
        kernels.ptr(okmask), kernels.ptr(gate), kernels.ptr(mail),
        kernels.ptr(out), n, H, W, kernels.costs_arg(_costs9(anis_perm)),
        bits, _MODES[mode], int(bool(clamp_positive)),
        int(bool(descending)), kernels.stream_ptr(d.device))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def sweep0_plan(H: int, W: int, mode: str, has_ok: bool,
                has_gate: bool = False) -> dict:
    """How the B1 kernel runs an (H, W) plane in `mode` (with an okmask
    where `has_ok`; B1-vg where `has_gate`) on the current CUDA
    device: `persistent` (one launch per sweep, `strips` CTAs of `rows`
    rows each) or the per-plane form for planes too large to hold."""
    return dict(_sweep0_plan(int(H), int(W), mode, bool(has_ok),
                             bool(has_gate), torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _sweep0_plan(H: int, W: int, mode: str, has_ok: bool, has_gate: bool,
                 device_index) -> dict:
    rows, strips = ctypes.c_int(), ctypes.c_int()
    persistent = kernels.lib().kt_gsweep_sweep0_plan(
        int(H), int(W), _MODES[mode], int(has_ok), int(has_gate),
        ctypes.byref(rows), ctypes.byref(strips))
    if persistent < 0:
        raise ValueError(f"sweep0_plan: {mode} with okmask={has_ok}, "
                         f"gate={has_gate} is not a kernel form")
    return {"persistent": bool(persistent), "rows": rows.value,
            "strips": strips.value}


# --------------------------------------------------------------------------- #
# B2: two fields in one pass


def _sweep0_dual_plain(da, db, cc, nodecost, okmask, anis_perm, kind: str,
                       descending: bool):
    """Plain torch version of the B2 kernel (the JAX package's
    `_dual_kernel_factory`, plane by plane)."""
    fill = NEG_INF if kind == "max2" else INF
    costs9 = _costs9(anis_perm)
    n, H, W = da.shape
    occ = cc > 0
    cc_eff = torch.where(occ, cc, -1)
    out_a = torch.empty_like(da)
    out_b = torch.empty_like(db)
    order = range(n - 1, -1, -1) if descending else range(n)
    pa = torch.full((H + 2, W + 2), fill, dtype=da.dtype, device=da.device)
    pb = torch.full_like(pa, fill)
    pc = torch.full((H + 2, W + 2), -1, dtype=cc.dtype, device=cc.device)
    for p in order:
        cur_a, cur_b, ccc = da[p], db[p], cc[p]
        occupied = occ[p]
        occ_a = occupied & (okmask[p] != 0) if kind == "ball_rail" \
            else occupied
        cand_a = torch.full_like(cur_a, fill)
        cand_b = torch.full_like(cur_b, fill)
        for (dy, dz), c in costs9:
            same = pc[1 + dy:1 + dy + H, 1 + dz:1 + dz + W] == ccc
            sva = torch.where(same, pa[1 + dy:1 + dy + H, 1 + dz:1 + dz + W],
                              fill)
            svb = torch.where(same, pb[1 + dy:1 + dy + H, 1 + dz:1 + dz + W],
                              fill)
            if kind == "ball_rail":
                cand_a = torch.minimum(cand_a, sva + c)
                cand_b = torch.minimum(cand_b, svb)
            else:
                cand_a = torch.maximum(cand_a, sva)
                cand_b = torch.maximum(cand_b, svb)
        if kind == "ball_rail":
            new_a = torch.where(occ_a, torch.minimum(cur_a, cand_a), INF)
            new_a = torch.where(new_a > 0.0, INF, new_a)  # clamp_positive
            cand_b = cand_b + nodecost[p]
            new_b = torch.where(occupied, torch.minimum(cur_b, cand_b), INF)
        else:
            new_a = torch.where(occupied, torch.maximum(cur_a, cand_a), fill)
            new_b = torch.where(occupied, torch.maximum(cur_b, cand_b), fill)
        out_a[p] = new_a
        out_b[p] = new_b
        # field A's occupancy difference folds into its carried VALUES
        pa[1:H + 1, 1:W + 1] = (torch.where(occ_a, new_a, fill)
                                if kind == "ball_rail" else new_a)
        pb[1:H + 1, 1:W + 1] = new_b
        pc[1:H + 1, 1:W + 1] = cc_eff[p]
    return out_a, out_b


def sweep0_dual(da, db, cc, nodecost, okmask, anis_perm, kind: str,
                descending: bool):
    """One directed axis-0 sweep of two fields with one cc read (B2).
    kind "ball_rail": A = euclid + okmask + clamp_positive, B = node with
    `nodecost`; kind "max2": two maxflood fields."""
    if da.device.type == "cpu":
        return _sweep0_dual_plain(da, db, cc, nodecost, okmask, anis_perm,
                                  kind, descending)
    if kind not in _KINDS:
        raise ValueError(f"unknown dual sweep kind {kind!r}")
    if kind == "ball_rail" and (nodecost is None or okmask is None):
        raise ValueError("ball_rail needs nodecost and okmask")
    if kind == "max2":
        nodecost = okmask = None
    kernels.require_cuda(
        "gsweep_sweep0_dual", da, db, cc, nodecost, okmask,
        dtypes=((torch.float32,), (torch.float32,), (torch.int32,),
                (torch.float32,), _MASK_DTYPES),
        shape=da.shape)
    n, H, W = da.shape
    out_a = torch.empty_like(da)
    out_b = torch.empty_like(db)
    # the strips' edge-row mailboxes (two edges, two steps, two fields of
    # W cells a strip), zero before every sweep
    plan = _dual_plan(H, W, kind, da.device.index)
    mail = torch.zeros((plan["strips"] * 8 * W,), dtype=torch.int64,
                       device=da.device) if plan["persistent"] else None
    rc = kernels.lib().kt_gsweep_sweep0_dual(
        kernels.ptr(da), kernels.ptr(db), kernels.ptr(cc),
        kernels.ptr(nodecost), kernels.ptr(okmask), kernels.ptr(out_a),
        kernels.ptr(out_b), kernels.ptr(mail), n, H, W,
        kernels.costs_arg(_costs9(anis_perm)), _KINDS[kind],
        int(bool(descending)), kernels.stream_ptr(da.device))
    kernels.check(rc, "gsweep_sweep0_dual")
    kernels.LAUNCHES["gsweep_sweep0_dual"] += 1
    return out_a, out_b


def dual_plan(H: int, W: int, kind: str) -> dict:
    """How the B2 kernel runs an (H, W) plane on the current CUDA device:
    `persistent` (one launch per sweep, `strips` CTAs of `rows` rows
    each) or the per-plane form for planes too large to hold."""
    return dict(_dual_plan(int(H), int(W), kind,
                           torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _dual_plan(H: int, W: int, kind: str, device_index) -> dict:
    rows, strips = ctypes.c_int(), ctypes.c_int()
    persistent = kernels.lib().kt_gsweep_dual_plan(
        int(H), int(W), _KINDS[kind], ctypes.byref(rows),
        ctypes.byref(strips))
    return {"persistent": bool(persistent), "rows": rows.value,
            "strips": strips.value}


# --------------------------------------------------------------------------- #
# Round/relax driver

# layout cycle: xyz --x sweeps--> (1,0,2) = yxz --y sweeps-->
#               (2,1,0) of yxz = zxy --z sweeps--> (1,2,0) back to xyz
_PERM_TO_Y = (1, 0, 2)
_PERM_Y_TO_Z = (2, 1, 0)
_PERM_Z_TO_X = (1, 2, 0)


def _permute(t, perm):
    return t.permute(*perm).contiguous()


# the original axis at each axis of the x, y and z layouts
_LAYOUT_AXES = ((0, 1, 2), (1, 0, 2), (2, 0, 1))


class MaskViews:
    """The three layout views of a static per-relax operand (cc ids,
    nodecost, okmask or a graph gate), built once and reused across
    relaxations."""

    __slots__ = ("x", "y", "z")

    def __init__(self, vol):
        self.x = vol.contiguous()
        self.y = _permute(self.x, _PERM_TO_Y)
        self.z = _permute(self.y, _PERM_Y_TO_Z)


def _views(v: Optional[MaskViews]):
    return (None, None, None) if v is None else (v.x, v.y, v.z)


@functools.lru_cache(maxsize=None)
def gate_bits9(layout: int, descending: bool) -> tuple:
    """The nine bits of a graph_into word that gate a sweep of layout
    `layout` (0 x, 1 y, 2 z): the neighbour at (dy, dz) of the previous
    plane lies at offset (-1, dy, dz) of the layout ((+1, dy, dz) when
    descending), and its move into the voxel is bit GRAPH_BITS[o] of that
    offset o in the volume's own axes."""
    axes = _LAYOUT_AXES[layout]
    bits = []
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            o = [0, 0, 0]
            for a, c in zip(axes, (1 if descending else -1, dy, dz)):
                o[a] = c
            bits.append(GRAPH_BITS[tuple(o)])
    return tuple(bits)


def one_round(d, cc_v: Optional[MaskViews], nc_v: Optional[MaskViews],
              ok_v: Optional[MaskViews], anisotropy, mode: str,
              clamp_positive: bool, gate_v: Optional[MaskViews] = None):
    """One full round: +-x, +-y, +-z sweeps with layout rotation. `gate_v`
    (minid mode, `cc_v` None): the layouts of G1's CCL gate (graph_into
    with labels), read by every sweep instead of cc."""
    ax, ay, az = (float(a) for a in anisotropy)
    cc, nc, ok, gt = (_views(cc_v), _views(nc_v), _views(ok_v),
                      _views(gate_v))

    def pair(dd, layout, ccv, ncv, okv, anis_perm):
        for desc in (False, True):
            bits = None if gate_v is None else gate_bits9(layout, desc)
            dd = sweep0(dd, ccv, ncv, okv, anis_perm, mode, clamp_positive,
                        desc, gt[layout], bits)
        return dd

    d = pair(d, 0, cc[0], nc[0], ok[0], (ax, ay, az))
    d = _permute(d, _PERM_TO_Y)
    d = pair(d, 1, cc[1], nc[1], ok[1], (ay, ax, az))
    d = _permute(d, _PERM_Y_TO_Z)
    d = pair(d, 2, cc[2], nc[2], ok[2], (az, ax, ay))
    return _permute(d, _PERM_Z_TO_X)


def _change_mask(nd, d, conv: str):
    if conv == "reach":
        return torch.isfinite(nd) != torch.isfinite(d)
    if conv == "negative":
        return (torch.where(nd <= 0, nd, INF) != torch.where(d <= 0, d, INF))
    return nd != d


def relax_full(d, cc_v: MaskViews, nc_v, ok_v, anisotropy, rounds: int,
               mode: str = "euclid", clamp_positive: bool = False,
               conv: str = "exact"):
    """`rounds` full rounds; the LAST round doubles as the convergence
    check. Returns (d, changed_mask): the per-voxel last-round change mask
    (empty at a fixpoint; callers reduce it per label, since cc partitions
    the foreground)."""
    for _ in range(max(int(rounds), 1) - 1):
        d = one_round(d, cc_v, nc_v, ok_v, anisotropy, mode, clamp_positive)
    nd = one_round(d, cc_v, nc_v, ok_v, anisotropy, mode, clamp_positive)
    return nd, _change_mask(nd, d, conv)


def relax_escalated(d, cc_v: MaskViews, nc_v, ok_v, anisotropy, rounds: int,
                    mode: str = "euclid", clamp_positive: bool = False,
                    conv: str = "exact", extra_stages: int = 2,
                    extra_rounds: int = 4):
    """relax_full plus up to `extra_stages` stages of `extra_rounds` more
    rounds, each run only while the previous stage's change mask is not
    empty. Returns (d, changed_mask) of the last executed stage."""
    d, mask = relax_full(d, cc_v, nc_v, ok_v, anisotropy, rounds, mode,
                         clamp_positive, conv)
    for _ in range(int(extra_stages)):
        if not profiling.host(mask.any(), bool):
            break
        d, mask = relax_full(d, cc_v, nc_v, ok_v, anisotropy,
                             int(extra_rounds), mode, clamp_positive, conv)
    return d, mask


def one_round_dual(da, db, cc_v: MaskViews, nc_v, ok_v, anisotropy,
                   kind: str):
    """One full +-x/+-y/+-z round of the fused two-field sweep."""
    ax, ay, az = (float(a) for a in anisotropy)
    nc, ok = _views(nc_v), _views(ok_v)

    def pair(aa, bb, ccv, ncv, okv, anis_perm):
        aa, bb = sweep0_dual(aa, bb, ccv, ncv, okv, anis_perm, kind, False)
        return sweep0_dual(aa, bb, ccv, ncv, okv, anis_perm, kind, True)

    da, db = pair(da, db, cc_v.x, nc[0], ok[0], (ax, ay, az))
    da, db = _permute(da, _PERM_TO_Y), _permute(db, _PERM_TO_Y)
    da, db = pair(da, db, cc_v.y, nc[1], ok[1], (ay, ax, az))
    da, db = _permute(da, _PERM_Y_TO_Z), _permute(db, _PERM_Y_TO_Z)
    da, db = pair(da, db, cc_v.z, nc[2], ok[2], (az, ax, ay))
    return _permute(da, _PERM_Z_TO_X), _permute(db, _PERM_Z_TO_X)


def relax_full_dual(da, db, cc_v: MaskViews, nc_v, ok_v, anisotropy,
                    rounds: int, kind: str = "ball_rail"):
    """`rounds` fused two-field rounds; the last round doubles as the
    convergence check. Returns ((da, db), (mask_a, mask_b)): per-field
    last-round change masks (field A under conv="negative" for
    ball_rail, exact otherwise)."""
    for _ in range(max(int(rounds), 1) - 1):
        da, db = one_round_dual(da, db, cc_v, nc_v, ok_v, anisotropy, kind)
    na, nb = one_round_dual(da, db, cc_v, nc_v, ok_v, anisotropy, kind)
    mask_a = _change_mask(na, da,
                          "negative" if kind == "ball_rail" else "exact")
    mask_b = nb != db
    return (na, nb), (mask_a, mask_b)


def relax_escalated_dual(da, db, cc_v: MaskViews, nc_v, ok_v, anisotropy,
                         rounds: int, kind: str = "ball_rail",
                         extra_stages: int = 2, extra_rounds: int = 4):
    """relax_full_dual plus escalation stages, jointly gated: a stage runs
    while EITHER field's mask changed. Extra rounds on a converged field
    are exact no-ops, so each field equals its separately escalated
    relax."""
    (da, db), (ma, mb) = relax_full_dual(da, db, cc_v, nc_v, ok_v,
                                         anisotropy, rounds, kind)
    for _ in range(int(extra_stages)):
        if not (profiling.host(ma.any(), bool)
                or profiling.host(mb.any(), bool)):
            break
        (da, db), (ma, mb) = relax_full_dual(da, db, cc_v, nc_v, ok_v,
                                             anisotropy, int(extra_rounds),
                                             kind)
    return (da, db), (ma, mb)
