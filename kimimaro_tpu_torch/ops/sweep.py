"""Directed axis-0 sweeps gated by an ok mask: one volume (B5) or a batch
of lanes (B4).

Torch counterpart of kimimaro_tpu.ops.pallas_sweep (`sweep_axis0`,
`sweep_axis0_batched`):

  node mode:      new = min(cur, min_9(prev_shifted) + node_cost)
  euclidean mode: new = min(cur, min_9(prev_shifted + step_cost))
  clamp_positive: positives reset to +inf (invalidation balls)

The first plane of the sweep passes through unchanged. `descending` walks
the planes from the last to the first instead of flipping the data.

A voxel graph gates the candidates in one of two forms. `vg`/`bits9` are
the JAX package's: the source bitfields, and the bit of the neighbour u of
the previous plane that allows its move into the voxel. `gate`/
`gate_bits9` is the form the kernels read: a word per voxel (ops.stencils
.graph_into, built once for many sweeps), and the bit of that word that
opens the move from each of the nine neighbours (ops.gsweep.gate_bits9).
Given `vg`, a wrapper builds the gate of its sweep itself
(`source_gate`). The gated forms count their launches apart
("sweep_axis0_vg", "sweep_axis0_batched_vg"). For CUDA tensors each
wrapper launches its kernel of csrc/sweep.cu once a sweep, in the form
`sweep_axis0_plan` (B5) or `sweep_axis0_batched_plan` (B4) names; for CPU
tensors it runs the plain version beside it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import kernels
from .gsweep import _costs9

INF = float("inf")


def _bits(name, bits9):
    bits9 = tuple(int(b) for b in bits9)
    if len(bits9) != 9 or not all(0 <= b < 32 for b in bits9):
        raise ValueError(f"{name}: bad bits {bits9}")
    return bits9


def _words(t):
    """uint32 words read as int32 (a view: the bit tests see the same
    bits)."""
    return t.view(torch.int32) if t.dtype == torch.uint32 else t


def source_gate(vg, bits9, descending: bool):
    """The gate of one sweep from the voxel graph's source bitfields
    (int32 words, (..., n, H, W): the sweep runs along axis -3 of each
    lane): bit k of the word at v is bit bits9[k] of v's neighbour k on the
    previous plane, clear where that neighbour lies outside. Returns the
    gate and its bits, (0, ..., 8)."""
    n, H, W = vg.shape[-3:]
    p = F.pad(vg, (1, 1, 1, 1, 1, 1))
    prev = p[..., 2:n + 2, :, :] if descending else p[..., 0:n, :, :]
    gate = torch.zeros_like(vg)
    k = 0
    for dy in (-1, 0, 1):
        for dz in (-1, 0, 1):
            u = prev[..., 1 + dy:1 + dy + H, 1 + dz:1 + dz + W]
            gate |= ((u >> bits9[k]) & 1) << k
            k += 1
    return gate, tuple(range(9))


def _gate_operands(name, descending, vg, bits9, gate, gate_bits9):
    """The gate a sweep reads and its nine bits, from either form (None,
    None without a graph)."""
    if (vg is None) != (bits9 is None) or \
            (gate is None) != (gate_bits9 is None):
        raise ValueError(f"{name}: give vg with bits9 and gate with "
                         f"gate_bits9")
    if vg is not None and gate is not None:
        raise ValueError(f"{name}: give vg or gate, not both")
    if vg is not None:
        return source_gate(_words(vg), _bits(name, bits9), descending)
    if gate is None:
        return None, None
    return _words(gate), _bits(name, gate_bits9)


def _sweep_axis0_plain(d, ok, node_cost, anisotropy, node_mode: bool,
                       clamp_positive: bool, descending: bool, vg=None,
                       bits9=None, gate=None, gate_bits9=None):
    """Plain torch version of the B5 kernel, and of B4 (`_sweep_axis0_
    batched_plain`): a Python loop over the planes of axis -3 of one
    volume or of a (B, n, H, W) batch of lanes. With `vg`, a candidate
    from the neighbour u on the previous plane counts only where bit
    bits9[k] of u's bitfield is set (no permission at the edge); with
    `gate`, only where bit gate_bits9[k] of the voxel's own gate word is
    set."""
    costs9 = _costs9(anisotropy)
    n, H, W = d.shape[-3:]
    out = torch.empty_like(d)
    order = range(n - 1, -1, -1) if descending else range(n)
    prev = None
    for p in order:
        cur = d[..., p, :, :]
        if prev is None:
            out[..., p, :, :] = prev = cur
            continue
        pv = F.pad(prev, (1, 1, 1, 1), value=INF)
        gv = None
        if vg is not None:
            gv = F.pad(vg[..., p + (1 if descending else -1), :, :],
                       (1, 1, 1, 1))
        cand = torch.full_like(cur, INF)
        for k, ((dy, dz), c) in enumerate(costs9):
            s = pv[..., 1 + dy:1 + dy + H, 1 + dz:1 + dz + W]
            if gv is not None:
                g = gv[..., 1 + dy:1 + dy + H, 1 + dz:1 + dz + W]
                s = torch.where(((g >> bits9[k]) & 1) > 0, s, INF)
            if gate is not None:
                s = torch.where(((gate[..., p, :, :] >> gate_bits9[k]) & 1)
                                > 0, s, INF)
            cand = torch.minimum(cand, s if node_mode else s + c)
        if node_mode:
            cand = cand + node_cost[..., p, :, :]
        new = torch.where(ok[..., p, :, :], torch.minimum(cur, cand), INF)
        if clamp_positive:
            new = torch.where(new > 0.0, INF, new)
        out[..., p, :, :] = prev = new
    return out


# B4's plain version: the same loop over a (B, n, H, W) batch of lanes
_sweep_axis0_batched_plain = _sweep_axis0_plain


def _launch(name, fn, d, ok, nc, gate, gate_bits9, anisotropy, node_mode,
            clamp_positive, descending, plan, lanes, *shape):
    """One launch of `fn` (kt_sweep_axis0 or kt_sweep_axis0_batched)."""
    kernels.require_cuda(
        name, d, ok, nc, gate,
        dtypes=((torch.float32,), (torch.bool,), (torch.float32,),
                (torch.int32,)),
        shape=d.shape)
    out = torch.empty_like(d)
    # the grid-wide strips' edge-row mailboxes (two edges, two steps, W
    # cells a strip, of each lane), zero before every sweep
    mail = torch.zeros((lanes * plan["ctas"] * 4 * shape[-1],),
                       dtype=torch.int64, device=d.device) \
        if plan["form"] == "strips" else None
    bits = None if gate is None else (ctypes.c_int * 9)(*gate_bits9)
    rc = fn(kernels.ptr(d), kernels.ptr(ok), kernels.ptr(nc),
            kernels.ptr(gate), kernels.ptr(mail), kernels.ptr(out), *shape,
            kernels.costs_arg(_costs9(anisotropy)), bits,
            int(bool(node_mode)), int(bool(clamp_positive)),
            int(bool(descending)), kernels.stream_ptr(d.device))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def sweep_axis0(d, ok, node_cost, anisotropy: Tuple[float, float, float],
                node_mode: bool, clamp_positive: bool,
                descending: bool = False, vg=None,
                bits9: Optional[Tuple[int, ...]] = None, gate=None,
                gate_bits9: Optional[Tuple[int, ...]] = None):
    """One axis-0 directional sweep of an (n, H, W) float32 volume; `ok`
    is a bool volume of the same shape, `node_cost` float32 (read only in
    node mode, may be None otherwise). A voxel graph (int32 or uint32
    words of the same shape), in one form at most: `vg`/`bits9`, the
    bitfields and the nine bit indices of this layout's offsets in
    (dy, dz) order; or `gate`/`gate_bits9`, the gate words and the nine
    bits of this layout and direction."""
    gate, gate_bits9 = _gate_operands("sweep_axis0", descending, vg, bits9,
                                      gate, gate_bits9)
    if d.device.type == "cpu":
        return _sweep_axis0_plain(d, ok, node_cost, anisotropy, node_mode,
                                  clamp_positive, descending, gate=gate,
                                  gate_bits9=gate_bits9)
    nc = node_cost if node_mode else None
    if node_mode and nc is None:
        raise ValueError("sweep_axis0: node mode needs node_cost")
    n, H, W = d.shape
    plan = _axis0_plan(H, W, bool(node_mode), gate is not None,
                       d.device.index)
    return _launch("sweep_axis0" if gate is None else "sweep_axis0_vg",
                   kernels.lib().kt_sweep_axis0, d, ok, nc, gate, gate_bits9,
                   anisotropy, node_mode, clamp_positive, descending, plan,
                   1, n, H, W)


_AXIS0_FORMS = ("plane", "strips", "cluster")


def sweep_axis0_plan(H: int, W: int, node_mode: bool,
                     has_vg: bool = False) -> dict:
    """How the B5 kernel runs an (H, W) plane on the current CUDA device
    (with a voxel graph where `has_vg`): `form` "cluster" (one launch per
    sweep in a grid of one thread-block cluster), "strips" (one
    cooperative launch per sweep over the SMs) or "plane" (one launch per
    plane, for planes too large for both), with `ctas` strips of `rows`
    rows each."""
    return dict(_axis0_plan(int(H), int(W), bool(node_mode), bool(has_vg),
                            torch.cuda.current_device()))


@functools.lru_cache(maxsize=None)
def _axis0_plan(H: int, W: int, node_mode: bool, has_vg: bool,
                device_index) -> dict:
    rows, ctas = ctypes.c_int(), ctypes.c_int()
    form = kernels.lib().kt_sweep_axis0_plan(
        int(H), int(W), int(node_mode), int(has_vg), ctypes.byref(rows),
        ctypes.byref(ctas))
    return {"form": _AXIS0_FORMS[form], "rows": rows.value,
            "ctas": ctas.value}


def sweep_axis0_batched(d, ok, nc, anisotropy: Tuple[float, float, float],
                        node_mode: bool, clamp_positive: bool,
                        descending: bool = False, vg=None,
                        bits9: Optional[Tuple[int, ...]] = None, gate=None,
                        gate_bits9: Optional[Tuple[int, ...]] = None):
    """One directed sweep along axis 1 of a (B, n, H, W) float32 batch of
    lanes; `ok` bool of the same shape, `nc` float32 (read only in node
    mode, may be None otherwise). A voxel graph per lane as in
    `sweep_axis0`: `vg`/`bits9` or `gate`/`gate_bits9`, (B, n, H, W)
    words."""
    gate, gate_bits9 = _gate_operands("sweep_axis0_batched", descending, vg,
                                      bits9, gate, gate_bits9)
    if d.device.type == "cpu":
        return _sweep_axis0_batched_plain(d, ok, nc, anisotropy, node_mode,
                                          clamp_positive, descending,
                                          gate=gate, gate_bits9=gate_bits9)
    nc = nc if node_mode else None
    if node_mode and nc is None:
        raise ValueError("sweep_axis0_batched: node mode needs nc")
    B, n, H, W = d.shape
    plan = _batched_plan(B, H, W, bool(node_mode), gate is not None,
                         d.device.index)
    return _launch(
        "sweep_axis0_batched" if gate is None else "sweep_axis0_batched_vg",
        kernels.lib().kt_sweep_axis0_batched, d, ok, nc, gate, gate_bits9,
        anisotropy, node_mode, clamp_positive, descending, plan, B, B, n, H,
        W)


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
