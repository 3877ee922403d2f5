"""Shared stencil utilities for voxel-grid kernels (torch counterpart of
kimimaro_tpu.ops.stencils)."""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import kernels
from ..utils.device import resolve_device


def neighborhood_offsets() -> List[Tuple[int, int, int]]:
    """The 26 neighbour offsets in lexicographic order, the fixed order
    every tie-break uses."""
    return [(dx, dy, dz)
            for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)
            if (dx, dy, dz) != (0, 0, 0)]


# cc3d voxel_connectivity_graph bit convention: bit GRAPH_BITS[o] set at
# voxel v permits movement FROM v along offset o
GRAPH_BITS = {
    (1, 0, 0): 0, (-1, 0, 0): 1, (0, 1, 0): 2, (0, -1, 0): 3,
    (0, 0, 1): 4, (0, 0, -1): 5,
    (1, 1, 0): 6, (-1, 1, 0): 7, (1, -1, 0): 8, (-1, -1, 0): 9,
    (1, 0, 1): 10, (-1, 0, 1): 11, (0, 1, 1): 12, (0, -1, 1): 13,
    (1, 0, -1): 14, (-1, 0, -1): 15, (0, 1, -1): 16, (0, -1, -1): 17,
    (1, 1, 1): 18, (-1, 1, 1): 19, (1, -1, 1): 20, (-1, -1, 1): 21,
    (1, 1, -1): 22, (-1, 1, -1): 23, (1, -1, -1): 24, (-1, -1, -1): 25,
}


def as_tensor(x, device=None) -> torch.Tensor:
    """A tensor as it is, on its own device; any other array-like (as the
    JAX ops take numpy arrays) as a tensor on `device` (`resolve_device`:
    asking for CUDA where there is none raises), or on the CPU where
    `device` is None."""
    if torch.is_tensor(x):
        return x
    a = np.ascontiguousarray(np.asarray(x))
    t = torch.from_numpy(a if a.flags.writeable else a.copy())
    return t if device is None else t.to(resolve_device(device))


def graph_word(voxel_graph: torch.Tensor) -> torch.Tensor:
    """A voxel graph as the int32 words the port computes with: uint32
    bitfields are reinterpreted (every bit kept), narrower types
    widened."""
    if voxel_graph.dtype == torch.uint32:
        return voxel_graph.view(torch.int32)
    if voxel_graph.dtype == torch.int32:
        return voxel_graph
    return voxel_graph.to(torch.int64).to(torch.int32)


def graph_allows(voxel_graph: torch.Tensor, offset: Sequence[int]
                 ) -> torch.Tensor:
    """Bool volume: may a walker leave each voxel along `offset`?"""
    bit = GRAPH_BITS[tuple(int(o) for o in offset)]
    return ((graph_word(voxel_graph) >> bit) & 1) > 0


# the bit of a CCL gate word (graph_into with labels) that says the voxel
# is occupied; the 26 move bits are 0-25
OCC_BIT = 26


def _graph_into_plain(vg: torch.Tensor,
                      labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain torch version of the G1 kernel: the 26 moves one after
    another, each a shifted copy of the words (and of the labels)."""
    X, Y, Z = vg.shape[-3:]
    pad = (1, 1, 1, 1, 1, 1)
    padded = F.pad(vg, pad)
    plab = None if labels is None else F.pad(labels, pad)
    out = torch.zeros_like(vg)
    for o, bit in GRAPH_BITS.items():
        back = GRAPH_BITS[tuple(-c for c in o)]
        at = (..., slice(1 + o[0], 1 + o[0] + X),
              slice(1 + o[1], 1 + o[1] + Y), slice(1 + o[2], 1 + o[2] + Z))
        move = (padded[at] >> back) & 1
        if labels is not None:
            move = move & (plab[at] == labels).to(torch.int32)
        out |= move << bit
    if labels is not None:
        out = torch.where(labels != 0, out | (1 << OCC_BIT), 0)
    return out


def _offset_bits():
    """G1's table: the bit of each offset of the 3 x 3 x 3 neighbourhood
    in (dx, dy, dz) order, then the bit of its reverse (0 at the
    centre)."""
    offs = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
            for dz in (-1, 0, 1)]
    bit = [GRAPH_BITS.get(o, 0) for o in offs]
    back = [GRAPH_BITS.get(tuple(-c for c in o), 0) for o in offs]
    return (ctypes.c_int * 54)(*(bit + back))


def graph_into(voxel_graph: torch.Tensor,
               labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The permissions of the moves INTO each voxel: bit GRAPH_BITS[o] of
    the result at v is set where the neighbour u = v + o lies in the
    volume and u's bit for -o (the move u -> v) is set. int32, the shape
    of `voxel_graph`; a sweep that relaxes v from u reads this word of v
    instead of u's. The moves run along the last three axes: a leading
    axis is one of lanes, and a lane's words see only its own graph.

    With `labels` (int32 words of the same shape, as ops.ccl.label_words
    gives them: equality and != 0 are what count) the CCL's form: each
    move bit is kept only where labels[u] == labels[v] != 0, and bit
    OCC_BIT is set where labels[v] != 0 (the word is 0 elsewhere).

    A CUDA tensor takes one launch of kernel G1 (csrc/gate.cu; counted as
    "graph_into", or "graph_into_ccl" with labels), a CPU tensor its plain
    version."""
    vg = graph_word(voxel_graph).contiguous()
    if labels is not None:
        if labels.dtype != torch.int32 or labels.shape != vg.shape:
            raise ValueError(
                f"graph_into: labels must be int32 words of the graph's "
                f"shape {tuple(vg.shape)}, got {labels.dtype} "
                f"{tuple(labels.shape)}")
        labels = labels.contiguous()
    if vg.device.type == "cpu":
        return _graph_into_plain(vg, labels)
    name = "graph_into" if labels is None else "graph_into_ccl"
    kernels.require_cuda(name, vg, labels,
                         dtypes=((torch.int32,), (torch.int32,)))
    X, Y, Z = vg.shape[-3:]
    out = torch.empty_like(vg)
    rc = kernels.lib().kt_graph_into(
        kernels.ptr(vg), kernels.ptr(labels), kernels.ptr(out),
        vg.numel() // max(X * Y * Z, 1), X, Y, Z, _offset_bits(),
        kernels.stream_ptr(vg.device))
    kernels.check(rc, name)
    kernels.LAUNCHES[name] += 1
    return out


def pad_const(vol: torch.Tensor, width: int, fill) -> torch.Tensor:
    """`vol` padded by `width` on both sides of every axis with `fill`."""
    shape = tuple(s + 2 * width for s in vol.shape)
    out = torch.full(shape, fill, dtype=vol.dtype, device=vol.device)
    out[tuple(slice(width, width + s) for s in vol.shape)] = vol
    return out


def shifted(vol: torch.Tensor, offset: Sequence[int], fill) -> torch.Tensor:
    """out[v] = vol[v + offset], out-of-bounds filled with `fill`."""
    out = torch.full_like(vol, fill)
    src, dst = [], []
    for o, n in zip(offset, vol.shape):
        if abs(o) >= n:
            return out
        if o >= 0:
            src.append(slice(o, n))
            dst.append(slice(0, n - o))
        else:
            src.append(slice(0, n + o))
            dst.append(slice(-o, n))
    out[tuple(dst)] = vol[tuple(src)]
    return out
