"""TEASAR trace core for one label (the host trace path).

Torch counterpart of kimimaro_tpu.trace: every field is computed by the
directional-sweep relaxation of ops.geodesic, and the per-path "railroad"
query (path from the target to the nearest zero-weight rail) is a chase
on an incremental, warm-started distance-from-rails field. The path loop
runs on the host, as the JAX package's fused loop
(`_compute_paths_fused`) and, where that overflows, as its eager loop
(`_compute_paths_host`); the fields stay on `device`.

Pipeline per label:
  soma detect (hole fill + re-EDT), root selection, DAF (distance from
  root field), PDRF penalty field, then the path loop with rolling-ball
  invalidation and rail zeroing.

A voxel graph (self-touch walls, cc3d convention) gates every field, the
re-EDT and the chase; like the JAX package, a label under a graph takes
the eager loop only, never the fused one. The fields' sweeps read the
graph's gate (ops.geodesic.SweepGate), built once per label.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from .ops import edt as edt_ops
from .ops import fill as fill_ops
from .ops.chase import RELAX_ROUNDS, _chase
from .ops.fma import fma_f32
from .ops.stencils import graph_word
from .ops.geodesic import (
    OFFSETS26,
    SweepGate,
    distance_field,
    euclidean_distance_field,
    invalidation_ball,
    invalidation_seeds,
    jax_index,
    parent_field,
    relax_rounds_batched,
)
from .skeleton import Skeleton
from .utils import profiling
from .utils.device import resolve_device

INF = float("inf")
# buffer sizes of the JAX package's fused path loop (kimimaro_tpu.trace)
FUSED_T_CAP = 32
FUSED_K_CAP = 256
_EXP_1_01 = float(np.float32(1.01))


def pow_1_01(x: torch.Tensor) -> torch.Tensor:
    """x ** float32(1.01), rounded once from float64 (the same f32 result
    on every device)."""
    return torch.pow(x.double(), _EXP_1_01).float()


def inv_pow_1_01(x: torch.Tensor) -> torch.Tensor:
    """1 / x ** float32(1.01) as XLA computes it: its simplifier rewrites
    the quotient into x ** -1.01, here rounded once from float64."""
    return torch.pow(x.double(), -_EXP_1_01).float()


def root_distance(path: torch.Tensor, root: torch.Tensor,
                  anis: torch.Tensor) -> torch.Tensor:
    """Physical distance of each path voxel (..., 3) from `root`, in
    float32 as XLA reduces it: the squares summed by chained fused
    multiply-adds, the square root rounded once."""
    dv = (path.float() - root.float()) * anis
    sq = fma_f32(dv[..., 2], dv[..., 2],
                 fma_f32(dv[..., 1], dv[..., 1], dv[..., 0] * dv[..., 0]))
    return torch.sqrt(sq.double()).float()


def integer_pow(p: torch.Tensor, e: int) -> torch.Tensor:
    """p ** e for a positive integer e by repeated squaring, in the order
    jax.lax.integer_pow multiplies."""
    acc = None
    while e > 0:
        if e & 1:
            acc = p if acc is None else acc * p
        e >>= 1
        if e > 0:
            p = p * p
    return acc


def _masked_argmax(field: torch.Tensor, mask: torch.Tensor):
    """Argmax of `field` restricted to `mask`, first-index tie-break."""
    masked = torch.where(mask, field, -INF)
    flat = int(torch.argmax(masked))
    return tuple(int(c) for c in np.unravel_index(flat, tuple(field.shape)))


def _pdrf_kernel(dbf_inf, daf, dbf_max, pdrf_scale, pdrf_exponent: int,
                 max_daf):
    """PDRF = pdrf_scale * (1 - DBF/dbf_max^1.01)^exponent + DAF/max(DAF).
    Background voxels (DBF = +inf) get +inf cost and are impassable.
    pdrf_scale: a float32 scalar; dbf_max: a float32 scalar or a tensor
    that broadcasts against the fields (one value per lane of a batch);
    max_daf: a float32 tensor of the same kind."""
    dev = dbf_inf.device
    m = inv_pow_1_01(torch.as_tensor(dbf_max, dtype=torch.float32,
                                     device=dev))
    # XLA fuses both multiply-adds of this formula
    p = fma_f32(dbf_inf, m, 1.0, negate=True)
    e = int(pdrf_exponent)
    p = integer_pow(p, e) if e > 0 else torch.ones_like(p)
    trickle = torch.where(max_daf > 0,
                          daf / torch.clamp(max_daf, min=1e-30), 0.0)
    return fma_f32(p, float(np.float32(pdrf_scale)), trickle)


def _zero_at(vol: torch.Tensor, coords) -> torch.Tensor:
    """A copy of `vol` with zeros at an (L, 3) coordinate array, by JAX's
    index rule for a scatter (ops.geodesic.jax_index)."""
    out = vol.clone()
    c, inb = jax_index(coords, vol.shape)
    c = c[inb]
    out[tuple(torch.as_tensor(c[:, a], device=vol.device)
              for a in range(3))] = 0.0
    return out


def _chase_parents(parent_codes: np.ndarray, start, offsets) -> np.ndarray:
    """Follow parent codes from `start` until a source voxel (code ==
    len(offsets)). Returns the path ordered rail-first."""
    path = []
    v = tuple(int(c) for c in start)
    sentinel = len(offsets)
    for _ in range(parent_codes.size):
        path.append(v)
        code = int(parent_codes[v])
        if code == sentinel:
            break
        off = offsets[code]
        v = (v[0] + off[0], v[1] + off[1], v[2] + off[2])
    return np.array(path[::-1], dtype=np.int64)


def _chase_len(shape) -> int:
    """Rows of the JAX package's chase and path buffers for a crop."""
    return max(int(2 * (shape[0] + shape[1] + shape[2])), 64)


def _buffer_writes(path: np.ndarray, padded: bool, shape) -> np.ndarray:
    """The voxels the JAX fused loop writes through its path buffer: the
    path and, where the buffer holds a -1 row (padding past the path, or
    a vertex the soma culling dropped), the crop's far corner, to which
    JAX's `.at[]` wraps -1 (its ball seed, ball mask and rail zeros)."""
    if not padded:
        return path
    corner = np.array([[s - 1 for s in shape]], dtype=path.dtype)
    return np.concatenate([path, corner])


def _chase_device_path(d_rail: torch.Tensor, target, vg_pad=None):
    """Pointer chase on the rail field (gated by `vg_pad`, the voxel graph
    padded by one zero voxel on the host, where given). Returns the
    rail-first path, or None when the chase buffer overflowed (the caller
    then rebuilds the path from parent codes)."""
    L = _chase_len(d_rail.shape)
    d_pad = np.pad(d_rail.detach().to("cpu").numpy(), 1,
                   constant_values=np.float32(np.inf))
    path, plen, reached = _chase(d_pad, target, L, vg_pad)
    if not reached:
        return None
    return path[:plen][::-1].astype(np.int64)


# --------------------------------------------------------------------------- #
# Root selection


def find_soma_root(DBF, dbf_max):
    """Max-DBF voxel closest to the centroid of all maxima."""
    DBF = np.asarray(DBF)
    coords = np.argwhere(DBF >= dbf_max)
    com = coords.mean(axis=0)
    best = np.argmin(np.sum((coords - com) ** 2, axis=1))
    return tuple(int(c) for c in coords[best])


def find_root(fg: torch.Tensor, anisotropy,
              voxel_graph=None) -> Optional[tuple]:
    """Distance field from the first foreground voxel; its maximum is a
    valid root (an extremal point)."""
    nz = torch.nonzero(fg.reshape(-1))
    if nz.shape[0] == 0:
        return None
    any_voxel = np.unravel_index(int(nz[0, 0]), tuple(fg.shape))
    _, target = euclidean_distance_field(
        fg, tuple(int(c) for c in any_voxel), anisotropy,
        return_max_location=True, voxel_graph=voxel_graph)
    return target


# --------------------------------------------------------------------------- #
# The trace core


def trace(
    labels,
    DBF,
    scale: float = 10,
    const: float = 10,
    anisotropy: Sequence[float] = (1, 1, 1),
    soma_detection_threshold: float = 1100,
    soma_acceptance_threshold: float = 4000,
    pdrf_scale: float = 5000,
    pdrf_exponent: int = 16,
    soma_invalidation_scale: float = 0.5,
    soma_invalidation_const: float = 0,
    fix_branching: bool = True,
    manual_targets_before=None,
    manual_targets_after=None,
    root=None,
    max_paths: Optional[int] = None,
    voxel_graph=None,
    device="cuda",
) -> Skeleton:
    """Skeletonize one binary label given its distance-to-boundary field
    (`labels` a binary volume, `DBF` its EDT in physical units; numpy
    arrays or tensors). `voxel_graph` (numpy array or tensor, cc3d
    convention) masks the moves of a self-touching label and routes the
    paths through the eager loop. The fields are computed on `device`
    (asking for CUDA where there is none raises)."""
    device = resolve_device(device)
    vg = gate = None
    if voxel_graph is not None:
        if not torch.is_tensor(voxel_graph):
            voxel_graph = torch.from_numpy(
                np.ascontiguousarray(voxel_graph, dtype=np.uint32))
        vg = graph_word(voxel_graph.to(device))
        # the gate of every field's sweeps, built once for the label
        with profiling.phase("graph_gate", device):
            gate = SweepGate(vg)
    manual_targets_before = list(manual_targets_before or [])
    manual_targets_after = list(manual_targets_after or [])
    anisotropy = tuple(float(a) for a in anisotropy)

    if not torch.is_tensor(labels):
        labels = torch.from_numpy(np.asarray(labels) != 0)
    if not torch.is_tensor(DBF):
        DBF = torch.from_numpy(np.array(DBF, dtype=np.float32))
    fg = labels.to(device) != 0
    dbf = DBF.to(device=device, dtype=torch.float32)
    dbf_max = float(dbf.max())

    soma_mode = False
    if dbf_max > soma_detection_threshold:
        filled, n_filled = fill_ops.fill(fg, return_fill_count=True)
        if n_filled > 0:
            fg = filled
            black_border = bool(fg.all())
            dbf = edt_ops.edt(fg.to(torch.uint8), anisotropy, black_border,
                              voxel_graph=vg)
            dbf = torch.where(fg, dbf, 0.0)
        dbf_max = float(dbf.max())
        soma_mode = dbf_max > soma_acceptance_threshold

    soma_radius = 0.0
    if soma_mode:
        if root is not None:
            manual_targets_before.insert(0, tuple(root))
        root = find_soma_root(dbf.to("cpu").numpy(), dbf_max)
        soma_radius = dbf_max * soma_invalidation_scale + soma_invalidation_const
    elif root is None:
        root = find_root(fg, anisotropy, voxel_graph=gate)
    else:
        root = tuple(int(c) for c in root)

    if root is None:
        return Skeleton()

    dbf_inf = torch.where(dbf == 0, INF, dbf)
    daf, target = euclidean_distance_field(
        fg, root, anisotropy, return_max_location=True, voxel_graph=gate)
    daf = torch.where(torch.isfinite(daf), daf, 0.0)
    max_daf = daf[target]
    pdrf = _pdrf_kernel(dbf_inf, daf, np.float32(dbf_max),
                        np.float32(pdrf_scale), int(pdrf_exponent), max_daf)

    valid = fg
    if soma_mode:
        ball = invalidation_ball(valid, dbf, [root], soma_invalidation_scale,
                                 soma_invalidation_const, anisotropy,
                                 voxel_graph=gate)
        valid = valid & ~ball
    elif len(manual_targets_before) == 0:
        manual_targets_before.append(tuple(int(c) for c in target))

    # the JAX package runs its fused device loop (multiply-adds fused)
    # when the manual targets fit its buffers, and its eager host loop
    # (not fused) when they do not, when the fused loop overflows, and
    # always under a voxel graph
    paths = None
    if (vg is None and len(manual_targets_before) <= FUSED_T_CAP
            and len(manual_targets_after) <= FUSED_T_CAP):
        paths = _compute_paths_fused(
            root, fg, valid, dbf, daf, pdrf,
            scale, const, anisotropy,
            soma_mode, soma_radius, fix_branching,
            manual_targets_before, manual_targets_after, max_paths,
        )
    if paths is None:
        paths = _compute_paths_host(
            root, fg, valid, dbf, daf, pdrf,
            scale, const, anisotropy,
            soma_mode, soma_radius, fix_branching,
            manual_targets_before, manual_targets_after, max_paths,
            voxel_graph=vg, gate=gate,
        )

    skel = Skeleton.simple_merge(
        [Skeleton.from_path(p) for p in paths if len(p) > 0]
    ).consolidate()

    if not skel.empty():
        verts = skel.vertices.astype(np.int64)
        dbf_host = dbf_inf.to("cpu").numpy()
        skel.radii = dbf_host[verts[:, 0], verts[:, 1], verts[:, 2]].astype(np.float32)
    skel.transform = np.array(
        [
            [anisotropy[0], 0, 0, 0],
            [0, anisotropy[1], 0, 0],
            [0, 0, anisotropy[2], 0],
        ],
        dtype=np.float32,
    )
    return skel


def _compute_paths_fused(
    root, fg, valid, dbf, daf, pdrf,
    scale, const, anisotropy,
    soma_mode, soma_radius, fix_branching,
    manual_targets_before, manual_targets_after, max_paths,
):
    """The JAX package's fused path loop (kimimaro_tpu.ops.fused_trace
    .fused_path_loop), run from the host: every relaxation runs its
    bounded rounds on B4 (RELAX_ROUNDS for the first rail field, half
    that for a ball, a third for the warm rail; at least 3 and 2), every
    path is a chase down the rail field, the invalidation radii are fused
    multiply-adds and the soma culling distance is float32. Like that
    loop, each path also seeds a ball at the crop's far corner and, with
    fix_branching, zeroes the PDRF and the rail field there whenever its
    path buffer holds a -1 row (`_buffer_writes`). Returns the
    rail-first paths, or None where that loop overflows (a relaxation
    that has not converged, a chase buffer overflow, FUSED_K_CAP paths
    with work left); the label then takes the eager loop from scratch,
    as in the JAX package."""
    valid_labels = int(valid.sum())
    root = tuple(int(c) for c in root)
    before, after = list(manual_targets_before), list(manual_targets_after)
    if max_paths is None:
        max_paths = max(valid_labels, 1)
    if len(before) + len(after) >= max_paths:
        return []

    r_main = RELAX_ROUNDS
    r_ball, r_warm = max(3, r_main // 2), max(2, r_main // 3)

    def relax(d, ok, nc, rounds, clamp=False, conv="exact"):
        out, done = relax_rounds_batched(
            d[None], ok[None], None if nc is None else nc[None], anisotropy,
            rounds, clamp_positive=clamp, conv=conv)
        return out[0], bool(done[0])

    pdrf = _zero_at(pdrf, [root])  # the initial rail
    d_rail = torch.full(fg.shape, INF, dtype=torch.float32, device=fg.device)
    d_rail[root] = 0.0
    d_rail, done = relax(d_rail, fg, pdrf, r_main)
    if not done:
        return None
    root_t = torch.tensor(root)
    anis = torch.tensor(anisotropy, dtype=torch.float32)
    soma_r = float(np.float32(soma_radius))
    chase_len = _chase_len(fg.shape)

    paths: List[np.ndarray] = []
    while (valid_labels > 0 or before or after) and len(paths) < max_paths:
        if len(paths) >= FUSED_K_CAP:
            return None
        if before:
            target = tuple(int(c) for c in before.pop())
        elif valid_labels == 0:
            target = tuple(int(c) for c in after.pop())
        else:
            target = _masked_argmax(daf, valid)

        path = _chase_device_path(d_rail, target)
        if path is None:
            return None
        padded = len(path) < chase_len
        if soma_mode:
            # drop the vertices within the soma radius of the root but the
            # rail anchor
            keep = (root_distance(torch.from_numpy(path), root_t, anis)
                    > soma_r).numpy()
            keep[0] = True
            padded = padded or not keep.all()
            path = path[keep]
        writes = _buffer_writes(path, padded, fg.shape)

        if valid_labels > 0:
            ok, init = invalidation_seeds(valid, dbf, writes, scale, const,
                                          fused=True)
            ball, done = relax(init, ok, None, r_ball, clamp=True,
                               conv="negative")
            if not done:
                return None
            ball = ball <= 0.0
            valid_labels -= int((ball & valid).sum())
            valid = valid & ~ball

        if fix_branching:
            pdrf = _zero_at(pdrf, writes)
            d_rail, done = relax(_zero_at(d_rail, writes), fg, pdrf, r_warm)
            if not done:
                return None

        paths.append(path)

    return paths


def _compute_paths_host(
    root, fg, valid, dbf, daf, pdrf,
    scale, const, anisotropy,
    soma_mode, soma_radius, fix_branching,
    manual_targets_before, manual_targets_after, max_paths,
    voxel_graph=None, gate=None,
):
    """The JAX package's eager TEASAR path loop, for the labels whose
    manual targets or paths overflow the fused loop's buffers, and for
    every label under a voxel graph (which gates each field and chase;
    `gate`: its SweepGate, for the fields).

    fix_branching=True: maintain a distance-from-rails field D over the
    PDRF node costs. Rails start as {root}; each accepted path is zeroed
    into the PDRF and seeded into D, then D is re-relaxed (warm start:
    distances only decrease). The path for a target is the pointer chase
    down D.

    fix_branching=False: one SSSP from the root, parents fetched once.
    """
    valid_labels = int(valid.sum())
    root = tuple(int(c) for c in root)
    paths: List[np.ndarray] = []

    if max_paths is None:
        max_paths = max(valid_labels, 1)
    if len(manual_targets_before) + len(manual_targets_after) >= max_paths:
        return []

    pdrf = _zero_at(pdrf, [root])  # the initial rail
    anis = np.asarray(anisotropy, dtype=np.float32)

    vg = voxel_graph
    vg_pad = None if vg is None else np.pad(vg.to("cpu").numpy(), 1)
    fields_vg = vg if gate is None else gate
    d_init = torch.full(fg.shape, INF, dtype=torch.float32, device=fg.device)
    d_init[root] = 0.0
    if fix_branching:
        d_rail = distance_field(fg, d_init, anisotropy, node_cost=pdrf,
                                voxel_graph=fields_vg)
    else:
        d_root = distance_field(fg, d_init, anisotropy, node_cost=pdrf,
                                voxel_graph=fields_vg)
        parents_host = parent_field(
            d_root, fg, anisotropy, node_cost=pdrf,
            voxel_graph=vg).to("cpu").numpy()

    while (valid_labels > 0 or manual_targets_before or manual_targets_after) \
            and len(paths) < max_paths:
        if manual_targets_before:
            target = tuple(int(c) for c in manual_targets_before.pop())
        elif valid_labels == 0:
            target = tuple(int(c) for c in manual_targets_after.pop())
        else:
            target = _masked_argmax(daf, valid)

        if fix_branching:
            path = _chase_device_path(d_rail, target, vg_pad)
            if path is None:
                # chase buffer overflow (pathological field): rebuild the
                # path from exact parent codes
                codes = parent_field(d_rail, fg, anisotropy, node_cost=pdrf,
                                     voxel_graph=vg).to("cpu").numpy()
                path = _chase_parents(codes, target, OFFSETS26)
        else:
            path = _chase_parents(parents_host, target, OFFSETS26)

        if soma_mode and len(path):
            dist_to_root = np.linalg.norm(anis * (path - np.array(root)), axis=1)
            path = np.concatenate((path[:1], path[dist_to_root > soma_radius]))

        if valid_labels > 0 and len(path):
            ball = invalidation_ball(valid, dbf, path, scale, const,
                                     anisotropy, voxel_graph=fields_vg)
            n_inv = int((ball & valid).sum())
            valid = valid & ~ball
            valid_labels -= n_inv

        if len(path) and fix_branching:
            pdrf = _zero_at(pdrf, path)
            d_rail = _zero_at(d_rail, path)
            d_rail = distance_field(fg, d_rail, anisotropy, node_cost=pdrf,
                                    voxel_graph=fields_vg)

        paths.append(path)

    return paths


# --------------------------------------------------------------------------- #
# point-to-point centerline (kimimaro_tpu.trace.point_to_point)


def point_to_point(binary_img, start, end,
                   anisotropy: Sequence[float] = (1, 1, 1),
                   pdrf_scale: float = 100000, pdrf_exponent: int = 4,
                   device="cuda") -> Skeleton:
    """Trace one centerline from `start` to `end` through a binary image
    (numpy array or tensor): the EDT (black border), the distance from
    `start` and its farthest voxel, the PDRF over them, the node-cost
    distance field from `end`, then parents chased from `start`. Radii are
    the EDT at the vertices. The fields are computed on `device` (asking
    for CUDA where there is none raises)."""
    device = resolve_device(device)
    if not torch.is_tensor(binary_img):
        binary_img = torch.from_numpy(np.asarray(binary_img) != 0)
    fg = binary_img.to(device) != 0
    anisotropy = tuple(float(a) for a in anisotropy)
    dbf = edt_ops.edt(fg.to(torch.uint8), anisotropy, black_border=True)
    dbf = torch.where(fg, dbf, 0.0)
    dbf_max = float(dbf.max())
    dbf_inf = torch.where(dbf == 0, INF, dbf)
    start = tuple(int(c) for c in start)
    end = tuple(int(c) for c in end)

    daf, target = euclidean_distance_field(fg, start, anisotropy,
                                           return_max_location=True)
    daf = torch.where(torch.isfinite(daf), daf, 0.0)
    pdrf = _pdrf_kernel(dbf_inf, daf, np.float32(dbf_max),
                        np.float32(pdrf_scale), int(pdrf_exponent),
                        daf[target])

    # the node-cost field from `end`, the path chased from `start` (the
    # reference runs dijkstra(PDRF, end, start))
    d_init = torch.full(fg.shape, INF, dtype=torch.float32, device=device)
    d_init[end] = 0.0
    d = distance_field(fg, d_init, anisotropy, node_cost=pdrf)
    codes = parent_field(d, fg, anisotropy, node_cost=pdrf).cpu().numpy()
    skel = Skeleton.from_path(_chase_parents(codes, start, OFFSETS26))
    if not skel.empty():
        verts = skel.vertices.astype(np.int64)
        skel.radii = dbf_inf[tuple(torch.as_tensor(verts[:, a], device=device)
                                   for a in range(3))].cpu().numpy()
    return skel
