"""The batched crop engine, and the host-side path assembly shared by the
engines.

Torch counterpart of kimimaro_tpu.engine. `trace_batched` traces the
labels the global engine hands back, a batch of labels at a time: each
lane holds one label's crop (its bbox padded to a power-of-two bucket),
and the whole per-label trace runs as (B, X, Y, Z) tensor code on the
device: soma hole refill and re-EDT, root choice, DAF and PDRF, the soma
root ball, then the path loop (target, rail chase, soma culling,
invalidation ball, rail re-relax). Every relaxation is kernel B4 through
ops.geodesic.relax_rounds_batched.

The JAX package runs the same trace per lane under `jax.vmap`, which
turns each `lax.cond` into "compute, then select per lane" and the path
`while_loop` into "run until no lane's condition holds, updating only
the lanes whose condition holds". This module keeps those semantics and
computes only the lanes whose result is kept. Lanes whose bounded
relaxations did not converge are re-run with two and four times the
sweep rounds; what still fails, and what the lanes cannot hold (more
than T_CAP manual targets, K_CAP paths, a path longer than the chase
buffer, or a refilled soma thicker than the re-EDT band, which more
rounds cannot change), goes back to the caller for the host trace path.
The fallback set equals the JAX engine's; `relax_retries` counts only
the re-runs made.

Under a voxel graph (self-touch walls) each lane also crops the graph
with its label: the graph gates the soma re-EDT's runs and, padded with
zeros, the rail chase, and its gate (ops.stencils.graph_into of the
lanes, built once per lane set) gates every relaxation (B4's
graph-gated form).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .ops.chase import RELAX_ROUNDS, chase_batched
from .ops.edt import AXIS_UNIT, wall_segments
from .ops.fma import fma_f32
from .ops.geodesic import _flood6_stage, relax_rounds_batched
from .ops.stencils import graph_allows, graph_into, graph_word
from .skeleton import Skeleton
from .trace import _pdrf_kernel, root_distance
from .utils import profiling

INF = float("inf")

T_CAP = 16     # manual-target slots per lane (beyond -> host fallback)
K_CAP = 64     # path rows per lane (overflow -> host fallback)
B_LANES = 64   # max lanes per batch
# lanes x crop voxels per batch (~10 live (B, crop) arrays of 4 bytes)
MAX_VOXEL_LANES = 32 * 1024 * 1024
# band of the in-crop re-EDT after a soma refill: distances longer than
# the band along an axis flag the lane inexact (nc bit 64), and it goes
# back to the host path
EDT_BAND_CAP = 128
_BIG = float(np.float32(3.4e37))  # the re-EDT's stand-in for +inf


def _lanes_for(bshape: Tuple[int, int, int], n_jobs: int) -> int:
    """Lanes per batch: a power of two covering n_jobs, bounded by B_LANES
    and by the per-batch voxel-lane budget."""
    vox = int(np.prod(bshape))
    b = max(1, min(B_LANES, MAX_VOXEL_LANES // max(vox, 1)))
    p = 1
    while p < min(b, n_jobs):
        p <<= 1
    return p


def _bucket_dim(n: int) -> int:
    b = 16
    while b < n:
        b <<= 1
    return b


# --------------------------------------------------------------------------- #
# Lane-batched helpers: every tensor is (B, X, Y, Z), every coordinate
# array (B, ..., 3) in crop frame


def _unravel(idx, shape):
    """Flat crop indices (B,) -> (B, 3) coordinates."""
    _, Y, Z = shape
    return torch.stack((idx // (Y * Z), (idx // Z) % Y, idx % Z), dim=-1)


def _crop_index(coords, shape):
    """Flat index into a (B * X*Y*Z + 1) buffer for coordinates (B, P, 3),
    by the JAX package's `.at[]` rule: a negative index counts from the
    end (so the -1 rows of a path address the crop's far corner), and
    what is still outside the crop goes to the last, spare element."""
    dev = coords.device
    size = torch.tensor(shape, dtype=torch.int64, device=dev)
    c = torch.where(coords < 0, coords + size, coords)
    inb = ((c >= 0) & (c < size)).all(dim=-1)
    X, Y, Z = shape
    lin = c[..., 0] * (Y * Z) + c[..., 1] * Z + c[..., 2]
    B = coords.shape[0]
    lane = torch.arange(B, device=dev).view((B,) + (1,) * (coords.dim() - 2))
    spare = B * X * Y * Z
    return torch.where(inb, lane * (X * Y * Z) + lin, spare), inb


def _gather(vol, coords, fill):
    """vol at coordinates (B, P, 3); outside the crop -> `fill`."""
    idx, inb = _crop_index(coords, tuple(vol.shape[1:]))
    flat = vol.reshape(-1)
    return torch.where(inb, flat[torch.clamp(idx, max=flat.numel() - 1)],
                       fill)


def _scatter(vol, coords, vals, reduce=None):
    """A copy of `vol` with `vals` (a scalar, or (B, P)) written at
    coordinates (B, P, 3), or min-reduced into it (`reduce="amin"`);
    writes outside the crop are dropped."""
    idx, _ = _crop_index(coords, tuple(vol.shape[1:]))
    buf = torch.cat((vol.reshape(-1), vol.new_zeros(1)))
    if reduce is None:
        buf[idx.reshape(-1)] = vals if not torch.is_tensor(vals) \
            else vals.reshape(-1)
    else:
        buf.scatter_reduce_(0, idx.reshape(-1), vals.reshape(-1), reduce)
    return buf[:-1].view(vol.shape)


def _bcast(flags, ndim=4):
    """(B,) -> (B, 1, 1, 1) for selects against (B, X, Y, Z) fields."""
    return flags.view((-1,) + (1,) * (ndim - 1))


def _relax_where(sel, d, ok, nc, anisotropy, rounds, clamp_positive=False,
                 conv="exact", gate=None):
    """relax_rounds_batched on the lanes where `sel` holds (gated by the
    lanes' graph gates `gate`, where given). The other lanes keep `d` and
    report converged: the JAX engine computes them too and selects them
    away."""
    idx = sel.nonzero()[:, 0]
    if idx.numel() == sel.numel():
        return relax_rounds_batched(d, ok, nc, anisotropy, rounds,
                                    clamp_positive, conv, gate=gate)
    out = d.clone()
    done = torch.ones_like(sel)
    if idx.numel():
        sub, c = relax_rounds_batched(
            d[idx], ok[idx], None if nc is None else nc[idx], anisotropy,
            rounds, clamp_positive, conv,
            gate=None if gate is None else gate[idx])
        out[idx] = sub
        done[idx] = c
    return out, done


def _crop_fill(fg, rounds: int):
    """Border-seeded 6-connected background flood of each lane's crop ->
    (filled foreground, converged). Counterpart of the JAX engine's
    `_crop_fill`, which floods by distance sweeps and reads only
    reachability: the same rounds and the same stall flag
    (ops.geodesic._flood6_stage)."""
    bg = ~fg
    border = torch.zeros_like(fg)
    for axis in (1, 2, 3):
        border.narrow(axis, 0, 1).fill_(True)
        border.narrow(axis, fg.shape[axis] - 1, 1).fill_(True)
    reached, conv = _flood6_stage(bg, border, rounds)
    return fg | (bg & ~reached), conv


def _pad_last(t, band, fill):
    out = t.new_full(t.shape[:-1] + (t.shape[-1] + 2 * band,), fill)
    out[..., band:band + t.shape[-1]] = t
    return out


def _crop_edtsq_banded(labels, anisotropy, black_border, vg=None):
    """Squared multi-label EDT of each lane's crop with static bands of
    EDT_BAND_CAP (counterpart of the JAX engine's `_crop_edtsq_banded`).
    labels: (B, X, Y, Z) uint8; black_border: (B,) bool; vg: the lanes'
    voxel graphs or None (a blocked +axis edge breaks a line like a label
    change). Exact when every distance fits the band; the second result
    flags, per lane, a foreground value above the smallest clipped band's
    reach (the caller escalates)."""
    band_cap = EDT_BAND_CAP
    shape = tuple(labels.shape[1:])
    dev = labels.device
    d = torch.full(labels.shape, _BIG, dtype=torch.float32, device=dev)
    oob_g = torch.where(black_border, 0.0, _BIG).view(-1, 1, 1, 1)
    for axis in range(3):
        w = np.float32(anisotropy[axis])
        n = shape[axis]
        if n == 1:
            d = torch.where(_bcast(black_border),
                            torch.minimum(d, float(w * w)), d)
            continue
        band = int(min(n - 1, band_cap))
        lab_t = torch.movedim(labels, 1 + axis, -1)
        d_t = torch.movedim(d, 1 + axis, -1)
        d_p = _pad_last(d_t, band, _BIG)
        l_p = _pad_last(lab_t, band, 0)
        wall_t = w_p = None
        if vg is not None:
            wall_t = wall_segments(torch.movedim(
                graph_allows(vg, AXIS_UNIT[axis]), 1 + axis, -1), -1)
            w_p = _pad_last(wall_t, band, -1)
        pos = torch.arange(n, device=dev)
        best = torch.full_like(d_t, _BIG)
        for o in range(2 * band + 1):
            off = np.float32(o - band)
            inside = (pos + (o - band) >= 0) & (pos + (o - band) < n)
            same = l_p[..., o:o + n] == lab_t
            if w_p is not None:
                same = same & (w_p[..., o:o + n] == wall_t)
            g = torch.where(same, d_p[..., o:o + n], 0.0)
            g = torch.where(inside, g, oob_g)
            step = float(np.float32(np.float32(w * w) * off) * off)
            best = torch.minimum(best, g + step)
        d = torch.movedim(torch.minimum(best, d_t), -1, 1 + axis)
        d = torch.where(labels == 0, 0.0, d)

    clipped = [(float(anisotropy[a]) * band_cap) ** 2
               for a in range(3) if shape[a] - 1 > band_cap]
    if clipped:
        bound = float(np.float32(min(clipped)))
        exact = ~((labels != 0) & (d > bound)).flatten(1).any(dim=1)
    else:
        exact = torch.ones(labels.shape[0], dtype=torch.bool, device=dev)
    return d, exact


def _masked_argmax_coords(field, mask):
    """First maximum of `field` over `mask` per lane -> (B, 3)."""
    masked = torch.where(mask, field, -INF)
    return _unravel(torch.argmax(masked.flatten(1), dim=1),
                    tuple(field.shape[1:]))


def _find_soma_root(dbf, dbf_max):
    """Per lane: the max-DBF voxel nearest the centroid of all maxima
    (reference trace.py:269-289). The centroid sums are float32, as in the
    JAX engine: exact while they stay under 2^24."""
    B = dbf.shape[0]
    shape = tuple(dbf.shape[1:])
    maxima = dbf >= _bcast(dbf_max)
    cnt = torch.clamp(maxima.flatten(1).sum(dim=1), min=1).to(torch.float32)
    d2 = None
    for a in range(3):
        c = torch.arange(shape[a], dtype=torch.float32, device=dbf.device)
        c = c.view([shape[a] if i == a else 1 for i in range(3)])
        com = torch.where(maxima, c, 0.0).flatten(1).sum(dim=1) / cnt
        t = c - com.view(B, 1, 1, 1)
        d2 = t * t if d2 is None else d2 + t * t
    d2 = torch.where(maxima, d2, INF)
    return _unravel(torch.argmin(d2.flatten(1), dim=1), shape)


def _euclid_field(fg, src, anisotropy, rounds, gate=None):
    """Geodesic euclidean field from one source voxel per lane (gated by
    the lanes' graph gates `gate`, where given). Returns (dist,
    converged)."""
    init = torch.full(fg.shape, INF, dtype=torch.float32, device=fg.device)
    init = _scatter(init, src[:, None, :], 0.0)
    return relax_rounds_batched(init, fg, None, anisotropy, rounds,
                                gate=gate)


# --------------------------------------------------------------------------- #
# One lane = one label, batched


def _trace_lanes(cc, dbf_vol, lids, offs, before, n_before, after, n_after,
                 root_in, has_root, max_paths_in, prm: dict,
                 crop_shape: Tuple[int, int, int],
                 anisotropy: Tuple[float, float, float], fix_branching: bool,
                 K: int, L: int, relax_rounds: int = RELAX_ROUNDS,
                 soma_possible: bool = True, vg_vol=None, crop_source=None,
                 has_vg: bool = False):
    """The per-label trace of the JAX engine's `_one_label`, for a batch of
    labels. Host arrays: lids (B,), offs (B, 3) crop origins, before and
    after (B, T_CAP, 3) manual targets in crop frame with counts
    n_before / n_after (B,), root_in (B, 3) with has_root (B,),
    max_paths_in (B,) (<= 0: no cap). `prm` holds the float32 TEASAR
    scalars; `vg_vol` the volume's voxel graph (int32 words) or None.
    `crop_source(offs, n_real, crop_shape)`, where given, supplies the
    lanes' crops instead of slicing `cc`/`dbf_vol`: (cc, dbf) or, with
    `has_vg`, (cc, dbf, vg), each (B,) + crop_shape.
    Returns device tensors (paths (B, K, L, 3) int64 target-first with -1
    padding, lens (B, K), n_paths (B,), overflow (B,), nc_bits (B,),
    radii (B, K, L)).

    nc_bits marks which bounded relaxation did not converge: 1 fill,
    2 probe, 4 DAF, 8 rail, 16 ball, 32 warm rail, 64 re-EDT truncated
    (a soma thicker than the band)."""
    dev = cc.device
    B = len(lids)
    shape = tuple(int(s) for s in crop_shape)
    anis = tuple(float(a) for a in anisotropy)
    r_main = int(relax_rounds)
    r_ball = max(3, r_main // 2)
    r_warm = max(2, r_main // 3)

    def t(a, dtype=torch.int64):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

    if crop_source is not None:
        got = crop_source(np.asarray(offs, dtype=np.int64), B, shape)
        if has_vg and len(got) < 3:
            raise ValueError("trace_batched: a voxel graph with a "
                             "crop_source needs (cc, dbf, vg) lane crops")
        lab = got[0].to(dev)
        dbf = got[1].to(device=dev, dtype=torch.float32)
        vg = graph_word(got[2].to(dev)) if has_vg else None
    else:
        lab = torch.zeros((B,) + shape, dtype=cc.dtype, device=dev)
        dbf = torch.zeros((B,) + shape, dtype=torch.float32, device=dev)
        # each lane's crop of the voxel graph rides with its label
        vg = (None if vg_vol is None else
              torch.zeros((B,) + shape, dtype=torch.int32, device=dev))
        for b in range(B):
            if lids[b] > 0:
                sl = tuple(slice(int(o), int(o) + s)
                           for o, s in zip(offs[b], shape))
                lab[b] = cc[sl]
                dbf[b] = dbf_vol[sl]
                if vg is not None:
                    vg[b] = vg_vol[sl]
    # the lanes' graph gates, for every relaxation of this lane set
    gate = None
    if vg is not None:
        with profiling.phase("graph_gate", dev):
            gate = graph_into(vg)
    lid = t(lids, cc.dtype)
    fg = (lab == _bcast(lid)) & _bcast(lid > 0)
    del lab
    dbf = torch.where(fg, dbf, 0.0)
    lane_active = fg.flatten(1).any(dim=1)
    dbf_max = dbf.flatten(1).amax(dim=1)
    nc_bits = torch.zeros(B, dtype=torch.int32, device=dev)

    # --- soma detection: hole fill + re-EDT (reference trace.py:104-119)
    refill = dbf_max > prm["sdt"]
    ridx = refill.nonzero()[:, 0]
    if ridx.numel():
        fg_r = fg[ridx]
        filled, conv_f = _crop_fill(fg_r, r_main)
        take = filled.flatten(1).sum(dim=1) > fg_r.flatten(1).sum(dim=1)
        dsq, edt_ok = _crop_edtsq_banded(
            filled.to(torch.uint8), anis, filled.flatten(1).all(dim=1),
            None if vg is None else vg[ridx])
        dbf1 = torch.where(filled, torch.sqrt(dsq.double()).float(), 0.0)
        fg[ridx] = torch.where(_bcast(take), filled, fg_r)
        dbf[ridx] = torch.where(_bcast(take), dbf1, dbf[ridx])
        nc_bits[ridx] |= (torch.where(conv_f, 0, 1)
                          | torch.where(edt_ok | ~take, 0, 64)).int()
        del filled, dsq, dbf1
    dbf_max = dbf.flatten(1).amax(dim=1)
    if soma_possible:
        soma_mode = dbf_max > prm["sat"]
    else:
        # the host knows every DBF max is below both thresholds
        soma_mode = torch.zeros(B, dtype=torch.bool, device=dev)
    soma_radius = torch.where(
        soma_mode, fma_f32(dbf_max, prm["sis"], prm["sic"]), 0.0)

    # --- root selection (reference trace.py:121-134)
    soma_root = _find_soma_root(dbf, dbf_max)
    first_vox = _unravel(torch.argmax(fg.flatten(1).to(torch.uint8), dim=1),
                         shape)
    d_probe, conv_p = _euclid_field(fg, first_vox, anis, r_main, gate)
    nc_bits |= torch.where(conv_p, 0, 2).int()
    auto_root = _masked_argmax_coords(
        torch.where(torch.isfinite(d_probe), d_probe, -INF), fg)
    del d_probe
    root_in = t(root_in)
    has_root = t(has_root, torch.bool)
    root = torch.where(soma_mode[:, None], soma_root,
                       torch.where(has_root[:, None], root_in, auto_root))

    # --- DAF + PDRF (reference trace.py:138-148,315-356)
    dbf_inf = torch.where(dbf == 0, INF, dbf)
    daf, conv_d = _euclid_field(fg, root, anis, r_main, gate)
    nc_bits |= torch.where(conv_d, 0, 4).int()
    daf = torch.where(torch.isfinite(daf), daf, 0.0)
    daf_target = _masked_argmax_coords(daf, fg)
    max_daf = _gather(daf, daf_target[:, None, :], 0.0)[:, 0]
    pdrf = _pdrf_kernel(dbf_inf, daf,
                        _bcast(torch.clamp(dbf_max, min=1e-30)),
                        np.float32(prm["pdrf_scale"]), prm["pdrf_exponent"],
                        _bcast(max_daf))

    # --- soma-mode root ball (reference trace.py:160-168); `valid` is
    # updated in place by the path loop, `fg` must stay
    valid = fg.clone()
    if soma_possible:
        r = fma_f32(_gather(dbf, root[:, None, :], 0.0), prm["sis"],
                    prm["sic"])
        init = torch.full(fg.shape, INF, dtype=torch.float32, device=dev)
        init = _scatter(init, root[:, None, :], -r)
        ok = _scatter(valid, root[:, None, :], True)
        bd, conv_s = _relax_where(soma_mode, init, ok, None, anis, r_ball,
                                  clamp_positive=True, conv="negative",
                                  gate=gate)
        valid = torch.where(_bcast(soma_mode), valid & ~(bd <= 0.0), valid)
        nc_bits |= torch.where(conv_s, 0, 16).int()
        del init, ok, bd
    valid_count = valid.flatten(1).sum(dim=1)

    # --- target bookkeeping: slot 0 holds either the user root (soma mode:
    # popped last, reference trace.py:121-123) or the DAF target (popped
    # first when there are no manual targets, trace.py:170-172); pops run
    # b_{nb-1}..b_0, then slot 0
    n_before = t(n_before)
    use_root_slot = soma_mode & has_root
    slot0_used = use_root_slot | (~soma_mode & (n_before == 0))
    slot0 = torch.where(use_root_slot[:, None], root_in, daf_target)
    slot0_i = slot0_used.long()
    before_ext = torch.cat((slot0[:, None, :], t(before)), dim=1)
    after = t(after)
    nb = torch.where(lane_active,
                     torch.where(slot0_used, n_before + 1, n_before), 0)
    na = torch.where(lane_active, t(n_after), 0)
    vc = torch.where(lane_active, valid_count, 0)
    mp = t(max_paths_in)
    max_paths = torch.where(mp > 0, mp, torch.clamp(vc, min=1))
    # reference compute_paths early-out (trace.py:217-218)
    blocked = (nb + na) >= max_paths

    # --- initial rails + rail distance field
    pdrf = _scatter(pdrf, root[:, None, :], 0.0)
    d0 = torch.full(fg.shape, INF, dtype=torch.float32, device=dev)
    d_rail, conv_r = relax_rounds_batched(_scatter(d0, root[:, None, :], 0.0),
                                          fg, pdrf, anis, r_main, gate=gate)
    nc_bits |= torch.where(conv_r, 0, 8).int()
    del d0

    # --- the path loop: every iteration runs the JAX body on the lanes
    # whose loop condition holds and commits only those
    paths = torch.full((B, K, L, 3), -1, dtype=torch.int64, device=dev)
    lens = torch.zeros((B, K), dtype=torch.int64, device=dev)
    k = torch.zeros(B, dtype=torch.int64, device=dev)
    ov = torch.zeros(B, dtype=torch.bool, device=dev)
    nc = torch.where(lane_active, nc_bits, 0)
    anis_t = torch.tensor(anis, dtype=torch.float32, device=dev)
    cap = torch.clamp(max_paths, max=K)
    pos = torch.arange(L, device=dev)
    # the chase's graph: no permission across the crop's edge
    vg_pad = None if vg is None else F.pad(vg, (1, 1, 1, 1, 1, 1), value=0)
    del vg
    while True:
        act = (((vc > 0) | (nb > 0) | (na > 0)) & (k < cap) & ~ov
               & (nc == 0) & ~blocked)
        a = act.nonzero()[:, 0]
        if a.numel() == 0:
            break
        vc_a, nb_a, na_a, valid_a = vc[a], nb[a], na[a], valid[a]
        use_before = nb_a > 0
        use_after = ~use_before & (vc_a == 0)
        auto_t = _masked_argmax_coords(daf[a], valid_a)
        bt = before_ext[a, torch.clamp(nb_a - slot0_i[a], min=0)]
        at = after[a, torch.clamp(na_a - 1, min=0)]
        target = torch.where(use_before[:, None], bt,
                             torch.where(use_after[:, None], at, auto_t))
        nb[a] = torch.where(use_before, nb_a - 1, nb_a)
        na[a] = torch.where(use_after, na_a - 1, na_a)

        d_pad = F.pad(d_rail[a], (1, 1, 1, 1, 1, 1), value=INF)
        gate_a = None if gate is None else gate[a]
        path, plen, reached = chase_batched(
            d_pad, target, L, None if vg_pad is None else vg_pad[a])
        del d_pad
        ov[a] = ov[a] | ~reached

        if soma_possible:
            dist = root_distance(path, root[a, None, :], anis_t)
            keep = ((dist > soma_radius[a, None])
                    | (pos == plen[:, None] - 1)) & (pos < plen[:, None])
            path = torch.where((soma_mode[a, None] & ~keep)[..., None], -1,
                               path)

        # rolling-ball invalidation (reference trace.py:253-259)
        dbf_a = dbf[a]
        radii_b = fma_f32(_gather(dbf_a, path, 0.0), prm["scale"],
                          prm["const"])
        init = torch.full(dbf_a.shape, INF, dtype=torch.float32, device=dev)
        init = _scatter(init, path, -radii_b, "amin")
        ok_inv = _scatter(valid_a, path, True)
        inv = vc_a > 0
        bd, conv_b = _relax_where(inv, init, ok_inv, None, anis, r_ball,
                                  clamp_positive=True, conv="negative",
                                  gate=gate_a)
        ball = (bd <= 0.0) & _bcast(inv)
        valid[a] = valid_a & ~ball
        vc[a] = vc_a - (ball & valid_a).flatten(1).sum(dim=1)
        nc_a = nc[a] | torch.where(conv_b, 0, 16).int()
        del dbf_a, init, ok_inv, bd, ball, valid_a

        # new rails (reference trace.py:261-263)
        if fix_branching:
            pdrf_a = _scatter(pdrf[a], path, 0.0)
            d_warm, conv_w = relax_rounds_batched(
                _scatter(d_rail[a], path, 0.0), fg[a], pdrf_a, anis, r_warm,
                gate=gate_a)
            pdrf[a] = pdrf_a
            d_rail[a] = d_warm
            nc_a = nc_a | torch.where(conv_w, 0, 32).int()
            del pdrf_a, d_warm
        nc[a] = nc_a
        ka = k[a]
        paths[a, ka] = path
        lens[a, ka] = plen
        k[a] = ka + 1

    work_left = (vc > 0) | (nb > 0) | (na > 0)
    ov = ov | (work_left & (k >= K) & (k < max_paths) & ~blocked & (nc == 0))
    radii = _gather(dbf_inf, paths.view(B, K * L, 3), 0.0).view(B, K, L)
    return paths, lens, k, ov, nc, radii


# --------------------------------------------------------------------------- #
# Host side: buckets, batches and the escalation ladder


def trace_batched(
    cc_dev,
    dbf_dev,
    jobs: List[dict],
    teasar_params: dict,
    anisotropy: Sequence[float],
    fix_branching: bool,
    voxel_graph=None,
    crop_source=None,
) -> Tuple[Dict[int, List[Tuple[np.ndarray, np.ndarray]]], List[dict]]:
    """Trace labels in device batches (counterpart of
    kimimaro_tpu.engine.trace_batched).

    cc_dev / dbf_dev: the component-id and DBF volumes on the device;
    voxel_graph: their voxel graph (uint32 or int32, on that device) or
    None. `crop_source(crop_offs (B, 3) int64, n_real, bshape)`, where
    given, returns each batch's lane crops instead of slicing the volumes
    ((cc, dbf), or (cc, dbf, vg) under a voxel graph, each (B,) +
    bshape): the multi-device path gathers them off its slabs, so
    cc_dev/dbf_dev/voxel_graph need only a `shape` and a `device`.
    jobs: [{segid, offset (3,), shape (3,), before [(x,y,z)...],
            after [...], root (x,y,z)|None, count, dbfmax}]
    Returns ({segid: [(path_vertices, path_radii), ...]}, fallback_jobs).
    Paths are rail-first int64 voxel coordinates in the job's bbox frame
    with per-vertex radii."""
    p = dict(teasar_params)
    f32 = lambda v: float(np.float32(v))  # noqa: E731
    prm = {
        "scale": f32(p.get("scale", 10)),
        "const": f32(p.get("const", 10)),
        "pdrf_scale": f32(p.get("pdrf_scale", 5000)),
        "pdrf_exponent": int(p.get("pdrf_exponent", 16)),
        "sdt": f32(p.get("soma_detection_threshold", 1100)),
        "sat": f32(p.get("soma_acceptance_threshold", 4000)),
        "sis": f32(p.get("soma_invalidation_scale", 0.5)),
        "sic": f32(p.get("soma_invalidation_const", 0)),
    }
    max_paths = p.get("max_paths", None)
    anis = tuple(float(a) for a in anisotropy)
    vol_shape = tuple(int(s) for s in cc_dev.shape)
    vg_vol = (None if voxel_graph is None or crop_source is not None
              else graph_word(voxel_graph))
    # labels whose DBF max (host-known) reaches neither threshold run
    # without the soma branches
    soma_cut = min(float(p.get("soma_detection_threshold", 1100)),
                   float(p.get("soma_acceptance_threshold", 4000)))

    def bucket_key(job):
        bshape = tuple(min(_bucket_dim(int(s)), vs)
                       for s, vs in zip(job["shape"], vol_shape))
        dmx = job.get("dbfmax")
        return bshape, (dmx is None) or (float(dmx) > soma_cut)

    buckets: Dict[tuple, List[dict]] = {}
    fallback: List[dict] = []
    for job in jobs:
        if len(job["before"]) > T_CAP or len(job["after"]) > T_CAP:
            fallback.append(job)
            continue
        key = bucket_key(job)
        # clamp the offset so the padded crop stays in bounds
        off = np.minimum(np.asarray(job["offset"], dtype=np.int64),
                         np.asarray(vol_shape) - np.asarray(key[0]))
        job = dict(job, crop_off=np.maximum(off, 0))
        buckets.setdefault(key, []).append(job)

    results: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}

    def cost(j):
        # similar-cost labels share a batch: the path loop runs to the
        # largest path count over its lanes
        cnt = j.get("count") or int(np.prod(j["shape"]))
        dmx = j.get("dbfmax")
        r_vox = (max(float(dmx) / max(min(anis), 1e-6), 1.0) if dmx
                 else 1.0)
        return (-cnt / (r_vox ** 3), -int(np.prod(j["shape"])))

    def drain(chunk, outs, retry):
        paths, lens, n_paths, overflow, nonconv, radii = outs
        header = torch.stack((n_paths, overflow.long(), nonconv.long(),
                              lens.amax(dim=1)), dim=1).cpu().numpy()
        max_n, max_l = int(header[:, 0].max()), int(header[:, 3].max())
        paths_np = paths[:, :max_n, :max_l].cpu().numpy()
        radii_np = radii[:, :max_n, :max_l].cpu().numpy()
        for j, job in enumerate(chunk):
            if header[j, 2] & 64 and not header[j, 2] & 1:
                # a truncated re-EDT of a converged (so fixed) refill is
                # truncated again at every rung: straight to the host path
                fallback.append(job)
                continue
            if header[j, 2]:  # unconverged relaxation -> escalate
                retry.append(job)
                continue
            if header[j, 1]:  # capacity overflow -> host fallback
                fallback.append(job)
                continue
            out = []
            for kk in range(int(header[j, 0])):
                row, rad = paths_np[j, kk], radii_np[j, kk]
                m = row[:, 0] >= 0
                # device rows run target -> rail; paths are rail-first,
                # in the job's bbox frame
                row = row[m][::-1] + (job["crop_off"]
                                      - np.asarray(job["offset"]))
                out.append((row, rad[m][::-1]))
            if not _paths_structurally_valid(out):
                fallback.append(job)
                continue
            results[job["segid"]] = out

    def run_pass(pass_buckets, relax_rounds):
        """Every bucket at the given sweep rounds; returns the jobs whose
        lanes flagged non-convergence."""
        retry: List[dict] = []
        for (bshape, soma), group in sorted(pass_buckets.items()):
            L = max(int(2 * sum(bshape)), 64)
            lanes = _lanes_for(bshape, len(group))
            group = sorted(group, key=cost)
            for i in range(0, len(group), lanes):
                chunk = group[i:i + lanes]
                B = len(chunk)
                bef = np.full((B, T_CAP, 3), -1, dtype=np.int64)
                aft = np.full((B, T_CAP, 3), -1, dtype=np.int64)
                roots = np.zeros((B, 3), dtype=np.int64)
                for j, job in enumerate(chunk):
                    # targets and roots arrive in the job's bbox frame; the
                    # crop starts at crop_off
                    shift = np.asarray(job["offset"]) - job["crop_off"]
                    for t_i, tgt in enumerate(job["before"]):
                        bef[j, t_i] = np.asarray(tgt) + shift
                    for t_i, tgt in enumerate(job["after"]):
                        aft[j, t_i] = np.asarray(tgt) + shift
                    if job.get("root") is not None:
                        roots[j] = np.asarray(job["root"]) + shift
                outs = _trace_lanes(
                    cc_dev, dbf_dev,
                    [int(j["segid"]) for j in chunk],
                    [j["crop_off"] for j in chunk],
                    bef, [len(j["before"]) for j in chunk],
                    aft, [len(j["after"]) for j in chunk],
                    roots, [j.get("root") is not None for j in chunk],
                    [int(max_paths) if max_paths is not None else -1] * B,
                    prm, bshape, anis, bool(fix_branching), K_CAP, L,
                    relax_rounds, soma, vg_vol, crop_source,
                    voxel_graph is not None)
                drain(chunk, outs, retry)
        return retry

    # escalation ladder: unconverged lanes re-run with doubled sweep
    # rounds; jobs still unconverged after it take the host path
    todo = buckets
    n_retried = 0
    for mult in (1, 2, 4):
        retry = run_pass(todo, RELAX_ROUNDS * mult)
        if not retry:
            break
        n_retried += len(retry)
        todo = {}
        for job in retry:
            todo.setdefault(bucket_key(job), []).append(job)
    else:
        fallback.extend(retry)
    profiling.count("relax_retries", n_retried)
    return results, fallback



def _paths_structurally_valid(path_list) -> bool:
    """TEASAR tree invariants, checked on host from fetched paths:
    every step is a 26-neighbor move, and each path's rail anchor (first
    vertex, rail-first order) lies on the tree built by earlier paths
    (the first path's anchor is the root). Catches wandering chases from
    a divergent rail field regardless of what the device kernel reported."""
    tree = None
    for verts, _ in path_list:
        if len(verts) == 0:
            continue
        steps = np.abs(np.diff(verts, axis=0))
        if steps.size and int(steps.max()) > 1:
            return False
        if tree is None:
            tree = set(map(tuple, verts.tolist()))
            continue
        if tuple(verts[0].tolist()) not in tree:
            return False
        tree.update(map(tuple, verts.tolist()))
    return True


def paths_to_skeleton(path_list, anisotropy) -> Skeleton:
    """Paths+radii -> consolidated Skeleton with reference transform
    semantics (reference trace.py:182-193)."""
    skels = []
    radii_map = {}
    for verts, rads in path_list:
        if len(verts) == 0:
            continue
        skels.append(Skeleton.from_path(verts))
        for v, r in zip(verts, rads):
            radii_map[tuple(int(c) for c in v)] = float(r)
    if not skels:
        return Skeleton()
    skel = Skeleton.simple_merge(skels).consolidate()
    if not skel.empty():
        skel.radii = np.array(
            [radii_map.get(tuple(int(c) for c in v), 0.0) for v in skel.vertices],
            dtype=np.float32,
        )
    skel.transform = np.array(
        [[anisotropy[0], 0, 0, 0],
         [0, anisotropy[1], 0, 0],
         [0, 0, anisotropy[2], 0]], dtype=np.float32)
    return skel


def paths_to_skeletons_batched(results, offsets_by_segid, anisotropy):
    """Vectorized finalize: every label's paths -> consolidated Skeleton in
    ONE set of array passes (semantics identical to per-label
    paths_to_skeleton: from_path consecutive-dup fusion, consolidate's
    first-occurrence vertex dedup in (x,y,z)-sorted order, undirected edge
    dedup, disconnected-vertex removal, last-write-wins radii — reference
    trace.py:182-193). The per-label loop cost ~2 ms x thousands of labels;
    this replaces it with ~15 numpy passes over the concatenated paths.

    results: {segid: [(verts int (P,3) in bbox frame, radii (P,)), ...]}
    offsets_by_segid: {segid: (3,) bbox offset}
    Returns {segid: Skeleton} with GLOBAL voxel vertices (not yet scaled
    to physical space; caller applies anisotropy/transform bookkeeping).
    """
    seg_list = [s for s in results if results[s]]
    if not seg_list:
        return {}
    if len(seg_list) >= (1 << 16):
        # key packing carries 16 bits of label index; huge id spaces take
        # the per-label path
        return None
    seg_index = {s: i for i, s in enumerate(seg_list)}

    vparts, rparts, sparts, pparts = [], [], [], []
    pid = 0
    for s in seg_list:
        mn = np.asarray(offsets_by_segid[s], dtype=np.int64)
        for verts, rads in results[s]:
            if len(verts) == 0:
                continue
            v = np.asarray(verts, dtype=np.int64) + mn
            vparts.append(v)
            rparts.append(np.asarray(rads, dtype=np.float32))
            sparts.append(np.full(len(v), seg_index[s], dtype=np.int64))
            pparts.append(np.full(len(v), pid, dtype=np.int64))
            pid += 1
    if not vparts:
        return {}

    V = np.concatenate(vparts)          # (T, 3) global voxel coords
    R = np.concatenate(rparts)          # (T,)
    S = np.concatenate(sparts)          # (T,) label index
    P = np.concatenate(pparts)          # (T,) path id

    # from_path: fuse consecutive duplicates within a path (keep the raw
    # arrays too — reference radii are last-write-wins over the RAW
    # stream, including occurrences the fusion drops)
    V_raw, R_raw, S_raw = V, R, S
    keep = np.ones(len(V), dtype=bool)
    keep[1:] = (P[1:] != P[:-1]) | np.any(V[1:] != V[:-1], axis=1)
    V, R, S, P = V[keep], R[keep], S[keep], P[keep]
    T = len(V)

    def pack(Sa, Va):
        # vertex dedup key per (label, voxel): coords < 2^16 per axis and
        # label index < 2^16 by construction of seg_list chunking upstream
        return ((Sa.astype(np.uint64) << 48)
                | (Va[:, 0].astype(np.uint64) << 32)
                | (Va[:, 1].astype(np.uint64) << 16)
                | Va[:, 2].astype(np.uint64))

    key = pack(S, V)
    order = np.argsort(key, kind="stable")
    ks = key[order]
    is_new = np.ones(T, dtype=bool)
    is_new[1:] = ks[1:] != ks[:-1]
    gid_sorted = np.cumsum(is_new) - 1
    n_groups = int(gid_sorted[-1]) + 1
    gid = np.empty(T, dtype=np.int64)
    gid[order] = gid_sorted

    # group -> representative (first occurrence in fused order)
    rep = np.full(n_groups, np.iinfo(np.int64).max, dtype=np.int64)
    np.minimum.at(rep, gid, np.arange(T, dtype=np.int64))

    # last-write radii over the RAW stream (every raw key exists in the
    # fused set, so the searchsorted is an exact match)
    uniq_keys = ks[is_new]
    raw_gid = np.searchsorted(uniq_keys, pack(S_raw, V_raw))
    last_raw = np.zeros(n_groups, dtype=np.int64)
    np.maximum.at(last_raw, raw_gid, np.arange(len(V_raw), dtype=np.int64))

    g_verts = V[rep]
    g_radii = R_raw[last_raw]
    g_seg = S[rep]

    # edges: consecutive path vertices, undirected, deduped
    same_path = P[1:] == P[:-1]
    e0 = gid[:-1][same_path]
    e1 = gid[1:][same_path]
    lo = np.minimum(e0, e1)
    hi = np.maximum(e0, e1)
    ekey = lo.astype(np.uint64) * np.uint64(n_groups) + hi.astype(np.uint64)
    ekey = np.unique(ekey)
    lo = (ekey // np.uint64(n_groups)).astype(np.int64)
    hi = (ekey % np.uint64(n_groups)).astype(np.int64)

    # disconnected-vertex removal + final per-group local ids. Groups are
    # already ordered by (label, x, y, z) — consolidate's output order.
    used = np.zeros(n_groups, dtype=bool)
    used[lo] = True
    used[hi] = True
    final_id = np.cumsum(used) - 1
    # per-label base offset of the local numbering
    kept_seg = g_seg[used]
    kept_verts = g_verts[used].astype(np.float32)
    kept_radii = g_radii[used]
    n_kept = len(kept_seg)
    seg_starts = np.searchsorted(kept_seg, np.arange(len(seg_list)))
    seg_ends = np.searchsorted(kept_seg, np.arange(len(seg_list)),
                               side="right")

    local = final_id - seg_starts[g_seg]
    elo = local[lo].astype(np.uint32)
    ehi = local[hi].astype(np.uint32)
    eseg = g_seg[lo]
    eorder = np.argsort(eseg, kind="stable")
    elo, ehi, eseg = elo[eorder], ehi[eorder], eseg[eorder]
    es_starts = np.searchsorted(eseg, np.arange(len(seg_list)))
    es_ends = np.searchsorted(eseg, np.arange(len(seg_list)), side="right")

    anisotropy = np.asarray(anisotropy, dtype=np.float32)
    transform = np.array(
        [[anisotropy[0], 0, 0, 0],
         [0, anisotropy[1], 0, 0],
         [0, 0, anisotropy[2], 0]], dtype=np.float32)

    out = {}
    for s, i in seg_index.items():
        v0, v1 = int(seg_starts[i]), int(seg_ends[i])
        if v1 <= v0:
            continue
        e0_, e1_ = int(es_starts[i]), int(es_ends[i])
        skel = Skeleton(
            kept_verts[v0:v1],
            np.stack([elo[e0_:e1_], ehi[e0_:e1_]], axis=1),
            kept_radii[v0:v1],
            segid=s,
        )
        skel.transform = transform.copy()
        out[s] = skel
    return out
