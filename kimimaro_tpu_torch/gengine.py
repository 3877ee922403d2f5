"""Global trace engine: every label's TEASAR trace in full-volume passes.

Torch counterpart of kimimaro_tpu.gengine. Connected components PARTITION
the foreground, so:

  * every geodesic field of the TEASAR pipeline (root probe, DAF, PDRF
    rail distance, rolling-ball invalidation) is computed for ALL labels
    at once as ONE cc-masked relaxation over the full volume (ops.gsweep,
    kernels B1 and B2);
  * per-label argmax/target selection reduces each label's bbox inside a
    fixed-shape crop around it (ops.crop_argmax, kernel B3, one call for
    all tiers): flat-index argmax order inside any containing box equals
    global (x,y,z)-lex order;
  * all labels chase their paths simultaneously on a per-voxel descent
    code of the shared rail field;
  * the path loop advances in lock-step iterations: iteration k runs path
    k of every still-active label.

Labels the global pass cannot hold (bbox exceeding the largest crop tier,
soma candidates, manual-target overflow) and labels whose fields did not
converge within the escalation budget are handed back to the caller.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .engine import _paths_structurally_valid
from .ops import gsweep
from .ops.chase import RELAX_ROUNDS
from .ops.crop_argmax import crop_argmax
from .ops.fma import fma_f32
from .ops.stencils import pad_const
from .trace import integer_pow, pow_1_01
from .utils import profiling

INF = float("inf")
NEG_INF = float("-inf")

T_CAP = 16     # manual-target slots per label
K_ITER = 24    # lock-step path iterations per path-buffer segment
MAX_SEGS = 16  # segments before the remaining actives are handed back
# Selective bail (kimimaro_tpu.gengine's defaults): with more than
# BAIL_MIN_LIVE live labels, once an iteration has BAIL_ACTIVE or fewer
# labels active, the labels still active after the next one leave for
# the crop engine (a lock-step iteration sweeps the full volume however
# few labels remain). Only labels whose gather crop fits BAIL_CROP a
# side may leave; if the others' crops fill BAIL_KEEP_FRAC of the volume
# or more, the small ones leave, once, and the others keep iterating.
BAIL_ACTIVE = 100
BAIL_MIN_LIVE = 500
BAIL_CROP = 128
BAIL_KEEP_FRAC = 0.25
EXTRA_ROUND_STAGES = 3  # escalation stages before a label is tainted
EXTRA_ROUNDS = 4        # rounds per escalation stage
_CHASE_CHECK = 16       # chase steps between all-lanes-done checks

# Gather-crop menu (per-axis extents, clamped to the volume). Labels land
# in the smallest tier whose crop holds their bbox; larger bboxes are
# handed back.
G_CROP_MENU = (16, 32, 48, 64, 96, 128, 192, 256, 384)


def _tier_crops(vol_shape) -> List[Tuple[int, int, int]]:
    """The gather-crop tiers for this volume: menu entries clamped
    per-axis, deduplicated (small volumes collapse to fewer tiers)."""
    crops: List[Tuple[int, int, int]] = []
    for m in G_CROP_MENU:
        c = tuple(int(min(m, int(s))) for s in vol_shape)
        if not crops or c != crops[-1]:
            crops.append(c)
    return crops


def _lane_bucket(n: int) -> int:
    """Lane counts quantize to powers of two (min 4)."""
    if n <= 4:
        return 4
    return 1 << (n - 1).bit_length()


# --------------------------------------------------------------------------- #
# device helpers


def _grouped_argmax(packed, cc, offs, lids, crops, boxes):
    """Per-label argmax over the lanes of every tier in one B3 call.
    crops: (N, 3) each lane's tier crop (its window is [off, off + crop));
    boxes: (origin, size) of what each lane scans inside its window, the
    label's bbox, or size 0 for a lane with nothing to scan (it answers
    -inf at its window origin, like a lane whose label holds only -inf).
    Returns (coords (N, 3) global int32, values (N,))."""
    return crop_argmax(packed, cc, offs, lids, crops, boxes)


def _lanes_touched(mask, cc, lids, live):
    """Per-lane any() of a voxel change mask: cc partitions the
    foreground, so the label owning a changed voxel is the only label the
    change can affect. Returns a host bool array."""
    ids = torch.unique(cc[mask])
    return profiling.host(torch.isin(lids, ids)).numpy() & live


def _scatter_min(vol, flat_idx, src):
    """A copy of `vol` with vol[flat_idx] = min(vol[flat_idx], src)."""
    out = vol.clone()
    out.view(-1).scatter_reduce_(0, flat_idx, src, "amin")
    return out


def _flat(coords, vol_shape):
    return (coords[:, 0].long() * (vol_shape[1] * vol_shape[2])
            + coords[:, 1].long() * vol_shape[2] + coords[:, 2].long())


def _sources(vol_shape, flat_idx, device):
    """+inf volume with zeros at the given flat indices."""
    d0 = torch.full(vol_shape, INF, dtype=torch.float32, device=device)
    d0.view(-1)[flat_idx] = 0.0
    return d0


def _descent_code(d_rail, cc):
    """Per-voxel descent byte: (first-min neighbour index k in [0,27) << 1)
    | (d_rail <= 0). The argmin runs over the 27-window in lexicographic
    offset order, centre +inf, cross-label neighbours +inf."""
    X, Y, Z = d_rail.shape
    dp = pad_const(d_rail, 1, INF)
    cp = pad_const(cc, 1, -1)
    best = torch.full_like(d_rail, INF)
    bestk = torch.zeros(d_rail.shape, dtype=torch.uint8, device=d_rail.device)
    k = 0
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dz in (-1, 0, 1):
                if dx == 0 and dy == 0 and dz == 0:
                    k += 1
                    continue
                sl = (slice(1 + dx, 1 + dx + X), slice(1 + dy, 1 + dy + Y),
                      slice(1 + dz, 1 + dz + Z))
                v = torch.where(cp[sl] == cc, dp[sl], INF)
                take = v < best
                best = torch.where(take, v, best)
                bestk = torch.where(take, k, bestk).to(torch.uint8)
                k += 1
    return (bestk << 1) | (d_rail <= 0.0).to(torch.uint8)


def _chase_codes(code_flat, starts, L: int, vol_shape, active):
    """All active lanes chase their paths at once on the descent-code
    volume: per step each lane reads ONE byte and moves by the decoded
    offset until it stands on a rail. Returns (flat_path (N, L) int32 with
    -1 padding, plen (N,), reached (N,)); inactive lanes do not move and
    report plen 0."""
    sy = vol_shape[1] * vol_shape[2]
    sz = vol_shape[2]
    deltas = torch.tensor(
        [dx * sy + dy * sz + dz
         for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)],
        dtype=torch.int64, device=code_flat.device)
    size = code_flat.numel()
    cur = _flat(starts, vol_shape)
    N = cur.shape[0]
    path = torch.full((N, L), -1, dtype=torch.int32, device=code_flat.device)
    plen = torch.zeros(N, dtype=torch.int64, device=code_flat.device)
    done = ~active
    for t in range(L):
        act = ~done
        path[:, t] = torch.where(act, cur, -1).to(torch.int32)
        c = code_flat[cur]
        at_rail = (c & 1) == 1
        nxt = torch.clamp(cur + deltas[(c >> 1).long()], 0, size - 1)
        cur = torch.where(act & ~at_rail, nxt, cur)
        plen = plen + act.to(torch.int64)
        done = done | at_rail
        if (t % _CHASE_CHECK == _CHASE_CHECK - 1
                and profiling.host(done.all(), bool)):
            break
    return path, plen, done


# --------------------------------------------------------------------------- #
# phases


def _probe_phase(cc_v, src_flat, anisotropy, rounds):
    d0 = _sources(cc_v.x.shape, src_flat, cc_v.x.device)
    return gsweep.relax_full(d0, cc_v, None, None, anisotropy, rounds,
                             mode="euclid")


def _root_daf_phase(probe, cc_v, offs, lids, roots_in, has_root, live_d,
                    crops, boxes, anisotropy, rounds):
    """Auto roots from the probe field, then the DAF relaxation."""
    packed = torch.where(torch.isfinite(probe), probe, NEG_INF)
    auto_root, _ = _grouped_argmax(packed, cc_v.x, offs, lids, crops, boxes)
    roots = torch.where(has_root[:, None], roots_in, auto_root)
    live_roots = profiling.host(live_d, lambda m: roots[m])
    d0 = _sources(probe.shape, _flat(live_roots, probe.shape), probe.device)
    daf, mask = gsweep.relax_full(d0, cc_v, None, None, anisotropy, rounds,
                                  mode="euclid")
    return roots, daf, mask


def _broadcast_phase(daf, dbf, cc_v, anisotropy, rounds):
    """Per-label scalar broadcasts as maxflood sweeps: per-voxel label-max
    of dbf^1.01 (the PDRF M term) and of DAF (the normalization term), in
    one fused two-field relax."""
    fg = cc_v.x > 0
    daf = torch.where(torch.isfinite(daf), daf, 0.0)
    dbfp = torch.where(fg, pow_1_01(dbf), NEG_INF)
    d0 = torch.where(fg, daf, NEG_INF)
    (m_fl, d_fl), (mask_m, mask_d) = gsweep.relax_full_dual(
        dbfp, d0, cc_v, None, None, anisotropy, rounds, kind="max2")
    return daf, m_fl, mask_m, d_fl, mask_d


def pdrf_terms(dbf_inf, daf, m, imd, pdrf_scale, pdrf_exponent: int):
    """The global engine's PDRF = pdrf_scale * (1 - DBF*m)^exponent +
    DAF*imd from its broadcast terms, m = 1/max(dbf^1.01) and imd =
    1/max(DAF) over the voxel's label. XLA fuses 1 - dbf*m, and the sum
    of two products with the DAF term as the fused product."""
    p = fma_f32(dbf_inf, m, 1.0, negate=True)
    e = int(pdrf_exponent)
    p = integer_pow(p, e) if e > 0 else torch.ones_like(p)
    return fma_f32(daf, imd, p * float(np.float32(pdrf_scale)))


def pdrf_kernel(dbf_inf, daf, dbf_max, pdrf_scale, pdrf_exponent: int,
                max_daf):
    """The global engine's PDRF of one label (or one per lane) from the
    label's maxima, in the signature of trace._pdrf_kernel: the crop
    engine and the host trace path round the PDRF otherwise, as the JAX
    package's do, and computing theirs with this one lets their skeletons
    be held against the global engine's."""
    dev = dbf_inf.device
    m = torch.reciprocal(torch.clamp(pow_1_01(torch.as_tensor(
        dbf_max, dtype=torch.float32, device=dev)), min=1e-30))
    imd = torch.where(max_daf > 0,
                      torch.reciprocal(torch.clamp(max_daf, min=1e-30)), 0.0)
    return pdrf_terms(dbf_inf, daf, m, imd, pdrf_scale, pdrf_exponent)


def _pdrf_rail_phase(daf, dbf, m_fl, d_fl, cc_v, roots_flat, pdrf_scale,
                     anisotropy, rounds, pdrf_exponent):
    """PDRF from the DBF + DAF and the initial rail field. m_fl / d_fl are
    the broadcast maxflood volumes (label-max of dbf^1.01 and DAF)."""
    fg = cc_v.x > 0
    m_vol = torch.where(fg, torch.reciprocal(torch.clamp(m_fl, min=1e-30)),
                        0.0)
    imd_vol = torch.where(d_fl > 0,
                          torch.reciprocal(torch.clamp(d_fl, min=1e-30)), 0.0)
    dbf_inf = torch.where(dbf == 0, INF, dbf)
    pdrf = pdrf_terms(dbf_inf, daf, m_vol, imd_vol, pdrf_scale,
                      pdrf_exponent)
    pdrf = torch.where(fg, pdrf, INF)
    # PDRF is non-negative, so a scatter-min of 0 is the root zeroing
    pdrf = _scatter_min(pdrf, roots_flat,
                        torch.zeros_like(roots_flat, dtype=torch.float32))
    d0 = _sources(dbf.shape, roots_flat, dbf.device)
    d_rail, mask = gsweep.relax_full(d0, cc_v, gsweep.MaskViews(pdrf), None,
                                     anisotropy, rounds, mode="node")
    return pdrf, d_rail, mask


def _iteration(st, it, it_w, daf, dbf, cc_v, offs, lids, roots,
               before_stack, after_stack, max_paths_arr, scale, const,
               crops, boxes, anisotropy, rounds, fix_branching, L):
    """One lock-step path iteration for every still-active label:
    target -> chase -> rolling-ball invalidation -> rail rezero + warm
    re-relax. `st` holds the loop state (valid, pdrf, d_rail, nb, na,
    done, path_buf, len_buf) and is updated in place. `it` is the global
    path index (max_paths accounting), `it_w` the row of the segment's
    path buffer. Returns (n_active, ball_mask, rail_mask); the masks cover
    what still changed past the escalation budget (rail_mask is None
    without fix_branching)."""
    vol_shape = tuple(daf.shape)
    valid, pdrf, d_rail = st["valid"], st["pdrf"], st["d_rail"]
    nb, na, done = st["nb"], st["na"], st["done"]
    N = lids.shape[0]
    cc_x = cc_v.x

    # --- target selection. A done lane scans nothing: `done` is sticky
    # and masks everything its target and value feed (`active`)
    packed = torch.where(valid != 0, daf, NEG_INF)
    box_off, box_size = boxes
    auto_t, am_val = _grouped_argmax(
        packed, cc_x, offs, lids, crops,
        (box_off, torch.where(done[:, None], 0, box_size)))
    has_valid = am_val > NEG_INF

    use_before = nb > 0
    use_after = (~use_before) & (~has_valid) & (na > 0)
    lanes = torch.arange(N, device=nb.device)
    bt = before_stack[lanes, torch.clamp(nb - 1, min=0).long()]
    at = after_stack[lanes, torch.clamp(na - 1, min=0).long()]
    target = torch.where(use_before[:, None], bt,
                         torch.where(use_after[:, None], at, auto_t))

    work = has_valid | (nb > 0) | (na > 0)
    active = work & (~done) & (it < max_paths_arr)
    nb = torch.where(active & use_before, nb - 1, nb)
    na = torch.where(active & use_after, na - 1, na)

    # --- chase on the shared rail field
    code = _descent_code(d_rail, cc_x)
    path_flat, plen, reached = _chase_codes(code.reshape(-1), target, L,
                                            vol_shape, active)
    overflow = active & (~reached)
    plen = torch.where(active, plen, 0)
    pmask = ((torch.arange(L, device=plen.device)[None, :] < plen[:, None])
             & active[:, None])
    sel = profiling.host(pmask, lambda m: path_flat[m]).long()

    # --- rolling-ball invalidation
    radii = fma_f32(dbf.reshape(-1)[sel], scale, const)
    ball0 = _scatter_min(
        torch.full(vol_shape, INF, dtype=torch.float32, device=daf.device),
        sel, -radii)
    ok = valid.clone()
    ok.view(-1)[sel] = 1
    ok_v = gsweep.MaskViews(ok)
    if fix_branching:
        # new rails: the path rezeroes run first (they do not depend on the
        # ball), then ONE dual-field escalated relax covers ball and rail
        zeros = torch.zeros(sel.shape, dtype=torch.float32,
                            device=sel.device)
        pdrf = _scatter_min(pdrf, sel, zeros)
        d_rail = _scatter_min(d_rail, sel, zeros)
        (ball_d, d_rail), (ball_mask, rail_mask) = \
            gsweep.relax_escalated_dual(
                ball0, d_rail, cc_v, gsweep.MaskViews(pdrf), ok_v,
                anisotropy, rounds, kind="ball_rail",
                extra_stages=EXTRA_ROUND_STAGES, extra_rounds=EXTRA_ROUNDS)
    else:
        ball_d, ball_mask = gsweep.relax_escalated(
            ball0, cc_v, None, ok_v, anisotropy, rounds, mode="euclid",
            clamp_positive=True, conv="negative",
            extra_stages=EXTRA_ROUND_STAGES, extra_rounds=EXTRA_ROUNDS)
        rail_mask = None
    valid = torch.where(ball_d <= 0.0, 0, valid).to(torch.uint8)

    # --- bookkeeping
    st["path_buf"][it_w] = path_flat
    st["len_buf"][it_w] = torch.stack(
        [plen, active.to(torch.int64), overflow.to(torch.int64)],
        dim=-1).to(torch.int16)
    st.update(valid=valid, pdrf=pdrf, d_rail=d_rail, nb=nb, na=na,
              done=done | (~work) | overflow)
    return profiling.host(active.sum(), int), ball_mask, rail_mask


def _drain(path_buf, dbf, gather_idx):
    """Gather finished path rows (flat voxel indices) and their radii."""
    flat = path_buf.reshape(-1)[gather_idx].long()
    return flat, dbf.reshape(-1)[flat]


# --------------------------------------------------------------------------- #
# host driver


def trace_global(
    cc_dev: torch.Tensor,
    dbf_dev: torch.Tensor,
    jobs: List[dict],
    teasar_params: dict,
    anisotropy: Sequence[float],
    fix_branching: bool,
    firstvox_arr: Optional[np.ndarray] = None,
) -> Tuple[Dict[int, List[Tuple[np.ndarray, np.ndarray]]], List[dict]]:
    """Run eligible labels through the global engine.

    cc_dev: compact int32 component ids; dbf_dev: float32 DBF, both on the
    working device; firstvox_arr: (n_ids, 3) each component's
    lexicographically first voxel, or None to find them here
    (`_first_voxels`). Returns ({segid: [(verts, radii),
    ...]}, leftover_jobs): path vertices in the job's bbox frame,
    rail-first. Leftover jobs (ineligible or tainted labels) are for the
    caller to trace otherwise.
    """
    p = dict(teasar_params)
    scale = float(np.float32(p.get("scale", 10)))
    const = float(np.float32(p.get("const", 10)))
    pdrf_scale = float(p.get("pdrf_scale", 5000))
    pdrf_exponent = int(p.get("pdrf_exponent", 16))
    sdt = float(p.get("soma_detection_threshold", 1100))
    sat = float(p.get("soma_acceptance_threshold", 4000))
    max_paths = p.get("max_paths", None)
    anis = tuple(float(a) for a in anisotropy)
    soma_cut = min(sdt, sat)
    device = cc_dev.device
    vol_shape = tuple(int(s) for s in cc_dev.shape)

    # --- eligibility split
    eligible: List[dict] = []
    leftover: List[dict] = []
    for job in jobs:
        dmx = job.get("dbfmax")
        soma_possible = (dmx is None) or (float(dmx) > soma_cut)
        n_b, n_a = len(job["before"]), len(job["after"])
        blocked = (max_paths is not None) and (n_b + n_a) >= int(max_paths)
        if soma_possible or n_b > T_CAP or n_a > T_CAP or blocked:
            leftover.append(job)
        else:
            eligible.append(job)

    tiers = _tier_crops(vol_shape)
    crop_max = tiers[-1]

    def fits(job, crop):
        return all(int(s) <= c for s, c in zip(job["shape"], crop))

    refit = [j for j in eligible if not fits(j, crop_max)]
    leftover.extend(refit)
    eligible = [j for j in eligible if fits(j, crop_max)]

    if len(eligible) < 2:
        # the global fixed cost only pays for itself across many labels
        return {}, leftover + eligible

    # each label lands in the smallest tier whose crop holds its bbox; each
    # tier's lane count pads to a power of two (None rows are padding)
    by_tier: List[List[dict]] = [[] for _ in tiers]
    for j in eligible:
        for t, c in enumerate(tiers):
            if fits(j, c):
                by_tier[t].append(j)
                break
    groups = []
    lane_jobs: List[Optional[dict]] = []
    for t, c in enumerate(tiers):
        b = _lane_bucket(len(by_tier[t]))
        start = len(lane_jobs)
        lane_jobs.extend(by_tier[t])
        lane_jobs.extend([None] * (b - len(by_tier[t])))
        groups.append((start, start + b, c))

    N = len(lane_jobs)
    n_live = sum(1 for j in lane_jobs if j is not None)
    live = np.array([j is not None for j in lane_jobs])
    L = max(2 * sum(crop_max), 64)
    r_main = RELAX_ROUNDS
    # rounds of the per-iteration ball and rail relaxes (one fused relax
    # when fix_branching; the JAX package's r_ball and r_warm, both 3)
    r_iter = max(3, r_main // 2)

    # --- host-side job arrays (global frame)
    lids = np.zeros(N, dtype=np.int32)
    offs = np.zeros((N, 3), dtype=np.int32)
    roots_in = np.zeros((N, 3), dtype=np.int32)
    has_root = np.zeros(N, dtype=bool)
    before_stack = np.zeros((N, T_CAP, 3), dtype=np.int32)
    nb0 = np.zeros(N, dtype=np.int32)
    after_stack = np.zeros((N, T_CAP, 3), dtype=np.int32)
    na0 = np.zeros(N, dtype=np.int32)
    # unlimited by default; the real bound is MAX_SEGS buffer segments
    max_paths_arr = np.full(N, 1 << 30, dtype=np.int32)
    job_off = np.zeros((N, 3), dtype=np.int64)
    # what a lane's argmax scans: its label's bbox (nothing on padding rows)
    box_size = np.zeros((N, 3), dtype=np.int32)
    crop_of = np.empty((N, 3), dtype=np.int64)
    for (a, b, c) in groups:
        crop_of[a:b] = np.asarray(c)
    for i, job in enumerate(lane_jobs):
        if job is None:
            continue
        lids[i] = job["segid"]
        mn = np.asarray(job["offset"], dtype=np.int64)
        job_off[i] = mn
        box_size[i] = np.asarray(job["shape"], dtype=np.int64)
        offs[i] = np.maximum(np.minimum(mn, np.asarray(vol_shape) - crop_of[i]),
                             0)
        for t_i, t in enumerate(job["before"]):
            before_stack[i, t_i] = np.asarray(t, dtype=np.int64) + mn
        nb0[i] = len(job["before"])
        for t_i, t in enumerate(job["after"]):
            after_stack[i, t_i] = np.asarray(t, dtype=np.int64) + mn
        na0[i] = len(job["after"])
        if job.get("root") is not None:
            roots_in[i] = np.asarray(job["root"], dtype=np.int64) + mn
            has_root[i] = True
        if max_paths is not None:
            max_paths_arr[i] = int(max_paths)

    # first foreground voxel per label (lexicographic min = the crop
    # engine's argmax(fg.ravel()) in any containing crop)
    if firstvox_arr is None:
        flat_first = profiling.host(
            _first_voxels(cc_dev, int(np.max(lids)) + 1))
        firstvox = np.stack(np.unravel_index(
            np.minimum(flat_first.numpy()[lids], int(np.prod(vol_shape)) - 1),
            vol_shape), axis=-1)
    else:
        firstvox = firstvox_arr[lids]
    firstvox = np.where(live[:, None], firstvox, 0).astype(np.int64)

    def dev(a):
        return torch.as_tensor(a, device=device)

    cc_v = gsweep.MaskViews(cc_dev.to(torch.int32))
    dbf = dbf_dev.to(torch.float32)
    lids_d, offs_d, live_d = dev(lids), dev(offs), dev(live)
    crops_d = dev(crop_of.astype(np.int32))
    boxes_d = (dev(job_off.astype(np.int32)), dev(box_size))
    live_idx = np.flatnonzero(live)
    setup_taint = np.zeros(N, dtype=bool)

    def _continue_until(field, mask, mode="euclid", nodecost=None):
        """Escalate an unconverged setup relax; labels still changing
        afterwards are tainted individually (cc masking means an
        unconverged label corrupts only itself)."""
        nc_v = None if nodecost is None else gsweep.MaskViews(nodecost)
        stages = 0
        while (profiling.host(mask.any(), bool)
               and stages < EXTRA_ROUND_STAGES):
            field, mask = gsweep.relax_full(field, cc_v, nc_v, None, anis,
                                            EXTRA_ROUNDS, mode=mode)
            stages += 1
        if profiling.host(mask.any(), bool):
            setup_taint[:] |= _lanes_touched(mask, cc_v.x, lids_d, live)
        return field

    # --- setup fields
    with profiling.phase("gengine_setup", device):
        probe, mask = _probe_phase(
            cc_v, dev(np.ravel_multi_index(tuple(firstvox[live_idx].T),
                                           vol_shape)), anis, r_main)
        probe = _continue_until(probe, mask)

        roots, daf, mask = _root_daf_phase(
            probe, cc_v, offs_d, lids_d, dev(roots_in), dev(has_root),
            live_d, crops_d, boxes_d, anis, r_main)
        daf = _continue_until(daf, mask)
        del probe

        daf, m_fl, mask_m, d_fl, mask_d = _broadcast_phase(
            daf, dbf, cc_v, anis, r_main)
        m_fl = _continue_until(m_fl, mask_m, mode="maxflood")
        d_fl = _continue_until(d_fl, mask_d, mode="maxflood")

        roots_flat = _flat(profiling.host(live_d, lambda m: roots[m]),
                           vol_shape)
        pdrf, d_rail, mask = _pdrf_rail_phase(
            daf, dbf, m_fl, d_fl, cc_v, roots_flat, pdrf_scale, anis, r_main,
            pdrf_exponent)
        del m_fl, d_fl
        d_rail = _continue_until(d_rail, mask, mode="node", nodecost=pdrf)

    # --- lock-step path loop (segmented path buffers)
    st = dict(
        valid=(cc_v.x > 0).to(torch.uint8), pdrf=pdrf, d_rail=d_rail,
        nb=dev(nb0), na=dev(na0),
        # tainted labels and dead padding lanes skip the loop
        done=dev(setup_taint | ~live),
    )
    before_d, after_d, mp_d = dev(before_stack), dev(after_stack), \
        dev(max_paths_arr)

    bail_n = BAIL_ACTIVE if n_live > BAIL_MIN_LIVE else 0
    bail_ok = live & np.all(crop_of <= BAIL_CROP, axis=1)
    taint_bail = np.zeros(N, dtype=bool)
    bailed = purged = False

    taint_nc = np.zeros(N, dtype=bool)
    t_overflow = np.zeros(N, dtype=bool)
    per_lane: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    last_actives = np.zeros((K_ITER, N), dtype=bool)

    def _drain_segment():
        """Fetch a segment's finished paths into per_lane. Tainted lanes
        are dropped at final assembly: a taint found in a LATER segment
        must still discard the lane's earlier rows."""
        lens = profiling.host(st["len_buf"]).numpy()  # (K_ITER, N, 3)
        plens = lens[:, :, 0].astype(np.int64)
        actives = lens[:, :, 1].astype(bool)
        t_overflow[:] |= lens[:, :, 2].astype(bool).any(axis=0) & live
        keep = actives & (plens > 0)
        keep[:, ~live] = False
        idx_list, meta = [], []
        for r in range(K_ITER):
            for lane in np.nonzero(keep[r])[0]:
                ln = int(plens[r, lane])
                base = (r * N + lane) * L
                idx_list.append(np.arange(base, base + ln, dtype=np.int64))
                meta.append((lane, ln))
        if idx_list:
            flat, radii = _drain(st["path_buf"], dbf,
                                 dev(np.concatenate(idx_list)))
            flat = profiling.host(flat).numpy()
            radii = profiling.host(radii).numpy()
            pos = 0
            for (lane, ln) in meta:
                f = flat[pos: pos + ln]
                rr = radii[pos: pos + ln]
                pos += ln
                verts = np.stack(np.unravel_index(f, vol_shape), axis=-1)
                # buffer rows run target->rail; paths are rail-first
                verts = verts[::-1] - job_off[lane]
                per_lane.setdefault(lane, []).append(
                    (verts.astype(np.int64), rr[::-1]))
        return actives

    it = 0
    seg = 0
    seg_rows = 0
    n_act = -1
    with profiling.phase("gengine_loop", device):
        while True:
            st["path_buf"] = torch.full((K_ITER, N, L), -1, dtype=torch.int32,
                                        device=device)
            st["len_buf"] = torch.zeros((K_ITER, N, 3), dtype=torch.int16,
                                        device=device)
            seg_rows = 0
            for it_w in range(K_ITER):
                n_prev = n_act
                n_act, ball_mask, rail_mask = _iteration(
                    st, it, it_w, daf, dbf, cc_v, offs_d, lids_d, roots,
                    before_d, after_d, mp_d, scale, const, crops_d, boxes_d,
                    anis, r_iter, bool(fix_branching), L)
                it += 1
                seg_rows = it_w + 1
                # taint labels whose ball/rail relax still changed past
                # the escalation budget
                for m in (ball_mask, rail_mask):
                    if m is not None and profiling.host(m.any(), bool):
                        taint_nc[:] |= _lanes_touched(m, cc_v.x, lids_d,
                                                      live)
                # the bail reads the previous iteration's active count in
                # this segment and the labels still active after this one,
                # as kimimaro_tpu.gengine's pipelined loop does: it lands
                # each iteration's count while the next one runs
                if (bail_n and not purged and it_w >= 1 and it >= 3
                        and n_prev <= bail_n):
                    act = live & ~profiling.host(st["done"]).numpy()
                    bigs = act & ~bail_ok
                    big_vol = float(np.prod(crop_of[bigs], axis=1).sum())
                    if big_vol < BAIL_KEEP_FRAC * float(np.prod(vol_shape)):
                        bailed = True
                        break
                    purged = True
                    smalls = act & bail_ok
                    taint_bail |= smalls
                    st["done"] = st["done"] | dev(smalls)
                if n_act == 0:
                    break
            last_actives = _drain_segment()
            if n_act == 0 or bailed:
                break
            seg += 1
            if seg >= MAX_SEGS:
                break
    profiling.count("gengine_iterations", it)

    # the labels handed back for capacity are counted apart
    t_capacity = taint_bail & live
    if bailed or n_act > 0:
        # still active when the loop stopped (bail or MAX_SEGS exhausted)
        t_capacity |= last_actives[max(seg_rows, 1) - 1] & live
    tainted = (setup_taint | taint_nc | t_overflow) & live | t_capacity

    # --- final assembly
    results: Dict[int, List[Tuple[np.ndarray, np.ndarray]]] = {}
    for lane, paths in per_lane.items():
        if tainted[lane] or lane_jobs[lane] is None:
            continue
        if not _paths_structurally_valid(paths):
            tainted[lane] = True
            continue
        results[int(lids[lane])] = paths
    for n_i in np.nonzero(tainted)[0]:
        if lane_jobs[n_i] is None:
            continue
        results.pop(int(lids[n_i]), None)
        leftover.append(lane_jobs[n_i])

    n_tainted = int((tainted & live).sum())
    profiling.count("gengine_jobs", n_live - n_tainted)
    profiling.count("gengine_fallback", n_tainted)
    profiling.count("gengine_taint_capacity", int(t_capacity.sum()))
    return results, leftover


def _first_voxels(cc_dev: torch.Tensor, n_ids: int) -> torch.Tensor:
    """Per-label minimum flat index (the lexicographically first voxel) of
    ids 0..n_ids-1, by a scatter-min of the flat indices; ids absent from
    the volume get the voxel count (kimimaro_tpu.gengine._first_voxels)."""
    flat = cc_dev.reshape(-1).long()
    n = flat.numel()
    out = torch.full((n_ids,), n, dtype=torch.int64, device=cc_dev.device)
    keep = flat < n_ids
    return out.scatter_reduce_(
        0, flat[keep], torch.arange(n, device=cc_dev.device)[keep], "amin")
