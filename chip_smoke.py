#!/usr/bin/env python3
"""Smoke run of kimimaro_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: the card's name and power limit;
  2. build: the CUDA kernels from kimimaro_tpu_torch/csrc (nvcc, sm_90a);
  3. kernels: each kernel (B1-B5, F1) against its plain torch version on
     the card, bit for bit, at a small shape and at the main path's shape,
     with both times (F1 with and without `negate`, on its flat and
     strided routes, with torch.addcmul's mismatches and time beside it); B1, B2 and B5 also at shapes that stress their
     strips (n = 1, n = 2, H = 1, H = 5, H = 301, W = 1, W = 33) and on
     each side of their shape rules (B1 and B2: persistent or per plane;
     B5: one cluster, grid-wide strips or per plane), each call made
     twice with identical results, and B5 at a soma-scale crop; B3 over
     whole windows and over random boxes, twice;
  4. small main path: skeletonize on a blob fixture with a soma-sized
     label (taken by the crop engine) and a label with more manual
     targets than the crop engine holds (taken by the host trace path) on
     CUDA equals the same call on the CPU; the scipy-only TEASAR oracle
     (tests/oracle_teasar.py) agrees on a winding tube;
  5. the main path at real size: a dense anisotropic Voronoi volume of
     512^3 with 2,124 labels (bench.py's generator, seed 0), run twice,
     with phase times, skeleton and launch counts, and 8 labels traced by
     the global engine cross-checked against the host trace path (both
     engines with the global engine's PDRF formula: the reference's
     engines round it differently); its routing counters (the global
     engine's iterations, the labels its selective bail hands to the crop
     engine, which must be some, either engine's jobs); then B3 bit-equal
     to its plain version on calls that run made (its row of the kernel
     table);
  6. the soma volume at real size: bench.py's hollow variant of that
     volume (carved holes, nested pits, two soma-scale balls that the
     global engine hands to the crop engine), run twice, with phase
     times, counters, launches and the peak device memory;
  7. cross-check: the global engine with the bail off traces the dense
     run's other labels bit-equal; 64 labels of the dense run, from one
     crop bucket, and the labels the bail handed back, traced by the crop
     engine on the card (with the global engine's PDRF formula) equal
     their global-engine skeletons;
     then B4 bit-equal to its plain version on the calls the soma run,
     the per-label path and this cross-check made, with a kernel-table
     row for each shape of the main path's runs;
  8. cross sections: B6 and X1 against their plain versions at small
     shapes; cross_sectional_area on the dense run's largest skeletons
     (bench.py's selection, >= 12,000 vertices) and on the soma volume's
     two balls (W = 512 rungs), each run twice, with ms/vertex, rung
     counters, launches and peak memory, the card equal to the CPU on a
     subset (the smallest dense skeletons up to 300 vertices, the smaller
     ball, each downsampled by 4); the per-label path
     (cross_sectional_area_single, fill_holes, zero normals on the dense
     rung: B4) CUDA against CPU; then B6 and X1
     bit-equal to their plain versions on the inputs those runs handed
     them, with times and bounds, B6's scalar path on the dense run's
     calls with the volume cut to tz - 1 and tz - 2, and a kernel-table
     row for B6 and X1 at each rung width; then F1 bit-equal to its plain
     version on the calls phases 4 to 6 and 8 handed it (`F1Spy`), timed
     beside torch.addcmul, with a kernel-table row for each route;
  9. the host-stage path: the soma volume through skeletonize with
     fill_holes and fix_avocados (bench.py's fill stage), run once, with
     phase times and counters; its filled volume equal to a serial
     oracle (scipy's binary_fill_holes per label in label order), the
     avocado output's invariants, a skeleton for every label above the
     dust threshold; a 64^3 hollow volume with a hole and an avocado on
     the card and on the CPU, equal skeletons; B4, B5 and F1 recorded
     on these runs (bit-equal to their plain versions with phases 4-8's
     calls, a kernel-table row for each new B4 shape); postprocess and
     join_close_components on the dense run's skeletons by the native
     and the python route (equal SWC, host seconds); the dense volume
     streamed from a CompressedLabelVolume (equal skeletons; upload
     seconds and peak host RSS beside the plain array's); and
     skeletonize_chunked of it in 2 x 2 x 2 chunks of 256 (the
     whole-volume run's labels save those that are dust in every chunk;
     wall and merge seconds);
 10. self-touch (voxel_graph): the dense volume with a quarter of its
     labels relabelled to a touching neighbour, under the connectivity
     graph of the labels before that merge (cc3d's convention, 512 MiB of
     uint32): compute_cc_labels under the graph counts the pre-merge
     components, plain CCL fewer; skeletonize twice (cold, warm) with
     B1's and B5's graph-gated forms and B4's graph gating recorded; its
     skeletons equal skeletonize(pre-merge, all-ones graph) merged by the
     merge map, label by label in SWC (labels whose lane refilled a soma
     left out and counted); a 64^3 self-touch volume with a label that
     takes the host trace path, card against CPU; then B1-vg and B5-vg
     bit-equal to their plain versions at strip-stressing shapes, on
     each side of their shape rules and on the recorded calls, B4-vg on
     each side of its plan rule and on the self-touch runs' calls, each
     timed in turns with the ungated form on the same inputs (B5-vg at
     96^3), and G1 (the graph gate, csrc/gate.cu) at its stress shapes
     and on the recorded calls, with kernel-table rows for B1-vg, B5-vg,
     B4's graph-gated shapes and G1; C1 (the crop engine's chase,
     csrc/chase.cu) launched once a crop path iteration, bit-equal to its
     plain version on the recorded lane sets with and without their graph,
     with kernel-table rows;
 11. the analysis extras: V1 (the joint Voronoi sweep) against its plain
     version at small, odd and strip-stressing shapes, on each side of its
     form rule and at 512^3 with ties, its distance against B5's euclid
     sweep; V1's lane-batched form against its plain version at mixed
     extents, one lane and 300, lanes with `active` off and on each side
     of voronoi_batched_plan (beyond it the batched kernel refuses a
     plane, and the batched field sends its crop to V1's single forms);
     oversegment of the dense volume with phase 5's skeletons on the
     batched route (downsample 0 and 5, each a first and a warm run, with
     phases, fewer than 1,000 V1 launches, the padding, the device memory
     and the lanes a two-stage prefetch would push out of one CTA's
     shared memory): a uint64 composite, every voxel of a
     skeletonized label in a segment, as many segments as distinct seed
     voxels, a segment per vertex, card = CPU on the crops of 6 labels;
     the batched V1 on the first round's calls of a run's first and last
     batches, each twice (a kernel-table row each); then the per-crop
     route (voronoi_feature_field on each crop) at downsample 0 and 5,
     its composite and every segment equal to the batched route's, and V1
     on its six most swept shapes (a kernel-table row each); connect_points on one winding
     neurite (a persistent random walk of 2,000 steps, radius 3) in an
     empty 512^3 volume: a chain of 26-adjacent voxels in the mask from
     end to start, radii = the EDT, card = CPU on a cut of at most 96^3;
     synapses_to_targets for 2 centroids on each of 256 dense labels (the
     host pass timed), then skeletonize(extra_targets_after=) on the card:
     each target a vertex of its label;
 12. the multi-device path: make_mesh(4, "cuda") (every shard on the one
     card); the sharded CCL and EDT of the dense and soma volumes against
     the single-device ones (compacted ids equal, the DBF within rtol
     1e-5, the differing voxels counted); the sharded EDT of a 128^3 cut
     and the preamble step of a 64^3 cut card = CPU; skeletonize_sharded
     of the dense volume twice (first, warm) and of the soma volume, with
     phases, launches, exchanges and peak memory, every label's SWC
     against phases 5 and 6's volumes on one device with the global
     engine's bail off, as the sharded engine runs (a label may differ
     only where its DBF
     differs or where the runs traced one of its components with
     different engines, both counted); a 64^3 blob volume at 3 shards and
     the 64^3 self-touch volume at 4 shards, card = CPU; then B1, B3, B4,
     B5 and F1 bit-equal to their plain versions on the calls the sharded
     runs made, with kernel-table rows at those shapes;
 13. the command line: `python -m kimimaro_tpu_torch.cli forge` of the
     dense volume (bench.py's parameters as options, --device cuda)
     writes phase 5's skeletons as SWC; `forge --cross-section 1` of a
     128^3 cut writes the areas cross_sectional_area computes on the
     card; `swc to` and `swc from` round-trip one label.

The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result. Launch counts are reset just before each main-path run of
phases 4 to 6 and 8 to 12 and read just after it; the table's launches are
their sum, so neither the kernel comparisons nor the cross-checks count.

    python3 chip_smoke.py --profile

runs the dense volume under torch.profiler instead and prints the card's
busy share and the operations that took most device time.

    python3 chip_smoke.py --ab DIR

times kernels B6 and F1 of this checkout against those built from the
sources of the checkout at DIR (the parent commit, e.g. unpacked with
git archive), on the same inputs in one process, in turns, and the dense
volume's and the dense cross sections' warm walls with either.

    python3 chip_smoke.py --self-touch

runs phase 10 alone (after the build).

    python3 chip_smoke.py --chase

runs C1's checks alone (after the build): the dense and soma volumes'
main-path runs (phases 5 and 6) and the self-touch volume skeletonized
once, each with the chase calls recorded, C1 against its plain version on
them, both timed.

    python3 chip_smoke.py --fill

runs phase 9's fill path alone (after the build): the soma volume with
`fill_holes` and `fix_avocados` against the serial oracle and the avocado
invariants, then the 64^3 fill volume on the card against the CPU.

    python3 chip_smoke.py --analysis

runs phase 11 alone (after the build, with the dense volume's skeletons
made first, not timed).

    python3 chip_smoke.py --sharded

runs phase 12 alone (after the build, with phases 5 and 6's single-device
runs made first).

    python3 chip_smoke.py --cli

runs phase 13 alone (after the build, with the dense volume's skeletons
made first).

    python3 chip_smoke.py --time-oversegment DIR [RUNS]

times oversegment with the port of the checkout at DIR (this one, or
another unpacked with git archive) on the card: the dense volume's, the
soma volume's and the 512^3 neurite walk's (phase 11's connect_points
path as its skeleton), each once and then RUNS times (default 3) warm,
and prints a JSON line per case with the seconds, phases, counters, V1
launches and a digest of the composite and the segments. Compare two
checkouts only within one call, in turns (parent, change, change,
parent), one process each.

    python3 chip_smoke.py --host-soma

runs one soma-mode label of 512^3 (a 3,680 nm soma with a neurite, alone
in the volume) through skeletonize instead: the crop engine hands it to
the host trace path, whose relaxes are B5 sweeps. It prints the run's
seconds, phases, counters and launches.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DENSE_N = 512
DENSE_LABELS = 2124
TEASAR = {  # bench.py's parameters
    "scale": 1.5,
    "const": 300,
    "pdrf_exponent": 4,
    "pdrf_scale": 100000,
    "soma_detection_threshold": 1100,
    "soma_acceptance_threshold": 3500,
}
ANIS = (16, 16, 40)


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds of fn() over `reps` runs after one warm-up,
    timed with CUDA events."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed_once(fn):
    """(fn(), its milliseconds timed with CUDA events), without a warm-up:
    for the plain versions, whose cost is their Python loop."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def require_equal(name, got, want):
    """Raise unless every output equals its plain version bit for bit;
    returns the measured max abs error (0.0)."""
    import torch

    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{name}: {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        gf, wf = g.double(), w.double()
        same = (gf == wf) | (torch.isnan(gf) & torch.isnan(wf))
        diff = torch.where(same, 0.0, (gf - wf).abs())
        err = max(err, float(diff.max()) if diff.numel() else 0.0)
        if not bool(same.all()):
            raise AssertionError(f"{name}: {int((~same).sum())} elements "
                                 f"differ (max abs err {err})")
    return err


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions


def sweep_inputs(shape, mode, has_ok, clamp, gen):
    import torch

    dev = "cuda"

    def rand(*s):
        return torch.rand(s, generator=gen, device=dev)

    cc = torch.randint(0, 4, shape, generator=gen, device=dev,
                       dtype=torch.int32)
    if mode == "minid":
        # raw labels bitcast to int32: -1 equals the carried id of an
        # unoccupied voxel in the plain version
        cc = torch.where(cc == 3, -7, torch.where(cc == 2, -1, cc))
        d = torch.where(cc != 0, torch.randint(1, 999, shape, generator=gen,
                                               device=dev, dtype=torch.int32),
                        2**31 - 1).to(torch.int32)
    elif mode == "maxflood":
        d = torch.where(cc > 0, rand(*shape) * 10, float("-inf"))
    else:
        d = torch.where(rand(*shape) < 0.25,
                        rand(*shape) * 10 - (5.0 if clamp else 0.0),
                        float("inf"))
    nc = rand(*shape) * 3 if mode == "node" else None
    ok = (rand(*shape) < 0.8).to(torch.uint8) if has_ok else None
    return d.contiguous(), cc, nc, ok


# B1 beyond its timed shapes: n = 1 and n = 2, H = 1, H = 5, a last strip
# shorter than the others (H = 301 is strips of 3 rows on 132 SMs), W = 1,
# W = 33 (no 16-byte rows: the plain-load stages), rotated non-cubic layouts
B1_STRESS_SHAPES = ((1, 7, 16), (2, 9, 16), (5, 1, 48), (6, 5, 32),
                    (6, 301, 48), (7, 12, 1), (5, 20, 33), (24, 512, 128),
                    (9, 128, 512))
# the square planes on each side of kt_gsweep_sweep0_plan's rule on an H100
# (132 SMs, 227 KB), by (mode, okmask): (persistent, per plane)
B1_RULE = {("euclid", False): (896, 912), ("euclid", True): (848, 864),
           ("node", False): (784, 800), ("node", True): (784, 800),
           ("maxflood", False): (896, 912), ("maxflood", True): (848, 864),
           ("minid", False): (896, 912), ("minid", True): (848, 864)}
B1_MODES = ("euclid", "node", "maxflood", "minid")


def b1_case(shape, mode, has_ok, clamp, gen, anis):
    """B1 against its plain version in both directions, each call made
    twice (the mailboxes start from zero again)."""
    from kimimaro_tpu_torch.ops import gsweep

    d, cc, nc, ok = sweep_inputs(shape, mode, has_ok, clamp, gen)
    err = 0.0
    for desc in (False, True):
        got = gsweep.sweep0(d, cc, nc, ok, anis, mode, clamp, desc)
        again = gsweep.sweep0(d, cc, nc, ok, anis, mode, clamp, desc)
        want = gsweep._sweep0_plain(d, cc, nc, ok, anis, mode, clamp, desc)
        name = f"B1 {mode} ok={has_ok} clamp={clamp} desc={desc} {shape}"
        err = max(err, require_equal(name, got, want))
        require_equal(name + " run twice", again, got)
    return err


def check_b1(shapes, gen):
    """B1 against its plain version at each shape in all four modes, with
    and without an okmask and clamp, both directions, twice; then on each
    side of its shared-memory rule. Returns the time of a euclid + okmask
    + clamp sweep of the last shape."""
    from kimimaro_tpu_torch.ops import gsweep

    anis = (16.0, 16.0, 40.0)
    err = 0.0
    for shape in shapes:
        for mode in B1_MODES:
            for has_ok in (False, True):
                for clamp in (False, True):
                    err = max(err, b1_case(shape, mode, has_ok, clamp, gen,
                                           anis))
        plan = gsweep.sweep0_plan(shape[1], shape[2], "euclid", True)
        log(f"[kernels] B1 bit-equal on {shape}: 4 modes x okmask x clamp "
            f"x direction, twice; plan {json.dumps(plan)}")
    for (mode, has_ok), sides in sorted(B1_RULE.items()):
        for side, persistent in zip(sides, (True, False)):
            plan = gsweep.sweep0_plan(side, side, mode, has_ok)
            if plan["persistent"] != persistent:
                raise AssertionError(f"B1 {mode} ok={has_ok} {side}^2: plan "
                                     f"{plan}, expected persistent="
                                     f"{persistent}")
            for clamp in (False, True):
                err = max(err, b1_case((2, side, side), mode, has_ok, clamp,
                                       gen, anis))
    log(f"[kernels] B1 bit-equal on each side of its shared-memory rule, "
        f"every mode and okmask (persistent / per-plane planes: "
        f"{json.dumps({f'{m} ok={o}': v for (m, o), v in B1_RULE.items()})})")
    d, cc, nc, ok = sweep_inputs(shapes[-1], "euclid", True, True, gen)
    ms = cuda_ms(lambda: gsweep.sweep0(d, cc, None, ok, anis, "euclid", True,
                                       False), 5)
    plain = cuda_ms(lambda: gsweep._sweep0_plain(d, cc, None, ok, anis,
                                                 "euclid", True, False), 1)
    return ms, plain, err


# B2 beyond the three shapes of B1: n = 1 and n = 2, H = 1, H = 5, a last
# strip shorter than the others (H = 301 is strips of 3 rows on 132 SMs),
# W = 1, W = 33 (no 16-byte rows: the plain-load stages), a rotated
# non-cubic layout, and a plane on each side of the shared-memory rule
B2_STRESS_SHAPES = ((1, 7, 16), (2, 9, 16), (5, 1, 48), (6, 5, 32),
                    (6, 301, 48), (7, 12, 1), (5, 20, 33), (64, 512, 128),
                    (3, 640, 640), (3, 704, 704))
# what kt_gsweep_dual_plan must answer on an H100 (132 SMs, 227 KB)
B2_PERSISTENT = {(3, 640, 640): True, (3, 704, 704): False}


def b2_inputs(shape, kind, gen):
    import torch

    cc = torch.randint(0, 4, shape, generator=gen, device="cuda",
                       dtype=torch.int32)
    r = lambda: torch.rand(shape, generator=gen, device="cuda")
    if kind == "ball_rail":
        da = torch.where(r() < 0.2, -r() * 60, float("inf"))
        db = torch.where(r() < 0.2, r(), float("inf"))
        return da, db, cc, r() * 3, (r() < 0.8).to(torch.uint8)
    da = torch.where(cc > 0, r() * 10, float("-inf"))
    db = torch.where(cc > 0, r() * 10, float("-inf"))
    return da, db, cc, None, None


def check_b2(shapes, gen):
    """B2 against its plain version at each shape, both kinds and both
    directions, each call made twice (the step counters start from zero
    again); the times are a ball_rail sweep of the last shape. Returns
    (ms, plain_ms, err, {kind: ms} at the last shape)."""
    from kimimaro_tpu_torch.ops import gsweep

    anis = (16.0, 16.0, 40.0)
    err = 0.0
    ms_kind = {}
    for shape in shapes:
        plan = gsweep.dual_plan(shape[1], shape[2], "ball_rail")
        want_plan = B2_PERSISTENT.get(tuple(shape), True)
        if plan["persistent"] != want_plan:
            raise AssertionError(f"B2 {shape}: plan {plan}, expected "
                                 f"persistent={want_plan}")
        for kind in ("max2", "ball_rail"):
            da, db, cc, nc, ok = b2_inputs(shape, kind, gen)
            for desc in (False, True):
                got = gsweep.sweep0_dual(da, db, cc, nc, ok, anis, kind, desc)
                again = gsweep.sweep0_dual(da, db, cc, nc, ok, anis, kind,
                                           desc)
                want = gsweep._sweep0_dual_plain(da, db, cc, nc, ok, anis,
                                                 kind, desc)
                err = max(err, require_equal(f"B2 {kind} desc={desc} {shape}",
                                             got, want))
                require_equal(f"B2 {kind} desc={desc} {shape} run twice",
                              again, got)
            if shape == shapes[-1]:
                ms_kind[kind] = cuda_ms(lambda: gsweep.sweep0_dual(
                    da, db, cc, nc, ok, anis, kind, False), 5)
        log(f"[kernels] B2 bit-equal on {shape}: ball_rail, max2 x direction, "
            f"twice; plan {json.dumps(plan)}")
    plain = cuda_ms(lambda: gsweep._sweep0_dual_plain(da, db, cc, nc, ok,
                                                      anis, kind, False), 1)
    return ms_kind["ball_rail"], plain, err, ms_kind


def b3_bound_ms(field, box_off, box_size):
    """Least time of one B3 call on these inputs: each field and cc cell
    some lane's box covers read once, the per-lane rows (origin, id, box)
    read and the (coordinates, value) rows written, over the HBM rate."""
    import torch

    seen = torch.zeros(field.shape, dtype=torch.bool, device="cuda")
    for o, b in zip(box_off.tolist(), box_size.tolist()):
        seen[o[0]:o[0] + b[0], o[1]:o[1] + b[1], o[2]:o[2] + b[2]] = True
    nbytes = 8 * int(seen.sum()) + box_off.shape[0] * (40 + 16)
    return 1e3 * nbytes / HBM_BYTES_PER_S


def check_b3(cases, gen):
    """B3 against its plain version at each case, over the whole windows
    and over random boxes inside them (some empty), each call made twice
    (the atomics' order must not show). The times are the last case over
    its whole windows."""
    import torch

    from kimimaro_tpu_torch.ops import crop_argmax as ca

    err = 0.0
    for shape, crop, n_lanes in cases:
        cc = torch.randint(0, 5, shape, generator=gen, device="cuda",
                           dtype=torch.int32)
        field = torch.round(torch.rand(shape, generator=gen, device="cuda")
                            * 3)
        field = torch.where(torch.rand(shape, generator=gen, device="cuda")
                            < 0.3, float("-inf"), field)
        field = torch.where(cc == 4, float("-inf"), field).contiguous()
        hi = torch.tensor([s - c for s, c in zip(shape, crop)],
                          device="cuda")
        offs = (torch.rand((n_lanes, 3), generator=gen, device="cuda")
                * (hi + 1)).floor().to(torch.int32).contiguous()
        # lid 9 is absent (an empty lane), lid 4 holds only -inf
        lids = torch.tensor([1, 2, 3, 0, 4, 9], dtype=torch.int32,
                            device="cuda").repeat(n_lanes // 6 + 1)[:n_lanes]
        lids = lids.contiguous()
        # random boxes inside the windows, every seventh one empty
        crop_t = torch.tensor(crop, device="cuda")
        u = torch.rand((2, n_lanes, 3), generator=gen, device="cuda")
        size = (u[0] * (crop_t + 1)).floor().clamp(max=crop_t)
        size[::7] = 0
        rel = (u[1] * (crop_t - size + 1)).floor().clamp(max=crop_t - size)
        boxes = ((offs + rel.to(torch.int32)).contiguous(),
                 size.to(torch.int32).contiguous())
        for bx, what in ((None, "windows"), (boxes, "boxes")):
            got = ca.crop_argmax(field, cc, offs, lids, crop, bx)
            again = ca.crop_argmax(field, cc, offs, lids, crop, bx)
            want = ca._crop_argmax_plain(field, cc, offs, lids, crop, bx)
            name = f"B3 {shape} crop={crop} lanes={n_lanes} {what}"
            err = max(err, require_equal(name, got, want))
            require_equal(name + " run twice", again, got)
        log(f"[kernels] B3 bit-equal on {shape}, crop {crop}, {n_lanes} "
            f"lanes, whole windows and random boxes, twice (ties, -inf "
            f"labels, empty lanes, empty boxes)")
    ms = cuda_ms(lambda: ca.crop_argmax(field, cc, offs, lids, crop), 5)
    ms_box = cuda_ms(lambda: ca.crop_argmax(field, cc, offs, lids, crop,
                                            boxes), 5)
    plain = cuda_ms(lambda: ca._crop_argmax_plain(field, cc, offs, lids,
                                                  crop), 1)
    bound = b3_bound_ms(field, offs, crop_t.to(torch.int32).expand(
        n_lanes, 3))
    log(f"[kernels] B3 {n_lanes} lanes of {crop} in {shape}: whole windows "
        f"{ms:.3f} ms (bound {bound:.3f} ms), random boxes {ms_box:.3f} ms "
        f"(bound {b3_bound_ms(field, *boxes):.3f} ms)")
    return ms, plain, err, bound


class B3Spy:
    """While installed, keeps the arguments of the global engine's B3
    calls at the indices in `keep`, and counts the calls."""

    def __init__(self, keep=(0, 1, 8)):
        self.keep = keep
        self.calls = 0
        self.kept = {}

    def install(self):
        from kimimaro_tpu_torch import gengine

        inner = gengine.crop_argmax

        def spy(field, cc, offs, lids, crop, boxes=None):
            if self.calls in self.keep:
                self.kept[self.calls] = (
                    field.clone(), cc, offs, lids, crop,
                    None if boxes is None else tuple(b.clone()
                                                     for b in boxes))
            self.calls += 1
            return inner(field, cc, offs, lids, crop, boxes)

        gengine.crop_argmax = spy

        def restore():
            gengine.crop_argmax = inner
            self.kept = self._to(self.kept, "cpu")

        return restore

    @classmethod
    def _to(cls, x, device):
        """The kept arguments with every tensor moved: they wait on the
        host while the timed runs go on."""
        import torch

        if isinstance(x, dict):
            return {k: cls._to(v, device) for k, v in x.items()}
        if isinstance(x, tuple):
            return tuple(cls._to(v, device) for v in x)
        return x.to(device) if isinstance(x, torch.Tensor) else x

    def on_card(self):
        return self._to(self.kept, "cuda")


def check_b3_recorded(spy):
    """B3 against its plain version on calls the dense run made (the root
    selection, the first path iteration, a later one), each made twice;
    with the time of the same lanes tier by tier over their whole tier
    crops, the form the one call replaced. Returns the kernel-table numbers
    of the first path iteration: (ms, plain_ms, err, bound_ms)."""
    import torch

    from kimimaro_tpu_torch.ops import crop_argmax as ca

    if 1 not in spy.kept:
        raise AssertionError(f"the dense run made {spy.calls} B3 calls")
    err = 0.0
    row = None
    kept = spy.on_card()
    for k, (field, cc, offs, lids, crops, boxes) in sorted(kept.items()):
        got = ca.crop_argmax(field, cc, offs, lids, crops, boxes)
        again = ca.crop_argmax(field, cc, offs, lids, crops, boxes)
        want, plain = timed_once(lambda: ca._crop_argmax_plain(
            field, cc, offs, lids, crops, boxes))
        e = require_equal(f"B3 dense call {k}", got, want)
        require_equal(f"B3 dense call {k} run twice", again, got)
        err = max(err, e)
        ms = cuda_ms(lambda: ca.crop_argmax(field, cc, offs, lids, crops,
                                            boxes), 5)
        bound = b3_bound_ms(field, *boxes)
        # the same lanes, one call per tier over the whole tier crops
        edges = [0] + (torch.nonzero((crops[1:] != crops[:-1]).any(dim=1))
                       .flatten() + 1).tolist() + [crops.shape[0]]
        tiers = [(a, b, tuple(crops[a].tolist()))
                 for a, b in zip(edges[:-1], edges[1:])]
        ms_tiers = cuda_ms(lambda: [ca.crop_argmax(
            field, cc, offs[a:b].contiguous(), lids[a:b].contiguous(), c)
            for a, b, c in tiers], 2)
        scanning = int((boxes[1].prod(dim=1) > 0).sum())
        voxels = int(boxes[1].long().prod(dim=1).sum())
        log(f"[kernels] B3 dense call {k}: {offs.shape[0]} lanes in "
            f"{len(tiers)} tiers, {scanning} scanning {voxels} box voxels "
            f"({voxels / field.numel():.2f} volumes): bit-equal, twice; "
            f"{ms:.3f} ms vs plain {plain:.1f} ms, bound {bound:.3f} ms; "
            f"tier by tier over whole crops {ms_tiers:.3f} ms")
        if k == 1:
            row = (ms, plain, err, bound)
    return row[0], row[1], err, row[3]


# B5 beyond its timed shape: n = 1, H = 1, W = 1, W = 33, a last strip
# shorter than the others, non-cubic; and the square planes on each side of
# kt_sweep_axis0_plan's rules on an H100 (132 SMs, 227 KB), by node mode:
# one cluster of 16 CTAs while each relaxes its strip in one pass, then
# grid-wide strips, then one launch per plane
B5_STRESS_SHAPES = ((1, 7, 16), (2, 9, 16), (5, 1, 48), (7, 12, 1),
                    (5, 20, 33), (17, 40, 24), (5, 301, 48))
B5_RULE = {False: ((170, "cluster"), (171, "strips"), (1184, "strips"),
                   (1200, "plane")),
           True: ((170, "cluster"), (171, "strips"), (1024, "strips"),
                  (1040, "plane"))}
# a soma-scale crop of the host trace path (--host-soma's label: about
# 460 x 460 x 184 voxels) as it is swept along x or y, and along z
B5_SOMA_SHAPES = ((460, 460, 184), (184, 460, 460))


def b5_inputs(shape, clamp, gen):
    """A field with a quarter finite, finite positive values on both end
    planes (the first plane of a sweep passes through unclamped and
    unmasked), an ok mask and node costs."""
    import torch

    r = lambda *s: torch.rand(s or shape, generator=gen, device="cuda")
    d = torch.where(r() < 0.25, r() * 10 - (5.0 if clamp else 0.0),
                    float("inf"))
    d[0] = r(*shape[1:]) + 0.5
    d[-1] = r(*shape[1:]) + 0.5
    return d.contiguous(), (r() < 0.8).contiguous(), (r() * 3).contiguous()


def b5_case(shape, node, clamp, gen, anis):
    """B5 against its plain version in both directions, each call made
    twice; the first plane must pass through unchanged."""
    from kimimaro_tpu_torch.ops import sweep

    d, ok, nc = b5_inputs(shape, clamp, gen)
    err = 0.0
    for desc in (False, True):
        got = sweep.sweep_axis0(d, ok, nc, anis, node, clamp, desc)
        again = sweep.sweep_axis0(d, ok, nc, anis, node, clamp, desc)
        want = sweep._sweep_axis0_plain(d, ok, nc, anis, node, clamp, desc)
        name = f"B5 node={node} clamp={clamp} desc={desc} {shape}"
        err = max(err, require_equal(name, got, want))
        require_equal(name + " run twice", again, got)
        first = -1 if desc else 0
        require_equal(name + " first plane", got[first], d[first])
    return err


def check_b5(shapes, gen):
    """B5 against its plain version at each shape (node and euclid, clamp,
    both directions, twice), on each side of its form rules and at a
    soma-scale crop. Returns the time of a node sweep of a 96^3 crop (the
    table's row) and the soma-scale times."""
    from kimimaro_tpu_torch.ops import sweep

    anis = (40.0, 16.0, 16.0)
    err = 0.0
    for shape in shapes:
        for node in (False, True):
            for clamp in (False, True):
                err = max(err, b5_case(shape, node, clamp, gen, anis))
        plans = {m: sweep.sweep_axis0_plan(shape[1], shape[2], m)["form"]
                 for m in (False, True)}
        log(f"[kernels] B5 bit-equal on {shape}: node/euclid x clamp x "
            f"direction, twice; form euclid {plans[False]}, node "
            f"{plans[True]}")
    for node, sides in B5_RULE.items():
        for side, form in sides:
            plan = sweep.sweep_axis0_plan(side, side, node)
            if plan["form"] != form:
                raise AssertionError(f"B5 node={node} {side}^2: plan {plan}, "
                                     f"expected {form}")
            for clamp in (False, True):
                err = max(err, b5_case((2, side, side), node, clamp, gen,
                                       anis))
    log(f"[kernels] B5 bit-equal on each side of its form rules: "
        f"{json.dumps({('node' if k else 'euclid'): v for k, v in B5_RULE.items()})}")
    d, ok, nc = b5_inputs((96, 96, 96), False, gen)
    ms = cuda_ms(lambda: sweep.sweep_axis0(d, ok, nc, anis, True, False), 5)
    plain = cuda_ms(lambda: sweep._sweep_axis0_plain(d, ok, nc, anis, True,
                                                     False, False), 1)
    soma = {}
    for shape in B5_SOMA_SHAPES:
        err = max(err, b5_case(shape, True, False, gen, anis))
        d, ok, nc = b5_inputs(shape, False, gen)
        for node in (True, False):
            soma[(shape, node)] = cuda_ms(lambda: sweep.sweep_axis0(
                d, ok, nc, anis, node, False), 5)
        plan = sweep.sweep_axis0_plan(shape[1], shape[2], True)
        log(f"[kernels] B5 soma-scale crop {shape} ({d.numel() / 1e6:.1f} M "
            f"voxels, form {plan['form']}, {plan['ctas']} CTAs of "
            f"{plan['rows']} rows): bit-equal; node sweep "
            f"{soma[(shape, True)]:.3f} ms, euclid "
            f"{soma[(shape, False)]:.3f} ms, bound "
            f"{1e3 * 13 * d.numel() / HBM_BYTES_PER_S:.3f} ms (bytes)")
    del d, ok, nc
    return ms, plain, err, soma


class B5Spy:
    """While installed, keeps the arguments of the host trace path's B5
    call number `nth` (from 0) of every (shape, mode, clamp, direction,
    graph bits), up to `keep` of them, and counts the calls by the form
    their plane takes (`calls`) and by key (`seen`)."""

    def __init__(self, keep=64, nth=0):
        self.keep = keep
        self.nth = nth
        self.kept = {}
        self.calls = {}
        self.seen = {}

    def install(self):
        from kimimaro_tpu_torch.ops import geodesic, sweep

        inner = geodesic.sweep_axis0

        def spy(d, ok, nc, anis, node_mode, clamp_positive, descending=False,
                gate=None, gate_bits9=None):
            if d.device.type == "cuda":
                key = (tuple(d.shape), bool(node_mode), bool(clamp_positive),
                       bool(descending), None if gate_bits9 is None
                       else tuple(gate_bits9))
                seen = self.seen.get(key, 0)
                self.seen[key] = seen + 1
                if seen == self.nth and len(self.kept) < self.keep:
                    self.kept[key] = (d.clone(), ok, nc, tuple(anis), gate)
                form = sweep.sweep_axis0_plan(d.shape[1], d.shape[2],
                                              node_mode, gate is not None)
                form = form["form"] + ("-vg" if gate is not None else "")
                self.calls[form] = self.calls.get(form, 0) + 1
            return inner(d, ok, nc, anis, node_mode, clamp_positive,
                         descending, gate=gate, gate_bits9=gate_bits9)

        geodesic.sweep_axis0 = spy

        def restore():
            geodesic.sweep_axis0 = inner

        return restore


def check_b5_recorded(spy, rows=None):
    """B5 against its plain version on the calls the host trace path made
    (phases 4 and 5), each made twice, with the kernel's time. Returns the
    max abs error; with `rows` (a dict), puts (ms, plain ms, err) of each
    key there."""
    from kimimaro_tpu_torch.ops import sweep

    err = 0.0
    ms_total = plain_total = 0.0
    forms = {}
    for key, (d, ok, nc, anis, gate) in sorted(
            spy.kept.items(), key=lambda kv: (kv[0][:4], kv[0][4] or ())):
        shape, node, clamp, desc, bits = key
        got = sweep.sweep_axis0(d, ok, nc, anis, node, clamp, desc,
                                gate=gate, gate_bits9=bits)
        again = sweep.sweep_axis0(d, ok, nc, anis, node, clamp, desc,
                                  gate=gate, gate_bits9=bits)
        want, plain = timed_once(lambda: sweep._sweep_axis0_plain(
            d, ok, nc, anis, node, clamp, desc, gate=gate, gate_bits9=bits))
        e = require_equal(f"B5 host call {key}", got, want)
        err = max(err, e)
        require_equal(f"B5 host call {key} run twice", again, got)
        ms = cuda_ms(lambda: sweep.sweep_axis0(d, ok, nc, anis, node, clamp,
                                               desc, gate=gate,
                                               gate_bits9=bits), 3)
        if rows is not None:
            rows[key] = (ms, plain, e)
        form = sweep.sweep_axis0_plan(shape[1], shape[2], node,
                                      gate is not None)["form"]
        forms[form] = forms.get(form, 0) + 1
        ms_total += ms
        plain_total += plain
    n = len(spy.kept)
    if n == 0:
        raise AssertionError("the host trace path made no B5 call")
    log(f"[kernels] B5 on {n} recorded host-path calls (distinct shape, "
        f"mode, clamp, direction; forms {json.dumps(forms)}): bit-equal, "
        f"twice; mean {ms_total / n:.4f} ms vs plain {plain_total / n:.2f} "
        f"ms; the calls by form: {json.dumps(spy.calls)}")
    return err


def check_b4(shapes, gen):
    """B4 against its plain loop at each shape; the times returned are
    those of the last shape. Each shape's node sweep is timed too."""
    import torch

    from kimimaro_tpu_torch.ops import sweep

    anis = (40.0, 16.0, 16.0)
    bits9 = (25, 21, 19, 23, 1, 19, 24, 20, 18)
    err = 0.0
    for shape in shapes:
        r = lambda: torch.rand(shape, generator=gen, device="cuda")
        vg = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                           device="cuda", dtype=torch.int32)
        for node in (False, True):
            for clamp in (False, True):
                d = torch.where(r() < 0.25, r() * 10 - (5.0 if clamp else 0.0),
                                float("inf")).contiguous()
                ok = (r() < 0.8).contiguous()
                nc = (r() * 3).contiguous()
                for desc in (False, True):
                    for g, b in ((None, None), (vg, bits9)):
                        got = sweep.sweep_axis0_batched(
                            d, ok, nc, anis, node, clamp, desc, vg=g,
                            bits9=b)
                        want = sweep._sweep_axis0_batched_plain(
                            d, ok, nc, anis, node, clamp, desc, g, b)
                        err = max(err, require_equal(
                            f"B4 node={node} clamp={clamp} desc={desc} "
                            f"graph={g is not None} {shape}", got, want))
        ms = cuda_ms(lambda: sweep.sweep_axis0_batched(d, ok, nc, anis,
                                                       True, False), 5)
        plain = cuda_ms(lambda: sweep._sweep_axis0_batched_plain(
            d, ok, nc, anis, True, False, False), 1)
        plan = sweep.sweep_axis0_batched_plan(shape[0], shape[2], shape[3],
                                              True)
        bms, by = b4_bound(shape, True)
        log(f"[kernels] B4 bit-equal on {shape} (form {plan['form']}, "
            f"{plan['ctas']} CTAs a lane): node/euclid x clamp x direction x "
            f"voxel graph; node sweep {ms:.4f} ms vs plain {plain:.3f} ms, "
            f"bound {bms:.4f} ms ({by})")
    ms_vg = cuda_ms(lambda: sweep.sweep_axis0_batched(
        d, ok, nc, anis, True, False, gate=vg, gate_bits9=bits9), 5)
    plain_vg = cuda_ms(lambda: sweep._sweep_axis0_batched_plain(
        d, ok, nc, anis, True, False, False, gate=vg, gate_bits9=bits9), 1)
    log(f"[kernels] B4 with a graph gate: {ms_vg:.3f} ms vs plain "
        f"{plain_vg:.3f} ms ({shape[0]} lanes of {shape[1:]})")
    return ms, plain, err


class B4Spy:
    """While installed, counts the B4 calls per lane shape and keeps the
    arguments of the first call of every (shape, mode, clamp, direction),
    up to `keep` of them; with `per_shape`, of the first call of every
    shape only."""

    def __init__(self, tag, keep=256, per_shape=False):
        self.tag = tag
        self.keep = keep
        self.per_shape = per_shape
        self.kept = {}
        self.calls = {}

    def install(self):
        from kimimaro_tpu_torch.ops import geodesic

        inner = geodesic.sweep_axis0_batched

        def spy(d, ok, nc, anis, node_mode, clamp_positive, descending=False,
                gate=None, gate_bits9=None):
            if d.device.type == "cuda":
                shape = tuple(d.shape)
                self.calls[shape] = self.calls.get(shape, 0) + 1
                key = (shape, bool(node_mode), bool(clamp_positive),
                       bool(descending), None if gate_bits9 is None
                       else tuple(gate_bits9))
                first = not self.per_shape or self.calls[shape] == 1
                if first and key not in self.kept and \
                        len(self.kept) < self.keep:
                    self.kept[key] = (d.clone(), ok.clone(),
                                      None if nc is None else nc.clone(),
                                      tuple(anis),
                                      None if gate is None else gate.clone())
            return inner(d, ok, nc, anis, node_mode, clamp_positive,
                         descending, gate=gate, gate_bits9=gate_bits9)

        geodesic.sweep_axis0_batched = spy

        def restore():
            geodesic.sweep_axis0_batched = inner

        return restore


def b4_bound(shape, node, vg=False):
    """Least time of one B4 sweep of `shape`: d, ok (and nodecost, and the
    voxel graph) read once, d written once, over the HBM rate, against
    nine candidates a voxel over the float32 peak. Returns (ms, by)."""
    vox = int(np.prod(shape))
    t_b = ((13 if node else 9) + (4 if vg else 0)) * vox / HBM_BYTES_PER_S
    t_o = (12 if node else 18) * vox / ALU_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def check_b4_recorded(spy, ungated=None):
    """B4 against its plain version on the calls a run made, each made
    twice. Returns {shape: (ms, plain_ms, bound_ms, bound_by, err)}, timed
    on the shape's first recorded call (a node sweep where there is one);
    with `ungated` (a dict), puts there the times of that call with and
    without its graph gate, in turns (a, b, b, a): {shape: ([gated ms],
    [ungated ms])}."""
    from kimimaro_tpu_torch.ops import sweep

    out = {}
    for key in sorted(spy.kept, key=lambda k: (k[0], not k[1], k[2], k[3],
                                               k[4] or ())):
        shape, node, clamp, desc, bits = key
        d, ok, nc, anis, gate = spy.kept[key]
        got = sweep.sweep_axis0_batched(d, ok, nc, anis, node, clamp, desc,
                                        gate=gate, gate_bits9=bits)
        again = sweep.sweep_axis0_batched(d, ok, nc, anis, node, clamp, desc,
                                          gate=gate, gate_bits9=bits)
        want, plain = timed_once(lambda: sweep._sweep_axis0_batched_plain(
            d, ok, nc, anis, node, clamp, desc, gate=gate, gate_bits9=bits))
        err = require_equal(f"B4 {spy.tag} call {key}", got, want)
        require_equal(f"B4 {spy.tag} call {key} run twice", again, got)
        if shape in out:
            out[shape] = out[shape][:4] + (max(out[shape][4], err),)
            continue
        ms = cuda_ms(lambda: sweep.sweep_axis0_batched(
            d, ok, nc, anis, node, clamp, desc, gate=gate, gate_bits9=bits),
            5)
        if ungated is not None and gate is not None:
            # the same call without its gate, in turns with the gated one
            ta, tb = turns(
                lambda: sweep.sweep_axis0_batched(
                    d, ok, nc, anis, node, clamp, desc, gate=gate,
                    gate_bits9=bits),
                lambda: sweep.sweep_axis0_batched(d, ok, nc, anis, node,
                                                  clamp, desc), 5)
            ungated[shape] = (ta, tb)
            ms = float(np.mean(ta))
        bms, by = b4_bound(shape, node, gate is not None)
        plan = sweep.sweep_axis0_batched_plan(shape[0], shape[2], shape[3],
                                              node, gate is not None)
        out[shape] = (ms, plain, bms, by, err)
        if not spy.per_shape:  # a per-shape record is summed up below
            log(f"[kernels] B4 {spy.tag} {shape} ({spy.calls.get(shape, 0)}"
                f" calls, form {plan['form']}, {plan['ctas']} CTAs a lane "
                f"of {plan['rows']} rows): {'node' if node else 'euclid'} "
                f"sweep {ms:.4f} ms vs plain {plain:.3f} ms, bound "
                f"{bms:.4f} ms ({by})")
    log(f"[kernels] B4 bit-equal on the {len(spy.kept)} recorded {spy.tag} "
        f"calls (distinct {'shape' if spy.per_shape else 'shape, mode, clamp, direction'}), twice")
    return out


def fma_triples(n, gen):
    """Random float32 triples, half of them with 13-bit mantissas and a c
    far below the product's ulp (a*b + c at or next to a float32
    midpoint, where rounding twice goes wrong)."""
    import torch

    def r(*shape):
        return torch.rand(shape, generator=gen, device="cuda")

    a, b, c = (r(n) * 2 - 1) * 100, r(n) * 2 - 1, r(n) * 2 - 1
    m = torch.floor(r(2, n) * 4096 + 4096) * torch.exp2(
        torch.floor(r(2, n) * 28) - 44)
    p = m[0].double() * m[1].double()
    tiny = (torch.sign(r(n) - 0.5) * p * torch.exp2(
        -torch.floor(r(n) * 30 + 30).double())).float()
    return (torch.cat([a, m[0]]), torch.cat([b, m[1]]), torch.cat([c, tiny]))


def f1_args(a, b, c):
    """F1's operands as tensors on the card (constants as 0-d tensors),
    for the plain version and torch.addcmul."""
    import torch

    return [t if isinstance(t, torch.Tensor) else torch.tensor(
        t, dtype=torch.float32, device="cuda") for t in (a, b, c)]


def addcmul(a, b, c, negate=False):
    """torch.addcmul's c + a*b (c - a*b with negate): F1's library
    yardstick, never called by the port."""
    import torch

    a, b, c = f1_args(a, b, c)
    return torch.addcmul(c, a, b, value=-1.0 if negate else 1.0)


def f1_bound(a, b, c, out):
    """Least time of one F1 call: each tensor operand's elements read
    once (a broadcast operand once, not once per use) and the output
    written once, over the HBM rate (bytes bound it: one operation an
    element)."""
    import torch

    nbytes = 4 * (out.numel() + sum(t.numel() for t in (a, b, c)
                                    if isinstance(t, torch.Tensor)))
    return 1e3 * nbytes / HBM_BYTES_PER_S


def check_f1(gen):
    """F1 against its plain version (float64, round-to-odd): 2^22 triples,
    half at midpoints, with and without `negate`, and torch.addcmul's
    mismatches against F1 on them; operands as the main path passes them
    on both routes (flat: contiguous, a view 4 bytes off, n % 4 != 0,
    one-element tensors, constants; strided: the cross sections'
    broadcasts); then the dense PDRF's 1 - dbf * m at 512^3, timed alone
    (negate, no negated copy), beside the parent's form (a negation pass,
    then F1 on -dbf), addcmul and the plain version. Returns a dict."""
    import torch

    from kimimaro_tpu_torch.ops import fma

    err = 0.0
    a, b, c = fma_triples(1 << 21, gen)
    mism = {}
    for negate in (False, True):
        got = fma.fma_f32(a, b, c, negate=negate)
        err = max(err, require_equal(
            f"F1 triples negate={negate}", got,
            fma._fma_f32_plain(a, b, c, negate=negate)))
        mism[negate] = int((addcmul(a, b, c, negate).view(torch.int32)
                            != got.view(torch.int32)).sum())
    log(f"[kernels] F1 bit-equal to its plain version on 2^22 triples (half "
        f"at float32 midpoints), with and without negate; torch.addcmul "
        f"differs from F1 on {mism[False]} of them (c + a*b) and "
        f"{mism[True]} (c - a*b, value=-1)")
    n4 = (1 << 20) + 3
    buf = torch.rand((n4 + 8,), generator=gen, device="cuda") * 200 - 100
    x = torch.rand((64, 5, 7, 5), generator=gen, device="cuda") * 900
    y = torch.rand((64, 1, 1, 1), generator=gen, device="cuda")
    z = torch.rand((64, 5, 7, 1), generator=gen, device="cuda") * 3
    routes = {}
    for args in ((x, y, z), (x, y, 1.0), (x, 1.5, 30.0),
                 (x[:, 0], 10.0, z[:, 0]), (buf[:n4], buf[4:n4 + 4], 1.0),
                 (buf[1:n4 + 1], buf[:n4], buf[3:n4 + 3]),
                 (buf[:n4], torch.tensor(0.5, device="cuda"), 30.0),
                 (x.transpose(0, 3), 2.0, 1.0)):
        shape = torch.broadcast_shapes(*(t.shape for t in args
                                         if isinstance(t, torch.Tensor)))
        route = fma.fma_plan(shape, [
            t.broadcast_to(shape) if isinstance(t, torch.Tensor) else None
            for t in args])["route"]
        routes[route] = routes.get(route, 0) + 1
        for negate in (False, True):
            err = max(err, require_equal(
                f"F1 {route} {tuple(shape)} negate={negate}",
                fma.fma_f32(*args, negate=negate),
                fma._fma_f32_plain(*f1_args(*args), negate=negate)))
    log(f"[kernels] F1 bit-equal on broadcast operands, views and constants "
        f"(routes {json.dumps(routes)}), with and without negate")
    n = DENSE_N
    dbf = torch.rand((n, n, n), generator=gen, device="cuda") * 400
    m = torch.rand((n, n, n), generator=gen, device="cuda") * 0.01
    neg = -dbf
    one = torch.ones((), device="cuda")
    got = fma.fma_f32(dbf, m, 1.0, negate=True)
    want, _ = timed_once(lambda: fma._fma_f32_plain(dbf, m, one,
                                                    negate=True))
    err = max(err, require_equal("F1 512^3", got, want))
    del want
    lib_equal = torch.equal(addcmul(dbf, m, 1.0, True).view(torch.int32),
                            got.view(torch.int32))
    ms = cuda_ms(lambda: fma.fma_f32(dbf, m, 1.0, negate=True), 5)
    ms_neg = cuda_ms(lambda: fma.fma_f32(neg, m, 1.0), 5)
    ms_two = cuda_ms(lambda: fma.fma_f32(-dbf, m, 1.0), 5)
    lib = cuda_ms(lambda: addcmul(dbf, m, 1.0, True), 5)
    plain = cuda_ms(lambda: fma._fma_f32_plain(dbf, m, one, negate=True), 2)
    bms = f1_bound(dbf, m, 1.0, got)
    log(f"[kernels] F1 1 - dbf * m at {n}^3: {ms:.4f} ms with negate, "
        f"{ms_neg:.4f} ms on a prepared -dbf, {ms_two:.4f} ms with the "
        f"negation pass (the parent's call); torch.addcmul {lib:.4f} ms "
        f"({'bit-equal' if lib_equal else 'NOT bit-equal'}); plain "
        f"{plain:.3f} ms; bound {bms:.4f} ms (bytes)")
    del dbf, m, neg, got
    return {"ms": ms, "plain": plain, "err": err, "bound": bms,
            "library": lib if lib_equal and not any(mism.values()) else None}


class F1Spy:
    """Wraps fma_f32 where the port's modules call it while installed:
    keeps the first inputs of every distinct call (shape, route,
    negate), up to `keep` of them, and the count of calls of each.
    Operands of a million elements or more are kept in host memory, so
    that the runs' peak device memory stays the port's own; `inputs`
    hands them back on the card."""

    SITES = ("gengine", "parallel.gengine", "trace", "engine",
             "ops.geodesic", "ops.xsbatch", "ops.xsarea")

    def __init__(self, tag, keep=48):
        self.tag = tag
        self.keep = keep
        self.kept = {}
        self.calls = {}

    @classmethod
    def modules(cls):
        import importlib

        return [importlib.import_module(f"kimimaro_tpu_torch.{m}")
                for m in cls.SITES]

    @classmethod
    def swap(cls, fn):
        """Put `fn` in place of fma_f32 at every site; returns a restore
        function."""
        mods = cls.modules()
        old = [m.fma_f32 for m in mods]
        for m in mods:
            m.fma_f32 = fn

        def restore():
            for m, f in zip(mods, old):
                m.fma_f32 = f
        return restore

    def install(self):
        import torch

        from kimimaro_tpu_torch.ops import fma

        def spy(a, b, c, negate=False):
            ts = [t for t in (a, b, c) if isinstance(t, torch.Tensor)]
            if ts and ts[0].device.type == "cuda":
                shape = torch.broadcast_shapes(*(t.shape for t in ts))
                route = fma.fma_plan(shape, [
                    t.broadcast_to(shape) if isinstance(t, torch.Tensor)
                    else None for t in (a, b, c)])["route"] if \
                    torch.Size(shape).numel() else "empty"
                key = (tuple(shape), route, bool(negate))
                self.calls[key] = self.calls.get(key, 0) + 1
                if key not in self.kept and len(self.kept) < self.keep:
                    self.kept[key] = tuple(
                        t if not isinstance(t, torch.Tensor)
                        else t.to("cpu", copy=True) if t.numel() >= 1 << 20
                        else t.clone() for t in (a, b, c))
            return fma.fma_f32(a, b, c, negate=negate)

        return self.swap(spy)

    def inputs(self):
        """The kept calls, (key, (a, b, c)) with the operands on the
        card."""
        import torch

        for key, ops in sorted(self.kept.items()):
            yield key, tuple(t.cuda() if isinstance(t, torch.Tensor) else t
                             for t in ops)


def check_f1_recorded(spies):
    """F1 against its plain version on the inputs the main path handed it
    (each distinct call kept by the spies), timed beside torch.addcmul
    and the bound. Returns {key: (ms, plain_ms, bound_ms, library_ms or
    None, calls)} and the max abs error."""
    import torch

    from kimimaro_tpu_torch.ops import fma

    out, err = {}, 0.0
    calls = {}
    for spy in spies:
        for k, v in spy.calls.items():
            calls[k] = calls.get(k, 0) + v
    seen = set()
    for spy in spies:
        for key, (a, b, c) in spy.inputs():
            if key in seen or key[1] == "empty":
                continue
            seen.add(key)
            negate = key[2]
            got = fma.fma_f32(a, b, c, negate=negate)
            want, plain = timed_once(lambda: fma._fma_f32_plain(
                *f1_args(a, b, c), negate=negate))
            err = max(err, require_equal(f"F1 {spy.tag} {key}", got, want))
            del want
            lib_out = addcmul(a, b, c, negate)
            equal = (lib_out.shape == got.shape and torch.equal(
                lib_out.view(torch.int32), got.view(torch.int32)))
            ms = cuda_ms(lambda: fma.fma_f32(a, b, c, negate=negate), 5)
            lib = cuda_ms(lambda: addcmul(a, b, c, negate), 5)
            bound = f1_bound(a, b, c, got)
            out[key] = (ms, plain, bound, lib if equal else None,
                        calls.get(key, 0))
            log(f"[f1] {spy.tag} {key} ({calls.get(key, 0)} main-path "
                f"calls): bit-equal, {ms:.4f} ms vs plain {plain:.3f} ms, "
                f"addcmul {lib:.4f} ms ({'' if equal else 'NOT '}bit-equal),"
                f" bound {bound:.4f} ms")
    rest = sorted(k for k in calls if k not in out)
    log(f"[f1] {len(calls)} distinct main-path calls, {sum(calls.values())} "
        f"launches; {len(rest)} kinds not kept: "
        + "; ".join(f"{k}: {calls[k]}" for k in rest[:40]))
    return out, err


# --------------------------------------------------------------------------- #
# phases 4 to 7: the main path


def blob_volume(seed=0, shape=(40, 36, 30), n_seeds=6):
    """Irregular 26-connected blobs (the fixture of tests/test_gengine.py)."""
    rng = np.random.RandomState(seed)
    vol = np.zeros(shape, dtype=np.uint32)
    x, y, z = np.ogrid[:shape[0], :shape[1], :shape[2]]
    for lab in range(1, n_seeds + 1):
        c = rng.randint(4, np.array(shape) - 4)
        r = rng.randint(3, 7, size=3)
        e = (((x - c[0]) / r[0]) ** 2 + ((y - c[1]) / (r[1] * 1.3)) ** 2
             + ((z - c[2]) / r[2]) ** 2)
        m = (e + rng.rand(*shape) * 0.4) < 1.0
        vol[m & (vol == 0)] = lab
    return vol


def assert_same_skeletons(a, b, what):
    if set(a) != set(b):
        raise AssertionError(f"{what}: labels {sorted(a)} vs {sorted(b)}")
    for k in a:
        sa, sb = a[k], b[k]
        va = sa.vertices[np.lexsort(sa.vertices.T)]
        vb = sb.vertices[np.lexsort(sb.vertices.T)]
        if not np.array_equal(va, vb):
            raise AssertionError(f"{what}: label {k} vertices differ")

        def edges(s):
            v = s.vertices
            return {tuple(sorted((tuple(v[e[0]]), tuple(v[e[1]]))))
                    for e in s.edges}

        if edges(sa) != edges(sb):
            raise AssertionError(f"{what}: label {k} edges differ")
        ra = {tuple(v): r for v, r in zip(sa.vertices, sa.radii)}
        rb = {tuple(v): r for v, r in zip(sb.vertices, sb.radii)}
        if ra != rb:
            raise AssertionError(f"{what}: label {k} radii differ")


def small_main_path():
    import kimimaro_tpu_torch
    from kimimaro_tpu_torch.utils import profiling

    from kimimaro_tpu_torch import kernels

    vol = blob_volume(seed=1)
    x, y, z = np.ogrid[:40, :36, :30]
    vol[((x - 30) ** 2 + (y - 26) ** 2 + ((z - 21) * 0.5) ** 2) <= 49] = 9
    tp = dict(TEASAR, const=30, soma_detection_threshold=80,
              soma_acceptance_threshold=100, soma_invalidation_scale=0.5,
              soma_invalidation_const=0)
    # more manual targets than the crop engine's 16 slots: host trace path
    many = np.bincount(vol.ravel())[1:9].argmax() + 1
    targets = [tuple(int(c) for c in p)
               for p in np.argwhere(vol == many)[::11][:17]]
    out = {}
    launches = None
    for device in ("cuda", "cpu"):
        profiling.reset_stats()
        profiling.collect(True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[device] = kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=tp, anisotropy=ANIS, dust_threshold=10,
            fix_borders=True, extra_targets_before=targets, device=device)
        profiling.collect(False)
        if device == "cuda":
            launches = dict(kernels.LAUNCHES)
        counters = profiling.get_stats()["counters"]
        log(f"[small] device={device}: {len(out[device])} skeletons in "
            f"{time.perf_counter() - t0:.2f} s, counters {counters}")
        if counters.get("crop_engine_jobs", 0) < 1:
            raise AssertionError("the soma-sized label did not reach the "
                                 "crop engine")
        if counters.get("fallback_jobs", 0) < 1:
            raise AssertionError(f"label {many} with 17 manual targets did "
                                 f"not take the host trace path")
    log(f"[small] launches: {json.dumps(launches)}")
    for k in ("sweep_axis0_batched", "sweep_axis0"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was not launched in the small run")
    assert_same_skeletons(out["cpu"], out["cuda"], "cuda vs cpu")
    log("[small] CUDA skeletons equal CPU skeletons (vertices, edges, radii)")

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from oracle_teasar import oracle_teasar, vertex_parity

    rng = np.random.RandomState(7)  # tests/test_swc_parity.py's tube
    tube = np.zeros((48, 16, 8), dtype=bool)
    yy = 6
    for xx in range(2, 46):
        yy = int(np.clip(yy + rng.randint(-1, 2), 2, 12))
        tube[xx, yy: yy + 3, 2:6] = True
    params = {"scale": 1.5, "const": 3.0, "pdrf_scale": 100000,
              "pdrf_exponent": 4}
    kernels.reset_launches()
    skels = kimimaro_tpu_torch.skeletonize(
        tube.astype(np.uint8), teasar_params=params, anisotropy=(1, 1, 1),
        dust_threshold=0, fix_borders=False, device="cuda")
    for k, v in kernels.LAUNCHES.items():
        launches[k] += v
    oracle_v, _ = oracle_teasar(tube, anisotropy=(1, 1, 1),
                                black_border=False, **params)
    parity = vertex_parity(skels[1].vertices.round(), oracle_v,
                           tol_voxels=1.0)
    log(f"[small] oracle vertex parity on the winding tube: "
        f"{parity * 100:.2f}%")
    if parity < 0.99:
        raise AssertionError(f"oracle parity {parity:.4f} < 0.99")
    return launches


def dense_volume(n, seed=0):
    """bench.py's synthetic_volume_dense: an anisotropic Voronoi partition
    with 2,124 labels at 512^3 (nearest seed by KD-tree)."""
    from scipy.spatial import cKDTree

    rng = np.random.RandomState(seed)
    n_labels = max(2, int(round(DENSE_LABELS * (n / 512) ** 3)))
    seeds = rng.randint(0, n, size=(n_labels, 3)).astype(np.float32)
    scale = np.array([16.0, 16.0, 40.0], dtype=np.float32)
    tree = cKDTree(seeds * scale)
    grid = np.stack(np.meshgrid(
        np.arange(n, dtype=np.float32) * scale[0],
        np.arange(n, dtype=np.float32) * scale[1],
        np.arange(n, dtype=np.float32) * scale[2],
        indexing="ij",
    ), axis=-1).reshape(-1, 3)
    labels = np.empty(n * n * n, dtype=np.uint32)
    step = 1 << 22
    for i in range(0, grid.shape[0], step):
        _, idx = tree.query(grid[i:i + step], k=1, workers=-1)
        labels[i:i + step] = idx.astype(np.uint32) + 1
    return labels.reshape(n, n, n)


def hollow_volume(dense, seed=4):
    """bench.py's synthetic_volume_hollow on top of the dense volume:
    interior holes carved into ~150 labels, 20 nested pit labels and two
    soma-scale balls (DBF max past the 1,100 detection threshold)."""
    import scipy.ndimage

    vol = dense.copy()
    n = vol.shape[0]
    rng = np.random.RandomState(seed)
    slcs = scipy.ndimage.find_objects(vol)
    lids = rng.choice(len(slcs), size=min(180, len(slcs)), replace=False)
    nxt = int(vol.max()) + 1
    n_pits = 0
    for k, li in enumerate(lids):
        s = slcs[li]
        if s is None:
            continue
        ext = np.array([x.stop - x.start for x in s])
        if (ext < 8).any():
            continue
        ctr = np.array([(x.start + x.stop) // 2 for x in s])
        r = np.maximum(ext // 5, 2)
        sl = tuple(slice(int(c - rr), int(c + rr)) for c, rr in zip(ctr, r))
        region = vol[sl]
        mine = region == (li + 1)
        if k % 3 == 0 and n_pits < 20:
            region[mine] = nxt  # nested pit label inside the host
            nxt += 1
            n_pits += 1
        else:
            region[mine] = 0  # interior hole
    rs = min(72, max(4, n // 6))
    w = np.arange(-rs, rs + 1)
    ox, oy, oz = np.meshgrid(w, w, w, indexing="ij")
    ball = ox**2 + oy**2 + (oz * 2.5) ** 2 <= rs**2
    for _ in range(2):
        c = rng.randint(rs + 2, n - rs - 2, size=3)
        sl = tuple(slice(int(cc - rs), int(cc + rs + 1)) for cc in c)
        vol[sl][ball] = nxt
        nxt += 1
    return vol


def run_main_path(tag, vol, require, capture=False, b3_spy=None,
                  runs=("first", "second"), **kwargs):
    """skeletonize(vol) on CUDA once per entry of `runs` (by default twice:
    cold, warm), the launch counts reset just before each run and read
    just after it; each run must launch every kernel in `require`. Returns
    (skeletons and counters of the last run, launches summed over the
    runs, and with `capture` the global engine's inputs and results of the
    second run). `b3_spy` is installed for the first run."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import gengine, kernels
    from kimimaro_tpu_torch.utils import profiling

    captured = []
    trace_global = gengine.trace_global

    def spy(cc_dev, dbf_dev, jobs, *args, **kw):
        results, leftover = trace_global(cc_dev, dbf_dev, jobs, *args, **kw)
        # a copy: the caller adds the crop engine's results to the dict
        captured.append((cc_dev, dbf_dev, jobs, dict(results)))
        return results, leftover

    total = {k: 0 for k in kernels.LAUNCHES}
    for run in runs:
        if capture and run == "second":
            gengine.trace_global = spy
        restore_b3 = b3_spy.install() if (b3_spy is not None
                                          and run == "first") else None
        profiling.reset_stats()
        profiling.collect(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            skels = kimimaro_tpu_torch.skeletonize(
                vol, teasar_params=TEASAR, anisotropy=ANIS,
                dust_threshold=1000, fix_borders=True, fix_branching=True,
                device="cuda", **kwargs)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            gengine.trace_global = trace_global
            if restore_b3 is not None:
                restore_b3()
            profiling.collect(False)
        launches = dict(kernels.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        stats = profiling.get_stats()
        phases = {k: round(v, 3) for k, v in stats["phases"].items()}
        peak = torch.cuda.max_memory_allocated()
        log(f"[{tag}] {run} run: {secs:.2f} s, {len(skels)} skeletons, "
            f"{len(skels) / secs:.1f} labels/s, peak device memory "
            f"{peak / 2**30:.2f} GiB ({(peak - held) / 2**30:.2f} GiB above "
            f"the {held / 2**30:.2f} GiB held at the run's start)")
        log(f"[{tag}] {run} run phases (s): {json.dumps(phases)}")
        log(f"[{tag}] {run} run counters: {json.dumps(stats['counters'])}")
        log(f"[{tag}] {run} run launches: {json.dumps(launches)}")
        for k in require:
            if launches[k] <= 0:
                raise AssertionError(f"{k} was not launched in the {tag} "
                                     f"{run} run")
        bad = [k for k, s in skels.items()
               if s.empty() or not np.isfinite(s.vertices).all()]
        if bad:
            raise AssertionError(f"{tag}: labels {bad[:10]} have empty or "
                                 f"non-finite skeletons")
    return skels, stats["counters"], total, (captured[0] if captured
                                             else None)


ROUTING = ("gengine_iterations", "gengine_taint_capacity", "gengine_jobs",
           "crop_engine_jobs")


def log_routing(tag, counters):
    """The global engine's iterations, the labels its selective bail
    handed to the crop engine, and the jobs of either engine."""
    log(f"[{tag}] routing: " + ", ".join(f"{k} {counters.get(k, 0)}"
                                         for k in ROUTING))


def dense_main_path(vol):
    """Returns (skeletons, the global engine's inputs and results, launches,
    the B3 calls recorded in the first run, C1's kernel-table rows from
    the crop engine's chase calls of both runs)."""
    n = vol.shape[0]
    b3_spy = B3Spy()
    chase_spy = ChaseSpy()
    restore = chase_spy.install()
    try:
        skels, counters, launches, captured = run_main_path(
            "dense", vol, ("gsweep_sweep0", "gsweep_sweep0_dual",
                           "crop_argmax", "chase_batched"),
            capture=True, b3_spy=b3_spy)
    finally:
        restore()
    if len(skels) < 0.9 * DENSE_LABELS * (n / 512) ** 3:
        raise AssertionError(f"dense run: only {len(skels)} skeletons")
    log_routing("dense", counters)
    # more than 500 live labels: the selective bail hands the lock-step
    # loop's last active labels to the crop engine
    if counters.get("gengine_taint_capacity", 0) == 0:
        raise AssertionError("dense run: the global engine handed no label "
                             "back (gengine_taint_capacity 0)")
    # one B3 call per grouped argmax: the root selection and one per path
    # iteration, whatever the number of crop tiers
    want = 2 * (counters["gengine_iterations"] + 1)
    if launches["crop_argmax"] != want:
        raise AssertionError(f"dense runs: {launches['crop_argmax']} B3 "
                             f"calls, expected {want}")
    c1_rows = chase_rows("dense", chase_spy, launches, counters, 2, False)
    return skels, captured, launches, b3_spy, c1_rows


def hollow_main_path(vol):
    """The soma volume: both balls go to the crop engine, and every label
    with a component above the dust threshold gets a skeleton. Returns
    (skeletons, launches, C1's kernel-table rows from the crop engine's
    chase calls of both runs)."""
    import scipy.ndimage

    chase_spy = ChaseSpy()
    restore = chase_spy.install()
    try:
        skels, counters, launches, _ = run_main_path(
            "soma", vol, ("sweep_axis0_batched", "chase_batched"),
            fill_holes=False, fix_avocados=False)
    finally:
        restore()
    log_routing("soma", counters)
    if counters.get("crop_engine_jobs", 0) < 2:
        raise AssertionError(f"soma volume: crop_engine_jobs "
                             f"{counters.get('crop_engine_jobs', 0)} < 2")
    counts = np.bincount(vol.ravel())
    missing = [int(k) for k in np.flatnonzero(counts > 1000)
               if k != 0 and int(k) not in skels]
    slcs = scipy.ndimage.find_objects(vol) if missing else []
    for k in missing:
        comp, _ = scipy.ndimage.label(vol[slcs[k - 1]] == k,
                                      structure=np.ones((3, 3, 3)))
        if np.bincount(comp.ravel())[1:].max() > 1000:
            raise AssertionError(f"soma volume: label {k} has no skeleton")
    log(f"[soma] every label with a component above the dust threshold has "
        f"a skeleton ({len(skels)}; {len(missing)} labels split into "
        f"dust only)")
    return skels, launches, chase_rows("soma", chase_spy, launches, counters,
                                       2, False)


def global_pdrf_formula():
    """Install the global engine's PDRF formula (`gengine.pdrf_kernel`) in
    place of `_pdrf_kernel` in the crop engine and the host trace path;
    returns the function that restores it. The reference's engines round
    the PDRF differently: its global engine takes M = 1 /
    maxflood(dbf^1.01) and the trickle DAF x (1 / max DAF), fused with the
    DAF product; its crop engine and host path take M = dbf_max^-1.01 and
    DAF / max DAF, fused with the p product. With each engine's own
    formula the skeletons of some labels differ between engines, in the
    port as in the reference (scripts/jax_engine_agreement.py); the
    cross-checks hold the rest of the engines' machinery equal under one
    formula."""
    from kimimaro_tpu_torch import engine, gengine
    from kimimaro_tpu_torch import trace as trace_mod

    inner = trace_mod._pdrf_kernel
    trace_mod._pdrf_kernel = engine._pdrf_kernel = gengine.pdrf_kernel

    def restore():
        trace_mod._pdrf_kernel = engine._pdrf_kernel = inner

    return restore


def cross_check(captured):
    """The global engine against the host trace path on 8 of its labels
    of the dense run (the equality chain the JAX package's tests pin),
    under the global engine's PDRF formula."""
    import torch

    from kimimaro_tpu_torch import engine
    from kimimaro_tpu_torch import trace as trace_mod
    from kimimaro_tpu_torch.skeleton import Skeleton

    cc_dev, dbf_dev, jobs, results = captured
    by_segid = {j["segid"]: j for j in jobs}
    rng = np.random.RandomState(0)
    picks = rng.choice(sorted(results), size=8, replace=False)
    restore = global_pdrf_formula()
    try:
        for segid in picks:
            job = by_segid[int(segid)]
            mn, shape = job["offset"], job["shape"]
            slc = tuple(slice(int(a), int(a + s))
                        for a, s in zip(mn, shape))
            crop = cc_dev[slc] == int(segid)
            host = trace_mod.trace(
                crop, torch.where(crop, dbf_dev[slc], 0.0), anisotropy=ANIS,
                fix_branching=True,
                manual_targets_before=list(job["before"]),
                manual_targets_after=list(job["after"]), root=job["root"],
                device="cuda", **TEASAR)
            eng = engine.paths_to_skeleton(results[segid], ANIS)
            if not Skeleton.equivalent(host, eng):
                raise AssertionError(f"label {segid}: global engine and "
                                     f"host trace disagree")
    finally:
        restore()
    log(f"[dense] 8 global-engine labels {sorted(int(s) for s in picks)} "
        f"equal their host-trace skeletons (the global engine's PDRF "
        f"formula)")


@contextlib.contextmanager
def bail_off():
    """The global engine without its selective bail (gengine.BAIL_ACTIVE
    0) inside the block."""
    from kimimaro_tpu_torch import gengine

    bail = gengine.BAIL_ACTIVE
    gengine.BAIL_ACTIVE = 0
    try:
        yield
    finally:
        gengine.BAIL_ACTIVE = bail


def same_paths(a, b):
    """Two labels' global-engine paths equal bit for bit."""
    return b is not None and len(a) == len(b) and all(
        np.array_equal(va, vb) and np.array_equal(ra, rb)
        for (va, ra), (vb, rb) in zip(a, b))


def crop_cross_check(captured):
    """64 dense labels of one crop bucket, and the labels the global
    engine's selective bail handed to the crop engine, through the crop
    engine on the card (B4 at full lane width on real crops) against their
    global-engine skeletons. Those of the handed-back labels come from the
    global engine run again with the bail off, whose paths of every other
    label must equal the dense run's bit for bit. Labels with a voxel in
    the 3x3x3 block at their crop's far corner are left out: padding rows
    of the crop engine's path buffer address that corner (the JAX engine's
    wrapped negative indices, kept by the port), so the two engines may
    differ there."""
    from kimimaro_tpu_torch import engine, gengine
    from kimimaro_tpu_torch.skeleton import Skeleton

    cc_dev, dbf_dev, jobs, results = captured
    vol_shape = np.asarray(cc_dev.shape)
    cc = cc_dev.cpu().numpy()

    t0 = time.perf_counter()
    with bail_off():
        full, _ = gengine.trace_global(cc_dev, dbf_dev, jobs, TEASAR, ANIS,
                                       True)
    secs_full = time.perf_counter() - t0
    for s, paths in results.items():
        if not same_paths(paths, full.get(s)):
            raise AssertionError(f"label {s}: the global engine's paths "
                                 f"differ with the bail off")
    bailed = sorted(s for s in full if s not in results)
    if not bailed:
        raise AssertionError("the dense run's global engine handed no "
                             "label back that it traces with the bail off")

    def bshape(job):
        return tuple(min(engine._bucket_dim(int(s)), int(v))
                     for s, v in zip(job["shape"], vol_shape))

    def corner_clear(job):
        b = np.asarray(bshape(job))
        off = np.maximum(np.minimum(job["offset"], vol_shape - b), 0)
        c = off + b - 1
        sl = tuple(slice(max(int(x) - 1, 0), int(x) + 2) for x in c)
        return not (cc[sl] == job["segid"]).any()

    traced = [j for j in jobs if j["segid"] in results]
    shapes = {}
    for j in traced:
        shapes.setdefault(bshape(j), []).append(j)
    common = max(shapes, key=lambda k: len(shapes[k]))
    clear = [j for j in shapes[common] if corner_clear(j)]
    rng = np.random.RandomState(0)
    picks = [clear[i] for i in sorted(rng.choice(len(clear), size=64,
                                                 replace=False))]
    handed = [j for j in jobs if j["segid"] in set(bailed)]
    handed_clear = [j for j in handed if corner_clear(j)]
    picks += handed_clear
    spy = B4Spy("crop cross-check")
    restore = spy.install()
    restore_pdrf = global_pdrf_formula()
    t0 = time.perf_counter()
    try:
        got, fallback = engine.trace_batched(cc_dev, dbf_dev, picks, TEASAR,
                                             ANIS, True)
    finally:
        restore_pdrf()
        restore()
    secs = time.perf_counter() - t0
    if fallback:
        raise AssertionError(f"crop engine fell back on "
                             f"{[j['segid'] for j in fallback]}")
    for j in picks:
        s = j["segid"]
        a = engine.paths_to_skeleton(got[s], ANIS)
        b = engine.paths_to_skeleton(full[s], ANIS)
        if not Skeleton.equivalent(a, b):
            raise AssertionError(f"label {s}: crop engine and global engine "
                                 f"disagree")
    log(f"[crop] the global engine with the bail off ({secs_full:.2f} s) "
        f"traces the {len(results)} labels of the dense run bit-equal and "
        f"the {len(bailed)} it handed back")
    log(f"[crop] 64 dense labels of bucket {common} ({len(shapes[common])} "
        f"in it, {len(shapes[common]) - len(clear)} left out at the crop "
        f"corner) and {len(handed_clear)} of the {len(handed)} handed-back "
        f"labels ({len(handed) - len(handed_clear)} left out at the crop "
        f"corner) traced by the crop engine in {secs:.2f} s equal their "
        f"global-engine skeletons (the global engine's PDRF formula)")
    return spy


# --------------------------------------------------------------------------- #
# phase 8: cross sections (kernels B6 and X1, and B4 on the dense rung)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3, published
ALU_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores, published
# integer operations per window cell and round of kernel X1 (the dilation:
# eight re-based neighbours of ~10 operations, the centre and the mask;
# the sweep: four directed passes of three neighbours and the in-word fill)
X1_OPS_PER_CELL_ROUND = {"dilate": 87, "sweep": 224}


class XsSpy:
    """Wraps the B6 and X1 wrappers while installed: keeps the first
    inputs of every distinct shape (and method and rounds) they are
    handed, and the count of calls and lanes per shape."""

    def __init__(self, tag):
        self.tag = tag
        self.fetch = {}
        self.flood = {}
        self.calls = {}

    def install(self):
        from kimimaro_tpu_torch.ops import xsfetch, xsslab

        fetch, flood = xsfetch.fetch_secb, xsslab.section_flood

        def fetch_spy(volp, zb, wx0, wy0, labels):
            key = ("fetch_secb", tuple(zb.shape[1:]))
            self._count(key, zb.shape[0])
            if key not in self.fetch:
                self.fetch[key] = (volp, zb.clone(), wx0.clone(), wy0.clone(),
                                   labels.clone())
            return fetch(volp, zb, wx0, wy0, labels)

        def flood_spy(seed, secb, zb, rounds, method):
            key = ("section_flood", tuple(seed.shape[1:]), method, rounds)
            self._count(key, seed.shape[0])
            if key not in self.flood:
                self.flood[key] = (seed.clone(), secb.clone(), zb.clone(),
                                   rounds, method)
            return flood(seed, secb, zb, rounds, method)

        xsfetch.fetch_secb, xsslab.section_flood = fetch_spy, flood_spy
        return lambda: self._restore(fetch, flood)

    def _count(self, key, lanes):
        calls, n = self.calls.get(key, (0, 0))
        self.calls[key] = (calls + 1, n + int(lanes))

    @staticmethod
    def _restore(fetch, flood):
        from kimimaro_tpu_torch.ops import xsfetch, xsslab

        xsfetch.fetch_secb, xsslab.section_flood = fetch, flood


def x1_rung(key):
    """The rung width of an X1 call's key: the smallest of the rung menu's
    widths (32 for the dilation; 64, 128, 512 for the sweep) that holds
    its window (windows are cut to the volume)."""
    _, (Wx, Wy), method, _ = key
    if method == "dilate":
        return "W=32 dilate"
    w = max(Wx, Wy)
    return "W=" + str(next((r for r in (64, 128) if w <= r), 512))


def b6_bound_ms(volp, zb, wx0, wy0):
    """Least time of one B6 call on these inputs: the distinct volume
    cells the windows read, the zb words and the output words, each moved
    once, over the HBM rate."""
    import torch

    tx, ty, tz = volp.shape
    B, Wx, Wy = zb.shape
    dev = volp.device
    seen = torch.zeros(volp.numel(), dtype=torch.bool, device=dev)
    for b in range(0, B, 256):
        z = zb[b:b + 256].long()[..., None] + torch.arange(5, device=dev)
        gx = wx0[b:b + 256].long().view(-1, 1, 1, 1) + torch.arange(
            Wx, device=dev).view(1, Wx, 1, 1)
        gy = wy0[b:b + 256].long().view(-1, 1, 1, 1) + torch.arange(
            Wy, device=dev).view(1, 1, Wy, 1)
        flat = (gx * ty + gy) * tz + z
        seen[flat[(z >= 0) & (z < tz)]] = True
    nbytes = 4 * int(seen.sum()) + 2 * 4 * zb.numel() + 3 * 4 * B
    return 1e3 * nbytes / HBM_BYTES_PER_S


def b6_rung(key):
    """The rung width of a B6 call's key: the smallest of the rung menu's
    widths (32, 64, 128, 512) that holds its window."""
    w = max(key[1])
    return "W=" + str(next((r for r in (32, 64, 128) if w <= r), 512))


def check_b6_depths(spy):
    """B6's scalar path at the main path's shapes: the dense run's
    recorded calls of each rung width on the volume cut to tz - 1 and
    tz - 2 along z (tz % 4 != 0: five 4-byte loads a cell), bit-equal to
    the plain version and timed beside the vector path on the volume as
    it was. Returns the max abs error."""
    import torch

    from kimimaro_tpu_torch.ops import xsfetch

    err = 0.0
    by_rung = {}
    for key in spy.fetch:
        r = b6_rung(key)
        if r not in by_rung or spy.calls[key][1] > spy.calls[by_rung[r]][1]:
            by_rung[r] = key
    cut = {}
    for rung, key in sorted(by_rung.items()):
        volp, zb, wx0, wy0, labels = spy.fetch[key]
        tz = volp.shape[2]
        ms_vec = cuda_ms(lambda: xsfetch.fetch_secb(volp, zb, wx0, wy0,
                                                    labels), 5)
        for d in (1, 2):
            if (id(volp), d) not in cut:
                cut[id(volp), d] = volp[:, :, :tz - d].contiguous()
            v = cut[id(volp), d]
            if xsfetch.fetch_plan(v, zb)["vector"]:
                raise AssertionError("B6: a volume of tz % 4 != 0 took "
                                     "the vector path")
            got = xsfetch.fetch_secb(v, zb, wx0, wy0, labels)
            want = xsfetch._fetch_secb_plain(v, zb, wx0, wy0, labels)
            err = max(err, require_equal(f"B6 scalar path {key} tz "
                                         f"{tz - d}", got, want))
            ms = cuda_ms(lambda: xsfetch.fetch_secb(v, zb, wx0, wy0,
                                                    labels), 5)
            log(f"[xs] B6 {rung} {zb.shape[0]} lanes of {key[1]}: scalar "
                f"path on tz = {tz - d} bit-equal, {ms:.4f} ms; vector path "
                f"on tz = {tz} {ms_vec:.4f} ms")
    return err


def x1_bound(seed, run, method):
    """Least time of one X1 call on these inputs: four words per cell
    moved once over the HBM rate, against the integer operations of the
    rounds this data ran over the 32-bit ALU peak. Returns (ms, by)."""
    B, Wx, Wy = seed.shape
    t_bytes = 4 * 4 * seed.numel() / HBM_BYTES_PER_S
    ops = X1_OPS_PER_CELL_ROUND[method] * Wx * Wy * int(run.sum())
    t_ops = ops / ALU_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def check_xs_small(gen):
    """B6 and X1 against their plain versions at small shapes: windows on
    the volume faces, cells whose z leaves the volume, both flood methods,
    shared-memory and device-memory planes, lanes that never converge."""
    import torch

    from kimimaro_tpu_torch.ops import xsfetch, xsslab

    err = 0.0
    tx, ty, tz = 37, 29, 23
    vol = torch.randint(0, 4, (tx, ty, tz), generator=gen, device="cuda",
                        dtype=torch.int32)
    B, Wx, Wy = 6, 13, 17
    wx0 = torch.tensor([0, tx - Wx, 5, 11, 0, 24], dtype=torch.int32,
                       device="cuda")
    wy0 = torch.tensor([0, ty - Wy, 3, 0, 12, 7], dtype=torch.int32,
                       device="cuda")
    labels = torch.tensor([1, 2, 3, 1, 0, 9], dtype=torch.int32,
                          device="cuda")
    zb = torch.randint(-6, tz + 2, (B, Wx, Wy), generator=gen, device="cuda",
                       dtype=torch.int32)
    err = max(err, require_equal(
        "B6 small", xsfetch.fetch_secb(vol, zb, wx0, wy0, labels),
        xsfetch._fetch_secb_plain(vol, zb, wx0, wy0, labels)))
    log("[xs] B6 bit-equal on 6 lanes of (13, 17) windows in (37, 29, 23): "
        "windows on the faces, z outside the volume, absent labels")
    never = 0
    forms = {}
    # the dilation on each side of its rule: one warp a lane with the
    # window in registers (one cell, a row narrower than a warp, 32 x 32,
    # one row or column past a warp: two columns a thread, the per-label
    # rung's 64 x 64 at its 96 rounds), one CTA a lane beyond (65 x 3, and
    # 100 x 97 in device memory); the sweep on each side of
    # section_flood_plan's rule: one CTA of a warp per 32 columns a lane up
    # to 256 columns in shared memory (13 ... 200), one cluster a lane
    # (256 x 256, 250 x 250 and the W = 512 window), one CTA a lane with
    # the window in device memory (a row of 4100 columns, beyond the
    # cluster's 16 warps x 8)
    for method, Wx, Wy, rounds in (
            ("dilate", 1, 1, 0), ("dilate", 5, 31, 1), ("dilate", 32, 32, 36),
            ("dilate", 33, 17, 36), ("dilate", 17, 33, 2),
            ("dilate", 64, 64, 96), ("dilate", 64, 33, 1),
            ("dilate", 65, 3, 4), ("dilate", 13, 10, 1),
            ("dilate", 32, 29, 36),
            ("dilate", 100, 97, 8), ("sweep", 13, 10, 0),
            ("sweep", 64, 61, 6), ("sweep", 128, 125, 2),
            ("sweep", 200, 197, 1), ("sweep", 250, 250, 1),
            ("sweep", 256, 256, 1), ("sweep", 512, 509, 1),
            ("sweep", 20, 4100, 0)):
        form = xsslab.section_flood_plan(Wx, Wy, method)[0]
        forms[form] = forms.get(form, 0) + 1
        B = 5 if Wx * Wy <= 128 * 128 else 3
        secb = (torch.randint(0, 32, (B, Wx, Wy), generator=gen,
                              device="cuda", dtype=torch.int32)
                & torch.randint(0, 32, (B, Wx, Wy), generator=gen,
                                device="cuda", dtype=torch.int32))
        secb = torch.where(torch.rand(secb.shape, generator=gen,
                                      device="cuda") < 0.75, secb, 0)
        ii = torch.arange(Wx, device="cuda").view(1, Wx, 1)
        jj = torch.arange(Wy, device="cuda").view(1, 1, Wy)
        slope = torch.rand((2, B, 1, 1), generator=gen, device="cuda") * 2 - 1
        zb = (torch.floor(slope[0] * ii + slope[1] * jj).to(torch.int32) - 2)
        # empty columns may hold any zb: the packed forms never read it
        zb = torch.where(secb != 0, zb, zb + (1 << 20))
        seed = torch.zeros_like(secb)
        seed[:, Wx // 2, Wy // 2] = 31
        seed &= secb
        got = xsslab.section_flood(seed, secb, zb, rounds, method)
        again = xsslab.section_flood(seed, secb, zb, rounds, method)
        want = xsslab._section_flood_plain(seed, secb, zb, rounds, method)
        err = max(err, require_equal(
            f"X1 {method} {(Wx, Wy)} rounds={rounds} ({form})", got, want))
        require_equal(f"X1 {method} {(Wx, Wy)} run twice", again, got)
        never += int(got[1].sum())
    if never == 0:
        raise AssertionError("X1 small checks: no lane ran out of rounds")
    want = {("dilate", 64, 64): "lane_warp", ("dilate", 65, 3): "lane_cta",
            ("dilate", 100, 97): "lane_cta"}
    for (method, Wx, Wy), form in want.items():
        got_form = xsslab.section_flood_plan(Wx, Wy, method)[0]
        if got_form != form:
            raise AssertionError(f"X1 {method} {(Wx, Wy)}: form {got_form}, "
                                 f"expected {form}")
    log(f"[xs] X1 bit-equal, twice, at small shapes and on each side of "
        f"section_flood_plan's rules (forms {json.dumps(forms)}), zb out of "
        f"int16 in empty columns; {never} lanes ran out of rounds")
    return err


def xs_select(skels):
    """bench.py's selection: the largest skeletons until at least 12,000
    vertices."""
    sel, nv = [], 0
    for s in sorted(skels.values(), key=len, reverse=True):
        sel.append(s)
        nv += len(s)
        if nv >= 12000:
            break
    return sel, nv


def xs_run(tag, vol, sel, spy=None):
    """cross_sectional_area(vol, sel) on the card twice (with `spy`
    installed), the launch counts reset just before each run and read just
    after it. Returns (skeletons of the second run, counters, seconds
    of the second run, launches summed over both runs)."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    total = {k: 0 for k in kernels.LAUNCHES}
    for run in ("first", "second"):
        # the spy counts the calls of both runs and keeps the first inputs
        # of every shape
        restore = spy.install() if spy is not None else None
        skels = {s.id: s.clone() for s in sel}
        profiling.reset_stats()
        profiling.collect(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        t0 = time.perf_counter()
        try:
            kimimaro_tpu_torch.cross_sectional_area(
                vol, skels, anisotropy=ANIS, device="cuda")
            torch.cuda.synchronize()
        finally:
            if restore is not None:
                restore()
            profiling.collect(False)
        secs = time.perf_counter() - t0
        launches = dict(kernels.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        counters = profiling.get_stats()["counters"]
        nv = sum(len(s) for s in sel)
        log(f"[{tag}] {run} run: {len(sel)} skeletons, {nv} vertices, "
            f"{secs:.3f} s, {1000 * secs / nv:.4f} ms/vertex, peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"[{tag}] {run} run counters: {json.dumps(counters)}")
        log(f"[{tag}] {run} run launches: {json.dumps(launches)}")
        for k in ("fetch_secb", "section_flood"):
            if launches[k] <= 0:
                raise AssertionError(f"{k} was not launched in the {tag} "
                                     f"{run} run")
        for s in skels.values():
            a = s.cross_sectional_area
            if a.shape != (len(s),) or not np.isfinite(a).all():
                raise AssertionError(f"{tag}: label {s.id} has bad areas")
    return skels, counters, secs, total


def xs_equal_cpu(tag, vol, sel, factor=4):
    """The same call on the card and on the CPU (plain versions of every
    kernel) agree: contacts exact, areas within rtol 1e-5 (f32 sums taken
    in another order). Both take the skeletons downsampled by `factor`:
    the same section widths at fewer vertices, for the plain floods are
    Python loops of window rows."""
    import kimimaro_tpu_torch

    t0 = time.perf_counter()
    sel = [s.downsample(factor) for s in sel]
    got, want = (kimimaro_tpu_torch.cross_sectional_area(
        vol, {s.id: s.clone() for s in sel}, anisotropy=ANIS, device=device)
        for device in ("cuda", "cpu"))
    for s in sel:
        a, b = got[s.id], want[s.id]
        np.testing.assert_allclose(a.cross_sectional_area,
                                   b.cross_sectional_area, rtol=1e-5, atol=0,
                                   err_msg=f"{tag} label {s.id}")
        np.testing.assert_array_equal(a.cross_sectional_area_contacts,
                                      b.cross_sectional_area_contacts,
                                      err_msg=f"{tag} label {s.id}")
    log(f"[{tag}] CPU run of {len(sel)} skeletons ({sum(len(s) for s in sel)}"
        f" vertices, {time.perf_counter() - t0:.1f} s) equals the card's")


def check_xs_recorded(spy):
    """B6 and X1 against their plain versions on the inputs the main path
    handed them, one batch per shape; W = 512 floods on the four lanes
    that ran the fewest rounds (the plain sweep is a Python loop of rows).
    Returns {key: (ms, plain_ms, bound_ms, bound_by, lanes)}."""
    import torch

    from kimimaro_tpu_torch.ops import xsfetch, xsslab

    out = {}
    err = 0.0
    for key, (volp, zb, wx0, wy0, labels) in sorted(spy.fetch.items()):
        got = xsfetch.fetch_secb(volp, zb, wx0, wy0, labels)
        want, plain = timed_once(lambda: xsfetch._fetch_secb_plain(
            volp, zb, wx0, wy0, labels))
        err = max(err, require_equal(f"B6 {spy.tag} {key}", got, want))
        ms = cuda_ms(lambda: xsfetch.fetch_secb(volp, zb, wx0, wy0, labels),
                     5)
        bound = b6_bound_ms(volp, zb, wx0, wy0)
        out[key] = (ms, plain, bound, "bytes", zb.shape[0])
        log(f"[xs] B6 {spy.tag} {zb.shape[0]} lanes of {key[1]} in "
            f"{tuple(volp.shape)}: bit-equal, {ms:.4f} ms vs plain "
            f"{plain:.3f} ms, bound {bound:.4f} ms")
    for key, (seed, secb, zb, rounds, method) in sorted(
            spy.flood.items()):
        got = xsslab.section_flood(seed, secb, zb, rounds, method)
        ms_all = cuda_ms(lambda: xsslab.section_flood(
            seed, secb, zb, rounds, method), 3)
        lanes = seed.shape[0]
        form = xsslab.section_flood_plan(key[1][0], key[1][1], method)[0]
        if seed.shape[1] >= 512:
            # the plain sweep is a Python loop of rows: kernel and plain
            # version on the four lanes that ran the fewest rounds
            pick = torch.argsort(got[2], stable=True)[:4]
            seed, secb, zb = seed[pick], secb[pick], zb[pick]
            got = xsslab.section_flood(seed, secb, zb, rounds, method)
        want, plain = timed_once(lambda: xsslab._section_flood_plain(
            seed, secb, zb, rounds, method))
        err = max(err, require_equal(f"X1 {spy.tag} {key}", got, want))
        ms = cuda_ms(lambda: xsslab.section_flood(seed, secb, zb, rounds,
                                                  method), 3)
        bound, by = x1_bound(seed, got[2], method)
        out[key] = (ms, plain, bound, by, seed.shape[0])
        log(f"[xs] X1 {spy.tag} {lanes} lanes of {key[1]} {method} "
            f"rounds={rounds} ({x1_rung(key)}, form {form}): {ms_all:.4f} "
            f"ms; on {seed.shape[0]} lanes bit-equal, rounds run "
            f"{int(got[2].min())}-{int(got[2].max())}, {ms:.4f} ms vs plain "
            f"{plain:.3f} ms, bound {bound:.4f} ms ({by})")
    return out, err


def per_label_path():
    """cross_sectional_area_single and fill_holes=True on the blob fixture
    of phase 4, CUDA against CPU, and ops.xsarea.cross_section_areas with
    zero normals, which go to the dense rungs (kernel B4). Returns the
    launches of its CUDA runs."""
    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.ops import xsarea

    vol = blob_volume(seed=1)
    skels = kimimaro_tpu_torch.skeletonize(
        vol, teasar_params=dict(TEASAR, const=30), anisotropy=ANIS,
        dust_threshold=10, device="cpu")
    lab = max(skels, key=lambda k: len(skels[k]))
    binimg = vol == lab
    verts = np.argwhere(binimg)[::25]
    normals = np.tile(np.float32([[0.0, 0.6, 0.8]]), (len(verts), 1))
    normals[:3] = 0.0
    out = {}
    total = {k: 0 for k in kernels.LAUNCHES}
    xs_spy, b4_spy = XsSpy("label"), B4Spy("label")
    for device in ("cuda", "cpu"):
        restore = ([xs_spy.install(), b4_spy.install()] if device == "cuda"
                   else [])
        kernels.reset_launches()
        try:
            single = kimimaro_tpu_torch.cross_sectional_area_single(
                binimg, skels[lab].clone(), anisotropy=ANIS,
                smoothing_window=3, device=device)
            filled = kimimaro_tpu_torch.cross_sectional_area(
                vol, {k: s.clone() for k, s in skels.items()},
                anisotropy=ANIS, fill_holes=True, device=device)
            dense = xsarea.cross_section_areas(binimg, verts, normals, ANIS,
                                               device=device)
        finally:
            for r in restore:
                r()
        if device == "cuda":
            launches = dict(kernels.LAUNCHES)
            for k in ("fetch_secb", "section_flood", "sweep_axis0_batched"):
                if launches[k] <= 0:
                    raise AssertionError(f"{k} was not launched on the "
                                         f"per-label path")
            for k, v in launches.items():
                total[k] += v
        out[device] = (single, filled, dense)
    (sa, fa, da), (sb, fb, db) = out["cuda"], out["cpu"]
    pairs = [(sa, sb)] + [(fa[k], fb[k]) for k in skels]
    for a, b in pairs:
        np.testing.assert_allclose(a.cross_sectional_area,
                                   b.cross_sectional_area, rtol=1e-5, atol=0)
        np.testing.assert_array_equal(a.cross_sectional_area_contacts,
                                      b.cross_sectional_area_contacts)
    np.testing.assert_allclose(da[0], db[0], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(da[1], db[1])
    log(f"[xs-label] cross_sectional_area_single (label {lab}, "
        f"{len(skels[lab])} vertices), fill_holes over {len(skels)} labels "
        f"and {len(verts)} dense-rung planes (3 zero normals): CUDA equals "
        f"CPU; launches {json.dumps(total)}")
    return total, xs_spy, b4_spy


def cross_sections(dense, dense_skels, hollow, soma_skels, gen, f1_spy):
    """Phase 8, with `f1_spy` recording F1 over its main-path runs.
    Returns (launches summed over its main-path runs, the kernel-table
    entries of B6 and X1, the max abs error, B4's per-label recorder)."""
    import torch

    err_small = check_xs_small(gen)
    restore_f1 = f1_spy.install()

    sel, nv = xs_select(dense_skels)
    dspy = XsSpy("dense")
    _, counters, secs, launches = xs_run("xs-dense", dense, sel, dspy)
    log(f"[xs-dense] ms/vertex {1000 * secs / nv:.4f} over {nv} vertices of "
        f"{len(sel)} skeletons (warm run {secs:.3f} s)")
    # the CPU subset: the selection's smallest skeletons up to 300
    # vertices (the plain floods are Python loops of window rows)
    small, nsmall = [], 0
    for s in sorted(sel, key=len):
        if small and nsmall + len(s) > 300:
            break
        small.append(s)
        nsmall += len(s)

    balls = [soma_skels[k] for k in sorted(soma_skels)[-2:]]
    sspy = XsSpy("soma")
    _, scount, ssecs, slaunches = xs_run("xs-soma", hollow, balls, sspy)
    if scount.get("xsb_rung3_queries", 0) <= 0:
        raise AssertionError(f"soma balls: no query reached rung 3 "
                             f"({scount})")

    llaunches, lspy, b4_label = per_label_path()
    restore_f1()
    xs_equal_cpu("xs-dense", dense, small)
    xs_equal_cpu("xs-soma", hollow, [min(balls, key=len)])
    for part in (slaunches, llaunches):
        for k, v in part.items():
            launches[k] += v

    spies = (dspy, sspy, lspy)
    for spy in spies:
        log(f"[xs] {spy.tag} shapes handed to B6/X1 (calls, lanes): "
            + "; ".join(f"{k}: {v}" for k, v in sorted(spy.calls.items())))
    timings = {}
    errs = [err_small]
    for spy in spies:
        t, e = check_xs_recorded(spy)
        errs.append(e)
        for key, v in t.items():
            if key not in timings or v[4] > timings[key][4]:
                timings[key] = v
    errs.append(check_b6_depths(dspy))
    torch.cuda.synchronize()
    err = max(errs)
    # the table's rows: each kernel at the dense run's most used shape, and
    # B6 and X1 at each rung width, at its shape of the most lanes
    rep = {}
    for name in ("fetch_secb", "section_flood"):
        key = max((k for k in dspy.calls if k[0] == name),
                  key=lambda k: dspy.calls[k][1])
        rep[name] = (key, timings[key])
    for name, rung_of, tag in (("section_flood", x1_rung, "x1_rungs"),
                               ("fetch_secb", b6_rung, "b6_rungs")):
        rows = {}
        for spy in spies:
            for key, (calls, _) in spy.calls.items():
                if key[0] != name:
                    continue
                row = rows.setdefault(rung_of(key), [0, None])
                row[0] += calls
                if row[1] is None or timings[key][4] > timings[row[1]][4]:
                    row[1] = key
        rep[tag] = {r: (c, k, timings[k]) for r, (c, k) in rows.items()}
    return launches, rep, err, b4_label


# --------------------------------------------------------------------------- #
# phase 9: the host-stage path (fill_holes, fix_avocados), postprocess,
# streaming and the chunked protocol


class HostStageSpy:
    """While installed, keeps the input and output of `fill_all_holes`
    and of `engage_avocado_protection` (with both remappings) of the last
    skeletonize run. Neither function writes its input."""

    def __init__(self):
        self.fill = None
        self.avocado = None

    def install(self):
        from kimimaro_tpu_torch import intake

        fill_inner = intake.fill_all_holes
        avo_inner = intake.engage_avocado_protection

        def fill_spy(cc_labels, *a, **kw):
            out = fill_inner(cc_labels, *a, **kw)
            self.fill = (cc_labels, out)
            return out

        def avo_spy(cc_labels, all_dbf, remapping, *a, **kw):
            out = avo_inner(cc_labels, all_dbf, remapping, *a, **kw)
            self.avocado = (cc_labels, dict(remapping), out[0], out[2])
            return out

        intake.fill_all_holes = fill_spy
        intake.engage_avocado_protection = avo_spy

        def restore():
            intake.fill_all_holes = fill_inner
            intake.engage_avocado_protection = avo_inner

        return restore


def serial_fill(cc_labels):
    """kimimaro's serial per-label hole filling (tests/test_ops_fill.py's
    oracle): scipy's binary_fill_holes of each label's box, in label
    order, a label absorbed by an earlier fill skipped. Returns (labels,
    voxels filled)."""
    import scipy.ndimage

    cc_labels = np.copy(cc_labels)
    labels = np.flatnonzero(np.bincount(cc_labels.ravel()))
    labels_set = set(int(u) for u in labels if u != 0)
    all_slices = scipy.ndimage.find_objects(cc_labels)
    filled_px = 0
    for label in labels:
        label = int(label)
        if label not in labels_set or all_slices[label - 1] is None:
            continue
        slices = all_slices[label - 1]
        binimg = cc_labels[slices] == label
        filled = scipy.ndimage.binary_fill_holes(binimg)
        n = int(filled.sum() - binimg.sum())
        filled_px += n
        if n == 0:
            continue
        sub = set(int(u) for u in np.unique(cc_labels[slices][filled]))
        sub.discard(label)
        labels_set -= sub
        cc_labels[slices] = np.where(filled, label, cc_labels[slices])
    return cc_labels, filled_px


def check_avocado(cc_in, remap_in, cc_out, remap_out):
    """The avocado output's invariants: every input label lies in one
    output label (each output label is a union of input labels, plus the
    background it filled), the output ids are contiguous, and the
    remapping covers every output id with an original label of the
    input. Returns (input labels, output labels)."""
    import torch

    a = torch.from_numpy(cc_in.astype(np.int64)).cuda().reshape(-1)
    b = torch.from_numpy(cc_out.astype(np.int64)).cuda().reshape(-1)
    nz = a != 0
    n_in = int(a.max()) + 1
    lo = torch.full((n_in,), 2**62, dtype=torch.int64, device="cuda")
    hi = torch.full((n_in,), -1, dtype=torch.int64, device="cuda")
    lo.scatter_reduce_(0, a[nz], b[nz], "amin")
    hi.scatter_reduce_(0, a[nz], b[nz], "amax")
    present = hi >= 0
    if bool((lo[present] != hi[present]).any()):
        raise AssertionError("avocado: an input label was split")
    if bool((lo[present] == 0).any()):
        raise AssertionError("avocado: an input label became background")
    ids_out = set(np.flatnonzero(np.bincount(cc_out.ravel())).tolist())
    ids_out.discard(0)
    if ids_out != set(range(1, len(ids_out) + 1)):
        raise AssertionError("avocado: output ids are not contiguous")
    if set(remap_out) != ids_out:
        raise AssertionError(f"avocado: the remapping covers "
                             f"{len(set(remap_out) & ids_out)} of "
                             f"{len(ids_out)} ids")
    if not set(remap_out.values()) <= set(remap_in.values()):
        raise AssertionError("avocado: remapping values not from its input")
    return int(present[1:].sum()), len(ids_out)


def fill_main_path(vol):
    """The fill path at full size: skeletonize(fill_holes=True,
    fix_avocados=True) of the hollow volume once (a second run took as
    long), then its filled volume
    against the serial oracle, the avocado invariants, and a skeleton for
    every label above the dust threshold. Returns (the run's launches,
    C1's kernel-table rows from the crop engine's chase calls)."""
    spy, chase_spy = HostStageSpy(), ChaseSpy()
    restores = [spy.install(), chase_spy.install()]
    try:
        skels, counters, launches, _ = run_main_path(
            "fill", vol, ("gsweep_sweep0", "sweep_axis0_batched", "fma_f32",
                          "chase_batched"),
            runs=("first",), fill_holes=True, fix_avocados=True)
    finally:
        for restore in reversed(restores):
            restore()
    if counters.get("gengine_iterations", 0):
        raise AssertionError("fill path: the global engine traced labels")
    t0 = time.perf_counter()
    cc_in, cc_out = spy.fill
    want, n_want = serial_fill(cc_in)
    if not np.array_equal(cc_out, want):
        raise AssertionError(f"fill path: the filled volume differs from "
                             f"the serial oracle on "
                             f"{int((cc_out != want).sum())} voxels")
    if counters.get("fill_voxels") != n_want or n_want == 0:
        raise AssertionError(f"fill path: {counters.get('fill_voxels')} "
                             f"voxels filled, the oracle {n_want}")
    log(f"[fill] the filled volume equals the serial oracle (scipy's "
        f"binary_fill_holes per label in label order; {n_want} voxels of "
        f"{counters.get('fill_labels')} labels; {time.perf_counter() - t0:.1f}"
        f" s)")
    a_in, r_in, a_out, r_out = spy.avocado
    n_in, n_out = check_avocado(a_in, r_in, a_out, r_out)
    log(f"[fill] avocado output: {n_in} labels in, {n_out} out "
        f"(contiguous), each a union of input labels, the remapping "
        f"covers every id")
    counts = np.bincount(a_out.ravel())
    jobs = [i for i in np.flatnonzero(counts > 1000) if i != 0]
    missing = sorted({r_out[int(i)] for i in jobs} - set(skels))
    if missing:
        raise AssertionError(f"fill path: labels {missing[:10]} above the "
                             f"dust threshold have no skeleton")
    big = {int(k) for k in np.flatnonzero(np.bincount(vol.ravel()) > 1000)
           if k != 0}
    gone = big - set(skels)
    log(f"[fill] every one of the {len(jobs)} labels above the dust "
        f"threshold after the host stages has a skeleton; of the {len(big)} "
        f"input labels above it, {len(gone)} have none (absorbed by the "
        f"host stages or split into dust: {sorted(gone)[:20]})")
    return launches, chase_rows("fill", chase_spy, launches, counters, 1,
                                False)


def small_fill_volume():
    """A 64^3 hollow volume (bench.py's generator at 64^3) with a block
    cut by the x = 0 face holding a pit on that face (an avocado), and a
    hollow box (a hole)."""
    vol = hollow_volume(dense_volume(64))
    vol[0:40, 4:60, 10:54] = vol.max() + 1
    vol[0:5, 8:16, 14:22] = vol.max() + 1
    vol[46:62, 40:62, 2:12] = vol.max() + 1
    vol[49:59, 44:58, 4:9] = 0
    return vol


def small_fill_path():
    """The fill path at 64^3 on the card and on the CPU: equal
    skeletons; at least one hole filled and one label absorbed by the
    avocado passes. Returns the card run's launches."""
    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    vol = small_fill_volume()
    out, launches = {}, None
    for device in ("cuda", "cpu"):
        profiling.reset_stats()
        profiling.collect(True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[device] = kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=1000,
            fix_borders=True, fix_branching=True, fill_holes=True,
            fix_avocados=True, device=device)
        profiling.collect(False)
        if device == "cuda":
            launches = dict(kernels.LAUNCHES)
        counters = profiling.get_stats()["counters"]
        log(f"[small-fill] device={device}: {len(out[device])} skeletons in "
            f"{time.perf_counter() - t0:.2f} s, counters {counters}")
        if counters.get("fill_voxels", 0) < 1 or \
                counters.get("avocado_absorbed", 0) < 1:
            raise AssertionError("small fill volume: no hole filled or no "
                                 "avocado absorbed")
    log(f"[small-fill] launches: {json.dumps(launches)}")
    assert_same_skeletons(out["cpu"], out["cuda"], "small fill cuda vs cpu")
    log("[small-fill] CUDA skeletons equal CPU skeletons (vertices, edges, "
        "radii)")
    return launches


def postprocess_phase(skels):
    """postprocess and join_close_components on the dense run's
    skeletons, by the native and the pure-python routes: equal SWC
    text; the host seconds of each are logged."""
    from kimimaro_tpu_torch import join_close_components, native, postprocess

    if not native.available():
        raise AssertionError("the native host library did not build")
    out = {}
    load = native._load
    for route in ("native", "python"):
        if route == "python":  # the loader finds no library
            native._load = lambda: None
        try:
            t0 = time.perf_counter()
            pp = {k: postprocess(s.clone(), dust_threshold=1000,
                                 tick_threshold=3500)
                  for k, s in skels.items()}
            t1 = time.perf_counter()
            jc = {k: join_close_components(s.clone(), radius=1500)
                  for k, s in skels.items()}
            t2 = time.perf_counter()
        finally:
            native._load = load
        out[route] = ({k: s.to_swc() for k, s in pp.items()},
                      {k: s.to_swc() for k, s in jc.items()})
        log(f"[post] {route} route on {len(skels)} skeletons: postprocess "
            f"{t1 - t0:.3f} s, join_close_components {t2 - t1:.3f} s")
    for i, what in enumerate(("postprocess", "join_close_components")):
        bad = [k for k in out["native"][i]
               if out["native"][i][k] != out["python"][i][k]]
        if bad:
            raise AssertionError(f"{what}: SWC differs between the routes "
                                 f"on labels {bad[:10]}")
    log("[post] native and python routes give equal SWC text")


class RssPeak:
    """Peak resident set size of this process above its size at start,
    sampled every 5 ms on a thread while in the block."""

    def __enter__(self):
        import threading

        self.page = os.sysconf("SC_PAGE_SIZE")
        self.base = self.peak = self._rss()
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()
        return self

    def _rss(self):
        with open("/proc/self/statm") as f:
            return int(f.read().split()[1]) * self.page

    def _run(self):
        while not self.stop.wait(0.005):
            self.peak = max(self.peak, self._rss())

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        self.peak = max(self.peak, self._rss())

    @property
    def mib(self):
        return (self.peak - self.base) / 2**20


def streaming_phase(dense, dense_skels):
    """A CompressedLabelVolume of the dense volume through skeletonize:
    skeletons equal the plain array's; the upload phase and the peak host
    RSS above the start of each run. Returns the launches of the
    streaming run."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    cv = kimimaro_tpu_torch.CompressedLabelVolume(dense, slab=16)
    log(f"[stream] compressed {dense.nbytes / 2**20:.0f} MiB to "
        f"{cv.nbytes_compressed / 2**20:.1f} MiB in "
        f"{time.perf_counter() - t0:.1f} s (set-up, not timed)")
    got, launches = {}, None
    for tag, vol in (("plain", dense), ("stream", cv)):
        profiling.reset_stats()
        profiling.collect(True)
        kernels.reset_launches()
        torch.cuda.synchronize()
        with RssPeak() as rss:
            t0 = time.perf_counter()
            got[tag] = kimimaro_tpu_torch.skeletonize(
                vol, teasar_params=TEASAR, anisotropy=ANIS,
                dust_threshold=1000, fix_borders=True, fix_branching=True,
                device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        profiling.collect(False)
        if tag == "stream":
            launches = dict(kernels.LAUNCHES)
        up = profiling.get_stats()["phases"]["upload"]
        log(f"[stream] {tag}: {secs:.2f} s, upload {up:.4f} s, host RSS "
            f"{rss.base / 2**20:.0f} MiB at the start, peak "
            f"{rss.peak / 2**20:.0f} MiB ({rss.mib:.0f} MiB above)")
    assert_same_skeletons(got["plain"], got["stream"], "stream vs plain")
    assert_same_skeletons(dense_skels, got["stream"], "stream vs dense run")
    log(f"[stream] streamed skeletons equal the plain array's "
        f"({len(got['stream'])})")
    return launches


def chunked_phase(dense, dense_skels):
    """skeletonize_chunked of the dense volume in 2 x 2 x 2 chunks of 256
    (one-voxel overlap): the label set of the whole-volume run, save
    labels whose every piece in every chunk is dust. Returns the launches
    summed over its chunks."""
    import scipy.ndimage
    import torch

    from kimimaro_tpu_torch import chunked, kernels

    merge_inner = chunked.merge_chunk_skeletons
    merge_s = []

    def merge_spy(*a, **kw):
        t0 = time.perf_counter()
        out = merge_inner(*a, **kw)
        merge_s.append(time.perf_counter() - t0)
        return out

    chunked.merge_chunk_skeletons = merge_spy
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        got = chunked.skeletonize_chunked(
            dense, chunk_size=(256, 256, 256), teasar_params=TEASAR,
            anisotropy=ANIS, dust_threshold=1000, fix_borders=True,
            fix_branching=True, device="cuda")
        torch.cuda.synchronize()
    finally:
        chunked.merge_chunk_skeletons = merge_inner
    secs = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    extra = set(got) - set(dense_skels)
    if extra:
        raise AssertionError(f"chunked: labels {sorted(extra)[:10]} not in "
                             f"the whole-volume run")
    dust_only = 0
    bounds = chunked.chunk_bounds(dense.shape, (256, 256, 256))
    for k in set(dense_skels) - set(got):
        for lo, hi in bounds:
            piece = dense[tuple(slice(a, b) for a, b in zip(lo, hi))] == k
            if piece.sum() <= 1000:
                continue
            comp, _ = scipy.ndimage.label(piece, structure=np.ones((3, 3, 3)))
            if np.bincount(comp.ravel())[1:].max() > 1000:
                raise AssertionError(f"chunked: label {k} has a component "
                                     f"above the dust threshold in chunk "
                                     f"{lo} but no skeleton")
        dust_only += 1
    log(f"[chunked] {len(bounds)} chunks of 256 (one-voxel overlap): "
        f"{secs:.2f} s wall, merge {sum(merge_s):.3f} s; {len(got)} labels, "
        f"the whole-volume run's {len(dense_skels)}; {dust_only} labels are "
        f"dust in every chunk")
    return launches


# --------------------------------------------------------------------------- #
# phase 10: self-touch (voxel_graph) at 512^3: B1's and B5's graph-gated
# forms, B4 with the graph


def graph_slices(o, shape):
    """(dst, src) slices: v in dst, v + o in src."""
    dst = tuple(slice(max(-c, 0), n + min(-c, 0)) for c, n in zip(o, shape))
    src = tuple(slice(max(c, 0), n + min(c, 0)) for c, n in zip(o, shape))
    return dst, src


def label_graph(pre):
    """cc3d's voxel_connectivity_graph of a device label volume: bit
    GRAPH_BITS[o] at v set where v + o is in the volume and has v's label
    (int32 words)."""
    import torch

    from kimimaro_tpu_torch.ops.stencils import GRAPH_BITS

    vg = torch.zeros(pre.shape, dtype=torch.int32, device=pre.device)
    for o, bit in GRAPH_BITS.items():
        dst, src = graph_slices(o, pre.shape)
        vg[dst] |= (pre[dst] == pre[src]).to(torch.int32) << bit
    return vg


def self_touch_volume(pre, share=4):
    """The self-touch volume of a label volume (numpy uint32): about one
    label in `share` relabelled to the id of a touching neighbour (each
    label takes part in one merge at most). Returns (merged (numpy
    uint32), its voxel graph (numpy uint32: the connectivity of `pre`),
    {pre label: merged label}, merges)."""
    import torch

    from kimimaro_tpu_torch.ops.stencils import GRAPH_BITS

    dev = torch.from_numpy(pre.view(np.int32)).cuda()
    ids = torch.unique(dev).cpu().numpy()
    k = int(ids.max()) + 1
    keys = []
    for o in GRAPH_BITS:
        if o < (0, 0, 0):
            continue  # each undirected pair of offsets once
        dst, src = graph_slices(o, pre.shape)
        a, b = dev[dst], dev[src]
        m = (a != b) & (a != 0) & (b != 0)
        lo, hi = torch.minimum(a, b)[m].long(), torch.maximum(a, b)[m].long()
        keys.append(torch.unique(lo * k + hi))
    keys = torch.unique(torch.cat(keys)).cpu().numpy()
    want = int((ids != 0).sum()) // share
    merge, used = {}, set()
    for key in keys:
        a, b = int(key // k), int(key % k)
        if a in used or b in used:
            continue
        merge[b] = a
        used.update((a, b))
        if len(merge) >= want:
            break
    lut = torch.arange(k, dtype=torch.int32, device=dev.device)
    for b, a in merge.items():
        lut[b] = a
    merged = lut[dev.long()]
    vg = label_graph(dev)
    mapping = {int(i): int(merge.get(int(i), int(i))) for i in ids if i}
    out = (merged.cpu().numpy().view(np.uint32),
           vg.cpu().numpy().view(np.uint32), mapping, len(merge))
    del dev, merged, vg, lut
    torch.cuda.empty_cache()
    return out


def device_components(vol, vg=None):
    """Components of a numpy label volume by the port's CCL on the card
    (with the graph `vg` where given)."""
    import torch

    from kimimaro_tpu_torch.intake import _upload
    from kimimaro_tpu_torch.ops.ccl import compact_cc, connected_components

    g = None if vg is None else torch.from_numpy(vg).cuda()
    _, n, _ = compact_cc(connected_components(
        _upload(vol, torch.device("cuda")), voxel_graph=g))
    return n


class GateSpy:
    """While installed, keeps the arguments of the first graph-gated B1
    sweep of every (shape, direction, bits) and counts the gated calls."""

    def __init__(self):
        self.kept = {}
        self.calls = 0

    def install(self):
        from kimimaro_tpu_torch.ops import gsweep

        inner = gsweep.sweep0

        def spy(d, cc, nodecost, okmask, anis, mode, clamp, desc, gate=None,
                bits9=None):
            if gate is not None and d.device.type == "cuda":
                self.calls += 1
                key = (tuple(d.shape), bool(desc), tuple(bits9))
                if key not in self.kept:
                    self.kept[key] = (d.clone(), gate, tuple(anis))
            return inner(d, cc, nodecost, okmask, anis, mode, clamp, desc,
                         gate, bits9)

        gsweep.sweep0 = spy

        def restore():
            gsweep.sweep0 = inner

        return restore


# B1-vg on each side of its shape rule on an H100 (132 SMs, 227 KB): the
# ids alone carried (4 bytes a cell), ids and G1's CCL gate a stage (8
# bytes a voxel): persistent up to 1056 x 1056
B1_VG_RULE = ((1056, True), (1072, False))


def b1_vg(d, gate, bits, desc, anis=(1.0, 1.0, 1.0)):
    """One B1-vg sweep (minid on G1's CCL gate)."""
    from kimimaro_tpu_torch.ops import gsweep

    return gsweep.sweep0(d, None, None, None, anis, "minid", False, desc,
                         gate, bits)


def b1_vg_case(shape, gen, layout, desc):
    """B1-vg against its plain version, twice, on random ids and random
    gate words (the move bits and the occupancy bit)."""
    import torch

    from kimimaro_tpu_torch.ops import gsweep

    d, _, _, _ = sweep_inputs(shape, "minid", False, False, gen)
    gate = torch.randint(0, 1 << 27, shape, generator=gen, device="cuda",
                         dtype=torch.int32)
    bits = gsweep.gate_bits9(layout, desc)
    got = b1_vg(d, gate, bits, desc)
    again = b1_vg(d, gate, bits, desc)
    want = gsweep._sweep0_gate_plain(d, gate, bits, desc)
    name = f"B1-vg layout={layout} desc={desc} {shape}"
    err = require_equal(name, got, want)
    require_equal(name + " run twice", again, got)
    return err


def check_b1_vg(spy, gen):
    """B1-vg against its plain version at strip-stressing shapes, on each
    side of its shape rule and on the recorded sweeps of the 512^3 CCL
    (each twice), timed there. Returns (ms, plain_ms, err, shape)."""
    from kimimaro_tpu_torch.ops import gsweep

    err = 0.0
    for i, shape in enumerate(((11, 9, 8), (13, 37, 45), *B1_STRESS_SHAPES)):
        err = max(err, b1_vg_case(shape, gen, i % 3, bool(i % 2)))
    for side, persistent in B1_VG_RULE:
        plan = gsweep.sweep0_plan(side, side, "minid", False, True)
        if plan["persistent"] != persistent:
            raise AssertionError(f"B1-vg {side}^2: plan {plan}, expected "
                                 f"persistent={persistent}")
        for desc in (False, True):
            err = max(err, b1_vg_case((2, side, side), gen, 1, desc))
    log(f"[kernels] B1-vg bit-equal at {len(B1_STRESS_SHAPES) + 2} shapes "
        f"and on each side of its shape rule (persistent / per plane: "
        f"{json.dumps(B1_VG_RULE)})")
    if not spy.kept:
        raise AssertionError("the self-touch CCL made no graph-gated sweep")
    timed = None
    for key, (d, gate, anis) in sorted(spy.kept.items()):
        shape, desc, bits = key
        got = b1_vg(d, gate, bits, desc, anis)
        again = b1_vg(d, gate, bits, desc, anis)
        want, plain = timed_once(lambda: gsweep._sweep0_gate_plain(
            d, gate, bits, desc))
        err = max(err, require_equal(f"B1-vg recorded {key}", got, want))
        require_equal(f"B1-vg recorded {key} run twice", again, got)
        if timed is None or int(np.prod(shape)) > int(np.prod(timed[3])):
            ms = cuda_ms(lambda: b1_vg(d, gate, bits, desc, anis), 5)
            timed = (ms, plain, 0.0, shape)
    log(f"[kernels] B1-vg bit-equal on the {len(spy.kept)} recorded sweeps "
        f"of the self-touch CCL (each layout and direction; "
        f"{spy.calls} gated calls), twice")
    return timed[0], timed[1], err, timed[3]


# B5 with a graph gate on each side of its form rules on an H100: the gate
# is a fourth word of a voxel's stage (the carried plane holds the field
# only), so the grid strips hold square planes up to 1024 x 1024 in euclid
# mode and 912 x 912 in node mode (848 and 784 while the neighbours'
# bitfields rode the carried plane)
B5_VG_RULE = {False: ((170, "cluster"), (171, "strips"), (1024, "strips"),
                      (1040, "plane")),
              True: ((170, "cluster"), (171, "strips"), (912, "strips"),
                     (928, "plane"))}
# B4 with a graph gate, two lanes of square planes too wide for a cluster:
# per-lane grid strips (66 CTAs a lane) up to 720 x 720 in euclid mode and
# 640 x 640 in node mode, one launch per plane beyond (623 and 565 with the
# carried bitfields)
B4_VG_RULE = {False: (((2, 2, 720, 720), "strips"),
                      ((2, 2, 736, 736), "plane")),
              True: (((2, 2, 640, 640), "strips"),
                     ((2, 2, 656, 656), "plane"))}


def b5_vg_case(shape, node, clamp, gen, anis, axis=0):
    """B5's graph-gated kernel against its plain version in both
    directions, twice, in both forms of the graph: source bitfields
    (the wrapper builds their gate) against the plain source form, and a
    gate against the plain gate form; the first plane passes through."""
    import torch

    from kimimaro_tpu_torch.ops import geodesic, gsweep, sweep

    d, ok, nc = b5_inputs(shape, clamp, gen)
    words = torch.randint(0, 1 << 26, shape, generator=gen, device="cuda",
                          dtype=torch.int32)
    err = 0.0
    for desc in (False, True):
        for form, kw in (
                ("source", {"vg": words,
                            "bits9": geodesic.sweep_bits9(axis, desc)}),
                ("gate", {"gate": words,
                          "gate_bits9": gsweep.gate_bits9(axis, desc)})):
            got = sweep.sweep_axis0(d, ok, nc, anis, node, clamp, desc, **kw)
            again = sweep.sweep_axis0(d, ok, nc, anis, node, clamp, desc,
                                      **kw)
            want = sweep._sweep_axis0_plain(d, ok, nc, anis, node, clamp,
                                            desc, **kw)
            name = (f"B5-vg ({form}) node={node} clamp={clamp} desc={desc} "
                    f"{shape}")
            err = max(err, require_equal(name, got, want))
            require_equal(name + " run twice", again, got)
            first = -1 if desc else 0
            require_equal(name + " first plane", got[first], d[first])
    return err


def check_b4_vg_rule(gen):
    """B4's graph-gated form on each side of its plan rule
    (B4_VG_RULE), both directions, twice, against its plain version."""
    import torch

    from kimimaro_tpu_torch.ops import gsweep, sweep

    anis = (40.0, 16.0, 16.0)
    err = 0.0
    for node, sides in B4_VG_RULE.items():
        for shape, form in sides:
            plan = sweep.sweep_axis0_batched_plan(shape[0], shape[2],
                                                  shape[3], node, True)
            if plan["form"] != form:
                raise AssertionError(f"B4-vg node={node} {shape}: plan "
                                     f"{plan}, expected {form}")
            r = lambda: torch.rand(shape, generator=gen, device="cuda")
            d = torch.where(r() < 0.25, r() * 10 - 5.0, float("inf"))
            ok, nc = r() < 0.8, r() * 3
            gate = torch.randint(0, 1 << 26, shape, generator=gen,
                                 device="cuda", dtype=torch.int32)
            for desc in (False, True):
                kw = {"gate": gate, "gate_bits9": gsweep.gate_bits9(1, desc)}
                got = sweep.sweep_axis0_batched(d, ok, nc, anis, node, True,
                                                desc, **kw)
                again = sweep.sweep_axis0_batched(d, ok, nc, anis, node,
                                                  True, desc, **kw)
                want = sweep._sweep_axis0_batched_plain(
                    d, ok, nc, anis, node, True, desc, **kw)
                name = f"B4-vg node={node} desc={desc} {shape}"
                err = max(err, require_equal(name, got, want))
                require_equal(name + " run twice", again, got)
    log(f"[kernels] B4-vg bit-equal on each side of its plan rule: "
        f"{json.dumps({('node' if k else 'euclid'): v for k, v in B4_VG_RULE.items()})}")
    return err


def check_b5_vg(gen):
    """B5's graph-gated form at B5's stress shapes and on each side of its
    form rules; timed on a node sweep of a 96^3 crop (B5's row shape) with
    its gate, in turns with the same sweep without it. Returns (ms,
    plain_ms, err, [gated ms], [ungated ms])."""
    import torch

    from kimimaro_tpu_torch.ops import gsweep, sweep

    anis = (40.0, 16.0, 16.0)
    err = 0.0
    for i, shape in enumerate(((11, 9, 8), *B5_STRESS_SHAPES)):
        for node in (False, True):
            for clamp in (False, True):
                err = max(err, b5_vg_case(shape, node, clamp, gen, anis,
                                          i % 3))
    for node, sides in B5_VG_RULE.items():
        for side, form in sides:
            plan = sweep.sweep_axis0_plan(side, side, node, True)
            if plan["form"] != form:
                raise AssertionError(f"B5-vg node={node} {side}^2: plan "
                                     f"{plan}, expected {form}")
            err = max(err, b5_vg_case((2, side, side), node, True, gen,
                                      anis))
    log(f"[kernels] B5-vg bit-equal at {len(B5_STRESS_SHAPES) + 1} shapes "
        f"and on each side of its form rules: "
        f"{json.dumps({('node' if k else 'euclid'): v for k, v in B5_VG_RULE.items()})}")
    d, ok, nc = b5_inputs((96, 96, 96), False, gen)
    gate = torch.randint(0, 1 << 26, d.shape, generator=gen, device="cuda",
                         dtype=torch.int32)
    bits = gsweep.gate_bits9(0, False)
    ta, tb = turns(
        lambda: sweep.sweep_axis0(d, ok, nc, anis, True, False, gate=gate,
                                  gate_bits9=bits),
        lambda: sweep.sweep_axis0(d, ok, nc, anis, True, False), 5)
    plain = cuda_ms(lambda: sweep._sweep_axis0_plain(
        d, ok, nc, anis, True, False, False, gate=gate, gate_bits9=bits), 1)
    log(f"[kernels] B5-vg node sweep of a 96^3 crop: {ta} ms with its gate, "
        f"{tb} ms without (in turns a, b, b, a)")
    return float(np.mean(ta)), plain, err, ta, tb


class G1Spy:
    """While installed, counts G1's calls (ops.stencils.graph_into, as the
    CCL (its CCL form, with labels), the crop engine and the host trace
    path's fields call it) per (shape, form) and keeps the inputs of the
    first call of each, up to `keep_bytes` of them."""

    MODULES = ("kimimaro_tpu_torch.ops.ccl", "kimimaro_tpu_torch.engine",
               "kimimaro_tpu_torch.ops.geodesic")

    def __init__(self, keep_bytes=4 << 30):
        self.keep_bytes = keep_bytes
        self.kept = {}
        self.calls = {}

    def install(self):
        import importlib

        from kimimaro_tpu_torch.ops import stencils

        inner = stencils.graph_into

        def spy(vg, labels=None):
            if vg.device.type == "cuda":
                key = (tuple(vg.shape), labels is not None)
                self.calls[key] = self.calls.get(key, 0) + 1
                held = sum(t.numel() * 4 for k in self.kept.values()
                           for t in k if t is not None)
                need = vg.numel() * (8 if key[1] else 4)
                if key not in self.kept and held + need <= self.keep_bytes:
                    self.kept[key] = (
                        stencils.graph_word(vg).clone(),
                        None if labels is None else labels.clone())
            return inner(vg, labels)

        mods = [importlib.import_module(m) for m in self.MODULES]
        for m in mods:
            m.graph_into = spy

        def restore():
            for m in mods:
                m.graph_into = inner

        return restore


# G1 beyond the main path's shapes: one voxel, lanes of one row, odd
# widths, more than 65,535 lanes (a tile each), two leading lane axes, the
# widths on each side of its z tiles (8, 16, 32)
G1_STRESS_SHAPES = ((1, 1, 1), (3, 1, 5, 7), (2, 9, 1, 33), (17, 40, 24),
                    (70000, 1, 2, 3), (2, 3, 5, 4, 6), (3, 5, 70, 8),
                    (2, 7, 37, 9), (2, 4, 33, 16), (1, 300, 11, 65),
                    (1, 3, 300, 5), (2, 2, 45, 40))


def g1_bound(shape, ccl=False):
    """Least time of one G1 call: the words (and labels) read once and the
    gate written once (8 B a voxel, 12 with labels) over the HBM rate,
    against 26 moves of four integer operations a voxel (and a label
    compare each) over the 32-bit peak. Returns (ms, by)."""
    vox = int(np.prod(shape))
    t_b = (12 if ccl else 8) * vox / HBM_BYTES_PER_S
    t_o = (130 if ccl else 104) * vox / ALU_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def g1_inputs(shape, gen):
    """Random words (every bit) and labels of three values and 0, two of
    them negative words."""
    import torch

    vg = torch.randint(-2**31, 2**31 - 1, shape, generator=gen,
                       device="cuda", dtype=torch.int32)
    lab = torch.randint(0, 4, shape, generator=gen, device="cuda",
                        dtype=torch.int32)
    return vg, torch.where(lab == 3, -5, torch.where(lab == 2, -1, lab))


def check_g1(spy, gen):
    """G1 in both forms against its plain version at its stress shapes
    (random words, every bit; random labels) and on the calls `spy` kept,
    each made twice. Returns {(shape, ccl): (ms, plain_ms, bound_ms,
    bound_by, err)} of the kept calls."""
    from kimimaro_tpu_torch.ops import stencils

    for shape in G1_STRESS_SHAPES:
        vg, lab = g1_inputs(shape, gen)
        for labels in (None, lab):
            what = f"G1{' ccl' if labels is not None else ''} {shape}"
            got = stencils.graph_into(vg, labels)
            require_equal(what, got, stencils._graph_into_plain(vg, labels))
            require_equal(what + " run twice",
                          stencils.graph_into(vg, labels), got)
    out = {}
    for key, (vg, labels) in sorted(spy.kept.items()):
        got = stencils.graph_into(vg, labels)
        again = stencils.graph_into(vg, labels)
        want, plain = timed_once(
            lambda: stencils._graph_into_plain(vg, labels))
        err = require_equal(f"G1 call {key}", got, want)
        require_equal(f"G1 call {key} run twice", again, got)
        del got, again, want
        ms = cuda_ms(lambda: stencils.graph_into(vg, labels), 5)
        bms, by = g1_bound(key[0], key[1])
        out[key] = (ms, plain, bms, by, err)
    for form in (False, True):
        if not any(k[1] == form for k in out):
            raise AssertionError(f"the self-touch runs made no G1 call "
                                 f"{'with' if form else 'without'} labels")
    top = sorted(out, key=lambda k: -spy.calls[k] * int(np.prod(k[0])))[:5]
    log(f"[kernels] G1 (both forms) bit-equal at {len(G1_STRESS_SHAPES)} "
        f"stress shapes and on the first call of each of the "
        f"{len(spy.calls)} (shape, form) of the self-touch runs "
        f"({sum(spy.calls.values())} calls), twice; most voxels: " +
        "; ".join(f"{k[0]}{' ccl' if k[1] else ''} x {spy.calls[k]}: "
                  f"{out[k][0]:.4f} ms vs plain {out[k][1]:.2f} ms, bound "
                  f"{out[k][2]:.4f} ms" for k in top))
    return out


# C1's bound: one dependent L2 round trip a step of the longest walk. The
# round trip is taken as an L2 hit's latency on an H100, about 270 cycles
# at the 1,980 MHz boost clock (assumed, not measured here)
L2_ROUND_TRIP_S = 270 / 1.98e9


class ChaseSpy:
    """While installed, counts the crop engine's chase calls per form and
    keeps the arguments of the first call of every (lanes, padded crop,
    form), up to `keep` of them."""

    def __init__(self, keep=8):
        self.keep = keep
        self.kept = {}
        self.calls = {}

    def install(self):
        from kimimaro_tpu_torch import engine

        inner = engine.chase_batched

        def spy(d_pad, start, max_len, vg_pad=None):
            if d_pad.device.type == "cuda":
                key = (tuple(d_pad.shape), int(max_len), vg_pad is not None)
                self.calls[key] = self.calls.get(key, 0) + 1
                if key not in self.kept and len(self.kept) < self.keep:
                    self.kept[key] = (d_pad.clone(), start.clone(),
                                      None if vg_pad is None
                                      else vg_pad.clone())
            return inner(d_pad, start, max_len, vg_pad)

        engine.chase_batched = spy

        def restore():
            engine.chase_batched = inner

        return restore


def c1_device_ms(d, start, L, vg, reps=20):
    """C1's own milliseconds a launch: `reps` launches back to back into
    outputs made once, by CUDA events, without the wrapper's host work
    (its checks and allocations take about as long as a short walk)."""
    import torch

    from kimimaro_tpu_torch.ops import chase

    B = d.shape[0]
    path = torch.empty((B, L, 3), dtype=torch.int64, device=d.device)
    length = torch.empty((B,), dtype=torch.int64, device=d.device)
    reached = torch.empty((B,), dtype=torch.bool, device=d.device)
    vgi = None if vg is None else vg.view(torch.int32)
    start = start.to(torch.int64).contiguous()

    def launches():
        for _ in range(reps):
            chase._launch(d, vgi, start, L, path, length, reached)

    return cuda_ms(launches, 3) / reps


def check_chase_recorded(spy):
    """C1 against its plain version on the recorded lane sets, each call
    made twice, and the gated lane sets again without their graph (the
    ungated form). Returns {key: (ms, plain_ms, bound_ms, steps, ungated ms,
    ungated plain ms)}: C1's own time (`c1_device_ms`; the wrapper's call,
    host work included, is logged beside it), the plain version once,
    whose cost is its Python loop, and the bound: the longest walk's steps
    times one L2 round trip."""
    from kimimaro_tpu_torch.ops import chase

    out = {}
    for key in sorted(spy.kept):
        shape, L, gated = key
        d, start, vg = spy.kept[key]
        row = []
        for g in ((vg, None) if gated else (None,)):
            got = chase.chase_batched(d, start, L, g)
            again = chase.chase_batched(d, start, L, g)
            want, plain = timed_once(
                lambda: chase._chase_batched_plain(d, start, L, g))
            what = f"C1 {'gated' if g is not None else 'ungated'} {key}"
            require_equal(what, got, want)
            require_equal(f"{what} run twice", again, got)
            call = cuda_ms(lambda: chase.chase_batched(d, start, L, g), 5)
            ms = c1_device_ms(d, start, L, g)
            steps = int(want[1].max())
            row.append((ms, plain, steps))
            log(f"[kernels] {what} ({spy.calls[key]} calls): {ms:.4f} ms "
                f"({call:.4f} ms a wrapper call) vs plain {plain:.1f} ms; "
                f"longest walk {steps} of {L} steps, "
                f"{int(want[2].sum())} of {shape[0]} lanes reached a rail; "
                f"bound {1e3 * steps * L2_ROUND_TRIP_S:.4f} ms "
                f"({1e6 * ms * 1e-3 / max(steps, 1):.3f} us a step)")
        (ms, plain, steps), *bare = row
        out[key] = (ms, plain, 1e3 * steps * L2_ROUND_TRIP_S, steps,
                    bare[0][0] if bare else None,
                    bare[0][1] if bare else None)
    log(f"[kernels] C1 bit-equal on the {len(spy.kept)} recorded chase "
        f"calls (distinct lanes, crop and form), twice, the gated ones "
        f"without their graph too")
    return out


def chase_rows(tag, spy, launches, counters, runs, gated):
    """C1 on a main-path run's recorded chase calls: every chase launched
    C1 once in the run's form (`gated`: under a voxel graph) and never in
    the other, a launch a path iteration of the crop engine (`runs` runs
    of the same volume, `counters` the last run's), and each recorded call
    bit-equal to the plain version. Returns the kernel-table rows: the
    run's form on the two recorded lane sets of the most calls, and for a
    gated run the ungated form on the first of them."""
    seen = sum(spy.calls.values())
    form, other = (("chase_batched_vg", "chase_batched") if gated
                   else ("chase_batched", "chase_batched_vg"))
    iters = counters.get("crop_path_iterations", 0)
    log(f"[{tag}] chase launches {form} {launches[form]}, {other} "
        f"{launches[other]} over {runs} run(s), {iters} crop path "
        f"iterations a run, {seen} chase calls seen")
    if launches[form] != seen or seen != runs * iters or launches[other]:
        raise AssertionError(f"{tag}: a chase did not launch C1 ({form}) "
                             f"once a path iteration")
    if seen == 0 or any(k[2] != gated for k in spy.calls):
        raise AssertionError(f"{tag}: no chase call, or one in the other "
                             f"form")
    checked = check_chase_recorded(spy)
    rows = []
    top = sorted(checked, key=lambda k: -spy.calls[k])[:2]
    for key in top:
        ms, plain, bms, steps, _, _ = checked[key]
        rows.append({
            "name": f"{form} {key[0]} L={key[1]} ({tag})", "route": "cuda",
            "source": "kimimaro_tpu_torch/csrc/chase.cu",
            "replaces": "kimimaro_tpu/ops/fused_trace.py:115",
            "launches": spy.calls[key], "max_abs_err": 0.0,
            "ms": round(ms, 4), "plain_ms": round(plain, 4),
            "bound_ms": round(bms, 4),
            "bound_by": f"latency ({steps} steps, assumed L2 round trip)",
            "library_ms": None})
    if gated:
        ms, plain = checked[top[0]][4:6]
        rows.append({
            "name": f"chase_batched {top[0][0]} L={top[0][1]} ({tag}, "
                    f"graph removed)",
            "route": "cuda", "source": "kimimaro_tpu_torch/csrc/chase.cu",
            "replaces": "kimimaro_tpu/ops/fused_trace.py:115",
            "launches": None, "max_abs_err": 0.0, "ms": round(ms, 4),
            "plain_ms": round(plain, 4), "bound_ms": None,
            "bound_by": None, "library_ms": None})
    return rows


class RefillSpy:
    """While installed, keeps the component volume and the jobs of the
    last crop-engine call; `labels()` then names the labels (in
    `labels_dev`, at a first voxel of the component) of the jobs whose DBF
    max passes the soma detection threshold: the lanes that refill and
    re-EDT."""

    def __init__(self, labels_dev, sdt):
        self.labels_dev = labels_dev
        self.sdt = sdt
        self.last = None

    def install(self):
        from kimimaro_tpu_torch import engine, intake

        inner = engine.trace_batched

        def spy(cc_dev, dbf_dev, jobs, *args, **kw):
            self.last = (cc_dev, list(jobs))
            return inner(cc_dev, dbf_dev, jobs, *args, **kw)

        intake.engine.trace_batched = spy

        def restore():
            intake.engine.trace_batched = inner

        return restore

    def labels(self):
        cc_dev, jobs = self.last
        out = set()
        for job in jobs:
            if job["dbfmax"] is None or job["dbfmax"] > self.sdt:
                sl = tuple(slice(int(o), int(o) + int(s))
                           for o, s in zip(job["offset"], job["shape"]))
                first = (cc_dev[sl] == job["segid"]).reshape(-1).nonzero()
                out.add(int(self.labels_dev[sl].reshape(-1)[first[0, 0]]))
        return out


def chase_phase(dense):
    """C1 alone: the self-touch volume of `dense` skeletonized once under
    its graph, the chase calls recorded, then `chase_rows`. Returns C1's
    kernel-table rows."""
    merged, vg, _, _ = self_touch_volume(dense)
    spy = ChaseSpy()
    restore = spy.install()
    try:
        _, counters, launches, _ = run_main_path(
            "self-touch", merged, ("chase_batched_vg",), runs=("first",),
            voxel_graph=vg)
    finally:
        restore()
    return chase_rows("self-touch", spy, launches, counters, 1, True)


def first_voxels(vol):
    """{label: linear index of its first voxel} of a numpy volume, by a
    scatter-min on the card."""
    import torch

    v = torch.from_numpy(vol.view(np.int32).reshape(-1)).cuda().long()
    first = torch.full((int(v.max()) + 1,), v.numel(), dtype=torch.int64,
                       device=v.device)
    first.scatter_reduce_(0, v, torch.arange(v.numel(), device=v.device),
                          "amin")
    first = first.cpu().numpy()
    return {i: int(first[i]) for i in range(1, len(first))
            if first[i] < v.numel()}


def self_touch_identity(merged_skels, pre, vg_ones_run, mapping, refill):
    """The self-touch run against skeletonize(pre, all-ones graph) merged
    by the merge map: equal SWC on every label none of whose lanes
    refilled. Returns (compared, left out)."""
    from kimimaro_tpu_torch.skeleton import Skeleton

    b = vg_ones_run
    want_labels = {mapping[k] for k in b}
    if set(merged_skels) != want_labels:
        raise AssertionError(
            f"self-touch identity: labels {sorted(set(merged_skels) ^ want_labels)[:10]} "
            f"are in one run only")
    first = first_voxels(pre)
    parts = {}
    for k in b:
        parts.setdefault(mapping[k], []).append(k)
    compared = skipped = 0
    for m, skel in merged_skels.items():
        if m in refill:
            skipped += 1
            continue
        ks = sorted(parts[m], key=lambda k: first[k])
        want = b[ks[0]] if len(ks) == 1 else Skeleton.simple_merge(
            [b[k] for k in ks]).consolidate()
        got_swc, want_swc = skel.to_swc(), want.to_swc()
        if got_swc != want_swc:
            g, w = got_swc.splitlines(), want_swc.splitlines()
            i = next((i for i, (x, y) in enumerate(zip(g, w)) if x != y),
                     min(len(g), len(w)))
            raise AssertionError(
                f"self-touch identity: label {m} (pieces {ks}) differs at "
                f"SWC line {i}: {g[i] if i < len(g) else None!r} vs "
                f"{w[i] if i < len(w) else None!r}")
        compared += 1
    return compared, skipped


def small_self_touch_volume():
    """A 64^3 self-touch volume: bench.py's generator at 64^3 cut to its
    first 16 x planes (its four labels), plus a bent tube and a block
    touching it, half of the labels merged into a touching neighbour (the
    block into the tube) and walled apart by the pre-merge graph; the tube
    is given 17 manual targets (more than the crop engine holds: the host
    trace path). Returns (merged, graph, targets)."""
    pre = dense_volume(64)
    pre[16:] = 0
    tube, block = int(pre.max()) + 1, int(pre.max()) + 2
    pre[30:56, 26:32, 20:25] = tube
    pre[40:46, 10:44, 20:25] = tube
    pre[50:56, 32:37, 20:25] = block
    merged, vg, mapping, _ = self_touch_volume(pre, share=2)
    merged = np.where(pre == block, mapping[tube], merged).astype(np.uint32)
    pts = np.argwhere(pre == tube)
    pts = [tuple(int(c) for c in p) for p in pts[::len(pts) // 17][:17]]
    return merged, vg, pts


def small_self_touch_path():
    """The 64^3 self-touch volume with its host-path label on the card
    and on the CPU: equal skeletons, one label to the host trace path.
    Returns the card run's launches."""
    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    vol, vg, pts = small_self_touch_volume()
    out, launches = {}, None
    for device in ("cuda", "cpu"):
        profiling.reset_stats()
        profiling.collect(True)
        kernels.reset_launches()
        t0 = time.perf_counter()
        out[device] = kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=1000,
            fix_borders=True, fix_branching=True, voxel_graph=vg,
            extra_targets_before=pts, device=device)
        profiling.collect(False)
        if device == "cuda":
            launches = dict(kernels.LAUNCHES)
        counters = profiling.get_stats()["counters"]
        log(f"[self-touch-64] device={device}: {len(out[device])} skeletons "
            f"in {time.perf_counter() - t0:.2f} s, counters {counters}")
        if counters.get("fallback_jobs", 0) < 1:
            raise AssertionError("64^3 self-touch volume: no label took the "
                                 "host trace path")
    log(f"[self-touch-64] launches: {json.dumps(launches)}")
    for k in out["cpu"]:
        if k not in out["cuda"] or \
                out["cuda"][k].to_swc() != out["cpu"][k].to_swc():
            raise AssertionError(f"64^3 self-touch: label {k} differs "
                                 f"between the card and the CPU")
    if set(out["cuda"]) != set(out["cpu"]):
        raise AssertionError("64^3 self-touch: different label sets")
    log(f"[self-touch-64] CUDA skeletons equal CPU skeletons (SWC) on all "
        f"{len(out['cpu'])} labels")
    return launches


def self_touch_phase(dense, gen):
    """Phase 10: the dense volume with a quarter of its labels merged into
    a touching neighbour, under the pre-merge voxel graph: component
    counts, skeletonize twice (cold, warm) with B1-vg, B4 and B5 recorded,
    the identity against skeletonize(pre, all-ones graph), the 64^3 volume
    card against CPU, then the graph-gated kernels against their plain
    versions, and C1 on the recorded chase calls. Returns (launches of the
    two 512^3 runs, launches of the 64^3 card run, B1-vg timing, B5-vg
    timing, B4's recorded shapes and calls, the B4-vg rule's error, G1's
    recorded shapes and their calls in the two 512^3 runs, C1's
    kernel-table rows)."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch.utility import compute_cc_labels

    t0 = time.perf_counter()
    merged, vg, mapping, n_merges = self_touch_volume(dense)
    log(f"[self-touch] {n_merges} of {len(mapping)} labels relabelled to a "
        f"touching neighbour: {len(set(mapping.values()))} labels; voxel "
        f"graph of the pre-merge labels, {vg.nbytes / 2**20:.0f} MiB uint32 "
        f"(made in {time.perf_counter() - t0:.1f} s, set-up)")
    t0 = time.perf_counter()
    cc, _ = compute_cc_labels(merged, voxel_graph=vg, device="cuda")
    n_graph = int(cc.max())
    del cc
    n_pre = device_components(dense)
    n_plain = device_components(merged)
    log(f"[self-touch] components: compute_cc_labels(merged, voxel_graph) "
        f"{n_graph}, pre-merge {n_pre}, plain CCL of merged {n_plain} "
        f"({time.perf_counter() - t0:.1f} s)")
    if n_graph != n_pre or not n_plain < n_pre:
        raise AssertionError("self-touch: the graph's components are not the "
                             "pre-merge volume's")

    gate_spy, b5_spy, g1_spy = GateSpy(), B5Spy(), G1Spy()
    b4_spy = B4Spy("self-touch", keep=4096, per_shape=True)
    chase_spy = ChaseSpy()
    labels_dev = torch.from_numpy(merged.view(np.int32)).cuda()
    refill_spy = RefillSpy(labels_dev, TEASAR["soma_detection_threshold"])
    restores = [s.install() for s in (gate_spy, b5_spy, g1_spy, b4_spy,
                                      refill_spy, chase_spy)]
    try:
        skels, counters, launches, _ = run_main_path(
            "self-touch", merged, ("gsweep_sweep0_vg",
                                   "sweep_axis0_batched_vg", "graph_into",
                                   "graph_into_ccl", "chase_batched_vg"),
            voxel_graph=vg)
    finally:
        for restore in reversed(restores[3:]):
            restore()
    # G1's calls per (shape, form) in the two runs just made: the rows'
    # launches (the spy stays on through the runs below only to keep their
    # inputs); each call is one launch, so they sum to the runs' counts
    g1_calls = dict(g1_spy.calls)
    for ccl, k in ((False, "graph_into"), (True, "graph_into_ccl")):
        n = sum(v for key, v in g1_calls.items() if key[1] == ccl)
        if n != launches[k]:
            raise AssertionError(f"self-touch: G1Spy saw {n} {k} calls, the "
                                 f"runs counted {launches[k]} launches")
    if counters.get("gengine_iterations", 0):
        raise AssertionError("self-touch: the global engine traced labels")
    for k in ("gsweep_sweep0_dual", "crop_argmax"):
        if launches[k]:
            raise AssertionError(f"self-touch: {k} ran under a graph")
    big = {mapping[int(k)] for k in
           np.flatnonzero(np.bincount(dense.ravel()) > 1000) if k}
    if not big <= set(skels):
        raise AssertionError(f"self-touch: labels "
                             f"{sorted(big - set(skels))[:10]} above the dust "
                             f"threshold have no skeleton")

    t0 = time.perf_counter()
    ones = np.full(dense.shape, (1 << 26) - 1, dtype=np.uint32)
    want = kimimaro_tpu_torch.skeletonize(
        dense, teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=1000,
        fix_borders=True, fix_branching=True, voxel_graph=ones,
        device="cuda")
    del ones
    refill = refill_spy.labels()
    compared, skipped = self_touch_identity(skels, dense, want, mapping,
                                            refill)
    log(f"[self-touch] identity: skeletonize(merged, pre-merge graph) equals "
        f"skeletonize(pre, all-ones graph) merged by the merge map on "
        f"{compared} labels (SWC); {skipped} left out (a lane refilled: "
        f"{sorted(refill)[:20]}); {len(want)} pre-merge "
        f"skeletons ({time.perf_counter() - t0:.1f} s)")
    del want, labels_dev

    try:
        small = small_self_touch_path()
    finally:
        for restore in reversed(restores[:3]):
            restore()
    b1_vg = check_b1_vg(gate_spy, gen)
    log(f"[kernels] gsweep_sweep0_vg: {b1_vg[0]:.3f} ms vs plain "
        f"{b1_vg[1]:.1f} ms (the self-touch CCL's sweep of {b1_vg[3]})")
    del gate_spy
    b5_err = check_b5_recorded(b5_spy) if b5_spy.kept else 0.0
    b5_vg = check_b5_vg(gen)
    log(f"[kernels] sweep_axis0_vg: {b5_vg[0]:.4f} ms vs plain "
        f"{b5_vg[1]:.1f} ms (node sweep of a 96^3 crop); without the gate "
        f"{np.mean(b5_vg[4]):.4f} ms: x{b5_vg[0] / np.mean(b5_vg[4]):.3f}")
    b4_err = check_b4_vg_rule(gen)
    bare = {}
    b4_rows = check_b4_recorded(b4_spy, ungated=bare)
    calls = b4_spy.calls
    for shape in sorted(bare, key=lambda k: -calls[k] * int(np.prod(k)))[:8]:
        ta, tb = bare[shape]
        log(f"[kernels] B4-vg self-touch {shape} ({calls[shape]} calls): "
            f"{[round(t, 4) for t in ta]} ms with the gate, "
            f"{[round(t, 4) for t in tb]} ms without (in turns a, b, b, a):"
            f" x{np.mean(ta) / np.mean(tb):.3f}")
    g1_rows = check_g1(g1_spy, gen)
    c1_rows = chase_rows("self-touch", chase_spy, launches, counters, 2,
                         True)
    return (launches, small, b1_vg,
            (b5_vg[0], b5_vg[1], max(b5_vg[2], b5_err)), b4_rows,
            dict(calls), b4_err, g1_rows, g1_calls, c1_rows)



# --------------------------------------------------------------------------- #
# phase 11: the analysis extras (oversegment on V1, connect_points,
# synapses_to_targets)

# V1's forms on each side of its shape rule: one cluster up to 170 x 170,
# grid-wide strips up to about 850 x 850 (two carried fields), per plane
# beyond
V1_RULE = ((170, "cluster"), (171, "strips"), (840, "strips"),
           (880, "plane"))
# V1 at its edges: sweeps of 1, 2, 7 and 9 planes, planes of one, three
# and 17 rows, a cluster whose last strip is short, a plane that several
# strips share, a 512 x 512 plane in grid-wide strips
V1_EDGES = tuple((n, H, 6) for n in (1, 2, 7, 9) for H in (1, 3, 17)) \
    + ((17, 130, 121), (33, 301, 48), (18, 512, 512))
# one V1 sweep a voxel: d, f and ok read, d and f written; nine adds,
# nine compares and nine selects
V1_BYTES, V1_OPS = 17, 27


def v1_bound(shape):
    """Least time of one V1 sweep of `shape`. Returns (ms, by)."""
    vox = int(np.prod(shape))
    t_b, t_o = V1_BYTES * vox / HBM_BYTES_PER_S, V1_OPS * vox / ALU_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def v1_inputs(shape, gen, ties):
    """A field with a quarter of its voxels finite (small integers where
    `ties`, so that isotropic steps tie), their features, an ok mask;
    voxels outside it +inf, as the relaxation keeps them."""
    import torch

    r = lambda: torch.rand(shape, generator=gen, device="cuda")
    ok = r() < 0.85
    seeded = r() < 0.25
    vals = torch.floor(r() * 4) if ties else r() * 10
    d = torch.where(seeded & ok, vals, float("inf"))
    f = torch.where(seeded, torch.randint(
        1, 1 << 30, shape, generator=gen, device="cuda", dtype=torch.int32),
        0).to(torch.int32)
    return d.contiguous(), f.contiguous(), ok.contiguous()


def v1_case(shape, gen, anis, ties):
    """V1 against its plain version in both directions, each call made
    twice, its change flag against the plain one's, its distance against
    B5's euclid sweep of the same field, its first plane passed through.
    Returns the max abs error."""
    import torch

    from kimimaro_tpu_torch.ops import geodesic, sweep, voronoi

    d, f, ok = v1_inputs(shape, gen, ties)
    err = 0.0
    for desc in (False, True):
        costs = geodesic.plane_costs(0, desc, anis)
        flag = torch.zeros(1, dtype=torch.int32, device="cuda")
        want_flag = torch.zeros(1, dtype=torch.int32, device="cuda")
        got = voronoi.voronoi_sweep(d, f, ok, costs, desc, flag)
        again = voronoi.voronoi_sweep(d, f, ok, costs, desc,
                                      torch.zeros_like(flag))
        want = voronoi._voronoi_sweep_plain(d, f, ok, costs, desc, want_flag)
        name = f"V1 ties={ties} desc={desc} {shape}"
        err = max(err, require_equal(name, got, want))
        require_equal(name + " run twice", again, got)
        require_equal(name + " change flag", flag, want_flag)
        # a second sweep of the output changes nothing and leaves the flag 0
        still = torch.zeros_like(flag)
        require_equal(name + " swept again", voronoi.voronoi_sweep(
            got[0], got[1], ok, costs, desc, still), got)
        if int(still) != 0:
            raise AssertionError(f"{name}: the change flag is set by a sweep "
                                 f"that changes nothing")
        require_equal(name + " distance against B5", got[0],
                      sweep.sweep_axis0(d, ok, None, anis, False, False,
                                        desc))
        first = -1 if desc else 0
        require_equal(name + " first plane", (got[0][first], got[1][first]),
                      (d[first], f[first]))
    return err


def check_v1(gen):
    """V1 against its plain version at small and odd shapes, B5's stress
    shapes, each side of its form rule and a 512^3 volume with ties.
    Returns (ms, plain ms, err) of an ascending 512^3 sweep."""
    import torch

    from kimimaro_tpu_torch.ops import geodesic, voronoi

    anis = (40.0, 16.0, 16.0)
    err = 0.0
    for shape in ((11, 9, 8), *B5_STRESS_SHAPES, (96, 96, 96),
                  *V1_EDGES):
        for ties in (False, True):
            err = max(err, v1_case(shape, gen, (1.0, 1.0, 1.0) if ties
                                   else anis, ties))
        log(f"[kernels] V1 bit-equal on {shape} (plan "
            f"{json.dumps(voronoi.voronoi_plan(shape[1], shape[2]))}): both "
            f"directions, with and without ties, twice; distance = B5's")
    for side, form in V1_RULE:
        plan = voronoi.voronoi_plan(side, side)
        if plan["form"] != form:
            raise AssertionError(f"V1 {side}^2: plan {plan}, expected {form}")
        err = max(err, v1_case((2, side, side), gen, anis, False))
    log(f"[kernels] V1 bit-equal on each side of its form rule: "
        f"{json.dumps(V1_RULE)}")
    n = DENSE_N
    iso = (1.0, 1.0, 1.0)
    err = max(err, v1_case((n, n, n), gen, iso, True))
    d, f, ok = v1_inputs((n, n, n), gen, True)
    costs = geodesic.plane_costs(0, False, iso)
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: voronoi.voronoi_sweep(d, f, ok, costs, False, flag),
                 5)
    _, plain = timed_once(lambda: voronoi._voronoi_sweep_plain(
        d, f, ok, costs, False, flag))
    bms, by = v1_bound((n, n, n))
    plan = voronoi.voronoi_plan(n, n)
    log(f"[kernels] V1 at {n}^3 with ties (plan {json.dumps(plan)}): "
        f"bit-equal; {ms:.4f} ms vs plain {plain:.1f} ms, bound {bms:.3f} "
        f"ms ({by})")
    del d, f, ok
    return ms, plain, err


class V1Spy:
    """While installed, counts the calls of V1's single form per shape and
    keeps the arguments of the first call of each shape in `want` (every
    shape where `want` is None)."""

    def __init__(self, want=None):
        self.want = None if want is None else set(want)
        self.kept = {}
        self.calls = {}

    def install(self):
        from kimimaro_tpu_torch.ops import geodesic

        inner = geodesic.voronoi_sweep

        def spy(d, f, ok, costs9, descending, changed):
            if d.device.type == "cuda":
                shape = tuple(d.shape)
                self.calls[shape] = self.calls.get(shape, 0) + 1
                if (self.want is None or shape in self.want) and \
                        shape not in self.kept:
                    self.kept[shape] = (d.clone(), f.clone(), ok.clone(),
                                        tuple(costs9), bool(descending))
            return inner(d, f, ok, costs9, descending, changed)

        geodesic.voronoi_sweep = spy

        def restore():
            geodesic.voronoi_sweep = inner

        return restore


def check_v1_recorded(spy, tag="oversegment"):
    """V1 against its plain version on the calls a run made, each twice.
    Returns {shape: (ms, plain ms, bound ms, bound by, err)}."""
    import torch

    from kimimaro_tpu_torch.ops import voronoi

    out = {}
    for shape, (d, f, ok, costs, desc) in sorted(spy.kept.items()):
        flag = torch.zeros(1, dtype=torch.int32, device="cuda")
        want_flag = torch.zeros(1, dtype=torch.int32, device="cuda")
        got = voronoi.voronoi_sweep(d, f, ok, costs, desc, flag)
        again = voronoi.voronoi_sweep(d, f, ok, costs, desc,
                                      torch.zeros_like(flag))
        want, plain = timed_once(lambda: voronoi._voronoi_sweep_plain(
            d, f, ok, costs, desc, want_flag))
        err = require_equal(f"V1 {tag} call {shape}", got, want)
        require_equal(f"V1 {tag} call {shape} run twice", again, got)
        require_equal(f"V1 {tag} call {shape} flag", flag, want_flag)
        ms = cuda_ms(lambda: voronoi.voronoi_sweep(d, f, ok, costs, desc,
                                                   flag), 5)
        out[shape] = (ms, plain) + v1_bound(shape) + (err,)
        plan = voronoi.voronoi_plan(shape[1], shape[2])
        log(f"[kernels] V1 {tag} {shape} ({spy.calls.get(shape, 0)} calls, "
            f"plan {json.dumps(plan)}): {ms:.4f} ms vs plain {plain:.2f} "
            f"ms, bound {out[shape][2]:.4f} ms")
    return out


# the batched V1 (voronoi_sweep_lanes) on each side of its shape rule and
# at the shapes that stress it: (B, N, H, W) with each lane's extent
def v1_batched_cases(cap):
    rng = np.random.RandomState(7)
    many = np.stack([rng.randint(1, 7, 300), rng.randint(1, 10, 300),
                     rng.randint(1, 12, 300)], 1)
    return (
        ("mixed", (7, 9, 21, 19), [(9, 21, 19), (1, 21, 19), (9, 1, 19),
                                   (9, 21, 1), (0, 5, 5), (4, 7, 3),
                                   (6, 20, 18)], False),
        ("one", (1, 40, 100, 80), [(40, 100, 80)], False),
        ("many", (300, 6, 9, 11), many.tolist(), False),
        ("inactive", (8, 7, 16, 16), [(7, 16, 16)] * 8, True),
        ("shared", (2, 3, 100, cap // 100), [(3, 100, cap // 100),
                                             (2, 100, cap // 100 - 1)],
         False))


def check_v1_single_side(gen, cap):
    """The other side of voronoi_batched_plan: a plane of one cell more
    than one CTA's shared memory is refused by the batched kernel, and
    voronoi_feature_field_batched sends a crop with such a plane to V1's
    single-volume forms beside a batch of crops that fit; every field
    equal to voronoi_feature_field's on its own."""
    import torch

    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.ops import geodesic, voronoi

    plan = voronoi.voronoi_batched_plan(2, 100, cap // 100 + 1)
    if plan["form"] != "single":
        raise AssertionError(f"batched V1 beyond {cap} cells: plan {plan}")
    shape = (1, 3, 100, cap // 100 + 1)
    d, f, ok = v1_inputs(shape, gen, False)
    try:
        voronoi.voronoi_sweep_batched(d, f, ok, [shape[1:]],
                                      geodesic.plane_costs(0, False, ANIS),
                                      False, torch.zeros(1, dtype=torch.int32,
                                                         device="cuda"))
    except ValueError:
        pass
    else:
        raise AssertionError("the batched V1 swept a plane beyond one CTA")
    rng = np.random.RandomState(9)
    oks, seeds = [], []
    for crop in ((100, cap // 100 + 1, 3), (100, cap // 100, 3),
                 (20, 30, 40)):
        m = rng.rand(*crop) < 0.8
        pts = np.argwhere(m)
        oks.append(m)
        seeds.append(pts[rng.choice(len(pts), 5, replace=False)])
    before = dict(kernels.LAUNCHES)
    got = geodesic.voronoi_feature_field_batched(oks, seeds, ANIS)
    took = {k: kernels.LAUNCHES[k] - before[k]
            for k in ("voronoi_sweep", "voronoi_sweep_batched")}
    if min(took.values()) <= 0:
        raise AssertionError(f"batched field across the shape rule: V1 "
                             f"launches {took}")
    for m, s, field in zip(oks, seeds, got):
        require_equal(f"batched field {m.shape}", field,
                      geodesic.voronoi_feature_field(m, s, ANIS))
    log(f"[kernels] batched V1 shape rule, other side: a plane of "
        f"{cap + 100} cells refused by the batched kernel; a crop with such "
        f"a plane took V1's single forms beside a batch of two "
        f"({json.dumps(took)} launches), every field equal to its own "
        f"voronoi_feature_field")


def check_v1_batched(gen):
    """The batched V1 kernel against its plain version, each call twice,
    at mixed extents, one lane and 300, lanes with `active` off, and on
    each side of voronoi_batched_plan (a plane that fills one CTA's
    shared memory, and one cell more: `check_v1_single_side`); both
    directions, with and without ties. Returns the max abs error."""
    import torch

    from kimimaro_tpu_torch.ops import geodesic, voronoi

    cap = voronoi.voronoi_batched_plan(1, 1, 1)["capacity"]
    err = 0.0
    for name, shape, ext, inactive in v1_batched_cases(cap):
        plan = voronoi.voronoi_batched_plan(shape[0], shape[2], shape[3])
        if plan["form"] != "shared":
            raise AssertionError(f"batched V1 {shape}: plan {plan}")
        ext_t = torch.tensor(ext, dtype=torch.int32)
        active = ((torch.arange(shape[0], device="cuda") % 2 == 0)
                  if inactive else None)
        for ties in (False, True):
            d, f, ok = v1_inputs(shape, gen, ties)
            anis = (1.0, 1.0, 1.0) if ties else (40.0, 16.0, 16.0)
            for desc in (False, True):
                costs = geodesic.plane_costs(0, desc, anis)
                runs = []
                for _ in range(2):
                    gd, gf = d.clone(), f.clone()
                    flag = torch.zeros(shape[0], dtype=torch.int32,
                                       device="cuda")
                    voronoi.voronoi_sweep_batched(gd, gf, ok, ext_t, costs,
                                                  desc, flag, active)
                    runs.append((gd, gf, flag))
                wd, wf = d.clone(), f.clone()
                wflag = torch.zeros(shape[0], dtype=torch.int32,
                                    device="cuda")
                voronoi._voronoi_sweep_lanes_plain(
                    wd, wf, ok, voronoi.VoronoiLanes.batched(shape, ext_t),
                    costs, desc, wflag, active)
                tag = f"batched V1 {name} {shape} ties={ties} desc={desc}"
                err = max(err, require_equal(tag, runs[0], (wd, wf, wflag)))
                require_equal(tag + " run twice", runs[1], runs[0])
        log(f"[kernels] batched V1 bit-equal on {name} {shape} (form "
            f"{plan['form']}, {plan['lanes']} lanes a CTA): both "
            f"directions, with and without ties, twice")
    check_v1_single_side(gen, cap)
    log(f"[kernels] batched V1 shape rule: a plane of up to {cap} cells in "
        f"one CTA's shared memory, beyond it V1's single forms")
    return err


class V1LaneSpy:
    """While installed, counts the batched V1 calls of each batch and
    layout (axis) of a run; with `keep`, keeps on the host the first
    round's calls (each layout, both directions) of the run's first and
    last batches."""

    def __init__(self, keep=False):
        self.keep = keep
        self.batches = []  # each batch's lane tables, in layout order
        self.calls = {}    # (batch, layout) -> calls
        self.kept = {}     # (batch, layout, descending) -> the call

    def install(self):
        from kimimaro_tpu_torch.ops import voronoi

        inner = voronoi.voronoi_sweep_lanes

        def spy(d, f, ok, lanes, costs9, descending, changed, active=None):
            if d.device.type == "cuda":
                if not self.batches or (len(self.batches[-1]) == 3 and not any(
                        x is lanes for x in self.batches[-1])):
                    self.batches.append([])
                    self.kept = {k: v for k, v in self.kept.items()
                                 if k[0] == 0}
                cur = self.batches[-1]
                if not any(x is lanes for x in cur):
                    cur.append(lanes)
                key = (len(self.batches) - 1,
                       [x is lanes for x in cur].index(True))
                self.calls[key] = self.calls.get(key, 0) + 1
                if self.keep and self.calls[key] <= 2:
                    self.kept[key + (bool(descending),)] = (
                        d.cpu(), f.cpu(), ok, lanes, tuple(costs9),
                        bool(descending),
                        None if active is None else active.clone())
            return inner(d, f, ok, lanes, costs9, descending, changed, active)

        voronoi.voronoi_sweep_lanes = spy

        def restore():
            voronoi.voronoi_sweep_lanes = inner

        return restore


def lanes_bound(lanes, active):
    """Least time of one batched V1 sweep: 17 bytes a real voxel of its
    live, active lanes (and 27 operations). Returns (ms, by, voxels)."""
    t = lanes.table
    on = lanes.live() & (np.ones(len(t), bool) if active is None
                         else active.cpu().numpy().astype(bool))
    vox = int((t[on, 1] * t[on, 2] * t[on, 3]).sum())
    t_b, t_o = V1_BYTES * vox / HBM_BYTES_PER_S, V1_OPS * vox / ALU_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations", vox


def check_v1_lanes_recorded(spy):
    """The batched V1 kernel against its plain version on the calls the
    spy kept, each run twice on fresh copies of the recorded fields; the
    kernel timed with CUDA events over fresh copies, the plain version
    once. Returns {(batch, layout, descending): (ms, plain ms, bound ms,
    bound by, err, lanes, voxels, calls)}."""
    import torch

    from kimimaro_tpu_torch.ops import voronoi

    out = {}
    for key, (d_h, f_h, ok, lanes, costs, desc, active) in sorted(
            spy.kept.items()):
        d0, f0 = d_h.cuda(), f_h.cuda()
        runs = []
        for _ in range(2):
            d, f = d0.clone(), f0.clone()
            flag = torch.zeros(len(lanes), dtype=torch.int32, device="cuda")
            voronoi.voronoi_sweep_lanes(d, f, ok, lanes, costs, desc, flag,
                                        active)
            runs.append((d, f, flag))
        d, f = d0.clone(), f0.clone()
        wflag = torch.zeros(len(lanes), dtype=torch.int32, device="cuda")
        _, plain = timed_once(lambda: voronoi._voronoi_sweep_lanes_plain(
            d, f, ok, lanes, costs, desc, wflag, active))
        name = f"batched V1 recorded call {key}"
        err = require_equal(name, runs[0], (d, f, wflag))
        require_equal(name + " run twice", runs[1], runs[0])
        del runs, d, f
        times = []
        for _ in range(5):
            d, f = d0.clone(), f0.clone()
            flag = torch.zeros(len(lanes), dtype=torch.int32, device="cuda")
            times.append(timed_once(lambda: voronoi.voronoi_sweep_lanes(
                d, f, ok, lanes, costs, desc, flag, active))[1])
        ms = float(np.mean(times[1:]))
        bms, by, vox = lanes_bound(lanes, active)
        live = int(lanes.live().sum())
        calls = spy.calls[key[:2]]
        out[key] = (ms, plain, bms, by, err, live, vox, calls)
        log(f"[kernels] batched V1 recorded call batch {key[0]} axis "
            f"{key[1]} desc={key[2]}: {live} lanes, {vox} voxels, "
            f"{d0.numel()} padded; {ms:.4f} ms vs plain {plain:.1f} ms, "
            f"bound {bms:.4f} ms ({by}); {calls} calls of this batch and "
            f"axis a run")
        del d0, f0, d, f
    return out


# shared-memory bytes a plane cell of the batched V1 takes: two carried
# copies of d and f, and with a two-stage cp.async prefetch of the cell's
# own d, f and ok 18 bytes more
V1_CARRIED_BYTES, V1_PREFETCH_BYTES = 16, 18


def prefetch_count(spy, cap):
    """Over every batched V1 call of the run the spy counted: the lanes
    (and their voxels) whose plane fits one CTA's shared memory as the
    kernel carries it (`cap` cells) but would not fit with a two-stage
    prefetch of each cell's own d, f and ok, by layout. Returns
    {layout: (lanes, all live lanes, their voxels, all voxels)}, each
    batch's lanes counted once per layout."""
    cap_pf = cap * V1_CARRIED_BYTES // (V1_CARRIED_BYTES + V1_PREFETCH_BYTES)
    out = {}
    for tables in spy.batches:
        for layout, lanes in enumerate(tables):
            t, live = lanes.table, lanes.live()
            cells = lanes.cells()
            lose = live & (cells > cap_pf) & (cells <= cap)
            vox = t[:, 1] * cells
            a, b, c, d = out.get(layout, (0, 0, 0, 0))
            out[layout] = (a + int(lose.sum()), b + int(live.sum()),
                           c + int(vox[lose].sum()), d + int(vox[live].sum()))
    return out, cap_pf


def first_appearance(a):
    """The values of a 1-D array renumbered 0, 1, ... by first appearance."""
    _, first, inv = np.unique(a, return_index=True, return_inverse=True)
    rank = np.empty_like(first)
    rank[np.argsort(first)] = np.arange(len(first))
    return rank[inv.ravel()]


# V1 launches a dense oversegment run may make on the batched route (25,608
# a crop at a time), and the device memory it may take: the dense
# skeletonize run's peak (PERF.md section 5)
V1_BATCHED_LAUNCHES = 1000
DENSE_PEAK_GIB = 15.60


def oversegment_run(tag, vol, skels, downsample, spy=None, per_crop=False):
    """oversegment on the card once, the launch counts reset just before
    it and read just after: the batched route, or with `per_crop` the
    route that runs voronoi_feature_field on each crop (V1's single
    form). Checks the launches of the route, the lane-rounds and the
    device memory the run took beyond what was held before it. Returns
    (labels, skeletons, launches)."""
    import importlib

    import torch

    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    ovs = importlib.import_module("kimimaro_tpu_torch.oversegment")
    restore = spy.install() if spy is not None else None
    profiling.reset_stats()
    profiling.collect(True)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        if per_crop:
            labels, out = ovs._oversegment(vol, skels, ANIS, False, False,
                                           False, downsample, "cuda",
                                           per_crop=True)
        else:
            labels, out = ovs.oversegment(vol, skels, anisotropy=ANIS,
                                          downsample=downsample,
                                          device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        profiling.collect(False)
        if restore is not None:
            restore()
    launches = dict(kernels.LAUNCHES)
    peak = (torch.cuda.max_memory_allocated() - held) / 2**30
    stats = profiling.get_stats()
    phases = {k: round(v, 3) for k, v in stats["phases"].items()}
    counters = stats["counters"]
    pad = (counters["voronoi_padded_voxels"] / counters["voronoi_voxels"]
           if counters.get("voronoi_voxels") else None)
    route = "per crop" if per_crop else "batched"
    log(f"[oversegment] {tag} ({route}, downsample={downsample}): "
        f"{secs:.2f} s for {len(out)} skeletons; phases (s) "
        f"{json.dumps(phases)}; counters {json.dumps(counters)}; V1 "
        f"launches {launches['voronoi_sweep']} single, "
        f"{launches['voronoi_sweep_batched']} batched; padded / real "
        f"voxels {pad}; device memory {peak:.2f} GiB beyond the "
        f"{held / 2**30:.2f} GiB held before the run")
    if per_crop:
        if launches["voronoi_sweep"] <= 0 or \
                launches["voronoi_sweep_batched"] != 0:
            raise AssertionError("oversegment's per-crop route: V1 launches "
                                 f"{launches}")
    elif not (0 < launches["voronoi_sweep_batched"] and
              launches["voronoi_sweep_batched"] + launches["voronoi_sweep"]
              < V1_BATCHED_LAUNCHES and (launches["voronoi_sweep"] > 0) ==
              (counters.get("voronoi_single_lanes", 0) > 0)):
        raise AssertionError(
            f"oversegment: {launches['voronoi_sweep_batched']} batched and "
            f"{launches['voronoi_sweep']} single V1 launches for "
            f"{counters.get('voronoi_single_lanes', 0)} crops beyond the "
            f"batched kernel's planes")
    if peak >= DENSE_PEAK_GIB:
        raise AssertionError(f"oversegment took {peak:.2f} GiB of device "
                             f"memory, the dense skeletonize run "
                             f"{DENSE_PEAK_GIB}")
    # a change flag stuck at 1 would run every crop to the cap of 4096
    # rounds with the same fields; the crops converge in about two
    rounds = counters.get("voronoi_rounds", 0)
    if not 0 < rounds <= 4 * len(out):
        raise AssertionError(f"oversegment: {rounds} V1 lane-rounds for "
                             f"{len(out)} skeletons")
    return labels, out, launches


def require_same_oversegment(tag, got, want):
    """The composite and every skeleton's segments of two runs equal."""
    (gl, gs), (wl, ws) = got, want
    if gl.dtype != wl.dtype or not np.array_equal(gl, wl):
        raise AssertionError(f"oversegment {tag}: the composites differ in "
                             f"{int((gl != wl).sum())} voxels")
    bad = [k for k in ws if not np.array_equal(gs[k].segments,
                                               ws[k].segments)]
    if bad or set(gs) != set(ws):
        raise AssertionError(f"oversegment {tag}: segments differ for "
                             f"labels {bad[:10]}")


def check_oversegment(vol, slcs, skels, labels, out, downsample, n_cpu=6):
    """The composite: uint64 of the volume's shape, background 0, every
    voxel of a skeletonized label in a segment, as many segments as
    distinct seed voxels, a segment per vertex; and on the crops of
    `n_cpu` labels (their boxes of `slcs` grown by one, the volume's other
    labels in them) equal to the port's CPU run, up to the ids."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch.utils.bbox import Bbox

    if labels.shape != vol.shape or labels.dtype != np.uint64:
        raise AssertionError(f"oversegment: {labels.shape} {labels.dtype}")
    if (labels[vol == 0] != 0).any():
        raise AssertionError("oversegment: background got a segment")
    lut = np.zeros(int(vol.max()) + 1, dtype=bool)
    lut[np.array(sorted(skels))] = True
    lost = int((labels[lut[vol]] == 0).sum())
    if lost:
        raise AssertionError(f"oversegment: {lost} voxels of skeletonized "
                             f"labels without a segment")
    anis = np.asarray(ANIS, dtype=np.float32)
    seeds = 0
    for s in skels.values():
        seg = s.downsample(downsample) if downsample > 0 else s
        v = (seg.vertices / anis).round().astype(int)
        seeds += len(np.unique(v, axis=0))
    segs = torch.unique(torch.from_numpy(labels.view(np.int64)).cuda())
    n_segs = int(segs.numel()) - int(bool((segs == 0).any()))
    if n_segs != seeds:
        raise AssertionError(f"oversegment: {n_segs} segments, {seeds} "
                             f"distinct seed voxels")
    bad = [k for k, s in out.items() if len(s.segments) != len(s.vertices)]
    if bad:
        raise AssertionError(f"oversegment: labels {bad[:10]} lack segments")
    # the CPU on the crops of n_cpu labels, spread over the smaller half
    by_size = sorted(skels, key=lambda k: int(np.prod(
        np.ptp(skels[k].vertices, axis=0) + 1)))
    pick = by_size[:len(by_size) // 2][::max(1, len(by_size) // 2 // n_cpu)]
    t0 = time.perf_counter()
    for k in pick[:n_cpu]:
        roi = Bbox.from_slices(slcs[k - 1])
        roi.grow(1)
        roi.minpt = np.clip(roi.minpt, 0, None)
        roi.maxpt = np.minimum(roi.maxpt, np.array(vol.shape))
        slc = roi.to_slices()
        cut = vol[slc]
        skel = skels[k].clone()
        skel.vertices = skel.vertices - roi.minpt.astype(np.float32) * anis
        cl, cs = kimimaro_tpu_torch.oversegment(
            cut, {k: skel}, anisotropy=ANIS, downsample=downsample,
            device="cpu")
        mine = cut == k
        card, cpu = labels[slc][mine], cl[mine]
        if not np.array_equal(first_appearance(card), first_appearance(cpu)):
            raise AssertionError(f"oversegment: label {k} card != CPU")
        to_cpu = dict(zip(card.tolist(), cpu.tolist()))
        if [to_cpu.get(int(s)) for s in out[k].segments] != \
                cs[k].segments.tolist():
            raise AssertionError(f"oversegment: label {k} segments card != "
                                 f"CPU")
    log(f"[oversegment] downsample={downsample}: uint64 composite, every "
        f"voxel of the {len(skels)} skeletonized labels in one of {n_segs} "
        f"segments (= distinct seed voxels), a segment per vertex; card = "
        f"CPU on the crops of {len(pick[:n_cpu])} labels "
        f"({time.perf_counter() - t0:.1f} s)")


def neurite_walk(n=DENSE_N, steps=2000, radius=3.0, seed=0):
    """One winding neurite alone in an n^3 volume, in the manner of
    bench.py's synthetic_volume_neurite: a persistent random walk of
    `steps` steps of 2 voxels in x and y (0.8 in z) from the centre,
    stamped with a ball of `radius` voxels (squashed in z by the
    anisotropy). Returns (volume, centres, start, end): start and end are
    the walk's two ends."""
    rng = np.random.RandomState(seed)
    aniso = np.asarray(ANIS, dtype=np.float32)
    pos = np.full(3, n / 2, dtype=np.float32)
    d = rng.randn(3).astype(np.float32)
    d /= np.linalg.norm(d)
    step = 2.0 / (aniso / aniso[0])
    pts = np.empty((steps, 3), dtype=np.float32)
    for i in range(steps):
        pts[i] = pos
        d = d + rng.randn(3).astype(np.float32) * 0.18
        d /= max(float(np.linalg.norm(d)), 1e-6)
        pos = np.clip(pos + d * step, 0, n - 1)
    r = int(round(radius))
    w = np.arange(-r, r + 1)
    ox, oy, oz = np.meshgrid(w, w, w, indexing="ij")
    keep = ox ** 2 + oy ** 2 + (oz * (aniso[2] / aniso[0])) ** 2 <= radius ** 2
    offs = np.stack([ox[keep], oy[keep], oz[keep]], axis=-1)
    vox = (pts[:, None, :].astype(np.int64) + offs[None]).reshape(-1, 3)
    np.clip(vox, 0, n - 1, out=vox)
    vol = np.zeros((n, n, n), dtype=bool)
    vol[vox[:, 0], vox[:, 1], vox[:, 2]] = True
    ends = [tuple(int(c) for c in pts[i].astype(np.int64)) for i in (0, -1)]
    return vol, pts, ends[0], ends[1]


def check_path(skel, vol, start, end, what):
    """The skeleton of connect_points is one path from `end` (the source
    of the field) to `start`, of 26-adjacent voxels inside the mask, its
    radii the EDT at its vertices. Returns its voxels."""
    import torch

    from kimimaro_tpu_torch.ops import edt as edt_ops

    anis = np.asarray(ANIS, dtype=np.float32)
    vox = np.rint(skel.vertices / anis).astype(np.int64)
    if tuple(vox[0]) != tuple(end) or tuple(vox[-1]) != tuple(start):
        raise AssertionError(f"{what}: the path runs {tuple(vox[0])} -> "
                             f"{tuple(vox[-1])}, not {end} -> {start}")
    steps = np.abs(np.diff(vox, axis=0))
    if len(vox) > 1 and (steps.max() > 1 or (steps.sum(axis=1) == 0).any()):
        raise AssertionError(f"{what}: a step of the path is not a "
                             f"26-neighbour move")
    if not vol[tuple(vox.T)].all():
        raise AssertionError(f"{what}: the path leaves the mask")
    edges = np.stack([np.arange(len(vox) - 1), np.arange(1, len(vox))], 1)
    if not np.array_equal(skel.edges, edges.astype(skel.edges.dtype)):
        raise AssertionError(f"{what}: the edges are not one chain")
    dbf = edt_ops.edt(torch.from_numpy(vol.view(np.uint8)).cuda(), ANIS,
                      black_border=True)
    at = dbf[tuple(torch.from_numpy(vox[:, a]).cuda() for a in range(3))]
    if not np.array_equal(skel.radii, at.cpu().numpy()):
        raise AssertionError(f"{what}: radii differ from the EDT")
    return vox


def connect_points_phase():
    """connect_points on one winding neurite in an empty 512^3 volume on the
    card, once, its launches reset just before it and read just after, with
    B5's calls of each mode and direction in its second round recorded and
    held bit-equal to the plain sweep; then the same call on a cut of the
    volume, card against CPU. Returns (launches, B5's table rows)."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    vol, pts, start, end = neurite_walk()
    log(f"[connect] neurite of {len(pts)} steps, {int(vol.sum())} voxels in "
        f"{vol.shape}, from {start} to {end} (made in "
        f"{time.perf_counter() - t0:.1f} s, set-up)")
    # each key's calls run three to a round (one per axis): call 3 is the
    # second round's first
    spy = B5Spy(nth=3)
    restore = spy.install()
    profiling.reset_stats()
    profiling.collect(True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        skel = kimimaro_tpu_torch.connect_points(vol, start, end,
                                                 anisotropy=ANIS,
                                                 device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        profiling.collect(False)
        restore()
    launches = dict(kernels.LAUNCHES)
    phases = {k: round(v, 3) for k, v in profiling.get_stats()["phases"]
              .items()}
    vox = check_path(skel, vol, start, end, "connect_points")
    log(f"[connect] {secs:.2f} s: a path of {len(vox)} vertices, "
        f"{skel.cable_length():.0f} nm; phases (s) {json.dumps(phases)}; "
        f"B5 sweeps {launches['sweep_axis0']} (rounds of six: "
        f"{launches['sweep_axis0'] / 6:.0f}, both fields), B1 sweeps "
        f"{launches['gsweep_sweep0']}, F1 {launches['fma_f32']}")
    for k in ("sweep_axis0", "gsweep_sweep0", "fma_f32"):
        if launches[k] <= 0:
            raise AssertionError(f"connect_points launched no {k}")
    # B5 at the shapes of this run: the recorded calls against the plain
    # sweep, a table row for each mode at the most timed direction
    recorded = {}
    b5_err = check_b5_recorded(spy, recorded)
    modes = {m for _, m, _, _, _ in recorded}
    if modes != {False, True}:
        raise AssertionError(f"connect_points: B5 recorded in modes {modes}")
    b5_rows = []
    for node in (False, True):
        keys = [k for k in recorded if k[1] == node]
        key = max(keys, key=lambda k: recorded[k][0])
        ms, plain, err = recorded[key]
        calls = sum(v for k, v in spy.seen.items() if k[1] == node)
        bms, by = b4_bound(key[0], node)
        mode = "node" if node else "euclid"
        log(f"[kernels] B5 connect_points {key[0]} {mode}: {len(keys)} "
            f"recorded calls bit-equal to the plain sweep; {ms:.3f} ms vs "
            f"plain {plain:.1f} ms, bound {bms:.3f} ms ({by}); {calls} calls "
            f"in the run")
        b5_rows.append({
            "name": f"sweep_axis0 {key[0]} {mode}", "route": "cuda",
            "source": "kimimaro_tpu_torch/csrc/sweep.cu",
            "replaces": "kimimaro_tpu/ops/pallas_sweep.py:117",
            "launches": calls, "max_abs_err": max(err, b5_err),
            "ms": round(ms, 4), "plain_ms": round(plain, 4),
            "bound_ms": round(bms, 4), "bound_by": by, "library_ms": None})
    del spy, recorded
    # a cut of at most 160 voxels a side around the walk's first steps
    k = len(pts)
    while k > 2:
        lo = np.maximum(np.floor(pts[:k].min(axis=0)).astype(int) - 4, 0)
        hi = np.minimum(np.ceil(pts[:k].max(axis=0)).astype(int) + 5,
                        DENSE_N)
        if (hi - lo).max() <= 160:
            break
        k = k * 15 // 16
    cut = vol[tuple(slice(a, b) for a, b in zip(lo, hi))]
    s_cut = tuple(int(c) for c in np.asarray(start) - lo)
    e_cut = tuple(int(c) for c in pts[k - 1].astype(np.int64) - lo)
    t0 = time.perf_counter()
    got = kimimaro_tpu_torch.connect_points(cut, s_cut, e_cut,
                                            anisotropy=ANIS, device="cuda")
    want = kimimaro_tpu_torch.connect_points(cut, s_cut, e_cut,
                                             anisotropy=ANIS, device="cpu")
    for name in ("vertices", "edges", "radii"):
        if not np.array_equal(getattr(got, name), getattr(want, name)):
            raise AssertionError(f"connect_points on the cut {cut.shape}: "
                                 f"{name} card != CPU")
    check_path(got, cut, s_cut, e_cut, "connect_points on the cut")
    log(f"[connect] cut {cut.shape} over the walk's first {k} steps: card = "
        f"CPU, a path of {len(got.vertices)} vertices "
        f"({time.perf_counter() - t0:.1f} s)")
    return launches, b5_rows


def synapse_targets_plain(labels, synapses):
    """synapses_to_targets by the plain loop: each label's voxels by one
    whole-volume compare, the nearest voxel of each centroid by cdist."""
    import scipy.spatial

    targets = {}
    for label, pairs in synapses.items():
        cloud = np.vstack((labels == label).nonzero()).T
        if len(cloud) == 0:
            continue
        by_swc = {}
        for centroid, swc in pairs:
            by_swc.setdefault(swc, []).append(centroid)
        for swc, centroids in by_swc.items():
            near = np.argmin(scipy.spatial.distance.cdist(cloud, centroids),
                             axis=0)
            for i in np.unique(near):
                targets[tuple(int(c) for c in cloud[i])] = swc
    return targets


def synapse_phase(dense, slcs):
    """synapses_to_targets for 2 seeded centroids on each of 256 labels of
    the dense volume above the dust threshold (the host pass timed; the
    same targets by the plain whole-volume loop on 8 of them), then
    skeletonize(extra_targets_after=) on the card once, launches reset
    just before it and read just after: every target is a vertex of its
    label's skeleton."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    rng = np.random.RandomState(11)
    big = np.flatnonzero(np.bincount(dense.ravel()) > 1000)
    big = big[big > 0]
    labs = rng.choice(big, size=min(256, len(big)), replace=False)
    syn = {}
    for lab in labs:
        s = slcs[lab - 1]
        syn[int(lab)] = [(tuple(float(rng.uniform(x.start, x.stop - 1))
                                for x in s), j + 1) for j in range(2)]
    t0 = time.perf_counter()
    targets = kimimaro_tpu_torch.synapses_to_targets(dense, syn)
    host = time.perf_counter() - t0
    few = {k: syn[k] for k in list(syn)[:8]}
    t0 = time.perf_counter()
    scan = synapse_targets_plain(dense, few)
    scan_s = time.perf_counter() - t0
    if scan != kimimaro_tpu_torch.synapses_to_targets(dense, few):
        raise AssertionError("synapses_to_targets != the plain loop")
    log(f"[synapses] {len(targets)} targets of {len(syn)} labels in "
        f"{host:.3f} s on the host (one pass over the volume); the plain "
        f"whole-volume loop {scan_s:.2f} s for 8 labels, the same targets")
    profiling.reset_stats()
    profiling.collect(True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    try:
        skels = kimimaro_tpu_torch.skeletonize(
            dense, teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=1000,
            fix_borders=True, fix_branching=True,
            extra_targets_after=list(targets), device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        profiling.collect(False)
    launches = dict(kernels.LAUNCHES)
    stats = profiling.get_stats()
    counters = {k: stats["counters"].get(k, 0) for k in
                ("engine_jobs", "crop_engine_jobs", "fallback_jobs")}
    anis = np.asarray(ANIS, dtype=np.float32)
    missing = []
    for t in targets:
        lab = int(dense[t])
        verts = {tuple(v) for v in skels[lab].vertices.tolist()}
        if tuple((np.asarray(t, np.float32) * anis).tolist()) not in verts:
            missing.append((lab, t))
    if missing:
        raise AssertionError(f"synapse targets not among their label's "
                             f"vertices: {missing[:5]} ({len(missing)})")
    log(f"[synapses] skeletonize(extra_targets_after) {secs:.2f} s, "
        f"{len(skels)} skeletons; each of the {len(targets)} targets is a "
        f"vertex of its label; jobs {json.dumps(counters)}; phases (s) "
        f"{json.dumps({k: round(v, 3) for k, v in stats['phases'].items()})}")
    return launches


def analysis_phase(dense, dense_skels, gen, hollow=None, soma_skels=None):
    """Phase 11: V1 and its batched form against their plain versions;
    oversegment of the dense volume with its skeletons (downsample 0 and
    5, each a first and a warm run on the batched route, then the per-crop
    route, every composite and segment equal) with its checks, and of the
    soma volume with its skeletons where given; the batched V1 on the
    calls a run made, V1's single form on every shape the batched runs
    sent it (the crops with a plane beyond one CTA); connect_points on a
    512^3 neurite; synapses_to_targets through skeletonize. Returns
    (launches of those runs but the per-crop reference route's, V1 at
    512^3, V1's rows by (run, shape) with their calls, the batched V1's
    recorded calls, its max abs error, B5's table rows of
    connect_points)."""
    import scipy.ndimage

    from kimimaro_tpu_torch.ops import voronoi

    v1 = check_v1(gen)
    v1b_err = check_v1_batched(gen)
    slcs = scipy.ndimage.find_objects(dense)
    total = {}

    def add(part):
        for k, v in part.items():
            total[k] = total.get(k, 0) + v

    batched = {}
    single = {}
    for ds in (0, 5):
        counting = V1LaneSpy() if ds == 0 else None
        labels, out, launches = oversegment_run("first run", dense,
                                                dense_skels, ds, counting)
        add(launches)
        check_oversegment(dense, slcs, dense_skels, labels, out, ds)
        del labels, out
        # the crops that take V1's single form on the user's route
        if ds == 0:
            single["dense"] = V1Spy()
        batched[ds] = oversegment_run("warm run", dense, dense_skels, ds,
                                      single.get("dense") if ds == 0
                                      else None)
        add(batched[ds][2])
        if ds == 0:
            log(f"[oversegment] batched V1 calls by (batch, axis): "
                f"{json.dumps({str(k): v for k, v in counting.calls.items()})}")
            cap = voronoi.voronoi_batched_plan(1, 1, 1)["capacity"]
            lose, cap_pf = prefetch_count(counting, cap)
            log(f"[oversegment] batched V1 lanes with a plane of "
                f"{cap_pf}-{cap} cells (carried in shared memory now, beyond "
                f"it with a two-stage prefetch of {V1_PREFETCH_BYTES} more "
                f"bytes a cell), by layout: (lanes, of live lanes, their "
                f"voxels, of all voxels) "
                f"{json.dumps({str(k): v for k, v in lose.items()})}")
    if hollow is not None:
        single["soma"] = V1Spy()
        labels, out, launches = oversegment_run(
            "soma run", hollow, soma_skels, 0, single["soma"])
        add(launches)
        check_oversegment(hollow, scipy.ndimage.find_objects(hollow),
                          soma_skels, labels, out, 0, n_cpu=4)
        del labels, out
    recording = V1LaneSpy(keep=True)
    oversegment_run("recorded run", dense, dense_skels, 0, recording)
    lanes_rows = check_v1_lanes_recorded(recording)
    del recording
    v1b_err = max([v1b_err] + [v[4] for v in lanes_rows.values()])
    per_crop = 0
    for ds in (0, 5):
        got = batched.pop(ds)
        per = oversegment_run("per-crop run", dense, dense_skels, ds,
                              per_crop=True)
        per_crop += per[2]["voronoi_sweep"]
        require_same_oversegment(f"downsample={ds} batched against per "
                                 f"crop", got[:2], per[:2])
        log(f"[oversegment] downsample={ds}: the batched route's composite "
            f"and the segments of all {len(per[1])} skeletons equal the "
            f"per-crop route's")
        del got, per
    log(f"[oversegment] V1 single-form launches: {total['voronoi_sweep']} "
        f"on the user's (batched) route, {per_crop} on the per-crop "
        f"reference route (a cross-check, left out of the kernel table)")
    rows = {}
    for tag, spy in single.items():
        if not spy.kept:
            raise AssertionError(f"oversegment {tag}: no crop took V1's "
                                 f"single form")
        for shape, row in check_v1_recorded(spy, tag).items():
            rows[(tag, shape)] = (spy.calls[shape], row)
    log(f"[kernels] V1's single form on every shape the batched runs sent "
        f"it: {json.dumps({f'{t} {s}': c for (t, s), (c, _) in rows.items()})}"
        f" (calls a run), each bit-equal to its plain version, twice")
    launches, b5_rows = connect_points_phase()
    add(launches)
    add(synapse_phase(dense, slcs))
    return total, v1, rows, lanes_rows, v1b_err, b5_rows


def v1_table(launches, v1, rows, lanes_rows, v1b_err):
    """The kernel table's V1 rows: a 512^3 sweep with all of the main
    path's single-form V1 launches (the batched route's crops with a plane
    beyond one CTA), each shape those crops gave with its calls of a run,
    the batched form with all of its launches, and each of its recorded
    calls (batch, axis, direction) with the calls of its batch and axis in
    a run."""
    n = DENSE_N
    ms, plain, err = v1
    err = max([err] + [v[4] for _, v in rows.values()])
    bms, by = v1_bound((n, n, n))
    table = [{"name": "voronoi_sweep", "route": "cuda",
              "source": "kimimaro_tpu_torch/csrc/voronoi.cu",
              "replaces": "kimimaro_tpu/ops/geodesic.py:727",
              "launches": launches["voronoi_sweep"], "max_abs_err": err,
              "ms": round(ms, 4), "plain_ms": round(plain, 4),
              "bound_ms": round(bms, 4), "bound_by": by, "library_ms": None}]
    for (tag, shape), (calls, (ms, plain, bms, by, _)) in sorted(
            rows.items()):
        table.append({"name": f"voronoi_sweep {tag} {shape}",
                      "route": "cuda",
                      "source": "kimimaro_tpu_torch/csrc/voronoi.cu",
                      "replaces": "kimimaro_tpu/ops/geodesic.py:727",
                      "launches": calls, "max_abs_err": err,
                      "ms": round(ms, 4), "plain_ms": round(plain, 4),
                      "bound_ms": round(bms, 4), "bound_by": by,
                      "library_ms": None})
    for key, (ms, plain, bms, by, _, live, vox, calls) in sorted(
            lanes_rows.items()):
        table.append({
            "name": f"voronoi_sweep_batched batch {key[0]} axis {key[1]} "
                    f"{'desc' if key[2] else 'asc'} ({live} lanes, {vox} "
                    f"voxels)",
            "route": "cuda", "source": "kimimaro_tpu_torch/csrc/voronoi.cu",
            "replaces": "kimimaro_tpu/ops/geodesic.py:727",
            "launches": calls, "max_abs_err": v1b_err, "ms": round(ms, 4),
            "plain_ms": round(plain, 4), "bound_ms": round(bms, 4),
            "bound_by": by, "library_ms": None})
    if lanes_rows:
        first = lanes_rows[min(lanes_rows)]
        table.insert(len(rows) + 1, {
            "name": "voronoi_sweep_batched", "route": "cuda",
            "source": "kimimaro_tpu_torch/csrc/voronoi.cu",
            "replaces": "kimimaro_tpu/ops/geodesic.py:727",
            "launches": launches["voronoi_sweep_batched"],
            "max_abs_err": v1b_err, "ms": round(first[0], 4),
            "plain_ms": round(first[1], 4), "bound_ms": round(first[2], 4),
            "bound_by": first[3], "library_ms": None})
    return table


def profile_dense(top=25):
    """`--profile`: one warm dense 512^3 run under torch.profiler. Prints
    the card's busy share (device time of all kernels and copies over the
    run's wall time) and the operations that took most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    import kimimaro_tpu_torch

    def run():
        t0 = time.perf_counter()
        kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=1000,
            fix_borders=True, fix_branching=True, device="cuda")
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    vol = dense_volume(DENSE_N)
    log(f"[profile] first run {run():.2f} s, second run {run():.2f} s")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        secs = run()
    # device-side events only (kernels, copies, memsets): a host operator's
    # row repeats the time of the kernels it launched
    rows = sorted(((e.key, e.count, e.self_device_time_total)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[2])
    busy = sum(r[2] for r in rows) / 1e6
    log(f"[profile] profiled run {secs:.2f} s; device time {busy:.3f} s in "
        f"{sum(r[1] for r in rows)} kernels and copies, busy share "
        f"{busy / secs:.3f}")
    for key, count, us in rows[:top]:
        log(f"[profile] {us / 1e6:8.4f} s {count:7d} x  {key[:100]}")
    return 0


def ab_library(parent):
    """The kernel library built from the sources of another checkout at
    `parent` (the same nvcc flags, one nvcc per source), loaded with the
    entry points B6 and F1 had there: kt_xs_fetch without the path flag
    and divisor, kt_fma_f32 with 64-bit strides and no negate."""
    import ctypes

    from kimimaro_tpu_torch import kernels

    csrc = os.path.join(parent, "kimimaro_tpu_torch", "csrc")
    out = os.path.join(ROOT, "build", "ab")
    os.makedirs(out, exist_ok=True)
    nvcc = kernels._nvcc()
    srcs = sorted(f for f in os.listdir(csrc) if f.endswith(".cu"))
    objs = [os.path.join(out, f + ".o") for f in srcs]
    kernels._run_all([nvcc, *kernels.NVCC_FLAGS, "-c", "-I", csrc, "-o", o,
                      os.path.join(csrc, f)] for f, o in zip(srcs, objs))
    lib = os.path.join(out, "libparent.so")
    kernels._run_all([[nvcc, *kernels.LINK_FLAGS, "-o", lib, *objs]])
    so = ctypes.CDLL(lib)
    p, i = ctypes.c_void_p, ctypes.c_int
    f, ll = ctypes.c_float, ctypes.c_longlong
    so.kt_xs_fetch.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, p]
    so.kt_xs_fetch.restype = i
    so.kt_fma_f32.argtypes = [p, f, p, p, f, p, p, f, p, p, ll, ll, ll, ll,
                              p]
    so.kt_fma_f32.restype = i
    return so


def parent_kernels(parent, plib):
    """The B6 and F1 wrappers of the checkout at `parent` (its own
    ops/xsfetch.py and ops/fma.py, host work included), run on its kernel
    library. Its F1 took no `negate`, so its callers negated a first (a
    negation pass over a)."""
    import collections
    import types

    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.ops.xsslab import K

    shim = types.SimpleNamespace(
        lib=lambda: plib, ptr=kernels.ptr, check=kernels.check,
        stream_ptr=kernels.stream_ptr, require_cuda=kernels.require_cuda,
        LAUNCHES=collections.Counter())
    mods = {}
    for name in ("xsfetch", "fma"):
        path = os.path.join(parent, "kimimaro_tpu_torch", "ops", name + ".py")
        with open(path) as f:
            src = f.read()
        for imp in ("from .. import kernels\n", "from .xsslab import K\n"):
            src = src.replace(imp, "")
        mod = types.ModuleType(f"parent_{name}")
        mod.kernels, mod.K = shim, K
        exec(compile(src, path, "exec"), mod.__dict__)
        mods[name] = mod

    def f1(a, b, c, negate=False):
        return mods["fma"].fma_f32(-a if negate else a, b, c)

    return mods["xsfetch"].fetch_secb, f1


def turns(fa, fb, reps):
    """CUDA-event times of fa and fb in turns: a, b, b, a."""
    ta = [cuda_ms(fa, reps)]
    tb = [cuda_ms(fb, reps), cuda_ms(fb, reps)]
    ta.append(cuda_ms(fa, reps))
    return ta, tb


def time_oversegment(root, runs):
    """`--time-oversegment DIR [RUNS]`: oversegment with the port at DIR
    on the dense, soma and neurite volumes (their skeletons made first
    with the same port, not timed), a first run and RUNS warm runs each.
    Prints one JSON line a case."""
    import hashlib

    import torch

    root = os.path.abspath(root)
    sys.path.insert(0, root)
    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    if not kimimaro_tpu_torch.__file__.startswith(root + os.sep):
        raise AssertionError(f"imported {kimimaro_tpu_torch.__file__}, not "
                             f"the port at {root}")
    log(f"[time-oversegment] {root}: nvcc {kernels.build():.2f} s")

    def volumes():
        dense = dense_volume(DENSE_N)
        yield "dense", dense, kimimaro_tpu_torch.skeletonize(
            dense, teasar_params=TEASAR, anisotropy=ANIS,
            dust_threshold=1000, fix_borders=True, fix_branching=True,
            device="cuda")
        hollow = hollow_volume(dense)
        del dense
        yield "soma", hollow, kimimaro_tpu_torch.skeletonize(
            hollow, teasar_params=TEASAR, anisotropy=ANIS,
            dust_threshold=1000, fix_borders=True, fix_branching=True,
            fill_holes=False, fix_avocados=False, device="cuda")
        del hollow
        vol, _, start, end = neurite_walk()
        skel = kimimaro_tpu_torch.connect_points(vol, start, end,
                                                 anisotropy=ANIS,
                                                 device="cuda")
        skel.id = 1
        yield "neurite", vol.astype(np.uint32), {1: skel}

    for case, vol, skels in volumes():
        secs, phases = [], []
        for _ in range(runs + 1):
            profiling.reset_stats()
            profiling.collect(True)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            try:
                labels, out = kimimaro_tpu_torch.oversegment(
                    vol, skels, anisotropy=ANIS, device="cuda")
                torch.cuda.synchronize()
            finally:
                profiling.collect(False)
            secs.append(round(time.perf_counter() - t0, 3))
            stats = profiling.get_stats()
            phases.append({k: round(v, 3) for k, v in stats["phases"].items()
                           if k.startswith(("oversegment", "voronoi"))})
        digest = hashlib.sha256(labels.tobytes())
        for k in sorted(out):
            digest.update(np.asarray(out[k].segments).tobytes())
        print(json.dumps({
            "root": root, "case": case, "skeletons": len(out),
            "first": secs[0], "seconds": secs[1:], "phases": phases,
            "counters": {k: v for k, v in stats["counters"].items()
                         if k.startswith("voronoi")},
            "launches": {k: v for k, v in kernels.LAUNCHES.items()
                         if k.startswith("voronoi")},
            "digest": digest.hexdigest()[:16]}), flush=True)
    return 0


def ab_parent(parent):
    """`--ab DIR`: B6 and F1 of this checkout against the kernels built
    from the checkout at DIR (the parent commit), on the same inputs in
    one process, in turns (parent, this, this, parent): B6 on every call
    shape the dense and soma cross sections hand it, F1 on the calls the
    dense run and the dense cross sections hand it (the parent's with its
    callers' negation pass), each pair compared too; then the walls with
    either pair swapped in: the dense volume's skeletonize and the dense
    cross sections, with their rung times."""
    import torch

    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.ops import fma, xsfetch

    t0 = time.perf_counter()
    plib = ab_library(parent)
    kernels.build()
    kernels.lib()
    b6_parent, f1_parent = parent_kernels(parent, plib)
    log(f"[ab] built both libraries in {time.perf_counter() - t0:.1f} s")

    n = DENSE_N
    dense = dense_volume(n)
    f1_dense = F1Spy("dense", keep=64)
    restore = f1_dense.install()
    try:
        dskels, _, _, _ = run_main_path("ab-dense", dense, ())
    finally:
        restore()
    hollow = hollow_volume(dense)
    sskels, _, _ = hollow_main_path(hollow)
    sel, _ = xs_select(dskels)
    dspy, sspy = XsSpy("dense"), XsSpy("soma")
    f1_xs = F1Spy("xs-dense", keep=64)
    restore = f1_xs.install()
    try:
        xs_run("ab-xs-dense", dense, sel, dspy)
    finally:
        restore()
    xs_run("ab-xs-soma", hollow, [sskels[k] for k in sorted(sskels)[-2:]],
           sspy)
    for spy in (dspy, sspy):
        for key, args in sorted(spy.fetch.items()):
            volp, zb = args[0], args[1]
            require_equal(f"ab B6 {spy.tag} {key}",
                          xsfetch.fetch_secb(*args), b6_parent(*args))
            ta, tb = turns(lambda: b6_parent(*args),
                           lambda: xsfetch.fetch_secb(*args), 5)
            plan = xsfetch.fetch_plan(volp, zb)
            log(f"[ab] B6 {spy.tag} {b6_rung(key)} {zb.shape[0]} lanes of "
                f"{key[1]} ({spy.calls[key]} calls, lanes over two runs; "
                f"this {'vector' if plan['vector'] else 'scalar'} path): "
                f"parent {ta[0]:.4f} / {ta[1]:.4f} ms, this {tb[0]:.4f} / "
                f"{tb[1]:.4f} ms, bound "
                f"{b6_bound_ms(volp, zb, args[2], args[3]):.4f} ms")
    for spy in (f1_dense, f1_xs):
        for key, (a, b, c) in sorted(
                spy.inputs(), key=lambda kv: -int(np.prod(kv[0][0]))):
            if key[1] == "empty":
                continue
            negate = key[2]
            require_equal(f"ab F1 {spy.tag} {key}",
                          fma.fma_f32(a, b, c, negate=negate),
                          f1_parent(a, b, c, negate))
            reps = 5 if np.prod(key[0]) > 1 << 16 else 20
            ta, tb = turns(lambda: f1_parent(a, b, c, negate),
                           lambda: fma.fma_f32(a, b, c, negate=negate),
                           reps)
            out = torch.empty(key[0], device="cuda")
            log(f"[ab] F1 {spy.tag} {key} ({spy.calls[key]} calls over two "
                f"runs): parent {ta[0]:.4f} / {ta[1]:.4f} ms, this "
                f"{tb[0]:.4f} / {tb[1]:.4f} ms, bound "
                f"{f1_bound(a, b, c, out):.4f} ms")
    del f1_dense, f1_xs, dspy, sspy
    ab_walls(dense, sel, b6_parent, f1_parent)
    return 0


def ab_walls(dense, sel, b6_parent, f1_parent):
    """`--ab`'s walls, warm, in turns (parent, this, this, parent, three
    times): the dense volume's skeletonize with the parent's F1 in place
    of this one, and the dense cross sections with the parent's B6 and
    F1, with their rung times (`xsb_rung{r}_ms`)."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch.ops import xsfetch
    from kimimaro_tpu_torch.utils import profiling

    fetch = xsfetch.fetch_secb

    def run(fn, parent):
        restore = F1Spy.swap(f1_parent) if parent else (lambda: None)
        if parent:
            xsfetch.fetch_secb = b6_parent
        profiling.reset_stats()
        profiling.collect(True)
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            restore()
            xsfetch.fetch_secb = fetch
            profiling.collect(False)
        return secs, profiling.get_stats()

    def dense_run():
        kimimaro_tpu_torch.skeletonize(
            dense, teasar_params=TEASAR, anisotropy=ANIS,
            dust_threshold=1000, fix_borders=True, fix_branching=True,
            device="cuda")

    def xs_dense():
        kimimaro_tpu_torch.cross_sectional_area(
            dense, {s.id: s.clone() for s in sel}, anisotropy=ANIS,
            device="cuda")

    for name, fn in (("dense", dense_run), ("xs-dense", xs_dense)):
        run(fn, True)  # the parent's first run in this process
        walls = {"parent": [], "this": []}
        for who in ("parent", "this", "this", "parent") * 3:
            secs, stats = run(fn, who == "parent")
            walls[who].append(secs)
            if name == "dense":
                what = "F1: phases " + json.dumps(
                    {k: round(v, 3) for k, v in stats["phases"].items()})
            else:
                what = "B6 and F1: rung ms " + json.dumps(
                    {k: v for k, v in stats["counters"].items()
                     if k.startswith("xsb_rung") and k.endswith("_ms")})
            log(f"[ab] {name} wall {secs:.3f} s with {who}'s {what}")
        log(f"[ab] {name} warm wall, median of {len(walls['this'])} each: "
            f"parent {np.median(walls['parent']):.3f} s (runs "
            f"{json.dumps([round(x, 3) for x in walls['parent']])}), this "
            f"{np.median(walls['this']):.3f} s (runs "
            f"{json.dumps([round(x, 3) for x in walls['this']])})")


def soma_label_volume(n=DENSE_N):
    """One soma-mode label alone in an n^3 volume: an ellipsoid of 3,680 nm
    radius under the (16, 16, 40) anisotropy (230 x 230 x 92 voxels), off
    centre in x, with a neurite of 9 x 5 voxels from it to the volume's
    face; its crop is about 502 x 461 x 185 voxels (43 M)."""
    vol = np.zeros((n, n, n), dtype=np.uint32)
    rad = 3680.0 / np.asarray(ANIS, dtype=np.float64)
    c = np.array([n // 2 - 16, n // 2, n // 2])
    y, z = np.ogrid[:n, :n]
    for x0 in range(0, n, 32):
        x = np.arange(x0, x0 + 32)[:, None, None]
        e = (((x - c[0]) / rad[0]) ** 2 + ((y - c[1]) / rad[1]) ** 2
             + ((z - c[2]) / rad[2]) ** 2)
        vol[x0:x0 + 32][e <= 1.0] = 1
    vol[c[0]:, c[1] - 4:c[1] + 5, c[2] - 2:c[2] + 3] = 1
    return vol


def host_soma():
    """`--host-soma`: one soma-mode label of 512^3 through skeletonize on
    the card, once; the crop engine hands it to the host trace path, whose
    relaxes are B5 sweeps. Prints its seconds, phases, counters, launches
    and the B5 calls by form."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    t0 = time.perf_counter()
    vol = soma_label_volume()
    lo = np.argwhere(vol).min(axis=0)
    hi = np.argwhere(vol).max(axis=0)
    log(f"[host-soma] volume {vol.shape}, label crop {tuple(hi - lo + 1)} "
        f"({int(vol.sum())} voxels), made in {time.perf_counter() - t0:.1f} s")
    spy = B5Spy(keep=0)
    restore = spy.install()
    profiling.reset_stats()
    profiling.collect(True)
    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        skels = kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=1000,
            fix_borders=True, fix_branching=True, fill_holes=False,
            device="cuda")
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        restore()
        profiling.collect(False)
    stats = profiling.get_stats()
    launches = dict(kernels.LAUNCHES)
    phases = {k: round(v, 3) for k, v in stats["phases"].items()}
    log(f"[host-soma] {secs:.2f} s, {len(skels)} skeleton(s) of "
        f"{[len(s) for s in skels.values()]} vertices")
    log(f"[host-soma] phases (s): {json.dumps(phases)}")
    log(f"[host-soma] counters: {json.dumps(stats['counters'])}")
    log(f"[host-soma] launches: {json.dumps(launches)}; B5 calls by form: "
        f"{json.dumps(spy.calls)}")
    if stats["counters"].get("fallback_jobs", 0) < 1 or \
            launches["sweep_axis0"] <= 0:
        raise AssertionError("the soma-mode label did not take the host "
                             "trace path")
    if 1 not in skels or skels[1].empty() or \
            not np.isfinite(skels[1].vertices).all():
        raise AssertionError("the soma-mode label has no finite skeleton")
    return 0


# --------------------------------------------------------------------------- #
# phase 12: the multi-device path

SHARDS = 4


def hbm_bound(nbytes, ops):
    """The larger of bytes over the HBM rate and operations over the
    float32 peak, in ms, with which one bounds it."""
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


class B1Spy:
    """While installed, counts B1's CUDA calls by (shape, mode, node costs,
    graph gate, clamp) and keeps the operands of the first call of each
    key, up to `keep`, in host memory."""

    def __init__(self, keep=16):
        self.keep = keep
        self.kept = {}
        self.calls = {}

    def install(self):
        from kimimaro_tpu_torch.ops import gsweep

        inner = gsweep.sweep0

        def spy(d, cc, nodecost, okmask, anis_perm, mode, clamp_positive,
                descending, gate=None, bits9=None):
            if d.device.type == "cuda":
                key = (tuple(d.shape), mode, nodecost is not None,
                       gate is not None, bool(clamp_positive))
                self.calls[key] = self.calls.get(key, 0) + 1
                if key not in self.kept and len(self.kept) < self.keep:
                    self.kept[key] = tuple(
                        None if t is None else t.to("cpu", copy=True)
                        for t in (d, cc, nodecost, okmask, gate)) + (
                        tuple(anis_perm), bool(descending),
                        None if bits9 is None else tuple(bits9))
            return inner(d, cc, nodecost, okmask, anis_perm, mode,
                         clamp_positive, descending, gate, bits9)

        gsweep.sweep0 = spy

        def restore():
            gsweep.sweep0 = inner

        return restore


def check_b1_recorded(spy):
    """B1 against its plain version on the calls a sharded run made (slabs
    with their halo planes, and their rotated layouts), each made twice.
    Returns {shape: (calls, ms, plain_ms, bound_ms, bound_by, err,
    what)}, timed on the shape's first kept call."""
    from kimimaro_tpu_torch.ops import gsweep

    rows = {}
    for key, ops in spy.kept.items():
        shape, mode, has_nc, has_gate, clamp = key
        d, cc, nc, ok, gate = (None if t is None else t.cuda()
                               for t in ops[:5])
        anis, desc, bits = ops[5:]
        got = gsweep.sweep0(d, cc, nc, ok, anis, mode, clamp, desc, gate,
                            bits)
        again = gsweep.sweep0(d, cc, nc, ok, anis, mode, clamp, desc, gate,
                              bits)
        want, plain = timed_once(
            lambda: gsweep._sweep0_plain(d, cc, nc, ok, anis, mode, clamp,
                                         desc) if gate is None
            else gsweep._sweep0_gate_plain(d, gate, bits, desc))
        err = require_equal(f"B1 sharded call {key}", got, want)
        require_equal(f"B1 sharded call {key} run twice", again, got)
        del want, again
        if shape in rows:
            rows[shape] = rows[shape][:5] + (max(rows[shape][5], err),
                                             rows[shape][6])
            continue
        ms = cuda_ms(lambda: gsweep.sweep0(d, cc, nc, ok, anis, mode, clamp,
                                           desc, gate, bits), 3)
        vox = int(np.prod(shape))
        # B1-vg: ids and gate in, ids out; B1: d and cc (and nc, ok) in
        per = 12 if has_gate else 12 + 4 * has_nc + (ok is not None)
        bms, by = hbm_bound(per * vox, 20 * vox)
        what = f"{mode}{' clamp' if clamp else ''}{' gated' if has_gate else ''}"
        rows[shape] = (0, ms, plain, bms, by, err, what)
    for key, n in spy.calls.items():
        if key[0] in rows:
            r = rows[key[0]]
            rows[key[0]] = (r[0] + n,) + r[1:]
    for shape, (calls, ms, plain, bms, by, err, what) in sorted(rows.items()):
        log(f"[kernels] B1 sharded {shape} ({calls} calls; timed a {what} "
            f"sweep): {ms:.3f} ms vs plain {plain:.1f} ms, bound {bms:.3f} "
            f"ms ({by}), bit-equal on every kept call, twice")
    return rows


class ShardB3Spy:
    """While installed, keeps the arguments of the sharded engine's first
    `keep` B3 calls (one per slab per argmax) in host memory."""

    def __init__(self, keep=8):
        self.keep = keep
        self.calls = 0
        self.kept = {}

    def install(self):
        from kimimaro_tpu_torch.parallel import gengine as tg

        inner = tg.crop_argmax

        def spy(field, cc, offs, lids, crop, boxes=None):
            if field.device.type == "cuda":
                if self.calls < self.keep:
                    self.kept[self.calls] = (
                        field.to("cpu", copy=True), cc.to("cpu", copy=True),
                        offs.clone(), lids.clone(), crop.clone(),
                        tuple(b.clone() for b in boxes))
                self.calls += 1
            return inner(field, cc, offs, lids, crop, boxes)

        tg.crop_argmax = spy

        def restore():
            tg.crop_argmax = inner

        return restore


def check_b3_sharded(spy):
    """B3 against its plain version on the sharded engine's calls (each
    lane's window cut into a slab, its box cut to the slab's rows), each
    made twice. Returns (ms, plain_ms, err, bound_ms, shape) of the first
    path iteration's call on slab 0."""
    from kimimaro_tpu_torch.ops import crop_argmax as ca

    err, row = 0.0, None
    for k, args in sorted(spy.kept.items()):
        field, cc = args[0].cuda(), args[1].cuda()
        offs, lids, crops, boxes = args[2:]
        got = ca.crop_argmax(field, cc, offs, lids, crops, boxes)
        again = ca.crop_argmax(field, cc, offs, lids, crops, boxes)
        want, plain = timed_once(lambda: ca._crop_argmax_plain(
            field, cc, offs, lids, crops, boxes))
        err = max(err, require_equal(f"B3 sharded call {k}", got, want))
        require_equal(f"B3 sharded call {k} run twice", again, got)
        if k == SHARDS or row is None:
            ms = cuda_ms(lambda: ca.crop_argmax(field, cc, offs, lids, crops,
                                                boxes), 5)
            row = (ms, plain, err, b3_bound_ms(field, *boxes),
                   tuple(field.shape))
    log(f"[kernels] B3 bit-equal on {len(spy.kept)} sharded-engine calls "
        f"({spy.calls} in the run), twice; the first iteration's slab-0 "
        f"call {row[4]}: {row[0]:.3f} ms vs plain {row[1]:.1f} ms, bound "
        f"{row[3]:.3f} ms")
    return row[0], row[1], err, row[3], row[4]


def labels_of(cc, labels, ids):
    """The original labels of the component ids `ids`, read off a compact
    cc volume and its label volume (both on the card)."""
    import torch

    n = int(cc.max()) + 1
    lab = torch.zeros(n, dtype=torch.int64, device=cc.device)
    lab.scatter_(0, cc.reshape(-1).long(), labels.reshape(-1).long()
                 & 0xFFFFFFFF)
    lab = lab.cpu().numpy()
    return {int(lab[i]) for i in ids if 0 < i < n}


def sharded_preamble(tag, vol, mesh):
    """The sharded CCL and EDT of `vol` against the single-device ones:
    compacted ids equal, the DBF within rtol 1e-5 (the differing voxels
    counted). Returns (the single-device cc on the card, the labels on
    the card, the labels whose DBF differs somewhere)."""
    import torch

    from kimimaro_tpu_torch.intake import _upload
    from kimimaro_tpu_torch.ops import edt as edt_ops
    from kimimaro_tpu_torch.ops.ccl import compact_cc, connected_components
    from kimimaro_tpu_torch.parallel import sharded as ts
    from kimimaro_tpu_torch.parallel import skeletonize as tsk

    dev = torch.device("cuda")
    labels_dev = _upload(vol, dev)
    cc1, n1, _ = compact_cc(connected_components(labels_dev))
    dbf1 = edt_ops.edt(cc1, anisotropy=tuple(float(a) for a in ANIS),
                       black_border=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lab = ts.shard_volume(labels_dev, mesh)
    cc2, n2, _ = tsk._compact_cc_sharded(ts.sharded_ccl_rounds(lab, mesh))
    torch.cuda.synchronize()
    t_ccl = time.perf_counter() - t0
    t0 = time.perf_counter()
    dsq = ts.sharded_edtsq(lab, mesh, ANIS, black_border=False)
    dbf2 = [ts.sqrt_f32(x) for x in dsq.slabs]
    torch.cuda.synchronize()
    t_edt = time.perf_counter() - t0
    del dsq
    h = lab.h
    if n1 != n2:
        raise AssertionError(f"{tag}: {n2} sharded components vs {n1}")
    n_diff, worst, diff_ids = 0, 0.0, set()
    for i in range(mesh.size):
        rows = slice(i * h, (i + 1) * h)
        if not torch.equal(cc2.slabs[i], cc1[rows]):
            raise AssertionError(f"{tag}: compacted ids of shard {i} differ "
                                 f"from the single-device CCL's")
        a, b = dbf1[rows], dbf2[i]
        neq = a != b
        n_diff += int(neq.sum())
        if bool(neq.any()):
            rel = ((a - b).abs() / a.abs().clamp(min=1e-30))[neq]
            worst = max(worst, float(rel.max()))
            diff_ids |= set(torch.unique(cc1[rows][neq]).tolist())
    if worst > 1e-5:
        raise AssertionError(f"{tag}: sharded DBF off by rtol {worst}")
    diff_labels = labels_of(cc1, labels_dev, diff_ids)
    log(f"[sharded] {tag} preamble on {mesh}: compacted CCL ids equal the "
        f"single-device CCL's ({n1} components; sharded CCL + compaction "
        f"{t_ccl:.2f} s); DBF (ring EDT, {t_edt:.2f} s) within rtol "
        f"{worst:.2e} of the single-device EDT, {n_diff} voxels differ, in "
        f"{len(diff_ids)} components of {len(diff_labels)} labels")
    return cc1, labels_dev, diff_labels


def run_sharded(tag, vol, mesh, runs=("first",), **kw):
    """skeletonize_sharded(vol) on the card, the launch and exchange
    counts reset just before each run and read just after it. Returns the
    last run's skeletons and counters and the launches summed over the
    runs."""
    import torch

    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.parallel import comm
    from kimimaro_tpu_torch.parallel import skeletonize as tsk
    from kimimaro_tpu_torch.utils import profiling

    total = {k: 0 for k in kernels.LAUNCHES}
    for run in runs:
        profiling.reset_stats()
        profiling.collect(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        comm.reset_exchanges()
        t0 = time.perf_counter()
        skels = tsk.skeletonize_sharded(
            vol, mesh=mesh, teasar_params=TEASAR, anisotropy=ANIS,
            dust_threshold=1000, fix_borders=True, fix_branching=True,
            **kw)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        profiling.collect(False)
        launches = dict(kernels.LAUNCHES)
        for k, v in launches.items():
            total[k] += v
        stats = profiling.get_stats()
        phases = {k: round(v, 3) for k, v in stats["phases"].items()}
        log(f"[{tag}] {run} run: {secs:.2f} s, {len(skels)} skeletons, "
            f"peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        log(f"[{tag}] {run} run phases (s): {json.dumps(phases)}")
        log(f"[{tag}] {run} run counters: "
            f"{json.dumps(stats['counters'])}")
        log(f"[{tag}] {run} run launches: {json.dumps(launches)}")
        log(f"[{tag}] {run} run exchanges: {json.dumps(comm.EXCHANGES)}")
    return skels, stats["counters"], total


def single_device_without_bail(tag, vol, single, **kw):
    """skeletonize(vol) on the card with the global engine's selective bail
    off: the sharded engine has no bail (nor has the JAX package's), so it
    traces in lock-step the labels that the single-device run hands to the
    crop engine, whose PDRF formula differs (ROADMAP Queue C 7). Logs how
    many labels differ from `single`, the single-device run with the
    bail."""
    import kimimaro_tpu_torch

    t0 = time.perf_counter()
    with bail_off():
        out = kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=1000,
            fix_borders=True, fix_branching=True, device="cuda", **kw)
    differ = sorted(k for k in out if k not in single
                    or out[k].to_swc() != single[k].to_swc())
    log(f"[sharded] {tag}: the single-device run with the bail off "
        f"({time.perf_counter() - t0:.2f} s) differs from the one with it "
        f"on {len(differ)} of {len(out)} labels ({differ[:12]})")
    return out


def compare_sharded(tag, single, sharded, dbf_labels):
    """Every label's SWC of the sharded run against the single-device
    run's: a label may differ only where its DBF differs (the ring EDT's
    last bits); a label that differs under a bit-equal DBF fails."""
    if set(single) != set(sharded):
        raise AssertionError(f"{tag}: labels {sorted(set(single) ^ set(sharded))[:10]} "
                             f"are in one run only")
    by_dbf = []
    for k in single:
        if single[k].to_swc() == sharded[k].to_swc():
            continue
        if k not in dbf_labels:
            raise AssertionError(f"{tag}: label {k} differs from the "
                                 f"single-device skeleton under a bit-equal "
                                 f"DBF")
        by_dbf.append(k)
    log(f"[sharded] {tag}: {len(single) - len(by_dbf)} of {len(single)} "
        f"labels SWC-equal to the single-device run; {len(by_dbf)} differ "
        f"where their DBF differs ({sorted(by_dbf)[:12]}); "
        f"{len(dbf_labels)} labels have a DBF that differs")
    return len(by_dbf)


def sharded_small_paths():
    """Card = CPU on small volumes: a 64^3 blob volume at 3 shards (64 % 3
    != 0: the padding path; its largest blob with 17 manual targets, more
    than the crop engine holds: the host trace path) and the 64^3
    self-touch volume under its graph at 4 shards (a label to the host
    trace path). Returns the card runs' launches."""
    import kimimaro_tpu_torch  # noqa: F401
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.parallel import make_mesh, skeletonize_sharded

    blobs = blob_volume(seed=0, shape=(64, 64, 64), n_seeds=12)
    big = int(np.argmax(np.bincount(blobs.ravel())[1:])) + 1
    pts = np.argwhere(blobs == big)
    blob_pts = [tuple(int(c) for c in p) for p in pts[::len(pts) // 17][:17]]
    touch, vg, pts = small_self_touch_volume()
    total = {k: 0 for k in kernels.LAUNCHES}
    for name, vol, n, kw in (
            ("blobs-64", blobs, 3, dict(dust_threshold=100,
                                        extra_targets_before=blob_pts)),
            ("self-touch-64", touch, SHARDS,
             dict(dust_threshold=1000, voxel_graph=vg,
                  extra_targets_before=pts))):
        out = {}
        for device in ("cuda", "cpu"):
            kernels.reset_launches()
            t0 = time.perf_counter()
            out[device] = skeletonize_sharded(
                vol, mesh=make_mesh(n, device), teasar_params=TEASAR,
                anisotropy=ANIS, fix_borders=True, fix_branching=True, **kw)
            if device == "cuda":
                for k, v in kernels.LAUNCHES.items():
                    total[k] += v
            log(f"[sharded-64] {name} at {n} shards on {device}: "
                f"{len(out[device])} skeletons in "
                f"{time.perf_counter() - t0:.2f} s")
        if set(out["cuda"]) != set(out["cpu"]) or not out["cpu"] or any(
                out["cuda"][k].to_swc() != out["cpu"][k].to_swc()
                for k in out["cpu"]):
            raise AssertionError(f"sharded {name}: the card's skeletons "
                                 f"differ from the CPU's")
        log(f"[sharded-64] {name}: card = CPU on all {len(out['cpu'])} "
            f"labels (SWC)")
    return total


def sharded_cuts(dense):
    """The same sharded code on the card and on the CPU at small cuts of
    the dense volume: the EDT of a 128^3 cut and the preamble step (EDT,
    PDRF, CCL, distance rounds with halos on B5) of a 64^3 cut, bit for
    bit."""
    import torch

    from kimimaro_tpu_torch.parallel import make_mesh
    from kimimaro_tpu_torch.parallel import sharded as ts

    cut = np.ascontiguousarray(dense[:128, :128, :128])
    got = ts.sharded_edtsq(cut, make_mesh(SHARDS, "cuda"), ANIS)
    want = ts.sharded_edtsq(cut, make_mesh(SHARDS, "cpu"), ANIS)
    for g, w in zip(got.slabs, want.slabs):
        require_equal("sharded EDT 128^3 card vs CPU", g.cpu(), w)
    small = np.ascontiguousarray(dense[:64, :64, :64])
    got = ts.preamble_step(small, make_mesh(SHARDS, "cuda"), ANIS)
    want = ts.preamble_step(small, make_mesh(SHARDS, "cpu"), ANIS)
    for k in ("dbf", "pdrf", "cc", "daf"):
        for g, w in zip(got[k].slabs, want[k].slabs):
            require_equal(f"preamble_step {k} 64^3 card vs CPU", g.cpu(), w)
    torch.cuda.synchronize()
    log(f"[sharded] the sharded EDT of a 128^3 cut and the preamble step "
        f"(DBF, PDRF, CCL, DAF) of a 64^3 cut: card = CPU, bit for bit")


def sharded_phase(dense, dense_skels, hollow, soma_skels):
    """Phase 12: the multi-device path over make_mesh(4, "cuda") (every
    shard on the one card): the preamble at 512^3 against the
    single-device CCL and EDT; skeletonize_sharded on the dense volume
    twice and the soma volume once, every label against phases 5 and 6's
    volumes on one device with the global engine's bail off (the sharded
    engine has none);
    card = CPU on small volumes; B1, B3, B4, B5 and F1 bit-equal to their
    plain versions on the calls the sharded runs made. Returns (launches
    of the sharded runs, kernel-table rows)."""
    import torch

    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.parallel import make_mesh

    dense_ref = single_device_without_bail("dense", dense, dense_skels)
    mesh = make_mesh(SHARDS, "cuda")
    log(f"[sharded] mesh {mesh}")
    cc1, labels_dev, dbf_labels = sharded_preamble("dense", dense, mesh)

    b1_spy, b3_spy = B1Spy(), ShardB3Spy()
    f1_spy = F1Spy("sharded")
    restores = [s.install() for s in (b1_spy, b3_spy, f1_spy)]
    try:
        skels, counters, launches = run_sharded(
            "sharded-dense", dense, mesh, ("first",))
    finally:
        for restore in reversed(restores[:2]):
            restore()
    restore_f1 = restores[2]
    skels2, _, more = run_sharded("sharded-dense", dense, mesh, ("warm",))
    for k, v in more.items():
        launches[k] += v
    if any(skels[k].to_swc() != skels2[k].to_swc() for k in skels):
        raise AssertionError("sharded dense: the warm run differs from the "
                             "first")
    del skels2
    compare_sharded("dense", dense_ref, skels, dbf_labels)
    del skels, cc1, labels_dev, dense_ref

    cc1, labels_dev, dbf_labels = sharded_preamble("soma", hollow, mesh)
    b4_spy, b5_spy = B4Spy("sharded soma"), B5Spy()
    restores = [b4_spy.install(), b5_spy.install()]
    try:
        soma, soma_counters, soma_launches = run_sharded(
            "sharded-soma", hollow, mesh, ("first",))
    finally:
        for restore in reversed(restores):
            restore()
        restore_f1()
    for k, v in soma_launches.items():
        launches[k] += v
    compare_sharded("soma", single_device_without_bail(
        "soma", hollow, soma_skels, fill_holes=False, fix_avocados=False),
        soma, dbf_labels)
    if soma_counters.get("crop_engine_jobs", 0) < 2:
        raise AssertionError("sharded soma: the crop engine took fewer than "
                             "2 jobs")
    del soma, cc1, labels_dev
    torch.cuda.empty_cache()

    # the small volumes' card runs (a label each to the host trace path;
    # the self-touch volume under its graph) and the 64^3 preamble step,
    # with B1 (and its graph-gated form), B4 and B5 recorded
    b5_cut = B5Spy()
    restore = b5_cut.install()
    try:
        sharded_cuts(dense)
    finally:
        restore()
    b5_cut_err = check_b5_recorded(b5_cut)
    log(f"[kernels] B5 on the 64^3 preamble step's halo sweeps: bit-equal "
        f"(max abs err {b5_cut_err})")
    del b5_cut
    b1_small, b4_small = B1Spy(keep=64), B4Spy("sharded 64^3", keep=64)
    restores = [b1_small.install(), b4_small.install(), b5_spy.install()]
    try:
        small = sharded_small_paths()
    finally:
        for restore in reversed(restores):
            restore()
    log(f"[sharded-64] launches of the card runs: {json.dumps(small)}")
    for k, v in small.items():
        launches[k] += v
    log(f"[sharded] launches over the sharded runs: {json.dumps(launches)}")
    for k in ("gsweep_sweep0", "gsweep_sweep0_vg", "crop_argmax",
              "sweep_axis0_batched", "sweep_axis0_batched_vg", "sweep_axis0",
              "sweep_axis0_vg", "fma_f32"):
        if launches[k] <= 0:
            raise AssertionError(f"{k} was never launched on the sharded "
                                 f"path")

    # the kernels on the calls the sharded runs made
    rows = []
    b1 = check_b1_recorded(b1_spy)
    del b1_spy
    gated = {k: v for k, v in check_b1_recorded(b1_small).items()
             if v[6].endswith("gated")}
    if not gated:
        raise AssertionError("the sharded self-touch run made no "
                             "graph-gated B1 call")
    for shape, (calls, ms, plain, bms, by, err, what) in sorted(
            gated.items()):
        rows.append({"name": f"gsweep_sweep0_vg sharded {shape}",
                     "route": "cuda",
                     "source": "kimimaro_tpu_torch/csrc/gsweep.cu",
                     "replaces": "kimimaro_tpu/ops/gsweep.py:219",
                     "launches": calls, "max_abs_err": err,
                     "ms": round(ms, 4), "plain_ms": round(plain, 4),
                     "bound_ms": round(bms, 4), "bound_by": by,
                     "library_ms": None})
    del b1_small
    b4_64 = check_b4_recorded(b4_small)
    top = sorted(b4_64, key=lambda k: b4_small.calls.get(k, 0)
                 * int(np.prod(k)))[-4:]
    for shape in sorted(top):
        ms, plain, bms, by, err = b4_64[shape]
        if shape in b4_small.calls:
            rows.append({"name": f"sweep_axis0_batched sharded 64^3 {shape}",
                         "route": "cuda",
                         "source": "kimimaro_tpu_torch/csrc/sweep.cu",
                         "replaces": "kimimaro_tpu/ops/pallas_sweep.py:308",
                         "launches": b4_small.calls[shape],
                         "max_abs_err": err, "ms": round(ms, 4),
                         "plain_ms": round(plain, 4),
                         "bound_ms": round(bms, 4), "bound_by": by,
                         "library_ms": None})
    top = sorted(b1, key=lambda k: b1[k][0] * int(np.prod(k)))[-6:]
    for shape in sorted(top):
        calls, ms, plain, bms, by, err, what = b1[shape]
        rows.append({"name": f"gsweep_sweep0 sharded {shape} ({what})",
                     "route": "cuda",
                     "source": "kimimaro_tpu_torch/csrc/gsweep.cu",
                     "replaces": "kimimaro_tpu/ops/gsweep.py:219",
                     "launches": calls, "max_abs_err": err,
                     "ms": round(ms, 4), "plain_ms": round(plain, 4),
                     "bound_ms": round(bms, 4), "bound_by": by,
                     "library_ms": None})
    ms, plain, err, bms, shape = check_b3_sharded(b3_spy)
    rows.append({"name": f"crop_argmax sharded {shape}", "route": "cuda",
                 "source": "kimimaro_tpu_torch/csrc/argmax.cu",
                 "replaces": "kimimaro_tpu/ops/pallas_argmax.py:205",
                 "launches": b3_spy.calls, "max_abs_err": err,
                 "ms": round(ms, 4), "plain_ms": round(plain, 4),
                 "bound_ms": round(bms, 4), "bound_by": "bytes",
                 "library_ms": None})
    del b3_spy
    b4 = check_b4_recorded(b4_spy)
    top = sorted(b4, key=lambda k: b4_spy.calls.get(k, 0) * int(np.prod(k)))
    for shape in top[-4:]:
        ms, plain, bms, by, err = b4[shape]
        rows.append({"name": f"sweep_axis0_batched sharded {shape}",
                     "route": "cuda",
                     "source": "kimimaro_tpu_torch/csrc/sweep.cu",
                     "replaces": "kimimaro_tpu/ops/pallas_sweep.py:308",
                     "launches": b4_spy.calls.get(shape, 0),
                     "max_abs_err": err, "ms": round(ms, 4),
                     "plain_ms": round(plain, 4), "bound_ms": round(bms, 4),
                     "bound_by": by, "library_ms": None})
    # B5 on the host trace path's and the halo sweeps' recorded calls: a
    # row for each form's call of the most voxels
    b5_rows = {}
    b5_err = check_b5_recorded(b5_spy, b5_rows)
    for gated in (False, True):
        keys = [k for k in b5_rows if (k[4] is not None) == gated]
        key = max(keys, key=lambda k: int(np.prod(k[0])))
        ms, plain, _ = b5_rows[key]
        vox = int(np.prod(key[0]))
        bms, by = hbm_bound(((13 if key[1] else 9) + 4 * gated) * vox,
                            (12 if key[1] else 18) * vox)
        name = "sweep_axis0_vg" if gated else "sweep_axis0"
        rows.append({"name": f"{name} sharded {key[0]}", "route": "cuda",
                     "source": "kimimaro_tpu_torch/csrc/sweep.cu",
                     "replaces": "kimimaro_tpu/ops/pallas_sweep.py:117",
                     "launches": small[name], "max_abs_err": b5_err,
                     "ms": round(ms, 4), "plain_ms": round(plain, 4),
                     "bound_ms": round(bms, 4), "bound_by": by,
                     "library_ms": None})
    f1_rows, f1_err = check_f1_recorded((f1_spy,))
    for route in ("flat", "strided"):
        keys = [k for k in f1_rows if k[1] == route]
        if not keys:
            continue
        key = max(keys, key=lambda k: int(np.prod(k[0])))
        ms, plain, bms, lib, _ = f1_rows[key]
        rows.append({
            "name": f"fma_f32 sharded {route} {key[0]}", "route": "cuda",
            "source": "kimimaro_tpu_torch/csrc/fma.cu",
            "replaces": "kimimaro_tpu/parallel/gengine.py:409",
            "launches": sum(v[4] for k, v in f1_rows.items()
                            if k[1] == route),
            "max_abs_err": f1_err, "ms": round(ms, 4),
            "plain_ms": round(plain, 4), "bound_ms": round(bms, 4),
            "bound_by": "bytes",
            "library_ms": None if lib is None else round(lib, 4)})
    return launches, rows


# --------------------------------------------------------------------------- #
# phase 13: the command line


def cli_phase(dense, dense_skels):
    """Phase 13: `python -m kimimaro_tpu_torch.cli forge` on the dense
    volume (bench.py's parameters as options) writes phase 5's skeletons;
    `forge --cross-section` on a 128^3 cut writes the areas the library
    call computes on the card; `swc to` / `swc from` round-trip one
    label."""
    import shutil
    import tempfile

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch.skeleton import Skeleton

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="cli-", dir=os.path.join(ROOT, "build"))
    env = dict(os.environ, PYTHONPATH=ROOT)
    forge = [sys.executable, "-m", "kimimaro_tpu_torch.cli", "forge"]
    opts = ["--scale", str(TEASAR["scale"]), "--const", str(TEASAR["const"]),
            "--pdrf-scale", str(TEASAR["pdrf_scale"]),
            "--pdrf-exponent", str(TEASAR["pdrf_exponent"]),
            "--soma-detect", str(TEASAR["soma_detection_threshold"]),
            "--soma-accept", str(TEASAR["soma_acceptance_threshold"]),
            "--anisotropy", ",".join(str(a) for a in ANIS),
            "--dust", "1000", "--fix-borders", "--no-fill-holes",
            "--device", "cuda"]

    def run(cmd):
        t0 = time.perf_counter()
        out = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True,
                             text=True, timeout=600)
        if out.returncode != 0:
            raise AssertionError(f"{' '.join(cmd[2:5])} exited "
                                 f"{out.returncode}: {out.stderr[-2000:]}")
        return time.perf_counter() - t0

    try:
        np.save(os.path.join(tmp, "dense.npy"), dense)
        secs = run(forge + ["dense.npy", "-o", "out"] + opts)
        files = sorted(os.listdir(os.path.join(tmp, "out")))
        want = sorted(f"{k}.swc" for k in dense_skels)
        if files != want:
            raise AssertionError(f"cli forge: {len(files)} files, expected "
                                 f"{len(want)}")
        for k, skel in dense_skels.items():
            with open(os.path.join(tmp, "out", f"{k}.swc")) as f:
                if f.read() != skel.to_swc():
                    raise AssertionError(f"cli forge: label {k}'s SWC "
                                         f"differs from phase 5's")
        log(f"[cli] python -m kimimaro_tpu_torch.cli forge dense.npy "
            f"--device cuda: {len(files)} SWC files, each equal to phase 5's "
            f"skeleton ({secs:.1f} s with the interpreter's start)")

        cut = np.ascontiguousarray(dense[:128, :128, :128])
        np.save(os.path.join(tmp, "cut.npy"), cut)
        secs = run(forge + ["cut.npy", "-o", "xs", "--cross-section", "1"]
                   + opts)
        params = dict(TEASAR, soma_invalidation_scale=2.0,
                      soma_invalidation_const=300.0, max_paths=None)
        skels = kimimaro_tpu_torch.skeletonize(
            cut, teasar_params=params, anisotropy=ANIS, dust_threshold=1000,
            fix_borders=True, fill_holes=False, device="cuda")
        skels = kimimaro_tpu_torch.cross_sectional_area(
            cut, skels, anisotropy=ANIS, smoothing_window=1,
            fill_holes=False, device="cuda")
        n_vert = 0
        for k, skel in skels.items():
            for suffix, want in (("xs_area", skel.cross_sectional_area),
                                 ("xs_area_contacts",
                                  skel.cross_sectional_area_contacts)):
                got = np.load(os.path.join(tmp, "xs", f"{k}_{suffix}.npy"))
                if got.shape != want.shape or not np.array_equal(got, want):
                    raise AssertionError(f"cli forge --cross-section: label "
                                         f"{k}'s {suffix} differs from the "
                                         f"library call's")
            n_vert += len(skel.vertices)
        log(f"[cli] forge --cross-section 1 on a 128^3 cut: {len(skels)} "
            f"labels, areas and contacts of {n_vert} vertices equal to "
            f"cross_sectional_area on the card ({secs:.1f} s)")

        label = max(dense_skels, key=lambda k: len(dense_skels[k].vertices))
        skel = dense_skels[label]
        vox = np.round(skel.vertices / np.asarray(ANIS, np.float32))
        rt = Skeleton(vox, edges=skel.edges, radii=skel.radii)
        os.makedirs(os.path.join(tmp, "rt"))
        with open(os.path.join(tmp, "rt", "s.swc"), "w") as f:
            f.write(rt.to_swc())
        cli = [sys.executable, "-m", "kimimaro_tpu_torch.cli", "swc"]
        run(cli + ["to", os.path.join("rt", "s.swc")])
        image = np.load(os.path.join(tmp, "rt", "s.npy"))
        run(cli + ["from", os.path.join("rt", "s.npy")])
        with open(os.path.join(tmp, "rt", "s.swc")) as f:
            back = Skeleton.from_swc(f.read())
        minpt = np.floor(vox.min(axis=0)).astype(int)
        want = set(map(tuple, vox.astype(int).tolist()))
        got = set(map(tuple, (back.vertices.astype(int) + minpt).tolist()))
        if got != want or int(image.sum()) != len(want):
            raise AssertionError("cli swc to/from: the round trip lost "
                                 "vertices")
        log(f"[cli] swc to / swc from on label {label} ({len(want)} "
            f"vertices): the image and the skeleton read back hold every "
            f"vertex")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def device_line():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--time-oversegment"] and len(sys.argv) in (3, 4):
        log(device_line())
        return time_oversegment(sys.argv[2], int(sys.argv[3])
                                if len(sys.argv) == 4 else 3)
    sys.path.insert(0, ROOT)
    from kimimaro_tpu_torch import kernels

    if sys.argv[1:] == ["--profile"]:
        log(device_line())
        return profile_dense()
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) == 3:
        log(device_line())
        rc = ab_parent(sys.argv[2])
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return rc
    if sys.argv[1:] == ["--self-touch"]:
        log(device_line())
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        log(f"[build] nvcc {kernels.build():.2f} s")
        self_touch_phase(dense_volume(DENSE_N), gen)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--chase"]:
        log(device_line())
        log(f"[build] nvcc {kernels.build():.2f} s")
        dense = dense_volume(DENSE_N)
        _, captured, _, _, rows = dense_main_path(dense)
        del captured
        rows += hollow_main_path(hollow_volume(dense))[2]
        print(json.dumps({"kernels": rows + chase_phase(dense)}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--fill"]:
        log(device_line())
        log(f"[build] nvcc {kernels.build():.2f} s")
        fill_main_path(hollow_volume(dense_volume(DENSE_N)))
        small_fill_path()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--analysis"]:
        import kimimaro_tpu_torch

        log(device_line())
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        log(f"[build] nvcc {kernels.build():.2f} s")
        dense = dense_volume(DENSE_N)
        t0 = time.perf_counter()
        skels = kimimaro_tpu_torch.skeletonize(
            dense, teasar_params=TEASAR, anisotropy=ANIS, dust_threshold=1000,
            fix_borders=True, fix_branching=True, device="cuda")
        hollow = hollow_volume(dense)
        soma_skels = kimimaro_tpu_torch.skeletonize(
            hollow, teasar_params=TEASAR, anisotropy=ANIS,
            dust_threshold=1000, fix_borders=True, fix_branching=True,
            fill_holes=False, fix_avocados=False, device="cuda")
        log(f"[analysis] {len(skels)} dense and {len(soma_skels)} soma "
            f"skeletons ({time.perf_counter() - t0:.1f} s, set-up)")
        (launches, v1, rows, lanes_rows, v1b_err,
         b5_rows) = analysis_phase(dense, skels, gen, hollow, soma_skels)
        log(f"[analysis] launches: {json.dumps(launches)}")
        print(json.dumps({"kernels": v1_table(launches, v1, rows, lanes_rows,
                                              v1b_err) + b5_rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] in (["--sharded"], ["--cli"]):
        import kimimaro_tpu_torch

        log(device_line())
        log(f"[build] nvcc {kernels.build():.2f} s")
        dense = dense_volume(DENSE_N)
        if sys.argv[1] == "--cli":
            t0 = time.perf_counter()
            skels = kimimaro_tpu_torch.skeletonize(
                dense, teasar_params=TEASAR, anisotropy=ANIS,
                dust_threshold=1000, fix_borders=True, fix_branching=True,
                device="cuda")
            log(f"[cli] {len(skels)} dense skeletons "
                f"({time.perf_counter() - t0:.1f} s, set-up)")
            cli_phase(dense, skels)
        else:
            skels, captured, _, _, _ = dense_main_path(dense)
            del captured
            hollow = hollow_volume(dense)
            soma_skels, _, _ = hollow_main_path(hollow)
            launches, rows = sharded_phase(dense, skels, hollow, soma_skels)
            print(json.dumps({"kernels": rows}))
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0
    if sys.argv[1:] == ["--host-soma"]:
        log(device_line())
        rc = host_soma()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return rc

    # 1. device
    t_start = time.perf_counter()

    def mark(what):
        log(f"[time] {what} done at {time.perf_counter() - t_start:.0f} s")

    name = torch.cuda.get_device_name(0)
    log(f"[device] {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(device_line())

    # 2. build
    t0 = time.perf_counter()
    build_s = kernels.build()
    kernels.lib()
    log(f"[build] nvcc {build_s:.2f} s (load {time.perf_counter() - t0:.2f} s)")

    # 3. kernels against their plain versions
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    n = DENSE_N
    table = []
    b1 = check_b1([(11, 9, 8), (13, 37, 45), *B1_STRESS_SHAPES, (n, n, n)],
                  gen)
    b2 = check_b2([(11, 9, 8), (13, 37, 45), *B2_STRESS_SHAPES, (n, n, n)],
                  gen)
    log(f"[kernels] B2 sweeps of {n}^3: "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in b2[3].items()))
    b3_windows = check_b3([((20, 18, 16), (8, 7, 6), 6),
                           ((n, n, n), (96, 96, 96), 2048)], gen)
    # B4 at a small shape, at the shapes the main path gives it (the soma
    # volume's (256, 256, 64) bucket of 2 lanes, swept along x and y, then
    # along z through the permuted copy; the crop cross-check's 64 lanes of
    # (128, 128, 32) and their z layout) and at 64 lanes of (64, 64, 32)
    # and on each side of sweep_axis0_batched_plan's rule: a cluster a
    # lane while a strip of 16 CTAs takes one pass ((2, 8, 256, 128)),
    # per-lane grid strips above ((2, 8, 272, 128), and the soma bucket's
    # z layout), one launch per plane beyond the co-resident CTAs (200
    # lanes of 300 x 300 planes); n = 1, H = 1, W = 1, odd widths
    b4 = check_b4([(3, 11, 9, 8), (1, 1, 9, 9), (5, 9, 1, 7), (5, 9, 7, 1),
                   (4, 11, 33, 17), (2, 8, 256, 128), (2, 8, 272, 128),
                   (200, 3, 300, 300), (2, 256, 256, 64), (2, 64, 256, 256),
                   (64, 128, 128, 32), (64, 32, 128, 128),
                   (64, 64, 64, 32)], gen)
    b5 = check_b5([(11, 9, 8), *B5_STRESS_SHAPES, (96, 96, 96)], gen)
    f1 = check_f1(gen)
    meta = (
        ("gsweep_sweep0", "kimimaro_tpu_torch/csrc/gsweep.cu",
         "kimimaro_tpu/ops/gsweep.py:219", b1,
         f"euclid+okmask+clamp sweep of {n}^3"),
        ("gsweep_sweep0_dual", "kimimaro_tpu_torch/csrc/gsweep.cu",
         "kimimaro_tpu/ops/gsweep.py:528", b2, f"ball_rail sweep of {n}^3"),
        ("crop_argmax", "kimimaro_tpu_torch/csrc/argmax.cu",
         "kimimaro_tpu/ops/pallas_argmax.py:205", b3_windows,
         f"2048 lanes of 96^3 crops in {n}^3"),
        ("sweep_axis0_batched", "kimimaro_tpu_torch/csrc/sweep.cu",
         "kimimaro_tpu/ops/pallas_sweep.py:308", b4,
         "node sweep of 64 lanes of (64, 64, 32) crops (phase 3)"),
        ("sweep_axis0", "kimimaro_tpu_torch/csrc/sweep.cu",
         "kimimaro_tpu/ops/pallas_sweep.py:117", b5,
         "node sweep of a 96^3 crop"),
    )
    for k, src, rep, (ms, plain, err, *_), what in meta:
        log(f"[kernels] {k}: {ms:.3f} ms vs plain {plain:.3f} ms ({what}), "
            f"max abs err {err}")

    mark("phase 3 (kernels against their plain versions)")
    # 4 to 7. the main path; the counts cover exactly its runs. The calls
    # of B5 (the host trace path's eager loop) and of B4 (the crop engine
    # and the host trace path's fused loop) in phases 4 and 5 are
    # recorded.
    b5_spy = B5Spy()
    b4_spy = B4Spy("main path")
    f1_main = F1Spy("main path")
    restore_b5 = b5_spy.install()
    restore_b4 = b4_spy.install()
    restore_f1 = f1_main.install()
    launches = small_main_path()
    mark("phase 4 (the small path)")
    t0 = time.perf_counter()
    dense = dense_volume(n)
    log(f"[dense] volume {dense.shape}, {len(np.unique(dense))} labels, made "
        f"in {time.perf_counter() - t0:.1f} s (set-up, not timed)")
    (dense_skels, captured, dense_launches, b3_spy,
     c1_dense) = dense_main_path(dense)
    mark("phase 5 (dense)")
    # B3 at the shapes the dense run handed it: the kernel table's row
    b3 = check_b3_recorded(b3_spy)
    del b3_spy
    log(f"[kernels] crop_argmax: {b3[0]:.3f} ms vs plain {b3[1]:.3f} ms, "
        f"bound {b3[3]:.3f} ms (the dense run's first path iteration), max "
        f"abs err {b3[2]}")
    t0 = time.perf_counter()
    hollow = hollow_volume(dense)
    log(f"[soma] volume {hollow.shape}, {len(np.unique(hollow))} labels, "
        f"made in {time.perf_counter() - t0:.1f} s (set-up, not timed)")
    soma_skels, soma_launches, c1_soma = hollow_main_path(hollow)
    mark("phase 6 (soma)")
    restore_f1()
    # B4's calls on the main path (phase 4's runs)
    b4_main_calls = dict(b4_spy.calls)
    cross_check(captured)
    restore_b4()
    restore_b5()
    b5_err = check_b5_recorded(b5_spy)
    del b5_spy
    b4_crop = crop_cross_check(captured)
    del captured
    mark("phase 7 (cross-checks)")

    # 8. cross sections: the dense and soma volumes' skeletons, the
    # per-label path, and B6/X1 at the shapes those runs handed them
    f1_xs = F1Spy("cross sections")
    xs_launches, xs_rep, xs_err, b4_label = cross_sections(
        dense, dense_skels, hollow, soma_skels, gen, f1_xs)
    mark("phase 8 (cross sections)")
    # 9. the host-stage path at full size and at 64^3 against the CPU,
    # with B4, B5 and F1 recorded; postprocess, streaming and chunked
    b4_fill = B4Spy("fill path", keep=4096, per_shape=True)
    b5_fill, f1_fill = B5Spy(), F1Spy("fill")
    restores = [b4_fill.install(), b5_fill.install(), f1_fill.install()]
    try:
        fill_launches, c1_fill = fill_main_path(hollow)
        mark("phase 9 (the fill path)")
        small_fill_launches = small_fill_path()
    finally:
        for restore in reversed(restores):
            restore()
    postprocess_phase(dense_skels)
    stream_launches = streaming_phase(dense, dense_skels)
    chunk_launches = chunked_phase(dense, dense_skels)
    mark("phase 9 (small fill, postprocess, streaming, chunked)")
    if b5_fill.kept:
        b5_err = max(b5_err, check_b5_recorded(b5_fill))
    del b5_fill
    # 10. self-touch: the dense volume under a voxel graph
    (touch_launches, touch_small_launches, b1_vg, b5_vg, b4_touch,
     b4_touch_calls, b4_rule_err, g1_touch, g1_touch_calls,
     c1_rows) = self_touch_phase(dense, gen)
    mark("phase 10 (self-touch)")
    # 11. the analysis extras on the dense run's skeletons
    (analysis_launches, v1, v1_rows, v1_lanes_rows, v1b_err,
     b5_connect) = analysis_phase(dense, dense_skels, gen, hollow,
                                  soma_skels)
    mark("phase 11 (analysis)")

    # 12. the multi-device path over four shards of the card
    sharded_launches, sharded_rows = sharded_phase(
        dense, dense_skels, hollow, soma_skels)
    mark("phase 12 (sharded)")
    # 13. the command line
    cli_phase(dense, dense_skels)
    mark("phase 13 (cli)")

    # F1 on the calls of phases 4 to 6, 8 and 9
    f1_rows, f1_err = check_f1_recorded((f1_main, f1_xs, f1_fill))
    del f1_main, f1_xs, f1_fill
    # B4 on the calls of phases 4 and 5 (the crop engine, the host trace
    # path's fused loop), the per-label path and the crop cross-check;
    # the main-path calls of each shape
    b4_rows = {}
    for spy, calls in ((b4_spy, b4_main_calls), (b4_label, b4_label.calls),
                       (b4_crop, {}), (b4_fill, b4_fill.calls)):
        checked = check_b4_recorded(spy)
        if spy is b4_fill:
            # every shape of the fill path checked; the table's rows: its
            # eight shapes of the most swept voxels
            ms = [v[0] for v in checked.values()]
            log(f"[kernels] B4 fill path: {len(checked)} shapes, "
                f"{sum(calls.values())} calls, {min(ms):.4f}-{max(ms):.4f} "
                f"ms a sweep, "
                f"{sum(calls[k] * v[0] for k, v in checked.items()):.1f} ms "
                f"at those times over the calls")
            top = sorted(checked, key=lambda k: calls[k] * int(np.prod(k)))
            checked = {k: checked[k] for k in top[-8:]}
        for shape, v in checked.items():
            b4_rows.setdefault(shape, [0, v])
            b4_rows[shape][0] += calls.get(shape, 0)
    for part in (dense_launches, soma_launches, xs_launches, fill_launches,
                 small_fill_launches, stream_launches, chunk_launches,
                 touch_launches, touch_small_launches, analysis_launches,
                 sharded_launches):
        for k, v in part.items():
            launches[k] += v
    log(f"[main] launches over the main-path runs: {json.dumps(launches)}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was never launched on the main path")

    # B4's row: the shape of the main path's most swept voxels (the
    # synthetic shape of phase 3 stays in the log)
    b4_main = max((k for k in b4_rows if b4_rows[k][0] > 0),
                  key=lambda k: b4_rows[k][0] * int(np.prod(k)))
    b4_err = max(v[1][4] for v in b4_rows.values())

    # least times of the timed calls: each input byte read once and each
    # output byte written once over the HBM rate, against the operations
    # over the float32 peak; bytes and operations per voxel from the
    # operands of the timed call (B1 d, cc, okmask in, d out; B2 two
    # fields, cc, nodecost, okmask in, two out; B4/B5 d, ok, nodecost in,
    # d out)
    def bound(nbytes, ops):
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / ALU_OPS_PER_S
        return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"

    vox = n ** 3
    bounds = {
        "gsweep_sweep0": bound(13 * vox, 20 * vox),
        "gsweep_sweep0_dual": bound(25 * vox, 40 * vox),
        "crop_argmax": (b3[3], "bytes"),
        "sweep_axis0_batched": b4_rows[b4_main][1][2:4],
        "sweep_axis0": bound(13 * 96 ** 3, 12 * 96 ** 3),
    }
    timed = {k: (b3 if k == "crop_argmax" else t) for k, _, _, t, _ in meta}
    timed["sweep_axis0"] = (b5[0], b5[1], max(b5[2], b5_err))
    timed["sweep_axis0_batched"] = (b4_rows[b4_main][1][0],
                                    b4_rows[b4_main][1][1],
                                    max(b4[2], b4_err))
    for k, src, rep, _, what in meta:
        ms, plain, err, *_ = timed[k]
        table.append({"name": k, "route": "cuda", "source": src,
                      "replaces": rep, "launches": launches[k],
                      "max_abs_err": err, "ms": round(ms, 4),
                      "plain_ms": round(plain, 4),
                      "bound_ms": round(bounds[k][0], 4),
                      "bound_by": bounds[k][1], "library_ms": None})
    f1_err = max(f1["err"], f1_err)
    table.append({"name": "fma_f32", "route": "cuda",
                  "source": "kimimaro_tpu_torch/csrc/fma.cu",
                  "replaces": "kimimaro_tpu/trace.py:67",
                  "launches": launches["fma_f32"], "max_abs_err": f1_err,
                  "ms": round(f1["ms"], 4), "plain_ms": round(f1["plain"], 4),
                  "bound_ms": round(f1["bound"], 4), "bound_by": "bytes",
                  "library_ms": None if f1["library"] is None
                  else round(f1["library"], 4)})
    # F1 by route at the main path's call of the most elements, with the
    # main-path calls of each route
    for route in ("flat", "strided"):
        keys = [k for k in f1_rows if k[1] == route]
        if not keys:
            continue
        key = max(keys, key=lambda k: int(np.prod(k[0])))
        ms, plain, bms, lib, _ = f1_rows[key]
        calls = sum(v[4] for k, v in f1_rows.items() if k[1] == route)
        table.append({
            "name": f"fma_f32 {route} {key[0]}", "route": "cuda",
            "source": "kimimaro_tpu_torch/csrc/fma.cu",
            "replaces": "kimimaro_tpu/trace.py:67", "launches": calls,
            "max_abs_err": f1_err, "ms": round(ms, 4),
            "plain_ms": round(plain, 4), "bound_ms": round(bms, 4),
            "bound_by": "bytes",
            "library_ms": None if lib is None else round(lib, 4)})
    # B4 at each shape the main path gave it, the calls at that shape
    for shape, (calls, (ms, plain, bms, by, err)) in sorted(b4_rows.items()):
        log(f"[kernels] sweep_axis0_batched {shape}: {ms:.4f} ms vs plain "
            f"{plain:.3f} ms, bound {bms:.4f} ms ({by}), {calls} main-path "
            f"calls")
        if calls > 0:
            table.append({
                "name": f"sweep_axis0_batched {shape}", "route": "cuda",
                "source": "kimimaro_tpu_torch/csrc/sweep.cu",
                "replaces": "kimimaro_tpu/ops/pallas_sweep.py:308",
                "launches": calls, "max_abs_err": err, "ms": round(ms, 4),
                "plain_ms": round(plain, 4), "bound_ms": round(bms, 4),
                "bound_by": by, "library_ms": None})
    # X1 at each rung width: its shape of the most lanes, the calls of
    # every shape of that width
    for rung, (calls, key, (ms, plain, bms, by, lanes)) in sorted(
            xs_rep["x1_rungs"].items()):
        log(f"[kernels] section_flood {rung}: {ms:.4f} ms vs plain "
            f"{plain:.3f} ms, bound {bms:.4f} ms ({by}) at {key} x {lanes} "
            f"lanes; {calls} main-path calls")
        table.append({"name": f"section_flood {rung}", "route": "cuda",
                      "source": "kimimaro_tpu_torch/csrc/xsflood.cu",
                      "replaces": "kimimaro_tpu/ops/xsslab.py:74",
                      "launches": calls, "max_abs_err": xs_err,
                      "ms": round(ms, 4), "plain_ms": round(plain, 4),
                      "bound_ms": round(bms, 4), "bound_by": by,
                      "library_ms": None})
    # B6 at each rung width: its shape of the most lanes, the calls of
    # every shape of that width
    for rung, (calls, key, (ms, plain, bms, by, lanes)) in sorted(
            xs_rep["b6_rungs"].items()):
        log(f"[kernels] fetch_secb {rung}: {ms:.4f} ms vs plain "
            f"{plain:.3f} ms, bound {bms:.4f} ms ({by}) at {key} x {lanes} "
            f"lanes; {calls} main-path calls")
        table.append({"name": f"fetch_secb {rung}", "route": "cuda",
                      "source": "kimimaro_tpu_torch/csrc/xsfetch.cu",
                      "replaces": "kimimaro_tpu/ops/xsfetch.py:159",
                      "launches": calls, "max_abs_err": xs_err,
                      "ms": round(ms, 4), "plain_ms": round(plain, 4),
                      "bound_ms": round(bms, 4), "bound_by": by,
                      "library_ms": None})
    for k, src, rep in (
            ("fetch_secb", "kimimaro_tpu_torch/csrc/xsfetch.cu",
             "kimimaro_tpu/ops/xsfetch.py:159"),
            ("section_flood", "kimimaro_tpu_torch/csrc/xsflood.cu",
             "kimimaro_tpu/ops/xsslab.py:74")):
        key, (ms, plain, bms, by, lanes) = xs_rep[k]
        log(f"[kernels] {k}: {ms:.4f} ms vs plain {plain:.3f} ms, bound "
            f"{bms:.4f} ms ({by}) at {key} x {lanes} lanes of the dense run")
        table.append({"name": k, "route": "cuda", "source": src,
                      "replaces": rep, "launches": launches[k],
                      "max_abs_err": xs_err, "ms": round(ms, 4),
                      "plain_ms": round(plain, 4),
                      "bound_ms": round(bms, 4), "bound_by": by,
                      "library_ms": None})
    # the graph-gated forms (phase 10): B1's at the self-touch CCL's sweep
    # (the two 512^3 runs' launches), B5's at a 96^3 node sweep (B5's row
    # shape; only the 64^3 card run's host-path label launches it, so its
    # launches are that run's and the 512^3 runs'), B4's at each shape of
    # the self-touch runs' most swept voxels
    log(f"[kernels] self-touch launches: 512^3 runs "
        f"{json.dumps(touch_launches)}; 64^3 card run "
        f"{json.dumps(touch_small_launches)}")
    table.append({"name": "gsweep_sweep0_vg", "route": "cuda",
                  "source": "kimimaro_tpu_torch/csrc/gsweep.cu",
                  "replaces": "kimimaro_tpu/ops/gsweep.py:219",
                  "launches": touch_launches["gsweep_sweep0_vg"],
                  "max_abs_err": b1_vg[2], "ms": round(b1_vg[0], 4),
                  "plain_ms": round(b1_vg[1], 4),
                  "bound_ms": round(bound(12 * int(np.prod(b1_vg[3])),
                                         20 * int(np.prod(b1_vg[3])))[0], 4),
                  "bound_by": bound(12 * int(np.prod(b1_vg[3])),
                                    20 * int(np.prod(b1_vg[3])))[1],
                  "library_ms": None})
    table.append({"name": "sweep_axis0_vg", "route": "cuda",
                  "source": "kimimaro_tpu_torch/csrc/sweep.cu",
                  "replaces": "kimimaro_tpu/ops/pallas_sweep.py:117",
                  "launches": touch_launches["sweep_axis0_vg"]
                  + touch_small_launches["sweep_axis0_vg"],
                  "max_abs_err": b5_vg[2], "ms": round(b5_vg[0], 4),
                  "plain_ms": round(b5_vg[1], 4),
                  "bound_ms": round(bound(17 * 96 ** 3, 12 * 96 ** 3)[0], 4),
                  "bound_by": bound(17 * 96 ** 3, 12 * 96 ** 3)[1],
                  "library_ms": None})
    touch_err = max([v[4] for v in b4_touch.values()] + [b4_rule_err])
    ms_all = [v[0] for v in b4_touch.values()]
    log(f"[kernels] B4 self-touch: {len(b4_touch)} shapes, "
        f"{sum(b4_touch_calls.values())} calls, {min(ms_all):.4f}-"
        f"{max(ms_all):.4f} ms a sweep")
    top = sorted(b4_touch, key=lambda k: b4_touch_calls[k] * int(np.prod(k)))
    for shape in top[-8:]:
        ms, plain, bms, by, err = b4_touch[shape]
        table.append({
            "name": f"sweep_axis0_batched_vg {shape}", "route": "cuda",
            "source": "kimimaro_tpu_torch/csrc/sweep.cu",
            "replaces": "kimimaro_tpu/ops/pallas_sweep.py:308",
            "launches": b4_touch_calls[shape], "max_abs_err": touch_err,
            "ms": round(ms, 4), "plain_ms": round(plain, 4),
            "bound_ms": round(bms, 4), "bound_by": by, "library_ms": None})
    # G1 at the 512^3 self-touch runs' shapes of the most voxels: the crop
    # engine's largest lane sets, and the CCL form at the CCL's volume; the
    # launches are those runs' calls of each shape
    g1_err = max(v[4] for v in g1_touch.values())
    for ccl, g1_name, g1_rep, top in (
            (False, "graph_into", "kimimaro_tpu/ops/geodesic.py:444", 3),
            (True, "graph_into_ccl", "kimimaro_tpu/ops/ccl.py:83", 2)):
        keys = [k for k in g1_touch
                if k[1] == ccl and g1_touch_calls.get(k, 0) > 0]
        for key in sorted(keys, key=lambda k: -g1_touch_calls[k]
                          * int(np.prod(k[0])))[:top]:
            ms, plain, bms, by, _ = g1_touch[key]
            table.append({
                "name": f"{g1_name} {key[0]}", "route": "cuda",
                "source": "kimimaro_tpu_torch/csrc/gate.cu",
                "replaces": g1_rep, "launches": g1_touch_calls[key],
                "max_abs_err": g1_err, "ms": round(ms, 4),
                "plain_ms": round(plain, 4), "bound_ms": round(bms, 4),
                "bound_by": by, "library_ms": None})
    # C1 on the recorded lane sets of the dense, soma, fill and self-touch
    # runs
    table.extend(c1_dense + c1_soma + c1_fill + c1_rows)
    table.extend(v1_table(launches, v1, v1_rows, v1_lanes_rows, v1b_err))
    # B5 at phase 11's connect_points shape (512^3), each mode
    table.extend(b5_connect)
    # phase 12: B1, B3, B4, B5 and F1 at the sharded path's shapes
    table.extend(sharded_rows)
    log(f"[main] every phase passed in {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
