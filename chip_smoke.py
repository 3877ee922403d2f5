#!/usr/bin/env python3
"""Smoke run of kimimaro_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: the card's name and power limit;
  2. build: the CUDA kernels from kimimaro_tpu_torch/csrc (nvcc, sm_90a);
  3. kernels: each kernel (B1-B5, F1) against its plain torch version on
     the card, bit for bit, at a small shape and at the main path's shape,
     with both times; B1, B2 and B5 also at shapes that stress their
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
     engines round it differently); then B3 bit-equal
     to its plain version on calls that run made (its row of the kernel
     table);
  6. the soma volume at real size: bench.py's hollow variant of that
     volume (carved holes, nested pits, two soma-scale balls that the
     global engine hands to the crop engine), run twice, with phase
     times, counters, launches and the peak device memory;
  7. cross-check: 64 labels of the dense run, from one crop bucket,
     traced by the crop engine at full lane width on the card (with the
     global engine's PDRF formula) equal their global-engine skeletons;
     then B4 bit-equal to its plain version on the calls the soma run,
     the per-label path and this cross-check made, with a kernel-table
     row for each shape of the main path's runs;
  8. cross sections: B6 and X1 against their plain versions at small
     shapes; cross_sectional_area on the dense run's largest skeletons
     (bench.py's selection, >= 12,000 vertices) and on the soma volume's
     two balls (W = 512 rungs), each run twice, with ms/vertex, rung
     counters, launches and peak memory, each equal to the CPU on a
     subset (the smallest dense skeletons up to 300 vertices, the smaller
     ball); the per-label path (cross_sectional_area_single, fill_holes,
     zero normals on the dense rung: B4) CUDA against CPU; then B6 and X1
     bit-equal to their plain versions on the inputs those runs handed
     them, with times and bounds, and a kernel-table row for X1 at each
     rung width.

The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result. Launch counts are reset just before each main-path run of
phases 4 to 6 and 8 and read just after it; the table's launches are
their sum, so neither the kernel comparisons nor the cross-checks count.

    python3 chip_smoke.py --profile

runs the dense volume under torch.profiler instead and prints the card's
busy share and the operations that took most device time.

    python3 chip_smoke.py --ab DIR

times kernels X1 and B4 of this checkout against those built from the
sources of the checkout at DIR (the parent commit, e.g. unpacked with
git archive), on the same inputs in one process, in turns.

    python3 chip_smoke.py --host-soma

runs one soma-mode label of 512^3 (a 3,680 nm soma with a neurite, alone
in the volume) through skeletonize instead: the crop engine hands it to
the host trace path, whose relaxes are B5 sweeps. It prints the run's
seconds, phases, counters and launches.
"""

from __future__ import annotations

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
    """While installed, keeps the arguments of the first host trace path
    B5 call of every (shape, mode, clamp, direction), up to `keep` of them,
    and counts the calls by the form their plane takes."""

    def __init__(self, keep=64):
        self.keep = keep
        self.kept = {}
        self.calls = {}

    def install(self):
        from kimimaro_tpu_torch.ops import geodesic, sweep

        inner = geodesic.sweep_axis0

        def spy(d, ok, nc, anis, node_mode, clamp_positive, descending=False):
            if d.device.type == "cuda":
                key = (tuple(d.shape), bool(node_mode), bool(clamp_positive),
                       bool(descending))
                if key not in self.kept and len(self.kept) < self.keep:
                    self.kept[key] = (d.clone(), ok, nc, tuple(anis))
                form = sweep.sweep_axis0_plan(d.shape[1], d.shape[2],
                                              node_mode)["form"]
                self.calls[form] = self.calls.get(form, 0) + 1
            return inner(d, ok, nc, anis, node_mode, clamp_positive,
                         descending)

        geodesic.sweep_axis0 = spy

        def restore():
            geodesic.sweep_axis0 = inner

        return restore


def check_b5_recorded(spy):
    """B5 against its plain version on the calls the host trace path made
    (phases 4 and 5), each made twice, with the kernel's time. Returns the
    max abs error."""
    from kimimaro_tpu_torch.ops import sweep

    err = 0.0
    ms_total = plain_total = 0.0
    forms = {}
    for key, (d, ok, nc, anis) in sorted(spy.kept.items()):
        shape, node, clamp, desc = key
        got = sweep.sweep_axis0(d, ok, nc, anis, node, clamp, desc)
        again = sweep.sweep_axis0(d, ok, nc, anis, node, clamp, desc)
        want, plain = timed_once(lambda: sweep._sweep_axis0_plain(
            d, ok, nc, anis, node, clamp, desc))
        err = max(err, require_equal(f"B5 host call {key}", got, want))
        require_equal(f"B5 host call {key} run twice", again, got)
        ms = cuda_ms(lambda: sweep.sweep_axis0(d, ok, nc, anis, node, clamp,
                                               desc), 3)
        form = sweep.sweep_axis0_plan(shape[1], shape[2], node)["form"]
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
        d, ok, nc, anis, True, False, vg=vg, bits9=bits9), 5)
    plain_vg = cuda_ms(lambda: sweep._sweep_axis0_batched_plain(
        d, ok, nc, anis, True, False, False, vg, bits9), 1)
    log(f"[kernels] B4 with the voxel graph: {ms_vg:.3f} ms vs plain "
        f"{plain_vg:.3f} ms ({shape[0]} lanes of {shape[1:]})")
    return ms, plain, err


class B4Spy:
    """While installed, counts the B4 calls per lane shape and keeps the
    arguments of the first call of every (shape, mode, clamp, direction),
    up to `keep` of them."""

    def __init__(self, tag, keep=256):
        self.tag = tag
        self.keep = keep
        self.kept = {}
        self.calls = {}

    def install(self):
        from kimimaro_tpu_torch.ops import geodesic

        inner = geodesic.sweep_axis0_batched

        def spy(d, ok, nc, anis, node_mode, clamp_positive, descending=False,
                vg=None, bits9=None):
            if d.device.type == "cuda":
                shape = tuple(d.shape)
                self.calls[shape] = self.calls.get(shape, 0) + 1
                key = (shape, bool(node_mode), bool(clamp_positive),
                       bool(descending))
                if key not in self.kept and len(self.kept) < self.keep:
                    self.kept[key] = (d.clone(), ok.clone(),
                                      None if nc is None else nc.clone(),
                                      tuple(anis))
            return inner(d, ok, nc, anis, node_mode, clamp_positive,
                         descending, vg=vg, bits9=bits9)

        geodesic.sweep_axis0_batched = spy

        def restore():
            geodesic.sweep_axis0_batched = inner

        return restore


def b4_bound(shape, node):
    """Least time of one B4 sweep of `shape`: d, ok (and nodecost) read
    once, d written once, over the HBM rate, against nine candidates a
    voxel over the float32 peak. Returns (ms, by)."""
    vox = int(np.prod(shape))
    t_b = (13 if node else 9) * vox / HBM_BYTES_PER_S
    t_o = (12 if node else 18) * vox / ALU_OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def check_b4_recorded(spy):
    """B4 against its plain version on the calls a run made, each made
    twice. Returns {shape: (ms, plain_ms, bound_ms, bound_by, err)}, timed
    on the shape's first recorded call (a node sweep where there is one)."""
    from kimimaro_tpu_torch.ops import sweep

    out = {}
    for key in sorted(spy.kept, key=lambda k: (k[0], not k[1], k[2], k[3])):
        shape, node, clamp, desc = key
        d, ok, nc, anis = spy.kept[key]
        got = sweep.sweep_axis0_batched(d, ok, nc, anis, node, clamp, desc)
        again = sweep.sweep_axis0_batched(d, ok, nc, anis, node, clamp, desc)
        want, plain = timed_once(lambda: sweep._sweep_axis0_batched_plain(
            d, ok, nc, anis, node, clamp, desc))
        err = require_equal(f"B4 {spy.tag} call {key}", got, want)
        require_equal(f"B4 {spy.tag} call {key} run twice", again, got)
        if shape in out:
            out[shape] = out[shape][:4] + (max(out[shape][4], err),)
            continue
        ms = cuda_ms(lambda: sweep.sweep_axis0_batched(d, ok, nc, anis, node,
                                                       clamp, desc), 5)
        bms, by = b4_bound(shape, node)
        plan = sweep.sweep_axis0_batched_plan(shape[0], shape[2], shape[3],
                                              node)
        out[shape] = (ms, plain, bms, by, err)
        log(f"[kernels] B4 {spy.tag} {shape} ({spy.calls.get(shape, 0)} "
            f"calls, form {plan['form']}, {plan['ctas']} CTAs a lane of "
            f"{plan['rows']} rows): {'node' if node else 'euclid'} sweep "
            f"{ms:.4f} ms vs plain {plain:.3f} ms, bound {bms:.4f} ms ({by})")
    log(f"[kernels] B4 bit-equal on the {len(spy.kept)} recorded {spy.tag} "
        f"calls (distinct shape, mode, clamp, direction), twice")
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


def check_f1(gen):
    """F1 against its plain version (float64, round-to-odd): 2^22 triples,
    half at midpoints; broadcast operands and constants as the main path
    passes them; then the dense PDRF's 1 - dbf * m at 512^3, timed.
    Returns (ms, plain_ms, max abs err, bound_ms, bound_by)."""
    import torch

    from kimimaro_tpu_torch.ops import fma

    err = 0.0
    a, b, c = fma_triples(1 << 21, gen)
    err = max(err, require_equal("F1 triples", fma.fma_f32(a, b, c),
                                 fma._fma_f32_plain(a, b, c)))
    x = torch.rand((64, 5, 7, 5), generator=gen, device="cuda") * 900
    y = torch.rand((64, 1, 1, 1), generator=gen, device="cuda")
    z = torch.rand((64, 5, 7, 1), generator=gen, device="cuda") * 3
    for args in ((x, y, z), (-x, y, 1.0), (x, 1.5, 30.0),
                 (x[:, 0], 10.0, z[:, 0])):
        plain = [t if isinstance(t, torch.Tensor) else torch.tensor(
            t, dtype=torch.float32, device="cuda") for t in args]
        err = max(err, require_equal(
            "F1 broadcast", fma.fma_f32(*args), fma._fma_f32_plain(*plain)))
    n = DENSE_N
    dbf = torch.rand((n, n, n), generator=gen, device="cuda") * 400
    m = torch.rand((n, n, n), generator=gen, device="cuda") * 0.01
    one = torch.ones((), device="cuda")
    got = fma.fma_f32(-dbf, m, 1.0)
    want, _ = timed_once(lambda: fma._fma_f32_plain(-dbf, m, one))
    err = max(err, require_equal("F1 512^3", got, want))
    ms = cuda_ms(lambda: fma.fma_f32(-dbf, m, 1.0), 5)
    plain = cuda_ms(lambda: fma._fma_f32_plain(-dbf, m, one), 2)
    nbytes = 3 * 4 * n ** 3
    bms = 1e3 * nbytes / HBM_BYTES_PER_S
    log(f"[kernels] F1 bit-equal to its plain version on 2^22 triples (half "
        f"at float32 midpoints) and broadcast operands; 1 - dbf * m at "
        f"{n}^3: {ms:.4f} ms vs plain {plain:.3f} ms, bound {bms:.4f} ms "
        f"(bytes)")
    del dbf, m
    return ms, plain, err, bms, "bytes"


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


def run_main_path(tag, vol, require, capture=False, b3_spy=None, **kwargs):
    """skeletonize(vol) on CUDA twice, the launch counts reset just before
    each run and read just after it; each run must launch every kernel in
    `require`. Returns (skeletons and counters of the second run, launches
    summed over both runs, and with `capture` the global engine's inputs
    and results of the second run). `b3_spy` is installed for the first
    run."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import gengine, kernels
    from kimimaro_tpu_torch.utils import profiling

    captured = []
    trace_global = gengine.trace_global

    def spy(cc_dev, dbf_dev, jobs, *args, **kw):
        results, leftover = trace_global(cc_dev, dbf_dev, jobs, *args, **kw)
        captured.append((cc_dev, dbf_dev, jobs, results))
        return results, leftover

    total = {k: 0 for k in kernels.LAUNCHES}
    for run in ("first", "second"):
        if capture and run == "second":
            gengine.trace_global = spy
        restore_b3 = b3_spy.install() if (b3_spy is not None
                                          and run == "first") else None
        profiling.reset_stats()
        profiling.collect(True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
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
        log(f"[{tag}] {run} run: {secs:.2f} s, {len(skels)} skeletons, "
            f"{len(skels) / secs:.1f} labels/s, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
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


def dense_main_path(vol):
    """Returns (skeletons, the global engine's inputs and results, launches,
    the B3 calls recorded in the first run)."""
    n = vol.shape[0]
    b3_spy = B3Spy()
    skels, counters, launches, captured = run_main_path(
        "dense", vol, ("gsweep_sweep0", "gsweep_sweep0_dual", "crop_argmax"),
        capture=True, b3_spy=b3_spy)
    if len(skels) < 0.9 * DENSE_LABELS * (n / 512) ** 3:
        raise AssertionError(f"dense run: only {len(skels)} skeletons")
    # one B3 call per grouped argmax: the root selection and one per path
    # iteration, whatever the number of crop tiers
    want = 2 * (counters["gengine_iterations"] + 1)
    if launches["crop_argmax"] != want:
        raise AssertionError(f"dense runs: {launches['crop_argmax']} B3 "
                             f"calls, expected {want}")
    return skels, captured, launches, b3_spy


def hollow_main_path(vol):
    """The soma volume: both balls go to the crop engine, and every label
    with a component above the dust threshold gets a skeleton."""
    import scipy.ndimage

    skels, counters, launches, _ = run_main_path(
        "soma", vol, ("sweep_axis0_batched",), fill_holes=False,
        fix_avocados=False)
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
    return skels, launches


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


def crop_cross_check(captured):
    """64 dense labels of one crop bucket through the crop engine on the
    card (B4 at full lane width on real crops) against their
    global-engine skeletons. Labels with a voxel in the 3x3x3 block at
    their crop's far corner are left out: padding rows of the crop
    engine's path buffer address that corner (the JAX engine's wrapped
    negative indices, kept by the port), so the two engines may differ
    there."""
    from kimimaro_tpu_torch import engine
    from kimimaro_tpu_torch.skeleton import Skeleton

    cc_dev, dbf_dev, jobs, results = captured
    vol_shape = np.asarray(cc_dev.shape)
    cc = cc_dev.cpu().numpy()

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
        b = engine.paths_to_skeleton(results[s], ANIS)
        if not Skeleton.equivalent(a, b):
            raise AssertionError(f"label {s}: crop engine and global engine "
                                 f"disagree")
    log(f"[crop] 64 dense labels of bucket {common} ({len(shapes[common])} "
        f"in it, {len(shapes[common]) - len(clear)} left out at the crop "
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
    # the dilation in shared and device memory; the sweep on each side of
    # section_flood_plan's rule: one CTA of a warp per 32 columns a lane up
    # to 256 columns in shared memory (13 ... 200), one cluster a lane
    # (256 x 256, 250 x 250 and the W = 512 window), one CTA a lane with
    # the window in device memory (a row of 4100 columns, beyond the
    # cluster's 16 warps x 8)
    for method, Wx, Wy, rounds in (
            ("dilate", 13, 10, 1), ("dilate", 32, 29, 36),
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
    log(f"[xs] X1 bit-equal, twice, at small shapes and on each side of "
        f"section_flood_plan's rule (forms {json.dumps(forms)}), zb out of "
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


def xs_equal_cpu(tag, vol, sel, got):
    """The same call on the CPU (plain versions of every kernel) equals
    the card's: contacts exact, areas within rtol 1e-5 (f32 sums taken in
    another order)."""
    import kimimaro_tpu_torch

    t0 = time.perf_counter()
    want = kimimaro_tpu_torch.cross_sectional_area(
        vol, {s.id: s.clone() for s in sel}, anisotropy=ANIS, device="cpu")
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


def cross_sections(dense, dense_skels, hollow, soma_skels, gen):
    """Phase 8. Returns (launches summed over its main-path runs, the
    kernel-table entries of B6 and X1, and the log lines' numbers)."""
    import torch

    err_small = check_xs_small(gen)

    sel, nv = xs_select(dense_skels)
    dspy = XsSpy("dense")
    got, counters, secs, launches = xs_run("xs-dense", dense, sel, dspy)
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
    xs_equal_cpu("xs-dense", dense, small, got)

    balls = [soma_skels[k] for k in sorted(soma_skels)[-2:]]
    sspy = XsSpy("soma")
    sgot, scount, ssecs, slaunches = xs_run("xs-soma", hollow, balls, sspy)
    if scount.get("xsb_rung3_queries", 0) <= 0:
        raise AssertionError(f"soma balls: no query reached rung 3 "
                             f"({scount})")
    xs_equal_cpu("xs-soma", hollow, [min(balls, key=len)], sgot)

    llaunches, lspy, b4_label = per_label_path()
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
    torch.cuda.synchronize()
    err = max(errs)
    # the table's rows: each kernel at the dense run's most used shape, and
    # X1 at each rung width, at its shape of the most lanes
    rep = {}
    for name in ("fetch_secb", "section_flood"):
        key = max((k for k in dspy.calls if k[0] == name),
                  key=lambda k: dspy.calls[k][1])
        rep[name] = (key, timings[key])
    x1_rows = {}
    for spy in spies:
        for key, (calls, _) in spy.calls.items():
            if key[0] != "section_flood":
                continue
            rung = x1_rung(key)
            row = x1_rows.setdefault(rung, [0, None])
            row[0] += calls
            if row[1] is None or timings[key][4] > timings[row[1]][4]:
                row[1] = key
    rep["x1_rungs"] = {r: (c, k, timings[k]) for r, (c, k) in
                       x1_rows.items()}
    return launches, rep, err, b4_label


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
    entry points X1 and B4 had there."""
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
    so.kt_xs_flood.argtypes = [p, p, p, p, p, p, p, i, i, i, i, i, p]
    so.kt_xs_flood.restype = i
    # B4 before its strips: no mailbox argument
    so.kt_sweep_axis0_batched.argtypes = [p, p, p, p, p, i, i, i, i, p, p,
                                          i, i, i, p]
    so.kt_sweep_axis0_batched.restype = i
    return so


def ab_parent(parent):
    """`--ab DIR`: X1 and B4 of this checkout against the kernels built
    from the checkout at DIR (the parent commit), on the same inputs in
    one process, timed in turns (parent, this, this, parent): X1 on the
    floods the dense and soma volumes' cross sections hand it, at each
    rung width, and the dense cross sections' wall with either X1; B4 on
    node sweeps at the main path's shapes, on the calls the crop engine
    makes for --host-soma's label, and that crop engine phase's wall with
    either B4. Results are compared too."""
    import ctypes

    import torch

    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.ops import sweep, xsslab
    from kimimaro_tpu_torch.ops.gsweep import _costs9

    t0 = time.perf_counter()
    plib = ab_library(parent)
    kernels.build()
    kernels.lib()
    log(f"[ab] built both libraries in {time.perf_counter() - t0:.1f} s")

    def x1_parent(seed, secb, zb, rounds, method):
        B, Wx, Wy = seed.shape
        kept = torch.empty_like(seed)
        scratch = torch.empty_like(seed) if method == "dilate" else None
        changed = torch.empty(B, dtype=torch.int32, device="cuda")
        run = torch.empty(B, dtype=torch.int32, device="cuda")
        kernels.check(plib.kt_xs_flood(
            kernels.ptr(seed), kernels.ptr(secb), kernels.ptr(zb),
            kernels.ptr(kept), kernels.ptr(scratch), kernels.ptr(changed),
            kernels.ptr(run), B, Wx, Wy, int(rounds),
            int(method == "sweep"), kernels.stream_ptr(seed.device)),
            "parent section_flood")
        return kept, changed != 0, run

    def b4_parent(d, ok, nc, anis, node_mode=True, clamp_positive=False,
                  descending=False, vg=None, bits9=None):
        B, n, H, W = d.shape
        out = torch.empty_like(d)
        bits = None if vg is None else (ctypes.c_int * 9)(*bits9)
        kernels.check(plib.kt_sweep_axis0_batched(
            kernels.ptr(d), kernels.ptr(ok),
            kernels.ptr(nc if node_mode else None), kernels.ptr(vg),
            kernels.ptr(out), B, n, H, W, kernels.costs_arg(_costs9(anis)),
            bits, int(node_mode), int(clamp_positive), int(descending),
            kernels.stream_ptr(d.device)), "parent sweep_axis0_batched")
        return out

    def turns(fa, fb, reps):
        ta = [cuda_ms(fa, reps)]
        tb = [cuda_ms(fb, reps), cuda_ms(fb, reps)]
        ta.append(cuda_ms(fa, reps))
        return ta, tb

    # the floods the cross sections hand X1
    n = DENSE_N
    dense = dense_volume(n)
    dskels, _, _, _ = run_main_path("ab-dense", dense, ())
    hollow = hollow_volume(dense)
    sskels, _ = hollow_main_path(hollow)
    sel, _ = xs_select(dskels)
    dspy, sspy = XsSpy("dense"), XsSpy("soma")
    xs_run("ab-xs-dense", dense, sel, dspy)
    xs_run("ab-xs-soma", hollow, [sskels[k] for k in sorted(sskels)[-2:]],
           sspy)
    rows = {}
    for spy in (dspy, sspy):
        for key, (calls, lanes) in spy.calls.items():
            if key[0] != "section_flood":
                continue
            rung = x1_rung(key)
            if rung not in rows or lanes > rows[rung][1]:
                rows[rung] = (spy, lanes, key)
    for rung, (spy, lanes, key) in sorted(rows.items()):
        seed, secb, zb, rounds, method = spy.flood[key]
        a = x1_parent(seed, secb, zb, rounds, method)
        b = xsslab.section_flood(seed, secb, zb, rounds, method)
        require_equal(f"ab X1 {key}", b, a)
        ta, tb = turns(lambda: x1_parent(seed, secb, zb, rounds, method),
                       lambda: xsslab.section_flood(seed, secb, zb, rounds,
                                                    method), 3)
        form = xsslab.section_flood_plan(key[1][0], key[1][1], method)[0]
        log(f"[ab] X1 {rung} ({spy.tag}, {seed.shape[0]} lanes of "
            f"{key[1]}, rounds {rounds}, this form {form}; {spy.calls[key]} "
            f"calls of this shape over two runs): parent "
            f"{ta[0]:.4f} / {ta[1]:.4f} ms, this {tb[0]:.4f} / {tb[1]:.4f} "
            f"ms")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    anis = (40.0, 16.0, 16.0)
    for shape in ((2, 256, 256, 64), (2, 64, 256, 256), (64, 128, 128, 32),
                  (64, 32, 128, 128), (64, 64, 64, 32)):
        r = lambda: torch.rand(shape, generator=gen, device="cuda")
        d = torch.where(r() < 0.25, r() * 10, float("inf")).contiguous()
        ok = (r() < 0.8).contiguous()
        nc = (r() * 3).contiguous()
        a = b4_parent(d, ok, nc, anis)
        b = sweep.sweep_axis0_batched(d, ok, nc, anis, True, False)
        require_equal(f"ab B4 {shape}", b, a)
        ta, tb = turns(lambda: b4_parent(d, ok, nc, anis),
                       lambda: sweep.sweep_axis0_batched(d, ok, nc, anis,
                                                         True, False), 5)
        plan = sweep.sweep_axis0_batched_plan(shape[0], shape[2], shape[3],
                                              True)
        bms, by = b4_bound(shape, True)
        log(f"[ab] B4 node sweep {shape} (this form {plan['form']}, "
            f"{plan['ctas']} CTAs a lane): parent {ta[0]:.4f} / "
            f"{ta[1]:.4f} ms, this {tb[0]:.4f} / {tb[1]:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
    ab_walls(sel, dense, x1_parent, b4_parent, turns)
    return 0


def ab_walls(sel, dense, x1_parent, b4_parent, turns):
    """`--ab`'s walls: the dense cross sections with the parent's X1 in
    place of this one, and the crop engine phase on --host-soma's label
    (its host trace path left out) with the parent's B4, in turns; then B4
    on each call that crop engine made, parent against this."""
    import torch

    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import intake
    from kimimaro_tpu_torch.ops import geodesic, sweep, xsslab
    from kimimaro_tpu_torch.utils import profiling

    flood = xsslab.section_flood
    failed = []

    def parent_flood(seed, secb, zb, rounds, method):
        try:
            return x1_parent(seed, secb, zb, rounds, method)
        except RuntimeError as e:
            # once more on the same inputs: a second failure is the call's
            # own, a success an error left over from an earlier call
            try:
                x1_parent(seed, secb, zb, rounds, method)
                again = "succeeds"
            except RuntimeError:
                again = "fails too"
            failed.append(f"{e} on {tuple(seed.shape)} {method} rounds "
                          f"{rounds}; the same call again {again}")
            return flood(seed, secb, zb, rounds, method)

    def xs_wall(fn):
        xsslab.section_flood = fn
        try:
            skels = {s.id: s.clone() for s in sel}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            kimimaro_tpu_torch.cross_sectional_area(dense, skels,
                                                    anisotropy=ANIS,
                                                    device="cuda")
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        finally:
            xsslab.section_flood = flood

    xs_wall(parent_flood)
    xs_wall(flood)
    ta, tb = turns(lambda: xs_wall(parent_flood), lambda: xs_wall(flood), 1)
    log(f"[ab] xs-dense wall with the parent's X1: {ta[0]:.1f} / "
        f"{ta[1]:.1f} ms, with this X1: {tb[0]:.1f} / {tb[1]:.1f} ms")
    log(f"[ab] the parent's X1 failed on {len(failed)} calls"
        + "".join(f"\n[ab]   {f}" for f in failed[:8]))

    vol = soma_label_volume()
    b4 = geodesic.sweep_axis0_batched
    fallback = intake._run_host_fallback
    spy = B4Spy("host-soma crop engine")

    def crop_phase(fn, record=False):
        geodesic.sweep_axis0_batched = fn
        intake._run_host_fallback = lambda *a, **k: None
        restore = spy.install() if record else None
        try:
            profiling.reset_stats()
            profiling.collect(True)
            kimimaro_tpu_torch.skeletonize(
                vol, teasar_params=TEASAR, anisotropy=ANIS,
                dust_threshold=1000, fix_borders=True, fix_branching=True,
                fill_holes=False, device="cuda")
            torch.cuda.synchronize()
        finally:
            if restore is not None:
                restore()
            profiling.collect(False)
            geodesic.sweep_axis0_batched = b4
            intake._run_host_fallback = fallback
        stats = profiling.get_stats()
        return stats["phases"]["crop_engine"], stats["counters"]

    secs, counters = crop_phase(b4, record=True)
    log(f"[ab] host-soma crop engine (this B4, first run): {secs:.3f} s, "
        f"counters {json.dumps(counters)}")
    walls = {"parent": [], "this": []}
    for who in ("parent", "this", "this", "parent"):
        walls[who].append(crop_phase(b4_parent if who == "parent" else b4)[0])
    log(f"[ab] host-soma crop engine phase with the parent's B4: "
        f"{walls['parent'][0]:.3f} / {walls['parent'][1]:.3f} s, with this "
        f"B4: {walls['this'][0]:.3f} / {walls['this'][1]:.3f} s")
    times = {}
    for key in sorted(spy.kept):
        shape, node, clamp, desc = key
        d, ok, nc, anis = spy.kept[key]
        args = (d, ok, nc, anis, node, clamp, desc)
        require_equal(f"ab B4 host-soma crop engine {key}",
                      sweep.sweep_axis0_batched(*args), b4_parent(*args))
        ta, tb = turns(lambda: b4_parent(*args),
                       lambda: sweep.sweep_axis0_batched(*args), 5)
        plan = sweep.sweep_axis0_batched_plan(shape[0], shape[2], shape[3],
                                              node)
        bms, by = b4_bound(shape, node)
        times.setdefault(shape, []).append((sum(ta) / 2, sum(tb) / 2))
        log(f"[ab] B4 host-soma crop engine {key} ({spy.calls[shape]} calls "
            f"of the shape, this form {plan['form']}, {plan['ctas']} CTAs a "
            f"lane of {plan['rows']} rows): parent {ta[0]:.4f} / "
            f"{ta[1]:.4f} ms, this {tb[0]:.4f} / {tb[1]:.4f} ms, bound "
            f"{bms:.4f} ms ({by})")
    est = [0.0, 0.0]
    for shape, calls in sorted(spy.calls.items()):
        t = times.get(shape, [])
        for i in (0, 1):
            est[i] += calls * sum(x[i] for x in t) / max(len(t), 1)
        log(f"[ab] host-soma crop engine: {calls} B4 calls of {shape} "
            f"({len(t)} kinds timed)")
    log(f"[ab] host-soma crop engine: B4's calls at their shapes' mean "
        f"times sum to {est[0] / 1e3:.3f} s with the parent's B4, "
        f"{est[1] / 1e3:.3f} s with this")


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
    if sys.argv[1:] == ["--host-soma"]:
        log(device_line())
        rc = host_soma()
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return rc

    # 1. device
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

    # 4 to 7. the main path; the counts cover exactly its runs. The calls
    # of B5 (the host trace path's eager loop) and of B4 (the crop engine
    # and the host trace path's fused loop) in phases 4 and 5 are
    # recorded.
    b5_spy = B5Spy()
    b4_spy = B4Spy("main path")
    restore_b5 = b5_spy.install()
    restore_b4 = b4_spy.install()
    launches = small_main_path()
    t0 = time.perf_counter()
    dense = dense_volume(n)
    log(f"[dense] volume {dense.shape}, {len(np.unique(dense))} labels, made "
        f"in {time.perf_counter() - t0:.1f} s (set-up, not timed)")
    dense_skels, captured, dense_launches, b3_spy = dense_main_path(dense)
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
    soma_skels, soma_launches = hollow_main_path(hollow)
    # B4's calls on the main path (phase 4's runs)
    b4_main_calls = dict(b4_spy.calls)
    cross_check(captured)
    restore_b4()
    restore_b5()
    b5_err = check_b5_recorded(b5_spy)
    del b5_spy
    b4_crop = crop_cross_check(captured)
    del captured

    # 8. cross sections: the dense and soma volumes' skeletons, the
    # per-label path, and B6/X1 at the shapes those runs handed them
    xs_launches, xs_rep, xs_err, b4_label = cross_sections(
        dense, dense_skels, hollow, soma_skels, gen)
    # B4 on the calls of phases 4 and 5 (the crop engine, the host trace
    # path's fused loop), the per-label path and the crop cross-check;
    # the main-path calls of each shape
    b4_rows = {}
    for spy, calls in ((b4_spy, b4_main_calls), (b4_label, b4_label.calls),
                       (b4_crop, {})):
        for shape, v in check_b4_recorded(spy).items():
            b4_rows.setdefault(shape, [0, v])
            b4_rows[shape][0] += calls.get(shape, 0)
    for part in (dense_launches, soma_launches, xs_launches):
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
    ms, plain, err, bms, by = f1
    table.append({"name": "fma_f32", "route": "cuda",
                  "source": "kimimaro_tpu_torch/csrc/fma.cu",
                  "replaces": "kimimaro_tpu/trace.py:67",
                  "launches": launches["fma_f32"], "max_abs_err": err,
                  "ms": round(ms, 4), "plain_ms": round(plain, 4),
                  "bound_ms": round(bms, 4), "bound_by": by,
                  "library_ms": None})
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
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
