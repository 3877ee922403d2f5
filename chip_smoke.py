#!/usr/bin/env python3
"""Smoke run of kimimaro_tpu_torch on one CUDA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. device: the card's name and power limit;
  2. build: the CUDA kernels from kimimaro_tpu_torch/csrc (nvcc, sm_90a);
  3. kernels: each kernel (B1-B5) against its plain torch version on the
     card, bit for bit, at a small shape and at the main path's shape,
     with both times;
  4. small main path: skeletonize on a blob fixture with a soma-sized
     label (taken by the crop engine) and a label with more manual
     targets than the crop engine holds (taken by the host trace path) on
     CUDA equals the same call on the CPU; the scipy-only TEASAR oracle
     (tests/oracle_teasar.py) agrees on a winding tube;
  5. the main path at real size: a dense anisotropic Voronoi volume of
     512^3 with 2,124 labels (bench.py's generator, seed 0), run twice,
     with phase times, skeleton and launch counts, and 8 labels traced by
     the global engine cross-checked against the host trace path;
  6. the soma volume at real size: bench.py's hollow variant of that
     volume (carved holes, nested pits, two soma-scale balls that the
     global engine hands to the crop engine), run twice, with phase
     times, counters, launches and the peak device memory;
  7. cross-check: 64 labels of the dense run, from one crop bucket,
     traced by the crop engine at full lane width on the card equal
     their global-engine skeletons.

The second-to-last line is the kernel table as JSON; the last line is
{"ok": true, "device": {...}}. Without CUDA it exits non-zero and prints
no result. Launch counts are reset just before each main-path run of
phases 4 to 6 and read just after it; the table's launches are their
sum, so neither the comparisons of phase 3 nor the cross-checks count.
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
        cc = torch.where(cc == 3, -7, cc)
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


def check_b1(shapes, gen):
    from kimimaro_tpu_torch.ops import gsweep

    anis = (16.0, 16.0, 40.0)
    err = 0.0
    for shape in shapes:
        for mode in ("euclid", "node", "maxflood", "minid"):
            for has_ok in (False, True):
                for clamp in (False, True):
                    d, cc, nc, ok = sweep_inputs(shape, mode, has_ok, clamp,
                                                 gen)
                    for desc in (False, True):
                        got = gsweep.sweep0(d, cc, nc, ok, anis, mode, clamp,
                                            desc)
                        want = gsweep._sweep0_plain(d, cc, nc, ok, anis, mode,
                                                    clamp, desc)
                        err = max(err, require_equal(
                            f"B1 {mode} ok={has_ok} clamp={clamp} "
                            f"desc={desc} {shape}", got, want))
        log(f"[kernels] B1 bit-equal on {shape}: 4 modes x okmask x clamp "
            f"x direction")
    d, cc, nc, ok = sweep_inputs(shapes[-1], "euclid", True, True, gen)
    ms = cuda_ms(lambda: gsweep.sweep0(d, cc, None, ok, anis, "euclid", True,
                                       False), 5)
    plain = cuda_ms(lambda: gsweep._sweep0_plain(d, cc, None, ok, anis,
                                                 "euclid", True, False), 1)
    return ms, plain, err


def check_b2(shapes, gen):
    import torch

    from kimimaro_tpu_torch.ops import gsweep

    anis = (16.0, 16.0, 40.0)
    err = 0.0
    for shape in shapes:
        for kind in ("max2", "ball_rail"):
            cc = torch.randint(0, 4, shape, generator=gen, device="cuda",
                               dtype=torch.int32)
            r = lambda: torch.rand(shape, generator=gen, device="cuda")
            if kind == "ball_rail":
                da = torch.where(r() < 0.2, -r() * 60, float("inf"))
                db = torch.where(r() < 0.2, r(), float("inf"))
                nc, ok = r() * 3, (r() < 0.8).to(torch.uint8)
            else:
                da = torch.where(cc > 0, r() * 10, float("-inf"))
                db = torch.where(cc > 0, r() * 10, float("-inf"))
                nc = ok = None
            for desc in (False, True):
                got = gsweep.sweep0_dual(da, db, cc, nc, ok, anis, kind, desc)
                want = gsweep._sweep0_dual_plain(da, db, cc, nc, ok, anis,
                                                 kind, desc)
                err = max(err, require_equal(f"B2 {kind} desc={desc} {shape}",
                                             got, want))
        log(f"[kernels] B2 bit-equal on {shape}: ball_rail, max2 x direction")
    ms = cuda_ms(lambda: gsweep.sweep0_dual(da, db, cc, nc, ok, anis, kind,
                                            False), 5)
    plain = cuda_ms(lambda: gsweep._sweep0_dual_plain(da, db, cc, nc, ok,
                                                      anis, kind, False), 1)
    return ms, plain, err


def check_b3(cases, gen):
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
        got = ca.crop_argmax(field, cc, offs, lids, crop)
        want = ca._crop_argmax_plain(field, cc, offs, lids, crop)
        err = max(err, require_equal(f"B3 {shape} crop={crop} "
                                     f"lanes={n_lanes}", got, want))
        log(f"[kernels] B3 bit-equal on {shape}, crop {crop}, {n_lanes} "
            f"lanes (ties, -inf labels, empty lanes)")
    ms = cuda_ms(lambda: ca.crop_argmax(field, cc, offs, lids, crop), 5)
    plain = cuda_ms(lambda: ca._crop_argmax_plain(field, cc, offs, lids,
                                                  crop), 1)
    return ms, plain, err


def check_b5(shapes, gen):
    import torch

    from kimimaro_tpu_torch.ops import sweep

    anis = (40.0, 16.0, 16.0)
    err = 0.0
    for shape in shapes:
        r = lambda: torch.rand(shape, generator=gen, device="cuda")
        for node in (False, True):
            for clamp in (False, True):
                d = torch.where(r() < 0.25, r() * 10 - (5.0 if clamp else 0.0),
                                float("inf")).contiguous()
                ok = (r() < 0.8).contiguous()
                nc = (r() * 3).contiguous()
                for desc in (False, True):
                    got = sweep.sweep_axis0(d, ok, nc, anis, node, clamp, desc)
                    want = sweep._sweep_axis0_plain(d, ok, nc, anis, node,
                                                    clamp, desc)
                    err = max(err, require_equal(
                        f"B5 node={node} clamp={clamp} desc={desc} {shape}",
                        got, want))
        log(f"[kernels] B5 bit-equal on {shape}: node/euclid x clamp x "
            f"direction")
    ms = cuda_ms(lambda: sweep.sweep_axis0(d, ok, nc, anis, True, False), 5)
    plain = cuda_ms(lambda: sweep._sweep_axis0_plain(d, ok, nc, anis, True,
                                                     False, False), 1)
    return ms, plain, err


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
        log(f"[kernels] B4 bit-equal on {shape}: node/euclid x clamp x "
            f"direction x voxel graph; node sweep {ms:.3f} ms vs plain "
            f"{plain:.3f} ms")
    ms_vg = cuda_ms(lambda: sweep.sweep_axis0_batched(
        d, ok, nc, anis, True, False, vg=vg, bits9=bits9), 5)
    plain_vg = cuda_ms(lambda: sweep._sweep_axis0_batched_plain(
        d, ok, nc, anis, True, False, False, vg, bits9), 1)
    log(f"[kernels] B4 with the voxel graph: {ms_vg:.3f} ms vs plain "
        f"{plain_vg:.3f} ms ({shape[0]} lanes of {shape[1:]})")
    return ms, plain, err


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
    skels = kimimaro_tpu_torch.skeletonize(
        tube.astype(np.uint8), teasar_params=params, anisotropy=(1, 1, 1),
        dust_threshold=0, fix_borders=False, device="cuda")
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


def run_main_path(tag, vol, require, capture=False, **kwargs):
    """skeletonize(vol) on CUDA twice, the launch counts reset just before
    each run and read just after it; each run must launch every kernel in
    `require`. Returns (skeletons and counters of the second run, launches
    summed over both runs, and with `capture` the global engine's inputs
    and results of the second run)."""
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
        finally:
            gengine.trace_global = trace_global
            profiling.collect(False)
        secs = time.perf_counter() - t0
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
    n = vol.shape[0]
    skels, _, launches, captured = run_main_path(
        "dense", vol, ("gsweep_sweep0", "gsweep_sweep0_dual", "crop_argmax"),
        capture=True)
    if len(skels) < 0.9 * DENSE_LABELS * (n / 512) ** 3:
        raise AssertionError(f"dense run: only {len(skels)} skeletons")
    return captured, launches


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
    return launches


def cross_check(captured):
    """The global engine against the host trace path on 8 of its labels
    of the dense run (the equality chain the JAX package's tests pin)."""
    import torch

    from kimimaro_tpu_torch import engine
    from kimimaro_tpu_torch import trace as trace_mod
    from kimimaro_tpu_torch.skeleton import Skeleton

    cc_dev, dbf_dev, jobs, results = captured
    by_segid = {j["segid"]: j for j in jobs}
    rng = np.random.RandomState(0)
    picks = rng.choice(sorted(results), size=8, replace=False)
    for segid in picks:
        job = by_segid[int(segid)]
        mn, shape = job["offset"], job["shape"]
        slc = tuple(slice(int(a), int(a + s)) for a, s in zip(mn, shape))
        crop = cc_dev[slc] == int(segid)
        host = trace_mod.trace(
            crop, torch.where(crop, dbf_dev[slc], 0.0), anisotropy=ANIS,
            fix_branching=True, manual_targets_before=list(job["before"]),
            manual_targets_after=list(job["after"]), root=job["root"],
            device="cuda", **TEASAR)
        eng = engine.paths_to_skeleton(results[segid], ANIS)
        if not Skeleton.equivalent(host, eng):
            raise AssertionError(f"label {segid}: global engine and host "
                                 f"trace disagree")
    log(f"[dense] 8 global-engine labels {sorted(int(s) for s in picks)} "
        f"equal their host-trace skeletons")


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
    t0 = time.perf_counter()
    got, fallback = engine.trace_batched(cc_dev, dbf_dev, picks, TEASAR,
                                         ANIS, True)
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
        f"global-engine skeletons")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from kimimaro_tpu_torch import kernels

    # 1. device
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    log(smi)

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
    b1 = check_b1([(11, 9, 8), (13, 37, 45), (n, n, n)], gen)
    b2 = check_b2([(11, 9, 8), (13, 37, 45), (n, n, n)], gen)
    b3 = check_b3([((20, 18, 16), (8, 7, 6), 6),
                   ((n, n, n), (96, 96, 96), 2048)], gen)
    # B4 at a small shape, at the shapes the main path gives it (the soma
    # volume's (256, 256, 64) bucket of 2 lanes, swept along x and y, then
    # along z through the permuted copy; the crop cross-check's 64 lanes of
    # (128, 128, 32) and their z layout) and at 64 lanes of (64, 64, 32)
    b4 = check_b4([(3, 11, 9, 8), (2, 256, 256, 64), (2, 64, 256, 256),
                   (64, 128, 128, 32), (64, 32, 128, 128),
                   (64, 64, 64, 32)], gen)
    b5 = check_b5([(11, 9, 8), (96, 96, 96)], gen)
    meta = (
        ("gsweep_sweep0", "kimimaro_tpu_torch/csrc/gsweep.cu",
         "kimimaro_tpu/ops/gsweep.py:219", b1,
         f"euclid+okmask+clamp sweep of {n}^3"),
        ("gsweep_sweep0_dual", "kimimaro_tpu_torch/csrc/gsweep.cu",
         "kimimaro_tpu/ops/gsweep.py:528", b2, f"ball_rail sweep of {n}^3"),
        ("crop_argmax", "kimimaro_tpu_torch/csrc/argmax.cu",
         "kimimaro_tpu/ops/pallas_argmax.py:205", b3,
         f"2048 lanes of 96^3 crops in {n}^3"),
        ("sweep_axis0_batched", "kimimaro_tpu_torch/csrc/sweep.cu",
         "kimimaro_tpu/ops/pallas_sweep.py:308", b4,
         "node sweep of 64 lanes of (64, 64, 32) crops"),
        ("sweep_axis0", "kimimaro_tpu_torch/csrc/sweep.cu",
         "kimimaro_tpu/ops/pallas_sweep.py:117", b5,
         "node sweep of a 96^3 crop"),
    )
    for k, src, rep, (ms, plain, err), what in meta:
        log(f"[kernels] {k}: {ms:.3f} ms vs plain {plain:.3f} ms ({what}), "
            f"max abs err {err}")

    # 4 to 7. the main path; the counts cover exactly its runs
    launches = small_main_path()
    t0 = time.perf_counter()
    dense = dense_volume(n)
    log(f"[dense] volume {dense.shape}, {len(np.unique(dense))} labels, made "
        f"in {time.perf_counter() - t0:.1f} s (set-up, not timed)")
    captured, dense_launches = dense_main_path(dense)
    t0 = time.perf_counter()
    hollow = hollow_volume(dense)
    log(f"[soma] volume {hollow.shape}, {len(np.unique(hollow))} labels, "
        f"made in {time.perf_counter() - t0:.1f} s (set-up, not timed)")
    soma_launches = hollow_main_path(hollow)
    del hollow
    for part in (dense_launches, soma_launches):
        for k, v in part.items():
            launches[k] += v
    log(f"[main] launches over the main-path runs: {json.dumps(launches)}")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"{k} was never launched on the main path")
    cross_check(captured)
    crop_cross_check(captured)

    for k, src, rep, (ms, plain, err), what in meta:
        table.append({"name": k, "route": "cuda", "source": src,
                      "replaces": rep, "launches": launches[k],
                      "max_abs_err": err, "ms": round(ms, 4),
                      "plain_ms": round(plain, 4)})
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
