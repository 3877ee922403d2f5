#!/usr/bin/env python3
"""Wall seconds of skeletonize on chip_smoke.py's dense and soma volumes
(512^3, bench.py's generators and TEASAR parameters), and of
cross_sectional_area on the dense run's largest skeletons (bench.py's
selection) and the soma volume's two balls, with the port of the
checkout at ROOT, on the card.

    python3 scripts/time_main_path.py ROOT [RUNS] [CASES]

Runs each case RUNS times (default 3) after one first run and prints one
JSON line per case: the seconds of the first run and of every timed run
and their phases, routing counters and kernel launches (skeletonize) or
counters (cross sections). CASES, a
comma-separated list, defaults to dense,soma,xs-dense,xs-soma;
host-soma-crop is chip_smoke.py --host-soma's label with the host trace
path left out (the phases up to the crop engine); self-touch is
chip_smoke.py phase 10's volume under its voxel graph; gated-sweeps
times B4 and B5 node sweeps with a graph and without, in turns, on the
same inputs (`gated_sweeps`), one JSON line a shape; ccl-kernels times
G1 (both forms where the port has them) and B1-vg on the self-touch
volume's CCL and at the crop engine's largest lane sets, and the CCL
under the graph as a whole (`ccl_kernels`); single-kernels times V1's
single-volume form (a 512^3 sweep and the sweeps that the dense and soma
oversegment runs send to it), X1's dilation on the dense cross
sections' recorded (32, 32) call, and B1, B2 and B5 at chip_smoke.py's
timed shapes (`single_kernels`). Pass the root of another
checkout (the parent commit unpacked with git archive) to time its port
on the same inputs; compare two checkouts only within one call, in turns
(parent, change, change, parent).
"""

import json
import os
import sys
import time

# the global engine's iterations, the labels it hands to the crop engine,
# and either engine's jobs
ROUTING = ("gengine_iterations", "gengine_taint_capacity", "gengine_jobs",
           "crop_engine_jobs")


def gated_sweeps(root):
    """CUDA-event ms of B4 and B5 node sweeps with a graph and without,
    in turns (a, b, b, a) on the same random inputs: B4 at the shapes of
    the self-touch run's most swept voxels, B5 at a 96^3 crop. The graph
    goes in the form the main path of the port at `root` passes it: a
    gate where its wrappers take one, else the source bitfields."""
    import inspect

    import torch

    import chip_smoke
    from kimimaro_tpu_torch.ops import geodesic, sweep

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    anis = (40.0, 16.0, 16.0)
    if "gate" in inspect.signature(sweep.sweep_axis0).parameters:
        from kimimaro_tpu_torch.ops.gsweep import gate_bits9
        form = {"gate_bits9": gate_bits9(0, False)}
        key = "gate"
    else:
        form = {"bits9": geodesic.sweep_bits9(0, False)}
        key = "vg"
    cases = [("B4", s, sweep.sweep_axis0_batched)
             for s in ((32, 128, 128, 64), (64, 128, 128, 32),
                       (32, 64, 128, 128), (64, 32, 128, 128))]
    cases.append(("B5", (96, 96, 96), sweep.sweep_axis0))
    for name, shape, fn in cases:
        r = lambda: torch.rand(shape, generator=gen, device="cuda")
        d = torch.where(r() < 0.25, r() * 10, float("inf")).contiguous()
        ok, nc = (r() < 0.8).contiguous(), (r() * 3).contiguous()
        words = torch.randint(0, 1 << 26, shape, generator=gen,
                              device="cuda", dtype=torch.int32)
        kw = dict(form, **{key: words})
        ta, tb = chip_smoke.turns(
            lambda: fn(d, ok, nc, anis, True, False, False, **kw),
            lambda: fn(d, ok, nc, anis, True, False, False), 20)
        print(json.dumps({"root": root, "case": "gated-sweeps",
                          "kernel": name, "shape": shape, "form": key,
                          "gated_ms": [round(t, 4) for t in ta],
                          "ungated_ms": [round(t, 4) for t in tb]}),
              flush=True)


def cuda_ms(fn, reps):
    """CUDA-event mean ms of `reps` calls after one warm-up call."""
    import torch

    fn()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return round(a.elapsed_time(b) / reps, 4)


def ccl_kernels(root, merged, vg, runs):
    """G1 and B1-vg as the CCL under a voxel graph calls them at 512^3
    (chip_smoke.py phase 10's self-touch volume), G1 at the crop engine's
    two largest lane-set shapes on random words, and
    `connected_components` under the graph end to end. The port at
    `root` decides the forms: G1's CCL form and B1-vg on (ids, its gate)
    where `graph_into` takes labels, else the graph's gate and B1-vg on
    (ids, cc, gate)."""
    import inspect

    import numpy as np
    import torch

    from kimimaro_tpu_torch.ops import ccl, gsweep, stencils

    folded = "labels" in inspect.signature(stencils.graph_into).parameters
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"root": root, "case": "ccl-kernels",
           "form": "ccl-gate" if folded else "cc+gate"}
    for shape in ((32, 128, 128, 64), (64, 128, 128, 32)):
        words = torch.randint(0, 1 << 26, shape, generator=gen,
                              device="cuda", dtype=torch.int32)
        out[f"g1_ms {shape}"] = cuda_ms(lambda: stencils.graph_into(words),
                                        20)
        del words
    labels = torch.from_numpy(merged.view(np.int32)).cuda()
    vgt = torch.from_numpy(vg.view(np.int32)).cuda()
    out["g1_ms 512^3"] = cuda_ms(lambda: stencils.graph_into(vgt), 20)
    if folded:
        out["g1_ccl_ms 512^3"] = cuda_ms(
            lambda: stencils.graph_into(vgt, labels), 20)
        gate = stencils.graph_into(vgt, labels)
        cc = None
    else:
        gate, cc = stencils.graph_into(vgt), labels
    n = labels.numel()
    ids = torch.where(labels != 0, torch.arange(
        1, n + 1, dtype=torch.int32, device="cuda").reshape(labels.shape),
        2**31 - 1)
    anis = (1.0, 1.0, 1.0)
    for desc in (False, True):
        bits = gsweep.gate_bits9(0, desc)
        out[f"b1_vg_ms desc={desc}"] = cuda_ms(
            lambda: gsweep.sweep0(ids, cc, None, None, anis, "minid", False,
                                  desc, gate, bits), 20)
    del gate, ids
    secs = []
    for _ in range(runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ccl.connected_components(labels, voxel_graph=vgt)
        torch.cuda.synchronize()
        secs.append(round(time.perf_counter() - t0, 4))
    out["ccl_first_s"], out["ccl_s"] = secs[0], secs[1:]
    print(json.dumps(out), flush=True)
    del labels, vgt
    torch.cuda.empty_cache()


class FirstCalls:
    """While installed, counts the calls of `module.name` by the shape of
    their first argument and keeps the arguments of each shape's first
    call (cloned, for the tensors)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.calls, self.kept = {}, {}

    def __enter__(self):
        import torch

        inner = self.inner = getattr(self.module, self.name)

        def spy(*args):
            shape = tuple(args[0].shape)
            self.calls[shape] = self.calls.get(shape, 0) + 1
            if shape not in self.kept:
                self.kept[shape] = tuple(
                    a.clone() if isinstance(a, torch.Tensor) else a
                    for a in args)
            return inner(*args)

        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.inner)


def single_kernels(root, dense, runs):
    """CUDA-event ms of V1's single-volume form and X1's dilation as the
    port at `root` runs them, and of B1, B2 and B5 beside them: V1 on a
    512^3 sweep with ties and on the first call of each shape that the
    dense and soma oversegment runs send to V1's single form (calls
    counted by shape), X1 on the dense cross sections' (32, 32) dilation
    call, B1 (euclid, okmask, clamp) and B2 (ball_rail) at 512^3 and B5
    (node) at 96^3 on chip_smoke.py's inputs. One JSON line."""
    import torch

    import chip_smoke
    import kimimaro_tpu_torch
    from kimimaro_tpu_torch.ops import geodesic, gsweep, sweep, voronoi
    from kimimaro_tpu_torch.ops import xsslab

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    out = {"root": root, "case": "single-kernels"}
    n = chip_smoke.DENSE_N
    iso = (1.0, 1.0, 1.0)
    d, f, ok = chip_smoke.v1_inputs((n, n, n), gen, True)
    flag = torch.zeros(1, dtype=torch.int32, device="cuda")
    costs = geodesic.plane_costs(0, False, iso)
    out["v1_ms 512^3"] = cuda_ms(
        lambda: voronoi.voronoi_sweep(d, f, ok, costs, False, flag), 20)
    del d, f, ok
    anis = (16.0, 16.0, 40.0)
    d, cc, _, ok = chip_smoke.sweep_inputs((n, n, n), "euclid", True, True,
                                           gen)
    out["b1_ms 512^3"] = cuda_ms(lambda: gsweep.sweep0(
        d, cc, None, ok, anis, "euclid", True, False), 20)
    del d, cc, ok
    da, db, cc, nc, ok = chip_smoke.b2_inputs((n, n, n), "ball_rail", gen)
    out["b2_ms 512^3"] = cuda_ms(lambda: gsweep.sweep0_dual(
        da, db, cc, nc, ok, anis, "ball_rail", False), 20)
    del da, db, cc, nc, ok
    d, ok, nc = chip_smoke.b5_inputs((96, 96, 96), False, gen)
    out["b5_ms 96^3"] = cuda_ms(lambda: sweep.sweep_axis0(
        d, ok, nc, (40.0, 16.0, 16.0), True, False, False), 20)
    del d, ok, nc
    torch.cuda.empty_cache()

    kw = dict(teasar_params=chip_smoke.TEASAR, anisotropy=chip_smoke.ANIS,
              dust_threshold=1000, fix_borders=True, fix_branching=True,
              device="cuda")
    skels = kimimaro_tpu_torch.skeletonize(dense, **kw)
    with FirstCalls(xsslab, "section_flood") as xs:
        kimimaro_tpu_torch.cross_sectional_area(
            dense, {s.id: s.clone() for s in chip_smoke.xs_select(skels)[0]},
            anisotropy=chip_smoke.ANIS, device="cuda")
    seed, secb, zb, rounds, method = xs.kept[max(
        k for k in xs.kept if xs.kept[k][4] == "dilate")]
    out["x1_dilate"] = {"lanes": seed.shape[0], "window":
                        list(seed.shape[1:]), "rounds": rounds,
                        "ms": cuda_ms(lambda: xsslab.section_flood(
                            seed, secb, zb, rounds, method), runs * 10)}
    del seed, secb, zb
    hollow = chip_smoke.hollow_volume(dense)
    soma = kimimaro_tpu_torch.skeletonize(hollow, fill_holes=False,
                                          fix_avocados=False, **kw)
    out["v1_single"] = {}
    for tag, vol, sk in (("dense", dense, skels), ("soma", hollow, soma)):
        with FirstCalls(geodesic, "voronoi_sweep") as v1:
            kimimaro_tpu_torch.oversegment(vol, sk,
                                           anisotropy=chip_smoke.ANIS,
                                           device="cuda")
        for shape, (d, f, ok, costs9, desc, _) in sorted(v1.kept.items()):
            flag = torch.zeros(1, dtype=torch.int32, device="cuda")
            out["v1_single"][f"{tag} {shape}"] = {
                "calls": v1.calls[shape], "ms": cuda_ms(
                    lambda: voronoi.voronoi_sweep(d, f, ok, costs9, desc,
                                                  flag), runs * 10)}
    print(json.dumps(out), flush=True)
    del hollow
    torch.cuda.empty_cache()


def main() -> int:
    root = os.path.abspath(sys.argv[1])
    runs = int(sys.argv[2]) if len(sys.argv) > 2 else 3
    cases = (sys.argv[3] if len(sys.argv) > 3
             else "dense,soma,xs-dense,xs-soma").split(",")
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    import kimimaro_tpu_torch
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    if not torch.cuda.is_available():
        print("time_main_path: CUDA is not available", file=sys.stderr)
        return 1
    kernels.build()

    def timed(name, fn, what):
        secs, stats, routing, launches = [], [], [], []
        for run in range(runs + 1):
            profiling.reset_stats()
            profiling.collect(True)
            torch.cuda.synchronize()
            kernels.reset_launches()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            profiling.collect(False)
            secs.append(round(time.perf_counter() - t0, 3))
            st = profiling.get_stats()
            stats.append({k: round(v, 3) for k, v in st[what].items()})
            routing.append({k: st["counters"].get(k, 0) for k in ROUTING})
            launches.append({k: v for k, v in kernels.LAUNCHES.items() if v})
        line = {"root": root, "case": name, "first": secs[0],
                "seconds": secs[1:], what: stats}
        if what == "phases":
            line["routing"] = routing
            line["launches"] = launches
        print(json.dumps(line), flush=True)
        return out

    if "host-soma-crop" in cases:
        from kimimaro_tpu_torch import intake

        vol = chip_smoke.soma_label_volume()
        intake._run_host_fallback = lambda *a, **k: None
        timed("host-soma-crop", lambda: kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=chip_smoke.TEASAR, anisotropy=chip_smoke.ANIS,
            dust_threshold=1000, fix_borders=True, fix_branching=True,
            fill_holes=False, device="cuda"), "phases")
        del vol
    if "gated-sweeps" in cases:
        gated_sweeps(root)
    if not {"dense", "soma", "xs-dense", "xs-soma", "self-touch",
            "ccl-kernels", "single-kernels"} & set(cases):
        return 0
    dense = chip_smoke.dense_volume(chip_smoke.DENSE_N)
    if "single-kernels" in cases:
        single_kernels(root, dense, runs)
    if {"self-touch", "ccl-kernels"} & set(cases):
        merged, vg, _, _ = chip_smoke.self_touch_volume(dense)
    if "ccl-kernels" in cases:
        ccl_kernels(root, merged, vg, runs)
    if "self-touch" in cases:
        timed("self-touch", lambda: kimimaro_tpu_torch.skeletonize(
            merged, teasar_params=chip_smoke.TEASAR,
            anisotropy=chip_smoke.ANIS, dust_threshold=1000,
            fix_borders=True, fix_branching=True, voxel_graph=vg,
            device="cuda"), "phases")
    if {"self-touch", "ccl-kernels"} & set(cases):
        del merged, vg
    vols = {"dense": (dense, {}),
            "soma": (None, {"fill_holes": False, "fix_avocados": False})}
    skels = {}
    for name, (vol, kw) in vols.items():
        if name not in cases and f"xs-{name}" not in cases:
            continue
        if vol is None:
            vol = chip_smoke.hollow_volume(dense)
            vols[name] = (vol, kw)
        skels[name] = timed(name, lambda: kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=chip_smoke.TEASAR, anisotropy=chip_smoke.ANIS,
            dust_threshold=1000, fix_borders=True, fix_branching=True,
            device="cuda", **kw), "phases")
    sel = {"xs-dense": lambda: (vols["dense"][0],
                                chip_smoke.xs_select(skels["dense"])[0]),
           "xs-soma": lambda: (vols["soma"][0],
                               [skels["soma"][k]
                                for k in sorted(skels["soma"])[-2:]])}
    for name, select in sel.items():
        if name not in cases:
            continue
        vol, chosen = select()
        timed(name, lambda: kimimaro_tpu_torch.cross_sectional_area(
            vol, {s.id: s.clone() for s in chosen},
            anisotropy=chip_smoke.ANIS, device="cuda"), "counters")
    return 0


if __name__ == "__main__":
    sys.exit(main())
