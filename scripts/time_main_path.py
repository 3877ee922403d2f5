#!/usr/bin/env python3
"""Wall seconds of skeletonize on chip_smoke.py's dense and soma volumes
(512^3, bench.py's generators and TEASAR parameters), and of
cross_sectional_area on the dense run's largest skeletons (bench.py's
selection) and the soma volume's two balls, with the port of the
checkout at ROOT, on the card.

    python3 scripts/time_main_path.py ROOT [RUNS] [CASES]

Runs each case RUNS times (default 3) after one first run and prints one
JSON line per case: the seconds of the first run and of every timed run
and their phases (skeletonize) or counters (cross sections). CASES, a
comma-separated list, defaults to dense,soma,xs-dense,xs-soma;
host-soma-crop is chip_smoke.py --host-soma's label with the host trace
path left out (the phases up to the crop engine). Pass the root of another
checkout (the parent commit unpacked with git archive) to time its port
on the same inputs; compare two checkouts only within one call, in turns
(parent, change, change, parent).
"""

import json
import os
import sys
import time


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
        secs, stats = [], []
        for run in range(runs + 1):
            profiling.reset_stats()
            profiling.collect(True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            profiling.collect(False)
            secs.append(round(time.perf_counter() - t0, 3))
            st = profiling.get_stats()[what]
            stats.append({k: round(v, 3) for k, v in st.items()})
        print(json.dumps({"root": root, "case": name, "first": secs[0],
                          "seconds": secs[1:], what: stats}), flush=True)
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
    if not {"dense", "soma", "xs-dense", "xs-soma"} & set(cases):
        return 0
    dense = chip_smoke.dense_volume(chip_smoke.DENSE_N)
    vols = {"dense": (dense, {}),
            "soma": (chip_smoke.hollow_volume(dense),
                     {"fill_holes": False, "fix_avocados": False})}
    skels = {}
    for name, (vol, kw) in vols.items():
        skels[name] = timed(name, lambda: kimimaro_tpu_torch.skeletonize(
            vol, teasar_params=chip_smoke.TEASAR, anisotropy=chip_smoke.ANIS,
            dust_threshold=1000, fix_borders=True, fix_branching=True,
            device="cuda", **kw), "phases")
    sel = {"xs-dense": (vols["dense"][0],
                        chip_smoke.xs_select(skels["dense"])[0]),
           "xs-soma": (vols["soma"][0],
                       [skels["soma"][k] for k in sorted(skels["soma"])[-2:]])}
    for name, (vol, chosen) in sel.items():
        if name not in cases:
            continue
        timed(name, lambda: kimimaro_tpu_torch.cross_sectional_area(
            vol, {s.id: s.clone() for s in chosen},
            anisotropy=chip_smoke.ANIS, device="cuda"), "counters")
    return 0


if __name__ == "__main__":
    sys.exit(main())
