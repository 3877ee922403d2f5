"""The readings the comparison's limits are set from, for one cell in one
process (set-up once): for each seed, one chunk of the cell through the
program and the compared numbers, and for the control seeds the numbers of
the control, the plain reference held in a lower precision (`--precision`,
one of `reference.teasar.PRECISIONS`) put in the program's place, on the
same chunks and sampled labels.

    python3 skelbench/readings.py --workload <cell> --seeds <n> [<n> ...] \
        [--control <n> [<n> ...]] [--precision bfloat16] \
        [--labels <base label> ...]

Prints one JSON line a seed (standard output) and the per-label details
(standard error). `--labels` judges those base labels too, on the first
seed's chunk, and prints each one's skeleton ends and the vertices that
each side has and the other lacks. Needs the card, as a run does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import run


def _ends(verts, edges):
    import numpy as np

    deg = np.bincount(np.asarray(edges, np.int64).ravel(),
                      minlength=len(verts))
    return verts[deg == 1]


def _unmatched(a, b):
    """Vertices of `a` farther than one voxel step from every one of b."""
    import numpy as np
    from scipy.spatial import cKDTree

    if len(a) == 0 or len(b) == 0:
        return len(a)
    d, _ = cKDTree(b).query(a, p=np.inf)
    return int((d > 1).sum())


def explain(cell, lut, res, labels, pool):
    """Per base label: the numbers, both sides' ends and unmatched
    vertices."""
    import numpy as np

    from reference import judge

    ref = cell._ref
    refs = ref.skeletons(labels)
    details = []
    judge.check([lut], [res], ref, [(0, lab) for lab in labels], refs,
                details=details, pool=pool)
    aniso = ref.kwargs["anisotropy"]
    for lab, d in zip(labels, details):
        skel = res.get(int(lut[lab]))
        v, e, _ = judge._voxels(skel, aniso)
        rv = np.concatenate([c["verts"] for c in refs[lab]])
        re_ = judge._joined_edges(refs[lab])
        run.log(f"label {lab}: {json.dumps(d)}; ends program "
                f"{_ends(v, e).tolist()} reference {_ends(rv, re_).tolist()};"
                f" unmatched program {_unmatched(v, rv)} reference "
                f"{_unmatched(rv, v)}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--precision", default="bfloat16")
    ap.add_argument("--labels", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    root = os.getcwd()
    run.use_checkout(root)
    import numpy as np
    import torch

    from kimimaro_tpu_torch.utils import profiling
    from reference import judge

    if not torch.cuda.is_available():
        run.log("needs a CUDA device")
        return 2
    cell = run.Cell(root, args.workload, "cuda")
    cell.skeletonize(cell.base_host.view(np.uint32))
    seeds = list(dict.fromkeys(args.seeds + args.control))
    got = {}
    for seed in seeds:
        chunk, lut = cell.chunks(seed).next()
        profiling.reset_stats()
        profiling.collect(True)
        got[seed] = (lut, cell.skeletonize(chunk))
        cell.sync()
        profiling.collect(False)
        run.log(f"seed {seed} counters: "
                f"{json.dumps(profiling.get_stats()['counters'])}")
    cell.free_device()
    pool = judge.make_pool()
    try:
        for seed in seeds:
            lut, res = got[seed]
            ctl = args.precision if seed in args.control else None
            out, low, labels = cell.judge(seed, [lut], [res], pool,
                                          control=ctl)
            line = {"seed": seed, "program": out}
            run.log(f"seed {seed} program: {json.dumps(cell.details)}")
            if ctl:
                line["control"] = low
                run.log(f"seed {seed} control ({ctl}): "
                        f"{json.dumps(cell.control_details)}")
            print(json.dumps(line), flush=True)
        lut, res = got[seeds[0]]
        inv = np.zeros(int(lut.max()) + 1, np.int64)
        inv[lut] = np.arange(len(lut))
        ends = sorted((judge.skeleton_ends(s), int(inv[k]))
                      for k, s in res.items())[::-1]
        run.log(f"seed {seeds[0]}: the {judge.BRANCHY} labels with the most "
                f"ends (ends, base label): {ends[:judge.BRANCHY]}")
        if args.labels:
            explain(cell, lut, res, args.labels, pool)
    finally:
        pool.close()
        pool.join()
    return 0


if __name__ == "__main__":
    sys.exit(main())
