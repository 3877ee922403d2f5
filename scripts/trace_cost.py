"""The program's tracing on the card, for one benchmark cell: what it costs
and what it misses.

    python3 scripts/trace_cost.py CELL [CHUNKS] [SEED] [DEVICE]

run from the root of a checkout with the benchmark (skelbench/, BENCHMARK.json)
on a machine with a CUDA card. After the cell's warm-up chunk it runs:

1. one chunk under `torch.cuda.set_sync_debug_mode("warn")` with
   `profiling.collect(True, sync=False)` (no phase synchronizes): every
   synchronizing CUDA call warns, and each warning is tallied under the
   outermost open phase, as routed (it came from inside `profiling.host`)
   or missed (with the line that made it), beside the program's own
   `<phase>_syncs` counters;
2. CHUNKS (default 5) chunks in each of three arms, in turns: collection
   off, `collect(True)` (the traced run's form) and
   `collect(True, sync=False)` (host intervals only), each chunk timed on
   the host clock to a device synchronize; with `collect(True)` also the
   per-layer metrics of `skelbench/layers/` that read spans and counters,
   and the spans a chunk records.

It prints the sync check as one JSON line, then the whole record as the
last line. DEVICE "cpu" rehearses the rest on a CPU (no sync check there).
"""

from __future__ import annotations

import collections
import importlib
import json
import os
import statistics
import sys
import time
import warnings

ROOT = os.getcwd()
sys.path.insert(0, os.path.join(ROOT, "skelbench"))

LAYERS = ("preamble_syncs", "preamble_wait_s", "gengine_syncs",
          "gengine_wait_s", "crop_syncs", "crop_wait_s", "crop_fields_s",
          "crop_loop_s", "crop_drain_s", "crop_path_iters", "preamble_s",
          "gengine_s", "crop_engine_s")


def sync_check(cell, chunk, profiling, torch):
    """Warnings of one chunk by outermost phase: routed and missed (by
    site), beside the program's counters."""
    host_code = profiling.host.__code__
    routed = collections.Counter()
    missed = collections.defaultdict(collections.Counter)

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        top = profiling._TOP[0][:-len("_syncs")] if profiling._TOP \
            else "-"
        f = sys._getframe(1)
        while f is not None and f.f_code is not host_code:
            f = f.f_back
        if f is not None:
            routed[top] += 1
        else:
            site = f"{os.path.relpath(filename, ROOT)}:{lineno}"
            missed[top][site] += 1

    profiling.reset_stats()
    profiling.collect(True, sync=False)
    shown = warnings.showwarning
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            cell.skeletonize(chunk)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            warnings.showwarning = shown
            profiling.collect(False)
    cell.sync()
    counted = {k[:-len("_syncs")]: v for k, v in
               profiling.get_stats()["counters"].items()
               if k.endswith("_syncs")}
    out = {}
    for top in sorted(set(counted) | set(routed) | set(missed)):
        sites = missed.get(top, collections.Counter())
        out[top] = {"counted": counted.get(top, 0),
                    "warned_routed": routed.get(top, 0),
                    "warned_missed": sum(sites.values()),
                    "missed_sites": dict(sites.most_common(25))}
    return out


def main(argv):
    name = argv[1]
    per_arm = int(argv[2]) if len(argv) > 2 else 5
    seed = int(argv[3]) if len(argv) > 3 else 2_718_281_829
    device = argv[4] if len(argv) > 4 else "cuda"
    import run

    run.use_checkout(ROOT)
    import torch

    from kimimaro_tpu_torch.utils import profiling

    card = run.card() if device == "cuda" else "cpu"
    cell = run.Cell(ROOT, name, device)
    chunks = cell.chunks(seed)
    t = time.perf_counter()
    cell.skeletonize(chunks.next()[0])                     # warm-up
    cell.sync()
    warm_s = time.perf_counter() - t

    checks = (sync_check(cell, chunks.next()[0], profiling, torch)
              if device == "cuda" else None)
    print(json.dumps({"cell": name, "sync_check": checks}), flush=True)

    arms = {"off": None, "on": True, "host_only": False}
    secs = {a: [] for a in arms}
    layer_vals = collections.defaultdict(list)
    n_spans = []
    order = list(arms)
    for i in range(per_arm):
        for arm in order[i % 3:] + order[:i % 3]:
            chunk, _ = chunks.next()
            profiling.reset_stats()
            if arms[arm] is not None:
                profiling.collect(True, sync=arms[arm])
            cell.sync()
            t = time.perf_counter()
            cell.skeletonize(chunk)
            cell.sync()
            secs[arm].append(time.perf_counter() - t)
            profiling.collect(False)
            if arm == "on":
                stats = profiling.get_stats()
                rec = {"chunks": 1, "phases": stats["phases"],
                       "counters": stats["counters"], "launches": {},
                       "profile": None}
                for m in LAYERS:
                    v = importlib.import_module(f"layers.{m}").read(rec)
                    if v is not None:
                        layer_vals[m].append(v)
                n_spans.append(len(profiling.spans()))
            profiling.reset_stats()
    out = {"cell": name, "card": card, "seed": seed, "warm_s": warm_s,
           "chunk_s": secs,
           "median_s": {a: statistics.median(v) for a, v in secs.items()},
           "layers_on": {m: v for m, v in layer_vals.items()},
           "spans_per_chunk": n_spans, "sync_check": checks}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
