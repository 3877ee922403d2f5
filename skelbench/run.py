"""The benchmark of kimimaro_tpu_torch: whole-volume skeletonization of
label chunks, closed loop, one client.

    python3 skelbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout that holds the program and BENCHMARK.json.
A run builds the cell's base volume on the card from its traffic file,
skeletonizes it once to warm up (set-up ends there), then for `--seconds`
skeletonizes chunks back to back through `kimimaro_tpu_torch.skeletonize`:
each chunk is the base volume under a fresh permutation of its ids, drawn
from `--seed`, handed over as a host array. The window ends when the last
chunk started before `--seconds` finishes. After the window the plain
reference judges the window's skeletons (`reference/judge.py`).

With `--trace 0` the last line of standard output carries the cell's
end-to-end metrics; with `--trace 1` the window runs with the program's
phase timers on, one more chunk runs under `torch.profiler`, and the line
carries the cell's per-layer metrics (`layers/<metric>.py`), the card's
busy and window seconds and a breakdown. Earlier lines (standard error)
carry the card's name and power limit, the per-chunk seconds, phases,
counters, launches and the generation seconds.

Everything a cell needs is found by name from its entry in BENCHMARK.json:
`configs[].file`, `skelbench/traffic/<traffic>.json` (whose steps are
`skelbench/steps/<step>.py`) and `skelbench/layers/<metric>.py`. A
configuration's `skeletonize_kwargs` go to the program as they stand; the
voxel graph is the traffic's (its config says `voxel_graph`: true where
the deployment feeds one, and a cell whose traffic disagrees is refused).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)

# top-level module names that may not be loaded in a run's process: the
# JAX package (the program's reference, never measured) and JAX itself;
# compared as whole first components (kimimaro_tpu_torch passes)
FORBIDDEN = ("jax", "jaxlib", "flax", "kimimaro_tpu")


def log(*args):
    print(*args, file=sys.stderr, flush=True)


def use_checkout(root):
    """The program under test is the checkout's own `kimimaro_tpu_torch`;
    its build and kernel caches go to fixed places inside the checkout."""
    root = os.path.abspath(root)
    if root not in sys.path:
        sys.path.insert(1, root)
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(root, "build",
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(root, "build", "triton")


def load_cell(root, name):
    """(cell, config, traffic, {end-to-end metric: unit}, {per-layer
    metric: unit}) of the cell `name` in root/BENCHMARK.json."""
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(root, cfg_entry["file"])) as fh:
        cfg = json.load(fh)
    with open(os.path.join(root, "skelbench", "traffic",
                           cell["traffic"] + ".json")) as fh:
        traffic = json.load(fh)

    def mine(m):
        return "workloads" not in m or name in m["workloads"]

    e2e = {m["name"]: m["unit"] for m in bench["end_to_end"] if mine(m)}
    per_layer = {m["name"]: m["unit"] for m in bench["per_layer"]
                 if ("workloads" in m and name in m["workloads"])
                 or ("workloads" not in m and m["moves"] in e2e)}
    return cell, cfg, traffic, e2e, per_layer


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def card():
    """(name, power limit) of the first card, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
        return out[0] if out else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


class Cell:
    """One cell's program, inputs and reference, for one process."""

    def __init__(self, root, name, device):
        import numpy as np
        import torch

        import gen
        import kimimaro_tpu_torch
        from reference import judge

        self.np, self.torch = np, torch
        self.cell, self.cfg, self.traffic, self.e2e, self.per_layer = \
            load_cell(root, name)
        self.device = torch.device(device)
        t = time.perf_counter()
        kwargs = dict(self.cfg["skeletonize_kwargs"])
        if "voxel_graph" in kwargs or "device" in kwargs:
            raise SystemExit("skeletonize_kwargs may not set voxel_graph "
                             "(the traffic's) or device (the run's)")
        try:
            judge.option_modules(kwargs)
        except ValueError as exc:
            raise SystemExit(str(exc))
        self.base, self.graph = gen.base_volume(self.cfg, self.traffic,
                                                self.device)
        if bool(self.cfg["voxel_graph"]) != (self.graph is not None):
            raise SystemExit(
                f"config {self.cell['config']!r} says voxel_graph "
                f"{self.cfg['voxel_graph']}, traffic {self.cell['traffic']!r}"
                f" makes {'a' if self.graph is not None else 'no'} graph")
        self.sync()
        self.gen_s = time.perf_counter() - t
        self.voxels = int(self.base.numel())
        self.base_host = self.base.cpu().numpy()
        graph = self.graph

        def skeletonize(vol):
            return kimimaro_tpu_torch.skeletonize(
                vol, voxel_graph=graph, device=self.device, **kwargs)

        self.skeletonize = skeletonize

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def chunks(self, seed):
        import gen

        return gen.Chunks(self.base, seed)

    def free_device(self):
        """Drop the harness's device tensors (the reference runs on the
        host, after the program's peak was read)."""
        self.base = None
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def judge(self, seed, luts, results, pool, control=None):
        """The comparison's numbers (and, with `control` a precision of
        `reference.teasar.PRECISIONS`, the control's) for the window's
        chunks: `luts` their id tables, `results` the program's
        skeletons."""
        from reference import judge

        np = self.np
        if getattr(self, "_ref", None) is None:
            self._ref = judge.Reference(
                self.base_host, self.graph, self.cfg["skeletonize_kwargs"],
                pool)
        ref = self._ref
        lut = luts[0]
        inv = np.zeros(int(lut.max()) + 1, np.int64)
        inv[lut] = np.arange(len(lut))
        ends = {int(inv[k]): judge.skeleton_ends(s)
                for k, s in results[0].items() if k < len(inv)}
        labels = judge.sample(ref, ends, seed)
        picked = [(k % len(luts), lab) for k, lab in enumerate(labels)]
        refs = ref.skeletons(labels)
        self.details = []
        out = judge.check(luts, results, ref, picked, refs,
                          details=self.details, pool=pool)
        ctl = None
        if control:
            low = ref.skeletons(labels, precision=control)
            self.control_details = []
            ctl = judge.check(luts, results, ref, picked, refs, control=low,
                              details=self.control_details, pool=pool)
        return out, ctl, labels


def _profile_chunk(cell, chunk):
    """One chunk under torch.profiler (the card's activity) with the kernel
    and phase spies: the `profile` entry of the traced record, and the
    breakdown."""
    from torch.profiler import ProfilerActivity, profile

    import devtrace
    import spy
    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling

    ks, ps = spy.KernelSpy(), spy.PhaseSpy()
    kernels.reset_launches()
    profiling.reset_stats()
    # the card's activity; a CPU run (the tests) has none to record
    act = ProfilerActivity.CUDA if cell.device.type == "cuda" \
        else ProfilerActivity.CPU
    try:
        with profile(activities=[act]) as prof:
            lo = time.time_ns() * 1e-3
            cell.skeletonize(chunk)
            cell.sync()
            hi = time.time_ns() * 1e-3
    finally:
        ks.close()
        ps.close()
    launches = dict(kernels.LAUNCHES)
    t = time.perf_counter()
    dev = devtrace.events(prof)
    # the profiler's clock is the Unix clock; where its events fall
    # outside the chunk's interval, the clocks differ, and the device
    # events alone are kept, unattributed
    inside = dev and lo - 1e6 < min(s for _, s, _ in dev) and \
        max(e for _, _, e in dev) < hi + 1e6
    if inside:
        dev = [(n, max(s, lo), min(e, hi)) for n, s, e in dev
               if e > lo and s < hi]
        idle = devtrace.idle_by_phase(dev, ps.ranges + [("chunk", lo, hi)],
                                      lo, hi)
    else:
        idle = {}
    device_s = devtrace.time_by_name(dev)
    rec = {"window_s": (hi - lo) * 1e-6,
           "busy_s": devtrace.union_seconds([(s, e) for _, s, e in dev]),
           "device_s": device_s, "calls": ks.calls, "launches": launches}
    log(f"profile: {len(dev)} device events, read in "
        f"{time.perf_counter() - t:.1f} s; clocks agree: {bool(inside)}")
    top = sorted(device_s.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
    breakdown = {"device_ops": [[n[:160], s] for n, s in top],
                 "idle_gaps": [[n, s] for n, s in gaps]}
    return rec, breakdown


def execute(root, name, seed, seconds, trace, device="cuda", wrap=None):
    """One run of the cell `name`: (result line, the compared numbers).
    `wrap`, where given, wraps the program's entry for the window's
    chunks (the fault tests break the timed path with it)."""
    use_checkout(root)
    import numpy as np
    import torch

    from kimimaro_tpu_torch import kernels
    from kimimaro_tpu_torch.utils import profiling
    from reference import judge

    cell = Cell(root, name, device)
    cell.skeletonize(cell.base_host.view(np.uint32))        # warm-up
    cell.sync()
    run_chunk = wrap(cell.skeletonize) if wrap else cell.skeletonize
    if trace:
        profiling.reset_stats()
        profiling.collect(True)
    kernels.reset_launches()
    cuda = cell.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(cell.device)
        held = torch.cuda.memory_allocated(cell.device)
    setup_s = time.perf_counter() - T_START

    chunks = cell.chunks(seed)
    luts, results, times = [], [], []
    attempted = failed = 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        t = time.perf_counter()
        chunk, lut = chunks.next()
        attempted += 1
        try:
            res = run_chunk(chunk)
        except Exception as exc:  # a failed chunk counts; the run goes on
            log(f"chunk {attempted} failed: {type(exc).__name__}: {exc}")
            failed += 1
            continue
        cell.sync()
        times.append(time.perf_counter() - t)
        luts.append(lut)
        results.append(res)
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(cell.device) if cuda else 0
    stats = profiling.get_stats()
    launches = dict(kernels.LAUNCHES)
    profiling.collect(False)

    breakdown = prof_rec = None
    t = time.perf_counter()
    if trace:
        chunk, _ = chunks.next()
        prof_rec, breakdown = _profile_chunk(cell, chunk)
    profile_s = time.perf_counter() - t

    log(f"card: {card() if cuda else 'cpu'}")
    log(f"generation_s: {cell.gen_s:.4f}  setup_s: {setup_s:.4f}")
    log(f"chunk_s: {json.dumps(times)}")
    if trace:
        log(f"phases: {json.dumps(stats['phases'])}")
        log(f"counters: {json.dumps(stats['counters'])}")
    log(f"launches: {json.dumps(launches)}")

    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {bad}")
        return None, None

    cell.free_device()
    t = time.perf_counter()
    cell.details = []
    numbers = {k: None for k in judge.LIMITS}
    if results:
        pool = judge.make_pool()
        try:
            numbers, _, _ = cell.judge(seed, luts, results, pool)
        finally:
            pool.close()
            pool.join()
    log(f"window_s: {window_s:.3f}  profile_s: {profile_s:.1f}  "
        f"judge_s: {time.perf_counter() - t:.1f}")
    log("sampled labels (base id, vertices, reference vertices, stray, "
        "vertex gap, radius gap, uncovered, path excess): "
        f"{json.dumps(cell.details)}")

    if trace:
        rec = {"chunks": len(results), "phases": stats["phases"],
               "counters": stats["counters"], "launches": launches,
               "profile": prof_rec}
        metrics = {}
        for m, unit in cell.per_layer.items():
            v = importlib.import_module(f"layers.{m}").read(rec)
            if v is not None:
                metrics[m] = {"value": v, "unit": unit}
    else:
        metrics = {}
        values = {"mvox_per_s": len(results) * cell.voxels / window_s / 1e6,
                  "setup_s": setup_s}
        if cuda:
            values["peak_gib"] = (peak - held) / 2 ** 30
        metrics = {m: {"value": values[m], "unit": unit}
                   for m, unit in cell.e2e.items() if m in values}

    ok = bool(results) and failed == 0 and judge.passes(numbers)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(cell.device) if cuda
           else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = prof_rec["busy_s"]
        dev["window_s"] = prof_rec["window_s"]
    out = {"correct": ok, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": dev}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": numbers[k], "limit": judge.LIMITS[k]}
                     for k in judge.LIMITS}
    return out, numbers


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    load_cell(root, args.workload)
    use_checkout(root)
    import torch

    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        chips = {w["name"]: w["chips"] for w in
                 json.load(fh)["workloads"]}[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); "
            f"found {torch.cuda.device_count()}")
        return 2
    out, numbers = execute(root, args.workload, args.seed, args.seconds,
                           bool(args.trace))
    if out is None:
        return 3
    emit(out)
    return 0


def emit(out):
    """The compared numbers beside their limits as the last lines of
    standard error, then the result line."""
    for k, v in out["checks"].items():
        log(f"check {k}: {v['value']!r} (limit {v['limit']!r})")
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    sys.exit(main())
