"""Fixtures of the benchmark's CPU tests: a checkout-like root in a temporary
directory holding a copy of skelbench/ and a BENCHMARK.json with the tiny
cells added by new files and new entries alone."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
SKELBENCH = os.path.dirname(HERE)
REPO = os.path.dirname(SKELBENCH)
if SKELBENCH not in sys.path:
    sys.path.insert(0, SKELBENCH)

VORONOI = {"step": "voronoi", "labels": 12, "scale": [16, 16, 40], "seed": 3}
TINY = {
    # name: (config changes, skeletonize_kwargs changes, traffic steps)
    "tiny-dense": ({"chunk": [48, 48, 24]}, {"dust_threshold": 100},
                   [VORONOI]),
    "tiny-autapse": ({"chunk": [48, 48, 24], "voxel_graph": True},
                     {"dust_threshold": 100},
                     [VORONOI, {"step": "merge", "share": 4}]),
    "tiny-soma": ({"chunk": [36, 36, 36]},
                  {"dust_threshold": 100,
                   "teasar_params": {"soma_detection_threshold": 150}},
                  [VORONOI, {"step": "hollow", "seed": 4, "labels": 6,
                             "pits": 2, "balls": 1, "ball_radius": 6,
                             "ball_z_squash": 2.5}]),
}


def base_config():
    with open(os.path.join(SKELBENCH, "configs",
                           "kimimaro-bench-512.json")) as fh:
        return json.load(fh)


def add_cell(root, name, cfg, steps):
    """Add the cell `name` to the checkout `root` by new files and new
    entries alone: its config, its traffic and its BENCHMARK.json
    entries (every per-layer metric listed for it)."""
    root = str(root)
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        bench = json.load(fh)
    cfg = dict(cfg, name=name)
    with open(os.path.join(root, "skelbench", "configs", f"{name}.json"),
              "x") as fh:
        json.dump(cfg, fh)
    with open(os.path.join(root, "skelbench", "traffic", f"{name}.json"),
              "x") as fh:
        json.dump({"steps": steps}, fh)
    bench["configs"].append({
        "name": name, "source": cfg["source"],
        "file": f"skelbench/configs/{name}.json",
        "reduced": ["chunk"], "why": "a CPU test's cell"})
    bench["workloads"].append({
        "name": name, "config": name, "traffic": name, "chips": 1,
        "why": "a CPU test's cell"})
    for m in bench["per_layer"]:
        m["workloads"].append(name)
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fh:
        json.dump(bench, fh)


def tiny_config(changes, kwargs):
    cfg = json.loads(json.dumps(base_config()))
    kw = cfg["skeletonize_kwargs"]
    kw["teasar_params"].update(kwargs.pop("teasar_params", {}))
    kw.update(kwargs)
    cfg.update(changes)
    return cfg


def checkout(root):
    """A checkout-like root: skelbench/ (without its tests) and
    BENCHMARK.json."""
    shutil.copytree(SKELBENCH, root / "skelbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), root)
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    root = checkout(tmp_path_factory.mktemp("checkout"))
    for name, (changes, kwargs, steps) in TINY.items():
        add_cell(root, name, tiny_config(dict(changes), dict(kwargs)), steps)
    return root


def run_python(root, code, timeout=600):
    """Run `code` in a fresh interpreter in `root`, with the repository's
    program importable; returns the completed process."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                          capture_output=True, text=True, timeout=timeout)
