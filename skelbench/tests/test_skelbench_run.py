"""Whole runs of tiny cells on the CPU (the program's plain kernels), in
fresh interpreters: the result line's keys, cells found by name from new
files and entries, the import check, the faults that `correct` has to
catch, and the refusal without a card."""

import json
import os

import pytest

from conftest import (REPO, VORONOI, add_cell, checkout, run_python,
                      tiny_config)

KEYS = {"correct", "attempted", "failed", "metrics", "device", "checks"}


def _run(root, name, trace, seconds=1.0, wrap="", code_before=""):
    code = f"""
import json, sys
sys.path.insert(0, 'skelbench')
import run
{code_before}
{wrap}
out, numbers = run.execute('.', {name!r}, 2 ** 33 + 17, {seconds}, {trace},
                           device='cpu'{', wrap=wrap' if wrap else ''})
run.emit(out)
print(json.dumps(sorted({{m.split('.')[0] for m in sys.modules}})))
"""
    p = run_python(root, code)
    assert p.returncode == 0, p.stderr[-4000:]
    lines = p.stdout.strip().splitlines()
    return json.loads(lines[-2]), json.loads(lines[-1]), p.stderr


# a kind of traffic the benchmark does not have: rods along z, one label
# each, on a grid
RODS = """
import torch


def apply(vol, graph, p, shape, device):
    vol = torch.zeros(shape, dtype=torch.int32, device=device)
    w, k = int(p["width"]), 1
    for x in range(1, shape[0] - w, 2 * w):
        for y in range(1, shape[1] - w, 2 * w):
            vol[x:x + w, y:y + w, 2:-2] = k
            k += 1
    return vol, graph
"""

# a skeletonize option the reference does not implement itself; it
# changes no skeleton
PARALLEL = """
def prepare(labels, graph, value):
    return labels, graph
"""

RECORD = """
import kimimaro_tpu_torch
seen = []
_inner = kimimaro_tpu_torch.skeletonize
def _spy(vol, **kw):
    seen.append(sorted(kw))
    return _inner(vol, **kw)
kimimaro_tpu_torch.skeletonize = _spy
import atexit
atexit.register(lambda: print("seen", json.dumps(seen[-1]), file=sys.stderr))
"""


def test_a_cell_of_new_files_alone(tmp_path):
    root = checkout(tmp_path)
    sb = root / "skelbench"
    (sb / "steps" / "rods.py").write_text(RODS)
    (sb / "reference" / "options" / "parallel.py").write_text(PARALLEL)
    cfg = tiny_config({"chunk": [40, 40, 20]},
                      {"dust_threshold": 100, "parallel": 1})
    add_cell(root, "tiny-rods", cfg, [{"step": "rods", "width": 6}])
    out, _, err = _run(root, "tiny-rods", 0, code_before=RECORD)
    assert out["correct"] is True, out["checks"]
    # the configuration's options reach the program as they stand
    seen = json.loads(err.split("seen ")[-1].splitlines()[0])
    assert "parallel" in seen and "voxel_graph" in seen


REFUSE = """
import sys
sys.path.insert(0, 'skelbench')
import run
try:
    run.execute('.', {name!r}, 5, 1.0, 0, device='cpu')
except SystemExit as exc:
    print('refused:', exc)
"""


@pytest.mark.parametrize("kwargs,changes,steps,why", [
    ({"fill_holes": True}, {}, [VORONOI], "fill_holes"),
    ({}, {"voxel_graph": True}, [VORONOI], "voxel_graph"),
])
def test_a_cell_the_reference_cannot_judge_is_refused(tmp_path, kwargs,
                                                       changes, steps, why):
    root = checkout(tmp_path)
    cfg = tiny_config(dict({"chunk": [24, 24, 12]}, **changes),
                      dict({"dust_threshold": 100}, **kwargs))
    add_cell(root, "tiny-bad", cfg, steps)
    p = run_python(root, REFUSE.format(name="tiny-bad"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert "refused:" in p.stdout and why in p.stdout


@pytest.mark.parametrize("name,trace", [("tiny-dense", 0),
                                        ("tiny-autapse", 1),
                                        ("tiny-soma", 0)])
def test_a_tiny_cell_runs_end_to_end(tiny_root, name, trace):
    out, modules, err = _run(tiny_root, name, trace)
    assert set(out) == KEYS | ({"breakdown"} if trace else set())
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    if trace:
        assert {"preamble_s", "crop_engine_s", "crop_jobs",
                "idle_share"} <= set(out["metrics"])
        assert "gengine_s" not in out["metrics"]     # bypassed by a graph
    else:
        assert {"mvox_per_s", "setup_s"} <= set(out["metrics"])
    # the last lines of standard error: each compared number and its limit
    tail = err.strip().splitlines()[-len(out["checks"]):]
    assert [t.split(":")[0] for t in tail] == \
        [f"check {k}" for k in out["checks"]]
    # the import check compares whole top-level names
    assert "kimimaro_tpu_torch" in modules
    assert not {"jax", "jaxlib", "flax", "kimimaro_tpu"} & set(modules)


FAULTS = {
    # a step that returns its state unchanged: nothing traced
    "unchanged": "lambda f: (lambda vol: {})",
    # half of the batch left out
    "half": "lambda f: (lambda vol: dict(sorted(f(vol).items())[::2]))",
    # an answer altered where it is produced: two labels' skeletons swapped
    "swapped": """lambda f: (lambda vol: (lambda r, k: {**r, k[0]: r[k[-1]],
        k[-1]: r[k[0]]})(f(vol), sorted(f(vol))))""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_timed_path_is_not_correct(tiny_root, fault):
    out, _, _ = _run(tiny_root, "tiny-dense", 0,
                     wrap=f"wrap = {FAULTS[fault]}")
    assert out["correct"] is False


def test_the_command_refuses_without_a_card(tiny_root):
    env_code = """
import subprocess, sys
p = subprocess.run([sys.executable, 'skelbench/run.py', '--workload',
                    'tiny-dense', '--seed', '5', '--seconds', '1',
                    '--trace', '0'], capture_output=True, text=True)
print(p.returncode, len(p.stdout))
"""
    p = run_python(tiny_root, env_code)
    rc, out_len = p.stdout.split()
    assert rc != "0" and out_len == "0"


def test_the_tiny_root_holds_no_program(tiny_root):
    # what the command finds in a directory of BENCHMARK.json and the
    # benchmark's files alone: no program beside them
    assert sorted(os.listdir(tiny_root)) == ["BENCHMARK.json", "skelbench"]
    assert os.path.isdir(os.path.join(REPO, "kimimaro_tpu_torch"))


@pytest.mark.gpu
def test_a_tiny_cell_on_the_card(tiny_root):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = run_python(tiny_root, """
import subprocess, sys
p = subprocess.run([sys.executable, 'skelbench/run.py', '--workload',
                    'tiny-dense', '--seed', '5', '--seconds', '2',
                    '--trace', '1'], capture_output=True, text=True)
print(p.stdout.strip().splitlines()[-1])
""")
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
