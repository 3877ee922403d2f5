"""Whole runs of a tiny cell with `fill_holes` and `fix_avocados` on the CPU:
the cell is judged correct through the reference's two option modules, its
traced line holds the host stages' metrics, and the judge reads the program
as wrong when either option's `prepare` is the identity. Also the refusal
of an option the reference still lacks (`object_ids`), now that it
implements `fill_holes`."""

import pytest

from conftest import VORONOI, add_cell, checkout, run_python, tiny_config
from reference import judge
from test_skelbench_reference import KW
from test_skelbench_run import REFUSE, _run

# over the Voronoi cells: a thin shell (the fruit, no avocado candidate)
# cut by the x = 0 face, holding a pit on that face (a candidate: the
# avocado), and a hollow box with thin walls holding a label in its hole
AVOCADO = """
def apply(vol, graph, p, shape, device):
    vol = vol.clone()
    k = int(vol.max()) + 1
    vol[0:9, 9:25, 7:17] = k
    vol[0:6, 12:22, 8:16] = k + 1
    vol[24:38, 6:30, 2:22] = k + 2
    vol[27:35, 10:26, 4:20] = 0
    vol[29:33, 14:22, 9:15] = k + 3
    return vol, graph
"""

IDENTITY = """
from reference.options import {0}
{0}.prepare = lambda labels, graph, value, **kw: (labels, graph)
"""


@pytest.fixture(scope="module")
def fill_root(tmp_path_factory):
    root = checkout(tmp_path_factory.mktemp("fill"))
    (root / "skelbench" / "steps" / "avocado.py").write_text(AVOCADO)
    cfg = tiny_config({"chunk": [40, 40, 24]},
                      {"dust_threshold": 100, "fill_holes": True,
                       "fix_avocados": True,
                       "teasar_params": {"soma_detection_threshold": 150}})
    add_cell(root, "tiny-fill", cfg, [VORONOI, {"step": "avocado"}])
    return root


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_with_the_host_stages_runs_end_to_end(fill_root, trace):
    out, _, err = _run(fill_root, "tiny-fill", trace)
    assert out["correct"] is True, (out["checks"], err[-3000:])
    if trace:
        m = out["metrics"]
        assert {"host_stages_s", "fill_holes_s", "avocado_s",
                "host_stages_syncs", "host_stages_wait_s",
                "avocado_candidates"} <= set(m)
        assert m["host_stages_syncs"]["value"] > 0
        assert m["avocado_candidates"]["value"] >= 1
        assert m["host_stages_s"]["value"] >= m["fill_holes_s"]["value"]


@pytest.mark.parametrize("option", ["fill_holes", "fix_avocados"])
def test_the_judge_without_an_option_reads_the_host_stages_as_wrong(
        fill_root, option):
    out, _, _ = _run(fill_root, "tiny-fill", 0,
                     code_before=IDENTITY.format(option))
    assert out["correct"] is False
    checks = out["checks"]
    assert checks["labels_off"]["value"] > 0 or \
        checks["uncovered"]["value"] > 0, checks


def test_the_reference_implements_both_host_stages():
    mods = judge.option_modules({**KW, "fill_holes": True,
                                 "fix_avocados": True})
    assert sorted(mods) == ["fill_holes", "fix_avocados"]


def test_an_option_the_reference_still_lacks_is_refused():
    with pytest.raises(ValueError, match="object_ids"):
        judge.option_modules({**KW, "object_ids": [1, 2]})


def test_a_cell_with_an_option_the_reference_still_lacks_is_refused(
        tmp_path):
    root = checkout(tmp_path)
    cfg = tiny_config({"chunk": [24, 24, 12]},
                      {"dust_threshold": 100, "object_ids": [1, 2]})
    add_cell(root, "tiny-bad", cfg, [VORONOI])
    p = run_python(root, REFUSE.format(name="tiny-bad"))
    assert p.returncode == 0, p.stderr[-3000:]
    assert "refused:" in p.stdout and "object_ids" in p.stdout
